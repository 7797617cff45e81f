"""Port parity: the reference-schema ``parameters.yaml`` entry
(``vgpmp_torch/config.py`` and ``PlanningSession.from_config``) against
``vgpmp_tpu.config`` and the JAX session, on YAML files written under
``tmp_path`` in the reference's list-of-single-key-dicts schema.

Parsing is exact (the same values); a session's states, planner parameters,
base pose and scene offset are the same float64 numbers, and its trainable
mask the same dict.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgpmp_tpu.config import load_parameters_yaml as jload
from vgpmp_tpu.session import PlanningSession as JSession
from vgpmp_torch.config import load_parameters_yaml as tload
from vgpmp_torch.session import PlanningSession as TSession

TRAINABLE_KEYS = ("q_mu", "q_sqrt", "lengthscales", "kernel_variance", "sigma_obs",
                  "inducing_variable", "alpha")

BENCHMARK_YAML = """
- robot:
    robot_name: "{robot}"
- scene:
    position: [0.0, 0.0, 0.0]
    orientation: [0.0, 0.0, 0.0, 1.0]
    environment_name: "{problemset}"
    environment_file_name: "{problemset}"
    sdf_file_name: "{problemset}"
    objects: []
    benchmark: True
    benchmark_attributes:
      problemset_name: "{problemset}"
    non_benchmark_attributes:
- trainable_params:
{trainable}
- graphics:
    visuals: False
    debug_joint_positions: False
    debug_sampler: False
"""

NON_BENCHMARK_YAML = """
- robot:
    robot_name: "franka"
- scene:
    position: [0.1, 0.2, 0.3]
    orientation: [0.0, 0.0, 0.0, 1.0]
    environment_name: "industrial"
    environment_file_name: "industrial"
    sdf_file_name: "industrial"
    objects: []
    benchmark: False
    non_benchmark_attributes:
      states: [
        [0.0, 0.3, 0.0, -1.2, 0.0, 1.5, 0.0],
        [0.5, 0.3, 0.2, -1.0, 0.0, 1.5, 0.5],
        [-0.4, 0.1, 0.0, -1.6, 0.2, 1.8, 0.3]
      ]
      robot_pos_and_orn: [[0.05, -0.1, 0.02], [0.0, 0.0, 0.3826834, 0.9238795]]
      planner_params:
        sigma_obs: 0.005
        epsilon: 0.05
        lengthscales: [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]
        variance: 0.2
        alpha: 100
        num_samples: 4
        num_inducing: 6
        learning_rate: 0.05
        num_steps: 10
        time_spacing_X: 12
        time_spacing_Xnew: 16
    benchmark_attributes:
- trainable_params:
{trainable}
- graphics:
    visuals: True
"""


def _trainable_block(flags: dict) -> str:
    return "\n".join(f"    {k}: {v}" for k, v in flags.items())


# every trainable key on and off in turn, and the reference file's own choice
FLAG_SETS = [
    dict(q_mu=True, q_sqrt=True, lengthscales=True, kernel_variance=True, sigma_obs=False,
         inducing_variable=False, alpha=False),
    {k: True for k in TRAINABLE_KEYS},
    {k: False for k in TRAINABLE_KEYS},
    dict(q_mu=True, q_sqrt=False, lengthscales=False, kernel_variance=True, sigma_obs=True,
         inducing_variable=True, alpha=False),
    {},  # no key given: the defaults
]


def _write(tmp_path, text, name="parameters.yaml"):
    p = tmp_path / name
    p.write_text(text)
    return p


@pytest.mark.parametrize("flags", range(len(FLAG_SETS)))
@pytest.mark.parametrize("benchmark", [True, False])
def test_load_parameters_yaml_matches_jax(tmp_path, flags, benchmark):
    block = _trainable_block(FLAG_SETS[flags])
    text = (BENCHMARK_YAML.format(robot="wam", problemset="bookshelves", trainable=block) if benchmark
            else NON_BENCHMARK_YAML.format(trainable=block))
    p = _write(tmp_path, text)
    want, got = jload(p), tload(p)
    assert got.benchmark is benchmark
    for f in ("robot_name", "benchmark", "problemset_name", "scene_position", "scene_orientation",
              "environment_name", "robot_pos_and_orn", "planner_params", "trainable_params",
              "graphics_params"):
        assert getattr(got, f) == getattr(want, f), f
    if benchmark:
        assert got.states is None and want.states is None and got.problemset_name == "bookshelves"
    else:
        np.testing.assert_array_equal(got.states, want.states)
        assert got.states.dtype == np.float64 and got.planner_params["num_inducing"] == 6
    assert got.trainable_mask() == want.trainable_mask()
    for yaml_key, leaf in (("sigma_obs", "sigma_obs_u"), ("alpha", "alpha_u"),
                           ("inducing_variable", "z_u"), ("lengthscales", "lengthscales_u")):
        if yaml_key in FLAG_SETS[flags]:
            assert got.trainable_mask()[leaf] is FLAG_SETS[flags][yaml_key]


def test_plain_mapping_schema_parses(tmp_path):
    """A mapping of the same sections parses like the list form."""
    import yaml

    block = _trainable_block(FLAG_SETS[1])
    listed = yaml.safe_load(BENCHMARK_YAML.format(robot="kuka", problemset="industrial", trainable=block))
    merged = {}
    for entry in listed:
        merged.update(entry)
    p = _write(tmp_path, yaml.safe_dump(merged), "mapping.yaml")
    assert tload(p) == tload(_write(tmp_path, BENCHMARK_YAML.format(
        robot="kuka", problemset="industrial", trainable=block), "list.yaml"))


def _same_session(t, j):
    np.testing.assert_array_equal(t.states, j.states)
    assert t.planner_params == j.planner_params
    np.testing.assert_array_equal(t.base_pose, j.base_pose)
    np.testing.assert_array_equal(t.scene_offset, j.scene_offset)
    assert t.trainable == j.trainable
    assert t.num_queries == j.num_queries
    assert t.model.num_inducing == j.model.num_inducing
    np.testing.assert_array_equal(t.model.limits_low.numpy(), np.asarray(j.model.limits_low))


def test_from_config_benchmark_mode_matches_jax(tmp_path):
    """Benchmark mode builds from the problemset (tuned overlay on, as the
    JAX entry does) with sigma_obs and alpha trainable."""
    p = _write(tmp_path, BENCHMARK_YAML.format(robot="franka", problemset="industrial",
                                               trainable=_trainable_block(FLAG_SETS[1])))
    t = TSession.from_config(p, dtype=torch.float64, device="cpu")
    j = JSession.from_config(p, dtype=jnp.float64)
    _same_session(t, j)
    assert t.device == torch.device("cpu") and t.sdf_mode == "packed"
    assert t.trainable["sigma_obs_u"] and t.trainable["alpha_u"]
    assert t.problemset_name == "industrial" and t.scene.mode == "packed"


def test_from_config_non_benchmark_mode_matches_jax(tmp_path):
    """Non-benchmark mode passes the file's states, base pose, scene position
    and planner parameters; the scene is the environment's grid."""
    p = _write(tmp_path, NON_BENCHMARK_YAML.format(trainable=_trainable_block(FLAG_SETS[3])))
    t = TSession.from_config(p, dtype=torch.float64, sdf_mode="nearest", device="cpu")
    j = JSession.from_config(p, dtype=jnp.float64, sdf_mode="nearest")
    _same_session(t, j)
    assert t.num_queries == 3 and t.model.num_inducing == 6 and t.scene.mode == "nearest"
    np.testing.assert_allclose(t.scene_offset, [0.1, 0.2, 0.3])
    assert t.trainable == dict(q_mu=True, q_sqrt=False, lengthscales_u=False, variance_u=True,
                               z_u=True, sigma_obs_u=True, alpha_u=False)


def test_from_config_needs_cuda_unless_told(tmp_path, monkeypatch):
    p = _write(tmp_path, BENCHMARK_YAML.format(robot="franka", problemset="testing",
                                               trainable=_trainable_block(FLAG_SETS[0])))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSession.from_config(p)
    s = TSession.from_config(p, device="cpu")
    assert s.model is None and s.trainable["q_mu"]
