"""The ``ur10-bookshelves`` configuration (6 joints, standard DH, the base
as the reference's benchmark script sets it, the bookshelves grid, a
constant learning rate): the port's own asset files, which differ from the
JAX package's in that base alone; the port's plain path against the
benchmark's plain float64 reference (``benchmark/reference``) at a tiny
size, with the checks the benchmark's own tests run
(``benchmark/tests/_ur10.py``); and the K1 and K3 wrappers' launch counters
by arm, and the plain K1 and K3 versions' counts on CUDA tensors, shown with
a stand-in extension and CPU tensors that say they lie on CUDA."""

import numpy as np
import pytest
import torch

from _torch_support import smooth_grid
from benchmark.tests import _ur10
from vgpmp_torch import robots, scene, sim
from vgpmp_torch.kinematics import dh
from vgpmp_torch.likelihoods import collision as col
from vgpmp_torch.sdf import grid as sg


@pytest.fixture(scope="module")
def pair():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _ur10.session_and_problem()
    torch.set_num_threads(n)


@pytest.mark.parametrize("what", ["configuration", "the_arm_reaches_the_shelves", "sphere_positions", "lookups",
                                  "elbo_gradient_and_adam", "metric_verdicts"])
def test_port_against_the_reference(pair, what):
    getattr(_ur10, f"check_{what}")(*pair)


def test_engine_replay_matches_solve_adaptive():
    _ur10.check_engine_replay()


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lies on CUDA."""

    @property
    def is_cuda(self):
        return True


def _fake(x):
    return torch.Tensor._make_subclass(_CudaLike, x)


class _Extension:
    """Stands in for the compiled kernels: outputs of the launches' shapes."""

    def k1_loglik(self, q, sigma, *a):
        return torch.zeros(q.shape[0]), torch.zeros(q.shape), None

    def k3_min_clearance(self, q, *a):
        return torch.zeros(q.shape[0])

    def k3_probe_clearance(self, q, robot, spheres, data, craig, grid, q_s, q_g, ds, dg, visited, seg_idx, T,
                           *a):
        return torch.zeros(q.shape[0]), torch.zeros((q_s.shape[0], T), dtype=torch.int32)


def _model(robot):
    data = smooth_grid(np.random.default_rng(5), (20, 20, 18), scale=1.0) - np.float32(0.1)
    sc = scene.Scene(base=sg.SdfGrid.from_arrays(data, np.array([-0.6, -0.6, -0.3]), 0.06, torch.float32),
                     base_offset=torch.zeros(3)).packed()
    spec = robots.load_robot(robot)
    return spec, col.CollisionModel(fk=dh.FkModel.from_spec(spec, np.eye(4), dtype=torch.float32), scene=sc,
                                    epsilon=0.05)


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(col._build, "load", lambda: _Extension())
    for f in (col.k1_loglik, col.k3_min_clearance, col.k3_probe_clearance):
        monkeypatch.setattr(f, "launches_by_arm", {})
    for f in (col.k1_loglik, col.k3_min_clearance):
        monkeypatch.setattr(f, "plain_on_card", 0)
    monkeypatch.setattr(col.k1_loglik, "launches_by", {})


def _launch_all(spec, model, B=2, G=5, T=3):
    q = torch.zeros(B * G, spec.dof)
    col.k1_loglik(model, _fake(q), torch.ones(1, spec.num_spheres), grad=True)
    col.k3_min_clearance(model, _fake(q))
    z = torch.zeros(B)
    col.k3_probe_clearance(model, _fake(q.reshape(B, G, -1)), q[:B], q[:B], z, z, torch.ones(B, dtype=torch.bool),
                           torch.zeros(B, G, dtype=torch.int64), T, 0.5, 5e-3)


def test_launches_are_counted_by_arm(counters):
    """Each launch counts under its arm's (joints, Craig's convention): the
    UR10 under (6, False), franka under (7, True), wam under (7, False); K1's
    count by (mode, dtype) keeps its keys."""
    for robot in ("ur10", "ur10", "franka", "wam"):
        _launch_all(*_model(robot))
    want = {(6, False): 2, (7, True): 1, (7, False): 1}
    for f in (col.k1_loglik, col.k3_min_clearance, col.k3_probe_clearance):
        assert f.launches_by_arm == want, f.__name__
    assert col.k1_loglik.launches_by == {("packed", "float32"): 4}
    assert (col.k1_loglik.plain_on_card, col.k3_min_clearance.plain_on_card) == (0, 0)


def test_plain_versions_count_their_calls_on_cuda_tensors(counters):
    """The plain K1 and K3 versions count a call on a CUDA tensor
    (``plain_on_card``) and none on a CPU tensor; the CPU entry points take
    them without counting. The metric's probe pass has no count of its own:
    its plain version asks the model for the clearance, so on the card it
    would launch K3."""
    spec, model = _model("ur10")
    q = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (2, 5, spec.dof)), dtype=torch.float32)
    sigma = torch.full((spec.num_spheres,), 5e-4)
    model.log_prob(q, sigma)
    model.min_clearance_eval(q)
    B, G, T = 2, 5, 3
    z = torch.zeros(B)
    args = (q[:, 0], q[:, -1], z, z, torch.ones(B, dtype=torch.bool), torch.zeros(B, G, dtype=torch.int64), T,
            0.5, 5e-3)
    model.probe_clearance(q, *args)
    assert (col.k1_loglik.plain_on_card, col.k3_min_clearance.plain_on_card) == (0, 0)
    col.log_prob_plain(model, _fake(q), sigma)
    col.min_clearance_eval_plain(model, _fake(q))
    sim.probe_clearance_plain(lambda x: col.min_clearance_eval_plain(model, x), _fake(q), *args)
    assert (col.k1_loglik.plain_on_card, col.k3_min_clearance.plain_on_card) == (1, 2)
    assert not any(f.launches_by_arm for f in (col.k1_loglik, col.k3_min_clearance, col.k3_probe_clearance))


def test_the_ports_assets_differ_from_the_jax_packages_in_the_ur10s_base_alone():
    """The port reads its own copy of the UR10's problemsets, whose
    bookshelves base is the identity where the JAX package's turns 180
    degrees about z, and nothing else differs; its robot file and the
    bookshelves grid are the JAX package's; every other asset is read from
    the JAX package's directory."""
    import json

    from vgpmp_torch.session import PlanningSession

    own = json.loads(robots.asset("problemsets", "ur10.json").read_text())
    jax = json.loads((robots.ASSET_DIR / "problemsets" / "ur10.json").read_text())
    assert own["bookshelves"].pop("robot_orientation_xyzw") == [0.0, 0.0, 0.0, 1.0]
    assert jax["bookshelves"].pop("robot_orientation_xyzw") == [0.0, 0.0, -1.0, 0.0]
    assert own == jax
    assert robots.asset("robots", "ur10.json").read_text() == (robots.ASSET_DIR / "robots" / "ur10.json").read_text()
    assert (robots.asset("scenes", "bookshelves.npz").resolve()
            == (robots.ASSET_DIR / "scenes" / "bookshelves.npz").resolve())
    for kind, name in (("problemsets", "franka.json"), ("robots", "wam.json"), ("scenes", "industrial.npz")):
        assert robots.asset(kind, name) == robots.ASSET_DIR / kind / name
    assert robots.available_robots() == ["franka", "kuka", "ur10", "wam"]
    for ps in ("bookshelves", "industrial"):
        sess = PlanningSession("ur10", ps, dtype=torch.float64, device="cpu", overrides={"num_steps": 0})
        np.testing.assert_array_equal(sess.base_pose, np.eye(4))
