"""The port's multi-process runtime (``vgpmp_torch.parallel.multihost``):
two ``python -m vgpmp_torch.parallel.multihost`` ranks over gloo on the CPU,
started by ``tools/launch_multihost_torch.py``, must give the one-process
result: equal success counts, the clearance to 1e-9 (the tolerance of
``tests/test_multihost.py``'s JAX runs is looser, 1e-5). Both runs start
together, each waited for with a timeout.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TINY = json.dumps({"num_steps": 12, "num_samples": 4, "num_bases": 64, "num_inducing": 6,
                   "time_spacing_X": 10, "time_spacing_Xnew": 12})
# a multiple of both rank counts: a row's draws depend on the padded batch
# (``vgpmp_torch/parallel/sharded.py``), as in ``tests/test_multihost.py``
N_PROBLEMS = 8


def test_two_processes_match_one_process(tmp_path):
    common = ["--robot", "franka", "--problemset", "industrial", "--max-problems", str(N_PROBLEMS),
              "--overrides", TINY]
    one, two = tmp_path / "one.json", tmp_path / "two.json"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [
        subprocess.Popen([sys.executable, "-m", "vgpmp_torch.parallel.multihost", "--device", "cpu",
                          "--json-out", str(one)] + common, cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        subprocess.Popen([sys.executable, "tools/launch_multihost_torch.py", "--processes", "2",
                          "--device", "cpu", "--timeout", "240", "--json-out", str(two)] + common,
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
    ]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    m1, m2 = json.loads(one.read_text()), json.loads(two.read_text())
    assert m1["num_processes"] == 1 and m2["num_processes"] == 2
    assert m1["mesh"] == {"dp": 1, "sp": 1} and m2["mesh"] == {"dp": 2, "sp": 1}
    assert m1["num_problems"] == m2["num_problems"] == N_PROBLEMS
    assert m1["card"] is None and m2["card"] is None
    assert m1["success_rate"] * N_PROBLEMS == m2["success_rate"] * N_PROBLEMS
    assert abs(m1["mean_min_clearance"] - m2["mean_min_clearance"]) <= 1e-9
    assert json.loads(outs[1].strip().splitlines()[-1]) == m2
