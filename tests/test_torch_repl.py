"""Port parity: the debug loop (``engine/repl.py``) and the profiling helpers
(``utils/profiling.py``).

The loop runs the script of ``tests/test_analysis.py::test_debug_loop_commands``
in both packages on franka/industrial (float64, ``num_inducing=5``): every
output line has the same words as JAX's, and its numbers agree to the
printed precision (4 decimals). The banner names the package.
"""

import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgpmp_tpu.engine import solver as js
from vgpmp_tpu.engine.repl import debug_loop as jax_loop
from vgpmp_tpu.session import PlanningSession as JaxSession
from vgpmp_torch.engine import solver as ts
from vgpmp_torch.engine.repl import debug_loop
from vgpmp_torch.session import PlanningSession
from vgpmp_torch.utils import profiling

NUMBER = re.compile(r"[-+]?\d+\.\d*(?:e[-+]?\d+)?")


def _loop_outputs(script):
    """Both packages' output lines and final configurations for ``script``."""
    over = dict(num_inducing=5)
    jsess = JaxSession("franka", "industrial", dtype=jnp.float64, overrides=over)
    tsess = PlanningSession("franka", "industrial", dtype=torch.float64, overrides=over, device="cpu")
    starts, goals = tsess.queries()
    jparams = jax.tree.map(lambda x: x[0], js.init_batch(jsess.model, starts[:1], goals[:1],
                                                         jsess.planner_params))
    tparams = ts.init_batch(tsess.model, starts[:1], goals[:1], tsess.planner_params)
    out = []
    for loop, model, params in ((jax_loop, jsess.model, jparams), (debug_loop, tsess.model, tparams)):
        fout = io.StringIO()
        q = loop(model, params, stdin=io.StringIO(script), stdout=fout)
        out.append((fout.getvalue().splitlines(), q))
    return out


@pytest.mark.parametrize("script", [
    "c\nset 0 0.3\nsdf\nfk\nlik\nee\nbogus\nq\n",
    "goto 0.1 -0.2 0.3 -1.5 0.2 1.2 0.4\nset 9 1.0\nset 3 -9\nlik\nsdf\nc\n",
])
def test_debug_loop_matches_jax(script):
    (jlines, jq), (tlines, tq) = _loop_outputs(script)
    assert jlines[0].replace("vgpmp-tpu", "vgpmp-torch") == tlines[0]
    assert len(tlines) == len(jlines) > 10
    for jl, tl in zip(jlines[1:], tlines[1:]):
        assert NUMBER.sub("#", tl) == NUMBER.sub("#", jl), (tl, jl)
        a = np.array([float(x) for x in NUMBER.findall(tl)])
        b = np.array([float(x) for x in NUMBER.findall(jl)])
        np.testing.assert_allclose(a, b, rtol=0, atol=1.0001e-4, err_msg=tl)
    np.testing.assert_allclose(tq, np.asarray(jq), rtol=0, atol=1e-15)
    out = "\n".join(tlines)
    if "bogus" in script:
        for text in ("collision log-density", "sdf grad per sphere", "ee position", "commands:"):
            assert text in out
        assert tq[0] == pytest.approx(0.3, abs=1e-12)
    else:
        assert "joint index out of range" in out


def test_timing_prints_and_returns(capsys):
    @profiling.timing
    def work(x):
        return {"y": x * 2, "z": (x, [x + 1])}

    out = work(torch.ones(3))
    assert torch.equal(out["y"], torch.full((3,), 2.0))
    assert re.match(r"work took \d+\.\d{3} ms", capsys.readouterr().out)
    assert not profiling._on_cuda(out)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "t") as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    path = tmp_path / "t" / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    assert "traceEvents" in path.read_text()
    assert any("mm" in e.key for e in prof.key_averages())


def test_grad_tap_records_the_upstream_gradient(capsys):
    """Identity forward; the recorded gradient is autograd's at that point,
    and the gradient below the tap is unchanged."""
    x = torch.linspace(-1, 1, 5, dtype=torch.float64, requires_grad=True)
    seen = []
    y = profiling.grad_tap(torch.sin(x), printer=seen.append)
    assert torch.equal(y, torch.sin(x))
    (gx,) = torch.autograd.grad((y ** 3).sum(), x)
    s = torch.sin(x).detach()
    assert len(seen) == 1
    torch.testing.assert_close(seen[0], 3 * s ** 2, rtol=0, atol=0)
    (want,) = torch.autograd.grad((torch.sin(x) ** 3).sum(), x)
    torch.testing.assert_close(gx, want, rtol=0, atol=0)
    z = profiling.grad_tap(x * 2.0, name="probe")
    z.sum().backward()
    assert "probe: upstream grad" in capsys.readouterr().out
