"""Interactive debug loop, entry point E of the reference (port of
``vgpmp_tpu/engine/repl.py``).

A line-oriented loop over a current joint configuration, with the probes of
:mod:`vgpmp_torch.engine.analysis`. Commands, one per line:

- ``q``               quit
- ``c``               print the current configuration
- ``set J V``         set joint J (0-based) to V radians (clamped to the limits)
- ``goto V0 V1 ...``  set the whole configuration (clamped)
- ``sdf``             the SDF's spatial gradient at every collision sphere
- ``fk``              the end-effector and sphere positions
- ``lik``             the collision log-density and the sphere clearances
- ``ee``              the end-effector position

The streams are injectable, so that tests drive the loop with a script.
"""

from __future__ import annotations

import sys
from typing import IO, Optional

import numpy as np
import torch

from vgpmp_torch.engine import analysis
from vgpmp_torch.kinematics.dh import sphere_positions
from vgpmp_torch.models.vgpmp import PlannerModel, PlannerParams

__all__ = ["debug_loop"]


def debug_loop(model: PlannerModel, params: PlannerParams, config0=None,
               stdin: Optional[IO] = None, stdout: Optional[IO] = None) -> np.ndarray:
    """Run the loop and return the final configuration (float64 ``[L]``).

    ``params`` is one problem's state, a batch of one (σ_obs of the ``lik``
    probe); ``config0`` is the first configuration (default: the middle of
    the joint box).
    """
    fin = stdin or sys.stdin
    fout = stdout or sys.stdout
    lo = model.limits_low.cpu().numpy().astype(np.float64)
    hi = model.limits_high.cpu().numpy().astype(np.float64)
    q = np.array(config0, dtype=np.float64) if config0 is not None else 0.5 * (lo + hi)

    def say(msg: str) -> None:
        print(msg, file=fout)

    def config() -> torch.Tensor:
        return torch.as_tensor(q, dtype=model.dtype, device=model.device)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    say(f"vgpmp-torch debug loop — {len(q)} joints; 'q' to quit")
    for line in fin:
        cmd = line.strip().split()
        if not cmd:
            continue
        op = cmd[0]
        if op == "q":
            break
        elif op == "c":
            say("config: " + np.array2string(q, precision=4))
        elif op == "set" and len(cmd) == 3:
            j, v = int(cmd[1]), float(cmd[2])
            if not 0 <= j < len(q):
                say(f"joint index out of range [0, {len(q)})")
                continue
            q[j] = float(np.clip(v, lo[j], hi[j]))
            say(f"joint {j} = {q[j]:.4f}")
        elif op == "goto" and len(cmd) == len(q) + 1:
            q = np.clip(np.array([float(v) for v in cmd[1:]]), lo, hi)
            say("config: " + np.array2string(q, precision=4))
        elif op == "sdf":
            g = host(analysis.sdf_gradient_at_config(model.collision, config()))
            say("sdf grad per sphere:\n" + np.array2string(g, precision=4))
        elif op == "fk":
            with torch.no_grad():
                pos = host(analysis.ee_positions(model.collision.fk, config()))
                sp = host(sphere_positions(model.collision.fk, config()))
            say("ee position: " + np.array2string(pos, precision=4))
            say("sphere positions:\n" + np.array2string(sp, precision=4))
        elif op == "lik":
            with torch.no_grad():
                val = float(analysis.debug_likelihood(params, model, config()))
                clear = host(model.collision.sphere_clearance(config()))
            say(f"collision log-density: {val:.4f}")
            say(f"clearance: min={clear.min():+.4f} "
                f"mean={clear.mean():+.4f} (per-sphere available via 'sdf')")
        elif op == "ee":
            with torch.no_grad():
                pos = host(analysis.ee_positions(model.collision.fk, config()))
            say("ee position: " + np.array2string(pos, precision=4))
        else:
            say("commands: q | c | set J V | goto V... | sdf | fk | lik | ee")
    return q
