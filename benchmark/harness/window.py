"""The measured window: whole batches, back to back, from the first's start
to the last's end. No batch starts once ``seconds`` have passed, and every
rate is all of the window's work over all of its time, so a stall anywhere
in it counts."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass
class Batch:
    index: int
    rows: int
    executed: int
    failed: int
    t0: float
    t1: float
    rounds: int
    spent: int


def run(seconds: float, run_batch: Callable[[int], Dict], clock=time.perf_counter,
        go: Optional[Callable[[int, bool], bool]] = None, at_least: int = 1) -> List[Batch]:
    """Run batches ``0, 1, ...`` until ``seconds`` have passed since the first
    started (and at least ``at_least`` ran). ``run_batch(k)`` returns
    ``{"rows", "executed", "failed", "rounds", "spent"}``. ``go(k, wants)``,
    where given, turns this process's wish to start batch ``k`` into the
    decision of all processes that run the window in step."""
    out: List[Batch] = []
    start = clock()
    k = 0
    while True:
        wants = k < at_least or clock() - start < seconds
        if go is not None:
            wants = go(k, wants)
        if not wants:
            break
        t0 = clock()
        r = run_batch(k)
        out.append(Batch(k, r["rows"], r["executed"], r["failed"], t0, clock(), r["rounds"], r["spent"]))
        k += 1
    return out


def totals(batches: List[Batch]) -> Dict[str, float]:
    """The window's seconds and rates."""
    seconds = batches[-1].t1 - batches[0].t0
    rows = sum(b.rows for b in batches)
    return {"seconds": seconds, "rows": rows, "batches": len(batches),
            "solves_per_s": rows / seconds,
            "executed_share": sum(b.executed for b in batches) / rows,
            "failed": sum(b.failed for b in batches),
            "restarts_per_problem": sum(b.spent for b in batches) / rows}
