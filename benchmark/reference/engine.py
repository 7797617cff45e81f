"""Plain reference of the adaptive restart engine's bookkeeping: which
problems each round re-attacks, and which restart each problem keeps.

Given the rounds a batch ran (the queries each round was handed and the
trajectories and verdicts it returned), :func:`replay` works out again which
slots every round should have held and each problem's best restart, and
counts where the batch's answer departs from that.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def score(executed, success, min_clearance) -> np.ndarray:
    """The restart score, in float32: execution first, then the geometric
    verdict, then the worst clearance (clipped to ±8 m) as the tie-breaker;
    a NaN score is −inf."""
    f = lambda x: np.asarray(x).astype(np.float32)
    s = f(executed) * np.float32(4) + f(success) * np.float32(2) + np.clip(f(min_clearance), -8, 8) / np.float32(16)
    return np.where(np.isnan(s), np.float32(-np.inf), s).astype(np.float64)


def bucket_sizes(B: int, round_sizes: Sequence[int], mult: int) -> List[int]:
    """The round sizes rounded up to a multiple of the dp ranks and capped at
    the batch, largest first."""
    up = lambda c: -(-c // mult) * mult
    return sorted({min(up(c), up(B)) for c in round_sizes}, reverse=True)


def replay(starts: np.ndarray, goals: np.ndarray, rounds: List[Dict], max_rounds: int,
           round_sizes: Sequence[int], mult: int, answer: Dict) -> Dict[str, int]:
    """``rounds``: each ``{"starts", "goals", "best", "executed", "success",
    "min_clearance"}`` as the round solver was handed and returned them;
    ``answer``: the batch's ``{"best", "executed", "success",
    "min_clearance"}``. Returns the count of rounds whose slots differ from
    the rule's, of problems whose kept answer differs, and whether the
    number of rounds is the rule's."""
    B = len(starts)
    sizes = bucket_sizes(B, round_sizes, mult)
    fields = ("executed", "success", "min_clearance")
    bad_slots = 0
    best = best_score = merged = None
    expected_rounds = max_rounds
    for rnd in range(max_rounds):
        if rnd == 0:
            slots = np.arange(B)
        else:
            unsolved = np.nonzero(~merged["executed"])[0]
            if unsolved.size == 0:
                expected_rounds = rnd
                break
            want = min(unsolved.size, sizes[0])
            C = next((c for c in sorted(sizes) if c >= want), sizes[0])
            slots = unsolved[(np.arange(C) + rnd * C) % unsolved.size]
        if rnd >= len(rounds):
            break
        r = rounds[rnd]
        if (len(r["starts"]) != len(slots) or not np.array_equal(r["starts"], starts[slots])
                or not np.array_equal(r["goals"], goals[slots])):
            bad_slots += 1
            continue
        sc = score(r["executed"], r["success"], r["min_clearance"])
        if merged is None:
            best, best_score = np.array(r["best"], copy=True), sc
            merged = {k: np.array(r[k], copy=True) for k in fields}
            continue
        keep: Dict[int, int] = {}
        for j in np.argsort(sc, kind="stable"):
            keep[int(slots[j])] = int(j)
        probs = np.fromiter(keep.keys(), dtype=int)
        js = np.fromiter(keep.values(), dtype=int)
        up = sc[js] > best_score[probs]
        probs, js = probs[up], js[up]
        best_score[probs] = sc[js]
        best[probs] = r["best"][js]
        for k in fields:
            merged[k][probs] = r[k][js]
    if merged is None:
        return {"slots": bad_slots, "answers": B, "rounds": int(len(rounds) != expected_rounds)}
    same = np.ones(B, dtype=bool)
    for k in fields:
        same &= _equal(merged[k], answer[k])
    same &= np.array([_equal(best[i], answer["best"][i]).all() for i in range(B)])
    return {"slots": bad_slots, "answers": int((~same).sum()),
            "rounds": int(len(rounds) != expected_rounds)}


def _equal(a, b) -> np.ndarray:
    a, b = np.asarray(a), np.asarray(b)
    eq = (a == b)
    if np.issubdtype(a.dtype, np.floating):
        eq |= np.isnan(a) & np.isnan(b)
    return eq
