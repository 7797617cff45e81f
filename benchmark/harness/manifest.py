"""``BENCHMARK.json`` and the files it names: a cell's configuration, traffic
mix, correctness limits and metrics, found by name.

Every name (configuration, traffic mix, cell, metric) is made of letters,
digits, ``_``, ``.`` and ``-``; a unit also takes ``/`` and ``%``. A cell
``<cell>`` reads ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``workloads/<cell>.json``; a per-layer metric ``<metric>`` is read by
``metrics/<metric>.py``. Adding a cell, a configuration or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
# The keys each entry has, and those it may add.
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}
TOP = {"command", "paths", "run_seconds", *KEYS}


class ManifestError(ValueError):
    """A manifest or a file it names that breaks the benchmark's rules."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ManifestError(f"{what} {name!r}: a name is 1 to 64 letters, digits, '_', '.' and '-', "
                            "not starting with '.' or '-'")
    return name


def check_unit(unit: str, what: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise ManifestError(f"{what}: unit {unit!r} is not 1 to 16 letters, digits, '_', '/', '%', "
                            "'.' and '-'")
    return unit


def load(root: Path = ROOT) -> Dict:
    """The manifest at ``root``, its names and units checked."""
    path = Path(root) / "BENCHMARK.json"
    if not path.exists():
        raise ManifestError(f"no manifest at {path}")
    m = json.loads(path.read_text())
    if set(m) != TOP:
        raise ManifestError(f"the manifest's keys are {sorted(TOP)}, not {sorted(m)}")
    for group, (needs, may) in KEYS.items():
        for x in m[group]:
            if not needs <= set(x) <= needs | may:
                raise ManifestError(f"{group} entry {x.get('name')!r}: keys {sorted(x)}, where it needs "
                                    f"{sorted(needs)} and may add {sorted(may)}")
    for c in m["configs"]:
        check_name(c["name"], "configuration")
    for w in m["workloads"]:
        for k in ("name", "config", "traffic"):
            check_name(w[k], f"workload {k}")
    for group in ("end_to_end", "per_layer"):
        for x in m[group]:
            check_name(x["name"], f"{group} metric")
            check_unit(x["unit"], f"metric {x['name']}")
            if x["better"] not in ("lower", "higher"):
                raise ManifestError(f"metric {x['name']}: better is 'lower' or 'higher'")
    names = [x["name"] for g in ("end_to_end", "per_layer") for x in m[g]]
    for what, seq in (("metric", names), ("workload", [w["name"] for w in m["workloads"]]),
                      ("configuration", [c["name"] for c in m["configs"]])):
        if len(set(seq)) != len(seq):
            raise ManifestError(f"two of the {what}s share a name")
    return m


def _json(path: Path, what: str) -> Dict:
    if not path.exists():
        raise ManifestError(f"{what}: no file {path}")
    return json.loads(path.read_text())


def _reports(metric: Dict, cell: str, e2e: List[str]) -> bool:
    listed = metric.get("workloads")
    if listed is not None:
        return cell in listed
    return metric.get("moves", metric["name"]) in e2e


def cell(m: Dict, name: str, root: Path = ROOT) -> Dict:
    """Everything one cell runs with: its manifest entry, configuration,
    traffic mix, limits and the metrics it reports."""
    w = next((w for w in m["workloads"] if w["name"] == check_name(name, "workload")), None)
    if w is None:
        raise ManifestError(f"no workload {name!r} in the manifest")
    c = next((c for c in m["configs"] if c["name"] == w["config"]), None)
    if c is None:
        raise ManifestError(f"workload {name}: no configuration {w['config']!r}")
    bench = Path(root) / "benchmark"
    e2e = [x for x in m["end_to_end"] if _reports(x, name, [y["name"] for y in m["end_to_end"]])]
    e2e_names = [x["name"] for x in e2e]
    return {
        "workload": w,
        "config": _json(Path(root) / c["file"], f"configuration {c['name']}"),
        "traffic": _json(bench / "traffic" / f"{w['traffic']}.json", f"traffic {w['traffic']}"),
        "limits": _json(bench / "workloads" / f"{name}.json", f"workload {name}")["limits"],
        "end_to_end": e2e,
        "per_layer": [x for x in m["per_layer"] if _reports(x, name, e2e_names)],
    }
