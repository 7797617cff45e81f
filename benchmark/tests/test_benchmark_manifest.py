"""The manifest: cells, configurations, traffic and metrics found by name,
names and units held to their characters, and a cell added with new files
and one new entry alone."""

import hashlib
import json
import shutil

import pytest

from benchmark.harness import manifest
from benchmark.tests.conftest import ROOT


def test_every_cell_and_metric_is_found_by_name():
    m = manifest.load(ROOT)
    for w in m["workloads"]:
        c = manifest.cell(m, w["name"], ROOT)
        assert c["config"]["name"] == w["config"]
        assert c["traffic"]["rows"] > 0
        assert set(c["limits"]) == {"elbo_gap", "grad_gap", "change_gap", "best_gap", "verdict_mismatch",
                                    "choice_mismatch"}
        assert {x["name"] for x in c["end_to_end"]} == {"solves_per_s", "executed_share", "setup_s"}
        assert c["per_layer"], "every cell reports a per-layer metric"
        for x in c["per_layer"]:
            assert (ROOT / "benchmark" / "metrics" / f"{x['name']}.py").exists()
    one = manifest.cell(m, "franka-industrial-b512", ROOT)
    assert "validate_ms_per_round" in {x["name"] for x in one["per_layer"]}


@pytest.mark.parametrize("bad", ["a b", "x/y", ".hidden", "-x", "", "é", "a" * 65, "a,b"])
def test_names_are_refused_with_other_characters(bad):
    with pytest.raises(manifest.ManifestError):
        manifest.check_name(bad, "test")


@pytest.mark.parametrize("bad", ["tokens per s", "", "a" * 17, "µs", "ms\t"])
def test_units_are_refused_with_other_characters(bad):
    with pytest.raises(manifest.ManifestError):
        manifest.check_unit(bad, "test")


@pytest.mark.parametrize("good", ["solves/s", "%", "ms", "slots/problem", "share"])
def test_units_of_the_manifest_pass(good):
    assert manifest.check_unit(good, "test") == good


def test_a_bad_name_in_the_manifest_is_refused(tmp_path):
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["workloads"][0]["name"] = "franka industrial"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    with pytest.raises(manifest.ManifestError):
        manifest.load(tmp_path)


@pytest.mark.parametrize("group,drop,add", [
    ("configs", "why", None), ("configs", None, "notes"), ("workloads", "chips", None),
    ("end_to_end", "bound", None), ("per_layer", "layer", None), ("per_layer", None, "why")])
def test_an_entry_with_other_keys_is_refused(tmp_path, group, drop, add):
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = m[group][0]
    if drop:
        del entry[drop]
    if add:
        entry[add] = "x"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    with pytest.raises(manifest.ManifestError):
        manifest.load(tmp_path)


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_new_files_and_one_entry(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digest(tmp_path)
    (tmp_path / "benchmark/traffic/b768.json").write_text(json.dumps(
        {"rows": 768, "round_sizes": [768, 192, 96], "pool": 2, "why": "a test's cell"}))
    (tmp_path / "benchmark/workloads/wam-industrial-b768.json").write_text(
        (tmp_path / "benchmark/workloads/wam-industrial-b1024.json").read_text())
    m["workloads"].append({"name": "wam-industrial-b768", "config": "wam-industrial", "traffic": "b768",
                           "chips": 1, "why": "a test's cell"})
    for x in m["per_layer"]:
        if "wam-industrial-b1024" in x.get("workloads", []):
            x["workloads"].append("wam-industrial-b768")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    c = manifest.cell(manifest.load(tmp_path), "wam-industrial-b768", tmp_path)
    assert c["traffic"]["rows"] == 768 and c["config"]["robot"] == "wam"
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"benchmark/traffic/b768.json", "benchmark/workloads/wam-industrial-b768.json"}
