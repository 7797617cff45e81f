"""The CPU side of the design tools that time K1 and K6 and read the
kernels' machine code on the card (``tools/k1_designs.py``,
``tools/k6_designs.py``, ``tools/kernel_resources.py``): how ``--configs``
cuts the configs into σ rows, how ``--variant`` writes a K6 header, and how
``--against`` pairs each kernel with its older version."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import k1_designs  # noqa: E402
import kernel_resources  # noqa: E402


@pytest.mark.parametrize("n,rows", [(36000, 36), (33792, 33), (1000, 1), (1293, 1), (2013, 3), (7, 1)])
def test_configs_keep_whole_rows(n, rows):
    """The σ rows of the first ``n`` configs: the largest divisor of ``n`` at
    most ``ceil(n / 1000)``, so every row holds ``n // rows`` configs (36 000
    configs are the smoke's 36 rows of 1 000; 33 792, two waves of 32-config
    tiles at four blocks an SM, are 33 rows of 1 024)."""
    assert k1_designs.rows_of(n) == rows
    assert n % rows == 0 and rows <= -(-n // 1000)


def test_against_pairs_each_kernel_with_its_older_version(capsys):
    """``--against``: a kernel (matched by its demangled name, since the
    mangled name of an anonymous namespace's kernel differs between two
    files) whose SASS hash is the older version's is ``same SASS``, one
    whose hash moved is ``changed``, one the older version lacks is a new
    kernel; registers and spills of both beside."""
    new, old = Path("new/k1_trilinear.cu"), Path("old/k1_trilinear.cu")

    def row(name, regs, spill, sha, tu):
        # a kernel in an anonymous namespace: its mangled name carries its file's hash
        return {"mangled": f"_GLOBAL__N_{tu}_{name}", "kernel": name, "registers": regs,
                "spill_store_bytes": spill, "sass_sha256": sha}

    rec = {str(new): [row("a", 48, 0, "x", 1), row("b", 64, 0, "y", 1), row("c", 40, 0, "z", 1)],
           str(old): [row("a", 48, 0, "x", 2), row("b", 76, 12, "w", 2)]}
    out = kernel_resources.compare(rec, [new], Path("old"))
    assert [(r["kernel"], r["same_sass"], r["old_registers"], r["old_spill_store_bytes"]) for r in out] == [
        ("a", True, 48, 0), ("b", False, 76, 12), ("c", False, None, None)]
    text = capsys.readouterr().out
    assert "same SASS" in text and "changed" in text and "new kernel" in text


def test_k6_variant_changes_only_the_named_constants(tmp_path, monkeypatch):
    """``k6_designs.py --variant NAME:CONST=VALUE,...`` writes the checkout's
    K6 header with those constants of ``namespace k6`` changed and nothing
    else; a name that is no such constant is refused."""
    import k6_designs

    monkeypatch.setattr(k6_designs, "BUILD", tmp_path)
    src = (k6_designs.CSRC / "k6_rff.cuh").read_text()
    got = k6_designs.variant("v", "BT=2,FWD_THREADS=256").read_text()
    assert "constexpr int BT = 2;" in got and "constexpr int FWD_THREADS = 256;" in got
    assert got.replace("BT = 2;", "BT = 4;").replace("FWD_THREADS = 256;", "FWD_THREADS = 128;") == src
    with pytest.raises(ValueError, match="no constant"):
        k6_designs.variant("w", "NOT_A_CONSTANT=1")
