"""The pathwise draw and evaluation (``gp.pathwise.draw_and_eval_paths``)
against its least time on an H100 (``benchmark/work/rff.py``), in %."""


def read(rec):
    s = rec.get("stages", {}).get("rff")
    if not s or not s.get("ms"):
        return None
    return 100.0 * s["least_s"] * 1e3 / s["ms"]
