"""The collision stage (forward and d/dq through ``model.collision.log_prob``)
against its least time on an H100 (``benchmark/work/k1.py``), in %."""


def read(rec):
    s = rec.get("stages", {}).get("k1")
    if not s or not s.get("ms"):
        return None
    return 100.0 * s["least_s"] * 1e3 / s["ms"]
