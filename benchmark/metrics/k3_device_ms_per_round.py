"""Device milliseconds of K3 a round: every ``clearance_tile_kernel``
operation of the traced batch (both entries: the metric's clearance and its
probes, and the restarts' probes), over the batch's rounds with a
``validate`` span. The operations are found by kernel name."""

NAME = "clearance_tile_kernel"


def read(rec):
    t = rec.get("trace")
    if not t or not t["validate_s"]:
        return None
    s = sum(v for n, v in t["ops_by_name"].items() if NAME in n)
    return 1e3 * s / len(t["validate_s"]) if s else None
