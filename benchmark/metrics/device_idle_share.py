"""The share of the traced batch's wall time in which no device operation
ran, in %."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
