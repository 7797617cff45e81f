"""Device milliseconds of K1 a step: every ``loglik_tile_kernel`` operation
(the collision likelihood and its d/dq, in the steps and the extraction) and
every ``dsigma_kernel`` one (K1's d/dσ) of the traced batch, over its Adam
steps. The operations are found by kernel name, so the reader reads any
version of the program."""

NAMES = ("loglik_tile_kernel", "dsigma_kernel")


def read(rec):
    t = rec.get("trace")
    if not t or not t["steps"]:
        return None
    s = sum(v for n, v in t["ops_by_name"].items() if any(k in n for k in NAMES))
    return 1e3 * s / t["steps"] if s else None
