"""Device milliseconds of the NCCL kernels on rank 0 per round of the traced
batch; nothing where no collective ran."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["nccl_s"] or not rec.get("traced_rounds"):
        return None
    return 1e3 * t["nccl_s"] / rec["traced_rounds"]
