"""Device operations launched inside an Adam step's spans, per step."""

STEP = ("elbo_forward", "elbo_backward", "adam_update")


def read(rec):
    t = rec.get("trace")
    if not t or not t["steps"]:
        return None
    return sum(t["per_span"][s]["ops"] for s in STEP) / t["steps"]
