"""Device milliseconds of the operations launched inside ``elbo_forward`` and
``elbo_backward`` (the model: GP, pathwise draw, collision likelihood), per
Adam step."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["steps"]:
        return None
    return 1e3 * sum(t["per_span"][s]["device_s"] for s in ("elbo_forward", "elbo_backward")) / t["steps"]
