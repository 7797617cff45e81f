"""Host milliseconds of an Adam step: the spans ``elbo_forward``,
``elbo_backward`` and ``adam_update`` of the traced batch, over its steps."""

STEP = ("elbo_forward", "elbo_backward", "adam_update")


def read(rec):
    t = rec.get("trace")
    if not t or not t["steps"]:
        return None
    return 1e3 * sum(t["span_s"][s] for s in STEP) / t["steps"]
