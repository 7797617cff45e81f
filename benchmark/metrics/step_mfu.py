"""The Adam steps' least time on an H100 (``benchmark/work/step.py``, each
term at its dtype's peak) over the host time of their spans ``elbo_forward``,
``elbo_backward`` and ``adam_update`` in the traced batch, in %. (The
profiler's own cost is in those spans.)"""

STEP = ("elbo_forward", "elbo_backward", "adam_update")


def read(rec):
    t, s = rec.get("trace"), rec.get("step")
    if not t or not s:
        return None
    host_s = sum(t["span_s"][n] for n in STEP)
    return 100.0 * s["least_s"] / host_s if host_s else None
