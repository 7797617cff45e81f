"""Device milliseconds from the first to the last device operation launched
inside each round's ``validate`` span (the metric of the round's rows),
averaged over the traced batch's rounds."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["validate_s"]:
        return None
    return 1e3 * sum(t["validate_s"]) / len(t["validate_s"])
