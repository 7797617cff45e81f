"""Restarts the adaptive engine spends per problem: slots over problems,
summed over the window's batches (``info["spent"]`` of ``solve_adaptive``)."""


def read(rec):
    return rec["window"]["restarts_per_problem"]
