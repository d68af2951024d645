"""The player's host time inside the search per simulation: the
``search`` span's host milliseconds in the host window (``trace_moves``
moves with the program's tracing on and no profiler, ``spans``) over the
``search.simulations`` the program counted there."""

from azbench import spans


def read(rec):
    if rec is None or rec.counters.get("driver") != "play":
        return None
    f = spans.of(rec)
    if f is None:
        return None
    host = f["host"]
    search = host["spans"].get("search")
    sims = host["counters"].get("search.simulations")
    if not search or not sims:
        return None
    return 1e3 * search["host_s"] / sims
