"""The expand stage's device time per batch simulation in the self-play
span window (one cycle, ``spans``): the device milliseconds put down to
the ``search.expand`` span over the ``search.simulations`` the program
counted."""

from azbench import spans


def read(rec):
    if rec is None or rec.counters.get("driver") != "selfplay":
        return None
    f = spans.of(rec)
    if f is None:
        return None
    expand = f["spans"].get("search.expand")
    sims = f["counters"].get("search.simulations")
    if not expand or not sims:
        return None
    return 1e3 * expand["device_s"] / sims
