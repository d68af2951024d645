"""The network's share of the card's peak in the profiled cycle of
self-play: the least time its forwards need (every conv and dense layer's
operations times the rows forwarded; the tower at the peak of its
precision, the rest at bfloat16's) over the cycle's wall time."""

from azbench import counting


def read(rec):
    if rec is None or rec.counters.get("driver") != "selfplay":
        return None
    least = counting.forward_least_s(rec.cfg, rec.counters["rows"],
                                     rec.counters["tower_precision"])
    return 100.0 * least / rec.window_s
