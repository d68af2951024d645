"""The share of the profiled player moves in which no device operation
ran."""


def read(rec):
    if rec is None or rec.counters.get("driver") != "play":
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
