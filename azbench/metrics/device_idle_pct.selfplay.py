"""The share of the profiled self-play cycle in which no device operation
ran: 100 × (1 − the union of device activity over the window)."""


def read(rec):
    if rec is None or rec.counters.get("driver") != "selfplay":
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
