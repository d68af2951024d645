"""Device operations (kernels, copies, fills) in the profiled player
moves, per simulation of the one game."""


def read(rec):
    if rec is None or rec.counters.get("driver") != "play":
        return None
    return rec.device_events / rec.counters["sims"]
