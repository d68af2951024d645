"""Device operations (kernels, copies, fills) in the profiled cycle of
self-play, per batch simulation (one simulation of every game)."""


def read(rec):
    if rec is None or rec.counters.get("driver") != "selfplay":
        return None
    return rec.device_events / rec.counters["batch_sims"]
