"""The descend kernel's share of its roofline in the profiled cycle of
self-play: the least time of the bytes its walks need (``counting``; the
walks of one search of each kind after the window) at the card's HBM
bandwidth, over the kernel's device time in the trace."""

from azbench import peaks


def read(rec):
    if rec is None or rec.counters.get("driver") != "selfplay":
        return None
    t = rec.kernel_s.get("descend_kernel", 0.0)
    if t <= 0:
        return None
    return 100.0 * rec.counters["descend_bytes"] / peaks.HBM_BYTES_PER_S / t
