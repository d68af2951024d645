"""The backup kernel's share of its roofline in the profiled cycle of
self-play: the least time of its bytes (32 per path edge, 36 per game and
launch; ``counting``) at the card's HBM bandwidth, over the kernel's
device time in the trace."""

from azbench import peaks


def read(rec):
    if rec is None or rec.counters.get("driver") != "selfplay":
        return None
    t = rec.kernel_s.get("backup_kernel", 0.0)
    if t <= 0:
        return None
    return 100.0 * rec.counters["backup_bytes"] / peaks.HBM_BYTES_PER_S / t
