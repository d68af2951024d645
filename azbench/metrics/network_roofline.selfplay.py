"""The network's share of its roofline where it runs, in the self-play
span window (one cycle, ``spans``): the least time its forwards need
(``counting.forward_least_s`` of the ``network.rows`` the program counted:
the tower at its precision's peak, the rest at bfloat16's) over the device
seconds put down to the ``search.network`` span."""

from azbench import counting, spans


def read(rec):
    if rec is None or rec.counters.get("driver") != "selfplay":
        return None
    f = spans.of(rec)
    if f is None:
        return None
    net = f["spans"].get("search.network")
    rows = f["counters"].get("network.rows")
    if not net or net["device_s"] <= 0 or not rows:
        return None
    least = counting.forward_least_s(rec.cfg, rows,
                                     rec.counters["tower_precision"])
    return 100.0 * least / net["device_s"]
