"""Putting a traced window's device work and idle time down to the
program's spans (``azbench/spans.py``), on hand-made host and device event
lists, and the five readers of the span figures on hand-made records."""

import pytest

from azbench import registry, spans
from azbench.common import TraceRecord

# Host events (name, start_ns, end_ns, correlation) of a window [0, 1000]:
# a search with a descend stage and a network stage; an ATen operation
# whose own correlation id equals a launch's; launches of operations 1-3,
# none of operation 4.
HOST = [
    ("search", 100, 600, 0),
    ("search.descend", 110, 200, 0),
    ("cudaLaunchKernel", 120, 125, 1),
    ("search.network", 300, 500, 0),
    ("aten::_int_mm", 310, 400, 3),
    ("cuLaunchKernel", 320, 330, 2),
    ("cudaMemcpyAsync", 700, 710, 3),
]
DEVICE = [
    ("descend_kernel", 150, 250, 1),  # in search.descend
    ("gemm_s8", 400, 550, 2),  # in search.network, below the ATen op
    ("elementwise", 520, 560, 4),  # no launch: placed by its start, 520
    ("memcpy", 750, 800, 3),  # launched outside every span
]
NAMES = ("search", "search.descend", "search.network")


def test_operations_go_to_the_innermost_span_open_at_their_launch():
    own, unlaunched = spans.owners(HOST, DEVICE, NAMES)
    assert own == ["search.descend", "search.network", "search",
                   spans.OUTSIDE]
    assert unlaunched == 1
    # Ranges of other names nest inside a span without taking its place.
    own, _ = spans.owners(HOST, DEVICE, ["aten::_int_mm"])
    assert own == [spans.OUTSIDE, "aten::_int_mm", spans.OUTSIDE,
                   spans.OUTSIDE]


def test_idle_gaps_go_to_the_span_of_the_operation_ending_them():
    got = spans.attribute(HOST, DEVICE, NAMES, (0, 1000))
    ns = 1e-9
    want = {
        # The leading gap [0, 150) ends at the descend kernel.
        "search.descend": dict(calls=1, device_s=100 * ns, ops=1,
                               idle_s=150 * ns),
        "search.network": dict(calls=1, device_s=150 * ns, ops=1,
                               idle_s=150 * ns),
        # Overlapping the GEMM, the unlaunched operation ends no gap.
        "search": dict(calls=1, device_s=40 * ns, ops=1, idle_s=0.0),
        # The gap [560, 750) and the trailing gap [800, 1000).
        spans.OUTSIDE: dict(calls=0, device_s=50 * ns, ops=1,
                            idle_s=390 * ns),
    }
    assert got.keys() == want.keys()
    for name, f in want.items():
        assert got[name]["calls"] == f["calls"]
        assert got[name]["ops"] == f["ops"]
        assert got[name]["device_s"] == pytest.approx(f["device_s"])
        assert got[name]["idle_s"] == pytest.approx(f["idle_s"])


def test_sums_equal_the_windows_totals():
    got = spans.attribute(HOST, DEVICE, NAMES, (0, 1000))
    busy = (250 - 150) + (560 - 400) + (800 - 750)
    assert sum(f["ops"] for f in got.values()) == len(DEVICE)
    assert sum(f["device_s"] for f in got.values()) == pytest.approx(
        sum(e - s for _, s, e, _ in DEVICE) * 1e-9)
    assert sum(f["idle_s"] for f in got.values()) == pytest.approx(
        (1000 - busy) * 1e-9)


def test_nested_spans_of_one_name_and_siblings():
    host = [("search", 0, 100, 0), ("search.expand", 10, 40, 0),
            ("search.install", 50, 60, 0), ("search", 200, 300, 0),
            ("search.expand", 210, 220, 0)]
    host += [("cudaLaunchKernel", t, t + 1, c) for c, t in
             enumerate((5, 15, 45, 55, 150, 215, 250), start=1)]
    device = [(f"k{c}", 1000 + 10 * c, 1005 + 10 * c, c)
              for c in range(1, 8)]
    own, _ = spans.owners(host, device, ["search", "search.expand",
                                         "search.install"])
    assert own == ["search", "search.expand", "search", "search.install",
                   spans.OUTSIDE, "search.expand", "search"]
    got = spans.attribute(host, device, ["search", "search.expand",
                                         "search.install"], (0, 2000))
    assert got["search"]["calls"] == 2
    assert got["search.expand"]["calls"] == 2
    # Everything before the first operation is the first operation's gap.
    assert got["search"]["idle_s"] == pytest.approx((1010 + 5 + 5) * 1e-9)
    assert got[spans.OUTSIDE]["idle_s"] == pytest.approx(
        (5 + 2000 - 1075) * 1e-9)


# -------------------------------------------------------------------------
# The readers, on hand-made records.

def _figures(network=True):
    f = {"window_s": 2.0, "counters": {"search.simulations": 100,
                                       "network.rows": 204800},
         "spans": {
             "search": dict(calls=4, device_s=0.01, ops=9, idle_s=0.1),
             "search.expand": dict(calls=100, device_s=0.3, ops=99,
                                   idle_s=0.2),
             "search.network": dict(calls=100, device_s=0.5, ops=99,
                                    idle_s=0.05),
             spans.OUTSIDE: dict(calls=0, device_s=0.1, ops=9, idle_s=0.4)}}
    if not network:
        del f["spans"]["search.network"]
    return f


def _record(driver, figures):
    counters = {"driver": driver, "spans": figures}
    if driver == "selfplay":
        counters["tower_precision"] = "int8"
    return TraceRecord(cfg=registry.config("connect4"), window_s=3.0,
                       busy_s=1.0, device_events=10, kernel_s={},
                       counters=counters, breakdown={})


def _read(name, rec):
    return registry.metric_reader(name)(rec)


def test_search_idle_pct_readers():
    for driver in ("selfplay", "play"):
        other = "play" if driver == "selfplay" else "selfplay"
        name = f"search_idle_pct.{driver}"
        assert _read(name, _record(driver, _figures())) == pytest.approx(
            100 * (0.1 + 0.2 + 0.05) / 2.0)
        assert _read(name, _record(other, _figures())) is None
        assert _read(name, _record(driver, None)) is None


def test_expand_device_ms_reader():
    name = "expand_device_ms.selfplay"
    assert _read(name, _record("selfplay", _figures())) == pytest.approx(
        3.0)
    assert _read(name, _record("play", _figures())) is None
    assert _read(name, _record("selfplay", None)) is None


def test_network_roofline_reader():
    name = "network_roofline.selfplay"
    # connect4, a row: the tower 16 convs of 2·42·9·128·128 = 198,180,864
    # int8 operations; the stem 387,072, the value head 3,622,400 and the
    # policy head 3,110,912 bf16 ones.
    least = 204800 * (198_180_864 / 1979e12 + 7_120_384 / 989e12)
    assert _read(name, _record("selfplay", _figures())) == pytest.approx(
        100 * least / 0.5)
    assert _read(name, _record("play", _figures())) is None
    # A search whose stages no longer fire (replayed from a graph).
    assert _read(name, _record("selfplay", _figures(network=False))) is None


def test_search_host_ms_reader():
    name = "search_host_ms.play"
    f = dict(_figures(), host={
        "window_s": 3.0, "counters": {"search.simulations": 400},
        "spans": {"search": {"calls": 2, "host_s": 2.8}}})
    assert _read(name, _record("play", f)) == pytest.approx(7.0)
    assert _read(name, _record("selfplay", f)) is None
    assert _read(name, _record("play", None)) is None


def test_a_record_without_span_figures_reads_none_without_a_card():
    rec = _record("selfplay", None)
    del rec.counters["spans"]
    assert spans.of(rec) is None
    assert rec.counters["spans"] is None
