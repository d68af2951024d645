"""The program's own spans, read from the device trace's clock.

The port wraps each ``search()`` call and each stage of a simulation in a
span of its ``utils.trace`` (``search``, ``search.descend``,
``search.expand``, ``search.network``, ``search.install``,
``search.backup``) and counts a search's work at its entry
(``search.simulations``, ``network.rows``). With the program's tracing on
under a ``torch.profiler``, each span is a ``record_function`` range on the
clock of the trace's device events.

``attribute`` puts down a traced window's device operations and idle time
to those spans: each operation to the innermost span open when the host
launched it (the launch event of the same correlation id), each idle gap to
the span under which the operation ending it was launched, the gap before
the first operation to that operation's span, the gap after the last one to
``outside``. The sums equal the window's own.

``of(record)`` gives a traced run's span figures to the per-layer metrics
that read them (``record.counters["spans"]``). The drivers' files predate
the spans, so where a driver has not filled that key the first reader runs
the span windows itself, once, after the run's own windows and check, in
the same process and on the cell's configuration and traffic mix: the
driver's loop of moves through the same program calls, from inputs made
from a seed of its own (the record carries no run seed).

* ``selfplay``: two cycles from the start (so the records drain
  ``record_lag`` moves behind, as in the run's traced cycle), then one cycle
  profiled, the span window.
* ``play``: one move, then ``trace_moves`` moves profiled (the span
  window), then ``trace_moves`` moves with the program's tracing on and no
  profiler (the host window), for the spans' host times without the
  profiler's recording. An earlier profile still leaves the process's
  launches slower (30-40% on the card's host), so these read above an
  untraced run's.

A span window's profiler records the device's activity, the CUDA runtime's
calls and the program's ranges, and not every host operation
(``_ranges_only``). A commit whose program has no spans gives ``None``, and
so does every reader. Each window prints one line a span on standard error:
``span <name> calls <n> host_ms <x> device_ms <y> ops <k> idle_ms <z>``,
then the sums against the window's own, where the search kernels' and the
GEMMs' device time went, each span's costliest device operations, the
counters and the steps' times.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import time
from collections import deque

import torch

from azbench import checks, program as P, registry, weights
from azbench.common import Context
from azbench.profiling import Traced

OUTSIDE = "outside"
WINDOW = "azbench.span_window"
#: The span windows' own seed: their weights, calibration, openings and
#: draws come from its sub-seeds.
SEED = 2 ** 31 + 1717
#: Kernels, by a part of their name, whose device time is shown by span:
#: the search's own and the network's GEMMs (the int8 tower's ``_int_mm``
#: among them).
KERNELS = ("descend", "backup", "gemm")
#: Device operations shown for each span, those that took most, and the
#: characters of their names kept.
TOP = 4
NAME_CHARS = 90


def owners(host: list, device: list, names) -> tuple:
    """(for each device operation, the innermost range of ``names`` open
    when the host launched it, else ``OUTSIDE``; the number of operations
    whose correlation id has no launch event, which are placed by their
    own start). ``host`` and ``device`` are [(name, start_ns, end_ns,
    correlation)]; ranges of ``names`` nest, as one thread's do."""
    names = set(names)
    ranges = sorted((s, -e, n) for n, s, e, _ in host if n in names)
    launch = {}
    for n, s, _, c in host:
        if c and n.startswith("cu") and s < launch.get(c, float("inf")):
            launch[c] = s
    unlaunched = 0
    at = []
    for i, (_, s, _, c) in enumerate(device):
        t = launch.get(c)
        if t is None:
            unlaunched += 1
            t = s
        at.append((t, i))
    at.sort()
    out = [OUTSIDE] * len(device)
    stack, j = [], 0
    for t, i in at:
        while j < len(ranges) and ranges[j][0] <= t:
            stack.append(ranges[j])
            j += 1
        while stack and -stack[-1][1] < t:
            stack.pop()
        if stack:
            out[i] = stack[-1][2]
    return out, unlaunched


def attribute(host: list, device: list, names, window: tuple,
              own=None) -> dict:
    """{span: {"calls", "device_s", "ops", "idle_s"}} for each of ``names``
    and ``OUTSIDE``, over the window [start_ns, end_ns] of the trace's
    clock; ``device`` sorted by start, every operation inside the window;
    ``own`` the operations' ``owners`` where already found. Device seconds
    and operations sum to the window's, idle seconds to the window's length
    less the union of device activity."""
    if own is None:
        own, _ = owners(host, device, names)
    names = set(names)
    out = {n: {"calls": 0, "device_s": 0, "ops": 0, "idle_s": 0}
           for n in names | {OUTSIDE}}
    for n, _, _, _ in host:
        if n in names:
            out[n]["calls"] += 1
    cur = window[0]
    for (_, s, e, _), o in zip(device, own):
        f = out[o]
        f["device_s"] += e - s
        f["ops"] += 1
        if s > cur:
            f["idle_s"] += s - cur
        cur = max(cur, e)
    out[OUTSIDE]["idle_s"] += max(window[1] - cur, 0)
    for f in out.values():
        f["device_s"] /= 1e9
        f["idle_s"] /= 1e9
    return out


def of(rec):
    """The span figures of a traced run's record, run on the first call
    (see the module's docstring); None where the program has no spans, the
    record is no cell's or there is no card."""
    if rec is None:
        return None
    if "spans" not in rec.counters:
        rec.counters["spans"] = _run(rec)
    return rec.counters["spans"]


def search_idle_pct(figures) -> float | None:
    """100 × the idle seconds put down to ``search`` and its stages over
    the span window's length."""
    if figures is None or "search" not in figures["spans"]:
        return None
    idle = sum(f["idle_s"] for n, f in figures["spans"].items()
               if n == "search" or n.startswith("search."))
    return 100.0 * idle / figures["window_s"]


def _program_trace():
    """The program's ``utils.trace``, where it has spans."""
    mod = importlib.import_module(f"{P.PACKAGE}.utils.trace")
    return mod if hasattr(mod, "tracing") else None


def _cell(cfg: dict, driver: str):
    found = [w for w in registry.benchmark()["workloads"]
             if registry.traffic(w["traffic"])["driver"] == driver
             and registry.config(w["config"]) == cfg]
    return found[0] if len(found) == 1 else None


def _run(rec):
    tr = _program_trace()
    driver = rec.counters.get("driver")
    cell = _cell(rec.cfg, driver)
    if tr is None or cell is None or not torch.cuda.is_available():
        return None
    ctx = Context(cell=cell, cfg=rec.cfg,
                  traffic=registry.traffic(cell["traffic"]), seed=SEED,
                  seconds=0.0, trace=True, device=torch.device("cuda", 0),
                  t0=time.time())
    out = {"selfplay": _selfplay, "play": _play}[driver](ctx, tr)
    out["marks"] = ctx.marks
    _report(out)
    return out


@contextlib.contextmanager
def _ranges_only():
    """While a ``torch.profiler`` starts, have it record of the host's
    operations the ``record_function`` ranges alone (the CUDA runtime's
    calls come with the device's activity): recording every operation
    slows a player's move and a self-play cycle by 60-70% on the card's
    host, which would swell the idle time the spans are read for."""
    profiler = torch.autograd.profiler
    start = profiler._enable_profiler
    user = {torch._C._profiler.RecordScope.USER_SCOPE}
    profiler._enable_profiler = lambda config, activities, scopes=None: \
        start(config, activities, user)
    try:
        yield
    finally:
        profiler._enable_profiler = start


def _span_window(ctx, tr, body) -> dict:
    """``body()`` profiled with the program's tracing on, its counters
    reset at the start and read at the end: the figures of each span and
    ``OUTSIDE``."""
    tr.reset()
    traced = Traced(host_ops=True)
    with tr.tracing():
        with _ranges_only():
            traced.__enter__()
        with torch.profiler.record_function(WINDOW):
            body()
            torch.cuda.synchronize()
        traced.__exit__(None, None, None)
    ctx.mark("span window profiled")
    snap = tr.snapshot()
    tr.reset()
    host = traced.host
    (w0, w1), = [(s, e) for n, s, e, _ in host if n == WINDOW]
    names = sorted(snap["spans"])
    # The profiler also lays each range over the device's timeline (a user
    # annotation under the range's name): no device work.
    marks = set(names) | {WINDOW}
    device = [d for d in traced.device if d[0] not in marks]
    traced.device = device
    own, unlaunched = owners(host, device, names)
    spans = attribute(host, device, names, (w0, w1), own)
    for n in names:
        spans[n]["host_s"] = snap["spans"][n]["host_s"]
    top = {}
    for (name, s, e, _), o in zip(device, own):
        by = top.setdefault(o, {})
        by[name] = by.get(name, 0) + e - s
    window_s = (w1 - w0) / 1e9
    ctx.mark("span window read")
    return {"window_s": window_s, "spans": spans,
            "counters": snap["counters"], "unlaunched": unlaunched,
            "placed": {key: _tally(device, own, [key in d[0] for d in device])
                       for key in KERNELS},
            "top": {o: [[n[:NAME_CHARS], t / 1e9] for n, t in sorted(
                by.items(), key=lambda x: -x[1])[:TOP]]
                for o, by in top.items()},
            # The window's own totals, read apart from the attribution.
            "totals": {"device_s": sum(e - s for _, s, e, _ in device) / 1e9,
                       "ops": len(device),
                       "idle_s": window_s - traced.busy_s()}}


def _tally(device, own, mask) -> dict:
    """{span: device seconds} of the operations ``mask`` selects."""
    out = {}
    for (_, s, e, _), o, m in zip(device, own, mask):
        if m:
            out[o] = out.get(o, 0.0) + (e - s) / 1e9
    return out


def selfplay_cycles(ctx):
    """The cell's self-play as its driver runs it (the configuration's
    tower, its games, draws and records' drain): a function that plays one
    cycle of the mix's moves and returns its batch simulations."""
    from azbench.drivers import selfplay as D
    cfg, dev, traffic = ctx.cfg, ctx.device, ctx.traffic
    env, args = P.env(cfg), P.args(cfg)
    W = weights.make(cfg, ctx.seed_for("weights"), dev)
    model, _, _ = D._tower(ctx, P.wrapper(env, args, dev, W, cfg), W)
    sp_cfg, sp = P.selfplay(env, args)
    S = P.search_module()
    fns = sp.make_move_fns(env, sp_cfg, model)
    B, A = int(args.process_batch_size), env.ACTION_SIZE
    sims_of = {"fast": sp_cfg.sims_fast, "full": sp_cfg.sims_full}
    gen = ctx.generator("draws")
    lag = int(traffic["record_lag"])
    raw = deque()
    carry = sp.init_selfplay(env, B, sp_cfg.start_temp, device=dev,
                             cfg=sp_cfg)

    def drain(item):
        w, d, o, p, pidx, played = item
        w.cpu(), d.cpu(), int(played)
        if o is not None:
            o.cpu()
            p = p.cpu().numpy()
            if pidx is not None:
                sp.densify_pi(p, pidx.cpu().numpy(), A)

    def cycle():
        nonlocal carry
        for kind in traffic["cycle"]:
            gum, tie, gam = checks.search_draws(env, carry.env_state,
                                                sims_of[kind], gen)
            carry, rec = fns[kind](carry, gumbel=gum, search_draws=S.
                                   SearchDraws(tie=tie, gammas=gam))
            raw.append((rec.win_state, rec.done, rec.obs, rec.pi,
                        rec.pi_idx, carry.games_played))
            while len(raw) > lag:
                drain(raw.popleft())
        return sum(sims_of[k] for k in traffic["cycle"])

    return cycle


def _selfplay(ctx, tr) -> dict:
    cycle = selfplay_cycles(ctx)
    ctx.mark("program ready")
    cycle()
    cycle()
    ctx.mark("two cycles")
    return _span_window(ctx, tr, cycle)


def player_moves(ctx):
    """The cell's player as its driver runs it (its network, openings and
    draws): a function that plays ``count`` moves, a new opening where a
    game ends."""
    from azbench.drivers import play as D
    cfg, dev = ctx.cfg, ctx.device
    env, args = P.env(cfg), P.args(cfg)
    W = weights.make(cfg, ctx.seed_for("weights"), dev)
    player = P.mcts_player(P.wrapper(env, args, dev, W, cfg), env, args,
                           seed=ctx.seed_for("player"))
    S = P.search_module()
    sims = int(args.numMCTSSims)
    gen = ctx.generator("draws")
    games = D.openings(ctx, int(ctx.traffic["openings"]))
    game = 0

    def start():
        state = env.init(1, dev)
        for a in games[game % len(games)]:
            state = env.step(state, torch.tensor([a], dtype=torch.int32,
                                                 device=dev))
        return state

    state = start()

    def moves(count):
        nonlocal state, game
        for _ in range(count):
            _, tie, gam = checks.search_draws(env, state, sims, gen)
            a = player.play(state, draws=S.SearchDraws(tie=tie, gammas=gam))
            state = env.step(state, torch.tensor([a], dtype=torch.int32,
                                                 device=dev))
            if bool((env.win_state(state) > 0).any()):
                game += 1
                state = start()
                player.reset()

    return moves


def _play(ctx, tr) -> dict:
    moves = player_moves(ctx)
    n = int(ctx.traffic["trace_moves"])
    ctx.mark("program ready")
    moves(1)
    ctx.mark("one move")
    out = _span_window(ctx, tr, lambda: moves(n))
    tr.reset()
    torch.cuda.synchronize()
    with tr.tracing():
        t0 = time.perf_counter()
        moves(n)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    out["host"] = dict(tr.snapshot(), window_s=window_s)
    tr.reset()
    ctx.mark("host window")
    return out


def _report(f) -> None:
    host = f.get("host", f)
    lines = []
    for n in sorted(f["spans"]):
        s = f["spans"][n]
        if n == OUTSIDE:
            inner = host["spans"].get("search", {}).get("host_s", 0.0)
            host_ms = 1e3 * (host["window_s"] - inner)
        else:
            host_ms = 1e3 * host["spans"][n]["host_s"]
        lines.append(f"span {n} calls {s['calls']} host_ms {host_ms:.3f} "
                     f"device_ms {1e3 * s['device_s']:.3f} ops {s['ops']} "
                     f"idle_ms {1e3 * s['idle_s']:.3f}")
    tot = f["totals"]
    sums = {k: sum(s[k] for s in f["spans"].values())
            for k in ("device_s", "ops", "idle_s")}
    lines.append(
        f"span-sums window_ms {1e3 * f['window_s']:.3f} device_ms "
        f"{1e3 * sums['device_s']:.3f} of {1e3 * tot['device_s']:.3f} ops "
        f"{sums['ops']} of {tot['ops']} idle_ms {1e3 * sums['idle_s']:.3f} "
        f"of {1e3 * tot['idle_s']:.3f} unlaunched {f['unlaunched']}")
    for what, by in f["placed"].items():
        total = sum(by.values())
        shares = " ".join(f"{n} {100.0 * t / total:.2f}%"
                          for n, t in sorted(by.items(), key=lambda x: -x[1])
                          if total > 0)
        lines.append(f"span-placed {what} device_ms {1e3 * total:.3f} "
                     f"{shares}")
    for o in sorted(f["top"]):
        lines += [f"span-top {o} {1e3 * t:.3f} ms {n}" for n, t in f["top"][o]]
    lines.append("span-counters " + " ".join(
        f"{k} {v}" for k, v in sorted(f["counters"].items())))
    if "host" in f:
        lines.append("span-counters host-window " + " ".join(
            f"{k} {v}" for k, v in sorted(f["host"]["counters"].items()))
            + f" window_ms {1e3 * f['host']['window_s']:.3f}")
    lines += [f"span-time {what} at {at:.3f} s" for what, at in f["marks"]]
    print("\n".join(lines), file=sys.stderr, flush=True)
