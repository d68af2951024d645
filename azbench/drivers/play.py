"""A player's move, as a person waits for it in the GUI's ``mcts:``
opponent or in ``cli.pit``: the program's ``MCTSPlayer`` over the float
(bfloat16) network, one game, a fresh search of ``numMCTSSims``
simulations every move. The player plays both sides of games that start
from random openings of ``opening_plies`` plies, drawn from the seed; a new
game starts where one ends. A closed loop: a move counts when its action is
on the host and the env has stepped it.

Window: moves until ``--seconds`` have passed; ``move_ms`` is the window
over the moves made in it.

Check (after the window): every move of the window: the opening's and each
move's states against the reference rules, each action legal and visited,
the root visited ``numMCTSSims`` times; the reference replays every
move's search with the same draws and evaluates the network calls again.

Traced run: ``trace_moves`` moves profiled for the device's activity, then
one with the host's operations for the idle gaps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from azbench import checks, program as P, weights
from azbench.common import Capture, Result, TraceRecord
from azbench.profiling import Traced
from azbench.reference import make_env


def openings(ctx, count: int) -> list:
    """``count`` random openings (lists of actions) of the traffic's
    ``opening_plies`` [lo, hi] plies, each ending on a running game."""
    ref = make_env(ctx.cfg)
    rng = ctx.rng("openings")
    lo, hi = ctx.traffic["opening_plies"]
    out = []
    while len(out) < count:
        plies = int(rng.integers(lo, hi + 1))
        s, acts = ref.init(), []
        for _ in range(plies):
            a = int(rng.choice(np.flatnonzero(ref.valid(s))))
            s = ref.step(s, a)
            acts.append(a)
            if (ref.win(s) > 0).any():
                break
        else:
            out.append(acts)
    return out


def run(ctx) -> Result:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    env = P.env(cfg)
    args = P.args(cfg)
    ctx.mark("program imported")
    W = weights.make(cfg, ctx.seed_for("weights"), dev)
    net = P.wrapper(env, args, dev, W, cfg)
    ctx.mark("weights made and loaded")
    # The warm-up's player and the window's: the window's player draws
    # its action choices from a generator of its own seed, which the
    # reference follows.
    warm = P.mcts_player(net, env, args, seed=0)
    player = P.mcts_player(net, env, args, seed=ctx.seed_for("player"))
    cap = Capture(player.eval_fn)
    player.eval_fn = cap
    S = P.search_module()
    sims = int(args.numMCTSSims)
    gen = ctx.generator("draws")
    games = openings(ctx, int(tr["openings"]))

    def start(k):
        state = env.init(1, dev)
        for a in games[k % len(games)]:
            state = env.step(state, torch.tensor([a], dtype=torch.int32,
                                                 device=dev))
        return state

    def move(state, who):
        _, tie, gam = checks.search_draws(env, state, sims, gen)
        a = who.play(state, draws=S.SearchDraws(tie=tie, gammas=gam))
        return a, tie, gam

    # Set-up's warm-up: one move from the empty board.
    move(env.init(1, dev), warm)
    ctx.mark("warm-up move")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    trace_moves = int(tr["trace_moves"])
    record, starts = [], []
    traced = host_traced = None
    game = 0
    state = start(game)
    player.reset()
    starts.append((game, P.state_items(state)))
    cap.on = True
    window_start = time.time()
    t0 = time.perf_counter()
    m = 0
    while True:
        if ctx.trace and m == 1:
            traced = Traced().__enter__()
        if ctx.trace and m == 1 + trace_moves:
            host_traced = Traced(host_ops=True).__enter__()
        a, tie, gam = move(state, player)
        nxt = env.step(state, torch.tensor([a], dtype=torch.int32,
                                           device=dev))
        win = env.win_state(nxt)
        done = bool((win > 0).any())
        record.append({"state": P.state_items(state), "action": a,
                       "next": P.state_items(nxt), "win": win,
                       "done": done, "tie": tie, "gammas": gam,
                       "calls": cap.calls, "tree": player.last_tree})
        cap.calls = []
        m += 1
        if traced is not None and m == 1 + trace_moves:
            traced.__exit__(None, None, None)
        if host_traced is not None and m == 2 + trace_moves:
            host_traced.__exit__(None, None, None)
        if done:
            game += 1
            state = start(game)
            player.reset()
            starts.append((game, P.state_items(state)))
        else:
            state = nxt
        if time.perf_counter() - t0 >= ctx.seconds and (
                not ctx.trace or m >= 2 + trace_moves):
            break
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    ctx.mark("window closed")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    cap.on = False

    trace = None
    if ctx.trace:
        trace = TraceRecord(
            cfg=cfg, window_s=traced.window_s, busy_s=traced.busy_s(),
            device_events=len(traced.device),
            kernel_s={"descend_rows_kernel":
                      traced.seconds_of("descend_rows_kernel"),
                      "backup_rows_kernel":
                      traced.seconds_of("backup_rows_kernel")},
            counters={"driver": "play", "sims": trace_moves * sims,
                      "moves": trace_moves, "peak_bytes": peak},
            breakdown={"device_ops": traced.device_ops(),
                       "idle_gaps": host_traced.idle_gaps()})
    del player, warm, net, cap
    if cuda:
        torch.cuda.empty_cache()
    res, notes = _check(ctx, W, record, starts, games, sims)
    ctx.mark("checked")
    return Result(e2e={"move_ms": 1e3 * window_s / m}, attempted=m,
                  failed=0, checks=res, window_start=window_start,
                  peak_bytes=max(peak, setup_peak) if cuda else 0,
                  trace=trace, notes=notes)


def _tree_counts(tree, A: int) -> tuple:
    """(root visits, the root children's visit counts [A]) of a player's
    batch-major tree of one game (the sink row left out)."""
    parent = tree.parent[0, :-1].cpu().numpy()
    act = tree.parent_action[0, :-1].cpu().numpy()
    n = tree.n[0, :-1].cpu().numpy()
    counts = np.zeros(A, np.int64)
    kids = parent == 0
    np.add.at(counts, act[kids], n[kids])
    return int(n[0]), counts


def _check(ctx, W, record, starts, games, sims) -> dict:
    cfg = ctx.cfg
    ref = make_env(cfg)
    A = cfg["action_size"]
    opening_bad = 0
    for k, items in starts:
        s = ref.init()
        for a in games[k % len(games)]:
            s = ref.step(s, a)
        got = {f: x[0].cpu().numpy() for f, x in items.items()}
        opening_bad += not checks.same_state(s, got)
    states = {f: np.stack([
        np.stack([r["state"][f][0].cpu().numpy() for r in record]),
        np.stack([r["next"][f][0].cpu().numpy() for r in record])])
        for f in record[0]["state"]}
    out = checks.transitions(
        cfg, states, np.array([[r["action"] for r in record]]),
        np.stack([r["win"][0].cpu().numpy() for r in record])[None],
        np.array([[r["done"] for r in record]]), auto_reset=False)
    out["env_mismatch"] += opening_bad

    bad = 0
    all_counts = []
    for r in record:
        root, counts = _tree_counts(r["tree"], A)
        all_counts.append(counts)
        bad += root != sims or counts[r["action"]] <= 0
    out["record_mismatch"] = int(bad)

    ref_eval = checks.reference_eval(ctx, W, "float32")
    spec = checks.search_spec(cfg)
    leaf = 0
    followed, missed = [], []
    moved = 0.0
    obs_all, pi_all, v_all = [], [], []
    rng = np.random.default_rng(ctx.seed_for("player"))
    temp = None
    wrong_actions = 0
    for m, r in enumerate(record):
        calls = r["calls"]
        if len(calls) != sims:
            raise RuntimeError(f"move {m} made {len(calls)} network calls "
                               f"for {sims} simulations")
        obs = torch.stack([c[0] for c in calls]).float().cpu().numpy()
        pi = torch.stack([c[1][0] for c in calls]).float().cpu().numpy()
        v = torch.stack([c[1][1] for c in calls]).float().cpu().numpy()
        root = {f: states[f][0, m] for f in states}
        got = checks.replay_search(
            cfg, spec, [root], sims, r["tie"].transpose(0, 1).cpu().numpy(),
            r["gammas"].cpu().numpy(), obs, pi, v, all_counts[m][None],
            ref_eval)
        leaf += got["leaf_mismatch"]
        followed += got["followed"]
        missed += got["missed"]
        moved = max(moved, got["visit_mismatch"])
        # The player's choice: its generator's draw from the reference's
        # visit policy at the game's temperature.
        if m == 0 or record[m - 1]["done"]:
            temp = float(cfg["args"]["startTemp"])
        temp = checks.next_temperature(cfg, temp, int(root["turns"]))
        pol = checks.temperature_policy(got["visits"][0], temp)
        wrong_actions += int(rng.choice(len(pol), p=pol)) != r["action"]
        obs_all.append(obs)
        pi_all.append(pi)
        v_all.append(v)
    out["leaf_mismatch"] = leaf
    out["visit_mismatch"] = moved
    out["action_mismatch"] = wrong_actions
    obs_all, pi_all, v_all = (np.concatenate(x) for x in
                              (obs_all, pi_all, v_all))
    out.update(checks.network_gaps(pi_all, v_all, obs_all, ref_eval))
    if ctx.control:
        low = checks.reference_eval(
            ctx, W, checks.CONTROL_OF[cfg["precision"]["inference"]])
        lp, lv = low(torch.from_numpy(
            obs_all.reshape((-1,) + obs_all.shape[2:])))
        got = checks.network_gaps(lp, lv, obs_all, ref_eval)
        out.update({f"control.{k}": x for k, x in got.items()})
    return out, checks.tie_notes(followed, missed)
