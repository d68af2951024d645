"""Self-play as the Coach runs it: ``process_batch_size`` games in lockstep,
each move a search on fresh trees through the program's move runners
(``selfplay.make_move_fns``), moves in the mix's fixed cycle of fast and
full searches, finished games restarted, and each move's record brought to
the host ``record_lag`` moves behind (sparse policies densified there). The
network is the configuration's self-play tower: the int8 one where its
precision says so (calibrated on the benchmark's random playouts), else the
float one. The benchmark draws every move's random numbers and hands them
to the runners.

Window: moves until ``--seconds`` have passed and the checked move is in,
closed by a synchronisation at the end of the move in progress;
``sims_per_s`` is games × simulations of every move over it.

Check (after the window): for ``check_games`` games drawn from the seed,
every move of the window against the reference rules and every record;
and one full move drawn from the seed (in cycle 1 or 2), whose searches the
reference replays with the same draws, and whose network calls the
reference network evaluates again.

Traced run: one cycle profiled for the device's activity (the kernels'
time, launches, the busy share), the next move profiled with the host's
operations for the idle gaps; after the window, one search of each kind on
the current games for the walks' bytes.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from azbench import checks, counting, program as P, weights
from azbench.common import Capture, Result, TraceRecord
from azbench.profiling import Traced


def _tower(ctx, net, W):
    """(the network the runners call, its precision, the calibration
    observations)."""
    precision = ctx.cfg["precision"]["selfplay_tower"]
    if precision == "int8":
        calib = checks.calibration_obs(ctx)
        return net.quantized_inference(calib_obs=calib), "int8", calib
    return net.model, precision, None


def run(ctx) -> Result:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    env = P.env(cfg)
    args = P.args(cfg)
    ctx.mark("program imported")
    W = weights.make(cfg, ctx.seed_for("weights"), dev)
    net = P.wrapper(env, args, dev, W, cfg)
    ctx.mark("weights made and loaded")
    model, precision, calib = _tower(ctx, net, W)
    ctx.mark(f"{precision} tower ready")
    sp_cfg, sp = P.selfplay(env, args)
    S = P.search_module()
    cap = Capture(model)
    fns = sp.make_move_fns(env, sp_cfg, cap)
    B, A = int(args.process_batch_size), env.ACTION_SIZE
    cycle = list(tr["cycle"])
    L = len(cycle)
    sims_of = {"fast": sp_cfg.sims_fast, "full": sp_cfg.sims_full}
    gen = ctx.generator("draws")

    def move(carry, kind):
        gum, tie, gam = checks.search_draws(env, carry.env_state,
                                            sims_of[kind], gen)
        carry, rec = fns[kind](carry, gumbel=gum,
                               search_draws=S.SearchDraws(tie=tie,
                                                          gammas=gam))
        return carry, rec, (tie, gam, gum)

    def drain(item):
        w, d, o, p, pidx, played = item
        w.cpu(), d.cpu(), int(played)
        if o is not None:
            o.cpu()
            p = p.cpu().numpy()
            if pidx is not None:
                sp.densify_pi(p, pidx.cpu().numpy(), A)

    # Set-up's warm-up: one cycle from the start, records drained.
    carry = sp.init_selfplay(env, B, sp_cfg.start_temp, device=dev,
                             cfg=sp_cfg)
    for kind in cycle:
        carry, rec, _ = move(carry, kind)
        drain((rec.win_state, rec.done, rec.obs, rec.pi, rec.pi_idx,
               carry.games_played))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    ctx.mark("warm-up cycle")

    rng = ctx.rng("check")
    check_cycle = int(rng.integers(1, 3))
    check_move = check_cycle * L + cycle.index("full")
    games = np.sort(rng.choice(B, size=min(int(tr["check_games"]), B),
                               replace=False))
    trace_first = (check_cycle + 1) * L  # the profiled cycle
    last_needed = trace_first + L + 1 if ctx.trace else check_move + 1

    games_t = torch.as_tensor(games, device=dev)
    carry = sp.init_selfplay(env, B, sp_cfg.start_temp, device=dev,
                             cfg=sp_cfg)
    states = [P.state_items(carry.env_state)]
    actions, wins, dones, visits, pis, kinds, gums = ([] for _ in range(7))
    checked = None
    raw = deque()
    lag = int(tr["record_lag"])
    traced = host_traced = None
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    window_start = time.time()
    t0 = time.perf_counter()
    sims_done = i = 0
    while True:
        kind = cycle[i % L]
        if ctx.trace and i == trace_first:
            traced = Traced().__enter__()
        if ctx.trace and i == trace_first + L:
            host_traced = Traced(host_ops=True).__enter__()
        cap.on = i == check_move
        carry, rec, draws = move(carry, kind)
        if cap.on:
            cap.on = False
            tie, gam, _ = draws
            checked = {"tie": tie[:, games_t], "gammas": gam[games_t],
                       "calls": cap.calls, "pi": rec.pi,
                       "pi_idx": rec.pi_idx, "root_visits": rec.root_visits}
            cap.calls = []
        states.append(P.state_items(carry.env_state))
        actions.append(rec.action)
        wins.append(rec.win_state)
        dones.append(rec.done)
        visits.append(rec.root_visits)
        pis.append(None if rec.pi is None else (rec.pi, rec.pi_idx))
        gums.append(None if rec.pi is None else draws[2])
        # Only one move's tie draws are held at a time.
        draws = tie = gam = None
        kinds.append(kind)
        sims_done += B * sims_of[kind]
        raw.append((rec.win_state, rec.done, rec.obs, rec.pi, rec.pi_idx,
                    carry.games_played))
        while len(raw) > lag:
            drain(raw.popleft())
        i += 1
        if traced is not None and i == trace_first + L:
            traced.__exit__(None, None, None)
        if host_traced is not None and i == trace_first + L + 1:
            host_traced.__exit__(None, None, None)
        if time.perf_counter() - t0 >= ctx.seconds and i >= last_needed:
            break
    if cuda:
        torch.cuda.synchronize(dev)
    window = time.perf_counter() - t0
    ctx.mark("window closed")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    while raw:
        drain(raw.popleft())

    trace = None
    if ctx.trace:
        trace = _trace_record(ctx, env, sp_cfg, S, model, carry, kinds,
                              trace_first, L, sims_of, B, traced,
                              host_traced, peak, precision)
    # The program's state is freed before the reference runs.
    del fns, cap, model, net, carry, raw
    if cuda:
        torch.cuda.empty_cache()
    res, notes = _check(ctx, W, precision, calib, states, actions, wins,
                        dones, visits, pis, gums, kinds, sims_of, games,
                        check_move, checked)
    ctx.mark("checked")
    return Result(e2e={"sims_per_s": sims_done / window}, attempted=i,
                  failed=0, checks=res, window_start=window_start,
                  peak_bytes=max(peak, setup_peak) if cuda else 0,
                  trace=trace, notes=notes)


def _trace_record(ctx, env, sp_cfg, S, model, carry, kinds, first, L,
                  sims_of, B, traced, host_traced, peak,
                  precision) -> TraceRecord:
    """The traced cycle's record, with the walks' bytes from one search of
    each kind on the games as the window left them."""
    TT = P.tree_t_module()
    gen = ctx.generator("walks")

    @torch.inference_mode()
    def net_eval(obs):
        logp, logv = model(obs)
        return torch.exp(logp), torch.exp(logv)

    nbytes = {}
    for kind, sims in sims_of.items():
        _, tie, gam = checks.search_draws(env, carry.env_state, sims, gen)
        cap = min(sp_cfg.capacity, sims + 2)
        tt = TT.init_tree_t(env, carry.env_state, cap,
                            sp_cfg.spec.value_size)
        with torch.inference_mode():
            S.search(env, tt, sp_cfg.spec, net_eval, sims,
                     draws=S.SearchDraws(tie=tie, gammas=gam))
        walks = counting.search_walks(tt.parent.cpu().numpy(), sims)
        nbytes[kind] = (
            counting.descend_search_bytes(walks, sims, tt.parent.shape[0],
                                          B),
            counting.backup_search_bytes(walks, sims, B))
    traced_kinds = kinds[first:first + L]
    batch_sims = sum(sims_of[k] for k in traced_kinds)
    return TraceRecord(
        cfg=ctx.cfg, window_s=traced.window_s, busy_s=traced.busy_s(),
        device_events=len(traced.device),
        kernel_s={"descend_kernel": traced.seconds_of("descend_kernel"),
                  "backup_kernel": traced.seconds_of("backup_kernel")},
        counters={
            "driver": "selfplay", "batch_sims": batch_sims,
            "rows": batch_sims * B, "tower_precision": precision,
            "descend_bytes": sum(nbytes[k][0] for k in traced_kinds),
            "backup_bytes": sum(nbytes[k][1] for k in traced_kinds),
            "peak_bytes": peak,
            # One full move's draws as the benchmark makes them: tie
            # [sims, B, A], Gamma and Gumbel [B, A], float32.
            "draw_bytes": (max(sims_of.values()) + 2) * B
            * env.ACTION_SIZE * 4},
        breakdown={"device_ops": traced.device_ops(),
                   "idle_gaps": host_traced.idle_gaps()})


def _actions(cfg, gs, acts, dones, dense, root_visits, gums) -> int:
    """Full moves of the checked games whose action is not the one the
    reference samples from the record's visit counts: the Gumbel-max of
    the visit policy at each game's temperature, with the move's draws."""
    G = acts.shape[1]
    temp = np.full(G, float(cfg["args"]["startTemp"]))
    bad = 0
    for m in range(acts.shape[0]):
        for g in range(G):
            temp[g] = checks.next_temperature(cfg, temp[g],
                                              int(gs["turns"][m, g]))
            if dense[m] is not None:
                counts = checks.root_counts_from_pi(
                    dense[m][g:g + 1], root_visits[m, g:g + 1])[0]
                pol = checks.temperature_policy(counts, temp[g])
                logits = np.log(np.maximum(pol, np.float32(1e-30)))
                bad += int(int(np.argmax(gums[m][g] + logits))
                           != int(acts[m, g]))
            if dones[m, g]:
                temp[g] = float(cfg["args"]["startTemp"])
    return bad


def _check(ctx, W, precision, calib, states, actions, wins, dones, visits,
           pis, gums, kinds, sims_of, games, check_move, checked) -> dict:
    cfg, dev = ctx.cfg, ctx.device
    idx = torch.as_tensor(games, device=dev)
    gs = checks.stack_games(states, games)
    acts = torch.stack(actions)[:, idx].cpu().numpy()
    dones_g = torch.stack(dones)[:, idx].cpu().numpy()
    out = checks.transitions(cfg, gs, acts,
                             torch.stack(wins)[:, idx].cpu().numpy(),
                             dones_g)
    A = cfg["action_size"]
    dense = [None if p is None else
             checks.dense_pi(p[0][idx], None if p[1] is None else p[1][idx],
                             A).cpu().numpy() for p in pis]
    root_visits = torch.stack(visits)[:, idx].cpu().numpy()
    out["record_mismatch"] = checks.policy_records(
        cfg, gs, dense, acts, root_visits, [sims_of[k] for k in kinds])
    out["action_mismatch"] = _actions(
        cfg, gs, acts, dones_g, dense, root_visits,
        [None if x is None else x[idx].cpu().numpy() for x in gums])

    ref_eval = checks.reference_eval(ctx, W, precision, calib)
    sims = sims_of[kinds[check_move]]
    calls = checked["calls"]
    if len(calls) != sims:
        raise RuntimeError(f"the checked move made {len(calls)} network "
                           f"calls for {sims} simulations")
    obs = torch.stack([c[0][idx] for c in calls]).float().cpu().numpy()
    pi = torch.exp(torch.stack([c[1][0][idx] for c in calls])).cpu().numpy()
    v = torch.exp(torch.stack([c[1][1][idx] for c in calls])).cpu().numpy()
    counts = checks.root_counts_from_pi(
        dense[check_move], checked["root_visits"][idx].cpu().numpy())
    got = checks.replay_search(
        cfg, checks.search_spec(cfg), checks.states_of(gs, check_move), sims,
        checked["tie"].transpose(0, 1).cpu().numpy(),
        checked["gammas"].cpu().numpy(),
        obs, pi, v, counts, ref_eval)
    got.pop("visits")
    notes = checks.tie_notes(got.pop("followed"), got.pop("missed"))
    out.update(got)
    out.update(checks.network_gaps(pi, v, obs, ref_eval))
    if ctx.control:
        low = checks.reference_eval(ctx, W, checks.CONTROL_OF[precision],
                                    calib)
        lp, lv = low(torch.from_numpy(obs.reshape((-1,) + obs.shape[2:])))
        got = checks.network_gaps(lp, lv, obs, ref_eval)
        out.update({f"control.{k}": x for k, x in got.items()})
    return out, notes
