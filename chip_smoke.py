#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (alphazero_general_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds; the first failure exits non-zero:

1. device: require CUDA; print the card's name, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build: compile the CUDA kernels with nvcc (ops/build.py) and print the
   ``-Xptxas -v`` resource summary.
3. kernels: during a full-width 200-simulation search and a 40-simulation
   one (connect4, 2048 games, random 128x8 ResNet; N = 203 and 43 tree
   rows), hold each kernel against its plain PyTorch version on the same
   tree snapshot, bit for bit, and time both: the kernel's device time
   from torch.profiler (with L2 flushed before each launch, and back to
   back with the inputs left in L2; the backup also at each block size of
   ``BACKUP_THREADS``), each wrapper call and the plain version with CUDA
   events, and the host's time per wrapper call by the host clock alone.
   Then, on seeded random trees of every size in ``RANDOM_NODES`` and
   batch in ``RANDOM_BATCHES`` (ragged, and a tree large enough to force
   fewer games a descend block), both kernels again, bit for bit.
4. reference: a small whole search on the card against the same search on
   the CPU (plain versions), visit counts equal.
5. self-play: 4 moves (fast, fast, fast, full) of the production config
   through ``make_move_fns``, with launch counters proving that every
   simulation went through both kernels.
6. breakdown: where the time of a 40- and a 200-simulation search goes,
   per stage (CUDA events and host clock) and per kernel (torch.profiler:
   the kernels' device times in place, between the network's passes).

The last two lines are the kernels line ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.mcts import search as S
from alphazero_general_tpu_torch.mcts import tree as T
from alphazero_general_tpu_torch.mcts.tree_t import init_tree_t
from alphazero_general_tpu_torch.models import NNetWrapper
from alphazero_general_tpu_torch.ops import backup as OB
from alphazero_general_tpu_torch.ops import descend as OD
from alphazero_general_tpu_torch.selfplay import (
    SelfPlayConfig, init_selfplay, make_move_fns,
)
from alphazero_general_tpu_torch.utils import get_args
from alphazero_general_tpu_torch.utils.random_tree import (
    DESCEND_COLUMNS, random_tree,
)

# The production connect4 config of bench.py:38-51 (the reference's
# envs/connect4/train.py): 2048 games, 200 full / 40 fast simulations at a
# 3 fast : 1 full cycle, ResNet 128 channels x 8 blocks, 32-channel heads,
# dense [1024, 256] (value) and [1024] (policy), bfloat16 compute.
GAMES = 2048
SIMS_FULL = 200
SIMS_FAST = 40
CYCLE = ("fast", "fast", "fast", "full")
MODEL = dict(num_channels=128, depth=8, value_head_channels=32,
             policy_head_channels=32, value_dense_layers=[1024, 256],
             policy_dense_layers=[1024], compute_dtype="bfloat16")
SEED = 0
#: Simulations of the phase-3 searches (full, fast) after which both
#: kernels are checked; the last snapshot of each is timed.
SNAPSHOTS = {SIMS_FULL: (50, 120, 199), SIMS_FAST: (20, 39)}
#: Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: float32 (non-tensor-core) operations/s, for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: Bytes written between timed launches to evict the kernel's inputs from
#: the 50 MB L2, as the network's passes do between launches in a search.
L2_FLUSH_BYTES = 256 * 2**20

#: Tolerance of the reference phase (a search on the card against the same
#: search on the CPU: the CPU's float arithmetic may round otherwise).
TOL_FLOAT = 1e-6
#: Random trees on which both kernels are held against their plain versions
#: (utils/random_tree.py): every tree size from the smallest to one that
#: forces fewer than 8 games a descend block (N = 7300: 4), and batches
#: that are a multiple of the block, ragged (1000 is not a multiple of 64)
#: or too small for the 16-byte staging loads (7).
RANDOM_NODES = (2, 43, 2048, 7300)
RANDOM_BATCHES = (2048, 1000, 7)
#: Block sizes of the backup timed in the kernel phase.
BACKUP_THREADS = (32, 64, 128)
#: Wrapper calls timed by the host clock alone, with no sync among them.
HOST_CALLS = 1000


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int, device) -> float:
    """Mean milliseconds of ``fn()``: CUDA events on the card (after one
    warm-up call), the host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def host_ms(fn, calls: int, device) -> float:
    """Host milliseconds per call of ``fn``, by the host clock over
    ``calls`` calls with no sync among them: what a wrapper costs the host
    to check its inputs and enqueue its kernel, without the device."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    sync(device)
    return dt * 1e3 / calls


def _device_kernels(prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def kernel_ms(fn, reps: int, device, kernel: str,
              flush_l2: bool = False) -> float:
    """Device milliseconds of one launch of the CUDA kernel whose name
    contains ``kernel``, from a torch.profiler trace of ``reps`` calls of
    ``fn`` — the kernel alone, without the wrapper's host time. With
    ``flush_l2``, a fill of ``L2_FLUSH_BYTES`` runs before each call, so
    the kernel reads its inputs from HBM; without it the calls run back to
    back and find their inputs in L2. On the CPU, where no kernel runs, the
    host time of one call."""
    if torch.device(device).type != "cuda":
        return time_ms(fn, reps, device)
    scrub = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                         device=device) if flush_l2 else None)
    fn()
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(reps):
            if scrub is not None:
                scrub.fill_(i)
            fn()
        torch.cuda.synchronize(device)
    hits = [e for e in _device_kernels(prof) if kernel in e.key]
    count = sum(e.count for e in hits)
    check(count == reps, f"profiler saw {count} launches of {kernel}, "
                         f"expected {reps}")
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def launch_floor_ms(device, reps: int = 50) -> float:
    """Device milliseconds of about the smallest kernel there is, a fill of
    one int32 (torch.profiler): no kernel launched on this card takes less,
    whatever its bound."""
    one = torch.zeros(1, dtype=torch.int32, device=device)
    return kernel_ms(lambda: one.fill_(1), reps, device, "FillFunctor")


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------

def random_openings(env, batch: int, max_plies: int, generator, device):
    """Games advanced by 0..max_plies random legal moves each."""
    states = env.init(batch, device)
    plies = torch.randint(0, max_plies + 1, (batch,), generator=generator,
                          device=device)
    for ply in range(max_plies):
        valid = env.valid_moves(states).to(torch.float32)
        action = torch.multinomial(valid, 1, generator=generator)[:, 0]
        stepped = env.step(states, action)
        move = plies > ply
        states = env.State(**{
            name: torch.where(move.reshape((-1,) + (1,) * (x.dim() - 1)),
                              getattr(stepped, name), x)
            for name, x in state_items(states).items()})
    return states


def table_eval_fn(action_size: int, value_size: int, seed: int = 0,
                  rows: int = 4093):
    """Evaluation by table lookup on an integer hash of the stone planes:
    the same numbers on any device, so a search gives equal visit counts on
    the card and on the CPU."""
    rng = np.random.default_rng(seed)
    pi_tab = rng.dirichlet(np.ones(action_size), rows).astype(np.float32)
    v_tab = rng.dirichlet(np.ones(value_size), rows).astype(np.float32)
    weights = rng.integers(1, rows, size=(2, 6 * 7))
    cache = {}

    def eval_fn(obs):
        dev = obs.device
        if dev not in cache:
            cache[dev] = tuple(torch.from_numpy(x).to(dev)
                               for x in (pi_tab, v_tab, weights))
        pi_t, v_t, w = cache[dev]
        stones = (obs[:, :2] > 0.5).reshape(obs.shape[0], 2, -1).long()
        h = (stones * w).sum(dim=(1, 2)) % rows
        return pi_t[h], v_t[h]

    return eval_fn


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def device_phase():
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: torch.cuda.is_available() is "
                           "false; this smoke run needs one GPU")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"device: {name} (count {count}); nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return name, count, smi


def build_phase():
    from alphazero_general_tpu_torch.ops.build import build_library, \
        load_library

    result = build_library()
    load_library()
    for line in result.log.splitlines():
        if line.startswith("---") or "ptxas info" in line \
                or "error" in line.lower() or "warning" in line.lower():
            log(f"  {line.strip()}")
    log(f"build: {result.path.name} in {result.seconds:.1f} s")
    return result


def _descend_inputs(tt):
    return (tt.parent, tt.parent_action, tt.n, tt.q, tt.v, tt.edge_prior,
            tt.eany, tt.nba, tt.nbp)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (float32 compared as its int32 bits, so -0.0 and
    0.0 differ and equal NaNs agree)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def compare_descend(cols, spec, where: str) -> float:
    """Kernel against plain on one set of [N, B] columns: every output
    equal bit for bit (the kernel is exact by construction). Returns the
    max abs p_sel error, 0.0."""
    got = OD.descend_columns(*cols, spec)
    sync(cols[0].device)
    want = OD.descend_plain(*cols, spec.cpuct, spec.fpu_reduction)
    for name, g, w in zip(("node", "action", "child", "depth", "p_sel"),
                          got, want):
        bad = (g.view(torch.int32) != w.view(torch.int32)).nonzero()
        if len(bad):
            game = int(bad[0, 0])
            raise SmokeFailure(
                f"descend {name} disagrees on {len(bad)} games {where}; "
                f"game {game}: kernel {[float(x[game]) for x in got]} plain "
                f"{[float(x[game]) for x in want]}")
    return (got[4] - want[4]).abs().max().item()


def compare_backup(args, nqv, spec, where: str) -> float:
    """Kernel against plain from the same n, q, v: visit counts equal and
    q, v equal bit for bit. Returns the max abs q/v error, 0.0."""
    k_cols = [x.clone() for x in nqv]
    p_cols = [x.clone() for x in nqv]
    OB.backup_columns_(*args, *k_cols, spec)
    sync(nqv[0].device)
    OB.backup_plain_(*args, *p_cols, spec)
    for name, g, w in zip("nqv", k_cols, p_cols):
        check(bits_equal(g, w), f"backup {name} disagrees {where}")
    return max((k_cols[1] - p_cols[1]).abs().max().item(),
               (k_cols[2] - p_cols[2]).abs().max().item())


def _path_lengths(tt) -> np.ndarray:
    """Edges from each game's pending leaf to its root (host walk)."""
    parent = tt.parent.cpu().numpy()
    leaf = tt.leaf.cpu().numpy()
    out = np.zeros(leaf.shape[0], np.int64)
    for b, node in enumerate(leaf):
        while node != 0:
            node = parent[node, b]
            out[b] += 1
    return out


def _descend_bytes(cols, walk) -> int:
    """Bytes the walk of this snapshot must move, counted by element (4 B
    each; 32-byte sectors would count more). Per game: the root's n and
    eany; where the walk starts, the parent column (rows 0..N-2) once, and
    per node it scores, that node's v and nbp and the q, n and edge_prior
    of its children; per child it steps to, its parent_action and eany;
    nba where it ends on a new edge; and the five [B] outputs."""
    parent = cols[0].cpu().numpy()
    node, _, child, depth = (x.cpu().numpy().astype(np.int64)
                             for x in walk[:4])
    N, B = parent.shape
    games = np.arange(B)
    kids = np.zeros((N, B), np.int64)
    r, b = np.nonzero(parent[:N - 1] >= 0)
    np.add.at(kids, (parent[r, b], b), 1)
    walked = depth > 0
    new_edge = walked & (child < 0)
    elems = B * (2 + 5) + int(walked.sum()) * (N - 1)
    elems += 2 * int((depth - new_edge).sum()) + int(new_edge.sum())
    # The scored nodes are the final node (if the walk ended on a new
    # edge) or its parent, and their ancestors up to the root.
    cur = np.where(child < 0, node, parent[node, games])
    live = walked.copy()
    scored = np.zeros(B, np.int64)
    while live.any():
        elems += int((2 + 3 * kids[cur, games])[live].sum())
        scored += live
        live &= cur != 0
        cur = np.where(live, parent[cur, games], 0)
    check(np.array_equal(scored, depth),
          "descend byte count: the host path disagrees with the depths")
    return elems * 4


def kernel_phase(env, eval_fn, spec, batch: int, sims: int, snapshots,
                 device, reps: int = 50):
    """Both kernels against their plain versions at each snapshot of one
    fresh-tree search, and their times and the bytes their work needs at
    the last snapshot."""
    gen = torch.Generator(device).manual_seed(SEED)
    host_calls = HOST_CALLS if torch.device(device).type == "cuda" else reps
    roots = random_openings(env, batch, 6, gen, device)
    tt = init_tree_t(env, roots, sims + 2, spec.value_size)
    S._simulate_step_t(env, tt, spec, eval_fn, root_adjust=True, slot=0,
                       expand_root_only=True, generator=gen)
    errs = {"descend": 0.0, "backup": 0.0}
    timing = {}
    for slot in range(1, sims):
        if slot not in snapshots:
            S._simulate_step_t(env, tt, spec, eval_fn, root_adjust=False,
                               slot=slot, generator=gen)
            continue
        cols = _descend_inputs(tt)
        where = f"at N={tt.parent.shape[0]}, B={batch}, after {slot} sims"
        errs["descend"] = max(errs["descend"],
                              compare_descend(cols, spec, where))
        if slot == snapshots[-1]:
            walk = OD.descend_columns(*cols, spec)
            launch = lambda: OD.descend_columns(*cols, spec)  # noqa: E731
            timing["descend"] = dict(
                ms=kernel_ms(launch, reps, device, "descend_kernel",
                             flush_l2=True),
                ms_l2_warm=kernel_ms(launch, reps, device, "descend_kernel"),
                call_ms=time_ms(launch, reps, device),
                host_ms=host_ms(launch, host_calls, device),
                plain_ms=time_ms(lambda: OD.descend_plain(
                    *cols, spec.cpuct, spec.fpu_reduction), 3, device),
                N=tt.parent.shape[0], depth_sum=int(walk[3].sum().item()),
                depth_max=int(walk[3].max().item()),
                bytes=_descend_bytes(cols, walk))
        values = S._leaf_step_t(env, tt, spec, eval_fn, False, slot, False,
                                gen)
        args = (tt.parent, tt.player, tt.leaf, values, tt.max_depth)
        errs["backup"] = max(errs["backup"], compare_backup(
            args, (tt.n, tt.q, tt.v), spec, where))
        if slot == snapshots[-1]:
            scratch = [tt.n.clone(), tt.q.clone(), tt.v.clone()]
            paths = _path_lengths(tt)

            def launch(threads=OB.THREADS):
                OB.backup_columns_(*args, *scratch, spec, threads=threads)

            timing["backup"] = dict(
                ms=kernel_ms(launch, reps, device, "backup_kernel",
                             flush_l2=True),
                ms_l2_warm=kernel_ms(launch, reps, device, "backup_kernel"),
                call_ms=time_ms(launch, reps, device),
                host_ms=host_ms(launch, host_calls, device),
                plain_ms=time_ms(lambda: OB.backup_plain_(
                    *args, *scratch, spec), 3, device),
                ms_by_threads={t: kernel_ms(
                    lambda: launch(t), reps, device, "backup_kernel",
                    flush_l2=True) for t in BACKUP_THREADS},
                path_sum=int(paths.sum()), path_max=int(paths.max()))
        OB.backup_batched_t(tt, values, spec)
        log(f"  snapshot after {slot} sims: descend and backup agree "
            f"(max errors {errs['descend']:.3g}, {errs['backup']:.3g})")
    check(torch.equal(tt.n[0], torch.full_like(tt.n[0], sims)),
          "root visits after the kernel-phase search != sims")
    return errs, timing


def random_tree_phase(spec, device, nodes=RANDOM_NODES,
                      batches=RANDOM_BATCHES):
    """Both kernels against their plain versions, bit for bit, on seeded
    random trees (utils/random_tree.py) of every size in ``nodes`` and
    every game count in ``batches``, with a discount below 1 so that the
    backup's exp is exercised. Returns the max abs errors."""
    spec = spec._replace(min_discount=0.8)
    errs = {"descend": 0.0, "backup": 0.0}
    for N in nodes:
        for B in batches:
            tree = {k: torch.from_numpy(x).to(device)
                    for k, x in random_tree(N, B, seed=SEED + N * 7 + B,
                                            num_players=spec.num_players,
                                            has_draw=spec.has_draw).items()}
            where = f"on a random tree, N={N}, B={B}"
            cols = [tree[name] for name, _ in DESCEND_COLUMNS]
            errs["descend"] = max(errs["descend"],
                                  compare_descend(cols, spec, where))
            args = [tree[k] for k in ("parent", "player", "leaf", "value",
                                      "max_depth")]
            errs["backup"] = max(errs["backup"], compare_backup(
                args, [tree[k] for k in "nqv"], spec, where))
            log(f"  random trees N={N} (games per descend block "
                f"{OD.games_per_block(N)}), B={B}: descend and backup "
                "equal bit for bit")
    return errs


def reference_phase(env, device, batch: int = 256, sims: int = 64):
    """A whole search through the kernels on ``device`` against the same
    search through the plain versions on the CPU."""
    spec = T.SearchSpec(add_root_noise=False, tie_noise=0.0)
    eval_fn = table_eval_fn(env.ACTION_SIZE, spec.value_size)
    gen = torch.Generator("cpu").manual_seed(SEED + 1)
    roots = random_openings(env, batch, 8, gen, "cpu")
    trees = []
    for dev in (device, "cpu"):
        on_dev = env.State(**{k: x.to(dev)
                              for k, x in state_items(roots).items()})
        tt = init_tree_t(env, on_dev, sims + 2, spec.value_size)
        trees.append(S.search(env, tt, spec, eval_fn, sims))
    got, want = trees
    for name in ("n", "parent", "parent_action"):
        check(torch.equal(getattr(got, name)[:-1].cpu(),
                          getattr(want, name)[:-1]),
              f"reference search: {name} differs between {device} and cpu")
    err = (got.q.cpu() - want.q).abs().max().item()
    check(err <= TOL_FLOAT, f"reference search: q error {err}")
    log(f"  {batch} games x {sims} sims on {device} == cpu "
        f"(n, parent, parent_action equal; q max error {err:.3g})")


def selfplay_phase(env, model, cfg, batch: int, cycle, device):
    """Moves of the config ``cfg`` through make_move_fns. Resets the
    kernels' launch counters just before and reads them just after."""
    fns = make_move_fns(env, cfg, model)
    carry = init_selfplay(env, batch, device=device)
    gen = torch.Generator(device).manual_seed(SEED + 2)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sync(device)
    OD.descend_columns.launches = 0
    OB.backup_columns_.launches = 0
    moves = []
    for kind in cycle:
        sims = cfg.sims_fast if kind == "fast" else cfg.sims_full
        before = carry.env_state
        t0 = time.perf_counter()
        carry, rec = fns[kind](carry, generator=gen)
        sync(device)
        dt = time.perf_counter() - t0
        moves.append((kind, sims, dt))
        check(bool((rec.root_visits == sims).all()),
              f"{kind} move: root visits != {sims}")
        check(rec.pi.shape == (batch, env.ACTION_SIZE)
              and bool(torch.isfinite(rec.pi).all()),
              f"{kind} move: policy shape or values wrong")
        check(bool(torch.allclose(rec.pi.sum(-1),
                                  torch.ones_like(rec.pi[:, 0]),
                                  atol=1e-5)),
              f"{kind} move: a policy row does not sum to 1")
        legal = env.valid_moves(before)[torch.arange(batch, device=device),
                                        rec.action.long()]
        check(bool(legal.all()), f"{kind} move: illegal action")
        log(f"  {kind} move: {sims} sims x {batch} games in {dt:.3f} s "
            f"= {batch * sims / dt:,.0f} sims/s")
    launches = {"descend": OD.descend_columns.launches,
                "backup": OB.backup_columns_.launches}
    expect = {"descend": sum(s - 1 for _, s, _ in moves),
              "backup": sum(s for _, s, _ in moves)}
    if not cuda:  # the plain versions run and launch nothing
        expect = {k: 0 for k in expect}
    check(launches == expect,
          f"kernel launches {launches} != expected {expect}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    total_sims = batch * sum(s for _, s, _ in moves)
    total_s = sum(dt for _, _, dt in moves)
    return dict(moves=moves, launches=launches,
                sims_per_s=total_sims / total_s, peak_bytes=peak)


STAGES = ("descend", "expand", "network", "install", "backup")


def breakdown_phase(env, eval_fn, spec, batch: int, sims: int, device):
    """Where the time of one fresh-tree search goes (the search of a fast
    move at full width).

    First run: per stage of a simulation, the device time between CUDA
    events recorded at the stage boundaries and the host time spent
    enqueueing the stage; the host never waits inside the loop. Where the
    device time of a stage is close to its host time, the device was
    waiting for the host. Second run, on the card only: a torch.profiler
    trace, for the device's busy share and the kernels that take its time.
    """
    from alphazero_general_tpu_torch.mcts import tree_t as TT

    cuda = torch.device(device).type == "cuda"
    gen = torch.Generator(device).manual_seed(SEED + 3)
    roots = random_openings(env, batch, 6, gen, device)

    def search(mark):
        tt = init_tree_t(env, roots, sims + 2, spec.value_size)
        S._simulate_step_t(env, tt, spec, eval_fn, root_adjust=True,
                           slot=0, expand_root_only=True, generator=gen)
        for slot in range(1, sims):
            mark(0)
            walk = OD.descend_batched_t(tt, spec)
            mark(1)
            obs, leaf_e, valid = TT.apply_walk_observe_t(env, tt, *walk,
                                                         slot)
            mark(2)
            pi, value = eval_fn(obs)
            mark(3)
            values = torch.where((leaf_e > 0).any(-1, keepdim=True), leaf_e,
                                 value)
            TT.install_prior_t(tt, pi, spec, False, slot, valid,
                               generator=gen)
            mark(4)
            OB.backup_batched_t(tt, values, spec)
            mark(5)

    marks = []

    def mark(i):
        ev = None
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        marks.append((i, time.perf_counter(), ev))

    search(lambda i: None)  # warm-up: allocator, cuDNN algorithm choice
    sync(device)
    t0 = time.perf_counter()
    search(mark)
    sync(device)
    wall = time.perf_counter() - t0
    host = dict.fromkeys(STAGES, 0.0)
    dev = dict.fromkeys(STAGES, 0.0)
    for (i, h0, e0), (_, h1, e1) in zip(marks[:-1], marks[1:]):
        if i == 5:
            continue  # between simulations
        host[STAGES[i]] += (h1 - h0) * 1e3
        if cuda:
            dev[STAGES[i]] += e0.elapsed_time(e1)
    n = sims - 1
    log(f"  one {sims}-sim search at B={batch}: {wall * 1e3 / sims:.3f} ms "
        "per simulation (host clock)")
    for st in STAGES:
        log(f"    {st:8s} device {dev[st] / n:.4f} ms/sim, host enqueue "
            f"{host[st] / n:.4f} ms/sim")
    out = dict(wall_ms_per_sim=wall * 1e3 / sims,
               device_ms={k: v / n for k, v in dev.items()},
               host_ms={k: v / n for k, v in host.items()})
    if not cuda:
        return out

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        search(lambda i: None)
        sync(device)
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"  profiler: device busy {busy_us / 1e3:.1f} ms of a "
        f"{window_us / 1e3:.1f} ms window ({100 * busy_us / window_us:.1f}%"
        f"), {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    for name in ("descend_kernel", "backup_kernel"):
        hits = [e for e in kernels if name in e.key]
        t = sum(e.self_device_time_total for e in hits) / 1e3
        c = sum(e.count for e in hits)
        log(f"    {name}: {t:.3f} ms over {c} launches "
            f"({t / max(c, 1):.4f} ms each)")
    out.update(busy_share=busy_us / window_us,
               launches_per_sim=sum(e.count for e in kernels) / sims)
    return out


def kernel_bounds(timing, batch: int) -> dict:
    """Each kernel's bound (ms, "bytes" or "operations") from the data of
    the snapshot it was timed on (see PERF.md)."""
    d, b = timing["descend"], timing["backup"]
    # descend: the bytes its walks need (_descend_bytes); operations: one
    # compare per row per walk step.
    d_ops = d["depth_sum"] * (d["N"] - 1)
    # backup: per path edge, parent, player, n, q, v read and n, q, v written
    # (32 bytes) and about 12 float operations; per game leaf, value,
    # max_depth read and the root's n, v, player touched (36 bytes).
    b_bytes = b["path_sum"] * 32 + batch * 36
    b_ops = b["path_sum"] * 12
    out = {}
    for name, nbytes, ops in (("descend", d["bytes"], d_ops),
                              ("backup", b_bytes, b_ops)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def kernel_records(errs, timing, launches, batch: int):
    """The per-kernel JSON records. ``ms`` is the device time of one launch
    with L2 flushed before it, on the snapshot the bound is computed from;
    ``ms_l2_warm`` the same launch back to back with its inputs in L2;
    ``host_ms`` the host's time per wrapper call."""
    bounds = kernel_bounds(timing, batch)
    out = []
    for name, src, replaces in (
            ("descend", "alphazero_general_tpu_torch/csrc/descend.cu",
             "alphazero_general_tpu/ops/descend.py:44"),
            ("backup", "alphazero_general_tpu_torch/csrc/backup.cu",
             "alphazero_general_tpu/ops/backup.py:26")):
        t = timing[name]
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "max_err": errs[name],
            "ms": t["ms"], "ms_l2_warm": t["ms_l2_warm"],
            "call_ms": t["call_ms"], "host_ms": t["host_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": None, "N": timing["descend"]["N"], "B": batch,
        })
    return out


def main() -> int:
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    name, count, smi = device_phase()
    device = "cuda:0"
    log(f"phase device: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    build_phase()
    log(f"phase build: {time.perf_counter() - t0:.1f} s")

    env = get_env("connect4")
    args = get_args(seed=SEED, numMCTSSims=SIMS_FULL, numFastSims=SIMS_FAST,
                    **MODEL)
    cfg = SelfPlayConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
    spec = cfg.spec
    net = NNetWrapper(env, args, device=device)

    t0 = time.perf_counter()
    log(f"  a one-element fill: {launch_floor_ms(device):.4f} ms of device "
        "time per launch (the least a kernel takes)")
    errs = {"descend": 0.0, "backup": 0.0}
    timings = {}
    for sims in (SIMS_FULL, SIMS_FAST):
        e, timings[sims] = kernel_phase(env, net.make_eval_fn(), spec, GAMES,
                                        sims, SNAPSHOTS[sims], device)
        errs = {k: max(errs[k], e[k]) for k in errs}
        t, bounds = timings[sims], kernel_bounds(timings[sims], GAMES)
        for k in ("descend", "backup"):
            log(f"  {k} at B={GAMES}, N={t['descend']['N']}: "
                f"{t[k]['ms']:.4f} ms of device time per launch with L2 "
                f"flushed, {t[k]['ms_l2_warm']:.4f} ms back to back, "
                f"{t[k]['call_ms']:.4f} ms per wrapper call, "
                f"{t[k]['host_ms']:.4f} ms of host time per call, plain "
                f"{t[k]['plain_ms']:.2f} ms; bound {bounds[k][0]:.6f} ms "
                f"({bounds[k][1]})")
        log("  backup with L2 flushed by threads a block: " + ", ".join(
            f"{th}: {ms:.4f} ms"
            for th, ms in t["backup"]["ms_by_threads"].items()))
        log(f"  descend needs {t['descend']['bytes']:,} bytes (by element) "
            f"over {t['descend']['depth_sum']:,} walk steps (deepest walk "
            f"{t['descend']['depth_max']}); backup walks "
            f"{t['backup']['path_sum']:,} path edges (longest path "
            f"{t['backup']['path_max']})")
    timing = timings[SIMS_FULL]
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    e = random_tree_phase(spec, device)
    errs = {k: max(errs[k], e[k]) for k in errs}
    log(f"phase random trees: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    reference_phase(env, device)
    log(f"phase reference: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sp = selfplay_phase(env, net.model, cfg, GAMES, CYCLE, device)
    log(f"  self-play: {sp['sims_per_s']:,.0f} sims/s over "
        f"{len(sp['moves'])} moves; launches {sp['launches']}; peak memory "
        f"{sp['peak_bytes'] / 2**30:.2f} GiB; card: {smi}")
    log(f"phase self-play: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for sims in (SIMS_FAST, SIMS_FULL):
        breakdown_phase(env, net.make_eval_fn(), spec, GAMES, sims, device)
    log(f"phase breakdown: {time.perf_counter() - t0:.1f} s")
    log(f"total: {time.perf_counter() - t_all:.1f} s")

    log(smi)
    log(json.dumps({"kernels": kernel_records(errs, timing, sp["launches"],
                                              GAMES)}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
