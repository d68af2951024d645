"""Ranks of the port's multi-process tests (tests/test_torch_multiproc.py,
and the ``gpu`` tests of tests/test_torch_cuda.py).

``launch(task, workdir, inputs)`` runs each rank as

    python tests/torch_rank_worker.py <task> <rank> <world> <workdir>

which joins a Gloo process group through ``file://<workdir>/store``, runs
the task on the inputs left in ``<workdir>/inputs.pt``, writes what it
found to ``<workdir>/out-<rank>.pt`` and leaves the group. Tasks:

* ``train``: the training-mode ``Norm`` on this rank's rows of a global
  batch, forward and backward; then SGD steps of a data-parallel
  ``NNetWrapper`` on this rank's rows of each global batch (on
  ``inputs["device"]``, the CPU by default).
* ``moves``: self-play moves of this rank's games through
  ``make_move_fns``, with the global batch's draws cut to its games; then
  the same moves with its own draws (``parallel.GameShard``).
* ``coach``: a 2-iteration tictactoe Coach with the JAX Coach's draws
  (``test_torch_arena.JaxDraws``) cut to this rank's games, recording the
  fast/full coins it draws; then, for each move k of ``inputs["stop"]``,
  a Coach whose rank 0 alone sets ``stop_train`` in its k-th self-play
  move, recording the moves each rank made.
* ``kernels``: on the card, both game-minor kernels against their plain
  versions at a snapshot of a search of this rank's games.

This module imports neither JAX nor the JAX package (the ``coach`` task
does, when it runs).
"""

import datetime
import hashlib
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from alphazero_general_tpu_torch.envs import get_env  # noqa: E402
from alphazero_general_tpu_torch.models import NNetWrapper  # noqa: E402
from alphazero_general_tpu_torch.models.architectures import Norm  # noqa: E402,E501
from alphazero_general_tpu_torch.parallel import mesh as M  # noqa: E402
from alphazero_general_tpu_torch.utils import get_args  # noqa: E402

#: Seconds the ranks of one launch may take together before all are killed
#: (a collective that one rank never reaches would hang them).
DEADLINE = 300


def launch(task: str, work: str, inputs: dict, world: int = 2) -> list:
    """Every rank of ``task`` on ``inputs``; their outputs, in rank order.
    Fails with the ranks' output if one exits non-zero or they pass
    ``DEADLINE``."""
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, str(r), str(world),
         work], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"{task}: the ranks passed {DEADLINE} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{task} rank {r} failed:\n{out[-4000:]}"
    return [torch.load(os.path.join(work, f"out-{r}.pt"), weights_only=False)
            for r in range(world)]


def state_digest(module) -> str:
    """sha256 of every parameter's and statistic's bytes."""
    h = hashlib.sha256()
    for k, v in sorted(module.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def task_train(inp):
    if "norm_x" not in inp:
        return task_steps(inp)
    rows = M.rank_slice(inp["norm_x"].shape[0])
    norm = Norm(inp["norm_x"].shape[1])
    norm.load_state_dict(inp["norm_state"])
    norm.train()
    x = inp["norm_x"][rows].clone().requires_grad_(True)
    y = norm(x)
    (y * inp["norm_g"][rows]).sum().backward()
    out = dict(norm_y=y.detach(), norm_dx=x.grad,
               norm_dw=norm.weight.grad, norm_db=norm.bias.grad,
               norm_stats=(norm.running_mean.clone(),
                           norm.running_var.clone()))
    out.update(task_steps(inp))
    return out


def task_steps(inp):
    out = {}
    env = get_env("connect4")
    device = inp.get("device", "cpu")
    net = NNetWrapper(env, get_args(**inp["args"]), device=device)
    net.model.load_state_dict(inp["state"])
    net.attach_mesh()
    batches = [tuple(x[M.rank_slice(len(x))] for x in b)
               for b in inp["batches"]]
    out["losses"] = net.train(batches, len(batches), iteration=1)
    out["state"] = {k: v.cpu() for k, v in net.model.state_dict().items()}
    out["digest"] = state_digest(net.model)
    return out


def task_moves(inp):
    from alphazero_general_tpu_torch.mcts.search import SearchDraws
    from alphazero_general_tpu_torch.selfplay import (
        SelfPlayConfig, init_selfplay, make_move_fns,
    )

    env = get_env("connect4")
    args = get_args(**inp["args"])
    net = NNetWrapper(env, args, device="cpu")
    net.model.load_state_dict(inp["state"])
    cfg = SelfPlayConfig.from_args(args, env.NUM_PLAYERS, env.HAS_DRAW)
    fns = make_move_fns(env, cfg, net.model)
    B = int(args.process_batch_size)
    rows = M.rank_slice(B)
    carry = init_selfplay(env, B // M.world_size(), cfg.start_temp,
                          device="cpu", cfg=cfg)
    fields = ("action", "player", "done", "win_state")
    recs = []
    for kind, (gumbel, tie, gammas) in zip(inp["kinds"], inp["draws"]):
        carry, rec = fns[kind](carry, gumbel=gumbel[rows],
                               search_draws=SearchDraws(
                                   tie=tie[:, rows], gammas=gammas[rows]))
        recs.append({f: getattr(rec, f) for f in fields})
    out = dict(recs=recs, games_played=int(carry.games_played))
    # The same moves with the port's own draws: a generator seeded alike on
    # every rank, seen through a GameShard of the global batch.
    carry = init_selfplay(env, B // M.world_size(), cfg.start_temp,
                          device="cpu", cfg=cfg)
    shard = M.shard_generator(
        torch.Generator().manual_seed(inp["seed"]), B)
    assert isinstance(shard, M.GameShard)
    out["own"] = []
    for kind in inp["kinds"]:
        carry, rec = fns[kind](carry, generator=shard)
        out["own"].append({f: getattr(rec, f) for f in fields})
    return out


class _CoinRecorder:
    """The Coach's numpy stream, recording each ``random()`` draw (the
    fast/full coins)."""

    def __init__(self, rng):
        self.rng, self.coins = rng, []

    def random(self, *a, **k):
        x = self.rng.random(*a, **k)
        self.coins.append(float(x))
        return x

    def __getattr__(self, name):
        return getattr(self.rng, name)


class _RankDraws:
    """The JAX Coach's draws of the global batch cut to this rank's games:
    each hook gets the rank's valid masks, which are placed at the rank's
    rows of a global mask (every action valid elsewhere) before the JAX
    draws are taken, and their rows are cut back out."""

    def __init__(self, draws):
        self.draws = draws

    @staticmethod
    def _cut(fn, valids):
        from alphazero_general_tpu_torch.mcts.search import SearchDraws
        from alphazero_general_tpu_torch.selfplay import MoveDraws

        b = valids.shape[0]
        rows = slice(M.rank() * b, (M.rank() + 1) * b)
        full = torch.ones((b * M.world_size(),) + valids.shape[1:],
                          dtype=valids.dtype)
        full[rows] = valids
        d = fn(full)
        s = d.search
        return MoveDraws(gumbel=d.gumbel[rows], search=SearchDraws(
            tie=None if s.tie is None else s.tie[:, rows],
            gammas=None if s.gammas is None else s.gammas[rows]))

    def selfplay(self, kind, sims, valids):
        return self._cut(lambda v: self.draws.selfplay(kind, sims, v),
                         valids)

    def arena(self):
        round_draws = self.draws.arena()
        return lambda t, sims, valids: self._cut(
            lambda v: round_draws(t, sims, v), valids)

    def calibration(self):
        return self.draws.calibration()


def task_coach(inp):
    os.environ["AZG_TEST_DEVICE_COUNT"] = "1"
    import _cpu_mesh_bootstrap  # noqa: F401  (JAX on the CPU)
    from test_torch_arena import JaxDraws

    from alphazero_general_tpu_torch.train import Coach

    env = get_env("tictactoe")
    args = get_args(**inp["args"])
    net = NNetWrapper(env, args, device="cpu")
    coach = Coach(env, net, args, draws=_RankDraws(JaxDraws(
        int(args.seed), env_name="tictactoe")))
    coach._np_rng = _CoinRecorder(coach._np_rng)
    coach.learn()
    coach.writer.close()
    stops = {k: _stopped_coach(get_args(
                 {**inp["stop"]["args"], "run_name": f"stop{k}"}), k)
             for k in inp.get("stop", {}).get("moves", ())}
    return dict(coins=coach._np_rng.coins,
                digest=state_digest(coach.train_net.model),
                sp_digest=state_digest(coach.self_play_net.model),
                self_play_iter=coach.self_play_iter,
                gating_counter=coach.gating_counter,
                model_iter=coach.model_iter, ranks=coach.ranks, stops=stops)


def _stopped_coach(args, k):
    """A tictactoe Coach's ``learn`` whose rank 0 sets ``stop_train`` in
    its k-th self-play move: the moves this rank made, its state, counts
    and seconds."""
    from alphazero_general_tpu_torch.train import Coach

    env = get_env("tictactoe")
    coach = Coach(env, NNetWrapper(env, args, device="cpu"), args)
    moves = [0]
    make = coach._get_move_fns

    def counted(model):
        def wrap(fn):
            def run(*a, **kw):
                moves[0] += 1
                if M.rank() == 0 and moves[0] == k:
                    coach.stop_train.set()
                return fn(*a, **kw)
            return run
        return {kind: wrap(fn) for kind, fn in make(model).items()}

    coach._get_move_fns = counted
    t0 = time.perf_counter()
    coach.learn()
    coach.writer.close()
    return dict(moves=moves[0], seconds=time.perf_counter() - t0,
                state=coach.state.name, model_iter=coach.model_iter,
                games=coach.games_played_iter,
                stop_set=coach.stop_train.is_set())


def task_kernels(inp):
    """Both game-minor kernels against their plain versions at a snapshot
    of a fresh-tree search of this rank's games on the card (its draws
    the global batch's, cut to its games)."""
    from alphazero_general_tpu_torch.mcts import search as S
    from alphazero_general_tpu_torch.mcts.tree import SearchSpec
    from alphazero_general_tpu_torch.mcts.tree_t import init_tree_t
    from alphazero_general_tpu_torch.ops import backup as OB
    from alphazero_general_tpu_torch.ops import descend as OD

    env = get_env("connect4")
    spec = SearchSpec()
    games, sims, snap = inp["games"], inp["sims"], inp["snapshot"]
    gen = M.shard_generator(torch.Generator("cuda").manual_seed(5), games)
    states = env.init(games // M.world_size(), "cuda")
    tt = init_tree_t(env, states, sims + 2, spec.value_size)
    eval_fn = S.uniform_eval_fn(env.ACTION_SIZE, spec.value_size, True)
    S._simulate_step_t(env, tt, spec, eval_fn, root_adjust=True, slot=0,
                       expand_root_only=True, generator=gen)
    for slot in range(1, snap):
        S._simulate_step_t(env, tt, spec, eval_fn, root_adjust=False,
                           slot=slot, generator=gen)
    cols = (tt.parent, tt.parent_action, tt.n, tt.q, tt.v, tt.edge_prior,
            tt.eany, tt.nba, tt.nbp)
    OD.descend_columns.launches = OB.backup_columns_.launches = 0
    got = OD.descend_columns(*cols, spec)
    want = OD.descend_plain(*(c.cpu() for c in cols), spec.cpuct,
                            spec.fpu_reduction)
    same = [torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
            for g, w in zip(got, want)]
    values = S._leaf_step_t(env, tt, spec, eval_fn, False, snap, False, gen)
    args = (tt.parent, tt.player, tt.leaf, values, tt.max_depth)
    k_nqv = [x.clone() for x in (tt.n, tt.q, tt.v)]
    p_nqv = [x.cpu() for x in (tt.n, tt.q, tt.v)]
    OB.backup_columns_(*args, *k_nqv, spec)
    OB.backup_plain_(*(a.cpu() for a in args), *p_nqv, spec)
    same += [torch.equal(k.cpu().view(torch.int32), p.view(torch.int32))
             for k, p in zip(k_nqv, p_nqv)]
    return dict(same=same, launches=(OD.descend_columns.launches,
                                     OB.backup_columns_.launches),
                root_n=int(tt.n[0].min()))


TASKS = {"train": task_train, "moves": task_moves, "coach": task_coach,
         "kernels": task_kernels}


def main(task, rank, world, work):
    # Small tensors: one intra-op thread (several processes share the
    # cores).
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{work}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=DEADLINE))
    try:
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        out = TASKS[task](inp)
        torch.save(out, os.path.join(work, f"out-{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
