"""The port's data parallelism in two processes against the JAX package's
2-device mesh.

Each test runs two ranks of ``tests/torch_rank_worker.py`` in a Gloo
process group on the CPU (a ``file://`` store in ``tmp_path``, no TCP port,
so that xdist workers never collide), each under a deadline after which
both are killed; the JAX side runs here on two of the suite's eight virtual
CPU devices (``make_mesh(2)``).

Held: the training-mode ``Norm`` over two ranks against flax's BatchNorm
on the global batch, forward and gradients (rtol 1e-5, atol 1e-6, as
tests/test_torch_train.py); three data-parallel SGD steps against JAX's
``make_sharded_train_step`` (params and batch statistics within the Coach
tests' 1e-5) and against the port's one-process steps, the two ranks'
weights bit-identical; the two ranks' self-play moves, with JAX's draws cut
to each rank's games, against JAX's ``make_move_fns(mesh=make_mesh(2))``:
actions, players, done flags and results equal, and with the ranks' own
draws (``parallel.GameShard``) those of one process; and a two-rank tictactoe
Coach (the counterpart of tests/test_multiproc.py: a warmup iteration with
both arenas, then a network one) whose iteration-1 samples are, as a
multiset, those of JAX's ``mesh_batch_axis=2`` Coach, with per-rank
sample files, checkpoints from rank 0 only, and the same weights, gating
state and fast/full coins on both ranks. In the same two processes, Coaches
whose rank 0 alone sets ``stop_train`` in its k-th self-play move: both
ranks leave self-play on the same move (the first count read at or after
move k: ``PIPE`` + 1 for an early k) and ``learn`` after it.
"""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

import alphazero_general_tpu.selfplay.selfplay as JSP
from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.envs.connect4 import Connect4 as JConnect4
from alphazero_general_tpu.models.wrapper import NNetWrapper as JWrapper
from alphazero_general_tpu.parallel.mesh import (
    make_mesh, make_sharded_train_step, replicate_tree, shard_leading_axis,
    shard_selfplay_carry,
)
from alphazero_general_tpu.train import Coach as JCoach
from alphazero_general_tpu.utils import config as JC
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.selfplay import (
    SelfPlayConfig, init_selfplay, make_move_fns,
)
from alphazero_general_tpu_torch.selfplay.replay import ReplayStore
from alphazero_general_tpu_torch.train.coach import PIPE
from alphazero_general_tpu_torch.utils import get_args
from alphazero_general_tpu_torch.utils.convert import resnet_state_dict
from test_torch_arena import _jax_move_draws
from test_torch_model import SMALL, jax_and_port, observations
from torch_rank_worker import launch

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
#: Trained weights and statistics against JAX (tests/test_torch_coach.py).
WEIGHT_ATOL = 1e-5


def _batches(n_batches, rows, seed):
    rng = np.random.default_rng(seed)
    obs = observations(n_batches * rows, seed=seed)
    pi = rng.dirichlet(np.ones(7), len(obs)).astype(np.float32)
    value = np.eye(3, dtype=np.float32)[rng.integers(0, 3, len(obs))]
    return [tuple(x[k * rows:(k + 1) * rows] for x in (obs, pi, value))
            for k in range(n_batches)]


def _flax_norm(x_nchw, g_nchw, scale, bias, mean, var):
    """flax's training-mode BatchNorm (momentum 0.9, epsilon 1e-5) on the
    whole batch: output, new statistics and the gradients of sum(y * g)."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    x = jnp.transpose(jnp.asarray(x_nchw), (0, 2, 3, 1))
    g = jnp.transpose(jnp.asarray(g_nchw), (0, 2, 3, 1))
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def loss(x, scale, bias):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd["batch_stats"])

    (_, (y, new)), (dx, ds, db) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(x, jnp.asarray(scale),
                                               jnp.asarray(bias))
    nchw = lambda a: np.asarray(jnp.transpose(a, (0, 3, 1, 2)))  # noqa: E731
    return nchw(y), nchw(dx), np.asarray(ds), np.asarray(db), \
        (np.asarray(new["mean"]), np.asarray(new["var"]))


def test_two_rank_norm_and_train_steps_match_jax_mesh(tmp_path):
    rng = np.random.default_rng(1)
    C = 8
    x = rng.normal(0.3, 1.2, (12, C, 6, 7)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.2, C).astype(np.float32)
    mean = rng.normal(0, 0.3, C).astype(np.float32)
    var = rng.uniform(0.5, 2.0, C).astype(np.float32)

    jnet, variables, net = jax_and_port("float32", seed=6)
    batches = _batches(3, 16, seed=9)
    state0 = {k: v.clone() for k, v in net.model.state_dict().items()}
    args = dict(compute_dtype="float32", **SMALL)
    t = torch.from_numpy
    outs = launch("train", str(tmp_path), dict(
        norm_x=t(x), norm_g=t(g),
        norm_state=dict(weight=t(scale), bias=t(bias), running_mean=t(mean),
                        running_var=t(var)),
        args=args, state=state0,
        batches=[tuple(t(a) for a in b) for b in batches]))

    # Norm: rows in rank order against flax on the global batch.
    y, dx, ds, db, (m, v) = _flax_norm(x, g, scale, bias, mean, var)
    got_y = torch.cat([o["norm_y"] for o in outs]).numpy()
    got_dx = torch.cat([o["norm_dx"] for o in outs]).numpy()
    np.testing.assert_allclose(got_y, y, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_dx, dx, rtol=RTOL, atol=ATOL)
    # Each rank's parameter gradient is its rows' share of the global one.
    np.testing.assert_allclose(sum(o["norm_dw"] for o in outs).numpy(), ds,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sum(o["norm_db"] for o in outs).numpy(), db,
                               rtol=RTOL, atol=ATOL)
    for o in outs:
        np.testing.assert_allclose(o["norm_stats"][0].numpy(), m,
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(o["norm_stats"][1].numpy(), v,
                                   rtol=RTOL, atol=ATOL)

    # Train steps: the ranks bit-identical, equal to JAX's sharded step and
    # to the port's one-process steps.
    assert outs[0]["digest"] == outs[1]["digest"]
    for k in outs[0]["state"]:
        assert torch.equal(outs[0]["state"][k], outs[1]["state"][k]), k
    mesh = make_mesh(2)
    jnet.state = jnet.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    step = make_sharded_train_step(jnet, mesh)
    jstate = replicate_tree(jnet.state, mesh)
    j_losses = []
    with mesh:
        for b in batches:
            jstate, (lp, lv) = step(
                jstate, shard_leading_axis(tuple(jnp.asarray(a) for a in b),
                                           mesh), jnet.current_lr(1))
            j_losses.append((float(lp), float(lv)))
    want = resnet_state_dict(jax.device_get(jstate))
    one_losses = net.train(batches, 3, iteration=1)
    one = net.model.state_dict()
    got = outs[0]["state"]
    np.testing.assert_allclose(outs[0]["losses"], np.mean(j_losses, 0),
                               rtol=RTOL)
    np.testing.assert_allclose(outs[0]["losses"], one_losses, rtol=RTOL)
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   atol=WEIGHT_ATOL, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), one[k].numpy(),
                                   atol=WEIGHT_ATOL, err_msg=k)
        moved += not torch.equal(got[k], state0[k])
    assert moved == len(want)


def test_two_rank_move_runners_match_jax_mesh(tmp_path):
    B, kinds = 8, ("fast", "full", "fast", "full")
    knobs = dict(numMCTSSims=12, numFastSims=4, process_batch_size=B)
    jnet, variables, net = jax_and_port("float32", seed=4)
    j_args = JC.get_args(compute_dtype="float32", seed=4, **SMALL, **knobs)
    j_cfg = JSP.SelfPlayConfig.from_args(j_args, 2, True)
    mesh = make_mesh(2)
    model = jnet.model
    fns = JSP.make_move_fns(
        JConnect4, j_cfg,
        lambda v, obs: model.apply(v, obs, train=False), mesh=mesh)
    jvars = replicate_tree(jax.tree_util.tree_map(jnp.asarray, variables),
                           mesh)
    carry = shard_selfplay_carry(
        JSP.init_selfplay(JConnect4, B, j_cfg.start_temp, cfg=j_cfg), mesh)
    want, draws = [], []
    for k, kind in enumerate(kinds):
        rng = jax.random.PRNGKey(200 + k)
        _, r_search, r_action, _ = jax.random.split(rng, 4)
        sims = j_cfg.sims_fast if kind == "fast" else j_cfg.sims_full
        valids = jax.vmap(JConnect4.valid_moves)(carry.env_state)
        draws.append(tuple(torch.from_numpy(np.array(a)) for a in
                           _jax_move_draws(r_search, r_action, valids,
                                           sims=sims, root_noise=True)))
        with mesh:
            carry, rec = fns[kind](jvars, carry, rng)
        want.append(rec)
    args = dict(compute_dtype="float32", **SMALL, **knobs)
    outs = launch("moves", str(tmp_path), dict(
        args=args, state=net.model.state_dict(), kinds=kinds, draws=draws,
        seed=7))
    fields = ("action", "player", "done", "win_state")
    for k, rec in enumerate(want):
        for f in fields:
            got = torch.cat([o["recs"][k][f] for o in outs]).numpy()
            np.testing.assert_array_equal(got, np.asarray(getattr(rec, f)),
                                          err_msg=f"move {k} {f}")
    assert sum(o["games_played"] for o in outs) == int(carry.games_played)

    # The ranks' own draws (root noise, tie noise, Gumbel) through
    # GameShard: the games of one process with the same seed.
    cfg = SelfPlayConfig.from_args(get_args(**args), 2, True)
    t_fns = make_move_fns(get_env("connect4"), cfg, net.model)
    t_carry = init_selfplay(get_env("connect4"), B, cfg.start_temp,
                            device="cpu", cfg=cfg)
    gen = torch.Generator().manual_seed(7)
    for k, kind in enumerate(kinds):
        t_carry, rec = t_fns[kind](t_carry, generator=gen)
        for f in fields:
            got = torch.cat([o["own"][k][f] for o in outs])
            assert torch.equal(got, getattr(rec, f)), f"own move {k} {f}"


def _rows(data):
    """The samples of (obs, pi, value) as a sorted list of row bytes."""
    flat = np.concatenate([np.asarray(x, np.float32).reshape(len(x), -1)
                           for x in data], axis=1)
    return sorted(map(bytes, flat))


def test_two_rank_coach_matches_jax_mesh_coach(tmp_path):
    B = 8
    knobs = dict(
        seed=5, numWarmupIters=1, process_batch_size=B, gamesPerIteration=B,
        numMCTSSims=6, numFastSims=3, numWarmupSims=4, probFastSim=0.5,
        train_batch_size=B, arenaCompare=B, arenaCompareBaseline=B,
        num_channels=8, depth=1, value_head_channels=2,
        policy_head_channels=2, value_dense_layers=[8],
        policy_dense_layers=[8], compute_dtype="float32",
        quant_selfplay=False, deviceWindowRows=16384,
        min_next_model_winrate=0.5, autoTrainSteps=False,
        train_steps_per_iteration=4)
    root = str(tmp_path)

    def dirs(tag):
        return dict(run_name=tag, checkpoint=os.path.join(root, "ckpt"),
                    data=os.path.join(root, "data"),
                    log_dir=os.path.join(root, "runs"))

    # JAX: iteration 1 (the warmup) on a 2-device mesh, no arenas.
    j_args = JC.get_args(mesh_batch_axis=2, numIters=1,
                         compareWithBaseline=False, compareWithPast=False,
                         **knobs, **dirs("jax"))
    j_env = j_get_env("tictactoe")
    jc = JCoach(j_env, JWrapper(j_env, j_args), j_args)
    assert jc.mesh is not None and jc.mesh.devices.size == 2
    jc.learn()

    # The port: iteration 1 with both arenas and the gating decision, then
    # iteration 2's self-play (fast and full moves: the coins) and train.
    stop_moves = (5, 12)
    outs = launch("coach", root, dict(args=dict(
        mesh_batch_axis=2, numIters=2, baselineCompareFreq=2,
        pastCompareFreq=2, **knobs, **dirs("port")), stop=dict(
            moves=stop_moves, args=dict(knobs, numIters=1,
                                        gamesPerIteration=8 * B,
                                        **dirs("port")))))
    files = sorted(os.listdir(os.path.join(root, "data", "port")))
    assert files == [f"iteration-000{i}-p{r}.npz" for i in (1, 2)
                     for r in (0, 1)], files
    parts = []
    for r in (0, 1):
        store = ReplayStore(os.path.join(root, "data"), "port")
        store._suffix = f"-p{r}"
        parts.append(store.load(1))
    assert all(len(p[0]) for p in parts)
    merged = tuple(np.concatenate([p[i] for p in parts]) for i in range(3))
    assert _rows(merged) == _rows(jc.store.load(1))

    ckpts = sorted(os.listdir(os.path.join(root, "ckpt", "port")))
    assert ckpts == sorted([f"iteration-000{i}{e}" for i in range(3)
                            for e in (".ckpt", ".json")]
                           + ["run_state.json"]), ckpts
    a, b = outs
    assert a["ranks"] == b["ranks"] == 2
    assert a["digest"] == b["digest"] and a["sp_digest"] == b["sp_digest"]
    for key in ("self_play_iter", "gating_counter", "model_iter", "coins"):
        assert a[key] == b[key], key
    assert a["model_iter"] == 3 and len(a["coins"]) > 0
    # Only rank 0 wrote metrics: one record per tag and step.
    with open(os.path.join(root, "runs", "port", "metrics.jsonl")) as f:
        keys = [(r["tag"], r["step"]) for r in map(json.loads, f)]
    assert len(keys) == len(set(keys))
    assert {("arena_past/games", 1), ("arena_baseline/games", 1)} <= set(
        keys)

    # Rank 0's stop at move k: both ranks leave on the same move and end
    # learn in STANDBY, with no training; rank 1's own event stays clear.
    for k in stop_moves:
        a, b = (o["stops"][k] for o in outs)
        assert a["moves"] == b["moves"] == max(k, PIPE + 1), (k, a, b)
        assert a["state"] == b["state"] == "STANDBY"
        assert a["model_iter"] == b["model_iter"] == 1
        assert a["games"] == b["games"] < 8 * B
        assert a["stop_set"] and not b["stop_set"]
        assert max(a["seconds"], b["seconds"]) < 120
