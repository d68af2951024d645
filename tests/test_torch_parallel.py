"""The port's parallel layer in one process: the mesh arithmetic against
the JAX package's, what a world of several ranks changes in the
single-process helpers, the launcher's process group, and the scanned
self-play chunk against JAX's ``play_chunk``.

The collectives themselves run in tests/test_torch_multiproc.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import alphazero_general_tpu.selfplay.selfplay as JSP
from alphazero_general_tpu.envs.connect4 import Connect4 as JConnect4
from alphazero_general_tpu.parallel.mesh import usable_devices as j_usable
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.envs.core import state_items
from alphazero_general_tpu_torch.parallel import mesh as M
from alphazero_general_tpu_torch.selfplay import selfplay as SP
from alphazero_general_tpu_torch.selfplay.replay import ReplayStore
from alphazero_general_tpu_torch.utils import config as C
from test_torch_arena import move_draws
from test_torch_search import (random_positions, table_eval_fns,
                               to_jax_states, to_torch_states)

torch.set_num_threads(1)

#: Batch sizes (self-play games, train batch, past arena, baseline arena)
#: for the mesh arithmetic: the connect4 preset's, ones that shrink a mesh
#: of 8 to 6, 4, 3 or 1, and zero (an arena that does not run).
SIZES = [(2048, 1024, 128, 128), (12, 24, 6, 0), (8, 8, 4, 4), (9, 27, 3, 3),
         (7, 14, 0, 0), (30, 60, 90, 45), (1, 2, 3, 4)]


@pytest.mark.parametrize("sizes", SIZES)
def test_mesh_size_matches_jax_usable_devices(sizes):
    """JAX's arithmetic over the suite's 8 virtual CPU devices, for every
    requested size from -1 (all) to more devices than there are."""
    assert jax.device_count() == 8
    for requested in (-1, 0, 1, 2, 3, 4, 5, 6, 8, 16):
        assert M.mesh_size(requested, 8, sizes) == j_usable(
            requested, *sizes), (requested, sizes)


def _world(monkeypatch, world, rank=0):
    """Pretend to be ``rank`` of ``world`` ranks (no process group)."""
    monkeypatch.setattr(M, "world_size", lambda: world)
    monkeypatch.setattr(M, "rank", lambda: rank)


def test_usable_devices_keeps_every_rank_or_raises(monkeypatch):
    assert M.usable_devices(-1, 2048, 1024, 128, 128) == 1
    _world(monkeypatch, 2)
    assert M.usable_devices(-1, 2048, 1024, 128, 128) == 2
    assert M.usable_devices(2, 8, 8, 0, 0) == 2
    # Where JAX would shrink the mesh, the port cannot leave the group.
    with pytest.raises(ValueError, match=r"\[2048, 1024, 127\]"):
        M.usable_devices(-1, 2048, 1024, 127)
    with pytest.raises(ValueError, match="mesh_batch_axis=1"):
        M.usable_devices(1, 8, 8)


def test_check_ported_accepts_the_world_size(monkeypatch):
    for axis in (-1, 1):
        C.check_ported(C.get_args(mesh_batch_axis=axis))
    with pytest.raises(ValueError, match="mesh_batch_axis=2"):
        C.check_ported(C.get_args(mesh_batch_axis=2))
    _world(monkeypatch, 2)
    C.check_ported(C.get_args(mesh_batch_axis=2))
    with pytest.raises(ValueError, match="mesh_batch_axis=4"):
        C.check_ported(C.get_args(mesh_batch_axis=4))


def test_rank_slices_partition_the_batch(monkeypatch, tmp_path):
    for world in (1, 2, 4):
        rows = []
        for r in range(world):
            _world(monkeypatch, world, r)
            s = M.rank_slice(16)
            rows += list(range(16))[s]
            assert s.stop - s.start == 16 // world
            # Each rank's sample files, suffixed as JAX's hosts' are.
            store = ReplayStore(str(tmp_path), "run")
            assert store.path(3).endswith(
                "iteration-0003" + (f"-p{r}" if world > 1 else "") + ".npz")
        assert rows == list(range(16))
    with pytest.raises(ValueError, match="does not split"):
        M.rank_slice(15)


def test_game_shard_draws_are_the_global_draws_cut(monkeypatch):
    """A GameShard's uniform draws over a rank's games are the rows of the
    same generator's draws over the global batch; without a group of more
    than one rank, shard_generator leaves the generator as it is."""
    gen = torch.Generator().manual_seed(3)
    assert M.shard_generator(gen, 8) is gen and M.shard_generator(None, 8) \
        is None
    want = torch.rand((8, 7), generator=torch.Generator().manual_seed(3))
    for r in range(2):
        _world(monkeypatch, 2, r)
        shard = M.shard_generator(torch.Generator().manual_seed(3), 8)
        got = M.draw_uniform((4, 7), shard, "cpu")
        assert torch.equal(got, want[4 * r:4 * (r + 1)])
        noise = SP.gumbel_noise((4, 7), M.shard_generator(
            torch.Generator().manual_seed(3), 8), "cpu")
        u = torch.clamp(want[4 * r:4 * (r + 1)],
                        min=torch.finfo(torch.float32).tiny)
        assert torch.equal(noise, -torch.log(-torch.log(u)))


def test_init_distributed(monkeypatch, tmp_path):
    """Without torchrun's variables no group forms; with them, the
    backend follows the device (captured, not started: no TCP port); an
    existing group is used as it is."""
    for k in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert M.init_distributed("cpu") is False and not M.is_distributed()
    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert M.init_distributed("cpu") is True
    assert seen == [("gloo", dict(init_method="env://", world_size=4,
                                  rank=3))]
    assert M.local_device("cuda") == torch.device("cuda", 3)
    assert M.local_device("cuda:1") == torch.device("cuda", 1)
    assert M.local_device("cpu") == torch.device("cpu")
    monkeypatch.undo()

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        assert M.init_distributed("cpu") is True
        assert M.world_size() == 1 and M.rank() == 0
        x = torch.arange(6.0)
        assert torch.equal(M.all_reduce_sum(x), x)
        assert int(M.all_reduce_min(3)) == 3 == int(M.all_reduce_max(3))
        assert torch.equal(M.all_gather_rows(x), x)
        M.barrier()
    finally:
        dist.destroy_process_group()
    assert not M.is_distributed()


B, SIMS_FULL, SIMS_FAST, MOVES = 8, 10, 4, 6


def test_play_chunk_matches_jax_play_chunk():
    """JAX's scanned chunk (the fast/full coin drawn in the program) and
    the port's loop, over one table evaluation, with the port given JAX's
    coins and draws (root and tie noise on): every record field, the
    coins and the carry equal, the policies within 1e-6."""
    j_eval, t_eval = table_eval_fns(seed=4)
    j_cfg = JSP.SelfPlayConfig(sims_full=SIMS_FULL, sims_fast=SIMS_FAST,
                               prob_fast=0.5, walk_impl="xla")
    t_cfg = SP.SelfPlayConfig(sims_full=SIMS_FULL, sims_fast=SIMS_FAST,
                              prob_fast=0.5)
    rng = jax.random.PRNGKey(11)
    # Random games a few moves from their end, so that some end and reset.
    pos = random_positions(B, seed=23, max_plies=30)
    temps = np.where(np.arange(B) % 2 == 0, 1.0, 0.5).astype(np.float32)
    j_carry = JSP.SelfPlayState(env_state=to_jax_states(pos),
                                temps=jnp.asarray(temps),
                                games_played=jnp.int32(0),
                                move_count=jnp.int32(0))
    j_carry, j_rec = jax.jit(functools.partial(
        JSP.play_chunk, JConnect4, j_cfg, j_eval, num_moves=MOVES))(
        j_carry, rng)

    keys = jax.random.split(rng, MOVES)

    def draws(k, valids):
        r_fast, r_search, r_action, _ = jax.random.split(keys[k], 4)
        fast = bool(jax.random.uniform(r_fast) < j_cfg.prob_fast)
        return fast, move_draws(r_search, r_action, valids,
                                SIMS_FAST if fast else SIMS_FULL, True)

    env = get_env("connect4")
    carry = SP.SelfPlayState(
        env_state=to_torch_states(pos), temps=torch.from_numpy(temps),
        games_played=torch.zeros((), dtype=torch.int32),
        move_count=torch.zeros((), dtype=torch.int32))
    carry, rec = SP.play_chunk(env, t_cfg, t_eval, carry, MOVES,
                               draws=draws)
    fast = np.asarray(j_rec.fast)
    assert 0 < fast.sum() < MOVES  # fast and full moves
    np.testing.assert_array_equal(rec.fast.numpy(), fast)
    np.testing.assert_allclose(rec.pi.numpy(), np.asarray(j_rec.pi),
                               rtol=1e-6, atol=1e-6)
    for f in ("obs", "player", "action", "win_state", "done"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(),
                                      np.asarray(getattr(j_rec, f)),
                                      err_msg=f)
    assert bool(rec.done.any())
    for name, x in state_items(carry.env_state).items():
        np.testing.assert_array_equal(
            x.numpy(), np.asarray(getattr(j_carry.env_state, name)),
            err_msg=name)
    assert int(carry.games_played) == int(j_carry.games_played)
    assert int(carry.move_count) == MOVES
    assert rec.obs.shape == (MOVES, B) + env.OBS_SHAPE


def test_play_chunk_fn_draws_its_coins_from_the_generator():
    """Without draws the coin is the generator's, drawn before each move's
    search draws: the runner of ``make_play_chunk_fn`` replays move_step
    over the model's evaluation with those coins; a warmup chunk plays
    warmup moves."""
    env = get_env("connect4")
    cfg = SP.SelfPlayConfig(sims_full=6, sims_fast=3, prob_fast=0.5)
    _, t_eval = table_eval_fns(seed=5)

    def apply_fn(obs):
        return tuple(torch.log(x) for x in t_eval(obs))

    def net_eval(obs):
        return tuple(torch.exp(x) for x in apply_fn(obs))

    run = SP.make_play_chunk_fn(env, cfg, apply_fn, 5)
    carry, rec = run(SP.init_selfplay(env, 4, device="cpu"),
                     generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    again = SP.init_selfplay(env, 4, device="cpu")
    for k in range(5):
        fast = bool(torch.rand((), generator=gen) < cfg.prob_fast)
        assert bool(rec.fast[k]) == fast
        again, r = SP.move_step(env, cfg, net_eval, again,
                                3 if fast else 6, fast=fast, generator=gen)
        assert torch.equal(r.action, rec.action[k])
        assert torch.equal(r.pi, rec.pi[k])
    assert 0 < int(rec.fast.sum()) < 5
    assert int(carry.move_count) == 5
    _, warm = SP.make_play_chunk_fn(env, cfg, apply_fn, 2, warmup=True)(
        SP.init_selfplay(env, 4, device="cpu"), generator=gen)
    assert not warm.fast.any() and (warm.root_visits == 5).all()
