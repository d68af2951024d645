"""The port stands alone: it and chip_smoke.py import neither JAX nor the
JAX package, chip_smoke.py refuses to run without a GPU, and its phases
rehearse on the CPU at a tiny size."""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

# Small tensors: one intra-op thread (several test processes, and the
# ranks that the multi-device rehearsal starts, share the host's cores).
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "alphazero_general_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack",
           "alphazero_general_tpu")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_port_and_chip_smoke_import_with_jax_blocked():
    mods = list(_port_modules()) + ["chip_smoke"]
    code = "\n".join([
        "import sys",
        *(f"sys.modules[{m!r}] = None" for m in BLOCKED),
        "import importlib",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r} and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('imported', len(" + repr(mods) + "))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(mods)}" in out.stdout


def test_every_port_module_imports_first():
    """Each module imports in a process where no other module of the port
    is loaded yet: no import cycle among them."""
    mods = list(_port_modules())
    code = "\n".join([
        "import importlib, sys",
        f"for m in {mods!r}:",
        "    for name in [k for k in sys.modules",
        "                 if k.split('.')[0] == 'alphazero_general_tpu_torch']:",
        "        del sys.modules[name]",
        "    importlib.import_module(m)",
        "print('imported', len(" + repr(mods) + "))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(mods)}" in out.stdout


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_port_source_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imported_names(path):
            root = name.split(".")[0]
            assert root not in BLOCKED, f"{path.name} imports {name}"


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """On a host without CUDA the script exits non-zero with a clear
    message and prints no result; alone in a directory, it fails too."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for CPU-only hosts")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok"' not in out.stdout

    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=120)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout


def test_chip_smoke_phases_rehearse_on_cpu():
    """The kernel, reference, self-play, reuse and breakdown phases at a
    tiny size on the CPU, where every wrapper runs its plain version (so no
    launches count), and the kernels line with its four records."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(REPO))
    from alphazero_general_tpu_torch.envs import get_env
    from alphazero_general_tpu_torch.mcts.tree import SearchSpec
    from alphazero_general_tpu_torch.models import NNetWrapper
    from alphazero_general_tpu_torch.selfplay import SelfPlayConfig
    from alphazero_general_tpu_torch.utils import get_args

    env = get_env("connect4")
    spec = SearchSpec()
    net = NNetWrapper(env, get_args(num_channels=8, depth=2,
                                    value_head_channels=4,
                                    policy_head_channels=4,
                                    value_dense_layers=[16],
                                    policy_dense_layers=[16]), device="cpu")
    errs, timing = C.kernel_phase(env, net.make_eval_fn(), spec, 8, 12,
                                  (4, 11), "cpu", reps=1)
    assert errs == {"descend": 0.0, "backup": 0.0}
    assert C.random_tree_phase(spec, "cpu", nodes=(2, 40),
                               batches=(9,)) == dict.fromkeys(C.COUNTED, 0.0)
    C.reference_phase(env, "cpu", batch=8, sims=10)
    C.reference_reuse_phase(env, "cpu", batch=8, sims=(4, 10))
    cfg = SelfPlayConfig(sims_full=12, sims_fast=4, spec=spec)
    sp = C.selfplay_phase(env, net.model, cfg, 8, C.CYCLE, "cpu")
    assert sp["launches"] == dict.fromkeys(C.COUNTED, 0)
    reuse_cfg = cfg._replace(reuse_tree=True)
    openings = C.random_openings(env, 8, 6, torch.Generator().manual_seed(0),
                                 "cpu")
    rp = C.selfplay_phase(env, net.model, reuse_cfg, 8, C.REUSE_CYCLE, "cpu",
                          openings=openings)
    assert rp["launches"] == dict.fromkeys(C.COUNTED, 0)
    assert rp["carried"] > 0 and rp["carry"].trees.capacity == 26
    rows_errs, rows_timing = C.rows_kernel_phase(
        env, net.make_eval_fn(), spec, rp["carry"].trees, 12, (0, 5, 11),
        "cpu", reps=1)
    assert rows_errs == {"descend_rows": 0.0, "backup_rows": 0.0}
    assert C.in_place_phase(lambda: None, "cpu") == {}
    timing.update(rows_timing)
    errs.update(rows_errs)
    records = [C.kernel_record(k, k, timing[k], sp["launches"][k], errs[k])
               for k in C.KERNELS]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "host_ms", "N", "B"}
    assert [r["name"] for r in records] == ["descend", "backup",
                                            "descend_rows", "backup_rows"]
    assert [r["N"] for r in records] == [15, 15, 27, 27]
    for r in records:
        assert keys <= set(r)
        assert (REPO / r["source"]).is_file()
        assert r["bound_ms"] > 0
    for name in ("descend_rows", "backup_rows"):
        assert rows_timing[name]["jax_route_ms"] > 0
    parts = C.breakdown_phase(env, net.make_eval_fn(), spec, 8, 4, "cpu")
    assert set(parts["host_ms"]) == set(C.STAGES)

    # The search layer's phases: multi-leaf reference and self-play, the
    # kernels mid-round and at the segments' slices, the players' moves
    # segmented against flat.
    C.multileaf_reference_phase(env, "cpu", batch=8, sims=20)
    lp = C.multileaf_selfplay_phase(env, net.model, cfg._replace(
        sims_fast=11, sims_full=20), 8, "cpu")
    assert lp[C.LEAF_BATCH]["net_calls"] == {11: 1 + 1 + 2, 20: 1 + 2 + 3}
    assert lp[1]["net_calls"] == {11: 11, 20: 20}
    assert C.net_calls(200, 8) == [1] + [8] * 24 + [1] * 7
    assert len(C.net_calls(40, 8)) == 12
    errs, rounds_t = C.rounds_kernel_phase(env, net.make_eval_fn(), spec, 8,
                                           200, "cpu", reps=1)
    assert errs == {"descend": 0.0, "backup": 0.0}
    assert rounds_t["descend"]["N"] == 203 and rounds_t["backup"]["B"] == 8
    errs, seg_t, _ = C.segment_phase(env, spec, 8, 70, "cpu", reps=1)
    assert errs == {"descend": 0.0, "backup": 0.0}
    assert sorted(seg_t) == [32, 64]
    # The launches by tree rows that the segments of a 70-simulation
    # search make (the root's expansion backs up on all 73 rows).
    assert C.fresh_launches_by_rows(cfg._replace(sims_full=70),
                                    [("full", 70)]) == {
        "descend": {32: 30, 64: 32, 73: 7}, "backup": {32: 30, 64: 32,
                                                       73: 8}}
    by_rows = {32: 30, 64: 32, 73: 7}
    records = [C.kernel_record(f"{k}@seg_n{n}", k, t[k], by_rows[n],
                               errs[k], by_rows)
               for n, t in seg_t.items() for k in ("descend", "backup")]
    assert [r["N"] for r in records] == [32, 32, 64, 64]
    assert [r["launches_at_N"] for r in records] == [30, 30, 32, 32]
    assert all(keys <= set(r) and r["bound_ms"] > 0 for r in records)
    moves = C.player_segment_phase("cpu", 40, timed=2)
    assert sorted(moves) == ["mcts", "rawmcts"]
    assert all(len(m["segmented"]) == len(m["flat"]) == 2
               and m["slices_host"] > 0 for m in moves.values())


def test_chip_smoke_int8_phases_rehearse_on_cpu(capsys):
    """The int8 phase (quantize on calibration playouts, each tower conv
    against the CPU's, the forward and the accuracy bounds against the
    bf16 ResNet, the timings and the conv's bound), int8 self-play moves
    with their launch check, and the FC / GroupNorm phase, at a tiny size
    on the CPU."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(REPO))
    from alphazero_general_tpu_torch.envs import get_env
    from alphazero_general_tpu_torch.models import NNetWrapper
    from alphazero_general_tpu_torch.selfplay import SelfPlayConfig
    from alphazero_general_tpu_torch.utils import get_args

    env = get_env("connect4")
    net = NNetWrapper(env, get_args(num_channels=16, depth=2,
                                    value_head_channels=4,
                                    policy_head_channels=4,
                                    value_dense_layers=[16],
                                    policy_dense_layers=[16]), device="cpu")
    r = C.int8_phase(env, net, 8, "cpu")
    assert r["rows"] == 8 * 42 and r["channels"] == 16
    assert r["card_err"] == 0.0 and r["kl"] < C.INT8_KL
    assert r["int8_ms"] > 0 and r["conv_int8_ms"] > 0
    b = r["bound"]
    assert b["ops"] == 2 * 8 * 42 * 9 * 16 * 16
    assert b["int8_patches"][0] > b["int8"][0] > 0
    C.log_int8("connect4", r, "cpu")
    assert "one 3x3 tower conv" in capsys.readouterr().out
    cfg = SelfPlayConfig(sims_full=6, sims_fast=3)
    sp = C.selfplay_phase(env, net.quant_model, cfg, 8, C.CYCLE, "cpu")
    assert sp["launches"] == dict.fromkeys(C.COUNTED, 0)
    assert set(C.other_nets_phase("cpu", batch=8)) == {"fc", "groupnorm"}


def test_chip_smoke_coach_phase_rehearses_on_cpu(tmp_path, capsys):
    """The Coach phase (cli.train.main, then its checks of files, metrics
    and launch counters) and the train-step check, at a tiny size on the
    CPU, where no kernel launches; its log lines."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(REPO))
    tiny_model = dict(num_channels=8, depth=1, value_head_channels=2,
                      policy_head_channels=2, value_dense_layers=[8],
                      policy_dense_layers=[8])
    sets = dict(C.COACH_CUTS, process_batch_size=4, gamesPerIteration=4,
                numMCTSSims=6, numFastSims=3, train_batch_size=8,
                arenaCompare=4, arenaCompareBaseline=4, deviceWindowRows=16384,
                min_next_model_winrate=0.0, **tiny_model)
    co = C.coach_phase("cpu", str(tmp_path), sets)
    assert co["launches"] == dict.fromkeys(C.COUNTED, 0)
    # At the JAX default quant_selfplay=True: both arenas after iteration 1
    # and iteration 2's self-play ran the int8 tower.
    assert co["int8_forwards"] > 0
    assert co["iters"][1]["int8"] == {"self_play": 0.0, "baseline": 1.0,
                                      "past": 1.0}
    assert co["iters"][2]["int8"] == {"self_play": 1.0}
    assert co["searches"] > 0 and co["simulations"] > co["searches"]
    assert sorted(co["iters"]) == [1, 2]
    assert co["iters"][1]["self_play_sims"] == co["iters"][1]["moves"] * 5
    C.log_coach(co, "cpu")
    out = capsys.readouterr().out
    assert "time/arena_past" in out and "sims/s" in out
    assert "the preset's gate of 0.52 would" in out
    tc = C.train_check_phase("cpu", tiny_model, co["store"].load(1),
                             reps=2, timed_batch=8)
    assert tc["max_err"] == 0.0
    assert tc["window"]["steps_per_s"] > 0 and tc["host"]["steps_per_s"] > 0
    # The kernels at the Coach's own shapes (an arena round, a warmup move).
    from alphazero_general_tpu_torch.envs import get_env
    from alphazero_general_tpu_torch.envs.presets import preset_args
    from alphazero_general_tpu_torch.models import NNetWrapper

    args = preset_args("connect4", **sets)
    net = NNetWrapper(get_env("connect4"), args, device="cpu")
    assert C.coach_shapes_phase(get_env("connect4"), net, "cpu", args) == {
        "descend": 0.0, "backup": 0.0}


def test_chip_smoke_multileaf_coach_phase_rehearses_on_cpu(tmp_path):
    """The multi-leaf Coach phase at a tiny size on the CPU: a warmup
    iteration, then a resumed call whose self-play plays the iteration-1
    network over the int8 tower at leaf_batch 4; the int8 forwards
    counted a network call each (rounds and single simulations)."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(REPO))
    sets = dict(C.LEAF_COACH_CUTS, process_batch_size=4, gamesPerIteration=4,
                numMCTSSims=11, numFastSims=6, train_batch_size=8,
                deviceWindowRows=16384, leaf_batch=4, num_channels=8,
                depth=1, value_head_channels=2, policy_head_channels=2,
                value_dense_layers=[8], policy_dense_layers=[8])
    co = C.coach_phase("cpu", str(tmp_path), dict(sets, numIters=1),
                       resume=dict(sets, numIters=2))
    assert co["launches"] == dict.fromkeys(C.COUNTED, 0)
    assert sorted(co["iters"]) == [1, 2]
    assert co["iters"][1]["int8"] == {"self_play": 0.0}
    assert co["iters"][2]["int8"] == {"self_play": 1.0}
    # Fewer network calls than simulations: rounds of 4 leaves.
    assert 0 < co["int8_forwards"] < co["iters"][2]["self_play_sims"]


def test_chip_smoke_tafl_phases_rehearse_on_cpu(tmp_path, capsys,
                                                monkeypatch):
    """The tafl phases (the kernels at tafl search snapshots, hnefatafl
    self-play with its sparse records and breakdown, the hnefatafl int8
    tower, the reference search, and the brandubh Coach through
    cli.train.main with its checks) at a tiny size on the CPU, and their
    four kernel records."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(REPO))
    tiny = dict(process_batch_size=8, numMCTSSims=12, numFastSims=4,
                numWarmupSims=3, num_channels=8, depth=1,
                value_head_channels=2, policy_head_channels=2,
                value_dense_layers=[16], policy_dense_layers=[16],
                deviceWindowRows=16384, train_batch_size=64)
    preset = C.preset_args
    monkeypatch.setattr(C, "preset_args",
                        lambda name, **kw: preset(name, **{**tiny, **kw}))
    monkeypatch.setattr(C, "TAFL_SNAPSHOTS", {
        ("hnefatafl", 12): (3, 11), ("hnefatafl", 4): (2, 3),
        ("brandubh", 12): (3, 11), ("brandubh", 4): (3,)})
    monkeypatch.setattr(C, "BRANDUBH_ARENA_GAMES", 8)
    monkeypatch.setattr(C, "TAFL_REFERENCE", dict(batch=8, sims=8, rows=101))
    monkeypatch.setattr(C, "HOST_CALLS", 2)
    monkeypatch.setattr(C, "BRANDUBH_COACH_CUTS", dict(
        C.BRANDUBH_COACH_CUTS, gamesPerIteration=8, arenaCompare=8, **tiny))
    monkeypatch.setattr(tempfile, "TemporaryDirectory",
                        lambda: _Dir(tmp_path))
    records, int8 = C.tafl_phases("cpu", "cpu")
    out = capsys.readouterr().out
    assert int8["rows"] == 8 * 121 and not int8["agreement_gated"]
    assert "hnefatafl int8 tower at B=8" in out
    assert [r["name"] for r in records] == [
        "descend@hnefatafl", "backup@hnefatafl", "descend@brandubh",
        "backup@brandubh"]
    assert [(r["N"], r["B"]) for r in records] == [(15, 8)] * 4
    assert all(r["max_abs_err"] == 0.0 and r["launches"] == 0
               and r["bound_ms"] > 0 for r in records)
    assert "hnefatafl self-play" in out and "(stage expand)" in out
    assert "brandubh coach cycle through cli.train.main" in out
    assert "arena past" in out and "arena baseline" not in out


def test_chip_smoke_env_phases_rehearse_on_cpu(tmp_path, capsys,
                                               monkeypatch):
    """The phases of the other envs (rollouts of every new env, the
    kernels at chess and nim3 search snapshots, the batch-major kernels on
    nim3 reuse trees, the kernels at stratego's shapes, chess self-play
    with its
    breakdown and reference search, one fast and one full move of every
    other env, the three-model nim3 arena, and the othello Coach through
    cli.train.main with its checks) at a tiny size on the CPU, and their
    four kernel records."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(REPO))
    tiny = dict(process_batch_size=8, numMCTSSims=12, numFastSims=4,
                numWarmupSims=3, num_channels=8, depth=1,
                value_head_channels=2, policy_head_channels=2,
                value_dense_layers=[16], policy_dense_layers=[16],
                deviceWindowRows=16384, train_batch_size=64)
    preset = C.preset_args
    monkeypatch.setattr(C, "preset_args",
                        lambda name, **kw: preset(name, **{**tiny, **kw}))
    monkeypatch.setattr(C, "ROLLOUT_ENVS", {
        "tictactoe": (8, None), "nim3": (8, None), "othello": (4, 12),
        "gobang": (4, 12), "stratego": (4, 12), "chess": (8, 12),
        "othello_x4": (4, 12)})
    monkeypatch.setattr(C, "CHESS_SNAPSHOTS", {12: (3, 11), 4: (2, 3)})
    monkeypatch.setattr(C, "NIM_GAMES", 8)
    monkeypatch.setattr(C, "NIM_SNAPSHOTS", (3, 11))
    monkeypatch.setattr(C, "NIM_REUSE_SNAPSHOTS", (0, 5, 11))
    monkeypatch.setattr(C, "STRATEGO_SNAPSHOTS", {12: (3, 11), 4: (2, 3)})
    monkeypatch.setattr(C, "CHESS_REFERENCE", dict(batch=4, sims=6,
                                                    rows=101))
    monkeypatch.setattr(C, "NIM_ARENA_GAMES", 6)
    monkeypatch.setattr(C, "HOST_CALLS", 2)
    monkeypatch.setattr(C, "OTHELLO_COACH_CUTS", dict(
        C.OTHELLO_COACH_CUTS, gamesPerIteration=8, arenaCompare=8, **tiny))
    monkeypatch.setattr(tempfile, "TemporaryDirectory",
                        lambda: _Dir(tmp_path))
    records = C.env_phases("cpu", "cpu")
    out = capsys.readouterr().out
    assert [r["name"] for r in records] == [
        "descend@chess", "backup@chess", "descend@nim3", "backup@nim3",
        "descend_rows@nim3_reuse", "backup_rows@nim3_reuse"]
    assert [(r["N"], r["B"]) for r in records] == [(15, 8)] * 4 + [(27, 8)] * 2
    assert all(r["max_abs_err"] == 0.0 and r["launches"] == 0
               and r["bound_ms"] > 0 for r in records)
    for name in C.ROLLOUT_ENVS:
        assert f"  {name}: " in out and "== cpu" in out
    for name in C.SELFPLAY_ENVS:
        assert f"  {name} self-play:" in out
    assert "chess self-play" in out and "(stage expand)" in out
    assert "nim3 three-model arena: 6 games" in out
    assert "stratego: B=8, 12 simulations, A = 1280" in out
    assert "nim3 reuse self-play (N = 27)" in out
    assert "othello coach cycle through cli.train.main" in out
    assert "arena past" in out and "arena baseline" not in out


def test_chip_smoke_player_phases_rehearse_on_cpu(tmp_path, capsys,
                                                  monkeypatch):
    """The player phases (the batch-major kernels at one game on random
    trees and at MCTSPlayer and chess analysis snapshots; pit, analyze and
    the evaluator's thread; roundrobin, pitmulti and clean through their
    ``main``) at a tiny size on the CPU, where no kernel launches, and
    their eight kernel records at B = 1."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(REPO))
    tiny = dict(num_channels=8, depth=1, value_head_channels=2,
                policy_head_channels=2, value_dense_layers=[16],
                policy_dense_layers=[16])
    preset = C.preset_args
    monkeypatch.setattr(C, "preset_args",
                        lambda name, **kw: preset(name, **{**tiny, **kw}))
    for name, value in dict(
            PLAYER_NODES=(20, 41), SIMS_FULL=12, PLAYER_SNAPSHOTS=(3, 11),
            ANALYSIS_SIMS=10, ANALYSIS_SNAPSHOTS=(4, 9),
            ANALYSIS_C4_SIMS=(16, 30), PIT_SIMS=6,
            EVALUATOR_SIMS=400, EVALUATOR_SECONDS=1.0, TOURNAMENT_GAMES=4,
            TOURNAMENT_SIMS=4, HOST_CALLS=2).items():
        monkeypatch.setattr(C, name, value)
    monkeypatch.setattr(tempfile, "TemporaryDirectory",
                        lambda: _Dir(tmp_path))
    records = C.player_phases("cpu", "cpu")
    out = capsys.readouterr().out
    assert [r["name"] for r in records] == [
        f"{k}@{name}_b1" for name in ("connect4", "connect4_n19",
                                      "connect4_n33", "chess")
        for k in ("descend_rows", "backup_rows")]
    assert [r["N"] for r in records] == [15, 15, 19, 19, 33, 33, 13, 13]
    assert all(r["B"] == 1 for r in records)
    assert all(r["max_abs_err"] == 0.0 and r["launches"] == 0
               and r["bound_ms"] > 0 for r in records)
    assert "p1 mcts: " in out and "sims/s" in out and "p1 nativemcts" in out
    assert "analyze chess (10 simulations, N = 13)" in out
    assert "background evaluator, connect4, max_sims 400" in out
    assert "roundrobin, 3 contestants" in out and "pitmulti, 2" in out
    assert not (tmp_path / "tournament" / "checkpoint" / "rr").exists()


def test_chip_smoke_main_runs_every_phase_in_order(monkeypatch, capsys):
    """``main`` runs every group of phases, in order, and joins their
    kernel records into the kernels line before the ok line."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(REPO))
    ran = []
    monkeypatch.setattr(C, "device_phase", lambda: ("card", 1, "card, 1 W"))
    monkeypatch.setattr(C, "build_phase", lambda: None)
    monkeypatch.setattr(C, "launch_floor_ms", lambda device: 0.001)
    groups = ("connect4", "tafl", "env", "player", "search_layer",
              "multi_device", "gui")
    for group in groups:
        record = [{"name": group}]
        result = {"connect4": (record, {}, {}), "tafl": (record, {}),
                  "search_layer": (record, {}),
                  "multi_device": (record, {}),
                  "gui": (record, {})}.get(group, record)
        monkeypatch.setattr(C, f"{group}_phases",
                            lambda d, smi, *rest, g=group, r=result:
                            ran.append(g) or r)
    assert C.main() == 0 and ran == list(groups)
    lines = capsys.readouterr().out.strip().splitlines()
    assert '"ok": true' in lines[-1]
    assert [r["name"] for r in json.loads(lines[-2])["kernels"]] == list(
        groups)
    assert json.loads(lines[-4]) == {"gui": {"card": "card, 1 W"}}


def test_chip_smoke_gui_phase_rehearses_on_cpu(tmp_path, capsys,
                                               monkeypatch):
    """Phase 33 at a tiny size on the CPU, where no kernel launches: the
    GUI server in this process over HTTP (connect4 against ``mcts:``, the
    evaluator, chess, stratego, tictactoe hot-seat and networked), the
    train panel paused, run to its end and a second session stopped, then
    both batch-major kernels' records at the evaluator's tree."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(REPO))
    preset = C.preset_args
    monkeypatch.setattr(C, "preset_args",
                        lambda name, **kw: preset(name, **{**TINY_NET, **kw}))
    for name, value in dict(
            GUI_SIMS=8, GUI_EVAL_SIMS=30, GUI_EVAL_SNAPSHOTS=(5, 29),
            GUI_PAUSE_S=0.5, HOST_CALLS=2,
            GUI_TRAIN_CUTS=dict(
                C.GUI_TRAIN_CUTS, process_batch_size=8,
                gamesPerIteration=48, arenaCompareBaseline=4,
                arenaCompare=4, numMCTSSims=4, train_batch_size=16,
                deviceWindowRows=16384, **TINY_NET)).items():
        monkeypatch.setattr(C, name, value)
    monkeypatch.setattr(tempfile, "TemporaryDirectory",
                        lambda: _Dir(tmp_path))
    records, numbers = C.gui_phases("cpu", "cpu")
    assert [r["name"] for r in records] == [
        "descend_rows@gui_connect4_b1", "backup_rows@gui_connect4_b1"]
    for r in records:
        assert r["max_abs_err"] == 0.0 and r["launches"] == 0
        assert r["N"] == 33 and r["B"] == 1 and r["bound_ms"] > 0
    assert numbers["agent_ms"] > 0 and numbers["evaluator_sims_per_s"] > 0
    assert {"self_play", "train", "arena_baseline",
            "arena_past"} <= set(numbers["train_times"])
    assert numbers["stop_s"] < C.GUI_STOP_S
    out = capsys.readouterr().out
    assert "GUI play: connect4 against mcts: at 8 simulations" in out
    assert "GUI train panel" in out and "GUI stop" in out
    assert (tmp_path / "train" / "checkpoint" / "gui"
            / "iteration-0001.ckpt").exists()


#: The multi-device phases at a tiny size: 8 games (4 a rank), an
#: 8-channel one-block net, 2 train steps through the group of one.
TINY_NET = dict(num_channels=8, depth=1, value_head_channels=2,
                policy_head_channels=2, value_dense_layers=[8],
                policy_dense_layers=[8])


def _tiny_multi(C):
    small = dict(process_batch_size=8, train_batch_size=8,
                 deviceWindowRows=16384, **TINY_NET)
    return dict(
        C.MULTI, games=8, sims_full=12, sims_fast=3,
        model=dict(TINY_NET, compute_dtype="bfloat16"), nccl_steps=2,
        nccl_batch=8, train_batch=8, snapshots=(4,),
        reuse_cycle=("full", "full"), reuse_sims=3, reuse_snapshots=(2,),
        reps=1, deadline=300,
        coach=dict(C.MULTI_COACH_CUTS, gamesPerIteration=8, arenaCompare=4,
                   arenaCompareBaseline=4, numMCTSSims=4, **small),
        resume=dict(C.MULTI_RESUME_CUTS, gamesPerIteration=8,
                    numMCTSSims=6, numFastSims=3, **small))


def test_chip_smoke_multi_device_phases_rehearse_on_cpu(capsys):
    """Phases 31-32 at a tiny size on the CPU: the group of one rank
    (Gloo here, NCCL on the card) from torchrun's variables, then two
    ranks of the script over Gloo, with every check of the phase (the
    table moves against this process's, the train step, the Coach's files,
    weights, coins and gating); their kernel records and log lines."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(REPO))
    records, numbers = C.multi_device_phases("cpu", "cpu", _tiny_multi(C))
    assert [r["name"] for r in records] == [
        f"{k}@connect4_{tag}rank{r}_of_2" for r in (0, 1)
        for k, tag in (("descend", ""), ("backup", ""),
                       ("descend_rows", "reuse_"), ("backup_rows", "reuse_"))]
    for r in records:
        assert r["max_abs_err"] == 0.0 and r["launches"] == 0
        assert {"ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"} <= set(r)
    assert numbers["nccl"]["backend"] == "gloo"
    assert numbers["nccl"]["max_err"] == 0.0
    assert numbers["sims_per_s"]["two_ranks"] > 0
    assert {"self_play", "train", "arena_baseline",
            "arena_past"} <= set(numbers["coach_times"])
    out = capsys.readouterr().out
    assert "NCCL at world size 1" in out and "two ranks on one card" in out
    assert not C.M.is_distributed()


def test_chip_smoke_fails_when_a_rank_fails(tmp_path):
    """A rank that exits non-zero fails phase 32 at once, with the ranks'
    output, and the other rank is stopped: 9 games do not split over two
    ranks, which each rank finds before its first collective."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(REPO))
    sizes = dict(_tiny_multi(C), games=9, device="cpu", threads=1)
    with pytest.raises(C.SmokeFailure, match="(?s)exited 1.*does not split"):
        C.run_ranks(str(tmp_path), sizes)


def test_parallel_modules_stand_alone():
    """The parallel layer is among the modules whose imports are held free
    of JAX above."""
    mods = set(_port_modules())
    assert {"alphazero_general_tpu_torch.parallel",
            "alphazero_general_tpu_torch.parallel.mesh"} <= mods


def test_gui_modules_stand_alone():
    """The GUI server is among the modules whose imports are held free of
    JAX above."""
    mods = set(_port_modules())
    assert {"alphazero_general_tpu_torch.gui",
            "alphazero_general_tpu_torch.gui.server"} <= mods


class _Dir:
    """A TemporaryDirectory stand-in that yields a pytest tmp_path."""

    def __init__(self, path):
        self.path = path

    def __enter__(self):
        return str(self.path)

    def __exit__(self, *exc):
        return False
