"""The port's GUI server (alphazero_general_tpu_torch/gui/server.py) and the
Coach's status, pause and stop surface, against the JAX package's.

* The JAX GUI's tests (tests/test_evaluator_gui.py, marked slow there) run
  against the port's server on the CPU (``handler_for("cpu")``): the page,
  the lookups, play against rawmcts, the train panel, chess, stratego,
  the args endpoint, hot-seat and networked play, TensorBoard (bound to
  the GUI's own host) and the page's contract; then the panel's pause and
  stop.
* Views: the same seeded random clicks in hot-seat sessions of both
  packages (neither evaluator started), on eight envs; at every position
  the view's fields equal, and for every valid action the cell, the arrow
  and the clicks mapped back.
* Agent replies: ``nativemcts`` sessions of both packages (the same C++
  source) answer the same human clicks alike on tictactoe and connect4.
* The Coach: the sequence of ``state`` values of a tictactoe iteration
  equals the JAX Coach's; both Coaches stopped at the k-th self-play move
  (JAX's draws injected into the port) keep equal samples and counts; a
  paused Coach makes no move until the pause is cleared.
* The device: ``main`` serves on ``cuda`` by default, and a session there
  fails with an error on a host without CUDA.
"""

import inspect
import json
import os
import re
import socket
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from alphazero_general_tpu.envs import get_env as j_get_env
from alphazero_general_tpu.gui import server as jsrv
from alphazero_general_tpu.models.wrapper import NNetWrapper as JWrapper
from alphazero_general_tpu.train import Coach as JCoach
from alphazero_general_tpu.utils import config as JC
from alphazero_general_tpu_torch.envs import get_env
from alphazero_general_tpu_torch.gui import server as srv
from alphazero_general_tpu_torch.models import NNetWrapper
from alphazero_general_tpu_torch.train import Coach, TrainState
from alphazero_general_tpu_torch.utils import config as C
from test_torch_arena import JaxDraws

# Small tensors: one intra-op thread (several test processes share the
# host's cores).
torch.set_num_threads(1)


def _serve(handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture(scope="module")
def gui_server():
    server = _serve(srv.handler_for("cpu"))
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()


def api(base, path, body=None):
    req = urllib.request.Request(
        base + path,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"},
        method="POST" if body is not None else "GET",
    )
    try:
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read()), r.status
    except urllib.error.HTTPError as e:
        return json.loads(e.read()), e.code


def _wait_train(base, deadline_s):
    """The panel's status once it stops running (or at the deadline)."""
    deadline = time.time() + deadline_s
    while True:
        st, _ = api(base, "/api/train/status")
        if not st["running"] or time.time() > deadline:
            return st
        time.sleep(0.1)


#: JAX's train-panel overrides (tests/test_evaluator_gui.py:141-153), with
#: a device window of 16384 rows instead of the default 2M.
TRAIN_OVERRIDES = {
    "numIters": 1, "gamesPerIteration": 4,
    "process_batch_size": 4, "numMCTSSims": 3, "numFastSims": 2,
    "numWarmupSims": 2, "arenaCompare": 4,
    "arenaCompareBaseline": 4, "num_channels": 4, "depth": 1,
    "value_dense_layers": [8], "policy_dense_layers": [8],
    "value_head_channels": 2, "policy_head_channels": 2,
    "compute_dtype": "float32", "train_batch_size": 8,
    "run_name": "webtrain", "deviceWindowRows": 16384,
}


# --------------------------------------------------------------------------
# JAX's GUI tests against the port's server
# --------------------------------------------------------------------------

class TestGuiServer:
    def test_index_serves_html(self, gui_server):
        with urllib.request.urlopen(gui_server + "/") as r:
            body = r.read().decode()
        assert "alphazero_general_tpu_torch" in body and "<table" in body

    def test_envs_listed(self, gui_server):
        out, status = api(gui_server, "/api/envs")
        assert status == 200
        assert "connect4" in out["envs"]

    def test_full_game_flow(self, gui_server):
        out, status = api(gui_server, "/api/new", {
            "env": "tictactoe", "opponent": "rawmcts", "human_seat": 0,
            "sims": 25,
        })
        assert status == 200, out
        game = out["game"]
        assert len(out["board"]) == 3
        assert not out["terminal"]
        assert srv._SESSIONS[game].state.board.device.type == "cpu"

        out, status = api(gui_server, "/api/move",
                          {"game": game, "to": [1, 1]})
        assert status == 200, out
        assert sum(1 for row in out["board"] for c in row if c) == 2
        assert out["player"] == 0

        out, _ = api(gui_server, "/api/move", {"game": game, "to": [1, 1]})
        assert out["message"] == "illegal move"

        out, _ = api(gui_server, "/api/undo", {"game": game})
        assert sum(1 for row in out["board"] for c in row if c) == 0

    def test_unknown_game_404(self, gui_server):
        out, status = api(gui_server, "/api/move",
                          {"game": "nope", "to": [0, 0]})
        assert status == 404


class TestTrainPanel:
    def test_train_via_api(self, gui_server, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)  # keep checkpoint/data/runs out of repo
        out, status = api(gui_server, "/api/train/start", {
            "env": "tictactoe", "overrides": TRAIN_OVERRIDES})
        assert status == 200 and out.get("ok"), out
        st, _ = api(gui_server, "/api/train/status")
        if st["running"]:
            out2, _ = api(gui_server, "/api/train/start",
                          {"env": "tictactoe"})
            assert "error" in out2
        final = _wait_train(gui_server, 120)
        assert not final["running"], final
        assert final["error"] is None, final
        assert final["model_iter"] >= 2
        assert final["state"] == "STANDBY"
        assert os.path.exists("checkpoint/webtrain/iteration-0001.ckpt")
        assert srv._TRAIN.coach.train_net.device.type == "cpu"

    def test_pause_and_stop_endpoints(self, gui_server):
        out, _ = api(gui_server, "/api/train/pause", {})
        assert "paused" in out or "error" in out
        out, _ = api(gui_server, "/api/train/stop", {})
        assert "ok" in out or "error" in out

    def test_pause_holds_and_stop_ends_self_play(self, gui_server, tmp_path,
                                                 monkeypatch):
        """A session paused in self-play finishes no game while paused and
        goes on when resumed; stopped, it leaves self-play and ``learn``
        and ends in STANDBY without training."""
        monkeypatch.chdir(tmp_path)
        out, _ = api(gui_server, "/api/train/start", {
            "env": "tictactoe", "overrides": dict(
                TRAIN_OVERRIDES, gamesPerIteration=100000,
                run_name="webstop")})
        assert out.get("ok"), out
        deadline = time.time() + 60
        st = {}
        while time.time() < deadline:
            st, _ = api(gui_server, "/api/train/status")
            if st["state"] == "SELF_PLAY" and st["games_played"] > 0:
                break
            time.sleep(0.05)
        assert st["state"] == "SELF_PLAY" and st["games_played"] > 0, st
        out, _ = api(gui_server, "/api/train/pause", {})
        assert out == {"paused": True}
        time.sleep(0.5)  # the move in flight ends
        held, _ = api(gui_server, "/api/train/status")
        time.sleep(1.5)
        st, _ = api(gui_server, "/api/train/status")
        assert st["paused"] and st["state"] == "SELF_PLAY"
        assert st["games_played"] == held["games_played"], (held, st)
        out, _ = api(gui_server, "/api/train/pause", {})
        assert out == {"paused": False}
        deadline = time.time() + 30
        while time.time() < deadline and st["games_played"] == held[
                "games_played"]:
            time.sleep(0.05)
            st, _ = api(gui_server, "/api/train/status")
        assert st["games_played"] > held["games_played"], st
        out, _ = api(gui_server, "/api/train/stop", {})
        assert out == {"ok": True}
        final = _wait_train(gui_server, 30)
        assert not final["running"] and final["state"] == "STANDBY", final
        assert final["error"] is None and final["model_iter"] == 1, final
        assert not os.path.exists("checkpoint/webstop/iteration-0001.ckpt")
        assert os.path.exists("data/webstop/iteration-0001.npz")


class TestChessStrategoWeb:
    def test_chess_flow(self, gui_server):
        out, status = api(gui_server, "/api/new", {
            "env": "chess", "opponent": "rawmcts", "human_seat": 0,
            "sims": 4,
        })
        assert status == 200, out
        game = out["game"]
        assert out["needs_two_clicks"]
        assert out["board"][6][4] == "♙"  # white pawn on e2
        assert out["board"][0][4] == "♚"  # black king on e8
        out, status = api(gui_server, "/api/move",
                          {"game": game, "from": [6, 4], "to": [4, 4]})
        assert status == 200, out
        assert out["board"][4][4] == "♙"
        assert out["turns"] == 2
        assert out["player"] == 0

    def test_stratego_placement_flow(self, gui_server):
        out, status = api(gui_server, "/api/new", {
            "env": "stratego", "opponent": "rawmcts", "human_seat": 0,
            "sims": 4,
        })
        assert status == 200, out
        game = out["game"]
        counts = dict((k, v) for k, v in out["place_counts"])
        assert counts["F"] == 1 and counts["B"] == 5
        out, status = api(gui_server, "/api/move",
                          {"game": game, "to": [0, 0], "piece": "F"})
        assert status == 200, out
        assert out["board"][0][0] == "F"
        counts = dict((k, v) for k, v in out["place_counts"])
        assert counts["F"] == 0
        assert out["turns"] == 2
        blues = [c for row in out["board"] for c in row
                 if c and c[0] == "?"]
        assert len(blues) == 1


class TestGuiFidelity:
    def test_args_endpoint(self, gui_server):
        out, status = api(gui_server, "/api/args?env=connect4")
        assert status == 200
        assert out["args"]["numMCTSSims"] > 0
        assert all(not k.startswith("_") for k in out["args"])
        assert str(out["args"]["temp_scaling_fn"]).startswith("__CALLABLE__")

    def test_hotseat_two_humans(self, gui_server):
        out, _ = api(gui_server, "/api/new",
                     {"env": "tictactoe", "opponent": "hotseat",
                      "human_seat": 0})
        game = out["game"]
        assert out["mode"] == "hotseat"
        out, _ = api(gui_server, "/api/move", {"game": game, "to": [0, 0]})
        assert out["player"] == 1 and out["turns"] == 1
        out, _ = api(gui_server, "/api/move", {"game": game, "to": [1, 1]})
        assert out["player"] == 0 and out["turns"] == 2
        assert out["last_move"] == [1, 1]

    def test_networked_join_and_turn_tokens(self, gui_server):
        out, _ = api(gui_server, "/api/new",
                     {"env": "tictactoe", "opponent": "human",
                      "human_seat": 0})
        game, tok0 = out["game"], out["token"]
        out, _ = api(gui_server, "/api/move",
                     {"game": game, "to": [0, 0], "token": tok0})
        assert out["turns"] == 0
        out, _ = api(gui_server, "/api/join", {"game": game})
        tok1 = out["token"]
        assert out["seat"] == 1
        out, _ = api(gui_server, "/api/join", {"game": game})
        assert out["error"] == "game is full"
        out, _ = api(gui_server, "/api/move",
                     {"game": game, "to": [0, 0], "token": tok1})
        assert out["turns"] == 0 and "not your turn" in out["message"]
        out, _ = api(gui_server, "/api/move",
                     {"game": game, "to": [0, 0], "token": tok0})
        assert out["turns"] == 1
        out, _ = api(gui_server, "/api/move",
                     {"game": game, "to": [1, 1], "token": tok1})
        assert out["turns"] == 2
        out, _ = api(gui_server, "/api/move",
                     {"game": game, "to": [2, 2], "token": "nope"})
        assert out["turns"] == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class TestTensorBoardLauncher:
    def test_status_then_start_stop(self, gui_server, tmp_path):
        out, status = api(gui_server, "/api/tensorboard")
        assert status == 200 and out["running"] is False
        port = _free_port()
        out, status = api(gui_server, "/api/tensorboard/start",
                          {"logdir": str(tmp_path), "port": port})
        assert status == 200
        if out.get("running"):
            assert out["url"].startswith(f"http://127.0.0.1:{port}")
            assert out["logdir"] == str(tmp_path)
            # Bound to the GUI's own host, not to every interface.
            argv = srv._TENSORBOARD.proc.args
            assert argv[argv.index("--host") + 1] == "127.0.0.1"
            st, _ = api(gui_server, "/api/tensorboard")
            assert st["running"] is True
        else:
            assert "error" in out
        out, status = api(gui_server, "/api/tensorboard/stop", {})
        assert status == 200 and out["running"] is False

    def test_binds_to_the_gui_host(self, gui_server, monkeypatch):
        """TensorBoard listens on the address the GUI listens on (the JAX
        GUI gives it 0.0.0.0), whether or not it starts on this host."""
        import importlib.util
        import subprocess

        started = []

        class Proc:
            def __init__(self, argv, **kw):
                self.args = argv
                started.append(argv)

            def poll(self):
                return None

            def terminate(self):
                pass

            def wait(self, timeout=None):
                return 0

        find_spec = importlib.util.find_spec
        monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
            object() if name == "tensorboard" else find_spec(name, *a)))
        monkeypatch.setattr(subprocess, "Popen", Proc)
        connect = socket.create_connection

        def probe(addr, *a, **k):
            return socket.socket() if addr[1] == 6006 else connect(addr, *a,
                                                                   **k)

        monkeypatch.setattr(socket, "create_connection", probe)
        out, status = api(gui_server, "/api/tensorboard/start",
                          {"logdir": "runs", "port": 6006})
        assert status == 200 and out["running"], out
        argv = started[0]
        assert argv[argv.index("--host") + 1] == "127.0.0.1"
        assert argv[argv.index("--port") + 1] == "6006"
        out, _ = api(gui_server, "/api/tensorboard/stop", {})
        assert out["running"] is False


class TestPageContract:
    def test_page_serves_canvas_ui(self, gui_server):
        with urllib.request.urlopen(f"{gui_server}/") as r:
            page = r.read().decode()
        assert 'canvas id="board"' in page
        assert 'id="evalbar"' in page and 'id="evallabel"' in page
        assert "hint_moves" in page and "bad_moves" in page
        called = set(re.findall(r"api\('(/api/[\w/]+)'", page))
        assert called, "page should call the JSON API"
        handler_src = inspect.getsource(srv.Handler)
        for ep in called:
            assert ep in handler_src, f"page calls unknown endpoint {ep}"
        # Every endpoint of JAX's handler is the port's.
        endpoints = set(re.findall(r'"(/api/[\w/]+)"',
                                   inspect.getsource(jsrv.Handler)))
        assert endpoints and endpoints <= set(re.findall(
            r'"(/api/[\w/]+)"', handler_src))


# --------------------------------------------------------------------------
# Views, exactly as the JAX package's
# --------------------------------------------------------------------------

class _JittedEnv:
    """A JAX env whose step, valid_moves and win_state run jitted (the JAX
    session calls them on one state, op by op otherwise)."""

    def __init__(self, env):
        self._env = env
        self.step = jax.jit(env.step)
        self.valid_moves = jax.jit(env.valid_moves)
        self.win_state = jax.jit(env.win_state)

    def __getattr__(self, name):
        return getattr(self._env, name)


VIEW_KEYS = ("board", "terminal", "turns", "player", "needs_two_clicks",
             "last_move", "message", "place_counts")
#: Plies of each view parity run (stratego: its 80 placements, then moves).
VIEW_PLIES = {"connect4": 12, "tictactoe": 9, "othello": 10, "gobang": 10,
              "chess": 8, "stratego": 84, "brandubh": 8, "hnefatafl": 4}


def _sessions(name, opponent, monkeypatch, seat=0):
    """The JAX and the port's session of ``name`` on the CPU, with neither
    evaluator started."""
    from alphazero_general_tpu.envs import stratego as JS

    # The JAX session's phase check runs op by op otherwise.
    monkeypatch.setattr(JS.Stratego, "_play_phase",
                        staticmethod(jax.jit(JS.Stratego._play_phase)))
    js = jsrv.GameSession(name, opponent, seat)
    js.env = _JittedEnv(js.env)
    ts = srv.GameSession(name, opponent, seat, device="cpu")
    for s in (js, ts):
        s.evaluator.start = lambda state: None
    return js, ts


def _clicks(sess, a, name):
    """The clicks of action ``a`` as the view draws its arrow: (from, to,
    piece)."""
    m = sess._move_of_action(a)
    piece = None
    if name == "stratego" and m[0] is None:
        piece = srv.STRATEGO_RANKS[a // 80]
    return (None if m[0] is None else m[:2]), m[2:], piece


def _underpromotion(sess, a):
    from alphazero_general_tpu_torch.envs.chess import action_to_uci

    uci = action_to_uci(sess._host(), a)
    return len(uci) == 5 and uci[4] != "q"


@pytest.mark.parametrize("name", sorted(VIEW_PLIES))
def test_views_match_jax(name, monkeypatch):
    js, ts = _sessions(name, "hotseat", monkeypatch)
    rng = np.random.default_rng(7)
    for ply in range(VIEW_PLIES[name] + 1):
        want, got = js.view(), ts.view()
        for key in VIEW_KEYS:
            assert got.get(key) == want.get(key), (name, ply, key)
        if got["terminal"] or ply == VIEW_PLIES[name]:
            break
        valid = np.flatnonzero(np.asarray(js.env.valid_moves(js.state)))
        np.testing.assert_array_equal(
            valid, np.flatnonzero(ts.env.valid_moves(ts.state)[0].numpy()))
        for a in valid.tolist():
            assert ts._cell_of_action(a) == js._cell_of_action(a), (ply, a)
            assert ts._move_of_action(a) == js._move_of_action(a), (ply, a)
            frm, to, piece = _clicks(ts, a, name)
            back = ts._action_from_clicks(frm, to, piece)
            assert back == js._action_from_clicks(frm, to, piece), (ply, a)
            if not (name == "chess" and _underpromotion(ts, a)):
                assert back == a, (ply, a, back)
        frm, to, piece = _clicks(ts, int(rng.choice(valid)), name)
        want, got = (s.human_move(frm, to, piece) for s in (js, ts))
        for key in VIEW_KEYS:
            assert got.get(key) == want.get(key), (name, ply, key)
    assert ts.history[-1] is ts.state and len(ts.history) == ply + 1


@pytest.mark.parametrize("name", ["tictactoe", "connect4"])
def test_native_agent_replies_match_jax(name, monkeypatch):
    """A ``nativemcts`` session answers the same human clicks with the same
    moves as the JAX package's (the same native/azg_native.cpp)."""
    js, ts = _sessions(name, "nativemcts", monkeypatch)
    assert type(ts.opponent).__name__ == "NativeRawMCTSPlayer"
    rng = np.random.default_rng(3)
    for _ in range(6):
        valid = np.flatnonzero(ts.env.valid_moves(ts.state)[0].numpy())
        frm, to, piece = _clicks(ts, int(rng.choice(valid)), name)
        want, got = (s.human_move(frm, to, piece) for s in (js, ts))
        for key in VIEW_KEYS:
            assert got.get(key) == want.get(key), key
        if got["terminal"]:
            break
    assert got["turns"] >= 4


def test_nativemcts_falls_back_to_rawmcts_as_jax_does():
    """The C++ engine has no chess: the session's opponent is the device's
    rawmcts, as the JAX GUI swaps it (gui/server.py:375-376)."""
    sess = srv.GameSession("othello", "nativemcts", 0, sims=4, device="cpu")
    assert type(sess.opponent).__name__ == "RawMCTSPlayer"
    assert sess.opponent.device.type == "cpu"
    assert sess.evaluator.device.type == "cpu"


# --------------------------------------------------------------------------
# The Coach's status, pause and stop surface
# --------------------------------------------------------------------------

#: JAX's tictactoe Coach test sizes (tests/test_coach.py:20-47), one
#: iteration, the float tower.
COACH = dict(
    seed=2, numIters=1, process_batch_size=8, gamesPerIteration=8,
    numMCTSSims=6, numFastSims=3, numWarmupSims=4, numWarmupIters=1,
    probFastSim=0.4, train_batch_size=16, arenaCompare=8,
    arenaCompareBaseline=8, arenaTemp=1.0, num_channels=8, depth=1,
    value_head_channels=2, policy_head_channels=2, value_dense_layers=[8],
    policy_dense_layers=[8], compute_dtype="float32",
    selfplay_chunk_moves=10, minTrainHistoryWindow=2,
    maxTrainHistoryWindow=4, quant_selfplay=False, deviceWindowRows=16384)


def _dirs(root, tag):
    return dict(run_name=tag, checkpoint=os.path.join(root, "checkpoint"),
                data=os.path.join(root, "data"),
                log_dir=os.path.join(root, "runs"))


def _recording(base):
    """``base`` whose ``state`` assignments are recorded in ``states`` and
    whose k-th self-play move (``stop_at``) sets ``stop_train``."""

    class Recording(base):
        stop_at = None

        @property
        def state(self):
            return self._state

        @state.setter
        def state(self, value):
            self._state = value
            self.__dict__.setdefault("states", []).append(value.name)

        def _counted(self, fns):
            def wrap(fn):
                def run(*a, **k):
                    self.moves += 1
                    if self.moves == self.stop_at:
                        self.stop_train.set()
                    return fn(*a, **k)
                return run
            return {kind: wrap(fn) for kind, fn in fns.items()}

    return Recording


class _JRecording(_recording(JCoach)):
    def _move_fns(self, quant=False):
        cfg, fns = super()._move_fns(quant)
        return cfg, self._counted(fns)


class _TRecording(_recording(Coach)):
    def _get_move_fns(self, model):
        return self._counted(super()._get_move_fns(model))


def _both(root, stop_at=None, **knobs):
    """The JAX Coach and the port's (JAX's weights and draws) of ``COACH``
    with ``knobs``, each run through ``learn``."""
    knobs = dict(COACH, **knobs)
    j_args = JC.get_args(mesh_batch_axis=1, **knobs, **_dirs(root, "jax"))
    j_env = j_get_env("tictactoe")
    jc = _JRecording(j_env, JWrapper(j_env, j_args), j_args)
    args = C.get_args(**knobs, **_dirs(root, "port"))
    env = get_env("tictactoe")
    net = NNetWrapper(env, args, device="cpu")
    net.load_jax_variables(jax.device_get(
        JWrapper(j_env, j_args).state.variables))
    tc = _TRecording(env, net, args, draws=JaxDraws(
        knobs["seed"], env_name="tictactoe"))
    for c in (jc, tc):
        c.moves, c.stop_at = 0, stop_at
        c.learn()
    return jc, tc


def test_coach_states_match_jax(tmp_path):
    """One iteration (warmup self-play, train, both arenas): the same
    sequence of states, from INIT to STANDBY."""
    jc, tc = _both(str(tmp_path))
    assert tc.states == jc.states
    assert tc.states[0] == "INIT" and tc.states[-1] == "STANDBY"
    assert {"SELF_PLAY", "SAVE_SAMPLES", "PROCESS_RESULTS", "TRAIN",
            "COMPARE_BASELINE", "COMPARE_PAST"} <= set(tc.states)
    assert tc.model_iter == jc.model_iter == 2
    assert [s.name for s in TrainState] == [s.name for s in type(
        jc._state)]


@pytest.mark.parametrize("k", [3, 12])
def test_coach_stopped_at_move_k_matches_jax(tmp_path, k):
    """Both Coaches stopped at the k-th self-play move (before the first
    read of the finished-game count, and after it): equal samples, games
    and iteration, both in STANDBY with no training done."""
    jc, tc = _both(str(tmp_path), stop_at=k, gamesPerIteration=64)
    assert tc.moves == jc.moves == k
    assert tc.games_played_iter == jc.games_played_iter < 64
    assert tc.model_iter == jc.model_iter == 1
    assert tc.state == TrainState.STANDBY and jc.state.name == "STANDBY"
    assert tc.states == jc.states
    assert "TRAIN" not in tc.states
    want, got = jc.store.load(1), tc.store.load(1)
    assert (got is None) == (want is None)
    if want is not None:
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    if k == 12:
        assert tc.games_played_iter > 0 and len(got[0]) > 0


def test_paused_coach_makes_no_move_until_resumed(tmp_path):
    args = C.get_args(**COACH, **_dirs(str(tmp_path), "paused"))
    env = get_env("tictactoe")
    coach = _TRecording(env, NNetWrapper(env, args, device="cpu"), args)
    coach.moves = 0
    coach.pause_train.set()
    t = threading.Thread(target=coach.learn, daemon=True)
    t.start()
    time.sleep(1.0)
    assert coach.moves == 0 and coach.state == TrainState.SELF_PLAY
    coach.pause_train.clear()
    t.join(timeout=120)
    assert not t.is_alive()
    assert coach.moves > 0 and coach.state == TrainState.STANDBY
    assert coach.model_iter == 2


def test_coach_stopped_before_its_first_move(tmp_path):
    """A stop set before ``learn`` leaves self-play before its first move
    and ``learn`` after it, with an empty sample file."""
    args = C.get_args(**COACH, **_dirs(str(tmp_path), "early"))
    env = get_env("tictactoe")
    coach = _TRecording(env, NNetWrapper(env, args, device="cpu"), args)
    coach.moves = 0
    coach.stop_train.set()
    coach.learn()
    assert coach.moves == 0 and coach.games_played_iter == 0
    assert coach.model_iter == 1 and coach.state == TrainState.STANDBY
    assert coach.states[-5:] == ["SELF_PLAY", "SAVE_SAMPLES",
                                 "PROCESS_RESULTS", "STANDBY", "STANDBY"]


# --------------------------------------------------------------------------
# The device
# --------------------------------------------------------------------------

def test_main_serves_on_cuda_by_default(monkeypatch):
    served = []

    class Server:
        def __init__(self, address, handler):
            served.append((address, handler))

        def serve_forever(self):
            pass

        def server_close(self):
            served.append("closed")

    monkeypatch.setattr(srv, "ThreadingHTTPServer", Server)
    assert srv.main(["--port", "0"]) == 0
    (address, handler), closed = served
    assert address == ("127.0.0.1", 0) and closed == "closed"
    assert handler.device == "cuda" and srv.Handler.device == "cuda"
    assert srv.main(["--port", "0", "--device", "cpu"]) == 0
    assert served[2][1].device == "cpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a host without CUDA")
def test_default_device_fails_without_cuda(tmp_path, monkeypatch):
    """Under the default device a session and the train panel fail with an
    error naming the flag, and nothing runs on the CPU instead."""
    monkeypatch.chdir(tmp_path)
    server = _serve(srv.Handler)
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        before = set(srv._SESSIONS)
        out, status = api(base, "/api/new", {"env": "tictactoe",
                                             "opponent": "rawmcts"})
        assert status == 500 and "--device cpu" in out["error"], out
        assert set(srv._SESSIONS) == before
        out, _ = api(base, "/api/train/start", {
            "env": "tictactoe", "overrides": dict(TRAIN_OVERRIDES,
                                                  run_name="nocuda")})
        assert "torch.cuda.is_available() is false" in out["error"], out
        assert not os.path.exists("checkpoint/nocuda")
    finally:
        server.shutdown()
        server.server_close()
    with pytest.raises(RuntimeError, match="--device cpu"):
        srv.GameSession("connect4", "hotseat", 0)
