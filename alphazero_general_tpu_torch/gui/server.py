"""Web play, live analysis and training — the GUI, the port of
alphazero_general_tpu/gui/server.py (reference: AlphaZeroGUI/main.py:
150-1022, CustomGUI.py:30-583; SURVEY.md §7.8 accepts a web UI).

Human-vs-agent play for any registered env, with the opponent picked from
the players (``nativemcts``, ``rawmcts``, or ``mcts:<checkpoint>`` through
the API), a live evaluator publishing a win-probability bar and best and
worst move hints, undo, human-vs-human play (hot-seat, or networked with
seat tokens), JSON endpoints usable programmatically, and a train panel
(start, pause, stop, polled status) over the port's Coach.

Everything runs on one device, the handler's ``device``: ``cuda`` unless
the server is started with ``--device cpu`` (the JAX GUI defaults to the
CPU). A session is one game (``env.init(1, device)``) searched by the
port's players and ``MCTSEvaluator`` (a batch-major tree of 403 rows,
both batch-major CUDA kernels a simulation on the card); the train panel
runs the port's Coach on a thread of its own (both game-minor kernels).
``view`` copies the fields it shows to the host once per position. On a
host without CUDA a session under ``cuda`` fails with an error; nothing
moves to the CPU on its own.

The TensorBoard button binds TensorBoard to the GUI's own host (the
address the server listens on), where the JAX GUI binds it to 0.0.0.0.

Run: ``python -m alphazero_general_tpu_torch.gui.server [--port 8000]
[--host 127.0.0.1] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import atexit
import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from alphazero_general_tpu_torch.envs import get_env, list_envs
from alphazero_general_tpu_torch.players.players import one_game
from alphazero_general_tpu_torch.utils.config import get_args

_PAGE = """<!DOCTYPE html>
<html><head><title>alphazero_general_tpu_torch</title><style>
body { font-family: system-ui, sans-serif; margin: 2em; background: #182026; color: #e8eaed; }
#board { margin: 1em 0; cursor: pointer; border-radius: 6px;
  box-shadow: 0 4px 18px rgba(0,0,0,0.45); display: block; }
#argtable td { padding: 2px 8px; font-size: 13px; }
#argtable input { background: #2b3440; color: #e8eaed;
  border: 1px solid #3a434d; padding: 3px 6px; width: 220px; }
#evalwrap { width: 380px; height: 18px; background: #8a3a3a; border-radius: 9px;
  overflow: hidden; position: relative; }
#evalbar { height: 100%; background: linear-gradient(90deg,#2e8f63,#3fae79);
  width: 50%; }
#evallabel { position: absolute; inset: 0; text-align: center; font-size: 12px;
  line-height: 18px; color: #fff; text-shadow: 0 1px 2px rgba(0,0,0,.6); }
button, select { background: #2b3440; color: #e8eaed; border: 1px solid #3a434d;
  padding: 6px 10px; border-radius: 4px; margin-right: 6px; }
#status { margin-top: 0.6em; min-height: 1.4em; }
</style></head><body>
<h2>alphazero_general_tpu_torch — play &amp; analyse</h2>
<div>
  <select id="env"></select>
  <select id="piece" style="display:none"></select>
  <select id="opp">
    <option value="nativemcts">native MCTS (fast)</option>
    <option value="rawmcts">raw MCTS (on the device)</option>
    <option value="hotseat">human — hot-seat</option>
    <option value="human">human — networked (share id)</option>
  </select>
  <select id="seat"><option value="0">I play first</option>
  <option value="1">opponent plays first</option></select>
  <button onclick="newGame()">new game</button>
  <button onclick="undo()">undo</button>
  <input id="joinid" placeholder="game id" style="width:110px;background:#2b3440;color:#e8eaed;border:1px solid #3a434d;padding:6px">
  <button onclick="joinGame()">join</button>
</div>
<div style="margin-top:1em">win probability (you)
  <div id="evalwrap"><div id="evalbar"></div><div id="evallabel">50%</div></div></div>
<canvas id="board" width="0" height="0"></canvas>
<div id="status">pick an env and press "new game"</div>
<hr style="border-color:#3a434d; margin:1.6em 0">
<h3>train</h3>
<div>
  <select id="tenv"></select>
  <input id="titers" type="number" value="2" min="1" style="width:70px;background:#2b3440;color:#e8eaed;border:1px solid #3a434d;padding:6px">
  <button onclick="trainStart()">start</button>
  <button onclick="trainPause()">pause/resume</button>
  <button onclick="trainStop()">stop</button>
  <button onclick="tensorboard()">tensorboard</button>
</div>
<div id="tstatus" style="margin-top:0.6em">idle</div>
<div style="margin-top:0.6em"><button onclick="toggleArgs()">edit args</button></div>
<table id="argtable" style="display:none; margin-top:0.6em"></table>
<script>
let game = null, sel = null, view = null, token = null, argDefaults = {};
async function api(path, body) {
  const r = await fetch(path, {method: body ? 'POST' : 'GET',
    headers: {'Content-Type': 'application/json'},
    body: body ? JSON.stringify(body) : undefined});
  return await r.json();
}
async function init() {
  const envs = await api('/api/envs');
  for (const id of ['env', 'tenv']) {
    const sel = document.getElementById(id);
    for (const e of envs.envs) {
      const o = document.createElement('option'); o.value = o.textContent = e;
      sel.appendChild(o);
    }
  }
  setInterval(pollTrain, 1000);
}
async function toggleArgs() {
  const tbl = document.getElementById('argtable');
  if (tbl.style.display !== 'none') { tbl.style.display = 'none'; return; }
  const r = await api('/api/args?env=' + document.getElementById('tenv').value);
  if (r.error) return;
  argDefaults = r.args;
  tbl.innerHTML = '';
  for (const [k, v] of Object.entries(r.args)) {
    const tr = document.createElement('tr');
    const td1 = document.createElement('td'); td1.textContent = k;
    const td2 = document.createElement('td');
    const inp = document.createElement('input');
    inp.id = 'arg_' + k; inp.value = JSON.stringify(v);
    td2.appendChild(inp);
    tr.appendChild(td1); tr.appendChild(td2); tbl.appendChild(tr);
  }
  tbl.style.display = '';
}
function collectArgOverrides() {
  const out = {numIters: parseInt(document.getElementById('titers').value)};
  for (const [k, v] of Object.entries(argDefaults)) {
    const inp = document.getElementById('arg_' + k);
    if (!inp) continue;
    let parsed;
    try { parsed = JSON.parse(inp.value); } catch { parsed = inp.value; }
    if (JSON.stringify(parsed) !== JSON.stringify(v)) out[k] = parsed;
  }
  return out;
}
async function trainStart() {
  const r = await api('/api/train/start', {
    env: document.getElementById('tenv').value,
    overrides: collectArgOverrides()});
  document.getElementById('tstatus').textContent = r.error || 'starting…';
}
async function trainPause() { await api('/api/train/pause', {}); }
async function trainStop() { await api('/api/train/stop', {}); }
async function tensorboard() {
  const s = await api('/api/tensorboard/start', {});
  if (s.url) window.open(s.url, '_blank');
  else alert(s.error || 'tensorboard failed to start');
}
async function pollTrain() {
  const s = await api('/api/train/status');
  if (!s.running && !s.state) return;
  document.getElementById('tstatus').textContent =
    `${s.state}  iter ${s.model_iter}  games ${s.games_played}  ` +
    `loss_pi ${s.loss_pi?.toFixed(3)}  loss_v ${s.loss_v?.toFixed(3)}  ` +
    `gated@${s.self_play_iter}` + (s.paused ? '  [paused]' : '') +
    (s.running ? '' : '  [finished]');
}
async function newGame() {
  const body = {env: document.getElementById('env').value,
    opponent: document.getElementById('opp').value,
    human_seat: parseInt(document.getElementById('seat').value)};
  const r = await api('/api/new', body);
  if (r.error) { setStatus(r.error); return; }
  game = r.game; token = r.token || null; render(r);
  if (r.mode === 'human') {
    setStatus('game id: ' + game + ' — share it; waiting for opponent');
  }
  pollState();
}
async function joinGame() {
  const id = document.getElementById('joinid').value.trim();
  if (!id) return;
  const r = await api('/api/join', {game: id});
  if (r.error) { setStatus(r.error); return; }
  game = id; token = r.token; render(r);
  pollState();
}
let polling = false;
async function pollState() {
  // Poll in every mode: networked games for the opponent's moves, agent
  // games so the live evaluator's evolving value/hints keep animating.
  if (polling) return; polling = true;
  while (game && view && !view.terminal) {
    await new Promise(res => setTimeout(res, 1200));
    const r = await api('/api/state?game=' + game);
    if (!r.error) { r.game = game; render(r); }
  }
  polling = false;
}
async function undo() {
  if (!game) return;
  render(await api('/api/undo', {game}));
}
function setStatus(s) { document.getElementById('status').textContent = s; }
function render(r) {
  if (r.error) { setStatus(r.error); return; }
  view = r;
  const pal = document.getElementById('piece');
  if (r.place_counts) {
    pal.style.display = '';
    const cur = pal.value;
    pal.innerHTML = '';
    for (const [name, cnt] of r.place_counts) {
      if (cnt <= 0) continue;
      const o = document.createElement('option');
      o.value = name; o.textContent = `${name} x${cnt}`;
      pal.appendChild(o);
    }
    if ([...pal.options].some(o => o.value === cur)) pal.value = cur;
  } else {
    pal.style.display = 'none';
  }
  drawBoard(r);
  animateEval(r.eval_for_human ?? 0.5);
  setStatus(r.message || '');
}
const CELL = 48;
function cellCenter(i, j) { return [j * CELL + CELL / 2, i * CELL + CELL / 2]; }
function drawBoard(r) {
  const cv = document.getElementById('board');
  const rows = r.board.length, cols = r.board[0].length;
  const dpr = window.devicePixelRatio || 1;
  cv.width = cols * CELL * dpr; cv.height = rows * CELL * dpr;
  cv.style.width = (cols * CELL) + 'px'; cv.style.height = (rows * CELL) + 'px';
  const g = cv.getContext('2d');
  g.setTransform(dpr, 0, 0, dpr, 0, 0);
  // checkerboard squares
  for (let i = 0; i < rows; i++) for (let j = 0; j < cols; j++) {
    g.fillStyle = (i + j) % 2 ? '#2a333d' : '#343f4b';
    g.fillRect(j * CELL, i * CELL, CELL, CELL);
  }
  const fillCell = (c, color, alpha) => {
    g.globalAlpha = alpha; g.fillStyle = color;
    g.fillRect(c[1] * CELL + 2, c[0] * CELL + 2, CELL - 4, CELL - 4);
    g.globalAlpha = 1;
  };
  // cell-style hints (drop games / arrow targets get a soft glow too)
  (r.hints || []).forEach((h, k) => fillCell(h, '#3fae79', 0.35 - 0.08 * k));
  (r.bad_hints || []).forEach((h, k) => fillCell(h, '#c75450', 0.3 - 0.08 * k));
  if (r.last_move) {
    g.strokeStyle = '#7aa2d8'; g.lineWidth = 2.5;
    g.strokeRect(r.last_move[1] * CELL + 2, r.last_move[0] * CELL + 2,
                 CELL - 4, CELL - 4);
  }
  if (sel) fillCell(sel, '#d8a04d', 0.4);
  // pieces: discs for stone games, glyph sprites otherwise
  g.textAlign = 'center'; g.textBaseline = 'middle';
  for (let i = 0; i < rows; i++) for (let j = 0; j < cols; j++) {
    const ch = r.board[i][j];
    if (!ch) continue;
    const [x, y] = cellCenter(i, j);
    if (ch === '\\u25cf' || ch === '\\u25cb') {  // ● / ○ stones
      const dark = ch === '\\u25cf';
      const grad = g.createRadialGradient(x - 6, y - 7, 3, x, y, CELL * 0.42);
      grad.addColorStop(0, dark ? '#6a6f78' : '#ffffff');
      grad.addColorStop(1, dark ? '#14181d' : '#b9c0c9');
      g.fillStyle = grad;
      g.beginPath(); g.arc(x, y, CELL * 0.38, 0, 7); g.fill();
      g.strokeStyle = 'rgba(0,0,0,0.45)'; g.lineWidth = 1; g.stroke();
    } else {
      g.font = (ch.length > 1 ? CELL * 0.42 : CELL * 0.62) + 'px serif';
      g.shadowColor = 'rgba(0,0,0,0.6)'; g.shadowBlur = 3;
      g.fillStyle = '#e8eaed';
      g.fillText(ch, x, y + 1);
      g.shadowBlur = 0;
    }
  }
  // best/worst move arrows (reference: brandubh gui.py:42-87)
  const arrow = (m, color, alpha, w) => {
    if (!m || m[0] === null || m[0] === undefined) return;
    const [x1, y1] = cellCenter(m[0], m[1]), [x2, y2] = cellCenter(m[2], m[3]);
    const ang = Math.atan2(y2 - y1, x2 - x1);
    const hx = x2 - Math.cos(ang) * 10, hy = y2 - Math.sin(ang) * 10;
    g.globalAlpha = alpha; g.strokeStyle = color; g.fillStyle = color;
    g.lineWidth = w; g.lineCap = 'round';
    g.beginPath(); g.moveTo(x1, y1); g.lineTo(hx, hy); g.stroke();
    g.beginPath();
    g.moveTo(x2, y2);
    g.lineTo(x2 - Math.cos(ang - 0.45) * 15, y2 - Math.sin(ang - 0.45) * 15);
    g.lineTo(x2 - Math.cos(ang + 0.45) * 15, y2 - Math.sin(ang + 0.45) * 15);
    g.closePath(); g.fill();
    g.globalAlpha = 1;
  };
  (r.bad_moves || []).forEach((m, k) => arrow(m, '#c75450', 0.45 - 0.12 * k, 3));
  (r.hint_moves || []).forEach((m, k) => arrow(m, '#3fae79', 0.85 - 0.2 * k, 5 - k));
  cv.onclick = (ev) => {
    const rect = cv.getBoundingClientRect();
    const j = Math.floor((ev.clientX - rect.left) / CELL);
    const i = Math.floor((ev.clientY - rect.top) / CELL);
    if (i >= 0 && i < rows && j >= 0 && j < cols) clickCell(i, j);
  };
}
let evalCur = 0.5, evalTarget = 0.5, evalAnim = null;
function animateEval(v) {
  evalTarget = v;
  if (evalAnim) return;
  const tick = () => {
    evalCur += (evalTarget - evalCur) * 0.12;
    if (Math.abs(evalTarget - evalCur) < 0.002) { evalCur = evalTarget; evalAnim = null; }
    else evalAnim = requestAnimationFrame(tick);
    document.getElementById('evalbar').style.width = (100 * evalCur) + '%';
    document.getElementById('evallabel').textContent =
      Math.round(100 * evalCur) + '%';
  };
  evalAnim = requestAnimationFrame(tick);
}
async function clickCell(i, j) {
  if (!game || !view || view.terminal) return;
  if (view.place_counts) {  // stratego placement: palette + one click
    const piece = document.getElementById('piece').value;
    render(await api('/api/move', {game, to: [i, j], piece, token}));
  } else if (view.needs_two_clicks) {
    if (!sel) { sel = [i, j]; render(view); return; }
    const r = await api('/api/move', {game, from: sel, to: [i, j], token});
    sel = null; render(r);
  } else {
    render(await api('/api/move', {game, to: [i, j], token}));
  }
}
init();
</script></body></html>
"""

TWO_CLICK_ENVS = {"brandubh", "hnefatafl", "chess", "stratego"}
FLIPPED_ENVS = {"chess"}  # displayed with the last board row on top

CHESS_GLYPHS = {0: "", 1: "♙", 2: "♘", 3: "♗", 4: "♖", 5: "♕", 6: "♔",
                -1: "♟", -2: "♞", -3: "♝", -4: "♜", -5: "♛", -6: "♚"}
STRATEGO_RANKS = {1: "S", 2: "2", 3: "3", 4: "4", 5: "5", 6: "6", 7: "7",
                  8: "8", 9: "9", 10: "M", 11: "B", 12: "F"}


def gui_device(device) -> torch.device:
    """``device`` as the GUI runs on it (``cuda`` as ``cuda:0``); raises
    RuntimeError for ``cuda`` on a host without it, rather than running
    on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the GUI runs on cuda, but torch.cuda.is_available() is "
                "false on this host; start the server with --device cpu "
                "to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", 0)
    return device


class GameSession:
    """One game of ``env_name`` on ``device``: the session's state is a
    batch of one game there, its history the states after each move."""

    def __init__(self, env_name: str, opponent: str, human_seat: int,
                 args=None, sims: int = 200, device="cuda"):
        self.device = gui_device(device)
        self.env = get_env(env_name)
        self.env_name = env_name
        self.args = args or get_args(numMCTSSims=sims, startTemp=0.0)
        self.human_seat = human_seat
        self.state = self.env.init(1, self.device)
        self.history = [self.state]
        self._host_copy = (None, None)
        self.lock = threading.Lock()
        # Human-vs-human modes (reference capability: boardgame/net.pyo +
        # hnefatafl/net networked play, SURVEY.md §2.2): 'hotseat' = both
        # seats from one browser; 'human' = networked — the creator takes
        # human_seat, a second client claims the other seat via /api/join
        # (token-checked moves), both poll /api/state.
        self.mode = opponent if opponent in ("human", "hotseat") else "agent"
        self.seat_tokens: dict = {}
        self.joined = self.mode != "human"
        self.opponent = (None if self.mode != "agent"
                         else self._build_opponent(opponent))
        from alphazero_general_tpu_torch.players.evaluator import (
            MCTSEvaluator,
        )

        self.evaluator = MCTSEvaluator(
            self.env, self.args, max_search_time=1.0, max_sims=400,
            sims_per_tick=40, device=self.device,
        )

    def issue_token(self, seat: int) -> str:
        token = uuid.uuid4().hex[:16]
        self.seat_tokens[token] = seat
        return token

    def join(self) -> dict:
        """Second client claims the open seat (networked human-vs-human)."""
        with self.lock:
            if self.mode != "human":
                return {"error": "not a networked human-vs-human game"}
            if self.joined:
                return {"error": "game is full"}
            self.joined = True
            seat = 1 - self.human_seat
            out = self.view("opponent joined — game on")
            out["token"] = self.issue_token(seat)
            out["seat"] = seat
            return out

    def _build_opponent(self, spec: str):
        from alphazero_general_tpu_torch.cli.pit import build_player
        from alphazero_general_tpu_torch.ops.native import GAME_IDS

        if spec == "nativemcts" and self.env_name not in GAME_IDS:
            spec = "rawmcts"  # C++ engine covers connect4/tictactoe only
        try:
            return build_player(spec, self.env, self.args, seed=0,
                                device=self.device)
        except SystemExit as e:
            raise ValueError(str(e))

    def _host(self):
        """The current position's fields on the host, copied once per
        position (one ``.cpu()`` a field)."""
        state = self.state
        cached, host = self._host_copy
        if cached is not state:
            host = one_game(state, "cpu")
            self._host_copy = (state, host)
        return host

    def _player(self) -> int:
        return int(self._host().player[0])

    def _win(self) -> np.ndarray:
        return self.env.win_state(self.state)[0].cpu().numpy()

    # ------------------------------------------------------------------ view
    def _chars(self, v: int) -> str:
        name = self.env_name
        if name in ("connect4", "gobang", "tictactoe", "othello"):
            return {0: "", 1: "●", -1: "○"}.get(v, "?")
        if name == "chess":
            return CHESS_GLYPHS.get(v, "?")
        if name == "stratego":
            return self._stratego_char(v)
        if name in TWO_CLICK_ENVS:
            return {0: "", 1: "♙", 2: "♟", 3: "♔", 4: "▣", 5: "▢",
                    7: "♔", 8: "♔"}.get(v, "?")
        return str(v)

    def _stratego_char(self, v: int) -> str:
        # Imperfect information: censor unrevealed enemy ranks for the human.
        from alphazero_general_tpu_torch.envs import stratego as S

        if v == 0:
            return ""
        base = v % S.VISIBLE_OFFSET
        if base == S.LAKE:
            return "≈"
        rank = base % S.TEAM_OFFSET
        is_red = 1 <= base <= S.NUM_PIECES
        mine = is_red == (self.human_seat == 0)
        visible = v >= S.VISIBLE_OFFSET
        glyph = STRATEGO_RANKS.get(rank, "?") if (mine or visible) else "?"
        return glyph if is_red else glyph.lower() + "\u0332"

    def _in_placement(self) -> bool:
        from alphazero_general_tpu_torch.envs import stratego as S

        return bool(S.Stratego.in_placement(self._host())[0])

    def _to_board_coords(self, cell):
        r, c = int(cell[0]), int(cell[1])
        if self.env_name in FLIPPED_ENVS:
            H = self._host().board.shape[1]
            r = H - 1 - r
        return r, c

    def _action_from_clicks(self, frm, to, piece=None):
        env = self.env
        name = self.env_name
        if name == "connect4":
            return int(to[1])
        if name in ("tictactoe", "othello", "gobang"):
            W = self._host().board.shape[2]
            return int(to[0]) * W + int(to[1])
        if name == "chess":
            from alphazero_general_tpu_torch.envs.chess import uci_to_action

            if frm is None:
                raise ValueError("select a piece first")
            fr, ff = self._to_board_coords(frm)
            tr, tf = self._to_board_coords(to)
            uci = (chr(97 + ff) + str(fr + 1) + chr(97 + tf) + str(tr + 1))
            host = self._host()
            if abs(int(host.board[0, fr, ff])) == 1 and tr in (0, 7):
                uci += "q"  # web UI promotes to queen
            return uci_to_action(host, uci)
        if name == "stratego":
            from alphazero_general_tpu_torch.envs import stratego as S

            if self._in_placement():
                ranks = {v: k for k, v in STRATEGO_RANKS.items()}
                if piece not in ranks:
                    raise ValueError("pick a piece type first")
                return S.Stratego.encode_place(
                    ranks[piece], int(to[0]), int(to[1]))
            if frm is None:
                raise ValueError("select a piece first")
            return S.Stratego.encode_action(int(frm[0]), int(frm[1]),
                                            int(to[0]), int(to[1]))
        if name in TWO_CLICK_ENVS:
            if frm is None:
                raise ValueError("select a piece first")
            return env.encode_action(int(frm[0]), int(frm[1]),
                                     int(to[0]), int(to[1]))
        raise ValueError(f"interactive play not supported for {name}")

    def view(self, message: str = "") -> dict:
        host = self._host()
        board = host.board[0].numpy()
        win = self._win()
        terminal = bool(win.any())
        player = int(host.player[0])
        analysis = self.evaluator.analysis
        # Eval bar: root value is from the mover's perspective.
        mover_value = analysis.value
        human_to_move = (self.mode != "agent" or player == self.human_seat)
        ref_seat = self.human_seat if self.mode == "agent" else 0
        eval_h = (mover_value if player == ref_seat else 1.0 - mover_value)
        hints, bad_hints, hint_moves, bad_moves = [], [], [], []
        if human_to_move and not terminal:
            for a in analysis.best_actions[:3]:
                hints.append(self._cell_of_action(a))
                hint_moves.append(self._move_of_action(a))
            for a in analysis.worst_actions[:2]:
                bad_hints.append(self._cell_of_action(a))
                bad_moves.append(self._move_of_action(a))
        if terminal:
            if win[-1] and self.env.HAS_DRAW:
                message = "draw"
            else:
                winner = int(np.argmax(win[:-1]))
                if self.mode == "agent":
                    message = ("you win!" if winner == self.human_seat
                               else "agent wins")
                else:
                    message = f"player {winner + 1} wins"
        last_move = None
        if int(host.last_action[0]) >= 0:
            last_move = self._cell_of_action(int(host.last_action[0]),
                                             placed=True)
        # Signed view for chess (int8), raw for others.
        rows = board.astype(np.int64)
        if self.env_name in FLIPPED_ENVS:
            rows = rows[::-1]
        out = {
            "board": [[self._chars(int(v)) for v in row] for row in rows],
            "terminal": terminal,
            "turns": int(host.turns[0]),
            "player": player,
            "human_seat": self.human_seat,
            "mode": self.mode,
            "joined": self.joined,
            "needs_two_clicks": self.env_name in TWO_CLICK_ENVS,
            "eval_for_human": float(np.clip(eval_h, 0.0, 1.0)),
            "analysis_sims": analysis.sims,
            "hints": hints,
            "bad_hints": bad_hints,
            # From→to arrow overlays for the canvas renderer (reference:
            # best/worst move arrows, envs/brandubh/gui.py:42-87). Entries
            # are [fr, fc, tr, tc]; fr/fc are null for drop/placement moves.
            "hint_moves": hint_moves,
            "bad_moves": bad_moves,
            "last_move": last_move,
            "message": message,
        }
        if self.env_name == "stratego" and self._in_placement():
            from alphazero_general_tpu_torch.envs import stratego as S

            counts = (host.red_to_place if self.human_seat == 0
                      else host.blue_to_place)[0].numpy()
            out["place_counts"] = [
                [STRATEGO_RANKS[p], int(counts[p])]
                for p in range(1, S.NUM_PIECES + 1)
            ]
        return out

    def _move_of_action(self, a: int):
        """[fr, fc, tr, tc] of an action in DISPLAY coordinates (row-flipped
        envs included); fr/fc are None for drop/placement actions. Feeds the
        canvas arrow overlays (reference: envs/brandubh/gui.py:42-87)."""
        to = self._cell_of_action(a)
        name = self.env_name
        frm = None
        if name == "chess":
            from alphazero_general_tpu_torch.envs.chess import action_to_uci

            host = self._host()
            uci = action_to_uci(host, a)
            fr, ff = int(uci[1]) - 1, ord(uci[0]) - 97
            frm = [host.board.shape[1] - 1 - fr, ff]
        elif name == "stratego":
            from alphazero_general_tpu_torch.envs import stratego as S

            if not self._in_placement():
                (r1, c1), _ = S.Stratego.decode_action(a)
                frm = [int(r1), int(c1)]
        elif name in TWO_CLICK_ENVS:
            (r1, c1), _ = self.env.decode_action(a)
            frm = [int(r1), int(c1)]
        return [None, None, to[0], to[1]] if frm is None else \
            [frm[0], frm[1], to[0], to[1]]

    def _cell_of_action(self, a: int, placed: bool = False):
        """Board cell of an action: ``placed=False`` = where a candidate
        move would land (hints), ``placed=True`` = where the already-played
        move landed (last-move highlight — differs for connect4 drops)."""
        name = self.env_name
        host = self._host()
        if name == "connect4":
            col = host.board[0, :, a].numpy()
            filled = int(np.abs(col).sum())
            row = len(col) - filled if placed else len(col) - 1 - filled
            return [row, int(a)]
        if name in ("tictactoe", "othello", "gobang"):
            W = host.board.shape[2]
            return [a // W, a % W]
        if name == "chess":
            from alphazero_general_tpu_torch.envs.chess import action_to_uci

            uci = action_to_uci(host, a)
            tr, tf = int(uci[3]) - 1, ord(uci[2]) - 97
            return [host.board.shape[1] - 1 - tr, tf]
        if name == "stratego":
            from alphazero_general_tpu_torch.envs import stratego as S

            if self._in_placement():
                cell = a % S.CELLS
                return [cell // S.W, cell % S.W]
            (_, _), (r2, c2) = S.Stratego.decode_action(a)
            return [r2, c2]
        if name in TWO_CLICK_ENVS:
            (_, _), (r2, c2) = self.env.decode_action(a)
            return [r2, c2]
        return [0, 0]

    # ----------------------------------------------------------------- moves
    def _step(self, action: int) -> None:
        self.state = self.env.step(self.state, torch.tensor(
            [action], dtype=torch.int32, device=self.device))
        self.history.append(self.state)

    def _agent_move(self):
        self._step(self.opponent.play(self.state))

    def start(self):
        with self.lock:
            if self.mode == "agent" and self.human_seat == 1:
                self._agent_move()
            self.evaluator.start(self.state)
            msg = ("share the game id — waiting for opponent to join"
                   if self.mode == "human" else "your move")
            out = self.view(msg)
            if self.mode == "human":
                out["token"] = self.issue_token(self.human_seat)
                out["seat"] = self.human_seat
            return out

    def human_move(self, frm, to, piece=None, token=None) -> dict:
        with self.lock:
            if self._win().any():
                return self.view()
            if self.mode == "human":
                seat = self.seat_tokens.get(token)
                if seat is None:
                    return self.view("invalid seat token")
                if not self.joined:
                    return self.view("waiting for opponent to join")
                if self._player() != seat:
                    return self.view("not your turn")
            elif self.mode == "agent" and self._player() != self.human_seat:
                return self.view("not your turn")
            try:
                action = self._action_from_clicks(frm, to, piece=piece)
            except ValueError as e:
                return self.view(str(e))
            if not 0 <= action < self.env.ACTION_SIZE or not bool(
                    self.env.valid_moves(self.state)[0, action]):
                return self.view("illegal move")
            self._step(action)
            if self.mode == "agent" and not self._win().any():
                self._agent_move()
            self.evaluator.start(self.state)
            return self.view("your move")

    def undo(self) -> dict:
        with self.lock:
            if self.mode == "agent":
                # Pop back to the previous human-to-move state.
                while len(self.history) > 1:
                    self.history.pop()
                    self.state = self.history[-1]
                    if self._player() == self.human_seat:
                        break
            elif len(self.history) > 1:  # human modes: one move back
                self.history.pop()
                self.state = self.history[-1]
            self.evaluator.start(self.state)
            return self.view("undone")


_SESSIONS: dict = {}


class TrainManager:
    """One training session driven from the web UI (reference:
    main.py:342-421 — Coach on a thread, polled status, pause/stop via the
    Coach's events, auto-detected completion)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.coach = None
        self.thread = None
        self.env_name = None
        self.error = None

    def start(self, env_name: str, overrides: dict, device="cuda") -> dict:
        with self.lock:
            if self.thread is not None and self.thread.is_alive():
                return {"error": "a training session is already running"}
            from alphazero_general_tpu_torch.envs.presets import preset_args
            from alphazero_general_tpu_torch.envs.stacked import maybe_stack
            from alphazero_general_tpu_torch.models import NNetWrapper
            from alphazero_general_tpu_torch.train import Coach
            from alphazero_general_tpu_torch.utils.config import _decode

            try:
                decoded = {k: _decode(v)
                           for k, v in (overrides or {}).items()}
                args = preset_args(env_name, **decoded)
                env = maybe_stack(get_env(env_name), args)
                nnet = NNetWrapper(env, args, device=gui_device(device))
                self.coach = Coach(env, nnet, args)
            except Exception as e:
                return {"error": f"{type(e).__name__}: {e}"}
            self.env_name = env_name
            self.error = None

            def run():
                try:
                    self.coach.learn()
                except Exception as e:  # surfaced via status
                    self.error = f"{type(e).__name__}: {e}"

            self.thread = threading.Thread(target=run, daemon=True)
            self.thread.start()
            return {"ok": True}

    def status(self) -> dict:
        c = self.coach
        if c is None:
            return {"running": False, "state": None}
        return {
            "running": self.thread.is_alive() if self.thread else False,
            "state": c.state.name,
            "env": self.env_name,
            "model_iter": c.model_iter,
            "games_played": c.games_played_iter,
            "loss_pi": c.loss_pi,
            "loss_v": c.loss_v,
            "sample_time": c.sample_time,
            "self_play_iter": c.self_play_iter,
            "paused": c.pause_train.is_set(),
            "error": self.error,
        }

    def pause(self) -> dict:
        if self.coach is None:
            return {"error": "no training session"}
        if self.coach.pause_train.is_set():
            self.coach.pause_train.clear()
        else:
            self.coach.pause_train.set()
        return {"paused": self.coach.pause_train.is_set()}

    def stop(self) -> dict:
        if self.coach is None:
            return {"error": "no training session"}
        self.coach.stop_train.set()
        self.coach.pause_train.clear()
        return {"ok": True}


_TRAIN = TrainManager()


class TensorBoardManager:
    """One-click TensorBoard launch — reference parity with the GUI's TB
    button (AlphaZeroGUI/main.py:977-982). Spawns ``python -m
    tensorboard.main`` against the metrics dir, listening on the GUI's own
    host ``bind``, and reports the URL."""

    def __init__(self):
        self.proc = None
        self.port = None
        self.logdir = None
        atexit.register(self.stop)

    def status(self, host: str = "127.0.0.1") -> dict:
        running = self.proc is not None and self.proc.poll() is None
        return {
            "running": running,
            "port": self.port if running else None,
            # Host comes from the request's Host header (the GUI may be
            # accessed remotely; a hardcoded 127.0.0.1 link would be dead).
            "url": (f"http://{host}:{self.port}/" if running else None),
            "logdir": self.logdir,
        }

    def start(self, logdir: str = "runs", port: int = 6006,
              host: str = "127.0.0.1", bind: str = "127.0.0.1") -> dict:
        if self.proc is not None and self.proc.poll() is None:
            return self.status(host)
        import importlib.util
        import socket
        import subprocess
        import sys
        import time

        if importlib.util.find_spec("tensorboard") is None:
            return {"running": False, "error": "tensorboard not installed"}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tensorboard.main", "--logdir", logdir,
             "--port", str(port), "--host", bind],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        self.port = int(port)
        self.logdir = logdir
        # Don't hand the UI a dead URL: wait briefly for the port to accept
        # (or the process to exit — e.g. port already taken).
        probe = "127.0.0.1" if bind in ("", "0.0.0.0", "::") else bind
        deadline = time.time() + 15.0
        while time.time() < deadline:
            if self.proc.poll() is not None:
                code = self.proc.poll()
                self.proc = None
                return {"running": False,
                        "error": f"tensorboard exited at startup "
                                 f"(code {code}; port {port} in use?)"}
            try:
                with socket.create_connection((probe, port), timeout=0.5):
                    break
            except OSError:
                time.sleep(0.3)
        return self.status(host)

    def stop(self) -> dict:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except Exception:
                self.proc.kill()
        self.proc = None
        return self.status()


_TENSORBOARD = TensorBoardManager()


@atexit.register
def _stop_train_at_exit() -> None:
    # A daemon Coach thread still inside a CUDA call when the interpreter
    # tears down may die mid-call. Signal it and give it a moment to park
    # (the Coach honours stop_train before every self-play move and after
    # every phase).
    t = _TRAIN.thread
    if t is not None and t.is_alive():
        c = _TRAIN.coach
        if c is not None:
            c.stop_train.set()
            c.pause_train.clear()
        t.join(timeout=10)


class Handler(BaseHTTPRequestHandler):
    #: Where the sessions and the train panel run; ``handler_for`` binds
    #: another.
    device = "cuda"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, payload, code=200):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/" or self.path.startswith("/index"):
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/api/envs":
            self._json({"envs": list_envs()})
        elif self.path.startswith("/api/args"):
            # Args-editor surface (reference: in-GUI args table,
            # main.py:707-791 — JSON-typed values, no eval; keys starting
            # with '_' are internal and hidden, main.py:713-715).
            from alphazero_general_tpu_torch.envs.presets import preset_args
            from alphazero_general_tpu_torch.utils.config import _encode

            env_name = self.path.split("env=")[-1] if "env=" in self.path \
                else "connect4"
            try:
                args = preset_args(env_name)
            except Exception as e:
                self._json({"error": str(e)}, 400)
                return
            encoded = {k: _encode(v) for k, v in sorted(args.items())
                       if not k.startswith("_")}
            self._json({"env": env_name, "args": encoded})
        elif self.path == "/api/train/status":
            self._json(_TRAIN.status())
        elif self.path == "/api/tensorboard":
            self._json(_TENSORBOARD.status(self._req_host()))
        elif self.path.startswith("/api/state"):
            game = self.path.split("game=")[-1]
            sess = _SESSIONS.get(game)
            if not sess:
                self._json({"error": "unknown game"}, 404)
            else:
                self._json(sess.view())
        else:
            self._json({"error": "not found"}, 404)

    def _req_host(self) -> str:
        """Hostname the client reached us at (for cross-service links like
        the TensorBoard URL) — the Host header minus any port."""
        host = self.headers.get("Host") or "127.0.0.1"
        if host.startswith("["):  # bracketed IPv6
            host = host[1:host.find("]")]
        elif ":" in host:
            host = host.rsplit(":", 1)[0]
        return host or "127.0.0.1"

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
        except ValueError:
            self._json({"error": "bad json"}, 400)
            return
        try:
            if self.path == "/api/new":
                sess = GameSession(
                    payload.get("env", "connect4"),
                    payload.get("opponent", "nativemcts"),
                    int(payload.get("human_seat", 0)),
                    sims=int(payload.get("sims", 200)),
                    device=self.device,
                )
                gid = uuid.uuid4().hex[:12]
                _SESSIONS[gid] = sess
                out = sess.start()
                out["game"] = gid
                self._json(out)
            elif self.path == "/api/move":
                sess = _SESSIONS.get(payload.get("game"))
                if not sess:
                    self._json({"error": "unknown game"}, 404)
                    return
                out = sess.human_move(payload.get("from"), payload.get("to"),
                                      payload.get("piece"),
                                      token=payload.get("token"))
                out["game"] = payload["game"]
                self._json(out)
            elif self.path == "/api/join":
                sess = _SESSIONS.get(payload.get("game"))
                if not sess:
                    self._json({"error": "unknown game"}, 404)
                    return
                out = sess.join()
                out["game"] = payload["game"]
                self._json(out)
            elif self.path == "/api/undo":
                sess = _SESSIONS.get(payload.get("game"))
                if not sess:
                    self._json({"error": "unknown game"}, 404)
                    return
                out = sess.undo()
                out["game"] = payload["game"]
                self._json(out)
            elif self.path == "/api/train/start":
                self._json(_TRAIN.start(
                    payload.get("env", "tictactoe"),
                    payload.get("overrides") or {},
                    device=self.device,
                ))
            elif self.path == "/api/train/pause":
                self._json(_TRAIN.pause())
            elif self.path == "/api/train/stop":
                self._json(_TRAIN.stop())
            elif self.path == "/api/tensorboard/start":
                self._json(_TENSORBOARD.start(
                    payload.get("logdir", "runs"),
                    int(payload.get("port", 6006)),
                    host=self._req_host(),
                    bind=self.server.server_address[0]))
            elif self.path == "/api/tensorboard/stop":
                self._json(_TENSORBOARD.stop())
            else:
                self._json({"error": "not found"}, 404)
        except Exception as e:  # surface errors to the UI
            self._json({"error": f"{type(e).__name__}: {e}"}, 500)


def handler_for(device) -> type:
    """``Handler`` with its sessions and train panel on ``device``."""
    return type("Handler", (Handler,), {"device": device})


def main(argv=None) -> int:
    from alphazero_general_tpu_torch.cli.common import add_device_arg

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    add_device_arg(p)
    ns = p.parse_args(argv)
    server = ThreadingHTTPServer((ns.host, ns.port), handler_for(ns.device))
    print(f"serving on http://{ns.host}:{ns.port} ({ns.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
