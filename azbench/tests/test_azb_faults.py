"""Each run drives a tiny cell on the CPU with the timed path broken
underneath, and ``correct`` comes out false by the cell's own limits: a
step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced, the search's tie noise left out where
it decides. (No cell spans chips, so none can leave out an exchange
between them.)"""

import pytest
import torch

from azbench import program as P, weights
from azbench.tests import tiny

torch.set_num_threads(1)


def _env_step_unchanged(monkeypatch):
    env = P._mod("envs.connect4").Connect4
    monkeypatch.setattr(env, "step", staticmethod(lambda state, a: state))


def _policy_rolled(monkeypatch):
    for mod, cls in (("models.quant", "QuantResNet"),
                     ("models.architectures", "ResNet")):
        klass = getattr(P._mod(mod), cls)
        real = klass.forward

        def forward(self, obs, _real=real):
            logp, logv = _real(self, obs)
            return logp.roll(1, dims=-1), logv

        monkeypatch.setattr(klass, "forward", forward)


def _action_altered(monkeypatch):
    sp = P._mod("selfplay.selfplay")
    real = sp.move_step

    def move_step(env, *a, **k):
        carry, rec = real(env, *a, **k)
        rec.action = (rec.action + 1) % env.ACTION_SIZE
        return carry, rec

    monkeypatch.setattr(sp, "move_step", move_step)


def _half_the_games_backed_up(monkeypatch):
    S = P.search_module()
    real = S.backup_batched_t

    def backup(tt, values, spec):
        half = tt.n.shape[1] // 2
        keep = [x[:, half:].clone() for x in (tt.n, tt.q, tt.v)]
        real(tt, values, spec)
        for x, k in zip((tt.n, tt.q, tt.v), keep):
            x[:, half:] = k

    monkeypatch.setattr(S, "backup_batched_t", backup)


def _flat_policy(monkeypatch):
    """The benchmark's weights with the policy's last layer zero: every
    valid action's prior ties, so the tie noise alone orders them."""
    real = weights.make

    def make(cfg, seed, device):
        W = real(cfg, seed, device)
        last = max(k.split(".")[0] for k in W if k.startswith("pmlp"))
        for k in (f"{last}.weight", f"{last}.bias"):
            W[k] = torch.zeros_like(W[k])
        return W

    monkeypatch.setattr(weights, "make", make)


def _tie_noise_ignored(monkeypatch):
    """The search adds no tie noise, on a flat policy where it decides."""
    _flat_policy(monkeypatch)
    S = P.search_module()

    def at(self, k):
        return (self.gammas if k == 0 else None,
                None if self.tie is None else torch.zeros_like(self.tie[k]))

    monkeypatch.setattr(S.SearchDraws, "at", at)


def _player_action_altered(monkeypatch):
    players = P._mod("players.players")
    real = players.MCTSPlayer.play

    def play(self, state, draws=None):
        a = real(self, state, draws=draws)
        valid = self.game_cls.valid_moves(state)[0]
        others = [b for b in range(valid.shape[0])
                  if valid[b] and b != a] or [a]
        return others[0]

    monkeypatch.setattr(players.MCTSPlayer, "play", play)


#: Deeper searches, so that nodes below the root (whose priors have no
#: Dirichlet noise) are expanded in the checked move.
DEEP = {"numMCTSSims": 40}

FAULTS = [
    ("c4.selfplay", _env_step_unchanged, {}),
    ("c4.selfplay", _policy_rolled, {}),
    ("c4.selfplay", _action_altered, {}),
    ("c4.selfplay", _half_the_games_backed_up, {}),
    ("c4.selfplay", _tie_noise_ignored, DEEP),
    ("c4.play", _env_step_unchanged, {}),
    ("c4.play", _policy_rolled, {}),
    ("c4.play", _player_action_altered, {}),
    ("c4.play", _tie_noise_ignored, {}),
]


@pytest.mark.parametrize("cell,fault,args", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f, _ in FAULTS])
def test_fault_is_caught(monkeypatch, cell, fault, args):
    fault(monkeypatch)
    res, correct = tiny.run(tiny.context(cell, seconds=0.3, **args))
    assert not correct, res.checks


@pytest.mark.parametrize("cell,args", [("c4.selfplay", DEEP),
                                       ("c4.play", {})])
def test_flat_policy_alone_is_correct(monkeypatch, cell, args):
    """The flat policy of the tie-noise fault is no fault by itself."""
    _flat_policy(monkeypatch)
    res, correct = tiny.run(tiny.context(cell, seconds=0.3, **args))
    assert correct, res.checks
