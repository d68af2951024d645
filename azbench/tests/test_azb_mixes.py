"""Each traffic mix runs a few moves or steps at tiny widths on the CPU
through the traffic files, and the plain reference agrees with the port
there."""

import pytest
import torch

from azbench.tests import tiny

torch.set_num_threads(1)


@pytest.mark.parametrize("cell", ["c4.selfplay", "c4.play"])
def test_mix_runs_and_agrees_with_reference(cell):
    res, correct = tiny.run(tiny.context(cell, seconds=0.3))
    assert res.attempted >= 2
    assert correct, res.checks
    assert set(res.e2e) in ({"sims_per_s"}, {"move_ms"})
    assert all(v > 0 for v in res.e2e.values())
    exact = {"illegal_actions", "env_mismatch", "record_mismatch",
             "leaf_mismatch", "visit_mismatch"}
    assert all(res.checks[k] == 0 for k in exact & set(res.checks))


def test_selfplay_sees_every_move_of_the_window():
    ctx = tiny.context("c4.selfplay", seconds=0.5)
    res, correct = tiny.run(ctx)
    assert correct
    # The checked move lies in cycle 1 or 2 of four moves, so the window
    # holds at least two cycles.
    assert res.attempted >= 8


def test_control_reads_above_the_program():
    """At the tiny size too, the reference one precision below puts its
    outputs further from the reference than the program does."""
    res, _ = tiny.run(tiny.context("c4.selfplay", control=True))
    assert res.checks["control.policy_gap"] > 3 * res.checks["policy_gap"]
