"""On the card: each cell's control, the reference one precision below
the configuration's put in the program's place, comes out not correct by
the cell's limits, while the program's own numbers come out correct. At
each cell's own size, with a short window and one seed. Run with

    python -m pytest -q -m gpu azbench/tests/test_azb_controls.py
"""

import time

import pytest
import torch

from azbench import registry
from azbench.common import Context

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = registry.workload(cell)
    tr = registry.traffic(w["traffic"])
    ctx = Context(cell=w, cfg=registry.config(w["config"]), traffic=tr,
                  seed=2 ** 31 + 4242, seconds=2.0, trace=False,
                  device=torch.device("cuda", 0), t0=time.time(),
                  control=True)
    res = registry.driver(tr["driver"]).run(ctx)
    limits = registry.limits(cell)
    own = {k: v for k, v in res.checks.items() if "." not in k}
    assert all(v <= limits[k] for k, v in own.items()), own
    read = {k[len("control."):]: v for k, v in res.checks.items()
            if k.startswith("control.")}
    assert read
    assert any(v > limits[k] for k, v in read.items()), read
