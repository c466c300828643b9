"""On the card (the `cuda` marker; skips elsewhere): a run at a small size
is judged correct, and the f32 control is not."""

import pytest
import torch
from conftest import SEED

from benchmark import harness
from benchmark.tests import control

SMALL = {"batch": 20000, "chunk": 5000, "pool_batches": 2, "check_per_batch": 2000}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sqiswap.haar-main", "sixteenth_iswap.haar-main"])
def test_small_run_on_the_card(cell):
    _card()
    r = harness.run(cell, SEED, 0.1, True, "cuda", overrides=SMALL, log=lambda *a, **k: None)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["busy_s"] > 0 and 0 < r["metrics"]["device_idle_pct"]["value"] < 100
    for name in ("adam_roofline_pct", "lm_roofline_pct", "polish_roofline_pct"):
        assert 0 < r["metrics"][name]["value"] <= 100


@pytest.mark.cuda
def test_control_on_the_card():
    _card()
    r = harness.run("sqiswap.haar-main", SEED, 0.1, False, "cuda",
                    overrides={**SMALL, "solver_wrap": control.F32Certified}, log=lambda *a, **k: None)
    assert r["correct"] is False
