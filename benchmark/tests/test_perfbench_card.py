"""On the card (the `cuda` marker; skips elsewhere): a run at a small size
is judged correct, and the f32 control is not."""

import pytest
import torch
from conftest import SEED

from benchmark import harness
from benchmark.tests import control

SMALL = {"batch": 20000, "chunk": 5000, "pool_batches": 2, "check_per_batch": 2000}
# the ks flow at its own circuits, every answer of a short window judged
KS_SMALL = {"check_per_batch": 4096}


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
def test_ks_run_on_the_card():
    _card()
    r = harness.run("sixteenth_iswap.circuits-ks", SEED, 0.1, True, "cuda", overrides=KS_SMALL,
                    log=lambda *a, **k: None)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["busy_s"] > 0 and 0 < r["metrics"]["device_idle_pct.ks"]["value"] < 100
    for name in ("ks_coords_pct.ks", "ks_member_pct.ks", "ks_self_pct"):
        assert 0 < r["metrics"][name]["value"] < 100


@pytest.mark.cuda
@pytest.mark.parametrize("cell, small, seconds", [("sqiswap.haar-main", SMALL, 0.0),
                                                  ("sixteenth_iswap.circuits-ks", KS_SMALL, 0.2)])
def test_control_on_the_card(cell, small, seconds):
    _card()
    c = harness.resolve_cell(harness.load_spec(), cell)
    over = {**small, **control.overrides(c["traffic"]["flow"], c["config"])}
    r = harness.run(cell, SEED, seconds, False, "cuda", overrides=over, log=lambda *a, **k: None)
    assert r["correct"] is False
