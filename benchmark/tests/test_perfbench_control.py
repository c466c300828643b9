"""The judgement fails the control (the program's f32 certification path)
and each planted fault that the main flow can have, at a tiny size on the
CPU. (The exchange between chips: no cell runs on more than one.)"""

import numpy as np
import pytest
from conftest import SEED, TINY, TINY_CIRCUITS

from benchmark import harness
from benchmark.flows import main as flow_main
from benchmark.tests import control

QUIET = {"log": lambda *a, **k: None}


def _run(cell="sqiswap.haar-main", **extra):
    tiny = TINY_CIRCUITS if cell.endswith("circuits-ks") else TINY
    return harness.run(cell, SEED + 5, 0.05, False, "cpu", overrides={**tiny, **extra}, **QUIET)


def test_control_is_not_correct():
    r = _run(solver_wrap=control.F32Certified)
    assert r["correct"] is False
    assert r["checks"]["cert_gap"]["value"] > r["checks"]["cert_gap"]["limit"]


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_planted_fault_is_not_correct(fault):
    r = _run(solver_wrap=control.FAULTS[fault])
    assert r["correct"] is False, r["checks"]


def test_altered_depth_is_not_correct(monkeypatch):
    real = flow_main.monodromy_ks_batch

    def altered(coverage, T):
        ks = real(coverage, T).copy()
        ks[0] = ks[0] + 1 if ks[0] < 3 else ks[0] - 1
        return ks

    monkeypatch.setattr(flow_main, "monodromy_ks_batch", altered)
    r = _run(check_per_batch=TINY["batch"])
    assert r["correct"] is False and r["checks"]["ks_mismatch"]["value"] >= 1


def test_unanswered_target_is_not_correct():
    class NoAnswer(control._Wrapped):
        def solve(self, x0s, tgt):
            x, cost = self.solver.solve(x0s, tgt)
            return x, cost * np.nan

    r = _run(solver_wrap=NoAnswer)
    assert r["correct"] is False and r["checks"]["unanswered"]["value"] == TINY["check_per_batch"]


def test_ks_control_is_not_correct():
    """The f32 reference in the program's place misplaces QFT-8's blocks on
    the layer faces (6 of its 32)."""
    cell = "sixteenth_iswap.circuits-ks"
    c = harness.resolve_cell(harness.load_spec(), cell)
    r = _run(cell, **control.overrides(c["traffic"]["flow"], c["config"]))
    assert r["correct"] is False and r["checks"]["ks_mismatch"]["value"] >= 1, r["checks"]


@pytest.mark.parametrize("fault", sorted(control.KS_FAULTS))
def test_planted_ks_fault_is_not_correct(fault):
    r = _run("sixteenth_iswap.circuits-ks", flow_wrap=control.KS_FAULTS[fault])
    key = {"ks_raised": "ks_mismatch", "ks_missing": "unanswered"}[fault]
    assert r["correct"] is False and r["checks"][key]["value"] >= 1, r["checks"]
