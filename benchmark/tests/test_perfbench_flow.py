"""The main flow end to end at a tiny size on the CPU, judged by the plain
reference, and the result line's keys."""

import numpy as np
import pytest
import torch
from conftest import SEED, TINY

from benchmark import harness
from benchmark.flows.main import Flow
from benchmark.reference import chain
from benchmark.reference.coverage import Coverage, coverage_file
from benchmark.traffic import haar


def test_run_is_correct_and_keyed():
    cell = "sqiswap.haar-main"
    r = harness.run(cell, SEED, 0.05, False, "cpu", overrides=TINY, log=lambda *a, **k: None)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] == TINY["batch"] and 0 <= r["failed"] <= r["attempted"]
    want = {m["name"] for m in harness.metric_entries(harness.load_spec(), "end_to_end", cell)}
    assert set(r["metrics"]) == want
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["checks"]) == {"ks_mismatch", "unanswered", "worst_certified_cost", "cert_gap"}


def test_traced_run_reports_its_per_layer_metrics():
    r = harness.run("sqiswap.haar-main", SEED + 1, 0.05, True, "cpu", overrides=TINY, log=lambda *a, **k: None)
    assert r["correct"] is True
    # on the CPU no kernel runs on a device: the trace's readers return nothing
    assert set(r["metrics"]) == {"ks_pct", "lanes_per_certified"}
    assert {"busy_s", "window_s"} <= set(r["device"]) and set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"


def test_flow_answers_agree_with_the_reference():
    """Every target's depth and certified cost, one batch, against the
    reference's own."""
    c = harness.resolve_cell(harness.load_spec(), "sqiswap.haar-main")
    cfg, tr = c["config"], {**c["traffic"], **TINY}
    T = haar.pool(tr["batch"], 7, torch.device("cpu"))
    flow = Flow(cfg, tr, torch.device("cpu"), 8, harness.Spans())
    out = flow.run_batch(T)
    from slam_decomposition_torch.config import data_dir

    ref_ks = Coverage(coverage_file(data_dir(), cfg["coverage_gate"])).depth(T.numpy())
    assert np.array_equal(out.ks, ref_ks)
    G = chain.gate(cfg["basis"])
    for i in range(tr["batch"]):
        ref = chain.square_cost(out.params(i)[None], T[i : i + 1].numpy(), G)[0]
        assert abs(ref - out.cost[i]) <= 1e-6 * max(ref, cfg["threshold"])
    assert (out.cost <= cfg["threshold"]).all()


@pytest.mark.parametrize("cell", ["sqiswap.haar-main", "sixteenth_iswap.haar-main"])
def test_reference_depths_are_the_ports(cell):
    """The reference's depths of 400 Haar targets against the port's
    `monodromy_ks_batch` on the CPU, for each configuration's coverage set."""
    from slam_decomposition_torch.config import data_dir
    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
    from benchmark.flows.main import port_gate

    cfg = harness.resolve_cell(harness.load_spec(), cell)["config"]
    T = haar.pool(400, 31, torch.device("cpu"))
    ks = monodromy_ks_batch(gate_set_to_coverage(port_gate(cfg["coverage_gate"]), device="cpu"), T, "cpu")
    ref = Coverage(coverage_file(data_dir(), cfg["coverage_gate"])).depth(T.numpy())
    assert np.array_equal(ks, ref)
    assert len(np.unique(ref)) >= 2
