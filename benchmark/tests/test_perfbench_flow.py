"""The flows end to end at a tiny size on the CPU, judged by the plain
reference, and the result line's keys."""

import numpy as np
import pytest
import torch
from conftest import SEED, TINY, TINY_CIRCUITS

from benchmark import harness
from benchmark.flows.main import Flow
from benchmark.reference import chain
from benchmark.reference import judge as chain_judge
from benchmark.reference.coverage import Coverage, coverage_file
from benchmark.traffic import haar

CHECKS = {"sqiswap.haar-main": {"ks_mismatch", "unanswered", "worst_certified_cost", "cert_gap"},
          "sixteenth_iswap.circuits-ks": {"ks_mismatch", "unanswered"}}


def _tiny(cell):
    return TINY_CIRCUITS if cell.endswith("circuits-ks") else TINY


def _batch_sizes(cell, tiny):
    import importlib

    tr = {**harness.resolve_cell(harness.load_spec(), cell)["traffic"], **tiny}
    gen = importlib.import_module(f"benchmark.traffic.{tr['targets']}")
    return {stop - start for start, stop in harness.make_pool(gen, tr, torch.device("cpu"))[1]}


@pytest.mark.parametrize("cell", sorted(CHECKS))
def test_run_is_correct_and_keyed(cell):
    r = harness.run(cell, SEED, 0.0, False, "cpu", overrides=_tiny(cell), log=lambda *a, **k: None)  # one batch
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] in _batch_sizes(cell, _tiny(cell)) and 0 <= r["failed"] <= r["attempted"]
    want = {m["name"] for m in harness.metric_entries(harness.load_spec(), "end_to_end", cell)}
    assert set(r["metrics"]) == want
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["checks"]) == CHECKS[cell]


# on the CPU no kernel runs on a device: the trace's readers return nothing
@pytest.mark.parametrize("cell, per_layer", [("sqiswap.haar-main", {"ks_pct", "lanes_per_certified"}),
                                             ("sixteenth_iswap.circuits-ks", set())])
def test_traced_run_reports_its_per_layer_metrics(cell, per_layer):
    r = harness.run(cell, SEED + 1, 0.05, True, "cpu", overrides=_tiny(cell), log=lambda *a, **k: None)
    assert r["correct"] is True
    assert set(r["metrics"]) == per_layer
    assert {"busy_s", "window_s"} <= set(r["device"]) and set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"


def test_mix_without_a_judge_is_judged_as_before():
    """A one-batch window of the main flow, rebuilt here as the harness ran
    it before mixes named their judge (the sample's keys read off the
    answer one by one, `failed` from the certified costs), gives the
    harness's checks and count exactly."""
    cell, seed, tiny = "sqiswap.haar-main", SEED + 2, {**TINY, "check_per_batch": 12}
    r = harness.run(cell, seed, 0.0, False, "cpu", overrides=tiny, log=lambda *a, **k: None)
    c = harness.resolve_cell(harness.load_spec(), cell)
    assert "judge" not in c["traffic"]
    cfg, tr, B, cpu = c["config"], {**c["traffic"], **tiny}, tiny["batch"], torch.device("cpu")
    s_starts, s_warm, s_sample, s_order = harness._seed_ints(seed, 4)
    flow = Flow(cfg, tr, cpu, s_starts, harness.Spans())
    pool = haar.pool(tr["pool_batches"] * B, tr["pool_seed"], cpu)
    start = int(np.random.default_rng(s_order).permutation(tr["pool_batches"])[0]) * B
    flow.warm(pool[start : start + B], s_warm)
    out = flow.run_batch(pool[start : start + B])
    pick = np.sort(np.random.default_rng(s_sample).choice(B, size=12, replace=False))
    checks = chain_judge.judge(cfg, pool[start + pick].numpy(), {
        "ks": out.ks[pick], "depth": out.depth[pick], "cost": out.cost[pick], "x": [out.params(i) for i in pick]})
    assert r["checks"] == checks and set(out.sample(pick)) == {"ks", "depth", "cost", "x"}
    assert r["attempted"] == B and r["failed"] == B - int((out.cost <= cfg["threshold"]).sum())


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


@pytest.mark.parametrize("cell", ["sqiswap.haar-main", "sixteenth_iswap.haar-main", "sixteenth_iswap.circuits-ks"])
def test_reference_depths_are_the_ports(cell):
    """The reference's depths of the cell's targets (400 Haar ones, or every
    block of the cell's circuits, those on the layer faces included) against
    the port's `monodromy_ks_batch` on the CPU, for each configuration's
    coverage set."""
    import importlib

    from slam_decomposition_torch.config import data_dir
    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
    from benchmark.flows.main import port_gate

    c = harness.resolve_cell(harness.load_spec(), cell)
    cfg, tr = c["config"], c["traffic"]
    gen = importlib.import_module(f"benchmark.traffic.{tr['targets']}")
    T = gen.batches(tr["pool_seed"], "cpu", **tr["target_params"])[0] if hasattr(gen, "batches") \
        else gen.pool(400, 31, torch.device("cpu"))
    ks = monodromy_ks_batch(gate_set_to_coverage(port_gate(cfg["coverage_gate"]), device="cpu"), T, "cpu")
    ref = Coverage(coverage_file(data_dir(), cfg["coverage_gate"])).depth(T.numpy())
    assert np.array_equal(ks, ref)
    assert len(np.unique(ref)) >= 2
