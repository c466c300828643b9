"""The program's spans and counters (utils/profiling.py), the chain kernels'
counts of J builds, and the benchmark's readers of them.

On the CPU: tracing off records nothing; spans nest with counts, totals,
self times and parents; the table resets as documented; under
``torch.profiler`` the spans are ``slam.<name>`` host ranges, and the
benchmark's trace reduction reads the same device ops and ``bench.`` spans
with them as without; the plain LM and polish count J's builds as
``tools/inputs.fresh_iterations`` reads them from the accepted steps; the
eigenphases count their targets by path; the four readers return numbers
from a tiny run. Marked ``cuda`` (skipping
without a card): the kernels' counts against their own accepted steps
(the plain versions' take other f32 decisions at the rounding floor), x and f
bit for bit with the counter passed or null, and the
trace reduction with and without the program's spans on the card. Run there
with ``python -m pytest tests/test_torch_tracing.py -m cuda``."""

import ctypes
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import harness
from benchmark.metrics import flops
from benchmark.metrics import trace as trace_mod
from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.ops import _build
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.ops import weyl
from slam_decomposition_torch.opt.samplers import haar_sample
from slam_decomposition_torch.tools.inputs import fresh_iterations, kernel_inputs
from slam_decomposition_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

READERS = ("ks_coords_pct", "ks_member_pct", "lm_counted_roofline_pct", "polish_counted_roofline_pct")


@pytest.fixture(autouse=True)
def _empty_table():
    profiling.reset()
    yield
    profiling.reset()


def _busy(seconds: float) -> None:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


# ---------------------------------------------------------------- the table


def test_tracing_off_records_nothing():
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b")  # the one null context: nothing allocated
    with profiling.span("a"):
        profiling.count("n", 3)
    d = kernel_inputs(2, 2, 1, "cpu")
    ck.lm_chain(d["x0"], d["lanes_t"], d["g32"], 1)
    assert profiling.count_launch("lm_chain", 1, 1, 2, "cpu") is None
    assert profiling.table() == {"spans": {}, "counters": {}, "kernels": {}}


def test_nested_spans_give_counts_totals_self_times_and_parents():
    with profiling.tracing():
        for _ in range(2):
            with profiling.span("outer"):
                _busy(0.002)
                for _ in range(3):
                    with profiling.span("inner"):
                        _busy(0.001)
        profiling.count("things", 2)
        profiling.count("things")
        t = profiling.table()
    outer, inner = t["spans"]["outer"], t["spans"]["inner"]
    assert (outer["count"], inner["count"]) == (2, 6)
    assert (outer["parent"], inner["parent"]) == (None, "outer")
    assert inner["seconds"] >= 0.006 and outer["seconds"] >= 0.004 + inner["seconds"]
    assert inner["self_seconds"] == inner["seconds"]
    assert outer["self_seconds"] == pytest.approx(outer["seconds"] - inner["seconds"], abs=1e-12)
    assert outer["self_seconds"] >= 0.004
    assert t["counters"] == {"things": 3}
    with profiling.tracing():  # a new block starts from an empty table
        assert profiling.table()["spans"] == {}
    assert not profiling.enabled()


def test_table_resets_when_a_profiler_starts_and_keeps_after_it_stops():
    with profiling.tracing():
        with profiling.span("before"):
            pass
    with profiling.span("untraced"):  # finds no profiler: records nothing
        pass
    assert set(profiling.table()["spans"]) == {"before"}
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("first"):  # the first span under the profiler resets the table
            pass
        with profiling.span("second"):
            pass
    with profiling.span("after"):
        pass
    assert set(profiling.table()["spans"]) == {"first", "second"}


def test_spans_are_host_ranges_under_the_profiler():
    """Named ranges on the host's timeline, not user annotations (which the
    profiler mirrors onto the card's timeline)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(8) + 1
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("slam.")}
    assert {name: (str(e.device_type()), e.activity_type()) for name, e in events.items()} == {
        "slam.outer": ("DeviceType.CPU", "cpu_op"), "slam.inner": ("DeviceType.CPU", "cpu_op")}
    outer, inner = events["slam.outer"], events["slam.inner"]
    assert outer.start_ns() <= inner.start_ns() and inner.end_ns() <= outer.end_ns()


def _segment(program_spans: bool, device, monkeypatch):
    """A bench span around program spans and work on ``device``, under the
    profiler, reduced as the benchmark reduces its traced segment."""
    if not program_spans:
        monkeypatch.setattr(profiling, "_profiler_enabled", lambda: False)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    a = torch.ones(256, 256, device=device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function("bench.work"):
            for _ in range(3):
                with profiling.span("outer"):
                    with profiling.span("inner"):
                        b = a @ a
                    b.sum().item()
        window_s = time.perf_counter() - t0
    monkeypatch.undo()
    ops, spans = trace_mod.profile_events(prof)
    return ops, spans, trace_mod.reduce(ops, spans, window_s)


def _same_reduction(device, monkeypatch):
    ops0, spans0, red0 = _segment(False, device, monkeypatch)
    ops1, spans1, red1 = _segment(True, device, monkeypatch)
    assert sorted(name for name, *_ in ops1) == sorted(name for name, *_ in ops0)
    assert not any(name.startswith("slam.") for name, *_ in ops1)
    assert [name for name, *_ in spans1] == [name for name, *_ in spans0] == ["work"]
    names = [sorted(n for n, _ in r["breakdown"]["device_ops"]) for r in (red0, red1)]
    assert names[0] == names[1]
    return ops1, red1


def test_trace_reduction_reads_the_same_with_program_spans(monkeypatch):
    _, red = _same_reduction(torch.device("cpu"), monkeypatch)
    assert red["busy_s"] == 0  # no device here


# ---------------------------------------------------------------- the plain versions' counts


def _fresh_count(fn, x, T, g, iters) -> int:
    """1 + the accepted steps before the last iteration, summed over the
    lanes, by tools/inputs.fresh_iterations' method."""
    return round(fresh_iterations(fn, x, T, g, iters) * x.shape[0])


@pytest.mark.parametrize("k", [2, 3, 13])
def test_plain_rebuild_counts_follow_the_accepted_steps(k):
    d = kernel_inputs(k, 3, 1, "cpu")
    acc = torch.zeros(1, dtype=torch.int64)
    ck.lm_chain_ref(d["x0"], d["lanes_t"], d["g32"], ck.LM32_ITERS, rebuilds=acc)
    assert acc.item() == _fresh_count(ck.lm_chain_ref, d["x0"], d["lanes_t"], d["g32"], ck.LM32_ITERS)
    x64 = d["x0"].double()
    acc.zero_()
    ck.polish_chain_ref(x64, d["T"], d["g64"], ck.LM_ITERS, rebuilds=acc)
    assert acc.item() == _fresh_count(ck.polish_chain_ref, x64, d["T"], d["g64"], ck.LM_ITERS)
    assert acc.item() >= x64.shape[0]  # every lane builds J in its first iteration


def test_wrappers_count_launches_lanes_and_rebuilds():
    d = kernel_inputs(2, 3, 2, "cpu")
    with profiling.tracing():
        xa = ck.adam_chain(d["x0"], d["lanes_t"], d["g32"], d["sched"][:5].contiguous())
        for _ in range(2):
            xl, fl = ck.lm_chain(xa, d["lanes_t"], d["g32"], 3)
        ck.polish_chain(xl[::2].double().contiguous(), d["T"], d["g64"], 2)
        got = profiling.table()["kernels"]
    lm = torch.zeros(1, dtype=torch.int64)
    ck.lm_chain_ref(xa, d["lanes_t"], d["g32"], 3, rebuilds=lm)
    polish = torch.zeros(1, dtype=torch.int64)
    ck.polish_chain_ref(xl[::2].double(), d["T"], d["g64"], 2, rebuilds=polish)
    assert got == {
        ("adam_chain", 2, 5): {"launches": 1, "lanes": 6},
        ("lm_chain", 2, 3): {"launches": 2, "lanes": 12, "rebuilds": 2 * lm.item()},
        ("polish_chain", 2, 2): {"launches": 1, "lanes": 3, "rebuilds": polish.item()},
    }


def test_eigenphase_targets_count_by_path():
    """On the CPU the eigenphases take the plain chain, with or without
    autograd: its targets count under ``weyl.plain_targets`` and nothing
    launches."""
    cov = gate_set_to_coverage(gates.cg_sqiswap(), device="cpu")
    T = torch.as_tensor(haar_sample(8, seed=5))
    before = _build.launch_counts()["gamma_eigenphases"]
    with profiling.tracing():
        monodromy_ks_batch(cov, T, "cpu")
        weyl.gamma_eigenphases(T[:3].clone().requires_grad_(True))
        got = profiling.table()["counters"]
    assert got == {"weyl.plain_targets": 11} and _build.launch_counts()["gamma_eigenphases"] == before


def test_eigenphases_refuse_devices_without_a_kernel():
    """A device that is neither the CPU nor CUDA raises, before it counts
    or launches anything."""
    before = _build.launch_counts()
    with profiling.tracing():
        with pytest.raises(ValueError, match="no eigenphase kernel for device meta"):
            weyl.gamma_eigenphases(torch.empty((2, 4, 4), dtype=torch.complex128, device="meta"))
        assert profiling.table()["counters"] == {}
    assert _build.launch_counts() == before


# ---------------------------------------------------------------- the readers


def test_readers_return_numbers_from_a_tiny_run():
    """The program's table of a traced segment on the CPU: the k assignment
    of 8 targets and one solve of each kernel; the card's busy and kernel
    seconds, which the CPU has not, stood in."""
    cov = gate_set_to_coverage(gates.conversion_gain_gate(0.0, 0.0, torch.pi / 2, 0.0, 0.5), device="cpu")
    T = torch.as_tensor(haar_sample(8, seed=3))
    d = kernel_inputs(2, 4, 2, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        with record_function("bench.ks"):
            monodromy_ks_batch(cov, T, "cpu")
        xa = ck.adam_chain(d["x0"], d["lanes_t"], d["g32"], d["sched"][:5].contiguous())
        xl, _ = ck.lm_chain(xa, d["lanes_t"], d["g32"], 4)
        ck.polish_chain(xl[::2].double().contiguous(), d["T"], d["g64"], 3)
        window_s = time.perf_counter() - t0
    red = trace_mod.reduce(*trace_mod.profile_events(prof), window_s)
    assert red["busy_s"] == 0 and red["kernel_s"] == {}
    assert all(harness.read_metric(name, {"trace": red}) is None for name in READERS)  # no device: nothing
    red.update(busy_s=window_s / 2, kernel_s={"lm": 1e-3, "polish": 2e-3})
    got = {name: harness.read_metric(name, {"trace": red}) for name in READERS}
    spans, kernels = profiling.table()["spans"], profiling.table()["kernels"]
    assert got["ks_coords_pct"] == 100 * spans["ks.coords"]["seconds"] / window_s
    assert got["ks_member_pct"] == 100 * spans["ks.member"]["seconds"] / window_s
    assert 0 < got["ks_coords_pct"] + got["ks_member_pct"] < 100 * spans["ks"]["seconds"] / window_s
    lm, polish = kernels[("lm_chain", 2, 4)], kernels[("polish_chain", 2, 3)]
    assert got["lm_counted_roofline_pct"] == 100 * flops.lm_launch(2, 8, 4, lm["rebuilds"] / 8)["bound_ms"] / 1e3 / 1e-3
    assert got["polish_counted_roofline_pct"] == (
        100 * flops.polish_launch(2, 4, 3, polish["rebuilds"] / 4)["bound_ms"] / 1e3 / 2e-3)
    assert all(v > 0 for v in got.values())


# ---------------------------------------------------------------- on the card

# the instances (K <= 12) and the generic programs' buckets (13: 3 slots, 24:
# 8, 48: 16; csrc/lm_generic.cuh lm_gen_bucket)
CARD_KS = [2, 3, 12, 13, 24, 48]
CARD_TARGETS, CARD_RESTARTS = 128, 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _kernel(name, x, T, g, iters, rebuilds=None):
    """slam_lm_chain / slam_polish_chain through their C entry, with the
    counter ``rebuilds`` or null."""
    xo, fo = torch.empty_like(x), torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    p = _build.ptr
    _build.launch(None, name, p(x), p(T), p(g), ctypes.c_int(iters), ctypes.c_int(g.shape[0]),
                  ctypes.c_int(x.shape[0]), p(xo), p(fo), None if rebuilds is None else p(rebuilds))
    return xo, fo


@pytest.mark.cuda
@pytest.mark.parametrize("k", CARD_KS)
def test_kernels_count_their_rebuilds(dev, k):
    d = kernel_inputs(k, CARD_TARGETS, CARD_RESTARTS, dev)
    xa = ck.adam_chain(d["x0"], d["lanes_t"], d["g32"], d["sched"])
    xl, fl = ck.lm_chain(xa, d["lanes_t"], d["g32"])
    xb = xl.view(CARD_TARGETS, CARD_RESTARTS, -1)[:, 0].double().contiguous()
    cases = (("slam_lm_chain", xa, d["lanes_t"], d["g32"], ck.LM32_ITERS, ck.lm_chain, ck.lm_chain_ref),
             ("slam_polish_chain", xb, d["T"], d["g64"], ck.LM_ITERS, ck.polish_chain, ck.polish_chain_ref))
    for name, x, T, g, iters, wrapper, plain in cases:
        acc = torch.zeros(1, dtype=torch.int64, device=dev)
        counted = _kernel(name, x, T, g, iters, acc)
        uncounted = _kernel(name, x, T, g, iters)
        assert torch.equal(counted[0], uncounted[0]) and torch.equal(counted[1], uncounted[1])
        own = _fresh_count(wrapper, x, T, g, iters)  # the kernel's own accepted steps
        ref = torch.zeros(1, dtype=torch.int64, device=dev)
        plain(x, T, g, iters, rebuilds=ref)
        # the plain version's count follows its own steps, which part from the
        # kernel's where f32 rounding (other sum orders) tips an accept test,
        # nearly always at ||r||^2's rounding floor
        print(f"{name} k={k} L={x.shape[0]}: rebuilds kernel {acc.item()}, its accepted steps {own}, "
              f"plain {ref.item()}")
        assert acc.item() == own
        assert x.shape[0] <= ref.item() <= x.shape[0] * iters
        with profiling.tracing():
            wrapper(x, T, g, iters)
            assert profiling.table()["kernels"][(wrapper.__name__, k, iters)] == {
                "launches": 1, "lanes": x.shape[0], "rebuilds": acc.item()}


@pytest.mark.cuda
def test_trace_reduction_reads_the_same_with_program_spans_on_the_card(dev, monkeypatch):
    ops, red = _same_reduction(dev, monkeypatch)
    assert ops and red["busy_s"] > 0
