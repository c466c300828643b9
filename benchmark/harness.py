"""One run of one cell: set-up, the measured window, the judgement, the
result line. Everything that belongs to one configuration, traffic mix,
flow or per-layer metric is found by its name in `BENCHMARK.json`:

- a configuration: the file that its entry names (`configs/<name>.json`);
- a traffic mix: `traffic/<name>.json`, whose "targets" names the
  generator (`traffic/<targets>.py`, given the mix's optional
  "target_params": a `pool` of "pool_batches" batches of "batch" targets,
  or `batches` of its own sizes), whose "flow" names the entry that
  the window drives (`flows/<flow>.py`), and whose optional "judge" names
  the comparison that decides `correct` (`reference/<judge>.py`; without
  it `reference/judge.py`, the judge of u3 chains);
- a per-layer metric: its reader `metrics/<name>.py`, a function
  `read(ctx)` that returns the number, or None where it finds nothing.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import importlib.util
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

from benchmark.metrics import trace as trace_mod

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_decomposition_tpu")
CHECK_PER_BATCH = 256  # answers judged from each batch of the window, drawn from the seed, unless the mix says
DEFAULT_JUDGE = "judge"
TRACE_SECONDS = 1.0  # the traced segment after the window: whole batches, at least two
TRACE_MIN_BATCHES = 2


class Spans:
    """Host-clock seconds spent inside each named span (each span ends in a
    synchronising copy); while ``profiling``, also a profiler range
    `bench.<name>`, which the trace reduction reads."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        ctx = torch.profiler.record_function(f"bench.{name}") if self.profiling else contextlib.nullcontext()
        try:
            with ctx:
                yield
        finally:
            self.seconds[name] += time.perf_counter() - t0

    def reset(self):
        self.seconds.clear()


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_file_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve_cell(spec: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell ``name`` with its configuration and traffic mix read."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return {"cell": cell, "config": config, "traffic": traffic}


def metric_entries(spec: dict, kind: str, cell: str) -> list:
    """The `end_to_end` or `per_layer` entries that this cell reports."""
    return [m for m in spec[kind] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def make_pool(gen_mod, traffic: dict, device) -> tuple:
    """(the mix's pool on ``device``, each batch's (start, stop) in it): a
    generator's `batches(seed, device, **target_params)` gives the batch
    sizes itself (one batch a circuit); otherwise `pool(n, seed, device,
    **target_params)` gives "pool_batches" batches of "batch" targets."""
    params = traffic.get("target_params", {})
    if hasattr(gen_mod, "batches"):
        pool, sizes = gen_mod.batches(traffic["pool_seed"], device, **params)
    else:
        sizes = [traffic["batch"]] * traffic["pool_batches"]
        pool = gen_mod.pool(sum(sizes), traffic["pool_seed"], device, **params)
    ends = np.cumsum([0] + sizes).tolist()
    return pool, list(zip(ends[:-1], ends[1:]))


def _seed_ints(seed: int, n: int) -> list:
    """n independent 63-bit seeds from one run seed of any size."""
    return [int(v) for v in np.random.SeedSequence(seed).generate_state(n, dtype=np.uint64) >> np.uint64(1)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell_name: str, seed: int, seconds: float, trace: bool, device="cuda", t_start: float | None = None,
        overrides: dict | None = None, log=print) -> dict:
    """One run; returns the result line's object. ``overrides`` changes
    traffic parameters (tests and readings at other sizes, such as
    ``check_per_batch``), and may name a ``solver_wrap`` (solver -> solver)
    that replaces each solver of a flow that solves, or a ``flow_wrap``
    (flow -> flow) that replaces the flow (the controls and the planted
    faults).

    A flow's ``run_batch`` returns an answer object with ``answered``, the
    count of its targets that it answered (counted against `failed`), and
    ``sample(pick)``, the answers of the targets ``pick`` as the judge takes
    them ({key: an array or a list, one entry a target})."""
    t_start = time.perf_counter() if t_start is None else t_start
    overrides = dict(overrides or {})
    wrap = overrides.pop("solver_wrap", None)
    flow_wrap = overrides.pop("flow_wrap", None)
    spec = load_spec()
    c = resolve_cell(spec, cell_name)
    config, traffic = c["config"], {**c["traffic"], **overrides}
    check_per_batch = traffic.get("check_per_batch", CHECK_PER_BATCH)
    device = torch.device(device)
    s_starts, s_warm, s_sample, s_order = _seed_ints(seed, 4)

    # ------------------------------------------------------------ set-up
    if device.type == "cuda":
        from slam_decomposition_torch.ops import _build

        _build.load()  # the kernel library, built into the checkout on a cell's first run
    gen_mod = importlib.import_module(f"benchmark.traffic.{traffic['targets']}")
    flow_mod = importlib.import_module(f"benchmark.flows.{traffic['flow']}")
    spans = Spans()
    flow = flow_mod.Flow(config, traffic, device, s_starts, spans)
    if wrap is not None:
        flow.solvers = {k: wrap(s) for k, s in flow.solvers.items()}
    if flow_wrap is not None:
        flow = flow_wrap(flow)
    # one pool for every run of the mix, its batches in an order drawn from the
    # run's seed: every seed gets the same work (with a pool drawn from the
    # seed, the sixteenth-iSwap cell's rate moved ~4% from seed to seed)
    pool, bounds = make_pool(gen_mod, traffic, device)
    order = np.random.default_rng(s_order).permutation(len(bounds))

    def batch_of(b: int) -> tuple:
        return bounds[int(order[b % len(order)])]

    sizes = set()  # a batch of each size the window takes
    for b in range(len(bounds)):
        start, stop = batch_of(b)
        if stop - start not in sizes:
            sizes.add(stop - start)
            flow.warm(pool[start:stop], s_warm)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    from slam_decomposition_torch.ops import chain_kernels as ck

    # ------------------------------------------------------------ the window
    ck.reset_launch_counts()
    spans.reset()
    sample_rng = np.random.default_rng(s_sample)
    rows, parts = [], collections.defaultdict(list)
    batch_s, attempted, answered, n_batches = [], 0, 0, 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        start, stop = batch_of(n_batches)
        tb = time.perf_counter()
        out = flow.run_batch(pool[start:stop])
        batch_s.append(time.perf_counter() - tb)
        n_batches += 1
        attempted += stop - start
        answered += out.answered
        pick = np.sort(sample_rng.choice(stop - start, size=min(check_per_batch, stop - start), replace=False))
        rows.append(start + pick)
        for key, part in out.sample(pick).items():
            parts[key].append(part)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    lanes = ck.lane_counts()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ctx = {
        "window_s": window_s, "span_s": dict(spans.seconds), "lanes": lanes, "attempted": attempted,
        "answered": answered, "batch_s": batch_s, "setup_s": setup_s, "trace": None,
    }
    log(f"window: {n_batches} batches, {attempted} targets in {window_s:.6f} s; batch seconds: "
        f"{len(batch_s)} samples, median {statistics.median(batch_s):.6f}", file=sys.stderr)
    log("batch seconds: " + " ".join(f"{b:.6f}" for b in batch_s), file=sys.stderr)

    # ------------------------------------------------------------ the traced segment
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace:
        ctx["trace"] = trace_mod.traced_segment(flow, pool, n_batches, batch_of, spans, device,
                                                TRACE_SECONDS, TRACE_MIN_BATCHES)
        device_info["busy_s"] = ctx["trace"]["busy_s"]
        device_info["window_s"] = ctx["trace"]["window_s"]

    # ------------------------------------------------------------ judge
    targets = pool[torch.as_tensor(np.concatenate(rows), device=device)].cpu().numpy()
    del flow, pool, out
    if device.type == "cuda":
        torch.cuda.empty_cache()
    answers = {key: np.concatenate(p) if isinstance(p[0], np.ndarray) else [a for part in p for a in part]
               for key, p in parts.items()}
    judge_mod = importlib.import_module(f"benchmark.reference.{traffic.get('judge', DEFAULT_JUDGE)}")
    checks = judge_mod.judge(config, targets, answers)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    # ------------------------------------------------------------ metrics
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metric_entries(spec, kind, cell_name):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": attempted - answered, "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = ctx["trace"]["breakdown"]
    result["checks"] = checks
    return result


def read_metric(name: str, ctx: dict):
    """A metric from its reader, `metrics/<name>.py`. A quantity split by the
    end-to-end metric that it moves, `<reader>.<suffix>` (`device_idle_pct.ks`
    moves `assigned_targets_per_s`), is read by `metrics/<reader>.py` unless
    it has a file of its own."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = HERE / "metrics" / f"{name.split('.', 1)[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    return load_file_module(path, f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}").read(ctx)
