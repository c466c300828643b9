"""Phase profile of the main solve (JAX scripts/profile_solver.py): the
seconds of Adam, the f32 LM ranking pass and the f64 polish, from solver
variants with the later phases set to zero iterations (``adam_only``:
lm32_iters = lm_iters = 0; ``adam+lm32``: lm_iters = 0; ``full``), each
timed as the script does (one warm call, then the mean of 3, each ending in
a synchronize), the phases by subtraction.

    python3 -m slam_decomposition_torch.tools.profile_solver [B] [k] [--reps 3] [--device cuda|cpu]

Two micro rows at B * R lanes: the batched chain forward
(``models.templates.chain_unitary``, f32) and the value and gradient of the
f32 square cost by autograd. And what the script could not have: the
kernels' own times in the same run (CUDA events around each launch, in
separate instrumented calls of each variant, mean of 3), so each
subtraction can be held against the kernels it should equal (a variant at
zero iterations still launches the LM / the polish for no iteration).

Prints the table and appends it to ``config.studies_dir()/profile_solver.md``.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import math
import time
import types

import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.tools import card, out_path, synchronize

RESTARTS = 4
REPS = 3
VARIANTS = {"adam_only": dict(lm32_iters=0, lm_iters=0), "adam+lm32": dict(lm_iters=0), "full": {}}
KERNELS = ("adam_chain", "lm_chain", "polish_chain")


def timed(fn, device, reps=REPS) -> float:
    """Mean seconds of fn() over ``reps`` calls after a warm one."""
    fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        synchronize(device)
    return (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def kernel_clock(device):
    """Times every call the solvers make of the three kernel wrappers (CUDA
    events on the card, the host clock on the CPU); yields {kernel: [ms of
    each call]}, filled once the block ends. The solvers reach the wrappers
    through ``opt.gauss_newton.ck``, which the block replaces by a view of
    ``ops.chain_kernels`` with the clocked wrappers: the module itself (and
    each wrapper's launch count) is left as it is."""
    from slam_decomposition_torch.opt import gauss_newton

    ck = gauss_newton.ck
    events = {name: [] for name in KERNELS}
    cuda = torch.device(device).type == "cuda"

    def clocked(name):
        fn = getattr(ck, name)

        def call(*args, **kw):
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                events[name].append((start, end))
            else:
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                events[name].append((t0, time.perf_counter()))
            return out
        return call

    view = types.SimpleNamespace(**vars(ck))
    for name in KERNELS:
        setattr(view, name, clocked(name))
    times = {}
    gauss_newton.ck = view
    try:
        yield times
    finally:
        gauss_newton.ck = ck
    synchronize(device)
    for name, pairs in events.items():
        times[name] = [s.elapsed_time(e) if cuda else 1e3 * (e - s) for s, e in pairs]


def profile(B: int = 1000, k: int = 2, device=DEFAULT_DEVICE, reps: int = REPS) -> dict:
    """{"seconds": {variant: s}, "kernel_ms": {variant: {kernel: ms a
    call}}, "micro": {row: s}, "rows": [(phase, seconds, share of the full
    solve, the kernels' own seconds)]}."""
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models.templates import build_ansatz, chain_unitary, cycle_gates
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.opt.gauss_newton import make_solver
    from slam_decomposition_torch.opt.samplers import haar_sample

    device = resolve_device(device)
    a = build_ansatz(cycle_gates([gates.SQISWAP], k))
    T = torch.as_tensor(haar_sample(B, seed=7)).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    x0 = torch.rand((B, RESTARTS, a.n_params), generator=gen, device=device, dtype=torch.float64) * (2 * math.pi)
    seconds, kernel_ms = {}, {}
    for name, kw in VARIANTS.items():
        solver = make_solver(a.eval_fn, a.n_params, chain_gates=a.chain_gates, device=device, **kw)
        seconds[name] = timed(lambda: solver.solve(x0, T), device, reps)
        with kernel_clock(device) as ms:
            for _ in range(reps):
                solver.solve(x0, T)
        kernel_ms[name] = {kn: sum(v) / reps for kn, v in ms.items()}

    lanes = B * RESTARTS
    xs32 = torch.rand((lanes, a.n_params), generator=gen, device=device) * (2 * math.pi)
    g32 = torch.as_tensor(a.chain_gates).to(device, torch.complex64)
    t32 = T[:1].to(torch.complex64).expand(lanes, 4, 4)

    def value_and_grad():
        x = xs32.detach().requires_grad_(True)
        f = ck.square_cost(x, t32, g32)
        (g,) = torch.autograd.grad(f.sum(), x)
        return f, g

    micro = {f"[micro] fwd eval x{lanes}": timed(lambda: chain_unitary(xs32, g32), device, reps),
             f"[micro] value_and_grad x{lanes}": timed(value_and_grad, device, reps)}

    def own(variant, minus=None):
        s = sum(kernel_ms[variant].values())
        return (s - (sum(kernel_ms[minus].values()) if minus else 0.0)) / 1e3

    full = seconds["full"]
    rows = [
        (f"adam_f32 ({ck.ADAM_ITERS} it)", seconds["adam_only"], own("adam_only")),
        (f"lm_f32 ({ck.LM32_ITERS} it)", seconds["adam+lm32"] - seconds["adam_only"], own("adam+lm32", "adam_only")),
        (f"lm_f64 polish ({ck.LM_ITERS} it)", seconds["full"] - seconds["adam+lm32"], own("full", "adam+lm32")),
        ("total", full, own("full")),
        *((name, s, None) for name, s in micro.items()),
    ]
    return {"B": B, "k": k, "restarts": RESTARTS, "seconds": seconds, "kernel_ms": kernel_ms, "micro": micro,
            "rows": [(name, s, s / full, k_s) for name, s, k_s in rows]}


def table(prof: dict, card_name: str) -> str:
    lines = [
        f"## profile_solver B={prof['B']} R={prof['restarts']} k={prof['k']} on {card_name} "
        f"({datetime.datetime.now(datetime.timezone.utc):%Y-%m-%d %H:%M} UTC)",
        "",
        "| phase | seconds | % of total | the kernels' own seconds |",
        "|---|---|---|---|",
    ]
    for name, s, share, k_s in prof["rows"]:
        lines.append(f"| {name} | {s:.6f} | {100 * share:.1f}% | {'' if k_s is None else f'{k_s:.6f}'} |")
    lines += ["", "Kernel ms a solve by variant: " + "; ".join(
        f"{v}: " + ", ".join(f"{kn} {ms:.4f}" for kn, ms in kms.items()) for v, kms in prof["kernel_ms"].items())]
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", type=int, nargs="?", default=1000)
    ap.add_argument("k", type=int, nargs="?", default=2)
    ap.add_argument("--reps", type=int, default=REPS, help="timed calls after the warm one")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    prof = profile(a.B, a.k, device, a.reps)
    md = table(prof, card(device))
    print(md)
    with out_path("profile_solver.md").open("a") as f:
        f.write(md + "\n")
    return prof


if __name__ == "__main__":
    main()
