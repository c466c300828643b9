"""Profile and A/B of the batched analytic init (ops/kak_batch.py) on one
CUDA card.

    python -m slam_decomposition_torch.tools.profile_init profile
    python -m slam_decomposition_torch.tools.profile_init ab

``profile``: on the k=2 and k=3 classes of haar_sample(100000, seed=456),
the warm init's seconds, the seconds of its stages (KAK state, Jacobi,
interleave angles, Gauss-Newton on 12 candidates per lane, Durand-Kerner),
and a torch.profiler table of one init call by device time.

``ab``: the small batched products as broadcast multiply-sum (``_mm``, the
default) against ``@`` (cuBLAS batched GEMM), alternating A B B A three
times in one process: the warm QFT-64 batched pass, the init of its k=2
and k=3 classes, then a k=2 init at 1000 / 4000 / 16000 / 64000 lanes of
haar_sample(100000, seed=7). Every time is host clock around work that
ends in torch.cuda.synchronize().
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile(dev: torch.device) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from slam_decomposition_torch.ops import kak_batch as kb
    from slam_decomposition_torch.opt.samplers import haar_sample, sqiswap_count_batch

    U = haar_sample(100_000, seed=456)
    ks = sqiswap_count_batch(U, device=dev)
    C = kb._Consts(dev)
    for k in (2, 3):
        T = torch.as_tensor(U[ks == k]).to(dev)
        init = kb.make_analytic_init(k, dev)
        init(T)
        stages = {"init": lambda: init(T), "kak_state": lambda: kb._kak_state(T, C),
                  "joint_diag": lambda: kb.joint_diag(T.real.contiguous(), T.imag.contiguous())}
        if k == 2:
            t = kb._kak_state(T, C)[0]
            target = kb._makhlin_magic(kb._mm(kb._mm(C.Bd, kb.can_matrix(t, C)), C.B))[0]
            p = torch.rand((len(t) * 12, 3), dtype=torch.float64, device=dev)
            tg = target.repeat_interleave(12, 0)
            coeffs = torch.rand((len(t), 5), dtype=torch.float64, device=dev) + 0.1
            stages.update({
                "interleave_angles": lambda: kb._interleave_angles(t, C),
                "gn_polish 12N": lambda: kb._gn_polish(p, tg, 8, C),
                "durand_kerner": lambda: kb._durand_kerner(coeffs),
            })
        for name, fn in stages.items():
            print(f"k={k} N={len(T)} {name}: {_timed(fn)[1]:.4f} s", flush=True)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            init(T)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=18), flush=True)


def ab(dev: torch.device) -> None:
    from slam_decomposition_torch.ops import kak_batch as kb
    from slam_decomposition_torch.opt.samplers import haar_sample, sqiswap_count_batch
    from slam_decomposition_torch.transpile import library
    from slam_decomposition_torch.transpile.consolidate import consolidate_2q_blocks
    from slam_decomposition_torch.transpile.passes import pass_manager_basic

    impls = {"mm": kb._mm, "matmul": lambda A, B: A @ B}
    circ = library.qft(64)
    Us = np.stack([b.unitary for b in consolidate_2q_blocks(circ)])
    ks = sqiswap_count_batch(Us, device=dev)
    qft_T = {k: torch.as_tensor(Us[ks == k]).to(dev) for k in (2, 3)}
    run = lambda: pass_manager_basic(circ, "sqiswap", 0.25, batched=True, device=dev)  # noqa: E731
    res = {name: {"pass": [], 2: [], 3: []} for name in impls}
    for name in impls:  # warm both
        kb._mm = impls[name]
        run()
    for name in ["matmul", "mm", "mm", "matmul"] * 3:
        kb._mm = impls[name]
        res[name]["pass"].append(_timed(run)[1])
        for k, T in qft_T.items():
            res[name][k].append(_timed(lambda: kb.make_analytic_init(k, dev)(T))[1])
    for name, r in res.items():
        for key, v in r.items():
            label = "qft64 pass" if key == "pass" else f"qft64 init k={key} N={len(qft_T[key])}"
            print(f"{name} {label}: {[round(x, 4) for x in v]} median {np.median(v):.4f} s", flush=True)
    U = haar_sample(100_000, seed=7)
    U2 = U[sqiswap_count_batch(U, device=dev) == 2]
    for n in (1000, 4000, 16000, 64000):
        T = torch.as_tensor(U2[:n]).to(dev)
        out = []
        for name in ("matmul", "mm", "mm", "matmul"):
            kb._mm = impls[name]
            init = kb.make_analytic_init(2, dev)
            init(T)
            out.append((name, round(_timed(lambda: init(T))[1], 4)))
        print(f"k=2 init N={n}: {out}", flush=True)
    kb._mm = impls["mm"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("profile", "ab"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_init: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    {"profile": profile, "ab": ab}[args.what](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
