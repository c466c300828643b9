"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (more for the build report):
  1. device: the card's name and power limit (nvidia-smi) and torch's name;
  2. build: compile the CUDA kernels from slam_decomposition_torch/csrc with
     nvcc, print the build seconds, ptxas registers / spills and the
     resident blocks and warps per SM (CUDA occupancy calculator) of each
     kernel instance; every instance must build without spills and with no
     stack frame beyond the math library's sincos scratch;
  3. kernel parity: each kernel against its plain PyTorch version on the
     same inputs at the main path's shapes (40000 f32 lanes = 10000
     targets x 4 restarts for Adam and LM, 10000 f64 lanes for the
     polish), at k=2 and k=3, with times of both after one warm call, and
     each instance's FLOPs, bound and share of the bound from the port's
     flop model (slam_decomposition_torch/utils/mfu.py) at those shapes;
     the Adam instance that also returns the square cost must return the
     default instance's x bit for bit and the plain square cost of that x;
  4. main path: slam_decomposition_torch.pipeline.decompose_haar at
     B=100000, chunk=10000, restarts=4, thresh=1e-10, seed=456, which must
     give the k histogram {2: 79029, 3: 20971}, certify every target at
     square cost <= 1e-10, and launch every kernel once per chunk it
     solves (warm-up, k buckets and rescue rounds);
  5. transpile path, counted like the main path:
     (a) QFT-64 (2048 blocks): the sqiSwap count histogram, then
     slam_decomposition_torch.transpile.passes.pass_manager_basic(qft(64),
     "sqiswap", 0.25) batched on the card and as the host loop, each run
     twice (warm, then timed), against the JAX package's durations and gate
     counts, with no host fallback and one polish launch per k-class; the
     timed batched pass's emitted steps re-certified on the host;
     (b) batched synthesis of haar_sample(100000, seed=456): the count
     histogram, every block's steps against its target, the host fallback
     under its limit, two polish launches, and the warm seconds per stage;
     after each of (a) and (b), the polish kernel against its plain version
     on the analytic init's seeds of each k-class (1275 / 32 and 79029 /
     20971 lanes), with phase 3's tolerances and outside the counted runs;
  6. result: a JSON line of the kernels (launches summed over the main and
     transpile runs), then the device line.

Any failure exits non-zero before the result lines. There is no CPU path:
without CUDA the script exits with status 1.
"""

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

B, CHUNK, RESTARTS, THRESH, SEED = 100_000, 10_000, 4, 1e-10, 456
WANT_HIST = {2: 79029, 3: 20971}
REPLACES = {
    "adam_chain": "slam_decomposition_tpu/ops/pallas_chain.py:753",
    "lm_chain": "slam_decomposition_tpu/ops/pallas_chain.py:299",
    "polish_chain": "slam_decomposition_tpu/ops/pallas_chain.py:611",
}
SOURCES = {
    name: f"slam_decomposition_torch/csrc/{name}.cu" for name in REPLACES
}
# stated tolerances (see each check for the reason; the readings they were
# set from are in PERF.md)
ADAM_PARITY_ITERS, ADAM_ATOL, ADAM_LANE_FRAC = 25, 5e-5, 0.995
ADAM_COST_FRAC_TOL = 0.01
ADAM_WITH_COST_ATOL = 1e-5  # the kernel's f32 cost against the plain f32 cost of its x
# bytes of stack frame an instance may have: the scratch of sincosf's / sincos's
# slow-path range reduction (32 / 72 B; with those two calls replaced every
# instance builds with a 0 B frame, PERF.md section 6), no array of the kernels'
STACK_MAX = 72
LM_RTOL, LM_ATOL, LM_LANE_FRAC = 1e-3, 1e-5, 0.99
POLISH_VERDICT_FRAC, POLISH_COST_ATOL, CERT_ATOL = 0.999, 1e-11, 1e-13
# transpile phase. QFT-64's reference values are the JAX package's own
# (pass_manager_basic on its CPU backend, command in PERF.md): the host loop
# emits 2722 sqiSwaps; the batched path counts the 38 blocks cp(pi/2^26)
# (chamber x = 7.5e-9, under the count's 1e-8 identity tolerance) as k=0
# and emits them as certified products, hence 2646 there, in both packages
# (tests/test_torch_transpile.py::test_tiny_cp_blocks_take_the_product_path)
QFT_Q, QFT_BLOCKS, QFT_HIST, QFT_DURATION = 64, 2048, {0: 741, 2: 1275, 3: 32}, 190.0
QFT_GATES_HOST = {"u1q": 5508, "riswap": 2722}
QFT_GATES_BATCHED = {"u1q": 5356, "riswap": 2646}
SYNTH_ATOL = 1e-10  # the host routine's trace-infidelity bar (transpile/kak.py)
SYNTH_FALLBACK_MAX = 10  # host fallbacks allowed in the Haar batch (PERF.md)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def timed_ms(fn):
    """Result and device milliseconds of fn() after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_device():
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    card = q[torch.cuda.current_device()] if len(q) > torch.cuda.current_device() else q[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    return card


def phase_build():
    from slam_decomposition_torch.ops import _build

    info = _build.build()
    print(f"[build] {info['seconds']:.1f} s nvcc -> {info['path'].name}")
    regs = _build.ptxas_summary(info["ptxas"])
    for entry, r in sorted(regs.items()):
        m = re.search(r"([a-z_]+_kernel)ILi(\d+)E(?:Lb(\d)E)?", entry)
        name = f"{m.group(1)}<{m.group(2)}{', cost' if m.group(3) == '1' else ''}>" if m else entry
        print(f"[build] ptxas {name}: {r.get('registers')} registers, "
              f"{r.get('stack_frame')} B stack, {r.get('spill_stores')} B spill stores, "
              f"{r.get('spill_loads')} B spill loads")
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0 and r.get("stack_frame", 1 << 30) <= STACK_MAX,
              f"{name} spills or keeps arrays in local memory")
    # Adam with and without the cost, the LM and the polish, each at k = 2, 3
    check(len(regs) == 8, f"expected 8 kernel instances in the ptxas report, got {len(regs)}")
    _build.load()
    for name in REPLACES:
        for k in (2, 3):
            o = _build.occupancy(name, k)
            print(f"[build] occupancy {name}<{k}>: {o['blocks']} resident blocks x {o['threads']} threads = "
                  f"{o['warps']} warps per SM")
            check(o["warps"] >= 12, f"{name}<{k}> keeps only {o['warps']} warps per SM resident")
    return regs


def fresh_iterations(fn, x, T, g, iters):
    """Mean number per lane of the LM iterations that rebuild J, A and b:
    the first, and each after an accepted step. fn(x, T, g, i) runs the
    first i iterations (the same ones for any count), so step i was
    accepted iff ||r||^2 after i + 1 iterations is below that after i."""
    f = [fn(x, T, g, i)[1] for i in range(iters)]
    accepted = sum((f[i] < f[i - 1]).double() for i in range(1, iters))
    return 1.0 + accepted.mean().item()


def bound_line(name, k, bound, ms):
    """Print and return the instance's bound against its measured time."""
    print(f"[bound] {name} k={k}: {bound['flops']:.4e} flops, {bound['bytes']} B -> bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); kernel {ms:.3f} ms = {bound['bound_ms'] / ms:.1%} of the bound")
    return bound


def phase_parity():
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.tools.inputs import best_restart, kernel_inputs
    from slam_decomposition_torch.utils import mfu

    dev = torch.device("cuda")
    stats = {name: {"max_abs_err": 0.0} for name in REPLACES}
    for k in (2, 3):
        g64, g32, T, lanes_t, x0, sched = kernel_inputs(k, CHUNK, RESTARTS, dev).values()

        # Adam: f32 association order differs, and Adam's m/sqrt(v) step
        # amplifies it on lanes whose gradient components sit near zero
        # (0.08-0.1% of lanes beyond 5e-5 after 25 steps on the H100), so
        # lanes are compared after 25 steps with a lane fraction, and the
        # 100-step results by their cost distribution.
        s25 = sched[:ADAM_PARITY_ITERS].contiguous()
        d = (ck.adam_chain(x0, lanes_t, g32, s25) - ck.adam_chain_ref(x0, lanes_t, g32, s25)).abs().amax(1)
        frac = (d <= ADAM_ATOL).float().mean().item()
        xa, ms = timed_ms(lambda: ck.adam_chain(x0, lanes_t, g32, sched))
        xa_ref, plain_ms = timed_ms(lambda: ck.adam_chain_ref(x0, lanes_t, g32, sched))
        ca = ck.square_cost(xa, lanes_t, g32)
        ca_ref = ck.square_cost(xa_ref, lanes_t, g32)
        dfrac = abs((ca < 1e-2).float().mean().item() - (ca_ref < 1e-2).float().mean().item())
        print(f"[parity] adam_chain k={k} L={x0.shape[0]}: {ADAM_PARITY_ITERS} steps max|dx| {d.max().item():.3e}, "
              f"{frac:.5f} of lanes within {ADAM_ATOL:g} (need >= {ADAM_LANE_FRAC}); 100 steps "
              f"|d frac(cost<1e-2)| {dfrac:.4f} (need <= {ADAM_COST_FRAC_TOL}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(frac >= ADAM_LANE_FRAC and dfrac <= ADAM_COST_FRAC_TOL, f"adam_chain k={k} disagrees with its plain version")
        st = stats["adam_chain"]
        st["max_abs_err"] = max(st["max_abs_err"], d.max().item())
        st[f"ms_k{k}"], st[f"plain_ms_k{k}"] = ms, plain_ms
        st[f"bound_k{k}"] = bound_line("adam_chain", k, mfu.adam_launch(k, x0.shape[0], sched.shape[0]), ms)
        # the instance that also returns the square cost: the same program
        # up to the last step, so its x must be the default instance's (held
        # to the plain version above) bit for bit
        (xc, cost), ms_c = timed_ms(lambda: ck.adam_chain(x0, lanes_t, g32, sched, with_cost=True))
        cerr = (cost - ck.square_cost(xc, lanes_t, g32)).abs().max().item()
        print(f"[parity] adam_chain with_cost k={k}: max|dx| to the default instance {(xc - xa).abs().max().item():.3e} "
              f"(need 0), max|cost - plain cost of its x| {cerr:.3e} (need <= {ADAM_WITH_COST_ATOL:g}); kernel {ms_c:.3f} ms")
        check(torch.equal(xc, xa), f"adam_chain with_cost k={k}: x differs from the default instance's")
        check(cerr <= ADAM_WITH_COST_ATOL, f"adam_chain with_cost k={k}: cost disagrees with the plain cost of its x")

        # LM: compare ||r||^2 per lane; accept/reject decisions near the f32
        # floor may differ, hence the lane fraction (the JAX kernel test's bound)
        (xl, fl), ms = timed_ms(lambda: ck.lm_chain(xa, lanes_t, g32))
        (_, fl_ref), plain_ms = timed_ms(lambda: ck.lm_chain_ref(xa, lanes_t, g32))
        ok = torch.isclose(fl, fl_ref, rtol=LM_RTOL, atol=LM_ATOL).float().mean().item()
        err = (fl - fl_ref).abs().max().item()
        print(f"[parity] lm_chain k={k} L={xa.shape[0]}: max|d||r||^2| {err:.3e}, {ok:.5f} of lanes within "
              f"rtol {LM_RTOL:g} atol {LM_ATOL:g} (need >= {LM_LANE_FRAC}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(ok >= LM_LANE_FRAC, f"lm_chain k={k} disagrees with its plain version")
        st = stats["lm_chain"]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st[f"ms_k{k}"], st[f"plain_ms_k{k}"] = ms, plain_ms
        fresh = fresh_iterations(ck.lm_chain, xa, lanes_t, g32, ck.LM32_ITERS)
        print(f"[bound] lm_chain k={k}: {fresh:.3f} of {ck.LM32_ITERS} iterations per lane rebuild J")
        st[f"bound_k{k}"] = bound_line("lm_chain", k, mfu.lm_launch(k, xa.shape[0], ck.LM32_ITERS, fresh), ms)

        # polish from each target's best restart
        xb = best_restart(xl, fl, RESTARTS)
        err, ms, plain_ms = polish_parity(f"k={k}", xb, T, g64)
        st = stats["polish_chain"]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st[f"ms_k{k}"], st[f"plain_ms_k{k}"] = ms, plain_ms
        fresh = fresh_iterations(ck.polish_chain, xb, T, g64, ck.LM_ITERS)
        print(f"[bound] polish_chain k={k}: {fresh:.3f} of {ck.LM_ITERS} iterations per lane rebuild J")
        st[f"bound_k{k}"] = bound_line("polish_chain", k, mfu.polish_launch(k, xb.shape[0], ck.LM_ITERS, fresh), ms)
    return stats


def polish_parity(label, x, T, g64):
    """The polish kernel against its plain version from the same x (L, n)
    f64: the certificates must give the same <= THRESH verdicts and agree
    within 10% of the bar where both certify (J is f32 in both, so an LM
    step at the f32 floor can be accepted in one and rejected in the
    other), and the kernel's certificate must match the true f64 cost of
    its x. Returns (max |d cost| where both certify, kernel ms, plain ms)."""
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.opt.gauss_newton import certificate

    (xp, fp), ms = timed_ms(lambda: ck.polish_chain(x, T, g64))
    (_, fp_ref), plain_ms = timed_ms(lambda: ck.polish_chain_ref(x, T, g64))
    c, c_ref = certificate(fp), certificate(fp_ref)
    verdict = ((c <= THRESH) == (c_ref <= THRESH)).double().mean().item()
    both = (c <= THRESH) & (c_ref <= THRESH)
    err = (c - c_ref)[both].abs().max().item() if both.any() else 0.0
    true = ck.square_cost(xp, T, g64)
    cert = c <= THRESH
    cert_err = (c - true)[cert].abs().max().item() if cert.any() else 0.0
    print(f"[parity] polish_chain {label} L={x.shape[0]}: certified {int(cert.sum())} vs plain "
          f"{int((c_ref <= THRESH).sum())}, same verdict on {verdict:.5f} of lanes (need >= {POLISH_VERDICT_FRAC}), "
          f"max|d cost| where both certify {err:.3e} (need <= {POLISH_COST_ATOL:g}), certificate vs true f64 cost "
          f"{cert_err:.3e} (need <= {CERT_ATOL:g}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    check(verdict >= POLISH_VERDICT_FRAC and err <= POLISH_COST_ATOL and cert_err <= CERT_ATOL,
          f"polish_chain {label} disagrees with its plain version")
    return err, ms, plain_ms


def polish_parity_on_init(label, U, ks, dev):
    """polish_parity at the transpile path's shapes and inputs: per k-class
    of U, the analytic init's x (the seeds the batched synthesis polishes).
    Returns the largest max |d cost|."""
    from slam_decomposition_torch.opt.gauss_newton import make_analytic_solver

    worst = 0.0
    for k in (2, 3):
        solver = make_analytic_solver(k, dev)
        T = torch.as_tensor(U[ks == k]).to(dev).contiguous()
        x = solver.init_only(T).to(torch.float64).contiguous()
        err, _, _ = polish_parity(f"{label} k={k} (analytic-init seeds)", x, T, solver.base.gates64)
        worst = max(worst, err)
    return worst


def phase_main_path(card):
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.pipeline import decompose_haar

    ck.reset_launch_counts()
    t0 = time.perf_counter()
    r = decompose_haar(B=B, chunk=CHUNK, restarts=RESTARTS, thresh=THRESH, seed=SEED, device="cuda")
    wall = time.perf_counter() - t0
    counts = ck.launch_counts()
    hist = r.k_histogram()
    worst = float(np.max(r.losses))
    # one launch of each kernel per solved chunk: one warm-up chunk per k,
    # the chunks of each k bucket, and the chunks of each rescue round
    chunks = sum(math.ceil(n / CHUNK) for n in [*hist.values(), *r.rescued])
    want = len(WANT_HIST) + chunks
    print(f"[main] k histogram {hist}; certified {r.n_certified}/{B} at <= {THRESH:g}; worst loss {worst:.3e}; "
          f"rescued {r.rescued}; launches {counts} (expected {want} each)")
    t = r.times
    print(f"[main] {card}: ranges {t['ranges']:.3f} s, solve {t['solve']:.3f} s, rescue {t['rescue']:.3f} s, "
          f"total {t['total']:.3f} s -> {r.n_certified / t['total']:.1f} targets/s "
          f"(call incl. warm-up {wall:.1f} s)")
    check(r.losses.shape == (B,) and np.isfinite(r.losses).all(), "losses are not finite of shape (B,)")
    check(hist == WANT_HIST, f"k histogram {hist} != {WANT_HIST}")
    check(r.n_certified == B, f"certified {r.n_certified} of {B}")
    check(worst <= THRESH, f"worst loss {worst} > {THRESH}")
    check(all(v == want for v in counts.values()), f"launches {counts}, expected {want} of each kernel")
    return counts, r.n_certified / t["total"]


def contract(results, U):
    """How many (steps, n) results meet the synthesis contract, and the worst
    phase-sensitive trace infidelity 1 - Re tr(V^dag U)/4: V =
    steps_to_matrix(steps) reproduces its target within SYNTH_ATOL, global
    phase included, with n sqiswap steps. Vectorized: blocks are grouped by
    step structure, so the matrix products run once per structure."""
    from slam_decomposition_torch.transpile.kak import SQISWAP_M

    groups = {}
    for i, (steps, _) in enumerate(results):
        groups.setdefault(tuple(kind for kind, _ in steps), []).append(i)
    infid = np.empty(len(U))
    n_sq = np.empty(len(U), dtype=np.int64)
    for kinds, idx in groups.items():
        V = np.broadcast_to(np.eye(4, dtype=complex), (len(idx), 4, 4))
        for j, kind in enumerate(kinds):
            if kind == "sqiswap":
                V = SQISWAP_M @ V
            elif kind == "1q":
                l = np.stack([results[i][0][j][1][0] for i in idx])
                r = np.stack([results[i][0][j][1][1] for i in idx])
                V = np.einsum("mab,mcd->macbd", l, r).reshape(-1, 4, 4) @ V
            else:
                V = np.exp(1j * np.array([results[i][0][j][1] for i in idx]))[:, None, None] * V
        infid[idx] = 1.0 - np.einsum("mij,mij->m", V.conj(), U[idx]).real / 4.0
        n_sq[idx] = kinds.count("sqiswap")
    ok = (infid <= SYNTH_ATOL) & (n_sq == np.array([n for _, n in results]))
    return int(ok.sum()), float(infid.max())


def _hist(ns):
    vals, cnt = np.unique(np.asarray(ns), return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, cnt)}


def phase_transpile(card, main_rate):
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.opt.samplers import haar_sample, sqiswap_count_batch
    from slam_decomposition_torch.transpile import library
    from slam_decomposition_torch.transpile.batch_synth import sqiswap_decompose_batch
    from slam_decomposition_torch.transpile.consolidate import consolidate_2q_blocks
    from slam_decomposition_torch.transpile.passes import pass_manager_basic

    dev = torch.device("cuda")
    total = {name: 0 for name in REPLACES}

    def counted(fn):
        """fn() with the launch counts set to 0 before and read after."""
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = ck.launch_counts()
        for name in total:
            total[name] += got[name]
        return out, wall, got

    def pass_twice(batched, stats=None):
        run = lambda: pass_manager_basic(circ, "sqiswap", 0.25, batched=batched, device=dev, stats=stats)  # noqa: E731
        run()
        torch.cuda.synchronize()
        if not batched:
            t0 = time.perf_counter()
            return run(), time.perf_counter() - t0, None
        return counted(run)

    # (a) QFT-64, the repo's largest transpile circuit
    circ = library.qft(QFT_Q)
    Us = np.stack([b.unitary for b in consolidate_2q_blocks(circ)])
    ks = sqiswap_count_batch(Us, device=dev)
    hist = _hist(ks)
    print(f"[transpile] qft({QFT_Q}): {len(Us)} blocks, sqiswap counts {hist}")
    check(len(Us) == QFT_BLOCKS, f"qft({QFT_Q}) consolidates to {len(Us)} blocks, not {QFT_BLOCKS}")
    check(hist == QFT_HIST, f"qft({QFT_Q}) counts {hist} != {QFT_HIST}")
    stats = {}
    (_, m_b), t_b, launches = pass_twice(True, stats)
    emitted = stats.pop("results")  # the timed pass's (steps, n) per block
    (_, m_h), t_h, _ = pass_twice(False)
    print(f"[transpile] qft({QFT_Q}) batched: duration {m_b['duration']}, gates {m_b['gate_counts']}, stats {stats}, "
          f"launches {launches}; host loop: duration {m_h['duration']}, gates {m_h['gate_counts']}")
    print(f"[transpile] {card}: qft({QFT_Q}) pass_manager_basic warm {t_b:.3f} s batched vs {t_h:.3f} s host loop")
    check(m_b["duration"] == QFT_DURATION == m_h["duration"], "qft-64 duration differs from the reference")
    check(m_b["gate_counts"] == QFT_GATES_BATCHED, f"batched gate counts {m_b['gate_counts']} != {QFT_GATES_BATCHED}")
    check(m_h["gate_counts"] == QFT_GATES_HOST, f"host gate counts {m_h['gate_counts']} != {QFT_GATES_HOST}")
    check(stats == {"device": QFT_BLOCKS - QFT_HIST[0], "fallback": 0, "trivial": QFT_HIST[0]},
          f"qft-64 stats {stats}")
    check(launches["polish_chain"] == 2 and launches["adam_chain"] == launches["lm_chain"] == 0,
          f"qft-64 batched pass launches {launches}, expected 2 polish")
    # the timed pass's emitted steps, re-certified on the host
    ok, worst = contract(emitted, Us)
    hist = _hist([n for _, n in emitted])
    print(f"[transpile] qft({QFT_Q}) emitted steps: {ok}/{len(Us)} meet the contract, worst trace infidelity "
          f"{worst:.3e} (need <= {SYNTH_ATOL:g}); emitted counts {hist}")
    check(ok == len(Us), f"{len(Us) - ok} qft-64 blocks miss the contract")
    check(hist == QFT_HIST, f"qft-64 emitted counts {hist} != {QFT_HIST}")
    # the polish kernel against its plain version at this path's shapes
    err_a = polish_parity_on_init(f"qft({QFT_Q})", Us, ks, dev)

    # (b) full width: the Haar batch of the main path
    U = haar_sample(B, seed=SEED)
    sqiswap_decompose_batch(haar_sample(B, seed=SEED + 1), device=dev)  # warm-up on other data
    stats, times = {}, {}
    res, wall, launches = counted(lambda: sqiswap_decompose_batch(U, stats=stats, device=dev, times=times))
    ks = np.array([n for _, n in res])
    hist = _hist(ks)
    ok, worst = contract(res, U)
    print(f"[transpile] haar {B} (seed {SEED}): counts {hist}; {ok}/{B} meet the contract (worst trace infidelity "
          f"{worst:.3e}); stats {stats} (fallback limit {SYNTH_FALLBACK_MAX}); launches {launches}")
    print(f"[transpile] {card}: haar {B} warm count {times['count']:.3f} s, init {times['init']:.3f} s, "
          f"polish {times['polish']:.3f} s, host emit {times['emit']:.3f} s; total {wall:.3f} s -> "
          f"{B / wall:.1f} blocks/s (main path: {main_rate:.1f} targets/s)")
    check(hist == WANT_HIST, f"haar counts {hist} != {WANT_HIST}")
    check(ok == B, f"{B - ok} of {B} blocks miss the contract")
    check(stats["fallback"] <= SYNTH_FALLBACK_MAX, f"fallback {stats['fallback']} > {SYNTH_FALLBACK_MAX}")
    check(launches["polish_chain"] == 2 and launches["adam_chain"] == launches["lm_chain"] == 0,
          f"haar batch launches {launches}, expected 2 polish")
    err_b = polish_parity_on_init(f"haar {B}", U, ks, dev)
    print(f"[transpile] launches summed over the transpile runs: {total}")
    return total, max(err_a, err_b)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs on a GPU only", file=sys.stderr)
        return 1
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = phase_device()
        phase_build()
        stats = phase_parity()
        counts, main_rate = phase_main_path(card)
        t_counts, t_polish_err = phase_transpile(card, main_rate)
        counts = {name: counts[name] + t_counts[name] for name in counts}
        stats["polish_chain"]["max_abs_err"] = max(stats["polish_chain"]["max_abs_err"], t_polish_err)
    except (SmokeFailure, ImportError, RuntimeError, subprocess.CalledProcessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": counts[name],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": stats[name]["ms_k2"],
            "plain_ms": stats[name]["plain_ms_k2"],
            "bound_ms": stats[name]["bound_k2"]["bound_ms"],
            "bound_by": stats[name]["bound_k2"]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a per-lane solve
            "flops": stats[name]["bound_k2"]["flops"],
            "ms_k3": stats[name]["ms_k3"],
            "plain_ms_k3": stats[name]["plain_ms_k3"],
            "bound_ms_k3": stats[name]["bound_k3"]["bound_ms"],
            "flops_k3": stats[name]["bound_k3"]["flops"],
        }
        for name in REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
