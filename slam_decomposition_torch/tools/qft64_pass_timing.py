"""Pass wall clock of the QFT on the card (JAX scripts/qft64_pass_timing.py).

The unrouted QFT-64 consolidates into 64 * 63 / 2 = 2016 controlled-phase
blocks. Printed, each cold (first call) and warm:

  * ``coverage.weyl_coords_float`` of every block on the device, held to the
    same call on the CPU within COORD_ATOL (both run in f64: the port has no
    mixed-precision tier, so the bound is f64's, not the TPU's 1e-7);
  * ``coverage.monodromy_ks_batch`` over the sqiSwap set, with the k
    histogram;
  * ``transpile.passes.optimized_sqiswap_sub(qc, 0.25)``, and with
    ``--fit`` also with ``fit_1q=True`` (the driven fit, a minute a pass on
    the H100);
  * ``pass_manager_basic``: the host loop against the batched synthesis,
    whose durations must be equal.

    python3 -m slam_decomposition_torch.tools.qft64_pass_timing [--qubits 64] [--fit] [--device cuda|cpu]

The timings also go to ``config.studies_dir()/qft64_pass_timing.json``.
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.tools import card, synchronize, write_json

COORD_ATOL = 1e-12


def cold_warm(fn, device) -> tuple:
    """(output, cold seconds, warm seconds) of two calls of fn()."""
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return out, times[0], times[1]


def timing(qubits: int = 64, fit: bool = False, device=DEFAULT_DEVICE) -> dict:
    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch, weyl_coords_float
    from slam_decomposition_torch.models import gates as G
    from slam_decomposition_torch.transpile import library
    from slam_decomposition_torch.transpile.consolidate import consolidate_2q_blocks
    from slam_decomposition_torch.transpile.passes import optimized_sqiswap_sub, pass_manager_basic

    device = resolve_device(device)
    out = {"qubits": qubits}
    qc = library.qft(qubits)
    t0 = time.perf_counter()
    blocks = consolidate_2q_blocks(qc)
    us = np.stack([b.unitary for b in blocks])
    out["consolidate_s"] = time.perf_counter() - t0
    out["blocks"] = len(blocks)
    print(f"consolidate: {len(blocks)} blocks in {out['consolidate_s']:.2f}s")

    coords, out["coords_cold_s"], out["coords_warm_s"] = cold_warm(lambda: weyl_coords_float(us, device), device)
    print(f"coords ({len(us)}): cold {out['coords_cold_s']:.2f}s warm {out['coords_warm_s']:.3f}s")
    if device.type != "cpu":
        err = float(np.abs(coords - weyl_coords_float(us, "cpu")).max())
        out["coords_max_delta"] = err
        print(f"device-vs-CPU f64 coordinate parity: max |delta| = {err:.2e} (need <= {COORD_ATOL:g})")
        assert err <= COORD_ATOL, err

    cov = gate_set_to_coverage(G.cg_sqiswap(), device=device)
    ks, out["ks_cold_s"], out["ks_warm_s"] = cold_warm(lambda: monodromy_ks_batch(cov, us, device), device)
    out["ks_hist"] = {int(k): n for k, n in sorted(collections.Counter(ks.tolist()).items())}
    print(f"ks ({len(us)}): cold {out['ks_cold_s']:.2f}s warm {out['ks_warm_s']:.3f}s dist {out['ks_hist']}")

    c, out["pass_cold_s"], out["pass_warm_s"] = cold_warm(
        lambda: optimized_sqiswap_sub(qc, duration_1q=0.25, device=device), device)
    print(f"optimized_sqiswap_sub full pass: cold {out['pass_cold_s']:.2f}s warm {out['pass_warm_s']:.2f}s "
          f"({len(c.ops)} ops out)")
    if fit:
        c, out["fit_cold_s"], out["fit_warm_s"] = cold_warm(
            lambda: optimized_sqiswap_sub(qc, duration_1q=0.25, fit_1q=True, device=device), device)
        print(f"optimized_sqiswap_sub fit_1q=True: cold {out['fit_cold_s']:.2f}s warm {out['fit_warm_s']:.2f}s "
              f"({len(c.ops)} ops out)")

    t0 = time.perf_counter()
    _, host_m = pass_manager_basic(qc, duration_1q=0.25, batched=False, device=device)
    out["basic_host_s"] = time.perf_counter() - t0
    print(f"pass_manager_basic host loop: {out['basic_host_s']:.2f}s (duration {host_m['duration']:.2f})")
    (_, dev_m), out["basic_batched_cold_s"], out["basic_batched_warm_s"] = cold_warm(
        lambda: pass_manager_basic(qc, duration_1q=0.25, batched=True, device=device), device)
    print(f"pass_manager_basic batched: cold {out['basic_batched_cold_s']:.2f}s warm {out['basic_batched_warm_s']:.2f}s "
          f"(duration {dev_m['duration']:.2f})")
    assert dev_m["duration"] == host_m["duration"], (dev_m, host_m)
    out["duration"] = dev_m["duration"]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qubits", type=int, default=64)
    ap.add_argument("--fit", action="store_true", help="also time optimized_sqiswap_sub(fit_1q=True)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    card_name = card(device)
    print(f"device: {card_name}")
    out = timing(a.qubits, a.fit, device)
    write_json("qft64_pass_timing.json", {"card": card_name, **out})
    return out


if __name__ == "__main__":
    main()
