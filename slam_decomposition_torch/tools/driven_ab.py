"""Device against host for the driven (Trotter) Adam paths (JAX
scripts/driven_ab.py). The JAX package's A/B was its segmented device mode
against its host pin (``SLAM_DRIVEN_MODE``), which the port does not have:
it solves on the device it is given. The port's counterpart runs the same
three surfaces on the card and on the CPU, with the same seeds:

  1. GRAPE (``explore.oct.optimize_pulses``) on CNOT, the hs functional, 8
     slices, 8 restarts x 300 iterations;
  2. ``models.trajectory.drive_pulse_for_target`` of CX, 32 restarts;
  3. ``explore.smush_volume.targeted_smush_coords`` of iSwap at k = 1 (5
     vertices x 6 restarts x 250 iterations).

    python3 -m slam_decomposition_torch.tools.driven_ab [quick] [--device cuda|cpu]

Prints each surface's seconds, then the script's table and its agreement
line; ``quick`` (or ``--device cpu``) runs ``--device`` alone. The rows also go to
``config.studies_dir()/driven_ab.json``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.tools import card, synchronize, write_json

SIZES = dict(grape_restarts=8, grape_iters=300, drive_restarts=32, targeted_restarts=6, targeted_iters=250)


def timed(label, fn, device):
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    dt = time.perf_counter() - t0
    print(f"{label}: {dt:.1f}s", flush=True)
    return out, dt


def run_mode(device, grape_restarts=8, grape_iters=300, drive_restarts=32, targeted_restarts=6,
             targeted_iters=250) -> dict:
    from slam_decomposition_torch.explore import oct
    from slam_decomposition_torch.explore.smush_volume import targeted_smush_coords
    from slam_decomposition_torch.models import gates as G
    from slam_decomposition_torch.models import trajectory as traj

    device = resolve_device(device)
    mode = device.type
    rows = {}
    ev = oct.make_smush_eval(np.pi / 2, 0.0, n_slices=8, t=1.0, device=device)
    res, rows["grape_cnot_hs"] = timed(
        f"[{mode}] GRAPE hs CNOT ({grape_restarts} restarts x {grape_iters} iters)",
        lambda: oct.optimize_pulses(ev, 8, functional="hs", target=G.CNOT.to_numpy(), restarts=grape_restarts,
                                    iters=grape_iters, seed=3),
        device,
    )
    rows["grape_value"] = float(res.value)
    out, rows["drive_pulse_cx"] = timed(
        f"[{mode}] drive_pulse_for_target CX ({drive_restarts} restarts)",
        lambda: traj.drive_pulse_for_target(G.CNOT.to_numpy(), np.pi / 2, 0.0, restarts=drive_restarts, seed=1,
                                            device=device),
        device,
    )
    rows["drive_pulse_loss"] = float(out[1])
    cs, rows["targeted_iswap_k1"] = timed(
        f"[{mode}] targeted_smush_coords iSwap k=1 (5 vx x {targeted_restarts} R x {targeted_iters} it)",
        lambda: targeted_smush_coords(np.pi / 2, 0.0, 1.0, 1, restarts=targeted_restarts, iters=targeted_iters,
                                      seed=0, device=device),
        device,
    )
    rows["targeted_n_coords"] = int(len(cs))
    rows["targeted_mean"] = [round(float(x), 6) for x in cs.mean(0)]
    return rows


def report(dev: dict, host: dict) -> list:
    """The script's table, the card against the CPU, and its agreement line."""
    lines = ["| surface | device | host (CPU) | speedup |", "|---|---|---|---|"]
    for key, label in (("grape_cnot_hs", "GRAPE hs CNOT"), ("drive_pulse_cx", "drive_pulse CX"),
                       ("targeted_iswap_k1", "targeted descent iSwap k1")):
        lines.append(f"| {label} | {dev[key]:.1f} s | {host[key]:.1f} s | {host[key] / max(dev[key], 1e-9):.1f}x |")
    lines.append(f"values: grape {dev['grape_value']:.3e} vs {host['grape_value']:.3e}; drive_pulse loss "
                 f"{dev['drive_pulse_loss']:.3e} vs {host['drive_pulse_loss']:.3e}; targeted mean "
                 f"{dev['targeted_mean']} vs {host['targeted_mean']}")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("quick", nargs="?", choices=["quick"], help="run --device alone")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    for name, v in SIZES.items():
        ap.add_argument(f"--{name.replace('_', '-')}", type=int, default=v)
    a = ap.parse_args(argv)
    sizes = {name: getattr(a, name) for name in SIZES}
    device = resolve_device(a.device)
    card_name = card(device)
    print(f"device: {card_name}")
    rows = {device.type: run_mode(device, **sizes)}
    if not a.quick and device.type != "cpu":
        rows["cpu"] = run_mode("cpu", **sizes)
        print("\n" + "\n".join(report(rows[device.type], rows["cpu"])))
    write_json("driven_ab.json", {"card": card_name, "sizes": sizes, "rows": rows})
    return rows


if __name__ == "__main__":
    main()
