"""Readings of the judged numbers on the card, from which their limits are
set: the program on many seeds and its f32 control (`control.overrides`:
the main flow's f32 certification, the ks flow's f32 reference) on a few,
at the cell's own size, all in one process.

    python3 benchmark/tests/readings.py --workload <cell> --seconds <s> \
        --check-per-batch <n> --seeds <s1 ...> --control-seeds <c1 ...>

Each run is `harness.run` with a short window; ``--check-per-batch`` makes
it judge as many answers as a full run does. Prints one JSON line a run
and, last, the largest reading of each number over the program's seeds and
the smallest over the control's.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402
from benchmark.tests import control  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--check-per-batch", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traffic", type=json.loads, default={}, help="traffic parameters to override (JSON)")
    args = ap.parse_args()
    readings = {"program": {}, "control": {}}
    cell = harness.resolve_cell(harness.load_spec(), args.workload)
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            over = {**args.traffic, "check_per_batch": args.check_per_batch}
            if side == "control":
                over.update(control.overrides(cell["traffic"]["flow"], cell["config"]))
            t0 = time.perf_counter()
            r = harness.run(args.workload, seed, args.seconds, False, args.device, overrides=over,
                            log=lambda *a, **k: None)
            line = {"side": side, "seed": seed, "correct": r["correct"], "attempted": r["attempted"],
                    "failed": r["failed"], "seconds": time.perf_counter() - t0,
                    "checks": {k: v["value"] for k, v in r["checks"].items()}}
            print(json.dumps(line), flush=True)
            for k, v in line["checks"].items():
                readings[side].setdefault(k, []).append(v)
    summary = {"program_max": {k: max(v) for k, v in readings["program"].items()},
               "control_min": {k: min(v) for k, v in readings["control"].items()}}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
