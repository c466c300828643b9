"""The benchmark of slam_decomposition_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernel library, the coverage set, the target pool, a warm-up),
then whole batches back to back for ``--seconds``, then the judgement of a
sample of the window's answers against the plain reference. The last line of
standard output is one JSON object (`correct`, `attempted`, `failed`,
`metrics`, `device`, with ``--trace 1`` `breakdown`, and last `checks`: each
number compared beside its limit, which standard error also ends with).
Exits non-zero without a result where no CUDA device (or fewer than the cell
asks for) is present, and where JAX or the JAX package has been loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.resolve_cell(harness.load_spec(), args.workload)["cell"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA device(s), torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                         log=print)
    found = harness.forbidden_modules()
    if found:
        print(f"no result: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
