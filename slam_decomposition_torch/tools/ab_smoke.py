"""chip_smoke.py from several source trees, in turns, on one CUDA card.

    python -m slam_decomposition_torch.tools.ab_smoke [--out OUT] DIR [DIR ...]

Runs ``python3 chip_smoke.py`` from each DIR in the order given, then in
the reverse order (for a parent and a change: parent, change, change,
parent), one process at a time; each tree builds its own kernels under its
build/. A tree is an unpacked commit, for example

    mkdir -p build/ab/parent && git archive HEAD~1 | tar -x -C build/ab/parent

(build/ is in .gitignore). Each run's whole output goes to
OUT/ab_<run>_<tree>.txt (default build/ab_smoke/ at the root of this
checkout; a relative OUT is taken from there). Printed per
run: its exit code, the card, the ptxas and occupancy lines, each kernel's
time beside its plain version's (phase 3), the bound and with_cost lines
where the tree prints them, the main path's and the transpile path's
timing lines, and the API, depth and general-solver phases' lines.
Exits 1 if any run failed.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
KEEP = re.compile(r"^(NVIDIA |\[build\] (ptxas|occupancy)|\[bound\] |\[main\] |\[api\] |\[frac\] |\[depth\] |\[general\] |"
                  r"\[parity\] adam_chain with_cost |\[transpile\] NVIDIA )")
PARITY = re.compile(r"^\[parity\] (\S+) (.*?) L=(\d+):.*kernel ([\d.]+) ms, plain ([\d.]+) ms")


def summary(text: str) -> list:
    """The lines of one chip_smoke.py output worth comparing across runs."""
    out = []
    for line in text.splitlines():
        m = PARITY.match(line)
        if m:
            out.append(f"[parity] {m.group(1)} {m.group(2)} L={m.group(3)}: kernel {m.group(4)} ms, "
                       f"plain {m.group(5)} ms")
        elif KEEP.match(line):
            out.append(line)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description="chip_smoke.py from several source trees, in turns")
    ap.add_argument("--out", default="build/ab_smoke", help="directory for each run's whole output")
    ap.add_argument("dirs", nargs="*", help="unpacked trees, each holding chip_smoke.py")
    args = ap.parse_args(argv)
    if not args.dirs:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [pathlib.Path(d).resolve() for d in args.dirs]
    for t in trees:
        if not (t / "chip_smoke.py").exists():
            print(f"ab_smoke: {t} holds no chip_smoke.py", file=sys.stderr)
            return 2
    logs = ROOT / args.out
    logs.mkdir(parents=True, exist_ok=True)
    failed = 0
    for run, tree in enumerate(trees + trees[::-1], 1):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, capture_output=True, text=True,
                              check=False)
        log = logs / f"ab_{run}_{tree.name}.txt"
        log.write_text(proc.stdout + proc.stderr)
        print(f"run {run} {tree.name} rc={proc.returncode} (output in {log})")
        for line in summary(proc.stdout):
            print(f"  {line}")
        if proc.returncode != 0:
            failed += 1
            print("  " + "\n  ".join(proc.stderr.strip().splitlines()[-5:]))
        sys.stdout.flush()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
