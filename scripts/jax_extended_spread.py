"""The JAX package's extended-coverage rows at three seeds, on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_extended_spread.py iSwap sqiSwap CNOT B

For each named gate, ``explore.smush_volume.extend_coverage(name, seed=s,
save=False)`` at s = 7 (the default, which wrote
slam_decomposition_tpu/data/extended_results.json), 8 and 9, and per row
the spread (max - min) of the extended volume over the three seeds: the
limit chip_smoke.py holds the PyTorch port's volumes to where it is wider
than 0.02 (``EXT_VOL_SPREAD``). With ``save=False`` nothing is written; the
bare coverage sets are read from the package's cache. About a minute per
gate and seed on one CPU core.
"""

import json
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

from slam_decomposition_tpu.explore.smush_volume import extend_coverage  # noqa: E402

SEEDS = (7, 8, 9)


def main(names) -> int:
    out = {}
    for name in names:
        rows = {}
        for seed in SEEDS:
            t0 = time.time()
            res = extend_coverage(name, seed=seed, save=False)
            print(f"{name} seed {seed}: {res} ({time.time() - t0:.1f} s)", flush=True)
            for k, row in res.items():
                rows.setdefault(k, []).append(row[1])
        out[name] = {k: {"ext_vol": v, "spread": max(v) - min(v)} for k, v in rows.items()}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["iSwap", "sqiSwap", "CNOT", "B"]))
