"""The judge of the `ks` flow's answers: a depth per target, with no
parameters and no certificate.

It takes a sample of the window's answers, drawn from the seed: each
sampled target (made by the benchmark's traffic, not by the program) and
the depth the program assigned it (`ks`). The reference works out each
target's depth from the configuration's cached coverage set itself, and
gives two numbers, each with its limit:

- `ks_mismatch`: sampled targets whose depth differs from the reference's
  (limit 0: an exact comparison);
- `unanswered`: sampled targets with no depth, or a depth outside
  [0, the set's last layer] (limit 0).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.coverage import config_coverage

BLOCK = 1 << 16  # targets the reference takes at once (bounds its temporaries)


def depths(coverage, targets: np.ndarray) -> np.ndarray:
    """The reference's depth of each target, in blocks, in the targets' precision."""
    return np.concatenate([coverage.depth(targets[s : s + BLOCK]) for s in range(0, len(targets), BLOCK)])


def judge(config: dict, targets: np.ndarray, answers: dict) -> dict:
    """{name: {"value", "limit"}} of the two numbers above. ``targets``
    (m, 4, 4); ``answers``: "ks" (m,)."""
    coverage = config_coverage(config)
    ref = depths(coverage, np.asarray(targets, dtype=np.complex128))
    ks = np.asarray(answers["ks"])
    answered = (ks >= 0) & (ks <= max(coverage.depths))
    return {
        "ks_mismatch": {"value": int((ks != ref).sum()), "limit": 0},
        "unanswered": {"value": int((~answered).sum()), "limit": 0},
    }
