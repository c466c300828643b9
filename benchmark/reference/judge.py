"""The judge of the main flow's answers, u3 chains: the judge of a traffic
mix that names none.

It takes a sample of the window's answers, drawn from the seed: for each
sampled target the target itself (made by the benchmark's traffic, not by
the program) and what the program returned for it: its depth from the
coverage layer (`ks`), the depth it was solved at, its parameters at that
depth and its certified square cost. The reference works out each target's
depth (from the configuration's cached coverage set) and the square cost
of the returned parameters itself, and gives four numbers, each with its
limit:

- `ks_mismatch`: sampled targets whose depth differs from the reference's
  (limit 0: an exact comparison);
- `unanswered`: sampled targets with no finite certificate, or with
  parameters that do not fit the depth they were solved at, or a depth
  outside [max(ks, first depth), last depth] (limit 0);
- `worst_certified_cost`: the largest reference cost of a target that the
  program counted as certified (limit: the configuration's threshold);
- `cert_gap`: the largest |certificate - reference cost| / max(reference
  cost, threshold) over the answered targets (limit: `CERT_GAP_LIMIT`, set
  from readings of the program and of its f32 control; `PERF.md`).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import chain
from benchmark.reference.coverage import config_coverage

# between the program's largest reading over a dozen seeds and more and the
# smallest reading of its f32 certification path (PERF.md, section 2)
CERT_GAP_LIMIT = 1e-6


def judge(config: dict, targets: np.ndarray, answers: dict) -> dict:
    """{name: {"value", "limit"}} of the four numbers above. ``targets``
    (m, 4, 4); ``answers``: "ks" (m,), "depth" (m,), "cost" (m,) and "x", a
    list of m parameter vectors."""
    thresh = float(config["threshold"])
    k_min, k_max = config["depths"]
    T = np.asarray(targets, dtype=np.complex128)
    ks, depth, cost = (np.asarray(answers[key]) for key in ("ks", "depth", "cost"))
    ref_ks = config_coverage(config).depth(T)
    G = chain.gate(config["basis"])

    ref_cost = np.full(len(T), np.nan)
    answered = np.isfinite(cost) & (depth >= np.maximum(ref_ks, k_min)) & (depth <= k_max)
    answered &= np.array([np.shape(x) == (6 * (d + 1),) for x, d in zip(answers["x"], depth)], dtype=bool)
    for d in np.unique(depth[answered]):
        idx = np.where(answered & (depth == d))[0]
        X = np.stack([np.asarray(answers["x"][i], dtype=np.float64) for i in idx])
        ref_cost[idx] = chain.square_cost(X, T[idx], G)
    answered &= np.isfinite(ref_cost)

    certified = answered & (cost <= thresh)
    gap = np.abs(cost - ref_cost) / np.maximum(ref_cost, thresh)
    return {
        "ks_mismatch": {"value": int((ks != ref_ks).sum()), "limit": 0},
        "unanswered": {"value": int((~answered).sum()), "limit": 0},
        "worst_certified_cost": {"value": float(ref_cost[certified].max()) if certified.any() else 0.0,
                                 "limit": thresh},
        "cert_gap": {"value": float(gap[answered].max()) if answered.any() else float("inf"),
                     "limit": CERT_GAP_LIMIT},
    }
