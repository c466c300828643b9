"""Polytope data model (JAX coverage/polytope.py:214-220, 446-450).

Only the two dataclasses are ported, with the JAX package's field names, so
the cached coverage pickles load into them (``convert.coverage_from_jax_pickle``).
A polytope in the reduced monodromy space (a1, a2, a3) is a union of convex
subpolytopes; each row ``[d, c1, c2, c3]`` means ``d + c . a >= 0``
(inequalities) or ``= 0`` (equalities), with exact ``Fraction`` entries.
The exact-rational engine that builds such sets is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import List, Tuple

Row = Tuple[Fraction, ...]


@dataclass
class ConvexPolytope:
    """d + A.x >= 0 inequality rows, d + A.x = 0 equality rows."""

    inequalities: List[Row] = field(default_factory=list)
    equalities: List[Row] = field(default_factory=list)
    name: str = ""


@dataclass
class Polytope:
    """Union of convex subpolytopes (the PU(4) center-shift structure)."""

    convex_subpolytopes: List[ConvexPolytope] = field(default_factory=list)
