"""Symbolic domain for abstract interpretation of BlockSpec index maps.

The kernels' index maps are tiny affine functions of the grid
coordinates — sums of ``var``, ``var // c``, ``c * var`` and integer
constants (see `kernels/attention.py`'s ``hh // rep`` GQA sharing).
Calling such a lambda with :class:`Ix` values instead of ints yields a
closed-form :class:`Ix` whose range, variable support, and coverage
over a block axis are decidable exactly:

* **range** — min/max over the grid box (each term is monotone in its
  own variable, so the box extremes are per-term extremes).
* **coverage** — whether the expression provably takes *every* value in
  ``[0, nb)`` as the grid is swept.  Proven for the unit cases the
  kernels actually use: a bare variable, ``var // c`` over a contiguous
  grid axis (floor of a contiguous range is contiguous), and the
  mixed-radix sum ``i * radix + j`` (decode's fused ``b*kvh`` axis).
* **support** — which grid axes the expression depends on; a grid axis
  absent from every output-dim expression is a *revisit* axis (the
  write-race check's raw material).

Maps that are not affine in the grid (the paged kernels' scalar-table
gathers) raise :class:`NonAffine` when evaluated; contracts must
declare those operands ``data_dependent`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


class NonAffine(Exception):
    """An index map stepped outside the affine fragment."""


@dataclasses.dataclass(frozen=True)
class Term:
    """``coeff * (var // div)`` with ``var`` ranging over ``[0, size)``."""

    var: str
    size: int
    div: int
    coeff: int

    def range(self) -> Tuple[int, int]:
        hi = self.coeff * ((self.size - 1) // self.div)
        return (min(0, hi), max(0, hi))


class Ix:
    """An affine-with-floordiv index expression over grid variables."""

    __slots__ = ("terms", "const")

    def __init__(self, terms: Tuple[Term, ...] = (), const: int = 0):
        # canonical: merged by (var, div), zero coeffs dropped, sorted
        merged: Dict[Tuple[str, int], Term] = {}
        for t in terms:
            key = (t.var, t.div)
            if key in merged:
                prev = merged[key]
                merged[key] = Term(t.var, t.size, t.div, prev.coeff + t.coeff)
            else:
                merged[key] = t
        self.terms = tuple(sorted(
            (t for t in merged.values() if t.coeff != 0),
            key=lambda t: (t.var, t.div)))
        self.const = const

    # -- constructors ------------------------------------------------------
    @staticmethod
    def var(name: str, size: int) -> "Ix":
        if size < 1:
            raise ValueError(f"grid axis {name!r} has size {size}")
        return Ix((Term(name, size, 1, 1),), 0)

    @staticmethod
    def lift(v) -> "Ix":
        if isinstance(v, Ix):
            return v
        if isinstance(v, (int,)) and not isinstance(v, bool):
            return Ix((), v)
        raise NonAffine(f"cannot lift {type(v).__name__} into the affine "
                        f"domain (data-dependent index map?)")

    # -- arithmetic (the fragment the kernels' index maps use) -------------
    def __add__(self, other) -> "Ix":
        o = Ix.lift(other)
        return Ix(self.terms + o.terms, self.const + o.const)

    __radd__ = __add__

    def __sub__(self, other) -> "Ix":
        return self + (Ix.lift(other) * -1)

    def __rsub__(self, other) -> "Ix":
        return Ix.lift(other) + (self * -1)

    def __mul__(self, other) -> "Ix":
        if isinstance(other, Ix):
            if not other.terms:
                other = other.const
            elif not self.terms:
                return other * self.const
            else:
                raise NonAffine("product of two grid variables is not affine")
        if not isinstance(other, int) or isinstance(other, bool):
            raise NonAffine(f"multiply by {type(other).__name__}")
        return Ix(tuple(Term(t.var, t.size, t.div, t.coeff * other)
                        for t in self.terms), self.const * other)

    __rmul__ = __mul__

    def __floordiv__(self, d) -> "Ix":
        if isinstance(d, Ix):
            if d.terms:
                raise NonAffine("division by a grid variable")
            d = d.const
        if not isinstance(d, int) or d <= 0:
            raise NonAffine(f"floordiv by {d!r}")
        if d == 1:
            return self
        if not self.terms:
            return Ix((), self.const // d)
        # only a bare unit variable divides exactly: floor(v/d)
        if (len(self.terms) == 1 and self.const == 0
                and self.terms[0].div == 1 and self.terms[0].coeff == 1):
            t = self.terms[0]
            return Ix((Term(t.var, t.size, d, 1),), 0)
        raise NonAffine("floordiv of a compound affine expression")

    def __neg__(self) -> "Ix":
        return self * -1

    def __mod__(self, other):
        raise NonAffine("mod is outside the affine fragment")

    def __eq__(self, other) -> bool:
        o = Ix.lift(other) if isinstance(other, (Ix, int)) else None
        return (o is not None and self.terms == o.terms
                and self.const == o.const)

    def __hash__(self):
        return hash((self.terms, self.const))

    def __repr__(self):
        parts = [f"{t.coeff}*({t.var}//{t.div})" if t.div > 1
                 else f"{t.coeff}*{t.var}" for t in self.terms]
        parts.append(str(self.const))
        return " + ".join(parts)

    # -- analysis ----------------------------------------------------------
    @property
    def support(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(t.var for t in self.terms))

    def range(self) -> Tuple[int, int]:
        lo = self.const + sum(t.range()[0] for t in self.terms)
        hi = self.const + sum(t.range()[1] for t in self.terms)
        return lo, hi

    def covers(self, nb: int) -> bool:
        """Provably takes every value in ``[0, nb)`` over the grid box."""
        if not self.terms:
            return self.const == 0 and nb == 1
        if self.const != 0:
            return False
        if len(self.terms) == 1:
            t = self.terms[0]
            # floor(v/d) over contiguous v in [0, size) hits every integer
            # in [0, (size-1)//d] (monotone, step <= 1).
            return t.coeff == 1 and (t.size - 1) // t.div == nb - 1
        # mixed radix: coeff_k == product of later ranges, all unit divs,
        # e.g. i*gn + j over (gm, gn) covering gm*gn blocks.
        ts = sorted(self.terms, key=lambda t: -abs(t.coeff))
        if any(t.div != 1 for t in ts):
            return False
        radix = 1
        for t in reversed(ts):
            if t.coeff != radix:
                return False
            radix *= t.size
        return radix == nb

    def injective_in(self, axes: Tuple[str, ...]) -> bool:
        """True if distinct values of the listed axes provably give
        distinct expression values (used to prove disjoint writes along
        one operand dim).  Conservative: unit-div, mixed-radix only."""
        ts = [t for t in self.terms if t.var in axes]
        if len(ts) != len(set(t.var for t in ts)):
            return False
        if any(t.div != 1 for t in ts):
            return False
        ts = sorted(ts, key=lambda t: -abs(t.coeff))
        bound = 0
        for t in reversed(ts):
            if abs(t.coeff) <= bound:
                return False
            bound = abs(t.coeff) * (t.size - 1) + bound
        return True


def grid_vars(grid: Tuple[Tuple[str, int], ...]) -> Tuple[Ix, ...]:
    return tuple(Ix.var(name, size) for name, size in grid)


def eval_index_map(index_map, grid: Tuple[Tuple[str, int], ...]
                   ) -> Tuple[Ix, ...]:
    """Run an index-map lambda on symbolic grid coordinates.

    Raises :class:`NonAffine` if the map leaves the affine fragment
    (e.g. reads a prefetched scalar ref).
    """
    try:
        out = index_map(*grid_vars(grid))
    except NonAffine:
        raise
    except Exception as e:
        # e.g. a Python-level table lookup or scalar-ref read applied to a
        # symbolic coordinate: outside the fragment, not a checker crash.
        raise NonAffine(f"index map escaped the affine domain: {e!r}")
    if not isinstance(out, tuple):
        out = (out,)
    return tuple(Ix.lift(v) for v in out)
