"""Contract checks for the H100 kernels: coverage, write races, split
reductions, shared memory and occupancy, precision, the kernels' limits.

Each check takes an instantiated
:class:`~repro_torch.kernels.contracts.LaunchContract` (one problem x one
schedule) and yields :class:`Finding`s. The codes keep the JAX package's
numbers where the meaning carries over (``repro.analysis.lint.checks``):

===== ====================================================================
GL101 a tile index map reaches outside the operand (below 0, or past its
      last tile on a dim whose edge the contract does not declare
      predicated), or a ragged dim is not declared predicated
GL102 an output element is written by no (block, split group)
GL103 an index map is not affine in the block coordinates and the operand
      declares neither a data-dependent gather (the paged loaders'
      block-table reads, ``csrc/attention.cu`` ``PagedKV`` /
      ``PagedDecodeKV``) nor a ranged read
GL104 the contract's block regions do not add up to the blocks the launch
      makes (new)
GL105 the plan is outside a limit of the kernel's own (its C plan function
      refuses it: more splits than k steps or than the kernel merges, a
      tile outside the kernel's regime, a cluster past its size) (new)
GL201 two blocks write one output element and no reduction is declared
GL202 a split axis of more than one group whose reduction is ``none``
GL203 an order-dependent float reduction (``atomicAdd`` partials into the
      output): its sums change from launch to launch
GL204 a ``ticket`` reduction whose workspace words are fewer than the
      tickets plus the partials, or with more tiles than ``MAX_TICKETS``
      (``hgemm.cuh``); a ``cluster`` reduction whose split is not the
      cluster
GL301 dynamic shared memory over 232,448 bytes a block
GL302 shared memory, threads, or the ``__launch_bounds__`` promise
      (registers x threads x blocks within 65,536 an SM) that leaves no
      block, or fewer blocks than promised, resident on an SM
GL303 the plan's admission or its split count depends on cluster
      co-residency (``cudaOccupancyMaxActiveClusters``), known only on the
      card (info: "needs the card") (new)
GL401 a narrow MMA (8- or 16-bit operands) without a 32-bit accumulator of
      the matching kind (bf16/fp16 -> fp32, int8 -> int32)
GL402 no counterpart: the JAX rule (a scalar block outside SMEM) names a
      TPU memory space the card does not have
===== ====================================================================
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

from repro_torch.analysis.lint.affine import Ix, NonAffine, eval_index_map
from repro_torch.analysis.lint.findings import Finding, finding
from repro_torch.kernels import contracts as kc
from repro_torch.kernels.contracts import LaunchContract, OperandSpec

def _site(c: LaunchContract) -> str:
    # the instantiation stays out of the site (check_contract records it in
    # the data): one defect at every schedule fingerprints once
    return f"contract:{c.name}"


def _nb(op: OperandSpec) -> Tuple[int, ...]:
    return tuple(-(-s // t) for s, t in zip(op.shape, op.tile))


def image(e: Ix) -> Optional[Tuple[int, int]]:
    """The range ``e`` provably covers without a gap over its box, or None:
    a constant; one term of coefficient +-1 (a floor of a contiguous
    range is contiguous); or a mixed radix whose coefficients, by size,
    are +-1, then each the product of the sizes before it."""
    lo, hi = e.range()
    if not e.terms:
        return lo, hi
    if len(e.terms) == 1:
        return (lo, hi) if abs(e.terms[0].coeff) == 1 else None
    ts = sorted(e.terms, key=lambda t: abs(t.coeff))
    if any(t.div != 1 for t in ts):
        return None
    radix = 1
    for t in ts:
        if abs(t.coeff) != radix:
            return None
        radix *= t.size
    return lo, hi


def _eval(region, fn):
    return eval_index_map(fn, region.grid)


def _boxes_overlap(a, b) -> bool:
    return all(x0 <= y1 and y0 <= x1 for (x0, x1), (y0, y1) in zip(a, b))


# -- coverage and bounds ----------------------------------------------------
def check_coverage(c: LaunchContract) -> List[Finding]:
    out: List[Finding] = []
    site = _site(c)
    declared = sum(r.blocks for r in c.regions)
    if declared != c.blocks:
        out.append(finding(
            "GL104", "error", site,
            f"block regions hold {declared} blocks, the launch makes "
            f"{c.blocks}", key="blocks"))
    for op in c.operands:
        maps = [(r, fn) for r in c.regions for nm, fn in r.maps
                if nm == op.name]
        if op.data_dependent is not None or op.ranged is not None:
            continue
        if len(op.shape) != len(op.tile):
            out.append(finding("GL101", "error", site,
                               f"operand {op.name!r}: tile rank "
                               f"{len(op.tile)} != rank {len(op.shape)}",
                               key=f"{op.name}:rank"))
            continue
        if not maps:
            out.append(finding(
                "GL103", "warning", site,
                f"operand {op.name!r} has no index map and declares no "
                f"data-dependent or ranged read", key=op.name))
            continue
        nbs = _nb(op)
        for d, (s, t) in enumerate(zip(op.shape, op.tile)):
            if s % t and d not in op.predicated:
                out.append(finding(
                    "GL101", "error", site,
                    f"operand {op.name!r} dim {d}: {s} is ragged in tiles of "
                    f"{t} and the edge is not declared predicated",
                    key=f"{op.name}:{d}:ragged"))
        boxes = []
        for r, fn in maps:
            try:
                idx = _eval(r, fn)
            except NonAffine as e:
                out.append(finding(
                    "GL103", "warning", site,
                    f"operand {op.name!r}: index map is not affine in the "
                    f"block coordinates ({e})", key=op.name))
                boxes = None
                break
            if len(idx) != len(op.shape):
                out.append(finding(
                    "GL101", "error", site,
                    f"operand {op.name!r}: map gives {len(idx)} dims for "
                    f"rank {len(op.shape)}", key=f"{op.name}:rank"))
                boxes = None
                break
            box = []
            for d, (e, nb) in enumerate(zip(idx, nbs)):
                lo, hi = e.range()
                if lo < 0 or (hi > nb - 1 and d not in op.predicated):
                    out.append(finding(
                        "GL101", "error", site,
                        f"operand {op.name!r} dim {d}: tile index range "
                        f"[{lo}, {hi}] outside [0, {nb - 1}] ({nb} tiles "
                        f"of {op.tile[d]} over {op.shape[d]})",
                        key=f"{op.name}:{d}"))
                box.append(image(e))
            if op.output:
                boxes.append((r, idx, box))
        if op.output and boxes is not None:
            out += _check_output(c, site, op, nbs, boxes)
    return out


def _check_output(c, site, op, nbs, boxes) -> List[Finding]:
    """Coverage (GL102) and races between blocks (GL201) of one output:
    each region's image must be a box, the boxes disjoint, their volume
    clipped to the operand the whole tile count; within a region the map
    must be injective over the axes that are not reduced."""
    out: List[Finding] = []
    reduced = {r.axis for r in c.reductions if r.out == op.name}
    clipped = []
    for r, idx, box in boxes:
        if any(b is None for b in box):
            out.append(finding(
                "GL102", "error", site,
                f"output {op.name!r}: the image of {r.grid} is not provably "
                f"a box ({idx})", key=f"{op.name}:box"))
            return out
        used = [a for e in idx for a in e.support]
        if len(used) != len(set(used)):
            out.append(finding(
                "GL201", "error", site,
                f"output {op.name!r}: block axes "
                f"{sorted({a for a in used if used.count(a) > 1})} index "
                f"more than one dim; two blocks may write one tile",
                key=f"{op.name}:joint"))
        for name, size in r.grid:
            if size <= 1 or name in used or name in r.loops or \
                    name in reduced:
                continue
            out.append(finding(
                "GL201", "error", site,
                f"output {op.name!r} is written by every block along "
                f"{name!r} (size {size}) and no reduction is declared",
                key=f"{op.name}:{name}"))
        clipped.append(tuple((max(lo, 0), min(hi, nb - 1))
                             for (lo, hi), nb in zip(box, nbs)))
    for i in range(len(clipped)):
        for j in range(i + 1, len(clipped)):
            if _boxes_overlap(clipped[i], clipped[j]):
                out.append(finding(
                    "GL201", "error", site,
                    f"output {op.name!r}: two block regions write the same "
                    f"tiles {clipped[i]} / {clipped[j]}",
                    key=f"{op.name}:overlap"))
    total = 1
    for nb in nbs:
        total *= nb
    vol = 0
    for b in clipped:
        v = 1
        for lo, hi in b:
            v *= max(0, hi - lo + 1)
        vol += v
    if vol < total:
        out.append(finding(
            "GL102", "error", site,
            f"output {op.name!r}: blocks write {vol} of its {total} tiles "
            f"({nbs} tiles of {op.tile})", key=f"{op.name}:gap"))
    return out


# -- split reductions ---------------------------------------------------------
def check_reductions(c: LaunchContract) -> List[Finding]:
    out: List[Finding] = []
    site = _site(c)
    outputs = {o.name: o for o in c.operands if o.output}
    sizes = {}
    for r in c.regions:
        for name, size in r.grid:
            sizes[name] = max(size, sizes.get(name, 0))
    for red in c.reductions:
        parts = sizes.get(red.axis, 1)
        op = outputs.get(red.out)
        if red.order == "atomic" and op is not None and op.dtype[0] == "float":
            out.append(finding(
                "GL203", "error", site,
                f"output {red.out!r}: partials over {red.axis!r} added by "
                f"atomics into a float output: the sum's order, and its "
                f"bits, change from launch to launch", key=red.out))
        if red.via == "none":
            if parts > 1:
                out.append(finding(
                    "GL202", "error", site,
                    f"output {red.out!r}: {parts} split groups along "
                    f"{red.axis!r} and no reduction", key=red.out))
        elif red.via == "ticket":
            if red.tickets > red.ticket_words:
                out.append(finding(
                    "GL204", "error", site,
                    f"output {red.out!r}: {red.tickets} tiles take a ticket "
                    f"each, the workspace sets aside {red.ticket_words}",
                    key=f"{red.out}:tickets"))
            if c.workspace_words < red.ticket_words + red.partial_words:
                out.append(finding(
                    "GL204", "error", site,
                    f"output {red.out!r}: workspace of {c.workspace_words} "
                    f"words, tickets ({red.ticket_words}) and partials "
                    f"({red.partial_words}) need "
                    f"{red.ticket_words + red.partial_words}",
                    key=f"{red.out}:words"))
        elif red.via == "cluster":
            if parts != c.cluster:
                out.append(finding(
                    "GL204", "error", site,
                    f"output {red.out!r}: {parts} splits merged over a "
                    f"cluster of {c.cluster}", key=f"{red.out}:cluster"))
        else:
            out.append(finding("GL204", "error", site,
                               f"reduction on {red.out!r}: unknown "
                               f"mechanism {red.via!r}", key=red.out))
    return out


# -- shared memory and occupancy ------------------------------------------------
def check_budgets(c: LaunchContract) -> List[Finding]:
    out: List[Finding] = []
    site = _site(c)
    if c.smem > kc.SMEM_PER_BLOCK:
        out.append(finding(
            "GL301", "error", site,
            f"{c.smem} bytes of dynamic shared memory, a block may have "
            f"{kc.SMEM_PER_BLOCK}", key="smem"))
    resident = c.min_blocks * (c.smem + kc.SMEM_RESERVED)
    if c.threads > kc.MAX_THREADS or \
            c.threads * c.min_blocks > kc.THREADS_PER_SM or \
            resident > kc.SMEM_PER_SM or c.max_regs < 16:
        out.append(finding(
            "GL302", "error", site,
            f"{c.min_blocks} block(s) of {c.threads} threads and {c.smem} "
            f"bytes promised an SM ({resident} of {kc.SMEM_PER_SM} bytes, "
            f"{c.max_regs} registers a thread)", key="occupancy"))
    if c.cluster > kc.PORTABLE_CLUSTER:
        out.append(finding(
            "GL302", "error", site,
            f"clusters of {c.cluster} blocks, past the portable "
            f"{kc.PORTABLE_CLUSTER}", key="cluster"))
    if c.needs_card:
        out.append(finding("GL303", "info", site,
                           f"needs the card: {c.needs_card}", key="card"))
    return out


def fits_budgets(c: LaunchContract) -> bool:
    """True where the launch fits the SM (the tuner's budget predicate)."""
    return not [f for f in check_budgets(c) if f.severity == "error"]


# -- precision and limits ---------------------------------------------------------
def check_precision(c: LaunchContract) -> List[Finding]:
    out: List[Finding] = []
    for i, d in enumerate(c.mma):
        narrow = d.lhs[1] < 4 or d.rhs[1] < 4
        kinds = {d.lhs[0], d.rhs[0]}
        kind_ok = (d.acc[0] == "int") == (kinds == {"int"})
        if narrow and not (d.acc[1] >= 4 and kind_ok):
            out.append(finding(
                "GL401", "error", _site(c),
                f"MMA {i}: {d.lhs} x {d.rhs} into {d.acc}: narrow operands "
                f"need a 32-bit accumulator of the matching kind",
                key=f"mma{i}"))
    return out


def check_limits(c: LaunchContract) -> List[Finding]:
    return [finding("GL105", "error", _site(c),
                    f"{lim.name} = {lim.value} outside [{lim.lo}, "
                    f"{lim.hi}]: the kernel's plan refuses it", key=lim.name)
            for lim in c.limits if not lim.ok]


# -- all of the above -------------------------------------------------------
def check_contract(c: LaunchContract, *, inst: str = "") -> List[Finding]:
    out: List[Finding] = []
    out += check_limits(c)
    out += check_coverage(c)
    out += check_reductions(c)
    out += check_budgets(c)
    out += check_precision(c)
    if inst:
        out = [dataclasses.replace(f, data=f.data + (("instantiation", inst),))
               for f in out]
    return out


def admits(c: LaunchContract) -> bool:
    """The lint admits the plan: no error (a warning or the info that it
    needs the card does not refuse it)."""
    return not [f for f in check_contract(c) if f.severity == "error"]


def check_all(contracts: Iterable[Tuple[LaunchContract, str]]
              ) -> List[Finding]:
    out: List[Finding] = []
    for c, inst in contracts:
        out += check_contract(c, inst=inst)
    return out
