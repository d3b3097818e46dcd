"""Declared launch contracts for every CUDA launch entry of this package.

A :class:`LaunchContract` is the statically checkable half of one launch
of a hand-written kernel (``csrc/*.cu``) for one problem and one schedule
of the tuner's space (the counterpart of ``repro.kernels.contracts`` for a
``pallas_call``): the grid, as boxes of named block coordinates; the
cluster size, threads per block and the blocks an SM must hold by the
kernel's ``__launch_bounds__``; each operand's tile index map as an affine
function of the block coordinates (``analysis/lint/affine.py`` proves its
range and coverage), a ragged edge declared predicated, a block-table
gather declared data-dependent; dynamic shared memory; workspace words,
tickets then partials; how split partials are combined (``ticket``: the
stream's workspace, the last block adds them in split order and puts its
ticket back to 0; ``cluster``: distributed shared memory in split order;
``none``); the MMA operand / accumulator dtype pairs; and the kernel's
own limits (``limits``), which the C plan functions check before a launch.

The builders mirror the C plan functions line for line (``gemm_plan`` /
``gemm_s8_plan`` in ``csrc/gemm.cu`` over ``hgemm.cuh``, ``sgemm.cuh``
and ``igemm.cuh``; ``conv_plan`` in ``csrc/conv.cu``; the attention plans
in ``csrc/attention.cuh``; ``ssd_plan`` in ``csrc/ssd.cuh``;
``epilogue_plan``) and take the card's SM count as an argument
(``hgemm::sm_count()`` enters the plans; an H100 SXM has 132). Each
contract's ``plan`` holds the figures the C function's array gives, field
for field, so the card can hold the two against each other. Where the
plan depends on how many clusters the card holds at once
(``cudaOccupancyMaxActiveClusters``, the wide 16-bit GEMM's K splits),
the builder takes the C plan's own fallback (one block an SM) and marks
the contract ``needs_card``.

The kernel limits live here and nowhere else in Python:
``tune/schedules.py`` reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

# -- the card ---------------------------------------------------------------
SMS = 132                      # H100 SXM streaming multiprocessors
SMEM_PER_BLOCK = 232448        # 227 KB of dynamic shared memory a block
SMEM_PER_SM = 233472           # 228 KB an SM
SMEM_RESERVED = 1024           # the runtime's share of each resident block
REGS_PER_SM = 65536
THREADS_PER_SM = 2048
MAX_THREADS = 1024
PORTABLE_CLUSTER = 8           # blocks a cluster may hold on any card

# -- kernel limits (csrc headers) --------------------------------------------
MAX_TICKETS = 1024             # hgemm.cuh: tickets ahead of the partials
HGEMM_BK = 64                  # hgemm.cuh BK, SK_ROW_CHUNK
SK_TRANS_CHUNK = 256           # hgemm.cuh: skinny k a round, B = table.T
SK_MAX_SPLITS = 32
WIDE_THREADS = 288
WD_MIN_STEPS = 4
WD_MAX_SPLITS = 8              # a tile's splits: one cluster of blocks
WIDE_TILES = {2: (128, 64), 3: (128, 128), 4: (128, 256), 5: (64, 256)}
GROUP_M = 8                    # OS order: M tiles a group
IGEMM_BK = 64                  # igemm.cuh: k bytes a stage
IGEMM_PAD = 16
IGEMM_MAX_SPLITS = 16
IGEMM_FILL = 3
IGEMM_TILES = {1: (16, 64), 2: (64, 64)}
IGEMM_CFG = {1: dict(warps=4, stages=4, per_sm=4),
             2: dict(warps=8, stages=4, per_sm=2)}
SGEMM_BK = 16                  # sgemm.cuh
SGEMM_BN = 128
SGEMM_STAGES = 4
SGEMM_MIN_STEPS = 4
SGEMM_MAX_SPLITS = 16
SGEMM_TILES = {1: (64, 128), 2: (128, 128)}
CC_TILE = (56, 64)             # conv.cu's CUDA-core plan
CC_KG = 4
CC_MAX_SPLITS = 32
CC_MAX_CHAIN = 512
CC_FILL, CC_TAIL, CC_MERGE, CC_PAIR = 2.0, 3.0, 0.2, 1.2
STRIP_SMEM = 48 * 1024
FT_WARPS, FT_ROWS, FT_MAX_CLUSTER = 4, 16, 4          # attention.cu bf16
F32_WARPS, F32_KT, F32_MAX_CLUSTER = 4, 16, 4         # attention.cu fp32
FLASH_CLUSTERS = (1, 2, 4)
FLASH_STAGES = (1, 2)
DS_WARPS, DS_SPLIT, DS_MAX_SPLIT = 8, 64, 4096        # split decode
DS_SPLIT_ALIGN = 16            # a caller's keys a split: a multiple of it
EPI_THREADS = 256
SSD_QMAX, SSD_NMAX = 256, 256
SSD_P = (8, 16, 32, 64)        # slice widths: any head dim runs as slices
HEAD_DIMS = (16, 32, 64, 128, 256)
HEAD_DIM_MAX = 512             # fp32's widest instance (16-bit: 256)

F32, BF16, F16, I8, I16, I32 = (("float", 4), ("float", 2), ("float", 2),
                                ("int", 1), ("int", 2), ("int", 4))
_DTYPE_NAMES = {"float32": F32, "bfloat16": BF16, "float16": F16,
                "int8": I8, "int16": I16, "int32": I32,
                "fp32": F32, "bf16": BF16, "fp16": F16}


def dt(dtype) -> Tuple[str, int]:
    """A torch dtype or a name -> ("float" | "int", bytes)."""
    if isinstance(dtype, tuple):
        return dtype
    return _DTYPE_NAMES[str(dtype).replace("torch.", "")]


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# -- contract dataclasses ---------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OperandSpec:
    """One operand of a launch: its logical extents, its tile, and how a
    block finds its tile. ``predicated`` names the dims whose ragged edge
    the kernel masks; ``data_dependent`` replaces the map for a gather
    through a table in device memory; ``ranged`` for a read range the
    kernel derives from the problem (a causal or windowed key range) and
    clamps to the operand itself."""

    name: str
    shape: Tuple[int, ...]
    tile: Tuple[int, ...]
    dtype: Tuple[str, int] = F32
    output: bool = False
    predicated: Tuple[int, ...] = ()
    data_dependent: Optional[str] = None
    ranged: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Region:
    """A box of block coordinates ((axis, size), launch order) and, per
    operand, the index map from them to its tile. ``loops`` are axes a
    block walks in a loop (a grid-stride loop), not blocks."""

    grid: Tuple[Tuple[str, int], ...]
    maps: Tuple[Tuple[str, Callable], ...] = ()
    loops: Tuple[str, ...] = ()

    @property
    def blocks(self) -> int:
        """Blocks of the box (0 where every axis is a loop: the box is a
        walk inside blocks another region counts)."""
        sizes = [size for name, size in self.grid if name not in self.loops]
        n = 1
        for size in sizes:
            n *= size
        return n if sizes else 0


@dataclasses.dataclass(frozen=True)
class Reduction:
    """How an output absorbs the partials of its split axis."""

    out: str
    axis: str
    via: str                       # "ticket" | "cluster" | "none"
    order: str = "split"           # "split" (fixed) | "atomic"
    tickets: int = 0               # ticket words the launch takes
    ticket_words: int = 0          # words set aside for tickets
    partial_words: int = 0         # words of partials


@dataclasses.dataclass(frozen=True)
class MmaPair:
    lhs: Tuple[str, int]
    rhs: Tuple[str, int]
    acc: Tuple[str, int]


@dataclasses.dataclass(frozen=True)
class Limit:
    """A bound the kernel's C plan checks: ``lo <= value <= hi``."""

    name: str
    value: int
    lo: int
    hi: int

    @property
    def ok(self) -> bool:
        return self.lo <= self.value <= self.hi


@dataclasses.dataclass(frozen=True)
class LaunchContract:
    name: str
    regions: Tuple[Region, ...]
    operands: Tuple[OperandSpec, ...]
    blocks: int                    # blocks the launch makes
    threads: int
    cluster: int = 1
    min_blocks: int = 1            # __launch_bounds__ blocks an SM
    smem: int = 0                  # dynamic shared memory bytes
    workspace_words: int = 0
    reductions: Tuple[Reduction, ...] = ()
    mma: Tuple[MmaPair, ...] = ()
    limits: Tuple[Limit, ...] = ()
    needs_card: Optional[str] = None
    launches: int = 1              # launches of one call (SSD: chunks)
    plan: Tuple[Tuple[str, int], ...] = ()
    # the __global__ template the launch instantiates ("ns::name") and its
    # leading int / bool template arguments, as the build's ptxas lists it
    kernel: str = ""
    kernel_args: Tuple[int, ...] = ()

    @property
    def max_regs(self) -> int:
        """Registers a thread may use by the launch bounds' promise."""
        return REGS_PER_SM // max(1, self.threads * self.min_blocks)

    def plan_dict(self) -> Dict[str, int]:
        return dict(self.plan)


# -- registry + launcher annotation ----------------------------------------
CONTRACT_BUILDERS: Dict[str, Callable[..., LaunchContract]] = {}


def contract_builder(name: str):
    def deco(fn):
        CONTRACT_BUILDERS[name] = fn
        return fn
    return deco


def kernel_contract(*names: str):
    """Annotate a wrapper that binds a ``*_launch`` entry with the names of
    its contracts. Declarative (identity at run time); the lint's source
    pass requires it on every such wrapper, each name registered."""
    def deco(fn):
        fn.__lint_contract__ = names
        return fn
    return deco


# ---------------------------------------------------------------------------
# the GEMM tile orders (hgemm::tile_coords): one tile a block, the splits of
# a tile adjacent (block = tile * S + split)
# ---------------------------------------------------------------------------
def _tile_regions(tm: int, tn: int, splits: int, ws: bool,
                  maps: Callable[[str], Tuple[Tuple[str, Callable], ...]]
                  ) -> Tuple[Region, ...]:
    """WS walks the tiles weight-major (tile t: row t % tm, column t //
    tm); OS in groups of GROUP_M row tiles, column-major inside a group
    (the last group holds the rest of the rows). ``maps(kind)`` gives the
    operand maps for a region whose coordinates are (g?, nt, r, s) with
    row tile ``first + r``."""
    if ws:
        return (Region((("nt", tn), ("mt", tm), ("s", splits)),
                       maps("ws")),)
    full, rest = divmod(tm, GROUP_M)
    out = []
    if full:
        out.append(Region((("g", full), ("nt", tn), ("r", GROUP_M),
                           ("s", splits)), maps("group")))
    if rest:
        out.append(Region((("nt", tn), ("r", rest), ("s", splits)),
                          maps(("tail", full * GROUP_M))))
    return tuple(out)


def _gemm_maps(kind):
    """Operand maps of the GEMM's tile orders: C (mt, nt); D likewise (a
    full bias) or (0, nt) (a broadcast row); A (mt, s) and B (s, nt) in
    units of a split's k range. Coordinates: WS (nt, mt, s); a whole OS
    group (g, nt, r, s); the last OS group (nt, r, s), rows from
    ``kind[1]``."""
    if kind == "ws":
        def coords(nt, mt, s):
            return mt, nt, s
    elif kind == "group":
        def coords(g, nt, r, s):
            return g * GROUP_M + r, nt, s
    else:
        first = kind[1]

        def coords(nt, r, s):
            return first + r, nt, s

    def tile(pick):
        return lambda *a: pick(*coords(*a))
    return (("c", tile(lambda m, n, s: (m, n))),
            ("d", tile(lambda m, n, s: (m, n))),
            ("d_row", tile(lambda m, n, s: (0, n))),
            ("a", tile(lambda m, n, s: (m, s))),
            ("b", tile(lambda m, n, s: (s, n))))


def _gemm_operands(m, n, k, bm, bn, splits, ksteps, bk, in_dt, out_dt,
                   acc_dt, has_bias, bias_rows):
    kspan = cdiv(max(ksteps, 1), max(splits, 1)) * bk
    ops = [OperandSpec("a", (m, max(k, 1)), (bm, kspan), in_dt,
                       predicated=(0, 1)),
           OperandSpec("b", (max(k, 1), n), (kspan, bn), in_dt,
                       predicated=(0, 1)),
           OperandSpec("c", (m, n), (bm, bn), out_dt, output=True,
                       predicated=(0, 1))]
    if has_bias:
        ops.append(OperandSpec("d" if bias_rows else "d_row",
                               (m if bias_rows else 1, n),
                               (bm if bias_rows else 1, bn), acc_dt,
                               predicated=(0, 1)))
    return tuple(ops)


def _select_maps(maps, ops):
    names = {o.name for o in ops}
    return tuple((nm, fn) for nm, fn in maps if nm in names)


def _ticket(splits, tiles, part_words, out="c", axis="s"):
    if splits <= 1:
        return Reduction(out, axis, "none")
    return Reduction(out, axis, "ticket", tickets=tiles,
                     ticket_words=MAX_TICKETS, partial_words=part_words)


# ---------------------------------------------------------------------------
# hgemm.cuh (bf16 / fp16): skinny mma.sync for M <= 16, wide wgmma above
# ---------------------------------------------------------------------------
def _wide_stages(bm, bn):
    return min(200 * 1024 // ((bm + bn) * HGEMM_BK * 2), 8)


def _wide_smem(bm, bn):
    return max(_wide_stages(bm, bn) * (bm + bn) * HGEMM_BK * 2,
               bm * (bn + 8) * 4) + 1024


def _skinny_geometry(m, n, k, b_trans, sms):
    """hgemm::plan's M <= 16 branch (the skinny kernel's geometry at any M:
    its tile holds 16 rows)."""
    target = 2 * sms
    bm = 16 if m > 8 else 8
    n256 = cdiv(n, 256)
    warps_n = 4 if b_trans or (n256 > 8 and n256 * cdiv(k, 64) >= target) \
        else 1
    if b_trans:
        bk = SK_TRANS_CHUNK
    elif warps_n == 4 or cdiv(n, 64) * cdiv(k, 256) < sms:
        bk = HGEMM_BK
    else:
        bk = 4 * HGEMM_BK
    bn = (16 if b_trans else 64) * warps_n
    ksteps = cdiv(k, bk)
    tiles_n = cdiv(n, bn)
    s = min(cdiv(target, tiles_n), ksteps, SK_MAX_SPLITS)
    s = s if s > 1 else 1
    if tiles_n > MAX_TICKETS:
        s = 1
    return dict(wide=0, bm=bm, bn=bn, bk=bk, warps_n=warps_n, stages=1,
                threads=128, smem=0, tiles_m=1, tiles_n=tiles_n,
                ksteps=ksteps, splits=s)


def _wide_shape(m, n, sms):
    tm = cdiv(m, 128)
    if tm * cdiv(n, 64) <= sms:
        return 0
    if tm * cdiv(n, 128) <= sms:
        return 1
    return 3 if m <= 64 else 2


def _plan_wide(m, n, k, shape, splits, sms, clusters):
    bm = 64 if shape == 3 else 128
    bn = 64 if shape == 0 else 128 if shape == 1 else 256
    ksteps = cdiv(k, HGEMM_BK)
    tiles_m, tiles_n = cdiv(m, bm), cdiv(n, bn)
    tiles = tiles_m * tiles_n
    s = splits
    asked = None
    if s <= 0:
        s = sms // tiles if tiles < sms else 1
        s = min(s, ksteps // WD_MIN_STEPS, WD_MAX_SPLITS)
        if s > 1 and tiles > 1:
            asked = ("the wide kernel's own K splits are cut back to the "
                     "clusters of that many blocks the card holds at once")
        while s > 1 and tiles > clusters(s):
            s -= 1
    s = min(s, WD_MAX_SPLITS, ksteps)
    return dict(wide=1, bm=bm, bn=bn, bk=HGEMM_BK, warps_n=0,
                stages=_wide_stages(bm, bn), threads=WIDE_THREADS,
                smem=_wide_smem(bm, bn), tiles_m=tiles_m, tiles_n=tiles_n,
                ksteps=ksteps, splits=s if s > 1 else 1), asked


def _hgemm_tile_code(p):
    if not p["wide"]:
        return 1
    return 2 + (3 if p["bm"] == 64 else 0 if p["bn"] == 64
                else 1 if p["bn"] == 128 else 2)


def _hgemm_contract(m, n, k, b_trans, in_dt, out_dt, ws, has_bias,
                    bias_rows, tile, splits, sms):
    def clusters(size):             # the C plan's fallback: one block an SM
        return sms // size
    limits = []
    needs = None
    static = tile == 0 and splits == 0
    if static:
        if m <= 16:
            p = _skinny_geometry(m, n, k, b_trans, sms)
        else:
            p, needs = _plan_wide(m, n, k, _wide_shape(m, n, sms), 0, sms,
                                  clusters)
    elif tile == 1:
        p = _skinny_geometry(m, n, k, b_trans, sms)
        p["splits"] = splits
        limits += [Limit("splits", splits, 1, SK_MAX_SPLITS),
                   Limit("splits <= k steps", splits, 1, max(p["ksteps"], 1))]
    else:
        shape = tile - 2
        limits.append(Limit("tile code", tile, 2, 5))
        shape = min(max(shape, 0), 3)
        p, _ = _plan_wide(m, n, k, shape, max(splits, 1), sms, clusters)
        p["splits"] = max(splits, 1)
        limits += [Limit("m (wide)", m, 17, 1 << 31),
                   Limit("splits", splits, 1, WD_MAX_SPLITS),
                   Limit("splits <= k steps", splits, 1,
                         max(p["ksteps"], 1))]
        if splits > 1:
            needs = ("a cluster of this many wide blocks is admitted only "
                     "where the card holds one at once")
    s = p["splits"]
    tiles = p["tiles_m"] * p["tiles_n"]
    blocks = tiles * s
    part = blocks * 32 * p["warps_n"] * (4 if b_trans else 16) * \
        (2 if m > 8 else 1) if not p["wide"] and s > 1 else 0
    ws_words = MAX_TICKETS + part if not p["wide"] and s > 1 else 0
    if p["wide"]:
        red = Reduction("c", "s", "cluster" if s > 1 else "none")
        cluster = s
    else:
        red = _ticket(s, tiles, part)
        cluster = 1
    ops = _gemm_operands(m, n, k, p["bm"], p["bn"], s, p["ksteps"], p["bk"],
                         in_dt, out_dt, F32, has_bias, bias_rows)
    code = 1 if p["wide"] else 0
    if p["wide"]:                   # hgemm::dispatch
        kernel = ("hgemm::wide_kernel",
                  (int(b_trans), 1 if p["bm"] == 64 else 2, p["bn"]))
    else:
        wn_kw = (4, 4) if b_trans or p["warps_n"] == 4 else \
            (1, 1) if p["bk"] == HGEMM_BK else (1, 4)
        kernel = ("hgemm::skinny_kernel",
                  (int(b_trans),) + wn_kw + (2 if m > 8 else 1,))
    plan = (("regime", code), ("bm", p["bm"]), ("bn", p["bn"]),
            ("bk", p["bk"]), ("splits", s), ("blocks", blocks),
            ("threads", p["threads"]), ("stages", p["stages"]),
            ("smem", p["smem"]), ("workspace_words", ws_words),
            ("tile_code", _hgemm_tile_code(p)))
    return LaunchContract(
        name="gemm", regions=_tile_regions(
            p["tiles_m"], p["tiles_n"], max(s, 1), ws,
            lambda kind: _select_maps(_gemm_maps(kind), ops)),
        operands=ops, blocks=blocks, threads=p["threads"], cluster=cluster,
        smem=p["smem"], workspace_words=ws_words,
        reductions=(red,), mma=(MmaPair(in_dt, in_dt, F32),),
        limits=tuple(limits), needs_card=needs, plan=plan,
        kernel=kernel[0], kernel_args=kernel[1])


# ---------------------------------------------------------------------------
# sgemm.cuh (fp32 GEMM on CUDA cores)
# ---------------------------------------------------------------------------
def _sgemm_smem(bm, b_trans, es=4):
    ldk, ldn = SGEMM_BK + 4, SGEMM_BN + 4
    a = bm * ldk
    b = SGEMM_BN * ldk if b_trans else SGEMM_BK * ldn
    return max(SGEMM_STAGES * (a + b) * es, bm * ldn * 4)


def _sgemm_contract(m, n, k, b_trans, out_dt, ws, has_bias, bias_rows,
                    tile, splits, sms):
    limits = []
    if tile == 0 and splits == 0:
        bm = 128 if cdiv(m, 128) * 128 == cdiv(m, 64) * 64 and m > 64 \
            else 64
    else:
        limits.append(Limit("tile code", tile, 1, 2))
        bm = 128 if tile == 2 else 64
    tiles_m, tiles_n = cdiv(m, bm), cdiv(n, SGEMM_BN)
    ksteps = cdiv(k, SGEMM_BK)
    tiles = tiles_m * tiles_n
    if tile == 0 and splits == 0:
        slots = sms * (2 if bm == 64 else 1)
        most = min(ksteps // SGEMM_MIN_STEPS, SGEMM_MAX_SPLITS)
        if tiles > MAX_TICKETS:
            most = 1
        s, best, c = 1, 0.0, 1
        while c <= most or c == 1:
            waves = float((tiles * c + slots - 1) // slots)
            cost = waves * (ksteps / c + 3.0 + c / 8.0)
            if c == 1 or cost < best:
                best, s = cost, c
            c += 1
    else:
        s = splits
        limits += [Limit("splits", splits, 1, SGEMM_MAX_SPLITS),
                   Limit("splits <= k steps", splits, 1, max(ksteps, 1))]
    blocks = tiles * s
    ws_words = MAX_TICKETS + blocks * bm * SGEMM_BN if s > 1 else 0
    threads = bm * SGEMM_BN // 64
    smem = _sgemm_smem(bm, b_trans)
    ops = _gemm_operands(m, n, k, bm, SGEMM_BN, s, ksteps, SGEMM_BK, F32,
                         out_dt, F32, has_bias, bias_rows)
    plan = (("regime", 2), ("bm", bm), ("bn", SGEMM_BN), ("bk", SGEMM_BK),
            ("splits", s), ("blocks", blocks), ("threads", threads),
            ("stages", SGEMM_STAGES), ("smem", smem),
            ("workspace_words", ws_words),
            ("tile_code", 2 if bm == 128 else 1))
    return LaunchContract(
        name="gemm", regions=_tile_regions(
            tiles_m, tiles_n, max(s, 1), ws,
            lambda kind: _select_maps(_gemm_maps(kind), ops)),
        operands=ops, blocks=blocks, threads=threads, smem=smem,
        workspace_words=ws_words,
        reductions=(_ticket(s, tiles, blocks * bm * SGEMM_BN),),
        mma=(MmaPair(F32, F32, F32),), limits=tuple(limits), plan=plan,
        kernel="sgemm::sgemm_kernel",
        kernel_args=(8, bm // 8, SGEMM_BN // 8, 1, int(b_trans)))


# ---------------------------------------------------------------------------
# igemm.cuh (int8; int16 on byte planes; the tensor-core conv)
# ---------------------------------------------------------------------------
def _b_slab(bn, es):
    return IGEMM_BK // es * (bn * es + IGEMM_PAD)


def _igemm_smem(bm, bn, stages, b_trans, es):
    lda = IGEMM_BK + IGEMM_PAD
    stage = bm * lda + (bn * lda if b_trans else _b_slab(bn, es))
    return stages * stage + (0 if b_trans or es > 1 else 2 * bn * lda)


def _igemm_geometry(m, n, kb, b_trans, es, tile, splits, sms):
    """igemm::plan / plan_with over k bytes ``kb``: (plan fields, limits)."""
    limits = []
    ksteps = cdiv(kb, IGEMM_BK) if kb > 0 else 1
    if tile == 0 and splits == 0:
        code = 1 if m <= 16 else 2
    else:
        limits.append(Limit("tile code", tile, 1, 2))
        code = 1 if tile == 1 else 2
    bm, bn = IGEMM_TILES[code]
    cfg = IGEMM_CFG[code]
    tiles_m, tiles_n = cdiv(m, bm), cdiv(n, bn)
    tiles = tiles_m * tiles_n
    if tile == 0 and splits == 0:
        slots = sms * cfg["per_sm"]
        merge = 0.5 * bm * bn * 4 / ((bm + bn) * IGEMM_BK)
        most = min(ksteps, IGEMM_MAX_SPLITS)
        if tiles > MAX_TICKETS:
            most = 1
        s, best = 1, 0.0
        for c in range(1, most + 1):
            waves = float((tiles * c + slots - 1) // slots)
            cost = waves * (cdiv(ksteps, c) + IGEMM_FILL) + (c - 1) * merge
            if c == 1 or cost < best:
                best, s = cost, c
    else:
        s = splits
        limits += [Limit("splits", splits, 1, IGEMM_MAX_SPLITS),
                   Limit("splits <= k steps", splits, 1, ksteps)]
    smem = _igemm_smem(bm, bn, cfg["stages"], b_trans, es)
    blocks = tiles * s
    part = tiles * s * bm * bn if s > 1 else 0
    return dict(code=code, bm=bm, bn=bn, tiles_m=tiles_m, tiles_n=tiles_n,
                tiles=tiles, ksteps=ksteps, splits=s, blocks=blocks,
                threads=32 * cfg["warps"], stages=cfg["stages"],
                per_sm=cfg["per_sm"], smem=smem, part=part,
                ws_words=MAX_TICKETS + part if s > 1 else 0), limits


def _igemm_contract(name, m, n, k, b_trans, es, in_dt, out_dt, ws,
                    has_bias, bias_rows, tile, splits, sms, bk_field,
                    regime, extra_smem=0):
    p, limits = _igemm_geometry(m, n, k * es, b_trans, es, tile, splits, sms)
    ops = _gemm_operands(m, n, k, p["bm"], p["bn"], p["splits"], p["ksteps"],
                         IGEMM_BK // es, in_dt, out_dt, I32, has_bias,
                         bias_rows)
    pair = (MmaPair(I8, I8, I32) if in_dt == I8 else
            MmaPair(I8, ("int", 1), I32) if in_dt == I16 else
            MmaPair(in_dt, in_dt, F32))
    plan = (("regime", regime(p)), ("bm", p["bm"]), ("bn", p["bn"]),
            ("bk", bk_field), ("splits", p["splits"]),
            ("blocks", p["blocks"]), ("threads", p["threads"]),
            ("stages", p["stages"]), ("smem", p["smem"]),
            ("workspace_words", p["ws_words"]), ("tile_code", p["code"]))
    return LaunchContract(
        name=name, regions=_tile_regions(
            p["tiles_m"], p["tiles_n"], max(p["splits"], 1), ws,
            lambda kind: _select_maps(_gemm_maps(kind), ops)),
        operands=ops, blocks=p["blocks"], threads=p["threads"],
        min_blocks=p["per_sm"], smem=p["smem"] + extra_smem,
        workspace_words=p["ws_words"],
        reductions=(_ticket(p["splits"], p["tiles"], p["part"]),),
        mma=(pair,), limits=tuple(limits), plan=plan,
        kernel="igemm::kernel",       # kernel<In, R, TRANS_B, ALoad>
        kernel_args=(0 if p["code"] == 1 else 1, int(b_trans)))


@contract_builder("gemm")
def gemm_contract(m: int, n: int, k: int, *, dtype, out_dtype=None,
                  b_trans: bool = False, ws: bool = False,
                  has_bias: bool = False, bias_rows: bool = False,
                  tile: int = 0, splits: int = 0,
                  sms: int = SMS) -> LaunchContract:
    """``gemm_launch`` / ``gemm_f16_launch`` / ``gemm_s16_launch``
    (``gemm_plan``'s array): bf16 / fp16 on ``hgemm.cuh``, fp32 on
    ``sgemm.cuh``, int16 on ``igemm.cuh``'s byte planes (k counted in
    bytes, ``bk`` 32 values)."""
    d = dt(dtype)
    name = _name(dtype)
    if name == "int16":
        out = dt(out_dtype or "int16")
        return _igemm_contract(
            "gemm", m, n, k, b_trans, 2, I16, out, ws, has_bias, bias_rows,
            tile, splits, sms, IGEMM_BK // 2,
            lambda p: 0 if p["code"] == 1 else 3)
    out = dt(out_dtype or dtype)
    if name == "float32":
        return _sgemm_contract(m, n, k, b_trans, out, ws, has_bias,
                               bias_rows, tile, splits, sms)
    if name not in ("bfloat16", "float16"):
        raise ValueError(f"gemm_contract: no kernel for {dtype}")
    return _hgemm_contract(m, n, k, b_trans, d, out, ws, has_bias,
                           bias_rows, tile, splits, sms)


@contract_builder("gemm_s8")
def gemm_s8_contract(m: int, n: int, k: int, *, out_dtype="int8",
                     b_trans: bool = False, ws: bool = False,
                     has_bias: bool = False, bias_rows: bool = False,
                     tile: int = 0, splits: int = 0,
                     sms: int = SMS) -> LaunchContract:
    """``gemm_s8_launch`` (``gemm_s8_plan``'s array)."""
    return _igemm_contract(
        "gemm_s8", m, n, k, b_trans, 1, I8, dt(out_dtype), ws, has_bias,
        bias_rows, tile, splits, sms, IGEMM_BK, lambda p: p["code"] - 1)


# ---------------------------------------------------------------------------
# conv.cu: the implicit-im2col conv
# ---------------------------------------------------------------------------
def _strip_bytes(n, h, w, ci, co, kh, kw, stride, pad, oh, ow, bm, es):
    if (kh == 1 and kw == 1 and stride == 1 and pad == 0) or ci * es >= 16:
        return 0
    segs = (bm + ow - 2) // ow + 1
    pixels = (min(bm, ow) - 1) * stride + kw
    slot = (pixels * ci * es + 30 + 15) // 16 * 16
    nbytes = segs * kh * slot
    return nbytes if nbytes <= STRIP_SMEM else 0


def _cc_smem(es):
    bm, bn = CC_TILE
    ldk, ldn = SGEMM_BK + 4, bn + 4
    ring = SGEMM_STAGES * (bm * ldk + SGEMM_BK * ldn) * es
    return max(ring, CC_KG * bm * ldn * 4)


def _cc_plan(m, n, k, tile, splits, sms):
    bm, bn = CC_TILE
    tiles = cdiv(m, bm) * cdiv(n, bn)
    ksteps = cdiv(k, SGEMM_BK)
    limits = []
    if tile == 0 and splits == 0:
        least = cdiv(ksteps, CC_MAX_CHAIN // SGEMM_BK)
        most = 1 if tiles > MAX_TICKETS else min(CC_MAX_SPLITS, ksteps // 2)
        best_s, best, s = 1, -1.0, 1
        while s <= max(most, 1):
            if not (s < least and 2 * s <= most):
                per_sm = (tiles * s + sms - 1) // sms
                rate = CC_PAIR if per_sm > 1 else 1.0
                cost = per_sm * (cdiv(ksteps, s) + CC_FILL) / rate + \
                    (CC_TAIL if s > 1 else 0.0) + CC_MERGE * (s - 1)
                if best < 0 or cost < best:
                    best, best_s = cost, s
            s *= 2
        s = best_s
    else:
        s = splits if splits > 0 else 1
        limits += [Limit("tile code", tile, 1, 1),
                   Limit("splits", splits, 1, CC_MAX_SPLITS),
                   Limit("splits <= k steps", splits, 1, max(ksteps, 1))]
    return dict(bm=bm, bn=bn, tiles_m=cdiv(m, bm), tiles_n=cdiv(n, bn),
                tiles=tiles, ksteps=ksteps, splits=s, blocks=tiles * s,
                ws_words=MAX_TICKETS + tiles * s * bm * bn if s > 1 else 0,
                part=tiles * s * bm * bn if s > 1 else 0), limits


@contract_builder("conv2d_implicit")
def conv_contract(n: int, h: int, w: int, ci: int, co: int, kh: int,
                  kw: int, *, stride: int = 1, padding: int = 0, dtype,
                  out_dtype=None, has_bias: bool = False, tile: int = 0,
                  splits: int = 0, sms: int = SMS) -> LaunchContract:
    """``conv2d_launch`` (``conv_plan``'s array for the implicit GEMM (M, N,
    K) = (N*OH*OW, CO, KH*KW*CI)): int8 / bf16 / fp16 on the tensor-core
    loop (the image as bytes), fp32 / int16 on the CUDA-core loop, each in
    the OS tile order; the strip loader's shared memory where a tap has
    less than 16 bytes of channels."""
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (w + 2 * padding - kw) // stride + 1
    m, k = n * oh * ow, kh * kw * ci
    name = _name(dtype)
    d = dt(dtype)
    es = d[1]
    acc = I32 if d[0] == "int" else F32
    out = dt(out_dtype or dtype)
    geom = (n, h, w, ci, co, kh, kw, stride, padding, oh, ow)
    if name in ("int8", "bfloat16", "float16"):
        p, _ = _igemm_geometry(m, co, k * es, 0, es, tile, splits, sms)
        strips = _strip_bytes(*geom, p["bm"], es)
        c = _igemm_contract(
            "conv2d_implicit", m, co, k, False, es, d, out, False, has_bias,
            False, tile, splits, sms, IGEMM_BK, lambda p: p["code"] - 1,
            extra_smem=strips)
        return dataclasses.replace(c, operands=_conv_operands(
            c.operands, n, oh, ow, co, d))
    if name not in ("float32", "int16"):
        raise ValueError(f"conv_contract: no kernel for {dtype}")
    p, limits = _cc_plan(m, co, k, tile, splits, sms)
    strips = _strip_bytes(*geom, p["bm"], es)
    smem = _cc_smem(es)
    ops = _gemm_operands(m, co, k, p["bm"], p["bn"], p["splits"],
                         p["ksteps"], SGEMM_BK, d, out, acc, has_bias, False)
    plan = (("regime", 2), ("bm", p["bm"]), ("bn", p["bn"]),
            ("bk", SGEMM_BK), ("splits", p["splits"]),
            ("blocks", p["blocks"]), ("threads", 64 * CC_KG),
            ("stages", SGEMM_STAGES), ("smem", smem),
            ("workspace_words", p["ws_words"]), ("tile_code", 1))
    return LaunchContract(
        name="conv2d_implicit", regions=_tile_regions(
            p["tiles_m"], p["tiles_n"], max(p["splits"], 1), False,
            lambda kind: _select_maps(_gemm_maps(kind), ops)),
        operands=_conv_operands(ops, n, oh, ow, co, d),
        blocks=p["blocks"], threads=64 * CC_KG, min_blocks=2,
        smem=smem + strips, workspace_words=p["ws_words"],
        reductions=(_ticket(p["splits"], p["tiles"], p["part"]),),
        mma=(MmaPair(d, d, acc),), limits=tuple(limits), plan=plan,
        kernel="sgemm::sgemm_kernel",   # conv.cu CcShape: MR 7, TY 8, TX 8
        kernel_args=(7, 8, 8, CC_KG, 0))


def _conv_operands(ops, n, oh, ow, co, d):
    """The implicit GEMM's A is the image gathered tap by tap (padding
    zero-filled by the copy), not a matrix in memory."""
    out = []
    for o in ops:
        if o.name == "a":
            o = dataclasses.replace(
                o, ranged="implicit im2col: each row's taps gathered from "
                          "the NHWC image, taps in the padding zero-filled")
        out.append(o)
    return tuple(out)


# ---------------------------------------------------------------------------
# datapath.cu: the conversion and the generic epilogue, grid-stride loops
# ---------------------------------------------------------------------------
ANY_THREADS = 256
ANY_MAX_BLOCKS = 132 * 16


def _grid_stride_contract(name, kernel, count, src, out):
    blocks = max(1, min(cdiv(count, ANY_THREADS), ANY_MAX_BLOCKS))
    iters = max(1, cdiv(cdiv(count, ANY_THREADS), blocks))
    ops = (OperandSpec("src", (max(count, 1),), (ANY_THREADS,), src,
                       predicated=(0,)),
           OperandSpec("c", (max(count, 1),), (ANY_THREADS,), out,
                       output=True, predicated=(0,)))
    region = Region((("it", iters), ("blk", blocks)),
                    (("src", lambda it, b: (it * blocks + b,)),
                     ("c", lambda it, b: (it * blocks + b,))),
                    loops=("it",))
    return LaunchContract(
        name=name, regions=(region,), operands=ops, blocks=blocks,
        threads=ANY_THREADS, plan=(("blocks", blocks),
                                   ("threads", ANY_THREADS)),
        kernel=kernel)


@contract_builder("convert")
def convert_contract(count: int, *, src_dtype, dtype) -> LaunchContract:
    """``convert_launch``: one value a thread an iteration, blocks as
    many as the values need up to 16 an SM."""
    return _grid_stride_contract("convert", "convert_kernel", count,
                                 dt(src_dtype), dt(dtype))


@contract_builder("epilogue_any")
def epilogue_any_contract(count: int, *, acc_dtype,
                          out_dtype) -> LaunchContract:
    """``epilogue_any_launch``: the generic epilogue, one value a thread an
    iteration (the bias read beside it)."""
    return _grid_stride_contract("epilogue_any", "epilogue_any_kernel", count,
                                 dt(acc_dtype), dt(out_dtype))


# ---------------------------------------------------------------------------
# the mvout epilogue (gemm.cu epilogue_launch)
# ---------------------------------------------------------------------------
@contract_builder("accumulator_epilogue")
def epilogue_contract(count: int, *, acc_dtype, out_dtype,
                      acc_offset: int = 0, out_offset: int = 0,
                      sms: int = SMS) -> LaunchContract:
    """``epilogue_launch`` (``epilogue_plan``'s array): a grid-stride loop
    of runs of four values over ``count`` values, the accumulator
    ``acc_offset`` bytes past a 16-byte boundary and the output
    ``out_offset``; the head before the first aligned run and the tail
    after the last are done one by one by the first block's threads."""
    acc, out = dt(acc_dtype), dt(out_dtype)
    head = min(count, (16 - acc_offset % 16) % 16 // acc[1])
    packed = (out_offset + head * out[1]) % (4 * out[1]) == 0
    runs = (count - head) // 4
    want = cdiv(runs, 2 * EPI_THREADS)
    blocks = max(1, min(want, 4 * sms))
    tail = count - head - 4 * runs
    span = 2 * blocks                            # thread tiles an iteration
    iters = max(1, cdiv(cdiv(runs, EPI_THREADS), span))
    ops = [OperandSpec("acc", (max(4 * runs, 1),), (4 * EPI_THREADS,), acc,
                       predicated=(0,)),
           OperandSpec("c", (max(4 * runs, 1),), (4 * EPI_THREADS,), out,
                       output=True, predicated=(0,))]
    regions = [Region((("it", iters), ("u", 2), ("blk", blocks)),
                      (("acc", lambda it, u, b: (it * span + u * blocks + b,)),
                       ("c", lambda it, u, b: (it * span + u * blocks + b,))),
                      loops=("it", "u"))]
    if head or tail:
        ops += [OperandSpec("c_edges", (head + tail,), (head + tail,), out,
                            output=True)]
        regions.append(Region((("e", 1),), (("c_edges", lambda e: (e,)),),
                              loops=("e",)))
    plan = (("blocks", blocks), ("threads", EPI_THREADS), ("head", head),
            ("runs", runs), ("tail", tail), ("packed", int(packed)))
    return LaunchContract(
        name="accumulator_epilogue", regions=tuple(regions),
        operands=tuple(ops), blocks=blocks, threads=EPI_THREADS,
        limits=(Limit("accumulator alignment", acc_offset % acc[1], 0, 0),),
        plan=plan, kernel="epilogue_kernel")


# ---------------------------------------------------------------------------
# attention.cu: flash (bf16 tensor cores, fp32 CUDA cores), split decode
# ---------------------------------------------------------------------------
def compiled_head_dim(d: int, dtype="float32") -> int:
    """``attention.cuh`` compiled_dim: the instance a head dim d runs (the
    next of HEAD_DIMS, 512 for fp32 up to HEAD_DIM_MAX), 0 for none."""
    for c in HEAD_DIMS:
        if 1 <= d <= c:
            return c
    return HEAD_DIM_MAX if _name(dtype) == "float32" and \
        HEAD_DIMS[-1] < d <= HEAD_DIM_MAX else 0


def ssd_slice_width(p: int) -> int:
    """``ssd.cuh`` slice_width: the compiled width of head dim p's column
    slices (p itself where compiled; 64 above 32)."""
    if p < 1:
        return 0
    return next((w for w in SSD_P if p <= w), SSD_P[-1])


def _ft_tile(d):
    kt = 16 if d >= 256 else 32 if d >= 128 else 64
    stage_bytes = 2 * kt * (d + 8) * 2
    return kt, lambda st: FT_WARPS * st * stage_bytes + (FT_WARPS + 2) * \
        FT_ROWS * 4


def f32_warps(d: int) -> int:
    """Warps a block of the fp32 flash kernel at compiled head dim d."""
    return 2 if d > 256 else F32_WARPS


def _f32_tile(d):
    rpl = 4 if d <= 64 else 2 if d == 128 else 1
    rb = 8 * rpl
    ld = d + 4
    stage = 2 * F32_KT * ld
    w = f32_warps(d)
    head = rb * ld + w * rb * (F32_KT + 4) + (w + 2) * rb
    return rb, (1 if d >= 256 else 2), \
        lambda st: 4 * (head + w * st * stage)


def flash_max_stages(dtype, d: int) -> int:
    """K/V stages a warp of the flash kernel streams at most (head dim d:
    its compiled instance's)."""
    return 1 if _name(dtype) == "float32" and \
        compiled_head_dim(d, dtype) >= 256 else 2


def _flash_tc(tq, tk, h, batch, d, q_offset, causal, window, cluster,
              stages):
    kt, smem = _ft_tile(d)
    limits = []
    if cluster == 0 and stages == 0:
        most = 0
        for row0 in range(0, tq, FT_ROWS):
            q0 = q_offset + row0
            lo = max(q0 - window + 1, 0) if window > 0 else 0
            hi = tk
            if causal and q0 + FT_ROWS < hi:
                hi = q0 + FT_ROWS
            if hi > lo:
                most = max(most, cdiv(hi, kt) - lo // kt)
        cl = 1
        while cl < FT_MAX_CLUSTER and cl * FT_WARPS < most:
            cl *= 2
        st = 2 if most > cl * FT_WARPS else 1
    else:
        cl, st = cluster, stages
        limits += [Limit("cluster", cluster, 1, FT_MAX_CLUSTER),
                   Limit("cluster a power of two",
                         int(cluster & (cluster - 1) == 0 and cluster > 0),
                         1, 1),
                   Limit("stages", stages, 1, 2)]
    return dict(cluster=cl, stages=st, grid=(cl, cdiv(tq, FT_ROWS),
                                            h * batch),
                threads=FT_WARPS * 32, smem=smem(st)), limits


def _flash_f32(tq, h, kvh, batch, d, q_offset, kv_len, causal, window,
               cluster, stages, sms):
    rb, max_stages, smem = _f32_tile(d)
    warps = f32_warps(d)
    g = h // kvh
    rows = tq * g
    nrb = cdiv(rows, rb)
    most = 0
    for rb0 in range(0, rows, rb):
        last = min(rb0 + rb, rows) - 1
        p0, p1 = q_offset + rb0 // g, q_offset + last // g
        lo = max(p0 - window + 1, 0) if window > 0 else 0
        hi = p1 + 1 if causal and p1 + 1 < kv_len else kv_len
        if hi > lo:
            most = max(most, cdiv(hi, F32_KT) - lo // F32_KT)
    blocks = nrb * kvh * batch
    cl = 1
    while cl < F32_MAX_CLUSTER and cl * warps < most and \
            blocks * cl < sms:
        cl *= 2
    st = 2 if max_stages > 1 and most > cl * warps else 1
    limits = [Limit("row tiles", nrb, 0, 65535),
              Limit("kv heads x sequences", kvh * batch, 0, 65535)]
    if cluster != 0 or stages != 0:
        cl, st = cluster, stages
        limits += [Limit("cluster", cluster, 1, F32_MAX_CLUSTER),
                   Limit("cluster a power of two",
                         int(cluster & (cluster - 1) == 0 and cluster > 0),
                         1, 1),
                   Limit("stages", stages, 1, max_stages)]
    return dict(cluster=cl, stages=st, rb=rb, nrb=nrb,
                grid=(cl, kvh * batch, nrb), threads=warps * 32,
                smem=smem(st)), limits


def _flash_contract(name, batch, tq, tk, h, kvh, d, q_offset, causal,
                    window, dtype, cluster, stages, sms, paged):
    io = dt(dtype)
    dc = compiled_head_dim(d, dtype)
    limits = [Limit("head dim", d, 1, HEAD_DIM_MAX if io == F32
                    else HEAD_DIMS[-1]),
              Limit("query heads a multiple of kv heads",
                    int(kvh > 0 and h % kvh == 0), 1, 1)]
    kv_note = ("K/V rows gathered through the request's block table, "
               "name * page + offset, one lookup a key row") if paged \
        else None
    kv_range = None if paged else \
        "the key range [lo, hi) of the block's query rows, clamped to Tk"
    if _name(dtype) in ("bfloat16", "float16"):
        p, lim = _flash_tc(tq, tk, h, batch, dc or HEAD_DIMS[-1], q_offset,
                           causal, window, cluster, stages)
        nq = cdiv(tq, FT_ROWS)
        ops = (OperandSpec("q", (batch, tq, h, d), (1, FT_ROWS, 1, d), io,
                           predicated=(1,)),
               OperandSpec("k", (batch, tk, kvh, d), (1, tk, 1, d), io,
                           data_dependent=kv_note, ranged=kv_range),
               OperandSpec("v", (batch, tk, kvh, d), (1, tk, 1, d), io,
                           data_dependent=kv_note, ranged=kv_range),
               OperandSpec("o", (batch, tq, h, d), (1, FT_ROWS, 1, d), io,
                           output=True, predicated=(1,)))
        maps = (("q", lambda c, i, b, hh: (b, i, hh, 0)),
                ("o", lambda c, i, b, hh: (b, i, hh, 0)))
        region = Region((("c", p["cluster"]), ("i", nq), ("b", batch),
                         ("h", h)), maps)
        blocks = p["cluster"] * nq * h * batch
        mma = (MmaPair(io, io, F32), MmaPair(io, io, F32))
    else:
        p, lim = _flash_f32(tq, h, kvh, batch, dc or HEAD_DIM_MAX, q_offset,
                            tk, causal, window, cluster, stages, sms)
        g = h // max(kvh, 1)
        nrb = p["nrb"]
        ops = (OperandSpec("q", (batch, kvh, tq * g, d), (1, 1, p["rb"], d),
                           io, predicated=(2,)),
               OperandSpec("k", (batch, tk, kvh, d), (1, tk, 1, d), io,
                           data_dependent=kv_note, ranged=kv_range),
               OperandSpec("v", (batch, tk, kvh, d), (1, tk, 1, d), io,
                           data_dependent=kv_note, ranged=kv_range),
               OperandSpec("o", (batch, kvh, tq * g, d), (1, 1, p["rb"], d),
                           io, output=True, predicated=(2,)))
        maps = (("q", lambda c, b, kh, z: (b, kh, nrb - 1 - z, 0)),
                ("o", lambda c, b, kh, z: (b, kh, nrb - 1 - z, 0)))
        region = Region((("c", p["cluster"]), ("b", batch), ("kh", kvh),
                         ("z", nrb)), maps)
        blocks = p["cluster"] * kvh * batch * nrb
        mma = ()
    plan = (("cluster", p["cluster"]), ("stages", p["stages"]),
            ("grid_x", p["grid"][0]), ("grid_y", p["grid"][1]),
            ("grid_z", p["grid"][2]), ("threads", p["threads"]),
            ("smem", p["smem"]))
    return LaunchContract(
        name=name, regions=(region,), operands=ops, blocks=blocks,
        threads=p["threads"], cluster=p["cluster"], smem=p["smem"],
        reductions=(Reduction("o", "c", "cluster" if p["cluster"] > 1
                              else "none"),),
        mma=mma, limits=tuple(limits + lim), plan=plan,
        kernel="flash_tc_kernel" if mma else "flash_f32_kernel",
        kernel_args=(dc,))


@contract_builder("flash_attention")
def flash_contract(b: int, tq: int, tk: int, h: int, kvh: int, d: int, *,
                   causal: bool = True, window: Optional[int] = None,
                   dtype="bfloat16", cluster: int = 0, stages: int = 0,
                   sms: int = SMS) -> LaunchContract:
    """``flash_attention_launch`` (``flash_attention_plan``'s array),
    queries right-aligned to the keys."""
    return _flash_contract("flash_attention", b, tq, tk, h, kvh, d, tk - tq,
                           bool(causal), int(window or 0), dtype, cluster,
                           stages, sms, paged=False)


@contract_builder("paged_prefill_attention")
def paged_prefill_contract(tq: int, start: int, h: int, kvh: int, d: int, *,
                           window: Optional[int] = None, dtype="bfloat16",
                           sms: int = SMS) -> LaunchContract:
    """``paged_prefill_launch`` (``paged_prefill_plan``'s array): the flash
    kernels through the block-table loaders, one request, its own plan."""
    return _flash_contract("paged_prefill_attention", 1, tq, start + tq, h,
                           kvh, d, start, True, int(window or 0), dtype, 0, 0,
                           sms, paged=True)


def _split_contract(name, batch, h, kvh, d, splits, split, dtype,
                    extra_ops, paged):
    io = dt(dtype)
    # the plan's compiled head dim (it does not see the dtype; 16-bit
    # launches stop at 256)
    dc = compiled_head_dim(d) or HEAD_DIM_MAX
    rep = h // kvh
    rep_blk = 2 if dc > 256 else 4 if rep <= 4 else 8
    nz = cdiv(rep, rep_blk)
    groups = batch * kvh * nz
    partial = splits * groups * rep_blk * (dc + 2) if splits > 1 else 0
    vec = 16 // io[1]
    gsz = min(dc // vec, 32)
    ng = DS_WARPS * 32 // gsz
    smem = 4 * ng * rep_blk * (dc + 2)
    ops = (OperandSpec("q", (batch, kvh, rep, d), (1, 1, rep_blk, d), io,
                       predicated=(2,)),) + extra_ops + \
        (OperandSpec("o", (batch, kvh, rep, d), (1, 1, rep_blk, d), io,
                     output=True, predicated=(2,)),)
    maps = (("q", lambda s, b, kh, z: (b, kh, z, 0)),
            ("o", lambda s, b, kh, z: (b, kh, z, 0)))
    red = Reduction("o", "s", "ticket", tickets=groups, ticket_words=groups,
                    partial_words=partial) if splits > 1 else \
        Reduction("o", "s", "none")
    plan = (("splits", splits), ("groups", groups), ("rep", rep_blk),
            ("split_keys", split), ("partial_words", partial))
    return LaunchContract(
        name=name, regions=(Region((("s", splits), ("b", batch),
                                    ("kh", kvh), ("z", nz)), maps),),
        operands=ops, blocks=splits * groups, threads=DS_WARPS * 32,
        min_blocks=1, smem=smem,
        workspace_words=groups + partial if splits > 1 else 0,
        reductions=(red,), mma=(),
        limits=(Limit("head dim", d, 1, HEAD_DIM_MAX),
                Limit("query heads a multiple of kv heads",
                      int(kvh > 0 and h % kvh == 0), 1, 1)),
        plan=plan, kernel="decode_split_kernel", kernel_args=(dc,))


@contract_builder("decode_attention")
def decode_contract(b: int, s: int, h: int, kvh: int, d: int, pos: int, *,
                    window: Optional[int] = None,
                    dtype="bfloat16") -> LaunchContract:
    """``decode_attention_launch`` (``decode_attention_plan``'s array):
    exactly the live 64-key splits of the host's ``pos``."""
    window = int(window or 0)
    lo = pos - window + 1 if window > 0 and pos - window + 1 > 0 else 0
    hi = max(min(pos + 1, s), 0)
    live = hi - lo if hi > lo else 0
    splits = cdiv(live, DS_SPLIT) if live > 0 else 1
    io = dt(dtype)
    kv = OperandSpec("k", (b, s, kvh, d), (1, DS_SPLIT, 1, d), io,
                     ranged="the split's 64 live keys from the window's "
                            "first, clamped to pos + 1")
    return _split_contract("decode_attention", b, h, kvh, d, splits,
                           DS_SPLIT, dtype,
                           (kv, dataclasses.replace(kv, name="v")),
                           paged=False)


@contract_builder("paged_decode_attention")
def paged_decode_contract(slots: int, max_pages: int, page: int, h: int,
                          kvh: int, d: int, *, n_pages: int,
                          window: Optional[int] = None, dtype="bfloat16",
                          split_keys: int = 0) -> LaunchContract:
    """``paged_decode_launch`` (``paged_decode_plan``'s array): the most
    splits the table's reach or the window can make live."""
    window = int(window or 0)
    keys = DS_SPLIT if split_keys == 0 else split_keys
    reach = max_pages * page
    splits = cdiv(reach, max(keys, 1))
    if window > 0:
        splits = min(splits, cdiv(window, max(keys, 1)) + 1)
    splits = splits if splits > 1 else 1
    io = dt(dtype)
    note = ("K/V rows gathered through the slot's block table (device "
            "memory), dead pages never read past the slot's length")
    pool = OperandSpec("k_pool", (kvh, n_pages, page, d), (1, 1, page, d),
                       io, data_dependent=note)
    extra = (pool, dataclasses.replace(pool, name="v_pool"),
             OperandSpec("tables", (slots, max_pages), (1, max_pages), I32),
             OperandSpec("lengths", (slots,), (1,), I32))
    c = _split_contract("paged_decode_attention", slots, h, kvh, d, splits,
                        keys, dtype, extra, paged=True)
    maps = c.regions[0].maps + (
        ("tables", lambda s, b, kh, z: (b, 0)),
        ("lengths", lambda s, b, kh, z: (b,)))
    limits = c.limits + (
        Limit("keys a split", keys, DS_SPLIT_ALIGN, DS_MAX_SPLIT),
        Limit(f"keys a split a multiple of {DS_SPLIT_ALIGN}",
              keys % DS_SPLIT_ALIGN, 0, 0),
        Limit("pages", int(max_pages > 0 and page > 0), 1, 1))
    return dataclasses.replace(
        c, regions=(dataclasses.replace(c.regions[0], maps=maps),),
        limits=limits)


# ---------------------------------------------------------------------------
# ssd.cu: the chunked Mamba-2 SSD, one launch a chunk
# ---------------------------------------------------------------------------
def _round16(v):
    return (v + 15) & ~15


def _round4(v):
    return (v + 3) & ~3


def _ssd_smem(dtype_name, n, p):
    if dtype_name == "bfloat16":
        pp = max(p, 16)
        ldp, lds = pp + 8, pp + 4
        stage = 64 * (_round16(n) + 8) * 2 + 2 * 64 * ldp * 2
        region = max(2 * stage, 2 * _round16(n) * lds * 4)
        out = 6 * SSD_QMAX * 4 + 64 * (_round16(n) + 8) * 2 + region
        state = 2 * SSD_QMAX * 4 + 16 + SSD_QMAX * 72 * 2 + \
            SSD_QMAX * ldp * 2 + 4 * 16 * pp * 4
        return max(out, state)
    ldp = p + 4
    region = max(2 * (32 * (_round4(n) + 4) + 2 * 32 * ldp),
                 2 * _round4(n) * ldp)
    out = 6 * SSD_QMAX + 32 * (_round4(n) + 4) + 2 * 32 * 36 + region
    state = 2 * SSD_QMAX + 4 + 2 * (32 * 68 + 32 * ldp)
    return 4 * max(out, state)


def _ssd_chunk(dtype_name, t, h, g, n, chunk, t0, has_out):
    q = min(chunk, t - t0)
    hpg = h // g
    n_hs = g * ((hpg + 1) // 2)
    if dtype_name == "bfloat16":
        n_ns = cdiv(_round16(n), 64)
        n_rt = cdiv(q, 64)
        n_yblk = n_rt * n_hs
        n_state = n_ns * h if has_out else 0
        blocks = n_yblk + n_state
        rows = 64
    else:
        sr = 64 if n > 32 else 32
        n_ns = cdiv(n, sr)
        n_rt = cdiv(q, 32)
        n_yblk = 2 * n_rt * n_hs
        n_state = n_ns * h if has_out else 0
        blocks = n_yblk + ((n_state + 1) & ~1)
        rows = 32
    return dict(q=q, n_hs=n_hs, n_ns=n_ns, n_rt=n_rt, n_yblk=n_yblk,
                n_state=n_state, blocks=blocks, rows=rows,
                state_rows=64 if dtype_name == "bfloat16" or n > 32 else 32,
                sets=(hpg + 1) // 2)


@contract_builder("ssd")
def ssd_contract(bsz: int, t: int, h: int, g: int, n: int, p: int,
                 chunk: int, *, dtype="bfloat16",
                 initial_state: bool = False,
                 final_state: bool = False) -> LaunchContract:
    """``ssd_launch`` (``ssd_plan``'s array): one launch a chunk, the
    chunk as a launch axis (the wrapper's sub-chunks of at most
    ``SSD_QMAX`` rows). An output block writes one row tile of a head pair
    (``hpg`` odd: the pair's second head predicated off), the latest row
    tiles first; a state block one slice of N of one head; an fp32 output
    block is a cluster of two splitting the key tiles; the grid's z axis
    takes the head dim's column slices (the last predicated where the
    slice width does not divide P)."""
    name = _name(dtype)
    io = dt(dtype)
    limits = (Limit("state size", n, 1, SSD_NMAX),
              Limit("T, head dim and chunk positive",
                    int(min(t, p, chunk) >= 1), 1, 1),
              Limit("groups divide heads", int(g >= 1 and h % g == 0), 1, 1))
    chunk = min(chunk, t, SSD_QMAX)
    chunks = cdiv(t, chunk)
    hpg = h // max(g, 1)
    pc = ssd_slice_width(p) or SSD_P[-1]
    slices = cdiv(max(p, 1), pc)
    pred_p = (5,) if p % pc else ()
    geoms = [_ssd_chunk(name, t, h, g, n, chunk, c * chunk,
                        c < chunks - 1 or final_state)
             for c in range(chunks)]
    whole = _ssd_chunk(name, chunk, h, g, n, chunk, 0, True)
    sets = geoms[0]["sets"]
    rows = geoms[0]["rows"]
    fp32 = name != "bfloat16"
    q_last = geoms[-1]["q"]
    # y (and x) as whole chunks and the last chunk: (B, chunk, rows, group,
    # head of the group's pairs, P); a pair's second head is predicated
    # off where a group has an odd number of heads
    ops = []
    for nm, nchunks, q in (("y", chunks - 1, chunk), ("y_last", 1, q_last)):
        if nchunks:
            for src, out in (("x", False), ("", True)):
                ops.append(OperandSpec(
                    nm if out else src + nm[1:], (bsz, nchunks, q, g,
                                                  2 * sets, p),
                    (1, 1, rows, 1, 2, pc), io, output=out,
                    predicated=(2, 4) + pred_p))
    regions = []
    blocks = 0
    for last in (False, True):
        if not last and chunks == 1:
            continue
        geo = geoms[-1] if last else geoms[0]
        nch = 1 if last else chunks - 1
        n_rt = geo["n_rt"]
        out_axes = (("c", nch), ("rt", n_rt), ("bb", bsz), ("grp", g),
                    ("hp", sets), ("sl", slices)) + \
            ((("kk", 2),) if fp32 else ())

        def ymap(c, rt, bb, grp, hp, sl, *kk, n_rt=n_rt):
            return (bb, c, n_rt - 1 - rt, grp, hp, sl)
        nm = "y_last" if last else "y"
        regions.append(Region(out_axes, (("x" + nm[1:], ymap), (nm, ymap))))
        if geo["n_state"]:
            maps = (("state", lambda c, ns, bb, hh, sl: (bb, hh, ns, sl)),) \
                if last else ()
            regions.append(Region((("c", nch), ("ns", geo["n_ns"]),
                                   ("bb", bsz), ("hh", h), ("sl", slices)),
                                  maps))
        pad = geo["blocks"] - geo["n_yblk"] - geo["n_state"]
        if pad:
            regions.append(Region((("c", nch), ("idle", pad), ("bb", bsz),
                                   ("sl", slices))))
        blocks += geo["blocks"] * bsz * nch * slices
    if initial_state:
        ops.append(OperandSpec("s_in", (bsz, h, n, p), (1, 1, n, pc), F32,
                               ranged="the carried state of the block's "
                                      "heads and columns, read whole"))
    if final_state:
        ops.append(OperandSpec("state", (bsz, h, n, p),
                               (1, 1, geoms[-1]["state_rows"], pc), F32,
                               output=True, predicated=(2,) + tuple(
                                   3 for _ in pred_p)))
    if chunks > 1:
        ops.append(OperandSpec(
            "scratch", (2, bsz, h, n, p), (1, bsz, h, n, p), F32,
            data_dependent="the state between chunks: chunk c writes buffer "
                           "c % 2 and reads the other"))
    plan = (("chunks", chunks), ("threads", 128), ("smem",
                                                   _ssd_smem(name, n, pc)),
            ("cluster", 2 if fp32 else 1), ("out_blocks", whole["n_yblk"]),
            ("state_blocks", whole["n_state"] if not fp32
             else (whole["n_state"] + 1) & ~1),
            ("first_blocks", geoms[0]["blocks"]),
            ("last_blocks", geoms[-1]["blocks"]), ("rows", bsz),
            ("scratch_words", 2 * bsz * h * n * p if chunks > 1 else 0),
            ("slices", slices))
    reds = tuple(Reduction(o.name, "kk", "cluster") for o in ops
                 if fp32 and o.output and o.name.startswith("y"))
    return LaunchContract(
        name="ssd", regions=tuple(regions), operands=tuple(ops),
        blocks=blocks, threads=128, cluster=2 if fp32 else 1, min_blocks=1,
        smem=_ssd_smem(name, n, pc), reductions=reds,
        mma=() if fp32 else (MmaPair(io, io, F32),), limits=limits,
        launches=chunks, plan=plan,
        kernel="ssd_kernel" if fp32 else "ssd_tc_kernel", kernel_args=(pc,))
