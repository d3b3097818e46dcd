"""The H100 kernels' schedule spaces (the port's counterpart of
``repro.tune.schedules``).

A schedule here is what a card kernel takes at run time in place of the
plan of its shape (``kernels/csrc``: the C plan functions re-validate it
and raise where the kernel cannot run it):

* GEMM (``kernels.gemm.gemm_plan`` / ``gemm_s8_plan``): ``{"tile",
  "splits"}``. bf16 / fp16: the skinny kernel for M <= 16 (its K splits),
  else ``hgemm.cuh``'s wide tiles 128 x 64, 128 x 128, 128 x 256 (and 64 x
  256 for M <= 64) x 1..``WD_MAX_SPLITS`` splits; int8 / int16: the skinny
  or square tiles x 1..``IGEMM_MAX_SPLITS``; fp32: ``sgemm.cuh``'s 64- or
  128-row tiles x 1..``SGEMM_MAX_SPLITS``.
* conv (``kernels.conv.conv_plan``): ``{"tile", "splits"}``: int8 / bf16 /
  fp16 take their ``igemm`` plan's tiles and splits; fp32 / int16 the
  CUDA-core loop's power-of-two splits (``cc_plan_of``), no split past
  ``CC_MAX_CHAIN`` k, as ``cc_plan`` keeps fp32's FMA chains.
* dense attention (``kernels.attention.flash_attention``): ``{"cluster",
  "stages"}``, blocks per cluster x K/V stages a warp (the card's
  counterpart of JAX's ``(block_q, block_k)``).
* paged attention: the page size, over JAX's lattice clamped to the
  context (allocation-coupled: the serving engine sizes its pools with it
  at startup), and the decode kernel's keys per split (its ``n_splits``).

In every space the shape's own plan is a candidate, ``{"tile": 0,
"splits": 0}`` (attention ``{"cluster": 0, "stages": 0}``, paged
``split_keys`` 0), and the tie order (``order``) is: that plan, then the
fewest waves, then the largest tile. Whether the kernel can take a
schedule is its launch contract's verdict (``kernels/contracts.py``,
``analysis/lint``), which the card holds to the C plan function's; only
cluster co-residency is left to the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.config import _DTYPES
from repro_torch.tune import cache as tcache

# The JAX package's static page and the decode kernel's keys per split
# (csrc/attention.cu DS_SPLIT).
DEFAULT_PAGE_SIZE = 64
DEFAULT_SPLIT_KEYS = 64
_PAGE_SIZES = (8, 16, 32, 64, 128, 256, 512)
_SPLIT_KEYS = (32, 64, 128, 256, 512)

# Kernel limits: the launch contracts' (kernels/contracts.py), the one
# place in Python that mirrors the csrc headers.
from repro_torch.kernels.contracts import (  # noqa: E402,F401
    CC_MAX_CHAIN, CC_MAX_SPLITS, CC_TILE, DS_MAX_SPLIT, DS_SPLIT_ALIGN,
    FLASH_CLUSTERS, FLASH_STAGES, HGEMM_BK, IGEMM_BK, IGEMM_MAX_SPLITS, IGEMM_TILES, MAX_TICKETS,
    SGEMM_BK, SGEMM_MAX_SPLITS, SGEMM_TILES, SK_MAX_SPLITS, WD_MAX_SPLITS,
    WIDE_TILES)

STATIC = {"tile": 0, "splits": 0}
FLASH_STATIC = {"cluster": 0, "stages": 0}
_INT = (torch.int8, torch.int16)
_CC = (torch.float32, torch.int16)      # the conv's CUDA-core loop


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def dtype_name(dtype) -> str:
    """The engine's short name of a torch dtype (or a name already)."""
    if isinstance(dtype, str):
        return dtype
    for name, dt in _DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"no engine datatype for {dtype}")


def schedule_dtype(dtype) -> torch.dtype:
    """A schedule's streamed dtype from a short name or a torch dtype."""
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------
def gemm_tiles(dtype: torch.dtype, m: int) -> Dict[int, Tuple[int, int]]:
    """Tile code -> (rows, columns) of the kernel ``dtype`` inputs run at
    M = m (bf16 / fp16: the skinny kernel's 16 x 64 nominal)."""
    if dtype in _INT:
        return dict(IGEMM_TILES)
    if dtype == torch.float32:
        return dict(SGEMM_TILES)
    if m <= 16:
        return {1: (16, 64)}
    return {c: t for c, t in WIDE_TILES.items() if c != 5 or m <= 64}


def gemm_ksteps(dtype: torch.dtype, k: int) -> int:
    """K steps of the kernel's loop (the splits' upper bound)."""
    if dtype in _INT:
        return max(1, _ceil_div(k * dtype.itemsize, IGEMM_BK))
    return max(1, _ceil_div(k, SGEMM_BK if dtype == torch.float32
                            else HGEMM_BK))


def gemm_max_splits(dtype: torch.dtype, m: int) -> int:
    if dtype in _INT:
        return IGEMM_MAX_SPLITS
    if dtype == torch.float32:
        return SGEMM_MAX_SPLITS
    return SK_MAX_SPLITS if m <= 16 else WD_MAX_SPLITS


def gemm_legal(dtype: torch.dtype, m: int, n: int, k: int,
               sched: Dict[str, int], b_trans: bool = False) -> bool:
    """Whether the GEMM kernel of ``dtype`` inputs can take ``sched`` at
    (M, N, K), B row-major or (``b_trans``) read transposed: a tile of the
    space at M (:func:`gemm_tiles`) whose launch contract the lint admits
    (``analysis/lint/feasibility.py``; the card's C plan function gives
    the same verdict, apart from cluster co-residency)."""
    from repro_torch.analysis.lint import feasibility
    tile, splits = sched["tile"], sched["splits"]
    if (tile, splits) == (0, 0):
        return True
    if tile not in gemm_tiles(dtype, m):
        return False
    return feasibility.gemm_plan_feasible(dtype, m, n, k, sched,
                                          b_trans=b_trans)


def enumerate_gemm_schedules(dtype: torch.dtype, m: int, n: int, k: int,
                             b_trans: bool = False) -> List[Dict[str, int]]:
    """The shape's own plan, then every legal (tile, splits): the skinny
    kernel's splits in powers of two, else each tile at every split."""
    out = [dict(STATIC)]
    most = min(gemm_max_splits(dtype, m), gemm_ksteps(dtype, k))
    skinny = dtype not in _INT and dtype != torch.float32 and m <= 16
    counts = [s for s in (1, 2, 4, 8, 16, 32) if s <= most] if skinny \
        else list(range(1, most + 1))
    for tile in gemm_tiles(dtype, m):
        for s in counts:
            sched = {"tile": tile, "splits": s}
            if gemm_legal(dtype, m, n, k, sched, b_trans):
                out.append(sched)
    return out


def gemm_cache_key(dtypes, ws: bool, m: int, n: int, k: int, has_bias: bool,
                   b_trans: bool, device=None) -> str:
    """The GEMM schedule's fingerprint (``cache.fingerprint``): dtypes
    (input, accumulator, output) as names or torch dtypes."""
    from repro_torch.core.config import Dataflow
    return tcache.fingerprint(tuple(dtype_name(d) for d in dtypes),
                              Dataflow.WS if ws else Dataflow.OS, m, n, k,
                              has_bias, b_trans=b_trans,
                              device=None if device is None else str(device))


# ---------------------------------------------------------------------------
# conv (implicit im2col)
# ---------------------------------------------------------------------------
def conv_dims(h: int, w: int, kh: int, kw: int, stride: int,
              padding: int) -> Tuple[int, int]:
    return ((h + 2 * padding - kh) // stride + 1,
            (w + 2 * padding - kw) // stride + 1)


def conv_legal(dtype: torch.dtype, m: int, n: int, k: int,
               sched: Dict[str, int]) -> bool:
    """Whether the conv kernel of ``dtype`` inputs can take ``sched`` for
    the implicit GEMM (M, N, K): its launch contract is admitted."""
    from repro_torch.analysis.lint import feasibility
    if (sched["tile"], sched["splits"]) == (0, 0):
        return True
    return feasibility.conv_plan_feasible(dtype, m, n, k, sched)


def enumerate_conv_schedules(dtype: torch.dtype, m: int, n: int,
                             k: int) -> List[Dict[str, int]]:
    """The shape's own plan, then the tensor-core loop's (tile, splits) as
    for the GEMM (16-bit images read as bytes), or the CUDA-core loop's
    power-of-two splits whose chains stay within ``CC_MAX_CHAIN`` k."""
    if dtype not in _CC:
        space = enumerate_gemm_schedules(
            torch.int8 if dtype == torch.int8 else torch.int16, m, n, k)
        return [s for s in space if conv_legal(dtype, m, n, k, s)]
    out = [dict(STATIC)]
    ksteps = max(1, _ceil_div(k, SGEMM_BK))
    s = 1
    while s <= min(CC_MAX_SPLITS, ksteps):
        sched = {"tile": 1, "splits": s}
        if _ceil_div(ksteps, s) * SGEMM_BK <= CC_MAX_CHAIN and \
                conv_legal(dtype, m, n, k, sched):
            out.append(sched)
        s *= 2
    return out


def conv_cache_key(dtypes, n: int, h: int, w: int, ci: int, co: int,
                   kh: int, kw: int, *, stride: int, padding: int,
                   has_bias: bool, device=None) -> str:
    payload = {
        "nhwc": [int(n), int(h), int(w), int(ci)],
        "co": int(co), "khw": [int(kh), int(kw)],
        "stride": int(stride), "pad": int(padding),
        "bias": bool(has_bias),
        "dtypes": [dtype_name(d) for d in dtypes],
    }
    return tcache.kernel_fingerprint(
        "conv", None, payload, device=None if device is None else str(device))


# ---------------------------------------------------------------------------
# attention (flash: dense, a fresh prompt or first chunk)
# ---------------------------------------------------------------------------
def enumerate_attn_schedules(dtype: torch.dtype,
                             d: int) -> List[Dict[str, int]]:
    """The call's own plan, then blocks per cluster x stages (fp32 at head
    dim 256 streams one stage: its shared memory)."""
    from repro_torch.kernels.contracts import flash_max_stages
    stages = FLASH_STAGES[:flash_max_stages(dtype, d)]
    return [dict(FLASH_STATIC)] + [{"cluster": c, "stages": s}
                                   for c in FLASH_CLUSTERS for s in stages]


def attn_legal(dtype: torch.dtype, d: int, sched: Dict[str, int]) -> bool:
    return sched in enumerate_attn_schedules(dtype, d)


def attn_cache_key(b: int, tq: int, tk: int, h: int, kvh: int, d: int, *,
                   causal: bool, window: Optional[int], dtype,
                   device=None) -> str:
    """As ``repro.tune.schedules.attn_cache_key``: shape, GQA grouping,
    masking and the streamed dtype (softcap is elementwise: excluded)."""
    payload = {
        "b": int(b), "tq": int(tq), "tk": int(tk),
        "h": int(h), "kvh": int(kvh), "d": int(d),
        "causal": bool(causal),
        "win": int(window) if window else 0,
        "dtype": dtype_name(schedule_dtype(dtype)),
    }
    return tcache.kernel_fingerprint(
        "attn", None, payload, device=None if device is None else str(device))


# ---------------------------------------------------------------------------
# paged attention (serving decode)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PagedAttnSchedule:
    """The KV page size (allocation-coupled: baked into the engine's pools
    at startup) and the paged decode kernel's keys per split (0: its own,
    ``DEFAULT_SPLIT_KEYS``)."""

    page_size: int
    split_keys: int = 0

    def effective(self, max_context: int) -> "PagedAttnSchedule":
        return PagedAttnSchedule(max(8, min(self.page_size, max_context)),
                                 self.split_keys)


def default_paged_schedule() -> PagedAttnSchedule:
    return PagedAttnSchedule(DEFAULT_PAGE_SIZE)


def paged_page_sizes(max_context: int) -> List[int]:
    """JAX's page lattice clamped to the context, deduplicated, ascending."""
    return sorted({PagedAttnSchedule(p).effective(max_context).page_size
                   for p in _PAGE_SIZES})


def enumerate_paged_schedules(max_context: int) -> List[PagedAttnSchedule]:
    """The static page with the kernel's own split, then every page of the
    lattice at every keys-per-split."""
    static = default_paged_schedule().effective(max_context)
    out = [static]
    for p in paged_page_sizes(max_context):
        for s in _SPLIT_KEYS:
            if (p, s) != (static.page_size, DEFAULT_SPLIT_KEYS):
                out.append(PagedAttnSchedule(p, s))
    return out


def paged_legal(sched: PagedAttnSchedule, max_context: int) -> bool:
    """A page of the lattice, and keys per split the decode kernel takes:
    its own (0), or a multiple of ``DS_SPLIT_ALIGN`` up to
    ``DS_MAX_SPLIT``. The problem's own verdict is the tuner's filter."""
    k = sched.split_keys
    return sched.page_size in paged_page_sizes(max_context) and (
        k == 0 or (0 < k <= DS_MAX_SPLIT and k % DS_SPLIT_ALIGN == 0))


def paged_attn_cache_key(b: int, h: int, kvh: int, d: int, max_context: int,
                         *, window: Optional[int], dtype,
                         device=None) -> str:
    payload = {
        "b": int(b), "h": int(h), "kvh": int(kvh), "d": int(d),
        "ctx": int(max_context),
        "win": int(window) if window else 0,
        "dtype": dtype_name(schedule_dtype(dtype)),
    }
    return tcache.kernel_fingerprint(
        "paged_attn", None, payload,
        device=None if device is None else str(device))


# ---------------------------------------------------------------------------
# the tie order
# ---------------------------------------------------------------------------
def order(is_static: bool, blocks: int, sms: int, tile_size: int) -> tuple:
    """The deterministic order among tied candidates: the shape's own plan,
    then the fewest waves of blocks over the SMs, then the largest tile."""
    return (not is_static, _ceil_div(blocks, max(1, sms)), -tile_size)
