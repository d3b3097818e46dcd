"""FLOP and byte costs of profiled dispatches (port of
``repro.obs.kernel_costs``).

The profiler (:mod:`repro_torch.obs.profile`) times ops at the
`ExecutionContext` dispatch boundary; this module supplies the other half
of a performance counter: how much *work* that call represents.

- **flops**: the JAX module's analytic formula per kernel family.
- **bytes**: what the JAX module derives from each kernel's one-block
  ``KernelContract`` (a degenerate schedule: one block per axis), written
  here as closed formulas since the port has no contracts: each affine
  operand touched once (the whole array, block-padded where the contract
  pads it), and block bytes x grid steps for operands gathered through a
  block table (the paged K/V pools). So the number is a roofline *lower
  bound* on traffic; the two modules give equal numbers at equal shapes.
- **peak**: the card's rate for the op's input dtype
  (:mod:`repro_torch.analysis.roofline`): the engine config's input for
  the GEMM family, the query's dtype for attention, x's for the SSD. On
  the H100 an fp32 op runs on the CUDA cores, so it is held to 67
  TFLOP/s, not to the tensor rate.

Joined with the profiler's timings this yields achieved-vs-roofline
utilization per kernel instantiation: the software analog of Gemmini's
hardware performance counters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.analysis.roofline import peak_ops


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Static work estimate for one dispatched op instantiation."""

    contract: str                 # kernel family (the JAX contract's name)
    flops: float
    bytes: float
    arith: str                    # "float" | "int"
    peak: float                   # the card's rate for the input dtype
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _gemm_contract_name(cfg, kw) -> str:
    df = kw.get("dataflow") or getattr(cfg, "dataflow", None)
    return "gemm_ws" if "WS" in str(getattr(df, "value", df)) else "gemm_os"


def _gemm_cost(cfg, kw, m: int, n: int, k: int, has_bias: bool):
    """(contract, bytes, arith, peak, grid) of the GEMM's one-block
    contract: A and B once, the D row (or the full (M, N) bias) at the
    accumulator's width, C once."""
    in_b = cfg.input_torch.itemsize
    acc_b = cfg.acc_torch.itemsize
    out_b = cfg.output_torch.itemsize
    name = _gemm_contract_name(cfg, kw)
    nbytes = float(m * k * in_b + k * n * in_b
                   + (m if has_bias else 1) * n * acc_b + m * n * out_b)
    grid = ({"j": 1, "i": 1, "kk": 1} if name == "gemm_ws"
            else {"i": 1, "j": 1, "kk": 1})
    arith = "float" if cfg.input_torch.is_floating_point else "int"
    return name, nbytes, arith, peak_ops(cfg.input_torch), grid


# -- per-op (args, kw, cfg) -> OpCost mappings --------------------------------

def _cost_gemm(args, kw, cfg) -> OpCost:
    a, b = args[0], args[1]
    d = args[2] if len(args) > 2 else kw.get("d")
    m, k = a.shape
    n = b.shape[1]
    name, nbytes, arith, peak, grid = _gemm_cost(cfg, kw, m, n, k,
                                                 d is not None)
    flops = 2.0 * m * n * k + (m * n if d is not None else 0.0)
    return OpCost(name, flops, nbytes, arith, peak,
                  {"grid": grid, "operands": 4})


def _cost_matmul(args, kw, cfg) -> OpCost:
    a, b = args[0], args[1]
    m = math.prod(a.shape[:-1])
    k = a.shape[-1]
    n = b.shape[-1]
    name, nbytes, arith, peak, grid = _gemm_cost(cfg, kw, m, n, k, False)
    return OpCost(name, 2.0 * m * n * k, nbytes, arith, peak,
                  {"grid": grid, "operands": 4})


def _cost_conv2d(args, kw, cfg) -> OpCost:
    x, w = args[0], args[1]
    b = args[2] if len(args) > 2 else kw.get("b")
    n, h, wd, ci = x.shape
    kh, kw_, _, co = w.shape
    stride = kw.get("stride", 1)
    padding = kw.get("padding", 0)
    oh = (h + 2 * padding - kh) // stride + 1
    ow = (wd + 2 * padding - kw_) // stride + 1
    # The padded input rows the taps reach, once; the filter, the bias at
    # the accumulator's width, the output.
    hp, wp = (oh - 1) * stride + kh, (ow - 1) * stride + kw_
    in_b = cfg.input_torch.itemsize
    nbytes = float(n * hp * wp * ci * in_b + kh * kw_ * ci * co * in_b
                   + (co * cfg.acc_torch.itemsize if b is not None else 0)
                   + n * oh * ow * co * cfg.output_torch.itemsize)
    flops = 2.0 * n * oh * ow * ci * co * kh * kw_
    arith = "float" if cfg.input_torch.is_floating_point else "int"
    return OpCost("conv2d_implicit", flops, nbytes, arith,
                  peak_ops(cfg.input_torch),
                  {"grid": {"nn": n, "cc": 1, "tt": kh * kw_},
                   "operands": 4 if b is not None else 3})


def _cost_flash_attention(args, kw, cfg) -> OpCost:
    q, k = args[0], args[1]
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    io = q.dtype.itemsize
    bq, bk = max(tq, 8), max(tk, 8)            # one block of each
    nbytes = float(2 * b * h * bq * d * io + 2 * b * kvh * bk * d * io)
    # QK^T and PV: 2 matmuls of (tq, tk) x d each, per batch x head.
    return OpCost("flash_attention", 4.0 * b * h * tq * tk * d, nbytes,
                  "float", peak_ops(q.dtype),
                  {"grid": {"bb": b, "hh": h, "i": 1, "j": 1},
                   "operands": 4})


def _cost_paged_attention(args, kw, cfg) -> OpCost:
    q, k_pool, block_tables = args[0], args[1], args[3]
    b, _, h, d = q.shape
    kvh, _, page, _ = k_pool.shape
    mp = block_tables.shape[1]
    io = q.dtype.itemsize
    steps = b * kvh * mp
    # q and o once; one K and one V page per grid step (gathered).
    nbytes = float(2 * b * kvh * (h // kvh) * d * io
                   + 2 * page * d * io * steps)
    # Table-capacity bound: the grid walks every table slot (dead pages
    # are clamp-elided on device but still deterministic work here).
    return OpCost("paged_decode_attention", 4.0 * b * h * (mp * page) * d,
                  nbytes, "float", peak_ops(q.dtype),
                  {"grid": {"bb": b, "hh": kvh, "j": mp}, "operands": 4})


def _cost_paged_prefill(args, kw, cfg) -> OpCost:
    q, k_pool, block_table = args[0], args[1], args[3]
    _, tq, h, d = q.shape
    _, _, page, _ = k_pool.shape
    mp = block_table.shape[0]
    kv_pages = kw.get("kv_pages")
    if kv_pages is not None:
        mp = min(mp, int(kv_pages))
    io = q.dtype.itemsize
    bq = max(tq, 8)
    nbytes = float(2 * h * bq * d * io + 2 * page * d * io * (h * mp))
    return OpCost("paged_prefill_attention", 4.0 * h * tq * (mp * page) * d,
                  nbytes, "float", peak_ops(q.dtype),
                  {"grid": {"hh": h, "i": 1, "j": mp}, "operands": 4})


def _cost_ssd(args, kw, cfg) -> OpCost:
    x, b = args[0], args[3]
    bsz, t, h, p = x.shape
    ngroups, n = b.shape[2], b.shape[3]
    q = min(kw.get("chunk", 256), t)
    nc = _cdiv(t, q)
    io = x.dtype.itemsize
    final = bool(kw.get("return_final_state"))
    # x, dt and y per chunk row at the model's width, a and d_skip per
    # head in fp32, B and C per group, the fp32 final state.
    nbytes = float(2 * bsz * h * nc * q * p * io + bsz * h * nc * q * io
                   + 2 * h * 4 + 2 * bsz * ngroups * nc * q * n * io
                   + (bsz * h * n * p * 4 if final else 0))
    # Per (batch, head, chunk): C@B^T (2q^2 n) + L@X (2q^2 p) + the two
    # state GEMMs B^T@X and C@state (2qnp each).
    per_chunk = 2.0 * q * q * n + 2.0 * q * q * p + 4.0 * q * n * p
    return OpCost("ssd", bsz * h * nc * per_chunk, nbytes, "float",
                  peak_ops(x.dtype),
                  {"grid": {"bb": bsz, "hh": h, "cc": nc},
                   "operands": 8 if final else 7})


_COST_FNS: Dict[str, Callable] = {
    "gemm": _cost_gemm,
    "matmul": _cost_matmul,
    "conv2d": _cost_conv2d,
    "flash_attention": _cost_flash_attention,
    "paged_attention": _cost_paged_attention,
    "paged_prefill_attention": _cost_paged_prefill,
    "ssd": _cost_ssd,
}


def op_cost(op: str, args: Tuple, kw: Dict[str, Any], cfg) -> Optional[OpCost]:
    """The op's cost at these call shapes, or None for ops with no
    registered cost mapping or shapes it cannot interpret (the profiler
    then reports timing only)."""
    fn = _COST_FNS.get(op)
    if fn is None:
        return None
    try:
        return fn(args, kw, cfg)
    except Exception:
        return None


def costed_ops() -> Tuple[str, ...]:
    return tuple(sorted(_COST_FNS))
