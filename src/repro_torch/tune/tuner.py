"""The kernel-schedule tuner on the H100 (port of ``repro.tune.tuner``).

The ``resolve_*`` functions are what the kernels' dispatch consults on a
launch that names no plan: ``resolve_plan`` for the engine GEMM (the
backward products included), ``resolve_conv_schedule`` for the fused
conv, ``resolve_attn_schedule`` for flash attention, and
``resolve_paged_attn_schedule`` for the serving engine's page size and
decode split (once, at startup). All honor the process flag
``tune_mode`` (``GEMMINI_TUNE``):

* ``off``    -- the kernels' own plans; the wrappers never import this
                module.
* ``cached`` -- the persisted schedule if one exists, the kernel's own
                plan otherwise; never measures.
* ``full``   -- a cache hit, else measure the space on the card (the
                plain version once on the CPU), pick the winner, persist
                it.

Winner selection is measurement-led but deterministic: candidates whose
min-of-iters time is within ``TIE_BAND`` of the best are tied, and ties
break by ``schedules.order``: the shape's own plan, then the fewest
waves, then the largest tile. On the CPU every candidate shares the plain
version's one timing, so the shape's own plan wins, every run.

The wrappers reach the tuner through ``gemm_schedule``, ``conv_schedule``
and ``attn_schedule`` (dtype-level; the ``resolve_*`` functions take a
config, as JAX's do, and call them), which keep each shape's resolution
in ``cache.resolved``: after the first call a launch pays one dict
lookup. Every ``tune_*`` returns a :class:`TuneReport`.

Each candidate faces the launch-contract lint once before it is
measured (``analysis/lint/feasibility.py``). The GEMM and conv spaces are
enumerated through it (``schedules.gemm_legal`` / ``conv_legal``); the
attention and paged spaces, which do not depend on the problem, go through
:func:`_contract_filter` at the problem's shape: the shape's own plan
always stays, a predicate that fails keeps its candidate, and a filter
that would leave nothing keeps the whole space.
JAX's ``tuned_plan_fn`` (the DSE's measured-cost hook, a Gemmini
``TilePlan`` the card never runs) is not ported (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.lint import feasibility
from repro_torch.core import flags
from repro_torch.core.config import Dataflow, GemminiConfig
from repro_torch.core.tiling import _resolve_dataflow
from repro_torch.tune import cache as tcache
from repro_torch.tune import measure, schedules
from repro_torch.tune.cache import PlanCache, get_cache
from repro_torch.tune.schedules import PagedAttnSchedule

# Measured times within 5% of the best are a tie -> the tie order decides.
TIE_BAND = 0.05


def _contract_filter(cands, keep_pred, feasible):
    """Drop the candidates the launch-contract lint proves infeasible.

    Strictly advisory, as the JAX tuner's: the shape's own plan
    (``keep_pred``) is always kept (winner selection reads it first), a
    predicate that raises keeps its candidate, and if the filter would
    leave nothing the original list survives."""
    kept = []
    for c in cands:
        try:
            ok = keep_pred(c) or feasible(c)
        except Exception:
            ok = True
        if ok:
            kept.append(c)
    return kept if kept else list(cands)


def _is_first(cands):
    first = cands[0] if cands else None
    return lambda c: c is first


def _check_mode() -> str:
    mode = flags.get("tune_mode")
    if mode not in flags.TUNE_MODES:
        raise ValueError(f"GEMMINI_TUNE/tune_mode must be one of "
                         f"{flags.TUNE_MODES}, got {mode!r}")
    return mode


def _tie_pick(results, key_fn):
    """Measurement-led, deterministically tie-broken winner selection: the
    candidates within TIE_BAND of the best min-of-iters time are tied and
    ``key_fn`` provides a total order among them."""
    best_us = min(r.min_us for r in results)
    tied = [r for r in results if r.min_us <= best_us * (1.0 + TIE_BAND)]
    return min(tied, key=key_fn)


def _device(device) -> torch.device:
    """``device``, or the card where there is one, else the CPU; a CUDA
    device always with its index."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class CandidateResult:
    """One measured candidate: its schedule, times, the card plan's blocks
    and tile size (0 on the CPU) and its place in the tie order."""

    sched: object
    min_us: float
    mean_us: float
    order: tuple
    is_static: bool


@dataclasses.dataclass(frozen=True)
class TuneReport:
    """One shape's measured space: the winner's schedule (``{"tile",
    "splits"}``, ``{"cluster", "stages"}`` or a :class:`PagedAttnSchedule`),
    every candidate, and the shape's own plan's result (``static``)."""

    winner: object
    candidates: Tuple[CandidateResult, ...]
    static: CandidateResult
    backend: str
    cache_key: str = ""

    @property
    def speedup_vs_static(self) -> float:
        best = min(c.min_us for c in self.candidates)
        return self.static.min_us / best if best else 1.0


def _report(results: List[CandidateResult], winner: CandidateResult,
            dev, key: str) -> TuneReport:
    sched = winner.sched
    return TuneReport(winner=dict(sched) if isinstance(sched, dict)
                      else sched, candidates=tuple(results),
                      static=results[0],
                      backend=measure.measurement_backend(dev),
                      cache_key=key)


def _measure_space(cands: List, run: Callable, info: Callable, dev,
                   label: str, iters: int) -> List[CandidateResult]:
    """Time each candidate (``run(sched)``) on the card, or the plain
    version once for all on the CPU; ``info(sched)`` gives (blocks, tile
    size) of the card plan, or raises where the card cannot run it (the
    candidate is dropped)."""
    sms = tcache.card(str(dev))[1]
    plain = None
    if dev.type != "cuda":
        plain = measure.time_callable(run, None, iters=iters, device=dev,
                                      label=f"{label}/plain")
    out = []
    for i, sched in enumerate(cands):
        static = i == 0
        if dev.type == "cuda":
            try:
                blocks, size = info(sched)
            except RuntimeError:
                continue
            t = measure.time_callable(run, sched, iters=iters, device=dev,
                                      label=f"{label}/{sched}")
        else:
            blocks, size, t = 0, 0, plain
        out.append(CandidateResult(
            sched=sched, min_us=t["min_us"], mean_us=t["mean_us"],
            order=schedules.order(static, blocks, sms, size),
            is_static=static))
    return out


def _dedupe(cands: List, same_as_static: Callable) -> List:
    """The shape's own plan first, and no other candidate that is the same
    launch (on the card: ``same_as_static``)."""
    return cands[:1] + [c for c in cands[1:] if not same_as_static(c)]


def _memoized(key: tuple, resolve: Callable[[str], Dict[str, int]],
              own: str) -> Optional[Dict[str, int]]:
    """The wrappers' entry: ``key`` (the mode first, then the shape) looked
    up in ``cache.resolved``, else ``resolve(mode)`` stored there; None
    where the schedule is the kernel's own plan (its ``own`` field 0)."""
    try:
        return tcache.resolved[key]
    except KeyError:
        pass
    sched = None
    if key[0] != "off":
        sched = resolve(_check_mode())
        sched = sched if sched[own] else None
    tcache.resolved[key] = sched
    return sched


def _store(cache: PlanCache, key: str, params: Dict[str, int], winner,
           default, n: int, dev, persist: bool) -> str:
    return cache.store_schedule(
        key, params, source="measured" if dev.type == "cuda" else "plain",
        best_us=winner.min_us, greedy_us=default.min_us, n_candidates=n,
        persist=persist)


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------
def _gemm_info(in_dt, m, n, k, b_trans, dev):
    from repro_torch.kernels import gemm as kg

    def info(sched):
        kw = dict(tile=sched["tile"], splits=sched["splits"])
        p = kg.gemm_s8_plan(m, n, k, b_trans, dev, **kw) \
            if in_dt == torch.int8 else \
            kg.gemm_plan(m, n, k, b_trans, dev, in_dt, **kw)
        return p["grid"], p["tile"][0] * p["tile"][1]
    return info


def _tune_gemm(dtypes, ws: bool, m: int, n: int, k: int, has_bias: bool,
               b_trans: bool, dev, *, iters: int = 5,
               cache: Optional[PlanCache] = None,
               persist: bool = True) -> TuneReport:
    in_dt = dtypes[0]
    cands = schedules.enumerate_gemm_schedules(in_dt, m, n, k, b_trans)
    info = _gemm_info(in_dt, m, n, k, b_trans, dev)
    if dev.type == "cuda":
        from repro_torch.kernels import gemm as kg
        p = kg.gemm_s8_plan(m, n, k, b_trans, dev) if in_dt == torch.int8 \
            else kg.gemm_plan(m, n, k, b_trans, dev, in_dt)
        cands = _dedupe(cands, lambda s: (s["tile"], s["splits"]) ==
                        (p["tile_code"], p["splits"]))
    run = measure.gemm_case(dtypes, ws, m, n, k, has_bias, b_trans, dev)
    results = _measure_space(cands, run, info, dev,
                             f"gemm[{m}x{n}x{k}]", iters)
    winner = _tie_pick(results, lambda r: r.order)
    key = schedules.gemm_cache_key(dtypes, ws, m, n, k, has_bias, b_trans,
                                   dev)
    key = _store(cache or get_cache(), key, winner.sched, winner,
                 results[0], len(results), dev, persist)
    return _report(results, winner, dev, key)


def _cfg_dtypes(cfg: GemminiConfig, in_fp32: bool = False):
    return (torch.float32 if in_fp32 else cfg.input_torch, cfg.acc_torch,
            cfg.output_torch)


def tune_gemm(cfg: GemminiConfig, m: int, n: int, k: int, *,
              dataflow: Optional[Dataflow] = None, has_bias: bool = False,
              b_trans: bool = False, in_fp32: bool = False, device=None,
              iters: int = 5, cache: Optional[PlanCache] = None,
              persist: bool = True) -> TuneReport:
    """Measure the GEMM's schedule space for ``cfg``'s datapath (``in_fp32``:
    fp32 inputs, the MoE router's) and persist the winner."""
    ws = _resolve_dataflow(cfg, dataflow) is Dataflow.WS
    return _tune_gemm(_cfg_dtypes(cfg, in_fp32), ws, m, n, k, has_bias,
                      b_trans, _device(device), iters=iters, cache=cache,
                      persist=persist)


def resolve_plan(cfg: GemminiConfig, m: int, n: int, k: int, *,
                 dataflow: Optional[Dataflow] = None, has_bias: bool = False,
                 b_trans: bool = False, in_fp32: bool = False,
                 device=None) -> Dict[str, int]:
    """The GEMM schedule to launch now, honoring the ``tune_mode`` flag:
    ``{"tile", "splits"}``, both 0 for the shape's own plan."""
    if _check_mode() == "off":
        return dict(schedules.STATIC)
    ws = _resolve_dataflow(cfg, dataflow) is Dataflow.WS
    in_dt, acc_dt, out_dt = _cfg_dtypes(cfg, in_fp32)
    sched = gemm_schedule(in_dt, acc_dt, out_dt, ws, m, n, k, has_bias,
                          b_trans, _device(device))
    return dict(sched or schedules.STATIC)


def gemm_schedule(in_dt, acc_dt, out_dt, ws: bool, m: int, n: int, k: int,
                  has_bias: bool, b_trans: bool,
                  device) -> Optional[Dict[str, int]]:
    """The GEMM wrapper's entry (and :func:`resolve_plan`'s, so a warm pass
    fills it): this shape's resolved schedule, None for its own plan;
    resolved once per mode and shape: the persisted entry (re-validated),
    else the own plan under ``cached``, else tuned."""
    def resolve(mode):
        dtypes, dev = (in_dt, acc_dt, out_dt), _device(device)
        key = schedules.gemm_cache_key(dtypes, ws, m, n, k, has_bias,
                                       b_trans, dev)
        if dev.type == "cuda":
            valid = _gemm_info(in_dt, m, n, k, b_trans, dev)
        else:
            def valid(p):
                return schedules.gemm_legal(in_dt, m, n, k, p, b_trans)
        hit = get_cache().lookup_checked(key, ("tile", "splits"), valid)
        if hit is not None:
            return hit
        if mode == "cached":
            return dict(schedules.STATIC)
        return _tune_gemm(dtypes, ws, m, n, k, has_bias, b_trans,
                          dev).winner

    key = (flags.get("tune_mode"), "gemm", in_dt, acc_dt, out_dt, ws, m, n,
           k, has_bias, b_trans, device.type, device.index)
    return _memoized(key, resolve, "tile")


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------
def _conv_info(in_dt, m, n, k, dev):
    from repro_torch.kernels import conv as kc

    def info(sched):
        p = kc.conv_plan(m, n, k, in_dt, dev, tile=sched["tile"],
                         splits=sched["splits"])
        return p["grid"], p["tile"][0] * p["tile"][1]
    return info


def _conv_mnk(n, h, w, ci, co, kh, kw, stride, padding):
    oh, ow = schedules.conv_dims(h, w, kh, kw, stride, padding)
    return n * oh * ow, co, kh * kw * ci


def _tune_conv(dtypes, n, h, w, ci, co, kh, kw, stride, padding, has_bias,
               dev, *, iters: int = 5, cache: Optional[PlanCache] = None,
               persist: bool = True) -> TuneReport:
    in_dt = dtypes[0]
    m, nn, k = _conv_mnk(n, h, w, ci, co, kh, kw, stride, padding)
    cands = schedules.enumerate_conv_schedules(in_dt, m, nn, k)
    info = _conv_info(in_dt, m, nn, k, dev)
    if dev.type == "cuda":
        from repro_torch.kernels import conv as kc
        p = kc.conv_plan(m, nn, k, in_dt, dev)
        cands = _dedupe(cands, lambda s: (s["tile"], s["splits"]) ==
                        (p["tile_code"], p["splits"]))
    run = measure.conv_case(dtypes, n, h, w, ci, co, kh, kw, stride, padding,
                            has_bias, dev)
    results = _measure_space(cands, run, info, dev,
                             f"conv[{n}x{h}x{w}x{ci}->{co} {kh}x{kw}"
                             f"/{stride}]", iters)
    winner = _tie_pick(results, lambda r: r.order)
    key = schedules.conv_cache_key(dtypes, n, h, w, ci, co, kh, kw,
                                   stride=stride, padding=padding,
                                   has_bias=has_bias, device=dev)
    key = _store(cache or get_cache(), key, winner.sched, winner,
                 results[0], len(results), dev, persist)
    return _report(results, winner, dev, key)


def tune_conv(cfg: GemminiConfig, n: int, h: int, w: int, ci: int, co: int,
              kh: int, kw: int, *, stride: int = 1, padding: int = 0,
              has_bias: bool = False, device=None, iters: int = 5,
              cache: Optional[PlanCache] = None,
              persist: bool = True) -> TuneReport:
    """Measure the fused conv's schedule space at ``cfg``'s datapath and
    persist the winner."""
    return _tune_conv(_cfg_dtypes(cfg), n, h, w, ci, co, kh, kw, stride,
                      padding, has_bias, _device(device), iters=iters,
                      cache=cache, persist=persist)


def resolve_conv_schedule(cfg: GemminiConfig, n: int, h: int, w: int,
                          ci: int, co: int, kh: int, kw: int, *,
                          stride: int = 1, padding: int = 0,
                          has_bias: bool = False,
                          device=None) -> Dict[str, int]:
    """The fused conv's schedule to launch now, honoring ``tune_mode``."""
    if _check_mode() == "off":
        return dict(schedules.STATIC)
    in_dt, _, out_dt = _cfg_dtypes(cfg)
    sched = conv_schedule(in_dt, out_dt, n, h, w, ci, co, kh, kw, stride,
                          padding, has_bias, _device(device))
    return dict(sched or schedules.STATIC)


def conv_schedule(in_dt, out_dt, n, h, w, ci, co, kh, kw, stride, padding,
                  has_bias: bool, device) -> Optional[Dict[str, int]]:
    """The conv wrapper's entry, as :func:`gemm_schedule`."""
    def resolve(mode):
        acc = torch.int32 if in_dt in (torch.int8, torch.int16) \
            else torch.float32
        dtypes, dev = (in_dt, acc, out_dt), _device(device)
        key = schedules.conv_cache_key(dtypes, n, h, w, ci, co, kh, kw,
                                       stride=stride, padding=padding,
                                       has_bias=has_bias, device=dev)
        m, nn, k = _conv_mnk(n, h, w, ci, co, kh, kw, stride, padding)
        if dev.type == "cuda":
            valid = _conv_info(in_dt, m, nn, k, dev)
        else:
            def valid(p):
                return schedules.conv_legal(in_dt, m, nn, k, p)
        hit = get_cache().lookup_checked(key, ("tile", "splits"), valid)
        if hit is not None:
            return hit
        if mode == "cached":
            return dict(schedules.STATIC)
        return _tune_conv(dtypes, n, h, w, ci, co, kh, kw, stride, padding,
                          has_bias, dev).winner

    key = (flags.get("tune_mode"), "conv", in_dt, out_dt, n, h, w, ci, co,
           kh, kw, stride, padding, has_bias, device.type, device.index)
    return _memoized(key, resolve, "tile")


# ---------------------------------------------------------------------------
# attention (flash)
# ---------------------------------------------------------------------------
def _attn_info(b, tq, tk, h, kvh, d, causal, window, dtype, dev):
    from repro_torch.kernels import attention as ka
    row_tiles = -(-tq // 16) * h * b if dtype == torch.bfloat16 else \
        -(-(tq * (h // kvh)) // 16) * kvh * b

    def info(sched):
        if not schedules.attn_legal(dtype, d, sched):
            raise RuntimeError(f"flash schedule {sched} not in the space")
        cl = sched["cluster"] or ka.flash_plan(
            b, tq, tk, h, kvh, d, causal=causal, window=window, dtype=dtype,
            device=dev)["cluster"]
        return cl * row_tiles, cl
    return info


def _tune_attention(b, tq, tk, h, kvh, d, causal, window, dtype, dev, *,
                    iters: int = 5, cache: Optional[PlanCache] = None,
                    persist: bool = True) -> TuneReport:
    dtype = schedules.schedule_dtype(dtype)
    cands = schedules.enumerate_attn_schedules(dtype, d)
    cands = _contract_filter(
        cands, _is_first(cands),
        lambda s: feasibility.attn_schedule_feasible(
            s, b=b, tq=tq, tk=tk, h=h, kvh=kvh, d=d, causal=causal,
            window=window, dtype=dtype))
    if dev.type == "cuda":
        from repro_torch.kernels import attention as ka
        own = ka.flash_plan(b, tq, tk, h, kvh, d, causal=causal,
                            window=window, dtype=dtype, device=dev)
        cands = _dedupe(cands, lambda s: (s["cluster"], s["stages"]) ==
                        (own["cluster"], own["stages"]))
    info = _attn_info(b, tq, tk, h, kvh, d, causal, window, dtype, dev)
    run = measure.attn_case(b, tq, tk, h, kvh, d, causal, window, dtype, dev)
    results = _measure_space(cands, run, info, dev,
                             f"attn[{b}x{tq}x{tk} h{h}/{kvh} d{d}]", iters)
    winner = _tie_pick(results, lambda r: r.order)
    key = schedules.attn_cache_key(b, tq, tk, h, kvh, d, causal=causal,
                                   window=window, dtype=dtype, device=dev)
    key = _store(cache or get_cache(), key, winner.sched, winner,
                 results[0], len(results), dev, persist)
    return _report(results, winner, dev, key)


def tune_attention(cfg: Optional[GemminiConfig], b: int, tq: int, tk: int,
                   h: int, kvh: int, d: int, *, causal: bool = True,
                   window: Optional[int] = None, dtype="bf16", device=None,
                   iters: int = 5, cache: Optional[PlanCache] = None,
                   persist: bool = True) -> TuneReport:
    """Measure flash attention's (cluster, stages) space and persist the
    winner (``cfg`` is not consulted: the card kernel reads no Gemmini
    budget)."""
    return _tune_attention(b, tq, tk, h, kvh, d, causal, window, dtype,
                           _device(device), iters=iters, cache=cache,
                           persist=persist)


def resolve_attn_schedule(cfg: Optional[GemminiConfig], b: int, tq: int,
                          tk: int, h: int, kvh: int, d: int, *,
                          causal: bool = True, window: Optional[int] = None,
                          dtype="bf16", device=None) -> Dict[str, int]:
    """Flash attention's schedule to launch now, honoring ``tune_mode``:
    ``{"cluster", "stages"}``, both 0 for the call's own plan."""
    if _check_mode() == "off":
        return dict(schedules.FLASH_STATIC)
    sched = attn_schedule(b, tq, tk, h, kvh, d, causal, window,
                          schedules.schedule_dtype(dtype), _device(device))
    return dict(sched or schedules.FLASH_STATIC)


def attn_schedule(b, tq, tk, h, kvh, d, causal, window, dtype,
                  device) -> Optional[Dict[str, int]]:
    """The flash wrapper's entry, as :func:`gemm_schedule`."""
    window = int(window or 0) or None

    def resolve(mode):
        dt, dev = schedules.schedule_dtype(dtype), _device(device)
        key = schedules.attn_cache_key(b, tq, tk, h, kvh, d, causal=causal,
                                       window=window, dtype=dt, device=dev)
        hit = get_cache().lookup_checked(
            key, ("cluster", "stages"),
            lambda p: schedules.attn_legal(dt, d, p))
        if hit is not None:
            return hit
        if mode == "cached":
            return dict(schedules.FLASH_STATIC)
        return _tune_attention(b, tq, tk, h, kvh, d, causal, window, dt,
                               dev).winner

    key = (flags.get("tune_mode"), "attn", b, tq, tk, h, kvh, d,
           bool(causal), window, dtype, device.type, device.index)
    return _memoized(key, resolve, "cluster")


# ---------------------------------------------------------------------------
# paged attention (the serving engine's page size and decode split)
# ---------------------------------------------------------------------------
def tune_paged_attention(cfg: Optional[GemminiConfig], b: int, h: int,
                         kvh: int, d: int, max_context: int, *,
                         window: Optional[int] = None, dtype="bf16",
                         device=None, iters: int = 5,
                         cache: Optional[PlanCache] = None,
                         persist: bool = True) -> TuneReport:
    """Measure the (page size, keys per split) space of the paged decode
    kernel at a full-context decode batch (the worst-case step the engine
    must sustain, as JAX measures it) and persist the winner."""
    from repro_torch.kernels import attention as ka
    dev = _device(device)
    dtype = schedules.schedule_dtype(dtype)
    sms = tcache.card(str(dev))[1]
    cands = schedules.enumerate_paged_schedules(max_context)
    cands = _contract_filter(
        cands, _is_first(cands),
        lambda s: feasibility.paged_schedule_feasible(
            s, b=b, h=h, kvh=kvh, d=d, max_context=max_context,
            window=window, dtype=dtype))
    plain = None
    results: List[CandidateResult] = []
    cases: Dict[int, Callable] = {}
    for i, s in enumerate(cands):
        if dev.type == "cuda":
            mp = -(-max_context // s.page_size)
            grid = ka.paged_decode_plan(b, mp, s.page_size, h, kvh, d,
                                        window, split_keys=s.split_keys)
            if s.page_size not in cases:
                cases = {s.page_size: measure.paged_case(
                    b, h, kvh, d, max_context, s.page_size, window, dtype,
                    dev)}
            t = measure.time_callable(
                cases[s.page_size], {"split_keys": s.split_keys},
                iters=iters, device=dev,
                label=f"paged[page={s.page_size},split={s.split_keys}]")
            blocks = grid[0] * grid[1]
        else:
            if plain is None:
                plain = measure.time_callable(
                    measure.paged_case(b, h, kvh, d, max_context,
                                       s.page_size, window, dtype, dev),
                    None, iters=iters, device=dev, label="paged/plain")
            t, blocks = plain, 0
        results.append(CandidateResult(
            sched=s, min_us=t["min_us"], mean_us=t["mean_us"],
            order=schedules.order(i == 0, blocks, sms, s.page_size),
            is_static=i == 0))
    winner = _tie_pick(results, lambda r: r.order)
    key = schedules.paged_attn_cache_key(b, h, kvh, d, max_context,
                                         window=window, dtype=dtype,
                                         device=dev)
    key = _store(cache or get_cache(), key,
                 dataclasses.asdict(winner.sched), winner, results[0],
                 len(results), dev, persist)
    return _report(results, winner, dev, key)


def resolve_paged_attn_schedule(cfg: Optional[GemminiConfig], b: int, h: int,
                                kvh: int, d: int, max_context: int, *,
                                window: Optional[int] = None, dtype="bf16",
                                device=None) -> PagedAttnSchedule:
    """The page size the serving engine sizes its pools with, and its
    decode split, honoring ``tune_mode``. Called once at engine startup
    (the page size is baked into the pool allocation), never on the
    request path."""
    mode = _check_mode()
    static = schedules.default_paged_schedule().effective(max_context)
    if mode == "off":
        return static
    dev = _device(device)
    key = schedules.paged_attn_cache_key(b, h, kvh, d, max_context,
                                         window=window, dtype=dtype,
                                         device=dev)
    hit = get_cache().lookup_checked(
        key, ("page_size", "split_keys"),
        lambda p: schedules.paged_legal(PagedAttnSchedule(**p), max_context))
    if hit is not None:
        return PagedAttnSchedule(**hit)
    if mode == "cached":
        return static
    return tune_paged_attention(cfg, b, h, kvh, d, max_context,
                                window=window, dtype=dtype,
                                device=dev).winner
