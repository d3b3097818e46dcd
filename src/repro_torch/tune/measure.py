"""Timing harness for candidate schedules (port of ``repro.tune.measure``).

On the card a candidate is the kernel itself, launched with the candidate
plan: ``time_callable`` brackets each call with CUDA events, as
``chip_smoke.py``'s phase 3 times a kernel: a sleep kernel first holds
the stream for longer than the host takes to enqueue the call (so the
events bracket the device's work, not the wrapper's host time), then the
L2 cache is flushed (a 128 MiB write, so no call reads the previous
call's operands from L2); it reports the min (the statistic the tuner
ranks by) and the mean of ``iters`` calls.
On the CPU a candidate's schedule is the card kernel's and the plain
version ignores it, so the tuner times the plain version once per shape
and every candidate shares that timing (``tuner``): host noise never picks
a winner, and the tie order does, deterministically.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

_FLUSH: Dict[int, torch.Tensor] = {}
_CYCLES_PER_US: Dict[int, float] = {}


def _flush(device: torch.device) -> None:
    buf = _FLUSH.get(device.index)
    if buf is None:
        buf = _FLUSH[device.index] = torch.empty(128 << 20, dtype=torch.uint8,
                                                 device=device)
    buf.zero_()


def _cycles_per_us(device: torch.device) -> float:
    """The sleep kernel's clock (``torch.cuda._sleep`` counts cycles),
    read once per device."""
    rate = _CYCLES_PER_US.get(device.index)
    if rate is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        rate = _CYCLES_PER_US[device.index] = \
            10_000_000 / (start.elapsed_time(end) * 1e3)
    return rate


def time_callable(fn: Callable, *args, iters: int = 5, warmup: int = 1,
                  label: str = "",
                  device: Optional[torch.device] = None) -> Dict[str, float]:
    """Time ``fn(*args)`` on ``device`` (a CUDA device: CUDA events around
    each call, L2 flushed first; else the host's clock): mean / min
    microseconds of ``iters`` calls after ``warmup``.

    With a process-global tracer installed (``repro_torch.obs.trace.
    install``), each measurement lands as a ``measure:<label>`` span on
    the tuner track, warm-up included."""
    from repro_torch.obs import trace as otrace
    tracer = otrace.active()
    t_span = tracer.clock() if tracer is not None else 0.0
    dev = torch.device(device) if device is not None else torch.device("cpu")
    cuda = dev.type == "cuda"
    for _ in range(max(1, warmup)):
        fn(*args)
    hold = 0
    if cuda:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()               # one synchronised call
        fn(*args)
        torch.cuda.synchronize(dev)
        host_us = (time.perf_counter() - t0) * 1e6
        hold = int(_cycles_per_us(dev) * (2.0 * host_us + 50.0))
    times = []
    for _ in range(iters):
        if cuda:
            torch.cuda._sleep(hold)
            _flush(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e6)
    out = {"mean_us": sum(times) / len(times), "min_us": min(times),
           "iters": float(iters)}
    if tracer is not None:
        tracer.complete(f"measure:{label or 'anon'}", t_span,
                        tracer.clock(), cat="tune",
                        tid=otrace.TID_TUNER, min_us=out["min_us"],
                        mean_us=out["mean_us"], iters=iters)
    return out


def measurement_backend(device=None) -> str:
    """"kernel" where the candidates run on a card, else "plain"."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    return "kernel" if dev.type == "cuda" else "plain"


def _operand(shape, dtype: torch.dtype, device, gen: torch.Generator):
    """Random operands (timing is data-independent for these kernels;
    integers kept small, floats unit-scale)."""
    if dtype in (torch.int8, torch.int16):
        return torch.randint(-64, 64, shape, generator=gen, device=device,
                             dtype=torch.int32).to(dtype)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def gemm_case(dtypes, ws: bool, m: int, n: int, k: int, has_bias: bool,
              b_trans: bool, device) -> Callable[[Optional[dict]], object]:
    """A closure that runs the (M, N, K) GEMM once with a schedule (None:
    the plain version on the CPU), its operands made once (``.operands``:
    A, B, D)."""
    from repro_torch.core.config import Activation
    from repro_torch.kernels import gemm as kg
    in_dt, acc_dt, out_dt = dtypes
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = _operand((m, k), in_dt, dev, gen)
    b = _operand((n, k), in_dt, dev, gen).t() if b_trans else \
        _operand((k, n), in_dt, dev, gen)
    d = _operand((n,), acc_dt, dev, gen) if has_bias else None

    def run(sched):
        return kg._gemm(a, b, d, acc_dtype=acc_dt, out_dtype=out_dt, shift=0,
                        activation=Activation.NONE, ws=ws, plan=sched)
    run.operands = (a, b, d)
    return run


def conv_case(dtypes, n: int, h: int, w: int, ci: int, co: int, kh: int,
              kw: int, stride: int, padding: int, has_bias: bool,
              device) -> Callable[[Optional[dict]], object]:
    from repro_torch.kernels import conv as kc
    in_dt, acc_dt, out_dt = dtypes
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _operand((n, h, w, ci), in_dt, dev, gen)
    wt = _operand((kh, kw, ci, co), in_dt, dev, gen)
    bias = _operand((co,), acc_dt, dev, gen) if has_bias else None

    def run(sched):
        return kc.conv2d_implicit(x, wt, bias, acc_dtype=acc_dt,
                                  out_dtype=out_dt, stride=stride,
                                  padding=padding, plan=sched)
    run.operands = (x, wt, bias)
    return run


def attn_case(b: int, tq: int, tk: int, h: int, kvh: int, d: int,
              causal: bool, window: Optional[int], dtype: torch.dtype,
              device) -> Callable[[Optional[dict]], object]:
    from repro_torch.kernels import attention as ka
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _operand((b, tq, h, d), dtype, dev, gen)
    k = _operand((b, tk, kvh, d), dtype, dev, gen)
    v = _operand((b, tk, kvh, d), dtype, dev, gen)

    def run(sched):
        return ka.flash_attention(q, k, v, causal=causal, window=window,
                                  plan=sched)
    run.operands = (q, k, v)
    return run


def paged_case(b: int, h: int, kvh: int, d: int, max_context: int,
               page: int, window: Optional[int], dtype: torch.dtype,
               device) -> Callable[[Optional[dict]], object]:
    """A full-context decode batch, as ``repro.tune.measure.
    measure_paged_schedule`` builds it: every slot at ``max_context``,
    tables allocated in order, pools of ``page``-token pages."""
    from repro_torch.kernels import attention as ka
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    mp = -(-max_context // page)
    q = _operand((b, 1, h, d), dtype, dev, gen)
    k_pool = _operand((kvh, b * mp + 1, page, d), dtype, dev, gen)
    v_pool = _operand((kvh, b * mp + 1, page, d), dtype, dev, gen)
    tables = torch.arange(b * mp, dtype=torch.int32,
                          device=dev).reshape(b, mp)
    lengths = torch.full((b,), max_context, dtype=torch.int32, device=dev)

    def run(sched):
        return ka.paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                         window=window, plan=sched)
    run.operands = (q, k_pool, v_pool, tables, lengths)
    return run
