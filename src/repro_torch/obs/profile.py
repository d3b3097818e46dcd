"""Opt-in kernel performance counters at the dispatch boundary (port of
``repro.obs.profile``).

When a :class:`Profiler` is installed (``GEMMINI_PROFILE=1`` env,
``serve --profile``, or an explicit :func:`install`), every
``ExecutionContext`` op is timed and recorded into a per-(op,
shape-signature) bucket, joined with the op's FLOPs and bytes
(:mod:`repro_torch.obs.kernel_costs`). Dividing by the card's peaks
(:mod:`repro_torch.analysis.roofline`) gives achieved compute / memory
utilization per kernel instantiation: the software analog of the paper's
hardware counters.

A call on the card is timed by CUDA events recorded on the current stream
around it, synchronised on the end event; a call on the CPU by the host
clock. Before the start event a spin kernel holds the stream for twice the
shortest time the host has taken to enqueue one of the bucket's calls
(5 ms at most, and for its first call), so the events bracket the op's
device work and not its host dispatch. The hold and the synchronisation
serialise the host with the card, so a profiled step is slower than an
unprofiled one; the values it computes are the same. Profiling applies
only to eager dispatches: while
``torch.compile`` traces or a CUDA graph captures, the op boundary passes
through untimed (a timer there would measure tracing, and a
synchronisation is illegal in a capture).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.obs import kernel_costs

ENV_VAR = "GEMMINI_PROFILE"


def _shape_sig(args: Tuple, kw: Dict[str, Any]) -> str:
    parts: List[str] = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None:
            dtype = getattr(a, "dtype", "")
            parts.append(f"{tuple(shape)}{dtype}")
        elif a is None:
            parts.append("-")
        else:
            parts.append(repr(a))
    for k in sorted(kw):
        v = kw[k]
        if getattr(v, "shape", None) is not None:
            v = f"{tuple(v.shape)}{v.dtype}"
        parts.append(f"{k}={v}")
    return ",".join(parts)


@dataclasses.dataclass
class OpBucket:
    """Aggregated timings for one (op, shape-signature) instantiation."""

    op: str
    sig: str
    contract: Optional[str] = None
    flops: float = 0.0            # per call
    bytes: float = 0.0            # per call
    arith: str = "float"
    peak: float = PEAK_FLOPS_BF16     # the card's rate for the input dtype
    enqueue_s: float = float("inf")   # shortest host enqueue of a call
    calls: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def record(self, dt_s: float) -> None:
        self.calls += 1
        self.total_s += dt_s
        self.min_s = min(self.min_s, dt_s)
        self.max_s = max(self.max_s, dt_s)

    def utilization(self) -> Dict[str, Optional[float]]:
        """Achieved-vs-roofline fractions from the bucket's BEST call
        (min_s): warmup noise inflates means, and the roofline question is
        what the kernel can sustain."""
        if not self.calls or self.min_s == float("inf"):
            return {"compute": None, "memory": None, "bound": None}
        if self.flops <= 0 and self.bytes <= 0:
            return {"compute": None, "memory": None, "bound": None}
        cu = (self.flops / self.min_s) / self.peak
        mu = (self.bytes / self.min_s) / HBM_BW
        t_c = self.flops / self.peak
        t_m = self.bytes / HBM_BW
        return {"compute": cu, "memory": mu,
                "bound": "compute" if t_c >= t_m else "memory"}

    def row(self) -> Dict[str, Any]:
        util = self.utilization()
        return {
            "op": self.op, "sig": self.sig, "contract": self.contract,
            "calls": self.calls, "total_s": self.total_s,
            "min_s": None if self.min_s == float("inf") else self.min_s,
            "max_s": self.max_s, "flops": self.flops, "bytes": self.bytes,
            "arith": self.arith, "compute_util": util["compute"],
            "memory_util": util["memory"], "bound": util["bound"],
        }


def _device(args: Tuple) -> Optional[torch.device]:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


class Profiler:
    """Per-op timing + cost aggregation.

    ``tracer``: optional :class:`repro_torch.obs.trace.Tracer`; when set,
    each profiled call also lands as a ``cat="kernel"`` complete span on
    the profile track.
    """

    def __init__(self, *, clock=time.perf_counter, tracer=None) -> None:
        self.clock = clock
        self.tracer = tracer
        self.buckets: Dict[Tuple[str, str], OpBucket] = {}
        self._cycles_per_s: Optional[float] = None

    def bucket(self, op: str, args: Tuple, kw: Dict[str, Any], cfg
               ) -> OpBucket:
        sig = _shape_sig(args, kw)
        key = (op, sig)
        b = self.buckets.get(key)
        if b is None:
            b = self.buckets[key] = OpBucket(op=op, sig=sig)
            cost = kernel_costs.op_cost(op, args, kw, cfg)
            if cost is not None:
                b.contract = cost.contract
                b.flops = cost.flops
                b.bytes = cost.bytes
                b.arith = cost.arith
                b.peak = cost.peak
        return b

    def call(self, bucket: OpBucket, fn, args: Tuple, kw: Dict[str, Any]):
        """``fn(*args, **kw)``, timed into ``bucket``: by CUDA events on
        the current stream (synchronised on the end event, the stream held
        while the host enqueues the call) when its first tensor argument
        lies on a card, else by the host clock. The span starts at the
        host clock's reading before the call and lasts the measured
        time."""
        dev = _device(args)
        if dev is not None and dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            hold_s = min(2.0 * bucket.enqueue_s + 5e-5, 5e-3)
            torch.cuda._sleep(int(hold_s * self._spin_rate()))
            t0 = self.clock()
            start.record()
            out = fn(*args, **kw)
            end.record()
            bucket.enqueue_s = min(bucket.enqueue_s, self.clock() - t0)
            end.synchronize()
            t1 = t0 + start.elapsed_time(end) / 1e3
        else:
            t0 = self.clock()
            out = fn(*args, **kw)
            t1 = self.clock()
        self.record(bucket, t0, t1)
        return out

    def _spin_rate(self) -> float:
        """The spin kernel's cycles per second, measured once (the second
        of two timed spins: the first pays the kernel's first launch)."""
        if self._cycles_per_s is None:
            for _ in range(2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                torch.cuda._sleep(1_000_000)
                end.record()
                end.synchronize()
            self._cycles_per_s = 1_000_000 / (start.elapsed_time(end) / 1e3)
        return self._cycles_per_s

    def record(self, bucket: OpBucket, t0: float, t1: float) -> None:
        bucket.record(t1 - t0)
        if self.tracer is not None:
            from repro_torch.obs import trace as otrace
            self.tracer.complete(
                bucket.op, t0, t1, cat="kernel", tid=otrace.TID_PROFILE,
                contract=bucket.contract, flops=bucket.flops,
                bytes=bucket.bytes, peak=bucket.peak, sig=bucket.sig)

    # -------------------------------------------------------------- report

    def table(self, *, by: str = "total_s") -> List[Dict[str, Any]]:
        rows = [b.row() for b in self.buckets.values()]
        rows.sort(key=lambda r: r.get(by) or 0.0, reverse=True)
        return rows

    def report(self, *, top: int = 20) -> str:
        rows = self.table()[:top]
        if not rows:
            return "profiler: no ops recorded"
        head = (f"{'op':<24} {'contract':<24} {'calls':>6} {'total_ms':>9} "
                f"{'best_ms':>8} {'gflops':>8} {'comp%':>6} {'mem%':>6} "
                f"{'bound':>8}")
        lines = [head, "-" * len(head)]
        for r in rows:
            cu = r["compute_util"]
            mu = r["memory_util"]
            lines.append(
                f"{r['op']:<24} {str(r['contract']):<24} {r['calls']:>6} "
                f"{r['total_s'] * 1e3:>9.3f} "
                f"{(r['min_s'] or 0.0) * 1e3:>8.3f} "
                f"{r['flops'] / 1e9:>8.2f} "
                f"{'--' if cu is None else format(cu * 100, '.2f'):>6} "
                f"{'--' if mu is None else format(mu * 100, '.2f'):>6} "
                f"{str(r['bound'] or '--'):>8}")
        return "\n".join(lines)

    def snapshot(self) -> List[Dict[str, Any]]:
        return self.table()


# ------------------------------------------------------ global installation

_ACTIVE: Optional[Profiler] = None


def install(profiler: Optional[Profiler] = None) -> Profiler:
    global _ACTIVE
    _ACTIVE = profiler or Profiler()
    return _ACTIVE


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[Profiler]:
    global _ACTIVE
    if _ACTIVE is None:
        spec = os.environ.get(ENV_VAR, "").strip().lower()
        if spec not in ("", "0", "off", "false", "no"):
            _ACTIVE = Profiler()
    return _ACTIVE


# The dispatch hook reads ``_ACTIVE`` itself (one None check per op), so
# ``$GEMMINI_PROFILE`` takes effect here, when the module is imported, and
# at every call of :func:`active`.
active()
