"""Deterministic fault injection for the serving/runtime stack.

The paper's system-level argument cuts both ways: an engine evaluated only
on the happy path is not evaluated. This module is the *provocation* half
of the robustness story -- a seeded, declarative :class:`FaultPlan` whose
every firing is reproducible from a single RNG seed, injected at the host
boundaries the engine already owns (around its jitted step calls, at the
page allocator, at checkpoint writes, and around eager
:class:`~repro_torch.core.context.ExecutionContext` op dispatch). The *survival*
half lives in :class:`repro_torch.serving.ServingEngine`: NaN/Inf guards with
retry-on-the-XLA-twin, bounded transient retries, schedule quarantine,
deadline shedding (docs/serving.md#robustness).

Everything here is off by default. Faults turn on either per engine
(``ServingEngine(faults=...)``) or process-wide via the ``GEMMINI_FAULTS``
environment variable / :func:`install`.

Fault kinds and their default sites::

    kind        injects                                 default site
    ----------  --------------------------------------  ------------
    nan / inf   poisoned kernel outputs (whole array)   *  (any site)
    transient   TransientOpError raised before the op   *  (any site)
    arena       page-allocator pressure (held pages)    arena
    straggler   a sleep before the engine step          step
    ckpt_io     OSError from save_checkpoint            checkpoint
    offload_io  failed KV host-offload DMA (the spill   spill
                or restore degrades to recompute)

Engine sites are ``prefill`` (whole-prompt and first-chunk calls),
``chunk`` (continuation chunks), ``decode`` (the decode step), ``step``
(once per engine iteration), ``arena`` (queried once per iteration),
``spill`` / ``restore`` (the KV host-offload copies, queried once per
attempted spill/restore when ``kv_offload`` is on), and ``op:<name>``
for eager ExecutionContext dispatch (e.g. ``op:gemm``).

Why host-level injection: the engine's model steps are jitted, so anything
injected *inside* traced code would be baked into the compiled function --
every subsequent call would fail identically and no seed could make the
fault transient. Poisoning returned arrays and raising before dispatch
keeps the compiled artifacts byte-identical to the fault-free run, which
is exactly what lets the chaos suite assert bit-equal tokens.

Determinism: spec ``i`` of a plan draws from ``default_rng([seed, i])``
with an independent draw counter per site. Fault firings are therefore a
pure function of (plan, sequence of injection-point visits) -- and the
engine's visit sequence is itself deterministic given the submitted trace.

Spec string grammar (``GEMMINI_FAULTS`` / :meth:`FaultPlan.parse`)::

    seed=7;nan@decode:p=0.25,max=2;transient@prefill:max=1;arena:pages=2

``kind[@site][:k=v,...]`` items separated by ``;``. Keys: ``p``
(probability per draw), ``start``/``stop`` (eligible draw-index window,
per site), ``max`` (max firings), ``delay`` (straggler sleep seconds),
``pages`` (arena pages withheld per step). Sites may contain colons
(``nan@op:gemm:max=1`` targets site ``op:gemm``): the k=v tail starts at
the first colon segment containing an ``=``.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

KINDS = ("nan", "inf", "transient", "arena", "straggler", "ckpt_io",
         "offload_io")

# Site a bare kind targets when the spec omits ``@site``.
DEFAULT_SITES = {"arena": "arena", "straggler": "step",
                 "ckpt_io": "checkpoint", "offload_io": "spill"}

ENV_VAR = "GEMMINI_FAULTS"


class TransientOpError(RuntimeError):
    """An injected transient failure (the retryable class: in production
    this slot is an XLA runtime error / preempted RPC, not a model bug)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault: what to inject, where, and how often."""

    kind: str
    site: str = "*"                # exact site name, or "*" = any site
    p: float = 1.0                 # firing probability per eligible draw
    start: int = 0                 # eligible draw-index window [start, stop)
    stop: int = 1 << 30            # ...counted per site
    max_hits: int = 1 << 30        # total firings across all sites
    delay_s: float = 0.02          # straggler sleep
    pages: int = 1                 # arena pages withheld per step

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {KINDS}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault probability must be in [0, 1], "
                             f"got {self.p}")


_SPEC_KEYS = {"p": ("p", float), "start": ("start", int),
              "stop": ("stop", int), "max": ("max_hits", int),
              "delay": ("delay_s", float), "pages": ("pages", int)}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed plus an ordered tuple of :class:`FaultSpec`.

    Frozen and value-like: two engines built from equal plans inject
    identical fault sequences (the reproducibility contract chaos tests
    and bug reports rely on)."""

    seed: int = 0
    specs: Tuple[FaultSpec, ...] = ()

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse the compact ``GEMMINI_FAULTS`` grammar (module docstring).
        An empty/whitespace string is the empty plan (no faults)."""
        seed = 0
        specs: List[FaultSpec] = []
        for item in filter(None, (s.strip() for s in text.split(";"))):
            if item.startswith("seed="):
                seed = int(item[5:])
                continue
            # Sites may themselves contain colons (``op:gemm``), so the
            # k=v tail starts at the first colon segment holding an "=".
            segs = item.split(":")
            cut = next((i for i in range(1, len(segs)) if "=" in segs[i]),
                       len(segs))
            kind, _, site = segs[0].partition("@")
            site = ":".join([site.strip()] + [s.strip()
                                              for s in segs[1:cut]]) \
                if site else ""
            tail = ":".join(segs[cut:])
            kw: Dict[str, Union[int, float, str]] = {
                "kind": kind.strip(),
                "site": site or DEFAULT_SITES.get(kind.strip(), "*")}
            for kv in filter(None, (s.strip() for s in tail.split(","))):
                key, _, val = kv.partition("=")
                if key not in _SPEC_KEYS:
                    raise ValueError(
                        f"unknown fault-spec key {key!r} in {item!r}; "
                        f"have {sorted(_SPEC_KEYS)}")
                field, cast = _SPEC_KEYS[key]
                kw[field] = cast(val)
            specs.append(FaultSpec(**kw))  # type: ignore[arg-type]
        return cls(seed=seed, specs=tuple(specs))

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """The process-wide plan from ``$GEMMINI_FAULTS``, or None when the
        variable is unset/empty (faults stay off -- the default)."""
        text = os.environ.get(ENV_VAR, "").strip()
        if not text:
            return None
        plan = cls.parse(text)
        return plan if plan.specs else None


def capturing() -> bool:
    """True while ``torch.compile`` traces or the current CUDA stream
    captures a graph: the torch counterparts of a jax trace, where a
    host-level fault or timer would be baked into the compiled artifact.
    No graph can be capturing before CUDA is initialised."""
    import torch
    return torch.compiler.is_compiling() or (
        torch.cuda.is_initialized() and
        torch.cuda.is_current_stream_capturing())


def _is_tracer(x) -> bool:
    # The torch counterpart of a jax tracer: a value seen while compiling
    # or capturing, where a host-level poison would be baked in.
    return capturing()


class FaultInjector:
    """Stateful executor of one :class:`FaultPlan`.

    Holds the per-spec RNG streams and draw/hit counters; the injection
    points below are what the engine, allocator callers, checkpoint store,
    and context dispatch invoke. ``injected`` tallies firings by
    ``kind@site`` for telemetry.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rngs = [np.random.default_rng([plan.seed, i])
                      for i in range(len(plan.specs))]
        self._draws: List[collections.Counter] = [
            collections.Counter() for _ in plan.specs]
        self._hits = [0] * len(plan.specs)
        self.injected: collections.Counter = collections.Counter()
        self.sleep = time.sleep          # injectable for tests
        # Optional repro_torch.obs.trace.Tracer: every firing lands as a
        # cat="fault" instant. The serving engine wires its own tracer in;
        # otherwise the process-global one (obs.trace.install) is used.
        self.tracer = None

    # -- core draw ---------------------------------------------------------
    def fires(self, site: str,
              kinds: Optional[Sequence[str]] = None) -> Optional[FaultSpec]:
        """Draw every matching spec at ``site``; the first that fires wins.
        Every matching spec's per-site draw counter advances whether or not
        it fires, so firings depend only on visit order, never on which
        other spec fired first."""
        hit: Optional[FaultSpec] = None
        for i, spec in enumerate(self.plan.specs):
            if kinds is not None and spec.kind not in kinds:
                continue
            if spec.site != "*" and spec.site != site:
                continue
            idx = self._draws[i][site]
            self._draws[i][site] += 1
            if hit is not None or self._hits[i] >= spec.max_hits:
                continue
            if not spec.start <= idx < spec.stop:
                continue
            if spec.p < 1.0 and self._rngs[i].random() >= spec.p:
                continue
            self._hits[i] += 1
            self.injected[f"{spec.kind}@{site}"] += 1
            hit = spec
        if hit is not None:
            self._trace_fire(hit, site)
        return hit

    def _trace_fire(self, spec: FaultSpec, site: str) -> None:
        """Emit the firing to this injector's tracer (or the process-global
        one): cat="fault" instant on the fault track."""
        from repro_torch.obs import trace as otrace
        tracer = self.tracer or otrace.active()
        if tracer is not None:
            tracer.instant(f"fault:{spec.kind}", cat="fault",
                           tid=otrace.TID_FAULT, site=site)

    # -- injection points --------------------------------------------------
    def check_transient(self, site: str) -> None:
        """Raise :class:`TransientOpError` when a transient spec fires --
        called immediately before the op it would have failed."""
        if self.fires(site, ("transient",)) is not None:
            raise TransientOpError(f"injected transient failure at {site!r}")

    def poison(self, site: str, out):
        """Return ``out`` NaN/Inf-poisoned when a poison spec fires (the
        observable signature of a miscompiled/mis-tiled kernel). Traced
        values and None pass through untouched -- poison is host-level
        only, so compiled artifacts stay byte-identical."""
        if out is None or _is_tracer(out):
            return out
        spec = self.fires(site, ("nan", "inf"))
        if spec is None:
            return out
        import torch
        if not out.is_floating_point():
            # Integer datapaths cannot hold NaN/Inf; saturate instead
            # (the closest observable analogue of a mis-tiled int kernel).
            return torch.full_like(out, torch.iinfo(out.dtype).max)
        bad = float("nan") if spec.kind == "nan" else float("inf")
        return torch.full_like(out, bad)

    def straggle(self, site: str = "step") -> float:
        """Sleep when a straggler spec fires; returns the injected delay."""
        spec = self.fires(site, ("straggler",))
        if spec is None:
            return 0.0
        self.sleep(spec.delay_s)
        return spec.delay_s

    def arena_pressure(self, site: str = "arena") -> int:
        """Pages the caller should withhold from its allocator this step
        (see ``PagedKVAllocator.hold_pages``); 0 = no pressure."""
        spec = self.fires(site, ("arena",))
        return spec.pages if spec is not None else 0

    def ckpt_fails(self, site: str = "checkpoint") -> bool:
        """True when a checkpoint-write spec fires (the store raises
        OSError in its place)."""
        return self.fires(site, ("ckpt_io",)) is not None

    def offload_fails(self, site: str) -> bool:
        """True when a KV host-offload DMA spec fires at ``site`` (one of
        ``spill`` / ``restore``): the engine drops the copy and the
        scheduler degrades that victim to the classic recompute restart --
        offload is an optimization, never a correctness dependency."""
        return self.fires(site, ("offload_io",)) is not None

    # -- telemetry ---------------------------------------------------------
    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def report(self) -> Dict[str, int]:
        """Firing counts by ``kind@site`` (stable ordering for logs)."""
        return {k: int(v) for k, v in sorted(self.injected.items())}


def as_injector(obj: Union[None, str, FaultPlan, FaultInjector]
                ) -> Optional[FaultInjector]:
    """Normalize the engine's ``faults=`` kwarg: None consults
    ``$GEMMINI_FAULTS`` (usually: faults off), a spec string parses, a plan
    binds a fresh injector, an injector passes through."""
    if obj is None:
        plan = FaultPlan.from_env()
        return FaultInjector(plan) if plan is not None else None
    if isinstance(obj, FaultInjector):
        return obj
    if isinstance(obj, str):
        obj = FaultPlan.parse(obj)
    if isinstance(obj, FaultPlan):
        return FaultInjector(obj) if obj.specs else None
    raise TypeError(f"cannot derive a FaultInjector from {type(obj)!r}")


# ---------------------------------------------------------------------------
# process-global injector (the ExecutionContext / checkpoint hook)
# ---------------------------------------------------------------------------
_ACTIVE: Optional[FaultInjector] = None


def install(obj: Union[str, FaultPlan, FaultInjector]) -> FaultInjector:
    """Install a process-global injector: eager ExecutionContext op
    dispatch and ``save_checkpoint`` consult it. Returns the injector
    (callers keep it for telemetry). Pair with :func:`deactivate` --
    tests should use try/finally."""
    global _ACTIVE
    inj = as_injector(obj)
    if inj is None:
        raise ValueError("install() needs a non-empty fault plan")
    _ACTIVE = inj
    return inj


def deactivate() -> None:
    """Remove the process-global injector (faults off)."""
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultInjector]:
    """The process-global injector, or None (the default: no faults)."""
    return _ACTIVE
