"""The model checker's executable harness: a tensor-free serving engine.

:class:`NullEngine` subclasses the real
:class:`~repro_torch.serving.engine.EngineControlPlane` -- the same admission,
chunking, preemption, recovery-ladder, and offload control flow the
production :class:`~repro_torch.serving.engine.ServingEngine` runs -- and
implements the compute hooks with fabricated deterministic token commits
(``token = f(rid, n_generated)``), no device tensors anywhere. A state is
therefore plain Python: deepcopy snapshots it, ``canon`` hashes it, and
one action steps in microseconds.

:class:`MCConfig` bounds one exploration: geometry (slots/pages), the
workload (prompts + generation lengths), feature flags (offload, prefix
cache, deadlines), and the fault alphabet. Shipped configurations live in
:data:`CONFIGS`; :data:`SELFTEST_CONFIGS` carry deliberately planted bugs
(``sabotage=``) the checker must catch -- the mc analogue of the property
suite's ``test_check_catches_refcount_drift`` oracle self-test.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.runtime import faults as rfaults
from repro_torch.serving.engine import EngineControlPlane
from repro_torch.serving.paged_cache import PagedKVAllocator
from repro_torch.serving.scheduler import ContinuousScheduler


class LogicalClock:
    """A clock that advances only by explicit ``tick`` actions, so time is
    part of the explored state, not an ambient side effect. All requests
    submitted between ticks share a timestamp -- which is exactly the
    tie-break scenario the scheduler's rid ordering must make
    deterministic."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float = 1.0) -> float:
        self.t += dt
        return self.t


@dataclasses.dataclass(frozen=True)
class NullModelCfg:
    """The minimal model-config surface the control plane consults."""

    name: str = "null"
    n_meta_tokens: int = 0
    n_codebooks: int = 1
    has_ssm: bool = False
    has_attn: bool = True
    vocab: int = 97


@dataclasses.dataclass(frozen=True)
class MCConfig:
    """One bounded exploration: geometry, workload, features, faults."""

    name: str
    slots: int = 3
    pages: int = 12
    page_size: int = 4
    max_context: int = 16
    # workload: prompt token tuples + per-request generation lengths
    prompts: Tuple[Tuple[int, ...], ...] = ((1, 2, 3, 4, 5, 6),
                                            (1, 2, 3, 4),
                                            (7, 8, 9))
    max_new: Tuple[int, ...] = (2, 2, 2)
    prefill_chunk: int = 4
    # budget 1: prefill_schedule's "first item always lands" rule means
    # exactly one chunk per call -- chunk-commit granularity for the MC
    prefill_token_budget: int = 1
    admission_policy: str = "fifo"
    kv_offload: bool = False
    host_pool_pages: int = 0
    prefix_cache: bool = False
    enforce_deadlines: bool = False
    deadlines: Tuple[Optional[float], ...] = ()   # relative, per request
    max_ticks: int = 0
    allow_preempt: bool = True
    allow_defrag: bool = True
    fault_kinds: Tuple[str, ...] = ()
    max_faults: int = 0
    sabotage: Optional[str] = None                # selftest bug plants


NULL_MODEL = NullModelCfg()


class NullEngine(EngineControlPlane):
    """The control plane over a fabricated-compute executor.

    Construction mirrors ``ServingEngine.__init__`` component wiring
    (allocator geometry, scheduler hooks, offload/prefix flags) minus
    everything device: no params, no jitted steps, no pools. Sampled
    tokens are ``(rid * 7919 + n_generated * 131 + 13) % vocab`` -- a
    deterministic function of visible state, so decision-relevant token
    *counts* evolve exactly as on the real engine while values stay
    reproducible across replays.
    """

    def __init__(self, mc_cfg: MCConfig, model_cfg: NullModelCfg = NULL_MODEL,
                 *, trace=False):
        super().__init__(
            model_cfg, max_slots=mc_cfg.slots, policy="continuous",
            # the empty plan (NOT None: None would consult $GEMMINI_FAULTS
            # and make exploration depend on the environment)
            faults=rfaults.FaultPlan(),
            nan_guard=bool(mc_cfg.fault_kinds),
            max_step_retries=2, retry_backoff_s=0.0,
            assert_invariants=False,       # the checker IS the oracle
            trace=trace, clock=LogicalClock())
        self.mc_cfg = mc_cfg
        self.max_context = mc_cfg.max_context
        self.page_size = mc_cfg.page_size
        self.max_pages_per_seq = -(-mc_cfg.max_context // mc_cfg.page_size)
        self.kv_offload = bool(mc_cfg.kv_offload)
        self.prefix_cache = bool(mc_cfg.prefix_cache)
        self.alloc = PagedKVAllocator(
            mc_cfg.pages, mc_cfg.page_size, self.max_pages_per_seq,
            tracer=self.tracer,
            host_pool_pages=(mc_cfg.host_pool_pages
                             if self.kv_offload else 0))
        self.prefill_pad = mc_cfg.page_size    # attention-only null model
        self.sched = ContinuousScheduler(
            self.alloc, mc_cfg.slots,
            prefill_token_budget=mc_cfg.prefill_token_budget,
            extra_tokens_per_prefill=model_cfg.n_meta_tokens,
            pad_to=self.prefill_pad,
            prefill_chunk=mc_cfg.prefill_chunk,
            admission_policy=mc_cfg.admission_policy,
            enforce_deadlines=mc_cfg.enforce_deadlines,
            clock=self.clock, tracer=self.tracer, metrics=self.metrics,
            offload=self.kv_offload, prefix_cache=self.prefix_cache,
            spill_fn=self._spill, restore_fn=self._restore)
        self.prefill_chunk = self.sched.prefill_chunk
        self._next_token = np.zeros((mc_cfg.slots,), np.int32)
        # one-shot armed faults retire here (kind strings, in firing
        # order): keeps the spent injector out of the state
        self.mc_fired: list = []

    # -- fabricated compute ------------------------------------------------
    def _fab_token(self, req) -> np.ndarray:
        return np.int32((req.rid * 7919 + req.n_generated * 131 + 13)
                        % self.model_cfg.vocab)

    def _null_logits(self):
        return np.zeros((1, 2), np.float32)

    def _dispatch(self, which: str, args: tuple):
        return self._null_logits(), None

    def _dispatch_fallback(self, which: str, args: tuple):
        return self._null_logits(), None

    def _exec_chunk(self, w):
        # Same site/which naming as the real engine, so armed faults hit
        # the identical recovery-ladder control flow (_run_guarded).
        site = "prefill" if w.first else "chunk"
        self._run_guarded(site, site, ())
        if not w.last:
            return None
        return self._fab_token(w.req)

    def _exec_decode(self, active_np: np.ndarray) -> np.ndarray:
        self._run_guarded("decode", "decode", ())
        last = np.zeros((self.max_slots,), np.int32)
        for slot, req in self.sched.running.items():
            if not req.prefilling:
                last[slot] = self._fab_token(req)
        return last

    def _capture_spill(self, req, page_ids):
        return {"rid": req.rid, "n_pages": len(page_ids)}

    def _apply_restore(self, req, slot, spill) -> None:
        pass                                   # nothing device to copy

    # -- sabotage (oracle self-tests) --------------------------------------
    def defrag(self) -> None:
        super().defrag()
        if self.mc_cfg.sabotage == "defrag_leak" and self.alloc._ref:
            # plant: refcount drift after compaction -> GL801 must fire
            p = next(iter(self.alloc._ref))
            self.alloc._ref[p] += 1

    def control_prefill(self, admit_new: bool = True) -> int:
        n = super().control_prefill(admit_new=admit_new)
        if self.mc_cfg.sabotage == "wedge":
            # plant half 1: silently LOSE preempted requests from the
            # queue (no terminal state) -- the lost-request bug class
            self.sched.queue = [r for r in self.sched.queue
                                if r.n_preempted == 0]
        return n

    def control_decode(self) -> None:
        super().control_decode()
        sab = self.mc_cfg.sabotage
        if sab == "rewind":
            # plant: drop below the pre-action commit point (popping just
            # the token this action pushed would still be prefix-monotone)
            # -> GL802 (no-rewind) must fire
            for req in self.sched.running.values():
                if len(req.generated) >= 2:
                    req.generated.pop()
                    req.generated.pop()
                    break
        elif sab == "wedge":
            # plant half 2: leak every free page into the held set; with
            # defrag disabled (it would release holds) the arena wedges.
            # Together the halves make states from which neither
            # can_admit nor a drained workload is ever reachable
            # -> GL804 and GL806 must fire
            self.alloc.hold_pages(self.alloc.free_pages)


def build_engine(cfg: MCConfig) -> NullEngine:
    return NullEngine(cfg)


# -- shipped configurations -------------------------------------------------
# The acceptance configuration: 3 slots / 12 pages / 3 requests, chunked
# prefill, shared-prefix prompts, preemption + defrag in the alphabet.
CONFIGS: Dict[str, MCConfig] = {
    "core-3s12p": MCConfig(
        name="core-3s12p", slots=3, pages=12, page_size=4, max_context=16,
        prompts=((1, 2, 3, 4, 5, 6), (1, 2, 3, 4), (7, 8, 9)),
        max_new=(2, 2, 2), prefill_chunk=4),
    # host offload: spill-on-preempt, restore-vs-recompute, LRU eviction
    "offload-2s8p": MCConfig(
        name="offload-2s8p", slots=2, pages=8, page_size=4, max_context=16,
        prompts=((1, 2, 3, 4, 5), (6, 7, 8)), max_new=(2, 2),
        prefill_chunk=4, kv_offload=True, host_pool_pages=4),
    # copy-on-write prefix cache: publish/match/reclaim under a shared
    # prompt prefix (first page of r0 and r1 is content-identical)
    "prefix-2s8p": MCConfig(
        name="prefix-2s8p", slots=2, pages=8, page_size=4, max_context=16,
        prompts=((1, 2, 3, 4, 9, 9), (1, 2, 3, 4, 5)), max_new=(2, 2),
        prefill_chunk=4, prefix_cache=True, allow_preempt=False),
    # EDF + SLO shedding under an explicitly ticked logical clock; equal
    # deadlines exercise the rid tie-break
    "deadline-2s8p": MCConfig(
        name="deadline-2s8p", slots=2, pages=8, page_size=4, max_context=16,
        prompts=((1, 2, 3), (4, 5, 6)), max_new=(2, 2), prefill_chunk=4,
        admission_policy="deadline", enforce_deadlines=True,
        deadlines=(3.0, 3.0), max_ticks=4, allow_defrag=False),
    # the recovery ladder: one-shot transient + NaN faults interleaved at
    # every point of the schedule
    "faults-2s8p": MCConfig(
        name="faults-2s8p", slots=2, pages=8, page_size=4, max_context=16,
        prompts=((1, 2, 3, 4, 5), (6, 7, 8)), max_new=(2, 2),
        prefill_chunk=4, fault_kinds=("transient", "nan"), max_faults=2,
        allow_defrag=False),
}

# Planted-bug configurations: the checker must FIND these (tests assert
# it does); they never run in CI's gate.
SELFTEST_CONFIGS: Dict[str, MCConfig] = {
    "sabotage-defrag-leak": MCConfig(
        name="sabotage-defrag-leak", slots=2, pages=8, page_size=4,
        max_context=16, prompts=((1, 2, 3),), max_new=(2,),
        prefill_chunk=4, sabotage="defrag_leak"),
    "sabotage-rewind": MCConfig(
        name="sabotage-rewind", slots=2, pages=8, page_size=4,
        max_context=16, prompts=((1, 2, 3),), max_new=(3,),
        prefill_chunk=4, allow_defrag=False, sabotage="rewind"),
    "sabotage-wedge": MCConfig(
        name="sabotage-wedge", slots=2, pages=4, page_size=4,
        max_context=16, prompts=((1, 2, 3), (4, 5, 6)), max_new=(2, 2),
        prefill_chunk=4, allow_defrag=False, sabotage="wedge"),
}

ALL_CONFIGS: Dict[str, MCConfig] = {**CONFIGS, **SELFTEST_CONFIGS}
