"""Request-level serving engine: continuous batching over paged KV caches
(port of ``repro.serving.engine``).

:class:`EngineControlPlane` is a copy of the JAX package's device-free
half -- admission, chunk ordering, preemption, token-commit accounting,
the spill/restore protocol -- so every scheduling decision is the JAX
engine's decision. :class:`ServingEngine` implements its compute hooks on
the port's model: a CUDA device runs the hand-written kernels, the CPU
runs their plain versions.

    engine = ServingEngine(configs.get("gemma3-1b"), max_slots=4)
    engine.submit(prompt, max_new_tokens=32)
    report = engine.run()            # drains the queue

The robustness envelope runs as in the JAX engine: deterministic fault
injection (``faults=`` / ``$GEMMINI_FAULTS``), bounded retries of
transient step failures, and the NaN guard, which counts a step whose
logits are not finite in ``fallbacks`` and re-runs it from the state it
received. The JAX engine re-runs it on its XLA twin; here the re-run
launches the same kernels, with the op hooks off, so an injected fault is
recovered and a kernel that itself gives non-finite logits raises instead
of being hidden behind plain versions. A guard trip at a decode step
quarantines the tuned paged-attention schedule the engine resolved its
page size (and decode split) under, as the JAX engine does.

With tuning on (``GEMMINI_TUNE`` / ``--tune`` ``cached`` or ``full``) the
page size and the paged decode kernel's keys per split come from
``repro_torch.tune.resolve_paged_attn_schedule`` at startup, and
``warm_prompt_lens`` pre-resolves every schedule the engine will launch
(:meth:`ServingEngine.warm`), so no request tunes on the request path.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import flags
from repro_torch.core.config import GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.models import transformer as tf
from repro_torch.obs import trace as otrace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime import faults as rfaults
from repro_torch.runtime.ft import StepWatchdog
from repro_torch.serving.paged_cache import PagedKVAllocator, arena_pages
from repro_torch.serving.scheduler import ContinuousScheduler, Request, summarize

# Tokens per KV page when the caller names none and tuning is off (the JAX
# package's static default; ``repro_torch.tune.schedules``).
DEFAULT_PAGE_SIZE = 64


def _all_finite(logits: torch.Tensor) -> bool:
    """The NaN guard's test: one reduction where the logits live, read
    once on the host."""
    return bool(torch.isfinite(logits).all())


def _env_check_default() -> bool:
    """``$GEMMINI_CHECK`` truthiness: the step-boundary allocator-invariant
    knob's environment default (off unless set to 1/true/on/yes)."""
    return os.environ.get("GEMMINI_CHECK", "").strip().lower() in (
        "1", "true", "on", "yes")


class EngineControlPlane:
    """The device-free half of the serving engine.

    Everything that *decides* lives here: submission, the per-iteration
    step structure (shed -> prefill chunks -> decode capacity -> decode),
    token-commit accounting (``_record_token`` and the finish/EOS logic),
    the recovery ladder's control flow (``_run_guarded``: transient retry
    -> NaN guard -> fallback -> quarantine), and the host-offload
    spill/restore protocol. None of it touches a device tensor; the
    compute work is behind the hooks below, which a subclass implements:

    * :meth:`_dispatch` / :meth:`_dispatch_fallback` -- run one model step
      (primary / the NaN guard's re-run), returning ``(logits, state)``.
    * :meth:`_exec_chunk` -- execute one prefill chunk's compute; returns
      the sampled token for the last chunk, else None.
    * :meth:`_exec_decode` -- execute one decode step's compute; returns
      per-slot sampled tokens.
    * :meth:`_capture_spill` / :meth:`_apply_restore` -- the device<->host
      copies behind the offload accounting.
    * :meth:`_sync_tables` -- push allocator block tables to the device
      (no-op by default: a tensor-free executor has no tables to sync).
    * :meth:`_bucket_key` -- the compile-bucket key of a dispatch, for the
      trace-time jit audit (default: one bucket).

    ``ServingEngine`` implements the hooks against the jitted model steps;
    ``repro.analysis.mc.harness.NullEngine`` implements them with
    fabricated deterministic token commits so the model checker can step
    the REAL scheduling/recovery logic through exhaustive interleavings.

    Subclasses finish construction by setting the geometry and component
    attributes: ``max_context``, ``page_size``, ``max_pages_per_seq``,
    ``prefill_pad``, ``alloc``, ``sched``, ``prefill_chunk``,
    ``_next_token``.
    """

    def __init__(self, model_cfg, *, max_slots: int,
                 policy: str = "continuous",
                 faults=None,
                 nan_guard: Optional[bool] = None,
                 max_step_retries: int = 2,
                 retry_backoff_s: float = 0.0,
                 assert_invariants: Optional[bool] = None,
                 watchdog: Optional[StepWatchdog] = None,
                 trace=None,
                 clock=None):
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {policy!r}")
        self.model_cfg = model_cfg
        self.policy = policy
        self.max_slots = max_slots
        # -- observability (docs/observability.md) -------------------------
        # One monotonic clock for every duration in the engine (wall
        # clocks step under NTP); the tracer and scheduler share it so
        # span timestamps and request timings live in one domain.
        self.clock = clock or time.monotonic
        self.tracer = otrace.as_tracer(trace, clock=self.clock)
        self.metrics = MetricsRegistry()
        # Bail-out cap for run(): overridable so tests can force the hang
        # diagnostics without 100k iterations.
        self.max_run_iters = 100_000
        # -- robustness envelope (docs/serving.md#robustness) --------------
        # faults: None consults $GEMMINI_FAULTS (usually: off); a spec
        # string / FaultPlan / FaultInjector turns deterministic fault
        # injection on for THIS engine only. nan_guard defaults to
        # "on iff faults are on": the guard host-checks every step's
        # logits, and the fault-free fast path must stay byte-identical
        # to an engine without the guard (no per-step isfinite sync).
        self.faults = rfaults.as_injector(faults)
        if self.faults is not None and self.tracer is not None:
            # Fault firings land on this engine's trace (cat="fault"),
            # not just on a globally installed tracer.
            self.faults.tracer = self.tracer
        self.nan_guard = (self.faults is not None) if nan_guard is None \
            else nan_guard
        self.max_step_retries = max_step_retries
        self.retry_backoff_s = retry_backoff_s
        # Debug oracle: run PagedKVAllocator.check() at every step
        # boundary. Off by default (it is O(pages) of pure-Python asserts
        # on the hot loop); None consults $GEMMINI_CHECK so the chaos
        # suite -- and any bug hunt -- can flip it on without code edits.
        self.assert_invariants = _env_check_default() \
            if assert_invariants is None else bool(assert_invariants)
        # per-step-name set of dispatched compile-bucket keys, consumed by
        # the trace-time auditor (repro.analysis.lint.jit_audit): every
        # distinct key is one XLA compilation, and the static census from
        # the page/chunk geometry caps how many may ever exist.
        self.observed_buckets: Dict[str, set] = {}
        self.quarantined: List[str] = []
        self.watchdog = watchdog or StepWatchdog()
        # The tuned schedule the decode path launches, for quarantine on a
        # guard trip (subclasses resolve it when tuning is on).
        self._paged_sched_key: Optional[str] = None
        self._rid = 0
        self.requests: List[Request] = []

    # -- compute hooks (subclass responsibility) ---------------------------
    def _dispatch(self, which: str, args: tuple):
        """Run one primary model step; returns ``(logits, state)``."""
        raise NotImplementedError

    def _dispatch_fallback(self, which: str, args: tuple):
        """Run the NaN guard's re-run of one model step from its pre-call
        state."""
        raise NotImplementedError

    def _exec_chunk(self, w):
        """Execute one prefill chunk's compute against the device state.
        Must return the sampled token when ``w.last`` (the chunk whose
        final row is the prompt's last true position), else None."""
        raise NotImplementedError

    def _exec_decode(self, active_np: np.ndarray) -> np.ndarray:
        """Execute one decode step's compute; returns sampled tokens
        indexed by slot (inactive slots' entries are ignored)."""
        raise NotImplementedError

    def _capture_spill(self, req: Request, page_ids: List[int]) -> Dict:
        """Device->host copy of a victim's committed pages (plus any
        per-slot recurrent state): the opaque host-pool payload."""
        raise NotImplementedError

    def _apply_restore(self, req: Request, slot: int, spill) -> None:
        """Host->device copy of a spill payload into a fresh slot."""
        raise NotImplementedError

    def _sync_tables(self, slots) -> None:
        """Push the allocator's block tables for ``slots`` to the device
        state. Default: no-op (tensor-free executors keep no tables)."""

    def _bucket_key(self, which: str, args: tuple):
        """The compile-bucket a dispatch lands in (jit-audit census)."""
        return ()

    # -- observability -----------------------------------------------------
    def now(self) -> float:
        """The engine clock (monotonic by default). ``submit(deadline=)``
        timestamps must come from this domain: ``engine.now() + rel_s``,
        never ``time.time() + rel_s``."""
        return self.clock()

    @property
    def counters(self) -> Dict[str, int]:
        """Read-only robustness-counter view over the metrics registry
        (the pre-obs ``engine.counters`` dict shape, kept for callers;
        new code should read ``engine.metrics`` directly)."""
        return {"retries": int(self.metrics.value("retries")),
                "fallbacks": int(self.metrics.value("fallbacks"))}

    def _step_gauges(self) -> None:
        """Per-iteration occupancy gauges (registry + tracer counter
        track): arena pages, live/prefilling slots, queue depth."""
        t = self.clock()
        used = self.alloc.used_pages
        live = sum(1 for r in self.sched.running.values()
                   if not r.prefilling)
        depth = len(self.sched.queue)
        self.metrics.gauge("arena_used_pages").set(used, t)
        self.metrics.gauge("arena_utilization").set(
            self.alloc.utilization, t)
        self.metrics.gauge("live_slots").set(live, t)
        self.metrics.gauge("running_slots").set(
            len(self.sched.running), t)
        self.metrics.gauge("queue_depth").set(depth, t)
        if self.tracer is not None:
            self.tracer.counter("arena_pages", used=used,
                                free=self.alloc.free_pages)
            self.tracer.counter("slots", live=live,
                                running=len(self.sched.running))
            self.tracer.counter("queue_depth", depth=depth)

    # -- submission --------------------------------------------------------
    def _bucket(self, n: int) -> int:
        return -(-max(1, n) // self.prefill_pad) * self.prefill_pad

    def submit(self, prompt, max_new_tokens: int, *,
               eos_id: int = -1, priority: int = 0,
               deadline: Optional[float] = None) -> Request:
        """``priority``/``deadline`` feed the scheduler's admission order
        (no-ops under the default FIFO policy); ``deadline`` is an
        absolute timestamp in the ENGINE clock's domain
        (``engine.now() + rel_s`` -- monotonic by default, not
        ``time.time()``)."""
        prompt = np.asarray(prompt, np.int32)
        need = self._bucket(len(prompt)) + self.model_cfg.n_meta_tokens
        cap = min(self.max_pages_per_seq,
                  self.alloc.n_pages) * self.page_size
        if need > cap:
            raise ValueError(f"prompt of {len(prompt)} tokens can never be "
                             f"admitted (cache capacity {cap} tokens, "
                             f"max_context={self.max_context})")
        req = Request(rid=self._rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      priority=priority, deadline=deadline)
        self._rid += 1
        self.requests.append(req)
        self.sched.submit(req)
        return req

    # -- token commit ------------------------------------------------------
    def _record_token(self, req: Request, tok: np.ndarray,
                      now: float) -> None:
        req.generated.append(tok if tok.ndim else int(tok))
        if req.t_first_token is None:
            req.t_first_token = now
        else:
            req.itl_s.append(now - req.t_last_token)
        req.t_last_token = now
        self._next_token[req.slot] = tok
        if self.tracer is not None:
            self.tracer.instant("token", cat="request",
                                tid=otrace.req_tid(req.rid),
                                n=req.n_generated)
        done = req.n_generated >= req.max_new_tokens
        if self.model_cfg.n_codebooks == 1 and int(tok) == req.eos_id:
            done = True
        if done:
            if self.tracer is not None and req.t_first_token is not None:
                # The request's decode phase as one span: first token
                # (end of prefill) to last.
                self.tracer.complete("decode", req.t_first_token, now,
                                     cat="request",
                                     tid=otrace.req_tid(req.rid),
                                     tokens=req.n_generated)
            self.sched.finish(req)

    # -- KV lifecycle: host offload (scheduler-wired hooks) ----------------
    def _spill(self, req: Request, page_ids: List[int],
               committed: int) -> bool:
        """Host-pool spill of a preemption victim's committed pages. Runs
        BEFORE ``free_slot`` re-issues the pages; the :meth:`_capture_spill`
        hook forces the device->host copy to complete while contents are
        still exclusively owned. Returns False (degrade to recompute) on
        an injected ``offload_io@spill`` fault or when the pool rejects
        the entry."""
        inj = self.faults
        if inj is not None and inj.offload_fails("spill"):
            return False
        if not page_ids:
            return False
        payload = self._capture_spill(req, page_ids)
        ok = self.alloc.host_put(req.rid, len(page_ids), committed, payload)
        if ok:
            self.metrics.counter("offload_spills").inc()
        return ok

    def _restore(self, req: Request, slot: int, committed: int) -> bool:
        """Host-pool restore into a freshly allocated slot (the scheduler
        allocated BEFORE calling, so the target pages exist and are
        exclusive; :meth:`_apply_restore` performs the copies). Returns
        False to degrade the admission to recompute: injected
        ``offload_io@restore`` fault, or a stale/missing spill entry."""
        inj = self.faults
        if inj is not None and inj.offload_fails("restore"):
            self.alloc.host_drop(req.rid)
            return False
        sp = self.alloc.host_take(req.rid)
        if sp is None or sp.tokens != committed:
            return False
        self._apply_restore(req, slot, sp)
        self.metrics.counter("offload_restores").inc()
        return True

    # -- robustness envelope ----------------------------------------------
    def _quarantine(self, site: str) -> None:
        """Bar the tuned schedule behind a guard trip from future
        resolution (PlanCache.quarantine). Only the decode path maps 1:1
        to one tuned schedule (the paged-attention key the page size was
        resolved under); prefill trips still fall back + count, but have
        no single schedule to blame."""
        key = self._paged_sched_key if site == "decode" else None
        if key is None or key in self.quarantined:
            return
        from repro_torch import tune
        tune.get_cache().quarantine(key)
        self.quarantined.append(key)

    def _run_guarded(self, site: str, which: str, args: tuple):
        """One model step under the robustness envelope.

        Order of events: (1) injected transient failures raise before
        the step's call, or from an op inside it, and retry with bounded
        exponential backoff from the step's pre-call state (``_dispatch``
        puts back what a failed step wrote), so a retry is a plain
        re-dispatch; (2) the injector may poison the returned logits
        (host-level: the kernels stay identical to the fault-free run);
        (3) with ``nan_guard`` on, non-finite logits trigger one re-run of
        the SAME step from the SAME pre-call state, the tuned schedule is
        quarantined, and the fallback is counted in telemetry. A re-run
        that still produces non-finite logits means a kernel fault or a
        diverged model -- that raises, because sampling from NaN logits
        would silently emit garbage tokens.
        """
        self.observed_buckets.setdefault(which, set()).add(
            self._bucket_key(which, args))
        inj = self.faults
        for attempt in range(self.max_step_retries + 1):
            try:
                if inj is not None:
                    inj.check_transient(site)
                logits, state = self._dispatch(which, args)
                break
            except rfaults.TransientOpError:
                self.metrics.counter("retries", site=site).inc()
                if self.tracer is not None:
                    self.tracer.instant("retry", cat="engine", site=site,
                                        which=which, attempt=attempt + 1)
                if attempt == self.max_step_retries:
                    raise
                if self.retry_backoff_s:
                    time.sleep(self.retry_backoff_s * (2 ** attempt))
        if inj is not None and logits is not None:
            logits = inj.poison(site, logits)
        if self.nan_guard and logits is not None and \
                not _all_finite(logits):
            self.metrics.counter("fallbacks", site=site).inc()
            if self.tracer is not None:
                self.tracer.instant("fallback", cat="engine", site=site,
                                    which=which)
            self._quarantine(site)
            logits, state = self._dispatch_fallback(which, args)
            if not _all_finite(logits):
                raise FloatingPointError(
                    f"non-finite logits at {site!r} survived a re-run of "
                    f"the step from its pre-call state: a kernel fault or "
                    f"model divergence, not an injected fault")
        return logits, state

    # -- execution (control skeletons over the compute hooks) --------------
    def _do_prefill_chunk(self, w) -> None:
        """Execute one scheduler-issued prefill chunk: run the compute
        hook, then commit the accounting (cache_len, prefix publication)
        and -- for the last chunk -- record the sampled token."""
        req, slot = w.req, w.slot
        if req.state != "running" or req.slot != slot:
            # The scheduler finished or preempted this request AFTER
            # emitting the chunk (sole-runner truncation later in the same
            # pass): its pages are freed -- executing the chunk would
            # scatter into a zero table row over pages the allocator may
            # already have re-issued.
            return
        t0 = self.clock()
        tok = self._exec_chunk(w)
        req.cache_len = w.true_end
        req.n_chunks += 1
        self.sched.note_committed(req)
        if self.tracer is not None:
            if w.first and w.last:
                self.tracer.complete("prefill", t0, cat="request",
                                     tid=otrace.req_tid(req.rid), slot=slot,
                                     tokens=w.true_end)
            else:
                self.tracer.complete(
                    f"prefill_chunk[{req.n_chunks - 1}]", t0, cat="request",
                    tid=otrace.req_tid(req.rid), slot=slot, start=w.start,
                    end=w.true_end, last=w.last)
        if w.last:
            self._record_token(req, tok, self.clock())

    def _do_decode(self) -> None:
        active_np = np.zeros((self.max_slots,), bool)
        for slot, req in self.sched.running.items():
            # Mid-prefill slots hold pages but must not decode: inactive
            # slots write the trash page and keep frozen lengths, so a
            # partially-prefilled cache can never be touched.
            active_np[slot] = not req.prefilling
        last = self._exec_decode(active_np)
        now = self.clock()
        for slot, req in list(self.sched.running.items()):
            if req.prefilling:
                continue
            req.cache_len += 1
            self._record_token(req, last[slot], now)

    # The two step phases, exposed individually so the model checker can
    # interleave them as atomic actions; step() composes exactly these, so
    # the checked control flow and the served control flow are one code
    # path (no re-model to drift).
    def control_prefill(self, admit_new: bool = True) -> int:
        """Admission-boundary phase: shed expired deadlines, execute the
        scheduler's prefill chunk queue, drain unservable rejections.
        Returns the number of chunks executed."""
        self.sched.shed_expired()
        ws = self.sched.prefill_schedule(admit_new=admit_new)
        for w in ws:
            self._do_prefill_chunk(w)
        for req in self.sched.rejected:
            # Regrew past the arena while preempted: finish truncated.
            self.sched.finish(req, truncated=True)
        self.sched.rejected = []
        return len(ws)

    def control_decode(self) -> None:
        """Decode-boundary phase: ensure every running slot can take one
        more token (preempting by eviction under pressure), shed expired
        deadlines, decode one token per fully-prefilled running slot."""
        new_pages, _evicted, _trunc = self.sched.ensure_decode_capacity()
        if new_pages:
            self._sync_tables({slot for slot, _ in new_pages})
        self.sched.shed_expired()
        if any(not r.prefilling for r in self.sched.running.values()):
            self._do_decode()

    def step(self) -> None:
        """One scheduler iteration: shed expired deadlines (admission
        boundary), prefill (whole prompts, or chunks interleaved at
        ``prefill_chunk`` granularity), ensure decode capacity (preempting
        by eviction under pressure), shed expired deadlines again (decode
        boundary), decode one token for every fully-prefilled running
        slot. With faults on, the injector runs first: straggler sleeps
        and one iteration's worth of arena pressure (pages withheld for
        the whole step, so the scheduler's can_admit-then-alloc protocol
        stays consistent, then released). With ``assert_invariants`` on
        (``GEMMINI_CHECK``), the allocator's ownership oracle runs at the
        step boundary."""
        t0 = self.clock()
        inj = self.faults
        held = 0
        if inj is not None:
            inj.straggle("step")
            k = inj.arena_pressure()
            if k:
                held = self.alloc.hold_pages(k)
        try:
            admit_new = not (self.policy == "static" and self.sched.running)
            self.control_prefill(admit_new=admit_new)
            self.control_decode()
        finally:
            if held:
                self.alloc.release_held()
            if self.assert_invariants:
                self.alloc.check()
            self._step_gauges()
            if self.tracer is not None:
                self.tracer.complete("step", t0, cat="engine",
                                     tid=otrace.TID_ENGINE)

    def run(self) -> Dict:
        """Drain the queue; returns {summary, requests} telemetry.

        Every submitted request reaches a terminal status before this
        returns: ``finished`` (possibly ``truncated``) or ``shed`` --
        the no-silent-loss invariant the chaos suite asserts."""
        t0 = self.clock()
        iters = 0
        while self.sched.has_work:
            ts = self.clock()
            self.step()
            self.watchdog.observe(self.clock() - ts)
            iters += 1
            if iters > self.max_run_iters:
                raise RuntimeError(
                    "serving loop did not converge\n" + self._hang_report())
        wall = self.clock() - t0
        summary = summarize(self.requests, wall)
        # Deterministic structural metric alongside the wall-clock ones:
        # continuous batching's win IS fewer engine iterations for the same
        # token count (slot recycling), independent of host noise.
        summary["iterations"] = float(iters)
        # Robustness counters (all 0 on a fault-free engine) + step-latency
        # percentiles from the watchdog: the BENCH_serving robustness row.
        # Counters read from the metrics registry (labels aggregated);
        # occupancy gauges contribute their run peaks (*_peak keys).
        summary["retries"] = self.metrics.value("retries")
        summary["fallbacks"] = self.metrics.value("fallbacks")
        summary["injected_faults"] = float(
            self.faults.total_injected if self.faults else 0)
        # KV-lifecycle counters (all 0 with both features off): prefill
        # positions actually computed, positions skipped via CoW prefix
        # hits, and the restore-vs-recompute restart split.
        for k in ("prefill_tokens", "prefix_hit_tokens", "offload_spills",
                  "offload_restores", "restarts_restored",
                  "restarts_recomputed"):
            summary[k] = self.metrics.value(k)
        summary.update(self.metrics.gauge_peaks())
        summary.update(self.watchdog.stats())
        report = {"summary": summary,
                  "requests": [self._req_report(r) for r in self.requests],
                  "quarantined": list(self.quarantined)}
        if self.faults is not None:
            report["faults"] = self.faults.report()
        return report

    def _hang_report(self, last_events: int = 32) -> str:
        """Diagnostic dump for a non-converging serving loop: scheduler
        queues, per-slot request states, allocator occupancy, robustness
        counters, and (when tracing is on) the last trace events -- so a
        hung engine is debuggable from the exception alone."""
        lines = ["-- engine hang diagnostics --"]
        q = [(r.rid, r.state, r.n_preempted, len(r.serve_prompt()))
             for r in self.sched.queue]
        lines.append(f"queue ({len(q)}): "
                     + ", ".join(f"rid={rid}[{st},pre={pre},len={ln}]"
                                 for rid, st, pre, ln in q[:16])
                     + (" ..." if len(q) > 16 else ""))
        for slot in sorted(self.sched.running):
            r = self.sched.running[slot]
            lines.append(
                f"slot {slot}: rid={r.rid} state={r.state} "
                f"cache_len={r.cache_len} prefill={r.prefill_pos}/"
                f"{r.prefill_target} gen={r.n_generated}/"
                f"{r.max_new_tokens} pages={len(self.alloc.slot_pages(slot))}")
        lines.append(
            f"allocator: {self.alloc.used_pages}/{self.alloc.n_pages} pages "
            f"used ({self.alloc.utilization:.0%}), "
            f"{self.alloc.held_pages} held, page_size={self.alloc.page_size}, "
            f"max_pages_per_seq={self.alloc.max_pages_per_seq}")
        lines.append(f"counters: {self.metrics.counters_flat()}")
        if self.tracer is not None:
            tail = self.tracer.tail(last_events)
            lines.append(f"last {len(tail)} trace events "
                         f"({self.tracer.dropped} dropped):")
            for ev in tail:
                lines.append(f"  {ev.get('ts', 0.0):>12.1f}us "
                             f"{ev.get('cat', '?')}/{ev.get('name', '?')} "
                             f"{ev.get('args', '')}")
        else:
            lines.append("tracing disabled (GEMMINI_TRACE / trace= would "
                         "append the last trace events here)")
        return "\n".join(lines)

    def _req_report(self, r: Request) -> Dict:
        itl = np.asarray(r.itl_s) if r.itl_s else None
        return {"rid": r.rid, "prompt_tokens": int(len(r.prompt)),
                "new_tokens": r.n_generated,
                "tokens": np.asarray(r.generated),
                "status": r.state, "shed_reason": r.shed_reason,
                "preempted": r.n_preempted, "truncated": r.truncated,
                "prefill_chunks": r.n_chunks,
                "ttft_s": (r.t_first_token - r.submitted_at)
                if r.t_first_token else None,
                "itl_p50_s": float(np.percentile(itl, 50))
                if itl is not None else None,
                "itl_p95_s": float(np.percentile(itl, 95))
                if itl is not None else None,
                "latency_s": (r.t_finished - r.submitted_at)
                if r.t_finished else None}

    # -- maintenance -------------------------------------------------------
    def defrag(self) -> None:
        """Compact live pages to the arena front (accounting only here;
        ``ServingEngine.defrag`` additionally permutes the device pools)."""
        self.alloc.defrag()



def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> numpy payload; bf16 travels as its raw 16-bit
    pattern (numpy has no bfloat16), so the round trip is exact."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _to_device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


class ServingEngine(EngineControlPlane):
    """Continuous-batching executor for one model on one device.

    Knobs follow ``repro.serving.ServingEngine``: ``max_slots`` /
    ``max_context`` / ``page_size`` / ``n_pages`` (decode batch width and
    paged-arena geometry), ``engine_cfg`` (the GEMM datapath; default bf16
    in, fp32 accumulate, bf16 out), ``prefill_token_budget``,
    ``prefill_chunk`` (None or negative = single pass, 0 = one page),
    ``policy``, ``admission_policy``, ``faults`` / ``nan_guard`` /
    ``max_step_retries`` / ``retry_backoff_s`` / ``enforce_deadlines``
    (the robustness envelope: ``faults=None`` consults
    ``$GEMMINI_FAULTS``; the guard is on iff faults are, unless
    ``nan_guard`` says otherwise), ``assert_invariants``, ``kv_offload`` /
    ``host_pool_pages`` / ``prefix_cache``, ``watchdog``, ``trace`` and
    ``clock``; ``warm_prompt_lens`` pre-resolves every tuned schedule the
    given prompt lengths will launch (:meth:`warm`; only with tuning on).

    ``device`` (default ``"cuda"``) decides the datapath: on a CUDA
    device every projection and attention runs its hand-written kernel;
    on ``"cpu"`` they run their plain versions. There is no backend knob
    and no silent fallback: asking for CUDA on a host without it raises,
    and a kernel that fails to build or launch raises. The NaN guard's
    counted re-run (``_dispatch_fallback``) launches the same kernels.
    ``params`` is the port's parameter tree (see
    :func:`repro_torch.convert.params_from_numpy`); ``None`` draws random
    weights from ``seed``.
    """

    def __init__(self, model_cfg, *, max_slots: int = 4,
                 max_context: int = 2048,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 engine_cfg: Optional[GemminiConfig] = None,
                 params=None, seed: int = 0,
                 temperature: float = 0.0,
                 prefill_token_budget: int = 512,
                 prefill_chunk: Optional[int] = None,
                 policy: str = "continuous",
                 admission_policy: str = "fifo",
                 faults=None,
                 nan_guard: Optional[bool] = None,
                 max_step_retries: int = 2,
                 retry_backoff_s: float = 0.0,
                 enforce_deadlines: bool = False,
                 assert_invariants: Optional[bool] = None,
                 kv_offload: bool = False,
                 host_pool_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 watchdog: Optional[StepWatchdog] = None,
                 trace=None,
                 clock=None,
                 device="cuda",
                 warm_prompt_lens=()):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine: CUDA is not available on this "
                               "host; pass device='cpu' for the plain path")
        super().__init__(model_cfg, max_slots=max_slots, policy=policy,
                         faults=faults, nan_guard=nan_guard,
                         max_step_retries=max_step_retries,
                         retry_backoff_s=retry_backoff_s,
                         assert_invariants=assert_invariants,
                         watchdog=watchdog, trace=trace, clock=clock)
        self.temperature = temperature
        self.max_context = max_context
        cfg = engine_cfg or GemminiConfig(input_dtype="bf16",
                                          acc_dtype="fp32",
                                          output_dtype="bf16")
        self.engine = ExecutionContext(cfg=cfg)
        # The NaN guard's re-run: the same kernels, no op hooks (an op
        # fault or timer fires once per step, on its primary call).
        self._rerun = dataclasses.replace(self.engine, hooks=False)
        # The recurrent-state rows of the step in flight (_run_guarded).
        self._pre_step = None

        # -- page geometry: the tuned schedule is the page size ------------
        decode_split = 0
        tuning = flags.get("tune_mode") != "off"
        if page_size is None:
            if tuning and model_cfg.has_attn:
                from repro_torch import tune
                sched = tune.resolve_paged_attn_schedule(
                    cfg, max_slots, model_cfg.n_heads, model_cfg.n_kv_heads,
                    model_cfg.head_dim, max_context, dtype=model_cfg.dtype,
                    device=self.device)
                page_size, decode_split = sched.page_size, sched.split_keys
            else:
                page_size = DEFAULT_PAGE_SIZE
        self.page_size = max(8, min(page_size, max_context))
        if decode_split:
            self.engine = dataclasses.replace(self.engine,
                                              decode_split=decode_split)
            self._rerun = dataclasses.replace(self._rerun,
                                              decode_split=decode_split)
        self.max_pages_per_seq = -(-max_context // self.page_size)
        if n_pages is None:
            # Budget-derived arena, capped at what running slots can hold.
            n_pages = max(self.max_pages_per_seq,
                          min(max_slots * self.max_pages_per_seq,
                              arena_pages(model_cfg, cfg, self.page_size)))
        self.kv_offload = bool(kv_offload)
        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache and model_cfg.has_ssm:
            # A prefix hit skips the chunks below the anchor, but an
            # SSM/hybrid family's recurrent state is a function of every
            # skipped position -- CoW pages cannot carry it.
            raise ValueError("prefix_cache requires an attention-only "
                             f"family; {model_cfg.name!r} has SSM state")
        self.alloc = PagedKVAllocator(
            n_pages, self.page_size, self.max_pages_per_seq,
            tracer=self.tracer,
            host_pool_pages=((host_pool_pages if host_pool_pages is not None
                              else n_pages) if self.kv_offload else 0))
        # Prompt bucketing is legal only for attention-only families, where
        # padded positions are dead under the causal and length masks; a
        # recurrent state would absorb the padding, so SSM and hybrid
        # families prefill at exact length.
        self.prefill_pad = 1 if model_cfg.has_ssm else self.page_size
        if prefill_chunk is not None and prefill_chunk < 0:
            prefill_chunk = None
        elif prefill_chunk == 0:
            prefill_chunk = self.page_size
        self.sched = ContinuousScheduler(
            self.alloc, max_slots,
            prefill_token_budget=prefill_token_budget,
            extra_tokens_per_prefill=model_cfg.n_meta_tokens,
            pad_to=self.prefill_pad,
            prefill_chunk=prefill_chunk,
            admission_policy=admission_policy,
            enforce_deadlines=enforce_deadlines,
            clock=self.clock, tracer=self.tracer, metrics=self.metrics,
            offload=self.kv_offload, prefix_cache=self.prefix_cache,
            spill_fn=self._spill, restore_fn=self._restore)
        self.prefill_chunk = self.sched.prefill_chunk
        if policy == "static":
            self.sched.prefill_token_budget = 1 << 30

        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        if params is None:
            params = tf.init_params(self._gen, model_cfg, device=self.device)
        self.params = params
        self.state = tf.init_paged_state(model_cfg, max_slots, n_pages,
                                         self.page_size,
                                         self.max_pages_per_seq,
                                         dtype=model_cfg.dtype,
                                         device=self.device)
        # The tuned schedule the decode path launches, for quarantine on a
        # guard trip: the key resolve_paged_attn_schedule resolved the page
        # size under (None with tuning off, or without attention).
        if model_cfg.has_attn and tuning:
            from repro_torch.tune import schedules as tsched
            self._paged_sched_key = tsched.paged_attn_cache_key(
                max_slots, model_cfg.n_heads, model_cfg.n_kv_heads,
                model_cfg.head_dim, max_context, window=None,
                dtype=model_cfg.dtype, device=self.device)
        tok_shape = (max_slots,) if model_cfg.n_codebooks == 1 \
            else (max_slots, model_cfg.n_codebooks)
        self._next_token = np.zeros(tok_shape, np.int32)
        self.warm_stats: Optional[Dict[str, int]] = None
        if warm_prompt_lens and tuning:
            self.warm_stats = self.warm(warm_prompt_lens)

    # -- plan warm-up ------------------------------------------------------
    def warm(self, prompt_lens) -> Dict[str, int]:
        """Pre-resolve every schedule the engine will launch (the JAX
        engine's ``warm``): prefill GEMM and flash shapes per first-chunk
        length (batch 1), continuation chunks' GEMMs, decode GEMMs at the
        slot batch, and the paged schedule the pools were sized with -- so
        no request tunes, or misses the cache, on the request path.
        Continuation chunks launch no flash: their attention is the
        block-table kernel, whose schedule is the page size."""
        from repro_torch import tune
        totals: Dict[str, int] = {}
        # Prefill runs at bucket + meta tokens (embed_inputs prepends them).
        first, rest = set(), set()
        for p in prompt_lens:
            dummy = Request(rid=-1,
                            prompt=np.zeros((max(1, int(p)),), np.int32),
                            max_new_tokens=0)
            spans = self.sched._chunk_spans(dummy)
            first.add(spans[0][2])
            for (s, _e, pe) in spans[1:]:
                rest.add(pe - s)
        kw = dict(device=self.device)
        for i, b in enumerate(sorted(first)):
            st = tune.warm_model_plans(
                self.engine.cfg, self.model_cfg, 1, b, include_decode=False,
                paged_slots=self.max_slots if i == 0 else 0,
                paged_max_context=self.max_context, **kw)
            totals = {k: totals.get(k, 0) + v for k, v in st.items()}
        for b in sorted(rest - first):
            st = tune.warm_model_plans(self.engine.cfg, self.model_cfg, 1, b,
                                       include_decode=False,
                                       include_attention=False, **kw)
            totals = {k: totals.get(k, 0) + v for k, v in st.items()}
        st = tune.warm_model_plans(self.engine.cfg, self.model_cfg,
                                   self.max_slots, 1,
                                   include_attention=False, **kw)
        return {k: totals.get(k, 0) + v for k, v in st.items()}

    # -- sampling ----------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """logits: (..., V) -> token ids; greedy (first index on ties, as
        ``jnp.argmax``) unless temperature > 0."""
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        probs = torch.softmax(logits.to(torch.float32) / self.temperature, -1)
        flat = probs.reshape(-1, probs.shape[-1])
        tok = torch.multinomial(flat, 1, generator=self._gen)
        return tok.reshape(probs.shape[:-1]).to(torch.int32).cpu().numpy()

    # -- device state ------------------------------------------------------
    def _table_row(self, slot: int) -> np.ndarray:
        row = np.zeros((self.max_pages_per_seq,), np.int32)
        pages = self.alloc.slot_pages(slot)
        row[:len(pages)] = pages
        return row

    def _sync_tables(self, slots) -> None:
        # In place: the decode kernel reads the tables where they live.
        for slot in slots:
            self.state.tables[slot] = torch.from_numpy(self._table_row(slot))

    def _set_length(self, slot: int, n: int) -> None:
        self.state.lengths[slot] = n

    # -- KV lifecycle compute hooks ----------------------------------------
    def _capture_spill(self, req: Request, page_ids: List[int]) -> Dict:
        """Device->host copy of a preemption victim's committed pages (plus
        its slot's conv / SSM state); the host copy completes before the
        pages can be re-issued."""
        st = self.state
        payload: Dict = {}
        if st.kv_k is not None:
            idx = torch.as_tensor(page_ids, dtype=torch.int64,
                                  device=self.device)
            payload["kv_k"] = _to_host(st.kv_k[:, :, idx])
            payload["kv_v"] = _to_host(st.kv_v[:, :, idx])
        if st.conv is not None:
            payload["conv"] = _to_host(st.conv[:, req.slot])
            payload["ssm"] = _to_host(st.ssm[:, req.slot])
        return payload

    def _apply_restore(self, req: Request, slot: int, spill) -> None:
        """Host->device copy of a spilled victim's pages into the freshly
        allocated slot's pages, and of its recurrent state into the slot."""
        st, pl = self.state, spill.payload
        if st.kv_k is not None:
            pages = self.alloc.slot_pages(slot)[:spill.n_pages]
            idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
            st.kv_k[:, :, idx] = _to_device(pl["kv_k"], st.kv_k)
            st.kv_v[:, :, idx] = _to_device(pl["kv_v"], st.kv_v)
        if st.conv is not None:
            st.conv[:, slot] = _to_device(pl["conv"], st.conv)
            st.ssm[:, slot] = _to_device(pl["ssm"], st.ssm)

    # -- model steps -------------------------------------------------------
    def _run_guarded(self, site: str, which: str, args: tuple):
        """The control plane's envelope around a copy of the recurrent-state
        rows the step overwrites, taken when the step can be run twice (the
        NaN guard is on, or an injector is installed for the op hooks) and
        dropped once the step is accepted. The steps write the KV pools and
        the recurrent state in place; a second run rewrites the same KV
        rows, and the recurrent rows are put back first."""
        self._pre_step = self._recurrent_snapshot(which, args) \
            if self.nan_guard or rfaults._ACTIVE is not None else None
        try:
            return super()._run_guarded(site, which, args)
        finally:
            self._pre_step = None

    def _dispatch(self, which: str, args: tuple):
        try:
            return self._step(self.engine, which, args)
        except rfaults.TransientOpError:
            # An op failed mid-step: the retry starts from the state the
            # step received.
            self._restore_pre_step(args)
            raise

    def _dispatch_fallback(self, which: str, args: tuple):
        """The step again, on the same kernels with the op hooks off, from
        the state the primary step received."""
        self._restore_pre_step(args)
        return self._step(self._rerun, which, args)

    def _recurrent_snapshot(self, which: str, args: tuple):
        """(rows, conv, ssm): copies of the recurrent-state rows the step
        reads and overwrites (the chunk's slot, or a decode step's active
        slots), or None where it reads none (attention-only families, and
        a fresh prefill, which starts its slot from zeros)."""
        st = args[2]
        if st.conv is None or which in ("prefill", "prefill_nl"):
            return None
        if which in ("chunk", "chunk_nl"):
            rows = slice(args[3], args[3] + 1)
            return rows, st.conv[:, rows].clone(), st.ssm[:, rows].clone()
        rows = torch.nonzero(args[3]).flatten()     # indexing copies
        return rows, st.conv[:, rows], st.ssm[:, rows]

    def _restore_pre_step(self, args: tuple) -> None:
        if self._pre_step is not None:
            rows, conv, ssm = self._pre_step
            st = args[2]
            st.conv[:, rows] = conv
            st.ssm[:, rows] = ssm

    def _step(self, ctx, which: str, args: tuple):
        mc, ps = self.model_cfg, self.page_size
        if which in ("prefill", "prefill_nl"):
            p, tok, st, slot, pages = args
            return tf.paged_prefill(ctx, p, mc, tok, st, slot, pages,
                                    page_size=ps,
                                    with_logits=which == "prefill")
        if which in ("chunk", "chunk_nl"):
            p, tok, st, slot, pages, start, kv_pages = args
            return tf.paged_prefill_chunk(ctx, p, mc, tok, st, slot, pages,
                                          start, page_size=ps,
                                          with_logits=which == "chunk",
                                          kv_pages=kv_pages)
        if which == "decode":
            p, tok, st, act = args
            return tf.paged_decode_step(ctx, p, mc, tok, st, act, page_size=ps)
        raise ValueError(f"unknown step {which!r}")

    @staticmethod
    def _bucket_key(which: str, args: tuple):
        """The shape bucket a dispatch lands in (the JAX engine's
        compile-bucket census: token-block length plus kv_pages)."""
        if which in ("prefill", "prefill_nl"):
            return (int(args[1].shape[1]),)
        if which in ("chunk", "chunk_nl"):
            return (int(args[1].shape[1]), args[6])
        return ()

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(toks)).to(self.device)

    # -- execution compute hooks -------------------------------------------
    def _exec_chunk(self, w):
        """One prefill chunk's device work (see the JAX engine's
        ``_exec_chunk``): single-span chunks run the whole-prompt path,
        first chunks the fresh prefill, continuation chunks the
        paged-prefill chunk. Only the last chunk samples and makes the
        slot's device length live. Chunk spans count cache positions, so
        hymba's meta tokens (prepended by the first chunk) shift the prompt
        slice."""
        req, slot = w.req, w.slot
        meta = self.model_cfg.n_meta_tokens
        prompt = req.serve_prompt()
        if w.first and w.last:
            toks = prompt
            pad = self._bucket(len(prompt)) - len(prompt)
            if pad:
                toks = np.pad(toks, ((0, pad),) + ((0, 0),) * (toks.ndim - 1))
            row = self._tokens(self._table_row(slot))
            logits, self.state = self._run_guarded(
                "prefill", "prefill",
                (self.params, self._tokens(toks[None]), self.state, slot,
                 row))
            true_len = len(prompt) + meta
            self._set_length(slot, true_len)
            self._sync_tables([slot])
            return self._sample(logits[0, true_len - 1])
        toks = prompt[max(0, w.start - meta): w.true_end - meta]
        pad = (w.padded_end - w.true_end)
        if pad:
            toks = np.pad(toks, ((0, pad),) + ((0, 0),) * (toks.ndim - 1))
        row = self._tokens(self._table_row(slot))
        if w.first:
            which = "prefill" if w.last else "prefill_nl"
            logits, self.state = self._run_guarded(
                "prefill", which,
                (self.params, self._tokens(toks[None]), self.state, slot,
                 row))
        else:
            # Static dead-key bound: the pages the whole (padded) prompt
            # will ever occupy (PrefillChunk.kv_pages).
            which = "chunk" if w.last else "chunk_nl"
            logits, self.state = self._run_guarded(
                "chunk", which,
                (self.params, self._tokens(toks[None]), self.state, slot, row,
                 int(w.start), w.kv_pages or None))
        if not w.last:
            return None
        self._sync_tables([slot])
        true_len = len(prompt) + meta
        self._set_length(slot, true_len)
        return self._sample(logits[0, (true_len - 1) - w.start])

    def _exec_decode(self, active_np: np.ndarray) -> np.ndarray:
        toks = self._tokens(self._next_token[:, None])      # (slots, 1[, n_q])
        active = self._tokens(active_np)
        logits, self.state = self._run_guarded(
            "decode", "decode", (self.params, toks, self.state, active))
        return self._sample(logits[:, -1])

    # -- maintenance -------------------------------------------------------
    def defrag(self) -> None:
        """Compact live pages to the arena front: permute the device pools
        (the trash page stays last) and rewrite every slot's table."""
        perm = self.alloc.defrag()
        st = self.state
        if st.kv_k is not None:
            inv = np.argsort(perm)
            idx = torch.as_tensor(np.concatenate([inv, [self.alloc.n_pages]]),
                                  dtype=torch.int64, device=self.device)
            st.kv_k.copy_(st.kv_k.index_select(2, idx))
            st.kv_v.copy_(st.kv_v.index_select(2, idx))
        self._sync_tables(list(self.sched.running))
