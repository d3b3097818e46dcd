"""The bounded action alphabet the checker interleaves.

Each action is one atomic control-plane transition on a
:class:`~repro_torch.analysis.mc.harness.NullEngine`:

* ``submit``        -- submit the next workload request
* ``prefill``       -- one admission-boundary phase (``control_prefill``:
  shed expired, admit/restore/prefix-match, execute exactly one prefill
  chunk under the budget-1 rule, drain rejections)
* ``decode``        -- one decode-boundary phase (``control_decode``:
  ensure capacity with eviction under pressure, shed expired, commit one
  token per active slot)
* ``preempt``       -- evict the scheduler's canonical victim (the
  youngest-admitted runner) mid-flight
* ``defrag``        -- arena compaction
* ``host_evict``    -- host-pool LRU eviction (capacity pressure as an
  explicit action rather than only a side effect of ``host_put``)
* ``tick``          -- advance the logical clock by 1 (deadline progress)
* ``fault:<kind>``  -- arm a one-shot (p=1, max=1) injector of ``kind``;
  it fires inside whatever phase next visits a matching site, and the
  spent injector retires to ``eng.mc_fired`` so exploration state stays
  finite

``prefill`` and ``decode`` are exactly the two sub-phases
``EngineControlPlane.step`` composes, so every interleaving the checker
drives is a behavior of the real engine loop (plus the adversarial ones
-- back-to-back decodes, preempt-during-prefill -- that a fault or
multi-host scheduler could induce).
"""

from __future__ import annotations

from typing import List

from repro_torch.runtime import faults as rfaults
from repro_torch.analysis.mc.harness import MCConfig, NullEngine


def enabled_actions(eng: NullEngine) -> List[str]:
    cfg: MCConfig = eng.mc_cfg
    s = eng.sched
    acts: List[str] = []
    if len(eng.requests) < len(cfg.prompts):
        acts.append("submit")
    if s.queue or any(r.prefilling for r in s.running.values()):
        acts.append("prefill")
    if any(not r.prefilling for r in s.running.values()):
        acts.append("decode")
    if cfg.allow_preempt and s.running:
        acts.append("preempt")
    if cfg.allow_defrag and eng.alloc.used_pages > 0:
        acts.append("defrag")
    if cfg.kv_offload and eng.alloc._host:
        acts.append("host_evict")
    if cfg.enforce_deadlines and eng.clock.t < cfg.max_ticks:
        acts.append("tick")
    if eng.faults is None and len(eng.mc_fired) < cfg.max_faults:
        acts.extend(f"fault:{k}" for k in cfg.fault_kinds)
    return acts


def _arm_fault(eng: NullEngine, kind_spec: str) -> None:
    """Install a one-shot injector: p=1, full window, max_hits=1. Those
    bounds are what make dropping the injector's draw counters from the
    canonical hash sound -- firing depends only on hits remaining, never
    on how many draws went by."""
    kind, _, site = kind_spec.partition("@")
    site = site or ("*" if kind in ("nan", "inf", "transient")
                    else rfaults.DEFAULT_SITES.get(kind, "*"))
    plan = rfaults.FaultPlan(seed=0, specs=(
        rfaults.FaultSpec(kind=kind, site=site, p=1.0, max_hits=1),))
    eng.faults = rfaults.FaultInjector(plan)


def apply_action(eng: NullEngine, action: str) -> None:
    """Apply one alphabet action. Raises on an action that is not enabled
    in this state (replay of a minimized trace probes enablement first).
    """
    cfg: MCConfig = eng.mc_cfg
    if action == "submit":
        i = len(eng.requests)
        rel = cfg.deadlines[i] if i < len(cfg.deadlines) else None
        eng.submit(
            list(cfg.prompts[i]), cfg.max_new[i],
            deadline=(eng.now() + rel) if rel is not None else None)
    elif action == "prefill":
        eng.control_prefill(admit_new=True)
    elif action == "decode":
        eng.control_decode()
    elif action == "preempt":
        eng.sched.preempt(eng.sched._eviction_victim())
    elif action == "defrag":
        eng.defrag()
    elif action == "host_evict":
        eng.alloc.host_evict_lru()
    elif action == "tick":
        eng.clock.advance(1.0)
    elif action.startswith("fault:"):
        _arm_fault(eng, action[len("fault:"):])
    else:
        raise ValueError(f"unknown mc action {action!r}")
    # retire a spent one-shot injector: its kind is logged, its draw
    # counters leave the state
    if eng.faults is not None and eng.faults.total_injected >= 1:
        eng.mc_fired.append(eng.faults.plan.specs[0].kind)
        eng.faults = None
