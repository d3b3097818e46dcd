"""Control-plane model checker (docs/analysis.md#model-checker).

Explicit-state bounded model checking of the serving control plane: the
REAL :class:`~repro_torch.serving.scheduler.ContinuousScheduler`,
:class:`~repro_torch.serving.paged_cache.PagedKVAllocator`, and
:class:`~repro_torch.serving.engine.EngineControlPlane` recovery logic -- not a
re-model -- driven through every interleaving of a bounded action
alphabet (submit, prefill-chunk commit, decode commit, preempt, defrag,
host-pool LRU eviction, deadline tick, fault arm/fire) over small
configurations (2-4 slots, 8-16 pages, 2-4 requests).

The split that makes this possible is the engine's control/compute seam:
:class:`~repro_torch.analysis.mc.harness.NullEngine` implements the compute
hooks with fabricated deterministic token commits, so a state is pure
Python (deepcopy-able, canonically hashable) and a few microseconds to
step.

* `harness` -- the null executor + the bounded configurations,
* `actions` -- the action alphabet (enablement + application),
* `canon`   -- canonical state hashing (page/seq relabeling) for
  memoization,
* `invariants` -- per-transition safety (GL801-805, GL807) and the
  graph-level wedge/liveness checks (GL804, GL806),
* `explore` -- BFS exploration, counterexample minimization, replay,
* `__main__` -- the CLI + CI gate (`python -m repro_torch.analysis.mc`),
  reporting violations as GL8xx findings through the `analysis/lint`
  findings/baseline machinery (empty baseline policy: a counterexample
  is a bug to fix + a regression to lock, never a baseline entry).
"""

from repro_torch.analysis.mc.harness import (        # noqa: F401
    ALL_CONFIGS, CONFIGS, SELFTEST_CONFIGS, LogicalClock, MCConfig,
    NullEngine, build_engine)
# NOTE: the explore() FUNCTION is deliberately not re-exported here --
# it would shadow the `explore` submodule attribute on this package and
# make `from repro_torch.analysis.mc import explore` ambiguous. Import it from
# the submodule: `from repro_torch.analysis.mc.explore import explore`.
from repro_torch.analysis.mc.explore import (        # noqa: F401
    MCResult, Violation, format_spec, minimize, parse_spec, replay)
