"""Fault tolerance: heartbeats, straggler detection, restart/elastic loop.

The paper's evaluation point is that *system-level* behaviour (not the
kernel) decides delivered performance; at 1000+-node scale the dominant
system-level events are node failure and stragglers. This module provides
the control-plane pieces the launcher composes:

* :class:`HeartbeatMonitor` -- tracks per-host liveness marks; ``dead()``
  after a timeout names the lost hosts (in a real deployment the marks come
  from the cluster agent; tests drive it with a fake clock).
* :class:`StragglerDetector` -- EWMA + variance of step times; a step whose
  z-score exceeds the threshold flags a straggler so the launcher can log,
  exclude, or re-shard around the slow host.
* :class:`StepWatchdog` -- the serving-loop composition of the two:
  per-step latency telemetry + straggler flags + liveness beats
  (``ServingEngine.run`` drives it once per iteration).
* :func:`run_with_restarts` -- the restart loop: run the training callable;
  on failure restore the latest committed checkpoint and re-enter, possibly
  on a *shrunk* mesh (elastic scaling: lose a pod -> continue on the
  remaining pod; the checkpoint layer reshards transparently).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class HeartbeatMonitor:
    """Per-host liveness marks over an injectable clock.

    Membership is explicit: hosts are declared at construction (or via
    :meth:`register`), and a beat from an undeclared host raises by
    default. The silent-register alternative is a liveness hole -- a
    typo'd host id in the beat path would keep "h0-typo" alive forever
    while the real ``h0`` quietly times out and nothing names it dead.
    ``strict=False`` downgrades the raise to a flag: the beat is dropped
    (never counted as liveness) and the offender lands in
    ``unknown_beats`` for the launcher to log.
    """

    def __init__(self, hosts: List[str], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 strict: bool = True):
        self.timeout = timeout_s
        self.clock = clock
        self.strict = strict
        now = clock()
        self.last: Dict[str, float] = {h: now for h in hosts}
        self.unknown_beats: Dict[str, int] = {}

    def register(self, host: str) -> None:
        """Declare a new member host (its clock starts now)."""
        self.last[host] = self.clock()

    def beat(self, host: str):
        if host not in self.last:
            if self.strict:
                raise KeyError(
                    f"heartbeat from unknown host {host!r}; known hosts: "
                    f"{sorted(self.last)} (register() it first)")
            self.unknown_beats[host] = self.unknown_beats.get(host, 0) + 1
            return
        self.last[host] = self.clock()

    def dead(self) -> List[str]:
        now = self.clock()
        return [h for h, t in self.last.items() if now - t > self.timeout]

    def alive(self) -> List[str]:
        d = set(self.dead())
        return [h for h in self.last if h not in d]


class StragglerDetector:
    """EWMA mean/variance of step times; flags z-score outliers.

    Warmup samples prime the statistics (no flags); afterwards mean/var
    follow an EWMA, with straggler steps weighted down 4x so one hiccup
    does not poison the baseline.
    """

    def __init__(self, alpha: float = 0.1, z_threshold: float = 3.0,
                 warmup: int = 5, min_rel_std: float = 0.02):
        self.alpha = alpha
        self.z = z_threshold
        self.warmup = warmup
        self.min_rel_std = min_rel_std   # jitter floor: ignore sub-2% noise
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self._warm: list = []

    def observe(self, dt: float) -> bool:
        """Record one step time; True if it is a straggler step."""
        self.n += 1
        if self.n <= self.warmup:
            self._warm.append(dt)
            if self.n == self.warmup:
                m = sum(self._warm) / len(self._warm)
                self.mean = m
                self.var = sum((x - m) ** 2 for x in self._warm) / \
                    len(self._warm)
            return False
        std = math.sqrt(max(self.var, 0.0))
        std = max(std, self.min_rel_std * self.mean)
        is_straggler = dt > self.mean + self.z * std
        a = self.alpha * (0.25 if is_straggler else 1.0)
        self.mean = (1 - a) * self.mean + a * dt
        self.var = (1 - a) * self.var + a * (dt - self.mean) ** 2
        return is_straggler


class StepWatchdog:
    """Serving-loop step watchdog: per-step latency telemetry plus the
    straggler/liveness machinery above, composed for the engine.

    ``ServingEngine.run`` calls :meth:`observe` once per iteration with
    the step's wall time: the detector flags straggler steps (injected or
    real), an optional :class:`HeartbeatMonitor` gets a beat for this
    host (so an external supervisor watching the monitor sees a wedged
    serving loop go dead), and :meth:`stats` folds p50/p95 step latency
    into the run summary.
    """

    def __init__(self, detector: Optional[StragglerDetector] = None,
                 monitor: Optional[HeartbeatMonitor] = None,
                 host: str = "serve"):
        self.detector = detector or StragglerDetector()
        self.monitor = monitor
        self.host = host
        if monitor is not None and host not in monitor.last:
            monitor.register(host)
        self.step_times: List[float] = []
        self.straggler_steps = 0

    def observe(self, dt: float) -> bool:
        """Record one engine step; True if it was flagged a straggler."""
        self.step_times.append(dt)
        if self.monitor is not None:
            self.monitor.beat(self.host)
        flagged = self.detector.observe(dt)
        if flagged:
            self.straggler_steps += 1
        return flagged

    def stats(self) -> Dict[str, float]:
        import numpy as np
        dts = np.asarray(self.step_times or [0.0])
        return {"straggler_steps": float(self.straggler_steps),
                "step_p50_s": float(np.percentile(dts, 50)),
                "step_p95_s": float(np.percentile(dts, 95))}


@dataclasses.dataclass
class RestartPolicy:
    max_failures: int = 3
    backoff_s: float = 0.0          # tests use 0
    allow_shrink: bool = True       # elastic: retry on a smaller mesh


def run_with_restarts(
    make_runner: Callable[[int, int], Callable[[], Any]],
    policy: RestartPolicy,
    *,
    n_pods: int = 2,
    on_failure: Optional[Callable[[int, BaseException], None]] = None,
) -> Tuple[Any, int, int]:
    """Run ``make_runner(attempt, pods)()`` with restart-on-failure.

    ``make_runner`` builds a fresh runner (re-mesh, restore checkpoint,
    re-jit) for each attempt; ``pods`` shrinks after a failure when the
    policy allows (elastic scaling). Returns (result, attempts, pods_used).
    """
    pods = n_pods
    for attempt in range(policy.max_failures + 1):
        try:
            runner = make_runner(attempt, pods)
            return runner(), attempt + 1, pods
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: B036 - restart loop by design
            if on_failure is not None:
                on_failure(attempt, e)
            if attempt == policy.max_failures:
                raise
            if policy.allow_shrink and pods > 1:
                pods -= 1            # drop the lost pod, keep training
            if policy.backoff_s:
                time.sleep(policy.backoff_s * (2 ** attempt))
    raise RuntimeError("unreachable")
