"""Ring-buffered span tracer with Chrome-trace / JSONL export.

The tracer is the single event sink for the whole stack: the serving
engine emits request-lifecycle and step-phase spans, the paged allocator
emits alloc/extend/evict/defrag events, the tuner emits measurement
spans, the fault injector emits fault-fire instants, and the kernel
profiler emits per-op timing spans.  Everything lands in one bounded
`collections.deque` ring, so an always-on tracer in a long-running
server costs O(capacity) memory and a dict append per event.

Tracing is **off by default**.  It activates through any of:

- ``ServingEngine(trace=...)`` (bool / int capacity / ``Tracer``),
- the ``GEMMINI_TRACE`` environment variable (``1`` or a capacity),
- an explicit :func:`install` of a tracer as the process-global sink
  (used by ``serve --trace`` so tuner + fault events flow too).

Event model (Chrome trace event format, ``ts``/``dur`` in microseconds):

- ``ph="X"`` complete span (name, cat, ts, dur, args)
- ``ph="i"`` instant event
- ``ph="C"`` counter track (args = {series: value})
- ``ph="M"`` metadata (thread names for the fixed track layout below)

Track (tid) layout inside the single process (pid 0):
engine step phases on ``TID_ENGINE``, allocator on ``TID_ALLOC``, tuner
on ``TID_TUNER``, faults on ``TID_FAULT``, kernel profile spans on
``TID_PROFILE``, and each request on ``REQ_TID_BASE + rid`` so Perfetto
renders one lane per request lifecycle.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional

ENV_VAR = "GEMMINI_TRACE"

PID = 0
TID_ENGINE = 0
TID_ALLOC = 1
TID_TUNER = 2
TID_FAULT = 3
TID_PROFILE = 4
REQ_TID_BASE = 1000

_THREAD_NAMES = {
    TID_ENGINE: "engine",
    TID_ALLOC: "allocator",
    TID_TUNER: "tuner",
    TID_FAULT: "faults",
    TID_PROFILE: "kernels",
}

DEFAULT_CAPACITY = 65536


def req_tid(rid: int) -> int:
    """Perfetto track id for request ``rid``."""
    return REQ_TID_BASE + int(rid)


@dataclass
class Tracer:
    """Bounded in-memory event ring.

    ``clock`` must be monotonic; timestamps are stored in microseconds
    relative to the tracer's construction so traces start near t=0.
    """

    capacity: int = DEFAULT_CAPACITY
    clock: Callable[[], float] = time.monotonic
    events: Deque[Dict[str, Any]] = field(init=False, repr=False)
    dropped: int = field(init=False, default=0)

    def __post_init__(self) -> None:
        if self.capacity <= 0:
            raise ValueError(f"tracer capacity must be positive, got {self.capacity}")
        self.events = collections.deque(maxlen=self.capacity)
        self._epoch = self.clock()

    # ---------------------------------------------------------------- core

    def now_us(self, t: Optional[float] = None) -> float:
        """Convert a clock reading (default: now) to trace microseconds."""
        t = self.clock() if t is None else t
        return (t - self._epoch) * 1e6

    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(ev)

    def emit(
        self,
        name: str,
        *,
        ph: str,
        cat: str = "engine",
        tid: int = TID_ENGINE,
        ts: Optional[float] = None,
        dur: Optional[float] = None,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        ev: Dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": ph,
            "ts": self.now_us() if ts is None else ts,
            "pid": PID,
            "tid": tid,
        }
        if dur is not None:
            ev["dur"] = dur
        if args:
            ev["args"] = args
        self._push(ev)

    # ------------------------------------------------------------ emitters

    def instant(self, name: str, *, cat: str = "engine", tid: int = TID_ENGINE,
                **args: Any) -> None:
        self.emit(name, ph="i", cat=cat, tid=tid, args=args or None)

    def complete(self, name: str, t0: float, t1: Optional[float] = None, *,
                 cat: str = "engine", tid: int = TID_ENGINE, **args: Any) -> None:
        """Record a finished span; ``t0``/``t1`` are raw clock readings."""
        t1 = self.clock() if t1 is None else t1
        self.emit(name, ph="X", cat=cat, tid=tid, ts=self.now_us(t0),
                  dur=max(0.0, (t1 - t0) * 1e6), args=args or None)

    def counter(self, name: str, *, tid: int = TID_ENGINE, **series: float) -> None:
        self.emit(name, ph="C", cat="metrics", tid=tid, args=dict(series))

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "engine", tid: int = TID_ENGINE,
             **args: Any):
        t0 = self.clock()
        try:
            yield
        finally:
            self.complete(name, t0, cat=cat, tid=tid, **args)

    def label_thread(self, tid: int, name: str) -> None:
        self.emit("thread_name", ph="M", cat="__metadata", tid=tid,
                  ts=0.0, args={"name": name})

    # -------------------------------------------------------------- export

    def tail(self, n: int) -> List[Dict[str, Any]]:
        """Last ``n`` events, oldest first (for diagnostics dumps)."""
        return list(self.events)[-n:]

    def chrome(self) -> Dict[str, Any]:
        """Chrome trace event format payload (``traceEvents`` object form)."""
        meta = [
            {"name": "thread_name", "cat": "__metadata", "ph": "M", "ts": 0.0,
             "pid": PID, "tid": tid, "args": {"name": label}}
            for tid, label in sorted(_THREAD_NAMES.items())
        ]
        return {
            "traceEvents": meta + list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped,
                          "capacity": self.capacity},
        }

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome(), f)
        return path

    def export_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
        return path


# ------------------------------------------------------------- validation

_VALID_PH = {"X", "B", "E", "i", "I", "C", "M", "b", "e", "n", "s", "t", "f"}


def validate_chrome(payload: Any) -> List[str]:
    """Schema-check a Chrome trace payload; return a list of errors.

    Accepts the object form (``{"traceEvents": [...]}``) or the bare
    array form.  Used by ``python -m repro_torch.obs --check`` as a CI gate.
    """
    errors: List[str] = []
    if isinstance(payload, dict):
        events = payload.get("traceEvents")
        if not isinstance(events, list):
            return ["payload object lacks a 'traceEvents' list"]
    elif isinstance(payload, list):
        events = payload
    else:
        return [f"payload must be an object or array, got {type(payload).__name__}"]

    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                errors.append(f"{where} ({ev.get('name', '?')}): missing '{key}'")
        ph = ev.get("ph")
        if ph is not None and ph not in _VALID_PH:
            errors.append(f"{where} ({ev.get('name', '?')}): bad phase {ph!r}")
        ts = ev.get("ts")
        if ts is not None and not isinstance(ts, (int, float)):
            errors.append(f"{where} ({ev.get('name', '?')}): non-numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(
                    f"{where} ({ev.get('name', '?')}): complete span needs dur >= 0")
        if ph == "C" and not isinstance(ev.get("args"), dict):
            errors.append(f"{where} ({ev.get('name', '?')}): counter needs args dict")
        if len(errors) > 50:
            errors.append("... (truncated)")
            break
    return errors


def load(path: str) -> List[Dict[str, Any]]:
    """Load events from a Chrome-trace JSON or a JSONL event log."""
    with open(path) as f:
        text = f.read()
    try:
        # Whole-file JSON first: a JSONL file (one object per line) fails
        # here with "Extra data" and falls through -- sniffing the first
        # character cannot tell the two apart.
        payload = json.loads(text)
    except json.JSONDecodeError:
        return [json.loads(line) for line in text.splitlines() if line.strip()]
    if isinstance(payload, dict):
        return list(payload.get("traceEvents", []))
    return list(payload)


# ------------------------------------------------------ global installation

_ACTIVE: Optional[Tracer] = None


def install(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-global event sink (tuner/fault events)."""
    global _ACTIVE
    _ACTIVE = tracer
    return tracer


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[Tracer]:
    return _ACTIVE


def _from_env() -> Optional[Tracer]:
    spec = os.environ.get(ENV_VAR, "").strip().lower()
    if spec in ("", "0", "off", "false", "no"):
        return None
    if spec.isdigit() and int(spec) > 1:
        return Tracer(capacity=int(spec))
    return Tracer()


def as_tracer(obj: Any, *, clock: Optional[Callable[[], float]] = None
              ) -> Optional[Tracer]:
    """Normalize a user-facing ``trace=`` knob into a Tracer (or None).

    ``None`` defers to ``GEMMINI_TRACE``; ``False`` forces off; ``True``
    enables with the default capacity; an int sets the ring capacity;
    a ``Tracer`` is used as-is (its own clock wins).
    """
    if isinstance(obj, Tracer):
        return obj
    if obj is None:
        t = _from_env()
    elif obj is False:
        return None
    elif obj is True:
        t = Tracer()
    elif isinstance(obj, int):
        t = Tracer(capacity=obj)
    else:
        raise TypeError(f"trace= expects None/bool/int/Tracer, got {type(obj).__name__}")
    if t is not None and clock is not None:
        t = Tracer(capacity=t.capacity, clock=clock)
    return t


def iter_spans(events: Iterable[Dict[str, Any]], *, cat: Optional[str] = None,
               ph: Optional[str] = None) -> Iterable[Dict[str, Any]]:
    for ev in events:
        if cat is not None and ev.get("cat") != cat:
            continue
        if ph is not None and ev.get("ph") != ph:
            continue
        yield ev
