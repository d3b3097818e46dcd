"""Persistent on-disk cache of tuned kernel schedules (port of
``repro.tune.cache``: ``PlanCache``, its JSON schema, atomic writes,
quarantine and ``get_cache`` / ``reset_cache`` verbatim up to imports).

What differs, because the schedules here are the H100 kernels' own:

* ``kernel_fingerprint`` adds the card's name, its SM count and a hash of
  ``kernels/csrc/*``, so a plan tuned on another card or another kernel
  source misses instead of loading; the Gemmini config's budgets enter
  only where a caller passes a config (the card kernels read none of
  them, so the GEMM, conv and attention keys pass ``None`` and name the
  datapath's dtypes in their payload);
* the default file is ``tile_plans_torch.json``, so the two packages
  never read each other's entries;
* a GEMM entry stores the card plan's integers (``tile``, ``splits``; 0, 0
  for the shape's own plan), not a ``TilePlan``; ``lookup_checked`` has
  the caller re-validate an entry (the kernel's C plan function on the
  card), and one the kernel cannot run misses;
* the process keeps each resolved schedule per shape (``resolved``), so a
  dispatch pays one dict lookup after the first; it is dropped with the
  cache, and on a quarantine.

The paper's software stack compiles against tiling parameters "generated by
the Chisel generator and included as a header file" -- a static schedule. The
tuner replaces that header with a *measured* one, and this module is where
the measured winners live between processes: a JSON file keyed by a stable
schedule fingerprint (kernel kind + config knobs + problem shape + dtypes),
so a serving binary restarted on the same host re-uses yesterday's tuning
run instead of re-measuring.

The cache is kernel-agnostic: an entry is a flat dict of integer schedule
parameters plus provenance metadata. Only those parameters are persisted;
the kernel's plan (grid, workspace) is re-derived from them at launch.

The cache also persists a *quarantine* set (``quarantined`` in the JSON,
absent when empty -- older readers ignore it): schedule keys the serving
engine's NaN/Inf guard flagged at runtime. Quarantined keys miss on lookup
and refuse re-store, degrading resolution to the static default schedule
until an operator :meth:`PlanCache.unquarantine`-s them.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import tempfile
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.config import Dataflow, GemminiConfig

SCHEMA_VERSION = 2

# The tuned schedule of each shape this process resolved: (mode, kind,
# shape...) -> params, or None for the shape's own plan.
resolved: Dict[tuple, Optional[Dict[str, int]]] = {}


def default_cache_path() -> str:
    """Resolution order: ``tune_cache`` flag ($GEMMINI_TUNE_CACHE at import),
    then ``$XDG_CACHE_HOME``/gemmini-repro, then ~/.cache/gemmini-repro."""
    from repro_torch.core import flags
    override = flags.get("tune_cache")
    if override:
        return override
    root = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(root, "gemmini-repro", "tile_plans_torch.json")


@functools.lru_cache(maxsize=None)
def source_hash() -> str:
    """sha256 prefix of the kernels' sources (``kernels/csrc/*``, names
    and bytes)."""
    from repro_torch.kernels import _build
    h = hashlib.sha256()
    for p in sorted(_build.CSRC.iterdir()):
        if p.is_file():
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def card(device: Optional[str] = None) -> Tuple[str, int]:
    """(name, SM count) of the device a schedule runs on: a CUDA device
    (default: the current one where CUDA is available), or ("cpu", 0)."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type != "cuda":
        return "cpu", 0
    props = torch.cuda.get_device_properties(
        dev.index if dev.index is not None else torch.cuda.current_device())
    return props.name, int(props.multi_processor_count)


def kernel_fingerprint(kind: str, cfg: Optional[GemminiConfig],
                       payload: Dict, *, engine_dtypes: bool = True,
                       tile_caps: bool = True,
                       device: Optional[str] = None) -> str:
    """Stable across processes/hosts: canonical JSON -> sha256 prefix.

    ``kind`` discriminates the kernel class ("gemm" | "attn" | "conv"); the
    shared config knobs cover everything that changes the kernel's legal
    schedule lattice; ``payload`` carries the kernel-specific problem shape.
    Nothing process-local (no id()s, no Python hash()). The card's name
    and SM count (of ``device``; "cpu" for the plain versions) and the
    kernel sources' hash are always in it; ``cfg``'s knobs only where a
    config is given (``None``: the card kernel reads none of them).

    A kernel must only fingerprint the knobs it actually consults, or two
    configs that launch identical schedules key different entries and the
    warm pass populates fingerprints the request path never hits (the
    warm-path has_bias bug, as a class): attention streams bf16/f32
    regardless of the engine's GEMM datapath, so it sets
    ``engine_dtypes=False`` (its own streamed dtype is in the payload), and
    only the GEMM lattice reads the ``max_tile_*`` caps (``tile_caps``).
    """
    name, sms = card(None if device is None else str(device))
    full = {
        "v": SCHEMA_VERSION,
        "kind": kind,
        "card": name,
        "sms": sms,
        "src": source_hash(),
    }
    if cfg is not None:
        full.update(dim=cfg.dim, spad=cfg.scratchpad_bytes,
                    accum=cfg.accumulator_bytes, banks=cfg.banks,
                    pipe=cfg.pipeline_depth)
        if engine_dtypes:
            full["dtypes"] = [cfg.input_dtype, cfg.acc_dtype,
                              cfg.output_dtype]
        if tile_caps:
            full["caps"] = [cfg.max_tile_m, cfg.max_tile_n, cfg.max_tile_k]
    full.update(payload)
    blob = json.dumps(full, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


def fingerprint(dtypes: Tuple[str, str, str], dataflow: Dataflow, m: int,
                n: int, k: int, has_bias: bool, *, b_trans: bool = False,
                device: Optional[str] = None) -> str:
    """GEMM-plan fingerprint: the JAX key's dataflow, shape and bias, the
    datapath's (input, accumulator, output) dtype names, and B's layout
    (the card plan reads it)."""
    return kernel_fingerprint("gemm", None, {
        "df": dataflow.value,
        "mnk": [m, n, k],
        "bias": bool(has_bias),
        "dtypes": list(dtypes),
        "bt": bool(b_trans),
    }, device=device)


_META_FIELDS = ("source", "best_us", "greedy_us", "n_candidates")


@dataclasses.dataclass
class CacheEntry:
    """One tuned schedule: kernel-specific integer parameters + provenance.

    ``params`` is flat and kernel-shaped: {"tile","splits"} for GEMM and
    conv, {"cluster","stages"} for attention, {"page_size","split_keys"}
    for paged attention. The JSON form inlines params alongside the
    metadata.
    """

    params: Dict[str, int]
    source: str = "analytic"      # "measured" | "proxy+analytic" | "analytic"
    best_us: float = 0.0          # winner's min-of-iters wall time
    greedy_us: float = 0.0        # default/greedy schedule's min-of-iters
    n_candidates: int = 0

    def to_json(self) -> Dict:
        d = dict(self.params)
        d.update(source=self.source, best_us=self.best_us,
                 greedy_us=self.greedy_us, n_candidates=self.n_candidates)
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "CacheEntry":
        meta = {k: d[k] for k in _META_FIELDS if k in d}
        params = {k: v for k, v in d.items()
                  if k not in _META_FIELDS and isinstance(v, int)
                  and not isinstance(v, bool)}
        return cls(params=params, **meta)


class PlanCache:
    """Thread-safe fingerprint -> CacheEntry map with atomic JSON persistence."""

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._entries: Dict[str, CacheEntry] = {}
        self._quarantined: set = set()
        self._loaded = False
        self._lock = threading.Lock()
        self._warned_unwritable = False
        self.hits = 0
        self.misses = 0

    @property
    def path(self) -> str:
        return self._path or default_cache_path()

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return
        if raw.get("version") != SCHEMA_VERSION:
            return
        for key, d in raw.get("plans", {}).items():
            try:
                self._entries[key] = CacheEntry.from_json(d)
            except TypeError:
                continue
        self._quarantined.update(raw.get("quarantined", []))

    def __len__(self) -> int:
        with self._lock:
            self._ensure_loaded()
            return len(self._entries)

    # -- kernel-agnostic schedule entries ---------------------------------
    def lookup_schedule(self, key: str,
                        required: Tuple[str, ...]) -> Optional[Dict[str, int]]:
        """Schedule params under ``key`` if present and well-formed.

        ``required`` names the parameters the kernel's schedule needs; an
        entry missing any (or holding non-positive values) is evicted and
        counted as a miss -- a malformed cache must degrade to re-tuning,
        never to an illegal launch.
        """
        with self._lock:
            self._ensure_loaded()
            if key in self._quarantined:
                # Quarantined at runtime (a NaN/Inf guard tripped on this
                # schedule's kernel): resolution must degrade to the static
                # default, never re-launch the suspect winner.
                self.misses += 1
                return None
            entry = self._entries.get(key)
            if entry is not None and all(
                    isinstance(entry.params.get(f), int)
                    and entry.params[f] > 0 for f in required):
                self.hits += 1
                return dict(entry.params)
            if entry is not None:
                self._entries.pop(key, None)
            self.misses += 1
            return None

    def store_schedule(self, key: str, params: Dict[str, int], *,
                       source: str = "measured", best_us: float = 0.0,
                       greedy_us: float = 0.0, n_candidates: int = 0,
                       persist: bool = True) -> str:
        entry = CacheEntry(params={k: int(v) for k, v in params.items()},
                           source=source, best_us=best_us,
                           greedy_us=greedy_us, n_candidates=n_candidates)
        with self._lock:
            self._ensure_loaded()
            if key in self._quarantined:
                # A re-tune can re-measure a quarantined schedule "fast"
                # again; runtime evidence outranks the stopwatch until an
                # operator unquarantines it.
                return key
            self._entries[key] = entry
        if persist:
            self.save()
        return key

    # -- quarantine (runtime-detected bad schedules) -----------------------
    def quarantine(self, key: str, *, persist: bool = True) -> None:
        """Bar ``key`` from resolution: the entry is dropped and every
        subsequent :meth:`lookup_schedule` misses, so the kernel degrades
        to its static default schedule. The engine calls this when a tuned
        schedule's kernel produced non-finite outputs (the measurement said
        "fast", the serving path said "wrong" -- the latter wins).
        Persisted with the plans so a restarted server does not re-launch
        the suspect schedule."""
        with self._lock:
            self._ensure_loaded()
            self._entries.pop(key, None)
            self._quarantined.add(key)
        resolved.clear()
        if persist:
            self.save()

    def unquarantine(self, key: str, *, persist: bool = True) -> None:
        """Re-trust ``key`` (operator override after root-causing): the
        next resolution re-tunes or re-stores normally."""
        with self._lock:
            self._ensure_loaded()
            self._quarantined.discard(key)
        if persist:
            self.save()

    def is_quarantined(self, key: str) -> bool:
        with self._lock:
            self._ensure_loaded()
            return key in self._quarantined

    # -- schedules re-validated by the caller (the card's plan functions) --
    def lookup_checked(self, key: str, fields: Tuple[str, ...],
                       valid: Callable[[Dict[str, int]], bool]
                       ) -> Optional[Dict[str, int]]:
        """The schedule under ``key``, its ``fields`` only (non-negative
        integers; 0 names the kernel's own choice). ``valid`` says whether
        the kernel can run it (on the card, its C plan function); an entry
        it refuses -- stale, written against other kernel limits -- is
        dropped and counted as a miss, never launched."""
        params = self.lookup_schedule(key, ())
        if params is None:
            return None
        sub = {f: params.get(f, -1) for f in fields}
        ok = all(v >= 0 for v in sub.values())
        if ok:
            try:
                ok = bool(valid(sub))
            except (RuntimeError, ValueError, TypeError):
                ok = False
        if not ok:
            with self._lock:
                self._entries.pop(key, None)
                self.misses += 1
                self.hits -= 1
            return None
        return sub

    def save(self) -> None:
        """Atomic write (tmp file + rename) so concurrent readers never see a
        torn cache. An unwritable path degrades to in-memory-only tuning
        with a one-time warning -- persistence must never kill serving."""
        with self._lock:
            self._ensure_loaded()
            payload = {"version": SCHEMA_VERSION,
                       "plans": {k: e.to_json()
                                 for k, e in sorted(self._entries.items())}}
            if self._quarantined:
                payload["quarantined"] = sorted(self._quarantined)
        path = self.path
        tmp = None
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                       prefix=".tile_plans.")
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError as e:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            if not self._warned_unwritable:
                self._warned_unwritable = True
                import warnings
                warnings.warn(f"plan cache not persisted to {path!r} ({e}); "
                              f"tuned plans stay in-memory for this process")


_global_cache: Optional[PlanCache] = None
_global_path: Optional[str] = None


def get_cache() -> PlanCache:
    """Process-wide cache bound to the current ``tune_cache`` flag; rebinds
    (and re-loads) if the flag changes, which tests use for tmp isolation."""
    global _global_cache, _global_path
    path = default_cache_path()
    if _global_cache is None or _global_path != path:
        _global_cache = PlanCache(path)
        _global_path = path
        resolved.clear()
    return _global_cache


def reset_cache() -> None:
    global _global_cache, _global_path
    _global_cache = None
    _global_path = None
    resolved.clear()
