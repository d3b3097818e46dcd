"""Optimization switches (copy of ``repro.core.flags``, the same names,
defaults and validation).

Each flag gates one beyond-paper optimization so the paper-faithful
baseline and the optimized variant can be lowered from the same source
tree and compared cell-by-cell. The dry-run CLI sets them via
``--opt name[=value]``; tests pin them explicitly.

In the port, ``remat_policy`` is read by the training forward
(``repro_torch.models.transformer.forward``); ``tune_mode`` and
``tune_cache`` by the tuner (``repro_torch.tune``: the GEMM, conv and
flash wrappers, the serving engine's page size, the CLIs' warm-up);
``moe_grouped_dispatch`` by the MoE layer under a mesh
(``repro_torch.models.moe._dispatch_grid``); the others shape XLA's
lowering of the JAX package's steps and have no reader here.
"""

from __future__ import annotations

import os
from typing import Any, Dict

TUNE_MODES = ("off", "cached", "full")

_DEFAULTS: Dict[str, Any] = {
    # T: empirical kernel-schedule autotuner (repro_torch.tune), covering
    # the card kernels' run-time plans: the GEMM's tiles and K splits, the
    # conv's splits, flash attention's cluster and stages, the page size
    # and the paged decode split. "off" = each kernel's plan of its shape;
    # "cached" = consult the persistent schedule cache, the kernel's own
    # plan on a miss (never measures); "full" = measure candidate
    # schedules for unseen shapes and persist the winners. Seeded from
    # $GEMMINI_TUNE so whole-model launchers pick it up without code
    # changes.
    "tune_mode": os.environ.get("GEMMINI_TUNE", "off"),
    # Plan-cache file override; empty = $GEMMINI_TUNE_CACHE, else
    # ~/.cache/gemmini-repro/tile_plans_torch.json (repro_torch.tune.cache).
    "tune_cache": os.environ.get("GEMMINI_TUNE_CACHE", ""),
    # A: update KV caches with a one-hot select instead of
    # dynamic-update-slice (DUS on a sequence-sharded cache forces the
    # partitioner to all-gather the whole cache; select is elementwise and
    # sharding-preserving).
    "onehot_cache_update": False,
    # B: group MoE dispatch per data-parallel shard so the scatter-add /
    # gather stay shard-local and the expert regroup lowers to an
    # all-to-all instead of a full-buffer all-reduce.
    "moe_grouped_dispatch": 0,      # truthy = group by the mesh shard grid
    # C: activation-rematerialization policy for the train step:
    # "full" (paper-style minimal residency), "dots" (save MXU outputs,
    # recompute elementwise), "none" (save everything).
    "remat_policy": "full",
    # A3: carry the stacked KV/SSM caches through the layer scan and
    # dynamic-update-slice the current layer's slice in place, instead of
    # streaming them through scan xs/ys. The xs/ys path makes XLA stage the
    # stack through f32 convert round-trips and a non-in-place update
    # fusion that rewrites the WHOLE stack every layer (measured 15 GB /
    # device/token on gemma2-2b @ 500k).
    "cache_as_carry": False,
    # A4: unroll the decode layer loop: static layer indices turn every
    # cache update into an in-place static-index DUS and remove the scan's
    # xs/ys staging entirely (decode bodies are small; HLO size is fine).
    "decode_unroll": False,
    # A2: grouped-GQA decode attention: contract per KV-head group with
    # einsum batch dims instead of jnp.repeat-ing K/V up to H heads.
    # repeat materializes an H-wide cache copy AND breaks the partitioner's
    # sharding propagation on the sequence axis (measured: SPMD falls back
    # to "involuntary full rematerialization" = all-gather of the cache).
    "gqa_grouped_decode": False,
}

_values: Dict[str, Any] = dict(_DEFAULTS)


def get(name: str) -> Any:
    return _values[name]


def set_flag(name: str, value: Any) -> None:
    if name not in _DEFAULTS:
        raise KeyError(f"unknown flag {name!r}; have {sorted(_DEFAULTS)}")
    if name == "tune_mode" and value not in TUNE_MODES:
        raise ValueError(f"tune_mode must be one of {TUNE_MODES}, got {value!r}")
    _values[name] = value


def changed() -> Dict[str, Any]:
    """The flags set away from their defaults (a dry-run row's record)."""
    return {k: v for k, v in _values.items() if v != _DEFAULTS[k]}


def reset() -> None:
    _values.clear()
    _values.update(_DEFAULTS)


def parse_opt(spec: str) -> None:
    """``name`` (-> True) or ``name=value`` with int/bool coercion."""
    if "=" in spec:
        name, raw = spec.split("=", 1)
        if raw.lower() in ("true", "false"):
            val: Any = raw.lower() == "true"
        else:
            try:
                val = int(raw)
            except ValueError:
                val = raw
    else:
        name, val = spec, True
    set_flag(name, val)
