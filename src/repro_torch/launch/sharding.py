"""Sharding rules (port of ``repro.launch.sharding``): parameter,
optimizer and activation specs, and their DTensor placements.

Strategy: storage sharded over ``model`` for weights (head / ff / expert
dims), the batch over ``pod`` x ``data``, ZeRO-1 over the data domain for
the optimizer's m and v, sequence-sharded storage for the residual
between blocks, and sequence-sharded KV caches for decode. The rules are
the JAX module's, verbatim: framework-free logic over shapes and axis
names. Every rule asks :func:`_first_divisible` for the highest-priority
tensor dim the mesh axis divides, else replicates, so one rule set works
across every arch (56 heads, 40 experts, odd vocabs, ...).

A spec is per tensor dim, as ``jax.sharding.PartitionSpec`` is
(:class:`P`: an entry per dim, a mesh axis name, a tuple of names or
None). DTensor placements are per mesh dim; :func:`to_placements`
translates. DTensor allows uneven shards; these rules never produce one,
and :func:`distribute` refuses one.

As in the JAX package, the ``model`` shardings shard storage: the sharded
context hands each kernel whole weights and only the batch split over the
data axes (``core.context``), as GSPMD gathers a model-sharded weight
before each Pallas call.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import tree as tu
from repro_torch.launch import mesh as mesh_lib


class P:
    """A partition spec: one entry per tensor dim (an axis name, a tuple
    of axis names, or None for replicated); fewer entries than dims leave
    the trailing dims replicated. A leaf of the port's trees (not a
    tuple), so a tree of specs has its tensors' structure."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self._entries == other._entries

    def __hash__(self):
        return hash(("P",) + self._entries)

    def __repr__(self):
        return f"P{self._entries!r}"


_axis_size = mesh_lib.axis_size


def _first_divisible(shape: Sequence[int], mesh, axis,
                     priority: Sequence[int]) -> Optional[int]:
    n = _axis_size(mesh, axis)
    for dim in priority:
        if dim < len(shape) and shape[dim] % n == 0 and shape[dim] >= n:
            return dim
    return None


def _spec_with(shape, ndim, mesh, axis, priority) -> P:
    dim = _first_divisible(shape, mesh, axis, priority)
    entries: list = [None] * ndim
    if dim is not None:
        entries[dim] = axis
    return P(*entries)


# ---------------------------------------------------------------------------
# parameter rules (path-pattern -> dim priority for the `model` axis)
# ---------------------------------------------------------------------------
# priority lists are dim indices *from the right* (negative), so the same
# rule covers stacked (L, ...) block params and unstacked params.
_PARAM_RULES: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("attn/wq",   (-1, -2)),
    ("attn/wk",   (-1, -2)),
    ("attn/wv",   (-1, -2)),
    ("attn/wo",   (-2, -1)),
    ("attn/bq",   (-1,)),
    ("attn/bk",   (-1,)),
    ("attn/bv",   (-1,)),
    ("mlp/wi",    (-1, -2)),
    ("mlp/wg",    (-1, -2)),
    ("mlp/wo",    (-2, -1)),
    ("moe/router", (-1,)),
    ("moe/wi",    (-3, -1)),     # expert dim (EP), else ff
    ("moe/wg",    (-3, -1)),
    ("moe/wo",    (-3, -2)),
    ("shared/wi", (-1, -2)),
    ("shared/wg", (-1, -2)),
    ("shared/wo", (-2, -1)),
    ("mamba/in_proj",  (-1, -2)),
    ("mamba/out_proj", (-2, -1)),
    ("mamba/conv_w",   (-1,)),
    ("mamba/a_log",    (-1,)),
    ("mamba/d_skip",   (-1,)),
    ("mamba/dt_bias",  (-1,)),
    ("heads",     (-1, -2)),     # musicgen output heads: vocab else d
    ("unembed",   (-1, -2)),
    ("embed",     (-2, -1)),     # vocab else d_model
    ("meta_tokens", ()),
)


def param_spec(path: str, leaf, mesh) -> P:
    """``path``: the leaf's "/"-joined tree path (``core.tree``), e.g.
    ``blocks/attn/wq``."""
    shape = tuple(leaf.shape)
    for pat, prio in _PARAM_RULES:
        if pat in path:
            prio_abs = [len(shape) + d for d in prio]
            return _spec_with(shape, len(shape), mesh, "model", prio_abs)
    return P()   # norms, scalars: replicated


def _map_with_path(fn, tree):
    pairs = tu.flatten_with_paths(tree)
    return tu.unflatten(tree, [fn(path, leaf) for path, leaf in pairs])


def param_specs(params_shape, mesh) -> Any:
    """Tree of specs for a params tree (tensors, meta tensors, or any
    leaves with a ``shape``)."""
    return _map_with_path(lambda path, leaf: param_spec(path, leaf, mesh),
                          params_shape)


def opt_state_specs(params_shape, mesh) -> Dict[str, Any]:
    """ZeRO-1: m/v take the param spec extended with a DP-axis shard on the
    highest-priority still-unsharded divisible dim."""
    dp = mesh_lib.data_axes(mesh)
    dp_ax = dp if len(dp) > 1 else dp[0]

    def mv_spec(path, leaf):
        base = param_spec(path, leaf, mesh)
        entries = list(base) + [None] * (len(leaf.shape) - len(base))
        # try to extend with dp on an unsharded divisible dim (prefer last
        # dims: big vocab/ff/d axes; avoid dim 0 = layer stack, usually odd)
        n = _axis_size(mesh, dp_ax)
        for dim in range(len(leaf.shape) - 1, -1, -1):
            if entries[dim] is None and leaf.shape[dim] % n == 0 \
                    and leaf.shape[dim] >= n:
                entries[dim] = dp_ax
                break
        return P(*entries)

    mv = _map_with_path(mv_spec, params_shape)
    return {"m": mv, "v": mv, "count": P()}


# ---------------------------------------------------------------------------
# activation / batch / cache rules
# ---------------------------------------------------------------------------
def data_axis(mesh):
    """The mesh axis (name or tuple of names) batch-like dims shard over:
    what ``ExecutionContext.with_mesh`` partitions its kernels' leading
    dims by (the same axes every batch rule below uses)."""
    dp = mesh_lib.data_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def batch_spec(mesh) -> P:
    return P(data_axis(mesh))


def tokens_spec(mesh, batch: int, ndim: int = 2) -> P:
    """(B, T[, n_q]) token arrays; replicate if B not divisible (long_500k)."""
    dp = mesh_lib.data_axes(mesh)
    dp_ax = dp if len(dp) > 1 else dp[0]
    if batch % _axis_size(mesh, dp_ax) != 0:
        return P(*([None] * ndim))
    return P(*([dp_ax] + [None] * (ndim - 1)))


def residual_spec(cfg, mesh, batch: int, seq: int) -> P:
    """Residual (B, T, D) between blocks: DP batch + sequence-parallel T
    storage."""
    dp = mesh_lib.data_axes(mesh)
    dp_ax = dp if len(dp) > 1 else dp[0]
    b_ok = batch % _axis_size(mesh, dp_ax) == 0
    t_ok = seq % _axis_size(mesh, "model") == 0 and \
        seq >= _axis_size(mesh, "model")
    return P(dp_ax if b_ok else None, "model" if t_ok else None, None)


def logits_spec(cfg, mesh, batch: int) -> P:
    dp = mesh_lib.data_axes(mesh)
    dp_ax = dp if len(dp) > 1 else dp[0]
    b_ok = batch % _axis_size(mesh, dp_ax) == 0
    v_ok = cfg.vocab % _axis_size(mesh, "model") == 0
    base = [dp_ax if b_ok else None, None]
    if cfg.n_codebooks > 1:
        base.append(None)
    base.append("model" if v_ok else None)
    return P(*base)


def decode_state_specs(cfg, mesh, batch: int, max_seq: int) -> Any:
    """Specs for ``transformer.DecodeState`` (kv_k, kv_v, conv, ssm, pos)."""
    dp = mesh_lib.data_axes(mesh)
    dp_ax = dp if len(dp) > 1 else dp[0]
    b_ok = batch % _axis_size(mesh, dp_ax) == 0
    bs = dp_ax if b_ok else None
    tp = _axis_size(mesh, "model")

    kv = conv = st = None
    if cfg.has_attn:
        if b_ok:
            # (L, B, S, KVH, D): batch over DP, sequence over model
            kv = P(None, bs, "model", None, None)
        else:
            # long_500k (B=1): sequence over the whole mesh
            seq_ax = tuple(mesh_lib.axis_names(mesh))
            kv = P(None, None, seq_ax, None, None)
    if cfg.has_ssm:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.d_state
        conv_entries = [None, bs, None, None]
        if conv_dim % tp == 0:
            conv_entries[3] = "model"
        conv = P(*conv_entries)
        # (L, B, H, N, P): heads over model if divisible, else N, else P
        sshape = (cfg.n_layers, batch, cfg.n_ssm_heads, cfg.d_state,
                  cfg.ssm_head_dim)
        dim = _first_divisible(sshape, mesh, "model", (2, 3, 4))
        entries = [None, bs, None, None, None]
        if dim is not None:
            entries[dim] = "model"
        st = P(*entries)
    from repro_torch.models.transformer import DecodeState
    return DecodeState(kv_k=kv, kv_v=kv, conv=conv, ssm=st, pos=P())


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------
def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim named in tensor dim ``d``'s entry, ``Replicate()`` on the
    rest. A tensor dim over several axes, e.g. ``("pod", "data")``, is
    ``Shard(d)`` on each, major to minor, which is DTensor's order for
    repeated shards; an entry that names them against the mesh's order
    raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_lib.axis_names(mesh)
    out = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(spec):
        axes = _names(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r} names {axes} against the "
                             f"mesh's order {names}")
        for i in idx:
            if i in seen:
                raise ValueError(f"spec {spec!r} uses axis {names[i]} twice")
            seen.add(i)
            out[i] = Shard(d)
    return tuple(out)


def from_placements(placements, mesh, ndim: int) -> P:
    """The spec of ``placements`` (the inverse of :func:`to_placements`;
    trailing replicated dims stay as ``None`` entries)."""
    from torch.distributed.tensor import Shard
    names = mesh_lib.axis_names(mesh)
    entries: list = [()] * ndim
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            entries[p.dim % ndim] = entries[p.dim % ndim] + (names[i],)
        elif not p.is_replicate():
            raise ValueError(f"no spec for placement {p}")
    return P(*(None if not e else e[0] if len(e) == 1 else e
               for e in entries))


def local_slices(shape: Sequence[int], spec: P, mesh,
                 coordinate: Sequence[int]) -> Tuple[slice, ...]:
    """The block of a ``shape`` tensor laid out by ``spec`` that the rank
    at mesh ``coordinate`` holds. Raises where an axis does not divide its
    dim: the rules never make an uneven shard."""
    names = mesh_lib.axis_names(mesh)
    out = []
    for d, n in enumerate(shape):
        axes = _names(spec[d]) if d < len(spec) else ()
        parts, idx = 1, 0
        for a in axes:
            size = _axis_size(mesh, a)
            parts *= size
            idx = idx * size + coordinate[names.index(a)]
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {axes} ({parts} ways)")
        chunk = n // parts
        out.append(slice(idx * chunk, (idx + 1) * chunk))
    return tuple(out)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh`` (the current card for ``cuda``)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def from_blocks(local: torch.Tensor, shape: Sequence[int], spec: P, mesh):
    """The DTensor of global ``shape`` laid out by ``spec`` whose block on
    this rank is ``local`` (:func:`local_slices`'s block)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def distribute(x: torch.Tensor, spec: P, mesh):
    """A DTensor laid out by ``spec`` from the full tensor ``x``, which
    every rank holds: each keeps its own block, and nothing is sent."""
    from torch.distributed.tensor import DTensor
    coord = mesh.get_coordinate()
    sl = local_slices(x.shape, spec, mesh, coord)
    local = x[sl]
    if local.shape != x.shape:
        local = local.clone()
    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def distribute_tree(tree, specs, mesh):
    """:func:`distribute` over a tree and its tree of specs."""
    spec_leaves = [s for _, s in tu.flatten_with_paths(specs)]
    pairs = tu.flatten_with_paths(tree)
    if len(spec_leaves) != len(pairs):
        raise ValueError(f"{len(pairs)} leaves against {len(spec_leaves)} "
                         f"specs")
    return tu.unflatten(tree, [distribute(x, s, mesh) for (_, x), s in
                               zip(pairs, spec_leaves)])


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def empty_tree(shapes, specs, mesh, *, fill: Optional[float] = None):
    """DTensors of the shapes and dtypes of ``shapes``' leaves (tensors on
    any device, meta included) laid out by ``specs``, each rank holding an
    uninitialized block (zeros with ``fill=0``). Under ``FakeTensorMode``
    nothing is allocated: the dry run's inputs."""
    from torch.distributed.tensor import DTensor
    coord = mesh.get_coordinate()
    dev = mesh.device_type
    spec_leaves = [s for _, s in tu.flatten_with_paths(specs)]

    def make(x, spec):
        sl = local_slices(x.shape, spec, mesh, coord)
        lshape = [s.stop - s.start for s in sl]
        local = torch.empty(lshape, dtype=x.dtype, device=dev) \
            if fill is None else torch.full(lshape, fill, dtype=x.dtype,
                                            device=dev)
        return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                                  run_check=False, shape=torch.Size(x.shape),
                                  stride=_contiguous_stride(x.shape))
    pairs = tu.flatten_with_paths(shapes)
    return tu.unflatten(shapes, [make(x, s) for (_, x), s in
                                 zip(pairs, spec_leaves)])
