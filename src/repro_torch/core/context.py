"""ExecutionContext: the dispatch behind every engine op (port of
``repro.core.context`` + the serving ops of ``repro.kernels.ops``).

The context carries the elaborated :class:`GemminiConfig`; the ops are
``ctx.gemm``, ``ctx.matmul``, ``ctx.conv2d``, ``ctx.flash_attention``,
``ctx.decode_attention``, ``ctx.paged_attention``,
``ctx.paged_prefill_attention`` and ``ctx.ssd``. There is no
backend knob: the device of the operands decides. A CUDA tensor launches
the hand-written kernel or the call raises; a CPU tensor runs the plain
PyTorch version. No fallback runs in between. The kernels run the plan of their shape unless the tuner names another:
under the process flag ``tune_mode`` (``GEMMINI_TUNE``) ``cached`` /
``full`` the GEMM, conv and flash wrappers resolve a schedule per shape
(``repro_torch.tune``); ``decode_split`` is the paged decode kernel's
keys per split that the serving engine resolved with its page size (0:
the kernel's own). The JAX context's per-context ``tune_mode`` is not
ported: nothing in the port scopes the flag (ROADMAP A12).

Op boundary (``repro.core.context._faulted_op`` / ``_profiled_op``):
every op is wrapped once. An installed fault injector
(``repro_torch.runtime.faults.install``) runs ``check_transient`` at site
``op:<name>`` before the call and ``poison`` on the first output after
it; an installed profiler (``repro_torch.obs.profile``) times the call
into its (op, shape) bucket. Both pass through untouched while
``torch.compile`` traces or a CUDA graph captures (``faults.capturing``),
and on a context made with ``hooks=False`` (the serving engine's NaN-guard
re-run, which must neither fault nor be timed again). With neither
installed an op costs one None check more than its kernel call, and no
value changes.

Sharding (the ``mesh`` / ``axis`` fields, ``repro.core.context``'s
``shard_map`` wrap): on a context made by :meth:`with_mesh` every op but
``paged_prefill_attention`` and ``decode_attention`` runs through
:meth:`_shard_call`, which hands the kernel plain local tensors. Dim 0 of
each batched operand (GEMM rows M, the attention / conv / SSD batch, the
paged-decode slots) is split over ``axis``; weights, pools and other
broadcast operands are whole on every rank (a ``model``-sharded weight is
gathered first, as GSPMD gathers it before a Pallas call). The result is a
DTensor of the same layout. A batched dim the axis does not divide runs
the unsharded call on whole operands instead. Only DTensor operands are
resharded: a plain tensor is a rank's own local tensor and passes through.
Unlike the JAX wrap, which skips a one-device axis, the port's wraps at one
shard too, since a kernel never takes a DTensor (each kernel entry raises
``TypeError`` on one). ``paged_prefill_attention`` is per request (B = 1)
and never split, as in JAX; ``decode_attention`` has no op in the JAX
context and is not split either: given DTensors, both run their kernel
on whole operands on every rank, as GSPMD replicates an op it cannot
partition (on the dry run's path, their plain versions on the DTensors
as they come: a sequence-sharded cache stays sharded).

A context without a mesh given DTensor operands on the CPU runs the plain
versions through DTensor's own sharding propagation: the dry run's path
(``launch.dryrun``), the counterpart of the JAX dry run's ``xla`` engine,
whose mesh is ignored and which GSPMD partitions. On the card such a call
raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import dtensor as shard
from repro_torch.core.config import Activation, Dataflow, GemminiConfig
from repro_torch.core.tiling import _resolve_dataflow
from repro_torch.kernels import attention as attn_kernels
from repro_torch.kernels import conv as conv_kernel
from repro_torch.kernels import gemm as gemm_kernel
from repro_torch.kernels import mamba2
from repro_torch.kernels import ref
from repro_torch.obs import profile as oprofile
from repro_torch.runtime import faults as rfaults


def _op(fn):
    """Wrap the op ``fn`` (named ``_<op>``) with the injector's and the
    profiler's op-boundary hooks, innermost the profiler: its timing
    excludes the injector's bookkeeping, and a poisoned output is still
    the op the bucket timed."""
    name = fn.__name__.lstrip("_")
    site = f"op:{name}"

    @functools.wraps(fn)
    def op(self, *args, **kw):
        inj, prof = rfaults._ACTIVE, oprofile._ACTIVE
        if (inj is None and prof is None) or not self.hooks or \
                rfaults.capturing():
            return fn(self, *args, **kw)
        if inj is not None:
            inj.check_transient(site)
        if prof is not None:
            out = prof.call(prof.bucket(name, args, kw, self.cfg), fn,
                            (self,) + args, kw)
        else:
            out = fn(self, *args, **kw)
        if inj is None:
            return out
        if isinstance(out, tuple):
            return (inj.poison(site, out[0]),) + out[1:]
        return inj.poison(site, out)

    op.__name__ = op.__qualname__ = name
    return op


@dataclasses.dataclass(frozen=True)
class ExecutionContext:
    """One engine's dispatch value: the elaborated config the GEMM
    datapath follows (``None`` is legal for the attention ops only),
    whether the op-boundary hooks fire (``hooks``), the paged decode
    kernel's keys per split (``decode_split``, 0 for its own), and the
    device mesh with the axis (a name or a tuple of names) batched dims
    split over (``mesh`` / ``axis``; module docstring)."""

    cfg: Optional[GemminiConfig] = None
    hooks: bool = True
    decode_split: int = 0
    mesh: Any = None
    axis: Any = "data"

    def __post_init__(self):
        if self.mesh is not None:
            from repro_torch.launch import mesh as mesh_lib
            have = mesh_lib.axis_names(self.mesh)
            missing = [a for a in self._axes() if a not in have]
            if missing:
                raise ValueError(f"axis {missing} not in mesh axes {have}")

    # -- the mesh ------------------------------------------------------------
    def _axes(self) -> Tuple[str, ...]:
        return self.axis if isinstance(self.axis, tuple) else (self.axis,)

    def with_mesh(self, mesh, axis: Any = "data") -> "ExecutionContext":
        return dataclasses.replace(self, mesh=mesh, axis=axis)

    def unsharded(self) -> "ExecutionContext":
        """The same context without the mesh (one device's dispatch; the
        dry run's)."""
        return dataclasses.replace(self, mesh=None)

    @property
    def n_shards(self) -> int:
        """Devices along ``axis`` (1 without a mesh): the divisor the
        per-device batch shapes are warmed with
        (``tune.warm_model_plans(n_shards=...)``)."""
        if self.mesh is None:
            return 1
        from repro_torch.launch import mesh as mesh_lib
        return mesh_lib.axis_size(self.mesh, self._axes())

    @property
    def sharded(self) -> bool:
        """True when dispatch hands kernels local shards: a mesh is set
        (at one shard too; module docstring)."""
        return self.mesh is not None

    def _layout(self, arrays: Tuple, batched: Tuple[bool, ...]):
        """(mesh, per-operand placements, placement of a batched output,
        gradient placements of a whole operand) for DTensor operands
        (``core.dtensor.layout``): the context's mesh and ``axis``, or, on
        the dry run's path, the operands' mesh and its data axes."""
        from repro_torch.launch import mesh as mesh_lib
        mesh = self.mesh
        if mesh is None:
            mesh = next(a.device_mesh for a in arrays if shard.is_dtensor(a))
            axes = mesh_lib.data_axes(mesh)
        else:
            axes = self._axes()
        return (mesh,) + shard.layout(mesh, axes, arrays, batched)

    def _shard_call(self, fn: Callable, arrays: Tuple,
                    batched: Tuple[bool, ...], out_batched: Any = True):
        """``fn(*locals)`` on each rank's local tensors
        (``core.dtensor.local_call``): dim 0 of each batched DTensor split
        over ``axis``, the other DTensors whole (``Replicate``); the
        outputs are DTensors, dim 0 split where ``out_batched`` (a bool,
        or a tuple of bools for a tuple result) says. Falls back to whole
        operands when a batched dim 0 does not divide. With no DTensor
        operand ``fn`` runs as is: plain tensors are the rank's own.

        Gradients: a batched operand's local gradient is its rows'; a
        whole operand's is each rank's partial sum over its rows, which
        leaves as a ``Partial`` DTensor over ``axis``, unreduced: the
        train step reduce-scatters it into its ZeRO shard."""
        if not self.sharded or not shard.any_dtensor(arrays):
            return fn(*arrays)
        return shard.local_call(fn, arrays, batched, out_batched, self.mesh,
                                self._axes())

    def _dispatch(self, kernel: Callable, plain: Callable, arrays: Tuple,
                  batched: Tuple[bool, ...], out_batched: Any = True):
        """One wrapped op: ``kernel`` on local tensors under a mesh
        (:meth:`_shard_call`), ``plain`` on DTensors laid out as the wrap
        lays them out on the dry run's path (:meth:`_plain_dtensor`), else
        ``kernel`` on the operands as they come."""
        if not shard.any_dtensor(arrays):
            return kernel(*arrays)       # no DTensor: plain tensors as is
        if self._plain_dtensor(*arrays):
            mesh, layouts, _, _ = self._layout(arrays, batched)
            return plain(*(
                a if not shard.is_dtensor(a) else
                a.redistribute(mesh, pl) if b else shard.whole(a, pl, None)
                for a, b, pl in zip(arrays, batched, layouts)))
        return self._shard_call(kernel, arrays, batched, out_batched)

    def _plain_dtensor(self, *tensors) -> bool:
        """True when the unsharded context is given a DTensor operand on
        the CPU: the op then runs its plain version on the DTensors (the
        dry run's path). On the card that raises ``TypeError``."""
        if self.sharded or not shard.any_dtensor(tensors):
            return False
        if any(t is not None and t.device.type != "cpu" for t in tensors):
            shard.require_local("a context without a mesh", *tensors)
        return True

    def _require_cfg(self, op: str) -> GemminiConfig:
        if self.cfg is None:
            raise ValueError(f"ctx.{op} needs an elaborated GemminiConfig; "
                             f"this context has cfg=None")
        return self.cfg

    def _gemm(self, a: torch.Tensor, b: torch.Tensor,
              d: Optional[torch.Tensor] = None, *,
              dataflow: Optional[Dataflow] = None, shift: int = 0,
              activation: Activation = Activation.NONE) -> torch.Tensor:
        """C = act(round_shift(A @ B + D)) at the config's accumulator and
        output dtypes; a: (M, K), b: (K, N) with any strides, d:
        broadcastable (1|M, N) bias.

        ``dataflow``: OS or WS on a BOTH instance; ``None`` takes the
        instance's own, and a BOTH instance's plan resolves to WS
        (``tiling._resolve_dataflow``, what ``plan_gemm`` would pick; no
        plan is solved). Asking a single-dataflow instance for the other
        dataflow raises ``ValueError`` on either device."""
        cfg = self._require_cfg("gemm")
        flow = _resolve_dataflow(cfg, dataflow)
        kw = dict(acc_dtype=cfg.acc_torch, out_dtype=cfg.output_torch,
                  shift=shift, activation=activation)
        d_rows = False
        if d is not None and shard.any_dtensor((a, b, d)):
            m = a.shape[0]
            _, layouts, _, _ = self._layout((a, b), (True, False))
            if any(not p.is_replicate() for p in layouts[0]):
                # Split and biased: a (1, N) bias row cannot split over
                # M, so it is broadcast to the M rows here, where each
                # rank takes its own (the kernel streams a full (M, N) D
                # operand either way).
                d, d_rows = d.expand(m, b.shape[1]), True
        # Otherwise d goes through whole: the kernel owns its (1|M, N)
        # broadcast.
        return self._dispatch(
            lambda aa, bb, dd: gemm_kernel.gemm(aa, bb, dd, dataflow=flow,
                                                **kw),
            lambda aa, bb, dd: ref.gemm_ref(aa, bb, dd, **kw),
            (a, b, d), (True, False, d_rows))

    def _matmul(self, a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
        """Batched-LHS sugar over :meth:`gemm`: a (..., K), M = prod(lead);
        the flattened rows are what a mesh splits. A DTensor is split on
        its leading dim before it is flattened (the same row blocks when
        the axis divides it) and whole elsewhere, so the flattening never
        merges two sharded dims (a sequence-sharded residual is gathered,
        as Megatron's sequence parallelism gathers it before a
        projection); on the dry run's path over the mesh's data axes."""
        lead = a.shape[:-1]
        if shard.is_dtensor(a) and a.dim() > 2:
            from repro_torch.launch import mesh as mesh_lib
            mesh = self.mesh if self.sharded else a.device_mesh
            axes = self._axes() if self.sharded else \
                mesh_lib.data_axes(mesh)
            a = shard.place_rows(a, mesh, axes)
        y = self._gemm(a.reshape(-1, a.shape[-1]), b, **kw)
        return shard.grad_layout(y.reshape(*lead, b.shape[-1]))

    def _conv2d(self, x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, *, stride: int = 1,
                padding: int = 0, shift: int = 0,
                activation: Activation = Activation.NONE,
                fused: bool = False,
                dataflow: Optional[Dataflow] = None) -> torch.Tensor:
        """Conv2D on the engine: x (N, H, W, CI), w (KH, KW, CI, CO), b
        (CO,) -> (N, OH, OW, CO) at the config's dtypes.

        On the card, ``fused=False`` is the paper's shipped design: im2col
        in plain torch, then the engine GEMM on the instance's dataflow
        (``dataflow`` as for :meth:`gemm`); ``fused=True`` is the
        implicit-im2col conv kernel. On the CPU both are ``conv2d_ref``,
        which equals either bit for bit on the int8 datapath."""
        cfg = self._require_cfg("conv2d")
        kw = dict(acc_dtype=cfg.acc_torch, out_dtype=cfg.output_torch,
                  shift=shift, activation=activation)
        if self.sharded or self._plain_dtensor(x, w, b):
            return self._dispatch(
                lambda xx, ww, bb: self.unsharded()._conv2d(
                    xx, ww, bb, stride=stride, padding=padding, shift=shift,
                    activation=activation, fused=fused, dataflow=dataflow),
                lambda xx, ww, bb: ref.conv2d_ref(
                    xx, ww, bb, stride=stride, padding=padding, **kw),
                (x, w, b), (True, False, False))
        if x.device.type == "cpu":
            _resolve_dataflow(cfg, dataflow)
            return ref.conv2d_ref(x, w, b, stride=stride, padding=padding,
                                  **kw)
        if fused:
            return conv_kernel.conv2d_implicit(x, w, b, stride=stride,
                                               padding=padding, **kw)
        n, h, wd, _ = x.shape
        kh, kwd, _, co = w.shape
        oh, ow = conv_kernel.out_hw(h, wd, kh, kwd, stride, padding)
        a = ref.im2col(x, kh, kwd, stride, padding)
        y = self._gemm(a, w.reshape(-1, co),
                       None if b is None else b[None, :], dataflow=dataflow,
                       shift=shift, activation=activation)
        return y.reshape(n, oh, ow, co)

    def _flash_attention(self, q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        return self._dispatch(
            lambda qq, kk, vv: attn_kernels.flash_attention(qq, kk, vv, **kw),
            lambda qq, kk, vv: attn_kernels.blockwise_attention(qq, kk, vv,
                                                                **kw),
            (q, k, v), (True, True, True))

    def _decode_attention(self, q, k, v, pos: int, *,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
        """One query token against a dense (B, S, KVH, D) cache; keys at
        positions <= ``pos`` (a host int) are live. Not split by a mesh
        (module docstring): on DTensors it runs on whole operands."""
        kw = dict(window=window, softcap=softcap, scale=scale)
        if self._plain_dtensor(q, k, v):     # the dry run: as they come
            return attn_kernels.decode_attention_plain(q, k, v, pos, **kw)
        return self._shard_call(
            lambda qq, kk, vv: attn_kernels.decode_attention(qq, kk, vv, pos,
                                                             **kw),
            (q, k, v), (False, False, False), False)

    def _paged_attention(self, q, k_pool, v_pool, block_tables, lengths, *,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
        """Under a mesh the decode slots split; each rank reads the whole
        pools."""
        kw = dict(window=window, softcap=softcap, scale=scale)
        plan = {"split_keys": self.decode_split} if self.decode_split \
            else None
        return self._dispatch(
            lambda qq, bt, ln, kp, vp: attn_kernels.paged_decode_attention(
                qq, kp, vp, bt, ln, plan=plan, **kw),
            lambda qq, bt, ln, kp, vp:
                attn_kernels.paged_decode_attention_plain(qq, kp, vp, bt, ln,
                                                          **kw),
            (q, block_tables, lengths, k_pool, v_pool),
            (True, True, True, False, False))

    def _paged_prefill_attention(self, q, k_pool, v_pool, block_table,
                                 start: int, *, window: Optional[int] = None,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None,
                                 kv_pages: Optional[int] = None
                                 ) -> torch.Tensor:
        """``kv_pages``: the static bound on table entries that can hold
        live keys (the engine's admission-time prompt footprint); the
        table is cut to it before either path runs
        (``repro.kernels.ops.paged_prefill_attention_impl``)."""
        if kv_pages is not None and kv_pages < block_table.shape[0]:
            block_table = block_table[:kv_pages]
        kw = dict(window=window, softcap=softcap, scale=scale)
        if self._plain_dtensor(q, k_pool, v_pool, block_table):
            return attn_kernels.paged_prefill_attention_plain(
                q, k_pool, v_pool, block_table, start, **kw)
        return self._shard_call(
            lambda qq, kp, vp, bt: attn_kernels.paged_prefill_attention(
                qq, kp, vp, bt, start, **kw),
            (q, k_pool, v_pool, block_table), (False,) * 4, False)

    def _ssd(self, x, dt, a_log, b, c, *, d_skip=None, chunk: int = 256,
             initial_state=None, return_final_state: bool = False):
        """The chunked Mamba-2 SSD (``repro.kernels.ops.ssd_impl``).

        ``initial_state`` (B, H, N, P) fp32 resumes a previous segment;
        None starts from zeros. Unlike the JAX dispatch, which sends a
        resumed chunk to its XLA reference because the TPU kernel's state
        scratch starts from zeros, the CUDA kernel takes the initial state
        into its state accumulator: a continuation chunk runs on the card
        too, and no plain version is on the card's path. Under a mesh
        the batch splits (``a_log`` / ``d_skip`` whole)."""
        kw = dict(chunk=chunk, return_final_state=return_final_state)
        return self._dispatch(
            lambda xx, dd, bb, cc, ii, al, ds: mamba2.ssd(
                xx, dd, al, bb, cc, d_skip=ds, initial_state=ii, **kw),
            lambda xx, dd, bb, cc, ii, al, ds: mamba2.ssd_plain(
                xx, dd, al, bb, cc, d_skip=ds, initial_state=ii, **kw),
            (x, dt, b, c, initial_state, a_log, d_skip),
            (True,) * 5 + (False, False),
            (True, True) if return_final_state else True)

    gemm = _op(_gemm)
    matmul = _op(_matmul)
    conv2d = _op(_conv2d)
    flash_attention = _op(_flash_attention)
    decode_attention = _op(_decode_attention)
    paged_attention = _op(_paged_attention)
    paged_prefill_attention = _op(_paged_prefill_attention)
    ssd = _op(_ssd)
