"""ExecutionContext: the dispatch behind every engine op (port of
``repro.core.context`` + the serving ops of ``repro.kernels.ops``).

The context carries the elaborated :class:`GemminiConfig`; the ops are
``ctx.gemm``, ``ctx.matmul``, ``ctx.conv2d``, ``ctx.flash_attention``,
``ctx.decode_attention``, ``ctx.paged_attention``,
``ctx.paged_prefill_attention`` and ``ctx.ssd``. There is no
backend knob: the device of the operands decides. A CUDA tensor launches
the hand-written kernel or the call raises; a CPU tensor runs the plain
PyTorch version. No fallback runs in between. The mesh is a later slice.
The kernels run the plan of their shape unless the tuner names another:
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
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

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
    whether the op-boundary hooks fire (``hooks``) and the paged decode
    kernel's keys per split (``decode_split``, 0 for its own)."""

    cfg: Optional[GemminiConfig] = None
    hooks: bool = True
    decode_split: int = 0

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
        return gemm_kernel.gemm(a, b, d, acc_dtype=cfg.acc_torch,
                                out_dtype=cfg.output_torch, shift=shift,
                                activation=activation,
                                dataflow=_resolve_dataflow(cfg, dataflow))

    def _matmul(self, a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
        """Batched-LHS sugar over :meth:`gemm`: a (..., K), M = prod(lead)."""
        lead = a.shape[:-1]
        y = self._gemm(a.reshape(-1, a.shape[-1]), b, **kw)
        return y.reshape(*lead, b.shape[-1])

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
        return attn_kernels.flash_attention(q, k, v, causal=causal,
                                            window=window, softcap=softcap,
                                            scale=scale)

    def _decode_attention(self, q, k, v, pos: int, *,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
        """One query token against a dense (B, S, KVH, D) cache; keys at
        positions <= ``pos`` (a host int) are live."""
        return attn_kernels.decode_attention(q, k, v, pos, window=window,
                                             softcap=softcap, scale=scale)

    def _paged_attention(self, q, k_pool, v_pool, block_tables, lengths, *,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
        return attn_kernels.paged_decode_attention(
            q, k_pool, v_pool, block_tables, lengths, window=window,
            softcap=softcap, scale=scale,
            plan={"split_keys": self.decode_split} if self.decode_split
            else None)

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
        return attn_kernels.paged_prefill_attention(
            q, k_pool, v_pool, block_table, start, window=window,
            softcap=softcap, scale=scale)

    def _ssd(self, x, dt, a_log, b, c, *, d_skip=None, chunk: int = 256,
             initial_state=None, return_final_state: bool = False):
        """The chunked Mamba-2 SSD (``repro.kernels.ops.ssd_impl``).

        ``initial_state`` (B, H, N, P) fp32 resumes a previous segment;
        None starts from zeros. Unlike the JAX dispatch, which sends a
        resumed chunk to its XLA reference because the TPU kernel's state
        scratch starts from zeros, the CUDA kernel takes the initial state
        into its state accumulator: a continuation chunk runs on the card
        too, and no plain version is on the card's path."""
        return mamba2.ssd(x, dt, a_log, b, c, d_skip=d_skip, chunk=chunk,
                          initial_state=initial_state,
                          return_final_state=return_final_state)

    gemm = _op(_gemm)
    matmul = _op(_matmul)
    conv2d = _op(_conv2d)
    flash_attention = _op(_flash_attention)
    decode_attention = _op(_decode_attention)
    paged_attention = _op(_paged_attention)
    paged_prefill_attention = _op(_paged_prefill_attention)
    ssd = _op(_ssd)
