"""ExecutionContext: the dispatch behind every engine op (port of
``repro.core.context`` + the serving ops of ``repro.kernels.ops``).

The context carries the elaborated :class:`GemminiConfig`; the ops are
``ctx.gemm``, ``ctx.matmul``, ``ctx.flash_attention``,
``ctx.paged_attention`` and ``ctx.paged_prefill_attention``. There is no
backend knob: the device of the operands decides. A CUDA tensor launches
the hand-written kernel or the call raises; a CPU tensor runs the plain
PyTorch version. No fallback runs in between. The mesh and the tuner are
later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.config import Activation, GemminiConfig
from repro_torch.kernels import attention as attn_kernels
from repro_torch.kernels import gemm as gemm_kernel


@dataclasses.dataclass(frozen=True)
class ExecutionContext:
    """One engine's dispatch value: the elaborated config the GEMM
    datapath follows (``None`` is legal for the attention ops only)."""

    cfg: Optional[GemminiConfig] = None

    def _require_cfg(self, op: str) -> GemminiConfig:
        if self.cfg is None:
            raise ValueError(f"ctx.{op} needs an elaborated GemminiConfig; "
                             f"this context has cfg=None")
        return self.cfg

    def gemm(self, a: torch.Tensor, b: torch.Tensor,
             d: Optional[torch.Tensor] = None, *, shift: int = 0,
             activation: Activation = Activation.NONE) -> torch.Tensor:
        """C = act(round_shift(A @ B + D)) at the config's accumulator and
        output dtypes; a: (M, K), b: (K, N) with any strides, d:
        broadcastable (1|M, N) bias."""
        cfg = self._require_cfg("gemm")
        return gemm_kernel.gemm(a, b, d, acc_dtype=cfg.acc_torch,
                                out_dtype=cfg.output_torch, shift=shift,
                                activation=activation)

    def matmul(self, a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
        """Batched-LHS sugar over :meth:`gemm`: a (..., K), M = prod(lead)."""
        lead = a.shape[:-1]
        y = self.gemm(a.reshape(-1, a.shape[-1]), b, **kw)
        return y.reshape(*lead, b.shape[-1])

    def flash_attention(self, q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
        return attn_kernels.flash_attention(q, k, v, causal=causal,
                                            window=window, softcap=softcap,
                                            scale=scale)

    def paged_attention(self, q, k_pool, v_pool, block_tables, lengths, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
        return attn_kernels.paged_decode_attention(
            q, k_pool, v_pool, block_tables, lengths, window=window,
            softcap=softcap, scale=scale)

    def paged_prefill_attention(self, q, k_pool, v_pool, block_table,
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
