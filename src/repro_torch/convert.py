"""Parameters and paged state from numpy, for weights made elsewhere.

``params_from_numpy`` takes a nested dict of numpy arrays -- the JAX
package's parameter tree after ``np.asarray`` on every leaf -- and builds
the port's tree on ``device``. bf16 leaves may arrive as numpy's bfloat16
extension dtype (moved by bit pattern) or as float32 with ``dtype=
torch.bfloat16`` requested; bf16 -> f32 -> bf16 is lossless, so both give
the same bits. The tree may hold any family's leaves: attention and MLP
weights, Mamba-2 blocks (``in_proj``, ``conv_w``, ``a_log``, ``d_skip``,
``dt_bias``, ``norm``, ``out_proj``), hymba's ``meta_tokens``,
musicgen's stacked codebook tables and ``heads``, and MoE blocks
(``router``, the stacked experts ``wi`` / ``wg`` / ``wo``, ``shared``).
Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.models.transformer import DecodeState, PagedDecodeState


def tensor_from_numpy(a: np.ndarray, device="cpu",
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Mapping[str, Any], device="cpu",
                      dtype: Optional[torch.dtype] = None) -> dict:
    """``dtype`` casts the floating leaves the JAX package keeps in the
    model dtype -- pass it when the tree arrives as fp32 copies; the leaves
    it keeps in fp32 (rmsnorm scales, the SSM's ``a_log``, ``d_skip`` and
    ``dt_bias``, the MoE ``router``) stay fp32."""
    def conv(name, node):
        if isinstance(node, Mapping):
            return {k: conv(k, v) for k, v in node.items()}
        t = tensor_from_numpy(np.asarray(node), device)
        if dtype is not None and t.is_floating_point() and \
                name not in FP32_LEAVES:
            t = t.to(dtype)
        return t
    return {k: conv(k, v) for k, v in tree.items()}


FP32_LEAVES = frozenset({"ln1", "ln2", "post_ln1", "post_ln2", "qnorm",
                         "knorm", "final_norm", "attn_out_norm",
                         "ssm_out_norm", "norm", "a_log", "d_skip",
                         "dt_bias", "router"})


def _getter(state: Any):
    return state.get if isinstance(state, Mapping) else \
        (lambda k: getattr(state, k, None))


def _maybe(a, device, dtype=None):
    return None if a is None else tensor_from_numpy(np.asarray(a), device,
                                                    dtype)


def paged_state_from_numpy(state: Any, device="cpu",
                           dtype: Optional[torch.dtype] = None
                           ) -> PagedDecodeState:
    """``state``: a mapping (or object) with ``kv_k``, ``kv_v``, ``conv``,
    ``ssm`` (each may be None), ``tables`` and ``lengths`` numpy arrays.
    ``dtype`` casts the pools and the conv state; the SSM state stays
    fp32."""
    get = _getter(state)
    return PagedDecodeState(
        _maybe(get("kv_k"), device, dtype), _maybe(get("kv_v"), device, dtype),
        _maybe(get("conv"), device, dtype),
        _maybe(get("ssm"), device, torch.float32),
        tensor_from_numpy(np.asarray(get("tables")), device, torch.int32),
        tensor_from_numpy(np.asarray(get("lengths")), device, torch.int32))


def decode_state_from_numpy(state: Any, device="cpu",
                            dtype: Optional[torch.dtype] = None
                            ) -> DecodeState:
    """The static path's dense state: ``kv_k``, ``kv_v``, ``conv``,
    ``ssm`` (each may be None) and the scalar ``pos``, which becomes a
    host int."""
    get = _getter(state)
    return DecodeState(
        _maybe(get("kv_k"), device, dtype), _maybe(get("kv_v"), device, dtype),
        _maybe(get("conv"), device, dtype),
        _maybe(get("ssm"), device, torch.float32), int(np.asarray(get("pos"))))
