"""Parameters and paged state from numpy, for weights made elsewhere.

``params_from_numpy`` takes a nested dict of numpy arrays -- the JAX
package's parameter tree after ``np.asarray`` on every leaf -- and builds
the port's tree on ``device``. bf16 leaves may arrive as numpy's bfloat16
extension dtype (moved by bit pattern) or as float32 with ``dtype=
torch.bfloat16`` requested; bf16 -> f32 -> bf16 is lossless, so both give
the same bits. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.models.transformer import PagedDecodeState


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
    """``dtype`` casts the floating leaves that are not fp32 norm scales'
    peers -- pass the model dtype when the tree arrives as fp32 copies;
    rmsnorm scales stay fp32 as the JAX package keeps them."""
    def conv(name, node):
        if isinstance(node, Mapping):
            return {k: conv(k, v) for k, v in node.items()}
        t = tensor_from_numpy(np.asarray(node), device)
        if dtype is not None and t.is_floating_point() and not _is_norm(name):
            t = t.to(dtype)
        return t
    return {k: conv(k, v) for k, v in tree.items()}


def _is_norm(name: str) -> bool:
    return name in ("ln1", "ln2", "post_ln1", "post_ln2", "qnorm", "knorm",
                    "final_norm")


def paged_state_from_numpy(state: Any, device="cpu",
                           dtype: Optional[torch.dtype] = None
                           ) -> PagedDecodeState:
    """``state``: a mapping (or object) with ``kv_k``, ``kv_v``,
    ``tables`` and ``lengths`` numpy arrays (``conv`` / ``ssm`` None)."""
    get = state.get if isinstance(state, Mapping) else \
        (lambda k: getattr(state, k))
    kv = [tensor_from_numpy(np.asarray(get(k)), device, dtype)
          for k in ("kv_k", "kv_v")]
    return PagedDecodeState(
        kv[0], kv[1], None, None,
        tensor_from_numpy(np.asarray(get("tables")), device, torch.int32),
        tensor_from_numpy(np.asarray(get("lengths")), device, torch.int32))
