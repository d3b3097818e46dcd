"""Gemmini generator configuration (port of ``repro.core.config``).

A :class:`GemminiConfig` names one elaborated accelerator instance: the
dataflow, the tile granularity, and the input / accumulator / output
datatypes. The datatype names map to ``torch`` dtypes here; the validation
rules are the JAX package's. The Table-1 design points belong to the DSE
path, which is a later slice.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Optional

import torch


class Dataflow(enum.Enum):
    """Systolic dataflow: OS (output-stationary), WS (weight-stationary),
    BOTH (runtime-selectable)."""

    OS = "OS"
    WS = "WS"
    BOTH = "BOTH"


class Activation(enum.Enum):
    """Fused non-linear activation units (paper section 2.1)."""

    NONE = "none"
    RELU = "relu"
    RELU6 = "relu6"
    GELU = "gelu"
    SILU = "silu"


# dtype name -> torch dtype.
_DTYPES: Mapping[str, torch.dtype] = {
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "bf16": torch.bfloat16,
    "fp16": torch.float16,
    "fp32": torch.float32,
}


def dtype_of(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown datatype {name!r}; options: {sorted(_DTYPES)}")
    return _DTYPES[name]


def bytes_of(name: str) -> int:
    return torch.empty((), dtype=dtype_of(name)).element_size()


@dataclasses.dataclass(frozen=True)
class GemminiConfig:
    """One elaborated accelerator instance (see ``repro.core.config`` for
    the meaning of every field; the defaults and checks are the same)."""

    dataflow: Dataflow = Dataflow.OS
    dim: int = 128
    input_dtype: str = "int8"
    acc_dtype: str = "int32"
    output_dtype: str = "int8"
    scratchpad_bytes: int = 8 * 1024 * 1024
    accumulator_bytes: int = 4 * 1024 * 1024
    banks: int = 4
    pipeline_depth: int = 2
    max_tile_m: Optional[int] = None
    max_tile_n: Optional[int] = None
    max_tile_k: Optional[int] = None
    hbm_bytes: int = 16 * 1024 * 1024 * 1024

    def __post_init__(self):
        if self.dim % 8 != 0 or self.dim <= 0:
            raise ValueError(f"dim must be a positive multiple of 8, got {self.dim}")
        if self.banks < 2:
            raise ValueError("banks >= 2 required (A and B streams)")
        if self.pipeline_depth not in (1, 2, 3):
            raise ValueError("pipeline_depth in {1,2,3}")
        dtype_of(self.input_dtype), dtype_of(self.acc_dtype), dtype_of(self.output_dtype)
        if self.scratchpad_bytes < 4 * self.dim * self.dim * bytes_of(self.input_dtype):
            raise ValueError("scratchpad too small for even one double-buffered tile pair")

    @property
    def acc_torch(self) -> torch.dtype:
        return dtype_of(self.acc_dtype)

    @property
    def output_torch(self) -> torch.dtype:
        return dtype_of(self.output_dtype)
