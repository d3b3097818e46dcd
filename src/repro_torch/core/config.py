"""Gemmini generator configuration (port of ``repro.core.config``).

A :class:`GemminiConfig` names one elaborated accelerator instance: the
dataflow, the tile granularity, and the input / accumulator / output
datatypes. The datatype names map to ``torch`` dtypes here; the validation
rules and the Table-1 design points are the JAX package's, value for value.
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
    def input_torch(self) -> torch.dtype:
        return dtype_of(self.input_dtype)

    @property
    def acc_torch(self) -> torch.dtype:
        return dtype_of(self.acc_dtype)

    @property
    def output_torch(self) -> torch.dtype:
        return dtype_of(self.output_dtype)

    @property
    def is_quantized(self) -> bool:
        return not self.input_torch.is_floating_point

    def replace(self, **kw) -> "GemminiConfig":
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        return (
            f"Gemmini[{self.dataflow.value} dim={self.dim} "
            f"{self.input_dtype}->{self.acc_dtype}->{self.output_dtype} "
            f"spad={self.scratchpad_bytes//1024}KiB acc={self.accumulator_bytes//1024}KiB "
            f"banks={self.banks} pipe={self.pipeline_depth}]"
        )


# ---------------------------------------------------------------------------
# Table 1 design points (``repro.core.config``): DESIGN_POINTS re-targeted
# to the TPU-scaled analogue space, PAPER_DESIGN_POINTS at the paper's own
# scale (16x16 int8 array, 64 KiB scratchpad) for the analytic ISA/DSE
# reproduction. Rows 9 and 10 are system-level (DMA model, host core).
# ---------------------------------------------------------------------------
_BASE = GemminiConfig()

DESIGN_POINTS: Mapping[int, GemminiConfig] = {
    1: _BASE,                                                     # baseline (OS)
    2: _BASE.replace(dataflow=Dataflow.WS),                       # WS
    3: _BASE.replace(dataflow=Dataflow.BOTH),                     # OS + WS runtime
    4: _BASE.replace(input_dtype="fp32", acc_dtype="fp32",        # 32b in / 32b acc
                     output_dtype="fp32"),
    5: _BASE.replace(dim=256),                                    # 32x32 (2x DIM)
    6: _BASE.replace(pipeline_depth=1),                           # fully combinational
    7: _BASE.replace(scratchpad_bytes=32 * 1024 * 1024),          # 4x scratchpad
    8: _BASE.replace(banks=8),                                    # more banks
    9: _BASE,                                                     # bus width (DMA model)
    10: _BASE,                                                    # host CPU (bench-level)
}

# Which Table-1 rows are kernel-level vs system-level (evaluated where).
SYSTEM_LEVEL_POINTS = {9: "bus_width_64b", 10: "host_cpu_boom"}

_PAPER_BASE = GemminiConfig(
    dim=16, scratchpad_bytes=64 * 1024, accumulator_bytes=16 * 1024,
    banks=5, pipeline_depth=2)

PAPER_DESIGN_POINTS: Mapping[int, GemminiConfig] = {
    1: _PAPER_BASE,                                              # baseline OS
    2: _PAPER_BASE.replace(dataflow=Dataflow.WS),                # WS
    3: _PAPER_BASE.replace(dataflow=Dataflow.BOTH),              # OS + WS
    4: _PAPER_BASE.replace(input_dtype="fp32", acc_dtype="fp32",
                           output_dtype="fp32"),                 # 32b in
    5: _PAPER_BASE.replace(dim=32, accumulator_bytes=64 * 1024), # 32x32
    6: _PAPER_BASE.replace(pipeline_depth=1),                    # combinational
    7: _PAPER_BASE.replace(scratchpad_bytes=256 * 1024,          # 4x spad
                           accumulator_bytes=64 * 1024),         # (paper sec.4
                                                                 # pairs 256K/64K)
    8: _PAPER_BASE.replace(banks=33),                            # more banks
    9: _PAPER_BASE,                                              # narrow bus
    10: _PAPER_BASE,                                             # BOOM host
}
