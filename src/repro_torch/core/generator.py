"""Elaboration: GemminiConfig -> a concrete accelerator instance (port of
``repro.core.generator``).

``elaborate(cfg)`` is the analogue of running the Chisel generator: it
checks the parameterization and returns a :class:`GemminiInstance` holding

  * ``ctx``: the instance's :class:`ExecutionContext`, which every op
    launch goes through (``gemm`` / ``matmul`` / ``conv2d`` here delegate
    to it);
  * ``header``: the "generated header file" of tiling parameters the
    software library compiles against (paper section 2.3), from the same
    ``plan_gemm`` solver as the JAX package;
  * ``plan``: the analytic tile plan the DSE runs on.

There is no backend argument: the device of the operands decides, as
everywhere in the port. The CUDA kernels pick their own tiles; the header
and plan describe the paper's accelerator, not the kernels' launch
shapes. :meth:`GemminiInstance.with_mesh` derives an instance whose
context hands each kernel its local shard (``core.context``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.core.config import Activation, Dataflow, GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.core.tiling import TilePlan, plan_gemm


@dataclasses.dataclass(frozen=True)
class GemminiInstance:
    """One elaborated accelerator + its co-designed software parameters."""

    cfg: GemminiConfig
    mesh: Any = None       # partitioned dispatch: kernels on local shards
    axis: Any = "data"     # mesh axis the batch-like dims shard over

    @functools.cached_property
    def ctx(self) -> ExecutionContext:
        return ExecutionContext(cfg=self.cfg, mesh=self.mesh, axis=self.axis)

    # -- engine entry points (delegates into ctx) --------------------------
    def gemm(self, a: torch.Tensor, b: torch.Tensor,
             d: Optional[torch.Tensor] = None, *,
             dataflow: Optional[Dataflow] = None, shift: int = 0,
             activation: Activation = Activation.NONE) -> torch.Tensor:
        return self.ctx.gemm(a, b, d, dataflow=dataflow, shift=shift,
                             activation=activation)

    def matmul(self, a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
        return self.ctx.matmul(a, b, **kw)

    def conv2d(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
        return self.ctx.conv2d(x, w, b, **kw)

    # -- the generated "header file" ---------------------------------------
    def header(self, m: int, n: int, k: int, *,
               dataflow: Optional[Dataflow] = None,
               has_bias: bool = False) -> Dict[str, Any]:
        """Tiling parameters for an (m, n, k) GEMM, as the generator emits
        them for the software library."""
        plan = plan_gemm(self.cfg, m, n, k, dataflow=dataflow,
                         has_bias=has_bias)
        return {
            "DIM": self.cfg.dim,
            "TILE_M": plan.tile_m, "TILE_N": plan.tile_n,
            "TILE_K": plan.tile_k, "GRID": plan.grid,
            "SPAD_BYTES": self.cfg.scratchpad_bytes,
            "ACC_BYTES": self.cfg.accumulator_bytes,
            "DATAFLOW": plan.dataflow.value,
            "UTILIZATION": plan.utilization,
            "ARITH_INTENSITY": plan.arithmetic_intensity,
        }

    def plan(self, m: int, n: int, k: int, **kw) -> TilePlan:
        return plan_gemm(self.cfg, m, n, k, **kw)

    def with_mesh(self, mesh, axis: Any = "data") -> "GemminiInstance":
        """A mesh-aware instance: its ops run each kernel on the local
        shard, dim 0 of the batched operands split over ``axis``, and
        resolve schedules at the per-device shapes (warm them with
        ``tune.warm_model_plans(n_shards=...)``)."""
        return dataclasses.replace(self, mesh=mesh, axis=axis)


@functools.lru_cache(maxsize=64)
def elaborate(cfg: GemminiConfig) -> GemminiInstance:
    """Run the generator: validate the parameterization and build an
    instance (the Chisel generator's elaboration-time ``require()``s)."""
    min_tile = cfg.dim * cfg.dim
    if cfg.accumulator_bytes < min_tile * cfg.acc_torch.itemsize:
        raise ValueError("accumulator cannot hold one output tile")
    return GemminiInstance(cfg=cfg)
