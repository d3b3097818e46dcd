"""Design-space exploration engine (paper section 3).

(A copy of ``repro.core.dse``, verbatim up to import paths: it is pure
Python, and the port imports nothing of ``repro``.)

Reproduces the paper's methodology: vary one generator parameter at a time
from the baseline (Table 1 design points), evaluate *whole workloads* (not
single layers), and report performance plus efficiency proxies.

Because we target TPUs in software, the three evaluation axes map to:
  performance  -> decoupled-queue cycle model (core.isa) over the workload's
                  full GEMM stream + measured kernel wall-time where runnable
  energy proxy -> total HBM bytes moved (the paper itself notes external
                  memory access dominates inference energy)
  area proxy   -> VMEM residency + streamed working set of the elaborated
                  schedule (scratchpad + accumulator provisioning)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import isa
from repro_torch.core.config import (DESIGN_POINTS, PAPER_DESIGN_POINTS,
                                     Dataflow, GemminiConfig)
from repro_torch.core.tiling import TilePlan, plan_gemm

# Signature of plan_gemm; the tuner provides a measured-schedule drop-in.
PlanFn = Callable[..., TilePlan]


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """One GEMM in a workload, with an optional host-side (CPU) cost.

    ``host_flops`` models work that cannot map to the engine (im2col,
    depthwise conv, bookkeeping) -- the paper's Amdahl term.
    """

    m: int
    n: int
    k: int
    has_bias: bool = True
    repeats: int = 1
    host_flops: float = 0.0


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    gemms: Tuple[GemmShape, ...]
    # Host-only work (cycles on the host core @ engine clock) that no design
    # point can accelerate: depthwise convs, reshapes, activations glue.
    host_only_flops: float = 0.0


@dataclasses.dataclass(frozen=True)
class DSEResult:
    point: int
    workload: str
    engine_cycles: float
    host_cycles: float
    total_cycles: float
    bottleneck: str
    hbm_bytes: float
    vmem_bytes: int
    macs: float
    utilization: float

    @property
    def macs_per_cycle(self) -> float:
        return self.macs / self.total_cycles if self.total_cycles else 0.0


# Host core sustained FLOPs/cycle for non-engine work.
_HOST_FLOPS_PER_CYCLE = {"rocket": 1.0, "boom": 3.0}


def evaluate(cfg: GemminiConfig, wl: Workload, sys: isa.SystemParams,
             host: str = "rocket",
             dataflow: Optional[Dataflow] = None,
             plan_fn: Optional[PlanFn] = None) -> Dict[str, float]:
    """``plan_fn`` swaps the schedule source: default is the greedy analytic
    solver. The JAX package's measured-cost backend (a tuned ``TilePlan``
    per GEMM) has no counterpart in the port yet: the card's tuner measures
    the H100 kernels' plans, not Gemmini tile plans (ROADMAP A12's
    remainder, ``tuned_plan_fn``)."""
    plan_fn = plan_fn or plan_gemm
    engine_cycles = 0.0
    hbm = 0.0
    macs = 0.0
    vmem = 0
    useful = 0.0
    bottlenecks: Dict[str, float] = {}
    for g in wl.gemms:
        plan = plan_fn(cfg, g.m, g.n, g.k, dataflow=dataflow,
                       has_bias=g.has_bias)
        t = isa.simulate(plan, cfg, sys, has_bias=g.has_bias)
        engine_cycles += t.total_cycles * g.repeats
        bottlenecks[t.bottleneck] = bottlenecks.get(t.bottleneck, 0.0) + \
            t.total_cycles * g.repeats
        hbm += (plan.hbm_read_bytes + plan.hbm_write_bytes) * g.repeats
        macs += plan.macs * g.repeats
        useful += plan.macs * plan.utilization * g.repeats
        vmem = max(vmem, plan.vmem_streamed_bytes + plan.vmem_resident_bytes)
    host_flops = wl.host_only_flops + sum(g.host_flops * g.repeats
                                          for g in wl.gemms)
    host_cycles = host_flops / _HOST_FLOPS_PER_CYCLE[host]
    return dict(engine_cycles=engine_cycles, host_cycles=host_cycles,
                total_cycles=engine_cycles + host_cycles,
                bottleneck=max(bottlenecks, key=bottlenecks.get)
                if bottlenecks else "none",
                hbm_bytes=hbm, vmem_bytes=vmem, macs=macs,
                utilization=useful / macs if macs else 0.0)


def run_design_points(wl: Workload,
                      points: Sequence[int] = tuple(range(1, 11)),
                      design_points=None,
                      plan_fn: Optional[PlanFn] = None) -> List[DSEResult]:
    """Evaluate Table-1 design points 1-10 on a workload (paper-native
    scale by default; pass config.DESIGN_POINTS for the TPU-scaled set)."""
    out = []
    for p in points:
        cfg = (design_points or PAPER_DESIGN_POINTS)[p]
        sys = isa.NARROW_BUS if p == 9 else \
            (isa.BOOM if p == 10 else isa.ROCKET)
        host = "boom" if p == 10 else "rocket"
        df = Dataflow.WS if p == 2 else (None if cfg.dataflow is not
                                         Dataflow.BOTH else Dataflow.OS)
        r = evaluate(cfg, wl, sys, host=host, dataflow=df, plan_fn=plan_fn)
        out.append(DSEResult(point=p, workload=wl.name,
                             engine_cycles=r["engine_cycles"],
                             host_cycles=r["host_cycles"],
                             total_cycles=r["total_cycles"],
                             bottleneck=r["bottleneck"],
                             hbm_bytes=r["hbm_bytes"],
                             vmem_bytes=int(r["vmem_bytes"]),
                             macs=r["macs"],
                             utilization=r["utilization"]))
    return out


# ---------------------------------------------------------------------------
# The paper's workloads, reconstructed at the GEMM-stream level.
# Layer dims from the public model definitions; host_flops carries the
# CPU-side im2col / depthwise / glue work the paper identifies.
# ---------------------------------------------------------------------------
def _conv_gemm(oh, ow, kh, kw, cin, cout, repeats=1, batch=1,
               im2col_on_host=True) -> GemmShape:
    m = oh * ow * batch
    k = kh * kw * cin
    # im2col expands the input kh*kw-fold; the paper does it on the host
    # (~1 host op per patch element moved; 1x1 convs need no reshaping).
    host = float(m * k) if im2col_on_host and (kh, kw) != (1, 1) else 0.0
    return GemmShape(m=m, n=cout, k=k, repeats=repeats, host_flops=host)


def mobilenet_v1(batch: int = 1) -> Workload:
    """MobileNetV1: pointwise convs on the engine; depthwise on the host
    (the paper's own mapping, section 3.3)."""
    gemms, host = [], 0.0
    spec = [  # (oh, cin, cout) for each pointwise conv after a dw conv
        (112, 32, 64), (56, 64, 128), (56, 128, 128), (28, 128, 256),
        (28, 256, 256), (14, 256, 512), *[(14, 512, 512)] * 5,
        (7, 512, 1024), (7, 1024, 1024)]
    # first standard 3x3 conv
    gemms.append(_conv_gemm(112, 112, 3, 3, 3, 32, batch=batch))
    for oh, cin, cout in spec:
        gemms.append(_conv_gemm(oh, oh, 1, 1, cin, cout, batch=batch))
        # depthwise 3x3 on the host: 9 MACs/output at ~5 host cycles/MAC
        # (strided gathers defeat the scalar in-order core's pipelining --
        # the paper: depthwise "take up nearly 100% of the execution time
        # in the accelerated workload")
        host += 5.0 * 9 * oh * oh * cin * batch
    gemms.append(GemmShape(m=batch, n=1000, k=1024))  # classifier
    return Workload("mobilenet", tuple(gemms), host_only_flops=host)


def _resnet_block(oh, cin, cmid, cout, stride, batch):
    return [
        _conv_gemm(oh, oh, 1, 1, cin, cmid, batch=batch),
        _conv_gemm(oh, oh, 3, 3, cmid, cmid, batch=batch),
        _conv_gemm(oh, oh, 1, 1, cmid, cout, batch=batch),
    ]


def resnet(depth: int, batch: int = 1) -> Workload:
    blocks = {50: (3, 4, 6, 3), 152: (3, 8, 36, 3)}[depth]
    gemms = [_conv_gemm(112, 112, 7, 7, 3, 64, batch=batch)]
    oh, cin = 56, 64
    for stage, nblocks in enumerate(blocks):
        cmid = 64 * (2 ** stage)
        cout = cmid * 4
        for b in range(nblocks):
            gemms += _resnet_block(oh, cin, cmid, cout, 1, batch)
            cin = cout
        oh //= 2
    gemms.append(GemmShape(m=batch, n=1000, k=2048))
    return Workload(f"resnet{depth}", tuple(gemms))


def mlp(dims: Sequence[int], batch: int = 128, name: str = "mlp") -> Workload:
    """Batched MLP inference (cloud MLPs exploit batch-level parallelism,
    paper section 2.2)."""
    gemms = [GemmShape(m=batch, n=dims[i + 1], k=dims[i])
             for i in range(len(dims) - 1)]
    return Workload(name, tuple(gemms))


# The four MLPs of Fig. 7b ([27][28][29][30]): digit MLPs, speech-enhancement
# autoencoder, multimodal net. MLP4's power-of-two dims tile better than
# MLP3's -- the paper's tiling-fit finding.
PAPER_MLPS = {
    "mlp1": mlp([784, 2500, 2000, 1500, 1000, 500, 10], name="mlp1"),
    "mlp2": mlp([784, 800, 800, 10], name="mlp2"),
    "mlp3": mlp([257, 2048, 2048, 2048, 257], name="mlp3"),
    "mlp4": mlp([512, 1024, 1024, 1024, 512, 128], name="mlp4"),
}

PAPER_DNNS = {
    "mobilenet": mobilenet_v1(),
    "resnet50": resnet(50),
    "resnet152": resnet(152),
}
