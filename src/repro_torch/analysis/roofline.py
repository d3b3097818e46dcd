"""The card's peak rates, the roofline the profiler divides by, and the
dry run's three-term roofline (port of ``repro.analysis.roofline``: its
terms come from ``analysis.cost`` where the JAX module reads XLA's HLO).

Published dense rates of one NVIDIA H100 SXM (80 GB HBM3) at its full
power limit of 700 W, the rates PERF.md's bounds use. A card set below
700 W reaches less; its limit is printed beside every measurement
(``nvidia-smi --query-gpu=name,power.limit``).

Hopper has no int16 MMA. An int16 product runs exactly as four int8
products of byte planes (``kernels/csrc/igemm.cuh``), so the int16 peak
is the int8 tensor rate over four.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

CARD = "NVIDIA H100 SXM 80GB HBM3, 700 W"

HBM_BW = 3.35e12                  # B/s
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_FLOPS_FP16 = 989e12
PEAK_FLOPS_FP32 = 67e12           # CUDA cores (no TF32)
PEAK_OPS_INT8 = 1979e12           # OP/s, tensor cores
PEAK_OPS_INT16 = PEAK_OPS_INT8 / 4
# int32 has no tensor-core MMA: multiply-adds on the CUDA cores, 64 INT32
# lanes an SM against 128 fp32 ones, so half the fp32 rate.
PEAK_OPS_INT32 = PEAK_FLOPS_FP32 / 2

_PEAKS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float16: PEAK_FLOPS_FP16,
          torch.float32: PEAK_FLOPS_FP32, torch.int8: PEAK_OPS_INT8,
          torch.int16: PEAK_OPS_INT16, torch.int32: PEAK_OPS_INT32}


def peak_ops(dtype: torch.dtype) -> float:
    """The card's peak rate for products of ``dtype`` inputs."""
    try:
        return _PEAKS[dtype]
    except KeyError:
        raise ValueError(f"no peak rate for {dtype} inputs") from None


# ---------------------------------------------------------------------------
# the dry run's roofline (``repro.analysis.roofline``'s Roofline / analyze)
# ---------------------------------------------------------------------------
# Link rates of the collective term, one direction, by whether a mesh
# axis's devices sit in one node. Within an 8-GPU H100 SXM node every
# card reaches every other over NVLink 4 through the NVSwitches: 900 GB/s
# in all, 450 GB/s a direction (NVIDIA H100 Tensor Core GPU datasheet).
# An axis that crosses nodes goes through each card's 400 Gb/s NDR
# InfiniBand adapter (ConnectX-7, as in a DGX H100): 50 GB/s a direction.
# Both are published peaks for the card named in ``CARD`` (700 W).
GPUS_PER_NODE = 8
NVLINK_BW = 450e9                 # B/s a direction, within a node
NDR_BW = 50e9                     # B/s a direction, across nodes


def axis_link_bw(mesh, axis: str) -> float:
    """The link rate of ``axis``: NVLink where the axis's devices (those
    of rank 0's line along it) share one node of ``GPUS_PER_NODE``, else
    NDR."""
    names = tuple(mesh.mesh_dim_names)
    ranks = mesh.mesh
    idx = [0] * ranks.dim()
    idx[names.index(axis)] = slice(None)
    line = ranks[tuple(idx)].flatten().tolist()
    return NVLINK_BW if len({r // GPUS_PER_NODE for r in line}) == 1 \
        else NDR_BW


@dataclasses.dataclass
class Roofline:
    """One dry-run cell's three terms on the card: compute (per-device
    FLOPs at the bf16 tensor-core peak), memory (per-device bytes at HBM
    rate), collective (each axis's bytes at its link rate, summed)."""
    arch: str
    shape: str
    mesh: str
    flops: float                  # per-device FLOPs (analysis.cost)
    hbm_bytes: float              # per-device bytes, unfused
    coll_bytes: float             # per-device collective bytes (AR x2)
    coll_breakdown: Dict[str, float]
    coll_by_axis: Dict[str, float]
    axis_bw: Dict[str, float]     # B/s per axis (axis_link_bw)
    per_device_hbm_peak: float    # argument + output bytes of the shards
    model_flops: float            # 6ND / 2ND analytic useful flops (global)
    n_chips: int
    logical_flops: float = 0.0    # the step's FLOPs above DTensor (global)
    min_bytes: float = 0.0        # inherent minimal HBM traffic (global)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return sum(b / self.axis_bw.get(a, NDR_BW)
                   for a, b in self.coll_by_axis.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (per-device FLOPs x devices)."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def replication(self) -> float:
        """(per-device FLOPs x devices) / the logical FLOPs: 1 where the
        mesh splits all work, the devices' count where each does all of
        it."""
        return self.flops * self.n_chips / self.logical_flops \
            if self.logical_flops else 0.0

    @property
    def t_ideal(self) -> float:
        """The larger of useful compute at peak and the inherent minimal
        HBM traffic at full rate, per device."""
        t_c = self.model_flops / self.n_chips / PEAK_FLOPS_BF16
        t_m = self.min_bytes / self.n_chips / HBM_BW
        return max(t_c, t_m)

    @property
    def roofline_fraction(self) -> float:
        return self.t_ideal / self.t_bound if self.t_bound else 0.0

    def row(self) -> Dict:
        return dict(
            arch=self.arch, shape=self.shape, mesh=self.mesh, card=CARD,
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, bottleneck=self.bottleneck,
            flops=self.flops, bytes=self.hbm_bytes,
            coll_bytes=self.coll_bytes,
            coll_breakdown={k: v for k, v in self.coll_breakdown.items()
                            if v},
            coll_by_axis=dict(self.coll_by_axis), axis_bw=dict(self.axis_bw),
            logical_flops=self.logical_flops, replication=self.replication,
            model_flops=self.model_flops, useful_ratio=self.useful_ratio,
            roofline_fraction=self.roofline_fraction,
            per_device_hbm=self.per_device_hbm_peak,
            min_bytes=self.min_bytes, t_ideal=self.t_ideal)


def analyze(report, *, arch: str, shape: str, mesh, mesh_name: str,
            n_chips: int, model_flops: float, arg_bytes: float = 0.0,
            out_bytes: float = 0.0) -> Roofline:
    """The :class:`Roofline` of an ``analysis.cost.CostReport``."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, flops=report.flops,
        hbm_bytes=report.bytes, coll_bytes=report.coll_bytes,
        coll_breakdown=dict(report.coll_breakdown),
        coll_by_axis=dict(report.coll_by_axis),
        axis_bw={a: axis_link_bw(mesh, a) for a in mesh.mesh_dim_names},
        per_device_hbm_peak=arg_bytes + out_bytes, model_flops=model_flops,
        n_chips=n_chips, logical_flops=report.logical_flops)


def model_flops_for(cfg, shape_kind: str, batch: int, seq: int) -> float:
    """Analytic useful FLOPs: 6*N*D train, 2*N*D inference forward,
    2*N per decoded token (D = tokens processed, N = active params)."""
    n = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n * batch * seq
    if shape_kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch          # decode: one token per sequence


def model_min_bytes_for(cfg, shape_kind: str, batch: int, seq: int) -> float:
    """Inherent minimal global HBM traffic per step (the memory roofline).

    decode:  every active parameter (bf16) and every cache byte must be
             read once per token -- the fundamental decode bound.
    prefill: parameters once + activations written once + KV written.
    train:   parameters + opt state (2x fp32) read/written once + the
             residual stream written in fwd and read in bwd.
    These are deliberate LOWER bounds (no rematerialization, perfect fusion
    of everything else), so roofline_fraction never flatters the system.
    """
    n_active = cfg.active_param_count()
    n_stored = cfg.param_count()
    act_bytes = 2.0 * batch * seq * cfg.d_model          # residual, bf16
    kv_bytes = 0.0
    if cfg.has_attn:
        kv_bytes += (2.0 * cfg.n_layers * batch * seq *
                     cfg.n_kv_heads * cfg.head_dim * 2)  # K+V bf16
    if cfg.has_ssm:
        kv_bytes += (cfg.n_layers * batch * cfg.n_ssm_heads *
                     cfg.d_state * cfg.ssm_head_dim * 4)  # fp32 state
    if shape_kind == "decode":
        return 2.0 * n_active + kv_bytes
    if shape_kind == "prefill":
        return 2.0 * n_active + act_bytes + kv_bytes
    # train: params bf16 + grads bf16 + m/v fp32 r+w, fwd act write + bwd read
    opt_bytes = n_stored * (2 + 2 + 4 * 4)
    return opt_bytes + 2.0 * act_bytes * cfg.n_layers
