"""Tiling solver: generator parameters -> tile factors.

(A copy of ``repro.core.tiling``, verbatim up to import paths: it is pure
Python, and the port imports nothing of ``repro``.)

The paper's software library ships "tiling parameters ... generated by the
Chisel generator, and included as a header file" (section 2.3): tile sizes are a
pure function of the elaborated array dimension and scratchpad capacity.  This
module is that header-file generator for the TPU target.

Given a GemminiConfig and a GEMM problem (M, N, K), it returns the Pallas
block shapes (tile_m, tile_n, tile_k) and grid such that

  * every tile dim is a multiple of cfg.dim (operands are zero-padded up,
    exactly like the paper zero-pads to the array size, section 3.3);
  * the double-buffered streamed working set fits ``scratchpad_bytes``:
        pipeline_depth * (tile_m*tile_k*in_b + tile_k*tile_n*in_b [+ D tile])
  * the resident accumulator tile fits ``accumulator_bytes``:
        tile_m*tile_n*acc_b   (OS: PE-resident accumulator; WS: output
        revisited across K -- same VMEM residency requirement);
  * data reuse is maximized: we prefer growing tile_k (OS) or tile_m (WS)
    first, mirroring each dataflow's reuse direction, then the others.

The solver also returns the DMA/traffic model used by the DSE (bytes moved
between HBM("main memory") and VMEM("scratchpad") for the schedule), which is
what reproduces the paper's scratchpad-size and bus-width findings without
hardware.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

from repro_torch.core.config import Dataflow, GemminiConfig, bytes_of


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_down_mult(x: int, m: int) -> int:
    return max(m, (x // m) * m)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A complete schedule for one GEMM on one elaborated instance."""

    m: int                      # padded problem dims
    n: int
    k: int
    tile_m: int
    tile_n: int
    tile_k: int
    grid: Tuple[int, int, int]  # (m_steps, n_steps, k_steps) logical grid
    dataflow: Dataflow
    # --- analytic traffic model (per full GEMM) ---
    hbm_read_bytes: int         # A,B,D streamed in
    hbm_write_bytes: int        # C written out
    vmem_streamed_bytes: int    # working set of streamed tiles (w/ buffering)
    vmem_resident_bytes: int    # accumulator/weight residency
    macs: int                   # M*N*K (padded)
    utilization: float          # useful MACs / padded MACs

    @property
    def arithmetic_intensity(self) -> float:
        return 2.0 * self.macs / max(1, self.hbm_read_bytes + self.hbm_write_bytes)

    @property
    def k_steps(self) -> int:
        return self.grid[2]


def _resolve_dataflow(cfg: GemminiConfig,
                      dataflow: Optional[Dataflow]) -> Dataflow:
    df = dataflow or (Dataflow.WS if cfg.dataflow is Dataflow.BOTH
                      else cfg.dataflow)
    if cfg.dataflow is not Dataflow.BOTH and df is not cfg.dataflow:
        raise ValueError(f"config elaborated with {cfg.dataflow}, asked for {df}")
    return df


def _streamed_bytes(cfg: GemminiConfig, tm: int, tn: int, tk: int,
                    has_bias: bool) -> int:
    # A tile + B tile (+ D/bias tile read once per (m,n) block at acc width)
    in_b = bytes_of(cfg.input_dtype)
    s = tm * tk * in_b + tk * tn * in_b
    if has_bias:
        s += tn * bytes_of(cfg.acc_dtype)  # bias row tile
    return cfg.pipeline_depth * s


def _resident_bytes(cfg: GemminiConfig, df: Dataflow, tm: int, tn: int,
                    tk: int) -> int:
    acc_b = bytes_of(cfg.acc_dtype)
    if df is Dataflow.OS:
        return tm * tn * acc_b               # C resident in accumulator
    in_b = bytes_of(cfg.input_dtype)
    return tk * tn * in_b + tm * tn * acc_b  # B resident + C revisited


def _fits(cfg: GemminiConfig, df: Dataflow, tm: int, tn: int, tk: int,
          has_bias: bool) -> bool:
    return (
        _streamed_bytes(cfg, tm, tn, tk, has_bias) <= cfg.scratchpad_bytes
        and _resident_bytes(cfg, df, tm, tn, tk) <= cfg.accumulator_bytes
    )


def make_plan(
    cfg: GemminiConfig,
    m: int,
    n: int,
    k: int,
    tile_m: int,
    tile_n: int,
    tile_k: int,
    *,
    dataflow: Optional[Dataflow] = None,
    has_bias: bool = False,
) -> TilePlan:
    """Build a :class:`TilePlan` from explicit tile factors.

    The shared back half of the greedy solver, the tuner's candidate
    enumeration, and the plan-cache loader: given legal dim-aligned tiles, it
    pads the problem to the tile grid and computes the analytic traffic model.
    Raises ``ValueError`` if the tiles are misaligned or bust the budgets.
    """
    df = _resolve_dataflow(cfg, dataflow)
    dim = cfg.dim
    for name, t in (("tile_m", tile_m), ("tile_n", tile_n), ("tile_k", tile_k)):
        if t <= 0 or t % dim:
            raise ValueError(f"{name}={t} is not a positive multiple of dim={dim}")
    if not _fits(cfg, df, tile_m, tile_n, tile_k, has_bias):
        raise ValueError(
            f"tiles ({tile_m},{tile_n},{tile_k}) bust budgets of {cfg.describe()}")

    mp2 = _round_up(_round_up(m, dim), tile_m)
    np2 = _round_up(_round_up(n, dim), tile_n)
    kp2 = _round_up(_round_up(k, dim), tile_k)
    grid = (mp2 // tile_m, np2 // tile_n, kp2 // tile_k)

    # ---- analytic HBM traffic for this schedule -------------------------
    gm, gn, gk = grid
    tm, tn, tk = tile_m, tile_n, tile_k
    in_b = bytes_of(cfg.input_dtype)
    acc_b = bytes_of(cfg.acc_dtype)
    # NOTE: this traffic/residency model describes the PAPER's ASIC
    # dataflows (WS preloads B once per (n, k) tile and keeps it resident
    # across M) -- it is what the DSE/ISA reproduction of the paper's
    # findings runs on. The TPU lowering of both dataflows is K-innermost
    # and re-fetches B per K step (kernels/gemm.py); the tuner therefore
    # ranks candidates with its own kernel-faithful cost
    # (tune.tuner.analytic_cycles), not with these WS reuse numbers.
    if df is Dataflow.OS:
        # For each (m, n) output tile we stream the full K of A and B.
        a_reads = gm * gn * gk * tm * tk        # A re-read per n-step
        b_reads = gm * gn * gk * tk * tn        # B re-read per m-step
    else:
        # WS: B tile preloaded once per (n, k), A streamed per m; same block
        # traffic totals, different residency (captured in resident_bytes).
        a_reads = gm * gn * gk * tm * tk
        b_reads = gn * gk * tk * tn             # B loaded once, reused over M
    d_reads = (gm * gn * tm * tn) if has_bias else 0
    c_writes = mp2 * np2

    macs = mp2 * np2 * kp2
    useful = m * n * k
    return TilePlan(
        m=mp2, n=np2, k=kp2,
        tile_m=tm, tile_n=tn, tile_k=tk,
        grid=grid, dataflow=df,
        hbm_read_bytes=(a_reads + b_reads) * in_b + d_reads * acc_b,
        hbm_write_bytes=c_writes * bytes_of(cfg.output_dtype),
        vmem_streamed_bytes=_streamed_bytes(cfg, tm, tn, tk, has_bias),
        vmem_resident_bytes=_resident_bytes(cfg, df, tm, tn, tk),
        macs=macs,
        utilization=useful / macs,
    )


def _snap(t: int, total: int, dim: int) -> int:
    """Largest dim-aligned tile <= t that minimizes padding of ``total``.

    ``total`` is already dim-rounded. Preferring exact divisors of the
    dim-block count keeps the plan's padded dims equal to ``padded_shape``'s
    (no extra full-tile row of zero padding past the dim rounding); when no
    divisor fits under ``t``, minimize the over-padding and tie-break toward
    the larger tile (fewer grid steps).
    """
    blocks = total // dim
    t_blocks = max(1, min(t, total) // dim)
    best_tb, best_pad = 1, None
    for tb in range(t_blocks, 0, -1):
        steps = -(-blocks // tb)
        pad = steps * tb - blocks
        if best_pad is None or pad < best_pad:
            best_tb, best_pad = tb, pad
            if pad == 0:
                break
    return best_tb * dim


def plan_gemm(
    cfg: GemminiConfig,
    m: int,
    n: int,
    k: int,
    *,
    dataflow: Optional[Dataflow] = None,
    has_bias: bool = False,
) -> TilePlan:
    """Solve for tile factors for a (m, n, k) GEMM under ``cfg``.

    Mirrors the paper's tiling: pad to the array dim, then grow tiles along the
    dataflow's reuse direction until the scratchpad/accumulator budgets bind.
    This greedy analytic schedule is the default plan; the empirical tuner
    (``repro.tune``) treats it as one candidate among ``enumerate_plans``.
    """
    df = _resolve_dataflow(cfg, dataflow)
    dim = cfg.dim
    mp, np_, kp = _round_up(m, dim), _round_up(n, dim), _round_up(k, dim)

    # Hard caps from the config (DSE knobs), else the padded problem itself.
    cap_m = min(cfg.max_tile_m or mp, mp)
    cap_n = min(cfg.max_tile_n or np_, np_)
    cap_k = min(cfg.max_tile_k or kp, kp)

    if not _fits(cfg, df, dim, dim, dim, has_bias):
        raise ValueError(
            f"minimal {dim}x{dim} tile does not fit budgets of {cfg.describe()}"
        )

    # Reuse-direction growth order:
    #  OS: grow K first (amortize accumulator residency over a long K stream),
    #      then N (B reuse across M), then M.
    #  WS: grow M first (amortize the preloaded weight tile over many A rows),
    #      then K, then N.
    order = ("k", "n", "m") if df is Dataflow.OS else ("m", "k", "n")
    caps = {"m": cap_m, "n": cap_n, "k": cap_k}
    cur = {"m": dim, "n": dim, "k": dim}

    grew = True
    while grew:
        grew = False
        for ax in order:
            nxt = dict(cur)
            nxt[ax] = min(caps[ax], cur[ax] * 2)
            if nxt[ax] != cur[ax] and _fits(cfg, df, nxt["m"], nxt["n"],
                                            nxt["k"], has_bias):
                cur = nxt
                grew = True

    # Snap tiles down so they divide the padded problem as evenly as possible
    # (avoid a ragged final step costing a full tile of zero padding).
    tm = _snap(cur["m"], mp, dim)
    tn = _snap(cur["n"], np_, dim)
    tk = _snap(cur["k"], kp, dim)
    return make_plan(cfg, m, n, k, tm, tn, tk, dataflow=df, has_bias=has_bias)


def enumerate_plans(
    cfg: GemminiConfig,
    m: int,
    n: int,
    k: int,
    *,
    dataflow: Optional[Dataflow] = None,
    has_bias: bool = False,
    max_candidates: int = 32,
) -> List[TilePlan]:
    """Candidate tile plans for the empirical tuner.

    A pruned lattice: per axis, every power-of-two multiple of ``dim`` up to
    the axis cap, each snapped against the padded problem, plus the greedy
    solver's tiles. The Cartesian product is filtered by the VMEM budgets,
    deduplicated, and ordered by the analytic proxy (padded MACs, then HBM
    traffic, then fewer grid steps) so truncation keeps the a-priori best
    schedules. The greedy plan is always included.
    """
    df = _resolve_dataflow(cfg, dataflow)
    dim = cfg.dim
    mp, np_, kp = _round_up(m, dim), _round_up(n, dim), _round_up(k, dim)
    greedy = plan_gemm(cfg, m, n, k, dataflow=df, has_bias=has_bias)

    def axis_candidates(total: int, cap: Optional[int], greedy_tile: int):
        cap = min(cap or total, total)
        out = {greedy_tile}
        t = dim
        while t <= cap:
            out.add(_snap(t, total, dim))
            out.add(t)
            t *= 2
        return sorted(v for v in out if v % dim == 0 and 0 < v <= total)

    ms = axis_candidates(mp, cfg.max_tile_m, greedy.tile_m)
    ns = axis_candidates(np_, cfg.max_tile_n, greedy.tile_n)
    ks = axis_candidates(kp, cfg.max_tile_k, greedy.tile_k)

    plans = {(greedy.tile_m, greedy.tile_n, greedy.tile_k): greedy}
    for tm, tn, tk in itertools.product(ms, ns, ks):
        if (tm, tn, tk) in plans or not _fits(cfg, df, tm, tn, tk, has_bias):
            continue
        plans[(tm, tn, tk)] = make_plan(cfg, m, n, k, tm, tn, tk,
                                        dataflow=df, has_bias=has_bias)

    def proxy(p: TilePlan):
        gm, gn, gk = p.grid
        return (p.macs, p.hbm_read_bytes + p.hbm_write_bytes, gm * gn * gk)

    ordered = sorted(plans.values(), key=proxy)
    ordered = ordered[:max_candidates]
    if greedy not in ordered:
        ordered[-1] = greedy
    return ordered


def padded_shape(cfg: GemminiConfig, m: int, n: int, k: int) -> Tuple[int, int, int]:
    """Problem padded to the elaborated array dimension (paper section 3.3)."""
    return _round_up(m, cfg.dim), _round_up(n, cfg.dim), _round_up(k, cfg.dim)
