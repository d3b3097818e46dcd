"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU.

The JAX side runs ``ExecutionContext(backend="xla_twin")``: the router on
the engine GEMM's datapath (fp32 input, fp32 sums, written at the config's
output dtype), every op on plain XLA. The port runs its plain versions
(CPU tensors). Both take the same numpy parameters and inputs from a seed.

Tolerances, each with its reason:
- fp32 (model dtype and engine config): the output within 1e-6 of the
  output's largest magnitude. Both sides sum every product in fp32, in
  other orders (MKL against XLA's dot), so the last bits differ.
- bf16 (model dtype and the serving engine config, bf16 -> fp32 -> bf16):
  the gate indices are equal, and the routed experts' output equals JAX's
  bit for bit: the same roundings at the same points (logits, the
  softmax's and sigmoid's ops, the gated product, the expert outputs, each
  choice's weighted row, each add of the combine), and the fp32 sums in
  between agree to far below half a bf16 step at these widths. A shared
  expert (llama4) is the port's dense gated MLP (``layers.mlp_apply``),
  whose activation follows XLA's op order too since ROADMAP C6 was
  repaired, so the output with it is bit for bit as well.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import GemminiConfig as JGemminiConfig
from repro.core.context import ExecutionContext as JContext
from repro.models import layers as jlayers
from repro.models import moe as jmoe

from repro_torch.convert import params_from_numpy
from repro_torch.core.config import GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.models import moe as tmoe

D, D_FF, TOKENS = 32, 16, (2, 12)
DTYPES = {"fp32": (jnp.float32, torch.float32, "fp32"),
          "bf16": (jnp.bfloat16, torch.bfloat16, "bf16")}


@dataclasses.dataclass(frozen=True)
class Case:
    n_experts: int
    ep: int                       # slots padded to a multiple of ep
    top_k: int
    router_weights_before: bool = False
    n_shared: int = 0


CASES = {
    # llama4 style: sigmoid weight on the expert input, a shared expert;
    # 6 experts in 8 slots
    "top1-before-shared": Case(6, 4, 1, router_weights_before=True,
                               n_shared=1),
    "top2-padded": Case(6, 4, 2),
    # granite style: top-8 softmax weights on the output, 10 in 12 slots
    "top8-padded": Case(10, 4, 8),
    "top2-unpadded": Case(4, 1, 2),
}


def _ctxs(dtype):
    _, _, name = DTYPES[dtype]
    out = "fp32" if name == "fp32" else "bf16"
    kw = dict(input_dtype=out, acc_dtype="fp32", output_dtype=out)
    return (JContext(cfg=JGemminiConfig(**kw), backend="xla_twin"),
            ExecutionContext(cfg=GemminiConfig(**kw)))


def _setup(case, dtype, seed):
    """(numpy params, numpy x) from the JAX init at ``dtype``; x (B, T, D)
    in the model dtype."""
    jdt, _, _ = DTYPES[dtype]
    p = jmoe.moe_init(jax.random.PRNGKey(seed), D, D_FF, case.n_experts,
                      ep=case.ep, n_shared=case.n_shared, dtype=jdt)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal(TOKENS + (D,)), jdt)
    return jax.tree.map(np.asarray, p), np.asarray(x)


def _jax_route(jctx, p, x, case):
    """The JAX module's routing, step for step (``moe.py`` routing
    block): the indices its ``moe_apply`` dispatches by."""
    xf = jnp.asarray(x).reshape(-1, D)
    logits = jlayers.project(jctx, xf.astype(jnp.float32),
                             jnp.asarray(p["router"]))
    e_pad = p["wi"].shape[0]
    if e_pad != case.n_experts:
        logits = jnp.where(jnp.arange(e_pad)[None] >= case.n_experts,
                           -jnp.inf, logits)
    return np.asarray(jax.lax.top_k(logits, case.top_k)[1])


def _run_both(case, dtype, dropless, seed=0, capacity_factor=1.0):
    npp, x = _setup(case, dtype, seed)
    jctx, tctx = _ctxs(dtype)
    kw = dict(n_experts=case.n_experts, top_k=case.top_k,
              capacity_factor=capacity_factor,
              router_weights_before=case.router_weights_before,
              dropless=dropless)
    want = jmoe.moe_apply(jctx, jax.tree.map(jnp.asarray, npp),
                          jnp.asarray(x), **kw)
    tp = params_from_numpy(npp)
    tx = torch.from_numpy(np.array(x, np.float32)).to(DTYPES[dtype][1])
    got = tmoe.moe_apply(tctx, tp, tx, **kw)
    _, idx = tmoe.route(tctx, tp, tx.reshape(-1, D),
                        n_experts=case.n_experts, top_k=case.top_k)
    return (np.asarray(want, np.float32), got, idx.numpy(),
            _jax_route(jctx, npp, x, case), (tctx, tp, tx, kw))


@pytest.mark.parametrize("dropless", [True, False],
                         ids=["dropless", "capacity"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_apply_matches_jax(dtype, case, dropless):
    c = CASES[case]
    want, got, idx, jidx, _ = _run_both(c, dtype, dropless)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == TOKENS + (D,)
    np.testing.assert_array_equal(idx, jidx)
    got = got.float().numpy()
    scale = np.abs(want).max()
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    else:
        np.testing.assert_array_equal(got, want)


def test_capacity_bound_call_drops_tokens():
    """The capacity-bound calls above do drop: with capacity_factor 1.0
    some expert draws more choices than its capacity, so their match with
    JAX covers the dropped rows too."""
    c = CASES["top2-padded"]
    _, _, idx, _, _ = _run_both(c, "fp32", False)
    n = idx.shape[0]
    capacity = max(1, int(1.0 * n * c.top_k / c.n_experts))
    assert np.bincount(idx.ravel()).max() > capacity


@pytest.mark.parametrize("case", sorted(CASES))
def test_padded_slots_never_chosen(case):
    c = CASES[case]
    for seed in range(4):
        _, _, idx, _, _ = _run_both(c, "bf16", True, seed=seed)
        assert idx.max() < c.n_experts
        # each token's k choices are distinct experts
        assert all(len(set(row)) == c.top_k for row in idx.tolist())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_apply_is_deterministic(dtype):
    *_, (tctx, tp, tx, kw) = _run_both(CASES["top8-padded"], dtype, True)
    a = tmoe.moe_apply(tctx, tp, tx, **kw)
    b = tmoe.moe_apply(tctx, tp, tx, **kw)
    assert torch.equal(a.view(-1).view(torch.uint8),
                       b.view(-1).view(torch.uint8))


@pytest.mark.parametrize("k", [2, 3])
def test_tied_logits_take_jax_top_k_order(k):
    """bf16 router logits that tie at the k-th place: the port picks what
    ``jax.lax.top_k`` picks (ties to the lower index). On the logits
    [1, 3, 3, 2, 3, 0.5] with k = 2 ``jax.lax.top_k`` gives [1, 2];
    ``torch.topk`` gave [2, 4] on this package's CPU build, so routing by
    it would send tokens to other experts."""
    row = np.array([1.0, 3.0, 3.0, 2.0, 3.0, 0.5], np.float32)
    e = len(row)
    # token t's logits are row rolled by t: ties land on every position
    router = np.zeros((D, e), np.float32)
    x = np.zeros((1, e, D), np.float32)
    for t in range(e):
        router[t] = np.roll(row, t)
        x[0, t, t] = 1.0
    npp = {"router": router,
           "wi": np.zeros((e, D, D_FF), np.float32),
           "wg": np.zeros((e, D, D_FF), np.float32),
           "wo": np.zeros((e, D_FF, D), np.float32)}
    jctx, tctx = _ctxs("bf16")
    case = Case(e, 1, k)
    jidx = _jax_route(jctx, npp, x.astype(jnp.bfloat16), case)
    _, idx = tmoe.route(tctx, params_from_numpy(npp, dtype=torch.bfloat16),
                        torch.from_numpy(x[0]).to(torch.bfloat16),
                        n_experts=e, top_k=k)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(jidx[0], [1, 2, 4][:k])


def test_moe_init_tree_matches_jax():
    """Same names, shapes and dtypes as ``repro.models.moe.moe_init``: the
    router in fp32, the experts and the shared MLP in the model dtype;
    with ``n_layers`` every leaf gains a leading L axis."""
    ref = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                       jmoe.moe_init(jax.random.PRNGKey(0), D, D_FF, 6, ep=4,
                                     n_shared=1, dtype=jnp.bfloat16))
    gen = torch.Generator().manual_seed(0)

    def shapes(node, lead=()):
        if isinstance(node, dict):
            return {k: shapes(v, lead) for k, v in node.items()}
        return (tuple(node.shape)[len(lead):],
                str(node.dtype).replace("torch.", ""))
    got = tmoe.moe_init(gen, D, D_FF, 6, ep=4, n_shared=1,
                        dtype=torch.bfloat16)
    assert shapes(got) == ref
    stacked = tmoe.moe_init(gen, D, D_FF, 6, ep=4, n_shared=1, n_layers=3,
                            dtype=torch.bfloat16)
    assert stacked["wi"].shape[0] == 3 == stacked["shared"]["wo"].shape[0]
    assert shapes(stacked, (3,)) == ref


class _Mesh:
    """A shape-only mesh stand-in (``launch.mesh`` reads its axis sizes
    and names)."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("flag,mesh,b,t,want", [
    (0, _Mesh(data=2, model=2), 4, 16, (1, None)),      # flag off
    (1, None, 4, 16, (1, None)),                         # no mesh
    (1, _Mesh(stage=2, data=2), 4, 16, (1, None)),       # no model axis
    (1, _Mesh(data=2, model=4), 3, 16, (1, None)),       # B does not divide
    (1, _Mesh(data=2, model=4), 4, 6, (1, None)),        # T does not divide
    (1, _Mesh(data=2, model=4), 4, 16, (8, (2, 4))),
    (1, _Mesh(pod=2, data=2, model=2), 4, 16, (8, (4, 2))),
], ids=["flag-off", "no-mesh", "no-model-axis", "b-indivisible",
        "t-indivisible", "data-model", "pod-data-model"])
def test_dispatch_grid(flag, mesh, b, t, want):
    """``_dispatch_grid`` as the JAX function: (1, None) when the flag is
    off, no mesh is active, the mesh has no ``model`` axis or the shapes
    do not divide; else (gb x gt, (gb, gt)) with gb = pod x data."""
    import contextlib
    from repro_torch.core import flags
    from repro_torch.launch import mesh as mesh_lib
    scope = mesh_lib.activate_mesh(mesh) if mesh is not None \
        else contextlib.nullcontext()
    flags.set_flag("moe_grouped_dispatch", flag)
    try:
        with scope:
            assert tmoe._dispatch_grid(b, t) == want
    finally:
        flags.reset()


def test_grouped_dispatch_is_the_layer_per_group():
    """Plain tensors under a (2, 4) grid: the grouped layer equals the
    ungrouped layer applied to each group's tokens apart (B split over
    data, T over model; each group's own capacity, here small enough to
    drop tokens), fp32 within 1e-6 of the largest magnitude, and the
    drops make it differ from one global group."""
    from repro_torch.core import flags
    from repro_torch.launch import mesh as mesh_lib
    gen = torch.Generator().manual_seed(3)
    p = tmoe.moe_init(gen, D, D_FF, 4, dtype=torch.float32)
    x = torch.randn((4, 16, D), generator=gen)
    kw = dict(n_experts=4, top_k=2, capacity_factor=0.5)
    ctx = ExecutionContext(cfg=GemminiConfig(input_dtype="fp32",
                                             acc_dtype="fp32",
                                             output_dtype="fp32"))
    flags.set_flag("moe_grouped_dispatch", 1)
    try:
        with mesh_lib.activate_mesh(_Mesh(data=2, model=4)):
            got = tmoe.moe_apply(ctx, p, x, **kw)
    finally:
        flags.reset()
    want = torch.cat([torch.cat([tmoe.moe_apply(
        ctx, p, x[i * 2:(i + 1) * 2, j * 4:(j + 1) * 4], **kw)
        for j in range(4)], dim=1) for i in range(2)], dim=0)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    assert float((got - tmoe.moe_apply(ctx, p, x, **kw)).abs().max()) > \
        1e-3 * scale
