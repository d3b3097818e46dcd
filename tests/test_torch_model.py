"""The port's dense model against the JAX package, on the CPU.

The JAX side runs ``ExecutionContext(cfg=f32, backend="xla_twin")``: the
JAX engine's datapath (every projection through the engine GEMM, bias on
its D input) with every kernel on its plain XLA twin. The port runs its
plain versions (CPU tensors). Both configs are fp32 end to end -- the
model dtype as well as the engine config, since an fp32 engine on a bf16
model fails in JAX with a scan-carry dtype error.

Tolerance: logits agree to 2e-5 absolute / 1e-4 relative. Both sides
compute in fp32, but their matmuls sum in different orders (MKL vs XLA's
dot) and the difference of ~1e-7 per op compounds over six layers and a
softmax; weights are O(1/sqrt(d)) so logits are O(1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.config import GemminiConfig as JGemminiConfig
from repro.core.context import ExecutionContext as JContext
from repro.models import transformer as jtf

from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.models import transformer as ttf

PAGE = 8
ATOL, RTOL = 2e-5, 1e-4

# gemma3 smoke with six layers and a global layer every third: the stock
# smoke config has two layers, both local, so no global layer would run.
ARCHS = {
    "gemma3-1b": dict(n_layers=6, global_period=3),
    "qwen1.5-4b": dict(),
}


def _configs(arch):
    kw = ARCHS[arch]
    jc = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32, **kw)
    tc = dataclasses.replace(tconfigs.get_smoke(arch), dtype=torch.float32, **kw)
    return jc, tc


def _params(jc, seed):
    """JAX init, then norm scales and biases made non-trivial (they start
    at zero) so the zero-centred norms and the D-input bias path carry
    weight. Returns the numpy tree both sides load."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(seed), jc))

    def perturb(path, a):
        name = path[-1].key
        if name in ("ln1", "ln2", "post_ln1", "post_ln2", "qnorm", "knorm",
                    "final_norm", "bq", "bk", "bv"):
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    arch = request.param
    jc, tc = _configs(arch)
    npt = _params(jc, seed=len(arch))
    f32 = dict(input_dtype="fp32", acc_dtype="fp32", output_dtype="fp32")
    jctx = JContext(cfg=JGemminiConfig(**f32), backend="xla_twin")
    tctx = ExecutionContext(cfg=GemminiConfig(**f32))
    jp = jax.tree.map(jnp.asarray, npt)
    tp = params_from_numpy(npt)
    return arch, jc, tc, jctx, tctx, jp, tp


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL, rtol=RTOL)


def _state_pair(jc, tc, slots=3, n_pages=12, mp=6):
    js = jtf.init_paged_state(jc, slots, n_pages, PAGE, mp, dtype=jnp.float32)
    ts = ttf.init_paged_state(tc, slots, n_pages, PAGE, mp,
                              dtype=torch.float32)
    return js, ts


def test_paged_prefill_chunk_and_decode_logits(model):
    """Fresh prefill (slot 0), a first chunk plus a continuation chunk past
    the sliding window (slot 1), then decode steps with an inactive slot:
    logits and KV pools agree with the JAX engine datapath at each call."""
    arch, jc, tc, jctx, tctx, jp, tp = model
    rng = np.random.default_rng(7)
    js, ts = _state_pair(jc, tc)

    # slot 0: whole prompt of 13 tokens, bucket-padded to 16, pages 0-1
    p0 = np.zeros((16,), np.int32)
    p0[:13] = rng.integers(0, jc.vocab, 13)
    pages0 = np.array([0, 1, 0, 0, 0, 0], np.int32)
    jl, js = jtf.paged_prefill(jctx, jp, jc, jnp.asarray(p0[None]), js,
                               jnp.int32(0), jnp.asarray(pages0),
                               page_size=PAGE)
    tl, ts = ttf.paged_prefill(tctx, tp, tc, torch.from_numpy(p0[None]), ts,
                               0, torch.from_numpy(pages0), page_size=PAGE)
    _close(jl, tl)

    # slot 1: first chunk [0, 16), continuation chunk [16, 24) with the
    # table cut to kv_pages = 3
    p1 = rng.integers(0, jc.vocab, 24).astype(np.int32)
    pages1 = np.array([2, 3, 4, 0, 0, 0], np.int32)
    _, js = jtf.paged_prefill(jctx, jp, jc, jnp.asarray(p1[None, :16]), js,
                              jnp.int32(1), jnp.asarray(pages1),
                              page_size=PAGE, with_logits=False)
    _, ts = ttf.paged_prefill(tctx, tp, tc, torch.from_numpy(p1[None, :16]),
                              ts, 1, torch.from_numpy(pages1), page_size=PAGE,
                              with_logits=False)
    jl, js = jtf.paged_prefill_chunk(jctx, jp, jc, jnp.asarray(p1[None, 16:]),
                                     js, jnp.int32(1), jnp.asarray(pages1),
                                     jnp.int32(16), page_size=PAGE,
                                     kv_pages=3)
    tl, ts = ttf.paged_prefill_chunk(tctx, tp, tc,
                                     torch.from_numpy(p1[None, 16:]), ts, 1,
                                     torch.from_numpy(pages1), 16,
                                     page_size=PAGE, kv_pages=3)
    _close(jl, tl)
    _close(js.kv_k, ts.kv_k)
    _close(js.kv_v, ts.kv_v)

    # decode: slots 0 and 1 live, slot 2 empty (inactive, len 0)
    tables = np.zeros((3, 6), np.int32)
    tables[0] = [0, 1, 5, 0, 0, 0]
    tables[1] = [2, 3, 4, 6, 0, 0]
    lengths = np.array([13, 24, 0], np.int32)
    js = js._replace(tables=jnp.asarray(tables), lengths=jnp.asarray(lengths))
    ts = ts._replace(tables=torch.from_numpy(tables),
                     lengths=torch.from_numpy(lengths))
    active = np.array([True, True, False])
    toks = rng.integers(0, jc.vocab, (3, 1)).astype(np.int32)
    for _ in range(3):
        jl, js = jtf.paged_decode_step(jctx, jp, jc, jnp.asarray(toks), js,
                                       jnp.asarray(active), page_size=PAGE)
        tl, ts = ttf.paged_decode_step(tctx, tp, tc, torch.from_numpy(toks),
                                       ts, torch.from_numpy(active),
                                       page_size=PAGE)
        # inactive slots' rows are padding the engine never reads (the
        # JAX twin attends an empty slot to a uniform mix, the kernels to
        # a zero row)
        _close(jl[:2], tl[:2])
        np.testing.assert_array_equal(np.asarray(js.lengths),
                                      ts.lengths.numpy())
        toks = np.array(jnp.argmax(jl, axis=-1), np.int32)
    # live pages agree; page 7+ and the trash page hold only padding writes
    _close(js.kv_k[:, :, :7], ts.kv_k[:, :, :7])
    _close(js.kv_v[:, :, :7], ts.kv_v[:, :, :7])


def test_init_params_tree_matches_jax(model):
    """Same names, same stacked (L, ...) shapes, same dtypes."""
    arch, jc, tc, *_ = model
    ref = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                       jtf.init_params(jax.random.PRNGKey(0), jc))
    got = ttf.init_params(torch.Generator().manual_seed(0), tc)

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return (tuple(node.shape), str(node.dtype).replace("torch.", ""))
    assert shapes(got) == ref


def test_layer_windows_and_rope_bases_match_jax(model):
    arch, jc, tc, *_ = model
    np.testing.assert_array_equal(jtf.layer_windows(jc, 0),
                                  ttf.layer_windows(tc))
    np.testing.assert_array_equal(jtf.layer_rope_bases(jc),
                                  ttf.layer_rope_bases(tc))


def test_non_dense_family_raises():
    cfg = ttf.ModelConfig(name="m", family="ssm", n_layers=1, d_model=8,
                          vocab=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttf.init_params(torch.Generator().manual_seed(0), cfg)
