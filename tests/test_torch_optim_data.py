"""The port's optimizer, schedules, data pipeline and gradient compression
against the JAX package, on the CPU.

Tolerances, each with its reason:
- AdamW and the global norm: fp32 within 1e-6 relative (the leaves'
  squared sums add in other orders); parameters of a bf16 leaf equal
  bit for bit or one bf16 step apart where the fp32 update lands within
  1e-6 of a rounding boundary.
- the schedules: fp32 within 1e-6 relative (``cos`` in another library).
- the data pipeline: bit for bit (the same numpy code).
- compression: top-k indices and values, the int8 codes and the scale bit
  for bit; the error-feedback residuals within 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JSyntheticLM
from repro.data import SyntheticLMConfig as JSyntheticLMConfig
from repro.data import make_global_batch
from repro.launch.mesh import make_mesh
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.runtime import compression as jcomp

from repro_torch.core import tree as tu
from repro_torch.data import SyntheticLM, SyntheticLMConfig, make_batch
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tschedule
from repro_torch.runtime import compression as tcomp


def _tree(rng):
    """A parameter-like tree: fp32 and bf16 matrices (weight decay), 1-d
    norms (none), nested dicts."""
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "blocks": {"wq": rng.standard_normal((3, 16, 8)).astype(
                np.float32), "ln": rng.standard_normal((3, 16)).astype(
                    np.float32)},
            "embed": rng.standard_normal((32, 8)).astype(np.float32)}


def _jax(tree, bf16=()):
    return {k: _jax(v, bf16) if isinstance(v, dict) else
            jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
            for k, v in tree.items()}


def _torch(tree, bf16=()):
    return {k: _torch(v, bf16) if isinstance(v, dict) else
            torch.from_numpy(v).to(torch.bfloat16 if k in bf16
                                   else torch.float32)
            for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_global_norm_matches_jax():
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    np.testing.assert_allclose(
        tadamw.global_norm(_torch(tree, ("embed",))).item(),
        float(jadamw.global_norm(_jax(tree, ("embed",)))), rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_jax(clip):
    """Three updates (weight decay on matrices only, the global-norm clip
    active at 1.0 and idle at 100, a bf16 leaf, an fp32 lr scale)."""
    rng = np.random.default_rng(1)
    bf16 = ("embed",)
    params = _tree(rng)
    cfg_j = jadamw.AdamWConfig(lr=1e-2, grad_clip=clip)
    cfg_t = tadamw.AdamWConfig(lr=1e-2, grad_clip=clip)
    jp, tp = _jax(params, bf16), _torch(params, bf16)
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    assert [x.dtype for x in tu.leaves(ts["m"])] == [torch.float32] * 4
    for i in range(3):
        grads = _tree(rng)
        scale = 0.5 + 0.25 * i
        jp, js, jm = jadamw.adamw_update(cfg_j, jp, _jax(grads, bf16), js,
                                         lr_scale=jnp.float32(scale))
        tp, ts, tm = tadamw.adamw_update(cfg_t, tp, _torch(grads, bf16), ts,
                                         lr_scale=torch.tensor(scale))
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=1e-7)
    assert int(ts["count"]) == int(js["count"]) == 3
    got = dict(tu.flatten_with_paths(tp))
    for path, want in tu.flatten_with_paths(jax.tree.map(_np, jp)):
        g = got[path]
        if g.dtype == torch.bfloat16:
            step = np.abs(want) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(g.float().numpy() - want) <= step), path
        else:
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-6,
                                       atol=1e-7, err_msg=path)
    for key in ("m", "v"):
        got = dict(tu.flatten_with_paths(ts[key]))
        for path, want in tu.flatten_with_paths(jax.tree.map(np.asarray,
                                                             js[key])):
            np.testing.assert_allclose(got[path].numpy(), want, rtol=1e-5,
                                       atol=1e-9, err_msg=f"{key}/{path}")


def test_adamw_leaves_its_inputs_alone():
    """The update is functional: params and state passed in keep their
    values (a step's state stays valid to checkpoint or compare)."""
    rng = np.random.default_rng(2)
    tp = _torch(_tree(rng))
    before = [x.clone() for x in tu.leaves(tp)]
    st = tadamw.adamw_init(tp)
    tadamw.adamw_update(tadamw.AdamWConfig(), tp, _torch(_tree(rng)), st)
    assert all(torch.equal(a, b) for a, b in zip(tu.leaves(tp), before))
    assert int(st["count"]) == 0
    assert all(not x.any() for x in tu.leaves(st["m"]))


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_jax(warmup):
    for step in range(-1, 14):
        np.testing.assert_allclose(
            tschedule.linear_warmup(step, warmup).item(),
            float(jschedule.linear_warmup(step, warmup)), rtol=1e-6)
        np.testing.assert_allclose(
            tschedule.cosine_schedule(step, 10, warmup).item(),
            float(jschedule.cosine_schedule(step, 10, warmup)), rtol=1e-6)
    # a tensor step counter, as the train step passes it
    np.testing.assert_allclose(
        tschedule.cosine_schedule(torch.tensor(4, dtype=torch.int32), 10,
                                  warmup).item(),
        float(jschedule.cosine_schedule(jnp.int32(4), 10, warmup)),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_codebooks", [1, 4])
def test_batches_equal_jax_bit_for_bit(n_codebooks):
    """``make_batch`` against the JAX ``make_global_batch`` on a one-device
    mesh: tokens, labels and the multimodal stub's ``extra_embeds``."""
    kw = dict(vocab=1000, seq=32, global_batch=6, seed=3,
              n_codebooks=n_codebooks)
    jgen, tgen = JSyntheticLM(JSyntheticLMConfig(**kw)), \
        SyntheticLM(SyntheticLMConfig(**kw))
    mesh = make_mesh((1,), ("data",))
    spec = ("data", None, None) if n_codebooks > 1 else ("data", None)
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(*spec))
    for step in (0, 7):
        want = make_global_batch(jgen, step, sh, extra_embed_dim=16,
                                 extra_tokens=5)
        got = make_batch(tgen, step, "cpu", extra_embed_dim=16,
                         extra_tokens=5)
        assert got["tokens"].dtype == torch.int32
        assert got["extra_embeds"].dtype == torch.float32
        for key in ("tokens", "labels", "extra_embeds"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    plain = make_batch(tgen, 1)
    assert set(plain) == {"tokens", "labels"}


def test_rows_are_the_jax_rows():
    kw = dict(vocab=50, seq=64, global_batch=2, seed=9, doc_len=8)
    jgen, tgen = JSyntheticLM(JSyntheticLMConfig(**kw)), \
        SyntheticLM(SyntheticLMConfig(**kw))
    for step, row in ((0, 0), (3, 1), (11, 5)):
        np.testing.assert_array_equal(tgen.row(step, row),
                                      jgen.row(step, row))


# ---------------------------------------------------------------------------
# gradient compression (tests/test_runtime.py's JAX cases)
# ---------------------------------------------------------------------------
def test_topk_matches_jax_including_ties():
    rng = np.random.default_rng(4)
    g = rng.standard_normal((64,)).astype(np.float32)
    g[[3, 17, 40]] = 5.0          # a three-way tie at the top ...
    g[[8, 30]] = -2.5             # ... and a tie straddling k
    g[50] = 2.5
    for k in (2, 4, 5, 64, 100):
        jv, ji = jcomp.topk_compress(jnp.asarray(g), k)
        tv, ti = tcomp.topk_compress(torch.from_numpy(g), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(
            tcomp.topk_decompress(tv, ti, g.shape, torch.float32).numpy(),
            np.asarray(jcomp.topk_decompress(jv, ji, g.shape, jnp.float32)))


def test_error_feedback_matches_jax():
    """Two DGC rounds on a two-leaf tree (one bf16): the kept sparse
    gradients and the carried residuals."""
    rng = np.random.default_rng(5)
    grads = {"a": rng.standard_normal((100,)).astype(np.float32),
             "b": rng.standard_normal((8, 8)).astype(np.float32)}
    jg, tg = _jax(grads, ("b",)), _torch(grads, ("b",))
    js, ts = jcomp.init_error_feedback(jg), tcomp.init_error_feedback(tg)
    for _ in range(2):
        jk, js = jcomp.compress_grads_with_feedback(jg, js, density=0.05)
        tk, ts = tcomp.compress_grads_with_feedback(tg, ts, density=0.05)
        for key in ("a", "b"):
            assert tk[key].dtype == tg[key].dtype
            np.testing.assert_array_equal(_np(tk[key]), _np(jk[key]))
            np.testing.assert_allclose(ts.residual[key].numpy(),
                                       np.asarray(js.residual[key]),
                                       rtol=0, atol=1e-7)


def test_int8_compression_matches_jax():
    rng = np.random.default_rng(6)
    g = (rng.standard_normal((1000,)) * 3).astype(np.float32)
    g[:4] = [0.5, -0.5, 1.5, 2.5]  # halves: round to even, as jnp.round
    g *= 127 / np.abs(g).max()     # scale 1: the halves stay halves
    jq, js = jcomp.int8_compress(jnp.asarray(g))
    tq, ts = tcomp.int8_compress(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and tq.numel() * 4 == g.nbytes
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    out = tcomp.int8_decompress(tq, ts)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jcomp.int8_decompress(jq, js)))
    assert float((out - torch.from_numpy(g)).abs().max()) <= ts.item() * 0.51
    tree = {"w": torch.from_numpy(g[:64].reshape(8, 8)).to(torch.bfloat16)}
    rt = tcomp.int8_roundtrip_tree(tree)
    assert rt["w"].dtype == torch.bfloat16
    q, s = tcomp.int8_compress_tree(tree)["w"]
    assert q.dtype == torch.int8
