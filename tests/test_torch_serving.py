"""The port's serving engine against the JAX engine, and the port's hygiene.

Engine level: the port's ``ServingEngine(device="cpu")`` (plain versions of
every kernel) against the JAX ``ServingEngine(backend="xla_twin")`` (the
JAX engine datapath without Pallas), both fp32 end to end (model dtype and
engine config), with the same converted weights and prompts. The control
plane is a verbatim copy, so every scheduling decision is the same; greedy
token streams must then be equal under chunked prefill, forced preemption,
defrag and host offload. Random-weight greedy tokens repeat a lot, so the
logits checks of ``test_torch_model`` carry the numerical weight.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.config import GemminiConfig as JGemminiConfig
from repro.models import transformer as jtf
from repro.serving import ServingEngine as JServingEngine

from repro_torch import configs as tconfigs
from repro_torch.convert import (paged_state_from_numpy, params_from_numpy,
                                 tensor_from_numpy)
from repro_torch.core.config import GemminiConfig
from repro_torch.kernels import _build
from repro_torch.launch import serve as tserve
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as tengine

REPO = Path(__file__).resolve().parents[1]
F32 = dict(input_dtype="fp32", acc_dtype="fp32", output_dtype="fp32")
ARCHS = {"gemma3-1b": dict(n_layers=6, global_period=3), "qwen1.5-4b": {},
         "granite-moe-3b-a800m": {}, "llama4-scout-17b-a16e": {}}
MOE_ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e")
_NORMS = ("ln1", "ln2", "post_ln1", "post_ln2", "qnorm", "knorm",
          "final_norm", "bq", "bk", "bv")


def _model(arch):
    """(JAX config, port config, numpy parameter tree) at smoke size in
    fp32; norm scales and biases perturbed off zero so they carry weight."""
    kw = ARCHS[arch]
    jc = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32, **kw)
    tc = dataclasses.replace(tconfigs.get_smoke(arch), dtype=torch.float32,
                             **kw)
    rng = np.random.default_rng(11)
    tree = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(3), jc))

    def perturb(path, a):
        if path[-1].key in _NORMS:
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jc, tc, jax.tree_util.tree_map_with_path(perturb, tree)


def _drive(eng, prompts, gen, defrag_after=None):
    for p in prompts:
        eng.submit(p, gen)
    if defrag_after is not None:
        for _ in range(defrag_after):
            eng.step()
        eng.defrag()
    rep = eng.run()
    return [np.asarray(r["tokens"]).ravel().tolist()
            for r in rep["requests"]], rep["summary"]


def _pair(arch, prompts, gen, defrag_after=None, **kw):
    jc, tc, tree = _model(arch)
    jeng = JServingEngine(jc, backend="xla_twin",
                          engine_cfg=JGemminiConfig(**F32),
                          params=jax.tree.map(jnp.asarray, tree),
                          temperature=0.0, seed=0, **kw)
    teng = ServingEngine(tc, engine_cfg=GemminiConfig(**F32),
                         params=params_from_numpy(tree), device="cpu", **kw)
    return (_drive(jeng, prompts, gen, defrag_after),
            _drive(teng, prompts, gen, defrag_after))


def _prompts(seed, lengths, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_chunked_engine_tokens_match_jax(arch):
    """Three requests over two slots: whole-prompt prefill, first chunks,
    continuation chunks past gemma's 8-token window, decode, slot reuse."""
    (jt, js), (tt, ts) = _pair(arch, _prompts(0, (19, 9, 30)), 6,
                               max_slots=2, max_context=48, page_size=8,
                               prefill_chunk=8)
    assert js["prefill_chunks"] > 3
    assert tt == jt
    assert ts["prefill_chunks"] == js["prefill_chunks"]


@pytest.mark.parametrize("kv_offload", [False, True])
def test_preemption_defrag_offload_tokens_match_jax(kv_offload):
    """Two slots over four pages force an eviction; the pools are
    defragmented mid-run; with ``kv_offload`` the victim's pages are
    spilled to the host and restored instead of recomputed."""
    (jt, js), (tt, ts) = _pair("gemma3-1b", _prompts(1, (19, 19)), 8,
                               defrag_after=3, max_slots=2, max_context=32,
                               page_size=8, n_pages=4, prefill_chunk=8,
                               kv_offload=kv_offload)
    assert js["preemptions"] >= 1
    if kv_offload:
        assert ts["offload_restores"] >= 1 and ts["restarts_recomputed"] == 0
    assert tt == jt
    for key in ("preemptions", "prefill_tokens", "offload_restores"):
        assert ts[key] == js[key], key


def test_prefix_cache_tokens_match_jax():
    """Four prompts sharing a 24-token system prefix: the copy-on-write
    prefix cache maps the shared pages instead of recomputing them."""
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 128, (24,)).astype(np.int32)
    prompts = [np.concatenate([shared, t]) for t in _prompts(3, (7,) * 4)]
    (jt, js), (tt, ts) = _pair("qwen1.5-4b", prompts, 5, max_slots=2,
                               max_context=64, page_size=8, n_pages=16,
                               prefill_chunk=8, prefix_cache=True)
    assert ts["prefix_hit_tokens"] > 0
    assert tt == jt
    assert ts["prefix_hit_tokens"] == js["prefix_hit_tokens"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_preemption_tokens_match_jax(arch):
    """The MoE archs under forced preemption: two slots over four pages
    evict a request mid-decode, and its recomputed prefill routes its
    tokens again; streams and counters equal the JAX engine's."""
    (jt, js), (tt, ts) = _pair(arch, _prompts(1, (19, 19)), 8,
                               max_slots=2, max_context=32, page_size=8,
                               n_pages=4, prefill_chunk=8)
    assert js["preemptions"] >= 1
    assert tt == jt
    for key in ("preemptions", "prefill_tokens"):
        assert ts[key] == js[key], key


def test_moe_prefix_cache_tokens_match_jax():
    """granite with the copy-on-write prefix cache: shared prefix pages
    are mapped, not recomputed, and the suffix tokens route as in JAX."""
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 128, (24,)).astype(np.int32)
    prompts = [np.concatenate([shared, t]) for t in _prompts(3, (7,) * 4)]
    (jt, js), (tt, ts) = _pair("granite-moe-3b-a800m", prompts, 5,
                               max_slots=2, max_context=64, page_size=8,
                               n_pages=16, prefill_chunk=8, prefix_cache=True)
    assert ts["prefix_hit_tokens"] > 0
    assert tt == jt
    assert ts["prefix_hit_tokens"] == js["prefix_hit_tokens"]


# ---------------------------------------------------------------------------
# parameters and payloads
# ---------------------------------------------------------------------------
def test_bf16_params_convert_losslessly():
    """bf16 leaves moved by bit pattern and bf16 -> f32 -> bf16 copies give
    the same bits; norm scales stay fp32."""
    jc = jconfigs.get_smoke("gemma3-1b")
    tree = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), jc))
    direct = params_from_numpy(tree)
    via_f32 = params_from_numpy(
        jax.tree.map(lambda a: a.astype(np.float32), tree),
        dtype=torch.bfloat16)
    assert direct["embed"].dtype == torch.bfloat16
    assert direct["final_norm"].dtype == torch.float32
    for a, b in ((direct["embed"], via_f32["embed"]),
                 (direct["blocks"]["attn"]["wq"],
                  via_f32["blocks"]["attn"]["wq"])):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    np.testing.assert_array_equal(
        direct["blocks"]["attn"]["wq"].float().numpy(),
        np.asarray(tree["blocks"]["attn"]["wq"], np.float32))


def test_paged_state_converts_exactly():
    """A JAX paged state (pools with the trash page, tables, lengths)
    arrives in the port's layout with the same values."""
    jc = jconfigs.get_smoke("gemma3-1b")
    js = jtf.init_paged_state(jc, 3, 10, 8, 4)
    rng = np.random.default_rng(4)
    js = js._replace(
        kv_k=jnp.asarray(rng.standard_normal(js.kv_k.shape), jnp.bfloat16),
        tables=jnp.asarray(rng.integers(0, 10, (3, 4)), jnp.int32),
        lengths=jnp.asarray([5, 0, 31], jnp.int32))
    ts = paged_state_from_numpy(jax.tree.map(np.asarray, js._asdict()))
    ref = tconfigs.get_smoke("gemma3-1b")
    assert tuple(ts.kv_k.shape) == (ref.n_layers, ref.n_kv_heads, 11, 8,
                                    ref.head_dim)
    assert ts.kv_k.dtype == torch.bfloat16 and ts.tables.dtype == torch.int32
    np.testing.assert_array_equal(ts.kv_k.float().numpy(),
                                  np.asarray(js.kv_k, np.float32))
    np.testing.assert_array_equal(ts.tables.numpy(), np.asarray(js.tables))
    np.testing.assert_array_equal(ts.lengths.numpy(), [5, 0, 31])
    assert ts.conv is None and ts.ssm is None


def test_spill_payload_round_trip_is_exact():
    """Host offload payloads are numpy; bf16 travels as its bit pattern."""
    x = torch.randn((2, 1, 3, 8, 16)).to(torch.bfloat16)
    back = tengine._to_device(tengine._to_host(x), x)
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------
def _port_sources():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), \
                f"{path.name} imports {name}"


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tconfigs.get_smoke("gemma3-1b"))


@pytest.mark.parametrize("kw", [dict(faults="nan@decode:max=1"),
                                dict(nan_guard=True)])
def test_engine_accepts_faults_and_nan_guard(kw):
    """Either argument turns the NaN guard on (faults imply it, as in the
    JAX engine); only ``faults=`` makes an injector."""
    eng = ServingEngine(tconfigs.get_smoke("gemma3-1b"), device="cpu",
                        max_context=32, **kw)
    assert eng.nan_guard
    assert (eng.faults is not None) == ("faults" in kw)
    assert eng.max_step_retries == 2 and eng.retry_backoff_s == 0.0


@pytest.mark.parametrize("arch", ["gemma3-1b", "hymba-1.5b", "mamba2-1.3b"])
def test_dispatch_fallback_equals_dispatch_on_cpu(arch):
    """``_dispatch_fallback`` re-runs a step on the engine's own path from
    the state the step received, so on the arguments of every guarded
    step (fresh prefill, continuation chunks, decode) it gives the logits
    ``_dispatch`` gave, bit for bit, and leaves the same state: the
    recurrent rows the primary step consumed are put back first."""
    eng = ServingEngine(tconfigs.get_smoke(arch), device="cpu",
                        max_context=64, page_size=8, prefill_chunk=8,
                        max_slots=2, nan_guard=True)
    primary = eng._dispatch
    seen = set()

    def both(which, args):
        logits, st = primary(which, args)
        after = [None if t is None else t.clone() for t in st]
        fb_logits, fb_st = eng._dispatch_fallback(which, args)
        if logits is not None:
            assert torch.equal(fb_logits, logits), which
        for a, b in zip(after, fb_st):
            assert (a is None and b is None) or torch.equal(a, b), which
        seen.add(which)
        return fb_logits, fb_st

    eng._dispatch = both
    rng = np.random.default_rng(5)
    for n in (21, 6):
        eng.submit(rng.integers(0, 128, (n,)).astype(np.int32), 4)
    rep = eng.run()
    assert all(r["status"] == "finished" for r in rep["requests"])
    assert {"prefill_nl", "chunk", "decode"} <= seen


def test_nvcc_command_targets_sm90a_into_ignored_build_dir():
    src = _build.sources()
    assert {p.name for p in src} == {"gemm.cu", "gemm16.cu", "gemm_bwd.cu",
                                     "gemm_bwd16.cu", "attention.cu",
                                     "attention_any.cu",
                                     "attention_decode_any.cu",
                                     "attention_wg.cu", "attention_wg16.cu",
                                     "conv.cu",
                                     "ssd.cu", "ssd_any.cu", "ssd16.cu",
                                     "ssd16_any.cu", "datapath.cu"}
    cmd = _build.nvcc_command(src[0], _build.build_dir() / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    rel = _build.build_dir().relative_to(REPO)
    ignored = {ln.strip().rstrip("/") for ln in
               (REPO / ".gitignore").read_text().splitlines()}
    assert rel.parts[0] in ignored


def test_serve_cli_runs_smoke_on_cpu(capsys):
    out = tserve.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen", "3",
                       "--temperature", "0"])
    assert out["tokens"].shape == (2, 3)
    assert "[serve] gemma3-1b on cpu: 2 reqs" in capsys.readouterr().out


def test_tensor_from_numpy_keeps_bits():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tensor_from_numpy(a, "cpu", torch.bfloat16)
    assert t.dtype == torch.bfloat16 and t.float().numpy().tolist() == \
        a.tolist()
