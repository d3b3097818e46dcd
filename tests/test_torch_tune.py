"""The port's kernel-schedule tuner (``repro_torch.tune``) on the CPU, held
against the JAX package's (``repro.tune``): the model shape walkers and
the page lattice equal JAX's, and the counterparts of ``tests/test_tune.py``
and of ``tests/test_chaos.py``'s quarantine tests. On the CPU every
candidate shares the plain version's one timing, so the shape's own plan
wins; the card's measurements are ``tests/test_torch_cuda.py``'s and
``chip_smoke.py`` phase 16's."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.config import GemminiConfig as JGemminiConfig
from repro.models import transformer as jtf
from repro.tune import schedules as jsched

from repro_torch import configs, tune
from repro_torch.core import flags
from repro_torch.core.config import Dataflow, GemminiConfig
from repro_torch.kernels import attention as ka
from repro_torch.kernels import gemm as kg
from repro_torch.models import transformer as tf
from repro_torch.serving import ServingEngine
from repro_torch.tune import cache as tcache
from repro_torch.tune import measure, schedules, tuner

BF16 = dict(input_dtype="bf16", acc_dtype="fp32", output_dtype="bf16")
F32 = dict(input_dtype="fp32", acc_dtype="fp32", output_dtype="fp32")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture
def tmp_cache(tmp_path):
    """Point the plan cache at a tmp file; restore the flags afterwards."""
    path = str(tmp_path / "plans.json")
    prev_cache = flags.get("tune_cache")
    prev_mode = flags.get("tune_mode")
    flags.set_flag("tune_cache", path)
    tcache.reset_cache()
    yield path
    flags.set_flag("tune_cache", prev_cache)
    flags.set_flag("tune_mode", prev_mode)
    tcache.reset_cache()


def _counting(monkeypatch):
    calls = {"n": 0}
    real = measure.time_callable

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(measure, "time_callable", counting)
    return calls


# ---------------------------------------------------------------------------
# shapes and spaces against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.names())
@pytest.mark.parametrize("include_decode", [True, False])
def test_model_shapes_equal_jax(arch, include_decode):
    """model_gemm_shapes and model_attention_shapes give JAX's lists, in
    JAX's order, for every registry arch at smoke size."""
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    for batch, seq in ((2, 16), (1, 40)):
        assert tf.model_gemm_shapes(cfg, batch, seq,
                                    include_decode=include_decode) == \
            jtf.model_gemm_shapes(jcfg, batch, seq,
                                  include_decode=include_decode)
        assert tf.model_attention_shapes(cfg, batch, seq) == \
            jtf.model_attention_shapes(jcfg, batch, seq)


def test_gemm_calls_name_the_card_plan_fields():
    """The router multiplies fp32 activations and the tied unembedding
    reads the table transposed: the fields the card plan also keys."""
    calls = tf.model_gemm_calls(configs.get_smoke("granite-moe-3b-a800m"),
                                2, 16)
    assert any(c[4] for c in calls)                 # the router
    tied = [c for c in calls if c[5]]
    cfg = configs.get_smoke("granite-moe-3b-a800m")
    assert tied and all(c[1] == cfg.vocab for c in tied)
    assert not any(c[5] for c in tf.model_gemm_calls(
        configs.get_smoke("musicgen-medium"), 2, 16))


@pytest.mark.parametrize("ctx", [2048, 300, 100, 20, 5])
@pytest.mark.parametrize("heads", [(4, 1, 16), (8, 2, 64), (4, 1, 256)])
def test_page_lattice_equals_jax(ctx, heads):
    """The page sizes the port tunes are JAX's lattice and clamp."""
    h, kvh, d = heads
    jcfg = JGemminiConfig(**BF16)
    want = sorted({s.page_size for s in jsched.enumerate_paged_schedules(
        jcfg, 4, h, kvh, d, ctx)})
    assert schedules.paged_page_sizes(ctx) == want
    space = schedules.enumerate_paged_schedules(ctx)
    assert space[0] == schedules.default_paged_schedule().effective(ctx)
    assert sorted({s.page_size for s in space}) == want
    assert len(space) == len(set(space))
    assert all(schedules.paged_legal(s, ctx) for s in space)


@pytest.mark.parametrize("dtype,m", [
    (torch.bfloat16, 4), (torch.bfloat16, 64), (torch.bfloat16, 256),
    (torch.float16, 100), (torch.float32, 4), (torch.float32, 256),
    (torch.int8, 4), (torch.int8, 256), (torch.int16, 100)])
def test_gemm_space(dtype, m):
    """The shape's own plan first, then only legal (tile, splits): the
    regime's tiles (64 x 256 only at M <= 64) and splits within the
    kernel's limit and its k steps."""
    space = schedules.enumerate_gemm_schedules(dtype, m, 1000, 600)
    assert space[0] == {"tile": 0, "splits": 0}
    assert all(schedules.gemm_legal(dtype, m, 1000, 600, s) for s in space)
    tiles = {s["tile"] for s in space[1:]}
    assert tiles == set(schedules.gemm_tiles(dtype, m))
    if dtype == torch.bfloat16 and m > 16:
        assert (5 in tiles) == (m <= 64)
        assert max(s["splits"] for s in space) == schedules.WD_MAX_SPLITS
    for bad in ({"tile": 9, "splits": 1}, {"tile": 1, "splits": 0},
                {"tile": 0, "splits": 2}, {"tile": 1, "splits": 99}):
        assert not schedules.gemm_legal(dtype, m, 1000, 600, bad)


def test_conv_space_keeps_fp32_chains():
    """The CUDA-core conv takes power-of-two splits whose chains stay
    within CC_MAX_CHAIN k; the tensor-core conv its GEMM's space."""
    k = 3 * 3 * 512
    space = schedules.enumerate_conv_schedules(torch.float32, 49, 512, k)
    ks = -(-k // schedules.SGEMM_BK)
    for s in space[1:]:
        assert s["splits"] & (s["splits"] - 1) == 0
        assert -(-ks // s["splits"]) * schedules.SGEMM_BK <= \
            schedules.CC_MAX_CHAIN
    tc = schedules.enumerate_conv_schedules(torch.int8, 3136, 64, 576)
    assert {s["tile"] for s in tc[1:]} == {1, 2}


# ---------------------------------------------------------------------------
# resolution modes (tests/test_tune.py's counterparts)
# ---------------------------------------------------------------------------
def test_off_never_imports_the_tuner():
    """Under ``off`` a GEMM, a conv, flash attention and a served request
    never import the tuner (a fresh process)."""
    code = (
        "import sys, numpy as np, torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.core.config import GemminiConfig\n"
        "from repro_torch.core.context import ExecutionContext\n"
        "from repro_torch.serving import ServingEngine\n"
        "ctx = ExecutionContext(cfg=GemminiConfig(input_dtype='bf16', "
        "acc_dtype='fp32', output_dtype='bf16'))\n"
        "ctx.gemm(torch.ones(4, 8, dtype=torch.bfloat16), "
        "torch.ones(8, 4, dtype=torch.bfloat16))\n"
        "ctx.flash_attention(*[torch.ones(1, 8, 2, 16)] * 3)\n"
        "eng = ServingEngine(configs.get_smoke('gemma3-1b'), max_slots=2, "
        "max_context=64, device='cpu', warm_prompt_lens=[8])\n"
        "eng.submit(np.arange(8, dtype=np.int32), 2)\n"
        "eng.run()\n"
        "assert eng.warm_stats is None and eng._paged_sched_key is None\n"
        "assert not any(m.startswith('repro_torch.tune') "
        "for m in sys.modules), sorted(sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC, GEMMINI_TUNE="off")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_cached_never_measures(tmp_cache, monkeypatch):
    """``cached`` returns a stored schedule and, on a miss, the shape's
    own plan, without measuring."""
    cfg = GemminiConfig(**BF16)
    key = schedules.gemm_cache_key(
        (torch.bfloat16, torch.float32, torch.bfloat16), False, 256, 512,
        1024, False, False, "cpu")
    tcache.get_cache().store_schedule(key, {"tile": 3, "splits": 2})

    def boom(*a, **kw):
        raise AssertionError("cached mode must not measure")
    monkeypatch.setattr(measure, "time_callable", boom)
    flags.set_flag("tune_mode", "cached")
    assert tuner.resolve_plan(cfg, 256, 512, 1024, device="cpu") == \
        {"tile": 3, "splits": 2}
    assert tuner.resolve_plan(cfg, 256, 512, 2048, device="cpu") == \
        {"tile": 0, "splits": 0}
    assert tuner.resolve_attn_schedule(cfg, 1, 64, 64, 4, 1, 16,
                                       device="cpu") == \
        {"cluster": 0, "stages": 0}
    assert tuner.resolve_paged_attn_schedule(
        cfg, 2, 4, 1, 16, 256, device="cpu") == \
        schedules.PagedAttnSchedule(64)


def test_full_tunes_once_then_hits(tmp_cache, monkeypatch):
    """``full`` measures a shape's space once and persists the winner (the
    shape's own plan on the CPU: every candidate shares one timing); the
    next resolution is a lookup, in this process and in a fresh cache."""
    calls = _counting(monkeypatch)
    flags.set_flag("tune_mode", "full")
    cfg = GemminiConfig(**BF16)
    p1 = tuner.resolve_plan(cfg, 96, 384, 384, device="cpu")
    assert calls["n"] == 1                   # the plain version, once
    assert p1 == {"tile": 0, "splits": 0}
    p2 = tuner.resolve_plan(cfg, 96, 384, 384, device="cpu")
    assert calls["n"] == 1 and p2 == p1
    with open(tmp_cache) as f:
        plans = json.load(f)["plans"]
    assert len(plans) == 1
    (entry,) = plans.values()
    assert entry["source"] == "plain" and entry["n_candidates"] > 1
    tcache.reset_cache()
    pc = tcache.get_cache()
    assert tuner.resolve_plan(cfg, 96, 384, 384, device="cpu") == p1
    assert calls["n"] == 1 and pc.hits == 1 and pc.misses == 0
    rep = tuner.tune_gemm(cfg, 96, 384, 384, device="cpu", persist=False)
    assert rep.candidates[0].is_static and rep.winner == p1
    assert {c.min_us for c in rep.candidates} == {rep.static.min_us}
    for tune_fn, args in (
            (tuner.tune_attention, (1, 32, 32, 4, 1, 16)),
            (tuner.tune_conv, (1, 8, 8, 16, 32, 3, 3)),
            (tuner.tune_paged_attention, (2, 4, 1, 16, 128))):
        r = tune_fn(cfg, *args, device="cpu", persist=False)
        assert r.candidates[0].is_static and r.winner == r.static.sched
        assert r.speedup_vs_static == 1.0


def test_fingerprint_stable_across_processes(tmp_cache):
    """Stable across processes, sensitive to everything the card plan
    reads: dataflow, bias, dtypes and B's layout."""
    args = (("bf16", "fp32", "bf16"), Dataflow.WS, 128, 4096, 1024, True)
    here = tcache.fingerprint(*args, b_trans=True, device="cpu")
    code = ("from repro_torch.core.config import Dataflow\n"
            "from repro_torch.tune import cache as tcache\n"
            "print(tcache.fingerprint(('bf16', 'fp32', 'bf16'), Dataflow.WS,"
            " 128, 4096, 1024, True, b_trans=True, device='cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC)).stdout.strip()
    assert out == here
    assert here != tcache.fingerprint(*args, b_trans=False, device="cpu")
    assert here != tcache.fingerprint(args[0], Dataflow.OS, *args[2:],
                                      b_trans=True, device="cpu")
    assert here != tcache.fingerprint(("fp32", "fp32", "bf16"), *args[1:],
                                      b_trans=True, device="cpu")
    assert here != tcache.fingerprint(*args[:5], False, b_trans=True,
                                      device="cpu")
    assert tcache.card("cpu") == ("cpu", 0)
    assert len(tcache.source_hash()) == 16


def test_cache_roundtrip(tmp_cache):
    key = schedules.gemm_cache_key(
        (torch.int8, torch.int32, torch.int8), True, 1000, 512, 2048, True,
        False, "cpu")
    pc = tcache.get_cache()
    assert pc.lookup_checked(key, ("tile", "splits"), lambda p: True) is None
    pc.store_schedule(key, {"tile": 2, "splits": 3}, best_us=12.5)
    tcache.reset_cache()
    pc2 = tcache.get_cache()
    assert pc2 is not pc
    assert pc2.lookup_checked(key, ("tile", "splits"), lambda p: True) == \
        {"tile": 2, "splits": 3}
    other = schedules.gemm_cache_key(
        (torch.int8, torch.int32, torch.int8), True, 1000, 512, 1024, True,
        False, "cpu")
    assert pc2.lookup_checked(other, ("tile", "splits"),
                              lambda p: True) is None


@pytest.mark.parametrize("entry", [{"tile": 9, "splits": 1},
                                   {"tile": 2, "splits": 99},
                                   {"tile": 3, "splits": 0},
                                   {"tile": 0, "splits": 2}])
def test_stale_illegal_entry_misses(tmp_cache, entry):
    """An entry the kernel cannot run (here, by the header limits; on the
    card, by its C plan function) misses and is dropped, never launched."""
    flags.set_flag("tune_mode", "cached")
    cfg = GemminiConfig(**BF16)
    key = schedules.gemm_cache_key(
        (torch.bfloat16, torch.float32, torch.bfloat16), False, 256, 1024,
        1024, False, False, "cpu")
    tcache.get_cache().store_schedule(key, {"tile": 3, "splits": 2})
    with open(tmp_cache) as f:
        raw = json.load(f)
    raw["plans"][key].update(entry)
    with open(tmp_cache, "w") as f:
        json.dump(raw, f)
    tcache.reset_cache()
    pc = tcache.get_cache()
    assert tuner.resolve_plan(cfg, 256, 1024, 1024, device="cpu") == \
        {"tile": 0, "splits": 0}
    assert pc.misses == 1 and pc.hits == 0 and len(pc) == 0


def test_stale_attention_and_paged_entries_miss(tmp_cache):
    flags.set_flag("tune_mode", "cached")
    pc = tcache.get_cache()
    akey = schedules.attn_cache_key(1, 64, 64, 4, 1, 16, causal=True,
                                    window=None, dtype=torch.bfloat16,
                                    device="cpu")
    pc.store_schedule(akey, {"cluster": 3, "stages": 1})
    pkey = schedules.paged_attn_cache_key(2, 4, 1, 16, 256, window=None,
                                          dtype=torch.bfloat16, device="cpu")
    pc.store_schedule(pkey, {"page_size": 100, "split_keys": 64})
    cfg = GemminiConfig(**BF16)
    assert tuner.resolve_attn_schedule(cfg, 1, 64, 64, 4, 1, 16,
                                       device="cpu") == \
        {"cluster": 0, "stages": 0}
    assert tuner.resolve_paged_attn_schedule(cfg, 2, 4, 1, 16, 256,
                                             device="cpu").page_size == 64
    assert pc.misses == 2 and len(pc) == 0


def _dispatch_keys(monkeypatch):
    """Record every GEMM and flash call the model makes, as the dispatch
    would key it on a card."""
    seen = {"gemm": [], "attn": []}
    real_gemm, real_flash = kg._gemm, ka.flash_attention

    def gemm(a, b, d, *, acc_dtype, out_dtype, ws, **kw):
        _, trans, _ = kg._b_layout(b)
        seen["gemm"].append((a.dtype, acc_dtype, out_dtype, ws, a.shape[0],
                             b.shape[1], a.shape[1], d is not None,
                             bool(trans)))
        return real_gemm(a, b, d, acc_dtype=acc_dtype, out_dtype=out_dtype,
                         ws=ws, **kw)

    def flash(q, k, v, *, causal=True, window=None, **kw):
        b, tq, h, d = q.shape
        seen["attn"].append((b, tq, k.shape[1], h, k.shape[2], d, causal,
                             window, q.dtype))
        return real_flash(q, k, v, causal=causal, window=window, **kw)
    monkeypatch.setattr(kg, "_gemm", gemm)
    monkeypatch.setattr(ka, "flash_attention", flash)
    return seen


def test_warm_then_serve_zero_misses(tmp_cache, monkeypatch):
    """Acceptance: a full-mode warm, then, in a fresh cache in ``cached``
    mode, an engine warmed for its prompts serves them: every GEMM and
    flash schedule the requests launch (the biased qwen QKV included) is
    one the warm pass resolved, so resolving them misses nothing."""
    cfg = GemminiConfig(**BF16)
    mc = configs.get_smoke("qwen1.5-4b")
    assert any(bias for (_, _, _, bias) in tf.model_gemm_shapes(mc, 1, 16))
    lens = (13, 40)
    flags.set_flag("tune_mode", "full")
    eng = ServingEngine(mc, max_slots=2, max_context=64, device="cpu",
                        warm_prompt_lens=lens, prefill_chunk=16)
    assert eng.warm_stats["cache_misses"] > 0       # cold: tuned
    assert eng.page_size == 64
    flags.set_flag("tune_mode", "cached")
    tcache.reset_cache()
    pc = tcache.get_cache()
    eng = ServingEngine(mc, max_slots=2, max_context=64, device="cpu",
                        warm_prompt_lens=lens, prefill_chunk=16)
    assert eng.warm_stats["cache_misses"] == 0
    seen = _dispatch_keys(monkeypatch)
    rng = np.random.default_rng(0)
    for n in lens:
        eng.submit(rng.integers(0, mc.vocab, (n,), dtype=np.int32), 3)
    rep = eng.run()
    assert all(r["status"] == "finished" for r in rep["requests"])
    assert seen["gemm"] and seen["attn"]
    h0, m0 = pc.hits, pc.misses
    cpu = torch.device("cpu")
    for key in set(seen["gemm"]):
        tuner.gemm_schedule(*key, cpu)
    for key in set(seen["attn"]):
        tuner.attn_schedule(*key, cpu)
    assert (pc.hits, pc.misses) == (h0, m0), \
        "the request path resolved a schedule the warm pass did not"


def test_warm_model_plans_counts(tmp_cache):
    flags.set_flag("tune_mode", "cached")
    mc = configs.get_smoke("gemma3-1b")
    stats = tune.warm_model_plans(GemminiConfig(**BF16), mc, batch=2, seq=16,
                                  device="cpu")
    assert stats["gemm_shapes"] == len(tf.model_gemm_calls(mc, 2, 16))
    assert stats["attn_shapes"] == len(tf.model_attention_shapes(mc, 2, 16))
    assert stats["shapes"] == stats["gemm_shapes"] + stats["attn_shapes"]
    assert stats["cache_misses"] == stats["shapes"]   # cold, no tuning


def test_warm_is_shard_aware(tmp_cache):
    """n_shards warms the per-device M, not the global one."""
    flags.set_flag("tune_mode", "cached")
    mc = configs.get_smoke("gemma3-1b")
    stats = tune.warm_model_plans(GemminiConfig(**BF16), mc, batch=8,
                                  seq=16, n_shards=4, include_decode=False,
                                  device="cpu")
    per_dev = tf.model_gemm_calls(mc, 2, 16, include_decode=False)
    assert stats["gemm_shapes"] == len(per_dev)
    assert all(call[0] == 2 * 16 for call in per_dev)


def test_time_callable_reports_min_mean_and_a_tuner_span():
    from repro_torch.obs import trace as otrace
    tracer = otrace.install(otrace.Tracer())
    try:
        t = measure.time_callable(lambda x: x * 2, torch.ones(8, 8),
                                  iters=4, label="probe")
    finally:
        otrace.deactivate()
    assert t["min_us"] > 0 and t["mean_us"] >= t["min_us"]
    assert int(t["iters"]) == 4
    spans = [e for e in tracer.events if e["name"] == "measure:probe"]
    assert len(spans) == 1 and spans[0]["tid"] == otrace.TID_TUNER


def test_a_bad_tune_mode_raises(tmp_cache, monkeypatch):
    """The process flag is the one tune policy: ``set_flag`` refuses a
    mode outside ``TUNE_MODES``, and one seeded past it (a bad
    ``GEMMINI_TUNE``) raises at the tuner's first resolution instead of
    running as ``off``."""
    with pytest.raises(ValueError):
        flags.set_flag("tune_mode", "sometimes")
    monkeypatch.setitem(flags._values, "tune_mode", "sometimes")
    with pytest.raises(ValueError):
        tuner.resolve_plan(GemminiConfig(**F32), 2, 4, 3, device="cpu")


# ---------------------------------------------------------------------------
# quarantine (tests/test_chaos.py's counterparts)
# ---------------------------------------------------------------------------
def test_plan_cache_quarantine_roundtrip(tmp_cache):
    pc = tcache.get_cache()
    pc.store_schedule("k1", {"page_size": 32})
    assert pc.lookup_schedule("k1", ("page_size",)) is not None
    pc.quarantine("k1")
    assert pc.is_quarantined("k1")
    assert pc.lookup_schedule("k1", ("page_size",)) is None
    pc.store_schedule("k1", {"page_size": 64})          # re-store refused
    assert pc.lookup_schedule("k1", ("page_size",)) is None
    tcache.reset_cache()
    pc2 = tcache.get_cache()
    assert pc2.is_quarantined("k1")                     # persisted
    pc2.unquarantine("k1")
    assert not pc2.is_quarantined("k1")
    pc2.store_schedule("k1", {"page_size": 64})
    assert pc2.lookup_schedule("k1", ("page_size",)) is not None


_TINY = dataclasses.replace(configs.get_smoke("gemma3-1b"),
                            dtype=torch.float32)


def _run(faults_spec=None, **kw):
    rng = np.random.default_rng(0)
    eng = ServingEngine(_TINY, max_slots=2, max_context=32, page_size=8,
                        n_pages=8, temperature=0.0, seed=0, prefill_chunk=8,
                        faults=faults_spec, device="cpu",
                        engine_cfg=GemminiConfig(**F32), **kw)
    for n in (5, 11, 19):
        eng.submit(rng.integers(0, 64, (n,), dtype=np.int32), 6)
    return eng, eng.run()


def test_guard_trip_quarantines_decode_schedule(tmp_cache):
    """A NaN guard trip at a decode step quarantines the paged key the
    engine resolved its page size under; the next resolution of that key
    returns the static page. A prefill trip falls back and counts, but
    blames no schedule."""
    flags.set_flag("tune_mode", "cached")
    key = schedules.paged_attn_cache_key(
        2, _TINY.n_heads, _TINY.n_kv_heads, _TINY.head_dim, 32, window=None,
        dtype=torch.float32, device="cpu")
    tcache.get_cache().store_schedule(key, {"page_size": 16,
                                            "split_keys": 128})
    eng, rep = _run("seed=1;nan@decode:max=1")
    assert eng._paged_sched_key == key
    assert rep["quarantined"] == [key]
    assert tcache.get_cache().is_quarantined(key)
    assert tuner.resolve_paged_attn_schedule(
        None, 2, _TINY.n_heads, _TINY.n_kv_heads, _TINY.head_dim, 32,
        dtype=torch.float32, device="cpu") == \
        schedules.default_paged_schedule().effective(32)
    eng2, rep2 = _run("seed=1;nan@prefill:max=1")
    assert rep2["summary"]["fallbacks"] == 1
    assert rep2["quarantined"] == []


def test_engine_takes_the_tuned_page_and_split(tmp_cache):
    """With tuning on and no page size named, the engine sizes its pools
    with the resolved page and launches the decode kernel with the
    resolved split."""
    flags.set_flag("tune_mode", "cached")
    key = schedules.paged_attn_cache_key(
        2, _TINY.n_heads, _TINY.n_kv_heads, _TINY.head_dim, 64, window=None,
        dtype=torch.float32, device="cpu")
    tcache.get_cache().store_schedule(key, {"page_size": 16,
                                            "split_keys": 128})
    eng = ServingEngine(_TINY, max_slots=2, max_context=64, device="cpu",
                        engine_cfg=GemminiConfig(**F32))
    assert eng.page_size == 16 and eng.max_pages_per_seq == 4
    assert eng.engine.decode_split == 128 and eng._rerun.decode_split == 128


def test_full_engine_tokens_equal_off(tmp_cache):
    """An fp32 engine under ``full`` gives the tokens it gives under
    ``off`` on the CPU: every candidate ties, so each shape keeps its own
    plan and the static page."""
    def serve(mode):
        flags.set_flag("tune_mode", mode)
        eng = ServingEngine(_TINY, max_slots=2, max_context=64, seed=0,
                            temperature=0.0, device="cpu", prefill_chunk=16,
                            engine_cfg=GemminiConfig(**F32),
                            warm_prompt_lens=(5, 30))
        rng = np.random.default_rng(3)
        for n in (5, 30):
            eng.submit(rng.integers(0, 64, (n,), dtype=np.int32), 6)
        rep = eng.run()
        return eng, [np.asarray(r["tokens"]).tolist()
                     for r in rep["requests"]]
    e_off, t_off = serve("off")
    e_full, t_full = serve("full")
    assert t_full == t_off
    assert e_full.page_size == e_off.page_size == 64
    assert e_full.warm_stats["shapes"] > 0 and e_off.warm_stats is None
