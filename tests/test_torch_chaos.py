"""The port's robustness envelope against the JAX engine's, on the CPU.

The JAX side is ``tests/test_chaos.py``'s harness as that suite runs it
(its ``_TINY`` config, ``backend="interpret"``, two slots, 8-token pages
and chunks), here with the fp32 engine config on both sides; the port
serves the same fp32 config with the same weights (the JAX engine's,
converted through numpy) on the CPU. The control plane, the fault
grammar and the injector are verbatim copies, so under one seeded plan
the two engines must inject the same faults, retry, fall back and shed
the same steps and requests, and give the same greedy tokens: the JAX
engine re-runs a guarded step on its XLA twin, the port on its own
kernels from the step's pre-call state.

The op boundary (``ExecutionContext``'s hooks) is held to the JAX eager
op hooks, and shown to pass through while ``torch.compile`` traces or a
CUDA graph captures: C1's lesson (the JAX guard reads a jax attribute
that no longer exists, so its hooks fire inside ``jax.jit``). The port's
engine steps run eagerly, so an installed injector's op faults fire
inside them, after earlier layers have written the recurrent state in
place: a retried or re-run step must start from the state it received.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.config import GemminiConfig as JGemminiConfig
from repro.core.context import ExecutionContext as JExecutionContext
from repro.runtime import faults as jfaults
from repro.serving import ServingEngine as JServingEngine

from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.models import transformer as ttf
from repro_torch.obs import profile as oprofile
from repro_torch.runtime import faults
from repro_torch.runtime.faults import TransientOpError
from repro_torch.serving import ServingEngine

from test_chaos import MIXED_PLAN, _TINY as _JTINY

F32 = dict(input_dtype="fp32", acc_dtype="fp32", output_dtype="fp32")
_TTINY = ttf.ModelConfig(**{
    f.name: getattr(_JTINY, f.name) for f in dataclasses.fields(_JTINY)
    if f.name != "dtype"}, dtype=torch.float32)
# The counters each engine reports, compared key for key (not the
# watchdog's straggler flags: they follow each host's step times).
_COUNTERS = ("retries", "fallbacks", "injected_faults", "shed",
             "preemptions", "prefill_chunks", "offload_spills",
             "offload_restores", "restarts_restored", "restarts_recomputed")


def _engines(spec, *, n_pages=8, **kw):
    """The JAX engine as ``test_chaos._run`` builds it (fp32 engine
    config) and the port's twin of it on the CPU, same weights."""
    jeng = JServingEngine(_JTINY, max_slots=2, max_context=32, page_size=8,
                          n_pages=n_pages, temperature=0.0, seed=0,
                          backend="interpret", prefill_chunk=8,
                          faults=spec, engine_cfg=JGemminiConfig(**F32),
                          **kw)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    teng = ServingEngine(_TTINY, max_slots=2, max_context=32, page_size=8,
                         n_pages=n_pages, temperature=0.0, seed=0,
                         prefill_chunk=8, faults=spec,
                         engine_cfg=GemminiConfig(**F32), params=params,
                         device="cpu", **kw)
    return jeng, teng


def _submit(eng, lens, gen, **kw):
    rng = np.random.default_rng(0)
    return [eng.submit(rng.integers(0, 64, (n,), dtype=np.int32), gen, **kw)
            for n in lens]


def _tokens(report):
    return [np.asarray(r["tokens"]).ravel().tolist()
            for r in report["requests"]]


def _held(jrep, trep):
    """Tokens, statuses, the counters and the faults report equal."""
    assert _tokens(trep) == _tokens(jrep)
    assert [r["status"] for r in trep["requests"]] == \
        [r["status"] for r in jrep["requests"]]
    for key in _COUNTERS:
        assert trep["summary"][key] == jrep["summary"][key], key
    assert trep.get("faults") == jrep.get("faults")


# (plan, geometry): test_chaos.py's plans. The eviction geometry (four
# pages, two 19-token prompts, eight new tokens) preempts mid-flight, so
# the offload faults have a spill and a restore to fail.
_EVICT = dict(n_pages=4, lens=(19, 19), gen=8, kv_offload=True)
_PLANS = {
    "clean": (None, {}),
    "nan@decode": ("seed=1;nan@decode:max=1", {}),
    "inf@prefill": ("seed=1;inf@prefill:max=1", {}),
    "transient@decode": ("seed=1;transient@decode:max=2", {}),
    "arena": ("seed=5;arena:pages=4,start=1,max=6", {}),
    "straggler": ("straggler@step:delay=0.5,max=2", dict(lens=(5,), gen=4)),
    "mixed": (MIXED_PLAN, {}),
    "offload_spill": ("offload_io@spill:max=99", _EVICT),
    "offload_restore": ("offload_io@restore:max=99", _EVICT),
    "offload_clean": (None, _EVICT),
}


@pytest.mark.parametrize("name", sorted(_PLANS))
def test_faulted_engine_matches_jax(name):
    spec, geo = _PLANS[name]
    geo = dict(geo)
    lens, gen = geo.pop("lens", (5, 11, 19)), geo.pop("gen", 6)
    jeng, teng = _engines(spec, **geo)
    slept = {}
    for tag, eng in (("jax", jeng), ("port", teng)):
        if eng.faults is not None:          # no real sleeps in a test
            eng.faults.sleep = slept.setdefault(tag, []).append
        _submit(eng, lens, gen)
    jrep, trep = jeng.run(), teng.run()
    _held(jrep, trep)
    assert slept.get("port") == slept.get("jax")
    assert teng.alloc.held_pages == 0 and teng.alloc.host_used_pages == 0
    for r in trep["requests"]:
        assert r["status"] in ("finished", "shed")
    if spec and ("nan@" in spec or "inf@" in spec):
        assert trep["summary"]["fallbacks"] >= 1


def test_retry_exhaustion_raises_as_jax():
    """A transient failure on every dispatch: one retry, then the
    engine raises, after the same count of retries as the JAX engine."""
    raised = {}
    for tag, eng in zip(("jax", "port"), _engines(
            "transient@prefill:max=99", max_step_retries=1)):
        _submit(eng, (5,), 3)
        with pytest.raises(Exception) as err:
            eng.run()
        assert type(err.value).__name__ == "TransientOpError"
        raised[tag] = eng.counters["retries"]
    assert raised["port"] == raised["jax"] == 2


def _deadline_at_admission(eng):
    t = [100.0]
    eng.sched.clock = lambda: t[0]
    rng = np.random.default_rng(0)
    eng.submit(rng.integers(0, 64, (5,), dtype=np.int32), 3, deadline=99.0)
    eng.submit(rng.integers(0, 64, (9,), dtype=np.int32), 3,
               deadline=10_000.0)
    return eng.run()


def _deadline_mid_decode(eng):
    t = [0.0]
    eng.sched.clock = lambda: t[0]
    rng = np.random.default_rng(0)
    r0 = eng.submit(rng.integers(0, 64, (5,), dtype=np.int32), 8,
                    deadline=50.0)
    eng.submit(rng.integers(0, 64, (9,), dtype=np.int32), 8)
    eng.step()
    eng.step()
    assert r0.state == "running" and r0.n_generated > 0
    t[0] = 60.0
    return eng.run()


def _deadline_unenforced(eng):
    rng = np.random.default_rng(0)
    eng.submit(rng.integers(0, 64, (5,), dtype=np.int32), 3, deadline=50.0)
    return eng.run()


@pytest.mark.parametrize("case,enforce", [
    (_deadline_at_admission, True), (_deadline_mid_decode, True),
    (_deadline_unenforced, False)], ids=["admission", "mid_decode",
                                         "unenforced"])
def test_deadlines_match_jax(case, enforce):
    jeng, teng = _engines(None, enforce_deadlines=enforce)
    jrep, trep = case(jeng), case(teng)
    _held(jrep, trep)
    assert trep["summary"]["shed"] == (1 if enforce else 0)
    assert teng.alloc.free_pages == teng.alloc.n_pages


# ---------------------------------------------------------------------------
# the op boundary
# ---------------------------------------------------------------------------
def test_eager_op_poison_and_transient_match_jax():
    """nan then transient at ``op:matmul``, then clean: the same firings
    as the JAX engine's eager op hooks, and the clean output again."""
    a = np.ones((4, 8), np.float32)
    b = np.ones((8, 8), np.float32)
    plan = "nan@op:matmul:max=1;transient@op:matmul:start=1,max=1"
    cfg = dict(input_dtype="bf16", acc_dtype="fp32", output_dtype="bf16")
    sides = {"jax": (JExecutionContext(cfg=JGemminiConfig(**cfg),
                                       backend="xla"), jfaults,
                     lambda x: np.asarray(x, np.float32)),
             "port": (ExecutionContext(cfg=GemminiConfig(**cfg)), faults,
                      lambda x: x.float().numpy())}
    reports = {}
    for tag, (ctx, mod, host) in sides.items():
        ta, tb = ((a, b) if tag == "jax"
                  else (torch.from_numpy(a), torch.from_numpy(b)))
        clean = host(ctx.matmul(ta, tb))
        inj = mod.install(plan)
        try:
            assert np.all(np.isnan(host(ctx.matmul(ta, tb))))
            with pytest.raises(Exception) as err:
                ctx.matmul(ta, tb)
            assert type(err.value).__name__ == "TransientOpError"
            np.testing.assert_array_equal(host(ctx.matmul(ta, tb)), clean)
            reports[tag] = inj.report()
        finally:
            mod.deactivate()
    assert reports["port"] == reports["jax"] == {"nan@op:matmul": 1,
                                                 "transient@op:matmul": 1}
    assert faults.active() is None


@pytest.mark.parametrize("predicate", ["compiling", "capturing"])
def test_op_hooks_pass_through_under_compile_and_capture(monkeypatch,
                                                         predicate):
    """While ``torch.compile`` traces or the current stream captures a
    CUDA graph, an op neither faults nor is timed, and its value is the
    clean one: a host-level fault or timer would be baked into the
    compiled artifact."""
    if predicate == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    else:
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
    assert faults.capturing()
    ctx = ExecutionContext(cfg=GemminiConfig(input_dtype="fp32",
                                             acc_dtype="fp32",
                                             output_dtype="fp32"))
    a, b = torch.ones((4, 8)), torch.ones((8, 8))
    inj = faults.install("nan@op:matmul;transient@op:matmul")
    prof = oprofile.install(oprofile.Profiler())
    try:
        out = ctx.matmul(a, b)
        # the injector's own poison passes a captured value through too
        assert inj.poison("op:matmul", out) is out
    finally:
        faults.deactivate()
        oprofile.deactivate()
    assert torch.equal(out, torch.full((4, 8), 8.0))
    assert inj.report() == {} and prof.buckets == {}


def test_hooks_off_change_no_value():
    """With no injector and no profiler installed an op is its plain
    call: the same tensor values as the wrapped function."""
    assert faults.active() is None and oprofile._ACTIVE is None
    ctx = ExecutionContext(cfg=GemminiConfig(input_dtype="fp32",
                                             acc_dtype="fp32",
                                             output_dtype="fp32"))
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn((5, 7), generator=g), torch.randn((7, 3), generator=g)
    assert torch.equal(ctx.matmul(a, b), ctx._matmul(a, b))


# Transient op failures inside the engine's eager steps, each at a matmul
# after the first layer has written its recurrent state: one in a
# continuation chunk, one in a decode step (draw indices count every
# ``op:matmul`` visit, the failed attempts' included).
_OP_PLANS = {
    "mamba2-1.3b": "transient@op:matmul:start=16,stop=17;"
                   "transient@op:matmul:start=28,stop=29",
    "hymba-1.5b": "transient@op:matmul:start=62,stop=63;"
                  "transient@op:matmul:start=148,stop=149",
}


@pytest.mark.parametrize("arch", sorted(_OP_PLANS))
def test_transient_op_faults_inside_steps_keep_the_tokens(arch):
    """An installed injector's transient op failure fires mid-step, after
    earlier layers wrote their conv / SSM state in place; the retry starts
    from the state the step received, so the tokens are the unfaulted
    run's."""
    runs, steps = {}, []
    for tag in ("clean", "faulted"):
        eng = ServingEngine(tconfigs.get_smoke(arch), device="cpu", seed=0,
                            max_context=64, page_size=8, prefill_chunk=8,
                            max_slots=2)
        rng = np.random.default_rng(2)
        for n in (21, 6):
            eng.submit(rng.integers(0, 128, (n,)).astype(np.int32), 6)
        inj = faults.install(_OP_PLANS[arch]) if tag == "faulted" else None
        primary = eng._dispatch

        def watch(which, args):
            try:
                return primary(which, args)
            except TransientOpError:
                steps.append(which)
                raise

        eng._dispatch = watch
        try:
            runs[tag] = eng.run()
        finally:
            faults.deactivate()
    assert inj.report() == {"transient@op:matmul": 2}
    assert sorted(steps) == ["chunk_nl", "decode"]
    assert runs["faulted"]["summary"]["retries"] == 2
    assert _tokens(runs["faulted"]) == _tokens(runs["clean"])
