"""The port's control-plane model checker (``src/repro_torch/analysis/mc``)
against the JAX package's (``src/repro/analysis/mc``).

* the gate: every shipped configuration exhausts clean on the port's
  control plane, with the JAX explorer's state and transition counts;
* the oracle self-tests: the planted bugs are found, and each minimized
  counterexample replays to the JAX checker's spec string;
* decision equivalence: the port's ``NullEngine`` decides as the port's
  ``ServingEngine`` does on the CPU;
* the NaN guard on host logits (C8): the port's control plane, guard on,
  steps through a compute hook that returns numpy logits.
"""

import numpy as np
import pytest
import torch

from repro.analysis.mc import explore as jmcx
from repro.analysis.mc.harness import ALL_CONFIGS as J_ALL_CONFIGS
from repro_torch.analysis.mc import explore as mcx
from repro_torch.analysis.mc.canon import canonical_state
from repro_torch.analysis.mc.harness import (ALL_CONFIGS, CONFIGS,
                                             SELFTEST_CONFIGS, LogicalClock,
                                             MCConfig, NullEngine,
                                             build_engine)
from repro_torch.analysis.mc import __main__ as mc_cli
from repro_torch.models import transformer as ttf
from repro_torch.serving import ServingEngine

SELFTEST_CODES = {"sabotage-defrag-leak": {"GL801", "GL803"},
                  "sabotage-rewind": {"GL802"},
                  "sabotage-wedge": {"GL804", "GL806"}}


def _codes(res):
    return {v.code for v in res.violations}


# ---------------------------------------------------------------------------
# the gate, and the JAX explorer's counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_shipped_config_clean_with_jax_counts(name):
    res = mcx.explore(CONFIGS[name])
    ref = jmcx.explore(J_ALL_CONFIGS[name])
    assert res.complete and res.violations == []
    assert (res.states, res.transitions, res.memo_hits,
            res.terminal_states) == (ref.states, ref.transitions,
                                     ref.memo_hits, ref.terminal_states)


def test_configs_equal_the_jax_configs():
    assert sorted(ALL_CONFIGS) == sorted(J_ALL_CONFIGS)
    for name, cfg in ALL_CONFIGS.items():
        assert repr(cfg) == repr(J_ALL_CONFIGS[name])


def test_cli_exits_zero_on_shipped_config(capsys):
    assert mc_cli.main(["--config", "core-3s12p"]) == 0
    out = capsys.readouterr().out
    assert "core-3s12p: 281 states" in out and "0 finding(s)" in out


def test_cli_reads_a_baseline_and_writes_none(tmp_path):
    """``--baseline`` only reads: a file with an entry suppresses the
    planted finding, and the file is left as it was."""
    path = tmp_path / "baseline.json"
    assert mc_cli.main(["--config", "sabotage-rewind"]) == 1
    res = mcx.explore(SELFTEST_CONFIGS["sabotage-rewind"])
    v = mcx.minimize(SELFTEST_CONFIGS["sabotage-rewind"], res.violations[0])
    from repro_torch.analysis.lint.findings import finding
    fp = finding(v.code, "error", f"mc:{v.config}", v.message,
                 key="|".join(v.trace)).fingerprint
    text = '{"suppress": [{"fingerprint": "%s"}]}\n' % fp
    path.write_text(text)
    assert mc_cli.main(["--config", "sabotage-rewind",
                        "--baseline", str(path)]) == 0
    assert path.read_text() == text
    with pytest.raises(SystemExit):
        mc_cli.main(["--write-baseline"])


# ---------------------------------------------------------------------------
# planted bugs: found, minimized to the JAX checker's traces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SELFTEST_CONFIGS))
def test_selftest_found_with_jax_spec(name):
    cfg = SELFTEST_CONFIGS[name]
    res = mcx.explore(cfg)
    ref = jmcx.explore(J_ALL_CONFIGS[name])
    assert res.complete and SELFTEST_CODES[name] <= _codes(res)
    assert _codes(res) == {v.code for v in ref.violations}
    for code in SELFTEST_CODES[name]:
        v = mcx.minimize(cfg, next(x for x in res.violations
                                   if x.code == code))
        jv = jmcx.minimize(J_ALL_CONFIGS[name],
                           next(x for x in ref.violations if x.code == code))
        assert mcx.format_spec(v.config, v.trace) == \
            jmcx.format_spec(jv.config, jv.trace)
        r1, r2 = mcx.replay(cfg, v.trace), mcx.replay(cfg, v.trace)
        assert r1.valid and r1.state_hash == r2.state_hash == v.state_hash


def test_replay_rejects_disabled_action_and_clean_trace():
    r = mcx.replay(CONFIGS["core-3s12p"], ("decode",))
    assert not r.valid and r.violation is None
    r = mcx.replay(CONFIGS["core-3s12p"], ("submit", "prefill"))
    assert r.valid and r.violation is None and r.executed == 2


def test_exported_regression_imports_the_port(tmp_path):
    cfg = SELFTEST_CONFIGS["sabotage-defrag-leak"]
    v = mcx.minimize(cfg, mcx.explore(cfg).violations[0])
    src = mcx.export_pytest(v)
    assert "from repro_torch.analysis.mc import" in src
    assert "python -m repro_torch.analysis.mc --replay" in \
        mcx.export_fault_script(v)
    ns = {}
    exec(compile(src, "regression", "exec"), ns)
    ns[f"test_mc_counterexample_{v.code.lower()}_sabotage_defrag_leak"]()


def test_canonical_hash_is_pure():
    a, b = build_engine(CONFIGS["core-3s12p"]), \
        build_engine(CONFIGS["core-3s12p"])
    assert canonical_state(a) == canonical_state(b)
    assert build_engine(CONFIGS["core-3s12p"]).assert_invariants is False


# ---------------------------------------------------------------------------
# decision equivalence: NullEngine vs the port's ServingEngine on the CPU
# ---------------------------------------------------------------------------
_TINY = ttf.ModelConfig(name="tiny-mc", family="dense", n_layers=2,
                        d_model=32, vocab=64, n_heads=2, n_kv_heads=1,
                        head_dim=16, d_ff=64, dtype=torch.float32)
_EQ_PROMPTS = ((1, 2, 3, 4, 5), (6, 7, 8), (9, 10, 11, 12, 13, 14))
_EQ_MAX_NEW = (3, 2, 2)


def _decision_view(eng):
    return (
        tuple(r.rid for r in eng.sched.queue),
        tuple(sorted((slot, r.rid, r.cache_len, r.prefill_pos,
                      r.n_generated, r.state)
                     for slot, r in eng.sched.running.items())),
        tuple(sorted((r.rid, r.state, r.n_generated, len(r.generated),
                      bool(r.truncated), r.n_preempted)
                     for r in eng.requests)),
        eng.alloc.used_pages,
        eng.alloc.free_pages,
    )


def _apply_ops(eng, ops):
    trail = []
    for op in ops:
        if op == "submit":
            i = len(eng.requests)
            eng.submit(np.asarray(_EQ_PROMPTS[i], np.int32),
                       _EQ_MAX_NEW[i], eos_id=-1)
        elif op == "step":
            eng.step()
        elif op == "preempt":
            if eng.sched.running:
                eng.sched.preempt(eng.sched._eviction_victim())
        elif op == "defrag":
            eng.defrag()
        trail.append(_decision_view(eng))
    it = 0
    while eng.sched.has_work:
        eng.step()
        trail.append(_decision_view(eng))
        it += 1
        assert it < 200, "drain did not terminate"
    return trail


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_null_engine_decides_as_the_serving_engine(seed):
    rng = np.random.default_rng(seed)
    ops = ["submit", "step", "submit", "step", "submit"]
    for _ in range(8):
        ops.append(rng.choice(["step", "step", "preempt", "defrag"]))
    real = ServingEngine(
        _TINY, max_slots=2, max_context=32, page_size=8, n_pages=8,
        prefill_chunk=8, prefill_token_budget=8, seed=0,
        clock=LogicalClock(), device="cpu")
    null = NullEngine(MCConfig(
        name="equiv", slots=2, pages=8, page_size=8, max_context=32,
        prompts=_EQ_PROMPTS, max_new=_EQ_MAX_NEW, prefill_chunk=8,
        prefill_token_budget=8))
    assert _apply_ops(real, ops) == _apply_ops(null, ops)


# ---------------------------------------------------------------------------
# C8: the NaN guard on a compute hook's host (numpy) logits
# ---------------------------------------------------------------------------
class _HostLogits(NullEngine):
    """The null executor with finite numpy logits, poisoned once by hand."""

    poison_next = False

    def _null_logits(self):
        if self.poison_next:
            self.poison_next = False
            return np.full((1, 2), np.nan, np.float32)
        return np.zeros((1, 2), np.float32)


def test_nan_guard_steps_on_numpy_logits():
    cfg = MCConfig(name="host-logits", slots=2, pages=8, page_size=4,
                   max_context=16, prompts=((1, 2, 3), (4, 5)),
                   max_new=(2, 2), prefill_chunk=4,
                   fault_kinds=("nan",), max_faults=1)
    eng = _HostLogits(cfg)
    assert eng.nan_guard
    for i, p in enumerate(cfg.prompts):
        eng.submit(np.asarray(p, np.int32), cfg.max_new[i], eos_id=-1)
    eng.step()
    eng.poison_next = True
    eng.step()
    while eng.sched.has_work:
        eng.step()
    assert all(r.state == "finished" for r in eng.requests)
    assert eng.metrics.value("fallbacks") == 1
