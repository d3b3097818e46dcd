"""The port's two remaining examples on the CPU: ``chaos_smoke`` (the
serving robustness gate) and ``dse_sweep`` (the design-space sweep),
against the JAX package's ``examples/`` scripts they port."""

import contextlib
import importlib.util
import io
import pathlib

import pytest

from repro_torch.examples import chaos_smoke, dse_sweep

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    return rc, buf.getvalue()


def test_chaos_smoke_passes_its_three_invariants_on_the_cpu(capsys):
    assert chaos_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("bit-identical to the fault-free run") == \
        len(chaos_smoke.PROMPT_LENS)
    assert "chaos_smoke OK" in out


def test_chaos_smoke_keeps_the_jax_scripts_plan_and_trace():
    jax_script = _jax_example("chaos_smoke")
    for name in ("FAULT_PLAN", "EXPECTED_INJECTED", "PROMPT_LENS",
                 "GEN_LENS"):
        assert getattr(chaos_smoke, name) == getattr(jax_script, name), name


def test_chaos_smoke_fails_on_a_broken_invariant(monkeypatch, capsys):
    """An expected fault report the plan cannot give (one more NaN than
    its cap) fails invariant 3: the script returns 1."""
    wrong = dict(chaos_smoke.EXPECTED_INJECTED, **{"nan@decode": 3})
    monkeypatch.setattr(chaos_smoke, "EXPECTED_INJECTED", wrong)
    assert chaos_smoke.main(["--device", "cpu"]) == 1
    assert "chaos_smoke FAILED" in capsys.readouterr().err


def test_chaos_smoke_raises_without_a_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chaos_smoke.main([])


def test_dse_sweep_prints_the_jax_scripts_rows():
    """The same five points, CSV rows and selected point, character for
    character."""
    rc, ours = _stdout(dse_sweep.main)
    _, theirs = _stdout(_jax_example("dse_sweep").main)
    assert rc == 0
    assert ours == theirs
    assert ours.splitlines()[0] == \
        "point,cycles,bottleneck,hbm_mb,perf_per_energy(norm)"
    assert "selected design point: " in ours
