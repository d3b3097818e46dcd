"""The port's launch-contract lint (``src/repro_torch/analysis/lint`` and
``src/repro_torch/kernels/contracts.py``) on the CPU.

* the generic half (``affine``, ``findings``) gives the JAX package's
  results on the same inputs;
* one planted contract or fixture function trips each port rule;
* the repo lints clean with an empty baseline, and the CLI exits 0;
* each contract's outputs hold the logical output elements of the JAX
  contract for the same problem;
* the tuner's filter always keeps the shape's own plan and the
  feasibility predicates are total on garbage;
* the ``_legal`` functions give the parent's answers on the probe space;
* the card harness's coverage, guard-band, ticket and fixed-order checks
  catch a planted fault (with the launches emulated on the CPU).

The card-side agreement with the C plan functions is in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 17.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis.lint import affine as jaffine
from repro.analysis.lint import findings as jfindings
from repro.core import tiling as jtiling
from repro.core.config import GemminiConfig as JGemminiConfig
from repro.kernels import contracts as jkc
from repro.tune import schedules as jschedules
from repro_torch.analysis.lint import (affine, card, checks, driver,
                                       feasibility, findings, jit_audit,
                                       source)
from repro_torch.analysis.lint import __main__ as lint_cli
from repro_torch.kernels import contracts as kc
from repro_torch.tune import schedules
from repro_torch.tune import tuner

FIXTURE = Path(__file__).parent / "fixtures" / "bad_torch_kernels.py"


def codes(fs):
    return sorted(f.code for f in fs if f.severity != "info")


# ---------------------------------------------------------------------------
# the generic half against the JAX package's
# ---------------------------------------------------------------------------
_IX_CASES = [
    (("i", 4), lambda i: 2 * i + 1),
    (("i", 4), lambda i: i - 1),
    (("i", 8), lambda i: i // 2),
    (("i", 8), lambda i: -i + 7),
]


@pytest.mark.parametrize("case", range(len(_IX_CASES)))
def test_ix_range_support_coverage_as_jax(case):
    (name, size), fn = _IX_CASES[case]
    e, je = fn(affine.Ix.var(name, size)), fn(jaffine.Ix.var(name, size))
    assert e.range() == je.range() and e.support == je.support
    assert repr(e) == repr(je)
    for nb in (1, 4, 8):
        assert e.covers(nb) == je.covers(nb)


def test_ix_mixed_radix_and_nonaffine_as_jax():
    for mod in (affine, jaffine):
        i, j = mod.Ix.var("i", 2), mod.Ix.var("j", 3)
        assert (i * 3 + j).covers(6) and not (i * 2 + j).covers(6)
        assert (i * 3 + j).injective_in(("i", "j"))
        for bad in (lambda: i * j, lambda: i % 2, lambda: (i + j) // 2):
            with pytest.raises(mod.NonAffine):
                bad()
    grid = (("i", 4), ("j", 2))
    idx = affine.eval_index_map(lambda i, j: (j, 0), grid)
    jidx = jaffine.eval_index_map(lambda i, j: (j, 0), grid)
    assert [repr(e) for e in idx] == [repr(e) for e in jidx]


def test_fingerprints_and_baselines_as_jax(tmp_path):
    fs = [findings.finding("GL102", "error", "contract:x", "m", key="o:0"),
          findings.finding("GL501", "error", "k.py::f", "m2")]
    jfs = [jfindings.finding("GL102", "error", "contract:x", "m", key="o:0"),
           jfindings.finding("GL501", "error", "k.py::f", "m2")]
    assert [f.fingerprint for f in fs] == [f.fingerprint for f in jfs]
    path = tmp_path / "baseline.json"
    jfindings.write_baseline(path, jfs[:1])
    bl = findings.load_baseline(path)
    new, sup = findings.apply_baseline(fs, bl)
    assert [f.code for f in new] == ["GL501"] and \
        [f.code for f in sup] == ["GL102"]
    assert findings.to_report(new, suppressed=sup) == \
        jfindings.to_report(jfs[1:], suppressed=jfs[:1])
    assert findings.load_baseline(tmp_path / "missing.json") == {}
    merged = findings.dedupe(fs + fs)
    assert dict(merged[0].data)["occurrences"] == 2


# ---------------------------------------------------------------------------
# planted contracts: one defect, one code
# ---------------------------------------------------------------------------
def _gemm(**kw):
    return kc.gemm_contract(256, 1000, 1100, dtype=torch.float32, tile=2,
                            splits=4, **kw)


def test_shipped_contract_is_clean():
    assert codes(checks.check_contract(_gemm())) == []
    assert checks.admits(_gemm())


def test_gl102_dropped_ragged_tile():
    c = _gemm()
    op = next(o for o in c.operands if o.name == "c")
    # the last row tile (ragged: 1000 = 7 x 128 + 104) is dropped
    c = dataclasses.replace(c, operands=tuple(
        dataclasses.replace(o, shape=(256, 1000 + 128)) if o is op else o
        for o in c.operands))
    assert codes(checks.check_contract(c)) == ["GL102"]


def test_gl204_workspace_one_word_short():
    c = _gemm()
    assert c.reductions[0].via == "ticket"
    c = dataclasses.replace(c, workspace_words=c.workspace_words - 1)
    fs = checks.check_contract(c)
    assert codes(fs) == ["GL204"] and "words" in fs[0].message


def test_gl204_more_tiles_than_tickets():
    c = kc.gemm_contract(4096, 4096, 1100, dtype=torch.float32, tile=1,
                         splits=2)
    assert "GL204" in codes(checks.check_contract(c))


def test_gl301_one_byte_past_shared_memory():
    c = dataclasses.replace(_gemm(), smem=kc.SMEM_PER_BLOCK + 1)
    assert codes(checks.check_contract(c)) == ["GL301", "GL302"]
    assert codes(checks.check_contract(
        dataclasses.replace(_gemm(), smem=kc.SMEM_PER_BLOCK))) == []


def test_gl401_bf16_into_bf16_accumulator():
    c = kc.gemm_contract(256, 1000, 1100, dtype=torch.bfloat16, tile=3,
                         splits=1)
    bad = dataclasses.replace(c, mma=(kc.MmaPair(kc.BF16, kc.BF16,
                                                 kc.BF16),))
    assert codes(checks.check_contract(c)) == []
    assert codes(checks.check_contract(bad)) == ["GL401"]


def test_gl201_two_regions_write_one_tile():
    c = _gemm(ws=True)
    r = c.regions[0]
    c = dataclasses.replace(c, regions=(r, r), blocks=2 * c.blocks)
    assert "GL201" in codes(checks.check_contract(c))


def test_gl202_split_without_reduction():
    c = _gemm()
    red = dataclasses.replace(c.reductions[0], via="none")
    assert codes(checks.check_contract(
        dataclasses.replace(c, reductions=(red,)))) == ["GL202"]


def test_gl201_split_axis_with_no_reduction_declared():
    c = dataclasses.replace(_gemm(), reductions=())
    assert codes(checks.check_contract(c)) == ["GL201"]


def test_gl203_atomic_float_partials():
    c = _gemm()
    red = dataclasses.replace(c.reductions[0], order="atomic")
    assert codes(checks.check_contract(
        dataclasses.replace(c, reductions=(red,)))) == ["GL203"]


def test_gl101_ragged_edge_not_predicated():
    c = _gemm()
    c = dataclasses.replace(c, operands=tuple(
        dataclasses.replace(o, predicated=()) if o.name == "c" else o
        for o in c.operands))
    assert codes(checks.check_contract(c)) == ["GL101"]


def test_gl103_paged_gather_must_be_declared():
    c = kc.paged_decode_contract(4, 32, 64, 8, 2, 128, n_pages=129)
    assert codes(checks.check_contract(c)) == []
    bare = dataclasses.replace(c, operands=tuple(
        dataclasses.replace(o, data_dependent=None) if o.name == "k_pool"
        else o for o in c.operands))
    fs = checks.check_contract(bare)
    assert [f.code for f in fs if f.severity == "warning"] == ["GL103"]


def test_gl105_and_gl303_limits_and_the_card():
    assert "GL105" in codes(checks.check_contract(
        kc.gemm_contract(256, 1000, 1100, dtype=torch.bfloat16, tile=2,
                         splits=9)))
    c = kc.gemm_contract(256, 1000, 1100, dtype=torch.bfloat16)
    fs = checks.check_contract(c)
    assert c.needs_card and [f.code for f in fs] == ["GL303"]
    assert fs[0].severity == "info" and checks.admits(c)


def test_skinny_kernel_past_16_rows_leaves_a_gap():
    c = kc.gemm_contract(100, 1000, 1100, dtype=torch.bfloat16, tile=1,
                         splits=1)
    assert codes(checks.check_contract(c)) == ["GL102"]


# ---------------------------------------------------------------------------
# source rules: the fixture, and the real wrappers
# ---------------------------------------------------------------------------
def test_fixture_trips_every_source_rule():
    fs = source.check_kernel_file(FIXTURE)
    assert codes(fs) == ["GL501", "GL502", "GL503", "GL504", "GL506"]
    by = {f.code: f.site.split("::")[-1] for f in fs}
    assert by["GL501"] == "unannotated" and by["GL503"] == "counts_twice"
    assert by["GL502"] == "library_on_card" and by["GL504"] == "unchecked"


def test_every_launching_wrapper_carries_a_contract():
    import ast
    kdir = Path(kc.__file__).parent
    names = {}
    for p in sorted(kdir.glob("*.py")):
        for fn in ast.walk(ast.parse(p.read_text())):
            if isinstance(fn, ast.FunctionDef) and \
                    source._contract_names(fn):
                names[fn.name] = source._contract_names(fn)
    assert names == {"_gemm": ("gemm", "gemm_s8"),
                     "accumulator_epilogue": ("accumulator_epilogue",),
                     "flash_attention": ("flash_attention",),
                     "decode_attention": ("decode_attention",),
                     "paged_decode_attention": ("paged_decode_attention",),
                     "paged_prefill_attention": ("paged_prefill_attention",),
                     "conv2d_implicit": ("conv2d_implicit",),
                     "ssd": ("ssd",)}
    assert all(n in kc.CONTRACT_BUILDERS for ns in names.values()
               for n in ns)


# ---------------------------------------------------------------------------
# the repo is clean
# ---------------------------------------------------------------------------
def test_repo_lints_clean_with_an_empty_baseline(capsys):
    assert lint_cli.main(["--format", "json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["counts"]["error"] == rep["counts"]["warning"] == 0
    assert rep["counts"]["suppressed"] == 0
    plans = rep["plans"]
    assert plans["plans"] == plans["admitted"] + plans["refused"]
    assert plans["admitted"] > 1000 and plans["refused"] > 100


def test_every_tile_and_split_of_the_space_is_probed():
    seen = {}
    for pr in driver.probes(("gemm",)):
        key = (pr.kw.get("dtype", "int8"), pr.kw["m"])
        seen.setdefault(key, set()).add(tuple(pr.schedule.values()))
    for (dtype, m), plans in seen.items():
        space = schedules.enumerate_gemm_schedules(getattr(torch, dtype), m,
                                                   driver.GEMM_N,
                                                   driver.GEMM_K)
        assert {(s["tile"], s["splits"]) for s in space} <= plans


# ---------------------------------------------------------------------------
# output extents against the JAX contracts
# ---------------------------------------------------------------------------
def _elements(ops):
    return sum(int(np.prod(o.shape)) for o in ops if o.output)


_CFG = JGemminiConfig(input_dtype="bf16", acc_dtype="fp32",
                      output_dtype="bf16")


@pytest.mark.parametrize("m", [4, 100, 256])
def test_gemm_and_epilogue_extents_as_jax(m):
    """The JAX GEMM's operands are padded to its tile plan: its output
    holds the problem's (M, N) in its top-left corner; the port's is
    exactly (M, N), its ragged edges predicated."""
    plan = jtiling.enumerate_plans(_CFG, m, 1000, 1100,
                                   max_candidates=1)[0]
    jout = jkc.gemm_os_contract(_CFG, plan).outputs[0]
    jepi = jkc.accumulator_epilogue_contract(_CFG, plan, m=plan.m,
                                             n=plan.n).outputs[0]
    assert jout.shape == jepi.shape == (plan.m, plan.n)
    assert plan.m - m < plan.tile_m and plan.n - 1000 < plan.tile_n
    for dtype in driver.GEMM_DTYPES[1:]:
        c = kc.gemm_contract(m, 1000, 1100, dtype=dtype)
        assert next(o for o in c.operands if o.output).shape == (m, 1000)
    e = kc.epilogue_contract(m * 1000, acc_dtype="float32",
                             out_dtype="bfloat16", acc_offset=4)
    assert _elements(e.operands) == m * 1000


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_extents_as_jax(dtype):
    jf = jkc.flash_attention_contract(_CFG, b=2, h=8, kvh=2, tq=100, tk=300,
                                      d=64, block_q=128, block_k=128)
    b, h, _, d = jf.outputs[0].shape
    f = kc.flash_contract(2, 100, 300, 8, 2, 64, window=128, dtype=dtype)
    assert _elements(f.operands) == b * h * 100 * d
    jd = jkc.decode_attention_contract(_CFG, b=4, h=8, kvh=2, s=2048, d=128,
                                       block_k=512)
    dd = kc.decode_contract(4, 2048, 8, 2, 128, 1000, dtype=dtype)
    assert _elements(dd.operands) == int(np.prod(jd.outputs[0].shape))
    jp = jkc.paged_decode_attention_contract(_CFG, b=4, h=8, kvh=2, d=128,
                                             page=64, mp=32, n_pages=128)
    pd = kc.paged_decode_contract(4, 32, 64, 8, 2, 128, n_pages=129,
                                  dtype=dtype)
    assert next(o for o in pd.operands if o.output).shape == \
        jp.outputs[0].shape
    jq = jkc.paged_prefill_attention_contract(_CFG, h=8, kvh=2, tq=100,
                                              d=64, page=16, mp=9,
                                              n_pages=12, block_q=128)
    hq, _, dq = jq.outputs[0].shape
    pq = kc.paged_prefill_contract(100, 37, 8, 2, 64, dtype=dtype)
    assert _elements(pq.operands) == hq * 100 * dq


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_conv_and_ssd_extents_as_jax(dtype):
    jc = jkc.conv2d_implicit_contract(
        JGemminiConfig(), n=1, h=15, w=15, ci=24, co=40, kh=3, kw=3,
        co_tile=128, stride=2, padding=1)
    n, oh, ow, _ = jc.outputs[0].shape
    c = kc.conv_contract(1, 15, 15, 24, 40, 3, 3, stride=2, padding=1,
                         dtype=dtype)
    # the implicit GEMM's (N*OH*OW, CO): the NHWC output, rows flattened
    assert next(o for o in c.operands if o.output).shape == \
        (n * oh * ow, 40)
    js = jkc.ssd_contract(_CFG, bsz=2, h=64, nc=4, q=256, p=64, n=128,
                          ngroups=1, return_final_state=True)
    s = kc.ssd_contract(2, 1024, 64, 1, 128, 64, 256, final_state=True,
                        dtype=dtype.replace("int8", "bfloat16"))
    assert _elements(s.operands) == sum(int(np.prod(o.shape))
                                        for o in js.outputs)


# ---------------------------------------------------------------------------
# the tuner's filter and the legal functions
# ---------------------------------------------------------------------------
def test_contract_filter_always_keeps_the_own_plan():
    cands = ["own", "a", "b"]
    first = tuner._is_first(cands)
    assert tuner._contract_filter(cands, first, lambda c: False) == ["own"]
    assert tuner._contract_filter(cands, first, lambda c: c != "a") == \
        ["own", "b"]
    raise_ = lambda c: (_ for _ in ()).throw(RuntimeError())   # noqa: E731
    assert tuner._contract_filter(cands, lambda c: False, raise_) == cands
    assert tuner._contract_filter(["a", "b"], lambda c: False,
                                  lambda c: False) == ["a", "b"]


def test_feasibility_is_total_on_garbage():
    assert feasibility.gemm_plan_feasible(torch.bfloat16, 4, 8, 8,
                                          object()) is False
    assert feasibility.gemm_plan_feasible("no-dtype", 4, 8, 8,
                                          {"tile": 1, "splits": 1}) is False
    assert feasibility.conv_plan_feasible(torch.int8, -1, 8, 8,
                                          {"tile": 1}) is False
    assert feasibility.attn_schedule_feasible(
        None, b=1, tq=1, tk=1, h=1, kvh=1, d=64) is False
    assert feasibility.paged_schedule_feasible(
        object(), b=1, h=1, kvh=1, d=64, max_context=64) is False


def _old_gemm_legal(dtype, m, n, k, sched):
    """The parent's ``schedules.gemm_legal`` (the header limits by hand)."""
    cd = lambda a, b: -(-a // b)                           # noqa: E731
    ints = (torch.int8, torch.int16)
    tile, splits = sched["tile"], sched["splits"]
    if (tile, splits) == (0, 0):
        return True
    tiles = schedules.gemm_tiles(dtype, m)
    if tile not in tiles or splits < 1:
        return False
    bm, bn = tiles[tile]
    if splits > 1 and cd(m, bm) * cd(n, bn) > 1024 \
            and (dtype == torch.float32 or dtype in ints or m <= 16):
        return False
    most = (16 if dtype in ints or dtype == torch.float32
            else 32 if m <= 16 else 8)
    ks = max(1, cd(k * dtype.itemsize, 64)) if dtype in ints else \
        max(1, cd(k, 16 if dtype == torch.float32 else 64))
    return splits <= min(most, ks)


def _old_conv_legal(dtype, m, n, k, sched):
    cd = lambda a, b: -(-a // b)                           # noqa: E731
    tile, splits = sched["tile"], sched["splits"]
    if (tile, splits) == (0, 0):
        return True
    if dtype not in (torch.float32, torch.int16):
        return _old_gemm_legal(torch.int8 if dtype == torch.int8 else
                               torch.int16, m, n, k, sched)
    ks = max(1, cd(k, 16))
    tiles = cd(m, 56) * cd(n, 64)
    return tile == 1 and 1 <= splits <= min(32, ks) and \
        (splits == 1 or tiles <= 1024)


@pytest.mark.parametrize("dtype", driver.GEMM_DTYPES)
def test_gemm_and_conv_legal_as_before_on_the_probe_space(dtype):
    td = getattr(torch, dtype)
    for m in driver.GEMM_MS:
        for s in driver.gemm_plans(dtype, m, driver.GEMM_N, driver.GEMM_K):
            assert schedules.gemm_legal(td, m, driver.GEMM_N, driver.GEMM_K,
                                        s) == \
                _old_gemm_legal(td, m, driver.GEMM_N, driver.GEMM_K, s), \
                (m, s)
    for (n, h, w, ci, co, kh, kw, st, pad) in driver.CONV_PROBES.values():
        oh, ow = (h + 2 * pad - kh) // st + 1, (w + 2 * pad - kw) // st + 1
        mm, kk = n * oh * ow, kh * kw * ci
        for s in driver.conv_plans(dtype, mm, co, kk):
            assert schedules.conv_legal(td, mm, co, kk, s) == \
                _old_conv_legal(td, mm, co, kk, s), (mm, s)


def test_paged_and_attn_legal_as_before():
    for ctx in (64, 2048):
        for page in schedules.paged_page_sizes(ctx):
            for split in (0, 8, 16, 24, 64, 4096, 4112, 8192):
                s = schedules.PagedAttnSchedule(page, split)
                old = split == 0 or (16 <= split <= 4096 and split % 16 == 0)
                assert schedules.paged_legal(s, ctx) == old
    for dtype in (torch.bfloat16, torch.float32):
        for d in (64, 256):
            stages = (1,) if dtype == torch.float32 and d >= 256 else (1, 2)
            for c in (0, 1, 2, 3, 4, 8):
                for st in (0, 1, 2, 3):
                    s = {"cluster": c, "stages": st}
                    old = (c, st) == (0, 0) or (c in (1, 2, 4) and
                                                st in stages)
                    assert schedules.attn_legal(dtype, d, s) == old


def test_schedule_constants_live_in_the_contracts():
    for name in ("MAX_TICKETS", "WIDE_TILES", "SGEMM_TILES", "CC_MAX_CHAIN",
                 "IGEMM_TILES", "WD_MAX_SPLITS", "SK_MAX_SPLITS"):
        assert getattr(schedules, name) is getattr(kc, name)


# ---------------------------------------------------------------------------
# GL601 over the engine's buckets
# ---------------------------------------------------------------------------
def test_bucket_census_as_jax_and_gl601():
    from repro.analysis.lint import jit_audit as jjit
    from repro_torch import configs
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(configs.get_smoke("gemma3-1b"), device="cpu",
                        max_slots=2, max_context=32, page_size=8,
                        prefill_chunk=8)
    census = jit_audit.expected_bucket_census(eng)
    assert census == jjit.expected_bucket_census(eng)
    eng.submit(np.arange(1, 12, dtype=np.int32), 2)
    eng.run()
    assert jit_audit.audit_engine(eng) == []
    eng.observed_buckets["decode"] = {("x", i) for i in range(3)}
    fs = jit_audit.audit_engine(eng)
    assert [f.code for f in fs] == ["GL601"]


# ---------------------------------------------------------------------------
# the card harness's checks, with the launch emulated on the CPU
# ---------------------------------------------------------------------------
class _FakeLauncher:
    def __init__(self, mode):
        self.mode = mode
        self.close = lambda name, got, want, kind: card.close(
            torch, name, got, want, kind)

    def run(self, pr, c):
        want = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        out = card.Guarded(torch, (8, 8), torch.float32, "cpu")
        ticket = torch.zeros(4, dtype=torch.int32)
        calls = []

        def launch():
            calls.append(1)
            g = out.out
            g.copy_(want)
            if self.mode == "gap":
                g[3, 5] = g.view(-1)[-1] * 0 + float("nan")
                out.bits[card.GUARD // 4 + 29] = card._SENTINELS[4][
                    len(calls) - 1]
            elif self.mode == "guard":
                out.bits[3] = 0
            elif self.mode == "ticket":
                ticket[1] = 1
            elif self.mode == "order" and len(calls) == 2:
                g[0, 0] = 0.5
            return 0
        return [("c", out, want, "fp32")], launch, lambda: ticket


@pytest.mark.parametrize("mode,msg", [
    ("ok", None), ("gap", "no block wrote"), ("guard", "guard band"),
    ("ticket", "ticket words"), ("order", "two launches differ")])
def test_card_harness_catches_planted_faults(mode, msg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    pr = driver.Probe("gemm", ())
    if msg is None:
        card.launch_checks(torch, pr, None, _FakeLauncher(mode))
        return
    with pytest.raises(card.CardFailure, match=msg):
        card.launch_checks(torch, pr, None, _FakeLauncher(mode))


def test_register_check_reads_ptxas_lines():
    """Each contract's kernel instantiation in the ptxas lines is held to
    the contract's own ``max_regs`` (threads x ``min_blocks``), so a wrong
    launch bound in a contract fails, and so does a contract whose kernel
    no entry instantiates."""
    log = ("ptxas info    : Compiling entry function "
           "'_ZN5igemm6kernelIaLi1ELb0ENS_7MatrixAEEEvNS_4ArgsIT_EET2_'"
           " for 'sm_90a'\nptxas info    : Used 128 registers\n"
           "ptxas info    : Compiling entry function "
           "'_ZN5hgemm11wide_kernelI13__nv_bfloat16Lb0ELi2ELi64ELb1ES1_EEv"
           "NS_4ArgsIT_EE'\nptxas info    : Used 168 registers\n")
    square = kc.gemm_s8_contract(256, 1000, 1100, tile=2, splits=1)
    wide = kc.gemm_contract(256, 1000, 1100, dtype="bfloat16", tile=2,
                            splits=1)
    assert (square.kernel_args, square.max_regs) == ((1, 0), 128)
    assert card.template_ints(
        "_ZN5hgemm11wide_kernelI13__nv_bfloat16Lb0ELi2ELi64ELb1ES1_EEv",
        wide.kernel) == (0, 2, 64, 1)
    quiet = dict(log=lambda m: None)
    out = card.check_registers({"gemm": log}, [square, wide], **quiet)
    assert out == {"entries": 2, "kernels": 2, "unlaunched": 0}
    with pytest.raises(card.CardFailure, match="registers"):
        card.check_registers({"gemm": log.replace("Used 128", "Used 129")},
                             [square], **quiet)
    with pytest.raises(card.CardFailure, match="registers"):
        card.check_registers({"gemm": log},
                             [dataclasses.replace(square, min_blocks=4)],
                             **quiet)
    skinny = kc.gemm_s8_contract(4, 1000, 1100, tile=1, splits=1)
    with pytest.raises(card.CardFailure, match="no ptxas entry"):
        card.check_registers({"gemm": log}, [skinny], **quiet)
