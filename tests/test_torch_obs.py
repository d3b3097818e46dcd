"""The port's kernel profiler and trace inspector against the JAX
package's, on the CPU.

``repro_torch.obs.kernel_costs.op_cost`` writes as closed formulas what
``repro.obs.kernel_costs`` derives from each kernel's one-block
``KernelContract``; both are evaluated here on shapes alone (JAX
``ShapeDtypeStruct`` values, torch ``meta`` tensors) and must agree
exactly, FLOPs and bytes. The profiler must cover every op family the
context dispatches and leave every value as it was, and its spans must
reach a tracer. ``python -m repro_torch.obs`` must give the same
``--check`` exit codes and the same summary as ``python -m repro.obs`` on
one trace file.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import Dataflow as JDataflow
from repro.core.config import GemminiConfig as JGemminiConfig
from repro.obs import __main__ as jobs_cli
from repro.obs import kernel_costs as jcosts

from repro_torch import configs as tconfigs
from repro_torch.analysis import roofline
from repro_torch.core.config import Dataflow, GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.obs import __main__ as tobs_cli
from repro_torch.obs import kernel_costs as tcosts
from repro_torch.obs import profile as oprofile
from repro_torch.obs import trace as otrace
from repro_torch.serving import ServingEngine

BF16 = dict(input_dtype="bf16", acc_dtype="fp32", output_dtype="bf16")
F32 = dict(input_dtype="fp32", acc_dtype="fp32", output_dtype="fp32")
I8 = dict(input_dtype="int8", acc_dtype="int32", output_dtype="int8")
_DT = {"bf16": (jnp.bfloat16, torch.bfloat16),
       "fp32": (jnp.float32, torch.float32),
       "int8": (jnp.int8, torch.int8), "int32": (jnp.int32, torch.int32)}

# op -> two (config, [(shape, dtype) | scalar, ...], kw) calls: the
# serving shapes at gemma3-1b's / mamba2-1.3b's widths and a small or
# ragged one; the engine's int8 and fp32 instances for the GEMM family.
_CALLS = {
    "gemm": [
        (BF16, [((64, 1152), "bf16"), ((1152, 1024), "bf16"),
                ((1, 1024), "fp32")], {}),
        (I8, [((1000, 2048), "int8"), ((2048, 512), "int8")],
         {"dataflow": "WS"}),
    ],
    "matmul": [
        (BF16, [((4, 1, 1152), "bf16"), ((1152, 262144), "bf16")],
         {"d": None}),
        (F32, [((3, 7, 32), "fp32"), ((32, 48), "fp32")],
         {"d": ((48,), "fp32")}),
    ],
    "conv2d": [
        (I8, [((1, 56, 56, 64), "int8"), ((3, 3, 64, 64), "int8"),
              ((64,), "int32")], {"stride": 1, "padding": 1}),
        (F32, [((1, 224, 224, 3), "fp32"), ((7, 7, 3, 64), "fp32")],
         {"stride": 2, "padding": 3}),
    ],
    "flash_attention": [
        (BF16, [((1, 256, 4, 256), "bf16"), ((1, 256, 1, 256), "bf16"),
                ((1, 256, 1, 256), "bf16")], {"causal": True}),
        (F32, [((2, 5, 4, 64), "fp32"), ((2, 7, 2, 64), "fp32"),
               ((2, 7, 2, 64), "fp32")], {"window": 4}),
    ],
    "paged_attention": [
        (BF16, [((4, 1, 4, 256), "bf16"), ((1, 129, 64, 256), "bf16"),
                ((1, 129, 64, 256), "bf16"), ((4, 32), "int32"),
                ((4,), "int32")], {}),
        (F32, [((2, 1, 2, 16), "fp32"), ((1, 9, 8, 16), "fp32"),
               ((1, 9, 8, 16), "fp32"), ((2, 4), "int32"),
               ((2,), "int32")], {"softcap": 50.0}),
    ],
    "paged_prefill_attention": [
        (BF16, [((1, 256, 4, 256), "bf16"), ((1, 129, 64, 256), "bf16"),
                ((1, 129, 64, 256), "bf16"), ((32,), "int32"), 768],
         {"kv_pages": 16}),
        (F32, [((1, 3, 2, 16), "fp32"), ((1, 9, 8, 16), "fp32"),
               ((1, 9, 8, 16), "fp32"), ((4,), "int32"), 8], {}),
    ],
    "ssd": [
        (BF16, [((1, 256, 64, 64), "bf16"), ((1, 256, 64), "fp32"),
                ((64,), "fp32"), ((1, 256, 1, 128), "bf16"),
                ((1, 256, 1, 128), "bf16")],
         {"chunk": 256, "return_final_state": True}),
        (F32, [((2, 300, 4, 16), "fp32"), ((2, 300, 4), "fp32"),
               ((4,), "fp32"), ((2, 300, 2, 8), "fp32"),
               ((2, 300, 2, 8), "fp32")], {"chunk": 128}),
    ],
}


def _jax_arg(a):
    if isinstance(a, tuple) and isinstance(a[0], tuple):
        return jax.ShapeDtypeStruct(a[0], _DT[a[1]][0])
    return a


def _torch_arg(a):
    if isinstance(a, tuple) and isinstance(a[0], tuple):
        return torch.empty(a[0], dtype=_DT[a[1]][1], device="meta")
    return a


def test_every_costed_op_is_covered():
    assert tcosts.costed_ops() == jcosts.costed_ops() == tuple(sorted(_CALLS))


@pytest.mark.parametrize("op,case", [(op, i) for op in sorted(_CALLS)
                                     for i in range(2)])
def test_op_cost_equals_jax(op, case):
    cfg, args, kw = _CALLS[op][case]
    jkw = {k: (JDataflow[v] if k == "dataflow" else _jax_arg(v))
           for k, v in kw.items()}
    tkw = {k: (Dataflow[v] if k == "dataflow" else _torch_arg(v))
           for k, v in kw.items()}
    want = jcosts.op_cost(op, tuple(_jax_arg(a) for a in args), jkw,
                          JGemminiConfig(**cfg))
    got = tcosts.op_cost(op, tuple(_torch_arg(a) for a in args), tkw,
                         GemminiConfig(**cfg))
    assert want is not None and got is not None
    assert (got.contract, got.flops, got.bytes, got.arith, got.detail) == \
        (want.contract, want.flops, want.bytes, want.arith, want.detail)
    in_dt = _DT[args[0][1]][1] if op not in ("gemm", "matmul", "conv2d") \
        else GemminiConfig(**cfg).input_torch
    assert got.peak == roofline.peak_ops(in_dt)


def test_peaks_follow_the_input_dtype():
    """fp32 runs on the CUDA cores, int16 as four int8 products."""
    assert roofline.peak_ops(torch.float32) == 67e12
    assert roofline.peak_ops(torch.bfloat16) == 989e12
    assert roofline.peak_ops(torch.int8) == 1979e12
    assert roofline.peak_ops(torch.int16) == 1979e12 / 4
    b = oprofile.OpBucket(op="matmul", sig="", flops=67e9, bytes=0.0,
                          peak=roofline.PEAK_FLOPS_FP32)
    b.record(1e-3)
    assert b.utilization()["compute"] == pytest.approx(1.0)


def _family_calls(g):
    """One call of every op family at a small shape on the CPU."""
    def rn(*shape):
        return torch.randn(shape, generator=g)

    f32 = ExecutionContext(cfg=GemminiConfig(**F32))
    i8 = ExecutionContext(cfg=GemminiConfig(**I8))
    x8 = torch.randint(-8, 8, (1, 6, 6, 4), generator=g, dtype=torch.int8)
    w8 = torch.randint(-8, 8, (3, 3, 4, 5), generator=g, dtype=torch.int8)
    pool = rn(1, 5, 4, 8)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    return [
        lambda: f32.gemm(rn(5, 7), rn(7, 3), rn(1, 3)),
        lambda: f32.matmul(rn(2, 5, 7), rn(7, 3), d=None),
        lambda: i8.conv2d(x8, w8, None, stride=1, padding=1),
        lambda: f32.flash_attention(rn(1, 6, 2, 8), rn(1, 6, 1, 8),
                                    rn(1, 6, 1, 8)),
        lambda: f32.decode_attention(rn(1, 1, 2, 8), rn(1, 6, 1, 8),
                                     rn(1, 6, 1, 8), 4),
        lambda: f32.paged_attention(rn(2, 1, 2, 8), pool, pool, tables,
                                    torch.tensor([5, 7], dtype=torch.int32)),
        lambda: f32.paged_prefill_attention(rn(1, 3, 2, 8), pool, pool,
                                            tables[0], 4),
        lambda: f32.ssd(rn(1, 9, 2, 4), torch.rand((1, 9, 2), generator=g),
                        rn(2), rn(1, 9, 1, 3), rn(1, 9, 1, 3), chunk=4,
                        return_final_state=True),
    ]


def _values(out):
    return list(out) if isinstance(out, tuple) else [out]


def test_profiler_covers_every_family_and_changes_no_value():
    calls = _family_calls(torch.Generator().manual_seed(0))
    plain = [_values(fn()) for fn in calls]
    calls = _family_calls(torch.Generator().manual_seed(0))
    prof = oprofile.install(oprofile.Profiler())
    try:
        profiled = [_values(fn()) for fn in calls]
    finally:
        oprofile.deactivate()
    for a, b in zip(plain, profiled):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    ops = {b.op: b for b in prof.buckets.values()}
    assert set(ops) == {"gemm", "matmul", "conv2d", "flash_attention",
                        "decode_attention", "paged_attention",
                        "paged_prefill_attention", "ssd"}
    for op, b in ops.items():
        assert b.calls == 1 and b.min_s > 0.0
        if op == "decode_attention":          # no cost in either package
            assert b.contract is None and b.row()["compute_util"] is None
        else:
            assert b.flops > 0 and b.bytes > 0
            assert b.row()["memory_util"] > 0
    assert ops["gemm"].peak == ops["ssd"].peak == roofline.PEAK_FLOPS_FP32
    assert ops["conv2d"].arith == "int"
    assert ops["conv2d"].peak == roofline.PEAK_OPS_INT8
    assert "profiler: no ops recorded" not in prof.report()


def test_profiled_spans_reach_the_tracer():
    tracer = otrace.Tracer()
    prof = oprofile.install(oprofile.Profiler(tracer=tracer))
    ctx = ExecutionContext(cfg=GemminiConfig(**F32))
    try:
        ctx.matmul(torch.ones((4, 8)), torch.ones((8, 2)))
        ctx.matmul(torch.ones((4, 8)), torch.ones((8, 2)))
    finally:
        oprofile.deactivate()
    spans = [e for e in tracer.chrome()["traceEvents"]
             if e.get("cat") == "kernel"]
    assert len(spans) == 2
    (bucket,) = prof.buckets.values()
    for ev in spans:
        assert ev["ph"] == "X" and ev["name"] == "matmul"
        assert ev["tid"] == otrace.TID_PROFILE
        assert ev["args"]["contract"] == "gemm_os"
        assert ev["args"]["flops"] == bucket.flops == 2.0 * 4 * 2 * 8
        assert ev["args"]["bytes"] == bucket.bytes
        assert ev["args"]["peak"] == bucket.peak == roofline.PEAK_FLOPS_FP32
        assert ev["args"]["sig"] == bucket.sig


@pytest.mark.parametrize("peak,want", [(roofline.PEAK_FLOPS_FP32, "10.00"),
                                       (None, "0.68")])
def test_trace_inspector_divides_by_the_spans_peak(peak, want):
    """The inspector's comp% is the profiler's compute share: a span's
    ``peak`` (an fp32 op: the CUDA-core rate) divides its rate; a span
    without one (a JAX trace's) is held to the bf16 tensor rate."""
    args = {"contract": "gemm_os", "flops": 6.7e9, "bytes": 0.0, "sig": "s"}
    if peak is not None:
        args["peak"] = peak
    ev = {"ph": "X", "cat": "kernel", "name": "matmul", "dur": 1000.0,
          "args": args}
    assert tobs_cli.kernel_table([ev])[1].split()[-2] == want
    b = oprofile.OpBucket(op="matmul", sig="s", flops=6.7e9,
                          peak=peak or roofline.PEAK_FLOPS_BF16)
    b.record(1e-3)
    assert format(b.utilization()["compute"] * 100, ".2f") == want


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """An engine trace (a faulted run with a fallback and a retry), the
    same with profiled kernel spans, and a broken one."""
    d = tmp_path_factory.mktemp("traces")
    out = {}
    for name, profiled in (("engine", False), ("kernels", True)):
        eng = ServingEngine(tconfigs.get_smoke("gemma3-1b"), device="cpu",
                            max_context=48, page_size=8, prefill_chunk=8,
                            max_slots=2, trace=True,
                            faults="seed=2;nan@decode:max=1;"
                                   "transient@prefill:max=1")
        if profiled:
            oprofile.install(oprofile.Profiler(tracer=eng.tracer))
        try:
            rng = np.random.default_rng(0)
            for n in (13, 5):
                eng.submit(rng.integers(0, 128, (n,)).astype(np.int32), 3)
            eng.run()
        finally:
            oprofile.deactivate()
        out[name] = str(d / f"{name}.json")
        eng.tracer.export_chrome(out[name])
    broken = json.load(open(out["engine"]))
    broken["traceEvents"][3].pop("ph")
    out["broken"] = str(d / "broken.json")
    json.dump(broken, open(out["broken"], "w"))
    out["missing"] = str(d / "missing.json")
    return out


@pytest.mark.parametrize("trace,flags", [
    ("engine", ["--check"]), ("broken", ["--check"]),
    ("missing", ["--check"]), ("engine", []), ("engine", ["--top", "3"]),
    ("engine", ["--json"]), ("kernels", ["--check"]),
    ("kernels", ["--json"])])
def test_trace_inspector_matches_jax(traces, capsys, trace, flags):
    argv = [traces[trace]] + flags
    want_rc = jobs_cli.main(argv)
    want = capsys.readouterr()
    got_rc = tobs_cli.main(argv)
    got = capsys.readouterr()
    assert got_rc == want_rc == {"engine": 0, "kernels": 0, "broken": 1,
                                 "missing": 2}[trace]
    assert got.out == want.out
    assert got.err == want.err


def test_trace_inspector_kernel_table_uses_the_card(traces, capsys):
    """With profiled spans, the summary adds the kernel table; its
    columns divide by the H100's peaks (the JAX one by the TPU's), and
    every other line is the JAX inspector's."""
    jobs_cli.main([traces["kernels"]])
    want = capsys.readouterr().out.splitlines()
    tobs_cli.main([traces["kernels"]])
    got = capsys.readouterr().out.splitlines()
    assert "-- kernel utilization (from profiled spans) --" in got
    start = got.index("-- kernel utilization (from profiled spans) --")
    end = got.index("", start)
    assert got[:start] == want[:start] and got[end:] == want[end:]
    assert len(got) == len(want)
