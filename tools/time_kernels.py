"""Device time of kernels for a same-card comparison of two checkouts: the
bf16 engine GEMM at gemma3-1b's 24 serving shapes (7 projections and the
tied unembedding at M = 4, 64 and 256, the rows of ``chip_smoke.py`` phase
3, with ``torch.matmul`` beside each), its 16 backward products at the
training shapes (``gemm[bwd]``: dA and dB of the 7 projections and the
unembedding at 4 x 1024 token rows through ``kernels.gemm.grad_a`` /
``grad_b``, whichever kernels the checkout routes them to, with
``torch.matmul`` beside each and the step's sum over its 366 products),
the fp32 GEMM at phase 3's fp32
shapes (``torch.addmm`` / ``torch.matmul`` beside, TF32 off), the fp16
GEMM at the quickstart (OS and WS) and at ResNet-50's host-im2col shapes
(``torch.matmul`` beside) and the int16 GEMM at the same shapes on both
dataflows (PyTorch has no int16 matmul on the card), fp32
``flash_attention`` at the fp32 gate's prompts and at hymba-1.5b's first
chunk, flash and paged prefill off the compiled instances (generic head
dims, column slices, a view off 16 bytes; ``generic_attention_cases``,
plain version and SDPA beside), fp32 paged prefill at the gate's last
chunks and at hymba-1.5b's
256-token continuation chunk at 768, bf16 paged prefill at a
256-token chunk at 768 (gemma3-1b global and window 512, hymba-1.5b
window 1024; the dense flash kernel on the same keys gathered beforehand
beside each), paged decode at gemma3-1b's serving shape (global and with
the 512-key window), and the chunked SSD at mamba2-1.3b's and
hymba-1.5b's widths (bf16 and fp16: the serving call, 256 tokens resumed,
and 1000 tokens fresh; fp32: 256 tokens fresh and resumed, 1000 fresh,
held against the fp64 recurrence), the operand conversion (``--only
convert``: int16 -> bf16 on each of its paths, packed (1000, 2048), the
same one value into its buffer, rows (mamba2-1.3b's SSD x view, fp16 ->
fp32) and general (a transposed view), ``chip_smoke.convert_views``,
``Tensor.to`` beside each), and the engine (``--only engine``: the
int8 quickstart GEMM and ResNet-50's distinct layers as GEMMs on both
dataflows beside ``torch._int_mm``, the int8 conv kernel at the stream's
distinct convs, phase 3's rows of the float and 16-bit datapaths
(``chip_smoke.datapath_cases``: the fp16 and int16 GEMMs at the
quickstart shape, the fp32 / bf16 / fp16 / int16 convs at the stem,
stage-1 3x3 and stage-4 3x3, each beside its library call where PyTorch
has one), and the device time of the 50-layer stream per route, int8 and
on phase 6b's four instances; a checkout without those datapaths skips
them), the mvout epilogue (``--only epilogue``: its six datapaths at
(1000, 512) and at a misaligned odd shape, and fp32 -> fp32 / fp16 at
(3136, 256)), and the conv (``--only conv``, not in the default set: the fp32,
bf16, fp16 and int16 conv at every distinct conv of the stream beside
cuDNN's ``conv2d``, with each checkout's plan, and the fused stream's
device time on phase 6b's four instances beside cuDNN's on the same 49
convs). It
times the ``repro_torch`` package
found under ``--src``, so two checkouts compare on one card, run after
run:

  python3 tools/time_kernels.py --src OTHER_CHECKOUT/src --tag parent
  python3 tools/time_kernels.py --tag change
  python3 tools/time_kernels.py --only ssd    # one group: gemm, attention,
                                              # ssd, convert, engine,
                                              # epilogue, conv

Each output is held against its plain version (``chip_smoke.check_close``;
a miss is reported in the row's ``check``, not fatal) and timed with ``chip_smoke.Timer`` (CUDA events, L2 flushed, median of
25), beside the host's cost of one call launched back to back
(``enqueue_us``). Prints one JSON line ``{"tag", "device", "rows": [...], "gemm_step_sums",
"bwd_step_sum"}`` (the GEMM's sum over one decode step, M = 4, and one
prefill chunk, M = 256; the backward products' over one training step);
needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gemm_cases(torch, cs):
    """(kernel, label, kind, run_kernel, run_plain, run_library, (bytes,
    operations))."""
    from repro_torch.kernels import gemm as kg

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    rows = [("gemm", f"{name} M={m} N={n} K={k}", "bf16", run_k, run_p,
             run_lib, (2 * (m * k + k * n + m * n), 2.0 * m * n * k))
            for name, m, n, k, run_k, run_p, run_lib
            in cs.gemm_serving_cases(torch, randn, kg.gemm)]
    rows += [("gemm", f"fp32 {name} M={m} N={n} K={k}", "fp32", run_k,
              run_p, run_lib, (nbytes, 2.0 * m * n * k))
             for name, m, n, k, run_k, run_p, run_lib, nbytes
             in cs.fp32_gemm_cases(torch, randn)]
    return rows + bwd_gemm_cases(torch, cs, randn) + \
        fp16_gemm_cases(torch, cs, gen) + int16_gemm_cases(torch, cs, gen)


def bwd_gemm_cases(torch, cs, randn):
    """The backward products of ``chip_smoke.gemm_backward_cases``, each
    with its launches a training step in the label. A checkout whose
    ``grad_b`` has no ``trans`` (before the backward kernel) runs the
    unembedding's dB as it did, into (d, vocab)."""
    import inspect

    from repro_torch import configs
    from repro_torch.kernels import gemm as kg

    bf16 = torch.bfloat16
    layers = configs.get("gemma3-1b").n_layers
    has_trans = "trans" in inspect.signature(kg.grad_b).parameters
    out = []
    for op, name, m, n, k, operands, run_k, run_p, run_lib, run_exact in \
            cs.gemm_backward_cases(torch, randn):
        if op == "dB" and name == "unembed" and not has_trans:
            dc_t, a = operands
            run_k = (lambda a=a, dc=dc_t.t(): kg.grad_b(a, dc, bf16))
        held = []
        if k >= cs.LONG_K:
            held = [lambda got, run_p=run_p, run_exact=run_exact,
                    label=f"gemm[bwd] {op} {name}":
                    cs.hold_long_k(torch, label, run_exact)(got, run_p())]
        per = 1 if name == "unembed" else layers
        out.append(("gemm[bwd]", f"{op} {name} M={m} N={n} K={k} x{per}",
                    "bf16", run_k, run_p, run_lib,
                    (2 * (m * k + k * n + m * n), 2.0 * m * n * k), *held))
    return out


def int16_gemm_cases(torch, cs, gen):
    """The int16 engine GEMM (phase 6b's int16 instance) at the quickstart
    (1000 x 512 x 2048) and at every host-im2col GEMM of ResNet-50's stream
    with M > 16 (``chip_smoke.resnet50_shapes``), each on OS and on WS:
    bias, shift 10, ReLU, int16 out, operands as phase 6b draws them."""
    from repro_torch.core.config import Activation
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import gemm_ref

    i16 = torch.int16
    out = []
    shapes = [("quickstart", (1000, 512, 2048))] + [
        (f"resnet50 {lab}", mnk) for lab, mnk, _, _ in cs.resnet50_shapes()
        if mnk[0] > 16]
    for label, (m, n, k) in shapes:
        a, b, d, shift = cs.datapath_operands(torch, gen, i16, (m, k), (k, n),
                                              n)
        kw = dict(acc_dtype=torch.int32, out_dtype=i16, shift=shift,
                  activation=Activation.RELU)
        for kernel, fn in (("gemm[int16]", kg.gemm_os),
                           ("gemm_ws", kg.gemm_ws)):
            out.append((kernel, f"int16 {label} M={m} N={n} K={k}", "int16",
                        lambda a=a, b=b, d=d, kw=kw, fn=fn: fn(a, b, d, **kw),
                        lambda a=a, b=b, d=d, kw=kw: gemm_ref(a, b, d, **kw),
                        None, (2 * (m * k + k * n + m * n) + 4 * n,
                               2.0 * m * n * k)))
    return out


def fp16_gemm_cases(torch, cs, gen):
    """The fp16 engine GEMM (phase 6b's fp16 instance) on OS at the
    quickstart (1000 x 512 x 2048) and at every host-im2col GEMM of
    ResNet-50's stream that takes the wide kernel
    (``chip_smoke.resnet50_shapes``), and on WS at the quickstart: bias,
    shift 1, ReLU, operands as phase 6b draws them; ``torch.matmul`` (the
    product alone) beside each."""
    from repro_torch.core.config import Activation
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import gemm_ref

    f16 = torch.float16
    out = []
    shapes = [("quickstart", (1000, 512, 2048))] + [
        (f"resnet50 {lab}", mnk) for lab, mnk, _, _ in cs.resnet50_shapes()
        if mnk[0] > 16]
    for label, (m, n, k) in shapes:
        a, b, d, shift = cs.datapath_operands(torch, gen, f16, (m, k), (k, n),
                                              n)
        kw = dict(acc_dtype=torch.float32, out_dtype=f16, shift=shift,
                  activation=Activation.RELU)
        for kernel, fn in (("gemm[fp16]", kg.gemm_os),
                           ("gemm_ws", kg.gemm_ws)):
            if kernel == "gemm_ws" and label != "quickstart":
                continue
            out.append((kernel, f"fp16 {label} M={m} N={n} K={k}", "fp16",
                        lambda a=a, b=b, d=d, kw=kw, fn=fn: fn(a, b, d, **kw),
                        lambda a=a, b=b, d=d, kw=kw: gemm_ref(a, b, d, **kw),
                        lambda a=a, b=b: torch.matmul(a, b),
                        (2 * (m * k + k * n + m * n) + 4 * n,
                         2.0 * m * n * k)))
    return out


def attention_cases(torch):
    """(kernel, label, kind, run_kernel, run_plain, None, (bytes,
    operations) or None)."""
    from repro_torch import configs
    from repro_torch.examples import serve_decode as sd
    from repro_torch.kernels import attention as ka

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out = []
    for arch in sd.ARCHS:
        sc = configs.get_smoke(arch)
        if not sc.has_attn:
            continue
        t = max(sd.PROMPT_LENS) + sc.n_meta_tokens
        for window in (None, sc.local_window) if sc.local_window else (None,):
            q = randn(1, t, sc.n_heads, sc.head_dim, dtype=torch.float32)
            k, v = (randn(1, t, sc.n_kv_heads, sc.head_dim,
                          dtype=torch.float32) for _ in range(2))
            kw = dict(window=window, softcap=sc.attn_softcap)
            out.append(("flash_attention",
                        f"fp32 {arch} T={t} H={sc.n_heads} "
                        f"KVH={sc.n_kv_heads} D={sc.head_dim} window={window} "
                        f"softcap={sc.attn_softcap}", "fp32",
                        lambda q=q, k=k, v=v, kw=kw:
                            ka.flash_attention(q, k, v, **kw),
                        lambda q=q, k=k, v=v, kw=kw:
                            ka.blockwise_attention(q, k, v, **kw), None, None))
        # the gate's last continuation chunk of its longest prompt (page
        # 16, 24 pages, chunks of sd.PREFILL_CHUNK), as phase 3 runs it
        tc = sd.PREFILL_CHUNK
        start = t - tc
        kvp = -(-t // 16)
        kp, vp = (randn(sc.n_kv_heads, 25, 16, sc.head_dim,
                        dtype=torch.float32) for _ in range(2))
        tab = torch.randperm(24, generator=gen, device="cuda")[:kvp].to(
            torch.int32)
        qc = randn(1, tc, sc.n_heads, sc.head_dim, dtype=torch.float32)
        for window in (None, sc.local_window) if sc.local_window else (None,):
            kw = dict(window=window, softcap=sc.attn_softcap)
            out.append(("paged_prefill_attention",
                        f"fp32 {arch} T={tc} start={start} page=16 "
                        f"window={window} softcap={sc.attn_softcap}", "fp32",
                        lambda q=qc, k=kp, v=vp, tab=tab, s=start, kw=kw:
                            ka.paged_prefill_attention(q, k, v, tab, s, **kw),
                        lambda q=qc, k=kp, v=vp, tab=tab, s=start, kw=kw:
                            ka.paged_prefill_attention_plain(q, k, v, tab, s,
                                                             **kw),
                        None, None))

    # paged prefill at a 256-token continuation chunk at 768 (gemma3-1b:
    # global and window 512; hymba-1.5b: window 1024), and the dense flash
    # kernel on the same keys gathered beforehand
    g3, hy = configs.get("gemma3-1b"), configs.get("hymba-1.5b")
    page, n_pages, t, start = 64, 128, 256, 768
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    table = perm[:16].to(torch.int32)
    for arch, cfg, windows in (("gemma3-1b", g3, (None, g3.local_window)),
                               ("hymba-1.5b", hy, (hy.local_window,))):
        h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kp, vp = (randn(kvh, n_pages + 1, page, d) for _ in range(2))
        kg, vg = (ka._gather(x, table[None])[:, :start + t].contiguous()
                  for x in (kp, vp))
        qp = randn(1, t, h, d)
        for window in windows:
            pairs = sum(min(start + i + 1, window or 1 << 30)
                        for i in range(t))
            live = start + t if window is None else min(start + t,
                                                        window - 1 + t)
            work = (2 * (2 * t * h * d + 2 * live * kvh * d) + 4 * 16,
                    4.0 * d * h * pairs)
            label = f"{arch} T={t} start={start} window={window}"
            out.append(("paged_prefill_attention", label, "bf16",
                        lambda q=qp, k=kp, v=vp, w=window:
                            ka.paged_prefill_attention(q, k, v, table, start,
                                                       window=w),
                        lambda q=qp, k=kp, v=vp, w=window:
                            ka.paged_prefill_attention_plain(
                                q, k, v, table, start, window=w), None, work))
            out.append(("flash_attention", f"{label} dense gathered keys",
                        "bf16",
                        lambda q=qp, k=kg, v=vg, w=window:
                            ka.flash_attention(q, k, v, window=w),
                        lambda q=qp, k=kg, v=vg, w=window:
                            ka.blockwise_attention(q, k, v, window=w), None,
                        work))
    # fp32 at hymba-1.5b's widths: flash at its first chunk (256 cache
    # positions, as phase 8's fp32 logits run it) and paged prefill at its
    # 256-token continuation chunk at 768 (window 1024)
    h, kvh, d, window = hy.n_heads, hy.n_kv_heads, hy.head_dim, \
        hy.local_window
    f32 = torch.float32
    q32 = randn(1, 256, h, d, dtype=f32)
    k32, v32 = (randn(1, 256, kvh, d, dtype=f32) for _ in range(2))
    pairs = 256 * 257 // 2
    out.append(("flash_attention",
                f"fp32 hymba-1.5b T=256 H={h} KVH={kvh} D={d} "
                f"window={window}", "fp32",
                lambda w=window: ka.flash_attention(q32, k32, v32, window=w),
                lambda w=window: ka.blockwise_attention(q32, k32, v32,
                                                        window=w),
                None, (4 * (2 * 256 * h * d + 2 * 256 * kvh * d),
                       4.0 * d * h * pairs)))
    kp32, vp32 = (randn(kvh, n_pages + 1, page, d, dtype=f32)
                  for _ in range(2))
    qp32 = randn(1, t, h, d, dtype=f32)
    pairs = sum(min(start + i + 1, window) for i in range(t))
    live = min(start + t, window - 1 + t)
    out.append(("paged_prefill_attention",
                f"fp32 hymba-1.5b T={t} start={start} window={window}",
                "fp32",
                lambda s=start, w=window: ka.paged_prefill_attention(
                    qp32, kp32, vp32, table, s, window=w),
                lambda s=start, w=window: ka.paged_prefill_attention_plain(
                    qp32, kp32, vp32, table, s, window=w), None,
                (4 * (2 * t * h * d + 2 * live * kvh * d) + 4 * 16,
                 4.0 * d * h * pairs)))
    h, kvh, d = g3.n_heads, g3.n_kv_heads, g3.head_dim
    kp, vp = (randn(kvh, n_pages + 1, page, d) for _ in range(2))
    lengths = [1010, 530, 310, 80]
    tables = perm[:4 * 32].reshape(4, 32).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qd = randn(4, 1, h, d)
    for window in (None, g3.local_window):
        live = sum(min(n, window or 1 << 30) for n in lengths)
        work = (2 * (2 * 4 * h * d + 2 * live * kvh * d) + 4 * 4 * 33,
                4.0 * d * h * live)
        out.append(("paged_decode_attention",
                    f"lengths={lengths} window={window}", "bf16",
                    lambda w=window: ka.paged_decode_attention(
                        qd, kp, vp, tables, lens, window=w),
                    lambda w=window: ka.paged_decode_attention_plain(
                        qd, kp, vp, tables, lens, window=w), None, work))
    return out


def generic_attention_cases(torch):
    """Flash and paged prefill off the compiled instances (PERF.md's "any
    head dim" rows), at a 256-token causal chunk with 32 / 8 heads: flash
    at head dims 48, 80, 96 and 200 (bf16, fp16) and 320 (bf16, fp16,
    fp32) with SDPA beside each, fp32 flash at 200; paged prefill at 768
    over page-64 pools at 80, 96, 200 and 320 (bf16), fp32 at 200 and 320,
    and bf16 at 128 two elements off 16 bytes; where the checkout takes
    head dims past 512, flash and paged prefill at 640 in bf16 and fp32.
    Where the checkout holds the generic 16-bit kernel, it is also timed
    by a direct call at two compiled shapes the registry's models run on
    ``attention.cu`` (gemma3-1b's D=256, H=4 / KVH=1 and hymba-1.5b's
    D=64, H=25 / KVH=5) and at the aligned D=128 chunk (flash and paged
    prefill): information for later work, not a route."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as ka

    gen = torch.Generator(device="cuda").manual_seed(34)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    kind_of = {bf16: "bf16", f16: "fp16", f32: "fp32"}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, kvh, t, start, page, n_pages = 32, 8, 256, 768, 64, 128
    past_512 = hasattr(ka, "FLASH_HEAD_DIM_MAX")

    def randn(*shape, dtype=bf16, off=0):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if not off:
            return x
        buf = torch.empty(x.numel() + off, dtype=dtype, device="cuda")
        view = buf[off:].view(x.shape)
        view.copy_(x)
        return view

    out = []
    pairs = t * (t + 1) // 2
    flash = [(d, dt) for d in (48, 80, 96, 200) for dt in (bf16, f16)] + \
        [(200, f32)] + [(320, dt) for dt in (bf16, f16, f32)] + \
        ([(640, bf16), (640, f32)] if past_512 else [])
    for d, dt in flash:
        q = randn(1, t, h, d, dtype=dt)
        k, v = (randn(1, t, kvh, d, dtype=dt) for _ in range(2))
        es = q.element_size()
        out.append(("flash_attention", f"generic {kind_of[dt]} T={t} H={h} "
                    f"KVH={kvh} D={d}", kind_of[dt],
                    lambda q=q, k=k, v=v: ka.flash_attention(q, k, v),
                    lambda q=q, k=k, v=v: ka.blockwise_attention(q, k, v),
                    lambda q=q, k=k, v=v: sdpa(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=True, enable_gqa=True),
                    (es * (2 * t * h * d + 2 * t * kvh * d),
                     4.0 * d * h * pairs)))
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    table = perm[:16].to(torch.int32)
    ppairs = sum(start + i + 1 for i in range(t))
    prefill = [(d, bf16, 0) for d in (80, 96, 200, 320)] + \
        [(200, f32, 0), (320, f32, 0), (128, bf16, 2), (128, bf16, 1)] + \
        ([(640, bf16, 0), (640, f32, 0)] if past_512 else [])
    for d, dt, off in prefill:
        kp, vp = (randn(kvh, n_pages + 1, page, d, dtype=dt, off=off)
                  for _ in range(2))
        q = randn(1, t, h, d, dtype=dt, off=off)
        es = q.element_size()
        out.append(("paged_prefill_attention",
                    f"generic {kind_of[dt]} T={t} start={start} H={h} "
                    f"KVH={kvh} D={d}" + (f" offset={off}" if off else ""),
                    kind_of[dt],
                    lambda q=q, k=kp, v=vp: ka.paged_prefill_attention(
                        q, k, v, table, start),
                    lambda q=q, k=kp, v=vp: ka.paged_prefill_attention_plain(
                        q, k, v, table, start), None,
                    (es * (2 * t * h * d + 2 * (start + t) * kvh * d) + 64,
                     4.0 * d * h * ppairs)))
    if not (_build.CSRC / "attention_wg.cu").exists():
        return out
    # the aligned chunk at head dim 128 on the generic kernel: what the
    # rows off 16 bytes above cost against it
    pfn = _build.bind("attention_wg", "paged_prefill_launch",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 +
                      [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    kp, vp = (randn(kvh, n_pages + 1, page, 128) for _ in range(2))
    qp = randn(1, t, h, 128)

    def direct_prefill():
        o = torch.empty_like(qp)
        _build.check(pfn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                         table.data_ptr(), o.data_ptr(), t, start, h, kvh,
                         128, n_pages + 1, page, 0, 0.0, 128 ** -0.5, 1,
                         torch.cuda.current_stream().cuda_stream),
                     "paged_prefill_launch")
        return o
    out.append(("paged_prefill_attention[any] direct",
                f"aligned T={t} start={start} H={h} KVH={kvh} D=128", "bf16",
                direct_prefill,
                lambda: ka.paged_prefill_attention_plain(qp, kp, vp, table,
                                                         start), None,
                (2 * (2 * t * h * 128 + 2 * (start + t) * kvh * 128) + 64,
                 4.0 * 128 * h * ppairs)))
    fn = _build.bind("attention_wg", "flash_attention_launch",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 +
                     [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_int])
    for name, hh, kk, d in (("gemma3-1b", 4, 1, 256),
                            ("hymba-1.5b", 25, 5, 64),
                            ("aligned", h, kvh, 128)):
        q = randn(1, t, hh, d)
        k, v = (randn(1, t, kk, d) for _ in range(2))

        def direct(q=q, k=k, v=v, hh=hh, kk=kk, d=d):
            o = torch.empty_like(q)
            _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), 1, t, t, hh, kk, d, 1, 0, 0.0,
                            d ** -0.5, 1,
                            torch.cuda.current_stream().cuda_stream, 0, 0),
                         "flash_attention_launch")
            return o
        work = (2 * (2 * t * hh * d + 2 * t * kk * d), 4.0 * d * hh * pairs)
        label = f"{name} T={t} H={hh} KVH={kk} D={d}"
        out.append(("flash_attention[any] direct", label, "bf16", direct,
                    lambda q=q, k=k, v=v: ka.blockwise_attention(q, k, v),
                    None, work))
        out.append(("flash_attention", f"{label} compiled", "bf16",
                    lambda q=q, k=k, v=v: ka.flash_attention(q, k, v),
                    lambda q=q, k=k, v=v: ka.blockwise_attention(q, k, v),
                    None, work))
    return out


def ssd_cases(torch, cs):
    """The bf16 and fp16 chunked SSD (y held against the plain version)."""
    from repro_torch import configs
    from repro_torch.kernels import mamba2 as km

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        cfg = configs.get(arch)
        h, p, g, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
            cfg.d_state
        for (t, resume), kind in [(tr, k) for k in ("bf16", "fp16")
                                  for tr in ((256, True), (1000, False))]:
            io = torch.bfloat16 if kind == "bf16" else torch.float16

            def randn(*shape, scale=1.0, dtype=io):
                return (torch.randn(shape, generator=gen, device="cuda")
                        * scale).to(dtype)
            x = randn(1, t, h, p)
            b, c = randn(1, t, g, n, scale=0.3), randn(1, t, g, n, scale=0.3)
            dt = torch.nn.functional.softplus(randn(1, t, h,
                                                    dtype=torch.float32))
            a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
            kw = dict(d_skip=torch.ones((h,), device="cuda"),
                      chunk=cfg.ssm_chunk, return_final_state=True,
                      initial_state=randn(1, h, n, p, scale=0.5,
                                          dtype=torch.float32)
                      if resume else None)
            nbytes = (2 * 2 * t * h * p + 2 * 2 * t * g * n + 4 * t * h +
                      8 * h + 4 * h * n * p * (2 if resume else 1))
            out.append(("ssd" if kind == "bf16" else "ssd[fp16]",
                        f"{kind} {arch} T={t} "
                        f"{'resumed' if resume else 'fresh'}", kind,
                        lambda x=x, b=b, c=c, dt=dt, a=a_log, kw=kw:
                            km.ssd(x, dt, a, b, c, **kw)[0],
                        lambda x=x, b=b, c=c, dt=dt, a=a_log, kw=kw:
                            km.ssd_plain(x, dt, a, b, c, **kw)[0], None,
                        (nbytes, cs.ssd_flops(t, h, p, g, n, cfg.ssm_chunk,
                                              resume))))
    return out + ssd32_cases(torch, cs, gen)


def ssd32_cases(torch, cs, gen):
    """The fp32 chunked SSD at mamba2-1.3b's and hymba-1.5b's widths: T =
    256 fresh (phases 7-8's fp32 logits), 256 resumed and 1000 fresh (four
    launches); y and the final state held against the fp64 recurrence
    within ``fp32_tolerance`` (``chip_smoke.ssd32_check``)."""
    from repro_torch import configs
    from repro_torch.kernels import mamba2 as km

    f32 = torch.float32
    out = []
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        cfg = configs.get(arch)
        h, p, g, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
            cfg.d_state
        chunk = cfg.ssm_chunk
        for t, resume in ((256, False), (256, True), (1000, False)):
            def randn(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device="cuda",
                                   dtype=f32) * scale
            x = randn(1, t, h, p)
            b, c = randn(1, t, g, n, scale=0.3), randn(1, t, g, n, scale=0.3)
            dt = torch.nn.functional.softplus(randn(1, t, h))
            a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
            d_skip = torch.ones((h,), device="cuda")
            init = randn(1, h, n, p, scale=0.5) if resume else None
            kw = dict(d_skip=d_skip, chunk=chunk, initial_state=init,
                      return_final_state=True)
            label = f"fp32 {arch} T={t} {'resumed' if resume else 'fresh'}"
            nbytes = (4 * 2 * t * h * p + 4 * 2 * t * g * n + 4 * t * h +
                      8 * h + 4 * h * n * p * (2 if resume else 1))
            out.append(("ssd", label, "fp32",
                        lambda x=x, b=b, c=c, dt=dt, a=a_log, kw=kw:
                            km.ssd(x, dt, a, b, c, **kw),
                        lambda x=x, b=b, c=c, dt=dt, a=a_log, kw=kw:
                            km.ssd_plain(x, dt, a, b, c, **kw), None,
                        (nbytes, cs.ssd_flops(t, h, p, g, n, chunk, resume)),
                        lambda got, x=x, b=b, c=c, dt=dt, a=a_log, d=d_skip,
                        init=init, label=label, chunk=chunk:
                            cs.ssd32_check(torch, f"ssd {label}", got, x, dt,
                                           a, b, c, d, init, chunk)))
    return out


def convert_cases(torch, cs):
    """The operand conversion on each of its paths
    (``chip_smoke.convert_views``): int16 -> bf16 packed (1000, 2048), the
    same view one value into its buffer (the source off 16 bytes), general
    (the (1000, 8, 256) transpose), and the rows path on mamba2-1.3b's SSD
    x view, fp16 -> fp32; ``Tensor.to`` on the same view beside each, bit
    for bit against the plain version."""
    from repro_torch.kernels import datapath as kd
    from repro_torch.kernels import epilogue as epi

    gen = torch.Generator(device="cuda").manual_seed(0)
    i16, f16 = torch.int16, torch.float16
    buf = torch.randint(-2 ** 15, 2 ** 15, (2 * 1000 * 2048,), generator=gen,
                        device="cuda", dtype=i16)
    hbuf = (torch.randn((256 * 8512,), generator=gen, device="cuda") * 4
            ).to(f16)
    out = []
    for path, view in cs.convert_views(torch, buf, i16):
        src, dst = (view, torch.bfloat16) if path != "rows" else \
            (cs.convert_views(torch, hbuf, f16)[2][1], torch.float32)
        n = src.numel()
        es = src.element_size() + torch.empty((), dtype=dst).element_size()
        label = f"{str(src.dtype)[6:]} {tuple(src.shape)} -> " \
            f"{str(dst)[6:]} {path}"
        out.append(("convert", label, "bf16" if dst == torch.bfloat16
                    else "fp32",
                    lambda src=src, dst=dst: kd.convert(src, dst),
                    lambda src=src, dst=dst: epi.convert(src, dst),
                    lambda src=src, dst=dst: src.to(dst), (es * n, 0.0),
                    lambda got, src=src, dst=dst, label=label:
                        cs.bits_equal(torch, f"convert {label}")(
                            got, epi.convert(src, dst))))
    return out


def engine_cases(torch, cs):
    """The int8 engine kernels: the quickstart GEMM and every distinct
    layer of ResNet-50's stream as a GEMM (``chip_smoke.resnet50_shapes``),
    each on both dataflows with ``torch._int_mm`` (the product alone)
    beside the OS row where it takes the shape, and the conv kernel at
    every distinct conv of the stream. Bit-exact against the plain
    version."""
    from repro_torch.core.config import Activation
    from repro_torch.kernels import conv as kc
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import conv2d_ref, gemm_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    i8, i32 = torch.int8, torch.int32

    def rint(lo, hi, *shape, dtype=i8):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=dtype)

    kw = dict(acc_dtype=i32, out_dtype=i8, shift=7,
              activation=Activation.RELU)
    shapes = cs.resnet50_shapes()
    out = []
    for label, m, n, k in [("quickstart", 1000, 512, 2048)] + [
            (f"resnet50 {lab}", *mnk) for lab, mnk, _, _ in shapes]:
        a, b = rint(-128, 128, m, k), rint(-128, 128, k, n)
        bias = rint(-1000, 1000, 1, n, dtype=i32)
        lib = (lambda a=a, b=b: torch._int_mm(a, b)) \
            if m > 16 and k % 8 == 0 and n % 8 == 0 else None
        work = (m * k + k * n + 4 * n + m * n, 2.0 * m * n * k)
        for kernel, fn in (("gemm[int8]", kg.gemm_os),
                           ("gemm_ws", kg.gemm_ws)):
            out.append((kernel, f"{label} M={m} N={n} K={k}", "int",
                        lambda a=a, b=b, bias=bias, fn=fn: fn(a, b, bias,
                                                              **kw),
                        lambda a=a, b=b, bias=bias: gemm_ref(a, b, bias,
                                                             **kw),
                        lib if kernel == "gemm[int8]" else None, work))
    for label, _, (h, ci, co, kh, stride, pad), _ in shapes:
        if label == "classifier":
            continue
        x, w = rint(-64, 64, 1, h, h, ci), rint(-32, 32, kh, kh, ci, co)
        bias = rint(-500, 500, co, dtype=i32)
        oh = (h + 2 * pad - kh) // stride + 1
        ckw = dict(stride=stride, padding=pad, acc_dtype=i32, out_dtype=i8,
                   shift=8, activation=Activation.RELU)
        out.append(("conv2d_implicit",
                    f"{label} 1x{h}x{h}x{ci} -> {oh}x{oh}x{co}", "int",
                    lambda x=x, w=w, bias=bias, ckw=ckw:
                        kc.conv2d_implicit(x, w, bias, **ckw),
                    lambda x=x, w=w, bias=bias, ckw=ckw:
                        conv2d_ref(x, w, bias, **ckw), None,
                    (x.numel() + w.numel() + 4 * co + oh * oh * co,
                     2.0 * oh * oh * co * kh * kh * ci)))
    rows = []
    try:
        cs.datapath_cases(torch, gen, rows)
    except (AttributeError, NotImplementedError) as e:
        print(f"[time_kernels] no float / 16-bit datapath kernels in this "
              f"checkout ({type(e).__name__}: {e})", flush=True)
    return out + [(kernel, label, kind, run_k, run_p, run_lib,
                   (nbytes, flops))
                  for kernel, label, _, kind, run_k, run_p, run_lib, nbytes,
                  flops, *_ in rows]


def epilogue_cases(torch, cs):
    """The mvout epilogue at ``chip_smoke.epilogue_cases``' rows: its six
    datapaths at (1000, 512) and at a misaligned odd shape, and fp32 ->
    fp32 / fp16 at (3136, 256); and one run of four values, int32 ->
    int8, whose time is the launch and the timer's own (the floor under
    every row).
    Bit-exact or within ``check_close``'s rule."""
    from repro_torch.core.config import Activation
    from repro_torch.kernels import epilogue as epi
    from repro_torch.kernels import gemm as kg

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    cs.epilogue_cases(torch, gen, rows)
    tiny = torch.randint(-2 ** 31, 2 ** 31 - 1, (1, 4), generator=gen,
                         device="cuda", dtype=torch.int32)
    kw = dict(out_dtype=torch.int8, shift=7, activation=Activation.RELU)
    rows.append(("accumulator_epilogue", "int32 (1, 4) -> int8 shift=7 relu "
                 "(launch floor)", False, "int",
                 lambda: kg.accumulator_epilogue(tiny, **kw),
                 lambda: epi.apply(tiny, **kw), None, 20, 0.0))
    return [(kernel, label, kind, run_k, run_p, run_lib, (nbytes, flops))
            for kernel, label, _, kind, run_k, run_p, run_lib, nbytes,
            flops, *_ in rows]


def conv_cases(torch, cs):
    """The conv kernel on the fp32, bf16, fp16 and int16 datapaths at every
    distinct conv of ResNet-50's stream, the classifier's 1x1 over a 1x1
    image included (``chip_smoke.resnet50_shapes``; operands as phase 6b
    draws them, ``chip_smoke.datapath_operands``; bias, the instance's
    shift, ReLU), each beside cuDNN's ``conv2d`` on channels-last views
    where PyTorch has one (floats; fp32 with TF32 off) and with the plan
    of the checkout timed."""
    from repro_torch.core.config import Activation
    from repro_torch.kernels import conv as kc
    from repro_torch.kernels.ref import conv2d_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for kind, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                     ("fp16", torch.float16), ("int16", torch.int16)):
        for label, (m, n, k), (h, ci, co, kh, stride, pad), _ in \
                cs.resnet50_shapes():
            x, w, b, shift = cs.datapath_operands(
                torch, gen, dt, (1, h, h, ci), (kh, kh, ci, co), co)
            kw = dict(stride=stride, padding=pad,
                      acc_dtype=torch.float32 if dt.is_floating_point
                      else torch.int32, out_dtype=dt, shift=shift,
                      activation=Activation.RELU)
            lib = None
            if dt.is_floating_point:
                xl = x.permute(0, 3, 1, 2)
                wl = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                bl = b.to(dt)
                lib = (lambda xl=xl, wl=wl, bl=bl, stride=stride, pad=pad:
                       torch.nn.functional.conv2d(xl, wl, bl, stride=stride,
                                                  padding=pad))
            try:
                plan = cs.conv_plan_text(kc, m, n, k, dt)
            except (AttributeError, NotImplementedError) as e:
                plan = f"no plan ({type(e).__name__})"
            es = x.element_size()
            out.append((f"conv2d_implicit[{kind}]",
                        f"{label} 1x{h}x{h}x{ci} -> {m}x{co} plan {plan}",
                        kind, lambda x=x, w=w, b=b, kw=kw:
                            kc.conv2d_implicit(x, w, b, **kw),
                        lambda x=x, w=w, b=b, kw=kw: conv2d_ref(x, w, b,
                                                                **kw),
                        lib, (es * (x.numel() + w.numel() + m * co) + 4 * co,
                              2.0 * m * co * k)))
    return out


def conv_streams(torch, cs):
    """Device ms of ResNet-50's 50-layer stream on the fused route (the
    conv kernel on every layer) on phase 6b's four instances, and of
    cuDNN's ``conv2d`` on the same 49 convs (``chip_smoke.library_stream``;
    floats, TF32 off), both read as ``chip_smoke.py`` phase 6b reads
    them."""
    from repro_torch.core.generator import elaborate

    out = {}
    for name, cfg in cs.datapath_instances():
        inst = elaborate(cfg)
        shift = 1 if cfg.input_torch.is_floating_point else 10
        layers = cs.resnet50_layers(torch, seed=1, dtype=cfg.input_torch)

        def run():
            return [inst.conv2d(x, w, b, stride=st, padding=p, shift=shift,
                                activation=act, fused=True)
                    for _, x, w, b, st, p, act in layers]

        prof = cs.profile_call(torch, f"{name} fused", run, quiet=True)
        out[f"{name} fused conv kernel"] = {
            "device_ms": prof["device_ms"], "wall_ms": prof["wall_ms"],
            "device_ms_by_kernel": prof["device_ms_by_kernel"]}
        if cfg.input_torch.is_floating_point:
            convs, lib = cs.library_stream(torch, name, layers)
            out[f"{name} cuDNN conv2d, {convs} convs"] = {
                "device_ms": lib["device_ms"], "wall_ms": lib["wall_ms"],
                "device_ms_by_kernel": lib["device_ms_by_kernel"]}
    return out


def engine_streams(torch, cs):
    """Device ms of ResNet-50's 50-layer stream at batch 1 per route (host
    im2col + OS GEMM, host im2col + WS GEMM, fused conv), from
    ``torch.profiler`` device events as ``chip_smoke.py`` phases 6 and 6b
    read them (``profile_call``: mean of 3 passes): on the quickstart's
    int8 instance ("int8 <route>") and on each of phase 6b's instances
    ("<datapath> <route>"), where this checkout runs them."""
    from repro_torch.core.config import Dataflow
    from repro_torch.core.generator import elaborate
    from repro_torch.examples import quickstart

    routes = {"host im2col + OS GEMM": dict(fused=False, dataflow=Dataflow.OS),
              "host im2col + WS GEMM": dict(fused=False, dataflow=Dataflow.WS),
              "fused conv kernel": dict(fused=True)}
    streams = [("int8", quickstart.QUICKSTART_CFG, 8,
                cs.resnet50_layers(torch))]
    if hasattr(cs, "datapath_instances"):
        streams += [(name, cfg, 1 if cfg.input_torch.is_floating_point
                     else 10, cs.resnet50_layers(torch, seed=1,
                                                 dtype=cfg.input_torch))
                    for name, cfg in cs.datapath_instances()]
    out = {}
    for name, cfg, shift, layers in streams:
        inst = elaborate(cfg)
        for route, kw in routes.items():
            def run(kw=kw):
                return [inst.conv2d(x, w, b, stride=st, padding=p,
                                    shift=shift, activation=act, **kw)
                        for _, x, w, b, st, p, act in layers]
            try:
                run()
            except NotImplementedError as e:
                print(f"[time_kernels] {name} {route}: not in this checkout "
                      f"({e})", flush=True)
                continue
            prof = cs.profile_call(torch, f"{name} {route}", run, quiet=True)
            out[f"{name} {route}"] = {
                "device_ms": prof["device_ms"],
                "device_ms_by_kernel": prof["device_ms_by_kernel"],
                "wall_ms": prof["wall_ms"]}
    return out


def enqueue_us(torch, fn, n=50):
    """Host microseconds per call of ``fn`` launched back to back (the
    wrapper's own cost: argument checks, plan and workspace lookups, the
    launch), with the card busy behind it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--tag", default="", help="names the run in the output")
    ap.add_argument("--only", choices=("gemm", "attention", "ssd", "convert",
                                       "engine", "epilogue", "conv"),
                    help="time one group of kernels")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))     # _ssd_exact
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import configs
    from repro_torch.kernels import _build

    _build.build()
    timer = cs.Timer(torch)
    cases = []
    if args.only in (None, "gemm"):
        cases += gemm_cases(torch, cs)
    if args.only in (None, "attention"):
        cases += attention_cases(torch) + generic_attention_cases(torch)
    if args.only in (None, "ssd"):
        cases += ssd_cases(torch, cs)
    if args.only in (None, "convert"):
        cases += convert_cases(torch, cs)
    if args.only in (None, "engine"):
        cases += engine_cases(torch, cs)
    if args.only in (None, "epilogue"):
        cases += epilogue_cases(torch, cs)
    if args.only == "conv":
        cases += conv_cases(torch, cs)
    rows = []
    for kernel, label, kind, run_k, run_p, run_lib, work, *held in cases:
        # A timing tool reports a miss and goes on (``chip_smoke.py`` is the
        # gate): an older checkout's kernel is timed even where it misses.
        # ``held``: a check of the kernel's own (the fp32 SSD's, against
        # the fp64 recurrence) in place of the plain version's rule.
        try:
            err, check = (held[0](run_k()) if held else cs.check_close(
                torch, f"{kernel} {label}", run_k(), run_p(), kind)), "ok"
        except SystemExit:
            got, want = run_k(), run_p()
            if isinstance(got, tuple):
                got, want = got[0], want[0]
            err = (got.float() - want.float()).abs().max().item()
            check = "outside tolerance"
        row = {"kernel": kernel, "shape": label, "max_abs_err": err,
               "check": check, "ms": timer(run_k),
               "enqueue_us": enqueue_us(torch, run_k)}
        if kernel in ("gemm[int8]", "gemm_ws", "accumulator_epilogue",
                      "convert") or label.startswith("generic") or \
                kernel.startswith(("conv2d_implicit", "gemm[")):
            row["plain_ms"] = timer(run_p)
        if run_lib is not None:
            row["library_ms"] = timer(run_lib)
        if work is not None:
            row["bound_ms"] = cs.bound_ms(*work, kind)[0]
        rows.append(row)
        lib = f"  library {row['library_ms']:.4f} ms" if "library_ms" in row \
            else ""
        print(f"[time_kernels] {args.tag} {kernel:<24} {label:<60} "
              f"{row['ms']:.4f} ms{lib}  enqueue {row['enqueue_us']:.1f} us  "
              f"err {err:.2e} ({check})", flush=True)
    sums = cs.gemm_step_sums(
        [r for r in rows if r["kernel"] == "gemm" and r["shape"].split()[0]
         in ("wq", "wk", "wv", "wo", "wi", "wg", "mlp.wo", "unembed")],
        configs.get("gemma3-1b").n_layers)
    for m, sm in sorted(sums.items()):
        print(f"[time_kernels] {args.tag} gemm step sum M={m}: kernel "
              f"{sm['ms']:.4f} ms  torch.matmul {sm['library_ms']:.4f} ms",
              flush=True)
    bwd = {key: sum(int(r["shape"].rsplit("x", 1)[1]) * r[key]
                    for r in rows if r["kernel"] == "gemm[bwd]")
           for key in ("ms", "library_ms", "bound_ms")}
    if any(r["kernel"] == "gemm[bwd]" for r in rows):
        print(f"[time_kernels] {args.tag} gemm[bwd] step sum (366 "
              f"products): kernel {bwd['ms']:.4f} ms  torch.matmul "
              f"{bwd['library_ms']:.4f} ms  bound {bwd['bound_ms']:.4f} ms",
              flush=True)
    streams = engine_streams(torch, cs) if args.only in (None, "engine") \
        else conv_streams(torch, cs) if args.only == "conv" else {}
    for route, st in streams.items():
        print(f"[time_kernels] {args.tag} resnet50 stream, {route}: device "
              f"{st['device_ms']:.4f} ms (wall {st['wall_ms']:.3f} ms)",
              flush=True)
    print(json.dumps({"tag": args.tag, "device": torch.cuda.get_device_name(0),
                      "src": os.path.abspath(args.src), "rows": rows,
                      "gemm_step_sums": sums, "bwd_step_sum": bwd,
                      "engine_streams": streams}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
