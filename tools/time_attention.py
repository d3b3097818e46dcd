"""Device time of the attention kernels that the bf16 flash and dense decode
redesign leaves as they were: fp32 ``flash_attention`` at the fp32 gate's
prompts (the rows of ``chip_smoke.py`` phase 3) and the paged kernels at
gemma3-1b's serving shapes. It times the ``repro_torch`` package found
under ``--src``, so two checkouts compare on one card, run after run:

  python3 tools/time_attention.py --src OTHER_CHECKOUT/src --tag parent
  python3 tools/time_attention.py --tag change

Each output is held against its plain version (``chip_smoke.check_close``)
and timed with ``chip_smoke.Timer`` (CUDA events, L2 flushed, median of
25). Prints one JSON line ``{"tag", "device", "rows": [...]}``; needs a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cases(torch):
    """(kernel, label, kind, run_kernel, run_plain) at the timed shapes."""
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
                            ka.blockwise_attention(q, k, v, **kw)))

    g3 = configs.get("gemma3-1b")
    h, kvh, d, page, n_pages = g3.n_heads, g3.n_kv_heads, g3.head_dim, 64, 128
    kp, vp = (randn(kvh, n_pages + 1, page, d) for _ in range(2))
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    table = perm[:16].to(torch.int32)
    qp = randn(1, 256, h, d)
    out.append(("paged_prefill_attention", "T=256 start=768 global", "bf16",
                lambda: ka.paged_prefill_attention(qp, kp, vp, table, 768),
                lambda: ka.paged_prefill_attention_plain(qp, kp, vp, table,
                                                         768)))
    lengths = [1010, 530, 310, 80]
    tables = perm[:4 * 32].reshape(4, 32).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qd = randn(4, 1, h, d)
    out.append(("paged_decode_attention", f"lengths={lengths} global", "bf16",
                lambda: ka.paged_decode_attention(qd, kp, vp, tables, lens),
                lambda: ka.paged_decode_attention_plain(qd, kp, vp, tables,
                                                        lens)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--tag", default="", help="names the run in the output")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_attention: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build

    _build.build()
    timer = cs.Timer(torch)
    rows = []
    for kernel, label, kind, run_k, run_p in cases(torch):
        err = cs.check_close(torch, f"{kernel} {label}", run_k(), run_p(),
                             kind)
        rows.append({"kernel": kernel, "shape": label, "max_abs_err": err,
                     "ms": timer(run_k)})
        print(f"[time_attention] {args.tag} {kernel:<24} {label:<60} "
              f"{rows[-1]['ms']:.4f} ms  err {err:.2e}", flush=True)
    print(json.dumps({"tag": args.tag, "device": torch.cuda.get_device_name(0),
                      "src": os.path.abspath(args.src), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
