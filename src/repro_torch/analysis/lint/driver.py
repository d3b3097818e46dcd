"""Lint driver: every kernel contract over the tuner's schedule space at
probe problems from the port's own paths, plus the AST rules over the
kernel wrappers.

The probes (:func:`probes`) take each kernel family at the shapes its
path gives it and at shapes chosen to stress it:

* GEMM, each datapath (int8, int16, bf16, fp16, fp32): M = 4 (skinny),
  100 and 256 (wide) at N = 1000, K = 1100 (a ragged edge on every
  tile), with and without a bias, on OS and WS (and bf16 at M = 4 with B
  read transposed, the tied unembedding's layout);
* conv, each datapath: ResNet-50's stage-1 3x3, the 7x7/2 stem, and a
  ragged 1x15x15x24 -> 40 3x3 at stride 2;
* flash: 1 x 256 x 256, H 4 / KVH 1, D 256, causal; 2 x 100 x 300, H 8
  / KVH 2, D 64, window 128; 1 x 256 x 256, H 32 / KVH 8 at D 80 (the
  next instance's zero-filled columns) and 1 x 64 x 64 at D 20 (rows of
  no whole 16-byte words: the element-by-element loads), each dtype;
  fp32 at D 320 (the 512 instance);
* paged decode: 4 slots at 2048 context, every page size and keys per
  split of the space, and the kernel's own split at D 80 (and fp32 at
  D 320); paged prefill: a 256-token chunk at 768 and 100 tokens at 37,
  the chunk at D 80 with 32 / 8 heads (and fp32 at D 320); dense decode
  at gemma3-1b's and gemma3-4b's heads and at D 80 (fp32 D 320);
* SSD: mamba2-1.3b's P 64, N 128, 64 heads: T = 256 resumed and 1000
  fresh; its d_inner as 32 heads of P 128 at N 256, a 512-token chunk
  resumed (two column slices, two sub-chunks); P 10 (element-by-element
  rows and states), bf16 and fp32;
* the mvout epilogue at (1000, 512) and (999, 513) read 4 bytes past a
  16-byte boundary, every datapath.

Each family's space (:func:`gemm_plans` and the like) is the tuner's
(``tune/schedules.py``) widened by the plans just past each limit, so
the lint proves refusals as well as admissions: every tile code and
split count of the tuner's space appears, and the card (``card.py``)
holds the lint's verdict on each plan to the C plan function's.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.lint import checks, source
from repro_torch.analysis.lint.findings import Finding, dedupe
from repro_torch.kernels import contracts as kc

GEMM_DTYPES = ("int8", "int16", "bfloat16", "float16", "float32")
CONV_DTYPES = ("int8", "int16", "bfloat16", "float16", "float32")
GEMM_MS = (4, 100, 256)
GEMM_N, GEMM_K = 1000, 1100
# (n, h, w, ci, co, kh, kw, stride, padding)
CONV_PROBES = {"stage1-3x3": (1, 56, 56, 64, 64, 3, 3, 1, 1),
               "stem-7x7/2": (1, 224, 224, 3, 64, 7, 7, 2, 3),
               "ragged": (1, 15, 15, 24, 40, 3, 3, 2, 1)}
# (b, tq, tk, h, kvh, d, causal, window)
FLASH_PROBES = ((1, 256, 256, 4, 1, 256, True, 0),
                (2, 100, 300, 8, 2, 64, True, 128),
                (1, 256, 256, 32, 8, 80, True, 0),
                (1, 64, 64, 4, 2, 20, True, 0))
FLASH_F32_PROBES = ((1, 100, 100, 8, 2, 320, True, 0),)
PAGED_SLOTS, PAGED_CONTEXT, PAGED_HEADS = 4, 2048, (8, 2, 128)
# head dims of the paged decode's own plan at page 64 (fp32 only: 320)
PAGED_DIMS, PAGED_F32_DIMS = (80,), (320,)
# (tq, start, h, kvh, d, window)
PREFILL_PROBES = ((256, 768, 8, 2, 128, 0), (100, 37, 8, 2, 64, 32),
                  (256, 768, 32, 8, 80, 0))
PREFILL_F32_PROBES = ((100, 37, 8, 2, 320, 32),)
# (b, s, h, kvh, d, pos, window): gemma3-1b's heads and gemma3-4b's
DECODE_PROBES = ((4, 2048, 4, 1, 256, 1000, 512),
                 (4, 2048, 8, 4, 256, 2047, 0), (4, 2048, 8, 2, 80, 2047, 0))
DECODE_F32_PROBES = ((4, 2048, 8, 2, 320, 1000, 0),)
# (b, t, h, g, n, p, chunk, initial, final)
SSD_PROBES = ((2, 256, 64, 1, 128, 64, 256, True, True),
              (1, 1000, 64, 1, 128, 64, 256, False, True),
              (1, 600, 32, 1, 256, 128, 512, True, True),
              (1, 100, 4, 2, 64, 10, 64, True, True))
EPILOGUE_SHAPES = (((1000, 512), 0), ((999, 513), 4))
EPILOGUE_DTYPES = (("int32", "int8"), ("int32", "int16"),
                   ("int32", "int32"), ("float32", "float32"),
                   ("float32", "bfloat16"), ("float32", "float16"))


@dataclasses.dataclass(frozen=True)
class Probe:
    """One plan of one problem: the family (a contract builder's name),
    the builder's problem arguments and the schedule."""

    family: str
    problem: Tuple[Tuple[str, object], ...]
    sched: Tuple[Tuple[str, int], ...] = ()

    @property
    def kw(self) -> Dict[str, object]:
        return dict(self.problem)

    @property
    def schedule(self) -> Dict[str, int]:
        return dict(self.sched)

    @property
    def static(self) -> bool:
        return not any(v for _, v in self.sched)

    def contract(self, sms: int = kc.SMS) -> kc.LaunchContract:
        kw = {**self.kw, **self.schedule}
        if self.family in ("gemm", "gemm_s8", "conv2d_implicit",
                           "flash_attention", "paged_prefill_attention",
                           "accumulator_epilogue"):
            kw["sms"] = sms
        return kc.CONTRACT_BUILDERS[self.family](**kw)

    @property
    def inst(self) -> str:
        p = ",".join(f"{k}={v}" for k, v in self.problem)
        s = ",".join(f"{k}={v}" for k, v in self.sched)
        return f"{p};{s}"


# -- the schedule spaces, widened past each limit ---------------------------
def _tune_space(kind: str, dtype: str, **kw) -> List[Dict[str, int]]:
    import torch

    from repro_torch.tune import schedules
    td = getattr(torch, dtype)
    if kind == "gemm":
        return schedules.enumerate_gemm_schedules(
            td, kw["m"], kw["n"], kw["k"], kw.get("b_trans", False))
    return schedules.enumerate_conv_schedules(td, kw["m"], kw["n"], kw["k"])


def gemm_plans(dtype: str, m: int, n: int, k: int,
               b_trans: bool = False) -> List[Dict[str, int]]:
    """The tuner's space for the GEMM of ``dtype`` inputs, then every tile
    code of the kernel (the other regime's too) at one split past its
    most, and at the most splits the kernel merges plus one."""
    space = _tune_space("gemm", dtype, m=m, n=n, k=k, b_trans=b_trans)
    if dtype in ("int8", "int16"):
        codes, most = (1, 2), kc.IGEMM_MAX_SPLITS
    elif dtype == "float32":
        codes, most = (1, 2, 3), kc.SGEMM_MAX_SPLITS
    else:
        codes, most = (1, 2, 3, 4, 5, 6), kc.SK_MAX_SPLITS
    seen = {(s["tile"], s["splits"]) for s in space}
    for code in codes:
        top = max([s["splits"] for s in space if s["tile"] == code] or [0])
        for s in sorted({1, 2, top + 1, most + 1}):
            if (code, s) not in seen:
                seen.add((code, s))
                space.append({"tile": code, "splits": s})
    space.append({"tile": 0, "splits": 2})            # half a plan
    return space


def conv_plans(dtype: str, m: int, n: int, k: int) -> List[Dict[str, int]]:
    space = _tune_space("conv", dtype, m=m, n=n, k=k)
    seen = {(s["tile"], s["splits"]) for s in space}
    if dtype in ("float32", "int16"):
        extra = [(1, 2 * max(s["splits"] for s in space) or 2),
                 (1, kc.CC_MAX_SPLITS + 1), (2, 1)]
    else:
        extra = [(c, s) for c in (1, 2, 3)
                 for s in (1, kc.IGEMM_MAX_SPLITS + 1)]
    for t, s in extra:
        if (t, s) not in seen:
            seen.add((t, s))
            space.append({"tile": t, "splits": s})
    return space


def flash_plans(dtype: str, d: int) -> List[Dict[str, int]]:
    import torch

    from repro_torch.tune import schedules
    space = schedules.enumerate_attn_schedules(getattr(torch, dtype), d)
    return space + [{"cluster": 3, "stages": 1}, {"cluster": 8, "stages": 1},
                    {"cluster": 1, "stages": 3}]


def paged_plans(max_context: int) -> List[Tuple[int, int]]:
    from repro_torch.tune import schedules
    out = [(s.page_size, s.split_keys)
           for s in schedules.enumerate_paged_schedules(max_context)]
    return out + [(64, 8), (64, 24), (64, 8192)]


# -- the probes ---------------------------------------------------------------
def probes(families: Optional[Tuple[str, ...]] = None) -> Iterator[Probe]:
    def want(f):
        return families is None or f in families

    if want("gemm"):
        for dtype in GEMM_DTYPES:
            for m in GEMM_MS:
                fam = "gemm_s8" if dtype == "int8" else "gemm"
                trans = (False, True) if (dtype, m) == ("bfloat16", 4) \
                    else (False,)
                for b_trans in trans:
                    for sched in gemm_plans(dtype, m, GEMM_N, GEMM_K,
                                            b_trans):
                        for ws, bias in ((False, False), (True, True),
                                         (False, True), (True, False)):
                            prob = (("m", m), ("n", GEMM_N), ("k", GEMM_K),
                                    ("b_trans", b_trans), ("ws", ws),
                                    ("has_bias", bias))
                            if fam == "gemm":
                                prob = (("dtype", dtype),) + prob
                            yield Probe(fam, prob, tuple(sched.items()))
    if want("conv2d_implicit"):
        for dtype in CONV_DTYPES:
            for name, (n, h, w, ci, co, kh, kw, st, pad) in \
                    CONV_PROBES.items():
                oh = (h + 2 * pad - kh) // st + 1
                ow = (w + 2 * pad - kw) // st + 1
                for sched in conv_plans(dtype, n * oh * ow, co, kh * kw * ci):
                    yield Probe("conv2d_implicit", (
                        ("n", n), ("h", h), ("w", w), ("ci", ci), ("co", co),
                        ("kh", kh), ("kw", kw), ("stride", st),
                        ("padding", pad), ("dtype", dtype),
                        ("has_bias", name != "stem-7x7/2")),
                        tuple(sched.items()))
    if want("flash_attention"):
        for dtype in ("bfloat16", "float16", "float32"):
            for b, tq, tk, h, kvh, d, causal, win in FLASH_PROBES + (
                    FLASH_F32_PROBES if dtype == "float32" else ()):
                for sched in flash_plans(dtype, d):
                    yield Probe("flash_attention", (
                        ("b", b), ("tq", tq), ("tk", tk), ("h", h),
                        ("kvh", kvh), ("d", d), ("causal", causal),
                        ("window", win), ("dtype", dtype)),
                        tuple(sched.items()))
    if want("paged_decode_attention"):
        h, kvh, d = PAGED_HEADS
        for dtype in ("bfloat16", "float16", "float32"):
            for page, split in paged_plans(PAGED_CONTEXT):
                mp = -(-PAGED_CONTEXT // page)
                yield Probe("paged_decode_attention", (
                    ("slots", PAGED_SLOTS), ("max_pages", mp), ("page", page),
                    ("h", h), ("kvh", kvh), ("d", d),
                    ("n_pages", PAGED_SLOTS * mp + 1), ("window", 0),
                    ("dtype", dtype)), (("split_keys", split),))
            mp = PAGED_CONTEXT // 64
            for d_ in PAGED_DIMS + (PAGED_F32_DIMS if dtype == "float32"
                                    else ()):
                yield Probe("paged_decode_attention", (
                    ("slots", PAGED_SLOTS), ("max_pages", mp), ("page", 64),
                    ("h", h), ("kvh", kvh), ("d", d_),
                    ("n_pages", PAGED_SLOTS * mp + 1), ("window", 0),
                    ("dtype", dtype)), (("split_keys", 0),))
    if want("paged_prefill_attention"):
        for dtype in ("bfloat16", "float16", "float32"):
            for tq, start, h, kvh, d, win in PREFILL_PROBES + (
                    PREFILL_F32_PROBES if dtype == "float32" else ()):
                yield Probe("paged_prefill_attention", (
                    ("tq", tq), ("start", start), ("h", h), ("kvh", kvh),
                    ("d", d), ("window", win), ("dtype", dtype)))
    if want("decode_attention"):
        for dtype in ("bfloat16", "float16", "float32"):
            for b, s, h, kvh, d, pos, win in DECODE_PROBES + (
                    DECODE_F32_PROBES if dtype == "float32" else ()):
                yield Probe("decode_attention", (
                    ("b", b), ("s", s), ("h", h), ("kvh", kvh), ("d", d),
                    ("pos", pos), ("window", win), ("dtype", dtype)))
    if want("ssd"):
        for dtype in ("bfloat16", "float32"):
            for b, t, h, g, n, p, chunk, init, fin in SSD_PROBES:
                yield Probe("ssd", (
                    ("bsz", b), ("t", t), ("h", h), ("g", g), ("n", n),
                    ("p", p), ("chunk", chunk), ("dtype", dtype),
                    ("initial_state", init), ("final_state", fin)))
    if want("accumulator_epilogue"):
        for (rows, cols), off in EPILOGUE_SHAPES:
            for acc, out in EPILOGUE_DTYPES:
                yield Probe("accumulator_epilogue", (
                    ("count", rows * cols), ("acc_dtype", acc),
                    ("out_dtype", out), ("acc_offset", off),
                    ("out_offset", 0)))


FAMILIES = ("gemm", "conv2d_implicit", "flash_attention",
            "paged_decode_attention", "paged_prefill_attention",
            "decode_attention", "ssd", "accumulator_epilogue")


def verdicts(families=None) -> Iterator[
        Tuple[Probe, kc.LaunchContract, List[Finding]]]:
    """Each probe with its contract and findings."""
    for pr in probes(families):
        c = pr.contract()
        yield pr, c, checks.check_contract(c, inst=pr.inst)


def run_contract_checks(families=None) -> Tuple[List[Finding], Dict]:
    """The contract findings of every probe that the tuner's space holds
    (a refused plan outside it is the lint working, not a finding), and
    the counts: plans, admitted, refused, needing the card."""
    out: List[Finding] = []
    counts = {"plans": 0, "admitted": 0, "refused": 0, "needs_card": 0}
    for pr, c, fs in verdicts(families=families):
        counts["plans"] += 1
        errors = [f for f in fs if f.severity == "error"]
        counts["admitted" if not errors else "refused"] += 1
        counts["needs_card"] += bool(c.needs_card)
        if pr.static or _in_tuner_space(pr):
            out += fs
    return dedupe(out), counts


def _in_tuner_space(pr: Probe) -> bool:
    kw, s = pr.kw, pr.schedule
    if pr.family in ("gemm", "gemm_s8"):
        return s in _tune_space("gemm", kw.get("dtype", "int8"), m=kw["m"],
                                n=kw["n"], k=kw["k"], b_trans=kw["b_trans"])
    if pr.family == "conv2d_implicit":
        oh = (kw["h"] + 2 * kw["padding"] - kw["kh"]) // kw["stride"] + 1
        ow = (kw["w"] + 2 * kw["padding"] - kw["kw"]) // kw["stride"] + 1
        return s in _tune_space("conv", kw["dtype"], m=kw["n"] * oh * ow,
                                n=kw["co"], k=kw["kh"] * kw["kw"] * kw["ci"])
    if pr.family == "flash_attention":
        import torch

        from repro_torch.tune import schedules
        return s in schedules.enumerate_attn_schedules(
            getattr(torch, kw["dtype"]), kw["d"])
    if pr.family == "paged_decode_attention":
        return (kw["page"], s["split_keys"]) in \
            paged_plans(PAGED_CONTEXT)[:-3]
    return True


def _kernels_dir() -> Path:
    import repro_torch.kernels as pkg
    return Path(pkg.__file__).parent


def run_source_checks(kernels_dir: Optional[Path] = None) -> List[Finding]:
    kdir = Path(kernels_dir) if kernels_dir else _kernels_dir()
    return dedupe(source.check_kernel_files(sorted(kdir.glob("*.py"))))


def lint_repo_timed(kernels_dir: Optional[Path] = None
                    ) -> Tuple[List[Finding], Dict[str, float], Dict]:
    """The whole static suite, one timing per contract family and one for
    the source pass, and the plan counts."""
    timings: Dict[str, float] = {}
    out: List[Finding] = []
    counts: Dict[str, int] = {}
    for fam in FAMILIES:
        t0 = time.perf_counter()
        fs, c = run_contract_checks((fam, "gemm_s8") if fam == "gemm"
                                    else (fam,))
        out += fs
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        timings[f"contracts:{fam}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out += run_source_checks(kernels_dir)
    timings["source"] = time.perf_counter() - t0
    sev = {"error": 0, "warning": 1, "info": 2}
    out = sorted(out, key=lambda f: (sev[f.severity], f.code, f.site))
    return out, timings, counts


def lint_repo(kernels_dir: Optional[Path] = None) -> List[Finding]:
    return lint_repo_timed(kernels_dir)[0]
