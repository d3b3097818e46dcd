"""The launch contracts held to the card (``chip_smoke.py`` phase 17).

For every probe plan of the lint driver (``driver.probes``), on a CUDA
card:

(a) agreement: the lint admits the plan exactly when the C plan function
    accepts it (a plan that needs the card may go either way: each such
    refusal is logged), and for every accepted plan the contract's figures
    (blocks, threads, shared memory, workspace words, cluster and the rest
    of the C array) equal the C function's, field for field;
(b) registers: for every admitted plan, each ``ptxas -v`` entry of the
    kernel template its contract names (``kernel``, ``kernel_args``) uses,
    rounded to the allocation's 8, at most the registers a thread the
    contract's threads x ``min_blocks`` leave of the SM's 65,536
    (``LaunchContract.max_regs``);
(c) coverage and bounds: one launch writes an output laid in a buffer with
    a 4 KB guard band on each side, all filled with a sentinel (a NaN
    payload for floats, a bit pattern for ints); a second launch the same
    with another sentinel. No output element holds its launch's sentinel
    in both (an element no block wrote), the guard bands are untouched,
    and the output matches the plain version by phase 3's rules (int
    paths bit-exact);
(d) tickets: after a ``ticket`` plan, every ticket word of the stream's
    workspace is 0;
(e) fixed order: the two launches are bit-equal.

The launches go through the C entry points with the wrappers' argument
lists, into the wrappers' per-stream workspaces, so that the output can
lie between guard bands; a plan the C function refuses launches nothing.
"""

from __future__ import annotations

import ctypes
import re
import time
from typing import Dict, List, Optional

from repro_torch.analysis.lint import checks, driver
from repro_torch.kernels import contracts as kc

GUARD = 4096
_SENTINELS = {1: (0x5A, -0x5B), 2: (0x7FD1, -0x004D),
              4: (0x7FC0DEAD, -0x005F4111)}
_FLOAT_SENTINELS = {2: (0x7E01, -0x01FD)}        # fp16: its own NaNs


class CardFailure(AssertionError):
    pass


def _fail(msg):
    raise CardFailure(msg)


# ---------------------------------------------------------------------------
# the plain versions' comparison (chip_smoke's check_close rules)
# ---------------------------------------------------------------------------
def close(torch, name, got, want, kind) -> float:
    """bf16: 2^-7 relative plus 2^-14 of the largest magnitude; fp16:
    2^-10 and infinities in the same places; fp32: 1e-5 relative plus
    1e-6 of the largest magnitude; int: bit-exact."""
    if kind == "int":
        if got.dtype != want.dtype or got.shape != want.shape:
            _fail(f"{name}: {got.dtype} {tuple(got.shape)} != {want.dtype} "
                  f"{tuple(want.shape)}")
        err = (got.long() - want.long()).abs().max().item() \
            if got.numel() else 0
        if err:
            _fail(f"{name}: int kernel differs from the plain version by "
                  f"{err}")
        return 0.0
    g, w = got.float(), want.float()
    if kind == "fp16":
        inf = torch.isinf(w)
        if not torch.equal(torch.isinf(g), inf):
            _fail(f"{name}: infinities differ from the plain version's")
        g, w = g[~inf], w[~inf]
    if not torch.isfinite(g).all():
        _fail(f"{name}: non-finite kernel output")
    if g.numel() == 0:
        return 0.0
    err = (g - w).abs()
    scale = w.abs().max().item()
    rtol, atol = {"bf16": (2.0 ** -7, 2.0 ** -14 * scale),
                  "fp16": (2.0 ** -10, 2.0 ** -14 * scale)}.get(
                      kind, (1e-5, 1e-6 * scale))
    bad = err > rtol * w.abs() + atol
    if bad.any():
        _fail(f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
              f"tolerance, max abs err {err.max().item():.3e}")
    return err.max().item()


def _kind(dtype) -> str:
    name = kc._name(dtype)
    return {"bfloat16": "bf16", "float16": "fp16", "float32": "fp32"}.get(
        name, "int")


# ---------------------------------------------------------------------------
# guarded outputs
# ---------------------------------------------------------------------------
class Guarded:
    """An output of ``shape`` and ``dtype`` between two guard bands of
    GUARD bytes, everything filled with a sentinel."""

    def __init__(self, torch, shape, dtype, device):
        self.torch = torch
        n = 1
        for s in shape:
            n *= s
        self.es = torch.empty((), dtype=dtype).element_size()
        self.nbytes = n * self.es
        self.buf = torch.empty(2 * GUARD + self.nbytes, dtype=torch.uint8,
                               device=device)
        self.bits = self.buf.view({1: torch.int8, 2: torch.int16,
                                   4: torch.int32}[self.es])
        self.out = self.buf[GUARD:GUARD + self.nbytes].view(dtype).view(
            shape)
        self.float16 = dtype == torch.float16

    def fill(self, which: int) -> int:
        table = _FLOAT_SENTINELS if self.float16 else _SENTINELS
        s = table.get(self.es, _SENTINELS[self.es])[which]
        self.bits.fill_(s)
        return s

    def check(self, name, sentinel) -> None:
        torch = self.torch
        g = GUARD // self.es
        edges = torch.cat([self.bits[:g], self.bits[len(self.bits) - g:]])
        if not bool((edges == sentinel).all()):
            _fail(f"{name}: a guard band beside the output was written")

    def body_bits(self):
        g = GUARD // self.es
        return self.bits[g:len(self.bits) - g].clone()


# ---------------------------------------------------------------------------
# the C plan functions, raw
# ---------------------------------------------------------------------------
_I, _P, _L = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong


def _raw(lib, fn, argtypes, args, n):
    from repro_torch.kernels import _build
    out = (ctypes.c_longlong * n)()
    f = _build.bind(lib, fn, argtypes + [_P])
    rc = f(*args, ctypes.addressof(out))
    return rc, list(out)


def _conv_mnk(kw):
    oh = (kw["h"] + 2 * kw["padding"] - kw["kh"]) // kw["stride"] + 1
    ow = (kw["w"] + 2 * kw["padding"] - kw["kw"]) // kw["stride"] + 1
    return kw["n"] * oh * ow, kw["co"], kw["kh"] * kw["kw"] * kw["ci"], \
        oh, ow


_SPLIT_KEYS = ("splits", "groups", "rep", "split_keys", "partial_words")


def _wrapped(plan_fn):
    """A wrapper's plan function: (0, its dict), or (1, {}) where the C
    entry refused (``_build.check`` raised)."""
    try:
        return 0, plan_fn()
    except RuntimeError:
        return 1, {}


def c_plan(torch, pr: driver.Probe):
    """(return code, the C array as a dict with the contract's plan keys)."""
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import conv as kconv
    from repro_torch.kernels import gemm as kg
    kw, s = pr.kw, pr.schedule
    if pr.family == "gemm_s8":
        rc, raw = _raw("gemm", "gemm_s8_plan", [_I] * 6,
                       (kw["m"], kw["n"], kw["k"], int(kw["b_trans"]),
                        s["tile"], s["splits"]), 11)
        keys = kg._PLAN_KEYS
    elif pr.family == "gemm":
        dt = getattr(torch, kw["dtype"])
        rc, raw = _raw("gemm", "gemm_plan", [_I] * 7,
                       (kw["m"], kw["n"], kw["k"], int(kw["b_trans"]),
                        kg._PLAN_DT[dt], s["tile"], s["splits"]), 11)
        keys = kg._PLAN_KEYS
    elif pr.family == "conv2d_implicit":
        m, n, k, _, _ = _conv_mnk(kw)
        rc, raw = _raw("conv", "conv_plan", [_I] * 6,
                       (m, n, k, kconv._IN[getattr(torch, kw["dtype"])],
                        s["tile"], s["splits"]), 11)
        keys = kg._PLAN_KEYS
    elif pr.family == "flash_attention":
        return _wrapped(lambda: ka.flash_plan(
            kw["b"], kw["tq"], kw["tk"], kw["h"], kw["kvh"], kw["d"],
            causal=kw["causal"], window=kw["window"],
            dtype=getattr(torch, kw["dtype"]), plan=s))
    elif pr.family == "paged_prefill_attention":
        return _wrapped(lambda: ka.paged_prefill_plan(
            kw["tq"], kw["start"], kw["h"], kw["kvh"], kw["d"], kw["window"],
            dtype=getattr(torch, kw["dtype"])))
    elif pr.family == "paged_decode_attention":
        return _wrapped(lambda: dict(zip(_SPLIT_KEYS, ka.paged_decode_plan(
            kw["slots"], kw["max_pages"], kw["page"], kw["h"], kw["kvh"],
            kw["d"], kw["window"], split_keys=s["split_keys"]))))
    elif pr.family == "decode_attention":
        return _wrapped(lambda: dict(zip(_SPLIT_KEYS, ka.decode_plan(
            kw["b"], kw["s"], kw["h"], kw["kvh"], kw["d"], kw["pos"],
            kw["window"]))))
    elif pr.family == "ssd":
        from repro_torch.kernels import mamba2 as km
        return _wrapped(lambda: km.ssd_plan(
            kw["bsz"], kw["t"], kw["h"], kw["g"], kw["n"], kw["p"],
            min(kw["chunk"], kw["t"]), getattr(torch, kw["dtype"]),
            kw["final_state"]))
    elif pr.family == "accumulator_epilogue":
        return _wrapped(lambda: kg.epilogue_plan(
            kw["count"], getattr(torch, kw["acc_dtype"]),
            getattr(torch, kw["out_dtype"]), kw["acc_offset"],
            kw["out_offset"]))
    else:
        raise ValueError(pr.family)
    return rc, dict(zip(keys, raw))


# ---------------------------------------------------------------------------
# (b) registers from the build logs
# ---------------------------------------------------------------------------
def ptxas_entries(logs: Dict[str, str]) -> List[tuple]:
    """(source, mangled name, registers a thread) of every kernel entry of
    the build logs that reports its registers."""
    out = []
    for src, text in logs.items():
        lines = text.splitlines()
        for i, ln in enumerate(lines):
            m = re.search(r"entry function '([^']+)'", ln)
            r = m and re.search(r"Used (\d+) registers",
                                " ".join(lines[i + 1:i + 4]))
            if r:
                out.append((src, m.group(1), int(r.group(1))))
    return out


def template_ints(mangled: str, kernel: str) -> Optional[tuple]:
    """The int / bool template arguments, in order, of ``mangled`` if it
    instantiates ``kernel`` ("ns::name"), else None."""
    sym = "".join(f"{len(p)}{p}" for p in kernel.split("::")) + "I"
    i = mangled.find(sym)
    if i < 0:
        return None
    return tuple(int(v.replace("n", "-")) for v in
                 re.findall(r"L[a-z](n?\d+)E", mangled[i + len(sym):]))


def check_registers(logs: Dict[str, str], contracts, log=print) -> Dict:
    """Each contract's kernel instantiations in the build logs: rounded
    registers a thread within the contract's ``max_regs``. A contract
    whose kernel has no entry fails (its name or arguments went stale)."""
    entries = ptxas_entries(logs)
    if not entries:
        _fail("no kernel entry with a register count in the build logs")
    strictest: Dict[tuple, object] = {}
    for c in contracts:
        key = (c.kernel, c.kernel_args)
        if key not in strictest or c.max_regs < strictest[key].max_regs:
            strictest[key] = c
    matched = set()
    worst = 0.0
    for (kernel, args), c in strictest.items():
        hits = [e for e in entries
                if (t := template_ints(e[1], kernel)) is not None
                and t[:len(args)] == args]
        if not hits:
            _fail(f"{c.name}: no ptxas entry instantiates {kernel} with "
                  f"leading template arguments {args}")
        for src, name, regs in hits:
            rounded = -(-regs // 8) * 8
            if rounded > c.max_regs:
                _fail(f"{src}: {name} uses {regs} registers a thread, more "
                      f"than the {c.max_regs} its contract's {c.threads} "
                      f"threads x {c.min_blocks} blocks an SM leave")
            worst = max(worst, rounded / c.max_regs)
            matched.add(name)
    log(f"registers: {len(matched)} kernel entries of {len(strictest)} "
        f"contract kernels fit their contracts (largest share of "
        f"max_regs {worst:.3f}); {len(entries) - len(matched)} entries no "
        f"admitted plan launches")
    return {"entries": len(matched), "kernels": len(strictest),
            "unlaunched": len(entries) - len(matched)}


# ---------------------------------------------------------------------------
# (c)-(e) launches
# ---------------------------------------------------------------------------
class Launcher:
    """Inputs per problem (made once from a seed), the plain version's
    output, and the launch of one plan into a guarded output."""

    def __init__(self, torch, device, ssd_exact=None, close_fn=None):
        self.torch = torch
        self.dev = device
        self.gen = torch.Generator(device=device).manual_seed(17)
        self.cache: Dict[tuple, dict] = {}
        self.ssd_exact = ssd_exact
        self.close = close_fn or (lambda name, got, want, kind:
                                  close(torch, name, got, want, kind))
        self.stream = torch.cuda.current_stream(device).cuda_stream \
            if device.type == "cuda" else 0

    def randn(self, *shape, dtype=None, scale=1.0):
        t = self.torch.randn(shape, generator=self.gen, device=self.dev)
        return (t * scale).to(dtype or self.torch.float32)

    def randint(self, lo, hi, *shape, dtype):
        return self.torch.randint(lo, hi, shape, generator=self.gen,
                                  device=self.dev).to(dtype)

    def operand(self, dtype, *shape):
        torch = self.torch
        if dtype == torch.int8:
            return self.randint(-128, 128, *shape, dtype=dtype)
        if dtype == torch.int16:
            return self.randint(-300, 300, *shape, dtype=dtype)
        return self.randn(*shape, dtype=dtype)

    # each returns (outputs: list of (name, Guarded, plain, kind),
    # launch(): rc, tickets(): tensor or None)
    def run(self, pr: driver.Probe, contract):
        return getattr(self, "_" + pr.family)(pr, contract)

    def _gemm_like(self, pr, c):
        torch = self.torch
        from repro_torch.kernels import gemm as kg
        from repro_torch.kernels.ref import gemm_ref
        kw, s = pr.kw, pr.schedule
        dt = torch.int8 if pr.family == "gemm_s8" else getattr(torch,
                                                              kw["dtype"])
        m, n, k = kw["m"], kw["n"], kw["k"]
        key = ("gemm", dt, m, n, k, kw["b_trans"], kw["has_bias"])
        if key not in self.cache:
            a = self.operand(dt, m, k)
            bb = self.operand(dt, n, k) if kw["b_trans"] else \
                self.operand(dt, k, n)
            b = bb.t() if kw["b_trans"] else bb
            acc = torch.int32 if dt in (torch.int8, torch.int16) else \
                torch.float32
            d = (self.randint(-5000, 5000, n, dtype=acc) if acc == torch.int32
                 else self.randn(n)) if kw["has_bias"] else None
            want = gemm_ref(a, b, d, acc_dtype=acc, out_dtype=dt)
            self.cache[key] = dict(a=a, bb=bb, d=d, want=want, acc=acc)
        e = self.cache[key]
        out = Guarded(torch, (m, n), dt, self.dev)
        need = c.workspace_words * 4
        wsp = kg._workspace(self.dev, self.stream, need) if need else None
        ldb = e["bb"].stride(0)
        dptr = e["d"].data_ptr() if e["d"] is not None else None
        args_common = (e["a"].data_ptr(), e["bb"].data_ptr(), dptr,
                       out.out.data_ptr(), m, n, k, e["a"].stride(0), ldb,
                       int(kw["b_trans"]), 0)

        def launch():
            w = wsp.data_ptr() if wsp is not None else None
            if dt in (torch.int8, torch.int16):
                lib, fn = kg._INT_IN[dt]
                f = _bind(lib, fn, kg._S8_ARGS)
                return f(*args_common, kg._INT_OUT[dt], 0, 0,
                         int(kw["ws"]), self.stream, w, s["tile"],
                         s["splits"])
            if dt == torch.float16:
                f = _bind("gemm16", "gemm_f16_launch", kg._F16_ARGS)
                return f(*args_common, kg._DT[dt], 0, 1.0, int(kw["ws"]),
                         self.stream, w, s["tile"], s["splits"])
            f = _bind("gemm", "gemm_launch", kg._FLOAT_ARGS)
            return f(*args_common, kg._DT[dt], kg._DT[dt], 0, 1.0,
                     int(kw["ws"]), self.stream, w, s["tile"], s["splits"])

        def tickets():
            return wsp[:kc.MAX_TICKETS] if wsp is not None else None
        return [("c", out, e["want"], _kind(dt))], launch, tickets

    _gemm = _gemm_s8 = _gemm_like

    def _conv2d_implicit(self, pr, c):
        torch = self.torch
        from repro_torch.kernels import conv as kconv
        from repro_torch.kernels import gemm as kg
        from repro_torch.kernels.ref import conv2d_ref
        kw, s = pr.kw, pr.schedule
        dt = getattr(torch, kw["dtype"])
        m, n, k, oh, ow = _conv_mnk(kw)
        key = ("conv", pr.problem)
        acc = kconv._ACC[dt]
        if key not in self.cache:
            x = self.operand(dt, kw["n"], kw["h"], kw["w"], kw["ci"])
            w = self.operand(dt, kw["kh"], kw["kw"], kw["ci"], kw["co"])
            b = (self.randint(-5000, 5000, kw["co"], dtype=acc)
                 if acc == torch.int32 else self.randn(kw["co"])) \
                if kw["has_bias"] else None
            want = conv2d_ref(x, w, b, stride=kw["stride"],
                              padding=kw["padding"], acc_dtype=acc,
                              out_dtype=dt)
            self.cache[key] = dict(x=x, w=w, b=b, want=want)
        e = self.cache[key]
        out = Guarded(torch, (kw["n"], oh, ow, kw["co"]), dt, self.dev)
        need = c.workspace_words * 4
        wsp = kg._workspace(self.dev, self.stream, need) if need else None
        outs = kg._INT_OUT if acc == torch.int32 else kg._DT

        def launch():
            f = _bind("conv", "conv2d_launch", kconv._ARGS)
            return f(e["x"].data_ptr(), e["w"].data_ptr(),
                     e["b"].data_ptr() if e["b"] is not None else None,
                     out.out.data_ptr(), kw["n"], kw["h"], kw["w"], kw["ci"],
                     kw["co"], kw["kh"], kw["kw"], kw["stride"],
                     kw["padding"], oh, ow, kconv._IN[dt], outs[dt], 0, 0,
                     1.0, self.stream,
                     wsp.data_ptr() if wsp is not None else None, s["tile"],
                     s["splits"])

        def tickets():
            return wsp[:kc.MAX_TICKETS] if wsp is not None else None
        return [("y", out, e["want"], _kind(dt))], launch, tickets

    def _flash_attention(self, pr, c):
        torch = self.torch
        from repro_torch.kernels import attention as ka
        kw, s = pr.kw, pr.schedule
        dt = getattr(torch, kw["dtype"])
        key = ("flash", pr.problem)
        if key not in self.cache:
            q = self.randn(kw["b"], kw["tq"], kw["h"], kw["d"], dtype=dt)
            k = self.randn(kw["b"], kw["tk"], kw["kvh"], kw["d"], dtype=dt)
            v = self.randn(kw["b"], kw["tk"], kw["kvh"], kw["d"], dtype=dt)
            want = ka.blockwise_attention(q, k, v, causal=kw["causal"],
                                          window=kw["window"] or None,
                                          softcap=30.0 if kw["window"]
                                          else None)
            self.cache[key] = dict(q=q, k=k, v=v, want=want)
        e = self.cache[key]
        out = Guarded(torch, tuple(e["q"].shape), dt, self.dev)

        def launch():
            f = _bind(ka.kernel_lib(kw["d"], e["q"], e["k"], e["v"]),
                      "flash_attention_launch",
                      [_P, _P, _P, _P] + [_I] * 8 + [ctypes.c_float] * 2 +
                      [_I, _P, _I, _I])
            return f(e["q"].data_ptr(), e["k"].data_ptr(), e["v"].data_ptr(),
                     out.out.data_ptr(), kw["b"], kw["tq"], kw["tk"], kw["h"],
                     kw["kvh"], kw["d"], int(kw["causal"]), kw["window"],
                     30.0 if kw["window"] else 0.0, kw["d"] ** -0.5,
                     ka._DT[dt], self.stream, s["cluster"], s["stages"])
        return [("o", out, e["want"], _kind(dt))], launch, lambda: None

    def _pools(self, dt, kvh, npool, page, d, lens, mp):
        torch = self.torch
        pk = torch.full((kvh, npool, page, d), float("nan"), device=self.dev)
        pv = torch.full((kvh, npool, page, d), float("nan"), device=self.dev)
        tables = torch.zeros((len(lens), mp), dtype=torch.int32)
        perm = torch.randperm(npool, generator=torch.Generator().manual_seed(
            npool)).tolist()
        for b, n in enumerate(lens):
            for j in range(-(-n // page)):
                pid = perm.pop()
                tables[b, j] = pid
                pk[:, pid] = self.randn(kvh, page, d)
                pv[:, pid] = self.randn(kvh, page, d)
        return pk.to(dt), pv.to(dt), tables.to(self.dev)

    def _paged_decode_attention(self, pr, c):
        torch = self.torch
        from repro_torch.kernels import attention as ka
        kw, s = pr.kw, pr.schedule
        dt = getattr(torch, kw["dtype"])
        key = ("paged", kw["page"], kw["dtype"], kw["d"])
        lens = [kw["max_pages"] * kw["page"], 1000, 17, 1][:kw["slots"]]
        if key not in self.cache:
            pk, pv, tables = self._pools(dt, kw["kvh"], kw["n_pages"],
                                         kw["page"], kw["d"], lens,
                                         kw["max_pages"])
            q = self.randn(kw["slots"], 1, kw["h"], kw["d"], dtype=dt)
            ln = torch.tensor(lens, dtype=torch.int32, device=self.dev)
            want = ka.paged_decode_attention_plain(q, pk, pv, tables, ln)
            self.cache[key] = dict(q=q, pk=pk, pv=pv, tables=tables, ln=ln,
                                   want=want)
        e = self.cache[key]
        out = Guarded(torch, tuple(e["q"].shape), dt, self.dev)
        plan = c.plan_dict()
        tk, part = ka._workspace(self.dev, self.stream, plan["groups"],
                                 plan["partial_words"])

        def launch():
            f = _bind(ka.kernel_lib(kw["d"], e["q"], e["pk"], e["pv"],
                                    decode=True), "paged_decode_launch",
                      [_P] * 6 + [_I] * 8 + [ctypes.c_float] * 2 +
                      [_I, _P, _P, _P, _I])
            return f(e["q"].data_ptr(), e["pk"].data_ptr(),
                     e["pv"].data_ptr(), e["tables"].data_ptr(),
                     e["ln"].data_ptr(), out.out.data_ptr(), kw["slots"],
                     kw["max_pages"], kw["h"], kw["kvh"], kw["d"],
                     kw["n_pages"], kw["page"], kw["window"], 0.0,
                     kw["d"] ** -0.5, ka._DT[dt], self.stream,
                     part.data_ptr(), tk.data_ptr(), s["split_keys"])
        return [("o", out, e["want"], _kind(dt))], launch, \
            lambda: tk[:plan["groups"]]

    def _paged_prefill_attention(self, pr, c):
        torch = self.torch
        from repro_torch.kernels import attention as ka
        kw = pr.kw
        dt = getattr(torch, kw["dtype"])
        page = 16
        total = kw["start"] + kw["tq"]
        mp = -(-total // page)
        key = ("prefill", pr.problem)
        if key not in self.cache:
            npool = mp + 3
            pk, pv, tables = self._pools(dt, kw["kvh"], npool, page, kw["d"],
                                         [total], mp)
            q = self.randn(1, kw["tq"], kw["h"], kw["d"], dtype=dt)
            table = tables[0].contiguous()
            want = ka.paged_prefill_attention_plain(
                q, pk, pv, table, kw["start"], window=kw["window"] or None)
            self.cache[key] = dict(q=q, pk=pk, pv=pv, table=table,
                                   npool=npool, want=want)
        e = self.cache[key]
        out = Guarded(torch, tuple(e["q"].shape), dt, self.dev)

        def launch():
            f = _bind(ka.kernel_lib(kw["d"], e["q"], e["pk"], e["pv"]),
                      "paged_prefill_launch",
                      [_P] * 5 + [_I] * 8 + [ctypes.c_float] * 2 + [_I, _P])
            return f(e["q"].data_ptr(), e["pk"].data_ptr(),
                     e["pv"].data_ptr(), e["table"].data_ptr(),
                     out.out.data_ptr(), kw["tq"], kw["start"], kw["h"],
                     kw["kvh"], kw["d"], e["npool"], page, kw["window"], 0.0,
                     kw["d"] ** -0.5, ka._DT[dt], self.stream)
        return [("o", out, e["want"], _kind(dt))], launch, lambda: None

    def _decode_attention(self, pr, c):
        torch = self.torch
        from repro_torch.kernels import attention as ka
        kw = pr.kw
        dt = getattr(torch, kw["dtype"])
        key = ("decode", pr.problem)
        if key not in self.cache:
            q = self.randn(kw["b"], 1, kw["h"], kw["d"], dtype=dt)
            k = self.randn(kw["b"], kw["s"], kw["kvh"], kw["d"], dtype=dt)
            v = self.randn(kw["b"], kw["s"], kw["kvh"], kw["d"], dtype=dt)
            want = ka.decode_attention_plain(q, k, v, kw["pos"],
                                             window=kw["window"] or None)
            self.cache[key] = dict(q=q, k=k, v=v, want=want)
        e = self.cache[key]
        out = Guarded(torch, tuple(e["q"].shape), dt, self.dev)
        plan = c.plan_dict()
        tk, part = ka._workspace(self.dev, self.stream, plan["groups"],
                                 plan["partial_words"])

        def launch():
            f = _bind(ka.kernel_lib(kw["d"], e["q"], e["k"], e["v"],
                                    decode=True), "decode_attention_launch",
                      [_P] * 4 + [_I] * 7 + [ctypes.c_float] * 2 +
                      [_I, _P, _P, _P])
            return f(e["q"].data_ptr(), e["k"].data_ptr(), e["v"].data_ptr(),
                     out.out.data_ptr(), kw["b"], kw["s"], kw["h"], kw["kvh"],
                     kw["d"], kw["pos"], kw["window"], 0.0, kw["d"] ** -0.5,
                     ka._DT[dt], self.stream, part.data_ptr(), tk.data_ptr())
        return [("o", out, e["want"], _kind(dt))], launch, \
            lambda: tk[:plan["groups"]]

    def _ssd(self, pr, c):
        torch = self.torch
        from repro_torch.kernels import mamba2 as km
        kw = pr.kw
        dt = getattr(torch, kw["dtype"])
        f32 = torch.float32
        b_, t, h, g, n, p = (kw["bsz"], kw["t"], kw["h"], kw["g"], kw["n"],
                             kw["p"])
        chunk = min(kw["chunk"], t)
        sub = km.launch_chunk(chunk, t)      # one launch's rows
        key = ("ssd", pr.problem)
        if key not in self.cache:
            x = self.randn(b_, t, h, p, dtype=dt)
            bm = self.randn(b_, t, g, n, dtype=dt, scale=0.3)
            cm = self.randn(b_, t, g, n, dtype=dt, scale=0.3)
            dtv = torch.nn.functional.softplus(self.randn(b_, t, h))
            a_log = torch.log(torch.linspace(1.0, 16.0, h, device=self.dev))
            d_skip = torch.ones((h,), dtype=f32, device=self.dev)
            init = self.randn(b_, h, n, p, scale=0.5) \
                if kw["initial_state"] else None
            exact_y, exact_s = self.ssd_exact[0](
                x, dtv, a_log, bm, cm, d_skip=d_skip, initial_state=init)
            tol = self.ssd_exact[1](dtv, a_log, chunk)
            plain_y = km.ssd_plain(x, dtv, a_log, bm, cm, d_skip=d_skip,
                                   chunk=chunk, initial_state=init)
            self.cache[key] = dict(x=x, b=bm, c=cm, dt=dtv, a_log=a_log,
                                   d=d_skip, init=init, exact_y=exact_y,
                                   exact_s=exact_s, tol=tol, plain_y=plain_y)
        e = self.cache[key]
        y = Guarded(torch, (b_, t, h, p), dt, self.dev)
        fin = Guarded(torch, (b_, h, n, p), f32, self.dev) \
            if kw["final_state"] else None
        scratch = torch.empty((2, b_, h, n, p), dtype=f32, device=self.dev) \
            if t > sub else None

        def launch():
            x, bm, cm, dtv = e["x"], e["b"], e["c"], e["dt"]
            f = _bind(km.kernel_lib(p, n), "ssd_launch",
                      [_P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _P, _L, _L,
                       _L, _P, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _P])
            return f(x.data_ptr(), *x.stride()[:3], dtv.data_ptr(),
                     *dtv.stride()[:3], e["a_log"].data_ptr(),
                     e["d"].data_ptr(), bm.data_ptr(), *bm.stride()[:3],
                     cm.data_ptr(), *cm.stride()[:3],
                     e["init"].data_ptr() if e["init"] is not None else None,
                     y.out.data_ptr(),
                     fin.out.data_ptr() if fin is not None else None,
                     scratch.data_ptr() if scratch is not None else None,
                     b_, t, h, g, n, p, sub, km._DT[dt],
                     int(km._rows16(x, bm, cm)), self.stream)

        def check_y(name, got, _want, kind):
            if dt == f32:
                return _exact(torch, name, got, e["exact_y"], e["tol"])
            return self.close(name, got, e["plain_y"], "bf16")

        def check_s(name, got, _want, kind):
            return _exact(torch, name, got, e["exact_s"], e["tol"])
        outs = [("y", y, check_y, None)]
        if fin is not None:
            outs.append(("state", fin, check_s, None))
        return outs, launch, lambda: None

    def _accumulator_epilogue(self, pr, c):
        torch = self.torch
        from repro_torch.kernels import epilogue as epi
        from repro_torch.kernels import gemm as kg
        kw = pr.kw
        acc_dt = getattr(torch, kw["acc_dtype"])
        out_dt = getattr(torch, kw["out_dtype"])
        count, off = kw["count"], kw["acc_offset"]
        key = ("epi", count, off, acc_dt)
        if key not in self.cache:
            base = (self.randint(-1 << 20, 1 << 20, count + 8,
                                 dtype=torch.int32)
                    if acc_dt == torch.int32
                    else self.randn(count + 8, scale=300.0))
            acc = base[off // 4:off // 4 + count]
            if acc.data_ptr() % 16 != off:
                _fail(f"epilogue: accumulator at {acc.data_ptr() % 16} "
                      f"bytes past 16, wanted {off}")
            self.cache[key] = dict(acc=acc)
        e = self.cache[key]
        want = epi.apply(e["acc"], shift=0, activation=_none(),
                         out_dtype=out_dt)
        out = Guarded(torch, (count,), out_dt, self.dev)
        codes = (0, kg._INT_OUT[out_dt]) if acc_dt == torch.int32 else \
            (1, kg._DT[out_dt])

        def launch():
            f = _bind("gemm", "epilogue_launch", kg._EPI_ARGS)
            return f(e["acc"].data_ptr(), out.out.data_ptr(), count, *codes,
                     0, 0, 1.0, self.stream)
        return [("c", out, want, _kind(out_dt))], launch, lambda: None


def _none():
    from repro_torch.core.config import Activation
    return Activation.NONE


def _bind(lib, fn, argtypes):
    from repro_torch.kernels import _build
    return _build.bind(lib, fn, argtypes)


def _exact(torch, name, got, exact, tol) -> float:
    err = (got.double() - exact).abs().max().item()
    scale = exact.abs().max().item()
    if not torch.isfinite(got).all() or err > tol * scale:
        _fail(f"{name}: err {err:.3e} > {tol:.2e} x {scale:.3e} (the fp64 "
              f"recurrence)")
    return err


# ---------------------------------------------------------------------------
# the phase
# ---------------------------------------------------------------------------
def _geometry_diff(contract, c_plan_dict) -> List[str]:
    want = contract.plan_dict()
    return [f"{k}: contract {want[k]} != C {c_plan_dict.get(k)}"
            for k in want if want[k] != c_plan_dict.get(k)]


def check_plan(torch, pr, sms, counts, log, launcher, notes):
    """(a) for one probe plan, then (c)-(e) where the C function accepts
    it. Returns the contract the launch ran (or None)."""
    c = pr.contract(sms)
    lint_ok = checks.admits(c)
    rc, cp = c_plan(torch, pr)
    c_ok = rc == 0
    counts["plans"] += 1
    if c.needs_card:
        counts["needs_card"] += 1
    if c_ok != lint_ok:
        if c.needs_card and lint_ok and not c_ok:
            notes.append(f"needs the card: {pr.family} {pr.inst}: the card "
                         f"refused it (C code {rc})")
            counts["card_refused"] += 1
        else:
            counts["c_disagree"] += 1
            _fail(f"{pr.family} {pr.inst}: the lint "
                  f"{'admits' if lint_ok else 'refuses'} the plan, the C "
                  f"plan function {'accepts' if c_ok else 'refuses'} it "
                  f"(code {rc})")
    if not c_ok:
        counts["refused"] += 1
        return None
    run_c = c
    diff = _geometry_diff(c, cp)
    if diff and c.needs_card and pr.family == "gemm":
        # the card cut the wide plan's splits: the contract at the card's
        # choice must match field for field
        run_c = driver.Probe(pr.family, pr.problem, (
            ("tile", cp["tile_code"]), ("splits", cp["splits"]))
        ).contract(sms)
        notes.append(f"needs the card: {pr.inst}: the card chose "
                     f"{cp['splits']} splits, the one-block-an-SM model "
                     f"{c.plan_dict()['splits']}")
        diff = _geometry_diff(run_c, cp)
    if diff:
        counts["c_disagree"] += 1
        _fail(f"{pr.family} {pr.inst}: geometry differs: " + "; ".join(diff))
    counts["admitted"] += 1
    launch_checks(torch, pr, run_c, launcher)
    counts["launched"] += 1
    return run_c


def launch_checks(torch, pr, c, launcher):
    outs, launch, tickets = launcher.run(pr, c)
    name = f"{pr.family} [{pr.inst}]"
    bits = []
    for which in (0, 1):
        sents = [g.fill(which) for _, g, _, _ in outs]
        code = launch()
        torch.cuda.synchronize()
        if code != 0:
            _fail(f"{name}: launch refused (CUDA error {code}) for a plan the "
                  f"C function accepted")
        for (oname, g, _, _), s in zip(outs, sents):
            g.check(f"{name} {oname}", s)
        bits.append([(g.body_bits(), s) for (_, g, _, _), s in
                     zip(outs, sents)])
        t = tickets()
        if t is not None and bool((t != 0).any()):
            _fail(f"{name}: {int((t != 0).sum())} ticket words left non-zero "
                  f"after the call")
    for (oname, g, want, kind), (b0, s0), (b1, s1) in zip(outs, *bits):
        unwritten = (b0 == s0) & (b1 == s1)
        if bool(unwritten.any()):
            _fail(f"{name} {oname}: {int(unwritten.sum())} elements no block "
                  f"wrote")
        if not torch.equal(b0, b1):
            _fail(f"{name} {oname}: two launches differ in "
                  f"{int((b0 != b1).sum())} elements (a split sum in no "
                  f"fixed order)")
        got = g.out
        if callable(want):
            want(f"{name} {oname}", got, None, kind)
        else:
            launcher.close(f"{name} {oname}", got, want, kind)


def run(torch, *, log=print, close_fn=None, ssd_exact=None,
        build_logs: Optional[Dict[str, str]] = None,
        budget_s: Optional[float] = None) -> Dict:
    """The whole phase: (a) and (c)-(e) over every probe plan of the nine
    kernel families, then (b) over the build logs for the plans that ran.
    Raises :class:`CardFailure` on the first failure."""
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"sms": sms}
    counts = dict(plans=0, admitted=0, refused=0, needs_card=0,
                  card_refused=0, c_disagree=0, launched=0)
    notes: List[str] = []
    launcher = Launcher(torch, dev, ssd_exact=ssd_exact, close_fn=close_fn)
    per_family: Dict[str, Dict[str, int]] = {}
    ran = []
    for pr in driver.probes():
        before = dict(counts)
        c = check_plan(torch, pr, sms, counts, log, launcher, notes)
        if c is not None:
            ran.append(c)
        fam = per_family.setdefault(pr.family, dict(plans=0, admitted=0,
                                                    refused=0, needs_card=0))
        for k in fam:
            fam[k] += counts[k] - before[k]
        if budget_s is not None and time.perf_counter() - t0 > budget_s:
            _fail(f"phase 17 passed {budget_s} s after {counts['plans']} "
                  f"plans")
    for note in notes[:20]:
        log(note)
    if len(notes) > 20:
        log(f"... and {len(notes) - 20} more notes")
    for fam, fc in per_family.items():
        log(f"{fam}: {fc['plans']} plans, {fc['admitted']} admitted, "
            f"{fc['refused']} refused, {fc['needs_card']} need the card")
    if build_logs is not None:
        out["registers"] = check_registers(build_logs, ran, log)
    out.update(counts=counts, per_family=per_family, notes=notes,
               seconds=time.perf_counter() - t0)
    return out
