"""AST rules over the kernel wrappers (``src/repro_torch/kernels/*.py``).

The contract checks prove what a contract declares; these rules hold the
wrappers that launch the kernels to their contracts and to the port's
conventions:

===== ==================================================================
GL501 a function binds a ``*_launch`` entry (``_build.bind``) but carries
      no ``@kernel_contract(...)`` naming registered builders
      (``kernels/contracts.py``)
GL502 a library kernel (``torch.matmul``, ``torch.bmm``,
      ``torch._int_mm``, ``F.scaled_dot_product_attention``,
      ``F.conv2d``) is called in a launching wrapper: the card branch of a
      wrapper runs its hand-written kernel or raises (the plain versions
      and ``kernels/ref.py`` are exempt: they launch nothing)
GL503 a launching wrapper does not count exactly one launch
      (``<counter>.launches += 1``) on every path after its launch: the
      launch counts (``kernels.launch_counts()``) and the profiler's
      windows rely on one count a launch
GL504 a bound C entry's return code is not passed to ``_build.check``
GL506 a kernel module imports ``jax`` or the JAX package (``repro``)
===== ==================================================================
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.lint.findings import Finding, finding

LIBRARY_KERNELS = ("torch.matmul", "torch.bmm", "torch._int_mm",
                   "torch.mm", "torch.addmm", "torch.einsum",
                   "F.scaled_dot_product_attention", "F.conv2d",
                   "torch.nn.functional.scaled_dot_product_attention",
                   "torch.nn.functional.conv2d")


def _attr_chain(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _calls(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node, _attr_chain(node.func)


def _contract_names(fn: ast.FunctionDef) -> Optional[Tuple[str, ...]]:
    for deco in fn.decorator_list:
        if isinstance(deco, ast.Call) and \
                _attr_chain(deco.func).endswith("kernel_contract"):
            return tuple(a.value for a in deco.args
                         if isinstance(a, ast.Constant))
    return None


def _module_strings(tree: ast.Module):
    """Module-level names bound to tuples / dicts holding strings (the GEMM
    wrapper binds its integer entries through such a table)."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            strs = [n.value for n in ast.walk(node.value)
                    if isinstance(n, ast.Constant) and isinstance(n.value,
                                                                  str)]
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = strs
    return out


def _bound_entries(call: ast.Call, tables) -> List[str]:
    """The C entry names a ``_build.bind`` call may bind."""
    names = []
    for a in call.args[:2]:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            names.append(a.value)
        elif isinstance(a, ast.Starred):
            for n in ast.walk(a.value):
                if isinstance(n, ast.Name) and n.id in tables:
                    names += tables[n.id]
    return [n for n in names if n.endswith("_launch") or n.endswith("_plan")]


def _count_incs(stmts) -> Tuple[int, int]:
    """(fewest, most) ``X.launches += 1`` over the paths through
    ``stmts`` (an ``if`` takes the min / max of its branches; a path that
    returns early is cut there)."""
    lo = hi = 0
    for st in stmts:
        if isinstance(st, ast.AugAssign) and \
                isinstance(st.target, ast.Attribute) and \
                st.target.attr == "launches":
            lo, hi = lo + 1, hi + 1
        elif isinstance(st, ast.If):
            a, b = _count_incs(st.body), _count_incs(st.orelse)
            lo, hi = lo + min(a[0], b[0]), hi + max(a[1], b[1])
        elif isinstance(st, (ast.For, ast.While, ast.With, ast.Try)):
            inner = _count_incs(getattr(st, "body", []))
            if inner[1]:
                hi += 2 * inner[1]      # a count in a loop: more than one
        elif isinstance(st, ast.Return):
            break
    return lo, hi


def _rel(path: Path) -> str:
    parts = path.parts
    if "src" in parts:
        return str(path.relative_to(next(p for p in path.parents
                                         if p.name == "src")))
    return path.name


def check_kernel_file(path, *, registry=None) -> List[Finding]:
    """GL501-GL504 and GL506 over one kernel module."""
    path = Path(path)
    if registry is None:
        from repro_torch.kernels.contracts import CONTRACT_BUILDERS
        registry = CONTRACT_BUILDERS
    tree = ast.parse(path.read_text(), filename=str(path))
    rel = _rel(path)
    out: List[Finding] = []
    tables = _module_strings(tree)

    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        for mod in mods:
            if mod.split(".")[0] in ("jax", "jaxlib", "repro"):
                out.append(finding(
                    "GL506", "error", f"{rel}::L{node.lineno}",
                    f"imports {mod}: the port's kernels import neither JAX "
                    f"nor the JAX package", key=mod))

    for fn in [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        site = f"{rel}::{fn.name}"
        binds = [(c, _bound_entries(c, tables)) for c, callee in _calls(fn)
                 if callee.endswith("_build.bind")]
        launches = [c for c, names in binds
                    if any(n.endswith("_launch") for n in names)]
        # GL504: every call of a bound entry goes to _build.check
        bound_vars = set()
        for st in ast.walk(fn):
            if isinstance(st, ast.Assign) and isinstance(st.value, ast.Call) \
                    and _attr_chain(st.value.func).endswith("_build.bind"):
                bound_vars |= {t.id for t in st.targets
                               if isinstance(t, ast.Name)}
        checked = set()
        for c, callee in _calls(fn):
            if callee.endswith("_build.check") and c.args:
                a = c.args[0]
                if isinstance(a, ast.Name):
                    checked.add(a.id)
                elif isinstance(a, ast.Call):
                    checked.add(id(a))
        for st in ast.walk(fn):
            call, target = None, None
            if isinstance(st, ast.Assign) and isinstance(st.value, ast.Call):
                call, target = st.value, st.targets[0]
            elif isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
                call = st.value
            if call is None or not isinstance(call.func, ast.Name) or \
                    call.func.id not in bound_vars:
                continue
            ok = isinstance(target, ast.Name) and target.id in checked
            if not ok:
                out.append(finding(
                    "GL504", "error", site,
                    f"the return code of {call.func.id}() at line "
                    f"{call.lineno} is not passed to _build.check: a launch "
                    f"the runtime refused would pass unseen",
                    key=f"L{call.lineno}"))
        for c, callee in _calls(fn):
            if isinstance(c.func, ast.Name) and c.func.id in bound_vars:
                continue
            for a in c.args:
                if isinstance(a, ast.Call) and isinstance(a.func, ast.Name) \
                        and a.func.id in bound_vars and \
                        not callee.endswith("_build.check"):
                    out.append(finding(
                        "GL504", "error", site,
                        f"the return code of {a.func.id}() at line "
                        f"{a.lineno} is not passed to _build.check",
                        key=f"L{a.lineno}"))
        if not launches:
            continue
        names = _contract_names(fn)
        if names is None:
            out.append(finding(
                "GL501", "error", site,
                f"{fn.name} binds a launch entry without a @kernel_contract "
                f"annotation"))
        else:
            for nm in names:
                if nm not in registry:
                    out.append(finding(
                        "GL501", "error", site,
                        f"@kernel_contract({nm!r}) does not resolve to a "
                        f"registered builder in kernels/contracts.py",
                        key=nm))
        # GL502: no library kernel in a launching wrapper
        for c, callee in _calls(fn):
            if callee in LIBRARY_KERNELS:
                out.append(finding(
                    "GL502", "error", site,
                    f"{callee} at line {c.lineno} in a wrapper that launches "
                    f"a hand-written kernel: its card branch must run the "
                    f"kernel or raise", key=f"L{c.lineno}"))
        # GL503: exactly one count on every path after the launch's check
        body = fn.body
        marks = [i for i, st in enumerate(body)
                 if any(isinstance(n, ast.Call) and (
                     _attr_chain(n.func).endswith("_build.check") or
                     (isinstance(n.func, ast.Name) and
                      n.func.id in bound_vars))
                     for n in ast.walk(st))]
        lo, hi = _count_incs(body[marks[-1] + 1:]) if marks else (0, 0)
        if (lo, hi) != (1, 1):
            out.append(finding(
                "GL503", "error", site,
                f"{fn.name} counts {lo}..{hi} launches after its launch; "
                f"every path must count exactly one", key="count"))
    return out


def check_kernel_files(paths: Sequence) -> List[Finding]:
    out: List[Finding] = []
    for p in paths:
        out += check_kernel_file(p)
    return out
