"""Build and load the hand-written Hopper kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at the first kernel launch, never at import: one ``nvcc`` per source,
all started together. Libraries land in a content-hashed directory under
``build/kernels/`` at the repository root (git-ignored), so a changed
source or flag set builds anew and an unchanged one is loaded as it is.

Each C entry point launches on the stream it is handed and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error,
so a launch the CUDA runtime refused (too much shared memory, too many threads)
never passes unseen.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """The content-hashed output directory: sources, headers and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def nvcc_command(src: Path, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]


def build() -> Dict[str, float]:
    """Compile every source whose library is missing; returns the build
    seconds per source (0.0 for a library that was already there).
    Raises with the compiler's output when a build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in sources():
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
        log = open(out_dir / f"{src.stem}.log", "w")
        procs[src.stem] = (subprocess.Popen(nvcc_command(src, tmp),
                                            stdout=log,
                                            stderr=subprocess.STDOUT),
                           tmp, lib, log)
    times = {src.stem: 0.0 for src in sources()}
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib)          # atomic: a reader never sees half a file
    if failed:
        msgs = "\n".join(f"--- {n} ---\n" + (out_dir / f"{n}.log").read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return times


def build_log(name: str) -> str:
    """The compiler's output for ``csrc/<name>.cu`` (registers, shared
    memory and spills per kernel, from ``-Xptxas=-v``)."""
    p = build_dir() / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_dir() / f"lib{name}.so"
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def bind(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """``fn`` of library ``name`` with its argument types declared (every
    pointer and the stream as ``c_void_p``, so ctypes never truncates one
    to a 32-bit int) and an int return: the launch's CUDA error code."""
    f = _FNS.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FNS[(name, fn)] = f
    return f


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
