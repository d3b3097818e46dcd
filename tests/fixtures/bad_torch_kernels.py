# Known-bad kernel wrappers, AST-scanned by the port's lint tests
# (tests/test_torch_lint.py). NEVER imported or executed: each function
# below trips exactly one source rule of repro_torch.analysis.lint.source.
# Do not "fix" these.

import ctypes

import jax.numpy as jnp                                   # GL506

from repro_torch.kernels import _build
from repro_torch.kernels.contracts import kernel_contract

_P, _I = ctypes.c_void_p, ctypes.c_int


def unannotated(a):
    # GL501: binds a launch entry without @kernel_contract.
    fn = _build.bind("gemm", "gemm_launch", [_P, _I])
    err = fn(a.data_ptr(), 1)
    _build.check(err, "unannotated")
    unannotated.launches += 1
    return a


@kernel_contract("gemm")
def library_on_card(a, b):
    # GL502: a library kernel in a launching wrapper.
    if a.device.type == "cuda":
        c = torch.matmul(a, b)                              # noqa: F821
    fn = _build.bind("gemm", "gemm_launch", [_P, _I])
    err = fn(a.data_ptr(), 1)
    _build.check(err, "library_on_card")
    library_on_card.launches += 1
    return c


@kernel_contract("gemm")
def counts_twice(a):
    # GL503: two launch counts on one path.
    fn = _build.bind("gemm", "gemm_launch", [_P, _I])
    err = fn(a.data_ptr(), 1)
    _build.check(err, "counts_twice")
    counts_twice.launches += 1
    counts_twice.launches += 1
    return a


@kernel_contract("gemm")
def unchecked(a):
    # GL504: the launch's return code never reaches _build.check.
    fn = _build.bind("gemm", "gemm_launch", [_P, _I])
    fn(a.data_ptr(), 1)
    unchecked.launches += 1
    return jnp.asarray(a)
