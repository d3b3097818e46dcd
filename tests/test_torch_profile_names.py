"""``chip_smoke.py``'s profiler classes for the kernels' names.

``profile_call`` files each CUDA kernel the profiler records under a
kernel class by its demangled name (``_kernel_class``: the first key of
``_KERNEL_NAMES`` the name contains) and holds each class to the launch
counters that map to it (``_COUNTER_CLASS``); a kernel filed under
another counter's class makes every window look short. These are the
names the card's kernels carry (nvcc's demangled instantiations), each
with the launch counter it adds to; runs on the CPU.
"""

import importlib.util
import pathlib

import pytest

_PATH = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
_SPEC = importlib.util.spec_from_file_location("chip_smoke_names", _PATH)
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

_ANON = "(anonymous namespace)::"
NAMES = [
    # the int16 GEMM: the int8 tensor-core loop on byte planes
    ("void igemm::kernel<short, 1, false, igemm::MatrixA>"
     "(igemm::Args<short>, igemm::MatrixA)", "gemm[int16]"),
    ("void igemm::kernel<short, 0, true, igemm::MatrixA>"
     "(igemm::Args<short>, igemm::MatrixA)", "gemm[int16]"),
    # the int8 GEMM on the same loop
    ("void igemm::kernel<signed char, 1, false, igemm::MatrixA>"
     "(igemm::Args<signed char>, igemm::MatrixA)", "gemm[int8]"),
    ("void igemm::kernel<signed char, 0, true, igemm::MatrixA>"
     "(igemm::Args<signed char>, igemm::MatrixA)", "gemm[int8]"),
    # fp32 flash and fp32 paged prefill: the CUDA-core flash kernel
    (f"void {_ANON}flash_f32_kernel<64, {_ANON}DenseKV32>({_ANON}F32Args)",
     "flash_attention"),
    (f"void {_ANON}flash_f32_kernel<16, {_ANON}PagedKV32>({_ANON}F32Args)",
     "paged_prefill_attention"),
    (f"void {_ANON}flash_f32_kernel<256, {_ANON}PagedKV32>({_ANON}F32Args)",
     "paged_prefill_attention"),
    # bf16 flash and paged prefill, and the int16 conv (CUDA cores)
    (f"void {_ANON}flash_tc_kernel<256, {_ANON}DenseKV>({_ANON}FlashArgs)",
     "flash_attention"),
    (f"void {_ANON}flash_tc_kernel<64, {_ANON}PagedKV>({_ANON}FlashArgs)",
     "paged_prefill_attention"),
    ("void sgemm::sgemm_kernel<short, 7, 8, 8, 4, false, false, sgemm::AnyOut,"
     " (anonymous namespace)::ConvTapsA<8, 2>>(sgemm::Args<short>, "
     "(anonymous namespace)::ConvTapsA<8, 2>)", "conv2d_implicit[int16]"),
    ("void sgemm::sgemm_kernel<float, 8, 16, 16, 1, false, true, float, "
     "sgemm::MatrixA<float>>(sgemm::Args<float>, sgemm::MatrixA<float>)",
     "gemm[fp32]"),
    # the conversion, one kernel per dtype pair and path
    (f"void {_ANON}convert_kernel<1, 3, true>({_ANON}CvArgs, int)",
     "convert"),
    (f"void {_ANON}convert_kernel<5, 0, false>({_ANON}CvArgs, int)",
     "convert"),
    # the fp16 SSD: the tensor-core kernel for __half (ssd16.cu)
    (f"void {_ANON}ssd_tc_kernel<64, false, __half>"
     f"({_ANON}TcArgs<__half>)", "ssd[fp16]"),
    (f"void {_ANON}ssd_tc_kernel<64, true, __nv_bfloat16>"
     f"({_ANON}TcArgs<__nv_bfloat16>)", "ssd"),
    # the backward products' persistent kernel
    ("void hgemm_bwd::bwd_kernel<__nv_bfloat16, true, false, 192>"
     "(hgemm_bwd::Args, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st)",
     "gemm[bwd]"),
]


@pytest.mark.parametrize("name,counter", NAMES)
def test_kernel_filed_under_its_counters_class(name, counter):
    assert cs._kernel_class(name) == cs._COUNTER_CLASS[counter]


def test_every_counter_has_a_class():
    """Every launch counter but gemm_ws (either GEMM class) maps to a class
    some kernel name can be filed under."""
    from repro_torch import kernels

    classes = {cls for _, cls in cs._KERNEL_NAMES}
    for counter in kernels.launch_counts():
        if counter != "gemm_ws":
            assert cs._COUNTER_CLASS[counter] in classes, counter
