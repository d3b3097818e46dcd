"""Kernel layer: hand-written Hopper kernels (``csrc/*.cu``), each beside
its plain PyTorch version. Nothing here builds or touches a card at
import; ``_build`` compiles at the first launch."""


SERVING_KERNELS = ("gemm", "flash_attention", "paged_prefill_attention",
                   "paged_decode_attention")
ENGINE_KERNELS = ("gemm[int8]", "gemm_ws", "accumulator_epilogue",
                  "conv2d_implicit", "gemm[fp16]", "gemm[int16]",
                  "conv2d_implicit[fp32]", "conv2d_implicit[bf16]",
                  "conv2d_implicit[fp16]", "conv2d_implicit[int16]")
RECURRENT_KERNELS = ("ssd",)
STATIC_KERNELS = ("decode_attention",)
# The fp16 model's instantiations of the serving, recurrent and static
# paths' kernels.
FP16_KERNELS = ("flash_attention[fp16]", "paged_prefill_attention[fp16]",
                "paged_decode_attention[fp16]", "decode_attention[fp16]",
                "ssd[fp16]")
# The attention kernels and the SSD on mixed operand dtypes (the fp32
# kernels on operands widened to fp32).
MIXED_KERNELS = ("flash_attention[mixed]", "paged_prefill_attention[mixed]",
                 "paged_decode_attention[mixed]", "decode_attention[mixed]",
                 "ssd[mixed]")
# The generic datapath (every other combination of the dtype table): the
# int32 main loop of the GEMM and the conv, the conversion and the generic
# epilogue.
GENERIC_KERNELS = ("gemm[int32]", "conv2d_implicit[int32]", "convert",
                    "epilogue[any]")
# The MoE serving path's own: its router is an fp32-input GEMM on every
# engine config.
MOE_KERNELS = ("gemm[fp32]",)
# The training path's own: the engine GEMM's backward products.
TRAIN_KERNELS = ("gemm[bwd]",)


def launch_counters():
    """Every kernel, by the name the ``kernels`` report gives it, to the
    wrapper (or the wrapper's per-datatype count) whose plain ``launches``
    count grows by one per launch of it: the serving path's four, the
    engine path's (the int8, fp16 and int16 GEMMs in OS order, any GEMM
    in WS order, the mvout epilogue, the implicit-im2col conv per input
    datatype), the fp32 GEMM in OS order (the fp32 engine config's, and the
    MoE router's on every config), the GEMM's backward products on any
    float datapath (the training path's), the recurrent families' chunked
    SSD and the static reference path's dense decode attention, their fp16
    instantiations and their launches on mixed dtypes, and the generic
    datapath's kernels."""
    import torch

    from repro_torch.kernels import attention, conv, datapath, gemm, mamba2
    return {"gemm": gemm.gemm,
            "flash_attention": attention.flash_attention,
            "paged_prefill_attention": attention.paged_prefill_attention,
            "paged_decode_attention": attention.paged_decode_attention,
            "gemm[int8]": gemm.gemm_os,
            "gemm_ws": gemm.gemm_ws,
            "accumulator_epilogue": gemm.accumulator_epilogue,
            "conv2d_implicit": conv.conv2d_implicit,
            "gemm[fp32]": gemm.OS_COUNTS[torch.float32],
            "gemm[bwd]": gemm.BWD_COUNT,
            "gemm[fp16]": gemm.OS_COUNTS[torch.float16],
            "gemm[int16]": gemm.OS_COUNTS[torch.int16],
            "conv2d_implicit[fp32]": conv.COUNTS[torch.float32],
            "conv2d_implicit[bf16]": conv.COUNTS[torch.bfloat16],
            "conv2d_implicit[fp16]": conv.COUNTS[torch.float16],
            "conv2d_implicit[int16]": conv.COUNTS[torch.int16],
            "ssd": mamba2.ssd,
            "decode_attention": attention.decode_attention,
            **{f"{name}[fp16]": count
               for name, count in attention.F16_COUNTS.items()},
            "ssd[fp16]": mamba2.F16_COUNT,
            **{f"{name}[mixed]": count
               for name, count in attention.MIXED_COUNTS.items()},
            "ssd[mixed]": mamba2.MIXED_COUNT,
            "gemm[int32]": gemm.OS_COUNTS[torch.int32],
            "conv2d_implicit[int32]": conv.COUNTS[torch.int32],
            "convert": datapath.convert,
            "epilogue[any]": datapath.epilogue_any}


def reset_launch_counts() -> None:
    from repro_torch.kernels import mamba2
    for fn in launch_counters().values():
        fn.launches = 0
    mamba2.ssd.resumed_launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in launch_counters().items()}
