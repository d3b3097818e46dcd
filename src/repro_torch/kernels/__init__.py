"""Kernel layer: hand-written Hopper kernels (``csrc/*.cu``), each beside
its plain PyTorch version. Nothing here builds or touches a card at
import; ``_build`` compiles at the first launch."""


def launch_counters():
    """The four kernel wrappers of the serving path; each carries a plain
    ``launches`` count that grows by one per kernel launch."""
    from repro_torch.kernels import attention, gemm
    return {"gemm": gemm.gemm,
            "flash_attention": attention.flash_attention,
            "paged_prefill_attention": attention.paged_prefill_attention,
            "paged_decode_attention": attention.paged_decode_attention}


def reset_launch_counts() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in launch_counters().items()}
