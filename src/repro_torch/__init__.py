"""PyTorch/CUDA port of the Gemmini reproduction.

Each module mirrors the module of the same path under ``repro`` (the JAX
reference) and is held against it by ``tests/test_torch_*.py``. Every
kernel the JAX package wrote in Pallas becomes a hand-written CUDA kernel
under ``kernels/csrc``; its plain PyTorch version sits beside it in the
same module and is what a CPU tensor runs.
"""
