"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain
PyTorch versions (``ref``).

Each wrapper module (``quant_matmul``, ``flash_attention``,
``paged_attention``) names the TPU kernel it replaces, computes its plain
version on CPU tensors, launches its kernel on CUDA tensors (or raises)
and counts its launches in a module-level ``launches`` integer.
``_build`` compiles ``csrc/*.cu`` with ``nvcc`` at first use.
"""
