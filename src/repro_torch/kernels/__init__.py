"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain
PyTorch versions (``ref``).

Each wrapper module (``quant_matmul``, ``flash_attention``,
``paged_attention``; ``cached_mix`` with ``mix_fwd``/``mix_dw`` and
``lmhead_ce`` with ``ce_fwd``/``ce_bwd``, the training kernels;
``adapter_fuse``, the float-tap adapter mix of single-user serving)
names the TPU kernel it replaces, computes its plain version on CPU
tensors, launches its kernel on CUDA tensors (or raises) and counts its
launches in a module-level ``launches`` integer (a dict by kernel name
where a module holds two). ``ops`` wraps them for model-shaped tensors
(the reference's ``kernels/ops.py``); ``cached_step`` composes the
training kernels into the cached-epoch loss. ``_build`` compiles
``csrc/*.cu`` with ``nvcc`` at first use.
"""
