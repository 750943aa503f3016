"""PyTorch/CUDA port of the PAC+ reproduction (the JAX package ``repro``
is the reference).

The package keeps ``repro``'s module layout so that each module has a
named counterpart there, and imports neither JAX nor anything of
``repro``. This first slice covers multi-tenant paged serving of a
dense decoder with an INT8 backbone:

* ``repro_torch.configs`` — architecture configs (dense only);
* ``repro_torch.core`` — block quantization, the OpSet seam, the
  per-user parallel adapters;
* ``repro_torch.kernels`` — hand-written CUDA kernels for ``sm_90a``
  (``quant_matmul``, ``flash_attention``, ``paged_attention``), each
  beside its plain PyTorch version;
* ``repro_torch.models`` — layers and the pattern-driven backbone;
* ``repro_torch.serve`` — page pools, the paged decode/prefill steps
  and :class:`~repro_torch.serve.engine.ServeEngine`;
* ``repro_torch.bridge`` — numpy trees (e.g. parameters exported from
  the JAX package) to the port's tensors and back.
"""
