"""PyTorch/CUDA port of the PAC+ reproduction (the JAX package ``repro``
is the reference).

The package keeps ``repro``'s module layout so that each module has a
named counterpart there, and imports neither JAX nor anything of
``repro``. Two slices are ported: multi-tenant paged serving of a dense
decoder with an INT8 backbone, and single-device PAC+ training (epoch 1
through the frozen backbone, later epochs from the activation cache):

* ``repro_torch.configs`` — architecture configs (dense only);
* ``repro_torch.core`` — block quantization, the OpSet seam (with tap
  emission), the parallel adapters, pruning init, the activation cache
  and the PAC+ training steps;
* ``repro_torch.kernels`` — hand-written CUDA kernels for ``sm_90a``
  (``quant_matmul``, ``flash_attention``, ``paged_attention``,
  ``mix_fwd``/``mix_dw``, ``ce_fwd``/``ce_bwd``), each beside its plain
  PyTorch version;
* ``repro_torch.models`` — layers and the pattern-driven backbone;
* ``repro_torch.optim`` — AdamW and global-norm clipping;
* ``repro_torch.data`` — the synthetic personal corpus and its pipeline;
* ``repro_torch.runtime`` / ``repro_torch.launch`` — ``RunSpec``,
  ``EdgeSession``, ``EpochRunner`` and the trainer CLI;
* ``repro_torch.serve`` — page pools, the paged decode/prefill steps
  and :class:`~repro_torch.serve.engine.ServeEngine`;
* ``repro_torch.bridge`` — numpy trees (e.g. parameters exported from
  the JAX package) to the port's tensors and back.
"""
