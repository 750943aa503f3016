"""PyTorch/CUDA port of the PAC+ reproduction (the JAX package ``repro``
is the reference).

The package keeps ``repro``'s module layout so that each module has a
named counterpart there, and imports neither JAX nor anything of
``repro``. Three slices are ported: multi-tenant paged serving of a
dense decoder with an INT8 backbone; single-device PAC+ training (epoch
1 through the frozen backbone, later epochs from the activation cache);
and the personal model's lifecycle (checkpoint, a persistent cache
reopened warm, one user's model served with ``pac_decode_step`` over a
linear INT8 KV cache):

* ``repro_torch.configs`` — architecture configs (dense only);
* ``repro_torch.core`` — block quantization, the OpSet seam (with tap
  emission and the adapter mix), the parallel adapters, pruning init,
  the activation cache (with its manifest) and the PAC+ training and
  serving steps;
* ``repro_torch.checkpoint`` — trees to disk in the reference's msgpack
  framing (each package reads the other's files);
* ``repro_torch.kernels`` — hand-written CUDA kernels for ``sm_90a``
  (``quant_matmul``, ``flash_attention``, ``paged_attention``,
  ``mix_fwd``/``mix_dw``, ``ce_fwd``/``ce_bwd``, ``adapter_fuse``), each
  beside its plain PyTorch version;
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
