"""Abstract inputs for the dry run and the roofline (twin of
``repro.launch.specs``).

``build_case(arch, shape, layout, ...)`` returns everything needed to
price one (architecture x input shape) cell: the step function and its
arguments, all on the ``meta`` device, so nothing is ever allocated or
computed (the reference's ``ShapeDtypeStruct`` stand-ins). The step is
the ``cuda`` OpSet's, the program the card runs; :meth:`Case.price`
runs it under :class:`~repro_torch.launch.op_cost.OpPricer` where the
reference lowers it.

Modality carve-out: for [audio]/[vlm] archs the frontend is a stub —
:func:`input_specs` supplies precomputed frame/patch **embeddings** of
the right shape (plus (3, B, S) M-RoPE position ids for qwen2-vl), as
the reference does.

Decode shapes price ``decode_step``: ONE token against a
``seq_len``-deep ``init_cache`` (INT8 K/V under ``kv_quant=8``).
``long_500k`` uses each arch's sub-quadratic path; a pure
full-attention arch serves it with ``window=8192`` on every layer
(note ``sw8k``).

A ``layout`` other than ``(1, 1)`` is ``(dp, stages)`` of the port's
:class:`~repro_torch.launch.mesh.EdgeMesh`: the case then runs every
rank's step, each in its own thread on meta, over
:class:`~repro_torch.launch.dryrun.PricedMesh` (see there), and prices
each rank with the bytes the mesh's protocol moves. The reference's
in/out shardings describe one GSPMD program and have no twin.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.configs import INPUT_SHAPES, ArchConfig, InputShape, get_arch
from repro_torch.core import steps
from repro_torch.core.opset import TAP_BLOCK
from repro_torch.core.parallel_adapters import init_adapter
from repro_torch.core.quantization import quantize
from repro_torch.launch.op_cost import OpPricer, tensor_bytes, tree_tensors
from repro_torch.models.backbone import init_backbone, init_cache, loss_head
from repro_torch.optim import adamw_init

SERVE_WINDOW = 8192  # sliding-window serving variant for long_500k
META = torch.device("meta")


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def abstract_params(cfg: ArchConfig, quant_bits: Optional[int] = None, dtype=torch.float32):
    """The backbone on meta (in quantized storage when ``quant_bits``)."""
    return init_backbone(None, cfg, device=META, dtype=dtype, quant_bits=quant_bits)


def input_specs(cfg: ArchConfig, shape: InputShape, dtype=torch.float32) -> dict:
    """The abstract batch of ``shape`` (the reference's step 2)."""
    B, S = shape.global_batch, shape.seq_len
    S_tok = 1 if shape.mode == "decode" else S
    batch: dict = {}
    if cfg.frontend is not None:
        # stub modality frontend: precomputed embeddings
        batch["embeds"] = _meta((B, S_tok, cfg.d_model), dtype)
    else:
        batch["tokens"] = _meta((B, S_tok), torch.int32)
    if cfg.rope == "mrope":
        batch["positions"] = _meta((3, B, S_tok), torch.int64)
    if shape.mode == "train":
        batch["labels"] = _meta((B, S_tok), torch.int32)
    return batch


def storage_form(shape, policy: str):
    """An abstract activation-cache entry of ``shape`` in its storage
    form: f32, bf16, or an int8 QTensor in blocks of ``TAP_BLOCK``."""
    if policy == "int8":
        return quantize(_meta(shape), bits=8, block=TAP_BLOCK)
    return _meta(shape, torch.bfloat16 if policy == "bf16" else torch.float32)


@dataclass
class Case:
    """One pricing cell: callable + meta arguments. ``fn`` runs one rank's
    step (``layout`` (1, 1)) or, for a layout, every rank's
    (``fn()`` returns the ranks' pricers itself)."""

    name: str
    fn: Callable
    args: tuple
    cfg: ArchConfig
    shape: InputShape
    note: str = ""
    layout: Tuple[int, int] = (1, 1)

    def price(self) -> List[OpPricer]:
        """Run the step on meta under the pricer: one
        :class:`~repro_torch.launch.op_cost.OpPricer` a rank, in rank
        order (the reference's ``lower()``)."""
        if self.layout != (1, 1):
            return self.fn(*self.args)
        with OpPricer() as pricer:
            self.fn(*self.args)
        return [pricer]

    def argument_bytes(self) -> int:
        """Bytes of the step's arguments, the twin of the reference's
        ``memory_analysis``: parameters, batch, optimizer state, cache
        (for a layout, the whole model's, before any rank's share)."""
        return sum(tensor_bytes(t) for t in tree_tensors(self.args))


def resolve_cfg_for_shape(cfg: ArchConfig, shape: InputShape) -> tuple:
    """Apply the long-context serving variant where required."""
    note = ""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        cfg = cfg.with_window(SERVE_WINDOW)
        note = "sw8k"
    return cfg, note


def build_case(
    arch,
    shape,
    layout: Tuple[int, int] = (1, 1),
    technique: str = "pac",
    quant_bits: Optional[int] = None,
    r: int = 8,
    dtype=torch.float32,
    kv_quant: Optional[int] = None,
    tap_policy: str = "f32",
) -> Case:
    """The cell (``arch`` x ``shape``): ``arch`` a name or an
    :class:`ArchConfig`, ``shape`` a name of :data:`INPUT_SHAPES` or an
    ad-hoc :class:`InputShape`. Train shapes take ``technique`` (``pac``,
    ``pac_cached``, ``full``, ``lora``); ``tap_policy`` is the activation
    cache's storage form (f32, bf16, int8) that ``pac`` emits and
    ``pac_cached`` reads."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = shape if isinstance(shape, InputShape) else INPUT_SHAPES[shape]
    cfg, note = resolve_cfg_for_shape(cfg, shape)
    if quant_bits:
        note = (note + f" int{quant_bits}").strip()
    if kv_quant:
        note = (note + f" kv{kv_quant}").strip()
    dp, stages = layout
    if (dp, stages) != (1, 1):
        from repro_torch.launch.dryrun import layout_case

        return layout_case(cfg, shape, dp, stages, technique=technique, quant_bits=quant_bits,
                           r=r, dtype=dtype, tap_policy=tap_policy, note=note)

    params = abstract_params(cfg, quant_bits, dtype)
    batch = input_specs(cfg, shape, dtype)
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        # a session makes its contiguous f32 head once for the life of the
        # head's leaf: make it before pricing, so that a step is a steady one
        loss_head(params, cfg)
        if technique == "pac":
            adapter = init_adapter(None, cfg, r, device=META, dtype=dtype)
            fn = functools.partial(steps.pac_train_step, cfg=cfg, r=r, kernel_impl="cuda",
                                   tap_policy=tap_policy)
            args = (params, adapter, adamw_init(adapter), batch)
        elif technique == "pac_cached":
            adapter = init_adapter(None, cfg, r, device=META, dtype=dtype)
            cached = {"b0": storage_form((B, S, cfg.d_model), tap_policy),
                      "taps": storage_form((cfg.n_periods, B, S, cfg.d_model), tap_policy),
                      "b_final": storage_form((B, S, cfg.d_model), tap_policy),
                      "labels": batch["labels"]}
            if "positions" in batch:
                cached["positions"] = batch["positions"]
            fn = functools.partial(steps.pac_cached_train_step, cfg=cfg, r=r, kernel_impl="cuda")
            args = (params, adapter, adamw_init(adapter), cached)
        elif technique == "full":
            fn = functools.partial(steps.full_train_step, cfg=cfg)
            args = (params, adamw_init(params), batch)
        elif technique == "lora":
            from repro_torch.core.peft import init_lora

            lora = init_lora(None, cfg, device=META, dtype=dtype)
            fn = functools.partial(steps.lora_train_step, cfg=cfg)
            args = (params, lora, adamw_init(lora), batch)
        else:
            raise ValueError(technique)
    elif shape.mode == "prefill":
        fn = functools.partial(steps.prefill_step, cfg=cfg, kernel_impl="cuda")
        args = (params, batch)
    else:  # decode: one token against a seq_len-deep cache
        cache = init_cache(cfg, B, S, dtype, device=META, kv_quant=kv_quant)
        fn = functools.partial(steps.decode_step, cfg=cfg, kernel_impl="cuda")
        args = (params, batch, cache, _meta((), torch.int64))
    return Case(name=f"{cfg.name}×{shape.name}", fn=fn, args=args, cfg=cfg, shape=shape,
                note=note)



# ---------------------------------------------------------------------------
# The serving engine's cells (the port's own entry points)
# ---------------------------------------------------------------------------


def _engine_state(cfg, max_batch: int, page: int, max_len: int, n_users: int, r: int,
                  kv_policy: str, quant_bits: Optional[int]):
    """A :class:`~repro_torch.serve.ServeEngine`'s resident state on meta:
    the backbone, the stacked adapter bank, the page pools (enough pages
    for ``max_batch`` full-length requests, as the engine sizes them) and
    the adapter cache."""
    from repro_torch.core.parallel_adapters import init_adapter_cache, stack_adapters
    from repro_torch.serve.paging import init_pools

    max_pages = -(-max_len // page)
    params = abstract_params(cfg, quant_bits)
    bank = stack_adapters([init_adapter(None, cfg, r, device=META) for _ in range(n_users)])
    pools = init_pools(cfg, max_batch * max_pages + 1, page, kv_policy, META, n_slots=max_batch)
    acache = init_adapter_cache(cfg, max_batch, max_len, r, device=META)
    return params, bank, pools, acache, max_pages


def _engine_note(quant_bits: Optional[int], kv_policy: str) -> str:
    return " ".join(n for n in (f"int{quant_bits}" if quant_bits else "",
                                f"kv-{kv_policy}", "paged") if n)


def engine_prefill_case(cfg, *, batch: int, prompt_pad: int, page: int, max_len: int,
                        n_users: int, r: int = 8, kv_policy: str = "int8",
                        quant_bits: Optional[int] = 8) -> Case:
    """One prefill wave of the serving engine (``ServeEngine._run_prefill``):
    ``batch`` prompts padded to ``prompt_pad`` tokens through
    ``paged_prefill`` into the pages, with the requests' adapters
    gathered from the bank, their caches copied into the engine's rows
    and the first tokens picked."""
    from repro_torch.core.parallel_adapters import gather_adapters
    from repro_torch.core.quantization import tree_leaves
    from repro_torch.serve.decode import paged_prefill

    params, bank, pools, acache, max_pages = _engine_state(
        cfg, batch, page, max_len, n_users, r, kv_policy, quant_bits)

    def wave(params, bank, tokens, lengths, pools, block_tables, user_idx, acache):
        ab = gather_adapters(bank, user_idx)
        logits, _, acaches = paged_prefill(params, ab, tokens, lengths, pools, block_tables,
                                           cfg=cfg, max_len=max_len, r=r, kernel_impl="cuda")
        for full, new in zip(tree_leaves(acache), tree_leaves(acaches)):
            full[:, :batch] = new
        return logits[:, 0].argmax(dim=-1)

    args = (params, bank, _meta((batch, prompt_pad), torch.int32), _meta((batch,), torch.int32),
            pools, _meta((batch, max_pages), torch.int32), _meta((batch,), torch.int32), acache)
    return Case(name=f"{cfg.name}×engine prefill", fn=wave, args=args, cfg=cfg,
                shape=InputShape("engine_prefill", prompt_pad, batch, "prefill"),
                note=_engine_note(quant_bits, kv_policy))


def engine_decode_case(cfg, *, batch: int, page: int, max_len: int, n_users: int, r: int = 8,
                       kv_policy: str = "int8", quant_bits: Optional[int] = 8) -> Case:
    """One decode step of the serving engine (``ServeEngine.step``) at
    ``batch`` rows: the adapters gathered, ``paged_pac_decode_step`` over
    the pools through ``max_len // page`` block-table slots a row, the
    tokens picked."""
    from repro_torch.core.parallel_adapters import gather_adapters
    from repro_torch.core.quantization import tree_map
    from repro_torch.serve.decode import paged_pac_decode_step

    params, bank, pools, acache, max_pages = _engine_state(
        cfg, batch, page, max_len, n_users, r, kv_policy, quant_bits)
    paged = [s.kind == "attn" for s in cfg.pattern]

    def step(params, bank, tokens, pools, block_tables, lengths, acache, user_idx):
        ab = gather_adapters(bank, user_idx)
        rows = [e if p else tree_map(lambda t: t[:, :batch], e) for e, p in zip(pools, paged)]
        logits, _, _ = paged_pac_decode_step(
            params, ab, tokens, rows, block_tables, lengths,
            tree_map(lambda t: t[:, :batch], acache), cfg=cfg, r=r, kernel_impl="cuda")
        return logits[:, 0].argmax(dim=-1)

    args = (params, bank, _meta((batch, 1), torch.int32), pools,
            _meta((batch, max_pages), torch.int32), _meta((batch,), torch.int32), acache,
            _meta((batch,), torch.int32))
    return Case(name=f"{cfg.name}×engine decode", fn=step, args=args, cfg=cfg,
                shape=InputShape("engine_decode", max_len, batch, "decode"),
                note=_engine_note(quant_bits, kv_policy))


def personal_decode_case(cfg, *, max_len: int, r: int = 8, kv_quant: Optional[int] = 8,
                         quant_bits: Optional[int] = 8) -> Case:
    """One step of single-user serving: ``pac_decode_step`` at B = 1 over
    a ``max_len``-deep linear KV cache (INT8 under ``kv_quant=8``), the
    token picked."""
    from repro_torch.core.parallel_adapters import init_adapter_cache

    params = abstract_params(cfg, quant_bits)
    adapter = init_adapter(None, cfg, r, device=META)
    cache = init_cache(cfg, 1, max_len, device=META, kv_quant=kv_quant)
    acache = init_adapter_cache(cfg, 1, max_len, r, device=META)

    def step(params, adapter, tokens, cache, acache, pos):
        logits, _, _ = steps.pac_decode_step(params, adapter, {"tokens": tokens}, cache, acache,
                                             pos, cfg=cfg, r=r, kernel_impl="cuda")
        return logits[:, 0].argmax(dim=-1)

    args = (params, adapter, _meta((1, 1), torch.int32), cache, acache,
            _meta((1,), torch.int64))
    note = " ".join(n for n in (f"int{quant_bits}" if quant_bits else "",
                                f"kv{kv_quant}" if kv_quant else "") if n)
    return Case(name=f"{cfg.name}×personal decode", fn=step, args=args, cfg=cfg,
                shape=InputShape("personal_decode", max_len, 1, "decode"), note=note)
