#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit; TF32 off for float32
   matmuls and convolutions, so every plain version runs in full f32.
2. Build: compile the kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a (one process per source, all at once).
3. Serving kernels: ``quant_matmul``, flash and paged attention against
   their plain PyTorch versions at the serving path's shapes, with the
   stated tolerance; the device time per call (CUDA graph replays, L2
   cold; see ``Timer``) of the kernel, the plain version and one
   PyTorch call for the same function (a yardstick the port never
   calls), and the least time the card could take. ``quant_matmul`` at
   the decode step's M = 8 (the skinny path: one launch of
   ``skinny::gemv``, the contraction split over a thread block cluster
   and summed through distributed shared memory) and at M = 2048 and 4096
   (the tiled path, ``qmm_mma`` on the bf16 tensor cores with x·s split
   in three terms: the epoch-1 step's and the prefill's rows), one
   layer's seven projections summed at each M (``quant_matmul_layer``
   lines), each tiled line beside both its bounds (the tensor cores' with
   3 products, and f32's); int4 at M = 8 and 4096; the skinny path at
   M = 3, K = 1000 (a partial last slice), the tiled path at its smallest
   M = 9 and at M = 1001 with K = 1000 (masked M and K) and K = 998 (rows
   unaligned for 16-byte loads), N = 384, int8 and int4
   (``quant_matmul_ragged`` lines), and twice at M = 4096, K = 2048,
   N = 8192 and at M = 1, K = 8192, N = 2048
   (``quant_matmul_deterministic``: bit-equal). Flash attention
   (on the bf16 tensor cores, Q, K, V and P split in three terms) at the
   prefill shape beside both its bounds (12 bf16 products, and f32's) and
   SDPA's kernel names, with window 128 and soft-cap 30, at Sq = Sk = 37
   and 1001, hd 64 and 128, n_rep 1 and 2, each causal or not, window 32
   or none, soft-cap 30 or none (``flash_attention_ragged`` lines), and
   twice at the prefill shape (``flash_attention_deterministic``:
   bit-equal), and with Sq = 300 queries over Sk = 100 keys, window 32,
   where rows 131.. have no key and get V's mean, the reference's answer
   (``flash_attention_keyless``). Paged attention (one launch: each
   request's pages split over a thread block cluster, staged by cp.async,
   merged in rank order through distributed shared memory) at the check's
   shape (B = 8, Hkv = 8, n_rep = 2, hd = 128, int8 pages of 16 tokens,
   lengths <= 511) and at a long context (lengths <= 4095, max_pages 256),
   each beside its byte bound, the plain version and SDPA over gathered
   KV; at B 1, 2, 3, 5, 8 and 72, Hkv 2, 4 and 8, n_rep 1, 2, 3, 5 and 8,
   hd 64 and 128, pages of 4 and 16 tokens, lengths on page edges up to
   543 and padding rows, f32, bf16 and int8 pages, plain, soft-cap 30,
   window 64 with soft-cap 30, and window 20 (``paged_attention_ragged``
   lines, unaligned pools too); and
   two calls and three CUDA-graph replays bit-equal
   (``paged_attention_deterministic``).
4. Serving: internlm2-1.8b at full width (24 layers, d=2048), random
   weights from a seeded generator, INT8 backbone and INT8 KV pages,
   4 users with r=8 adapters, 8 requests with ragged prompts, 16 new
   tokens each, through ``ServeEngine``. Launch counts are read from
   this run alone and must all be positive. Two more decode steps run
   under ``torch.profiler`` for the device's busy share and kernel time
   by name. Then the first prefill and two decode steps run again under
   the ``ref`` OpSet, and the logits are compared.
4a. Other KV pages (``f32_kv_serving``, ``bf16_kv_serving``): paged
   attention over f32 and bf16 pages at the check's shape (its unscaled
   branch), timed; then the same backbone, users and prompts served over
   each, 8 new tokens, paged attention launched; the prefill and two
   decode steps under ``cuda`` and ``ref`` within 2e-4 (f32) and 2e-2
   (bf16; ``KV_TOL_REASON``), greedy equal; KV bytes a token and the
   walls beside the int8 cell's.
4b. A bound pool (``page_bound_serving``): the largest pool below what
   the prompts need at once on which the host replay of the page table
   (:func:`admission_replay`) waits, prefills in waves of different
   buckets and never runs out (:func:`tight_pool`); 8 new tokens under
   ``cuda`` and ``ref``: each run's admissions equal the replay's, the
   streams are equal, no more than ``n_pages`` - 1 pages are held, all
   are free at the end.
4c. INT4 kernels: ``quant_matmul`` at int4 over internlm2's four
   projection shapes at M = 1, 8, 2048 and 4096 (skinny and tiled), each
   against its plain version, timed beside its bound and ``torch.matmul``
   on the dequantized weight; a layer's seven summed.
4d. An INT4 backbone (``int4_serving``, ``pac_run`` with ``quant: 4``,
   ``int4_personal``): drawn once, served to the int8 cell's users and
   prompts (8 new tokens; the serving gate; token agreement with the
   INT8 backbone's streams printed), trained (2 epochs x 2 steps of 4 x
   512, its checkpoint and persistent cache written; the cached-step and
   trainer gates) and its checkpoint personal-served (the prompt's
   prefill, then 12 ``pac_decode_step``s over INT8 and f32 KV; 2e-2 and
   2e-4, greedy equal). ``quant_matmul``'s launches are counted by
   branch: the tiled path must run in the serving prefill, the epoch-1
   step and the personal prefill, the skinny GEMV in the serving and
   personal decode steps.
4e. The reference's bf16 backbone (``bf16_serving``, ``bf16_training``,
   ``bf16_personal``): the kernels' bf16 branches at its shapes first
   (flash with bf16 q, k, v and O on ``flash_fwd_wg``, TMA + wgmma, at
   the prefill and epoch-1 shapes, one bf16 rounding of O from its plain
   version, beside SDPA in f32 on the upcast inputs, the reference's
   function, and SDPA on bf16; two calls bit-equal; S 37 and 1001, n_rep
   1 and 2, causal or not, window 128, soft-cap 30; Sq 300 over Sk 100;
   paged attention with a bf16 q over int8, bf16 and f32 pages; the CE
   pair with the bf16 head, and a bf16 h); then a bf16 internlm2-1.8b
   (each leaf drawn in f32 and cast, as the reference casts its draw)
   served to the int8 cell's users and prompts (8 new tokens, int8
   pages; the prefill and two decode steps under ``cuda`` and ``ref``
   over int8, bf16 and f32 pages by :func:`bf16_logits_gate`: within
   twice the port's own move at full depth, ``BF16_OWN_MOVE``), trained
   (2 epoch-1 and 2 cached steps of 4 x 512 through the step entry
   points under both OpSets: losses within 3e-2, the bf16 taps within
   twice their own move) and personal-served (prefill, then 8 decode
   steps at B = 1 over f32 linear KV, within the ``personal_gap``'s 2e-4,
   greedy tokens equal). No weight is quantized, so
   ``quant_matmul`` never runs on this path.
5. Training kernels: flash attention timed at the epoch-1 step's
   B·H = 4·16; ``mix_fwd``/``mix_dw`` and ``ce_fwd``/``ce_bwd`` the
   same way at the training path's shapes (ragged and soft-capped cases
   too), and the gradients of their two autograd Functions against
   autograd of the plain versions. ``mix_fwd`` and ``mix_dw`` (both on
   the bf16 tensor cores) also at T=1001, d=1000, d_a=100 with int8
   scales per 32 columns (every masked edge, scales changing inside a
   tile; ``mix_fwd`` with f32 and bf16 ``a`` too) and at T=37, d=130,
   d_a=17 with qblock 24 (unaligned rows; ``mix_fwd``'s dequantizing
   path), twice at the training shape (bit-equal), and beside both their
   bounds: the bf16 tensor cores' (a 3-term split triples the operations)
   and f32's. ``ce_fwd`` and ``ce_bwd`` (on the bf16 tensor cores, every
   f32 operand split in three terms: the forward's logits, then the
   backward's logits again and ``dh = P @ Wᵀ``) also at T=1001, d=1000,
   V=3001 and T=37, d=130, V=517 with and without the soft-cap (every
   masked edge; ``ce_bwd`` on the lse of the plain forward), twice at the
   training shape with and without it (bit-equal), and beside both their
   bounds (6 products, 12 for the backward). ``ce_bwd`` is also timed
   beside the backward alone of autograd on a graph built once (no
   logits recompute), which the library time, with its forward, is not.
6. Training: PAC+ on internlm2-1.8b at full width through
   ``EdgeSession``/``EpochRunner`` — INT8 backbone, int8 activation
   cache, pruning init, 3 epochs x 2 steps of 4 x 512 tokens: epoch 0
   full (frozen forward through ``quant_matmul`` and flash attention,
   taps emitted int8, copied to pinned host buffers on a side stream),
   epochs 1-2 from the cache through the mix and CE kernels, their
   batches read, stacked and copied by the ``CachePrefetcher`` that
   ``EdgeSession.epoch_scope`` arms. Launch counts from this run alone
   must all be positive.
   One cached batch then goes through the cached step under ``cuda`` and
   ``ref`` (loss and gradients compared), one full and one cached step
   run under ``torch.profiler``, and the same trainer runs under ``ref``
   (per-epoch losses compared). The run writes its adapter checkpoint
   and a persistent activation cache into a temporary directory
   (``persistence`` line): the checkpoint loads back bit-equal; a second
   run (1 epoch x 2 steps) over the cache directory is warm — every step
   cached, no ``quant_matmul``/``flash_attention`` launch, the first
   run's epoch-0 losses (its entries read off disk by the prefetcher's
   worker); another seed invalidates and re-captures it.
7. Personal kernels: ``adapter_fuse`` against its plain version (f32 and
   bf16, λ in {0, 0.5, 1}) at T = 1, 8, 2048 and ragged shapes on both
   of its paths (T <= 8: one launch of ``skinny::gemv``, with T = 3,
   d = 2047, d_a = 130 on its element-by-element loads), timed beside the
   plain version and ``torch.addmm`` (the tiled path, on the tensor
   cores, beside both its bounds); ``quant_matmul`` at M = 1; two calls
   bit-equal (``adapter_fuse_deterministic``) and both GEMV calls captured
   in a CUDA graph, replayed three times, equal to the eager call bit for
   bit (``skinny_graph_replay``); flash attention and ``quant_matmul`` at
   the prompt's shapes.
8. Personal: the checkpoint served with ``pac_decode_step`` at B = 1
   over an INT8 linear KV cache, 32 teacher-forced prompt tokens then
   16 greedy tokens, under ``cuda`` (launch counts from this run alone:
   ``adapter_fuse`` 24 and ``quant_matmul`` 168 per step) and ``ref``
   (equal tokens, logits compared), two steps under ``torch.profiler``;
   ``prefill_step`` against the teacher-forced f32-KV decode, and INT8
   against f32 KV. The same loop over an f32 KV cache under both OpSets
   (``personal_gap`` line: each step's gap, and the INT8 KV codes that
   the two INT8 runs wrote differently) holds ``cuda`` to ``ref``
   without the INT8 codes' one-step flips.
9. Prefetch: the cached epoch's input path at full width, 6 steps of
   4 x 512 tokens, int8 cache (``prefetch`` line). Epoch 0 fills the
   cache; from one snapshot the cached epoch then runs in turns through
   ``EpochRunner`` (the prefetcher: pinned ring, side-stream copies)
   and through ``step`` with no epoch scope (read and copied on the
   caller's thread), twice each, the second time with one step under
   ``torch.profiler``: per-step losses bit-equal, the prefetched batch's
   host→device copies ``Pinned -> Device`` on a stream no kernel runs
   on, epoch 1's tap copies ``Device -> Pinned``, no worker thread left;
   per-step wall times, medians, busy shares and memory high-water marks.
10. Distributed: first the six kernels of this path against their
   plain versions at the shapes one rank gives them (``quant_matmul`` at
   M = 512 over the layer's projections, flash at B·H = 1·16 x 512,
   mix and CE at T = 1024 and 512, int8 entries; ``*_distributed``
   lines); then the training phase's spec at dp=2 x stages=2 (12
   periods a stage, 2 micro-batches) through ``EdgeSession`` and
   ``EpochRunner`` in four ranks that ``repro_torch.launch.mesh.spawn``
   starts on the one card, over gloo, twice (``distributed`` line).
   Epoch 0 pipelines the frozen forward (``quant_matmul``, flash) over
   each dp row's two stages and runs the adapter step (mix and CE
   kernels) on each row's first stage; epochs 1-2 run the cached step
   over all four ranks, the owner (rank 0) scattering the cached rows.
   Gates: the first step's loss within 1e-4, every step's within 1e-5
   and the epoch means within 5e-2 of the training phase's; epoch 0's cache entries against the
   training phase's: b0 codes bit-equal, tap and b_final codes within one
   step (the share that moved printed); every rank's adapter and
   optimizer bit-equal after every step, and the losses of the two runs;
   each training kernel launched on the ranks that run it. Per rank and
   step: wall time, launches, bytes sent point to point and all-reduced
   with their host seconds; each rank's memory high-water mark. A third
   run in the same ranks reshards from an ``on_step`` hook
   (``EdgeSession.reshard``): dp 1 over ranks 0-1 after epoch 0 (ranks
   2-3 parked), dp 2 again after epoch 1, when the owner broadcasts its
   adapter and optimizer to the returning ranks (``reshard`` line).
   Gates: epoch 0 bit-equal to the first run, every later step within
   1e-5 of it; the members bit-equal in adapter and optimizer after every
   step; the parked ranks launching no kernel and moving no byte; each
   member's mix and CE kernels at T = 1024 (two rows) in epoch 1 and 512
   in epoch 2. Per rank and step the mode, wall time, launches, token
   counts and bytes; each reshard's seconds and bytes broadcast; each
   rank's memory high-water mark and the run's seconds.
11. Plan: the planner (Alg. 1) and plan-driven training. First
   ``quant_matmul`` at M = 1024 and flash at B·H = 2·16 x 512, the shapes
   a stage of the plan below gives them (``*_plan`` lines). The port's
   planner makes a ragged 3-stage plan of full internlm2-1.8b over a
   Jetson Nano (low power), a TX2 and a Nano (high), each holding half
   the backbone's weights and adapter state (micro-batch 2, 2
   micro-batches); its boundaries must be the JAX planner's (0, 5, 16,
   24), and it is saved as JSON. The calibrated cost model counts the
   full-width step's FLOPs on the meta device (``plan_calibration``).
   The training phase's spec then replays the saved plan
   (``plan=<file>, pool=3``), resolved once here and run as 3 gloo ranks
   on the card, dp=1 x 3 ragged stages: modes ``plan-driven dp1xpp3``,
   then ``cached pure-dp`` twice, the distributed phase's gates against
   the training phase's run, and each stage launching ``quant_matmul``
   7 x its periods x 2 micro-batches in epoch 1. Last ``plan="auto",
   pool=4, micro=2``: Alg. 1 picks (12, 12) on dp=2 x pp=2, and every
   step's loss and every rank's fingerprint equal the distributed
   phase's first run bit for bit. The ``plan`` line carries per rank its
   periods, step walls, launches, transfer bytes and host seconds and
   memory, and the planner's latency and simulated bubble fraction,
   estimates for the modelled Jetson devices, not times on the card.
12. Fleet: the training phase's spec (no checkpoint, no cache
   directory) as ``SessionJob``s under ``FleetScheduler`` on a
   ``SimClock`` (heartbeat timeout 1.5 s a tick), every member on the
   one card (placement and resharding, not transfers between cards):
   (a) ``alice`` alone on a bound pool of four members; (b) the same
   with ``dev1`` killed at tick 3, inside the first cached epoch; (c)
   ``alice`` and ``bob`` (seed 1) on one member with quantum 2,
   preempted through snapshots on disk; (d) one elastic step of (a)'s
   first cached batch under ``ref`` against ``cuda``. Capture steps run
   ``EdgeSession.step``, each cached step four one-sequence chunks of
   the mix and CE kernels summed in chunk order. Gates: (b) and (c)'s
   ``alice`` equal (a) bit for bit (every loss and the adapter's
   fingerprint), ``dev1`` detected lost and never placed after; (a)'s
   capture steps equal the training phase's bit for bit, its cached
   steps within 1e-5 and epochs within 5e-2; (d) loss within 2e-5,
   gradients within 1e-4·max(1, |g|max); (a)'s launches a step: 168
   ``quant_matmul``, 24 flash, 25 mix and 1 CE each in a capture step,
   100 mix and 4 CE each in a cached step (``fleet`` line: per run the
   ticks' placements, shares, lost and preempted, each step's wall time,
   mode and launches; memory high-water mark, phase time).
12a. Pipeline gradients (``pipeline_grads`` line): first the distributed
   path's kernel checks again at its shapes (``*_pipeline_grads`` lines),
   then four gloo ranks on the card. (a) internlm2-1.8b as a dense f32
   backbone under ``ref``, dp 1 x 4 stages of 6 periods, 4 x 512 tokens
   in 4 micro-batches: each stage's slab trained through
   ``pipeline_grads`` (the backbone's CE on stage 0), held to one
   process's autograd of the same loss (each rank runs it in turn on
   the whole backbone): loss within 1e-5, gradients within
   1e-4·max(1, |g|max) (``PG_TOL_REASON``); each rank's F/B ops its
   stage's 1F1B list with at most S − s graphs alive, and its backward's
   bytes those of its forward; per rank the step's wall, forward and
   backward seconds, bytes and peak memory. (b) PAC+ on the INT8
   backbone under ``cuda`` with int8 taps, dp 2 x stages 2, through
   ``pipeline_grads`` with the adapter trainable: loss and gradients
   bit-equal to ``pipeline_pac_loss_and_grads``, no bytes beyond the
   forward's, and a ``distributed`` epoch-1 step's launches a rank.
12b. Roofline (``roofline`` line): the five internlm2-1.8b cells timed
   above (the serving engine's 8 x 512 prefill wave and a decode step at
   B = 8 over INT8 pages, the personal decode step at B = 1, the epoch-1
   and the cached step at 4 x 512) priced on the meta device at those
   shapes by ``repro_torch.launch`` (the ``cuda`` OpSet's program, each
   kernel call a unit): the three roofline terms on the card's constants
   and ``t_compute_f32``, the bottleneck, model FLOPs and useful-compute
   ratio, the phase's wall (no new timed run) and ``share``, the largest
   term over the wall, which must lie in (0, 1.05]. Then the dry run
   (``dryrun`` line): internlm2-1.8b at the four input shapes through
   ``launch.dryrun.run_case``. The distributed line (10) also carries
   the dry run's per-rank point-to-point and all-reduce bytes of an
   epoch-1 and a cached step at dp 2 x stages 2, which must equal what
   ``EdgeMesh.stats`` counted for each rank and step.
13. Head width 256: flash attention at gemma2-2b's prefill (B·H = 8·8
   over 4 kv heads, S = 512; soft-cap 50, and window 128 with it) and
   epoch-1 (4·8) shapes, timed beside both bounds and SDPA, two calls
   bit-equal, its ragged and keyless cases at hd 256, and granite-20b's
   MQA (B·H = 1·48 over one kv head, hd 128); paged attention at B = 8,
   Hkv = 4, n_rep = 2, hd 256, int8 pages of 16 (lengths <= 511 and <=
   4095), its ragged cases at hd 256 (window 64 and soft-cap 30 among
   them), bit-equal reruns and graph replays. Then gemma2's widths:
   ``quant_matmul`` over a layer's seven projections (K = 2304 and 9216)
   at M = 4096 and 8, ``mix_fwd``/``mix_dw`` at d = 2304, d_a = 288,
   ``ce_fwd``/``ce_bwd`` over the 256000-token vocabulary with soft-cap
   30, ``adapter_fuse`` at T = 1 and 8.
14. gemma2-2b serving at full width (``gemma2_serving`` line): 26
   layers, random seeded INT8 weights, 4 users with r = 8 adapters, INT8
   KV pages of 16, the serving phase's 8 requests and a ninth of 4500
   tokens (its own wave: flash prefill and paged decode cross the 4096
   window), 8 new tokens each, through ``ServeEngine``; then each wave's
   prefill and two decode steps under ``cuda`` and ``ref``: logits within
   2e-2, greedy tokens equal.
15. gemma2-2b training (``pac_run`` line): PAC+ through ``EdgeSession``/
   ``EpochRunner``, 2 epochs x 2 steps of 4 x 512 tokens, INT8 backbone,
   int8 cache, pruning init (d_a = 288, one head of 288); the cached step
   ``cuda`` against ``ref`` (loss 2e-5, gradients 1e-4·max(1, |g|max))
   and the trainer's epochs under both (5e-2).
16. gemma2-2b personal (``gemma2_personal`` line): the trained adapter,
   12 ``pac_decode_step``s at B = 1 over an f32 linear KV cache under both
   OpSets: each step within 2e-4, greedy tokens equal, 13
   ``adapter_fuse`` and 182 ``quant_matmul`` launches a step.
16b. The reference's bf16 backbone at gemma2-2b (``gemma2_bf16_serving``,
   ``gemma2_bf16_training``, ``gemma2_bf16_personal``): the bf16 branches
   at head widths 256, 64 and 112 first (flash with bf16 q, k, v and O
   on ``flash_pad`` + ``flash_fwd_mma<hd, bf16>`` at gemma2's prefill
   (B·H 8·8 over 8·4, S 512, soft-cap 50), its 4500-token prompt (1·8
   over 1·4, window 4096), its epoch-1 step (4·8 over 4·4), t5-base-pac's
   (4·12, hd 64) and kimi-k2's (4·64 over 4·32, hd 112, soft-cap 30,
   window 128), each within one bf16 rounding of O from its plain version,
   two calls bit-equal, beside SDPA in f32 on the upcast inputs and SDPA
   on bf16; the ragged and keyless cases at the three widths; paged
   attention with a bf16 q at B 8 and hd 256 (Hkv 4, n_rep 2, soft-cap
   50; lengths <= 511 and <= 4095), 112 (Hkv 8, n_rep 8) and 64 (Hkv 12,
   n_rep 1) over int8, bf16 and f32 pages, reruns and graph replays
   bit-equal, its ragged cases at the three widths; the CE pair with
   gemma2's tied bf16 head, d 2304, V 256000, soft-cap 30, read in place);
   then a bf16 gemma2-2b at full width and depth served to 14's users
   and prompts (8 new tokens, int8 pages; each wave's prefill and two
   decode steps under ``cuda`` and ``ref`` over int8, bf16 and f32 pages
   by :func:`bf16_logits_gate` on gemma2's own move), trained (as 4e,
   the tied bf16 head) and personal-served (as 4e). Flash 26 launches a
   prefill, paged attention 26 a decode step, the CE pair one each a
   step, ``quant_matmul`` none.
17. The paper's Table III models (t5-base-pac, bart-large-pac,
   t5-large-pac): each trained as in 15, with its gates.
18. musicgen-large (``musicgen_prefill`` line): 48 layers at full width,
   no rope, fed seeded frame embeddings (4 x 512): ``prefill_step`` under
   ``cuda`` against ``ref``, last-position logits within 2e-2.
19. Baselines (``baselines`` line): first the training kernels at
   t5-base-pac's widths (``*_width`` lines). Then Table V's five
   techniques (``benchmarks/bench_step_time.py``) on t5-base-pac and
   internlm2-1.8b at full width, dense f32 backbones from the seed, 4 x
   512 tokens, TF32 off: full fine-tuning, LoRA and Houlsby adapters
   (plain ops and plain autograd, as in the reference: the ``ref``
   attention's blocked backward recomputes its scores), PAC+'s epoch-1
   and cached steps under ``ref`` on the same backbone and under
   ``cuda`` on its INT8 quantization; per row the median per-sample ms
   of 2 steps after a warm-up, peak memory, trainable parameters,
   losses and launches (internlm2's rows a profiled step too), per model
   the time and memory savings
   (reported). Gates: LoRA's and Houlsby's logits at init bit-equal to
   the backbone's; each baseline's losses falling; one step of each on
   reduced internlm2 on the card against the CPU (loss 1e-5, parameters
   5e-5 but for near-zero gradients).
20. Distill (``distill`` line): ``quant_matmul`` at M = 1024 and flash at
   B·H = 2·16 (``*_distill`` lines), then ``distillation_init``'s loop
   on internlm2-1.8b at full width (INT8 backbone, pruning start, 8
   steps over 2 batches of 2 x 512) with the teacher through ``cuda``
   (launches a step counted) and ``ref``: the loss falls in both, the
   runs agree per step within 1e-3 of the loss and in the adapter
   (``DISTILL_TOL_REASON``).
21. Head width 112 (kimi-k2): flash attention at kimi's layout, B·H =
   4·64 over 8 kv heads a sequence (n_rep 8), S = 512, causal, timed
   beside both bounds and SDPA (soft-cap 30, and window 128 with it,
   checked), two calls bit-equal, its ragged and keyless cases at hd 112;
   paged attention at B = 8, Hkv = 8, n_rep = 8, hd 112, int8 pages of
   16 (lengths <= 511 and <= 4095), its ragged cases at hd 112 (f32, bf16
   and int8 pages; window 64 with soft-cap 30, window 20), bit-equal
   reruns and graph replays.
22. One MoE layer (``moe_layer`` line): mixtral-8x7b's FFN at full width
   (d 4096, 8 experts of 14336, top-2), INT8 experts dequantized as the
   OpSets do, T = 4 x 512 tokens sharing a common direction, capacity
   factor 1.25: two calls bit-equal (routes too), ``dropped_frac`` > 0,
   the layer's and the dequantization's device times; at capacity factor
   E within 1e-4 of ``moe_forward_dense``. No kernel: the MoE runs
   outside any kernel in both packages.
23. mixtral-8x7b's widths: ``quant_matmul`` over a layer's four attention
   projections (K = 4096, N = 4096 and 1024) at M = 8 and 4096, flash at
   B·H = 4·32 over 8 kv heads, paged at Hkv = 8, n_rep = 4, ``mix_fwd``/
   ``mix_dw`` at d = 4096, d_a = 512, ``ce_fwd``/``ce_bwd`` over V =
   32000, ``adapter_fuse`` at T = 1 and 8.
24. mixtral-8x7b serving (``mixtral_serving`` line): 32 layers at full
   width, random seeded INT8 weights (46.7 B parameters), 4 users with
   r = 8 adapters, INT8 KV pages of 16, the serving phase's 8 requests,
   8 new tokens each, through ``ServeEngine``; then their prefill and
   two decode steps under ``cuda`` and ``ref`` with every MoE layer's
   routes recorded: at least 99.9 % of tokens routed alike in every
   layer, and where a request's tokens routed alike in every layer so
   far, logits within 2e-2 and greedy tokens equal (the rows compared
   and excluded printed).
25. mixtral-8x7b training (``pac_run`` line): as 15, 2 epochs x 2 steps
   of 4 x 512, with one full and one cached step profiled. The card holds
   one 48 GB backbone: the ``cuda`` session's is released before the
   ``ref`` trainer opens its own, the same seeded draw (fingerprints
   equal), which 26 then serves.
26. mixtral-8x7b personal (``mixtral_personal`` line): 12
   ``pac_decode_step``s at B = 1 over an f32 linear KV cache under both
   OpSets, routes recorded: every layer's routes alike, each step within
   2e-4, greedy tokens equal, 32 ``adapter_fuse`` and 128
   ``quant_matmul`` launches a step.
27. xlstm-125m's widths: ``mix_fwd``/``mix_dw`` at d = 768, d_a = 96,
   ``ce_fwd``/``ce_bwd`` over V = 50304, ``adapter_fuse`` at T = 1 and
   8 (no ``quant_matmul``, flash or paged: its mixers run dense, it has
   no attention and no FFN).
28. xlstm-125m serving (``xlstm_serving`` line): 12 layers (9 mLSTM, 3
   sLSTM) at full width, random seeded INT8 weights, 4 users with r = 8
   adapters, through ``ServeEngine``'s stepwise prompt path: 8 requests
   of 32-128 prompt tokens, 8 new each, through 4 slots (4 admissions
   into retired rows), under ``cuda`` and ``ref``: every stream equal;
   16 teacher-forced steps under both, logits within 2e-2, greedy
   equal; the first prompt stepwise against one ``pac_logits`` pass
   within ``STEPWISE_TOL``. No kernel runs on this path (launches
   reported).
29. xlstm-125m training (``pac_run`` line): as 15 but 2 epochs x 1
   step (its steps are host-bound, ~6 s), its path's kernels the mixes
   and the CE (4, 4, 1, 1 a step); the cached step's gate
   with mLSTM blocks also takes 8x the ``ref`` step's own move under a
   halved or quartered chunk. Then ``xlstm_personal``: 12
   ``pac_decode_step``s at B = 1 over the SSM state under both OpSets,
   within 2e-4, tokens equal, 3 ``adapter_fuse`` a step.
30. One Mamba mixer (``mamba_layer`` line): jamba-1.5-large-398b's at
   full width (d 8192, d_inner 16384, d_state 16), INT8 leaves
   dequantized: ``mamba_forward`` over 2 x 1024 tokens against
   ``mamba_decode`` step by step, outputs and final state within 2e-4
   of their scale; times and peak memory. No kernel.
31. jamba-1.5-large-398b at ``reduced()`` (a reduced config, so labelled
   on every line): ``quant_matmul`` (W_k 64 wide: one block a row,
   padded), flash, paged and the training kernels at its widths, then a
   ``jamba_hybrid`` line: the hybrid stepwise engine (attention pages
   beside Mamba state rows, MoE) under ``cuda`` and ``ref``, streams
   equal, and a PAC+ session (full, then cached) with its gates, with
   ``quant_matmul``, flash and paged attention launched and counted.
32. qwen2-vl-7b's widths: ``quant_matmul`` over a layer's seven
   projections (K = 3584 and 18944) at M = 8 and 4096, ``mix_fwd``/
   ``mix_dw`` at d = 3584 and the adapter's ragged d_a = 444,
   ``ce_fwd``/``ce_bwd`` over V = 152064, ``adapter_fuse`` at T = 1
   and 8, flash at B·H = 8·28 over 8·4 (n_rep 7) and ragged at n_rep 7,
   paged at B = 8, Hkv = 4, n_rep = 7 (lengths <= 511 and <= 4095),
   ragged at n_rep 7, reruns and graph replays bit-equal.
33. qwen2-vl-7b serving (``qwen2vl_serving`` line): 28 layers at full
   width, random seeded INT8 weights (7.62 G parameters), 4 users with
   r = 8 adapters, 8 requests of 64-480 prompt tokens and 8 new through
   ``ServeEngine``, then prefill and two decode steps under ``cuda`` and
   ``ref``: logits within 2e-2, greedy equal; ``quant_matmul``, flash
   and paged attention launched.
34. qwen2-vl-7b training (``pac_run`` line, as 15) with its cached-step
   and trainer gates, then ``qwen2vl_personal`` (as 29: 12 steps over
   f32 KV within 2e-4, tokens equal, 196 ``quant_matmul`` and 28
   ``adapter_fuse`` a step).
35. mrope with distinct streams (``qwen2vl_mrope`` line): one batch of
   4 x 512 tokens laid out as text, an image grid and text (three
   position streams that differ): the PAC+ logits ``cuda`` against
   ``ref`` within 2e-2, one epoch-1 and one cached step (its batch
   carrying the positions) within 2e-5 in loss and 1e-4·max(1, |g|max)
   in gradients, and the logits with equal streams more than 0.2 away.
36. moonshot-v1-16b-a3b's widths: ``quant_matmul`` over a layer's four
   attention projections (K = N = 2048) at M = 1, 8, 2048 and 4096,
   ``mix_fwd``/``mix_dw`` at d = 2048, d_a = 256, ``ce_fwd``/``ce_bwd``
   over V = 163840, ``adapter_fuse`` at T = 1 and 8, flash at B·H = 8·16
   over 8·16 (n_rep 1) and the adapter's 4·2, paged at B = 8, Hkv = 16,
   n_rep = 1, ragged at Hkv 16, reruns and graph replays bit-equal.
37. moonshot-v1-16b-a3b served (``moonshot_serving``, as 24: 48 layers,
   64 experts of 1408 top-6, V = 163840, 28.1 G parameters), trained
   (``pac_run``, as 25, its edge-pool plan over ``MOONSHOT_POOL``
   devices) and personal-served (``moonshot_personal``, as 26: 48
   ``adapter_fuse`` and 192 ``quant_matmul`` a step), under the same
   logit, cached-step and epoch gates; its routes are gated in the
   forced comparison (``ref`` following the ``cuda`` routes, each
   layer's own choice >= 99.9 %), the free run's share printed: the
   reference's own routes move under one ulp a layer at its depth
   (``ROUTE_OWN_MOVE``). Every MoE serving and personal phase, mixtral's
   too, runs the forced comparison beside the free one.
38. grok-1-314b's widths: ``quant_matmul`` (K = 6144, N = 6144 and 1024)
   at M = 1, 8, 2048 and 4096, mix at d = 6144, d_a = 768, CE over V =
   131072, ``adapter_fuse``, flash at B·H = 8·48 over 8·8 (n_rep 6) and
   the adapter's 4·6 over 4·1, both with soft-cap 30, ragged at n_rep 6,
   paged at B = 8, Hkv = 8, n_rep = 6 with soft-cap 30 (lengths <= 511
   and <= 4095), ragged at n_rep 6, reruns and graph replays bit-equal.
39. grok-1-314b at full width over ``GROK_LAYERS`` layers
   (:func:`grok_cut`), served, trained and personal-served as 37. No
   Jetson Nano-H pool holds one of its layers, so its sessions open on a
   one-device layout (:func:`single_device_layout`) once the planner has
   refused. The ``done`` line carries every such phase's peaks.
40. Summary: one JSON line ``{"kernels": [...]}`` (eight kernels, each
   with its launches on every path, the ``reshard`` run's among them,
   the hd 256, gemma2, hd 112, mixtral, xlstm, jamba_reduced, qwen2vl,
   moonshot and grok rows beside the first, paged attention's
   ``unscaled`` and ``quant_matmul``'s ``int4`` rows (with its int4
   launches by path and branch), and its
   device kernels by name:
   ``skinny::gemv`` for ``quant_matmul`` at M <= 8 and ``adapter_fuse``
   at T <= 8), the card's line, and last ``{"ok": true, "device":
   {...}}``.

``python3 chip_smoke.py --bf16-own-move [--arch gemma2-2b]`` builds the
kernels, then runs only :func:`bf16_own_move`: the port's ``ref`` OpSet on
the bf16 internlm2-1.8b (or gemma2-2b) on the card against the same
program on the host's CPU, whose readings are ``BF16_OWN_MOVE[arch]``,
the yardstick of 4e's and 16b's gates.

Needs one CUDA card and the repository's ``src`` beside this file; it
imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
DEV = "cuda"
T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# the card's peaks, one source for every bound: the port's roofline
# constants (NVIDIA H100 SXM data sheet)
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_FLOP_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_F32 as F32_FLOP_PER_S  # noqa: E402

REPEATS = 5

QMM_SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048)]  # (K, N)
QMM_SKINNY_ROWS = 8  # quant_matmul's tiled path runs above this M (csrc/quant_matmul.cu)
PATH_QMM_ROWS = (1, 8, 2048, 4096)  # personal decode, serving decode, epoch-1 step, prefill
#: the seven projections of one internlm2-1.8b layer, by (K, N)
#: the decode path's kernels, by name in a profile: the GEMV (quant_matmul
#: at M <= 8, adapter_fuse at T <= 8), paged attention
SKINNY_WATCH = ("skinny::gemv", "paged_attn")
LAYER_PROJECTIONS = [(2048, 2048), (2048, 1024), (2048, 1024), (2048, 2048),
                     (2048, 8192), (2048, 8192), (8192, 2048)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, flop_per_s: float = F32_FLOP_PER_S):
    """The least time for the work: bytes over the HBM rate or operations
    over the card's peak for the operands' type (f32 by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Device time of one call: ``CALLS`` calls captured in a CUDA graph
    and replayed back to back (so host launch overhead is not counted),
    median over ``REPEATS`` replays, L2 flushed before each replay. Pass
    several closures over distinct input copies to cycle through them, so
    that inputs smaller than the 50 MB L2 are read cold, as in a decode
    step that walks 24 layers."""

    CALLS = 6
    #: the host seconds every timing of this run took, summed over all
    #: timers: ``setup_s`` before the first replay (the warm-up call and the
    #: capture), ``replay_s`` in the replays, ``first5_s`` in each timing's
    #: first five replays (what ``REPEATS`` = 5 would have taken)
    spent = {"timings": 0, "setup_s": 0.0, "replay_s": 0.0, "first5_s": 0.0}

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # > 50 MB L2

    def __call__(self, fns, calls: int = CALLS, repeats: int = REPEATS) -> float:
        """``calls``/``repeats`` shrink for calls of tens of milliseconds."""
        t0 = time.perf_counter()
        fns = fns if isinstance(fns, list) else [fns]
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(calls):
                fns[i % len(fns)]()
        ms = self._median(graph.replay, calls, repeats, t0)
        del graph
        return ms

    def eager(self, fn, calls: int, repeats: int) -> float:
        """The same without a CUDA graph, ``calls`` calls launched from the
        host each time (for work that cannot be captured, in calls of
        milliseconds, where the host's launches hide)."""
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return self._median(lambda: [fn() for _ in range(calls)], calls, repeats, t0)

    def _median(self, run, calls: int, repeats: int, t0: float) -> float:
        spent = Timer.spent
        spent["timings"] += 1
        spent["setup_s"] += time.perf_counter() - t0
        times = []
        for i in range(repeats):
            t1 = time.perf_counter()
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
            took = time.perf_counter() - t1
            spent["replay_s"] += took
            spent["first5_s"] += took if i < 5 else 0.0
        return statistics.median(times)


def copies(nbytes: int) -> int:
    """Input copies to cycle through so that they exceed the L2 twice."""
    return max(1, -(-(128 << 20) // max(nbytes, 1)))


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max |kernel - plain| = {err:.3e} > {tol:.1e}")


# ---------------------------------------------------------------- kernels


def qmm_case(timer: Timer, gen: torch.Generator, M: int, K: int, N: int, bits: int) -> dict:
    """``quant_matmul`` at (M, K, N) against its plain version, timed
    beside the plain version and cuBLAS on the pre-dequantized weight."""
    from repro_torch.core.quantization import dequantize, quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_matmul import quant_matmul

    x, w, got, want = qmm_check(gen, M, K, N, bits)
    nbytes = M * K * 4 + w.q.numel() + w.scale.numel() * 4 + M * N * 4
    ws = [w] + [quantize(torch.randn(K, N, generator=gen, device=DEV) * K ** -0.5, bits)
                for _ in range(copies(w.q.numel()) - 1)]
    wfs = [dequantize(c) for c in ws[:copies(4 * K * N)]]
    b_ms, b_by = bound(nbytes, 2.0 * M * N * K)
    bounds = {}
    if M > QMM_SKINNY_ROWS:  # the tiled path: bf16 tensor cores, x·s split in three
        f32_ms, f32_by = b_ms, b_by
        b_ms, b_by = bound(nbytes, 3 * 2.0 * M * N * K, BF16_FLOP_PER_S)
        bounds = {"bound_tc_ms": b_ms, "bound_tc_by": b_by, "bound_f32_ms": f32_ms,
                  "bound_f32_by": f32_by}
    r = {"check": "quant_matmul", "M": M, "K": K, "N": N, "bits": bits,
         "path": "tiled" if M > QMM_SKINNY_ROWS else "skinny",
         "max_abs_err": max_err(got, want), "tol": "atol 1e-3 + rtol 1e-4",
         "tol_reason": qmm_tol_reason(M),
         "ms": timer([lambda c=c: quant_matmul(x, c.q, c.scale, bits=bits) for c in ws]),
         "plain_ms": timer([lambda c=c: ref.quant_matmul_ref(x, c.q, c.scale, bits)
                            for c in ws]),
         "library_ms": timer([lambda c=c: torch.matmul(x, c) for c in wfs]),
         "library": "torch.matmul on the pre-dequantized f32 weight",
         "bound_ms": b_ms, "bound_by": b_by, **bounds}
    emit(r)
    return r


def qmm_tol_reason(M: int) -> str:
    reason = "f32 atol 1e-3 / rtol 1e-4 of the reference (tests/test_kernels.py:38); "
    if M <= QMM_SKINNY_ROWS:
        return reason + "sums reorder"
    return reason + ("the kernel rounds x·s in f32 where the reference rounds q·s, and "
                     "carries it to the tensor cores as three bf16 terms (~24 bits, "
                     "tests/test_torch_kernels.py::test_quant_matmul_bf16_split_error_model: "
                     "~2e-7 against the exact product, under the plain f32 version's own "
                     "error); sums reorder")


def qmm_check(gen: torch.Generator, M: int, K: int, N: int, bits: int):
    """``quant_matmul`` on seeded inputs at (M, K, N), held to its plain
    version: (x, w, kernel's y, plain y)."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_matmul import quant_matmul

    x = torch.randn(M, K, generator=gen, device=DEV)
    w = quantize(torch.randn(K, N, generator=gen, device=DEV) * K ** -0.5, bits)
    got = quant_matmul(x, w.q, w.scale, bits=bits)
    want = ref.quant_matmul_ref(x, w.q, w.scale, bits)
    if got.shape != (M, N) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"quant_matmul M={M} K={K} N={N} int{bits}: shape "
                             f"{tuple(got.shape)} or non-finite output")
    check(f"quant_matmul M={M} K={K} N={N} int{bits}",
          float(((got - want).abs() - 1e-4 * want.abs()).max()), 1e-3)
    return x, w, got, want


def layer_row(qmm: dict, M: int, bits: int = 8) -> dict:
    """The 7 projections of one layer at ``M`` rows and ``bits``, times summed."""
    def layer_sum(key):
        return sum(qmm[(M, K, N, bits)][key] for K, N in LAYER_PROJECTIONS)

    rows = [qmm[(M, K, N, bits)] for K, N in QMM_SHAPES]
    r = {"at": f"the 7 projections of one layer at M={M}, int{bits} (times summed)",
         "max_abs_err": max(r_["max_abs_err"] for r_ in rows),
         "ms": layer_sum("ms"), "plain_ms": layer_sum("plain_ms"),
         "bound_ms": layer_sum("bound_ms"), "bound_by": rows[0]["bound_by"],
         "library_ms": layer_sum("library_ms")}
    if M > QMM_SKINNY_ROWS:
        r.update(bound_tc_ms=layer_sum("bound_tc_ms"), bound_f32_ms=layer_sum("bound_f32_ms"))
    return r


FLASH_TOL = 3e-5  # the reference's flash tolerance (tests/test_kernels.py:105)
FLASH_TOL_REASON = ("the reference's flash tolerance (tests/test_kernels.py:105); Q, K, V and P "
                    "reach the tensor cores as three bf16 terms each (~24 bits: "
                    "tests/test_torch_kernels.py::test_flash_bf16_split_error_model errs 4.5e-7 "
                    "against float64 attention, under the plain f32 version's own error); "
                    "sums reorder")


def flash_case(timer: Timer, gen: torch.Generator, B: int, H: int, Hkv: int, S: int, hd: int,
               at: str, cap: float = None, dtype=torch.float32, window: int = None):
    """Causal ``flash_attention`` over grouped KV at (B·H, S, hd) against
    its plain version, timed beside the plain version and SDPA (KV heads
    repeated beforehand), with both bounds: the bf16 tensor cores' (each
    product's 3-term split takes six bf16 products: 12 in all) and f32's.
    ``cap``: the attention soft-cap of the kernel and its plain version
    (SDPA has none, and runs without). ``window``: the sliding window of
    all three (SDPA's as a boolean mask). ``dtype`` bf16: the bf16 branch,
    q, k, v and O bf16 (Q·Kᵀ one product, P·V three: P's terms), held to
    one bf16 rounding of O (:func:`bf16_out_check`); its ``library_ms`` is
    the reference's function (SDPA in f32 on q, k, v cast to f32, O cast to
    bf16), SDPA on bf16 beside it. The row names the kernels the call
    launched (the wrapper's route). Returns (the row, (q, k, v), the SDPA
    call)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, route_of

    q = torch.randn(B * H, S, hd, generator=gen, device=DEV).to(dtype)
    k = torch.randn(B * Hkv, S, hd, generator=gen, device=DEV).to(dtype)
    v = torch.randn(B * Hkv, S, hd, generator=gen, device=DEV).to(dtype)
    opts = dict(attn_softcap=cap, window=window)
    got = flash_attention(q, k, v, **opts)
    want = ref.flash_attention_ref(q, k, v, **opts)
    if (got.shape != q.shape or got.dtype != dtype or not bool(torch.isfinite(got).all())):
        raise AssertionError(f"flash_attention {at}: shape {tuple(got.shape)}, {got.dtype} or "
                             "non-finite")
    err = max_err(got, want)
    bf16 = dtype == torch.bfloat16
    if bf16:
        check(f"flash_attention {at}", bf16_out_check(got, want), BF16_OUT_ATOL)
    else:
        check(f"flash_attention {at}", err, FLASH_TOL)
    q4, k4, v4 = (t.reshape(B, -1, S, hd) for t in (q, k, v))
    k4r, v4r = k4.repeat_interleave(H // Hkv, dim=1), v4.repeat_interleave(H // Hkv, dim=1)
    pos = torch.arange(S, device=DEV)
    band = dict(is_causal=True) if window is None else dict(
        attn_mask=(pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q4, k4r, v4r, **band)

    # causal (query, key) pairs per head, inside the window where one is given
    pairs = S * (S + 1) // 2 if window is None else sum(min(i + 1, window) for i in range(S))
    nbytes = float(q.element_size()) * (q.numel() * 2 + k.numel() + v.numel())
    flops = 4.0 * hd * pairs * B * H
    f32_ms, f32_by = bound(nbytes, flops)
    # the tensor cores' products: 6 + 6 for f32 operands, 1 + 3 for bf16
    b_ms, b_by = bound(nbytes, (2 if bf16 else 6) * flops, BF16_FLOP_PER_S)
    library = ("scaled_dot_product_attention, causal, KV heads repeated beforehand"
               + ("" if window is None else f", window {window} as a boolean mask")
               + (", no soft-cap (SDPA has none)" if cap else ""))
    r = {"check": "flash_attention", "at": at, "BH": B * H, "BHkv": B * Hkv, "S": S, "hd": hd,
         "causal": True, "window": window, "softcap": cap,
         "dtype": str(dtype).replace("torch.", ""),
         "route": route_of(q), "max_abs_err": err,
         "tol": BF16_OUT_TOL if bf16 else f"atol {FLASH_TOL}",
         "tol_reason": BF16_OUT_TOL_REASON if bf16 else FLASH_TOL_REASON,
         "ms": timer(lambda: flash_attention(q, k, v, **opts)),
         "plain_ms": timer(lambda: ref.flash_attention_ref(q, k, v, **opts)),
         "library_ms": timer(sdpa), "library": library,
         "bound_ms": b_ms, "bound_by": b_by, "bound_tc_ms": b_ms, "bound_tc_by": b_by,
         "bound_f32_ms": f32_ms, "bound_f32_by": f32_by}
    if bf16:  # the reference's function: q, k, v cast to f32, S, P and O in f32, O cast once
        q32, k32, v32 = q4.float(), k4r.float(), v4r.float()
        r.update(library_ms=timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            q32, k32, v32, **band).to(dtype)),
            library=library + ", in f32 on q, k, v cast to f32 beforehand, O cast to bf16: "
                              "the reference's function",
            library_bf16_ms=r["library_ms"],
            library_bf16=library + ", on bf16 (P rounded to bf16: not the same function)")
    return r, (q, k, v), sdpa


def device_kernels(fn) -> list:
    """The names of the kernels one call of ``fn`` runs on the device."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:120] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def flash_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |Δ|, the value its check holds to its bound, the bound): f32
    at ``FLASH_TOL``; bf16 the excess over one bf16 rounding of O."""
    if got.dtype == torch.bfloat16:
        return max_err(got, want), bf16_out_check(got, want), BF16_OUT_ATOL
    err = max_err(got, want)
    return err, err, FLASH_TOL


def flash_ragged(gen: torch.Generator, hds=(64, 128), n_reps=(1, 2), dtype=torch.float32,
                 window: int = 32) -> None:
    """``flash_attention`` at Sq = Sk = 37 and 1001 (partial query and key
    tiles), each head width of ``hds``, each n_rep of ``n_reps`` (query
    heads a kv head), each with causal on and off, ``window`` or none and
    soft-cap 30 or none, against its plain version: one line per (S, hd,
    n_rep). ``dtype`` bf16: q, k, v bf16, held to one bf16 rounding of O."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, route_of

    bf16 = dtype == torch.bfloat16
    for S in (37, 1001):
        for hd in hds:
            for n_rep in n_reps:
                q = torch.randn(4 * n_rep, S, hd, generator=gen, device=DEV).to(dtype)
                k, v = (torch.randn(4, S, hd, generator=gen, device=DEV).to(dtype)
                        for _ in range(2))
                cases = []
                for causal in (True, False):
                    for win in (None, window):
                        for cap in (None, 30.0):
                            kw = dict(causal=causal, window=win, attn_softcap=cap)
                            got = flash_attention(q, k, v, **kw)
                            if not bool(torch.isfinite(got).all()):
                                raise AssertionError(f"flash_attention S={S} {kw}: non-finite")
                            err, value, tol = flash_err(got, ref.flash_attention_ref(q, k, v, **kw))
                            check(f"flash_attention S={S} hd={hd} n_rep={n_rep} {dtype} {kw}",
                                  value, tol)
                            cases.append({**kw, "max_abs_err": err, "check_value": value})
                emit({"check": "flash_attention_ragged", "S": S, "hd": hd, "n_rep": n_rep,
                      "BH": 4 * n_rep, "dtype": str(dtype).replace("torch.", ""),
                      "route": route_of(q), "cases": cases,
                      "max_abs_err": max(c["max_abs_err"] for c in cases),
                      "check_value": max(c["check_value"] for c in cases),
                      "tol": BF16_OUT_TOL if bf16 else f"atol {FLASH_TOL}",
                      "tol_reason": BF16_OUT_TOL_REASON if bf16 else FLASH_TOL_REASON})


def flash_keyless(gen: torch.Generator, hds=(64, 128), dtype=torch.float32,
                  window: int = 32) -> None:
    """``flash_attention`` with Sq = 300 queries over Sk = 100 keys and
    ``window`` (B·H = 8 over 4 KV heads, each head width of ``hds``, causal
    or not): rows q >= Sk + window - 1 (131 at window 32) have no key and
    get V's mean, as in the plain version and the reference. ``dtype``
    bf16: held to one bf16 rounding of O."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import _keyless_from, flash_attention, route_of

    Sq, Sk = 300, 100
    bf16 = dtype == torch.bfloat16
    for hd in hds:
        q = torch.randn(8, Sq, hd, generator=gen, device=DEV).to(dtype)
        k, v = (torch.randn(4, Sk, hd, generator=gen, device=DEV).to(dtype) for _ in range(2))
        cases = []
        for causal in (True, False):
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
            if got.shape != q.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash_attention keyless hd={hd}: shape or non-finite")
            first = _keyless_from(Sq, Sk, window)
            err, value, tol = flash_err(got, want)
            check(f"flash_attention keyless hd={hd} {dtype} causal={causal}", value, tol)
            cases.append({"causal": causal, "max_abs_err": err, "check_value": value,
                          "max_abs_err_keyless_rows": max_err(got[:, first:], want[:, first:])})
        emit({"check": "flash_attention_keyless", "BH": 8, "BHkv": 4, "Sq": Sq, "Sk": Sk,
              "window": window, "hd": hd, "dtype": str(dtype).replace("torch.", ""),
              "route": route_of(q), "keyless_rows": Sq - first, "cases": cases,
              "max_abs_err": max(c["max_abs_err"] for c in cases),
              "check_value": max(c["check_value"] for c in cases),
              "tol": BF16_OUT_TOL if bf16 else f"atol {FLASH_TOL}",
              "tol_reason": BF16_OUT_TOL_REASON if bf16 else FLASH_TOL_REASON})


PAGED_TOL = {"f32": 2e-4, "int8": 2e-4, "bf16": 3e-2}  # tests/test_decode_parity.py:36
PAGED_TOL_REASON = "the reference's paged tolerances (tests/test_decode_parity.py:36)"


def paged_case(gen: torch.Generator, rng: np.random.Generator, B: int, Hkv: int, n_rep: int,
               hd: int, page: int, max_pages: int, lengths_np: np.ndarray, padding=()):
    """Seeded decode inputs: q (B, Hkv, n_rep, hd), f32 K/V pools of
    B * max_pages + 1 pages (page 0 the null page), and block tables that
    give each row the pages its length needs, in a random order; the rows
    in ``padding`` keep the null page (length 0: a padding row)."""
    n_pages = B * max_pages + 1
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    bt_np = np.zeros((B, max_pages), np.int32)
    for b in range(B):
        if b not in padding:
            n = min(max_pages, -(-(int(lengths_np[b]) + 1) // page))
            bt_np[b, :n] = perm[b * max_pages:b * max_pages + n]
    q = torch.randn(B, Hkv, n_rep, hd, generator=gen, device=DEV)
    kf = torch.randn(n_pages, page, Hkv, hd, generator=gen, device=DEV)
    vf = torch.randn(n_pages, page, Hkv, hd, generator=gen, device=DEV)
    return (q, kf, vf, torch.from_numpy(bt_np).to(DEV),
            torch.from_numpy(lengths_np.astype(np.int32)).to(DEV))


#: device bytes of one K or V row of hd values, by page type (int8: codes and an f32 scale)
PAGE_ROW_BYTES = {"int8": lambda hd: hd + 4, "bf16": lambda hd: 2 * hd, "f32": lambda hd: 4 * hd}


def paged_bound(lengths_np: np.ndarray, Hkv: int, n_rep: int, hd: int, page: int,
                pages: str = "int8", q_bytes: int = 4):
    """The least time of one call over ``pages``: each attended K/V row
    (and an int8 row's scale) read once, q (``q_bytes`` a value) read and
    the f32 output written once, the block-table entries and lengths read
    once; 4 * n_rep * hd f32 FLOPs a token and kv head."""
    tokens = int((lengths_np.astype(np.int64) + 1).sum())
    B = len(lengths_np)
    nbytes = (tokens * Hkv * 2 * PAGE_ROW_BYTES[pages](hd) + B * Hkv * n_rep * hd * (q_bytes + 4)
              + 4 * int(sum(-(-(int(n) + 1) // page) for n in lengths_np)) + 4 * B)
    return bound(nbytes, 4.0 * n_rep * hd * Hkv * tokens)


def paged_timed(timer: Timer, gen: torch.Generator, lengths_np: np.ndarray, max_pages: int,
                at: str, Hkv: int = 8, n_rep: int = 2, hd: int = 128, cap: float = None,
                pages: str = "int8", q_dtype=torch.float32) -> dict:
    """``paged_attention`` at B = len(lengths), pages of 16 tokens (int8
    unless ``pages`` says "f32" or "bf16", which have no scales;
    internlm2-1.8b's Hkv = 8, n_rep = 2, hd = 128 unless given), against
    its plain version; timed beside the plain version and SDPA over the KV
    gathered to dense f32 beforehand (length mask), with the byte bound.
    ``cap``: the attention soft-cap of the kernel and its plain version
    (SDPA has none, and runs without). ``q_dtype`` bf16: a bf16
    backbone's query (the output stays f32)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import _KIND, paged_attention, plan_for
    from repro_torch.serve.paging import quantize_kv_pages

    B, page = len(lengths_np), 16
    rng = np.random.default_rng(SEED)
    qd, kf, vf, bt, lengths = paged_case(gen, rng, B, Hkv, n_rep, hd, page, max_pages, lengths_np)
    qd = qd.to(q_dtype)
    if pages == "int8":
        (kq, ks), (vq, vs) = quantize_kv_pages(kf), quantize_kv_pages(vf)
    else:  # unscaled pages: the kernel's other branch
        kq, vq = (t.to(torch.bfloat16) if pages == "bf16" else t for t in (kf, vf))
        ks = vs = None
    del kf, vf
    got = paged_attention(qd, kq, vq, bt, lengths, k_scale=ks, v_scale=vs, attn_softcap=cap)
    want = ref.paged_attention_ref(qd, kq, vq, bt, lengths, k_scale=ks, v_scale=vs,
                                   attn_softcap=cap)
    if not torch.isfinite(got).all():
        raise AssertionError(f"paged_attention {at}: non-finite output")
    check(f"paged_attention {at}", max_err(got, want), PAGED_TOL[pages])
    b_ms, b_by = paged_bound(lengths_np, Hkv, n_rep, hd, page, pages, qd.element_size())
    S = max_pages * page
    idx = bt.long()

    def dense(t, sc):
        t = t[idx].float() if sc is None else t[idx].float() * sc[idx][..., None]
        return t.reshape(B, S, Hkv, hd).transpose(1, 2).repeat_interleave(n_rep, dim=1)

    kd, vd = dense(kq, ks), dense(vq, vs)
    qsd = qd.float().reshape(B, Hkv * n_rep, 1, hd)
    mask = (torch.arange(S, device=DEV)[None, :] <= lengths[:, None])[:, None, None, :]
    scaled = ks is not None
    pool_bytes = 2 * (kq.numel() * kq.element_size() + (4 * ks.numel() if scaled else 0))
    pools = [(kq, vq, ks, vs)] + [
        (kq.clone(), vq.clone(), ks.clone() if scaled else None, vs.clone() if scaled else None)
        for _ in range(copies(pool_bytes) - 1)]
    r = {"check": "paged_attention", "at": at, "B": B, "Hkv": Hkv, "n_rep": n_rep, "hd": hd,
         "page": page, "max_pages": max_pages, "lengths": lengths_np.tolist(), "pages": pages,
         "q_dtype": str(q_dtype).replace("torch.", ""), "softcap": cap,
         "plan": plan_for(qd, B, Hkv, n_rep, hd, page, max_pages, _KIND[kq.dtype])._asdict(),
         "max_abs_err": max_err(got, want), "tol": f"atol {PAGED_TOL[pages]}",
         "tol_reason": PAGED_TOL_REASON,
         "ms": timer([lambda p=p: paged_attention(qd, p[0], p[1], bt, lengths, k_scale=p[2],
                                                  v_scale=p[3], attn_softcap=cap) for p in pools]),
         "plain_ms": timer([lambda p=p: ref.paged_attention_ref(
             qd, p[0], p[1], bt, lengths, k_scale=p[2], v_scale=p[3], attn_softcap=cap)
             for p in pools]),
         "library_ms": timer(lambda: torch.nn.functional.scaled_dot_product_attention(
             qsd, kd, vd, attn_mask=mask)),
         "library": "scaled_dot_product_attention over dense f32 KV gathered beforehand"
                    + (", no soft-cap (SDPA has none)" if cap else ""),
         "bound_ms": b_ms, "bound_by": b_by}
    emit(r)
    return r


def paged_ragged(gen: torch.Generator, shapes=None, q_dtype=torch.float32) -> None:
    """``paged_attention`` against its plain version at B 1, 2, 3, 5, 8
    and 72 (the last groups two kv heads a block, one rank: no cluster),
    Hkv 2, 4 and 8, n_rep 1, 2, 3, 5 and 8, hd 64 and 128, pages of 4 and
    16 tokens, lengths on page edges up to 543 (the serving ``max_len``
    544) and padding rows (length 0 on the null page), f32, bf16 and int8
    pages, each plain, with soft-cap 30, with window 64 and soft-cap 30,
    and with window 20 (which leaves most ranks of a long row empty); and
    int8 and bf16 pools whose base is not 16-byte aligned. One line per
    shape; ``shapes`` replaces the shapes (B, Hkv, n_rep, hd, page,
    max_pages, lengths, padding rows); ``q_dtype`` bf16: a bf16
    backbone's query."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention, plan_for
    from repro_torch.serve.paging import quantize_kv_pages

    rng = np.random.default_rng(SEED + 1)
    shapes = shapes or [  # B, Hkv, n_rep, hd, page, max_pages, lengths, padding rows
        (1, 2, 1, 64, 4, 136, [543], ()),
        (3, 8, 8, 128, 16, 34, [0, 16, 543], (0,)),
        (8, 2, 2, 64, 16, 34, [0, 15, 16, 17, 255, 256, 542, 543], ()),
        (8, 8, 2, 128, 4, 136, [3, 4, 5, 127, 128, 300, 542, 543], ()),
        (3, 2, 8, 128, 4, 136, [0, 3, 543], (0,)),
        (72, 8, 2, 128, 16, 34, list(rng.integers(0, 544, size=72)), (5,)),
        (2, 8, 3, 128, 16, 34, [100, 543], ()),  # n_rep 3: 3 of a head's query rows
        (5, 4, 5, 128, 4, 136, [0, 17, 255, 542, 543], (0,)),  # n_rep 5
    ]
    options = {"plain": {}, "cap30": dict(attn_softcap=30.0),
               "window64_cap30": dict(window=64, attn_softcap=30.0),
               "window20": dict(window=20)}
    for B, Hkv, n_rep, hd, page, max_pages, lens, padding in shapes:
        lengths_np = np.array(lens, np.int32)
        lengths_np[list(padding)] = 0
        q, kf, vf, bt, lengths = paged_case(gen, rng, B, Hkv, n_rep, hd, page, max_pages,
                                            lengths_np, padding)
        q = q.to(q_dtype)
        (kq, ks), (vq, vs) = quantize_kv_pages(kf), quantize_kv_pages(vf)
        pools = {"f32": ((kf, vf), {}), "bf16": ((kf.bfloat16(), vf.bfloat16()), {}),
                 "int8": ((kq, vq), dict(k_scale=ks, v_scale=vs))}
        if B == 8 and hd == 64:  # pools whose base is off 16-byte alignment: plain loads
            def shifted(t):
                flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=DEV)
                out = flat[1:].view(t.shape)
                out.copy_(t)
                return out
            pools["int8_unaligned"] = ((shifted(kq), shifted(vq)), dict(k_scale=ks, v_scale=vs))
            pools["bf16_unaligned"] = ((shifted(kf.bfloat16()), shifted(vf.bfloat16())), {})
        errs = {}
        for kind, ((kp, vp), scales) in pools.items():
            for opt, kw in options.items():
                got = paged_attention(q, kp, vp, bt, lengths, **scales, **kw)
                want = ref.paged_attention_ref(q, kp, vp, bt, lengths, **scales, **kw)
                label = f"{kind} {opt}"
                if not torch.isfinite(got).all():
                    raise AssertionError(f"paged_attention_ragged B={B} {label}: non-finite")
                errs[label] = max_err(got, want)
                check(f"paged_attention_ragged B={B} Hkv={Hkv} n_rep={n_rep} hd={hd} "
                      f"page={page} {label}", errs[label], PAGED_TOL[kind.split("_")[0]])
        emit({"check": "paged_attention_ragged", "B": B, "Hkv": Hkv, "n_rep": n_rep, "hd": hd,
              "q_dtype": str(q_dtype).replace("torch.", ""), "page": page, "max_pages": max_pages, "lengths": lengths_np.tolist(),
              "padding_rows": list(padding),
              "plan_int8": plan_for(q, B, Hkv, n_rep, hd, page, max_pages, 0)._asdict(),
              "max_abs_err": errs, "tol": {k: f"atol {v}" for k, v in PAGED_TOL.items()},
              "tol_reason": PAGED_TOL_REASON})


def paged_deterministic(gen: torch.Generator, lengths_np: np.ndarray, max_pages: int,
                        Hkv: int = 8, n_rep: int = 2, hd: int = 128,
                        q_dtype=torch.float32) -> None:
    """Two eager calls at the check's shape bit-equal, and the call
    captured in a CUDA graph and replayed three times, each bit-equal to
    the eager call (``q_dtype`` bf16: a bf16 backbone's query)."""
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serve.paging import quantize_kv_pages

    q, kf, vf, bt, lengths = paged_case(gen, np.random.default_rng(SEED), len(lengths_np), Hkv,
                                        n_rep, hd, 16, max_pages, lengths_np)
    q = q.to(q_dtype)
    (kq, ks), (vq, vs) = quantize_kv_pages(kf), quantize_kv_pages(vf)

    def fn():
        return paged_attention(q, kq, vq, bt, lengths, k_scale=ks, v_scale=vs)

    eager, again = fn(), fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = fn()
    replays = []
    for _ in range(3):
        static.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(bool(torch.equal(static, eager)))
    del graph
    ok = bool(torch.equal(eager, again)) and all(replays)
    emit({"check": "paged_attention_deterministic",
          "at": f"B={len(lengths_np)} Hkv={Hkv} n_rep={n_rep} hd={hd} page=16 int8",
          "q_dtype": str(q_dtype).replace("torch.", ""),
          "calls_bit_equal": bool(torch.equal(eager, again)), "replays_equal_eager": replays,
          "bit_equal": ok})
    if not ok:
        raise AssertionError(f"paged_attention: reruns or graph replays differ ({replays})")


def paged_phase(timer: Timer, gen: torch.Generator) -> dict:
    """Paged attention at the check's shape (B = 8, Hkv = 8, n_rep = 2,
    hd = 128, int8 pages of 16 tokens, seeded lengths <= 511, max_pages
    32) and at a long context (seeded lengths <= 4095, max_pages 256),
    both timed; the ragged cases; bit-equal reruns and graph replays."""
    rng = np.random.default_rng(SEED)
    lengths_np = rng.integers(1, 512, size=8).astype(np.int32)
    r = paged_timed(timer, gen, lengths_np, 32, "decode B=8 Hkv=8 n_rep=2 hd=128 page=16 int8, "
                    "lengths<=511")
    long_lengths = np.random.default_rng(SEED + 2).integers(1, 4096, size=8).astype(np.int32)
    long = paged_timed(timer, gen, long_lengths, 256, "long context B=8 Hkv=8 n_rep=2 hd=128 "
                       "page=16 int8, lengths<=4095")
    paged_ragged(gen)
    paged_deterministic(gen, lengths_np, 32)
    row = {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "at", "plan")}
    row["long"] = {k: long[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "at", "plan")}
    return row


def kernel_phase(timer: Timer, gen: torch.Generator):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul

    rows = {}

    # quant_matmul: decode M=8, epoch-1 M=2048 and prefill M=4096 over the
    # path's (K, N), plus int4
    qmm = {}
    cases = [(M, K, N, 8) for M in (8, 2048, 4096) for K, N in QMM_SHAPES] + [
        (8, 2048, 2048, 4), (4096, 2048, 2048, 4)]
    for M, K, N, bits in cases:
        qmm[(M, K, N, bits)] = qmm_case(timer, gen, M, K, N, bits)
    for M in (8, 2048, 4096):
        emit({"check": "quant_matmul_layer", "M": M, **layer_row(qmm, M)})
    rows["quant_matmul"] = layer_row(qmm, 8)
    # the skinny path with a partial last slice; the tiled path's ragged
    # edges: its smallest M, masked M and K, rows unaligned for 16-byte
    # loads (K = 998)
    for M, K, N in ((3, 1000, 384), (9, 1000, 384), (1001, 1000, 384), (1001, 998, 384)):
        for bits in (8, 4):
            _, _, got, want = qmm_check(gen, M, K, N, bits)
            emit({"check": "quant_matmul_ragged", "M": M, "K": K, "N": N, "bits": bits,
                  "max_abs_err": max_err(got, want),
                  "check_value": float(((got - want).abs() - 1e-4 * want.abs()).max()),
                  "tol": "atol 1e-3 + rtol 1e-4", "tol_reason": qmm_tol_reason(M)})
    x, w, got, _ = qmm_check(gen, 4096, 2048, 8192, 8)
    again = quant_matmul(x, w.q, w.scale)
    emit({"check": "quant_matmul_deterministic", "M": 4096, "K": 2048, "N": 8192,
          "bit_equal": bool(torch.equal(got, again))})
    if not torch.equal(got, again):
        raise AssertionError("quant_matmul: two calls at M=4096 differ")
    x, w, got, _ = qmm_check(gen, 1, 8192, 2048, 8)
    again = quant_matmul(x, w.q, w.scale)
    emit({"check": "quant_matmul_deterministic", "M": 1, "K": 8192, "N": 2048,
          "bit_equal": bool(torch.equal(got, again))})
    if not torch.equal(got, again):
        raise AssertionError("quant_matmul: two calls at M=1 differ")
    del x, w, got, again

    # flash attention: prefill, B·H = 8·16, S = 512, hd = 128, causal, grouped KV
    B, H, Hkv, S, hd = 8, 16, 8, 512, 128
    r, (q, k, v), sdpa = flash_case(timer, gen, B, H, Hkv, S, hd, "prefill")
    r["library_kernels"] = device_kernels(sdpa)  # which of PyTorch's attention kernels runs
    kw = dict(window=128, attn_softcap=30.0)
    r["max_abs_err_window128_cap30"] = max_err(flash_attention(q, k, v, **kw),
                                               ref.flash_attention_ref(q, k, v, **kw))
    check("flash_attention window=128 cap=30", r["max_abs_err_window128_cap30"], FLASH_TOL)
    emit(r)
    rows["flash_attention"] = {k_: r[k_] for k_ in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                    "bound_by", "bound_tc_ms", "bound_f32_ms",
                                                    "library_ms", "library_kernels")}
    rows["flash_attention"]["at"] = "prefill BH=8*16 S=512 hd=128 causal"
    got, again = flash_attention(q, k, v), flash_attention(q, k, v)
    emit({"check": "flash_attention_deterministic", "BH": B * H, "BHkv": B * Hkv, "S": S,
          "hd": hd, "bit_equal": bool(torch.equal(got, again))})
    if not torch.equal(got, again):
        raise AssertionError("flash_attention: two calls at the prefill shape differ")
    del q, k, v, got, again, sdpa
    flash_ragged(gen)
    flash_keyless(gen)

    rows["paged_attention"] = paged_phase(timer, gen)
    return rows


# ---------------------------------------------------------------- serving


def device_profile(fn, watch=(), trace: Path = None) -> dict:
    """``fn`` under ``torch.profiler``: the host wall time, the device's
    busy time and its share of the wall time, the torch ops called from
    Python (top-level host events), device time by kernel name (the top
    ten) and summed over the kernels whose names hold each of ``watch``.
    With ``trace`` (a file to write the profiler's trace to) also every
    memory copy (its kind, stream and bytes) and the kernels' streams."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    streams = {}
    if trace is not None:
        prof.export_chrome_trace(str(trace))
        events = json.loads(Path(trace).read_text())["traceEvents"]
        streams = {"copies": [{"kind": e["name"], "stream": e["args"]["stream"],
                               "bytes": e["args"]["bytes"], "ms": e["dur"] / 1e3}
                              for e in events if e.get("cat") == "gpu_memcpy"],
                   "kernel_streams": sorted({e["args"]["stream"] for e in events
                                             if e.get("cat") == "kernel"})}
    by_name = {}
    host_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        elif e.cpu_parent is None:
            host_ops += 1
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if by_name else "not measured",
            "device_busy_share": busy_us / wall_us if by_name else "not measured",
            "host_ops": host_ops,
            "kernels_by_device_ms": [[n[:80], t / 1e3] for n, t in top],
            **({"watched_device_ms": {w: sum(t for n, t in by_name.items() if w in n) / 1e3
                                      for w in watch}} if watch else {}),
            **streams}


def profile_decode(eng, prompts, names, phase: str = "decode_profile") -> None:
    """Two steady decode steps at batch 8 under ``torch.profiler``."""
    for i, p in enumerate(prompts):
        eng.submit(p, names[i % len(names)], max_new_tokens=8)
    eng.step()  # prefill + first decode step
    eng.step()
    emit({"phase": phase, "steps": 2, "batch": 8,
          **device_profile(lambda: (eng.step(), eng.step()), watch=SKINNY_WATCH)})
    eng.drain()


def paged_cuda_vs_ref(backbone, cfg, ab, prompts, page: int, max_len: int, r: int, s_pad: int,
                      steps: int = 2, routes: dict = None, forced: bool = False,
                      kv_policy: str = "int8", runs: dict = None) -> dict:
    """The prompts' paged prefill (padded to ``s_pad``) and ``steps``
    decode steps over ``kv_policy`` KV pages, under the ``cuda`` and the ``ref``
    OpSet, the cuda run's greedy tokens fed to both: per OpSet the (B, V)
    logits of each step, the prefill's first. ``routes`` (a dict) gets per
    OpSet each step's MoE route records, one a layer
    (``models.moe.record_routes``). ``forced``: a third run,
    ``ref_forced``, under ``ref`` with every MoE layer taking the ``cuda``
    run's routes (``models.moe.replay_routes``); its records are each
    layer's own choice. ``runs`` (name -> (OpSet, backbone, adapter rows,
    device)) takes the place of those runs, the first one's greedy tokens
    fed to all."""
    from repro_torch.models.moe import record_routes, replay_routes
    from repro_torch.serve import paging
    from repro_torch.serve.decode import paged_pac_decode_step, paged_prefill

    B = len(prompts)
    max_pages = -(-max_len // page)
    if runs is None:
        runs = {name: (impl, backbone, ab, DEV) for name, impl in (
            ("cuda", "cuda"), ("ref", "ref"), *((("ref_forced", "ref"),) if forced else ()))}
    lead = next(iter(runs))
    state = {}
    for name, (_, _, _, dev) in runs.items():
        table = paging.PageTable(paging.PageAllocator(B * max_pages + 1), page, max_pages)
        for i, p in enumerate(prompts):
            table.open(i, len(p))
        pools = paging.init_pools(cfg, table.allocator.n_pages, page, kv_policy, dev, n_slots=B)
        state[name] = [table, pools, None]
    toks = np.zeros((B, s_pad), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    logits, recs = {}, {name: [] for name in state}

    def following(name):  # the cuda run's routes of this step, for the forced run
        return (replay_routes(recs["cuda"][-1]) if name == "ref_forced"
                else contextlib.nullcontext())

    for name, st in state.items():
        impl, bb, rows, dev = runs[name]
        bt, lengths = st[0].dense(range(B))
        with following(name), record_routes() as rec:
            lg, st[1], st[2] = paged_prefill(
                bb, rows, torch.from_numpy(toks).to(dev), torch.from_numpy(lengths).to(dev),
                st[1], torch.from_numpy(bt).to(dev), cfg=cfg, max_len=max_len, r=r,
                kernel_impl=impl)
        logits[name] = [lg[:, 0]]
        recs[name].append(rec)
    for _ in range(steps):
        tok = logits[lead][-1].argmax(-1).int()[:, None]
        for name, st in state.items():
            impl, bb, rows, dev = runs[name]
            table = st[0]
            for i in range(B):
                table.extend_to(i, table.length(i) + 1)
            bt, lengths = table.dense(range(B))
            with following(name), record_routes() as rec:
                lg, st[1], st[2] = paged_pac_decode_step(
                    bb, rows, tok.to(dev), st[1], torch.from_numpy(bt).to(dev),
                    torch.from_numpy(lengths).to(dev), st[2], cfg=cfg, r=r, kernel_impl=impl)
            logits[name].append(lg[:, 0])
            recs[name].append(rec)
            for i in range(B):
                table.append_token(i)
    if routes is not None:
        routes.update(recs)
    return logits


#: the serving cells' config, pages of 16 tokens, max_len, batch and adapter rank
SERVING_ARCH = "internlm2-1.8b"
SERVING_PAGE, SERVING_MAX_LEN, SERVING_BATCH, SERVING_R = 16, 544, 8, 8
#: new tokens a request of each config's serving cell (32 until the bf16 slice; cut for the
#: smoke's time, as the other cells' below)
SERVING_NEW_TOKENS = 16
#: ... of the other configs' serving cells (gemma2-2b, qwen2-vl-7b, the MoE configs,
#: xlstm-125m; 16 until the bf16 gemma2-2b slice)
CONFIG_NEW_TOKENS = 8
#: steps of the INT4 and the other configs' personal loops (8 teacher-forced, then greedy;
#: 16 until the bf16 slice)
PERSONAL_STEPS = 12


def serving_phase(gen: torch.Generator, walls: dict, keep: dict = None):
    """The serving path (phase 4 above). ``walls`` gets the prefill
    wave's and a decode step's wall, at their shapes, for the roofline;
    ``keep`` (a dict) the INT8 backbone, users, prompts, streams and the
    ``serving`` line, for the serving phases over other pages and pools."""
    from repro_torch.configs import get_arch
    from repro_torch.core.parallel_adapters import gather_adapters, stack_adapters
    from repro_torch.core.parallel_adapters import init_adapter
    from repro_torch.core.quantization import tree_storage_bytes
    from repro_torch.kernels import flash_attention, paged_attention, quant_matmul
    from repro_torch.models.backbone import init_backbone
    from repro_torch.serve import ServeEngine

    kernels = {"quant_matmul": quant_matmul, "flash_attention": flash_attention,
               "paged_attention": paged_attention}
    cfg = get_arch(SERVING_ARCH)
    page, max_len, max_batch, n_new, r = (SERVING_PAGE, SERVING_MAX_LEN, SERVING_BATCH,
                                          SERVING_NEW_TOKENS, SERVING_R)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backbone = init_backbone(gen, cfg, device="cuda", quant_bits=8)
    users = {f"user{u}": init_adapter(gen, cfg, r=r, device="cuda") for u in range(4)}
    torch.cuda.synchronize()
    emit({"phase": "serving_init", "arch": cfg.name, "params": cfg.param_count(),
          "backbone_bytes": tree_storage_bytes(backbone), "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(SEED)
    prompt_lens = rng.integers(64, 481, size=8)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist() for n in prompt_lens]
    names = list(users)

    def serve(n_tokens):
        return serve_streams(backbone, cfg, users, prompts, "cuda", n_tokens, page, max_len,
                             max_batch, r)

    serve(2)  # warm-up: first launches, allocator growth
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.launches = 0
    eng, streams, wall = serve(n_new)
    launches = {n: mod.launches for n, mod in kernels.items()}
    for s in streams:
        if len(s) != n_new or not all(0 <= t < cfg.vocab for t in s):
            raise AssertionError(f"bad stream: {s}")
    line = {"phase": "serving", "requests": len(prompts), "users": len(users),
            "prompt_lens": prompt_lens.tolist(), "new_tokens": n_new, "kv": "int8",
            "page": page, "prefill_ms": eng.prefill_seconds * 1e3,
            "decode_steps": eng.decode_steps,
            "decode_ms_per_step": eng.decode_seconds * 1e3 / eng.decode_steps,
            "decode_tokens_per_s": eng.decode_tokens / eng.decode_seconds,
            "wall_s": wall, "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "init_max_memory_allocated": init_peak,
            "launches": launches, "first_tokens": [s[:4] for s in streams]}
    emit(line)
    if keep is not None:
        keep.update(backbone=backbone, users=users, prompts=prompts, streams=streams,
                    line=line)
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    s_pad = 1 << (int(max(prompt_lens)) - 1).bit_length()  # the engine's prompt bucket
    walls["prefill"] = {"s": eng.prefill_seconds, "batch": len(prompts), "prompt_pad": s_pad,
                        "page": page, "max_len": max_len, "users": len(users)}
    walls["decode"] = {"s": eng.decode_seconds / eng.decode_steps, "batch": max_batch,
                       "steps": eng.decode_steps, "page": page, "max_len": max_len,
                       "users": len(users)}
    del eng
    profile_decode(ServeEngine(backbone, cfg, users, r=r, kernel_impl="cuda", kv_policy="int8",
                               page_size=page, max_len=max_len, max_batch=max_batch),
                   prompts, names)

    # the first prefill and 2 decode steps again, cuda OpSet vs ref OpSet
    bank = stack_adapters([users[n] for n in names])
    ab = gather_adapters(bank, torch.arange(8, device="cuda") % 4)
    logits = paged_cuda_vs_ref(backbone, cfg, ab, prompts, page, max_len, r, s_pad)
    tol = 2e-2
    diffs = [max_err(a, b) for a, b in zip(logits["cuda"], logits["ref"])]
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
             for a, b in zip(logits["cuda"], logits["ref"])]
    finite = all(bool(torch.isfinite(t).all()) for t in logits["cuda"] + logits["ref"])
    emit({"phase": "cuda_vs_ref", "steps": ["prefill", "decode1", "decode2"],
          "max_abs_dlogits": diffs, "greedy_agreement": agree, "tol": tol,
          "tol_reason": "f32 sums reorder through 24 layers, and an int8 KV code may move by "
                        "one step where the two paths' K/V differ in the last ulp",
          "logits_shape": list(logits["cuda"][0].shape), "finite": finite})
    if not finite or max(diffs) > tol or logits["cuda"][0].shape != (8, cfg.vocab):
        raise AssertionError(f"cuda vs ref logits: {diffs} (tol {tol}), finite={finite}")
    return launches


# ---------------------------------------------------------------- other pages, a bound pool, INT4

#: new tokens a request of the f32/bf16-page and INT4 serving cells (the int8 cell's 32, cut
#: for the smoke's time)
SHORT_NEW_TOKENS = 8
#: new tokens a request of the page-bound cell
POOL_NEW_TOKENS = 8
#: the serving gate by KV page type: max |Δlogits| of the prefill and two decode steps,
#: ``cuda`` OpSet against ``ref`` on the same greedy tokens
KV_TOL = {"int8": 2e-2, "bf16": 2e-2, "f32": 2e-4}
KV_TOL_REASON = {
    "int8": "f32 sums reorder through 24 layers, and an int8 KV code may move by one step where "
            "the two paths' K/V differ in the last ulp",
    "bf16": "f32 sums reorder through 24 layers, and a K/V value whose two f32 values differ "
            "in the last ulp may round to neighbouring bf16 values: one bf16 step, at most "
            "2^-7 of |v| and so of its block's absmax, the size of one int8 code step "
            "(absmax/127); a flipped bf16 value moves the attention no further than a flipped "
            "int8 code, so bf16 pages take the int8 gate (the reference's own bf16 decode "
            "tolerance, tests/test_decode_parity.py:36, is 3e-2)",
    "f32": "the reference's decode-parity ceiling over f32 KV (tests/test_decode_parity.py:36), "
           "which the personal path meets over f32 KV (personal_gap)",
}


def _bucket(n: int, cap: int) -> int:
    """The engine's power-of-two bucket of ``n``, at most ``cap``."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def watch_schedule(eng, rec: dict) -> dict:
    """Record ``eng``'s admissions into ``rec`` as they happen: this
    package's ``ServeEngine`` and the reference's alike (each admits
    through ``_run_prefill(reqs, row0)`` inside ``step()`` and takes pages
    with ``allocator.alloc``). ``rec``: ``waves``, one [step (from 1),
    request ids, batch bucket, prompt bucket] a prefill wave; ``steps``;
    ``max_in_use``, the most pages held at once (the null page aside)."""
    rec.update(waves=[], steps=0, max_in_use=0)
    step, prefill, alloc = eng.step, eng._run_prefill, eng.allocator.alloc

    def stepped():
        rec["steps"] += 1
        return step()

    def prefilled(reqs, row0):
        rec["waves"].append([rec["steps"], [r.rid for r in reqs],
                             _bucket(len(reqs), eng.max_batch),
                             _bucket(max(len(r.prompt) for r in reqs), 1 << 30)])
        return prefill(reqs, row0)

    def allocated(n):
        pages = alloc(n)
        rec["max_in_use"] = max(rec["max_in_use"],
                                eng.allocator.n_pages - 1 - eng.allocator.free_pages)
        return pages

    eng.step, eng._run_prefill, eng.allocator.alloc = stepped, prefilled, allocated
    return rec


def admission_replay(lens, n_new: int, page: int, max_len: int, max_batch: int,
                     n_pages: int, rec: dict = None) -> dict:
    """What ``ServeEngine`` does with prompts of ``lens`` tokens (request
    ids in order) and ``n_new`` greedy tokens each, no end token, on a
    pool of ``n_pages`` pages, replayed on the page table alone: no model
    runs, for the schedule depends on the lengths alone. Each step admits
    pending requests in order while a slot is free and the prompt's pages
    are free (the first that does not fit waits, and all behind it),
    prefills them in one wave (their first token), retires the finished,
    then extends every active request by one token (a page on a boundary,
    as the reference's ``step``), accounts the token and retires again,
    swap-removing. Returns :func:`watch_schedule`'s record plus
    ``waits``, the steps whose admission stopped on pages (filled into
    ``rec`` where given); raises ``OutOfPagesError`` where the engine
    would, ``rec`` then holding the schedule up to that step."""
    from repro_torch.serve import paging

    table = paging.PageTable(paging.PageAllocator(n_pages), page, -(-max_len // page))
    free = table.allocator
    rec = {} if rec is None else rec
    rec.update(waves=[], steps=0, max_in_use=0, waits=0)
    pending, active = list(range(len(lens))), []  # active: [request id, tokens emitted]

    def held():
        rec["max_in_use"] = max(rec["max_in_use"], n_pages - 1 - free.free_pages)

    def retire():
        for idx in range(len(active) - 1, -1, -1):
            if active[idx][1] >= n_new:
                table.close(active[idx][0])
                active[idx] = active[-1]
                active.pop()

    while pending or active:
        rec["steps"] += 1
        wave = []
        while len(active) < max_batch and pending:
            rid = pending[0]
            if -(-lens[rid] // page) > free.free_pages:
                rec["waits"] += 1
                break
            table.open(pending.pop(0), lens[rid])
            active.append([rid, 1])
            wave.append(rid)
        held()
        if wave:
            rec["waves"].append([rec["steps"], wave, _bucket(len(wave), max_batch),
                                 _bucket(max(lens[i] for i in wave), 1 << 30)])
        elif not active:
            raise paging.OutOfPagesError(f"prompt {pending[0]} needs more pages than the pool")
        retire()
        for rid, _ in active:
            table.extend_to(rid, table.length(rid) + 1)
        held()
        for a in active:
            table.append_token(a[0])
            a[1] += 1
        retire()
    return rec


def tight_pool(lens, n_new: int, page: int, max_len: int, max_batch: int):
    """The largest pool, by host arithmetic on the lengths alone, below
    what the prompts need at once (their pages and the null page) on
    which :func:`admission_replay` waits at least once, prefills in at
    least two waves of different batch buckets and never runs out of
    pages: the reference's engine has no eviction, so a decode step that
    finds no page raises. Returns (n_pages, the replay)."""
    from repro_torch.serve.paging import OutOfPagesError

    at_once = sum(-(-n // page) for n in lens) + 1
    for n_pages in range(at_once - 1, 1, -1):
        try:
            rec = admission_replay(lens, n_new, page, max_len, max_batch, n_pages)
        except OutOfPagesError:
            continue
        if rec["waits"] and len({w[2] for w in rec["waves"]}) >= 2:
            return n_pages, rec
    raise AssertionError(f"no pool below {at_once} pages admits {lens} in waves")


def serving_adapters(users: dict, n: int):
    """The serving cells' adapter rows: ``users`` in turn over ``n`` requests."""
    from repro_torch.core.parallel_adapters import gather_adapters, stack_adapters

    names = list(users)
    return gather_adapters(stack_adapters([users[u] for u in names]),
                           torch.arange(n, device=DEV) % len(names))


def serving_gate(backbone, cfg, users, prompts, kv_policy: str, phase: str) -> dict:
    """The prompts' prefill and two decode steps over ``kv_policy`` pages
    under ``cuda`` and ``ref`` (:func:`paged_cuda_vs_ref`), held to
    ``KV_TOL`` with equal greedy tokens at every step: the figures."""
    s_pad = _bucket(max(map(len, prompts)), 1 << 30)
    logits = paged_cuda_vs_ref(backbone, cfg, serving_adapters(users, len(prompts)), prompts,
                               SERVING_PAGE, SERVING_MAX_LEN, SERVING_R, s_pad,
                               kv_policy=kv_policy)
    diffs = [max_err(a, b) for a, b in zip(logits["cuda"], logits["ref"])]
    equal = [bool(torch.equal(a.argmax(-1), b.argmax(-1)))
             for a, b in zip(logits["cuda"], logits["ref"])]
    finite = all(bool(torch.isfinite(t).all()) for t in logits["cuda"] + logits["ref"])
    tol = KV_TOL[kv_policy]
    if not (finite and max(diffs) <= tol and all(equal)):
        raise AssertionError(f"{phase} cuda vs ref over {kv_policy} pages: |dlogits| {diffs} "
                             f"(tol {tol}), greedy equal {equal}, finite {finite}")
    return {"steps": ["prefill", "decode1", "decode2"], "max_abs_dlogits": diffs,
            "greedy_equal": equal, "tol": tol, "tol_reason": KV_TOL_REASON[kv_policy]}


def kv_pages_phase(timer: Timer, gen: torch.Generator, keep: dict):
    """Paged attention over f32 and over bf16 pages at the check's shape
    (:func:`paged_phase`'s first), timed; then the serving cell over each:
    the int8 cell's backbone, users and prompts (not drawn again),
    ``SHORT_NEW_TOKENS`` new
    tokens a request through ``ServeEngine(kv_policy=)`` with launches
    counted (paged attention's unscaled branch), then the prefill and two
    decode steps under ``cuda`` and ``ref`` (:func:`serving_gate`). Prints
    each cell's times and KV bytes a token beside the int8 cell's.
    Returns (each cell's launches, the kernel rows by page type)."""
    from repro_torch.configs import get_arch
    from repro_torch.serve import paging

    lengths_np = np.random.default_rng(SEED).integers(1, 512, size=8).astype(np.int32)
    rows = {}
    for policy in ("f32", "bf16"):
        r = paged_timed(timer, gen, lengths_np, 32, f"decode B=8 Hkv=8 n_rep=2 hd=128 page=16 "
                        f"{policy}, lengths<=511", pages=policy)
        rows[policy] = {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "at", "plan")}
    cfg = get_arch(SERVING_ARCH)
    backbone, users, prompts, int8 = keep["backbone"], keep["users"], keep["prompts"], keep["line"]
    paths = {}
    for policy in ("f32", "bf16"):
        t0 = time.perf_counter()
        serve_streams(backbone, cfg, users, prompts, "cuda", 2, SERVING_PAGE, SERVING_MAX_LEN,
                      SERVING_BATCH, SERVING_R, kv_policy=policy)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        eng, streams, wall = serve_streams(backbone, cfg, users, prompts, "cuda", SHORT_NEW_TOKENS,
                                           SERVING_PAGE, SERVING_MAX_LEN, SERVING_BATCH,
                                           SERVING_R, kv_policy=policy)
        launches = {k: v for k, v in read_launches().items()
                    if k in ("quant_matmul", "flash_attention", "paged_attention")}
        peak = torch.cuda.max_memory_allocated()
        missing = [n for n, c in launches.items() if c <= 0]
        if missing:
            raise AssertionError(f"kernels never launched over {policy} pages: {missing}")
        gate = serving_gate(backbone, cfg, users, prompts, policy, f"{policy}_kv_serving")
        emit({"phase": f"{policy}_kv_serving", "arch": cfg.name, "kv": policy,
              "requests": len(prompts), "new_tokens": SHORT_NEW_TOKENS, "page": SERVING_PAGE,
              "n_pages": eng.allocator.n_pages,
              "kv_bytes_per_token": paging.kv_bytes_per_token(cfg, policy),
              "prefill_ms": eng.prefill_seconds * 1e3, "decode_steps": eng.decode_steps,
              "decode_ms_per_step": eng.decode_seconds * 1e3 / eng.decode_steps,
              "decode_tokens_per_s": eng.decode_tokens / eng.decode_seconds, "wall_s": wall,
              "max_memory_allocated": peak, "launches": launches,
              "streams_equal_int8_kv": [s == t[:SHORT_NEW_TOKENS]
                                        for s, t in zip(streams, keep["streams"])],
              "int8_cell": {"kv_bytes_per_token": paging.kv_bytes_per_token(cfg, "int8"),
                            **{k: int8[k] for k in ("prefill_ms", "decode_ms_per_step",
                                                    "decode_tokens_per_s", "new_tokens")}},
              "cuda_vs_ref": gate, "seconds": time.perf_counter() - t0})
        paths[f"{policy}_kv_serving"] = launches
    return paths, rows


def page_bound_phase(keep: dict) -> dict:
    """The serving cell on a pool too small for all its prompts at once
    (:func:`tight_pool`): admission waits, and prefill runs in waves of
    different buckets. The int8 cell's backbone, users and prompts,
    ``POOL_NEW_TOKENS`` new tokens a request, under ``cuda`` (launches
    counted) and ``ref`` at the same pool. Gates: each run's schedule
    (which request each step admits, each wave's buckets) equals the host
    replay's, the streams are equal, no more than ``n_pages`` - 1 pages
    are ever held, and every page is free once the engine drains. Prints
    whether the streams equal the ample pool's (the int8 cell's)."""
    from repro_torch.configs import get_arch

    cfg = get_arch(SERVING_ARCH)
    backbone, users, prompts = keep["backbone"], keep["users"], keep["prompts"]
    t0 = time.perf_counter()
    lens = [len(p) for p in prompts]
    n_pages, replay = tight_pool(lens, POOL_NEW_TOKENS, SERVING_PAGE, SERVING_MAX_LEN,
                                 SERVING_BATCH)
    runs = {}
    for impl in ("cuda", "ref"):
        schedule = {}
        reset_launches()
        eng, streams, wall = serve_streams(backbone, cfg, users, prompts, impl, POOL_NEW_TOKENS,
                                           SERVING_PAGE, SERVING_MAX_LEN, SERVING_BATCH,
                                           SERVING_R, n_pages=n_pages, schedule=schedule)
        runs[impl] = {"streams": streams, "schedule": schedule, "wall_s": wall,
                      "free_at_end": eng.allocator.free_pages,
                      "prefill_ms": eng.prefill_seconds * 1e3, "decode_steps": eng.decode_steps,
                      "decode_ms_per_step": eng.decode_seconds * 1e3 / eng.decode_steps,
                      "launches": {k: v for k, v in read_launches().items()
                                   if k in ("quant_matmul", "flash_attention",
                                            "paged_attention")}}
        del eng
    cuda, ref = runs["cuda"], runs["ref"]
    line = {"phase": "page_bound_serving", "arch": cfg.name, "kv": "int8",
            "requests": len(prompts), "prompt_lens": lens, "new_tokens": POOL_NEW_TOKENS,
            "page": SERVING_PAGE, "n_pages": n_pages,
            "pages_at_once": sum(-(-n // SERVING_PAGE) for n in lens) + 1,
            "replay": replay, "schedule": cuda["schedule"], "ref_schedule": ref["schedule"],
            "schedule_equal_replay": [runs[i]["schedule"]["waves"] == replay["waves"]
                                      for i in runs],
            "streams_equal": cuda["streams"] == ref["streams"],
            "max_pages_in_use": [runs[i]["schedule"]["max_in_use"] for i in runs],
            "free_at_end": [runs[i]["free_at_end"] for i in runs],
            "streams_equal_ample_pool": [s == t[:POOL_NEW_TOKENS]
                                         for s, t in zip(cuda["streams"], keep["streams"])],
            **{k: cuda[k] for k in ("prefill_ms", "decode_steps", "decode_ms_per_step",
                                    "wall_s", "launches")},
            "ref_wall_s": ref["wall_s"], "seconds": time.perf_counter() - t0}
    emit(line)
    waves = cuda["schedule"]["waves"]
    if not (all(line["schedule_equal_replay"]) and len(waves) >= 2
            and len({w[2] for w in waves}) >= 2 and replay["waits"] > 0):
        raise AssertionError(f"page-bound schedule {waves} against the replay {replay}")
    if not line["streams_equal"]:
        raise AssertionError("page-bound streams differ between cuda and ref")
    if max(line["max_pages_in_use"]) > n_pages - 1 or line["free_at_end"] != [n_pages - 1] * 2:
        raise AssertionError(f"pages held {line['max_pages_in_use']}, free at the end "
                             f"{line['free_at_end']} of {n_pages - 1}")
    missing = [n for n, c in cuda["launches"].items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the page-bound path: {missing}")
    return cuda["launches"]


def int4_kernel_phase(timer: Timer, gen: torch.Generator) -> dict:
    """int4 ``quant_matmul`` at each projection shape of an internlm2-1.8b
    layer, (K, N) in ``QMM_SHAPES``, at M = 1 and 8 (the skinny GEMV) and
    2048 and 4096 (the tiled ``qmm_mma``), each held to its plain version
    and timed beside its bound and ``torch.matmul`` on the dequantized
    weight; one layer's seven projections summed at each M."""
    qmm = {}
    for M in PATH_QMM_ROWS:
        for K, N in QMM_SHAPES:
            qmm[(M, K, N, 4)] = qmm_case(timer, gen, M, K, N, 4)
    rows = {}
    for M in PATH_QMM_ROWS:
        rows[f"M={M}"] = layer_row(qmm, M, bits=4)
        emit({"check": "quant_matmul_layer", "M": M, "bits": 4, **rows[f"M={M}"]})
    return rows


def branch_counts() -> dict:
    from repro_torch.kernels import quant_matmul

    return dict(quant_matmul.branch_launches)


def require_branches(path: str, branches: dict, want) -> None:
    missing = [b for b in want if branches.get(b, 0) <= 0]
    if missing:
        raise AssertionError(f"quant_matmul never took {missing} on the {path} path: "
                             f"{branches}")


def int4_serving_phase(gen: torch.Generator, keep: dict) -> dict:
    """An INT4 backbone drawn once from the seeded generator, served to
    the int8 cell's users and prompts: ``SHORT_NEW_TOKENS`` new tokens a
    request through ``ServeEngine`` over int8 pages (launches counted by
    branch: the tiled ``qmm_mma`` in the prefill wave, M = 8 x 512, and the
    skinny GEMV at the decode's M = 8), then the prefill and two decode
    steps under ``cuda`` and ``ref`` (:func:`serving_gate`), and two decode
    steps under the profiler (``int4_decode_profile``). The streams'
    agreement with the INT8 backbone's is printed, not gated: the weights
    differ. Returns (launches, the backbone)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.quantization import tree_storage_bytes
    from repro_torch.models.backbone import init_backbone
    from repro_torch.serve import ServeEngine

    cfg = get_arch(SERVING_ARCH)
    users, prompts = keep["users"], keep["prompts"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    backbone = init_backbone(gen, cfg, device="cuda", quant_bits=4)
    torch.cuda.synchronize()
    emit({"phase": "serving_init", "arch": cfg.name, "quant": 4,
          "backbone_bytes": tree_storage_bytes(backbone), "seconds": time.perf_counter() - t0})
    serve_streams(backbone, cfg, users, prompts, "cuda", 2, SERVING_PAGE, SERVING_MAX_LEN,
                  SERVING_BATCH, SERVING_R)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    eng, streams, wall = serve_streams(backbone, cfg, users, prompts, "cuda", SHORT_NEW_TOKENS,
                                       SERVING_PAGE, SERVING_MAX_LEN, SERVING_BATCH, SERVING_R)
    launches = {k: v for k, v in read_launches().items()
                if k in ("quant_matmul", "flash_attention", "paged_attention")}
    branches = branch_counts()
    peak = torch.cuda.max_memory_allocated()
    gate = serving_gate(backbone, cfg, users, prompts, "int8", "int4_serving")
    emit({"phase": "int4_serving", "arch": cfg.name, "quant": 4, "kv": "int8",
          "requests": len(prompts), "new_tokens": SHORT_NEW_TOKENS, "page": SERVING_PAGE,
          "prefill_ms": eng.prefill_seconds * 1e3, "decode_steps": eng.decode_steps,
          "decode_ms_per_step": eng.decode_seconds * 1e3 / eng.decode_steps,
          "decode_tokens_per_s": eng.decode_tokens / eng.decode_seconds, "wall_s": wall,
          "max_memory_allocated": peak, "launches": launches,
          "quant_matmul_branches": branches,
          "token_agreement_int8_backbone": [
              float(np.mean([a == b for a, b in zip(s, t)]))
              for s, t in zip(streams, keep["streams"])],
          "cuda_vs_ref": gate, "seconds": time.perf_counter() - t0})
    require_branches("int4 serving", branches, ("int4 tiled", "int4 skinny"))
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the int4 serving path: {missing}")
    profile_decode(ServeEngine(backbone, cfg, users, r=SERVING_R, kernel_impl="cuda",
                               kv_policy="int8", page_size=SERVING_PAGE,
                               max_len=SERVING_MAX_LEN, max_batch=SERVING_BATCH,
                               device=DEV),
                   prompts, list(users), phase="int4_decode_profile")
    return {**launches, "quant_matmul_branches": branches}, backbone


def int4_personal_phase(backbone, cfg, ckpt: Path, r: int = 8) -> dict:
    """The INT4 run's checkpoint served to one user: the prompt's prefill
    (``prefill_step``, M = ``PROMPT_LEN``: the tiled path) under ``cuda``
    and ``ref`` (the serving gate), then ``PERSONAL_STEPS`` ``pac_decode_step``s at B = 1
    (8 teacher-forced prompt tokens, then greedy; M = 1: the skinny GEMV)
    over an INT8 and an f32 linear KV cache, each under ``cuda`` (launches
    counted) and ``ref``: ``personal_phase``'s gates, 2e-2 over INT8 KV
    and 2e-4 over f32 KV (the ``personal_gap``), greedy tokens equal."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.parallel_adapters import init_adapter_cache
    from repro_torch.core.steps import pac_decode_step, prefill_step
    from repro_torch.models.backbone import init_cache

    t0 = time.perf_counter()
    adapter = load_checkpoint(str(ckpt), device=DEV)["adapter"]
    n_prompt, n_steps, max_len = 8, PERSONAL_STEPS, 16
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, size=(1, PROMPT_LEN)).astype(np.int32)).to(DEV)
    reset_launches()
    pre = {impl: prefill_step(backbone, {"tokens": prompt}, cfg=cfg, kernel_impl=impl)
           for impl in ("cuda", "ref")}
    prefill_branches = branch_counts()
    prefill_err = max_err(pre["cuda"], pre["ref"])

    def serve(impl, kv_quant):
        cache = init_cache(cfg, 1, max_len, device=DEV, kv_quant=kv_quant)
        acache = init_adapter_cache(cfg, 1, max_len, r, device=DEV)
        logits, greedy, tok = [], [], prompt[:, :1]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for p in range(n_steps):
            lg, cache, acache = pac_decode_step(
                backbone, adapter, {"tokens": tok}, cache, acache,
                torch.full((1,), p, dtype=torch.long, device=DEV), cfg=cfg, r=r,
                kernel_impl=impl)
            logits.append(lg[:, 0])
            if p >= n_prompt - 1:
                greedy.append(int(lg[0, 0].argmax()))
            tok = (prompt[:, p + 1:p + 2] if p + 1 < n_prompt
                   else torch.tensor([[greedy[-1]]], dtype=torch.int32, device=DEV))
        torch.cuda.synchronize()
        return torch.cat(logits), greedy, time.perf_counter() - t

    serve("cuda", 8)  # warm-up
    reset_launches()
    runs = {(impl, kv): serve(impl, kv) for impl in ("cuda", "ref") for kv in (8, None)}
    launches = {k: v for k, v in read_launches().items()
                if k in ("quant_matmul", "flash_attention", "adapter_fuse")}
    decode_branches = branch_counts()
    gap = {kv: (runs[("cuda", kv)][0] - runs[("ref", kv)][0]).abs().amax(-1).tolist()
           for kv in (8, None)}
    tokens_equal = {kv: runs[("cuda", kv)][1] == runs[("ref", kv)][1] for kv in (8, None)}
    per_step = {k: v / (2 * n_steps) for k, v in launches.items()}  # two cuda loops
    tol = {"dlogits": 2e-2, "dlogits_f32_kv": 2e-4, "prefill": KV_TOL["int8"]}
    finite = all(bool(torch.isfinite(v[0]).all()) for v in runs.values())
    emit({"phase": "int4_personal", "arch": cfg.name, "quant": 4, "batch": 1,
          "adapter": f"{ckpt.name}, r={r}", "steps": n_steps, "prompt_tokens": n_prompt,
          "prefill_tokens": PROMPT_LEN, "prefill_max_abs_dlogits": prefill_err,
          "prefill_quant_matmul_branches": prefill_branches,
          "decode_ms_per_step": runs[("cuda", 8)][2] * 1e3 / n_steps,
          "decode_ms_per_step_f32_kv": runs[("cuda", None)][2] * 1e3 / n_steps,
          "ref_decode_ms_per_step": runs[("ref", 8)][2] * 1e3 / n_steps,
          "launches": launches, "launches_per_step": per_step,
          "quant_matmul_branches": decode_branches,
          "tokens_cuda": runs[("cuda", 8)][1], "tokens_equal_int8_kv": tokens_equal[8],
          "tokens_equal_f32_kv": tokens_equal[None],
          "max_abs_dlogits_int8_kv": max(gap[8]), "max_abs_dlogits_f32_kv": max(gap[None]),
          "personal_gap_per_step": gap[None], "tol": tol,
          "tol_reason": "personal_phase's: the serving gate over INT8 KV, the reference's "
                        "decode-parity ceiling over f32 KV (tests/test_decode_parity.py:36); "
                        "the prefill at the serving gate", "seconds": time.perf_counter() - t0})
    if not (finite and all(tokens_equal.values()) and max(gap[8]) <= tol["dlogits"]
            and max(gap[None]) <= tol["dlogits_f32_kv"] and prefill_err <= tol["prefill"]):
        raise AssertionError(f"int4 personal cuda vs ref: tokens equal {tokens_equal}, gap "
                             f"{max(gap[8])} / {max(gap[None])}, prefill {prefill_err}")
    require_branches("int4 personal prefill", prefill_branches, ("int4 tiled",))
    require_branches("int4 personal decode", decode_branches, ("int4 skinny",))
    if (per_step["adapter_fuse"] != cfg.n_periods or per_step["quant_matmul"] != 7 * cfg.n_layers
            or decode_branches.get("int4 skinny", 0) != launches["quant_matmul"]):
        raise AssertionError(f"int4 launches per decode step: {per_step}, {decode_branches}")
    return {**launches, "quant_matmul_branches": {
        b: prefill_branches.get(b, 0) + decode_branches.get(b, 0)
        for b in set(prefill_branches) | set(decode_branches)}}


# ---------------------------------------------------------------- bf16 backbone

#: the reference's bf16 tolerance for losses, adapter gradients and taps (and the
#: serving gate of its bf16 pages), tests/test_opset.py:35-48, tests/test_decode_parity.py:36
BF16_TOL = 3e-2
BF16_TOL_REASON = ("the reference's bf16 tolerance (tests/test_opset.py:35-48): every op of a "
                   "bf16 backbone rounds to 8 bits, and cuda rounds in other places than ref "
                   "(flash's O once, the paged kernel's f32 softmax)")
#: the port's own move on each bf16 backbone at full width and depth, its ``ref`` OpSet on
#: the card against the same program on the host's CPU, the same weights and inputs
#: (:func:`bf16_own_move`, ``--bf16-own-move --arch ...``; NVIDIA H100 80GB HBM3, 700.00 W):
#: the largest |Δlogits| over the serving cell's prefill and two decode steps on int8, bf16
#: and f32 pages, over the personal prompt's last logits, and over the epoch-1 step's bf16
#: taps. internlm2-1.8b: 0.081-0.089 a serving step (2 of 24 rows' greedy tokens differ a
#: page policy, at top-2 margins of 0.0015-0.014), taps of a scale 23.75. gemma2-2b (its 8
#: requests over the three page kinds and its 4500-token prompt over int8 pages): 0.0955-0.1093
#: a step on the 8 requests, 0.0863-0.0921 on the long prompt (whose greedy token differs at 2
#: of 3 steps, at margins 0.029-0.030), taps of a scale 24.75.
BF16_OWN_MOVE = {
    "internlm2-1.8b": {"serving": 0.08939427137374878, "personal_prefill": 0.078125,
                       "taps": 0.5625},
    "gemma2-2b": {"serving": 0.10926267504692078, "personal_prefill": 0.0892333984375,
                  "taps": 0.6875},
}
#: the bf16 gates' bound over that move: the smoke's backbone is another draw than the
#: measurement's, and C5's factor for a move measured on one draw (FORM_FACTOR in
#: tests/test_torch_moe_configs.py)
BF16_FORM_FACTOR = 2
BF16_LOGITS_REASON = (
    "the port's own move at full depth (BF16_OWN_MOVE[arch]: ref on the card against ref on "
    "the host's CPU), times BF16_FORM_FACTOR. Greedy "
    "tokens equal in every row whose ref top-2 margin exceeds twice the own move, the rows "
    "the port's own move cannot flip; its own runs flipped rows at margins <= 0.014 "
    "(internlm2-1.8b) and <= 0.030 (gemma2-2b)")
#: a bf16 kernel output against its plain version's: the two f32 results a few
#: ulps apart round to one bf16 value or to neighbours, 2^-7 of the value at most
BF16_OUT_RTOL = 2.0 ** -7
BF16_OUT_ATOL = 1e-6  # what bf16_out_check may exceed one bf16 step by
BF16_OUT_TOL = f"|dO| <= 2^-7 |O| + {BF16_OUT_ATOL}"
BF16_OUT_TOL_REASON = ("one bf16 rounding of O: q, k, v exact on the tensor cores, P in three "
                       "terms, the softmax and O summed in f32, O rounded to bf16 once as the "
                       "plain version rounds its f32 O")
BF16_NEW_TOKENS = 8  # a request's new tokens on the bf16 serving path
BF16_STEPS = 2  # epoch-1 steps, then as many cached steps
BF16_PERSONAL_PROMPT, BF16_PERSONAL_STEPS = 4, 8  # teacher-forced, then greedy to 8 tokens


def bf16_logits_gate(cuda: list, ref: list, phase: str, kind: str = "serving",
                     arch: str = SERVING_ARCH) -> dict:
    """Each step's (B, V) logits under ``cuda`` against ``ref`` on ``arch``'s
    bf16 backbone: within ``BF16_FORM_FACTOR`` times the port's own move
    ``BF16_OWN_MOVE[arch][kind]``, greedy tokens equal in every row whose
    ``ref`` top-2 margin exceeds twice that move (``BF16_LOGITS_REASON``)."""
    own = BF16_OWN_MOVE[arch][kind]
    tol = BF16_FORM_FACTOR * own
    diffs, equal, decided, close = [], [], [], []
    for a, b in zip(cuda, ref):
        a, b = a.float(), b.float()
        top2 = b.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * own
        same = a.argmax(-1) == b.argmax(-1)
        diffs.append(float((a - b).abs().max()))
        equal.append(same.tolist())
        decided.append(bool(same[clear].all()))
        close.append(int((~clear).sum()))
    finite = all(bool(torch.isfinite(t).all()) for t in cuda + ref)
    if not (finite and max(diffs) <= tol and all(decided)):
        raise AssertionError(f"{phase} cuda vs ref: |dlogits| {diffs} (tol {tol}), greedy "
                             f"equal {equal}, equal where decided {decided}, finite {finite}")
    return {"max_abs_dlogits": diffs, "tol": tol, "own_move": own, "greedy_equal": equal,
            "greedy_equal_where_decided": decided, "rows_within_own_move": close,
            "tol_reason": BF16_LOGITS_REASON}


def bf16_out_check(got: torch.Tensor, want: torch.Tensor) -> float:
    """max(|Δ| − 2^-7·|want|) of a bf16 output against its plain version's."""
    return float(((got.float() - want.float()).abs() - BF16_OUT_RTOL * want.float().abs()).max())


def bf16_kernel_phase(timer: Timer, gen: torch.Generator) -> dict:
    """The three kernels' bf16 branches at the bf16 path's shapes, each
    against its plain version and timed: flash with bf16 q, k, v at the
    prefill (B·H = 8·16) and epoch-1 (4·16) shapes, S 512, hd 128 (the
    kernel its route launches named, timed beside the reference's function,
    SDPA in f32 on the upcast inputs, and SDPA on bf16), two calls at the
    prefill shape bit-equal, and at S 37 and 1001, n_rep 1 and 2, causal or
    not, window 128 or none, soft-cap 30 or none, and Sq 300 over Sk 100
    with window 128 (rows with no key); paged
    attention with a bf16 q over int8, bf16 and f32 pages at the check's
    shape; ``ce_fwd``/``ce_bwd`` with the bf16 head (W) and the f32 hidden
    (h, the side network's sum) at the training shape, with and without the
    soft-cap, and with a bf16 h too at a ragged shape, on the wgmma loop
    (the kernels each route launches named, W read in place or, where V is
    not a multiple of 8, from one padded copy), two calls bit-equal, timed
    beside the f32 yardstick (the reference's function) and the bf16-cast
    one. Returns the kernels line's ``bf16`` rows."""
    from repro_torch.kernels.flash_attention import flash_attention

    rows = {"flash_attention": {}, "paged_attention": {}}
    for name, B in (("prefill", 8), ("training", 4)):
        r, (q, k, v), _ = flash_case(timer, gen, B, 16, 8, 512, 128,
                                     f"bf16 {name} B*H={B}*16 over {B}*8", dtype=torch.bfloat16)
        emit(r)
        rows["flash_attention"][name] = {key: r[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_f32_ms",
            "library_ms", "library_bf16_ms", "route", "at")}
        if name == "prefill":  # two calls bit for bit (each row's sums in a fixed order)
            equal = bool(torch.equal(flash_attention(q, k, v), flash_attention(q, k, v)))
            emit({"check": "flash_attention_deterministic", "dtype": "bfloat16", "BH": 128,
                  "BHkv": 64, "S": 512, "hd": 128, "route": r["route"], "bit_equal": equal})
            if not equal:
                raise AssertionError("flash_attention bf16 prefill: two calls differ")
    flash_ragged(gen, hds=(128,), dtype=torch.bfloat16, window=128)
    flash_keyless(gen, hds=(128,), dtype=torch.bfloat16, window=128)
    lengths_np = np.random.default_rng(SEED).integers(1, 512, size=8).astype(np.int32)
    for pages in ("int8", "bf16", "f32"):
        r = paged_timed(timer, gen, lengths_np, 32, f"bf16 q, decode B=8 Hkv=8 n_rep=2 hd=128 "
                        f"page=16 {pages}, lengths<=511", pages=pages, q_dtype=torch.bfloat16)
        rows["paged_attention"][pages] = {k: r[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at")}

    T, d, V = TRAIN_T, TRAIN_D, TRAIN_V
    h = torch.randn(T, d, generator=gen, device=DEV)
    w = (torch.randn(d, V, generator=gen, device=DEV) * d ** -0.5).to(torch.bfloat16)
    lab = torch.randint(0, V, (T,), generator=gen, device=DEV)
    g = torch.randn(T, generator=gen, device=DEV)
    cases = [(h, w, lab, g, cap) for cap in (None, 30.0)]
    h2 = torch.randn(37, 130, generator=gen, device=DEV)
    w2 = (torch.randn(130, 517, generator=gen, device=DEV) * 130 ** -0.5).to(torch.bfloat16)
    lab2 = torch.randint(0, 517, (37,), generator=gen, device=DEV)
    g2 = torch.randn(37, generator=gen, device=DEV)
    cases += [(h2.to(torch.bfloat16), w2, lab2, g2, 30.0), (h2, w2, lab2, g2, None)]
    errs = bf16_ce_checks(cases, h)
    rows.update(bf16_ce_timed(timer, h, w, lab, g, None, "bf16 head, T=4*512, d=2048, V=92544",
                              errs))
    return rows


#: the bf16 branches at head widths 256, 64 and 112, at the shapes their paths give them:
#: flash as (row, B, H, Hkv, S, hd, soft-cap, window, what), causal
BF16_WIDE_FLASH = [
    ("gemma2_prefill", 8, 8, 4, 512, 256, 50.0, None, "gemma2-2b prefill"),
    ("gemma2_long", 1, 8, 4, 4500, 256, 50.0, 4096,
     "gemma2-2b's 4500-token prompt, window 4096 (it bites)"),
    ("gemma2_training", 4, 8, 4, 512, 256, 50.0, None, "gemma2-2b epoch-1 step"),
    ("t5_training", 4, 12, 12, 512, 64, None, None, "t5-base-pac epoch-1 step"),
    ("kimi_prefill", 4, 64, 32, 512, 112, 30.0, 128, "kimi-k2 prefill, window 128"),
]
#: paged decode with a bf16 q as (row, Hkv, n_rep, hd, lengths below, max_pages, soft-cap), B 8,
#: pages of 16, over int8, bf16 and f32 pages
BF16_WIDE_PAGED = [
    ("hd256", 4, 2, 256, 512, 32, 50.0),
    ("hd256_long", 4, 2, 256, 4096, 256, 50.0),
    ("hd112", 8, 8, 112, 512, 32, None),
    ("hd64", 12, 1, 64, 512, 32, None),
]
#: the paged kernel's ragged cases at head width 64 (the default list's), for a bf16 q
BF16_HD64_PAGED_RAGGED = [
    (1, 2, 1, 64, 4, 136, [543], ()),
    (8, 2, 2, 64, 16, 34, [0, 15, 16, 17, 255, 256, 542, 543], ()),
]


def bf16_wide_kernel_phase(timer: Timer, gen: torch.Generator) -> dict:
    """The bf16 branches at the other head widths, each against its plain
    version and timed beside its bound, its plain version and its library
    yardstick: flash with bf16 q, k, v (``flash_pad`` + ``flash_fwd_mma<hd,
    bf16>``) at ``BF16_WIDE_FLASH``'s shapes, held to one bf16 rounding of
    O, two calls bit-equal each, and its ragged and keyless cases at hd 64,
    112 and 256 (window 128); paged attention with a bf16 q at
    ``BF16_WIDE_PAGED``'s shapes over int8, bf16 and f32 pages (row 3b's
    tolerances), two calls and three graph replays bit-equal at each width,
    its ragged cases at each width; ``ce_fwd``/``ce_bwd`` with gemma2-2b's
    tied bf16 head (d 2304, V 256000, read in place by TMA) and final
    soft-cap 30. Returns the kernels line's new ``bf16`` entries."""
    from repro_torch.kernels import lmhead_ce
    from repro_torch.kernels.flash_attention import flash_attention

    bf = torch.bfloat16
    rows = {"flash_attention": {}, "paged_attention": {}}
    for name, B, H, Hkv, S, hd, cap, window, at in BF16_WIDE_FLASH:
        r, (q, k, v), _ = flash_case(timer, gen, B, H, Hkv, S, hd, f"bf16 {at}", cap=cap,
                                     dtype=bf, window=window)
        emit(r)
        rows["flash_attention"][name] = {key: r[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_f32_ms",
            "library_ms", "library_bf16_ms", "route", "at")}
        kw = dict(attn_softcap=cap, window=window)
        equal = bool(torch.equal(flash_attention(q, k, v, **kw), flash_attention(q, k, v, **kw)))
        emit({"check": "flash_attention_deterministic", "dtype": "bfloat16", "at": at,
              "BH": B * H, "BHkv": B * Hkv, "S": S, "hd": hd, "route": r["route"],
              "bit_equal": equal})
        if not equal:
            raise AssertionError(f"flash_attention bf16 {at}: two calls differ")
        del q, k, v
    flash_ragged(gen, hds=(64, 112, 256), dtype=bf, window=128)
    flash_keyless(gen, hds=(64, 112, 256), dtype=bf, window=128)

    pkeys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at", "plan")
    for name, Hkv, n_rep, hd, below, max_pages, cap in BF16_WIDE_PAGED:
        lengths = np.random.default_rng(SEED).integers(1, below, size=8).astype(np.int32)
        for pages in ("int8", "bf16", "f32"):
            r = paged_timed(timer, gen, lengths, max_pages, f"bf16 q, decode B=8 Hkv={Hkv} "
                            f"n_rep={n_rep} hd={hd} page=16 {pages}, lengths<{below}",
                            Hkv=Hkv, n_rep=n_rep, hd=hd, cap=cap, pages=pages, q_dtype=bf)
            rows["paged_attention"][f"{name}_{pages}"] = {k_: r[k_] for k_ in pkeys}
        if max_pages == 32:
            paged_deterministic(gen, lengths, max_pages, Hkv=Hkv, n_rep=n_rep, hd=hd, q_dtype=bf)
    for shapes in (HD256_PAGED_RAGGED, HD112_PAGED_RAGGED, BF16_HD64_PAGED_RAGGED):
        paged_ragged(gen, shapes, q_dtype=bf)

    T, d, V = GEMMA2_T, GEMMA2_D, GEMMA2_V
    h = torch.randn(T, d, generator=gen, device=DEV)
    w = (torch.randn(d, V, generator=gen, device=DEV) * d ** -0.5).to(bf)
    lab = torch.randint(0, V, (T,), generator=gen, device=DEV)
    g = torch.randn(T, generator=gen, device=DEV)
    if not lmhead_ce.w_in_place(V, w.data_ptr()):
        raise AssertionError("gemma2-2b's bf16 head is not read in place")
    errs = bf16_ce_checks([(h, w, lab, g, 30.0)], h)
    for name, row in bf16_ce_timed(timer, h, w, lab, g, 30.0, f"gemma2-2b's tied bf16 head, "
                                   f"T=4*512, d={d}, V={V}, soft-cap 30", errs,
                                   arch=GEMMA2).items():
        rows[name] = {"gemma2": row}
    return rows

def bf16_ce_checks(cases: list, timed_h) -> dict:
    """``ce_fwd`` and ``ce_bwd`` with a bf16 head on each case (h, W, labels,
    g, soft-cap) against their plain versions: one ``lmhead_ce_bf16`` line
    a case (whether TMA reads W in place, the kernels each call launches);
    on the cases whose h is ``timed_h``, two calls bit-equal. Returns the
    largest max |Δ| of each over those cases."""
    from repro_torch.kernels import lmhead_ce, ref

    reason = ("the reference's blockwise-CE tolerances (tests/test_cached_step.py:105, :113): "
              "the bf16 W is exact on the tensor cores and h keeps its three terms")
    errs = {"ce_fwd": 0.0, "ce_bwd": 0.0}
    for hh, ww, ll, gg, cap in cases:
        nll, lse = lmhead_ce.ce_fwd(hh, ww, ll, cap)
        want_nll, want_lse = ref.ce_fwd_ref(hh, ww, ll, cap)
        dh = lmhead_ce.ce_bwd(hh, ww, ll, want_lse, gg, cap)
        want_dh = ref.ce_bwd_ref(hh, ww, ll, want_lse, gg, cap)
        e_f = max(float(((nll - want_nll).abs() - 1e-5 * want_nll.abs()).max()),
                  float(((lse - want_lse).abs() - 1e-5 * want_lse.abs()).max()))
        bf16_h = hh.dtype == torch.bfloat16
        e_b = (bf16_out_check(dh, want_dh) if bf16_h
               else float(((dh - want_dh).abs() - 1e-4 * want_dh.abs()).max()))
        T, d, V = hh.shape[0], hh.shape[1], ww.shape[1]
        at = f"T={T} d={d} V={V} h {hh.dtype} W bf16 cap={cap}"
        check(f"ce_fwd {at}", e_f, 2e-5)
        check(f"ce_bwd {at}", e_b, BF16_OUT_ATOL if bf16_h else 1e-5)
        if dh.dtype != hh.dtype:
            raise AssertionError(f"ce_bwd {at}: dh {dh.dtype}, not h's dtype")
        e = {"ce_fwd": max(max_err(nll, want_nll), max_err(lse, want_lse)),
             "ce_bwd": max_err(dh, want_dh)}
        line = {"check": "lmhead_ce_bf16", "at": at, "ce_fwd_max_abs_err": e["ce_fwd"],
                "ce_bwd_max_abs_err": e["ce_bwd"], "ce_fwd_check": e_f, "ce_bwd_check": e_b,
                "tol": "ce_fwd atol 2e-5 + rtol 1e-5; ce_bwd atol 1e-5 + rtol 1e-4 (a bf16 dh: "
                       + BF16_OUT_TOL + ")", "tol_reason": reason,
                "w_in_place": lmhead_ce.w_in_place(V, ww.data_ptr())}
        line["route"] = lmhead_ce.route_of(hh, ww)  # the kernels each call launches
        emit(line)
        del want_dh
        if hh is timed_h:
            errs = {k: max(errs[k], e[k]) for k in errs}
            # two calls bit for bit (the chunks and the merge run in a fixed order)
            nll2, lse2 = lmhead_ce.ce_fwd(hh, ww, ll, cap)
            dh2 = lmhead_ce.ce_bwd(hh, ww, ll, want_lse, gg, cap)
            for name, equal in (("ce_fwd", torch.equal(nll, nll2) and torch.equal(lse, lse2)),
                                ("ce_bwd", torch.equal(dh, dh2))):
                emit({"check": f"{name}_deterministic", "dtype": "h f32, W bf16", "T": T,
                      "d": d, "V": V, "softcap": cap, "bit_equal": bool(equal)})
                if not equal:
                    raise AssertionError(f"{name} bf16 W cap={cap}: two calls differ")
    return errs


def bf16_ce_timed(timer: Timer, h, w, lab, g, cap, at: str, errs: dict,
                  arch: str = None) -> dict:
    """``ce_fwd`` and ``ce_bwd`` with the bf16 head ``w`` and the f32 ``h``
    at soft-cap ``cap``, timed beside their plain versions, the f32
    yardstick (``torch.matmul`` in f32 on W cast once, TF32 off: the
    reference's function) and the bf16-cast one (h rounded to bf16: one
    product, not the same function), with the bound of the kernels'
    products (h's three terms by W's one, in the forward and in each of
    the backward's two GEMMs). ``errs``: each one's max |Δ| from its
    checks. Emits the ``ce_fwd`` and ``ce_bwd`` lines (with ``arch`` where
    given); returns their rows."""
    from repro_torch.kernels import lmhead_ce, ref

    T, d = h.shape
    V = w.shape[1]
    _, lse = ref.ce_fwd_ref(h, w, lab, cap)
    hb, wf = h.to(torch.bfloat16), w.float()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 yardstick in f32 ("highest")

    def softcapped(x):
        return x if cap is None else cap * torch.tanh(x / cap)

    fwd_bytes = 4.0 * T * d + 2.0 * d * V + 12.0 * T
    b_ms, b_by = bound(fwd_bytes, 3 * 2.0 * T * d * V, flop_per_s=BF16_FLOP_PER_S)
    f32_ms, _ = bound(fwd_bytes, 2.0 * T * d * V)
    loop, routes = "wgmma loop (TMA ring, producer warpgroup, wgmma consumers)", \
        lmhead_ce.route_of(h, w)
    route = f"{loop}: {', '.join(routes['ce_fwd'])}"
    head = {"check": "ce_fwd", "dtype": "h f32, W bf16"}
    if arch is not None:
        head["arch"] = arch
    r = {**head, "T": T, "d": d, "V": V, "softcap": cap,
         "max_abs_err": errs["ce_fwd"], "route": route,
         "ms": timer(lambda: lmhead_ce.ce_fwd(h, w, lab, cap), calls=2, repeats=3),
         "plain_ms": timer(lambda: ref.ce_fwd_ref(h, w, lab, cap), calls=2, repeats=3),
         "library_ms": timer(lambda: torch.logsumexp(softcapped(torch.matmul(h, wf)), dim=-1),
                             calls=2, repeats=3),
         "library": "torch.matmul in f32 (TF32 off, precision highest; W cast to f32 once "
                    "beforehand)" + (", the soft-cap" if cap else "") + ", then "
                    "torch.logsumexp: the reference's function",
         "library_bf16_cast_ms": timer(lambda: torch.logsumexp(softcapped(torch.matmul(hb, w)),
                                                               dim=-1), calls=2, repeats=3),
         "library_bf16_cast": "torch.matmul on bf16 with h rounded to bf16 beforehand, then "
                              "torch.logsumexp: one product, not the same function",
         "bound_ms": b_ms, "bound_by": b_by, "bound_f32_ms": f32_ms}
    emit(r)
    rows = {"ce_fwd": dict(_row(r, f"LM-head CE forward, {at}"), route=route)}
    hr, hr32 = hb.clone().requires_grad_(), h.clone().requires_grad_()

    def library_bwd(x, w_):
        loss = torch.nn.functional.cross_entropy(softcapped(torch.matmul(x, w_)), lab.long(),
                                                 reduction="sum")
        return torch.autograd.grad(loss, x)

    bwd_bytes = 8.0 * T * d + 2.0 * d * V + 16.0 * T
    b_ms, b_by = bound(bwd_bytes, 6 * 2.0 * T * d * V, flop_per_s=BF16_FLOP_PER_S)
    f32_ms, _ = bound(bwd_bytes, 4.0 * T * d * V)
    route = f"{loop}: {', '.join(routes['ce_bwd'])}"
    r = {**head, "check": "ce_bwd", "T": T, "d": d, "V": V, "softcap": cap,
         "max_abs_err": errs["ce_bwd"], "route": route,
         "ms": timer(lambda: lmhead_ce.ce_bwd(h, w, lab, lse, g, cap), calls=2, repeats=3),
         "plain_ms": timer(lambda: ref.ce_bwd_ref(h, w, lab, lse, g, cap), calls=2, repeats=3),
         "library_ms": timer(lambda: library_bwd(hr32, wf), calls=2, repeats=3),
         "library": "autograd of F.cross_entropy(" + ("softcap(h @ W)" if cap else "h @ W")
                    + ") in f32 (TF32 off; W cast to f32 once beforehand; its forward "
                      "included): the reference's function",
         "library_bf16_cast_ms": timer(lambda: library_bwd(hr, w), calls=2, repeats=3),
         "library_bf16_cast": "the same on bf16 with h rounded to bf16 beforehand: one "
                              "product, not the same function",
         "bound_ms": b_ms, "bound_by": b_by, "bound_f32_ms": f32_ms}
    torch.backends.cuda.matmul.allow_tf32 = tf32
    emit(r)
    rows["ce_bwd"] = dict(_row(r, f"LM-head CE backward (logits recomputed), {at}"), route=route)
    return rows


def bf16_serving_shape(arch: str) -> tuple:
    """A bf16 serving cell's pages, max_len, batch and adapter rank: the
    config's own serving cell's."""
    if arch == GEMMA2:
        return 16, GEMMA2_MAX_LEN, 8, 8
    return SERVING_PAGE, SERVING_MAX_LEN, SERVING_BATCH, SERVING_R


def serving_waves(prompts: list, users: dict) -> list:
    """The cuda-vs-ref gate's waves over a serving cell's prompts, as the
    engine admits them: the first eight together (padded to their
    bucket), each later one alone at its own length (gemma2-2b's long
    prompt); each (label, prompts, adapter rows, padded length), the
    users taken in turn."""
    from repro_torch.core.parallel_adapters import gather_adapters, stack_adapters

    names = list(users)
    bank = stack_adapters([users[u] for u in names])
    waves = [("8 requests", prompts[:8], list(range(min(8, len(prompts)))),
              _bucket(max(map(len, prompts[:8])), 1 << 30))]
    waves += [(f"{len(p)}-token prompt", [p], [i], len(p))
              for i, p in enumerate(prompts[8:], start=8)]
    return [(label, wave, gather_adapters(bank, torch.tensor(rows, device=DEV) % len(names)),
             s_pad) for label, wave, rows, s_pad in waves]


def bf16_serving_phase(gen: torch.Generator, keep: dict, arch: str = SERVING_ARCH,
                       phase: str = "bf16_serving"):
    """The reference's bf16 backbone (each leaf drawn in f32 and cast, as
    it casts its f32 draw) at ``arch``'s full width and depth, served to
    its INT8 cell's users and prompts (``keep``): ``BF16_NEW_TOKENS`` new
    tokens a request through ``ServeEngine`` over int8 pages (launches
    counted: flash ``n_layers`` a prefill wave, paged attention with a
    bf16 q ``n_layers`` a decode step; no weight is quantized, so
    ``quant_matmul`` never runs), then each wave's prefill and two decode
    steps under ``cuda`` and ``ref`` over int8, bf16 and f32 pages
    (:func:`serving_waves`, :func:`paged_cuda_vs_ref`,
    :func:`bf16_logits_gate`). Returns (launches, the backbone)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.quantization import tree_storage_bytes
    from repro_torch.models.backbone import init_backbone

    cfg = get_arch(arch)
    page, max_len, max_batch, r = bf16_serving_shape(arch)
    users, prompts = keep["users"], keep["prompts"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    backbone = init_backbone(gen, cfg, device=DEV, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    emit({"phase": "serving_init", "arch": cfg.name, "dtype": "bfloat16",
          "backbone_bytes": tree_storage_bytes(backbone), "seconds": time.perf_counter() - t0})
    serve_streams(backbone, cfg, users, prompts[:max_batch], "cuda", 2, page, max_len,
                  max_batch, r)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sched = {}
    eng, streams, wall = serve_streams(backbone, cfg, users, prompts, "cuda", BF16_NEW_TOKENS,
                                       page, max_len, max_batch, r, schedule=sched)
    launches = {k: v for k, v in read_launches().items()
                if k in ("quant_matmul", "flash_attention", "paged_attention")}
    peak = torch.cuda.max_memory_allocated()
    gates = {}
    for policy in ("int8", "bf16", "f32"):
        for label, wave, rows, s_pad in serving_waves(prompts, users):
            logits = paged_cuda_vs_ref(backbone, cfg, rows, wave, page, max_len, r, s_pad,
                                       kv_policy=policy)
            gates.setdefault(policy, {})[label] = {
                "steps": ["prefill", "decode1", "decode2"],
                **bf16_logits_gate(logits["cuda"], logits["ref"],
                                   f"{phase} ({label}) over {policy} pages", arch=arch)}
            del logits
    waves = len(sched["waves"])
    emit({"phase": phase, "arch": cfg.name, "dtype": "bfloat16", "kv": "int8",
          "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
          "new_tokens": BF16_NEW_TOKENS, "page": page, "max_len": max_len,
          "prefill_waves": waves, "prefill_ms": eng.prefill_seconds * 1e3,
          "decode_steps": eng.decode_steps,
          "decode_ms_per_step": eng.decode_seconds * 1e3 / eng.decode_steps,
          "decode_tokens_per_s": eng.decode_tokens / eng.decode_seconds, "wall_s": wall,
          "max_memory_allocated": peak, "launches": launches,
          "launches_per_wave_and_step": {
              "flash_attention": launches["flash_attention"] / waves,
              "paged_attention": launches["paged_attention"] / eng.decode_steps},
          "token_agreement_int8_backbone": [
              float(np.mean([a == b for a, b in zip(s_, t[:BF16_NEW_TOKENS])]))
              for s_, t in zip(streams, keep["streams"])],
          "cuda_vs_ref": gates, "seconds": time.perf_counter() - t0})
    if (launches["quant_matmul"] != 0
            or launches["flash_attention"] != cfg.n_layers * waves
            or launches["paged_attention"] != cfg.n_layers * eng.decode_steps):
        raise AssertionError(f"{phase} launches: {launches}, {waves} prefill waves, "
                             f"{eng.decode_steps} decode steps")
    return launches, backbone


def bf16_training_phase(backbone, cfg, gen: torch.Generator, r: int = 8,
                        phase: str = "bf16_training"):
    """PAC+ on the bf16 backbone through the step entry points: from one
    adapter, ``BF16_STEPS`` epoch-1 steps (``pac_train_step``, B = 4, S =
    512: flash bf16 in the frozen forward, ``n_layers`` launches a step,
    the bf16 taps through ``mix_fwd``/``mix_dw``, the bf16 head, tied or
    not, through ``ce_fwd``/``ce_bwd``, once each a step), then as many
    cached steps on the first step's activations, under ``cuda`` (launches
    counted) and ``ref``: the losses within ``BF16_TOL``, the taps within
    ``BF16_FORM_FACTOR`` times the port's own move, the cached steps fed
    the same bf16 entries. Returns (launches, the ``cuda`` run's
    adapter)."""
    from repro_torch.core.parallel_adapters import init_adapter
    from repro_torch.core.steps import pac_cached_train_step, pac_train_step
    from repro_torch.models.backbone import loss_head
    from repro_torch.optim import adamw_init

    t0 = time.perf_counter()
    if loss_head(backbone, cfg).dtype != torch.bfloat16:
        raise AssertionError("the bf16 head was copied to another dtype")
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, size=(4, 512)).astype(np.int32))
             .to(DEV) for k in ("tokens", "labels")}
    adapter0 = init_adapter(gen, cfg, r=r, device=DEV)
    runs, cached = {}, None
    for impl in ("cuda", "ref"):
        adapter, opt = adapter0, adamw_init(adapter0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if impl == "cuda":
            reset_launches()
        losses, walls, acts = [], [], None
        for _ in range(BF16_STEPS):
            t = time.perf_counter()
            loss, adapter, opt, out = pac_train_step(backbone, adapter, opt, batch, cfg=cfg, r=r,
                                                     kernel_impl=impl)
            losses.append(float(loss))
            walls.append(time.perf_counter() - t)
            acts = out if acts is None else acts
        if cached is None:  # the cuda run's first activations feed both cached runs
            cached = {"b0": acts[0], "taps": acts[1], "b_final": acts[2],
                      "labels": batch["labels"]}
        for _ in range(BF16_STEPS):
            t = time.perf_counter()
            loss, adapter, opt = pac_cached_train_step(backbone, adapter, opt, cached, cfg=cfg,
                                                       r=r, kernel_impl=impl)
            losses.append(float(loss))
            walls.append(time.perf_counter() - t)
        runs[impl] = {"losses": losses, "step_s": walls, "taps": acts[1],
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "adapter": adapter}
        if impl == "cuda":
            launches = {k: v for k, v in read_launches().items() if k in TRAINING_KERNELS}
    dloss = [abs(a - b) for a, b in zip(runs["cuda"]["losses"], runs["ref"]["losses"])]
    dtaps = max_err(runs["cuda"]["taps"], runs["ref"]["taps"])
    tap_mag = max(float(runs["ref"]["taps"].float().abs().max()), 1.0)
    taps_tol = BF16_FORM_FACTOR * BF16_OWN_MOVE[cfg.name]["taps"]
    emit({"phase": phase, "arch": cfg.name, "dtype": "bfloat16", "batch": 4, "seq": 512,
          "epoch1_steps": BF16_STEPS, "cached_steps": BF16_STEPS,
          "taps_dtype": str(runs["cuda"]["taps"].dtype).replace("torch.", ""),
          **{f"{k}_{impl}": runs[impl][k] for impl in runs
             for k in ("losses", "step_s", "max_memory_allocated")},
          "abs_dloss": dloss, "max_abs_dtaps": dtaps, "taps_scale": tap_mag,
          "launches": launches, "launches_per_step": {  # flash runs in epoch 1 only
              k: v / (BF16_STEPS if k == "flash_attention" else 2 * BF16_STEPS)
              for k, v in launches.items()},
          "tol": {"loss": BF16_TOL, "taps": taps_tol},
          "tol_reason": BF16_TOL_REASON + "; taps within BF16_FORM_FACTOR times the port's own "
                                          "move (BF16_OWN_MOVE)",
          "seconds": time.perf_counter() - t0})
    finite = all(np.isfinite(runs[i]["losses"]).all() for i in runs)
    if not (finite and max(dloss) <= BF16_TOL and dtaps <= taps_tol):
        raise AssertionError(f"{phase} cuda vs ref: dloss {dloss}, dtaps {dtaps}")
    if runs["cuda"]["taps"].dtype != torch.bfloat16:
        raise AssertionError(f"bf16 taps left as {runs['cuda']['taps'].dtype}")
    if (launches["quant_matmul"] != 0 or launches["flash_attention"] != BF16_STEPS * cfg.n_layers
            or min(launches["mix_fwd"], launches["mix_dw"]) <= 0
            or not launches["ce_fwd"] == launches["ce_bwd"] == 2 * BF16_STEPS):
        raise AssertionError(f"{phase} launches: {launches}")
    return launches, runs["cuda"]["adapter"]


def bf16_personal_phase(backbone, adapter, cfg, r: int = 8,
                        phase: str = "bf16_personal") -> dict:
    """The trained adapter served to one user on the bf16 backbone: the
    prompt's prefill (``prefill_step``, flash bf16) under ``cuda`` and
    ``ref``, then ``BF16_PERSONAL_STEPS`` ``pac_decode_step``s at B = 1 over
    the linear f32 KV cache (``BF16_PERSONAL_PROMPT`` teacher-forced, then
    the ``cuda`` run's greedy tokens, fed to ``ref`` too), the λ-mix through
    ``adapter_fuse`` on the bf16 taps with an f32 output: each step's
    logits within 2e-4 (the ``personal_gap``), greedy tokens equal; the
    prompt's last logits by :func:`bf16_logits_gate`."""
    from repro_torch.core.parallel_adapters import init_adapter_cache
    from repro_torch.core.steps import pac_decode_step, prefill_step
    from repro_torch.models.backbone import init_cache

    t0 = time.perf_counter()
    n_prompt, n_steps, max_len = BF16_PERSONAL_PROMPT, BF16_PERSONAL_STEPS, 16
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, size=(1, PROMPT_LEN)).astype(np.int32)).to(DEV)
    reset_launches()
    pre = {impl: prefill_step(backbone, {"tokens": prompt}, cfg=cfg, kernel_impl=impl)
           for impl in ("cuda", "ref")}
    prefill_launches = read_launches()["flash_attention"]

    def serve(impl, feed=None):
        cache = init_cache(cfg, 1, max_len, device=DEV)
        acache = init_adapter_cache(cfg, 1, max_len, r, device=DEV)
        logits, fed, tok = [], [], prompt[:, :1]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for p in range(n_steps):
            lg, cache, acache = pac_decode_step(
                backbone, adapter, {"tokens": tok}, cache, acache,
                torch.full((1,), p, dtype=torch.long, device=DEV), cfg=cfg, r=r,
                kernel_impl=impl)
            logits.append(lg[:, 0])
            tok = (prompt[:, p + 1:p + 2] if p + 1 < n_prompt else feed[p + 1]
                   if feed is not None else lg[:, 0].argmax(-1, keepdim=True).int())
            fed.append(tok)
        torch.cuda.synchronize()
        return logits, [prompt[:, :1]] + fed, time.perf_counter() - t

    serve("cuda")  # warm-up
    reset_launches()
    cuda = serve("cuda")
    ref_run = serve("ref", feed=cuda[1])
    launches = {k: v for k, v in read_launches().items()
                if k in ("quant_matmul", "flash_attention", "adapter_fuse")}
    gap = [max_err(a, b) for a, b in zip(cuda[0], ref_run[0])]
    tokens_equal = [bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                    for a, b in zip(cuda[0][n_prompt - 1:], ref_run[0][n_prompt - 1:])]
    finite = all(bool(torch.isfinite(t).all()) for t in cuda[0] + ref_run[0])
    gate = {"personal_gap_per_step": gap, "greedy_equal": tokens_equal, "tol": 2e-4,
            "tol_reason": "the reference's decode-parity ceiling over f32 KV "
                          "(tests/test_decode_parity.py:36), as every personal_gap"}
    if not (finite and max(gap) <= 2e-4 and all(tokens_equal)):
        raise AssertionError(f"{phase} cuda vs ref: gap {gap}, greedy equal "
                             f"{tokens_equal}, finite {finite}")
    pre_gate = bf16_logits_gate([pre["cuda"][:, -1]], [pre["ref"][:, -1]],
                                f"{phase} prefill", "personal_prefill", cfg.name)
    emit({"phase": phase, "arch": cfg.name, "dtype": "bfloat16", "batch": 1, "kv": "f32",
          "steps": n_steps, "prompt_tokens": n_prompt, "prefill_tokens": PROMPT_LEN,
          "prefill_last_token": pre_gate, "prefill_flash_launches": prefill_launches,
          "decode_ms_per_step": cuda[2] * 1e3 / n_steps,
          "ref_decode_ms_per_step": ref_run[2] * 1e3 / n_steps,
          "launches": launches,
          "launches_per_step": {k: v / n_steps for k, v in launches.items()},
          "tokens_cuda": [int(t) for t in torch.cat(cuda[1][n_prompt:-1])],
          "cuda_vs_ref": gate, "seconds": time.perf_counter() - t0})
    if (launches["adapter_fuse"] != n_steps * cfg.n_periods or launches["quant_matmul"] != 0
            or prefill_launches != cfg.n_layers):
        raise AssertionError(f"{phase} launches: {launches}, prefill flash "
                             f"{prefill_launches}")
    return {**launches, "flash_attention": prefill_launches}


def serving_prompts(cfg, long_prompt: int = None, rng: np.random.Generator = None) -> list:
    """A serving cell's seeded prompts: 8 of 64-480 tokens, then one of
    ``long_prompt`` tokens where given (gemma2-2b's, past its window),
    drawn from ``rng`` (a fresh one seeded ``SEED`` by default)."""
    rng = np.random.default_rng(SEED) if rng is None else rng
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(64, 481, size=8)]
    if long_prompt:
        prompts.append(rng.integers(0, cfg.vocab, size=long_prompt).tolist())
    return prompts


def bf16_own_move(arch: str = SERVING_ARCH) -> dict:
    """The yardstick of the bf16 gates (``python3 chip_smoke.py
    --bf16-own-move [--arch ...]``): the port's own move on ``arch``'s bf16
    backbone at full width and depth, the ``ref`` OpSet on the card against
    the same program on the host's CPU on the same weights and inputs, so
    that only the order of the f32 sums under each bf16 rounding differs.
    Measured at the bf16 phases' shapes: the serving cell's waves'
    (:func:`serving_waves`: its 8 prompts, and gemma2-2b's 4500-token
    prompt on int8 pages only, for the host's time) prefill and two decode
    steps over int8, bf16 and f32 pages (the card's greedy tokens fed to
    both; per row the two runs' greedy tokens and the card's top-2
    margin), one epoch-1 step of 4 x 512 (the loss and the bf16 taps) and
    the personal prompt's prefill; ``cuda`` on the card beside each,
    against the card's ``ref``. Prints one line, returns it."""
    from repro_torch.configs import get_arch
    from repro_torch.core.parallel_adapters import init_adapter
    from repro_torch.core.quantization import tree_map
    from repro_torch.core.steps import pac_train_step, prefill_step
    from repro_torch.models.backbone import init_backbone
    from repro_torch.optim import adamw_init

    t0 = time.perf_counter()
    cfg = get_arch(arch)
    page, max_len, _, r = bf16_serving_shape(arch)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    backbone = init_backbone(gen, cfg, device=DEV, dtype=torch.bfloat16)
    users = {f"user{u}": init_adapter(gen, cfg, r=r, device=DEV) for u in range(4)}
    adapter0 = init_adapter(gen, cfg, r=8, device=DEV)
    rng = np.random.default_rng(SEED)
    prompts = serving_prompts(cfg, GEMMA2_LONG_PROMPT if arch == GEMMA2 else None, rng)

    def host(tree):
        return tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, tree)

    on = {"card": (backbone, DEV), "cpu": (host(backbone), "cpu")}
    line = {"phase": "bf16_own_move", "arch": cfg.name, "dtype": "bfloat16",
            "cpu_threads": torch.get_num_threads(), "serving": {}}
    for policy in ("int8", "bf16", "f32"):
        for label, wave, rows, s_pad in serving_waves(prompts, users):
            if policy != "int8" and len(wave) == 1:
                continue  # the long prompt on the host's CPU once
            lg = paged_cuda_vs_ref(backbone, cfg, rows, wave, page, max_len, r, s_pad,
                                   kv_policy=policy, runs={
                                       "card": ("ref", backbone, rows, DEV),
                                       "cpu": ("ref", on["cpu"][0], host(rows), "cpu"),
                                       "cuda": ("cuda", backbone, rows, DEV)})
            card = [t.float().cpu() for t in lg["card"]]
            cpu = [t.float() for t in lg["cpu"]]
            cuda = [t.float().cpu() for t in lg["cuda"]]
            top2 = [t.topk(2, dim=-1).values for t in card]
            fig = {
                "steps": ["prefill", "decode1", "decode2"],
                "card_vs_cpu": [max_err(a, b) for a, b in zip(card, cpu)],
                "cuda_vs_card": [max_err(a, b) for a, b in zip(cuda, card)],
                "greedy_equal_card_cpu": [(a.argmax(-1) == b.argmax(-1)).tolist()
                                          for a, b in zip(card, cpu)],
                "greedy_equal_cuda_card": [(a.argmax(-1) == b.argmax(-1)).tolist()
                                           for a, b in zip(cuda, card)],
                "card_top2_margin": [(t[:, 0] - t[:, 1]).tolist() for t in top2],
                "logit_scale": max(float(t.abs().max()) for t in card)}
            line["serving"].setdefault(policy, {})[label] = fig
            emit({"bf16_own_move_serving": policy, "arch": cfg.name, "wave": label, **fig})
            del lg
    line["serving_max"] = max(max(f["card_vs_cpu"]) for waves in line["serving"].values()
                              for f in waves.values())
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, size=(4, 512)).astype(np.int32))
             for k in ("tokens", "labels")}
    train = {}
    for name, impl, (bb, dev) in (("card", "ref", on["card"]), ("cpu", "ref", on["cpu"]),
                                  ("cuda", "cuda", on["card"])):
        ad = tree_map(lambda t, dev=dev: t.to(dev), adapter0)
        loss, _, _, out = pac_train_step(bb, ad, adamw_init(ad),
                                         {k: v.to(dev) for k, v in batch.items()}, cfg=cfg, r=8,
                                         kernel_impl=impl)
        train[name] = (float(loss), out[1].float().cpu())
        del out
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, size=(1, PROMPT_LEN)).astype(np.int32))
    pre = {name: prefill_step(on[dev_of][0], {"tokens": prompt.to(on[dev_of][1])}, cfg=cfg,
                              kernel_impl=impl)[:, -1].float().cpu()
           for name, impl, dev_of in (("card", "ref", "card"), ("cpu", "ref", "cpu"),
                                      ("cuda", "cuda", "card"))}
    line.update({
        "training": {"batch": 4, "seq": 512, "losses": {k: v[0] for k, v in train.items()},
                     "card_vs_cpu_loss": abs(train["card"][0] - train["cpu"][0]),
                     "cuda_vs_card_loss": abs(train["cuda"][0] - train["card"][0]),
                     "card_vs_cpu_taps": max_err(train["card"][1], train["cpu"][1]),
                     "cuda_vs_card_taps": max_err(train["cuda"][1], train["card"][1]),
                     "taps_scale": float(train["card"][1].abs().max())},
        "personal_prefill": {"tokens": PROMPT_LEN,
                             "card_vs_cpu": max_err(pre["card"], pre["cpu"]),
                             "cuda_vs_card": max_err(pre["cuda"], pre["card"])},
        "seconds": time.perf_counter() - t0})
    emit({k: v for k, v in line.items() if k != "serving"})
    return line


# ---------------------------------------------------------------- training kernels

TRAIN_T, TRAIN_D, TRAIN_DA, TRAIN_V = 4 * 512, 2048, 256, 92544  # internlm2-1.8b, r=8, B=4, S=512


def mix_fwd_check(out, bw, want_out, want_bw) -> float:
    """max(|Δ| − rtol·|want|) over ``out`` and ``bw``, rtol 1e-4; a bf16
    ``out`` adds one bf16 step (2^-7 relative): two f32 results inside the
    tolerance may round to neighbouring bf16 values."""
    rtol = 1e-4 + (2.0 ** -7 if out.dtype == torch.bfloat16 else 0.0)
    got, want = out.float(), want_out.float()
    return max(float(((got - want).abs() - rtol * want.abs()).max()),
               float(((bw - want_bw).abs() - 1e-4 * want_bw.abs()).max()))


def _row(r, at):
    out = {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    out["at"] = at
    return out


def training_kernel_phase(timer: Timer, gen: torch.Generator):
    """Flash attention at the epoch-1 step's shape, timed; the four
    training kernels against their plain versions at the training path's
    shapes, their timings, and the gradients of the two autograd Functions
    against autograd of the plain versions."""
    from repro_torch.core.quantization import dequantize, quantize
    from repro_torch.kernels import cached_mix, lmhead_ce, ref
    from repro_torch.kernels.cached_step import dq_adapter_mix
    from repro_torch.kernels.cached_step import lmhead_ce as lmhead_ce_op

    dev = "cuda"
    rows = {}

    # ---- flash attention at the epoch-1 step's shape: B·H = 4·16, S = 512
    emit(flash_case(timer, gen, 4, 16, 8, 512, 128, "training")[0])

    # ---- mix_fwd / mix_dw: f32, bf16, int8 entries at (T, d, d_a), and a ragged case
    mix_reason = ("the reference's dq_adapter_mix tolerances (tests/test_cached_step.py:55, "
                  ":84); f32 sums over d or T reorder")
    worst = {"mix_fwd": 0.0, "mix_dw": 0.0}
    for T, d, da in ((TRAIN_T, TRAIN_D, TRAIN_DA), (1000, 1000, 200)):
        b = torch.randn(T, d, generator=gen, device=dev)
        w = torch.randn(d, da, generator=gen, device=dev) * d ** -0.5
        a = torch.randn(T, da, generator=gen, device=dev)
        g = torch.randn(T, da, generator=gen, device=dev)
        lam = torch.tensor(0.7, device=dev)
        for storage, ent in (("f32", b), ("bf16", b.bfloat16()), ("int8", quantize(b, 8, 128))):
            out, bw = cached_mix.mix_fwd(ent, w, a, lam)
            want_out, want_bw = ref.mix_fwd_ref(ent, w, a, lam)
            dw, want_dw = cached_mix.mix_dw(ent, g, lam, d), ref.mix_dw_ref(ent, g, lam, d)
            e_fwd = mix_fwd_check(out, bw, want_out, want_bw)
            e_dw = float(((dw - want_dw).abs() - 1e-3 * want_dw.abs()).max())
            check(f"mix_fwd {storage} T={T} d={d} da={da}", e_fwd, 1e-4)
            check(f"mix_dw {storage} T={T} d={d} da={da}", e_dw, 2e-4)
            err_f, err_d = max(max_err(out, want_out), max_err(bw, want_bw)), max_err(dw, want_dw)
            worst["mix_fwd"] = max(worst["mix_fwd"], err_f)
            worst["mix_dw"] = max(worst["mix_dw"], err_d)
            emit({"check": "cached_mix", "storage": storage, "T": T, "d": d, "da": da,
                  "mix_fwd_max_abs_err": err_f, "mix_dw_max_abs_err": err_d,
                  "mix_fwd_check": e_fwd, "mix_dw_check": e_dw,
                  "tol": "mix_fwd atol 1e-4 + rtol 1e-4; mix_dw atol 2e-4 + rtol 1e-3",
                  "tol_reason": mix_reason})
            if (T, d, da) == (TRAIN_T, TRAIN_D, TRAIN_DA):  # a second call, bit for bit
                out2, bw2 = cached_mix.mix_fwd(ent, w, a, lam)
                equal = bool(torch.equal(out, out2) and torch.equal(bw, bw2))
                emit({"check": "mix_fwd_deterministic", "storage": storage, "T": T, "d": d,
                      "da": da, "bit_equal": equal})
                if not equal:
                    raise AssertionError(f"mix_fwd {storage}: two calls differ")
                equal = bool(torch.equal(dw, cached_mix.mix_dw(ent, g, lam, d)))
                emit({"check": "mix_dw_deterministic", "storage": storage, "T": T, "d": d,
                      "da": da, "bit_equal": equal})
                if not equal:
                    raise AssertionError(f"mix_dw {storage}: two calls differ")
    # both kernels on every masked edge (T, d, d_a off the tiles, ld > d)
    # and, with qblock 32, on int8 entries whose scale changes inside a
    # tile; mix_fwd with f32 and bf16 a. T=37, d=130, d_a=17 adds rows whose
    # width is not a multiple of 8 (element-wise loads) and qblock 24, which
    # mix_fwd dequantizes as it stages (a k16 step would straddle blocks)
    for T, d, da, qblock in ((1001, 1000, 100, 32), (37, 130, 17, 24)):
        b = torch.randn(T, d, generator=gen, device=dev)
        w = torch.randn(d, da, generator=gen, device=dev) * d ** -0.5
        a = torch.randn(T, da, generator=gen, device=dev)
        g = torch.randn(T, da, generator=gen, device=dev)
        lam = torch.tensor(0.7, device=dev)
        for storage, ent in (("f32", b), ("bf16", b.bfloat16()), ("int8", quantize(b, 8, qblock))):
            for a_ in (a, a.bfloat16()):
                out, bw = cached_mix.mix_fwd(ent, w, a_, lam)
                want_out, want_bw = ref.mix_fwd_ref(ent, w, a_, lam)
                if out.dtype != a_.dtype or bw.dtype != torch.float32:
                    raise AssertionError(f"mix_fwd gave out {out.dtype}, bw {bw.dtype}")
                e_fwd = mix_fwd_check(out, bw, want_out, want_bw)
                check(f"mix_fwd {storage} T={T} d={d} da={da} qblock={qblock} a={a_.dtype}", e_fwd,
                      1e-4)
                err_f = max(max_err(out, want_out), max_err(bw, want_bw))
                # a bf16 out's one-step rounding flips are not the kernel's error
                worst["mix_fwd"] = max(worst["mix_fwd"], err_f if out.dtype == torch.float32
                                       else max_err(bw, want_bw))
                emit({"check": "mix_fwd_ragged", "storage": storage, "T": T, "d": d, "da": da,
                      "qblock": qblock if storage == "int8" else None,
                      "ld": ent.q.shape[1] if storage == "int8" else d, "a": str(a_.dtype),
                      "mix_fwd_max_abs_err": err_f, "mix_fwd_check": e_fwd,
                      "tol": "out and bw atol 1e-4 + rtol 1e-4 (bf16 out: + 2^-7 relative, one "
                             "bf16 step)", "tol_reason": mix_reason})
            dw, want_dw = cached_mix.mix_dw(ent, g, lam, d), ref.mix_dw_ref(ent, g, lam, d)
            e_dw = float(((dw - want_dw).abs() - 1e-3 * want_dw.abs()).max())
            check(f"mix_dw {storage} T={T} d={d} da={da} qblock={qblock}", e_dw, 2e-4)
            worst["mix_dw"] = max(worst["mix_dw"], max_err(dw, want_dw))
            emit({"check": "mix_dw_ragged", "storage": storage, "T": T, "d": d, "da": da,
                  "qblock": qblock if storage == "int8" else None,
                  "mix_dw_max_abs_err": max_err(dw, want_dw), "mix_dw_check": e_dw,
                  "tol": "atol 2e-4 + rtol 1e-3", "tol_reason": mix_reason})
    # timings at the training path's storage (int8 taps), T = 2048, d = 2048, d_a = 256
    T, d, da = TRAIN_T, TRAIN_D, TRAIN_DA
    ents = [quantize(torch.randn(T, d, generator=gen, device=dev), 8, 128)
            for _ in range(copies(T * d))]
    w = torch.randn(d, da, generator=gen, device=dev) * d ** -0.5
    a = torch.randn(T, da, generator=gen, device=dev)
    g = torch.randn(T, da, generator=gen, device=dev)
    lam = torch.tensor(0.7, device=dev)
    ent_bytes = T * d + T * (d // 128) * 4
    deq = [dequantize(e) for e in ents[:2]]
    # mix_fwd runs on the bf16 tensor cores, W_down split in three terms:
    # it is held to that work's bound, the f32 CUDA-core bound beside it
    fwd_bytes = ent_bytes + 4 * (d * da + 3 * T * da)
    b_ms, b_by = bound(fwd_bytes, 3 * 2.0 * T * d * da, flop_per_s=BF16_FLOP_PER_S)
    f32_ms, f32_by = bound(fwd_bytes, 2.0 * T * d * da)
    r = {"check": "mix_fwd", "storage": "int8", "T": T, "d": d, "da": da,
         "max_abs_err": worst["mix_fwd"],
         "ms": timer([lambda e=e: cached_mix.mix_fwd(e, w, a, lam) for e in ents]),
         "plain_ms": timer([lambda e=e: ref.mix_fwd_ref(e, w, a, lam) for e in ents]),
         "library_ms": timer([lambda e=e: torch.matmul(dequantize(e), w) for e in ents]),
         "library": "dequantize, then torch.matmul", "bound_ms": b_ms, "bound_by": b_by,
         "bound_tc_ms": b_ms, "bound_tc_by": b_by, "bound_f32_ms": f32_ms,
         "bound_f32_by": f32_by}
    emit(r)
    rows["mix_fwd"] = _row(r, "one period's mix, T=4*512, d=2048, d_a=256, int8 entry")
    # mix_dw runs on the bf16 tensor cores, g (scaled) split in three terms:
    # it is held to that work's bound, the f32 CUDA-core bound beside it
    dw_bytes = ent_bytes + 4 * (T * da + d * da)
    b_ms, b_by = bound(dw_bytes, 3 * 2.0 * T * d * da, flop_per_s=BF16_FLOP_PER_S)
    f32_ms, f32_by = bound(dw_bytes, 2.0 * T * d * da)
    r = {"check": "mix_dw", "storage": "int8", "T": T, "d": d, "da": da,
         "max_abs_err": worst["mix_dw"],
         "ms": timer([lambda e=e: cached_mix.mix_dw(e, g, lam, d) for e in ents]),
         "plain_ms": timer([lambda e=e: ref.mix_dw_ref(e, g, lam, d) for e in ents]),
         "library_ms": timer([lambda x=x: torch.matmul(x.T, g) for x in deq]),
         "library": "torch.matmul of the dequantized entry's transpose and g",
         "bound_ms": b_ms, "bound_by": b_by, "bound_tc_ms": b_ms, "bound_tc_by": b_by,
         "bound_f32_ms": f32_ms, "bound_f32_by": f32_by}
    emit(r)
    rows["mix_dw"] = _row(r, "one period's dW_down, T=4*512, d=2048, d_a=256, int8 entry")
    # gradients through MixFn against autograd of the plain version
    ent = ents[0]
    grads = {}
    for impl in ("cuda", "plain"):
        wr, ar, lr_ = (t.clone().requires_grad_() for t in (w, a, torch.tensor(0.3, device=dev)))
        if impl == "cuda":
            out = dq_adapter_mix(ent, wr, ar, lr_)
        else:
            out = ref.dq_adapter_mix_ref(ent, wr, ar, lr_, d)
        grads[impl] = torch.autograd.grad(torch.sin(out).sum(), (wr, ar, lr_))
    errs = [float(((x - y).abs() - 1e-3 * y.abs()).max()) for x, y in zip(*grads.values())]
    emit({"check": "MixFn_grad", "T": T, "d": d, "da": da, "storage": "int8",
          "max_abs_err": [max_err(x, y) for x, y in zip(*grads.values())],
          "grads": ["W_down", "a", "lambda"], "tol": "atol 2e-4 + rtol 1e-3",
          "tol_reason": "the reference's custom-VJP gradient tolerance (tests/test_cached_step.py:84)"})
    check("MixFn gradients", max(errs), 2e-4)
    del ents, deq, grads

    # ---- ce_fwd / ce_bwd at (T, d, V), with and without the soft-cap
    T, d, V = TRAIN_T, TRAIN_D, TRAIN_V
    h = torch.randn(T, d, generator=gen, device=dev)
    w = torch.randn(d, V, generator=gen, device=dev) * d ** -0.5
    lab = torch.randint(0, V, (T,), generator=gen, device=dev)
    g = torch.randn(T, generator=gen, device=dev)
    ce_errs = {"ce_fwd": 0.0, "ce_bwd": 0.0}
    ce_reason = ("the reference's blockwise-CE tolerances (tests/test_cached_step.py:105, "
                 ":113); f32 sums reorder")

    def ce_fwd_check(nll, lse, want_nll, want_lse) -> float:
        return max(float(((nll - want_nll).abs() - 1e-5 * want_nll.abs()).max()),
                   float(((lse - want_lse).abs() - 1e-5 * want_lse.abs()).max()))

    for cap in (None, 30.0):
        nll, lse = lmhead_ce.ce_fwd(h, w, lab, cap)
        want_nll, want_lse = ref.ce_fwd_ref(h, w, lab, cap)
        dh = lmhead_ce.ce_bwd(h, w, lab, want_lse, g, cap)
        want_dh = ref.ce_bwd_ref(h, w, lab, want_lse, g, cap)
        e_f = ce_fwd_check(nll, lse, want_nll, want_lse)
        e_b = float(((dh - want_dh).abs() - 1e-4 * want_dh.abs()).max())
        check(f"ce_fwd cap={cap}", e_f, 2e-5)
        check(f"ce_bwd cap={cap}", e_b, 1e-5)
        errs = {"ce_fwd": max(max_err(nll, want_nll), max_err(lse, want_lse)),
                "ce_bwd": max_err(dh, want_dh)}
        for k in ce_errs:
            ce_errs[k] = max(ce_errs[k], errs[k])
        emit({"check": "lmhead_ce", "T": T, "d": d, "V": V, "softcap": cap,
              "ce_fwd_max_abs_err": errs["ce_fwd"], "ce_bwd_max_abs_err": errs["ce_bwd"],
              "ce_fwd_check": e_f, "ce_bwd_check": e_b,
              "tol": "ce_fwd atol 2e-5 + rtol 1e-5; ce_bwd atol 1e-5 + rtol 1e-4",
              "tol_reason": ce_reason})
        equal = bool(torch.equal(dh, lmhead_ce.ce_bwd(h, w, lab, want_lse, g, cap)))
        emit({"check": "ce_bwd_deterministic", "T": T, "d": d, "V": V, "softcap": cap,
              "bit_equal": equal})
        if not equal:
            raise AssertionError(f"ce_bwd cap={cap}: two calls differ")
        del dh, want_dh
        nll2, lse2 = lmhead_ce.ce_fwd(h, w, lab, cap)  # a second call, bit for bit
        equal = bool(torch.equal(nll, nll2) and torch.equal(lse, lse2))
        emit({"check": "ce_fwd_deterministic", "T": T, "d": d, "V": V, "softcap": cap,
              "bit_equal": equal})
        if not equal:
            raise AssertionError(f"ce_fwd cap={cap}: two calls differ")
    # every masked edge: T, d and V off the tiles (V ends inside a vocab
    # tile and a W chunk), d not a multiple of 4 (element-wise split loads)
    for Tr, dr, Vr in ((1001, 1000, 3001), (37, 130, 517)):
        h2 = torch.randn(Tr, dr, generator=gen, device=dev)
        w2 = torch.randn(dr, Vr, generator=gen, device=dev) * dr ** -0.5
        lab2 = torch.randint(0, Vr, (Tr,), generator=gen, device=dev)
        g2 = torch.randn(Tr, generator=gen, device=dev)
        for cap in (None, 30.0):
            nll, lse = lmhead_ce.ce_fwd(h2, w2, lab2, cap)
            want_nll, want_lse = ref.ce_fwd_ref(h2, w2, lab2, cap)
            e_f = ce_fwd_check(nll, lse, want_nll, want_lse)
            check(f"ce_fwd T={Tr} d={dr} V={Vr} cap={cap}", e_f, 2e-5)
            err = max(max_err(nll, want_nll), max_err(lse, want_lse))
            ce_errs["ce_fwd"] = max(ce_errs["ce_fwd"], err)
            emit({"check": "ce_fwd_ragged", "T": Tr, "d": dr, "V": Vr, "softcap": cap,
                  "ce_fwd_max_abs_err": err, "ce_fwd_check": e_f,
                  "tol": "atol 2e-5 + rtol 1e-5", "tol_reason": ce_reason})
            dh = lmhead_ce.ce_bwd(h2, w2, lab2, want_lse, g2, cap)
            want_dh = ref.ce_bwd_ref(h2, w2, lab2, want_lse, g2, cap)
            e_b = float(((dh - want_dh).abs() - 1e-4 * want_dh.abs()).max())
            check(f"ce_bwd T={Tr} d={dr} V={Vr} cap={cap}", e_b, 1e-5)
            err = max_err(dh, want_dh)
            ce_errs["ce_bwd"] = max(ce_errs["ce_bwd"], err)
            emit({"check": "ce_bwd_ragged", "T": Tr, "d": dr, "V": Vr, "softcap": cap,
                  "ce_bwd_max_abs_err": err, "ce_bwd_check": e_b,
                  "tol": "atol 1e-5 + rtol 1e-4", "tol_reason": ce_reason})
    nll, lse = ref.ce_fwd_ref(h, w, lab)
    # ce_fwd runs on the bf16 tensor cores, h and W split in three terms (6
    # products): it is held to that work's bound, the f32 CUDA-core bound beside it
    fwd_bytes = 4.0 * (T * d + d * V + 3 * T)
    b_ms, b_by = bound(fwd_bytes, 6 * 2.0 * T * d * V, flop_per_s=BF16_FLOP_PER_S)
    f32_ms, f32_by = bound(fwd_bytes, 2.0 * T * d * V)
    r = {"check": "ce_fwd", "T": T, "d": d, "V": V, "max_abs_err": ce_errs["ce_fwd"],
         "ms": timer(lambda: lmhead_ce.ce_fwd(h, w, lab), calls=2, repeats=3),
         "plain_ms": timer(lambda: ref.ce_fwd_ref(h, w, lab), calls=2, repeats=3),
         "library_ms": timer(lambda: torch.logsumexp(torch.matmul(h, w), dim=-1), calls=2,
                             repeats=3),
         "library": "torch.matmul, then torch.logsumexp", "bound_ms": b_ms, "bound_by": b_by,
         "bound_tc_ms": b_ms, "bound_tc_by": b_by, "bound_f32_ms": f32_ms,
         "bound_f32_by": f32_by}
    emit(r)
    rows["ce_fwd"] = _row(r, "LM-head CE forward, T=4*512, d=2048, V=92544")
    hr = h.clone().requires_grad_()

    def library_bwd():
        loss = torch.nn.functional.cross_entropy(torch.matmul(hr, w), lab.long(),
                                                 reduction="sum")
        return torch.autograd.grad(loss, hr)

    # ce_bwd runs two GEMMs of the forward's size on the bf16 tensor cores
    # (the logits again, then dh), each 6 products of the 3-term split
    bwd_bytes = 4.0 * (2 * T * d + d * V + 4 * T)
    b_ms, b_by = bound(bwd_bytes, 12 * 2.0 * T * d * V, flop_per_s=BF16_FLOP_PER_S)
    f32_ms, f32_by = bound(bwd_bytes, 4.0 * T * d * V)
    r = {"check": "ce_bwd", "T": T, "d": d, "V": V, "max_abs_err": ce_errs["ce_bwd"],
         "ms": timer(lambda: lmhead_ce.ce_bwd(h, w, lab, lse, g), calls=2, repeats=3),
         "plain_ms": timer(lambda: ref.ce_bwd_ref(h, w, lab, lse, g), calls=2, repeats=3),
         "library_ms": timer(library_bwd, calls=2, repeats=3),
         "library": "autograd of F.cross_entropy(h @ W) (its forward included)",
         "bound_ms": b_ms, "bound_by": b_by, "bound_tc_ms": b_ms, "bound_tc_by": b_by,
         "bound_f32_ms": f32_ms, "bound_f32_by": f32_by}
    # the backward alone, on an autograd graph built once (no logits
    # recompute): a yardstick beside the library column, not in it.
    # Autograd runs it on the stream its forward ran on, not a CUDA
    # graph's capture stream, so it is timed without a graph
    loss = torch.nn.functional.cross_entropy(torch.matmul(hr, w), lab.long(), reduction="sum")
    r["library_bwd_only_ms"] = timer.eager(
        lambda: torch.autograd.grad(loss, hr, retain_graph=True), calls=2, repeats=3)
    r["library_bwd_only"] = ("torch.autograd.grad of F.cross_entropy(h @ W) on a graph built "
                             "once (retain_graph): the backward without a logits recompute")
    del loss
    emit(r)
    rows["ce_bwd"] = _row(r, "LM-head CE backward (logits recomputed), T=4*512, d=2048, V=92544")
    # gradients through CEFn against autograd of the plain version
    grads = []
    for fn in (lambda x: lmhead_ce_op(x, w, lab), lambda x: ref.lmhead_ce_ref(x, w, lab)):
        x = h.clone().requires_grad_()
        grads.append(torch.autograd.grad(torch.cos(fn(x)).sum(), x)[0])
    emit({"check": "CEFn_grad", "T": T, "d": d, "V": V, "max_abs_err": max_err(*grads),
          "tol": "atol 1e-5 + rtol 1e-4",
          "tol_reason": "the reference's dh tolerance (tests/test_cached_step.py:113)"})
    check("CEFn gradient", float(((grads[0] - grads[1]).abs() - 1e-4 * grads[1].abs()).max()),
          1e-5)
    return rows


# ---------------------------------------------------------------- training


def kernel_counters():
    """(module, key) of every kernel's launch count; key None where the
    module counts one kernel in a plain integer."""
    from repro_torch.kernels import (adapter_fuse, cached_mix, flash_attention, lmhead_ce,
                                     paged_attention, quant_matmul)

    return [(quant_matmul, None), (flash_attention, None), (paged_attention, None),
            (cached_mix, "mix_fwd"), (cached_mix, "mix_dw"), (lmhead_ce, "ce_fwd"),
            (lmhead_ce, "ce_bwd"), (adapter_fuse, None)]


def reset_launches() -> None:
    from repro_torch.kernels import quant_matmul

    for mod, key in kernel_counters():
        if key is None:
            mod.launches = 0
        else:
            mod.launches[key] = 0
    quant_matmul.branch_launches.clear()


def read_launches() -> dict:
    return {key or mod.__name__.rsplit(".", 1)[1]: (mod.launches if key is None
                                                    else mod.launches[key])
            for mod, key in kernel_counters()}


def cached_step_gate(s, spec) -> None:
    """Epoch 0's first batch, from the session's cache, through the cached
    step's loss under ``cuda`` and ``ref``: loss and gradients compared
    (``cached_step_cuda_vs_ref`` line)."""
    from repro_torch.core.quantization import tree_leaves, tree_map
    from repro_torch.kernels.cached_step import cached_loss_parts
    from repro_torch.models.backbone import arange_positions

    ids = s.pipe.epoch_order(0)[0]
    labels = torch.from_numpy(s.corpus.batch(ids)["labels"]).to(DEV)
    hit = s.cache.get_batch(ids, with_final=True, dtype=None, compressed=True)
    cached_b = {k: v.to(DEV) for k, v in zip(("b0", "taps", "b_final"), hit)}
    cached_b["labels"] = labels
    pos = arange_positions(s.cfg, spec.batch, spec.seq, DEV)  # (3, B, S) under mrope
    res = {}
    for impl in ("cuda", "ref"):
        ap = tree_map(lambda t: t.clone().requires_grad_(), s.adapter)
        num, den = cached_loss_parts(s.backbone, ap, s.cfg, cached_b, pos, spec.r, impl=impl)
        loss = num / den.clamp_min(1)
        res[impl] = (float(loss.detach()), torch.autograd.grad(loss, tree_leaves(ap)))
    gmax = max(float(g.abs().max()) for g in res["ref"][1])
    gerr = max(max_err(a, b) for a, b in zip(res["cuda"][1], res["ref"][1]))
    dloss = abs(res["cuda"][0] - res["ref"][0])
    loss_tol, grad_tol = 2e-5, 1e-4 * max(1.0, gmax)
    # an adapter with mLSTM blocks: its own f32 move under an equal
    # function (the ref step with the mLSTM chunk cut to a half and a
    # quarter), the rule of tests/test_torch_families.py's _ref_noise
    noise = {"loss": 0.0, "grads": 0.0}
    if any(sp.kind == "mlstm" for sp in s.cfg.pattern):
        for div in (2, 4):
            twin = dataclasses.replace(s.cfg, mlstm_chunk=s.cfg.mlstm_chunk // div)
            ap = tree_map(lambda t: t.clone().requires_grad_(), s.adapter)
            num, den = cached_loss_parts(s.backbone, ap, twin, cached_b, pos, spec.r, impl="ref")
            loss = num / den.clamp_min(1)
            grads = torch.autograd.grad(loss, tree_leaves(ap))
            noise["loss"] = max(noise["loss"], abs(float(loss.detach()) - res["ref"][0]))
            noise["grads"] = max(noise["grads"], max(max_err(a, b) for a, b in
                                                     zip(grads, res["ref"][1])))
        loss_tol, grad_tol = max(loss_tol, 8 * noise["loss"]), max(grad_tol, 8 * noise["grads"])
    emit({"phase": "cached_step_cuda_vs_ref", "arch": s.cfg.name,
          "loss": [res["cuda"][0], res["ref"][0]],
          "abs_dloss": dloss, "max_abs_dgrad": gerr, "grad_max": gmax,
          "ref_own_move": noise, "tol": {"loss": loss_tol, "grads": grad_tol},
          "tol_reason": "the reference's pallas-vs-ref cached-step tolerances "
                        "(tests/test_cached_step.py:163-190): f32 sums reorder; with mLSTM "
                        "blocks, 8 times the ref step's own move under a halved or quartered "
                        "mLSTM chunk where larger (tests/test_torch_families.py _ref_noise)"})
    if not (dloss <= loss_tol and gerr <= grad_tol):
        raise AssertionError(f"{s.cfg.name} cached step cuda vs ref: dloss {dloss}, "
                             f"dgrad {gerr}")


def trainer_gate(spec, cuda_losses: list, keep_backbone: bool = False, layout=None):
    """The same trainer under the ``ref`` kernels, in memory: per-epoch
    losses against the ``cuda`` run's (``trainer_cuda_vs_ref`` line, with
    its peak). Returns its session's backbone with ``keep_backbone`` (the
    same seeded draw as the ``cuda`` run's), else None. ``layout``: the
    ``cuda`` session's, where it was given one."""
    from repro_torch.runtime import EdgeSession, EpochReport, EpochRunner

    torch.cuda.reset_peak_memory_stats()
    s = EdgeSession(spec.replace(kernels="ref", ckpt=None, cache_dir=None), log=print,
                    device=DEV, layout=layout).open()
    events = list(EpochRunner(s).events())
    peak = torch.cuda.max_memory_allocated()
    s.close()
    backbone = s.backbone if keep_backbone else None
    del s
    ref_steps = [e for e in events if not isinstance(e, EpochReport)]
    ref_reports = [e for e in events if isinstance(e, EpochReport)]
    ref_losses = [r.mean_loss for r in ref_reports]
    tol = 5e-2
    diffs = [abs(a - b) for a, b in zip(cuda_losses, ref_losses)]
    emit({"phase": "trainer_cuda_vs_ref", "arch": spec.arch, "cuda_epoch_losses": cuda_losses,
          "ref_epoch_losses": ref_losses, "ref_modes": [r.mode for r in ref_reports],
          "ref_full_step_s": [e.wall_s for e in ref_steps if not e.cache_hit],
          "ref_cached_step_s": [e.wall_s for e in ref_steps if e.cache_hit],
          "abs_diff": diffs, "tol": tol, "max_memory_allocated": peak,
          "tol_reason": "the reference's int8 pallas-vs-ref trainer tolerance "
                        "(tests/test_cached_step.py:257): under cuda epoch 0 trains on taps "
                        "quantized at the tap site, under ref on f32 taps"})
    if len(diffs) != len(cuda_losses) or max(diffs) > tol:
        raise AssertionError(f"{spec.arch} trainer cuda vs ref epoch losses differ by {diffs}")
    PEAKS.setdefault(training_key(spec.arch, spec.quant), {})["ref_max_memory_allocated"] = peak
    return backbone


def profile_steps(s) -> None:
    """Where a step's time goes: one full step (the cache emptied first)
    and one cached step of epoch 0's first batch under the profiler
    (``train_profile`` lines)."""
    batch = s.corpus.batch(s.pipe.epoch_order(0)[0])
    s.cache.clear()
    for mode in ("full", "cached"):
        events = []
        prof = device_profile(lambda: events.append(s.step(dict(batch))),
                              watch=("mix_dw_mma", "dw_reduce", "mix_fwd_mma",
                                     "mix_fwd_reduce", "ce_split", "ce_fwd_mma", "ce_merge",
                                     "ce_grad_mma", "ce_dh_mma", "ce_fwd_wg", "ce_grad_wg",
                                     "ce_dh_wg", "flash_split",
                                     "flash_fwd_mma", "qmm_mma"))
        if events[0].mode != mode:
            raise AssertionError(f"profiled a {events[0].mode} step, wanted {mode}")
        emit({"phase": "train_profile", "arch": s.cfg.name, "step": mode, **prof})


def training_phase(workdir: Path, walls: dict):
    """PAC+ at full width through the port's EdgeSession/EpochRunner,
    with its checkpoint and persistent cache in ``workdir``. Returns
    (launches, the session's backbone, the checkpoint's path, the run's
    per-step and per-epoch losses and epoch 0's cache entries); ``walls``
    gets the epoch-1 and cached steps' walls for the roofline."""
    from repro_torch.runtime import (ConsoleHook, EdgeSession, EpochReport, EpochRunner,
                                     RunHooks, RunSpec)

    ckpt = workdir / "adapter.msgpack"
    spec = RunSpec(arch="internlm2-1.8b", quant=8, cache_compress="int8", kernels="cuda",
                   init="pruning", epochs=3, steps_per_epoch=2, batch=4, seq=512, seed=SEED,
                   ckpt=str(ckpt), cache_dir=str(workdir / "act_cache"))
    training_kernels = ("quant_matmul", "flash_attention", "mix_fwd", "mix_dw", "ce_fwd",
                        "ce_bwd")

    def read():
        return {k: v for k, v in read_launches().items() if k in training_kernels}

    per_step = []

    class StepLaunches(RunHooks):
        """Each step's launches (counts read after the step's loss is on the host)."""

        def on_step(self, session, event):
            now = read()
            before = per_step[-1][1] if per_step else dict.fromkeys(now, 0)
            per_step.append(({k: now[k] - before[k] for k in now}, now))

    def run(s, hooks=()):
        events = list(EpochRunner(s, hooks=[ConsoleHook(), *hooks]).events())
        return ([e for e in events if not isinstance(e, EpochReport)],
                [e for e in events if isinstance(e, EpochReport)])

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = EdgeSession(spec, log=print).open()
    torch.cuda.synchronize()
    open_s = time.perf_counter() - t0
    reset_launches()
    steps_, reports = run(s, [StepLaunches()])
    launches = read()
    peak = torch.cuda.max_memory_allocated()
    # what the distributed phase holds its run against: the per-step
    # losses and epoch 0's cache entries (int8 codes and scales, host)
    single = {"step_losses": [e.loss for e in steps_],
              "epoch_losses": [r.mean_loss for r in reports],
              "codes": {int(k): s.cache.get(int(k), with_final=True, dtype=None, compressed=True)
                        for ids in s.pipe.epoch_order(0) for k in ids}}
    s.finish()
    full = [e.wall_s for e in steps_ if not e.cache_hit]
    cached = [e.wall_s for e in steps_ if e.cache_hit]
    for name, ws in (("epoch1", full), ("cached", cached)):
        walls[name] = {"s": min(ws), "all_s": ws, "batch": spec.batch, "seq": spec.seq,
                       "quant": spec.quant, "cache": spec.cache_compress, "r": spec.r}
    emit({"phase": "training", "arch": s.cfg.name, "layers": s.cfg.n_layers,
          "d_model": s.cfg.d_model, "vocab": s.cfg.vocab, "batch": spec.batch, "seq": spec.seq,
          "quant": spec.quant, "cache": spec.cache_compress, "r": spec.r,
          "modes": [r.mode for r in reports], "epoch_losses": [r.mean_loss for r in reports],
          "step_losses": [e.loss for e in steps_], "open_s": open_s,
          "full_step_s": full, "cached_step_s": cached,
          "max_memory_allocated": peak, "cache_bytes": s.cache.nbytes,
          "cache_seqs": len(s.cache), "launches": launches,
          "launches_per_step": [d for d, _ in per_step]})
    if [r.mode for r in reports] != ["full", "cached", "cached"]:
        raise AssertionError(f"modes {[r.mode for r in reports]}")
    if not all(np.isfinite(r.mean_loss) for r in reports) or not (
            reports[-1].mean_loss < reports[0].mean_loss):
        raise AssertionError(f"epoch losses do not fall: {[r.mean_loss for r in reports]}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the training path: {missing}")
    persistence_phase(s, spec, steps_, run)

    cached_step_gate(s, spec)
    cuda_losses = [r.mean_loss for r in reports]

    profile_steps(s)
    backbone = s.backbone
    s.close()
    del s

    trainer_gate(spec, cuda_losses)
    return launches, backbone, ckpt, single


def persistence_phase(s, spec, steps_, run) -> None:
    """The training run's durable outputs: its checkpoint loads back bit
    for bit; a second run over its cache directory (1 epoch x 2 steps)
    is warm — every step cached, no frozen-forward kernel launched — and
    gives the first run's epoch-0 losses; another seed invalidates the
    directory and re-captures it."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.activation_cache import MANIFEST_NAME
    from repro_torch.core.quantization import tree_leaves
    from repro_torch.runtime import EdgeSession

    t0 = time.perf_counter()
    loaded = load_checkpoint(spec.ckpt, device=DEV)
    load_s = time.perf_counter() - t0
    pairs = list(zip(tree_leaves(loaded["adapter"]), tree_leaves(s.adapter)))
    bit_equal = (loaded["config"] == s.cfg.name and len(pairs) == len(tree_leaves(s.adapter))
                 and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs))
    del loaded, pairs
    manifest = Path(spec.cache_dir) / MANIFEST_NAME

    def rerun(run_spec):
        reset_launches()
        t = time.perf_counter()
        session = EdgeSession(run_spec, log=print).open()
        open_s = time.perf_counter() - t
        events, reports = run(session)
        session.finish()
        session.close()
        return session, events, reports, open_s, read_launches()

    warm_s, warm_steps, warm_reports, warm_open_s, warm_launches = rerun(
        spec.replace(epochs=1, ckpt=None))
    cold = [e.loss for e in steps_ if e.epoch == 0]
    warm = [e.loss for e in warm_steps]
    reseed = spec.replace(epochs=1, seed=SEED + 1, ckpt=None)
    seeded_s, seeded_steps, _, _, seeded_launches = rerun(reseed)
    recaptured = json.loads(manifest.read_text())["meta"] == seeded_s.meta
    loss_tol = 2e-5
    emit({"phase": "persistence", "ckpt": Path(spec.ckpt).name,
          "ckpt_bytes": Path(spec.ckpt).stat().st_size, "ckpt_load_s": load_s,
          "ckpt_bit_equal": bit_equal, "warm": warm_s.warm, "warm_open_s": warm_open_s,
          "warm_modes": [r.mode for r in warm_reports],
          "warm_steps_cached": [e.cache_hit for e in warm_steps],
          "warm_step_s": [e.wall_s for e in warm_steps], "warm_launches": warm_launches,
          "warm_losses": warm, "cold_epoch0_losses": cold, "loss_tol": loss_tol,
          "loss_tol_reason": "the reference's cached-step loss tolerance "
                             "(tests/test_cached_step.py:163): the same int8 taps, from the "
                             "tap site in the first run and from the cache in the second",
          "reseeded_warm": seeded_s.warm, "reseeded_modes": [e.mode for e in seeded_steps],
          "reseeded_launches": seeded_launches, "reseeded_manifest_recaptured": recaptured})
    if not bit_equal:
        raise AssertionError("the checkpoint does not load back bit-equal to the adapter")
    if not (warm_s.warm and all(e.cache_hit for e in warm_steps)
            and [r.mode for r in warm_reports] == ["cached"]):
        raise AssertionError("the rerun over the cache directory was not warm")
    if warm_launches["quant_matmul"] or warm_launches["flash_attention"]:
        raise AssertionError(f"the warm rerun ran the frozen forward: {warm_launches}")
    if max(abs(a - b) for a, b in zip(warm, cold)) > loss_tol:
        raise AssertionError(f"warm losses {warm} differ from the first run's {cold}")
    if seeded_s.warm or any(e.cache_hit for e in seeded_steps) or not recaptured \
            or seeded_launches["quant_matmul"] <= 0:
        raise AssertionError("a new seed did not invalidate and re-capture the cache")


# ---------------------------------------------------------------- prefetch

PREFETCH_WORKER = "activation-cache-prefetch"  # CachePrefetcher's thread
#: steps an epoch of the prefetch cell (8 until the bf16 gemma2-2b slice): at least 6, so that
#: the profiled third step still sees a batch copied (the prefetcher's queue of 2 runs its
#: worker three batches ahead: the third step's copy is the sixth batch's)
PREFETCH_STEPS = 6


def prefetch_phase(workdir: Path) -> dict:
    """The cached epoch's input path at full width: ``PREFETCH_STEPS`` steps
    of 4 x 512 tokens, int8 cache, ``cuda`` kernels. Epoch 0 fills the cache (its
    second step profiled: the taps' device→host copy must land in pinned
    memory); then, from one snapshot, the cached epoch runs four times in
    turns: through ``EpochRunner`` (the prefetcher), through ``step``
    with no epoch scope (read and copied on the caller's thread), and
    both again with their third step profiled. Gates: bit-equal per-step
    losses; the prefetched batch's host→device copies from pinned memory
    on a stream no kernel runs on; no worker thread left. Returns the
    path's launches (epoch 0 and the first prefetched epoch)."""
    import threading

    from repro_torch.core.quantization import tree_map
    from repro_torch.runtime import EdgeSession, EpochReport, EpochRunner, RunSpec

    spec = RunSpec(arch="internlm2-1.8b", quant=8, cache_compress="int8", kernels="cuda",
                   init="pruning", epochs=2, steps_per_epoch=PREFETCH_STEPS, batch=4, seq=512,
                   seed=SEED)
    s = EdgeSession(spec, log=print).open()
    runner = EpochRunner(s)
    # a batch's int8 payloads and f32 scales (one per 128 columns): b0 and
    # b_final (B, S, d), taps (n_p, B, S, d); their copies, by size
    rows = spec.batch * spec.seq * s.cfg.d_model
    batch_bytes = {n * rows * size // block for n in (1, s.cfg.n_periods)
                   for size, block in ((1, 1), (4, 128))}

    def workers():
        return [t.name for t in threading.enumerate() if t.name == PREFETCH_WORKER and t.is_alive()]

    def steps_of(epoch, profile_at=None, prefetched=True):
        """One epoch's StepEvents, through EpochRunner or step(); the
        ``profile_at``-th step under the profiler (its trace kept)."""
        events, prof, on_pf = [], None, []
        if prefetched:
            it = runner.run_epoch(epoch)
        else:
            it = (s.step(b, epoch=epoch, index=i) for i, b in enumerate(s.pipe.epoch(epoch)))
        torch.cuda.reset_peak_memory_stats()
        for i in range(spec.steps_per_epoch):
            if i == profile_at:
                prof = device_profile(lambda: events.append(next(it)),
                                      trace=workdir / f"prefetch_{epoch}_{prefetched}.json")
            else:
                events.append(next(it))
            on_pf.append(s._prefetch is not None)
        rest = list(it)  # the report: the epoch scope closes here
        if prefetched and not (len(rest) == 1 and isinstance(rest[0], EpochReport)):
            raise AssertionError(f"the epoch did not end with its report: {rest}")
        return events, prof, on_pf, torch.cuda.max_memory_allocated()

    reset_launches()
    t0 = time.perf_counter()
    fill, fill_prof, _, fill_peak = steps_of(0, profile_at=1)
    fill_s = time.perf_counter() - t0
    snap = {k: tree_map(lambda t: t.clone(), v) if k in ("adapter", "opt") else v
            for k, v in s.snapshot().items()}
    cached, _, on_pf, pf_peak = steps_of(1)
    launches = read_launches()
    after_epoch = workers()
    runs = {"prefetched": (cached, None, on_pf, pf_peak)}
    for name, prefetched in (("sync", False), ("prefetched_profiled", True),
                             ("sync_profiled", False)):
        s.restore(snap)
        runs[name] = steps_of(1, profile_at=2 if "profiled" in name else None,
                              prefetched=prefetched)
    s.restore(snap)
    left = workers()
    cache_bytes, cache_seqs = s.cache.nbytes, len(s.cache)
    s.close()
    del s, snap, runner

    losses = {k: [e.loss for e in v[0]] for k, v in runs.items()}
    walls = {k: [e.wall_s for e in v[0]] for k, v in runs.items()}
    pf_prof, sync_prof = runs["prefetched_profiled"][1], runs["sync_profiled"][1]

    def batch_copies(prof, kind):
        return [c for c in prof["copies"] if kind in c["kind"] and c["bytes"] in batch_bytes]

    h2d = batch_copies(pf_prof, "HtoD")
    taps_d2h = batch_copies(fill_prof, "DtoH")
    line = {"phase": "prefetch", "arch": "internlm2-1.8b", "steps_per_epoch": spec.steps_per_epoch,
            "batch": spec.batch, "seq": spec.seq, "cache": spec.cache_compress,
            "cache_bytes": cache_bytes, "cache_seqs": cache_seqs, "fill_epoch_s": fill_s,
            "modes": [[e.mode for e in fill], [e.mode for e in cached]],
            "steps_on_prefetcher": {k: v[2] for k, v in runs.items()},
            "losses": losses, "step_s": walls,
            "median_step_s": {k: statistics.median(v) for k, v in walls.items()},
            "max_memory_allocated": {"fill": fill_peak, **{k: v[3] for k, v in runs.items()}},
            "busy_share": {"prefetched": pf_prof["device_busy_share"],
                           "sync": sync_prof["device_busy_share"]},
            "profiled_wall_ms": {"prefetched": pf_prof["wall_ms"], "sync": sync_prof["wall_ms"]},
            "device_busy_ms": {"prefetched": pf_prof["device_busy_ms"],
                               "sync": sync_prof["device_busy_ms"]},
            "prefetched_h2d": h2d, "sync_h2d": batch_copies(sync_prof, "HtoD"),
            "kernel_streams": {"prefetched": pf_prof["kernel_streams"],
                               "sync": sync_prof["kernel_streams"]},
            "fill_d2h": taps_d2h, "fill_profile_wall_ms": fill_prof["wall_ms"],
            "fill_busy_share": fill_prof["device_busy_share"],
            "kernels_by_device_ms": {"fill": fill_prof["kernels_by_device_ms"],
                                     "prefetched": pf_prof["kernels_by_device_ms"],
                                     "sync": sync_prof["kernels_by_device_ms"]},
            "workers_alive_after_epoch": after_epoch, "workers_alive_at_end": left,
            "launches": launches}
    emit(line)
    n = PREFETCH_STEPS
    if [e.mode for e in fill] != ["full"] * n or any(e.mode != "cached" for v in runs.values()
                                                      for e in v[0]):
        raise AssertionError(f"modes {line['modes']}")
    if line["steps_on_prefetcher"] != {"prefetched": [True] * n, "sync": [False] * n,
                                       "prefetched_profiled": [True] * n,
                                       "sync_profiled": [False] * n}:
        raise AssertionError(f"steps on the prefetcher: {line['steps_on_prefetcher']}")
    if len({tuple(v) for v in losses.values()}) != 1 or not all(
            np.isfinite(x) for x in losses["sync"]):
        raise AssertionError(f"prefetched and synchronous losses differ: {losses}")
    if not h2d or any(c["kind"] != "Memcpy HtoD (Pinned -> Device)"
                      or c["stream"] in pf_prof["kernel_streams"] for c in h2d):
        raise AssertionError(f"the prefetched batch's copies: {h2d}, kernels on "
                             f"{pf_prof['kernel_streams']}")
    if not taps_d2h or any(c["kind"] != "Memcpy DtoH (Device -> Pinned)" for c in taps_d2h):
        raise AssertionError(f"epoch 1's tap copies: {taps_d2h}")
    if after_epoch or left:
        raise AssertionError(f"prefetch workers still alive: {after_epoch}, {left}")
    missing = [n for n in ("quant_matmul", "flash_attention", "mix_fwd", "mix_dw", "ce_fwd",
                           "ce_bwd") if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the prefetch path: {missing}")
    return launches


# ---------------------------------------------------------------- distributed training

DIST_DP, DIST_STAGES = 2, 2
DIST_ROWS = 1  # a rank's rows: batch 4 over 2 micro-batches x dp 2, and over the pool of 4
DIST_STEP_TOL = 1e-5  # per-step |Δloss| against the single process
DIST_TOL = {"first_step": 1e-4, "steps": DIST_STEP_TOL, "epoch": 5e-2, "tap_codes": 1}
TRAINING_KERNELS = ("quant_matmul", "flash_attention", "mix_fwd", "mix_dw", "ce_fwd", "ce_bwd")


def fingerprint(tree, chunk: int = 1 << 26) -> list:
    """Two int64 sums a leaf over its 16-bit words (plain, and weighted
    by position mod 1021), ``chunk`` words at a time so that a 48 GB
    backbone is never widened at once (a QTensor counts its codes and
    scales): equal bits give equal sums; the card computes them, so
    comparing ranks costs no copy of the state."""
    from repro_torch.core.quantization import QTensor, tree_leaves

    out = []
    for leaf in tree_leaves(tree):
        for t in ((leaf.q, leaf.scale) if isinstance(leaf, QTensor) else (leaf,)):
            w = t.detach().reshape(-1).contiguous().view(torch.uint8)
            w = w[: w.numel() // 2 * 2].view(torch.int16)
            plain = weighted = 0
            for i in range(0, w.numel(), chunk):
                part = w[i:i + chunk].to(torch.int64)
                pos = (torch.arange(i, i + part.numel(), device=w.device) % 1021) + 1
                plain += int(part.sum())
                weighted += int((part * pos).sum())
            out += [plain, weighted]
    return out


@contextlib.contextmanager
def token_counts(seen: list):
    """While the block runs, append ``(kernel, T)`` to ``seen`` for each
    call of the mix and CE kernels' wrappers (T: the rows of its
    activations), through the module attributes their autograd
    Functions call."""
    from repro_torch.kernels import cached_mix, lmhead_ce

    originals = []
    for mod, name, arg in ((cached_mix, "mix_fwd", 2), (cached_mix, "mix_dw", 1),
                           (lmhead_ce, "ce_fwd", 0), (lmhead_ce, "ce_bwd", 0)):
        fn = getattr(mod, name)
        originals.append((mod, name, fn))

        def probe(*a, _fn=fn, _name=name, _arg=arg, **kw):
            seen.append((_name, int(a[_arg].shape[0])))
            return _fn(*a, **kw)

        setattr(mod, name, probe)
    try:
        yield
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def distributed_rank(spec, runs: int, layout: str = None, reshards: dict = None,
                     count_blocks: bool = False) -> dict:
    """One rank of the distributed and plan phases: ``runs`` runs of
    ``spec`` through ``EdgeSession``/``EpochRunner`` (``layout``: the
    layout the parent resolved, as JSON), each step's loss, wall time,
    launches, mesh transfer counters and adapter/optimizer fingerprint;
    on the owner also epoch 0's cache entries (first run). ``reshards``
    (``{(epoch, step): dp}``) reshards the last run's session after
    those steps, from an ``on_step`` hook: its seconds (the group and
    the state broadcast, ending in a sync) and bytes broadcast are kept
    apart from the steps'. Only that run records the token counts of
    the mix and CE calls (:func:`token_counts`). ``count_blocks`` also
    records each step's backbone blocks run through the ``cuda`` OpSet
    (its ``prepare_block`` calls; the adapter's blocks run on plain ops)."""
    import torch.distributed as dist

    from repro_torch.core.opset import CudaOpSet
    from repro_torch.runtime import EdgeSession, EpochRunner, RunHooks

    rank = dist.get_rank()
    out = {"rank": rank, "runs": []}
    blocks = [0]
    if count_blocks:
        prepare = CudaOpSet.prepare_block

        def counted(self, p, block_spec):
            blocks[0] += 1
            return prepare(self, p, block_spec)

        CudaOpSet.prepare_block = counted
    for run in range(runs):
        schedule = (reshards or {}) if run == runs - 1 else {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = EdgeSession(spec, log=print if rank == 0 and run == 0 else None,
                        layout=layout).open()
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        steps, seen = [], []

        class Record(RunHooks):
            def on_step(self, session, event):
                now = {k: v for k, v in read_launches().items() if k in TRAINING_KERNELS}
                stats = dict(session.mesh.stats)
                prev = steps[-1] if steps else {"_launches": dict.fromkeys(now, 0),
                                                "_stats": dict.fromkeys(stats, 0), "_seen": 0}
                tokens = {}
                for name, T in seen[prev["_seen"]:]:
                    tokens.setdefault(name, set()).add(T)
                steps.append({"loss": event.loss, "wall_s": event.wall_s, "mode": event.mode,
                              "launches": {k: now[k] - prev["_launches"][k] for k in now},
                              "tokens": {k: sorted(v) for k, v in tokens.items()},
                              **{k: stats[k] - prev["_stats"][k] for k in stats},
                              "fingerprint": fingerprint((session.adapter, session.opt)),
                              "_launches": now, "_stats": stats, "_seen": len(seen),
                              **({"blocks": blocks[0] - prev.get("_blocks", 0),
                                  "_blocks": blocks[0]} if count_blocks else {})})
                dp = schedule.get((event.epoch, event.index))
                if dp is not None:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    session.reshard(dp)
                    torch.cuda.synchronize()
                    after = dict(session.mesh.stats)
                    steps[-1]["reshard"] = {
                        "dp": dp, "s": time.perf_counter() - t, "active": session.mesh.active,
                        "members": list(session.mesh.members),
                        **{k: after[k] - stats[k] for k in stats}}
                    steps[-1]["_stats"] = after

        reset_launches()
        blocks[0] = 0
        with token_counts(seen) if schedule else contextlib.nullcontext():
            reports = EpochRunner(s, hooks=[Record()]).run()
        rec = {"open_s": open_s, "modes": [r.mode for r in reports],
               "periods": s.backbone["periods"],
               "epoch_losses": [r.mean_loss for r in reports],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": {k: v for k, v in read_launches().items() if k in TRAINING_KERNELS},
               "steps": [{k: v for k, v in st.items() if not k.startswith("_")}
                         for st in steps]}
        if rank == 0 and run == 0:
            rec["codes"] = {int(k): s.cache.get(int(k), with_final=True, dtype=None,
                                                compressed=True)
                            for ids in s.pipe.epoch_order(0) for k in ids}
        s.close()
        del s
        rec["run_s"] = time.perf_counter() - t0
        out["runs"].append(rec)
    return out


def code_moves(got, want) -> dict:
    """Two int8 cache entries' codes: max |Δq|, the share that moved, and
    the largest relative scale difference."""
    dq = (got.q.int() - want.q.int()).abs()
    ds = (got.scale - want.scale).abs().max() / want.scale.abs().max().clamp_min(1e-30)
    return {"max_dq": int(dq.max()), "moved": int((dq > 0).sum()), "codes": dq.numel(),
            "max_rel_dscale": float(ds)}


def distributed_kernel_phase(timer: Timer, gen: torch.Generator,
                             path: str = "distributed", arch: str = None) -> dict:
    """The six kernels of the distributed path against their plain
    versions at the shapes one rank gives them (dp=2, stages=2, batch 4
    x 512, 2 micro-batches): ``quant_matmul`` at M = 512 (a stage's
    micro-batch, one row a dp rank) over the layer's (K, N), int8;
    ``flash_attention`` at B·H = 1·16, S = 512; ``mix_fwd``/``mix_dw`` on
    int8 entries and ``ce_fwd``/``ce_bwd`` at T = 1024 (the epoch-1 loss,
    a dp row's two rows) and T = 512 (the cached step, one row a rank),
    d = 2048, d_a = 256, V = 92544; each at the tolerance of its check
    at the training shapes. ``path`` names the lines of another path of
    the same shapes (PAC+ through ``pipeline_grads``). ``arch``, a key of
    ``FAMILY_DIST_WIDTHS``: that config's distributed path's shapes
    instead (its projections at its stage's M, flash at its heads or
    none, the mix and CE kernels at its widths and T), each line naming
    it. Returns flash's row (None where the path runs no flash)."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels import cached_mix, lmhead_ce, ref

    M, projections, heads, (d, da, V), Ts = (
        (DIST_ROWS * 512, QMM_SHAPES, (DIST_ROWS, 16, 8, 128), (TRAIN_D, TRAIN_DA, TRAIN_V),
         (2 * DIST_ROWS * 512, DIST_ROWS * 512)) if arch is None else FAMILY_DIST_WIDTHS[arch])
    named = {} if arch is None else {"arch": arch}
    for K, N in sorted(set(projections), key=projections.index):
        _, _, got, want = qmm_check(gen, M, K, N, 8)
        emit({"check": f"quant_matmul_{path}", **named, "M": M, "K": K, "N": N, "bits": 8,
              "max_abs_err": max_err(got, want),
              "check_value": float(((got - want).abs() - 1e-4 * want.abs()).max()),
              "tol": "atol 1e-3 + rtol 1e-4", "tol_reason": qmm_tol_reason(M)})
    r = None
    if heads is not None:
        B, H, Hkv, hd = heads
        r = flash_case(timer, gen, B, H, Hkv, 512, hd, f"{path} stage")[0]
        emit(dict(r, **named))
    for T in Ts:
        ent = quantize(torch.randn(T, d, generator=gen, device=DEV), 8, 128)
        w = torch.randn(d, da, generator=gen, device=DEV) * d ** -0.5
        a = torch.randn(T, da, generator=gen, device=DEV)
        g = torch.randn(T, da, generator=gen, device=DEV)
        lam = torch.tensor(0.7, device=DEV)
        out, bw = cached_mix.mix_fwd(ent, w, a, lam)
        want_out, want_bw = ref.mix_fwd_ref(ent, w, a, lam)
        dw, want_dw = cached_mix.mix_dw(ent, g, lam, d), ref.mix_dw_ref(ent, g, lam, d)
        e_fwd = mix_fwd_check(out, bw, want_out, want_bw)
        e_dw = float(((dw - want_dw).abs() - 1e-3 * want_dw.abs()).max())
        check(f"mix_fwd int8 T={T} ({path})", e_fwd, 1e-4)
        check(f"mix_dw int8 T={T} ({path})", e_dw, 2e-4)
        del ent, w, a, g, out, bw, want_out, want_bw, dw, want_dw
        h = torch.randn(T, d, generator=gen, device=DEV)
        wh = torch.randn(d, V, generator=gen, device=DEV) * d ** -0.5
        lab = torch.randint(0, V, (T,), generator=gen, device=DEV)
        gl = torch.randn(T, generator=gen, device=DEV)
        nll, lse = lmhead_ce.ce_fwd(h, wh, lab)
        want_nll, want_lse = ref.ce_fwd_ref(h, wh, lab)
        dh, want_dh = (lmhead_ce.ce_bwd(h, wh, lab, want_lse, gl),
                       ref.ce_bwd_ref(h, wh, lab, want_lse, gl))
        e_f = max(float(((nll - want_nll).abs() - 1e-5 * want_nll.abs()).max()),
                  float(((lse - want_lse).abs() - 1e-5 * want_lse.abs()).max()))
        e_b = float(((dh - want_dh).abs() - 1e-4 * want_dh.abs()).max())
        check(f"ce_fwd T={T} ({path})", e_f, 2e-5)
        check(f"ce_bwd T={T} ({path})", e_b, 1e-5)
        emit({"check": f"training_kernels_{path}", **named, "T": T, "d": d, "da": da, "V": V,
              "storage": "int8", "mix_fwd_check": e_fwd, "mix_dw_check": e_dw,
              "ce_fwd_max_abs_err": max(max_err(nll, want_nll), max_err(lse, want_lse)),
              "ce_bwd_max_abs_err": max_err(dh, want_dh), "ce_fwd_check": e_f,
              "ce_bwd_check": e_b,
              "tol": "mix_fwd atol 1e-4 + rtol 1e-4; mix_dw atol 2e-4 + rtol 1e-3; ce_fwd "
                     "atol 2e-5 + rtol 1e-5; ce_bwd atol 1e-5 + rtol 1e-4",
              "tol_reason": "the tolerances of the checks at the training shapes"})
        del h, wh, lab, gl, nll, lse, want_nll, want_lse, dh, want_dh
    return r


def parity(ranks: list, single: dict) -> dict:
    """The first run of a distributed run (``distributed_rank``'s records,
    rank 0 holding epoch 0's cache entries) against the single-process
    training run: per-step losses, their distance to the single
    process's, ranks' losses and fingerprints equal after every step, and
    epoch 0's cache codes (b0 bit-equal, taps and b_final moved codes)."""
    first = [r["runs"][0] for r in ranks]
    losses = [st["loss"] for st in first[0]["steps"]]
    codes = first[0].pop("codes")
    moves = {"b0": [], "taps": [], "b_final": []}
    for k, want in single["codes"].items():
        for name, g, w in zip(("b0", "taps", "b_final"), codes[k], want):
            moves[name].append(code_moves(g, w))
    b0_equal = all(torch.equal(g[0].q, w[0].q) and torch.equal(g[0].scale, w[0].scale)
                   for g, w in ((codes[k], single["codes"][k]) for k in single["codes"]))
    summary = {name: {"max_dq": max(m["max_dq"] for m in ms),
                      "moved_share": sum(m["moved"] for m in ms) / sum(m["codes"] for m in ms),
                      "max_rel_dscale": max(m["max_rel_dscale"] for m in ms)}
               for name, ms in moves.items()}
    return {"modes": first[0]["modes"], "step_losses": losses,
            "single_step_losses": single["step_losses"],
            "epoch_losses": first[0]["epoch_losses"],
            "single_epoch_losses": single["epoch_losses"],
            "abs_dloss_first_step": abs(losses[0] - single["step_losses"][0]),
            "abs_dloss_steps": [abs(a - b) for a, b in zip(losses, single["step_losses"])],
            "abs_depoch": [abs(a - b) for a, b in zip(first[0]["epoch_losses"],
                                                       single["epoch_losses"])],
            "ranks_equal_losses": all([st["loss"] for st in r["steps"]] == losses
                                      for r in first),
            "adapters_bit_equal": [len({str(r["steps"][j]["fingerprint"]) for r in first}) == 1
                                   for j in range(len(first[0]["steps"]))],
            "b0_codes_equal": b0_equal, "codes": summary}


def check_parity(line: dict, modes: list) -> None:
    """The distributed gates (``DIST_TOL``) on a :func:`parity` line: the
    modes, ranks agreeing, the first step's loss within 1e-4, every
    step's within ``DIST_STEP_TOL`` and the epoch means within 5e-2 of
    the single process's, b0 codes bit-equal, taps and b_final within one
    step."""
    tol = DIST_TOL
    if line["modes"] != modes:
        raise AssertionError(f"modes {line['modes']}, wanted {modes}")
    if not (line["ranks_equal_losses"] and all(line["adapters_bit_equal"])):
        raise AssertionError(f"ranks disagree: losses {line['ranks_equal_losses']}, "
                             f"adapters {line['adapters_bit_equal']}")
    if not (line["abs_dloss_first_step"] <= tol["first_step"]
            and len(line["step_losses"]) == len(line["single_step_losses"])
            and max(line["abs_dloss_steps"]) <= tol["steps"]
            and max(line["abs_depoch"]) <= tol["epoch"]):
        raise AssertionError("distributed vs single-process losses: first step "
                             f"{line['abs_dloss_first_step']}, steps {line['abs_dloss_steps']}, "
                             f"epochs {line['abs_depoch']}")
    if not all(np.isfinite(x) for x in line["step_losses"]):
        raise AssertionError(f"losses {line['step_losses']}")
    summary = line["codes"]
    if (not line["b0_codes_equal"] or summary["taps"]["max_dq"] > tol["tap_codes"]
            or summary["b_final"]["max_dq"] > tol["tap_codes"]):
        raise AssertionError(f"cache codes: b0 equal {line['b0_codes_equal']}, {summary}")


DIST_TOL_REASON = ("the first step sums the same tokens' CE in another order (f32); every "
                   "step: the same sums in another order, so the losses stay within a few f32 "
                   "steps (9.5e-7 at 12) while a fault in the gradient sum moves a later step's "
                   "loss by far more; epochs: the trainer_cuda_vs_ref gate; tap codes: a frozen "
                   "forward on smaller micro-batches may round a code the other way")


def rank_stats(ranks: list) -> dict:
    """Per rank of a distributed run's first run: step walls, transfer
    bytes and host seconds, launches, memory high-water mark."""
    first = {r["rank"]: r["runs"][0] for r in ranks}
    return {"open_s": [run["open_s"] for run in first.values()],
            "step_s": {k: [st["wall_s"] for st in run["steps"]] for k, run in first.items()},
            "step_modes": [st["mode"] for st in first[0]["steps"]],
            "bytes_per_step": {k: [{x: st[x] for x in ("p2p_bytes", "p2p_s", "allreduce_bytes",
                                                       "allreduce_s")}
                                   for st in run["steps"]] for k, run in first.items()},
            "max_memory_allocated": [run["max_memory_allocated"] for run in first.values()],
            "launches_per_step": {k: [st["launches"] for st in run["steps"]]
                                  for k, run in first.items()}}


#: the distributed phase's third run: dp 2 -> 1 after epoch 0, back to 2 after epoch 1
RESHARDS = {(0, 1): 1, (1, 1): 2}
CACHED_KERNELS = TRAINING_KERNELS[2:]
BYTE_COUNTERS = ("p2p_bytes", "allreduce_bytes", "broadcast_bytes")


def _leaves_differing(a: list, b: list) -> int:
    """How many arrays two :func:`fingerprint` lists disagree on."""
    return sum(a[i:i + 2] != b[i:i + 2] for i in range(0, len(a), 2))


def reshard_line(ranks: list) -> dict:
    """The distributed phase's third run (``RESHARDS``) against its first:
    per rank each step's mode, wall, launches, token counts and bytes,
    each reshard's seconds and bytes broadcast, the memory high-water
    mark and the run's seconds; the gates' values; and, leaf by leaf,
    how many of the owner's adapter and optimizer arrays differ from the
    unchanged run's after each step (epoch 1's first step starts from
    equal state, so there it counts the update's leaves that differ)."""
    first = {r["rank"]: r["runs"][0] for r in ranks}
    last = {r["rank"]: r["runs"][2] for r in ranks}
    owner = [st["loss"] for st in last[0]["steps"]]
    want = [st["loss"] for st in first[0]["steps"]]
    n = len(owner)
    members = {j: [k for k in last if last[k]["steps"][j]["mode"] != "parked"]
               for j in range(n)}
    return {
        "phase": "reshard", "arch": "internlm2-1.8b", "spawned": [DIST_DP, DIST_STAGES],
        "schedule": {f"after epoch {e} step {i}": dp for (e, i), dp in RESHARDS.items()},
        "step_losses": owner, "unchanged_step_losses": want,
        "epoch0_bit_equal": all(
            [st["loss"] for st in last[k]["steps"][:2]] == [st["loss"] for st in
                                                            first[k]["steps"][:2]]
            and [st["fingerprint"] for st in last[k]["steps"][:2]]
            == [st["fingerprint"] for st in first[k]["steps"][:2]] for k in last),
        "abs_dloss_steps": [abs(a - b) for a, b in zip(owner, want)],
        "members": [members[j] for j in range(n)],
        "members_bit_equal": [len({str(last[k]["steps"][j]["fingerprint"])
                                   for k in members[j]}) == 1
                              and len({last[k]["steps"][j]["loss"] for k in members[j]}) == 1
                              for j in range(n)],
        "leaves": len(last[0]["steps"][0]["fingerprint"]) // 2,
        "leaves_differing_from_unchanged": [
            _leaves_differing(a["fingerprint"], b["fingerprint"])
            for a, b in zip(last[0]["steps"], first[0]["steps"])],
        "modes": {k: [st["mode"] for st in run["steps"]] for k, run in last.items()},
        "step_s": {k: [st["wall_s"] for st in run["steps"]] for k, run in last.items()},
        "launches_per_step": {k: [st["launches"] for st in run["steps"]]
                              for k, run in last.items()},
        "tokens_per_step": {k: [st["tokens"] for st in run["steps"]] for k, run in last.items()},
        "bytes_per_step": {k: [{x: st[x] for x in BYTE_COUNTERS} for st in run["steps"]]
                           for k, run in last.items()},
        "reshards": {k: [st["reshard"] for st in run["steps"] if "reshard" in st]
                     for k, run in last.items()},
        "max_memory_allocated": [run["max_memory_allocated"] for run in last.values()],
        "run_s": [run["run_s"] for run in last.values()]}


def check_reshard(line: dict) -> None:
    """The third run's gates: epoch 0 bit-equal to the first run, every
    later step within ``DIST_STEP_TOL`` of it, the members bit-equal in
    adapter and optimizer after every step (epoch 1: ranks 0-1, epoch 2:
    all four), the parked ranks launching nothing and moving no bytes,
    each member's mix and CE kernels at T = 1024 in epoch 1 and 512 in
    epoch 2, and no frozen-forward kernel after epoch 0."""
    want_members = [[0, 1, 2, 3]] * 2 + [[0, 1]] * 2 + [[0, 1, 2, 3]] * 2
    if line["members"] != want_members:
        raise AssertionError(f"reshard members {line['members']}, wanted {want_members}")
    if not (line["epoch0_bit_equal"] and all(line["members_bit_equal"])):
        raise AssertionError(f"reshard: epoch 0 bit-equal {line['epoch0_bit_equal']}, "
                             f"members {line['members_bit_equal']}")
    if not (max(line["abs_dloss_steps"]) <= DIST_STEP_TOL
            and all(np.isfinite(x) for x in line["step_losses"])):
        raise AssertionError(f"reshard losses {line['step_losses']} against "
                             f"{line['unchanged_step_losses']}")
    for k, modes in line["modes"].items():
        for j, mode in enumerate(modes):
            launched = line["launches_per_step"][k][j]
            if mode == "parked":
                moved = line["bytes_per_step"][k][j]
                if any(launched.values()) or any(moved.values()) or line["tokens_per_step"][k][j]:
                    raise AssertionError(f"parked rank {k} step {j}: launches {launched}, "
                                         f"bytes {moved}")
            elif j >= 2:
                T = 1024 if j < 4 else 512
                tokens = line["tokens_per_step"][k][j]
                if (any(launched[x] <= 0 for x in CACHED_KERNELS)
                        or launched["quant_matmul"] or launched["flash_attention"]
                        or any(tokens.get(x) != [T] for x in CACHED_KERNELS)):
                    raise AssertionError(f"rank {k} step {j} ({mode}): launches {launched}, "
                                         f"tokens {tokens}, wanted T = {T}")
    for k in (2, 3):
        if line["modes"][k][2:4] != ["parked", "parked"]:
            raise AssertionError(f"rank {k} modes {line['modes'][k]}")


def distributed_phase(single: dict):
    """The hybrid DP x PP trainer at full width: the training phase's spec
    (internlm2-1.8b, 24 periods, INT8 backbone, int8 cache, r=8, pruning,
    lr 3e-3, 3 epochs x 2 steps of 4 x 512 tokens) with dp=2, stages=2
    (12 periods a stage, 2 micro-batches), as four ranks sharing the card
    over gloo, run three times, the third resharding (``RESHARDS``: dp 1
    over ranks 0-1 for epoch 1, ranks 2-3 parked; dp 2 again for epoch
    2). Gates: :func:`check_parity` against the single-process run; the
    first two runs' per-step losses bit-equal; the training kernels
    launched on the ranks that run them; :func:`check_reshard` on the
    third (``reshard`` line). Returns the first run's launches and the
    third's, each summed over the ranks, and the ranks' records."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.runtime import RunSpec

    spec = RunSpec(arch="internlm2-1.8b", quant=8, cache_compress="int8", kernels="cuda",
                   init="pruning", epochs=3, steps_per_epoch=2, batch=4, seq=512, seed=SEED,
                   dp=DIST_DP, stages=DIST_STAGES)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    t0 = time.perf_counter()
    ranks = spawn(distributed_rank, DIST_DP, DIST_STAGES, "cuda", args=(spec, 3, None, RESHARDS),
                  timeout=300.0, deadline=700.0)
    phase_s = time.perf_counter() - t0
    line = {"phase": "distributed", "arch": "internlm2-1.8b", "dp": DIST_DP,
            "stages": DIST_STAGES, "ranks": len(ranks), "backend": "gloo",
            "n_micro": spec.default_micro(), "batch": spec.batch, "seq": spec.seq,
            "quant": spec.quant, "cache": spec.cache_compress, "r": spec.r,
            **parity(ranks, single)}
    rerun = [st["loss"] for st in ranks[0]["runs"][1]["steps"]]
    line["step_losses"] = [line["step_losses"], rerun]
    line["reruns_bit_equal"] = line["step_losses"][0] == rerun
    line["rerun_ranks_equal_losses"] = all([st["loss"] for st in r["runs"][1]["steps"]] == rerun
                                           for r in ranks)
    line["rerun_adapters_bit_equal"] = [
        len({str(r["runs"][1]["steps"][j]["fingerprint"]) for r in ranks}) == 1
        for j in range(len(ranks[0]["runs"][1]["steps"]))]
    line.update(rank_stats(ranks), phase_s=phase_s,
                tol=DIST_TOL,
                tol_reason=DIST_TOL_REASON)
    line.update(priced_mesh_bytes(spec, {r["rank"]: r["runs"][0] for r in ranks}))
    emit(line)
    if not line["priced_bytes_equal"]:
        raise AssertionError(f"priced mesh bytes {line['priced_bytes_per_step']} differ from "
                             f"the counted {line['bytes_per_step']}")
    line["step_losses"] = line["step_losses"][0]
    first = [r["runs"][0] for r in ranks]
    launches = {k: sum(r["launches"][k] for r in first) for k in TRAINING_KERNELS}
    check_parity(line, ["hybrid dp2xpp2", "cached pure-dp", "cached pure-dp"])
    if not (line["reruns_bit_equal"] and line["rerun_ranks_equal_losses"]
            and all(line["rerun_adapters_bit_equal"])):
        raise AssertionError(f"reruns differ: {line['step_losses']} against {rerun}, ranks "
                             f"{line['rerun_ranks_equal_losses']}, adapters "
                             f"{line['rerun_adapters_bit_equal']}")
    for r in ranks:
        for st in r["runs"][0]["steps"]:
            head = r["rank"] % DIST_STAGES == 0
            want = (("quant_matmul", "flash_attention") + (CACHED_KERNELS if head else ())
                    if st["mode"].startswith("hybrid") else CACHED_KERNELS)
            if any(st["launches"][k] <= 0 for k in want):
                raise AssertionError(f"rank {r['rank']} {st['mode']}: launches {st['launches']}")
    resharded = reshard_line(ranks)
    resharded["phase_s"] = max(resharded["run_s"])
    emit(resharded)
    check_reshard(resharded)
    reshard_launches = {k: sum(r["runs"][2]["launches"][k] for r in ranks)
                        for k in TRAINING_KERNELS}
    return launches, reshard_launches, ranks


# ---------------------------------------------------------------- plan-driven training

PLAN_REF_BOUNDARIES = (0, 5, 16, 24)  # the JAX planner's for the ragged plan's inputs
PLAN_MEMORY_SHARE = 0.5  # each device holds half the backbone's weights and adapter state
PLAN_MICRO_BATCH, PLAN_N_MICRO = 2, 2
PROJECTIONS_PER_PERIOD = 7  # quant_matmul launches a period of internlm2-1.8b (168 / 24)


def plan_kernel_phase(timer: Timer, gen: torch.Generator, path: str = "plan",
                      at: str = "plan stage") -> None:
    """The plan path's kernels at the shapes it gives them that no other
    check covers: a stage runs one dp rank's micro-batch of 2 x 512, so
    ``quant_matmul`` at M = 1024 over the layer's (K, N), int8, and
    ``flash_attention`` at B·H = 2·16, S = 512. (The loss on stage 0 and
    the cached step run at T = 2048, the training phase's checked
    shape.) Each at the tolerance of its check at the training shapes.
    The distill path's teacher runs the same shapes (``path="distill"``)."""
    M = PLAN_MICRO_BATCH * 512
    for K, N in QMM_SHAPES:
        _, _, got, want = qmm_check(gen, M, K, N, 8)
        emit({"check": f"quant_matmul_{path}", "M": M, "K": K, "N": N, "bits": 8,
              "max_abs_err": max_err(got, want),
              "check_value": float(((got - want).abs() - 1e-4 * want.abs()).max()),
              "tol": "atol 1e-3 + rtol 1e-4", "tol_reason": qmm_tol_reason(M)})
    r = flash_case(timer, gen, PLAN_MICRO_BATCH, 16, 8, 512, 128, at)[0]
    emit(dict(r, check=f"flash_attention_{path}"))


def ragged_plan(cfg, workdir: Path):
    """The ragged plan, made by the port's planner: Alg. 1 over
    ``period_costs(cfg, "pac", 512, int8)`` and a pool of a Jetson Nano
    (low power), a TX2 (high) and a Nano (high), each holding
    ``PLAN_MEMORY_SHARE`` of the backbone's weights and adapter state,
    micro-batch 2, 2 micro-batches, at most 3 stages; saved as JSON.
    Returns (plan, its path, planner seconds)."""
    import dataclasses

    from repro_torch.core.planner import (JETSON_NANO_H, JETSON_NANO_L, JETSON_TX2_H,
                                          HybridParallelismPlanner, period_costs)

    t0 = time.perf_counter()
    pc = period_costs(cfg, "pac", seq_len=512, quant_bits=8)
    need = sum(c.param_bytes + 2 * c.trainable_bytes for c in pc)
    pool = [dataclasses.replace(d, memory_bytes=need * PLAN_MEMORY_SHARE)
            for d in (JETSON_NANO_L, JETSON_TX2_H, JETSON_NANO_H)]
    plan = HybridParallelismPlanner(pc, pool, PLAN_MICRO_BATCH, PLAN_N_MICRO).plan(max_stages=3)
    seconds = time.perf_counter() - t0
    path = workdir / "ragged_plan.json"
    plan.save(str(path))
    return plan, path, seconds


def plan_phase(single: dict, dist_ranks: list, workdir: Path):
    """Plan-driven training at full width. The port's planner makes the
    ragged plan (:func:`ragged_plan`; its boundaries must be the JAX
    planner's, ``PLAN_REF_BOUNDARIES``), saved to JSON; the calibrated
    cost model counts the full-width step on the meta device. Then the
    training phase's spec replays the plan (``plan=<file>, pool=3``):
    resolved once here (``resolve_layout``: dp=1 x 3 ragged stages) and
    run as 3 gloo ranks through ``EdgeSession``/``EpochRunner``, gated
    by :func:`check_parity` against the single-process run, each stage
    launching ``quant_matmul`` 7 x its periods x 2 micro-batches (and
    flash once a period and micro-batch) in epoch 1 and nothing in the
    cached epochs but on the owner. Last ``plan="auto", pool=4,
    micro=2``: Alg. 1 must pick (12, 12) on dp=2 x pp=2, and every
    step's loss and every rank's fingerprint must equal the distributed
    phase's first run bit for bit. Returns the launches of both runs,
    summed over the ranks."""
    from repro_torch.configs import get_arch
    from repro_torch.core.pipeline import simulate_plan
    from repro_torch.launch.costs import AnalyticCostModel, CalibratedCostModel
    from repro_torch.launch.mesh import spawn
    from repro_torch.runtime import RunSpec
    from repro_torch.runtime.session import resolve_layout

    t_phase = time.perf_counter()
    cfg = get_arch("internlm2-1.8b")
    plan, path, plan_s = ragged_plan(cfg, workdir)
    part = plan.stage_partition()
    sim = simulate_plan(plan)
    emit({"phase": "plan_made", "boundaries": list(part.boundaries),
          "reference_boundaries": list(PLAN_REF_BOUNDARIES),
          "samples_per_device": [list(x) for x in part.samples_per_device],
          "devices": [[d.name for d in st.devices] for st in plan.stages],
          "planner_s": plan_s, "describe": plan.describe().splitlines()})
    print("plan boundaries:", part.boundaries, flush=True)
    if part.boundaries != PLAN_REF_BOUNDARIES:
        raise AssertionError(f"ragged plan boundaries {part.boundaries}, the reference "
                             f"planner's {PLAN_REF_BOUNDARIES}")

    t0 = time.perf_counter()
    calibrated = CalibratedCostModel(micro_batch=PLAN_MICRO_BATCH, quant_bits=8).period_costs(
        cfg, "pac", seq_len=512)
    calibrate_s = time.perf_counter() - t0
    analytic = AnalyticCostModel(quant_bits=8).period_costs(cfg, "pac", seq_len=512)
    emit({"phase": "plan_calibration", "arch": cfg.name, "micro_batch": PLAN_MICRO_BATCH,
          "seq": 512, "counted_on": "meta device, ref OpSet (FlopCounterMode)",
          "period_fwd_flops": {"calibrated": calibrated[0].fwd_flops,
                               "analytic": analytic[0].fwd_flops},
          "period_bwd_flops": {"calibrated": calibrated[0].bwd_flops,
                               "analytic": analytic[0].bwd_flops},
          "fwd_ratio": calibrated[0].fwd_flops / analytic[0].fwd_flops,
          "seconds": calibrate_s})

    base = dict(arch="internlm2-1.8b", quant=8, cache_compress="int8", kernels="cuda",
                init="pruning", epochs=3, steps_per_epoch=2, batch=4, seq=512, seed=SEED)
    spec = RunSpec(**base, plan=str(path), pool=3)
    layout = resolve_layout(spec)
    if (layout.dp, layout.stages, layout.n_micro) != (1, 3, PLAN_N_MICRO):
        raise AssertionError(f"ragged replay resolved to dp={layout.dp} x {layout.stages} "
                             f"stages, {layout.n_micro} micro-batches")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(distributed_rank, layout.dp, layout.stages, "cuda",
                  args=(spec, 1, layout.to_json()), timeout=300.0, deadline=600.0)
    ragged_s = time.perf_counter() - t0
    line = {"phase": "plan", "arch": cfg.name, "plan": "saved ragged plan, replayed",
            "boundaries": list(part.boundaries),
            "rank_periods": {r["rank"]: list(r["runs"][0]["periods"]) for r in ranks},
            "dp": layout.dp, "stages": layout.stages, "n_micro": layout.n_micro,
            "pool": layout.pool, "ranks": len(ranks), "backend": "gloo",
            "batch": spec.batch, "seq": spec.seq, "quant": spec.quant,
            "cache": spec.cache_compress, "r": spec.r, **parity(ranks, single),
            **rank_stats(ranks), "run_s": ragged_s,
            "planner_estimate_jetson": {
                "note": "the planner's model of the Jetson pool, not a time on this card",
                "minibatch_latency_s": plan.minibatch_latency,
                "simulated_minibatch_s": sim["minibatch_time"],
                "simulated_bubble_fraction": sim["bubble_fraction"],
                "stage_time_s": [st.stage_time for st in plan.stages]},
            "tol": DIST_TOL,
            "tol_reason": DIST_TOL_REASON}
    first = [r["runs"][0] for r in ranks]
    launches = {k: sum(r["launches"][k] for r in first) for k in TRAINING_KERNELS}

    # --plan auto: Alg. 1 on 4 Nano profiles must give the distributed phase's mesh
    auto = RunSpec(**base, plan="auto", pool=4, micro=2)
    auto_layout = resolve_layout(auto)
    t0 = time.perf_counter()
    auto_ranks = spawn(distributed_rank, auto_layout.dp, auto_layout.stages, "cuda",
                       args=(auto, 1, auto_layout.to_json()), timeout=300.0, deadline=600.0)
    auto_s = time.perf_counter() - t0
    auto_first = [r["runs"][0] for r in auto_ranks]
    dist_first = [r["runs"][0] for r in dist_ranks]
    auto_losses = [st["loss"] for st in auto_first[0]["steps"]]
    line["auto"] = {"boundaries": list(auto_layout.partition.boundaries),
                    "dp": auto_layout.dp, "stages": auto_layout.stages,
                    "modes": auto_first[0]["modes"], "step_losses": auto_losses,
                    "distributed_step_losses": [st["loss"] for st in dist_first[0]["steps"]],
                    "losses_bit_equal_distributed": auto_losses == [
                        st["loss"] for st in dist_first[0]["steps"]],
                    "fingerprints_bit_equal_distributed": all(
                        [st["fingerprint"] for st in a["steps"]]
                        == [st["fingerprint"] for st in d["steps"]]
                        for a, d in zip(auto_first, dist_first)),
                    "run_s": auto_s,
                    "planner_estimate_jetson": {
                        "note": "the planner's model of 4 Jetson Nano (high power), not a "
                                "time on this card",
                        "minibatch_latency_s": auto_layout.plan.minibatch_latency,
                        "simulated_bubble_fraction":
                            simulate_plan(auto_layout.plan)["bubble_fraction"]}}
    auto_launches = {k: sum(r["launches"][k] for r in auto_first) for k in TRAINING_KERNELS}
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)

    check_parity(line, ["plan-driven dp1xpp3", "cached pure-dp", "cached pure-dp"])
    for r in ranks:
        a, b = r["runs"][0]["periods"]
        for st in r["runs"][0]["steps"]:
            got = st["launches"]
            if st["mode"].startswith("plan-driven"):
                want = {"quant_matmul": PROJECTIONS_PER_PERIOD * (b - a) * PLAN_N_MICRO,
                        "flash_attention": (b - a) * PLAN_N_MICRO}
                head = r["rank"] == 0
            else:
                want = {"quant_matmul": 0, "flash_attention": 0}
                head = r["rank"] == 0  # the cached rows shard over dp alone: the owner's
            loss_ok = (all(got[k] > 0 for k in TRAINING_KERNELS[2:]) if head
                       else all(got[k] == 0 for k in TRAINING_KERNELS[2:]))
            if any(got[k] != v for k, v in want.items()) or not loss_ok:
                raise AssertionError(f"rank {r['rank']} (periods [{a}, {b})) {st['mode']}: "
                                     f"launches {got}, wanted {want}")
    ragged_bounds = [r["runs"][0]["periods"] for r in ranks]
    if [list(p) for p in ragged_bounds] != [[part.boundaries[i], part.boundaries[i + 1]]
                                            for i in range(3)]:
        raise AssertionError(f"ranks ran periods {ragged_bounds}, the plan {part.boundaries}")
    want_auto = {"boundaries": [0, 12, 24], "dp": 2, "stages": 2,
                 "modes": ["plan-driven dp2xpp2", "cached pure-dp", "cached pure-dp"]}
    if any(line["auto"][k] != v for k, v in want_auto.items()):
        raise AssertionError(f"--plan auto: {line['auto']}, wanted {want_auto}")
    if not (line["auto"]["losses_bit_equal_distributed"]
            and line["auto"]["fingerprints_bit_equal_distributed"]):
        raise AssertionError("--plan auto differs from the distributed phase's run: "
                             f"{auto_losses} against {line['auto']['distributed_step_losses']}")
    return launches, auto_launches


# ---------------------------------------------------------------- fleet

FLEET_MEMBERS = 4
FLEET_KILL = (3, "dev1")  # tick, member: a tick inside the first cached epoch
#: launches a step of one job: (capture step, cached step of 4 chunks of one sequence)
FLEET_STEP_LAUNCHES = ({"quant_matmul": 168, "flash_attention": 24, "mix_fwd": 25, "mix_dw": 25,
                        "ce_fwd": 1, "ce_bwd": 1},
                       {"quant_matmul": 0, "flash_attention": 0, "mix_fwd": 100, "mix_dw": 100,
                        "ce_fwd": 4, "ce_bwd": 4})


def fleet_run(spec, names, members: int, events=None, quantum=None, snapshot_dir=None):
    """One ``FleetScheduler`` run of jobs ``names`` (job i on seed
    ``spec.seed + i``) over a bound pool of ``members`` members on the
    card (each slot past the card count maps to it: every member shares
    the one H100). Returns the run's record and its jobs, left open."""
    from repro_torch.checkpoint import tree_fingerprint
    from repro_torch.fleet import DeviceMember, DevicePool, FleetScheduler, SessionJob, SimClock
    from repro_torch.runtime import RunHooks

    steps, last = [], {}

    class Record(RunHooks):
        """Each step's loss, mode, wall time and launches (since the
        previous step of any job: jobs step one after another)."""

        def __init__(self, name):
            self.name = name

        def on_step(self, session, event):
            now = {k: v for k, v in read_launches().items() if k in TRAINING_KERNELS}
            prev = last.get("launches", dict.fromkeys(now, 0))
            last["launches"] = now
            steps.append({"job": self.name, "epoch": event.epoch, "index": event.index,
                          "loss": event.loss, "mode": event.mode, "wall_s": event.wall_s,
                          "launches": {k: now[k] - prev[k] for k in now}})

    pool = DevicePool([DeviceMember(f"dev{i}") for i in range(members)], clock=SimClock(),
                      heartbeat_timeout=1.5, bind_devices=True)
    sched = FleetScheduler(pool, events=events, quantum=quantum, snapshot_dir=snapshot_dir,
                           log=print)
    jobs = [SessionJob(name, spec.replace(seed=spec.seed + i), hooks=[Record(name)])
            for i, name in enumerate(names)]
    for job in jobs:
        sched.submit(job)
    reset_launches()
    t0 = time.perf_counter()
    report = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = {"members": members, "devices": sorted({str(pool.torch_device(m)) for m in pool.alive()}),
           "run_s": wall,
           "launches": {k: v for k, v in read_launches().items() if k in TRAINING_KERNELS},
           "ticks": [{"tick": r.tick, "placements": {k: list(v) for k, v in r.placements.items()},
                      "shares": {k: list(v) for k, v in r.shares.items()}, "lost": r.lost,
                      "preempted": r.preempted, "queued": r.queued} for r in report.ticks],
           "steps": steps,
           "jobs": {j.name: {"state": j.state, "losses": report.losses(j.name),
                             "fingerprint": tree_fingerprint(j.session.adapter),
                             "forward_steps": j.forward_steps, "cached_steps": j.cached_steps,
                             "reshards": j.reshards} for j in jobs}}
    return rec, jobs


def release(jobs: list) -> None:
    """Close finished jobs and drop them (the caller holds no other
    reference), so that the next run does not share the card with them."""
    for job in jobs:
        job.close()
    jobs.clear()


def fleet_phase(single: dict, workdir: Path) -> dict:
    """The fleet at full width: the training phase's spec (no checkpoint,
    no cache directory) as ``SessionJob``s under ``FleetScheduler`` on a
    ``SimClock``, every member on the one card. (a) ``alice`` alone on a
    bound pool of four; (b) the same with ``dev1`` killed at tick 3,
    inside the first cached epoch; (c) ``alice`` and ``bob`` (seed 1) on
    one member with quantum 2, preempted through snapshots on disk; (d)
    one elastic step of (a)'s first cached batch under the ``ref``
    kernels against ``cuda``. Gates: (b) and (c)'s ``alice`` equal (a)
    bit for bit (losses and adapter fingerprint); (a)'s capture steps
    equal the training phase's bit for bit, its cached steps within
    ``DIST_STEP_TOL`` and its epochs within 5e-2; (d) within the cached
    step's tolerances; (a)'s launches per step as
    ``FLEET_STEP_LAUNCHES``. Returns (a)'s launches."""
    from repro_torch.core.quantization import tree_leaves
    from repro_torch.fleet import ElasticDpRunner, FaultPlan, FleetEvent, ScriptedEvents
    from repro_torch.runtime import RunSpec

    spec = RunSpec(arch="internlm2-1.8b", quant=8, cache_compress="int8", kernels="cuda",
                   init="pruning", epochs=3, steps_per_epoch=2, batch=4, seq=512, seed=SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    free, (a_job,) = fleet_run(spec, ["alice"], FLEET_MEMBERS)
    kill_tick, kill_dev = FLEET_KILL
    killed, jobs = fleet_run(spec, ["alice"], FLEET_MEMBERS, events=ScriptedEvents(
        FaultPlan([FleetEvent(kill_tick, "kill", device=kill_dev)])))
    release(jobs)
    snaps = workdir / "fleet_snapshots"
    preempt, jobs = fleet_run(spec, ["alice", "bob"], 1, quantum=2, snapshot_dir=str(snaps))
    release(jobs)

    # (d) (a)'s first cached batch, the final adapter, one elastic step's
    # loss and gradients under both kernel sets
    s = a_job.session
    ids = s.pipe.epoch_order(1)[0]
    b0, taps, bf = s.cache.get_batch(ids, with_final=True, dtype=None, compressed=True)
    cached = {"b0": b0, "taps": taps, "b_final": bf,
              "labels": torch.from_numpy(s.corpus.batch(ids)["labels"]).to(s.device)}
    first = next(t for t in free["ticks"] if t["tick"] == spec.steps_per_epoch)
    placement = [(m, s.device, sh) for m, sh in zip(first["placements"]["alice"],
                                                    first["shares"]["alice"])]
    res = {}
    for impl, runner in (("cuda", a_job._elastic),
                         ("ref", ElasticDpRunner(s.backbone, s.cfg, r=spec.r, lr=spec.lr,
                                                 kernel_impl="ref", device=s.device))):
        runner.reshard([(m, d) for m, d, _ in placement])
        loss, grads = runner.loss_and_grads(s.adapter, cached, placement)
        res[impl] = (float(loss), tree_leaves(grads))
    gmax = max(float(g.abs().max()) for g in res["ref"][1])
    gerr = max(max_err(a, b) for a, b in zip(res["cuda"][1], res["ref"][1]))
    dloss = abs(res["cuda"][0] - res["ref"][0])
    ref_vs_cuda = {"placement": [[m, sh] for m, _, sh in placement],
                   "loss": [res["cuda"][0], res["ref"][0]], "abs_dloss": dloss,
                   "max_abs_dgrad": gerr, "grad_max": gmax}
    release([a_job])
    del a_job, s, res, cached, b0, taps, bf, runner, loss, grads
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase

    want = free["jobs"]["alice"]
    losses = want["losses"]
    n_cap = spec.steps_per_epoch
    epochs = [float(np.mean(losses[e * n_cap:(e + 1) * n_cap])) for e in range(spec.epochs)]
    lost_at = next((t["tick"] for t in killed["ticks"] if kill_dev in t["lost"]), None)
    alice_steps = [st for st in free["steps"] if st["job"] == "alice"]
    line = {"phase": "fleet", "arch": "internlm2-1.8b", "batch": spec.batch, "seq": spec.seq,
            "quant": spec.quant, "cache": spec.cache_compress, "r": spec.r, "chunk": 1,
            "clock": "SimClock", "heartbeat_timeout": 1.5,
            "note": "every member runs on the one card: placement and resharding are "
                    "exercised, transfers between cards are not",
            "runs": {"fault_free": free, "kill": killed, "preempt": preempt},
            "kill": {"tick": kill_tick, "device": kill_dev, "detected_at": lost_at},
            "step_losses": losses, "single_step_losses": single["step_losses"],
            "capture_bit_equal_single": losses[:n_cap] == single["step_losses"][:n_cap],
            "abs_dloss_steps": [abs(a - b) for a, b in zip(losses, single["step_losses"])],
            "epoch_losses": epochs, "single_epoch_losses": single["epoch_losses"],
            "abs_depoch": [abs(a - b) for a, b in zip(epochs, single["epoch_losses"])],
            "kill_bit_equal": (killed["jobs"]["alice"]["losses"] == losses
                               and killed["jobs"]["alice"]["fingerprint"] == want["fingerprint"]),
            "preempted_bit_equal": (preempt["jobs"]["alice"]["losses"] == losses
                                    and preempt["jobs"]["alice"]["fingerprint"]
                                    == want["fingerprint"]),
            "snapshot_on_disk": (snaps / "alice.ckpt").exists(),
            "launches_per_capture_step": [st["launches"] for st in alice_steps
                                          if "full" in st["mode"]],
            "launches_per_cached_step": [st["launches"] for st in alice_steps
                                         if st["mode"].startswith("elastic")],
            "ref_vs_cuda": ref_vs_cuda,
            "max_memory_allocated": peak, "phase_s": phase_s,
            "tol": {"cached_steps": DIST_STEP_TOL, "epoch": 5e-2, "loss": 2e-5,
                    "grads": 1e-4 * max(1.0, gmax)},
            "tol_reason": "capture steps run the training phase's EdgeSession.step (bit for "
                          "bit); a cached step sums the same tokens' CE and gradients a chunk "
                          "at a time (f32 reordered), as the distributed phase; ref vs cuda: "
                          "the cached_step_cuda_vs_ref tolerances"}
    emit(line)

    if not (free["jobs"]["alice"]["state"] == "done" and want["forward_steps"] == n_cap
            and want["cached_steps"] == n_cap * (spec.epochs - 1)):
        raise AssertionError(f"fault-free run: {want}")
    if not (line["capture_bit_equal_single"] and max(line["abs_dloss_steps"]) <= DIST_STEP_TOL
            and max(line["abs_depoch"]) <= 5e-2 and all(np.isfinite(losses))):
        raise AssertionError(f"fleet vs single process: steps {line['abs_dloss_steps']}, "
                             f"epochs {line['abs_depoch']}")
    k = killed["jobs"]["alice"]
    if not (line["kill_bit_equal"] and k["forward_steps"] == n_cap and k["reshards"] >= 1
            and lost_at is not None):
        raise AssertionError(f"kill run: {k}, detected at {lost_at}")
    late = [t for t in killed["ticks"] if t["tick"] >= lost_at
            and any(kill_dev in d for d in t["placements"].values())]
    if late:
        raise AssertionError(f"{kill_dev} placed after its loss was detected: {late}")
    p = preempt["jobs"]
    if not ("alice" in [n for t in preempt["ticks"] for n in t["preempted"]]
            and line["snapshot_on_disk"] and line["preempted_bit_equal"]
            and p["bob"]["state"] == "done" and p["bob"]["losses"] != losses):
        raise AssertionError(f"preemption run: {p}, snapshot {line['snapshot_on_disk']}")
    if not (dloss <= 2e-5 and gerr <= 1e-4 * max(1.0, gmax)):
        raise AssertionError(f"elastic step cuda vs ref: dloss {dloss}, dgrad {gerr}")
    want_steps = [FLEET_STEP_LAUNCHES[0]] * n_cap + [FLEET_STEP_LAUNCHES[1]] * (
        n_cap * (spec.epochs - 1))
    if [st["launches"] for st in alice_steps] != want_steps:
        raise AssertionError(f"launches per step {[st['launches'] for st in alice_steps]}")
    return free["launches"]


# ---------------------------------------------------------------- the backward through the pipeline

PG_STAGES, PG_MICRO = 4, 4  # (a): dp 1 x 4 stages of 6 periods, 4 micro-batches of 1 x 512
PG_LOSS_TOL, PG_GRAD_TOL = 1e-5, 1e-4  # the gradient's x max(1, |g|max)
PG_TOL_REASON = (
    "the pipeline sums the same tokens' CE and each slab's gradient over 4 micro-batches in "
    "micro order, the single process over the batch at once: the same f32 ops in another "
    "order, so 1e-5 on the loss and 1e-4·max(1, |g|max) on the gradients, the bounds of the "
    "distributed step's gate and of the cached step's gradients")


def _inflight_max(ops) -> int:
    n = top = 0
    for op in ops:
        n += 1 if op.kind == "F" else -1
        top = max(top, n)
    return top


def pipeline_grads_rank(cfg=None, device=None) -> dict:
    """One of the four ranks of the ``pipeline_grads`` phase (``cfg``:
    internlm2-1.8b by default; ``device``: this rank's card by default).

    (a) dp 1 x 4 stages: internlm2-1.8b as a dense f32 backbone from the
    seed under ``ref``, each rank's stage slab trained through
    ``pipeline_grads(steps.pipeline_lm_loss)`` on 4 x 512 tokens in 4
    micro-batches, held to the single-process autograd of the same CE,
    which each rank runs in turn on the whole backbone (drawn again from
    the seed) and keeps its stage's periods of. Two runs; the second is
    compared and its wall, bytes, trace and peak memory reported.
    (b) dp 2 x stages 2: PAC+ on the INT8 backbone under ``cuda`` with
    int8 taps through ``pipeline_grads(steps.pipeline_pac_loss,
    shared="world")`` against ``pipeline_pac_loss_and_grads`` on the same
    adapter and batch, with the kernels' launches counted around the
    ``pipeline_grads`` call alone."""
    import functools

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core import pipeline, steps
    from repro_torch.core.parallel_adapters import init_adapter
    from repro_torch.core.quantization import tree_leaves, tree_map
    from repro_torch.launch.mesh import EdgeMesh
    from repro_torch.models.backbone import backbone_logits, cross_entropy, init_backbone

    cfg = get_arch("internlm2-1.8b") if cfg is None else cfg
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    batch = {k: torch.randint(0, cfg.vocab, (BASELINE_B, BASELINE_S), generator=gen, device=dev,
                              dtype=torch.int32) for k in ("tokens", "labels")}

    def draw(bits=None):
        return init_backbone(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev,
                             quant_bits=bits)

    out = {"rank": rank}
    # (a) the backward across four real stages
    mesh = EdgeMesh(1, PG_STAGES, device=dev)
    full = draw()
    local = steps.stage_backbone(full, cfg, mesh, copy=True)
    del full
    torch.cuda.empty_cache()
    a, b = local["periods"]
    for turn in range(PG_STAGES):  # the single process's autograd, one rank at a time
        if turn == rank:
            full = draw()
            blocks = tree_leaves(tree_map(lambda t: t.requires_grad_(True), full["blocks"]))
            out["single_s"] = []
            for _ in range(2):  # the second one timed warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = cross_entropy(backbone_logits(full, cfg, batch), batch["labels"])
                grads = torch.autograd.grad(loss, blocks)
                torch.cuda.synchronize()
                out["single_s"].append(time.perf_counter() - t0)
            want_loss, want = float(loss.detach()), [g[a:b].clone() for g in grads]
            del full, blocks, loss, grads
            torch.cuda.empty_cache()
        dist.barrier()
    loss_fn = functools.partial(steps.pipeline_lm_loss, cfg=cfg, n_micro=PG_MICRO)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        fwd, trace = {}, []

        def counted(*args):
            value = loss_fn(*args)
            torch.cuda.synchronize()
            fwd.update(p2p=mesh.stats["p2p_bytes"], t=time.perf_counter(),
                       held=torch.cuda.memory_allocated())
            return value

        p0 = mesh.stats["p2p_bytes"]
        t0 = time.perf_counter()
        loss, grads = pipeline.pipeline_grads(counted, local["blocks"], local, batch, mesh,
                                              trace=trace)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runs.append({"wall_s": t1 - t0, "forward_s": fwd["t"] - t0, "backward_s": t1 - fwd["t"],
                     "fwd_p2p_bytes": fwd["p2p"] - p0,
                     "bwd_p2p_bytes": mesh.stats["p2p_bytes"] - fwd["p2p"],
                     "resident_before": resident, "held_after_forward": fwd["held"] - resident,
                     "max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "step_peak_bytes": torch.cuda.max_memory_allocated() - resident,
                     "trace": [[op.micro, op.kind] for op in trace],
                     "in_flight_max": _inflight_max(trace), "loss": float(loss)})
    g = tree_leaves(grads)
    gmax = max(float(w.abs().max()) for w in want)
    out["a"] = dict(runs[-1], first_run=runs[0], stage=mesh.stage, periods=[a, b],
                    in_flight_bound=PG_STAGES - mesh.stage, keeps=min(PG_STAGES - mesh.stage,
                                                                     PG_MICRO),
                    single_loss=want_loss, abs_dloss=abs(float(loss) - want_loss),
                    max_abs_dgrad=max(float((x - w).abs().max()) for x, w in zip(g, want)),
                    grad_max=gmax, runs_bit_equal=runs[0]["loss"] == runs[1]["loss"])
    mesh.close()
    del local, grads, g, want
    torch.cuda.empty_cache()

    # (b) PAC+ through pipeline_grads under cuda, dp 2 x stages 2
    mesh = EdgeMesh(2, 2, device=dev)
    full = draw(8)
    local = steps.stage_backbone(full, cfg, mesh, copy=True)
    del full
    torch.cuda.empty_cache()
    adapter = init_adapter(torch.Generator(device=dev).manual_seed(SEED + 1), cfg, 8, device=dev)
    kw = dict(cfg=cfg, n_micro=2, r=8, kernel_impl="cuda", tap_policy="int8")
    want_loss, want_g, _ = steps.pipeline_pac_loss_and_grads(local, adapter, batch, mesh=mesh,
                                                             **kw)
    p0 = mesh.stats["p2p_bytes"]
    with torch.no_grad():
        steps.pipeline_pac_loss(adapter, local, batch, mesh, **kw)
    fwd_bytes = mesh.stats["p2p_bytes"] - p0
    torch.cuda.synchronize()
    reset_launches()
    p0 = mesh.stats["p2p_bytes"]
    t0 = time.perf_counter()
    loss, grads = pipeline.pipeline_grads(functools.partial(steps.pipeline_pac_loss, **kw),
                                          adapter, local, batch, mesh, shared="world")
    torch.cuda.synchronize()
    out["b"] = {"wall_s": time.perf_counter() - t0, "stage": mesh.stage,
                "launches": {k: v for k, v in read_launches().items() if k in TRAINING_KERNELS},
                "p2p_bytes": mesh.stats["p2p_bytes"] - p0, "forward_p2p_bytes": fwd_bytes,
                "loss": float(loss),
                "loss_bit_equal": bool(torch.equal(loss.reshape(()), want_loss.reshape(()))),
                "grads_bit_equal": all(torch.equal(x, w) for x, w in
                                       zip(tree_leaves(grads), tree_leaves(want_g)))}
    mesh.close()
    return out


def pipeline_grads_phase() -> dict:
    """The backward through the pipeline on the card (``pipeline_grads``
    line): four gloo ranks sharing it run :func:`pipeline_grads_rank`.
    Gates: (a) each rank's loss within ``PG_LOSS_TOL`` and its slab's
    gradient within ``PG_GRAD_TOL``·max(1, |g|max) of the single
    process's; each rank ran its stage's ``build_1f1b_schedule`` ops with
    at most S − s graphs alive; each rank's backward sent as many bytes
    as its forward. (b) loss and gradients bit-equal to
    ``pipeline_pac_loss_and_grads``; the call's point-to-point bytes
    those of the loss's forward alone (nothing crosses back); each
    rank's launches those of a ``distributed`` epoch-1 step: 168
    ``quant_matmul`` and 24 flash, and on the stage-0 ranks 25 of each
    mix kernel and one of each CE kernel. Returns (b)'s launches summed
    over the ranks."""
    from repro_torch.core.pipeline import build_1f1b_schedule
    from repro_torch.launch.mesh import spawn

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(pipeline_grads_rank, 1, PG_STAGES, "cuda", timeout=300.0, deadline=600.0)
    line = {"phase": "pipeline_grads", "arch": "internlm2-1.8b", "card": card_line(),
            "batch": BASELINE_B, "seq": BASELINE_S, "phase_s": time.perf_counter() - t0,
            "a": {"layout": "dp 1 x stages 4, gloo, 4 ranks on one card", "opset": "ref",
                  "dtype": "f32", "n_micro": PG_MICRO, "ranks": [r["a"] for r in ranks],
                  "single_s": [r["single_s"] for r in ranks],
                  "tol": {"loss": PG_LOSS_TOL, "grads": f"{PG_GRAD_TOL}·max(1, |g|max)"},
                  "tol_reason": PG_TOL_REASON},
            "b": {"layout": "dp 2 x stages 2", "opset": "cuda", "taps": "int8", "n_micro": 2,
                  "ranks": [r["b"] for r in ranks]}}
    emit(line)
    sched = build_1f1b_schedule(PG_STAGES, PG_MICRO)
    for r in ranks:
        a = r["a"]
        if not (a["abs_dloss"] <= PG_LOSS_TOL
                and a["max_abs_dgrad"] <= PG_GRAD_TOL * max(1.0, a["grad_max"])):
            raise AssertionError(f"rank {r['rank']}: pipelined vs single process: dloss "
                                 f"{a['abs_dloss']}, dgrad {a['max_abs_dgrad']} (|g|max "
                                 f"{a['grad_max']})")
        if a["trace"] != [[op.micro, op.kind] for op in sched[a["stage"]]] or \
                a["in_flight_max"] > a["in_flight_bound"]:
            raise AssertionError(f"rank {r['rank']}: ran {a['trace']}, "
                                 f"{a['in_flight_max']} graphs alive")
        if a["bwd_p2p_bytes"] != a["fwd_p2p_bytes"] or a["fwd_p2p_bytes"] <= 0:
            raise AssertionError(f"rank {r['rank']}: backward bytes {a['bwd_p2p_bytes']}, "
                                 f"forward {a['fwd_p2p_bytes']}")
        b = r["b"]
        want = {"quant_matmul": 168, "flash_attention": 24, "mix_fwd": 0, "mix_dw": 0,
                "ce_fwd": 0, "ce_bwd": 0}
        if b["stage"] == 0:
            want.update(mix_fwd=25, mix_dw=25, ce_fwd=1, ce_bwd=1)
        if not (b["loss_bit_equal"] and b["grads_bit_equal"]
                and b["p2p_bytes"] == b["forward_p2p_bytes"] and b["launches"] == want):
            raise AssertionError(f"rank {r['rank']} PAC+ through pipeline_grads: {b}, "
                                 f"launches wanted {want}")
    return {k: sum(r["b"]["launches"][k] for r in ranks) for k in TRAINING_KERNELS}


# ---------------------------------------------------------------- personal serving

PERSONAL_D, PERSONAL_DA = 2048, 256  # internlm2-1.8b, r=8
#: the personal cell's prompt, greedy tokens (32 until the bf16 gemma2-2b slice) and cache
PROMPT_LEN, N_GREEDY, PERSONAL_MAX_LEN = 32, 16, 64


def personal_kernel_phase(timer: Timer, gen: torch.Generator):
    """``adapter_fuse`` against its plain version (f32 and bf16, λ in
    {0, 0.5, 1}) at the decode shapes T = 1 and 8, the training width
    T = 2048 (there also a bf16 b beside an f32 W and a, the bf16
    backbone's mix, whose output is f32), and ragged shapes on both paths (the split-K path at T = 1
    and 8 with a partial 32-row slice of d, a partial 128-column block
    and 32 or 47 slices; the tiled path at T = 100), each timed beside
    the plain version and ``torch.addmm``; ``quant_matmul`` at the decode step's M = 1; flash
    attention and ``quant_matmul`` at the 32-token prompt's shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.adapter_fuse import adapter_fuse
    from repro_torch.kernels.flash_attention import flash_attention

    dev, rows = DEV, {}
    reason = {torch.float32: "the reference's adapter_fuse tolerance (tests/test_kernels.py:68); "
                             "f32 sums reorder",
              torch.bfloat16: "bf16 output: the two f32 results may round to neighbouring bf16 "
                              "values, one step of 2^-7 relative at most; 1e-5 for the f32 "
                              "sums' reordering"}
    tol = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-5, 2.0 ** -7)}
    for T, d, da in ((1, PERSONAL_D, PERSONAL_DA), (8, PERSONAL_D, PERSONAL_DA),
                     (2048, PERSONAL_D, PERSONAL_DA), (1, 1000, 200), (8, 1500, 200),
                     (3, 2047, 130), (100, 1000, 200)):
        b32 = torch.randn(T, d, generator=gen, device=dev)
        w32 = torch.randn(d, da, generator=gen, device=dev) * d ** -0.5
        a32 = torch.randn(T, da, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            b, w, a = (t.to(dtype) for t in (b32, w32, a32))
            atol, rtol = tol[dtype]
            err = 0.0
            for lam_v in (0.0, 0.5, 1.0):
                lam = torch.tensor(lam_v, device=dev)
                got, want = adapter_fuse(b, w, a, lam), ref.adapter_fuse_ref(b, w, a, lam)
                if got.dtype != dtype or got.shape != (T, da):
                    raise AssertionError(f"adapter_fuse gave {got.dtype} {tuple(got.shape)}")
                check(f"adapter_fuse T={T} d={d} da={da} {dtype} lam={lam_v}",
                      float(((got - want).float().abs() - rtol * want.float().abs()).max()),
                      atol)
                err = max(err, max_err(got, want))
            lam = torch.tensor(0.5, device=dev)
            lam_host = float(lam)  # read once, outside the timing
            ws = [w] + [torch.randn(d, da, generator=gen, device=dev).to(dtype) * d ** -0.5
                        for _ in range(copies(w.numel() * w.element_size()) - 1)]
            esize = b.element_size()
            nbytes = T * d * esize + d * da * esize + 2 * T * da * esize + 4
            b_ms, b_by = bound(nbytes, 2.0 * T * d * da + 3.0 * T * da,
                               BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S)
            bounds = {}
            if T > 8:  # the tiled path: bf16 tensor cores, f32 operands split in three
                products = 6 if dtype == torch.float32 else 1
                b_ms, b_by = bound(nbytes, products * 2.0 * T * d * da + 3.0 * T * da,
                                   BF16_FLOP_PER_S)
                f32_ms, f32_by = bound(nbytes, 2.0 * T * d * da + 3.0 * T * da)
                bounds = {"bound_tc_ms": b_ms, "bound_tc_by": b_by, "bound_f32_ms": f32_ms,
                          "bound_f32_by": f32_by}
            r = {"check": "adapter_fuse", "T": T, "d": d, "da": da, "dtype": str(dtype),
                 "lambdas": [0.0, 0.5, 1.0], "max_abs_err": err,
                 "tol": f"atol {atol} + rtol {rtol}", "tol_reason": reason[dtype],
                 "ms": timer([lambda w_=w_: adapter_fuse(b, w_, a, lam) for w_ in ws]),
                 "plain_ms": timer([lambda w_=w_: ref.adapter_fuse_ref(b, w_, a, lam)
                                    for w_ in ws]),
                 "library_ms": timer([lambda w_=w_: torch.addmm(a, b, w_, beta=1.0 - lam_host,
                                                                alpha=lam_host) for w_ in ws]),
                 "library": "torch.addmm(a, b, W, beta=1-λ, alpha=λ), λ read on the host once",
                 "bound_ms": b_ms, "bound_by": b_by, **bounds,
                 "path": "split-K" if T <= 8 else "tiled"}
            emit(r)
            if (T, d, da) == (1, PERSONAL_D, PERSONAL_DA) and dtype == torch.float32:
                rows["adapter_fuse"] = _row(r, "one period's mix at decode, T=1, d=2048, "
                                               "d_a=256, f32 (PERF.md also lists T=2048)")
            del ws
        if d == PERSONAL_D:  # the bf16 backbone's mix: a bf16 tap, the f32 adapter, f32 out
            b, err = b32.to(torch.bfloat16), 0.0
            for lam_v in (0.0, 0.5, 1.0):
                lam = torch.tensor(lam_v, device=dev)
                got, want = adapter_fuse(b, w32, a32, lam), ref.adapter_fuse_ref(b, w32, a32, lam)
                if got.dtype != torch.float32 or got.shape != (T, da):
                    raise AssertionError(f"adapter_fuse gave {got.dtype} {tuple(got.shape)}")
                err = max(err, max_err(got, want))
                check(f"adapter_fuse T={T} d={d} da={da} b bf16, W and a f32 lam={lam_v}",
                      max_err(got, want), 1e-4)
            emit({"check": "adapter_fuse", "T": T, "d": d, "da": da,
                  "dtype": "b bf16, W and a f32, out f32", "lambdas": [0.0, 0.5, 1.0],
                  "max_abs_err": err, "tol": "atol 0.0001", "path": "split-K" if T <= 8
                  else "tiled", "tol_reason": reason[torch.float32] + "; the bf16 b is exact "
                                                                    "on the tensor cores"})
    qmm = {(1, K, N, 8): qmm_case(timer, gen, 1, K, N, 8) for K, N in QMM_SHAPES}
    emit({"check": "quant_matmul_layer", "M": 1, **layer_row(qmm, 1)})
    skinny_reruns(gen)
    # the prompt's shapes: 32 tokens, 16 heads over 8 KV heads
    for K, N in QMM_SHAPES:
        qmm_check(gen, PROMPT_LEN, K, N, 8)
    q = torch.randn(16, PROMPT_LEN, 128, generator=gen, device=dev)
    k, v = (torch.randn(8, PROMPT_LEN, 128, generator=gen, device=dev) for _ in range(2))
    err = max_err(flash_attention(q, k, v), ref.flash_attention_ref(q, k, v))
    check(f"flash_attention S={PROMPT_LEN}", err, 3e-5)
    emit({"check": "prompt_shapes", "quant_matmul_M": PROMPT_LEN, "flash_BH": 16,
          "flash_S": PROMPT_LEN, "flash_max_abs_err": err, "tol": "as above"})
    return rows


def skinny_reruns(gen: torch.Generator) -> None:
    """The decode path's GEMV (``adapter_fuse`` at T = 1, f32, and
    ``quant_matmul`` at M = 1, K = 8192, N = 2048): two eager calls
    bit-equal, and each call captured in a CUDA graph and replayed three
    times equal to the eager call bit for bit."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels.adapter_fuse import adapter_fuse
    from repro_torch.kernels.quant_matmul import quant_matmul

    b = torch.randn(1, PERSONAL_D, generator=gen, device=DEV)
    w = torch.randn(PERSONAL_D, PERSONAL_DA, generator=gen, device=DEV) * PERSONAL_D ** -0.5
    a = torch.randn(1, PERSONAL_DA, generator=gen, device=DEV)
    lam = torch.tensor(0.5, device=DEV)
    x = torch.randn(1, 8192, generator=gen, device=DEV)
    wq = quantize(torch.randn(8192, 2048, generator=gen, device=DEV) * 8192 ** -0.5, 8)
    calls = {"adapter_fuse": lambda: adapter_fuse(b, w, a, lam),
             "quant_matmul": lambda: quant_matmul(x, wq.q, wq.scale)}
    got = {}
    for name, fn in calls.items():
        eager = fn()
        again = fn()
        emit({"check": f"{name}_deterministic", "at": "T=1 d=2048 d_a=256 f32"
              if name == "adapter_fuse" else "M=1 K=8192 N=2048 int8",
              "bit_equal": bool(torch.equal(eager, again))})
        if not torch.equal(eager, again):
            raise AssertionError(f"{name}: two calls differ")
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = fn()
        replays = []
        for _ in range(3):
            static.zero_()
            graph.replay()
            torch.cuda.synchronize()
            replays.append(bool(torch.equal(static, eager)))
        got[name] = replays
        del graph
    ok = all(all(v) for v in got.values())
    emit({"check": "skinny_graph_replay", "replays_equal_eager": got, "bit_equal": ok})
    if not ok:
        raise AssertionError(f"skinny GEMV: graph replays differ from eager: {got}")


def personal_phase(backbone, cfg, ckpt: Path, walls: dict, r: int = 8):
    """Serve the trained adapter, loaded from its checkpoint, with the
    reference's one-request loop: ``pac_decode_step`` at B=1 over an
    INT8 linear KV cache, ``PROMPT_LEN`` teacher-forced prompt tokens then
    ``N_GREEDY`` greedy tokens, under ``cuda`` (launches counted) and then ``ref``. Then
    ``prefill_step`` against the teacher-forced f32-cache decode, and
    the INT8-KV decode against the f32-KV one. Last, where the gap
    between the OpSets arises: the same loop over an f32 linear KV cache
    under both, each step's largest gap, and how many INT8 KV codes the
    two INT8 runs wrote differently."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.parallel_adapters import init_adapter_cache
    from repro_torch.core.steps import decode_step, pac_decode_step, prefill_step
    from repro_torch.models.backbone import init_cache

    dev = DEV
    adapter = load_checkpoint(str(ckpt), device=dev)["adapter"]
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, PROMPT_LEN)).astype(np.int32))
    prompt = prompt.to(dev)
    n_steps = PROMPT_LEN + N_GREEDY - 1  # the last step's logits give the last greedy token

    def serve(impl, steps=n_steps, kv_quant=8):
        cache = init_cache(cfg, 1, PERSONAL_MAX_LEN, device=dev, kv_quant=kv_quant)
        acache = init_adapter_cache(cfg, 1, PERSONAL_MAX_LEN, r, device=dev)
        logits, greedy = [], []
        tok = prompt[:, :1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in range(steps):
            lg, cache, acache = pac_decode_step(
                backbone, adapter, {"tokens": tok}, cache, acache,
                torch.full((1,), p, dtype=torch.long, device=dev), cfg=cfg, r=r,
                kernel_impl=impl)
            logits.append(lg[:, 0])
            if p >= PROMPT_LEN - 1:
                greedy.append(lg[:, 0].argmax(-1))
            tok = prompt[:, p + 1:p + 2] if p + 1 < PROMPT_LEN else greedy[-1][:, None].int()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = [int(t) for t in torch.cat(greedy)] if greedy else []
        return torch.cat(logits), tokens, wall, cache

    serve("cuda", steps=2)  # warm-up: first launches, allocator growth
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    logits_cuda, tokens_cuda, wall, cache_cuda = serve("cuda")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "personal_profile", "steps": 2, "from": "an empty cache",
          **device_profile(lambda: serve("cuda", steps=2), watch=SKINNY_WATCH)})
    logits_ref, tokens_ref, wall_ref, cache_ref = serve("ref")
    dlogits = max_err(logits_cuda, logits_ref)
    logits_cuda32, tokens_cuda32, _, _ = serve("cuda", kv_quant=None)
    logits_ref32, tokens_ref32, _, _ = serve("ref", kv_quant=None)
    dlogits32 = max_err(logits_cuda32, logits_ref32)
    codes = [(cc[k].int() - cr[k].int()).abs()[:, :, :n_steps]
             for cc, cr in zip(cache_cuda, cache_ref) for k in ("k", "v")]
    emit({"phase": "personal_gap", "steps": n_steps,
          "max_abs_dlogits_int8_kv": dlogits, "max_abs_dlogits_f32_kv": dlogits32,
          "tokens_equal_f32_kv": tokens_cuda32 == tokens_ref32,
          "kv_codes_differing": sum(int((c != 0).sum()) for c in codes),
          "kv_codes_written": sum(c.numel() for c in codes),
          "kv_code_max_step": max(int(c.max()) for c in codes),
          "per_step_int8_kv": (logits_cuda - logits_ref).abs().amax(-1).tolist(),
          "per_step_f32_kv": (logits_cuda32 - logits_ref32).abs().amax(-1).tolist()})

    def teacher_forced(kv_quant):
        cache = init_cache(cfg, 1, PROMPT_LEN, device=dev, kv_quant=kv_quant)
        for p in range(PROMPT_LEN):
            lg, cache = decode_step(backbone, {"tokens": prompt[:, p:p + 1]}, cache,
                                    torch.full((1,), p, dtype=torch.long, device=dev), cfg=cfg,
                                    kernel_impl="cuda")
        return lg

    pre = prefill_step(backbone, {"tokens": prompt}, cfg=cfg, kernel_impl="cuda")
    dec32, dec8 = teacher_forced(None), teacher_forced(8)
    rel_prefill = max_err(dec32, pre) / float(pre.abs().max())
    rel_kv = max_err(dec8, dec32) / float(dec32.abs().max())
    per_step = {k: v / n_steps for k, v in launches.items()}
    walls["personal"] = {"s": wall / n_steps, "steps": n_steps, "max_len": PERSONAL_MAX_LEN,
                         "r": r, "kv": 8}
    finite = bool(torch.isfinite(logits_cuda).all() and torch.isfinite(logits_ref).all())
    tol = {"dlogits": 2e-2, "dlogits_f32_kv": 2e-4, "prefill_rel": 2e-3, "int8_kv_rel": 5e-2}
    emit({"phase": "personal", "arch": cfg.name, "batch": 1, "prompt_tokens": PROMPT_LEN,
          "greedy_tokens": N_GREEDY, "max_len": PERSONAL_MAX_LEN, "kv": "int8 linear",
          "adapter": f"{ckpt.name}, r={r}", "steps": n_steps,
          "decode_ms_per_step": wall * 1e3 / n_steps,
          "ref_decode_ms_per_step": wall_ref * 1e3 / n_steps,
          "max_memory_allocated": peak, "launches": launches, "launches_per_step": per_step,
          "tokens_cuda": tokens_cuda, "tokens_equal": tokens_cuda == tokens_ref,
          "max_abs_dlogits": dlogits, "max_abs_dlogits_f32_kv": dlogits32,
          "prefill_vs_decode_rel": rel_prefill,
          "int8_vs_f32_kv_rel": rel_kv, "finite": finite, "logits_shape": list(pre.shape),
          "tol": tol,
          "tol_reason": "serving gate (PERF.md section 2) over the int8 KV, whose one-step code "
                        "flips carry the f32 sums' reordering forward; over the f32 KV the "
                        "reference's decode-parity ceiling (tests/test_decode_parity.py:36); "
                        "prefill vs decode and int8 vs f32 KV are the reference's bounds "
                        "(tests/test_backbone_smoke.py:123, :152)"})
    if (tokens_cuda != tokens_ref or tokens_cuda32 != tokens_ref32 or not finite
            or dlogits > tol["dlogits"] or dlogits32 > tol["dlogits_f32_kv"]):
        raise AssertionError(f"cuda vs ref: tokens equal {tokens_cuda == tokens_ref} (int8 KV), "
                             f"{tokens_cuda32 == tokens_ref32} (f32 KV), |dlogits| {dlogits} "
                             f"(int8 KV), {dlogits32} (f32 KV), finite {finite}")
    if rel_prefill > tol["prefill_rel"] or rel_kv > tol["int8_kv_rel"]:
        raise AssertionError(f"prefill vs decode {rel_prefill}, int8 vs f32 KV {rel_kv}")
    if per_step["adapter_fuse"] != cfg.n_periods or per_step["quant_matmul"] != 7 * cfg.n_layers:
        raise AssertionError(f"launches per decode step: {per_step}")
    return launches


# ---------------------------------------------------------------- the other dense configs

GEMMA2 = "gemma2-2b"
#: gemma2-2b's seven projections of one layer, by (K, N): q, k, v, o, wi, wg, wo
GEMMA2_PROJECTIONS = [(2304, 2048), (2304, 1024), (2304, 1024), (2048, 2304),
                      (2304, 9216), (2304, 9216), (9216, 2304)]
GEMMA2_T, GEMMA2_D, GEMMA2_DA, GEMMA2_V = 4 * 512, 2304, 288, 256000  # r = 8, B = 4, S = 512
GEMMA2_LONG_PROMPT = 4500   # past the 4096 window of the local layers
#: the engine pads a prompt to a power of two (8192 for the long one), and
#: the adapter's prefill takes at most max_len positions
GEMMA2_MAX_LEN = 8192
PAPER_MODELS = ("t5-base-pac", "bart-large-pac", "t5-large-pac")
#: the paged kernel at head width 256, B, Hkv, n_rep, hd, page, max_pages, lengths, padding rows
HD256_PAGED_RAGGED = [
    (1, 1, 2, 256, 16, 34, [543], ()),
    (3, 4, 2, 256, 16, 34, [0, 16, 543], (0,)),
    (8, 4, 2, 256, 4, 136, [3, 4, 5, 127, 128, 300, 542, 543], ()),
    (3, 1, 8, 256, 4, 136, [0, 3, 543], (0,)),
    (72, 4, 2, 256, 16, 34, list(np.random.default_rng(SEED + 3).integers(0, 544, size=72)), (5,)),
]


def hd256_kernel_phase(timer: Timer, gen: torch.Generator) -> dict:
    """Flash and paged attention at gemma2-2b's head width 256 against
    their plain versions, the shapes its paths give them: flash at the
    prefill's B·H = 8·8 over 4 kv heads and the epoch-1 step's 4·8 (S =
    512, causal; timed beside both bounds and SDPA; soft-cap 50, and
    window 128 with it, checked), two calls bit-equal, the ragged and
    keyless cases at hd 256, and granite-20b's MQA (B·H = 1·48 over one kv
    head, hd 128); paged attention at B = 8, Hkv = 4, n_rep = 2, int8
    pages of 16 (lengths <= 511 and <= 4095, timed beside its byte bound,
    the plain version and SDPA on gathered KV), the ragged cases at hd 256
    (window 64 with soft-cap 30 among them) and bit-equal reruns and
    graph replays. Returns the flash and paged rows' ``hd256`` entries."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms",
            "bound_f32_ms", "library_ms", "at")
    r, (q, k, v), sdpa = flash_case(timer, gen, 8, 8, 4, 512, 256, "gemma2 prefill")
    r["library_kernels"] = device_kernels(sdpa)
    for label, kw in (("cap50", dict(attn_softcap=50.0)),
                      ("window128_cap50", dict(window=128, attn_softcap=50.0))):
        r[f"max_abs_err_{label}"] = max_err(flash_attention(q, k, v, **kw),
                                            ref.flash_attention_ref(q, k, v, **kw))
        check(f"flash_attention hd=256 {label}", r[f"max_abs_err_{label}"], FLASH_TOL)
    emit(r)
    got, again = (flash_attention(q, k, v, attn_softcap=50.0) for _ in range(2))
    equal = bool(torch.equal(got, again))
    emit({"check": "flash_attention_deterministic", "BH": 64, "BHkv": 32, "S": 512, "hd": 256,
          "softcap": 50.0, "bit_equal": equal})
    if not equal:
        raise AssertionError("flash_attention: two calls at gemma2's prefill shape differ")
    del q, k, v, got, again, sdpa
    flash = {k_: r[k_] for k_ in keys}
    train = flash_case(timer, gen, 4, 8, 4, 512, 256, "gemma2 training")[0]
    emit(train)
    flash["training"] = {k_: train[k_] for k_ in keys}
    granite = flash_case(timer, gen, 1, 48, 1, 512, 128, "granite-20b MQA")[0]
    emit(granite)
    flash["granite_mqa"] = {k_: granite[k_] for k_ in keys}
    flash_ragged(gen, hds=(256,))
    flash_keyless(gen, hds=(256,))

    pkeys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at", "plan")
    lengths = np.random.default_rng(SEED).integers(1, 512, size=8).astype(np.int32)
    paged = {k_: v_ for k_, v_ in paged_timed(
        timer, gen, lengths, 32, "decode B=8 Hkv=4 n_rep=2 hd=256 page=16 int8, lengths<=511",
        Hkv=4, n_rep=2, hd=256).items() if k_ in pkeys}
    long_lengths = np.random.default_rng(SEED + 2).integers(1, 4096, size=8).astype(np.int32)
    long = paged_timed(timer, gen, long_lengths, 256, "long context B=8 Hkv=4 n_rep=2 hd=256 "
                       "page=16 int8, lengths<=4095", Hkv=4, n_rep=2, hd=256)
    paged["long"] = {k_: long[k_] for k_ in pkeys}
    paged_ragged(gen, HD256_PAGED_RAGGED)
    paged_deterministic(gen, lengths, 32, Hkv=4, n_rep=2, hd=256)
    return {"flash_attention": flash, "paged_attention": paged}


#: the paged kernel at head width 112 (kimi-k2): B, Hkv, n_rep, hd, page, max_pages, lengths,
#: padding rows
HD112_PAGED_RAGGED = [
    (1, 1, 8, 112, 16, 34, [543], ()),
    (3, 8, 8, 112, 16, 34, [0, 16, 543], (0,)),
    (8, 2, 4, 112, 4, 136, [3, 4, 5, 127, 128, 300, 542, 543], ()),
    (3, 1, 8, 112, 4, 136, [0, 3, 543], (0,)),
    (72, 8, 2, 112, 16, 34, list(np.random.default_rng(SEED + 4).integers(0, 544, size=72)), (5,)),
]
KIMI = "kimi-k2-1t-a32b"


def hd112_kernel_phase(timer: Timer, gen: torch.Generator) -> dict:
    """Flash and paged attention at kimi-k2's head width 112 against their
    plain versions: flash at kimi's layout, B·H = 4·64 over 8 kv heads a
    sequence (n_rep 8), S = 512, causal (timed beside both bounds and
    SDPA; soft-cap 30, and window 128 with it, checked), two calls
    bit-equal, the ragged and keyless cases at hd 112; paged attention at
    B = 8, Hkv = 8, n_rep = 8, int8 pages of 16 (lengths <= 511 and
    <= 4095, timed beside its byte bound, the plain version and SDPA on
    gathered KV), the ragged cases at hd 112 (f32, bf16 and int8 pages;
    window 64 with soft-cap 30 among them) and bit-equal reruns and graph
    replays. Returns the flash and paged rows' ``hd112`` entries."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms",
            "bound_f32_ms", "library_ms", "at")
    r, (q, k, v), sdpa = flash_case(timer, gen, 4, 64, 8, 512, 112, "kimi-k2 prefill")
    r["library_kernels"] = device_kernels(sdpa)
    for label, kw in (("cap30", dict(attn_softcap=30.0)),
                      ("window128_cap30", dict(window=128, attn_softcap=30.0))):
        r[f"max_abs_err_{label}"] = max_err(flash_attention(q, k, v, **kw),
                                            ref.flash_attention_ref(q, k, v, **kw))
        check(f"flash_attention hd=112 {label}", r[f"max_abs_err_{label}"], FLASH_TOL)
    emit(r)
    got, again = (flash_attention(q, k, v) for _ in range(2))
    equal = bool(torch.equal(got, again))
    emit({"check": "flash_attention_deterministic", "BH": 256, "BHkv": 32, "S": 512, "hd": 112,
          "bit_equal": equal})
    if not equal:
        raise AssertionError("flash_attention: two calls at kimi-k2's layout differ")
    del q, k, v, got, again, sdpa
    flash = {k_: r[k_] for k_ in keys}
    flash_ragged(gen, hds=(112,))
    flash_keyless(gen, hds=(112,))

    pkeys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at", "plan")
    lengths = np.random.default_rng(SEED).integers(1, 512, size=8).astype(np.int32)
    paged = {k_: v_ for k_, v_ in paged_timed(
        timer, gen, lengths, 32, "decode B=8 Hkv=8 n_rep=8 hd=112 page=16 int8, lengths<=511",
        Hkv=8, n_rep=8, hd=112).items() if k_ in pkeys}
    long_lengths = np.random.default_rng(SEED + 2).integers(1, 4096, size=8).astype(np.int32)
    long = paged_timed(timer, gen, long_lengths, 256, "long context B=8 Hkv=8 n_rep=8 hd=112 "
                       "page=16 int8, lengths<=4095", Hkv=8, n_rep=8, hd=112)
    paged["long"] = {k_: long[k_] for k_ in pkeys}
    paged_ragged(gen, HD112_PAGED_RAGGED)
    paged_deterministic(gen, lengths, 32, Hkv=8, n_rep=8, hd=112)
    return {"flash_attention": flash, "paged_attention": paged}


MIXTRAL = "mixtral-8x7b"
MOE_DENSE_TOL = 1e-4  # moe_forward at capacity factor E against moe_forward_dense


def moe_layer_phase(gen: torch.Generator) -> dict:
    """One mixtral-8x7b MoE FFN at full width (d 4096, 8 experts of d_e
    14336, top-2), experts drawn f32 and quantized INT8 one leaf at a time,
    then dequantized as the OpSets do, on T = 4 x 512 tokens at the
    config's capacity factor 1.25: two calls bit-equal, the
    share of dropped routes, the layer's device time beside the
    dequantization's; at capacity factor E (nothing drops) within 1e-4 of
    ``moe_forward_dense``. No kernel: the reference computes its MoE
    outside any Pallas kernel, and so does the port."""
    from repro_torch.configs import get_arch
    from repro_torch.core.quantization import maybe_dequantize_tree, quantize
    from repro_torch.models.moe import moe_forward, moe_forward_dense, record_routes

    cfg = get_arch(MIXTRAL)
    spec, d, de, E = cfg.moe, cfg.d_model, cfg.moe.d_expert, cfg.moe.n_experts
    torch.cuda.reset_peak_memory_stats()
    qp = {"router": torch.randn(d, E, generator=gen, device=DEV) * d ** -0.5}
    for name, shape, std in (("wi", (E, d, de), d ** -0.5), ("wg", (E, d, de), d ** -0.5),
                             ("wo", (E, de, d), de ** -0.5)):
        qp[name] = quantize(torch.randn(shape, generator=gen, device=DEV) * std, 8)
    # tokens share a common direction, as a layer's hidden states do, so
    # the router favours some experts and the capacity drops tokens (on
    # independent Gaussian tokens the eight loads stay under it)
    common = torch.randn(d, generator=gen, device=DEV)
    x = torch.randn(4, 512, d, generator=gen, device=DEV) + common

    def dense():
        return maybe_dequantize_tree(qp)

    def timed(fn, n=3):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n, out

    p = dense()
    with record_routes() as routes:
        out, aux = moe_forward(p, x, spec, return_aux=True)
        again = moe_forward(p, x, spec)
    equal = bool(torch.equal(out, again))
    first, second = routes
    routes_equal = all(torch.equal(first[k], second[k]) for k in first)
    dequant_ms, _ = timed(dense)
    layer_ms, _ = timed(lambda: moe_forward(p, x, spec))
    nodrop = moe_forward(p, x, spec, capacity_factor=float(E))
    want = moe_forward_dense(p, x, spec)
    err = max_err(nodrop, want)
    C = -(-max(1, int(spec.top_k * x.shape[0] * x.shape[1] * spec.capacity_factor / E)) // 8) * 8
    flops = 3 * 2.0 * E * min(C, 2048) * d * de
    line = {"phase": "moe_layer", "arch": cfg.name, "d": d, "d_expert": de, "experts": E,
            "top_k": spec.top_k, "T": x.shape[0] * x.shape[1],
            "capacity_factor": spec.capacity_factor, "capacity": min(C, 2048),
            "dropped_frac": float(aux["dropped_frac"]),
            "load_balance": float(aux["load_balance"]), "router_z": float(aux["router_z"]),
            "bit_equal": equal, "routes_bit_equal": routes_equal,
            "layer_ms": layer_ms, "dequantize_ms": dequant_ms,
            "expert_gemm_tflop": flops / 1e12,
            "f32_bound_ms": bound(0.0, flops)[0],
            "no_drop_vs_dense_max_abs_err": err, "tol": MOE_DENSE_TOL,
            "tol_reason": "the same f32 products summed in another order: the dense "
                          "reference contracts over all experts with zero weights",
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(line)
    if not (equal and routes_equal and err <= MOE_DENSE_TOL and line["dropped_frac"] > 0.0
            and bool(torch.isfinite(out).all())):
        raise AssertionError(f"moe layer: {line}")
    return line


def gemma2_kernel_phase(timer: Timer, gen: torch.Generator, arch: str = GEMMA2,
                        projections=None, d: int = GEMMA2_D, da: int = GEMMA2_DA,
                        V: int = GEMMA2_V, cap=30.0, T: int = GEMMA2_T, Ms=(8, 4096)) -> dict:
    """The other kernels at gemma2-2b's widths (or ``arch``'s, given its
    projections, d, d_a, V and final soft-cap), against their plain
    versions and timed: ``quant_matmul`` over one layer's seven
    projections (K = 2304 and 9216) at the prefill's M = 4096 and the
    decode step's M = 8 (``quant_matmul_layer`` lines); ``mix_fwd`` and
    ``mix_dw`` at T = 4·512, d = 2304, d_a = 288 over an int8 entry;
    ``ce_fwd`` and ``ce_bwd`` at T = 4·512, d = 2304 and the 256000-token
    vocabulary with the final soft-cap 30; ``adapter_fuse`` at T = 1 and
    8. Returns each kernel's ``gemma2`` entry. Empty ``projections``: no
    ``quant_matmul`` (a path whose projections run dense); ``T``: the
    training kernels' tokens; ``Ms``: the rows ``quant_matmul`` is checked
    and timed at."""
    from repro_torch.core.quantization import dequantize, quantize
    from repro_torch.kernels import cached_mix, lmhead_ce, ref
    from repro_torch.kernels.adapter_fuse import adapter_fuse

    dev, rows = DEV, {}
    projections = GEMMA2_PROJECTIONS if projections is None else projections
    qmm = {}
    for M in Ms if projections else ():
        for K, N in sorted(set(projections)):
            qmm[(M, K, N)] = qmm_case(timer, gen, M, K, N, 8)
        layer = {key: sum(qmm[(M, K, N)][key] for K, N in projections)
                 for key in ("ms", "plain_ms", "bound_ms", "library_ms")
                 + (("bound_tc_ms", "bound_f32_ms") if M > QMM_SKINNY_ROWS else ())}
        layer.update(at=f"{arch}'s {len(projections)} projections of one layer at M={M}, int8 "
                        "(times summed)",
                     max_abs_err=max(qmm[(M, K, N)]["max_abs_err"] for K, N in projections),
                     bound_by=qmm[(M,) + max(projections, key=lambda kn: kn[0] * kn[1])][
                         "bound_by"])
        emit({"check": "quant_matmul_layer", "arch": arch, "M": M, **layer})
        rows.setdefault("quant_matmul", {})[f"M{M}"] = layer

    ents = [quantize(torch.randn(T, d, generator=gen, device=dev), 8, 128)
            for _ in range(copies(T * d))]
    w = torch.randn(d, da, generator=gen, device=dev) * d ** -0.5
    a = torch.randn(T, da, generator=gen, device=dev)
    g = torch.randn(T, da, generator=gen, device=dev)
    lam = torch.tensor(0.7, device=dev)
    out, bw = cached_mix.mix_fwd(ents[0], w, a, lam)
    want_out, want_bw = ref.mix_fwd_ref(ents[0], w, a, lam)
    check(f"mix_fwd {arch}", mix_fwd_check(out, bw, want_out, want_bw), 1e-4)
    dw, want_dw = cached_mix.mix_dw(ents[0], g, lam, d), ref.mix_dw_ref(ents[0], g, lam, d)
    check(f"mix_dw {arch}", float(((dw - want_dw).abs() - 1e-3 * want_dw.abs()).max()), 2e-4)
    ent_bytes = T * d + T * (d // 128) * 4
    deq = [dequantize(e) for e in ents[:2]]
    for name, nbytes, fn, plain, lib, err in (
            ("mix_fwd", ent_bytes + 4 * (d * da + 3 * T * da),
             lambda e: cached_mix.mix_fwd(e, w, a, lam), lambda e: ref.mix_fwd_ref(e, w, a, lam),
             [lambda e=e: torch.matmul(dequantize(e), w) for e in ents],
             max(max_err(out, want_out), max_err(bw, want_bw))),
            ("mix_dw", ent_bytes + 4 * (T * da + d * da),
             lambda e: cached_mix.mix_dw(e, g, lam, d), lambda e: ref.mix_dw_ref(e, g, lam, d),
             [lambda x=x: torch.matmul(x.T, g) for x in deq], max_err(dw, want_dw))):
        b_ms, b_by = bound(nbytes, 3 * 2.0 * T * d * da, flop_per_s=BF16_FLOP_PER_S)
        f32_ms, _ = bound(nbytes, 2.0 * T * d * da)
        r = {"check": name, "arch": arch, "storage": "int8", "T": T, "d": d, "da": da,
             "max_abs_err": err, "ms": timer([lambda e=e: fn(e) for e in ents]),
             "plain_ms": timer([lambda e=e: plain(e) for e in ents]), "library_ms": timer(lib),
             "bound_ms": b_ms, "bound_by": b_by, "bound_tc_ms": b_ms, "bound_f32_ms": f32_ms}
        emit(r)
        rows[name] = _row(r, f"one period, T={T}, d={d}, d_a={da}, int8 entry")
    del ents, deq, out, bw, want_out, want_bw, dw, want_dw

    h = torch.randn(T, d, generator=gen, device=dev)
    w = torch.randn(d, V, generator=gen, device=dev) * d ** -0.5
    lab = torch.randint(0, V, (T,), generator=gen, device=dev)
    g = torch.randn(T, generator=gen, device=dev)
    nll, lse = lmhead_ce.ce_fwd(h, w, lab, cap)
    want_nll, want_lse = ref.ce_fwd_ref(h, w, lab, cap)
    check(f"ce_fwd {arch}", max(float(((nll - want_nll).abs() - 1e-5 * want_nll.abs()).max()),
                               float(((lse - want_lse).abs() - 1e-5 * want_lse.abs()).max())), 2e-5)
    dh = lmhead_ce.ce_bwd(h, w, lab, want_lse, g, cap)
    want_dh = ref.ce_bwd_ref(h, w, lab, want_lse, g, cap)
    check(f"ce_bwd {arch}", float(((dh - want_dh).abs() - 1e-4 * want_dh.abs()).max()), 1e-5)
    errs = {"ce_fwd": max(max_err(nll, want_nll), max_err(lse, want_lse)),
            "ce_bwd": max_err(dh, want_dh)}
    del nll, want_nll, dh, want_dh
    hr = h.clone().requires_grad_()

    def softcapped(x):
        return x if cap is None else cap * torch.tanh(x / cap)

    def library_bwd():
        logits = softcapped(torch.matmul(hr, w))
        return torch.autograd.grad(torch.nn.functional.cross_entropy(
            logits, lab.long(), reduction="sum"), hr)

    for name, products, nbytes, fn, plain, lib, library in (
            ("ce_fwd", 6, 4.0 * (T * d + d * V + 3 * T), lambda: lmhead_ce.ce_fwd(h, w, lab, cap),
             lambda: ref.ce_fwd_ref(h, w, lab, cap),
             lambda: torch.logsumexp(softcapped(torch.matmul(h, w)), dim=-1),
             "torch.matmul, the soft-cap, torch.logsumexp"),
            ("ce_bwd", 12, 4.0 * (2 * T * d + d * V + 4 * T),
             lambda: lmhead_ce.ce_bwd(h, w, lab, want_lse, g, cap),
             lambda: ref.ce_bwd_ref(h, w, lab, want_lse, g, cap), library_bwd,
             "autograd of F.cross_entropy(softcap(h @ W)) (its forward included)")):
        b_ms, b_by = bound(nbytes, products * 2.0 * T * d * V, flop_per_s=BF16_FLOP_PER_S)
        f32_ms, _ = bound(nbytes, products / 6 * 2.0 * T * d * V)  # 6 products a GEMM
        r = {"check": name, "arch": arch, "T": T, "d": d, "V": V, "softcap": cap,
             "max_abs_err": errs[name], "ms": timer(fn, calls=2, repeats=3),
             "plain_ms": timer(plain, calls=2, repeats=3),
             "library_ms": timer(lib, calls=2, repeats=3), "library": library,
             "bound_ms": b_ms, "bound_by": b_by, "bound_tc_ms": b_ms, "bound_f32_ms": f32_ms}
        emit(r)
        rows[name] = _row(r, f"LM-head CE, T={T}, d={d}, V={V}, soft-cap {cap}")
    del h, w, hr, lse, want_lse

    for T in (1, 8):
        b = torch.randn(T, d, generator=gen, device=dev)
        w = torch.randn(d, da, generator=gen, device=dev) * d ** -0.5
        a = torch.randn(T, da, generator=gen, device=dev)
        lam = torch.tensor(0.5, device=dev)
        got, want = adapter_fuse(b, w, a, lam), ref.adapter_fuse_ref(b, w, a, lam)
        check(f"adapter_fuse {arch} T={T}", max_err(got, want), 1e-4)
        ws = [w] + [torch.randn(d, da, generator=gen, device=dev) * d ** -0.5
                    for _ in range(copies(w.numel() * 4) - 1)]
        b_ms, b_by = bound(4.0 * (T * d + d * da + 2 * T * da), 2.0 * T * d * da + 3.0 * T * da)
        r = {"check": "adapter_fuse", "arch": arch, "T": T, "d": d, "da": da,
             "max_abs_err": max_err(got, want),
             "ms": timer([lambda w_=w_: adapter_fuse(b, w_, a, lam) for w_ in ws]),
             "plain_ms": timer([lambda w_=w_: ref.adapter_fuse_ref(b, w_, a, lam) for w_ in ws]),
             "library_ms": timer([lambda w_=w_: torch.addmm(a, b, w_, beta=0.5, alpha=0.5)
                                  for w_ in ws]),
             "bound_ms": b_ms, "bound_by": b_by}
        emit(r)
        if T == 1:
            rows["adapter_fuse"] = _row(r, f"one period's mix at decode, T=1, d={d}, d_a={da}")
    return rows


MIXTRAL_PROJECTIONS = [(4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096)]  # wq wk wv wo
MIXTRAL_D, MIXTRAL_DA, MIXTRAL_V = 4096, 512, 32000  # r = 8
MIXTRAL_MAX_LEN = 544
MIXTRAL_POOL = 16  # Jetson Nano-H profiles whose memory holds the INT8 model (the plan report)
ROUTE_SHARE_MIN = 0.999  # tokens whose routes must agree, cuda against ref, in every layer
#: the share of the serving wave's tokens that the reference's own routes move, at its worst
#: layer, when every MoE layer's router input moves by one f32 ulp (JAX's route at the config's
#: experts, top-k, capacity factor and depth: tests/test_torch_moe_configs.py, the largest of
#: 4 draws); a config absent moved none
ROUTE_OWN_MOVE = {"moonshot-v1-16b-a3b": 1 / 4096}
#: peaks of device memory of the serving, training and personal phases of the
#: configs held once at a time, by phase (the ``done`` line)
PEAKS = {}


def training_key(arch: str, quant: int) -> str:
    """A training run's name in ``PEAKS``: the arch, and its backbone's
    width where it is not INT8."""
    return f"{arch} training" if quant == 8 else f"{arch} int{quant} training"


def route_free_gated(arch: str) -> bool:
    """Whether the free-running comparison's route share is gated (at
    ``ROUTE_SHARE_MIN`` in every layer) for ``arch``: where the reference's
    own routes move under one ulp a layer (``ROUTE_OWN_MOVE``), a flipped
    token's request carries its move into the later layers, so the share
    there counts the flips of the layers before, and the gate holds the
    forced comparison alone (each layer's own choice on the ``cuda`` run's
    routes). A depth cut takes its config's entry."""
    base = GROK if arch.startswith(GROK + "-cut") else arch
    return ROUTE_OWN_MOVE.get(base, 0.0) == 0.0


def pooled_route_shares(cuda_steps: list, other_steps: list) -> list:
    """Per MoE layer, the share of all the steps' tokens (each step's
    records, one a layer, pooled) whose experts and kept flags are equal
    in the two runs: a decode step of 8 tokens, or 1, counts by its
    tokens, not as a share of its own."""
    equal, tokens = None, None
    for rc, ro in zip(cuda_steps, other_steps):
        e = [int(((a["top_e"] == b["top_e"]).all(-1) & (a["kept"] == b["kept"]).all(-1)).sum())
             for a, b in zip(rc, ro)]
        n = [a["top_e"][..., 0].numel() for a in rc]
        equal = e if equal is None else [x + y for x, y in zip(equal, e)]
        tokens = n if tokens is None else [x + y for x, y in zip(tokens, n)]
    return [x / y for x, y in zip(equal, tokens)]


def forced_compare(routes: dict, logits: dict, labels) -> list:
    """Per step, the ``cuda`` run's routes against the ``ref_forced``
    run's own choices (that run follows the ``cuda`` routes, so a layer's
    flips are its own: ``route_share_per_layer``, split as
    :func:`route_compare`), and every row's logits."""
    out = []
    for i, (rc, rf) in enumerate(zip(routes["cuda"], routes["ref_forced"])):
        shares, _, counts = route_compare(rc, rf)
        a, b = logits["cuda"][i], logits["ref_forced"][i]
        out.append({"step": labels[i], "route_share_min": min(shares),
                    "route_share_per_layer": shares, "unequal_per_layer": counts,
                    "rows_compared": a.shape[0], "max_abs_dlogits": max_err(a, b),
                    "greedy_equal": bool(torch.equal(a.argmax(-1), b.argmax(-1))),
                    "finite": bool(torch.isfinite(a).all() and torch.isfinite(b).all())})
    return out


def route_compare(cuda_recs: list, ref_recs: list, real=None):
    """Two runs' route records of one call (one a MoE layer, in order):
    the share of tokens whose experts and kept flags are equal, per
    layer; the (B,) rows all of whose counted tokens (``real``, (B, S)
    bool; None: every token) have equal routes in every layer; and per
    layer the unequal tokens counted (``real``/``padding``, and
    ``experts``: another top-k, ``kept``: the same experts, another
    capacity cut)."""
    if len(cuda_recs) != len(ref_recs) or not cuda_recs:
        raise AssertionError(f"route records: {len(cuda_recs)} against {len(ref_recs)}")
    shares, agree, counts = [], None, []
    for a, b in zip(cuda_recs, ref_recs):
        same_e = (a["top_e"] == b["top_e"]).all(-1)
        eq = same_e & (a["kept"] == b["kept"]).all(-1)
        shares.append(float(eq.float().mean()))
        ok = (eq | ~real).all(-1) if real is not None else eq.all(-1)
        agree = ok if agree is None else agree & ok
        counted = real if real is not None else torch.ones_like(eq)
        counts.append({"real": int((~eq & counted).sum()), "padding": int((~eq & ~counted).sum()),
                       "experts": int((~same_e).sum()), "kept": int((same_e & ~eq).sum())})
    return shares, agree, counts


def mixtral_kernel_phase(timer: Timer, gen: torch.Generator) -> dict:
    """The kernels at mixtral-8x7b's widths against their plain versions,
    timed: ``quant_matmul`` over a layer's four attention projections
    (K = 4096, N = 4096 and 1024; the experts are dequantized, not sent
    through it) at M = 8 and 4096; flash at the epoch-1 step's B·H = 4·32
    over 8 kv heads, hd 128 (the 4096 window spans S = 512); paged at
    B = 8, Hkv = 8, n_rep = 4, int8 pages of 16, lengths <= 511;
    ``mix_fwd``/``mix_dw`` at d = 4096, d_a = 512; ``ce_fwd``/``ce_bwd``
    over V = 32000 with no soft-cap; ``adapter_fuse`` at T = 1 and 8.
    Returns each kernel's ``mixtral`` entry."""
    rows = gemma2_kernel_phase(timer, gen, MIXTRAL, MIXTRAL_PROJECTIONS, MIXTRAL_D, MIXTRAL_DA,
                               MIXTRAL_V, None)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms",
            "bound_f32_ms", "library_ms", "at")
    r = flash_case(timer, gen, 4, 32, 8, 512, 128, "mixtral training")[0]
    emit(r)
    rows["flash_attention"] = {k: r[k] for k in keys}
    lengths = np.random.default_rng(SEED).integers(1, 512, size=8).astype(np.int32)
    pkeys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at", "plan")
    rows["paged_attention"] = {k: v for k, v in paged_timed(
        timer, gen, lengths, 32, "mixtral decode B=8 Hkv=8 n_rep=4 hd=128 page=16 int8, "
        "lengths<=511", Hkv=8, n_rep=4, hd=128).items() if k in pkeys}
    return rows


def mixtral_serving_phase(gen: torch.Generator, arch: str = MIXTRAL,
                          max_len: int = MIXTRAL_MAX_LEN, phase: str = "mixtral_serving") -> dict:
    """mixtral-8x7b at full width and depth (32 layers, d = 4096, 32 heads
    over 8 kv heads, 8 experts of 14336 top-2, window 4096, V = 32000),
    random seeded INT8 weights (46.7 B parameters), 4 users with r = 8
    adapters, INT8 KV pages of 16, through ``ServeEngine``: the serving
    phase's 8 requests (64-480-token prompts), ``CONFIG_NEW_TOKENS`` new tokens each. Then
    their prefill and two decode steps under ``cuda`` and ``ref`` with
    every layer's routes recorded: in every layer at least 99.9 % of the
    tokens routed alike; where a request's tokens routed alike in every
    layer so far, logits within 2e-2 and greedy tokens equal. Then the
    same steps under ``ref`` following the ``cuda`` run's routes
    (``replay_routes``): each layer's own choice routes 99.9 % of the
    steps' tokens (pooled) as ``cuda`` did, every row's logits within
    2e-2, greedy tokens equal. Another MoE config likewise, as ``phase``,
    with its ``max_len``; the free run's route share is gated where
    :func:`route_free_gated`. The line carries the peaks of the draw, the
    engine's run and the comparison."""
    from repro_torch.configs import get_arch
    from repro_torch.core.parallel_adapters import gather_adapters, init_adapter
    from repro_torch.core.quantization import tree_storage_bytes
    from repro_torch.models.backbone import init_backbone
    from repro_torch.serve import ServeEngine

    cfg = get_arch(arch)
    page, max_batch, n_new, r = 16, 8, CONFIG_NEW_TOKENS, 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backbone = init_backbone(gen, cfg, device=DEV, quant_bits=8)
    users = {f"user{u}": init_adapter(gen, cfg, r=r, device=DEV) for u in range(4)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(SEED)
    prompt_lens = rng.integers(64, 481, size=8)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist() for n in prompt_lens]
    names = list(users)
    eng = ServeEngine(backbone, cfg, users, r=r, kernel_impl="cuda", kv_policy="int8",
                      page_size=page, max_len=max_len, max_batch=max_batch)
    bank = eng.bank
    del users
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    handles = [eng.submit(p, names[i % 4], max_new_tokens=n_new) for i, p in enumerate(prompts)]
    t = time.perf_counter()
    eng.drain()
    wall = time.perf_counter() - t
    launches = {k: v for k, v in read_launches().items()
                if k in ("quant_matmul", "flash_attention", "paged_attention")}
    streams = [h.result() for h in handles]
    for st in streams:
        if len(st) != n_new or not all(0 <= tok < cfg.vocab for tok in st):
            raise AssertionError(f"bad stream: {st}")
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
            "params": cfg.param_count(), "active_params": cfg.active_param_count(),
            "backbone_bytes": tree_storage_bytes(backbone), "init_s": init_s,
            "init_max_memory_allocated": init_peak, "requests": len(prompts),
            "users": len(names), "prompt_lens": [len(p) for p in prompts], "new_tokens": n_new,
            "kv": "int8", "page": page, "max_len": max_len,
            "prefill_ms": eng.prefill_seconds * 1e3, "decode_steps": eng.decode_steps,
            "decode_ms_per_step": eng.decode_seconds * 1e3 / eng.decode_steps,
            "decode_tokens_per_s": eng.decode_tokens / eng.decode_seconds, "wall_s": wall,
            "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": launches,
            "launches_per_decode_step": {"quant_matmul": 4 * cfg.n_layers,
                                         "paged_attention": cfg.n_layers},
            "first_tokens": [st[:4] for st in streams]}
    del eng
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on {phase}'s path: {missing}")

    s_pad = 1 << (int(max(prompt_lens)) - 1).bit_length()
    routes = {}
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    logits = paged_cuda_vs_ref(backbone, cfg, gather_adapters(bank, torch.arange(8, device=DEV)
                                                              % 4),
                               prompts, page, max_len, r, s_pad, routes=routes, forced=True)
    line.update(compare_s=time.perf_counter() - t,
                compare_max_memory_allocated=torch.cuda.max_memory_allocated())
    PEAKS[phase] = {k: line[k] for k in ("init_max_memory_allocated", "max_memory_allocated",
                                         "compare_max_memory_allocated")}
    lengths = torch.tensor([len(p) for p in prompts], device=DEV)
    real = torch.arange(s_pad, device=DEV)[None, :] < lengths[:, None]
    agree = torch.ones(len(prompts), dtype=torch.bool, device=DEV)
    tol, steps, labels = 2e-2, [], ["prefill", "decode1", "decode2"]
    free_gated = route_free_gated(cfg.name)
    for i, (rc, rr) in enumerate(zip(routes["cuda"], routes["ref"])):
        shares, ok, counts = route_compare(rc, rr, real if i == 0 else None)
        agree &= ok
        a, b = logits["cuda"][i][agree], logits["ref"][i][agree]
        steps.append({"step": labels[i], "route_share_min": min(shares),
                      "route_share_per_layer": shares, "unequal_per_layer": counts,
                      "first_layer_unequal": next((j for j, sh in enumerate(shares) if sh < 1.0),
                                                  None),
                      "rows_compared": int(agree.sum()),
                      "rows_excluded": int((~agree).sum()),
                      "max_abs_dlogits": max_err(a, b) if len(a) else None,
                      "greedy_equal": bool(torch.equal(a.argmax(-1), b.argmax(-1))),
                      "finite": bool(torch.isfinite(logits["cuda"][i]).all()
                                     and torch.isfinite(logits["ref"][i]).all())})
    forced = forced_compare(routes, logits, labels)
    pooled = pooled_route_shares(routes["cuda"], routes["ref_forced"])
    del backbone, bank
    line.update(cuda_vs_ref=steps, cuda_vs_ref_forced=forced,
                forced_route_share_per_layer=pooled, tol=tol,
                route_share_min=ROUTE_SHARE_MIN, free_route_share_gated=free_gated,
                logits_shape=list(logits["cuda"][0].shape),
                tol_reason="the serving gate (PERF.md section 2) where every layer routed a "
                           "request's tokens alike; routing is discontinuous, so a token whose "
                           "top-2 or capacity cut sits on a near-tie may route otherwise under "
                           "the other OpSet's f32 sums, and its request is then not compared; "
                           "the forced run follows the cuda routes, so every row is compared",
                route_reason="every layer of the forced run routes 99.9 % of the prefill's and "
                             "decode steps' tokens (pooled) as cuda did; the free run's share "
                             "too, step by step, where the reference's own routes do not move "
                             "under one ulp a layer (ROUTE_OWN_MOVE)")
    emit(line)
    for st in steps:
        if not (st["finite"] and (st["max_abs_dlogits"] is None or st["max_abs_dlogits"] <= tol)
                and st["greedy_equal"] and (not free_gated or (
                    st["route_share_min"] >= ROUTE_SHARE_MIN and st["rows_compared"] > 0))):
            raise AssertionError(f"{phase} cuda vs ref: {st}")
    for st in forced:
        if not (st["finite"] and st["max_abs_dlogits"] <= tol and st["greedy_equal"]):
            raise AssertionError(f"{phase} cuda vs ref, routes forced: {st}")
    if min(pooled) < ROUTE_SHARE_MIN:
        raise AssertionError(f"{phase} routes forced: layers' shares {pooled}")
    return launches


def mixtral_personal_phase(backbone, adapter, cfg, r: int = 8,
                           phase: str = "mixtral_personal") -> dict:
    """The trained mixtral-8x7b adapter served to one user:
    ``PERSONAL_STEPS`` ``pac_decode_step``s at B = 1 over an f32 linear KV cache, 8
    teacher-forced prompt tokens then greedy, under ``cuda`` (launches
    counted: ``adapter_fuse`` 32 and ``quant_matmul`` 128 a step) and
    ``ref``, every layer's routes recorded: where the routes agree in
    every layer of every step so far, the step's logits within 2e-4 (the
    ``personal_gap``) and the greedy tokens equal. Then ``ref`` once more
    following the ``cuda`` run's routes and tokens (``replay_routes``):
    every step's logits within 2e-4, its greedy tokens and every layer's
    own choice of routes the ``cuda`` run's. Another MoE config's adapter
    likewise, as ``phase`` (``adapter_fuse`` once a period,
    ``quant_matmul`` 4 a layer; the free run's route share gated where
    :func:`route_free_gated`)."""
    from repro_torch.core.parallel_adapters import init_adapter_cache
    from repro_torch.core.steps import pac_decode_step
    from repro_torch.models.backbone import init_cache
    from repro_torch.models.moe import record_routes, replay_routes

    n_prompt, n_steps, max_len = 8, PERSONAL_STEPS, 16
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, size=(1, n_prompt)).astype(np.int32)).to(DEV)

    def serve(impl, follow=None, feed=None, steps=n_steps):
        """``follow``: each step's route records to replay; ``feed``: the
        greedy tokens to feed after the prompt (else the run's own)."""
        cache = init_cache(cfg, 1, max_len, device=DEV)
        acache = init_adapter_cache(cfg, 1, max_len, r, device=DEV)
        logits, greedy, recs, tok = [], [], [], prompt[:, :1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in range(steps):
            replay = replay_routes(follow[p]) if follow else contextlib.nullcontext()
            with replay, record_routes() as rec:
                lg, cache, acache = pac_decode_step(
                    backbone, adapter, {"tokens": tok}, cache, acache,
                    torch.full((1,), p, dtype=torch.long, device=DEV), cfg=cfg, r=r,
                    kernel_impl=impl)
            logits.append(lg[:, 0])
            recs.append(rec)
            if p >= n_prompt - 1:
                greedy.append(int(lg[0, 0].argmax()))
            nxt = (feed or greedy)[len(greedy) - 1] if p >= n_prompt - 1 else None
            tok = (prompt[:, p + 1:p + 2] if p + 1 < n_prompt
                   else torch.tensor([[nxt]], dtype=torch.int32, device=DEV))
        torch.cuda.synchronize()
        return logits, greedy, recs, time.perf_counter() - t0

    serve("cuda", steps=2)  # warm-up: first launches, allocator growth
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    lc, tc, rc, wall = serve("cuda")
    launches = {k: v for k, v in read_launches().items()
                if k in ("quant_matmul", "flash_attention", "adapter_fuse")}
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lr, tr, rr, wall_ref = serve("ref")
    ref_peak = torch.cuda.max_memory_allocated()
    PEAKS[phase] = {"max_memory_allocated": peak, "ref_max_memory_allocated": ref_peak}
    gaps, shares, agree, first = [], [], True, []
    for p in range(n_steps):
        sh, ok, counts = route_compare(rc[p], rr[p])
        shares.append(min(sh))
        first.append(next(({"layer": j, **counts[j]} for j, x in enumerate(sh) if x < 1.0),
                          None))
        agree = agree and bool(ok.all())
        gaps.append(max_err(lc[p], lr[p]) if agree else None)
    compared = [g for g in gaps if g is not None]
    # the greedy tokens of the steps whose routes agreed in every layer so far
    agreed = len(compared) - (n_prompt - 1)
    lf, tf, rf, _ = serve("ref", follow=rc, feed=tc)
    forced_shares = [min(route_compare(rc[p], rf[p])[0]) for p in range(n_steps)]
    forced_pooled = pooled_route_shares(rc, rf)
    forced_gaps = [max_err(lc[p], lf[p]) for p in range(n_steps)]
    free_gated = route_free_gated(cfg.name)
    per_step = {k: v / n_steps for k, v in launches.items()}
    tol = 2e-4
    emit({"phase": phase, "arch": cfg.name, "layers": cfg.n_layers, "batch": 1,
          "steps": n_steps, "prompt_tokens": n_prompt, "kv": "f32 linear",
          "decode_ms_per_step": wall * 1e3 / n_steps,
          "ref_decode_ms_per_step": wall_ref * 1e3 / n_steps, "max_memory_allocated": peak,
          "ref_max_memory_allocated": ref_peak,
          "launches": launches, "launches_per_step": per_step, "tokens_cuda": tc,
          "tokens_equal": tc == tr, "route_share_min_per_step": shares,
          "first_layer_unequal_per_step": first,
          "steps_compared": len(compared), "personal_gap_per_step": gaps,
          "max_abs_dlogits": max(compared) if compared else None, "tol": tol,
          "free_route_share_gated": free_gated,
          "forced": {"route_share_min_per_step": forced_shares,
                     "route_share_per_layer": forced_pooled, "tokens": tf,
                     "tokens_equal": tf == tc, "personal_gap_per_step": forced_gaps,
                     "max_abs_dlogits": max(forced_gaps)},
          "tol_reason": "the reference's decode-parity ceiling over f32 KV "
                        "(tests/test_decode_parity.py:36), at the steps whose routes agree in "
                        "every layer so far, and at every step of the run that follows the "
                        "cuda run's routes and tokens"})
    free_ok = (all(g <= tol for g in compared) and tc[:max(0, agreed)] == tr[:max(0, agreed)]
               and (not free_gated or (compared and min(shares) >= ROUTE_SHARE_MIN
                                       and tc == tr)))
    if not (free_ok and all(bool(torch.isfinite(x).all()) for x in lc)):
        raise AssertionError(f"{phase} cuda vs ref: tokens equal {tc == tr}, "
                             f"gaps {gaps}, route shares {shares}")
    if not (min(forced_pooled) >= ROUTE_SHARE_MIN and max(forced_gaps) <= tol and tf == tc):
        raise AssertionError(f"{phase} cuda vs ref, routes forced: tokens {tf} against {tc}, "
                             f"gaps {forced_gaps}, route shares {forced_shares}")
    if per_step["adapter_fuse"] != cfg.n_periods or per_step["quant_matmul"] != 4 * cfg.n_layers:
        raise AssertionError(f"{phase} launches per decode step: {per_step}")
    return launches


def gemma2_serving_phase(gen: torch.Generator, arch: str = GEMMA2,
                         max_len: int = GEMMA2_MAX_LEN, long_prompt=GEMMA2_LONG_PROMPT,
                         phase: str = "gemma2_serving", keep: dict = None) -> dict:
    """gemma2-2b at full width (26 layers, d = 2304, 8 heads of 256 over 4
    kv heads, d_ff 9216, V = 256000, window 4096 on every other layer,
    soft-caps 50 and 30, tied embeddings), random seeded INT8 weights, 4
    users with r = 8 adapters, INT8 KV pages of 16, through
    ``ServeEngine``: the serving phase's 8 requests (64-480-token prompts)
    and a ninth of 4500 tokens, ``CONFIG_NEW_TOKENS`` new tokens each. The long prompt runs
    its own wave (bucket 1, padded to 8192): flash prefill and paged
    decode both cross the window. Then the 8 requests' prefill and two
    decode steps, and the long request's, under ``cuda`` and ``ref``:
    logits within 2e-2, greedy tokens equal. Another config likewise, as
    ``phase``, with its ``max_len`` (``long_prompt`` None: the 8 requests
    only). ``keep`` (a dict) gets the users, prompts and streams, for the
    bf16 backbone's serving phase."""
    from repro_torch.configs import get_arch
    from repro_torch.core.parallel_adapters import gather_adapters, init_adapter, stack_adapters
    from repro_torch.core.quantization import tree_storage_bytes
    from repro_torch.models.backbone import init_backbone
    from repro_torch.serve import ServeEngine

    cfg = get_arch(arch)
    page, max_batch, n_new, r = 16, 8, CONFIG_NEW_TOKENS, 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backbone = init_backbone(gen, cfg, device=DEV, quant_bits=8)
    users = {f"user{u}": init_adapter(gen, cfg, r=r, device=DEV) for u in range(4)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serving_prompts(cfg, long_prompt)
    prompt_lens = [len(p) for p in prompts[:8]]
    names = list(users)

    def engine():
        return ServeEngine(backbone, cfg, users, r=r, kernel_impl="cuda", kv_policy="int8",
                           page_size=page, max_len=max_len, max_batch=max_batch)

    warm = engine()  # warm-up: first launches at these widths, allocator growth
    for i, p in enumerate(prompts[:8]):
        warm.submit(p, names[i % 4], max_new_tokens=2)
    warm.drain()
    del warm
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = engine()
    reset_launches()
    handles = [eng.submit(p, names[i % 4], max_new_tokens=n_new) for i, p in enumerate(prompts)]
    t = time.perf_counter()
    eng.drain()
    wall = time.perf_counter() - t
    launches = {k: v for k, v in read_launches().items()
                if k in ("quant_matmul", "flash_attention", "paged_attention")}
    streams = [h.result() for h in handles]
    for st in streams:
        if len(st) != n_new or not all(0 <= tok < cfg.vocab for tok in st):
            raise AssertionError(f"bad stream: {st}")
    if keep is not None:
        keep.update(users=users, prompts=prompts, streams=streams)
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.n_layers, "params": cfg.param_count(),
            "backbone_bytes": tree_storage_bytes(backbone), "init_s": init_s,
            "requests": len(prompts), "users": len(users),
            "prompt_lens": [len(p) for p in prompts], "new_tokens": n_new, "kv": "int8",
            "page": page, "max_len": max_len, "prefill_ms": eng.prefill_seconds * 1e3,
            "decode_steps": eng.decode_steps,
            "decode_ms_per_step": eng.decode_seconds * 1e3 / eng.decode_steps,
            "decode_tokens_per_s": eng.decode_tokens / eng.decode_seconds, "wall_s": wall,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "init_max_memory_allocated": init_peak, "launches": launches,
            "first_tokens": [st[:4] for st in streams]}
    del eng
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on {arch}'s serving path: {missing}")

    bank = stack_adapters([users[n] for n in names])
    waves = {"8 requests": (prompts[:8], torch.arange(8, device=DEV) % 4,
                            1 << (int(max(prompt_lens)) - 1).bit_length())}
    if long_prompt:
        waves[f"{long_prompt}-token prompt"] = (prompts[8:], torch.tensor([0], device=DEV),
                                                long_prompt)
    tol, checks = 2e-2, {}
    for label, (wave, rows_, s_pad) in waves.items():
        logits = paged_cuda_vs_ref(backbone, cfg, gather_adapters(bank, rows_), wave, page,
                                   max_len, r, s_pad)
        checks[label] = {
            "max_abs_dlogits": [max_err(a, b) for a, b in zip(logits["cuda"], logits["ref"])],
            "greedy_equal": [bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                             for a, b in zip(logits["cuda"], logits["ref"])],
            "finite": all(bool(torch.isfinite(x).all()) for x in logits["cuda"] + logits["ref"]),
            "logits_shape": list(logits["cuda"][0].shape)}
        del logits
    line.update(cuda_vs_ref=checks, steps=["prefill", "decode1", "decode2"], tol=tol,
                tol_reason=f"the serving gate (PERF.md section 2): f32 sums reorder through "
                           f"{cfg.n_layers} layers, and an int8 KV code may move by one step")
    emit(line)
    for label, c in checks.items():
        if not (c["finite"] and max(c["max_abs_dlogits"]) <= tol and all(c["greedy_equal"])):
            raise AssertionError(f"{phase} cuda vs ref ({label}): {c}")
    return launches


def single_device_layout(spec, reason: str):
    """A one-process run's layout with no edge-pool plan (``reason`` in its
    report line), for a config no Jetson Nano-H pool holds: one layer of
    grok-1-314b is 5.07 GB in INT8 against a device's 4 GiB, so the
    session's offline plan refuses it at any pool, in both packages."""
    from repro_torch.runtime.session import Layout

    return Layout(spec.pool or 4, 1, 1, spec.default_micro(), None, None,
                  (f"edge-pool plan: none ({reason})",))


def pac_run(arch: str, epochs: int = 2, steps: int = 2, profile: bool = False,
            one_backbone: bool = False, pool=None,
            path_kernels=("quant_matmul", "flash_attention", "mix_fwd", "mix_dw", "ce_fwd",
                          "ce_bwd"), single_device: bool = False, quant: int = 8,
            outputs: Path = None, path_branches=()):
    """PAC+ on ``arch`` at full width through ``EdgeSession``/
    ``EpochRunner``: a ``quant``-bit backbone (INT8 unless given), int8
    activation cache, pruning init,
    ``epochs`` x ``steps`` steps of 4 x 512 tokens, each step's launches by
    kernel; then the cached-step gate, with ``profile`` a full and a cached
    step under the profiler, and the trainer gate. Returns (launches, the
    session's backbone and adapter). With ``one_backbone`` (a backbone the
    card holds once only: mixtral-8x7b's 48 GB) the ``cuda`` session's
    backbone is released before the trainer gate opens its ``ref``
    session, and the backbone returned is that session's, the same seeded
    draw (its fingerprint must equal the first's). ``pool``: the Jetson
    pool of the session's offline edge-pool plan (its default of 4 cannot
    hold mixtral-8x7b, and the planner then refuses, as the reference's
    does). ``path_kernels``: the kernels the arch's training path must
    launch (xlstm-125m's has no ``quant_matmul`` or flash: its mixers
    run dense, and it has no attention). ``single_device``: the session's
    edge-pool plan must refuse the arch, and both sessions open on
    :func:`single_device_layout` instead. ``outputs``: a directory for the
    run's checkpoint (``adapter.msgpack``) and persistent cache
    (``act_cache``), written by ``finish``; the line then carries the
    cache manifest's quantization and backbone fingerprint.
    ``path_branches``: the ``quant_matmul`` branches (``"int4 tiled"``,
    ...) the run must launch, counted in the line."""
    from repro_torch.runtime import EdgeSession, EpochReport, EpochRunner, RunHooks, RunSpec
    from repro_torch.runtime.session import resolve_layout

    kept = {} if outputs is None else {"ckpt": str(outputs / "adapter.msgpack"),
                                        "cache_dir": str(outputs / "act_cache")}
    spec = RunSpec(arch=arch, quant=quant, cache_compress="int8", kernels="cuda",
                   init="pruning", epochs=epochs, steps_per_epoch=steps, batch=4, seq=512,
                   seed=SEED, pool=pool, **kept)
    layout = None
    if single_device:
        refused = None
        try:
            resolve_layout(spec)
        except RuntimeError as e:  # the planner's refusal, asserted just below
            refused = str(e)
        if refused is None or "no feasible plan" not in refused:
            raise AssertionError(f"{arch}: the edge-pool plan did not refuse the model")
        layout = single_device_layout(spec, refused)
    training_kernels = ("quant_matmul", "flash_attention", "mix_fwd", "mix_dw", "ce_fwd",
                        "ce_bwd")
    per_step = []

    def read():
        return {k: v for k, v in read_launches().items() if k in training_kernels}

    class StepLaunches(RunHooks):
        def on_step(self, session, event):
            now = read()
            before = per_step[-1][1] if per_step else dict.fromkeys(now, 0)
            per_step.append(({k: now[k] - before[k] for k in now}, now))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = EdgeSession(spec, log=print, device=DEV, layout=layout).open()
    torch.cuda.synchronize()
    open_s = time.perf_counter() - t0
    reset_launches()
    events = list(EpochRunner(s, hooks=[StepLaunches()]).events())
    launches = read()
    branches = branch_counts()
    steps_ = [e for e in events if not isinstance(e, EpochReport)]
    reports = [e for e in events if isinstance(e, EpochReport)]
    extra = {}
    if path_branches:
        extra["quant_matmul_branches"] = branches
    if outputs is not None:
        s.finish()
        extra.update(ckpt=spec.ckpt, manifest_quant=s.meta["quant"],
                     manifest_backbone=s.meta["backbone"])
    emit({"phase": "pac_run", "arch": arch, "layers": s.cfg.n_layers, "d_model": s.cfg.d_model,
          "heads": s.cfg.n_heads, "hd": s.cfg.hd, "vocab": s.cfg.vocab, "batch": spec.batch,
          "seq": spec.seq, "quant": spec.quant, "cache": spec.cache_compress, "r": spec.r,
          "modes": [r.mode for r in reports], "epoch_losses": [r.mean_loss for r in reports],
          "step_losses": [e.loss for e in steps_], "open_s": open_s,
          "full_step_s": [e.wall_s for e in steps_ if not e.cache_hit],
          "cached_step_s": [e.wall_s for e in steps_ if e.cache_hit],
          "full_step_median_s": statistics.median(
              [e.wall_s for e in steps_ if not e.cache_hit] or [float("nan")]),
          "cached_step_median_s": statistics.median(
              [e.wall_s for e in steps_ if e.cache_hit] or [float("nan")]),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "plan_line": s.layout.lines[0] if s.layout.lines else None,
          "cache_bytes": s.cache.nbytes, "launches": launches,
          "launches_per_step": [dl for dl, _ in per_step], **extra})
    PEAKS[training_key(arch, quant)] = {"max_memory_allocated": torch.cuda.max_memory_allocated()}
    if [r.mode for r in reports] != ["full"] + ["cached"] * (epochs - 1):
        raise AssertionError(f"{arch} modes {[r.mode for r in reports]}")
    if not all(np.isfinite(r.mean_loss) for r in reports):
        raise AssertionError(f"{arch} epoch losses {[r.mean_loss for r in reports]}")
    missing = [n for n in path_kernels if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on {arch}'s training path: {missing}")
    require_branches(f"{arch} training", branches, path_branches)
    if outputs is not None and s.meta["quant"] != quant:
        raise AssertionError(f"{arch}: the cache manifest says quant {s.meta['quant']}")
    if path_branches:
        launches["quant_matmul_branches"] = branches
    cached_step_gate(s, spec)
    if profile:
        profile_steps(s)
    backbone, adapter = s.backbone, s.adapter
    s.close()
    del s
    if not one_backbone:
        trainer_gate(spec, [r.mean_loss for r in reports], layout=layout)
        return launches, backbone, adapter
    prints = fingerprint(backbone)
    del backbone
    torch.cuda.empty_cache()
    backbone = trainer_gate(spec, [r.mean_loss for r in reports], keep_backbone=True,
                            layout=layout)
    if fingerprint(backbone) != prints:
        raise AssertionError(f"{arch}: the ref session drew another backbone")
    return launches, backbone, adapter


def gemma2_personal_phase(backbone, adapter, cfg, r: int = 8, phase: str = "gemma2_personal",
                          qmm_per_layer: int = 7) -> dict:
    """The trained gemma2-2b adapter served to one user:
    ``PERSONAL_STEPS`` ``pac_decode_step``s at B = 1 over an f32 linear KV cache, 8
    teacher-forced prompt tokens then greedy, under ``cuda`` (launches
    counted: ``adapter_fuse`` 13 and ``quant_matmul`` 182 a step) and
    ``ref``: each step's logits within 2e-4 (the ``personal_gap``), the
    greedy tokens equal. Another config's trained adapter likewise, as
    ``phase``, with ``qmm_per_layer`` projections a layer through
    ``quant_matmul`` (xlstm-125m: 0, its mixers run dense; its cache is
    the SSM state)."""
    from repro_torch.core.parallel_adapters import init_adapter_cache
    from repro_torch.core.steps import pac_decode_step
    from repro_torch.models.backbone import init_cache

    n_prompt, n_steps, max_len = 8, PERSONAL_STEPS, 16
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, size=(1, n_prompt)).astype(np.int32)).to(DEV)

    def serve(impl, steps=n_steps):
        cache = init_cache(cfg, 1, max_len, device=DEV)
        acache = init_adapter_cache(cfg, 1, max_len, r, device=DEV)
        logits, greedy, tok = [], [], prompt[:, :1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in range(steps):
            lg, cache, acache = pac_decode_step(
                backbone, adapter, {"tokens": tok}, cache, acache,
                torch.full((1,), p, dtype=torch.long, device=DEV), cfg=cfg, r=r,
                kernel_impl=impl)
            logits.append(lg[:, 0])
            if p >= n_prompt - 1:
                greedy.append(int(lg[0, 0].argmax()))
            tok = (prompt[:, p + 1:p + 2] if p + 1 < n_prompt
                   else torch.tensor([[greedy[-1]]], dtype=torch.int32, device=DEV))
        torch.cuda.synchronize()
        return torch.cat(logits), greedy, time.perf_counter() - t0

    serve("cuda", steps=2)  # warm-up: first launches, allocator growth
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    lc, tc, wall = serve("cuda")
    launches = {k: v for k, v in read_launches().items()
                if k in ("quant_matmul", "flash_attention", "adapter_fuse")}
    peak = torch.cuda.max_memory_allocated()
    lr, tr, wall_ref = serve("ref")
    gap = (lc - lr).abs().amax(-1).tolist()
    per_step = {k: v / n_steps for k, v in launches.items()}
    tol = 2e-4
    emit({"phase": phase, "arch": cfg.name, "batch": 1, "steps": n_steps,
          "prompt_tokens": n_prompt, "kv": "f32 linear", "decode_ms_per_step": wall * 1e3 / n_steps,
          "ref_decode_ms_per_step": wall_ref * 1e3 / n_steps, "max_memory_allocated": peak,
          "launches": launches, "launches_per_step": per_step, "tokens_cuda": tc,
          "tokens_equal": tc == tr, "personal_gap_per_step": gap, "max_abs_dlogits": max(gap),
          "tol": tol, "tol_reason": "the reference's decode-parity ceiling over f32 KV "
                                    "(tests/test_decode_parity.py:36)"})
    if tc != tr or not max(gap) <= tol or not bool(torch.isfinite(lc).all()):
        raise AssertionError(f"{phase} cuda vs ref: tokens equal {tc == tr}, gap {gap}")
    if (per_step["adapter_fuse"] != cfg.n_periods
            or per_step["quant_matmul"] != qmm_per_layer * cfg.n_layers):
        raise AssertionError(f"{phase} launches per decode step: {per_step}")
    return launches


def musicgen_phase(gen: torch.Generator) -> dict:
    """musicgen-large at full width (48 layers, d = 2048, 32 heads of 64,
    no rope, V = 2048), random seeded INT8 weights, fed seeded frame
    embeddings (B = 4, S = 512, as the reference feeds its audio stub):
    ``prefill_step`` under ``cuda`` (launches counted) against ``ref``,
    the last position's logits within the serving gate 2e-2."""
    from repro_torch.configs import get_arch
    from repro_torch.core.steps import prefill_step
    from repro_torch.models.backbone import init_backbone

    cfg = get_arch("musicgen-large")
    backbone = init_backbone(gen, cfg, device=DEV, quant_bits=8)
    embeds = torch.randn(4, 512, cfg.d_model, generator=gen, device=DEV) * 0.3
    prefill_step(backbone, {"embeds": embeds}, cfg=cfg, kernel_impl="cuda")  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    got = prefill_step(backbone, {"embeds": embeds}, cfg=cfg, kernel_impl="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items()
                if k in ("quant_matmul", "flash_attention")}
    want = prefill_step(backbone, {"embeds": embeds}, cfg=cfg, kernel_impl="ref")
    err, tol = max_err(got, want), 2e-2
    finite = bool(torch.isfinite(got).all())
    emit({"phase": "musicgen_prefill", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads, "hd": cfg.hd, "rope": cfg.rope,
          "batch": 4, "frames": 512, "prefill_ms": wall * 1e3, "launches": launches,
          "logits_shape": list(got.shape), "max_abs_dlogits": err, "finite": finite,
          "greedy_equal": bool(torch.equal(got.argmax(-1), want.argmax(-1))), "tol": tol,
          "tol_reason": "the serving gate (PERF.md section 2): f32 sums reorder through 48 "
                        "layers"})
    if not finite or err > tol or tuple(got.shape) != (4, 1, cfg.vocab):
        raise AssertionError(f"musicgen prefill cuda vs ref: {err} (tol {tol}), finite {finite}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"kernels never launched on musicgen's prefill: {launches}")
    return launches


# ------------------------------------------------------- baselines, distill

BASELINE_MODELS = ("t5-base-pac", "internlm2-1.8b")  # Table V's model; the training cell's
BASELINE_B, BASELINE_S, BASELINE_STEPS = 4, 512, 2  # timed steps, after one warm-up
PROFILED_BASELINES = ("internlm2-1.8b",)  # the models whose rows also profile a step
BASELINES = ("full", "lora", "adapters")
T5_PROJECTIONS = [(768, 768)] * 4 + [(768, 3072), (768, 3072), (3072, 768)]
T5_DA, T5_V = 96, 32128  # adapter width at r = 8; vocabulary
DISTILL_STEPS, DISTILL_B = 8, 2  # 8 steps over 2 calibration batches of 2 x 512
DISTILL_KL_RTOL = 1e-3
DISTILL_ADAPTER_SHARE = 1e-3  # elements allowed past 5e-5, each within AdamW's reach
DISTILL_TOL_REASON = (
    "the teacher's taps and logits differ by quant_matmul's and flash's rounding (the f32-KV "
    "decode gap <= 2e-4 in logits): a logit moved by d moves the loss by at most "
    "2d·E|log p| per position, so 1e-3 of the loss at every step leaves room for the rounding "
    "and none for a kernel off by 1e-2. The adapters take 8 unclipped AdamW steps on those "
    "gradients: an element whose gradient passes within a few eps of 0 moves by any fraction "
    "of lr (ROADMAP C3), so all are held to 8 steps' reach (2·lr each) and at most 1e-3 of "
    "them past 5e-5, ten times the CPU test's share against the reference over 2 layers")


def width_kernel_phase(gen: torch.Generator, arch: str, projections, H: int, hd: int, d: int,
                       da: int, V: int, T: int = BASELINE_B * BASELINE_S) -> None:
    """The training kernels at ``arch``'s widths, the shapes its epoch-1
    and cached steps give them at B x S = 4 x 512, held to their plain
    versions at their training-shape tolerances (``*_width`` lines):
    ``quant_matmul`` over one layer's projections at M = T, int8; flash at
    B·H = 4·H, S = 512; ``mix_fwd``/``mix_dw`` over an int8 entry at
    (T, d, d_a); ``ce_fwd``/``ce_bwd`` at (T, d, V)."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels import cached_mix, lmhead_ce, ref

    for K, N in sorted(set(projections)):
        _, _, got, want = qmm_check(gen, T, K, N, 8)
        emit({"check": "quant_matmul_width", "arch": arch, "M": T, "K": K, "N": N, "bits": 8,
              "max_abs_err": max_err(got, want), "tol": "atol 1e-3 + rtol 1e-4",
              "tol_reason": qmm_tol_reason(T)})
    r = flash_case(Timer(), gen, BASELINE_B, H, H, BASELINE_S, hd, f"{arch} training")[0]
    emit(dict(r, check="flash_attention_width", arch=arch))
    ent = quantize(torch.randn(T, d, generator=gen, device=DEV), 8, 128)
    w = torch.randn(d, da, generator=gen, device=DEV) * d ** -0.5
    a, g = (torch.randn(T, da, generator=gen, device=DEV) for _ in range(2))
    lam = torch.tensor(0.7, device=DEV)
    out, bw = cached_mix.mix_fwd(ent, w, a, lam)
    want_out, want_bw = ref.mix_fwd_ref(ent, w, a, lam)
    check(f"mix_fwd {arch}", mix_fwd_check(out, bw, want_out, want_bw), 1e-4)
    dw, want_dw = cached_mix.mix_dw(ent, g, lam, d), ref.mix_dw_ref(ent, g, lam, d)
    check(f"mix_dw {arch}", float(((dw - want_dw).abs() - 1e-3 * want_dw.abs()).max()), 2e-4)
    h = torch.randn(T, d, generator=gen, device=DEV)
    wh = torch.randn(d, V, generator=gen, device=DEV) * d ** -0.5
    lab = torch.randint(0, V, (T,), generator=gen, device=DEV)
    gl = torch.randn(T, generator=gen, device=DEV)
    nll, lse = lmhead_ce.ce_fwd(h, wh, lab, None)
    want_nll, want_lse = ref.ce_fwd_ref(h, wh, lab, None)
    check(f"ce_fwd {arch}", max(float(((nll - want_nll).abs() - 1e-5 * want_nll.abs()).max()),
                                float(((lse - want_lse).abs() - 1e-5 * want_lse.abs()).max())),
          2e-5)
    dh = lmhead_ce.ce_bwd(h, wh, lab, want_lse, gl, None)
    want_dh = ref.ce_bwd_ref(h, wh, lab, want_lse, gl, None)
    check(f"ce_bwd {arch}", float(((dh - want_dh).abs() - 1e-4 * want_dh.abs()).max()), 1e-5)
    emit({"check": "training_kernels_width", "arch": arch, "T": T, "d": d, "da": da, "V": V,
          "mix_fwd_max_abs_err": max(max_err(out, want_out), max_err(bw, want_bw)),
          "mix_dw_max_abs_err": max_err(dw, want_dw),
          "ce_fwd_max_abs_err": max(max_err(nll, want_nll), max_err(lse, want_lse)),
          "ce_bwd_max_abs_err": max_err(dh, want_dh),
          "tol": "mix_fwd atol 1e-4 + rtol 1e-4; mix_dw atol 2e-4 + rtol 1e-3; ce_fwd atol "
                 "2e-5 + rtol 1e-5; ce_bwd atol 1e-5 + rtol 1e-4 (the training shapes')"})


def _timed_steps(step, tree, n: int = BASELINE_STEPS, profile: bool = True) -> dict:
    """``step(tree, opt) -> (loss, tree', opt', ...)`` from ``tree`` and a
    fresh AdamW state: one warm-up step, then ``n`` timed ones on the same
    batch, each ending in a sync, then with ``profile`` one more under the
    profiler.
    Returns the per-step walls, the timed steps' losses, the peak memory
    from the warm-up on, the kernels' launches a timed step and the
    profiled step's device busy share, host ops and top kernels. The
    caller keeps no reference to ``tree`` when the steps should replace
    it (full fine-tuning's backbone)."""
    from repro_torch.optim import adamw_init

    torch.cuda.reset_peak_memory_stats()
    opt = adamw_init(tree)
    loss, tree, opt = step(tree, opt)[:3]
    float(loss)
    reset_launches()
    walls, losses = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, tree, opt = step(tree, opt)[:3]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    out = {"step_s": walls, "losses": losses,
           "launches_per_step": {k: v / n for k, v in read_launches().items() if v},
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if profile:
        state = [tree, opt]
        del tree, opt
        prof = device_profile(lambda: state.__setitem__(slice(None), step(*state)[1:3]))
        out["profile"] = dict(prof, kernels_by_device_ms=prof["kernels_by_device_ms"][:5])
    return out


def _update_close(cpu_new, card_new, cpu_grads, clip: float, lr: float, atol: float = 5e-5):
    """max |card − cpu| over the updated leaves, beside the bound the
    elements whose clipped CPU gradient lies within 100·eps of 0 are held
    to (one AdamW step's reach, 2·lr: ROADMAP C3). Returns (max over the
    other elements, max over those, their count)."""
    from repro_torch.core.quantization import tree_leaves

    grads = tree_leaves(cpu_grads)
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))
    scale = min(1.0, clip / max(norm, 1e-12))
    rest = steep = 0.0
    n_steep = 0
    for a, b, g in zip(tree_leaves(cpu_new), tree_leaves(card_new), grads):
        diff = (b.cpu() - a).abs()
        mask = g.abs() * scale < 100 * 1e-8
        rest = max(rest, float(diff[~mask].max()) if (~mask).any() else 0.0)
        steep = max(steep, float(diff[mask].max()) if mask.any() else 0.0)
        n_steep += int(mask.sum())
    if rest > atol or steep > 2 * lr:
        raise AssertionError(f"updated parameters on the card vs the CPU: {rest} (tol {atol}), "
                             f"near-zero-gradient elements {steep} (tol {2 * lr})")
    return rest, steep, n_steep


def baselines_card_vs_cpu() -> dict:
    """Gate (c): one step of each baseline on reduced internlm2-1.8b
    (seeded on the CPU, B and ``up`` non-zero) on ``cuda:0`` against the
    same step on the CPU: loss within 1e-5, the updated tree within 5e-5
    (elements whose clipped gradient is within 100·eps of 0: 2·lr)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import peft, steps
    from repro_torch.core.quantization import tree_leaves, tree_map
    from repro_torch.models.backbone import backbone_logits, cross_entropy, init_backbone
    from repro_torch.optim import adamw_init

    cfg = get_arch("internlm2-1.8b").reduced()
    gen = torch.Generator().manual_seed(SEED)
    backbone = init_backbone(gen, cfg, device="cpu")
    lora, houlsby = peft.init_lora(gen, cfg), peft.init_houlsby(gen, cfg)
    for layer in lora["layers"]:
        for k in ("b_q", "b_v"):
            layer[k] = torch.randn(layer[k].shape, generator=gen) * 0.05
    for layer in houlsby["layers"]:
        for k in ("up", "ln"):
            layer[k] = torch.randn(layer[k].shape, generator=gen) * 0.1
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen, dtype=torch.int32)
             for k in ("tokens", "labels")}
    runs = {"full": (lambda bb, t, o, b: steps.full_train_step(t, o, b, cfg=cfg), backbone,
                     lambda bb, t: backbone_logits(t, cfg, batch), 1e-4),
            "lora": (lambda bb, t, o, b: steps.lora_train_step(bb, t, o, b, cfg=cfg), lora,
                     lambda bb, t: peft.lora_logits(bb, t, cfg, batch), 1e-3),
            "adapters": (lambda bb, t, o, b: steps.houlsby_train_step(bb, t, o, b, cfg=cfg),
                         houlsby, lambda bb, t: peft.houlsby_logits(bb, t, cfg, batch), 1e-3)}
    to_card = lambda tree: tree_map(lambda t: t.to(DEV), tree)  # noqa: E731
    out = {}
    for name, (step, tree, logits, lr) in runs.items():
        cpu = step(backbone, tree, adamw_init(tree), batch)
        card_tree = to_card(tree)
        card = step(to_card(backbone), card_tree, adamw_init(card_tree), to_card(batch))
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), tree)
        flat = torch.autograd.grad(cross_entropy(logits(backbone, leaves), batch["labels"]),
                                   tree_leaves(leaves))
        it = iter(flat)
        grads = tree_map(lambda _: next(it), leaves)
        dloss = abs(float(card[0]) - float(cpu[0]))
        if not dloss <= 1e-5:
            raise AssertionError(f"{name} step on the card vs the CPU: loss {dloss} > 1e-5")
        rest, steep, n_steep = _update_close(cpu[1], card[1], grads, 1.0, lr)
        out[name] = {"loss_cpu": float(cpu[0]), "abs_dloss": dloss, "max_abs_dparam": rest,
                     "near_zero_grad_elements": n_steep, "near_zero_max_abs_dparam": steep}
    return out


def baselines_phase() -> dict:
    """Table V / Fig. 13a at full width (``benchmarks/bench_step_time.py``'s
    five techniques): on t5-base-pac and internlm2-1.8b, each a dense f32
    backbone drawn from the seed, B x S = 4 x 512, TF32 off: ``full``,
    ``lora`` (rank 8 on W_q, W_v), ``adapters`` (Houlsby, bottleneck 64),
    ``pac`` and ``pac_cached`` (r = 8) under the ``ref`` OpSet on the same
    backbone, and ``pac``/``pac_cached`` under ``cuda`` on its INT8
    quantization (int8 taps), as the training cell runs them. Per row: the
    median per-sample ms of 2 timed steps after a warm-up on one repeated
    batch, the peak memory, the trainable parameters, the losses, the
    kernels' launches a step; per model the savings of
    ``bench_step_time.py:81-86`` (reported, not gated). Gates: (a) LoRA's
    and Houlsby's logits at init equal ``backbone_logits`` bit for bit;
    (b) each baseline's losses finite and falling; (c)
    :func:`baselines_card_vs_cpu`. ``full`` runs last, consuming the
    backbone: its AdamW update holds ~8 copies of the parameters
    (internlm2: 1.89 G f32, 7.6 GB each). Returns the kernels' launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core import peft, steps
    from repro_torch.core.parallel_adapters import init_adapter
    from repro_torch.models.backbone import backbone_logits, init_backbone

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    line = {"phase": "baselines", "batch": BASELINE_B, "seq": BASELINE_S,
            "warmup_steps": 1, "timed_steps": BASELINE_STEPS,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "resident_at_start": torch.cuda.memory_allocated(), "models": {}}
    launches: dict = {}
    for arch in BASELINE_MODELS:
        cfg = get_arch(arch)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
        batch = {k: torch.randint(0, cfg.vocab, (BASELINE_B, BASELINE_S), generator=gen,
                                  device=DEV, dtype=torch.int32) for k in ("tokens", "labels")}
        lora = peft.init_lora(gen, cfg, device=DEV)
        houlsby = peft.init_houlsby(gen, cfg, device=DEV)
        adapter = init_adapter(gen, cfg, 8, device=DEV)
        rows = {}

        def timed(step, tree):  # t5-base-pac's rows are timed, not profiled (the budget)
            return _timed_steps(step, tree, profile=arch in PROFILED_BASELINES)

        # the INT8 backbone first, drawn and quantized leaf by leaf (the f32
        # tree is never resident), then the f32 one from the same seed: each
        # row's peak holds only the backbone it trains on
        for impl, suffix in (("cuda", "_cuda_int8"), ("ref", "")):
            bb = init_backbone(torch.Generator(device=DEV).manual_seed(SEED), cfg, device=DEV,
                               quant_bits=8 if impl == "cuda" else None)
            cached = {"labels": batch["labels"]}

            def pac(t, o, bb=bb, impl=impl, cached=cached):
                out = steps.pac_train_step(bb, t, o, batch, cfg=cfg, r=8, kernel_impl=impl,
                                           tap_policy="int8" if impl == "cuda" else "f32")
                cached.update(zip(("b0", "taps", "b_final"), out[3]))
                return out

            rows["pac" + suffix] = timed(pac, adapter)
            rows["pac_cached" + suffix] = timed(
                lambda t, o, bb=bb, impl=impl, cached=cached: steps.pac_cached_train_step(
                    bb, t, o, cached, cfg=cfg, r=8, kernel_impl=impl), adapter)
            for name in ("pac" + suffix, "pac_cached" + suffix):
                for k, v in rows[name]["launches_per_step"].items():
                    launches[k] = launches.get(k, 0) + v * BASELINE_STEPS
            del cached, pac
            if impl == "cuda":
                del bb
                torch.cuda.empty_cache()
        held = {"backbone": bb}
        backbone = bb
        del bb
        want = backbone_logits(backbone, cfg, batch)
        identity = {"lora": bool(torch.equal(peft.lora_logits(backbone, lora, cfg, batch), want)),
                    "adapters": bool(torch.equal(peft.houlsby_logits(backbone, houlsby, cfg,
                                                                     batch), want))}
        del want
        params = {"full": peft.peft_param_count(backbone), "lora": peft.peft_param_count(lora),
                  "adapters": peft.peft_param_count(houlsby), "pac": peft.peft_param_count(adapter)}
        rows["lora"] = timed(
            lambda t, o: steps.lora_train_step(backbone, t, o, batch, cfg=cfg), lora)
        rows["adapters"] = timed(
            lambda t, o: steps.houlsby_train_step(backbone, t, o, batch, cfg=cfg), houlsby)
        del lora, houlsby, adapter, backbone
        torch.cuda.empty_cache()
        # full fine-tuning last: its steps replace the backbone, of which no
        # other reference is left
        rows["full"] = timed(lambda t, o: steps.full_train_step(t, o, batch, cfg=cfg),
                                    held.pop("backbone"))
        torch.cuda.empty_cache()
        for name, row in rows.items():
            row["per_sample_ms"] = statistics.median(row["step_s"]) * 1e3 / BASELINE_B
            row["params_trainable"] = params[name.split("_")[0]]
        base = min(rows[n]["per_sample_ms"] for n in BASELINES)
        falling = {n: bool(all(np.isfinite(rows[n]["losses"]))
                           and rows[n]["losses"][-1] < rows[n]["losses"][0]) for n in BASELINES}
        line["models"][arch] = {
            "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab, "rows": rows,
            "pac_time_saving": 1 - rows["pac"]["per_sample_ms"] / base,
            "cached_saving": 1 - rows["pac_cached"]["per_sample_ms"] / base,
            "pac_cuda_int8_time_saving": 1 - rows["pac_cuda_int8"]["per_sample_ms"] / base,
            "cached_cuda_int8_saving": 1 - rows["pac_cached_cuda_int8"]["per_sample_ms"] / base,
            "memory_saving_vs_full": {
                n: 1 - rows[n]["max_memory_allocated"] / rows["full"]["max_memory_allocated"]
                for n in rows if n != "full"},
            "identity_start_bit_equal": identity, "losses_fall": falling}
        if not (all(identity.values()) and all(falling.values())):
            emit(line)
            raise AssertionError(f"{arch}: identity start {identity}, losses finite and "
                                 f"falling {falling}")
    line["card_vs_cpu"] = baselines_card_vs_cpu()
    line["card_vs_cpu_tol"] = {"loss": 1e-5, "params": 5e-5,
                               "near_zero_grad_params": "2·lr (ROADMAP C3)"}
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)
    return {k: int(round(v)) for k, v in launches.items()}


def distill_phase(gen: torch.Generator) -> dict:
    """``distillation_init`` at full width: internlm2-1.8b with an INT8
    backbone, the pruning start (``distillation_init(steps=0)``: W_up
    redrawn), 8 steps over 2 calibration batches of 2 x 512, run with the
    teacher through ``cuda`` (``quant_matmul``, flash; launches counted)
    and through ``ref``. Gates: the loss (the KL up to the teacher's
    entropy) falls from step 1 to step 8 in both runs; the runs agree
    (``DISTILL_TOL_REASON``). Returns the ``cuda`` run's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core.init_methods import _distill, distillation_init
    from repro_torch.core.quantization import tree_leaves
    from repro_torch.models.backbone import init_backbone

    cfg = get_arch("internlm2-1.8b")
    torch.cuda.empty_cache()
    backbone = init_backbone(gen, cfg, device=DEV, quant_bits=8)
    calib = [{"tokens": torch.randint(0, cfg.vocab, (DISTILL_B, 512), generator=gen,
                                      device=DEV, dtype=torch.int32)} for _ in range(2)]
    start = distillation_init(torch.Generator(device=DEV).manual_seed(SEED), backbone, cfg,
                              calib, r=8, steps=0)
    runs = {}
    for impl in ("cuda", "ref"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        adapter, losses = _distill(start, backbone, cfg, calib, r=8, steps=DISTILL_STEPS,
                                   kernel_impl=impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[impl] = {"adapter": adapter, "losses": [float(x) for x in losses],
                      "ms_per_step": wall * 1e3 / DISTILL_STEPS,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "launches": {k: v for k, v in read_launches().items() if v}}
    cuda_launches = runs["cuda"]["launches"]
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(
        tree_leaves(runs["cuda"]["adapter"]), tree_leaves(runs["ref"]["adapter"]))])
    kl_gap = [abs(a - b) for a, b in zip(runs["cuda"]["losses"], runs["ref"]["losses"])]
    share = float((diffs > 5e-5).float().mean())
    line = {"phase": "distill", "arch": cfg.name, "backbone": "int8", "init": "pruning",
            "r": 8, "steps": DISTILL_STEPS, "calib_batches": 2, "batch": DISTILL_B, "seq": 512,
            "adapter_params": int(diffs.numel()),
            **{f"{impl}_{k}": v for impl, run in runs.items() for k, v in run.items()
               if k != "adapter"},
            "cuda_launches_per_step": {k: v / DISTILL_STEPS for k, v in cuda_launches.items()},
            "abs_dkl_per_step": kl_gap, "max_abs_dadapter": float(diffs.max()),
            "share_dadapter_over_5e-5": share, "kl_rtol": DISTILL_KL_RTOL,
            "adapter_tol": {"max": 2 * 1e-3 * DISTILL_STEPS, "share_over_5e-5":
                            DISTILL_ADAPTER_SHARE}, "tol_reason": DISTILL_TOL_REASON}
    emit(line)
    for impl, run in runs.items():
        kl = run["losses"]
        if not (all(np.isfinite(kl)) and kl[-1] < kl[0]):
            raise AssertionError(f"distill ({impl}): the loss does not fall: {kl}")
    if any(g > DISTILL_KL_RTOL * max(1.0, abs(k)) for g, k in zip(kl_gap, runs["ref"]["losses"])):
        raise AssertionError(f"distill cuda vs ref: per-step loss gaps {kl_gap}")
    if float(diffs.max()) > 2 * 1e-3 * DISTILL_STEPS or share > DISTILL_ADAPTER_SHARE:
        raise AssertionError(f"distill cuda vs ref adapters: max {float(diffs.max())}, "
                             f"share past 5e-5 {share}")
    if min(cuda_launches.get(k, 0) for k in ("quant_matmul", "flash_attention")) <= 0:
        raise AssertionError(f"distill: frozen-forward kernels not launched: {cuda_launches}")
    return cuda_launches


# ------------------------------------------------------------------ the SSM family

XLSTM, JAMBA = "xlstm-125m", "jamba-1.5-large-398b"
XLSTM_D, XLSTM_DA, XLSTM_V = 768, 96, 50304  # r = 8
XLSTM_MAX_LEN, XLSTM_SLOTS = 320, 4  # prompts of 32-128 tokens + 16 new; 8 requests, 4 slots
#: the stepwise path's last prompt logits against one pass over the prompt
#: at xlstm's full width and depth
STEPWISE_TOL = 5e-2
STEPWISE_TOL_REASON = (
    "the reference's forward-vs-decode tests hold one mixer to 2e-4 (tests/test_ssm.py); the "
    "chunkwise and the recurrent mLSTM agree per block within ~5e-6 of its output's scale, and "
    "12 blocks compound that through the mLSTM's division by max(|n.q|, e^-m): on the CPU at "
    "this width the last logits of 64 and 240 stepwise tokens sat 6.1e-3 and 1.03e-2 from one "
    "pass (scale ~4.6); a state row lost or misplaced moves them by O(1)")
XLSTM_TRAIN_KERNELS = ("mix_fwd", "mix_dw", "ce_fwd", "ce_bwd")  # no quant_matmul, no flash
MAMBA_B, MAMBA_S = 2, 1024
MAMBA_TOL = 2e-4  # of the output's scale: the reference's forward-vs-decode tolerance
JAMBA_PAGE, JAMBA_SLOTS, JAMBA_MAX_LEN = 16, 2, 64


def stepwise_logits(backbone, cfg, ab, prompts, n_steps: int, impl: str, page: int,
                    max_len: int, r: int) -> list:
    """The prompts' first ``n_steps`` tokens fed one a step through
    ``paged_pac_decode_step`` (the engine's stepwise path) from fresh
    state rows, pages and adapter caches under the ``impl`` OpSet: the
    (B, V) logits of each step."""
    from repro_torch.core.parallel_adapters import init_adapter_cache
    from repro_torch.serve import paging
    from repro_torch.serve.decode import paged_pac_decode_step

    B = len(prompts)
    max_pages = -(-max_len // page)
    table = paging.PageTable(paging.PageAllocator(B * max_pages + 1), page, max_pages)
    for i in range(B):
        table.open(i, 0)
    pools = paging.init_pools(cfg, table.allocator.n_pages, page, "int8", DEV, n_slots=B)
    acache = init_adapter_cache(cfg, B, max_len, r, device=DEV) if ab is not None else None
    toks = torch.tensor([p[:n_steps] for p in prompts], dtype=torch.int32, device=DEV)
    out = []
    for t in range(n_steps):
        for i in range(B):
            table.extend_to(i, t + 1)
        bt, lengths = table.dense(range(B))
        lg, _, _ = paged_pac_decode_step(
            backbone, ab, toks[:, t:t + 1], pools, torch.from_numpy(bt).to(DEV),
            torch.from_numpy(lengths).to(DEV), acache, cfg=cfg, r=r, kernel_impl=impl)
        out.append(lg[:, 0])
        for i in range(B):
            table.append_token(i)
    return out


def serve_streams(backbone, cfg, users, prompts, impl: str, n_new: int, page: int,
                  max_len: int, slots: int, r: int = 8, kv_policy: str = "int8",
                  n_pages: int = None, schedule: dict = None):
    """The prompts through ``ServeEngine`` (``users`` in turn) over
    ``kv_policy`` pages (``n_pages`` of them, or the engine's default),
    drained: (the engine, each request's stream, wall seconds).
    ``schedule`` (a dict) gets the run's admissions (:func:`watch_schedule`)."""
    from repro_torch.serve import ServeEngine

    names = list(users)
    eng = ServeEngine(backbone, cfg, users, r=r, kernel_impl=impl, kv_policy=kv_policy,
                      page_size=page, max_len=max_len, max_batch=slots, n_pages=n_pages,
                      device=DEV)
    if schedule is not None:
        watch_schedule(eng, schedule)
    handles = [eng.submit(p, names[i % len(names)], max_new_tokens=n_new)
               for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.drain()
    wall = time.perf_counter() - t0
    streams = [h.result() for h in handles]
    for st in streams:
        if len(st) != n_new or not all(0 <= tok < cfg.vocab for tok in st):
            raise AssertionError(f"bad stream: {st}")
    return eng, streams, wall


def xlstm_serving_phase(gen: torch.Generator) -> dict:
    """xlstm-125m at full width and depth (12 layers: 9 mLSTM, 3 sLSTM,
    d 768, 4 heads, V 50304), random seeded INT8 weights, 4 users with
    r = 8 adapters, through ``ServeEngine``'s stepwise path: 8 requests of
    32-128 prompt tokens, ``CONFIG_NEW_TOKENS`` new tokens each, 4 slots (so 4 requests are
    admitted into retired rows), under ``cuda`` and ``ref``: every
    stream equal. Then 16 teacher-forced steps of the 8 requests under
    both OpSets (logits within 2e-2, greedy tokens equal), and the first
    request's whole prompt stepwise against one ``pac_logits`` pass over
    it (``STEPWISE_TOL``). No kernel runs on this path: the mixers are
    dequantized and dense, there is no attention and no FFN, and the
    engine's per-request adapters take the plain λ-mix (``adapter_fuse``,
    like the TPU kernel, takes one adapter): the launches are reported."""
    from repro_torch.configs import get_arch
    from repro_torch.core.opset import get_opset
    from repro_torch.core.parallel_adapters import gather_adapters, init_adapter, pac_logits
    from repro_torch.core.quantization import tree_storage_bytes
    from repro_torch.models.backbone import backbone_forward, init_backbone

    cfg = get_arch(XLSTM)
    page, n_new, r = 16, CONFIG_NEW_TOKENS, 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backbone = init_backbone(gen, cfg, device=DEV, quant_bits=8)
    users = {f"user{u}": init_adapter(gen, cfg, r=r, device=DEV) for u in range(4)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(32, 129, size=8)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    eng, streams, wall = serve_streams(backbone, cfg, users, prompts, "cuda", n_new, page,
                                       XLSTM_MAX_LEN, XLSTM_SLOTS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    ref_eng, ref_streams, ref_wall = serve_streams(backbone, cfg, users, prompts, "ref", n_new,
                                                   page, XLSTM_MAX_LEN, XLSTM_SLOTS)
    line = {"phase": "xlstm_serving", "arch": cfg.name, "layers": cfg.n_layers,
            "pattern": [s.kind for s in cfg.pattern], "params": cfg.param_count(),
            "backbone_bytes": tree_storage_bytes(backbone), "init_s": init_s,
            "requests": len(prompts), "users": len(users), "slots": XLSTM_SLOTS,
            "admitted_into_retired_rows": len(prompts) - XLSTM_SLOTS,
            "prompt_lens": [len(p) for p in prompts], "new_tokens": n_new,
            "prefill_mode": eng.prefill_mode, "decode_steps": eng.decode_steps,
            "stepwise_prompt_tokens": eng.stepwise_prompt_tokens,
            "decode_ms_per_step": eng.decode_seconds * 1e3 / eng.decode_steps,
            "ref_decode_ms_per_step": ref_eng.decode_seconds * 1e3 / ref_eng.decode_steps,
            "generated_tokens_per_s": len(prompts) * n_new / wall,
            "rows_per_s": eng.decode_tokens / eng.decode_seconds, "wall_s": wall,
            "ref_wall_s": ref_wall, "max_memory_allocated": peak, "launches": launches,
            "launches_per_step": {k: v / eng.decode_steps for k, v in launches.items()},
            "streams_equal": streams == ref_streams, "first_tokens": [s[:4] for s in streams]}
    del eng, ref_eng
    ab = gather_adapters(user_bank(users), torch.arange(8, device=DEV) % 4)
    logits = {impl: stepwise_logits(backbone, cfg, ab, prompts, 16, impl, page, XLSTM_MAX_LEN, r)
              for impl in ("cuda", "ref")}
    gaps = [max_err(a, b) for a, b in zip(logits["cuda"], logits["ref"])]
    greedy = all(bool(torch.equal(a.argmax(-1), b.argmax(-1)))
                 for a, b in zip(logits["cuda"], logits["ref"]))
    del logits
    first = prompts[0]
    ab1 = gather_adapters(user_bank(users), torch.zeros(1, dtype=torch.long, device=DEV))
    step_last = stepwise_logits(backbone, cfg, ab1, [first], len(first), "cuda", page,
                                XLSTM_MAX_LEN, r)[-1]
    with torch.no_grad():
        toks = torch.tensor([first], dtype=torch.int32, device=DEV)
        b_final, taps, x0, pos = backbone_forward(backbone, cfg, {"tokens": toks},
                                                  collect_taps=True, return_inputs=True,
                                                  ops=get_opset("cuda"))
        one_pass = pac_logits(backbone, users["user0"], cfg, x0, taps, b_final, pos, r)[:, -1]
    fwd_err = max_err(step_last, one_pass)
    line.update(cuda_vs_ref={"steps": 16, "max_abs_dlogits": gaps, "greedy_equal": greedy,
                             "tol": 2e-2},
                stepwise_vs_one_pass={"prompt_tokens": len(first), "max_abs_dlogits": fwd_err,
                                      "logit_scale": float(one_pass.abs().max()),
                                      "argmax_equal": bool(torch.equal(step_last.argmax(-1),
                                                                       one_pass.argmax(-1))),
                                      "tol": STEPWISE_TOL, "tol_reason": STEPWISE_TOL_REASON})
    emit(line)
    if not (line["streams_equal"] and max(gaps) <= 2e-2 and greedy and fwd_err <= STEPWISE_TOL
            and bool(torch.isfinite(step_last).all())):
        raise AssertionError(f"xlstm serving: {line}")
    return launches


def user_bank(users: dict):
    """The users' adapters stacked, in the engine's order."""
    from repro_torch.core.parallel_adapters import stack_adapters

    return stack_adapters([users[n] for n in users])


def mamba_layer_phase(gen: torch.Generator) -> dict:
    """One Mamba mixer at jamba-1.5-large-398b's full width (d 8192,
    d_inner 16384, d_state 16, conv 4), its leaves drawn f32 and quantized
    INT8 by the backbone's rule (``a_log`` (16384, 16) among them), then
    dequantized as the OpSets prepare an SSM block: ``mamba_forward`` over
    B x S = 2 x 1024 (its chunks of 128) against ``mamba_decode`` step by
    step over the same tokens, the outputs and the final state ``h``
    within ``MAMBA_TOL`` of their scale; both timed (host clock around a
    synchronised run: the scan is a loop of small ops), peak memory. No
    kernel: the mixer runs dense in both packages."""
    from repro_torch.configs import get_arch
    from repro_torch.core.quantization import (QTensor, maybe_dequantize_tree, quantize,
                                               should_quantize, tree_leaves)
    from repro_torch.models import ssm
    from repro_torch.models.layers import LeafMaker

    cfg = get_arch(JAMBA)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def finish(t, name=""):
        return quantize(t, 8) if should_quantize((name,), t) else t

    qp = ssm.init_mamba(LeafMaker(gen, device=DEV, finish=finish), cfg)
    quantized = sorted(k for k, v in qp.items() if isinstance(v, QTensor))
    p = maybe_dequantize_tree(qp)
    x = torch.randn(MAMBA_B, MAMBA_S, cfg.d_model, generator=gen, device=DEV)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def decode_all():
        cache = ssm.init_mamba_cache(cfg, MAMBA_B, device=DEV)
        outs = []
        for t in range(MAMBA_S):
            o, cache = ssm.mamba_decode(p, x[:, t:t + 1], cfg, cache)
            outs.append(o)
        return torch.cat(outs, 1), cache

    with torch.no_grad():
        ssm.mamba_forward(p, x[:, :256], cfg)  # warm-up
        fwd_s, (out, state) = timed(lambda: ssm.mamba_forward(p, x, cfg, return_state=True))
        dec_s, (dec, cache) = timed(decode_all)
    scale, h_scale = float(out.abs().max()), float(state["h"].abs().max())
    err, h_err = max_err(dec, out), max_err(cache["h"], state["h"])
    di, ds, dc = cfg.d_inner, cfg.ssm_d_state, cfg.ssm_d_conv
    line = {"phase": "mamba_layer", "arch": cfg.name, "d": cfg.d_model, "d_inner": di,
            "d_state": ds, "d_conv": dc, "B": MAMBA_B, "S": MAMBA_S, "chunk": 128,
            "quantized_leaves": quantized,
            "params": sum(t.numel() for t in tree_leaves(p)),
            "forward_ms": fwd_s * 1e3, "decode_ms_per_step": dec_s * 1e3 / MAMBA_S,
            "forward_ms_per_token": fwd_s * 1e3 / (MAMBA_B * MAMBA_S),
            "out_scale": scale, "max_abs_dout": err, "h_scale": h_scale, "max_abs_dh": h_err,
            "tol": f"{MAMBA_TOL} of the scale",
            "tol_reason": "the reference's forward-vs-decode tolerance (tests/test_ssm.py); "
                          "the scan's steps are the same f32 ops, the projections sum over "
                          "8192 and 16384 terms in other orders at M = 2 and M = 2048",
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(line)
    if not ("a_log" in quantized and err <= MAMBA_TOL * max(1.0, scale)
            and h_err <= MAMBA_TOL * max(1.0, h_scale) and bool(torch.isfinite(out).all())):
        raise AssertionError(f"mamba layer: {line}")
    return line


def jamba_kernel_phase(timer: Timer, gen: torch.Generator) -> dict:
    """The kernels at jamba-1.5-large-398b reduced's widths (d 256, 4 heads
    of 64 over one kv head, dense FFN 1024, V 512; a reduced config),
    against their plain versions: ``quant_matmul`` through the OpSet's
    wrapper over an attention layer's and a dense FFN's projections (W_k
    and W_v 64 wide: one quantization block a row, its codes padded to the
    kernel's 128) at the epoch-1 step's M = 4 x 64 and a decode step's
    M = 2; flash at B·H = 4·4 over one kv head, S = 64; paged at B = 2,
    Hkv = 1, n_rep = 4, hd 64; ``mix_fwd``/``mix_dw`` at d = 256, d_a = 32,
    ``ce_fwd``/``ce_bwd`` at V = 512 (both at T = 4 x 64), ``adapter_fuse``
    at T = 1 and 8; each timed beside its plain version, its bound and its
    library call. Returns each kernel's ``jamba_reduced`` entry."""
    from repro_torch.core.quantization import dequantize, quantize
    from repro_torch.kernels import ops

    label = "jamba-1.5-large-398b reduced"
    qmm = {}
    shapes = ((256, 256), (256, 64), (256, 1024), (1024, 256))
    for M in (2, 256):
        for K, N in shapes:
            x = torch.randn(M, K, generator=gen, device=DEV)
            w = quantize(torch.randn(K, N, generator=gen, device=DEV) * K ** -0.5, 8)
            got, want = ops.quant_matmul(x, w), x @ dequantize(w)
            err = float(((got - want).abs() - 1e-4 * want.abs()).max())
            check(f"quant_matmul {label} M={M} K={K} N={N} block={w.block}", err, 1e-3)
            ws = [w] + [quantize(torch.randn(K, N, generator=gen, device=DEV) * K ** -0.5, 8)
                        for _ in range(copies(w.q.numel()) - 1)]
            wfs = [dequantize(c) for c in ws[:copies(4 * K * N)]]
            nbytes = M * K * 4 + w.q.numel() + w.scale.numel() * 4 + M * N * 4
            b_ms, b_by = (bound(nbytes, 2.0 * M * N * K) if M <= QMM_SKINNY_ROWS
                          else bound(nbytes, 3 * 2.0 * M * N * K, BF16_FLOP_PER_S))
            r = {"check": "quant_matmul_jamba", "config": label, "M": M, "K": K, "N": N,
                 "block": w.block, "max_abs_err": max_err(got, want),
                 "tol": "atol 1e-3 + rtol 1e-4", "tol_reason": qmm_tol_reason(M),
                 "ms": timer([lambda c=c: ops.quant_matmul(x, c) for c in ws]),
                 "plain_ms": timer([lambda c=c: x @ dequantize(c) for c in ws]),
                 "library_ms": timer([lambda c=c: torch.matmul(x, c) for c in wfs]),
                 "library": "torch.matmul on the pre-dequantized f32 weight",
                 "bound_ms": b_ms, "bound_by": b_by}
            emit(r)
            qmm[(M, K, N)] = r
    rows = {"quant_matmul": {}}
    for M in (2, 256):  # the four distinct projection shapes, times summed
        rows["quant_matmul"][f"M{M}"] = {
            **{k: sum(qmm[(M, K, N)][k] for K, N in shapes)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "max_abs_err": max(qmm[(M, K, N)]["max_abs_err"] for K, N in shapes),
            "bound_by": qmm[(M, 256, 1024)]["bound_by"],
            "at": f"{label}'s 4 projection shapes at M={M} (W_k 64 wide, padded), int8 "
                  "(times summed)"}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at")
    r = flash_case(timer, gen, 4, 4, 1, 64, 64, f"{label} training")[0]
    emit(r)
    rows.update(gemma2_kernel_phase(timer, gen, label, (), 256, 32, 512, None, T=256))
    rows["flash_attention"] = {k: r[k] for k in keys}
    lengths = np.random.default_rng(SEED).integers(1, 64, size=2).astype(np.int32)
    rows["paged_attention"] = {k: v for k, v in paged_timed(
        timer, gen, lengths, 4, f"{label} decode B=2 Hkv=1 n_rep=4 hd=64 page=16 int8",
        Hkv=1, n_rep=4, hd=64).items() if k in keys}
    return rows


def jamba_hybrid_phase(gen: torch.Generator) -> dict:
    """jamba-1.5-large-398b at ``reduced()`` (a reduced config: 16 layers,
    two periods of 7 Mamba layers and one attention layer, MoE on every
    other layer with 4 experts, d 256) through the ``cuda`` OpSet on the
    card, INT8 backbone: the hybrid stepwise engine (attention pages
    beside Mamba state rows, 2 users' adapters, 4 requests of 9-24 prompt
    tokens, 8 new each, 2 slots) under ``cuda`` and ``ref``, streams
    equal, with ``paged_attention`` and ``quant_matmul`` launched and
    counted; then one PAC+ session, 2 epochs of 1 step of 4 x 64 tokens
    (full, then cached), with flash, ``quant_matmul`` and the four
    training kernels counted, and its cached step and trainer held to
    ``ref``. jamba at full width waits for per-expert dequantization
    (ROADMAP A6.4b)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.parallel_adapters import init_adapter
    from repro_torch.models.backbone import init_backbone
    from repro_torch.runtime import EdgeSession, EpochReport, EpochRunner, RunSpec

    cfg = get_arch(JAMBA).reduced()
    label = "reduced config"
    backbone = init_backbone(gen, cfg, device=DEV, quant_bits=8)
    users = {f"user{u}": init_adapter(gen, cfg, r=8, device=DEV) for u in range(2)}
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(9, 25, size=4)]
    reset_launches()
    eng, streams, wall = serve_streams(backbone, cfg, users, prompts, "cuda", 8, JAMBA_PAGE,
                                       JAMBA_MAX_LEN, JAMBA_SLOTS)
    serve_launches = read_launches()
    _, ref_streams, _ = serve_streams(backbone, cfg, users, prompts, "ref", 8, JAMBA_PAGE,
                                      JAMBA_MAX_LEN, JAMBA_SLOTS)
    serving = {"requests": len(prompts), "slots": JAMBA_SLOTS, "prefill_mode": eng.prefill_mode,
               "decode_steps": eng.decode_steps, "wall_s": wall,
               "decode_ms_per_step": eng.decode_seconds * 1e3 / eng.decode_steps,
               "launches": serve_launches, "streams_equal": streams == ref_streams}
    del eng, backbone
    spec = RunSpec(arch=JAMBA, reduced=True, quant=8, cache_compress="int8", kernels="cuda",
                   init="pruning", epochs=2, steps_per_epoch=1, batch=4, seq=64, seed=SEED)
    s = EdgeSession(spec, log=print, device=DEV).open()
    reset_launches()
    events = list(EpochRunner(s).events())
    train_launches = read_launches()
    reports = [e for e in events if isinstance(e, EpochReport)]
    steps_ = [e for e in events if not isinstance(e, EpochReport)]
    cached_step_gate(s, spec)
    s.close()
    del s
    trainer_gate(spec, [r.mean_loss for r in reports])
    line = {"phase": "jamba_hybrid", "arch": cfg.name, "config": label, "layers": cfg.n_layers,
            "pattern": [s_.kind + ("+moe" if s_.moe else "") for s_ in cfg.pattern],
            "d_model": cfg.d_model, "serving": serving,
            "training": {"modes": [r.mode for r in reports],
                         "epoch_losses": [r.mean_loss for r in reports],
                         "step_s": [e.wall_s for e in steps_], "launches": train_launches}}
    emit(line)
    need = {"serving": ("quant_matmul", "paged_attention"),
            "training": ("quant_matmul", "flash_attention", "mix_fwd", "mix_dw", "ce_fwd",
                         "ce_bwd")}
    missing = [f"{path}:{k}" for path, keys in need.items() for k in keys
               if line[path]["launches"][k] <= 0]
    if missing or not serving["streams_equal"] or line["training"]["modes"] != ["full",
                                                                                 "cached"]:
        raise AssertionError(f"jamba hybrid ({label}): missing launches {missing}: {line}")
    return {k: serve_launches[k] + train_launches[k] for k in serve_launches}

# ---------------------------------------------------------------- qwen2-vl-7b (mrope)

QWEN2VL = "qwen2-vl-7b"
#: one qwen2-vl-7b layer's seven projections (K, N): wq, wk, wv, wo, wi, wg, the FFN's wo
QWEN2VL_PROJECTIONS = [(3584, 3584), (3584, 512), (3584, 512), (3584, 3584),
                       (3584, 18944), (3584, 18944), (18944, 3584)]
QWEN2VL_D, QWEN2VL_DA, QWEN2VL_V = 3584, 444, 152064  # r = 8: 3 adapter heads of 148
QWEN2VL_MAX_LEN = 544
#: the paged kernel at n_rep 7 (28 query heads over 4 kv heads): B, Hkv, n_rep, hd, page,
#: max_pages, lengths, padding rows
QWEN2VL_PAGED_RAGGED = [
    (1, 1, 7, 128, 16, 34, [543], ()),
    (3, 4, 7, 128, 16, 34, [0, 16, 543], (0,)),
    (8, 4, 7, 128, 4, 136, [3, 4, 5, 127, 128, 300, 542, 543], ()),
    (72, 4, 7, 128, 16, 34, list(np.random.default_rng(SEED + 5).integers(0, 544, size=72)),
     (5,)),
]
MROPE_SANITY = 10  # distinct streams must move the logits by this many serving gates


def qwen2vl_kernel_phase(timer: Timer, gen: torch.Generator) -> dict:
    """The kernels at qwen2-vl-7b's widths against their plain versions,
    timed beside their bounds and library calls: ``quant_matmul`` over a
    layer's seven projections (K = 3584 and 18944) at M = 8 and 4096;
    ``mix_fwd``/``mix_dw`` at d = 3584 and the adapter's ragged d_a = 444
    (the last 64-column tile 60 wide); ``ce_fwd``/``ce_bwd`` over
    V = 152064, no soft-cap; ``adapter_fuse`` at T = 1 and 8; flash at the
    prefill's B·H = 8·28 over 8·4 (n_rep 7, hd 128, S = 512, causal: a
    tile of query heads spans two kv heads) and at the ragged shapes with
    n_rep 7; paged attention at B = 8, Hkv = 4, n_rep = 7 (7 of a block's
    8 query rows live), int8 pages of 16, lengths <= 511 and <= 4095,
    the ragged cases at n_rep 7 and bit-equal reruns and graph replays.
    Returns each kernel's ``qwen2vl`` entry."""
    rows = gemma2_kernel_phase(timer, gen, QWEN2VL, QWEN2VL_PROJECTIONS, QWEN2VL_D, QWEN2VL_DA,
                               QWEN2VL_V, None)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms",
            "bound_f32_ms", "library_ms", "at")
    r, _, sdpa = flash_case(timer, gen, 8, 28, 4, 512, 128, "qwen2-vl-7b prefill")
    r["library_kernels"] = device_kernels(sdpa)
    emit(r)
    del sdpa
    rows["flash_attention"] = {k: r[k] for k in keys}
    flash_ragged(gen, hds=(128,), n_reps=(7,))
    pkeys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at", "plan")
    lengths = np.random.default_rng(SEED).integers(1, 512, size=8).astype(np.int32)
    rows["paged_attention"] = {k: v for k, v in paged_timed(
        timer, gen, lengths, 32, "qwen2-vl-7b decode B=8 Hkv=4 n_rep=7 hd=128 page=16 int8, "
        "lengths<=511", Hkv=4, n_rep=7, hd=128).items() if k in pkeys}
    long_lengths = np.random.default_rng(SEED + 2).integers(1, 4096, size=8).astype(np.int32)
    long = paged_timed(timer, gen, long_lengths, 256, "qwen2-vl-7b long context B=8 Hkv=4 "
                       "n_rep=7 hd=128 page=16 int8, lengths<=4095", Hkv=4, n_rep=7, hd=128)
    rows["paged_attention"]["long"] = {k: long[k] for k in pkeys}
    paged_ragged(gen, QWEN2VL_PAGED_RAGGED)
    paged_deterministic(gen, lengths, 32, Hkv=4, n_rep=7, hd=128)
    return rows


def vl_batch(cfg, B: int, S: int, seed: int) -> dict:
    """A seeded batch laid out as Qwen2-VL lays a text-image-text prompt
    (``models.layers.vision_positions``): per row a text prefix of 16-63
    tokens, an image of 1 x h x w patches (h, w in 12-19; one row a video
    of 2 frames of 10 x w), then text continuing from the largest id + 1
    on all three streams. Tokens and labels random (the vision
    frontend is stubbed, as in the reference). {"tokens", "labels",
    "positions" (3, B, S)} on the card."""
    from repro_torch.models.layers import vision_positions

    rng = np.random.default_rng(seed)
    rows = []
    for b in range(B):
        grid = ((2, 10, int(rng.integers(12, 20))) if b == B - 1
                else (1, int(rng.integers(12, 20)), int(rng.integers(12, 20))))
        n_before = int(rng.integers(16, 64))
        rows.append(vision_positions(n_before, grid, S - n_before - int(np.prod(grid))))
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, S)).astype(
                np.int32)).to(DEV),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, S)).astype(
                np.int32)).to(DEV),
            "positions": torch.stack(rows, dim=1).to(DEV)}


def qwen2vl_mrope_phase(backbone, adapter, cfg, r: int = 8) -> dict:
    """The trained qwen2-vl-7b model on one batch of 4 x 512 tokens whose
    three mrope streams differ (:func:`vl_batch`), at full width and
    depth: the PAC+ logits (backbone, adapter, head) under ``cuda`` and
    ``ref`` within the serving gate 2e-2; one epoch-1 step
    (``pac_train_step``, f32 taps) and one cached step
    (``pac_cached_train_step`` over int8 entries whose batch carries the
    ``positions``) under both, loss within 2e-5 and gradients within
    1e-4·max(1, |g|max) (the cached step's gates; each step at lr 0 and
    no clip, its gradient read back from AdamW's first moment); and the
    logits with equal streams (the default positions) differing from
    those with distinct streams by more than ``MROPE_SANITY`` serving
    gates, so the streams reach the attention. Decode is not compared
    after such a prompt: the reference gives a decode token the same
    position on every stream, and so does the port."""
    from repro_torch.core.opset import get_opset
    from repro_torch.core.parallel_adapters import pac_logits
    from repro_torch.core.quantization import tree_leaves
    from repro_torch.core.steps import pac_cached_train_step, pac_train_step
    from repro_torch.models.backbone import backbone_forward
    from repro_torch.optim import adamw_init

    B, S, b1 = 4, 512, 0.9
    batch = vl_batch(cfg, B, S, SEED + 7)
    pos = batch["positions"]

    def logits(impl, with_positions=True):
        b = batch if with_positions else {"tokens": batch["tokens"]}
        with torch.no_grad():
            bf, taps, x, p = backbone_forward(backbone, cfg, b, collect_taps=True,
                                              return_inputs=True, ops=get_opset(impl))
            return pac_logits(backbone, adapter, cfg, x, taps, bf, p, r)

    def grads_of(opt):  # lr 0, no clip: AdamW's first moment is (1 - b1)·g
        return [m / (1 - b1) for m in tree_leaves(opt["mu"])]

    reset_launches()
    lc = logits("cuda")
    launches = {k: v for k, v in read_launches().items() if v}
    lr_ = logits("ref")
    plain = logits("cuda", with_positions=False)
    dlogits = max_err(lc, lr_)
    moved = max_err(lc, plain)
    greedy = float((lc.argmax(-1) == lr_.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(lc).all() and torch.isfinite(lr_).all())
    del lc, lr_, plain

    epoch1 = {}
    for impl in ("cuda", "ref"):
        loss, _, opt, _ = pac_train_step(backbone, adapter, adamw_init(adapter), batch, cfg=cfg,
                                         r=r, lr=0.0, clip=None, kernel_impl=impl)
        epoch1[impl] = (float(loss), grads_of(opt))
    reset_launches()
    _, _, _, (b0q, tapsq, bfq) = pac_train_step(backbone, adapter, adamw_init(adapter), batch,
                                                cfg=cfg, r=r, lr=0.0, clip=None,
                                                kernel_impl="cuda", tap_policy="int8")
    launches_epoch1 = {k: v for k, v in read_launches().items() if v}
    cached_b = {"b0": b0q, "taps": tapsq, "b_final": bfq, "labels": batch["labels"],
                "positions": pos}
    cached = {}
    reset_launches()
    for impl in ("cuda", "ref"):
        loss, _, opt = pac_cached_train_step(backbone, adapter, adamw_init(adapter), cached_b,
                                             cfg=cfg, r=r, lr=0.0, clip=None, kernel_impl=impl)
        cached[impl] = (float(loss), grads_of(opt))
        if impl == "cuda":
            launches_cached = {k: v for k, v in read_launches().items() if v}

    def gate(res):
        gmax = max(float(g.abs().max()) for g in res["ref"][1])
        return {"loss": [res["cuda"][0], res["ref"][0]],
                "abs_dloss": abs(res["cuda"][0] - res["ref"][0]),
                "max_abs_dgrad": max(max_err(a, b) for a, b in zip(res["cuda"][1], res["ref"][1])),
                "grad_max": gmax, "tol": {"loss": 2e-5, "grads": 1e-4 * max(1.0, gmax)}}

    steps = {"epoch1_f32_taps": gate(epoch1), "cached_int8": gate(cached)}
    tol = 2e-2
    line = {"phase": "qwen2vl_mrope", "arch": cfg.name, "batch": B, "seq": S,
            "positions": "(3, B, S): text, an image grid (one row a 2-frame video), text",
            "streams_distinct": bool((pos[0] != pos[1]).any() and (pos[1] != pos[2]).any()),
            "max_position": [int(pos[i].max()) for i in range(3)],
            "logits": {"max_abs_dlogits": dlogits, "greedy_agreement": greedy,
                       "finite": finite, "tol": tol},
            "equal_streams_max_abs_dlogits": moved, "sanity_min": MROPE_SANITY * tol,
            "steps": steps, "launches_logits": launches, "launches_epoch1": launches_epoch1,
            "launches_cached": launches_cached,
            "tol_reason": "the serving gate for logits; the reference's pallas-vs-ref "
                          "cached-step tolerances (tests/test_cached_step.py:163-190) for "
                          "both steps: f32 sums reorder, the taps f32 in the epoch-1 step"}
    emit(line)
    bad = [k for k, g in steps.items()
           if not (g["abs_dloss"] <= g["tol"]["loss"] and g["max_abs_dgrad"] <= g["tol"]["grads"])]
    if bad or not (finite and dlogits <= tol and moved > MROPE_SANITY * tol
                   and line["streams_distinct"]):
        raise AssertionError(f"qwen2-vl mrope: steps {bad} or logits {line['logits']}, "
                             f"equal streams moved {moved}")
    return {k: launches.get(k, 0) + launches_epoch1.get(k, 0) + launches_cached.get(k, 0)
            for k in set(launches) | set(launches_epoch1) | set(launches_cached)}


# ---------------------------------------------------------------- the roofline

#: moonshot-v1-16b-a3b's four attention projections (K, N): wq wk wv wo, 16 heads over 16
MOONSHOT = "moonshot-v1-16b-a3b"
MOONSHOT_PROJECTIONS = [(2048, 2048)] * 4
MOONSHOT_D, MOONSHOT_DA, MOONSHOT_V = 2048, 256, 163840  # r = 8: 2 adapter heads of 128
MOONSHOT_POOL = 8  # Jetson Nano-H profiles whose memory holds the INT8 model (7 the fewest)
GROK = "grok-1-314b"
GROK_LAYERS = 6  # the depth cut: grok_cut's docstring gives the reckoning
GROK_PROJECTIONS = [(6144, 6144), (6144, 1024), (6144, 1024), (6144, 6144)]  # 48 heads over 8
GROK_D, GROK_DA, GROK_V = 6144, 768, 131072  # r = 8: 6 adapter heads of 128 over 1
MOE_MAX_LEN = 544
#: the paged kernel at n_rep 6 (grok: 48 query heads over 8 kv heads, and its adapter's 6 over
#: 1): B, Hkv, n_rep, hd, page, max_pages, lengths, padding rows
GROK_PAGED_RAGGED = [
    (1, 1, 6, 128, 16, 34, [543], ()),
    (3, 8, 6, 128, 16, 34, [0, 16, 543], (0,)),
    (8, 8, 6, 128, 4, 136, [3, 4, 5, 127, 128, 300, 542, 543], ()),
    (72, 8, 6, 128, 16, 34, list(np.random.default_rng(SEED + 6).integers(0, 544, size=72)),
     (5,)),
]
#: the paged kernel at moonshot's 16 kv heads of one query head each
MOONSHOT_PAGED_RAGGED = [
    (3, 16, 1, 128, 16, 34, [0, 16, 543], (0,)),
    (72, 16, 1, 128, 16, 34, list(np.random.default_rng(SEED + 7).integers(0, 544, size=72)),
     (5,)),
]


def grok_cut():
    """grok-1-314b at its published width over ``GROK_LAYERS`` of its 64
    layers: every field of the config but ``name`` and ``n_layers``,
    registered once under its own name so that ``RunSpec(arch=...)`` and
    ``get_arch`` resolve it (the reference cuts depth the same way,
    ``src/repro/launch/costs.py:105``).

    The depth is the largest even count, at least 2, at which every grok
    phase's peak stays under 72 GB of the card's 80, reckoned from a
    2-layer run (NVIDIA H100 80GB HBM3, 700.00 W): its phases peaked at
    41.76 GB (the ``cuda`` training session; serving 40.83, its
    comparison 41.23, the ``ref`` session 39.12, personal 38.32), on an
    INT8 backbone of 11.81 GB, 1.66 GB of it the embedding and head and
    5.07 GB each layer (4.92 G values and a scale a 128). A layer's
    experts dequantized whole (19.3 GB of f32) are transient, one block at
    a time, so k layers peak at ~41.76 + 5.07 (k - 2) GB: 62.0 at 6, 72.2
    at 8. At 6 the phases peaked at 66.88 GB (the serving comparison; the
    training session 63.31): a layer adds 6.41 GB to serving (its INT8
    and 16 f32 copies of the layer's 81 MB adapter: 4 users, their bank,
    8 gathered rows), so 8 layers would need ~79.7."""
    from repro_torch.configs import get_arch, register

    name = f"{GROK}-cut{GROK_LAYERS}"
    try:
        return get_arch(name)
    except KeyError:  # the first call registers it
        return register(dataclasses.replace(get_arch(GROK), name=name, n_layers=GROK_LAYERS))


def moe_kernel_phase(timer: Timer, gen: torch.Generator, arch: str) -> dict:
    """The kernels at moonshot-v1-16b-a3b's or grok-1-314b's widths
    against their plain versions, timed beside their bounds and library
    calls: ``quant_matmul`` over a layer's four attention projections
    (moonshot K = N = 2048; grok K = 6144, N = 6144 and 1024; the experts
    are dequantized, not sent through it) at M = 1, 8, 2048 and 4096;
    ``mix_fwd``/``mix_dw`` at d = 2048 / d_a = 256 or 6144 / 768; CE over
    V = 163840 or 131072, no final soft-cap; ``adapter_fuse`` at T = 1
    and 8; flash at the prefill's B·H = 8·16 over 8·16 (n_rep 1) or 8·48
    over 8·8 (n_rep 6, soft-cap 30) and at the adapter's heads, 4·2 over
    4·2 or 4·6 over 4·1 (soft-cap 30; no path launches it there: the
    adapter's attention runs plain, as in the reference), S = 512, hd 128;
    for grok the ragged flash
    cases at n_rep 6; paged attention at B = 8 over Hkv 16, n_rep 1 or
    Hkv 8, n_rep 6 with soft-cap 30, int8 pages of 16, lengths <= 511 (and
    for grok <= 4095), the ragged cases and bit-equal reruns and graph
    replays. Returns each kernel's entry for the config."""
    grok = arch == GROK
    projections, d, da, V = ((GROK_PROJECTIONS, GROK_D, GROK_DA, GROK_V) if grok else
                             (MOONSHOT_PROJECTIONS, MOONSHOT_D, MOONSHOT_DA, MOONSHOT_V))
    H, Hkv, Ha, Hkva = (48, 8, 6, 1) if grok else (16, 16, 2, 2)
    cap = 30.0 if grok else None
    rows = gemma2_kernel_phase(timer, gen, arch, projections, d, da, V, None, Ms=PATH_QMM_ROWS)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms",
            "bound_f32_ms", "library_ms", "at")
    r, _, sdpa = flash_case(timer, gen, 8, H, Hkv, 512, 128, f"{arch} prefill", cap)
    r["library_kernels"] = device_kernels(sdpa)
    emit(r)
    del sdpa
    rows["flash_attention"] = {k: r[k] for k in keys}
    a = flash_case(timer, gen, 4, Ha, Hkva, 512, 128,
                   f"{arch} adapter heads (no path: the adapter's attention runs plain)", cap)[0]
    emit(a)
    rows["flash_attention"]["adapter"] = {k: a[k] for k in keys}
    if grok:
        flash_ragged(gen, hds=(128,), n_reps=(6,))
    pkeys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "at", "plan")
    n_rep = H // Hkv
    lengths = np.random.default_rng(SEED).integers(1, 512, size=8).astype(np.int32)
    at = f"decode B=8 Hkv={Hkv} n_rep={n_rep} hd=128 page=16 int8" + (" cap 30" if cap else "")
    rows["paged_attention"] = {k: v for k, v in paged_timed(
        timer, gen, lengths, 32, f"{arch} {at}, lengths<=511", Hkv=Hkv, n_rep=n_rep, hd=128,
        cap=cap).items() if k in pkeys}
    if grok:
        long_lengths = np.random.default_rng(SEED + 2).integers(1, 4096, size=8).astype(np.int32)
        long = paged_timed(timer, gen, long_lengths, 256, f"{arch} long context {at}, "
                           "lengths<=4095", Hkv=Hkv, n_rep=n_rep, hd=128, cap=cap)
        rows["paged_attention"]["long"] = {k: long[k] for k in pkeys}
    paged_ragged(gen, GROK_PAGED_RAGGED if grok else MOONSHOT_PAGED_RAGGED)
    paged_deterministic(gen, lengths, 32, Hkv=Hkv, n_rep=n_rep, hd=128)
    return rows


# ---------------------------------------------------------------- MoE and SSM, distributed

MOE_DIST_LAYERS = 4  # mixtral-8x7b's depth on the distributed path: moe_dist_cut's reckoning
SSM_PLAN_SEQ = 128  # xlstm's tokens a row on the plan path: a quarter of the training cell's
#: xlstm-125m's 3 periods over 2 stages, 2 devices each: the only 2-stage layout (ragged)
SSM_PLAN_LAYERS = ((0, 0), (1, 2))
#: each family's distributed path at the shapes one rank gives its kernels: (quant_matmul's
#: M, the layer's projections, flash's (B, H, Hkv, hd) or None, (d, d_a, V), the mix and CE
#: kernels' T: the epoch-1 loss over a dp row's rows, then the cached step's rows a rank)
FAMILY_DIST_WIDTHS = {
    "mixtral-8x7b": (512, MIXTRAL_PROJECTIONS, (1, 32, 8, 128), (MIXTRAL_D, MIXTRAL_DA, MIXTRAL_V),
                     (1024, 512)),
    "xlstm-125m": (SSM_PLAN_SEQ, [], None, (XLSTM_D, XLSTM_DA, XLSTM_V),
                   (2 * SSM_PLAN_SEQ, SSM_PLAN_SEQ)),
}
FAMILY_TOL_REASON = (
    "the replica runs each rank's rows through the same ops one route unit at a time, so only "
    "the order of f32 sums differs: the distributed gates (first step 1e-4, every step "
    "DIST_STEP_TOL, epochs 5e-2, b0 codes bit-equal, tap codes one step)")


def moe_dist_cut():
    """mixtral-8x7b at its published width over ``MOE_DIST_LAYERS`` of its
    32 layers, registered as :func:`grok_cut` registers grok's (``reduced``
    lists the depth alone). Four ranks share the card and each draws the
    whole backbone (``runtime/session.py`` ``open``; the reference's
    session does the same): a layer holds 1.451 G values (attention 41.9
    M, experts 1409.3 M), so 4 layers are ~5.8 GB of INT8 codes, 0.18 GB
    of scales and the f32 embedding and head (0.52 GB each), and each
    block's experts dequantized whole add 5.6 GB of f32 while it runs:
    ~12-13 GB a rank at peak, ~50 GB over the four. Two layers a stage
    keep 2 periods a stage at dp 2 x stages 2."""
    from repro_torch.configs import get_arch, register

    name = f"{MIXTRAL}-cut{MOE_DIST_LAYERS}"
    try:
        return get_arch(name)
    except KeyError:  # the first call registers it
        return register(dataclasses.replace(get_arch(MIXTRAL), name=name,
                                            n_layers=MOE_DIST_LAYERS))


def moe_dist_rank(spec, runs: int) -> dict:
    """:func:`distributed_rank` on a rank of the MoE phase: the depth cut is
    registered in the rank's process first (ranks import the registry
    afresh)."""
    moe_dist_cut()
    return distributed_rank(spec, runs)


def _cat_rows(parts: list, dim: int):
    """Cache entries of consecutive rows (tensors or int8 QTensors) joined
    along their batch axis."""
    from repro_torch.core.quantization import QTensor

    if isinstance(parts[0], QTensor):
        p = parts[0]
        return QTensor(torch.cat([x.q for x in parts], dim),
                       torch.cat([x.scale for x in parts], dim), p.bits, p.block, p.orig_last)
    return torch.cat(parts, dim)


def _routes_otherwise(whole: list, units: list) -> dict:
    """Per MoE layer, the tokens the whole batch routes or keeps otherwise
    than its route units do (``record_routes`` records; ``units``:
    (rows, records) in sample order)."""
    out = []
    for layer, w in enumerate(whole):
        moved = sum(int(((u[layer]["top_e"] != w["top_e"][rows])
                         | (u[layer]["kept"] != w["kept"][rows])).any(-1).sum())
                    for rows, u in units)
        dropped = int((~w["kept"]).any(-1).sum())
        out.append({"moved": moved, "tokens": int(w["top_e"][..., 0].numel()),
                    "whole_dropped": dropped,
                    "units_dropped": sum(int((~u[layer]["kept"]).any(-1).sum())
                                         for _, u in units)})
    return out


def route_unit_run(spec, n_micro: int, dp: int) -> dict:
    """One process on ``spec`` (no mesh), the distributed run's replica:
    epoch 0's batches through ``backbone_forward`` under ``cuda`` one
    route unit at a time (a dp rank's rows of one micro-batch: what a
    rank's stages route and run together), their int8 entries joined in
    sample order into an ``ActivationCache``, and every step
    ``pac_cached_train_step`` over the entries in the run's data order,
    from the session's seeded adapter. Returns the replica's step and
    epoch losses and epoch 0's entries by sample id (:func:`parity`'s
    ``single``). With MoE layers, what distribution changes: each epoch-0
    batch also runs whole through the same forward (per MoE layer, the
    tokens it routes otherwise, ``record_routes``), and the same session
    runs whole through ``EpochRunner``."""
    from repro_torch.core import steps
    from repro_torch.core.activation_cache import ActivationCache
    from repro_torch.core.opset import get_opset
    from repro_torch.core.quantization import tree_map
    from repro_torch.models.backbone import backbone_forward
    from repro_torch.models.moe import record_routes
    from repro_torch.runtime import EdgeSession, EpochRunner

    t0 = time.perf_counter()
    s = EdgeSession(spec, device=DEV).open()
    cfg, ops = s.cfg, get_opset("cuda", spec.cache_compress)
    a, o = (tree_map(torch.clone, t) for t in (s.adapter, s.opt))
    cache = ActivationCache(compress=spec.cache_compress)
    mb = spec.batch // n_micro
    q = mb // dp
    units = [slice(m * mb + r * q, m * mb + (r + 1) * q) for m in range(n_micro)
             for r in range(dp)]
    losses, epoch_losses, routes, out = [], [], [], {}
    for epoch in range(spec.epochs):
        el = []
        for batch in s.pipe.epoch(epoch):
            ids = batch["seq_ids"]
            labels = torch.from_numpy(batch["labels"]).to(DEV)
            if epoch == 0:
                tokens = torch.from_numpy(batch["tokens"]).to(DEV)
                parts, recs = [], []
                with torch.no_grad():
                    for rows in units:
                        with record_routes() as rec:
                            bf, taps, x0, _ = backbone_forward(
                                s.backbone, cfg, {"tokens": tokens[rows]}, collect_taps=True,
                                return_inputs=True, ops=ops)
                        parts.append((ops.emit_tap(x0), taps, ops.emit_tap(bf)))
                        recs.append((rows, rec))
                    if cfg.moe is not None:
                        with record_routes() as whole_routes:
                            backbone_forward(s.backbone, cfg, {"tokens": tokens}, ops=ops)
                        routes.append(_routes_otherwise(whole_routes, recs))
                entries = tuple(_cat_rows([p[i] for p in parts], dim)
                                for i, dim in enumerate((0, 1, 0)))
                cache.put_batch(ids, *entries, orig_last=cfg.d_model)
            else:
                entries = tuple(h.to(DEV) for h in cache.get_batch(
                    ids, with_final=True, dtype=None, compressed=True))
            cached = dict(zip(("b0", "taps", "b_final"), entries), labels=labels)
            loss, a, o = steps.pac_cached_train_step(s.backbone, a, o, cached, cfg=cfg, r=spec.r,
                                                     lr=spec.lr, kernel_impl="cuda")
            losses.append(float(loss))
            el.append(losses[-1])
        epoch_losses.append(sum(el) / len(el))
    out.update(replica={"step_losses": losses, "epoch_losses": epoch_losses,
                        "codes": {int(k): cache.get(int(k), with_final=True, dtype=None,
                                                    compressed=True)
                                  for ids in s.pipe.epoch_order(0) for k in ids}},
               routes=routes, replica_s=time.perf_counter() - t0)
    del a, o, cache
    if cfg.moe is not None:
        t1 = time.perf_counter()
        reports = EpochRunner(s).run()
        out["whole"] = {"modes": [r.mode for r in reports],
                        "step_losses": [x for r in reports for x in r.losses],
                        "epoch_losses": [r.mean_loss for r in reports],
                        "run_s": time.perf_counter() - t1}
    s.close()
    del s
    torch.cuda.empty_cache()
    return out


def family_rank_launches(ranks: list, stages: int, epoch1: dict) -> list:
    """Each rank's launches a step of a family's distributed run, held:
    in an epoch-1 step ``epoch1`` (kernel: count, or None for "at least
    one") on every rank, and the four training kernels on each dp row's
    first stage (its loss) and none on the others; in a cached step the
    four on every rank (the cached rows shard over the whole pool).
    Returns the rows that fail."""
    bad = []
    for r in ranks:
        head = r["rank"] % stages == 0
        for j, st in enumerate(r["runs"][0]["steps"]):
            got = st["launches"]
            if st["mode"].startswith("cached"):
                ok = all(got[k] > 0 for k in CACHED_KERNELS)
            else:
                ok = (all(got[k] > 0 if n is None else got[k] == n for k, n in epoch1.items())
                      and all((got[k] > 0) == head for k in CACHED_KERNELS))
            if not ok:
                bad.append({"rank": r["rank"], "step": j, "mode": st["mode"], "launches": got})
    return bad


def moe_distributed_phase() -> dict:
    """mixtral-8x7b at full width over ``MOE_DIST_LAYERS`` layers
    (:func:`moe_dist_cut`) on the distributed path, as the distributed
    phase runs internlm2-1.8b: INT8, int8 cache, r 8, pruning init,
    ``cuda``, dp 2 x stages 2 (2 periods a stage, 2 micro-batches of 1 x
    512 a rank), 2 epochs x 2 steps of 4 x 512, four gloo ranks sharing
    the card, once through :func:`distributed_rank`. At the published
    capacity factor 1.25 a rank routes its 512 tokens alone, so the whole
    batch in one process drops other tokens; the gate is the replica that
    routes as the ranks do (:func:`route_unit_run`): :func:`check_parity`
    against it, every rank's adapter and optimizer bit-equal after every
    step, and on every rank in an epoch-1 step ``quant_matmul`` 4
    projections x 2 layers x 2 micro-batches and flash 2 x 2 (the four
    training kernels on each row's loss rank). The whole batch's loss gap
    and the tokens it routes otherwise are printed, not gated. Returns
    the launches summed over the ranks."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.runtime import RunSpec

    t_phase = time.perf_counter()
    cfg = moe_dist_cut()
    base = dict(arch=cfg.name, quant=8, cache_compress="int8", kernels="cuda", init="pruning",
                epochs=2, steps_per_epoch=2, batch=4, seq=512, seed=SEED)
    spec = RunSpec(**base, dp=DIST_DP, stages=DIST_STAGES)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    t0 = time.perf_counter()
    ranks = spawn(moe_dist_rank, DIST_DP, DIST_STAGES, "cuda", args=(spec, 1),
                  timeout=300.0, deadline=700.0)
    ranks_s = time.perf_counter() - t0
    n_micro, per_stage = spec.default_micro(), cfg.n_periods // DIST_STAGES
    run = route_unit_run(RunSpec(**base), n_micro, DIST_DP)
    line = {"phase": "moe_distributed", "arch": cfg.name, "layers": cfg.n_layers,
            "reduced": [f"depth: {cfg.n_layers} of 32 layers (four ranks share the card, each "
                        "drawing the whole backbone; widths as published)"],
            "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
            "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k, "d_expert": cfg.moe.d_expert,
            "capacity_factor": cfg.moe.capacity_factor, "vocab": cfg.vocab, "dp": DIST_DP,
            "stages": DIST_STAGES, "ranks": len(ranks), "backend": "gloo", "n_micro": n_micro,
            "route_unit_tokens": spec.batch // n_micro // DIST_DP * spec.seq,
            "batch": spec.batch, "seq": spec.seq, "quant": spec.quant,
            "cache": spec.cache_compress, "r": spec.r, "gate": "route-unit replica",
            **parity(ranks, run["replica"]), **rank_stats(ranks), "ranks_s": ranks_s,
            "replica_s": run["replica_s"]}
    w, layers = run["whole"], [x for st in run["routes"] for x in st]
    line["whole_batch"] = {  # printed, not gated
        "step_losses": w["step_losses"], "epoch_losses": w["epoch_losses"],
        "abs_dloss_steps_vs_distributed": [abs(a - b) for a, b in zip(w["step_losses"],
                                                                       line["step_losses"])],
        "routes_otherwise_per_step": run["routes"],
        "routes_otherwise_share": sum(x["moved"] for x in layers)
        / sum(x["tokens"] for x in layers), "run_s": w["run_s"]}
    epoch1 = {"quant_matmul": len(MIXTRAL_PROJECTIONS) * per_stage * n_micro,
              "flash_attention": per_stage * n_micro}
    line.update(launches_expected_epoch1=epoch1, launch_failures=family_rank_launches(
        ranks, DIST_STAGES, epoch1), tol=DIST_TOL, tol_reason=FAMILY_TOL_REASON,
        phase_s=time.perf_counter() - t_phase)
    emit(line)
    check_parity(line, ["hybrid dp2xpp2", "cached pure-dp"])
    if line["launch_failures"]:
        raise AssertionError(f"moe_distributed launches: {line['launch_failures']}")
    if not all(np.isfinite(line["whole_batch"]["step_losses"])):
        raise AssertionError(f"the whole batch's losses {line['whole_batch']['step_losses']}")
    first = [r["runs"][0] for r in ranks]
    return {k: sum(r["launches"][k] for r in first) for k in TRAINING_KERNELS}


def ssm_plan(workdir: Path):
    """xlstm-125m's ragged 2-stage plan (``SSM_PLAN_LAYERS``, in periods),
    two Jetson Nano (high) a stage, each taking one row of a micro-batch
    of 2, 2 micro-batches; built by hand (the planner's layouts at this
    size keep one stage) and saved as JSON. Returns (plan, its path)."""
    from repro_torch.core.planner import JETSON_NANO_H, Plan, Stage

    plan = Plan(stages=[Stage(a, b, (JETSON_NANO_H,) * 2, (1, 1), 0.0)
                        for a, b in SSM_PLAN_LAYERS],
                n_stages=len(SSM_PLAN_LAYERS), micro_batches=2, latency_begin=0.0,
                latency_exec=0.0, latency_end=0.0)
    path = workdir / "ssm_plan.json"
    plan.save(str(path))
    return plan, path


def ssm_plan_phase(workdir: Path) -> dict:
    """xlstm-125m at full width and depth (3 periods of 3 mLSTM + 1 sLSTM,
    d 768) over the ragged plan of :func:`ssm_plan`: boundaries (0, 1, 3),
    stage 0's slab padded with one masked identity period, dp 2 a stage.
    The spec replays it (``plan=<file>, pool=4``: resolved once here to
    dp 2 x 2 ragged stages, 2 micro-batches of 2 rows, one a dp rank) as
    four gloo ranks through ``distributed_rank``: INT8, int8 cache, r 8,
    pruning init, ``cuda``, 2 epochs x 2 steps of 4 x ``SSM_PLAN_SEQ``.
    Gates against one process on the same spec (:func:`route_unit_run`'s
    replica of the ranks' rows, one micro-batch a rank at a time, run in
    a thread of this process while the ranks run, so the ranks' walls are
    taken beside it): :func:`check_parity` at the distributed gates
    (epoch 0's b0 bit-equal); the members bit-equal after every step; in an epoch-1
    step each rank runs its stage's active blocks alone (4 blocks a
    period x 2 micro-batches: 8 on stage 0, whose padded period runs
    nothing, 16 on stage 1), no ``quant_matmul`` or flash (xlstm's mixers
    run dense), and the four training kernels on each row's loss rank.
    Returns the launches summed over the ranks."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import spawn
    from repro_torch.runtime import RunSpec
    from repro_torch.runtime.session import resolve_layout

    t_phase = time.perf_counter()
    cfg = get_arch(XLSTM)
    plan, path = ssm_plan(workdir)
    base = dict(arch=XLSTM, quant=8, cache_compress="int8", kernels="cuda", init="pruning",
                epochs=2, steps_per_epoch=2, batch=4, seq=SSM_PLAN_SEQ, seed=SEED)
    spec = RunSpec(**base, plan=str(path), pool=4)
    layout = resolve_layout(spec)
    part = layout.partition
    if (layout.dp, layout.stages, layout.n_micro, part.boundaries) != (2, 2, 2, (0, 1, 3)):
        raise AssertionError(f"the ragged plan resolved to dp={layout.dp} x {layout.stages} "
                             f"stages, {layout.n_micro} micro-batches, {part.boundaries}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the replica runs in this process while the ranks run: both are
    # host-bound, and xlstm's ranks hold under 1 GB of the card each
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        replica = pool.submit(route_unit_run, RunSpec(**base), layout.n_micro, layout.dp)
        ranks = spawn(distributed_rank, layout.dp, layout.stages, "cuda",
                      args=(spec, 1, layout.to_json(), None, True), timeout=300.0,
                      deadline=700.0)
        ranks_s = time.perf_counter() - t0
        run = replica.result()
    masks = part.masks()
    line = {"phase": "ssm_plan", "arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "plan": "hand-built ragged plan, saved and replayed",
            "boundaries": list(part.boundaries), "masks": [list(m) for m in masks],
            "samples_per_device": [list(x) for x in part.samples_per_device],
            "rank_periods": {r["rank"]: list(r["runs"][0]["periods"]) for r in ranks},
            "dp": layout.dp, "stages": layout.stages, "n_micro": layout.n_micro,
            "pool": layout.pool, "ranks": len(ranks), "backend": "gloo", "batch": spec.batch,
            "seq": spec.seq, "quant": spec.quant, "cache": spec.cache_compress, "r": spec.r,
            "gate": "one process, the ranks' rows one micro-batch at a time",
            **parity(ranks, run["replica"]), **rank_stats(ranks), "ranks_s": ranks_s,
            "replica_s": run["replica_s"], "replica_beside_ranks": True,
            "blocks_per_step": {r["rank"]: [st.get("blocks") for st in r["runs"][0]["steps"]]
                                for r in ranks},
            "tol": DIST_TOL, "tol_reason": FAMILY_TOL_REASON}
    modes = [f"plan-driven dp{layout.dp}xpp{layout.stages}", "cached pure-dp"]
    epoch1 = {"quant_matmul": 0, "flash_attention": 0}
    line["launch_failures"] = family_rank_launches(ranks, layout.stages, epoch1)
    want_blocks = {r["rank"]: [len(cfg.pattern) * sum(masks[r["rank"] % layout.stages])
                               * layout.n_micro if not st["mode"].startswith("cached") else 0
                               for st in r["runs"][0]["steps"]] for r in ranks}
    line["blocks_expected"] = want_blocks
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)
    check_parity(line, modes)
    if line["launch_failures"]:
        raise AssertionError(f"ssm_plan launches: {line['launch_failures']}")
    if line["blocks_per_step"] != want_blocks:
        raise AssertionError(f"blocks run a step {line['blocks_per_step']}, wanted {want_blocks}")
    first = [r["runs"][0] for r in ranks]
    return {k: sum(r["launches"][k] for r in first) for k in TRAINING_KERNELS}


ROOFLINE_SHARE_MAX = 1.05  # a larger share means the pricer under-counts the step


def roofline_phase(walls: dict) -> dict:
    """The five internlm2-1.8b cells this run timed, priced on the meta
    device at the shapes they ran (``repro_torch.launch.specs``, the
    ``cuda`` OpSet's program, kernels as units): the serving engine's
    prefill wave and decode step, the personal decode step, the epoch-1
    and the cached step. Per cell the three roofline terms on the card's
    constants and ``t_compute_f32``, the bottleneck, the model FLOPs and
    the useful-compute ratio, the wall the phase measured (no new timed
    run; the fastest of a training phase's steps) and ``share`` = the
    largest term over that wall, which must lie in (0, 1.05]."""
    from repro_torch.configs import InputShape, get_arch
    from repro_torch.core.parallel_adapters import adapter_param_count
    from repro_torch.launch.roofline import analyze
    from repro_torch.launch.specs import (build_case, engine_decode_case, engine_prefill_case,
                                          personal_decode_case)

    cfg = get_arch("internlm2-1.8b")
    pre, dec, per, ep1 = walls["prefill"], walls["decode"], walls["personal"], walls["epoch1"]
    cells = {
        "serving_prefill": (engine_prefill_case(
            cfg, batch=pre["batch"], prompt_pad=pre["prompt_pad"], page=pre["page"],
            max_len=pre["max_len"], n_users=pre["users"]), "pac", pre),
        "serving_decode": (engine_decode_case(
            cfg, batch=dec["batch"], page=dec["page"], max_len=dec["max_len"],
            n_users=dec["users"]), "pac", dec),
        "personal_decode": (personal_decode_case(cfg, max_len=per["max_len"], r=per["r"],
                                                 kv_quant=per["kv"]), "pac", per),
    }
    for name, technique in (("epoch1", "pac"), ("cached", "pac_cached")):
        w = walls[name]
        cells[name] = (build_case(cfg, InputShape(name, w["seq"], w["batch"], "train"),
                                  technique=technique, quant_bits=w["quant"], r=w["r"],
                                  tap_policy=w["cache"]), technique, w)
    out = {}
    for name, (case, technique, wall) in cells.items():
        t0 = time.perf_counter()
        pricer = case.price()[0]
        terms = analyze(pricer.cost, arch=cfg.name, shape=case.shape, technique=technique,
                        note=case.note, n_active_params=cfg.active_param_count(),
                        n_adapter_params=adapter_param_count(cfg, ep1["r"]),
                        argument_bytes=case.argument_bytes())
        longest = max(terms.t_compute, terms.t_memory, terms.t_collective)
        out[name] = {"shape": [case.shape.global_batch, case.shape.seq_len], "note": case.note,
                     "flops": terms.flops_per_device, "bytes": terms.bytes_per_device,
                     "t_compute_ms": terms.t_compute * 1e3,
                     "t_compute_f32_ms": terms.t_compute_f32 * 1e3,
                     "t_memory_ms": terms.t_memory * 1e3,
                     "t_collective_ms": terms.t_collective * 1e3,
                     "bottleneck": terms.bottleneck,
                     "model_flops_total": terms.model_flops_total,
                     "useful_compute_ratio": terms.useful_compute_ratio,
                     "units": {k: {"calls": pricer.unit_calls[k], "flops": u.flops,
                                   "bytes": u.bytes} for k, u in pricer.units.items()},
                     "wall_ms": wall["s"] * 1e3, "share": longest / wall["s"],
                     "price_s": time.perf_counter() - t0}
    line = {"phase": "roofline", "arch": cfg.name, "cells": out,
            "share_max": ROOFLINE_SHARE_MAX, "kernel_bounds": priced_kernel_bounds(),
            "constants": {"PEAK_FLOPS_BF16": BF16_FLOP_PER_S, "PEAK_FLOPS_F32": F32_FLOP_PER_S,
                          "HBM_BW": HBM_BYTES_PER_S}}
    emit(line)
    bad = {k: c["share"] for k, c in out.items() if not 0 < c["share"] <= ROOFLINE_SHARE_MAX}
    if bad:
        raise AssertionError(f"roofline shares outside (0, {ROOFLINE_SHARE_MAX}]: {bad}")
    return line


def priced_kernel_bounds() -> dict:
    """Bounds of kernel shapes the kernel table lacked one for, with the
    bytes of the pricer's unit (``launch.op_cost``, on meta) and the
    FLOPs by each row's rule: int4 ``quant_matmul`` at M = 8 (f32) and
    4096 (3 bf16 products), flash at the distill teacher's B·H = 2·16
    (12 bf16 products of the causal pairs, and f32), ``adapter_fuse`` at
    qwen2-vl's T = 8 (f32)."""
    from repro_torch.core.quantization import QTensor
    from repro_torch.kernels import ops
    from repro_torch.launch.op_cost import price

    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def unit_bytes(fn, *args):
        return sum(u.bytes for u in price(fn, *args)[2].units.values())

    out = {}
    K = N = 2048
    w4 = QTensor(m(K, N // 2, dtype=torch.int8), m(K, N // 128), 4, 128, N)
    for M in (8, 4096):
        nbytes = unit_bytes(ops.quant_matmul, m(M, K), w4)
        f32 = bound(nbytes, 2.0 * M * K * N)
        row = {"at": f"int4 M={M} K={K} N={N}", "bytes": nbytes, "bound_f32_ms": f32[0],
               "bound_f32_by": f32[1]}
        if M > QMM_SKINNY_ROWS:
            tc = bound(nbytes, 3 * 2.0 * M * K * N, BF16_FLOP_PER_S)
            row.update(bound_tc_ms=tc[0], bound_tc_by=tc[1])
        out[f"quant_matmul_int4_M{M}"] = row
    B, H, Hkv, S, hd = PLAN_MICRO_BATCH, 16, 8, 512, 128
    nbytes = unit_bytes(ops.flash_attention, m(B, H, S, hd), m(B, Hkv, S, hd), m(B, Hkv, S, hd))
    flops = 4.0 * hd * (S * (S + 1) // 2) * B * H
    tc, f32 = bound(nbytes, 6 * flops, BF16_FLOP_PER_S), bound(nbytes, flops)
    out["flash_attention_distill"] = {"at": f"B·H={B}·{H} over {B}·{Hkv}, S={S}, hd={hd}",
                                      "bytes": nbytes, "bound_tc_ms": tc[0],
                                      "bound_tc_by": tc[1], "bound_f32_ms": f32[0],
                                      "bound_f32_by": f32[1]}
    T, d, da = 8, 3584, 444
    nbytes = unit_bytes(ops.adapter_fuse, m(T, d), m(d, da), m(T, da), m())
    f32 = bound(nbytes, 2.0 * T * d * da)
    out["adapter_fuse_qwen2vl_T8"] = {"at": f"T={T}, d={d}, d_a={da}, f32", "bytes": nbytes,
                                      "bound_ms": f32[0], "bound_by": f32[1]}
    return out


def dryrun_phase() -> dict:
    """``repro_torch.launch.dryrun.run_case`` for internlm2-1.8b at the
    four input shapes (the reference's dry-run cells, on meta)."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch.dryrun import run_case

    t0 = time.perf_counter()
    recs = {shape: run_case("internlm2-1.8b", shape, verbose=False) for shape in INPUT_SHAPES}
    keep = ("note", "flops_per_device", "bytes_per_device", "t_compute", "t_compute_f32",
            "t_memory", "t_collective", "bottleneck", "model_flops_total",
            "useful_compute_ratio", "price_s")
    line = {"phase": "dryrun", "arch": "internlm2-1.8b", "technique": "pac",
            "cases": {k: {f: r[f] for f in keep} for k, r in recs.items()},
            "seconds": time.perf_counter() - t0}
    emit(line)
    if any(r["status"] != "ok" or not r["flops_per_device"] > 0 for r in recs.values()):
        raise AssertionError(f"dry run: {recs}")
    return line


def priced_mesh_bytes(spec, first_runs: dict) -> dict:
    """The dry run's per-rank point-to-point and all-reduce bytes of one
    epoch-1 step and one cached step of ``spec``'s layout, against what
    ``EdgeMesh.stats`` counted for each rank and step of the run
    (``first_runs``: rank -> its first run's record)."""
    from repro_torch.configs import InputShape
    from repro_torch.launch.specs import build_case

    cfg = spec.arch_config()
    shape = InputShape("distributed", spec.seq, spec.batch, "train")
    kinds = {"p2p_bytes": "p2p", "allreduce_bytes": "all-reduce"}
    priced = {t: [{k: p.cost.collectives[kind] for k, kind in kinds.items()} for p in build_case(
        cfg, shape, (spec.dp, spec.stages), technique=t, quant_bits=spec.quant, r=spec.r,
        tap_policy=spec.cache_compress).price()] for t in ("pac", "pac_cached")}
    equal = all(
        st[k] == priced["pac" if st["mode"].startswith("hybrid") else "pac_cached"][rank][k]
        for rank, run in first_runs.items() for st in run["steps"]
        for k in ("p2p_bytes", "allreduce_bytes"))
    return {"priced_bytes_per_step": priced, "priced_bytes_equal": equal}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Drive the port on one NVIDIA card.")
    parser.add_argument("--bf16-own-move", action="store_true",
                        help="build, then measure only the bf16 gates' yardstick "
                             "(bf16_own_move) and exit")
    parser.add_argument("--arch", default=SERVING_ARCH, choices=(SERVING_ARCH, GEMMA2),
                        help="the bf16 backbone --bf16-own-move measures")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    seconds = _build.build()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0, "per_source_s": seconds})
    for name in _build.KERNELS:
        entry = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "Used" in line or "spill" in line:
                print(f"ptxas {name} {entry}: {line.strip()}", flush=True)

    if args.bf16_own_move:
        bf16_own_move(args.arch)
        print(card_line(), flush=True)
        return 0
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # each path's kernels are checked just before the path runs, so that
    # no path's measurements carry another's leftovers
    rows = kernel_phase(Timer(), gen)
    walls = {}  # the internlm2 cells' walls, for the roofline line
    keep = {}
    serving = serving_phase(gen, walls, keep)
    serving_done_s = time.perf_counter() - T_START  # the serving slice's phases
    # the reference's other serving paths on the same backbone, users and
    # prompts: f32 and bf16 KV pages, a pool too small for every prompt at
    # once; then an INT4 backbone served, trained and personal-served
    a8, rows["paged_attention"]["unscaled"] = kv_pages_phase(Timer(), gen, keep)
    a8["page_bound_serving"] = page_bound_phase(keep)
    del keep["backbone"]
    torch.cuda.empty_cache()
    rows["quant_matmul"]["int4"] = int4_kernel_phase(Timer(), gen)
    a8["int4_serving"], int4_backbone = int4_serving_phase(gen, keep)
    del int4_backbone
    torch.cuda.empty_cache()
    # the reference's bf16 backbone on the same users and prompts: its
    # kernels' bf16 branches, then served, trained and personal-served
    bf16_rows = bf16_kernel_phase(Timer(), gen)  # the kernels line's bf16 rows
    a8["bf16_serving"], b_backbone = bf16_serving_phase(gen, keep)
    del keep
    a8["bf16_training"], b_adapter = bf16_training_phase(b_backbone, get_arch("internlm2-1.8b"),
                                                         gen)
    a8["bf16_personal"] = bf16_personal_phase(b_backbone, b_adapter,
                                              get_arch("internlm2-1.8b"))
    del b_backbone, b_adapter
    torch.cuda.empty_cache()
    bf16_done_s = time.perf_counter() - T_START
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int4_") as int4_dir:
        a8["int4_training"], i_backbone, _ = pac_run(
            "internlm2-1.8b", quant=4, outputs=Path(int4_dir), path_branches=("int4 tiled",))
        a8["int4_personal"] = int4_personal_phase(i_backbone, get_arch("internlm2-1.8b"),
                                                  Path(int4_dir) / "adapter.msgpack")
        del i_backbone
    torch.cuda.empty_cache()
    a8_done_s = time.perf_counter() - T_START
    rows.update(training_kernel_phase(Timer(), gen))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        training, backbone, ckpt, single = training_phase(Path(workdir), walls)
        training_done_s = time.perf_counter() - T_START
        rows.update(personal_kernel_phase(Timer(), gen))
        personal = personal_phase(backbone, get_arch("internlm2-1.8b"), ckpt, walls)
        del backbone
        personal_done_s = time.perf_counter() - T_START
        prefetch = prefetch_phase(Path(workdir))
        prefetch_done_s = time.perf_counter() - T_START
        distributed_kernel_phase(Timer(), gen)
        distributed, reshard, dist_ranks = distributed_phase(single)
        distributed_done_s = time.perf_counter() - T_START
        plan_kernel_phase(Timer(), gen)
        plan, plan_auto = plan_phase(single, dist_ranks, Path(workdir))
        del dist_ranks
        plan_done_s = time.perf_counter() - T_START
        fleet = fleet_phase(single, Path(workdir))
        del single
    fleet_done_s = time.perf_counter() - T_START
    # the backward through the pipeline: (a) across four f32 stages under
    # ref, (b) PAC+ through pipeline_grads under cuda at the distributed
    # path's shapes, whose kernels are checked first
    distributed_kernel_phase(Timer(), gen, "pipeline_grads")
    pipeline_grads = pipeline_grads_phase()
    pipeline_grads_done_s = time.perf_counter() - T_START
    # the internlm2 cells priced on meta against their walls, then the dry run
    roofline_phase(walls)
    dryrun_phase()
    roofline_done_s = time.perf_counter() - T_START

    # the other dense configs: gemma2-2b's head width 256 and widths, then
    # its paths, the paper's Table III models, musicgen's audio frames
    hd256 = hd256_kernel_phase(Timer(), gen)
    for name in ("flash_attention", "paged_attention"):
        rows[name]["hd256"] = hd256[name]
    for name, row in gemma2_kernel_phase(Timer(), gen).items():
        rows[name]["gemma2"] = row
    g_keep = {}
    gemma2_serving = gemma2_serving_phase(gen, keep=g_keep)
    gemma2_training, g_backbone, g_adapter = pac_run(GEMMA2, profile=True)
    gemma2_personal = gemma2_personal_phase(g_backbone, g_adapter, get_arch(GEMMA2))
    del g_backbone, g_adapter
    gemma2_done_s = time.perf_counter() - T_START
    # the reference's bf16 backbone at gemma2-2b's full width and depth: the
    # bf16 branches at head widths 256, 112 and 64, then served to its INT8
    # cell's users and prompts, trained and personal-served
    for name, row in bf16_wide_kernel_phase(Timer(), gen).items():
        bf16_rows[name].update(row)
    a8["gemma2_bf16_serving"], gb_backbone = bf16_serving_phase(gen, g_keep, GEMMA2,
                                                                "gemma2_bf16_serving")
    del g_keep
    a8["gemma2_bf16_training"], gb_adapter = bf16_training_phase(
        gb_backbone, get_arch(GEMMA2), gen, phase="gemma2_bf16_training")
    a8["gemma2_bf16_personal"] = bf16_personal_phase(gb_backbone, gb_adapter, get_arch(GEMMA2),
                                                     phase="gemma2_bf16_personal")
    del gb_backbone, gb_adapter
    torch.cuda.empty_cache()
    gemma2_bf16_done_s = time.perf_counter() - T_START
    paper_models = {}
    for arch in PAPER_MODELS:
        for k, v in pac_run(arch)[0].items():
            paper_models[k] = paper_models.get(k, 0) + v
    musicgen = musicgen_phase(gen)
    paper_done_s = time.perf_counter() - T_START

    # the paper's baselines beside PAC+ (Table V), then distillation_init
    width_kernel_phase(gen, "t5-base-pac", T5_PROJECTIONS, 12, 64, 768, T5_DA, T5_V)
    baselines = baselines_phase()
    baselines_done_s = time.perf_counter() - T_START
    plan_kernel_phase(Timer(), gen, "distill", "distill teacher")
    distill = distill_phase(gen)
    distill_done_s = time.perf_counter() - T_START

    # MoE: kimi-k2's head width 112, one mixtral-8x7b layer, mixtral's
    # widths, then mixtral served, trained and personal-served at full
    # width and depth (its 48 GB INT8 backbone held once at a time)
    hd112 = hd112_kernel_phase(Timer(), gen)
    for name in ("flash_attention", "paged_attention"):
        rows[name]["hd112"] = hd112[name]
    moe_layer_phase(gen)
    for name, row in mixtral_kernel_phase(Timer(), gen).items():
        rows[name]["mixtral"] = row
    mixtral_serving = mixtral_serving_phase(gen)
    torch.cuda.empty_cache()
    mixtral_training, m_backbone, m_adapter = pac_run(MIXTRAL, profile=True, one_backbone=True,
                                                      pool=MIXTRAL_POOL)
    mixtral_personal = mixtral_personal_phase(m_backbone, m_adapter, get_arch(MIXTRAL))
    del m_backbone, m_adapter
    torch.cuda.empty_cache()
    mixtral_done_s = time.perf_counter() - T_START
    # mixtral on the distributed path at full width over a depth cut, at
    # the published capacity factor, gated by a replica that routes as the
    # ranks do (its kernels at one rank's shapes first)
    r = distributed_kernel_phase(Timer(), gen, "moe_distributed", MIXTRAL)
    rows["flash_attention"]["moe_distributed"] = {k: r[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms", "bound_f32_ms",
        "library_ms", "at")}
    moe_distributed = moe_distributed_phase()
    moe_distributed_done_s = time.perf_counter() - T_START

    # the SSM family: xlstm-125m served (stepwise), trained and
    # personal-served at full width and depth, one of jamba's Mamba mixers
    # at full width, jamba reduced through the hybrid path
    for name, row in gemma2_kernel_phase(Timer(), gen, XLSTM, (), XLSTM_D, XLSTM_DA,
                                         XLSTM_V, None).items():
        rows[name]["xlstm"] = row
    xlstm_serving = xlstm_serving_phase(gen)
    xlstm_training, x_backbone, x_adapter = pac_run(XLSTM, epochs=2, steps=1,
                                                    path_kernels=XLSTM_TRAIN_KERNELS)
    xlstm_personal = gemma2_personal_phase(x_backbone, x_adapter, get_arch(XLSTM),
                                           phase="xlstm_personal", qmm_per_layer=0)
    del x_backbone, x_adapter
    xlstm_done_s = time.perf_counter() - T_START
    # xlstm-125m over its ragged 2-stage plan, replayed on four ranks
    distributed_kernel_phase(Timer(), gen, "ssm_plan", XLSTM)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssm_") as ssm_dir:
        ssm_plan_launches = ssm_plan_phase(Path(ssm_dir))
    ssm_plan_done_s = time.perf_counter() - T_START
    mamba_layer_phase(gen)
    for name, row in jamba_kernel_phase(Timer(), gen).items():
        rows[name]["jamba_reduced"] = row
    jamba_hybrid = jamba_hybrid_phase(gen)
    jamba_done_s = time.perf_counter() - T_START

    # mrope: qwen2-vl-7b's widths (n_rep 7, the adapter's d_a 444), then
    # qwen2-vl-7b served, trained and personal-served at full width and
    # depth, and one batch whose three position streams differ
    for name, row in qwen2vl_kernel_phase(Timer(), gen).items():
        rows[name]["qwen2vl"] = row
    qwen2vl_serving = gemma2_serving_phase(gen, QWEN2VL, QWEN2VL_MAX_LEN, None,
                                           "qwen2vl_serving")
    torch.cuda.empty_cache()
    qwen2vl_training, q_backbone, q_adapter = pac_run(QWEN2VL)
    qwen2vl_personal = gemma2_personal_phase(q_backbone, q_adapter, get_arch(QWEN2VL),
                                             phase="qwen2vl_personal")
    qwen2vl_mrope = qwen2vl_mrope_phase(q_backbone, q_adapter, get_arch(QWEN2VL))
    del q_backbone, q_adapter
    torch.cuda.empty_cache()
    qwen2vl_done_s = time.perf_counter() - T_START

    # MoE at published widths: moonshot-v1-16b-a3b at full depth (64
    # experts top-6, 16 heads over 16), then grok-1-314b over its depth
    # cut (48 heads over 8, soft-cap 30, 8 experts of 32768): each served,
    # trained and personal-served, one INT8 backbone on the card at a time
    for name, row in moe_kernel_phase(Timer(), gen, MOONSHOT).items():
        rows[name]["moonshot"] = row
    moonshot_serving = mixtral_serving_phase(gen, MOONSHOT, MOE_MAX_LEN, "moonshot_serving")
    torch.cuda.empty_cache()
    moonshot_training, o_backbone, o_adapter = pac_run(MOONSHOT, profile=True, one_backbone=True,
                                                       pool=MOONSHOT_POOL)
    moonshot_personal = mixtral_personal_phase(o_backbone, o_adapter, get_arch(MOONSHOT),
                                               phase="moonshot_personal")
    del o_backbone, o_adapter
    torch.cuda.empty_cache()
    moonshot_done_s = time.perf_counter() - T_START
    grok = grok_cut()
    for name, row in moe_kernel_phase(Timer(), gen, GROK).items():
        rows[name]["grok"] = row
    grok_serving = mixtral_serving_phase(gen, grok.name, MOE_MAX_LEN, "grok_serving")
    torch.cuda.empty_cache()
    # no Jetson pool holds one grok layer: both sessions open on one device
    grok_training, k_backbone, k_adapter = pac_run(grok.name, profile=True, one_backbone=True,
                                                   single_device=True)
    grok_personal = mixtral_personal_phase(k_backbone, k_adapter, grok, phase="grok_personal")
    del k_backbone, k_adapter
    torch.cuda.empty_cache()
    grok_done_s = time.perf_counter() - T_START

    sources = {"quant_matmul": ("src/repro_torch/kernels/csrc/quant_matmul.cu",
                                "src/repro/kernels/quant_matmul.py:93"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:108"),
               "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:142"),
               "mix_fwd": ("src/repro_torch/kernels/csrc/cached_mix.cu",
                           "src/repro/kernels/cached_step.py:186"),
               "mix_dw": ("src/repro_torch/kernels/csrc/cached_mix.cu",
                          "src/repro/kernels/cached_step.py:271"),
               "ce_fwd": ("src/repro_torch/kernels/csrc/lmhead_ce.cu",
                          "src/repro/kernels/cached_step.py:459"),
               "ce_bwd": ("src/repro_torch/kernels/csrc/lmhead_ce.cu",
                          "src/repro/kernels/cached_step.py:497"),
               "adapter_fuse": ("src/repro_torch/kernels/csrc/adapter_fuse.cu",
                                "src/repro/kernels/adapter_fuse.py:83")}
    paths = {"serving": serving, "training": training, "personal": personal,
             "prefetch": prefetch, "distributed": distributed, "reshard": reshard,
             "plan": plan,
             "plan_auto": plan_auto, "fleet": fleet, "pipeline_grads": pipeline_grads,
             "gemma2_serving": gemma2_serving,
             "gemma2_training": gemma2_training, "gemma2_personal": gemma2_personal,
             "paper_models": paper_models, "musicgen_prefill": musicgen,
             "baselines": baselines, "distill": distill, "mixtral_serving": mixtral_serving,
             "mixtral_training": mixtral_training, "mixtral_personal": mixtral_personal,
             "xlstm_serving": xlstm_serving, "xlstm_training": xlstm_training,
             "xlstm_personal": xlstm_personal, "jamba_hybrid": jamba_hybrid,
             "qwen2vl_serving": qwen2vl_serving, "qwen2vl_training": qwen2vl_training,
             "qwen2vl_personal": qwen2vl_personal, "qwen2vl_mrope": qwen2vl_mrope,
             "moonshot_serving": moonshot_serving, "moonshot_training": moonshot_training,
             "moonshot_personal": moonshot_personal, "grok_serving": grok_serving,
             "grok_training": grok_training, "grok_personal": grok_personal,
             "moe_distributed": moe_distributed, "ssm_plan": ssm_plan_launches, **a8}
    home = {"quant_matmul": "serving", "flash_attention": "serving",
            "paged_attention": "serving", "adapter_fuse": "personal"}
    # each kernel's launches on its own main path (serving for the first
    # three, training for the four training kernels, personal for
    # adapter_fuse), every path listed
    device_names = {"quant_matmul": ["skinny::gemv (M <= 8)", "qmm_mma (M > 8)"],
                    "flash_attention": ["flash_split + flash_fwd_mma (f32)",
                                        "flash_fwd_wg (bf16, hd 128)",
                                        "flash_pad + flash_fwd_mma<hd, bf16> (bf16, hd 64, "
                                        "112, 256)"],
                    "paged_attention": ["paged_attn"],
                    "mix_fwd": ["mix_fwd_mma", "mix_fwd_reduce"],
                    "mix_dw": ["mix_dw_mma", "dw_reduce"],
                    "ce_fwd": ["ce_split", "ce_fwd_mma (f32 W)", "ce_fwd_wg (bf16 W)",
                               "ce_pad (bf16 h, or a bf16 W TMA cannot read in place)",
                               "ce_merge"],
                    "ce_bwd": ["ce_split", "ce_grad_mma + ce_dh_mma (f32 W)",
                               "ce_grad_wg + ce_dh_wg (bf16 W)", "ce_pad (as ce_fwd)"],
                    "adapter_fuse": ["skinny::gemv (T <= 8)",
                                     "mix_fwd_mma + mix_fwd_reduce (T > 8)"]}
    for name, row in bf16_rows.items():
        rows[name]["bf16"] = row
    rows["quant_matmul"]["int4_branches_by_path"] = {
        p: paths[p]["quant_matmul_branches"] for p in ("int4_serving", "int4_training",
                                                       "int4_personal")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "device_kernels": device_names[name],
         "launches": paths[home.get(name, "training")][name],
         "launches_by_path": {p: counts.get(name, 0) for p, counts in paths.items()},
         **rows[name]}
        for name, (src, rep) in sources.items()]})
    emit({"phase": "done", "wall_s": time.perf_counter() - T_START,
          "through_serving_s": serving_done_s, "through_bf16_s": bf16_done_s,
          "through_int4_and_pages_s": a8_done_s,
          "through_training_s": training_done_s,
          "through_personal_s": personal_done_s, "through_prefetch_s": prefetch_done_s,
          "through_distributed_s": distributed_done_s, "through_plan_s": plan_done_s,
          "through_fleet_s": fleet_done_s, "through_pipeline_grads_s": pipeline_grads_done_s,
          "through_roofline_s": roofline_done_s,
          "through_gemma2_s": gemma2_done_s, "through_gemma2_bf16_s": gemma2_bf16_done_s,
          "through_paper_models_s": paper_done_s, "through_baselines_s": baselines_done_s,
          "through_distill_s": distill_done_s, "through_mixtral_s": mixtral_done_s,
          "through_moe_distributed_s": moe_distributed_done_s,
          "through_xlstm_s": xlstm_done_s, "through_ssm_plan_s": ssm_plan_done_s,
          "through_jamba_s": jamba_done_s,
          "through_qwen2vl_s": qwen2vl_done_s, "through_moonshot_s": moonshot_done_s,
          "through_grok_s": grok_done_s, "grok_layers": GROK_LAYERS, "peaks": PEAKS,
          "timing": dict(Timer.spent, repeats=REPEATS)})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
