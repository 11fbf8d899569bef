#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: build its CUDA kernels and its native host
loader, hold each kernel against its plain version on the card, and train
the flagship TransformerLM through the port's entry points on one card, at
seq 256, at seq 8,192, at seq 8,192 through the sequence-parallel path (a
ring of one card, and Ulysses on one card), and at seq 256 under every
synchronous strategy; then the data plane, the image-classification
family (the CNN zoo at full width through the ImageNet benchmark entry
point), the text family with the rest of the benchmark suite (BERT, NCF,
disk input, the raw baseline and the sweep), ``run_many``'s CUDA graphs
with the strategy search, the MoE LM with expert parallelism and the
pipeline schedules, the async PS plane, the LM family, the telemetry planes,
the serving plane (decode, the engines, the server, the router and the
export), the operator tools and the static analyzer on what those
phases left running or wrote, the long-context entry point at head width
128, and the port's optimizers (Adafactor, SGD) with their checkpoints.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and ``nvcc``;
exits non-zero without them, or when any phase fails. Phases:

1. The card's name and power limit (``nvidia-smi``), TF32 off.
2. Build every kernel source of the port into ``build/`` (timed); print
   each kernel's registers, barriers, stack and spills from ``-Xptxas -v``,
   any ptxas warning, and the forward kernels' dynamic shared memory. A
   serialized-wgmma warning (C7518-C7520, C7512, ...) fails the phase, and
   so does a spill in a kernel of ``NO_SPILL`` (the dw/db kernels, the
   wide dh kernel, the hd-128 flash backward). The native data loader
   (``data/native/loader.cc``) is built with ``g++`` beside them; a failed
   build fails the phase.
3. Each fused-LM-head kernel against its plain version on the same inputs:
   D = 512 with bf16 activations and an f32 table, both table layouts, with
   and without a bias, ragged N and V (1,000 x 31,999), the forward and dh
   kernels' tiling edges (``XENT_EDGES``: N one short of and one past the
   forward's 128-row and dh's 64-row blocks, V one past the forward's
   128-column and dh's 64-column vocab tiles, every such V odd, so the
   packed "dv" table is padded), the dw/db kernel's (``XENT_DWDB_EDGES``:
   N = 1 and one short of and one past its 64-row stripe, V = 63, 65, 129
   and 193, where a cluster's second block holds no column or one), and
   the main paths' own shapes ("dv", no bias, V = 32,000): N = 8,192 (the
   flagship micro-batch here) and 65,536 (the long-context step). The pack
   kernel must equal its plain version bit for bit. The same at the wide
   widths, D = 768 and 1,024 (``XENT_WIDE``): both layouts, with and
   without a bias, 1,000 x 4,001 and the edges of the wide dh and dw/db
   kernels' clusters (``XENT_WIDE_EDGES``: every N of 1, 63, 65, 127 and
   129 with every V of 63, 65, 127, 129, 193 and 257, where the first,
   second or third cluster's stripe or vocab tile holds no row or column,
   or one); and lm1b's full softmax, f32 h at D = 1,024, "vd" with a bias, N
   = 2,048 by V = 793,471, held against the plain version fed the bf16
   rounding of h and against the plain version at f32 h, and dh, dw and db
   the same bits over two calls. Tolerance: lse within
   0.01 absolute; dh, dw and db within TILE_RTOL in every tile (see
   ``worst_tile``). Then each kernel is timed at the flagship micro-batch
   (N = 98,304) beside its plain version, the one PyTorch call computing
   the same function where there is one, and its bound, with the TFLOP/s
   reached and the share of the bound; and the pack beside its bytes'
   bound. dw/db must give the same bits twice on those inputs; it is also
   timed on a table packed beforehand, beside cuBLAS's products of the same
   work (``h @ wp`` into a materialised bf16 [N, V] S, then ``h.T @ S``), a
   yardstick for the text only. At D = 768 and 1,024 each kernel is timed
   at ``scale_lm``'s default head (d768: N = 49,152, V = 32,000, "dv") and
   its d1024 x 12 head (N = 32,768), the forward beside ``logsumexp(h @
   w.to(bf16))``, and at lm1b's full softmax (D = 1,024, N = 32,768, V =
   793,471, "vd", a bias, f32 h), beside the bounds; no library call there
   (its logits would be about 104 GB). At both scale_lm heads the lse, dh,
   dw and db are held against the plain versions, TILE_RTOL in every tile
   (the grid in many waves of clusters); dh, dw and db must give the same
   bits twice at the d1024 head; the clusters of the wide dh and dw/db
   kernels that the card holds at once are printed.
4. The flagship at full width (d512 x 6 layers, 8 heads, d_ff 2048, vocab
   32,000, seq 256, untied fused head, bf16 activations, f32 params) through
   ``AutoDist(resource_info=..., strategy_builder=AllReduce()).function``
   with Adam(1e-3) and 2-way gradient accumulation over micro-batches of 32
   sequences, for 3 steps; launch counts are set to 0 just before and read
   just after. First, on a small batch, its fused-head loss is held against
   the plain logits head with the same weights (rtol 1e-2: bf16 logits).
   Then tokens/s and MFU over 6 more steps, and a ``torch.profiler``
   window over 3 more: the device's busy time per step, its idle share of
   the wall time, and the top kernels.
5. Each flash-attention kernel against its plain version on the same
   inputs: bf16 q/k/v/dO [B, L, 8, 64], B = 2 at a ragged L = 1,000 causal
   and not causal, with ring offsets (q_offset 1,024, with bf16 and with
   f32 gradient outputs; k_offset 300 and 700, where the first 300 or 700
   query rows see no key and the last 300 or 700 keys no query: those
   rows of dq and keys of dk and dv must come out exactly 0, in bf16 and
   in f32), the forward's tiling edges (L = 129, 193 and 8,191, causal and
   not: one row past a 128- and a 192-row block, one short of the path's
   length), the backward's (L = 63, 65, 127, 129, 191 and 193: one short
   of and one past a 64-row tile, a 128-key dK/dV block and a 192-row dQ
   block), and the long-context path's own shape, B = 8 at L = 8,192,
   causal. Tolerance: lse within FLASH_LSE_ATOL absolute; out, dq, dk and
   dv within TILE_RTOL in every tile. Then each kernel is timed at the
   long-context shape (B = 8, L = 8,192, H = 8, hd = 64, causal) beside its
   plain version, its bound (with the TFLOP/s reached and the share of the
   bound) and a library yardstick the port never calls
   (``F.scaled_dot_product_attention(is_causal=True)``, and that call's
   backward for dK/dV and dQ together, which computes its own D: it is
   set beside the pair, and beside ``prepare_backward_q_side`` and the
   pair). The same at head width 128 (the four kernels' hd-128
   instantiations; phase 7's carry checks with them): [8, 8,192, 8, 128]
   causal, ragged L = 1,000 causal and not, offsets (1,024, 0) and (0, 300)
   (f32 outputs, blind rows and unseen keys exactly 0), L = 65, 127 and
   129 causal and not (one off the hd-128 tiling's 64-row tiles and
   128-row blocks), the carry at the path shape, ragged, with a carry in
   and with rows 0-99 carried through bit for bit; then the four timed at
   [8, 8,192, 8, 128] beside their plain versions, bounds and
   ``F.scaled_dot_product_attention``.
6. The long-context entry point (``autodist_tpu_torch.examples.long_context_lm``)
   at full width: d512 x 6 layers, 8 heads, d_ff 2048, vocab 32,000, seq =
   max_len = 8,192, flash attention, every block rematerialized, untied
   fused head, bf16 activations, f32 params, ``AllReduce``, Adam 1e-3. The
   batch is cut to 8 sequences (65,536 tokens a step) from the example's
   default 48. First, on B = 2, L = 1,024, the flash model's loss is held
   against the dot model's with the same weights (rtol 1e-2: bf16). Then 3
   counted steps (launch counts set to 0 just before, read just after; all
   six kernels must have launched, all losses finite), the entry point's
   timed loop (one warm-up step, then 4 steady ones) on the same session
   for tokens/s and MFU with peak memory, and a profiler window over 2
   steps. Phase 16 reuses this session's runner and first weights (one
   build, its sparse walk and init, for both phases).
7. The flash carry kernel (ring attention's local step) against its plain
   version: ragged L = 1,000 with no carry in, a past shard with a carry in
   (q_offset 1,024, k_offset 0), a diagonal step with a carry in, steps
   whose first 100, 150, 200 or 300 rows see no key (the block that holds
   the boundary is part pass-through, the boundary in each consumer
   warpgroup's rows in turn; those rows' carry must come out bit for bit as
   it went in), the tiling edges L = 129, 193 and 8,191 (causal and not,
   and with a carry in), and the path's own shapes, B = 8 at L_local =
   8,192 (the one-card ring) and 2,048 (with a carry in). Tolerance: acc and
   l within TILE_RTOL in every tile of rows, m within FLASH_LSE_ATOL. Then
   the ring's arithmetic on one card: B = 8, L = 8,192 split into 4 shards,
   the forward ring schedule with the carry kernel, the backward schedule
   with the dK/dV and dQ kernels (offsets, f32 outputs) summed as the ring
   sums them, against ``flash_forward_plain``/``flash_backward_plain`` on the
   whole sequence, tile by tile (lse within FLASH_LSE_ATOL). Then the carry
   kernel is timed at B = 8, L = 8,192 as the one-card ring calls it (no
   carry in) beside its plain version, its bound and
   ``F.scaled_dot_product_attention(is_causal=True)``, which lacks the
   carry merge.
8. Sequence-parallel training at full width (d512 x 6 layers, 8 heads, d_ff
   2048, vocab 32,000, seq = max_len = 8,192, B = 8, ring attention, every
   block rematerialized, untied fused head, bf16 activations, f32 params,
   Adam 1e-3) through ``create_sequence_parallel_session(AutoDist(
   resource_info=ONE_CARD, strategy_builder=SequenceParallel(seq_axis_size=1)),
   ...)``. First, on B = 2, L = 1,024, the ring model's loss is held against
   the flash model's with the same weights (rtol 1e-2). Then 3 counted
   steps (every kernel but ``flash_fwd`` must launch, ``flash_fwd`` never;
   all losses finite), tokens/s and MFU over 4 steady steps with peak
   memory, and a profiler window over 2 steps.
9. The flagship entry point (``autodist_tpu_torch.examples.flagship_lm``)
   at its real shape: d512 x 6 layers, 8 heads, d_ff 2048, vocab 32,000,
   max_len 512, untied fused head, bf16 activations, f32 params,
   ``AllReduce``, Adam 1e-3, micro-batches of 384 x 256 tokens with 8-way
   accumulation (dp = 1: one card), the batch resident on the card. First,
   on a small batch, its fused-head loss is held against the plain logits
   head (rtol 1e-2). Then the entry point's own ``main``: 2 warm-up and
   FLAGSHIP_STEPS timed steps, launch counts set to 0 just before and read
   just after (each fused-head kernel must launch 8 times a step, the pack
   16; the final loss finite), its tokens/s, MFU and peak memory; a
   profiler window over 2 steps; and ``plan_costs``' FLOPs and bytes of the
   step over its measured seconds (the bundled calibration's device rates).
10. ``train()`` at full width (the flagship model, micro-batches of 32 x 256
   with 2-way accumulation) on host batches through the prefetching device
   feed (``prefetch_depth=2``: pinned memory, a side stream) into a
   temporary checkpoint directory: 4 straight steps against 2 steps, the
   final save, a restore into a fresh runner (which must equal the saved
   state bit for bit) and 2 more steps. The losses and the final params
   must be bit-identical, and the losses equal the synchronous feed's.
11. The strategy family on one card: the flagship at full width and phase
   4's size (micro-batches of 32 x 256, 2-way accumulation, Adam 1e-3), 3
   steps from one seed and one set of batches under each of
   ``STRATEGY_LOWERINGS``: ``AllReduce()`` (the reference run), ``AutoDist()``
   with no builder (``PSLoadBalancing``), ``PS``, ``PartitionedPS``,
   ``UnevenPartitionedPS``, ``PartitionedAR``, ``RandomAxisPartitionAR``,
   ``Parallax``, and the codecs: ``Parallax(compressor="HorovodCompressorEF")``,
   ``AllReduce(compressor="HorovodCompressor")``, ``AllReduce(compressor=
   "PowerSGDCompressor", power_sgd_rank=2)``; and ``AllReduce()`` with
   ``zero=1``, each given the first batch as ``example_batch``, so the
   sparse walk marks ``pos_embed`` (and only it: at bf16 the embedding table
   is cast before its gather) sparse in every lowering, and ``Parallax``
   must send it to a PS synchronizer and ``embed/embedding`` to the
   all-reduce. Each prints its sparse parameters and their routes, its
   losses, the device's busy ms per step over steps 2 and 3 (a profiler
   window: the union of kernel intervals) beside
   the card's event-timed ms for them, peak memory, fused-head launches per
   step (counts set to 0 just before, read just after) and its final
   params' largest distance from the reference run's (kept on the host).
   On one card the mesh's reduce, model and data axes are all 1, so every
   uncompressed lowering must equal the reference bit for bit (losses and
   params); each compressed one must stay within
   rtol 1e-2 of the reference losses, end with other params, and (EF,
   PowerSGD) hold a nonzero residual after step 1. Then one ``torch.linalg.qr``
   of a PowerSGD factor's shape ([32,000, 2] f32) is timed on the host's
   clock and the card's.
12. Ulysses on one card at full width: the long-context model of phase 8
   with ``attention_impl="ulysses"`` (d512 x 6, seq 8,192, B = 8, every
   block rematerialized) through ``create_sequence_parallel_session(...,
   SequenceParallel(seq_axis_size=1))``. On B = 2, L = 1,024 its loss is
   held against the flash model's (rtol 1e-2; a group of one calls flash
   itself, so this holds the wiring, not the exchange); then 3 counted
   steps (flash forward, dK/dV and dQ must launch, the carry never; losses
   finite), tokens/s over 4 steady steps and a profiler window over 2.
   Then a one-card replay of Ulysses over 4 shards (B = 8, L = 8,192): the
   two all-to-alls as this script's own permutes of the shards (the port's
   ``all_to_all`` and its backward need a group of several ranks and do
   not run here), flash forward and backward on each rank's pair of heads
   ([8, 8,192, 2, 64]), held tile by tile against the kernels on all 8
   heads (TILE_RTOL; lse within FLASH_LSE_ATOL).
13. The data plane: the native ``DataLoader`` (``is_native`` must hold) gives
   the numpy path's batches bit for bit unshuffled, and a shuffled epoch
   serves every row once.
14. The image family: ``image_classifier.main`` (SmallCNN under
   ``PSLoadBalancing`` from the native loader through the device feed; its
   loss must fall). ResNet-50 at full width (224 px, GroupNorm, 1,000
   classes): on 4 images its bf16 loss is held against its f32 loss with
   the same weights (rtol 1e-2); then the ImageNet benchmark entry point at
   32 and 128 images a card under ``PSLoadBalancing`` and
   ``AllReduce(chunk_size=200)`` (images/s, MFU from a ``FlopCounterMode``
   count, peak memory, and a profiler window over 2 steps each); the
   record-pool input (``--input_mode cache``) at 128 on uint8 record shards
   written here with ``save_shards`` (a pool of half the records, so it
   refreshes, at the default cadence of 64 rows every 16 steps), with its
   host time split by the pool's profiler spans over one refresh interval;
   and 3 steps each of VGG16, DenseNet-121 (224 px) and Inception-v3
   (299 px) at batch 8, whose losses must be finite.
15. The text family and the benchmark suite, through the port's
   ``examples/benchmark`` entry points, with launch counts set to 0 at its
   start. BERT-base (d768 x 12, 12 heads, d_ff 3,072, vocab 30,522, seq
   128, 20 prediction slots, bf16): on 4 sequences its bf16 loss is held
   against its f32 loss with the same weights (rtol 1e-2); then the BERT
   benchmark (``AllReduce(compressor="HorovodCompressor")``, AdamW 1e-4) at
   ``run_all``'s shapes, bert-base at 2,048 with 8 micro-batches a step and
   bert-large (d1,024 x 24) at 128 (examples/s, MFU, peak memory and a
   profiler window over 2 steps each); a corpus written here from a word
   list, ``--tokenize_corpus``, bert-base trained from ``--data_dir`` (the
   MLM batcher's masks through the device feed), saved with ``Saver`` and
   scored by ``--eval --restore`` (masked-LM accuracy). NCF at the JAX
   defaults (138,000 users, 27,000 items, f32, a batch of 65,536, Adam
   1e-3): under ``Parallax`` with a profiler window, the four tables routed
   to PS and nothing else; ``Parallax`` against ``AllReduce()`` over 3 steps
   from one seed, which on one card must agree bit for bit (losses and
   params); and one epoch over a MovieLens-format ratings file written here
   (every user 20-40 ratings), with HR@10 and NDCG@10. BERT and NCF reach
   none of the port's kernels (every count still 0, read just before the
   next run). ``disk_input`` at the flagship's shape (384 x 256, the fused
   head, one step a batch) from a resident batch and from ``.npy`` shards
   through the native loader: its JSON line, ``native_loader`` must hold
   and each fused-head kernel launch once a step (counts read just after).
   ``raw_torch_baseline`` for ResNet-50 at 128 beside phase 14's
   ``AllReduce`` rate at 128; ``run_all --list``, and one ``--only ncf
   --steps 5`` row run in its own process and parsed as the sweep parses it.
16. ``run_many`` and the strategy search (launch counts set to 0 at its
   start and banked wherever it sets them to 0 again). ``run_many`` against
   ``run()`` on fresh sessions with the same weights and batches: two
   ``run()`` steps (the card's warm-up), then blocks of two, the first
   captured into a CUDA graph and replayed, the second replayed; the
   losses and every parameter after must equal six ``run()`` steps bit for
   bit, and one replay must count twice one step's launches. So for the
   flagship at its real shape with accumulation off (384 x 256, as
   ``bench.py``'s unroll sweep), for the long-context model of phase 6
   (flash: 12 forward, 6 dK/dV and 6 dQ launches a step), and for each of
   phase 11's twelve lowerings at phase 4's size (each captured, or its
   raise printed). The flagship's tokens/s and peak memory by unroll factor
   (``run()``, then ``run_many`` at K = 1, 2 and 4, FLAGSHIP_UNROLL_STEPS
   steps each on one session, the peak reset before each; the fused-head
   launches per step at K = 4 must equal K = 1's). The uncompressed
   lowerings share ``AllReduce()``'s ``run()`` reference (on one card they
   equal it bit for bit, phase 11). NCF at 65,536 under ``Parallax`` (the benchmark's
   ``--strategy AllReduce`` if it cannot be captured, with the reason
   printed): steps/s under ``run()`` and at K = 1, 2, 4 and 8, the host's
   seconds to enqueue one ``run()`` step over ``plan_costs``' launches (the
   bundled calibration's host term), and the idle share at ``run()`` and K
   = 8 from profiler windows. Then ``AutoDist(strategy_builder="autotune")``
   on NCF at 65,536: the search's table, enumerated, probed (at most
   ``AUTODIST_TUNE_TOPK``), its seconds, the winner, each probed
   candidate's predicted step time beside its measured one, the default
   plan's steps/s beside the winner's; the session's ``tuned_plan`` must be
   set (the search applied, not degraded to the default builder), no
   candidate may fail with an error, and ``train()`` for SEARCH_TRAIN_STEPS
   steps must run in blocks of the plan's ``unroll``.
17. Expert and pipeline parallelism (counts set to 0 just before the MoE's
   counted steps). The MoE LM at the JAX sweep's ``moe`` row (512 x 256 in 4
   micro-batches, d512 x 4, 8 experts, vocab 32,000, bf16, the fused head)
   through ``moe_lm.build`` under ``ExpertParallel`` (an expert axis of 1 on
   one card): MOE_COUNTED counted steps (each fused-head kernel must launch
   4 times a step, the pack 8), tokens/s, MFU (one active expert a token),
   peak memory and a profiler window of 2 steps (busy and idle share, the
   top ten kernels); then ``run_all --only moe`` in its own process, parsed
   as the sweep parses it. The expert axis replayed: at the sweep's
   micro-batch (128 x 256) the 8 experts split into 4 shards of 2, each
   shard's partial FFN run from the same h and combine and the partials
   added, held with the gradients of h, combine and both banks against the
   whole FFN (||shards - whole|| / ||whole|| at most PIPE_RTOL). The
   pipeline schedules replayed (S = 4 virtual stages on one card, through
   the port's own schedule functions) at the pipeline example's shape (16 x
   256 in 4 micro-batches, d512 x 8, vocab 32,000, bf16): GPipe through
   ``PipelineLM.apply`` and autograd, 1F1B, and interleaved 1F1B (v = 2),
   each loss and every leaf's gradient against ``sequential_apply`` with
   autograd (relative norm at most PIPE_RTOL), and each schedule's step time.
18. The async PS plane (``async_ps``; counts set to 0 before each part):
   (a) the flagship at full width through ``examples.flagship_lm.build``
   (one micro-batch of 384 x 256 a step, no accumulation), 3 steps under
   ``PS(sync=False)`` with one worker must equal ``PS()`` bit for bit in
   every parameter, each fused-head kernel launching once a step and the
   pack twice; (b) two in-process workers under ``PS(staleness=2)`` from
   two threads, 6 steps each: 12 updates applied, no gate entry finding a
   lag above 2, every parameter finite, the last loss below the first, each
   fused-head kernel launched 12 times; steps/s (host clock), the service's
   apply ms and a 2-step profiler window; (c) a stale interleaving (workers
   0 and 1 read version 0, worker 0 applies, worker 1 applies its gradient
   of version 0) must equal bit for bit a plain replay (a plain
   ``torch.optim.Adam`` stepped on the gradients of the recorded versions),
   and the version worker 1 held must be unchanged; (d) ``zero=4`` (the
   apply in 4 shards) must equal (a)'s unsharded service bit for bit; (e)
   across processes through the Coordinator: the port's ``async_ps_train``
   in its own process (chief and loopback worker on cuda:0),
   ``applied_updates == 2 x steps``; then the flagship from a two-node
   loopback spec under ``PS(sync=False)``: this process serves and does not
   step, the Coordinator re-executes this script as the worker (whose
   ``main`` runs only the worker half, prints to stderr and writes its
   report under the working directory), which takes (a)'s 3 steps over the
   TCP transport; the chief's parameters must equal (a)'s bit for bit (f32
   over a lossless wire), the native transport must have carried the bytes,
   and per step the pull and push bytes and ms are printed beside (a)'s
   steps/s; then once more with ``AUTODIST_WIRE_DTYPE=bf16``: push bytes
   about half, final loss within rtol 1e-2 of the exact run's; (f) (b)'s
   run with ``worker_crash@step=2,worker=1``: the worker is retired, a
   replacement is admitted (``add_worker``, seeded at the slowest live
   count) and takes its remaining steps, every planned step applies and the
   parameters are finite.
19. The LM family beyond d512 (``--only lm_family`` alone): (a)
   ``lm1b_train --model lstm`` at its defaults (batch 128 under Adam, seq
   256, embedding 512, hidden 1,024, 6 layers, vocab 32,000, 1,024
   negatives, ``Parallax``): the sparse walk's seconds, words/s and MFU
   over counted steps, a profiler window (kernel classes, idle share);
   (b) ``--full_softmax --vocab 793471`` at the defaults: words/s, the
   fused head's launches a step (1 each, the pack 2), peak memory, and at
   a cut of V (32,000) the fused loss within rtol 1e-2 of the plain f32
   head's on the same weights and batch; (c) ``scale_lm`` at d768 x 12 bs
   192, d1024 x 12 bs 128 and d1024 x 24 bs 96: tokens/s, MFU and the
   fused head's launches a step, and at d1024 x 12 the fused loss within
   rtol 1e-2 of the plain head's; (d) ``run_all --only lm1b_lstm`` in its
   own process.
20. The telemetry planes (``--only telemetry`` alone), around the flagship
   d512 x 6 at vocab 32,000 through ``train()``, at micro 64 x seq 256 x
   accum 2 (the real 384 x 256 x 8 step takes 1.25 s; the phase runs about
   90 steps), its batches carrying an all-ones float ``mask``: (a) every
   plane off, then every plane armed (``AUTODIST_TELEMETRY``, ``_PROFILE``,
   ``_HEALTH``, ``_METRICS_DIR``, ``_METRICS_PORT`` on a free loopback port,
   ``_RECORDER``): tokens/s, device kernels and busy ms a step, what health
   adds, and a disabled span's cost times the spans a step as a share of
   the step; (d) ``train.mfu`` within 10% of the phase's own MFU (a
   ``FlopCounterMode`` count, the fused head's kernels counted by their own
   operations, over the measured step time, against ``peak_spec``), the
   attribution shares, and the profile written to ``AUTODIST_PROFILE_DIR``
   calibrating the autotuner (source ``profile:...``); (e) the census of
   params and optimizer state equals their tensors' bytes, the budget's
   source is "measured", a 1 TiB ``torch.empty`` raises
   ``OutOfMemoryError``, which ``record_oom`` books; (f) ``tracing.trace``
   around two ``train()`` steps writes a device trace naming
   ``xent_fwd_kernel`` and host spans with ``train.dispatch``, and a
   ``/metrics`` scrape lists ``train.steps_per_s`` and ``train.mfu``; (b)
   the health bundle of one step against the norms computed on the host
   (rtol 1e-3), and under ``train(unroll=8)`` the graph's reduced bundle
   against eight eager steps'; (c) ``AUTODIST_HEALTH_ACTION=recover`` with
   ``AUTODIST_FAULTS=nan_grads@step=5`` per step and a batch poisoned once
   under ``unroll=8``: the run rolls back, finishes, and its params equal a
   clean run's bit for bit; (g) phase 18's server and one worker process
   (``CHIP_SMOKE_WORKER=telemetry``) with spans on and
   ``AUTODIST_TRACE_PULL=1``: the merged cluster trace has two lanes, and
   the worker's step splits by its ``ps.*`` spans, its parameter copies
   timed apart; while the server is up, ``adtop --once --raw`` reads it,
   and the chief and the worker dump their span rings as JSONL for phase
   22. (d)'s profile is kept for phase 22 too.
21. Serving (``--only serving`` alone), at the flagship's full width (d512 x 6,
   8 heads, d_ff 2048, vocab 32,000, max_len 512, untied head, bf16
   activations, f32 params, seed 0): (a) decode (a 48-token prefill, then 16
   single-token steps) against the full forward's logits (within
   SERVE_LOGIT_RTOL of the largest logit), and lm1b's LSTM at its defaults:
   the recurrence from a non-zero carry and the bf16 decode path against
   their plain versions on the host, every tile within TILE_RTOL, the cell
   kernel launched once a layer a token; (b) the dense engine (8 slots):
   bench.py's mix (24 prompts of 4-48 tokens, 8 or 48 new) and 4 prompts of
   256-448 tokens (32 new), greedy, served alone and all together equal to
   ``generate``, token for token; sampled (0.8, top-k 40) alone equal to
   ``generate`` with the same seed; (c) the paged engine (page_len 16, the
   dense engine's KV bytes and a scratch page) equal to the dense one,
   greedy (with prompts sharing a 4-page prefix: the prefix cache must hit)
   and sampled, and again after every free page is poisoned with 53.0; the
   peak concurrency of short requests against the dense slots; (d) not
   judged: the decode step's ms at B = 1, 8 and 32, its kernels, busy ms and
   idle share in a profiler window, the prefill's ms a bucket, KV bytes and
   peak memory, and an ``InferenceServer`` under 8 client threads,
   continuous against static: requests/s and p50/p99 of queue, prefill,
   decode and total; (e) a ``RouterServer`` over two replicas on the card,
   one killed with requests in flight: every request completes with the
   ``generate`` tokens, no client sees a failure, ``recover.*`` books a
   respawn; with the request-trace plane armed, and while the fleet is up,
   ``adfleet --once --raw`` over the router and its replicas and
   ``adtrace`` through the router read it for phase 22; (f) the ``torch.export`` artifact of the full forward, loaded on
   the card, against the eager apply (within SERVE_LOGIT_RTOL), a load for
   the CPU refused, the artifact's bytes; (g) ``python -m
   autodist_tpu_torch.examples.serve_lm --d_model 512 --n_layers 6 --vocab
   32000 --max_len 512`` in its own process: every request served; (h) one
   short leg with the lock sanitizer armed (``locks``): 8 requests through
   an ``InferenceServer`` on the dense engine, its observed lock-order
   edges exported for phase 22.
22. The operator tools (``autodist_tpu_torch.tools``), each a ``python -m``
   process that must exit 0, on what phases 20 and 21 left: ``adprof``
   summarizes (d)'s profile and diffs it against itself (no regression);
   ``tracedump`` merges (g)'s two span dumps into a Chrome trace of two
   lanes; ``graftlint --crosscheck`` on (h)'s export reports no dynamic
   finding and prints the observed and unexercised edges; and the results
   of ``adtop`` (a "ps" status), ``adfleet`` (the router's routed count) and
   ``adtrace`` (as many completed requests as the fleet served), run while
   their servers were up. It starts no model.
23. The long-context entry point at head width 128 (``--only
   long_context_128`` runs it with the hd-128 checks and times of phases 5
   and 7): ``long_context_lm --d_model 1024`` (8 heads of 128, d_ff 4,096,
   vocab 32,000, seq 8,192, 6 layers, flash, every block rematerialized,
   the fused head at D = 1,024, bf16, Adam 1e-3) at 8 sequences: 3 counted
   steps (the hd-128 forward and the one-pass backward ``flash_bwd``
   must launch, the backward 6 times a step, and no hd-64 flash kernel;
   losses finite), tokens/s and MFU over 4 steady steps with peak
   memory, a profiler window over 2; then phase 8's ring of one card at
   the same width, 3 counted steps (the hd-128 carry and ``flash_bwd`` at
   f32 parts must launch and no other flash kernel); then phase 7b's
   one-card ring replay at hd 128, a check only.
24. The port's optimizers (``--only optimizers``): (a) the flagship at
   phase 4's shape (32 x 256, no accumulation) under ``choose_optimizer``'s
   factored choice, forced by a 1 MiB budget (the port's Adafactor,
   ``optax.adafactor``): ``run_many(2)`` equals ``run()`` bit for bit, one
   replay counting twice a step's launches; (b) NCF at 65,536 one step
   under Adafactor against the plain float64 update of optax's first step
   on the same gradients (within 1e-5 of the update's largest magnitude,
   beyond half an f32 ulp of each stored parameter); (c) save and restore
   into the same runner, v1 and v2, bit for bit: (b)'s Adafactor state,
   NCF under SGD with momentum 0.9, and bf16 tables in v1.
25. One JSON line of per-kernel numbers (the seven kernels and the four
   hd-128 instantiations, their launches by phase with ``unroll``, ``moe``,
   ``async_ps``, ``lm_family``, ``telemetry``, ``serving``,
   ``long_context_128``, ``sequence_parallel_128`` and ``optimizers``; the
   fused head's also at D = 768 and 1,024), then the result line.

``python3 chip_smoke.py --only unroll`` (or ``--only moe_pipe``, ``--only
async_ps``, ``--only lm_family``, ``--only telemetry``, ``--only serving``,
``--only long_context_128``, ``--only optimizers``) builds the kernels and
runs phase 16 (or 17, 18, 19, 20, 21, 23, 24) alone, without the kernel
line; ``--only tools`` runs phases 20, 21 and 22. A
process the Coordinator launched (``AUTODIST_WORKER`` set) runs only phase
18 (e)'s worker half, or phase 20 (g)'s with ``CHIP_SMOKE_WORKER=telemetry``,
and prints no result line.
"""

import collections
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import torch

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

D, V = 512, 32000
MAIN_MICRO_ROWS = 32 * 256        # rows the main path's head sees per micro-batch
FLAGSHIP_ROWS = 384 * 256         # the JAX flagship's micro-batch (bench.py)
LSE_ATOL = 0.01
# Every output is held tile by tile: ||got - want|| / ||want|| over each
# 64-long tile of the dimension a kernel's block owns (rows, keys or vocab
# columns), split by batch and head, at most TILE_RTOL. The kernels and their
# plain versions round the same operands to bf16, so what is left is another
# f32 summation order and one bf16 rounding of the stored result (2^-9
# relative). A tile left unwritten, zeroed or unscaled reads about 1.
TILE = 64
# Kernel-name marks of the libraries' matmuls and convolutions (profile windows).
LIBRARY_PRODUCTS = ("gemm", "nvjet", "cutlass", "xmma", "cudnn")
TILE_RTOL = 1e-2
STEADY_STEPS = 6                  # steps timed for throughput after the counted run
PROFILE_STEPS = 3                 # steps traced after those

# Long-context slice: flash attention at the example's sequence length.
LC_SEQ, LC_BATCH, LC_HEADS, HEAD_DIM = 8192, 8, 8, 64
FLASH_LSE_ATOL = 1e-3
# The flash backward's row term D (f32 sums of 64 or 128 products) against
# its plain version: another f32 summation order only.
DD_RTOL = 1e-5
LC_COUNTED, LC_STEADY, LC_PROFILE = 3, 4, 2
# Phase 23: the long-context entry point at d_model 1,024 (head width 128).
LC128_D, LC128_COUNTED = 1024, 3
FLAGSHIP_STEPS, FLAGSHIP_ACCUM = 10, 8      # timed steps of phase 9, its micro-batches a step
RING_SHARDS = 4                   # shards of the ring replay on one card
# The forward kernels' blocks hold 192 query rows, 64 per consumer
# warpgroup; their key tiles 128 keys. Lengths one past a 128- and a
# 192-row block and one short of the long-context length, and k_offsets
# whose first visible row falls in each consumer's rows of a block.
EDGE_LENGTHS = (129, 193, LC_SEQ - 1)
EDGE_K_OFFSETS = (100, 150, 200, 300)
# The backward kernels stream 64-row tiles; dK/dV blocks hold 128 keys (two
# consumers of 64), dQ blocks 192 query rows (three of 64): lengths one
# short of and one past each.
BWD_EDGE_LENGTHS = (63, 65, 127, 129, 191, 193)
# ptxas's "wgmma serialized" warnings (C7518-C7520: a wgmma on a divergent
# path; C7512: too few registers): a kernel that shows one runs every wgmma
# one after the other.
SERIALIZED_WGMMA = ("wgmma", "serialized")
# The fused-head forward's blocks hold 128 rows and walk 128-column vocab
# tiles, dh's 64 rows and 64-column tiles: (N, V) one short of or one past
# each, every V odd (the packed "dv" table's row stride is padded to 8).
XENT_EDGES = ((127, 129), (129, 65), (63, 129), (65, 65))
# The dw/db kernel's blocks own 64 vocab columns, two blocks to a cluster,
# and walk 64-row stripes: N = 1, one short of and one past a stripe; V = 63
# and 65 (the first cluster's second block holds no column, or one), 129
# (the second cluster's second block holds none) and 193 (one).
XENT_DWDB_EDGES = tuple((n, v) for n in (1, 63, 65) for v in (63, 65, 129, 193))
# The wide kernels' widths (D = 768 and 1,024), and lm1b's full softmax (f32
# h, "vd", a bias) at N rows by its vocabulary.
XENT_WIDE = (768, 1024)
# The wide dh and dw/db kernels run clusters of two, the d halves of a
# 64-row stripe (dh) or 64-column vocab tile (dw/db): N of 1, 63, 65, 127
# and 129 (the second or third stripe holds no row or one) with V of 63,
# 65, 127, 129, 193 and 257 (the second, third or fifth tile holds no
# column or one), every V odd.
XENT_WIDE_EDGES = tuple((n, v) for n in (1, 63, 65, 127, 129)
                        for v in (63, 65, 127, 129, 193, 257))
LM1B_VOCAB = 793471
LM1B_CHECK_ROWS = 2048
# A spill in these kernels fails phase 2.
NO_SPILL = ("xent_dwdb_kernel", "xent_dwdb_wide_kernel", "xent_dh_wide_kernel",
            "xent_dh_wide_plain_kernel", "flash_bwd_kernel")
# Phase 12: the Ulysses replay's shards (4 seq ranks: 2 of the 8 heads each).
ULYSSES_SHARDS = 4
# Phase 14: ResNet-50 benchmark runs (strategy, images a card, timed steps).
IMAGE_RUNS = (("PSLoadBalancing", 32, 15), ("AllReduce", 32, 15),
              ("PSLoadBalancing", 128, 10), ("AllReduce", 128, 10))
# The record-pool run: (strategy, images a card, timed steps), over record
# shards of IMAGE_RECORDS records of IMAGE_RECORD_SIZE px, half of them pooled.
IMAGE_CACHE_RUN = ("PSLoadBalancing", 128, 20)
IMAGE_RECORDS, IMAGE_RECORD_SIZE = 512, 256
# The record pool's host-time window: one refresh interval (the default 16).
POOL_PROFILE_STEPS = 16
# Phase 15: BERT benchmark runs (size, global batch, micro-batches a step,
# steps), the disk run's batch and steps over a corpus of TEXT_LINES lines
# from TEXT_WORDS words; NCF's steps (synthetic, and over RATING_USERS
# users' ratings of RATING_ITEMS items: one epoch); disk_input's corpus rows
# and timed steps; the raw baseline's timed steps.
BERT_RUNS = (("base", 2048, 8, 4), ("large", 128, 1, 4))
BERT_DISK_BATCH, BERT_DISK_STEPS = 32, 4
TEXT_LINES, TEXT_WORDS = 5000, 5000
NCF_STEPS, NCF_RATING_STEPS = 6, 4
RATING_USERS, RATING_ITEMS = 2000, 3000
DISK_ROWS, DISK_STEPS = 8192, 5
RAW_STEPS = 10
# Phase 11: (label, builder (None: AutoDist's default), session keywords,
# codec: None, "bf16", or the residual the codec keeps, "error").
STRATEGY_STEPS = 3
STRATEGY_LOWERINGS = (
    ("AllReduce()", "AllReduce", {}, {}, None),
    ("AutoDist() default (PSLoadBalancing)", None, {}, {}, None),
    ("PS()", "PS", {}, {}, None),
    ("PartitionedPS()", "PartitionedPS", {}, {}, None),
    ("UnevenPartitionedPS()", "UnevenPartitionedPS", {}, {}, None),
    ("PartitionedAR()", "PartitionedAR", {}, {}, None),
    ("RandomAxisPartitionAR()", "RandomAxisPartitionAR", {}, {}, None),
    ("Parallax()", "Parallax", {}, {}, None),
    ("Parallax(HorovodCompressorEF)", "Parallax", {"compressor": "HorovodCompressorEF"}, {},
     "error"),
    ("AllReduce(HorovodCompressor)", "AllReduce", {"compressor": "HorovodCompressor"}, {},
     "bf16"),
    ("AllReduce(PowerSGDCompressor, rank 2)", "AllReduce",
     {"compressor": "PowerSGDCompressor", "power_sgd_rank": 2}, {}, "error"),
    ("AllReduce() zero=1", "AllReduce", {}, {"zero": 1}, None),
)
# Phase 16: the flagship's unroll factors (0: run() itself) and the steps
# timed at each; NCF's factors, the steps timed at each and its profiler
# windows' steps.
FLAGSHIP_UNROLLS = (0, 1, 2, 4)
FLAGSHIP_UNROLL_STEPS = 8
NCF_UNROLLS = (1, 2, 4, 8)
NCF_UNROLL_STEPS, NCF_PROFILE_STEPS = 64, 16
# Phase 16b: train() steps after the search.
SEARCH_TRAIN_STEPS = 16
# Phase 17: the JAX sweep's moe row (examples/benchmark/run_all.py:77-80),
# the expert replay's shards, and the pipeline example's default shape.
MOE_SWEEP_ARGS = ["--batch_size", "512", "--accum", "4"]
MOE_COUNTED, MOE_SWEEP_STEPS = 3, 5
EXPERT_SHARDS = 4
PIPE_SHAPE = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=8, d_ff=2048, max_len=257,
                  n_stages=4, num_microbatches=4)
PIPE_BATCH, PIPE_SEQ = 16, 256
PIPE_RTOL = 1e-2
# Phase 18: (a)/(d)/(e) steps, (b)/(f) steps per worker, and the two-node
# loopback spec of (e) (both "nodes" on card 0). Its working directory (the
# strategy handed to the worker, the cluster spec, the worker's report) is
# under the checkout's git-ignored build/.
ASYNC_STEPS = 3
ASYNC_THREAD_STEPS = 6
ASYNC_ROWS, ASYNC_SEQ = 384, 256
ASYNC_MODEL_ARGS = []             # flagship_lm flags (a host rehearsal shrinks the model)
ASYNC_TWO_NODES = {"nodes": [{"address": "localhost", "gpus": [0], "chief": True},
                             {"address": "127.0.0.1", "gpus": [0]}]}
# Phase 19: counted steps of lm1b's sampled and full-softmax runs; the cut
# of V at which the fused loss meets the plain f32 head; scale_lm's sizes
# (d_model, layers, batch) and timed steps; the sweep row's steps.
LM1B_STEPS, LM1B_FULL_STEPS = 3, 2
LM1B_CUT_VOCAB = 32000
SCALE_RUNS = ((768, 12, 192), (1024, 12, 128), (1024, 24, 96))
SCALE_STEPS = 3
LM1B_SWEEP_STEPS = 3
LM_FAMILY_ARGS, SCALE_ARGS = [], []   # lm1b_train and scale_lm flags a host rehearsal adds
os.environ.setdefault("AUTODIST_WORKING_DIR", os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "build", "autodist_wd"))


# Phase 22's inputs, written by phases 20 and 21 (under the git-ignored
# build/), and the results of the tools phases 20 and 21 ran.
ROOT = os.path.dirname(os.path.abspath(__file__))
TOOLS_DIR = os.path.join(ROOT, "build", "chip_tools")
TOOLS = {}
SAN_REQUESTS = 8
# Phase 6's long-context runner and first weights, which phase 16 reuses.
LC_SESSION = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(build_log: str):
    """One line per kernel instantiation from ``-Xptxas -v``: its name,
    registers, barriers, static shared memory, stack and spills; and every
    ptxas warning (a serialized wgmma among them)."""
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line:
            mangled = line.split("for ", 1)[1].strip()
            kernel = next((k for k in ("flash_fwd_carry_kernel", "flash_fwd_kernel",
                                       "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                                       "flash_bwd_kernel", "flash_bwd_dq_convert_kernel",
                                       "flash_bwd_dd_kernel",
                                       "xent_fwd_wide_kernel", "xent_dh_wide_kernel",
                                       "xent_dh_wide_plain_kernel",
                                       "xent_dwdb_wide_kernel", "xent_fwd_kernel",
                                       "xent_dh_kernel", "xent_dwdb_kernel",
                                       "xent_pack_kernel", "lstm_fwd_kernel",
                                       "lstm_bwd_kernel")
                           if k in mangled), mangled)
            # A wide kernel's template arguments: the layout and its chunk count.
            args = re.search(r"_wide_kernelILb([01])ELi(\d+)E", mangled)
            if args:
                kernel += f"<{'vd' if args.group(1) == '1' else 'dv'}, {args.group(2)}>"
            # A flash kernel's: the head width, and a backward kernel's output type.
            args = re.search(r"flash_\w+?_kernelILi(\d+)E(f|13__nv_bfloat16)?E", mangled)
            if args:
                out = {"f": ", f32", "13__nv_bfloat16": ", bf16"}.get(args.group(2), "")
                kernel += f"<hd {args.group(1)}{out}>"
            # The one-pass backward's and its dQ pass's: the output type (hd 128).
            args = re.search(r"flash_bwd(?:_dq_convert)?_kernelI(f|13__nv_bfloat16)E", mangled)
            if args:
                kernel += f"<hd 128, {'f32' if args.group(1) == 'f' else 'bf16'}>"
            frame = lines[i + 1].strip() if i + 1 < len(lines) else ""
            used = lines[i + 2].split("Used", 1)[-1].strip() if i + 2 < len(lines) else ""
            yield f"{kernel}: {used}; {frame}"
        elif "Performance Loss" in line or "warning" in line.lower():
            yield line.strip()


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def tool_proc(name: str, *args: str) -> subprocess.Popen:
    """``python -m autodist_tpu_torch.tools.<name> args`` from the
    checkout's root, its output captured."""
    return subprocess.Popen([sys.executable, "-m", f"autodist_tpu_torch.tools.{name}",
                             *args], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def tool_result(name: str, proc: subprocess.Popen, timeout: float = 120.0) -> str:
    """The tool's standard output; raises unless it exited 0 in time (and
    then leaves no process behind)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"tools: {name} exited {proc.returncode}: stderr "
                             f"{err[-2000:]!r} stdout {out[-2000:]!r}")
    return out


def stop(procs) -> None:
    """Kill whatever of ``procs`` still runs (a phase that failed early)."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def rate(r) -> str:
    """A timed row's achieved tensor-core TFLOP/s and the share of its bound
    reached (bound / time); stored in the row for the JSON line too."""
    r["tflops"] = r["flops"] / (r["ms"] * 1e-3) / 1e12
    r["bound_share"] = r["bound"][0] / r["ms"]
    return f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of the bound"


def inputs(n, v, layout, bias, gen, dev, d=D, h_dtype=torch.bfloat16):
    h = (torch.randn(n, d, generator=gen) * 0.5).to(dev, h_dtype)
    w = torch.randn(d, v, generator=gen) * 0.05
    w = (w.T.contiguous() if layout == "vd" else w).to(dev)
    b = (torch.randn(v, generator=gen) * 0.1).to(dev) if bias else None
    g = torch.rand(n, generator=gen).to(dev)
    return h, w, b, g


def check_kernels(fx, dev):
    """Phase 3a: every kernel against its plain version; max abs errors."""
    gen = torch.Generator().manual_seed(0)
    errs = {"xent_fwd": 0.0, "xent_dh": 0.0, "xent_dwdb": 0.0}
    cases = [(1000, V - 1, layout, bias) for layout in ("dv", "vd") for bias in (True, False)]
    cases += [(n, v, layout, bias) for n, v in XENT_EDGES + XENT_DWDB_EDGES
              for layout in ("dv", "vd") for bias in (True, False)]
    cases += [(MAIN_MICRO_ROWS, V, "dv", False), (LC_BATCH * LC_SEQ, V, "dv", False)]
    cases = [(D, torch.bfloat16) + c for c in cases]
    for d in XENT_WIDE:
        cases += [(d, torch.bfloat16, n, v, layout, bias)
                  for n, v in ((1000, 4001),) + XENT_WIDE_EDGES
                  for layout in ("dv", "vd") for bias in (True, False)]
    cases.append((1024, torch.float32, LM1B_CHECK_ROWS, LM1B_VOCAB, "vd", True))
    for d, h_dtype, n, v, layout, bias in cases:
        h, w, b, g = inputs(n, v, layout, bias, gen, dev, d, h_dtype)
        packed = fx.xent_pack_w(w, layout)
        torch.cuda.synchronize()
        if not torch.equal(packed, fx.pack_w_plain(w, layout)):
            raise AssertionError(f"the pack kernel disagrees with its plain version at v={v} "
                                 f"layout={layout}")
        lse = fx.xent_fwd(h, w, b, layout)
        dh = fx.xent_dh(h, w, b, lse, g, layout)
        dw, db = fx.xent_dwdb(h, w, b, lse, g, layout)
        torch.cuda.synchronize()
        if dh.dtype != h.dtype:
            raise AssertionError(f"dh came back {dh.dtype} for {h.dtype} h")
        # The kernels read f32 h rounded to bf16: the plain versions get the
        # same rounding, and the lse is also held against f32 h's.
        hk = fx.kernel_h(h)
        ref_lse = fx.matmul_logsumexp_plain(hk, w, b, layout)
        ref_dh, ref_dw, ref_db = fx.lse_backward_plain(hk, w, b, lse, g, layout)
        e_lse = (lse - ref_lse).abs().max().item()
        if hk is not h:
            e_f32 = (lse - fx.matmul_logsumexp_plain(h, w, b, layout)).abs().max().item()
            log(f"check d={d} f32 h: lse against the plain version at f32 h {e_f32:.3g}")
            if not e_f32 <= LSE_ATOL:
                raise AssertionError(f"f32 h: lse {e_f32} from the f32 plain version")
            same_bits(fx, h, w, b, lse, g, layout, (dh, dw, db), f"d={d} f32 h n={n} v={v}")
        v_dim = 0 if layout == "vd" else 1
        e = {name: compare(got, want, dim)
             for name, got, want, dim in (("dh", dh, ref_dh, 0), ("dw", dw, ref_dw, v_dim),
                                          ("db", db, ref_db, 0))}
        log(f"check d={d} h={str(h.dtype)[6:]} n={n} v={v} layout={layout} bias={bias}: "
            f"lse {e_lse:.3g}; "
            + "; ".join(f"{k} {describe(c)}" for k, c in e.items()))
        ok = math.isfinite(e_lse) and e_lse <= LSE_ATOL and all(
            c[2] <= TILE_RTOL for c in e.values())
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version at d={d} n={n} "
                                 f"v={v} layout={layout} bias={bias} h={h.dtype}")
        errs["xent_fwd"] = max(errs["xent_fwd"], e_lse)
        errs["xent_dh"] = max(errs["xent_dh"], e["dh"][0])
        errs["xent_dwdb"] = max(errs["xent_dwdb"], e["dw"][0], e["db"][0])
    return errs


def same_bits(fx, h, w, b, lse, g, layout, first, label):
    """dh, dw and db of a second call equal ``first`` bit for bit: no
    backward kernel sums in an order that changes from call to call."""
    second = (fx.xent_dh(h, w, b, lse, g, layout), *fx.xent_dwdb(h, w, b, lse, g, layout))
    torch.cuda.synchronize()
    same = [torch.equal(x, y) for x, y in zip(first, second)]
    log(f"check {label}: dh, dw and db bit-identical over two calls: {same}")
    if not all(same):
        raise AssertionError(f"{label}: the backward kernels gave other bits on a second call")


def worst_tile(got, want, dim):
    """The largest ``||got - want|| / ||want||`` over tiles of TILE entries
    along ``dim`` (the dimension a kernel block owns). A tile spans the last
    dimension (the head or model width) and is split by every other one
    (batch, head), so one wrong block shows however small its share of the
    whole. A tile whose reference is 0 must come out 0 (inf otherwise)."""
    def norms(x):
        x = x.float().movedim(dim, 0)
        if x.dim() == 1:
            x = x[:, None]
        x = torch.cat([x, x.new_zeros(-x.shape[0] % TILE, *x.shape[1:])])
        x = x.reshape(-1, TILE, *x.shape[1:])
        return torch.linalg.vector_norm(x, dim=(1, -1))
    err, ref = norms(got.float() - want.float()), norms(want)
    ratio = torch.where(ref > 0, err / ref.clamp(min=1e-30),
                        torch.where(err > 0, math.inf, 0.0))
    return ratio.max().item()


def compare(got, want, dim):
    """``(max |got - want|, max |want|, worst tile ratio)``; NaN counts as inf."""
    diff = (got.float() - want.float()).abs().max().item()
    worst = worst_tile(got, want, dim)
    return diff, want.float().abs().max().item(), worst if math.isfinite(worst) else math.inf


def describe(c):
    return f"{c[0]:.3g} (max {c[1]:.3g}, worst tile {c[2]:.3g})"


def time_kernels(fx, dev):
    """Phase 3b: each kernel at the flagship micro-batch, as the main path
    calls it ("dv" table, no bias, g = 1/N from the mean loss)."""
    gen = torch.Generator().manual_seed(1)
    n = FLAGSHIP_ROWS
    h, w, _, _ = inputs(n, V, "dv", False, gen, dev)
    g = torch.full((n,), 1.0 / n, device=dev)
    lse = fx.xent_fwd(h, w, None)
    in_bytes = n * D * 2 + D * V * 4
    ops = 2.0 * n * D * V
    rows = {
        "xent_fwd": dict(flops=ops, ms=time_ms(lambda: fx.xent_fwd(h, w, None), 3),
                         plain_ms=time_ms(lambda: fx.matmul_logsumexp_plain(h, w, None), 1),
                         library_ms=time_ms(
                             lambda: torch.logsumexp(h @ w.to(h.dtype), -1), 3),
                         bound=bound(in_bytes + n * 4, ops)),
        "xent_dh": dict(flops=2 * ops, ms=time_ms(lambda: fx.xent_dh(h, w, None, lse, g), 3),
                        bound=bound(in_bytes + 2 * n * 4 + n * D * 2, 2 * ops)),
        "xent_dwdb": dict(flops=2 * ops,
                          ms=time_ms(lambda: fx.xent_dwdb(h, w, None, lse, g), 3),
                          bound=bound(in_bytes + 2 * n * 4 + D * V * 4 + V * 4, 2 * ops)),
    }
    # One plain call computes dh, dw and db together: its time stands for both.
    plain_bwd = time_ms(lambda: fx.lse_backward_plain(h, w, None, lse, g), 1)
    rows["xent_dh"].update(plain_ms=plain_bwd, library_ms=None)
    rows["xent_dwdb"].update(plain_ms=plain_bwd, library_ms=None)
    for name, r in rows.items():
        log(f"time {name} N={n}: kernel {r['ms']:.3f} ms ({rate(r)}), plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound'][0]:.3f} ms ({r['bound'][1]})")
    # The pack runs inside the forward's and dh's wrappers, so their times
    # above include it: f32 w read once, bf16 w written once.
    pack_ms = time_ms(lambda: fx.xent_pack_w(w), 10)
    log(f"time xent_pack_w D={D} V={V} (dv): {pack_ms:.3f} ms, plain "
        f"{time_ms(lambda: fx.pack_w_plain(w), 10):.3f} ms, bound "
        f"{bound(D * V * 6, 0)[0]:.3f} ms (bytes)")
    dwdb_yardstick(fx, h, w, lse, g, rows["xent_dwdb"])
    # The main path's own micro-batch, for the step-time breakdown.
    m = MAIN_MICRO_ROWS
    hm, lm, gm = h[:m], lse[:m], torch.full((m,), 1.0 / m, device=dev)
    log(f"time at the main path's N={m}: "
        f"xent_fwd {time_ms(lambda: fx.xent_fwd(hm, w, None), 5):.3f} ms, "
        f"xent_dh {time_ms(lambda: fx.xent_dh(hm, w, None, lm, gm), 5):.3f} ms, "
        f"xent_dwdb {time_ms(lambda: fx.xent_dwdb(hm, w, None, lm, gm), 5):.3f} ms")
    del h, w, lse, g, hm, lm, gm
    free_card()
    for label, wide in time_wide(fx, dev).items():
        for name, r in wide.items():
            rows[name].setdefault("wide", {})[label] = r
    return rows


def time_wide(fx, dev):
    """Phase 3b at D = 768 and 1,024: each kernel at scale_lm's default head
    (d768: N = 49,152, V = 32,000, "dv", no bias) and its d1024 head (N =
    32,768; the forward beside the library call at both), and at lm1b's full
    softmax (D = 1,024, N = 32,768, V = 793,471, "vd", a bias, f32 h: the
    wrappers' bf16 rounding of h is in their times; no library call, whose
    logits would be about 104 GB). At both scale_lm heads the lse, dh, dw
    and db are held against the plain versions (``check_at_size``), and dh,
    dw and db must give the same bits twice at the d1024 head. ``{label:
    {kernel: row}}``, each row with its width ``d``."""
    gen = torch.Generator().manual_seed(2)
    lib = fx._lib()
    log("wide dh and dw/db kernels: clusters resident at once: "
        + ", ".join(f"D={d} {layout} {name} {lib.xent_wide_active_clusters(k, d, vd)}"
                    for d in XENT_WIDE for vd, layout in ((0, "dv"), (1, "vd"))
                    for k, name in ((0, "dh"), (1, "dw/db"))))
    out = {}
    for label, d, n, v, layout, bias, h_dtype in (
            ("scale_lm d768", 768, 49152, V, "dv", False, torch.bfloat16),
            ("scale_lm d1024", 1024, 32768, V, "dv", False, torch.bfloat16),
            ("lm1b full softmax", 1024, 32768, LM1B_VOCAB, "vd", True, torch.float32)):
        h, w, b, _ = inputs(n, v, layout, bias, gen, dev, d, h_dtype)
        g = torch.full((n,), 1.0 / n, device=dev)
        lse = fx.xent_fwd(h, w, b, layout)
        if label == "scale_lm d1024":
            same_bits(fx, h, w, b, lse, g, layout,
                      (fx.xent_dh(h, w, b, lse, g, layout), *fx.xent_dwdb(h, w, b, lse, g, layout)),
                      label)
        hb = h.element_size()
        in_bytes = n * d * hb + d * v * 4 + (v * 4 if bias else 0)
        ops = 2.0 * n * d * v
        reps = 3 if v == V else 1
        rows = {
            "xent_fwd": dict(flops=ops, ms=time_ms(lambda: fx.xent_fwd(h, w, b, layout), reps),
                             bound=bound(in_bytes + n * 4, ops), library_ms=None),
            "xent_dh": dict(flops=2 * ops,
                            ms=time_ms(lambda: fx.xent_dh(h, w, b, lse, g, layout), reps),
                            bound=bound(in_bytes + 2 * n * 4 + n * d * hb, 2 * ops),
                            library_ms=None),
            "xent_dwdb": dict(flops=2 * ops,
                              ms=time_ms(lambda: fx.xent_dwdb(h, w, b, lse, g, layout), reps),
                              bound=bound(in_bytes + 2 * n * 4 + d * v * 4 + v * 4, 2 * ops),
                              library_ms=None),
        }
        if v == V:
            rows["xent_fwd"]["library_ms"] = time_ms(
                lambda: torch.logsumexp(h @ w.to(h.dtype), -1), 3)
            rows["xent_fwd"]["plain_ms"] = time_ms(
                lambda: fx.matmul_logsumexp_plain(h, w, b, layout), 1)
            plain_bwd = time_ms(lambda: fx.lse_backward_plain(h, w, b, lse, g, layout), 1)
            rows["xent_dh"]["plain_ms"] = rows["xent_dwdb"]["plain_ms"] = plain_bwd
            check_at_size(fx, h, w, b, lse, g, layout, label)
            if not rows["xent_fwd"]["ms"] < rows["xent_fwd"]["library_ms"]:
                raise AssertionError(f"{label}: the forward kernel is slower than the "
                                     f"library call: {rows['xent_fwd']}")
        for name, r in rows.items():
            r["d"] = d
            log(f"time {name} D={d} N={n} V={v} {layout} bias={bias} h={str(h.dtype)[6:]} "
                f"({label}): kernel {r['ms']:.3f} ms ({rate(r)}), plain {r.get('plain_ms')} ms, "
                f"library {r['library_ms']} ms, bound {r['bound'][0]:.3f} ms ({r['bound'][1]}); "
                f"card {card_line()}")
        out[label] = rows
        del h, w, b, g, lse
        free_card()
    return out


def check_at_size(fx, h, w, b, lse, g, layout, label):
    """The lse, dh, dw and db at a head the main path runs, against the plain
    versions on the same inputs, TILE_RTOL in every tile: the grid in many
    waves of clusters, as the checks' small shapes are not."""
    ref_lse = fx.matmul_logsumexp_plain(h, w, b, layout)
    ref = fx.lse_backward_plain(h, w, b, lse, g, layout)
    got = (fx.xent_dh(h, w, b, lse, g, layout), *fx.xent_dwdb(h, w, b, lse, g, layout))
    torch.cuda.synchronize()
    e_lse = (lse - ref_lse).abs().max().item()
    v_dim = 0 if layout == "vd" else 1
    e = {name: compare(x, y, dim) for name, x, y, dim in zip(
        ("dh", "dw", "db"), got, ref, (0, v_dim, 0))}
    log(f"check {label} at size: lse {e_lse:.3g}; "
        + "; ".join(f"{k} {describe(c)}" for k, c in e.items()))
    if not (math.isfinite(e_lse) and e_lse <= LSE_ATOL
            and all(c[2] <= TILE_RTOL for c in e.values())):
        raise AssertionError(f"{label}: a kernel disagrees with its plain version at size")


def dwdb_yardstick(fx, h, w, lse, g, row):
    """dw/db at the flagship micro-batch: the same bits from two calls; its
    time on a table packed beforehand (the backward packs once for dh and
    dw/db); and cuBLAS's two products of the same work, S = h @ wp into a
    materialised bf16 [N, V] and h.T @ S, which skip the softmax (a
    yardstick for the text only: no library call computes dw/db)."""
    first, second = fx.xent_dwdb(h, w, None, lse, g), fx.xent_dwdb(h, w, None, lse, g)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"check xent_dwdb N={h.shape[0]}: dw and db bit-identical over two calls: {same}")
    if not same:
        raise AssertionError("xent_dwdb gave different bits from call to call")
    del first, second
    wp = fx.xent_pack_w(w)
    packed_ms = time_ms(lambda: fx.xent_dwdb(h, w, None, lse, g, wp=wp), 3)
    s = torch.empty(h.shape[0], V, dtype=torch.bfloat16, device=h.device)
    scores_ms = time_ms(lambda: torch.matmul(h, wp, out=s), 3)
    dw_ms = time_ms(lambda: torch.matmul(h.T, s), 3)
    del s
    torch.cuda.empty_cache()
    log(f"time xent_dwdb N={h.shape[0]} on a packed table: {packed_ms:.3f} ms "
        f"({row['flops'] / (packed_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{row['bound'][0] / packed_ms:.3f} of the bound); cuBLAS h @ wp "
        f"{scores_ms:.3f} ms + h.T @ S {dw_ms:.3f} ms = {scores_ms + dw_ms:.3f} ms; "
        f"{fx._lib().xent_dwdb_active_clusters()} clusters of 2 resident at once")


def main_path(kernels, dev):
    """Phase 4: the flagship training step through the port's entry points."""
    from autodist_tpu_torch import AllReduce, AutoDist
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.utils.flops import mfu, transformer_flops_per_token

    micro, accum, seq, steps = 32, 2, 256, 3
    cfg = tlm.TransformerLMConfig(vocab_size=V, d_model=D, n_heads=8, n_layers=6,
                                  d_ff=2048, max_len=512, fused_head=True,
                                  tied_output=False, dtype=torch.bfloat16)
    model, params = tlm.init_params(cfg, seed=0, device=dev)

    # Reference on a small input: fused head (kernels) vs plain logits head.
    small = {k: torch.as_tensor(a).to(dev)
             for k, a in tlm.synthetic_batch(cfg, 4, seq, seed=99).items()}
    plain_model = tlm.TransformerLM(dataclasses.replace(cfg, fused_head=False))
    with torch.no_grad():
        fused = float(tlm.make_loss_fn(model)(params, small))
        plain = float(tlm.make_loss_fn(plain_model)(params, small))
    log(f"reference: fused-head loss {fused:.6f} vs logits-head loss {plain:.6f}")
    if not (math.isfinite(fused) and abs(fused - plain) <= 1e-2 * abs(plain)):
        raise AssertionError("fused-head loss disagrees with the logits head")

    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                  strategy_builder=AllReduce())
    batches = [tlm.synthetic_batch(cfg, micro * accum, seq, seed=i) for i in range(steps)]
    step = ad.function(tlm.make_loss_fn(model), params,
                       lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
                       example_batch=batches[0], accumulation_steps=accum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = counted_steps(step, batches, kernels)
    log(f"main path: losses {losses}; step seconds {times}")
    log(f"main path: kernel launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    missing = [name for name, count in launches.items()
               if count == 0 and name.startswith("xent_")]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    # Throughput over more steady steps than the counted run has, then a trace.
    more = [tlm.synthetic_batch(cfg, micro * accum, seq, seed=steps + i)
            for i in range(STEADY_STEPS + PROFILE_STEPS)]
    t0 = time.perf_counter()
    for batch in more[:STEADY_STEPS]:
        float(step(batch))
    per_step = (time.perf_counter() - t0) / STEADY_STEPS
    tokens = micro * accum * seq
    flops = transformer_flops_per_token(D, 6, 2048, V, seq) * tokens
    log(f"main path: {tokens / per_step:.1f} tokens/s over {STEADY_STEPS} steady steps "
        f"({tokens} tokens/step, {1e3 * per_step:.3f} ms/step), MFU "
        f"{mfu(flops / per_step):.4f} of 989 TFLOP/s")
    profile_steps(step, more[STEADY_STEPS:])
    return launches


def counted_steps(step, batches, kernels):
    """One step per batch with every launch count set to 0 just before and
    read just after: ``(losses, step seconds, {kernel: launches})``. Fails
    on a non-finite loss."""
    for k in kernels:
        k.launches = 0
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(float(step(batch)))       # float() waits for the step
        times.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in kernels}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    return losses, times, launches


def device_kernels(prof):
    """The device kernels a ``torch.profiler`` window recorded."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_us(kernels) -> float:
    """The union of the kernels' intervals, in microseconds."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def profile_steps(step, batches, label="profile"):
    """A torch.profiler window over steady steps of a main path: device busy
    time per step (the union of kernel intervals), the device's idle share
    of the wall time, the port's kernels and the kernels that take the most.
    The window records the card's activity only: nothing here reads a host
    event, and recording every ATen call as one slowed the steps and took
    seconds to process (a DenseNet-121 window 8.4 s against 2.9)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            float(step(batch))
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    n = len(batches)
    if not kernels:
        log(f"{label}: the profiler recorded no device time; busy and idle share "
            "not measured")
        return
    busy = busy_us(kernels)
    per_name = collections.Counter()
    for e in kernels:
        per_name[e.name] += e.time_range.elapsed_us()
    def share(*marks):
        return sum(us for name, us in per_name.items() if any(m in name for m in marks)) \
            / n / 1e3

    log(f"{label}: {n} steps, {1e3 * wall / n:.3f} ms/step wall with the profiler on; "
        f"device busy {busy / n / 1e3:.3f} ms/step, idle share "
        f"{1 - busy / 1e6 / wall:.3f}; {len(kernels) // n} kernels/step; "
        f"fused-head kernels {share('xent_'):.3f} ms/step, flash kernels "
        f"{share('flash_'):.3f} ms/step, library products (cuBLAS, CUTLASS, cuDNN) "
        f"{share(*LIBRARY_PRODUCTS):.3f} ms/step, PyTorch elementwise kernels "
        f"{share('elementwise_kernel'):.3f} ms/step")
    for name, us in per_name.most_common(10):
        log(f"{label}:   {us / n / 1e3:8.3f} ms/step  {name[:110]}")


def profile_pool(b, label, steps=POOL_PROFILE_STEPS):
    """The record pool's host time, split: a profiler window over one
    refresh interval of the benchmark's own loop (batch, step, no read-back
    until the last), with the CPU time of the pool's spans (refresh, and the
    gather: index draws, their copies, the gather and augmentation
    launches) and of each step's call, against the device's busy time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            batch = b.next_batch()
            with record_function("smoke.step"):
                loss = b.step(batch)
        float(loss)
        wall = time.perf_counter() - t0
    # A span is listed twice, on the host and as the device's annotation
    # (no host time): keep the host's.
    spans = collections.Counter()
    for e in prof.key_averages():
        if e.key.startswith(("DeviceDatasetCache.", "smoke.")):
            spans[e.key] = max(spans[e.key], e.cpu_time_total / steps / 1e3)
    busy = busy_us(device_kernels(prof)) / 1e6
    log(f"{label}: {steps} steps, {1e3 * wall / steps:.3f} ms/step wall with the profiler "
        f"on, device busy {1e3 * busy / steps:.3f} ms/step, idle share "
        f"{1 - busy / wall:.3f}; host ms a step in "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(spans.items())))


def flash_inputs(b, lq, lk, gen, dev, hd=HEAD_DIM):
    """bf16 q [b, lq, 8, hd], k/v [b, lk, 8, hd] and dO like q."""
    def draw(length, std=1.0):
        return (torch.randn(b, length, LC_HEADS, hd, generator=gen) * std).to(
            dev, torch.bfloat16)
    return draw(lq), draw(lk), draw(lk), draw(lq, 0.1)


def width(name: str, hd: int) -> str:
    """A kernel's name in the JSON line and the counts: the hd-128
    instantiation's carries ``_hd128``."""
    return name if hd == HEAD_DIM else f"{name}_hd{hd}"


def check_flash(fa, dev):
    """Phase 5a: every flash kernel against its plain version; max abs errors."""
    gen = torch.Generator().manual_seed(2)
    errs = {"flash_fwd": 0.0, "flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    cases = [  # (b, lq, lk, causal, q_offset, k_offset, backward out_dtype)
        (2, 1000, 1000, True, 0, 0, None),
        (2, 1000, 1000, False, 0, 0, None),
        (2, 1000, 1000, True, 1024, 0, None),
        (2, 1000, 1000, True, 1024, 0, torch.float32),
        (2, 1000, 1000, True, 0, 300, torch.float32),
        (2, 1000, 1000, True, 0, 300, None),
        (2, 1000, 1000, True, 0, 700, torch.float32),
        (LC_BATCH, LC_SEQ, LC_SEQ, True, 0, 0, None),
    ]
    # The forward's tiling edges: one row past a 128-row and a 192-row block
    # (the last block's rows end in its second or its first consumer), and
    # one row short of the long-context length; and the backward's.
    cases += [(2, n, n, causal, 0, 0, None)
              for n in sorted(set(EDGE_LENGTHS + BWD_EDGE_LENGTHS)) for causal in (True, False)]
    for b, lq, lk, causal, qo, ko, out_dtype in cases:
        q, k, v, do = flash_inputs(b, lq, lk, gen, dev)
        out, lse = fa.flash_fwd(q, k, v, causal, qo, ko)
        dd = fa.prepare_backward_q_side(out, do)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, dd, causal, qo, ko, out_dtype)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, dd, causal, qo, ko, out_dtype)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_forward_plain(q, k, v, causal, qo, ko)
        ref = fa.flash_backward_plain(q, k, v, do, lse, dd, causal, qo, ko, out_dtype)
        e_lse = (lse - ref_lse).abs().max().item()
        e_dd = compare(dd, fa.backward_q_side_plain(out, do), 1)
        # Forward and dQ blocks own query rows, dK/dV blocks keys: dim 1 of
        # [B, L, H, 64] either way.
        e = {name: compare(got, want, 1)
             for name, got, want in (("out", out, ref_out), ("dq", dq, ref[0]),
                                     ("dk", dk, ref[1]), ("dv", dv, ref[2]))}
        if out_dtype is not None and any(t.dtype != out_dtype for t in (dq, dk, dv)):
            raise AssertionError("flash backward ignored out_dtype")
        log(f"check flash b={b} lq={lq} lk={lk} causal={causal} offsets=({qo}, {ko}) "
            f"out_dtype={out_dtype}: lse {e_lse:.3g}; row term {describe(e_dd)}; "
            + "; ".join(f"{n} {describe(c)}" for n, c in e.items()))
        ok = (math.isfinite(e_lse) and e_lse <= FLASH_LSE_ATOL and e_dd[2] <= DD_RTOL
              and all(c[2] <= TILE_RTOL for c in e.values()))
        # Query rows that see no key, and keys that no query sees: exactly 0.
        blind = min(lq, max(0, ko - qo)) if causal else 0
        unseen = min(lk, max(0, qo - ko + lq)) if causal else lk
        if blind or unseen < lk:
            zero = not (dq[:, :blind].any() or dk[:, unseen:].any() or dv[:, unseen:].any())
            log(f"check flash: dq rows 0-{blind - 1} and dk, dv keys {unseen}-{lk - 1} "
                f"exactly 0: {zero}")
            ok = ok and zero
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version at b={b} "
                                 f"lq={lq} lk={lk} causal={causal} offsets=({qo}, {ko})")
        errs["flash_fwd"] = max(errs["flash_fwd"], e["out"][0], e_lse)
        errs["flash_bwd_dkdv"] = max(errs["flash_bwd_dkdv"], e["dk"][0], e["dv"][0])
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e["dq"][0])
    return errs


def time_flash(fa, dev, hd=HEAD_DIM):
    """Phase 5b: each flash kernel at the long-context shape, causal, as the
    main path calls it, beside its plain version, its bound and the library
    call computing the same function; at head width ``hd`` (the rows keyed
    by :func:`width`): the forward, and the backward pair at 64, the
    one-pass backward at 128; then the whole backward with its row term
    beside the library's, which computes its own."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(3)
    b, length = LC_BATCH, LC_SEQ
    q, k, v, do = flash_inputs(b, length, length, gen, dev, hd)
    out, lse = fa.flash_fwd(q, k, v)
    dd = fa.prepare_backward_q_side(out, do)
    # Tensor-core FLOPs over the causal half of the scores: 2 products in the
    # forward (S, PV), 4 in dK/dV (S, dP, dV, dK), 3 in dQ (S, dP, dQ), 5 in
    # the one-pass backward (S, dP, dV, dK, dQ).
    pairs = length * (length + 1) / 2
    per_product = 2.0 * b * LC_HEADS * pairs * hd
    act = b * length * LC_HEADS * hd * 2                # one bf16 [B, L, H, hd]
    row = b * LC_HEADS * length * 4                     # one f32 [B*H, L]
    rows = {
        "flash_fwd": dict(flops=2 * per_product, ms=time_ms(lambda: fa.flash_fwd(q, k, v), 10),
                          plain_ms=time_ms(lambda: fa.flash_forward_plain(q, k, v), 1),
                          bound=bound(4 * act + row, 2 * per_product)),
    }
    if hd == HEAD_DIM:
        rows["flash_bwd_dkdv"] = dict(
            flops=4 * per_product, ms=time_ms(lambda: fa.flash_bwd_dkdv(q, k, v, do, lse, dd), 5),
            bound=bound(4 * act + 2 * row + 2 * act, 4 * per_product))
        rows["flash_bwd_dq"] = dict(
            flops=3 * per_product, ms=time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, dd), 5),
            bound=bound(4 * act + 2 * row + act, 3 * per_product))
        backward = ("flash_bwd_dkdv", "flash_bwd_dq")
    else:
        # Its f32 dQ sums (a [64, hd] tile a query tile of each head) leave
        # the card's cache at least once and are read once by the dQ pass:
        # twice their bytes beside the inputs and outputs.
        acc = b * LC_HEADS * -(-length // 64) * 64 * hd * 4
        rows["flash_bwd"] = dict(
            flops=5 * per_product, ms=time_ms(lambda: fa.flash_bwd(q, k, v, do, lse, dd), 5),
            bound=bound(4 * act + 2 * row + 3 * act + 2 * acc, 5 * per_product))
        backward = ("flash_bwd",)
    # One plain call computes dq, dk and dv together: its time stands for each.
    plain_bwd = time_ms(lambda: fa.flash_backward_plain(q, k, v, do, lse, dd), 1)
    # The yardstick: PyTorch's fused attention on the same tensors ([B, H, L, D] views).
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    rows["flash_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 10)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), do.transpose(1, 2),
                                                  retain_graph=True), 5)
    for name in backward:
        rows[name].update(plain_ms=plain_bwd, library_ms=lib_bwd)
    for name, r in rows.items():
        log(f"time {name} B={b} L={length} H={LC_HEADS} hd={hd}: kernel "
            f"{r['ms']:.3f} ms ({rate(r)}), plain {r['plain_ms']:.3f} ms, library "
            f"{r['library_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms ({r['bound'][1]})")
    # The row term: a kernel that reads O and dO once.
    dd_ms = time_ms(lambda: fa.prepare_backward_q_side(out, do), 20)
    log(f"time prepare_backward_q_side B={b} L={length} hd={hd}: kernel {dd_ms:.4f} ms, "
        f"plain {time_ms(lambda: fa.backward_q_side_plain(out, do), 5):.4f} ms, bound "
        f"{bound(2 * act + row, 0)[0]:.4f} ms (bytes)")

    # The library's backward computes its own D: set it beside the backward
    # alone and beside D's pass and the backward, as _FlashAttention.backward
    # runs them.
    def alone():
        fa.flash_bwd(q, k, v, do, lse, dd)

    def with_d():
        fa.flash_bwd(q, k, v, do, lse, fa.prepare_backward_q_side(out, do))
    whole_bound = sum(rows[name]["bound"][0] for name in backward)
    log(f"time flash backward B={b} L={length} hd={hd} ({' and '.join(backward)}): "
        f"{time_ms(alone, 5):.3f} ms (bound {whole_bound:.3f} ms), with "
        f"prepare_backward_q_side {time_ms(with_d, 5):.3f} ms; library backward (its own D "
        f"included) {lib_bwd:.3f} ms; card {card_line()}")
    return {width(name, hd): r for name, r in rows.items()}


def long_context_path(kernels, dev):
    """Phase 6: long-context training through the port's entry point."""
    from autodist_tpu_torch.examples import long_context_lm as lc
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.utils.flops import mfu, transformer_flops_per_token

    argv = ["--seq_len", str(LC_SEQ), "--batch_size", str(LC_BATCH), "--device", str(dev)]
    cfg, step, batch = lc.build(lc.parse_args(argv))
    log(f"long context: {cfg}")
    LC_SESSION.update(runner=step.runner, params={k: v.detach().cpu().clone()
                                                  for k, v in step.get_state().params.items()})

    # Reference on a small input: flash (kernels) vs dot attention, same weights.
    params = step.get_state().params
    small = {k: torch.as_tensor(a).to(dev)
             for k, a in tlm.synthetic_batch(cfg, 2, min(1024, LC_SEQ), seed=98).items()}
    dot_cfg = dataclasses.replace(cfg, attention_impl="dot", remat=False)
    with torch.no_grad():
        flash = float(tlm.make_loss_fn(tlm.TransformerLM(cfg))(params, small))
        dot = float(tlm.make_loss_fn(tlm.TransformerLM(dot_cfg))(params, small))
    log(f"long-context reference: flash loss {flash:.6f} vs dot loss {dot:.6f}")
    if not (math.isfinite(flash) and abs(flash - dot) <= 1e-2 * abs(dot)):
        raise AssertionError("flash-attention loss disagrees with dot attention")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = counted_steps(step, [batch] * LC_COUNTED, kernels)
    tokens = batch["tokens"].shape[0] * LC_SEQ
    log(f"long context: losses {losses}; step seconds {times}")
    log(f"long context: kernel launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    missing = [name for name, count in launches.items()
               if count == 0 and name != "flash_fwd_carry" and not name.endswith("_hd128")]
    if missing:
        raise AssertionError(f"long-context path never launched {missing}")

    # The entry point's timed loop (lc.main's) on this session: one warm-up
    # step, then LC_STEADY timed ones.
    torch.cuda.reset_peak_memory_stats()
    float(step(batch))
    t0 = time.perf_counter()
    for _ in range(LC_STEADY):
        loss = step(batch)
    float(loss)
    rate = tokens * LC_STEADY / (time.perf_counter() - t0)
    flops = transformer_flops_per_token(D, 6, 2048, V, LC_SEQ) * tokens
    log(f"long context: {rate:.1f} tokens/s over {LC_STEADY} steady steps "
        f"({tokens} tokens/step, {1e3 * tokens / rate:.3f} ms/step), MFU "
        f"{mfu(flops * rate / tokens):.4f} of 989 TFLOP/s (full score matrix counted); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(step, [batch] * LC_PROFILE, label="long-context profile")
    return launches


def lc_session(dev):
    """Phase 6's long-context runner and first weights (built here when
    phase 6 did not run)."""
    if not LC_SESSION:
        from autodist_tpu_torch.examples import long_context_lm as lc
        _, step, _ = lc.build(lc.parse_args(["--seq_len", str(LC_SEQ), "--batch_size",
                                             str(LC_BATCH), "--device", str(dev)]))
        LC_SESSION.update(runner=step.runner, params={
            k: v.detach().cpu().clone() for k, v in step.get_state().params.items()})
    return LC_SESSION["runner"], LC_SESSION["params"]


def carry_case(fa, q, k, v, carry, qo, ko, causal=True):
    """The carry kernel and its plain version on the same inputs; returns
    ``(worst tile of acc, of l, max |m - m_ref|, kernel's (acc, m, l))``."""
    got = fa.flash_fwd_carry(q, k, v, carry, causal, qo, ko)
    torch.cuda.synchronize()
    want = fa.flash_forward_carry_plain(q, k, v, carry, causal, qo, ko)
    e_acc = compare(got[0], want[0], 2)
    e_l = compare(got[2][..., None], want[2][..., None], 2)
    e_m = (got[1] - want[1]).abs().max().item()
    return e_acc, e_l, e_m, got


def check_carry(fa, dev):
    """Phase 7a: the carry kernel against its plain version; max abs error."""
    gen = torch.Generator().manual_seed(4)
    err = 0.0
    q, k, v, _ = flash_inputs(2, 1000, 1000, gen, dev)
    _, k_prev, v_prev, _ = flash_inputs(2, 1000, 1000, gen, dev)
    # A carry as the ring hands it on: this shard's diagonal step (and, for
    # the diagonal case, a past shard's step) done by the plain version.
    diag = fa.flash_forward_carry_plain(q, k, v, None, True, 1024, 1024)
    past = fa.flash_forward_carry_plain(q, k_prev, v_prev, None, True, 1024, 0)
    cases = [  # (label, q, k, v, carry, q_offset, k_offset, causal)
        ("ragged, no carry", q, k, v, None, 0, 0, True),
        ("past shard, carry in", q, k_prev, v_prev, diag, 1024, 0, True),
        ("diagonal, carry in", q, k, v, past, 1024, 1024, True),
    ]
    # Rows 0 .. ko - 1 see no key; the block holding row ko is part
    # pass-through, with the boundary in each consumer's rows in turn.
    cases += [(f"rows 0-{ko - 1} see no key, carry in", q, k, v, diag, 0, ko, True)
              for ko in EDGE_K_OFFSETS]
    for n in EDGE_LENGTHS:
        qe, ke, ve, _ = flash_inputs(2, n, n, gen, dev)
        for causal in (True, False):
            cases.append((f"edge, no carry, causal={causal}", qe, ke, ve, None, 0, 0, causal))
        cin = fa.flash_forward_carry_plain(qe, ke, ve, None, True, n, n)
        cases.append(("edge, carry in, causal=False", qe, ke, ve, cin, n, 0, False))
    for b, length, carry in ((LC_BATCH, LC_SEQ, False),
                             (LC_BATCH, LC_SEQ // RING_SHARDS, True)):
        qb, kb, vb, _ = flash_inputs(b, length, length, gen, dev)
        cin = fa.flash_forward_carry_plain(qb, kb, vb, None, True, length, length) \
            if carry else None
        cases.append((f"path shape B={b} L={length}", qb, kb, vb, cin,
                      length if carry else 0, 0, True))
    for label, q_, k_, v_, cin, qo, ko, causal in cases:
        e_acc, e_l, e_m, got = carry_case(fa, q_, k_, v_, cin, qo, ko, causal)
        log(f"check flash carry {label} b={q_.shape[0]} L={q_.shape[1]} offsets=({qo}, {ko}): "
            f"acc {describe(e_acc)}; l {describe(e_l)}; m {e_m:.3g}")
        ok = (e_acc[2] <= TILE_RTOL and e_l[2] <= TILE_RTOL and math.isfinite(e_m)
              and e_m <= FLASH_LSE_ATOL)
        blind = ko - qo if causal and cin is not None else 0   # rows that see no key
        if blind > 0:
            same = all(torch.equal(g[:, :, :blind], c[:, :, :blind]) for g, c in zip(got, cin))
            log(f"check flash carry: rows 0-{blind - 1} without a key carried through "
                f"bit-equal: {same}")
            ok = ok and same
        if not ok:
            raise AssertionError(f"carry kernel disagrees with its plain version: {label}")
        err = max(err, e_acc[0], e_l[0], e_m)
    return {"flash_fwd_carry": err}


def check_ring_replay(fa, dev, hd=HEAD_DIM):
    """Phase 7b: the ring's arithmetic on one card. B = 8, L = 8,192 in 4
    shards: the forward ring schedule chains the carry kernel, the backward
    schedule sums the f32 parts of ``flash_bwd`` (the dK/dV and dQ kernels
    at head width 64, the one-pass kernel at 128) as the ring does;
    out, lse, dq, dk and dv against the plain versions on the whole
    sequence; at head width ``hd``."""
    gen = torch.Generator().manual_seed(5)
    n, length = RING_SHARDS, LC_SEQ
    ll = length // n
    q, k, v, do = flash_inputs(LC_BATCH, length, length, gen, dev, hd)
    shard = [slice(r * ll, (r + 1) * ll) for r in range(n)]
    qs, ks, vs, dos = ([x[:, s].contiguous() for s in shard] for x in (q, k, v, do))
    outs, lses = [], []
    for r in range(n):
        carry = None
        for step in range(n):                        # ring order, causal steps only
            src = (r - step) % n
            if step == 0 or src <= r:
                carry = fa.flash_fwd_carry(qs[r], ks[src], vs[src], carry, True, r * ll, src * ll)
        acc, m, l = carry
        l = l.clamp(min=1e-30)
        outs.append((acc / l[..., None]).transpose(1, 2).to(torch.bfloat16).contiguous())
        lses.append((m + torch.log(l)).reshape(-1, ll))
    f32 = torch.float32
    dq = [torch.zeros(x.shape, dtype=f32, device=dev) for x in qs]
    dk = [torch.zeros(x.shape, dtype=f32, device=dev) for x in ks]
    dv = [torch.zeros(x.shape, dtype=f32, device=dev) for x in vs]
    for src in range(n):                             # K/V shard src travels r = src .. n-1
        for r in range(src, n):
            dd = fa.prepare_backward_q_side(outs[r], dos[r])
            a, b, c = fa.flash_bwd(qs[r], ks[src], vs[src], dos[r], lses[r], dd, True,
                                   r * ll, src * ll, f32)
            dq[r] += a
            dk[src] += b
            dv[src] += c
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v)
    ref_dd = fa.prepare_backward_q_side(ref_out, do)
    ref = fa.flash_backward_plain(q, k, v, do, ref_lse, ref_dd, out_dtype=f32)
    lse = torch.cat(lses, dim=1)
    e_lse = (lse - ref_lse).abs().max().item()
    e = {name: compare(torch.cat(got, dim=1), want, 1)
         for name, got, want in (("out", outs, ref_out), ("dq", dq, ref[0]),
                                 ("dk", dk, ref[1]), ("dv", dv, ref[2]))}
    log(f"check ring replay B={LC_BATCH} L={length} hd={hd} in {n} shards: lse {e_lse:.3g}; "
        + "; ".join(f"{name} {describe(c)}" for name, c in e.items()))
    if not (math.isfinite(e_lse) and e_lse <= FLASH_LSE_ATOL
            and all(c[2] <= TILE_RTOL for c in e.values())):
        raise AssertionError("the ring replay disagrees with the whole-sequence plain versions")
    return max(e_lse, e["out"][0])


def time_carry(fa, dev, hd=HEAD_DIM):
    """Phase 7c: the carry kernel at B = 8, L = 8,192 as the one-card ring
    calls it (no carry in), beside its plain version, its bound and SDPA;
    at head width ``hd``."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(6)
    b, length = LC_BATCH, LC_SEQ
    q, k, v, _ = flash_inputs(b, length, length, gen, dev, hd)
    pairs = length * (length + 1) / 2
    per_product = 2.0 * b * LC_HEADS * pairs * hd
    act = b * length * LC_HEADS * hd * 2
    acc = b * LC_HEADS * length * hd * 4                # f32 [B, H, L, hd]
    row = b * LC_HEADS * length * 4
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    r = dict(flops=2 * per_product, ms=time_ms(lambda: fa.flash_fwd_carry(q, k, v), 10),
             plain_ms=time_ms(lambda: fa.flash_forward_carry_plain(q, k, v), 1),
             library_ms=time_ms(
                 lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 10),
             bound=bound(3 * act + acc + 2 * row, 2 * per_product))
    carry = fa.flash_fwd_carry(q, k, v)
    with_carry = time_ms(lambda: fa.flash_fwd_carry(q, k, v, carry), 10)
    log(f"time flash_fwd_carry B={b} L={length} H={LC_HEADS} hd={hd}, no carry in: "
        f"kernel {r['ms']:.3f} ms ({rate(r)}), plain {r['plain_ms']:.3f} ms, library (SDPA, "
        f"no carry merge) {r['library_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
        f"({r['bound'][1]}); "
        f"with a carry in {with_carry:.3f} ms; the forward kernel "
        f"{time_ms(lambda: fa.flash_fwd(q, k, v), 10):.3f} ms in the same run")
    return {width("flash_fwd_carry", hd): r}


def ring_session(dev, d_model=D, d_ff=2048):
    """Phase 8's session (phase 23's at d_model 1,024): the long-context
    model with ring attention, 8 heads, 6 layers, remat, the fused head,
    under ``SequenceParallel`` on one card (a ring of one) and Adam 1e-3;
    its loss first held against the flash model's on a small input with
    the same weights. Returns ``(cfg, step, batch)``."""
    from autodist_tpu_torch import AutoDist, SequenceParallel
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.parallel.sequence import (create_sequence_parallel_session,
                                                      make_sequence_parallel_loss_fn)
    from autodist_tpu_torch.runner import step_function

    cfg = tlm.TransformerLMConfig(vocab_size=V, d_model=d_model, n_heads=LC_HEADS, n_layers=6,
                                  d_ff=d_ff, max_len=LC_SEQ, dtype=torch.bfloat16,
                                  remat=True, attention_impl="ring", fused_head=True,
                                  tied_output=False)
    model, params = tlm.init_params(cfg, seed=0, device=dev)
    log(f"sequence parallel: {cfg}")

    # Reference on a small input: the ring model vs the flash model, same weights.
    small = {k: torch.as_tensor(a).to(dev)
             for k, a in tlm.synthetic_batch(cfg, 2, min(1024, LC_SEQ), seed=97).items()}
    flash_model = tlm.TransformerLM(dataclasses.replace(cfg, attention_impl="flash"))
    with torch.no_grad():
        ring = float(make_sequence_parallel_loss_fn(model)(params, small))
        flash = float(tlm.make_loss_fn(flash_model)(params, small))
    log(f"sequence-parallel reference (d_model {d_model}): ring loss {ring:.6f} vs flash "
        f"loss {flash:.6f}")
    if not (math.isfinite(ring) and abs(ring - flash) <= 1e-2 * abs(flash)):
        raise AssertionError("ring-attention loss disagrees with flash attention")

    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                  strategy_builder=SequenceParallel(seq_axis_size=1), device=dev)
    runner = create_sequence_parallel_session(
        ad, model, params, lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8))
    log(f"sequence parallel: mesh {dict(runner.plan.mesh_axes)}")
    return cfg, step_function(runner, params), tlm.synthetic_batch(cfg, LC_BATCH, LC_SEQ)


def sequence_parallel_path(kernels, dev):
    """Phase 8: sequence-parallel training through the port's session, a
    ring of one card."""
    from autodist_tpu_torch.utils.flops import mfu, transformer_flops_per_token

    _, step, batch = ring_session(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = counted_steps(step, [batch] * LC_COUNTED, kernels)
    log(f"sequence parallel: losses {losses}; step seconds {times}")
    log(f"sequence parallel: kernel launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    missing = [name for name, count in launches.items()
               if count == 0 and name != "flash_fwd" and not name.endswith("_hd128")]
    if missing or launches["flash_fwd"]:
        raise AssertionError(f"sequence-parallel path: never launched {missing}; "
                             f"flash_fwd launched {launches['flash_fwd']} times")

    tokens = LC_BATCH * LC_SEQ
    torch.cuda.reset_peak_memory_stats()
    float(step(batch))
    t0 = time.perf_counter()
    for _ in range(LC_STEADY):
        loss = step(batch)
    float(loss)
    per_step = (time.perf_counter() - t0) / LC_STEADY
    flops = transformer_flops_per_token(D, 6, 2048, V, LC_SEQ) * tokens
    log(f"sequence parallel: {tokens / per_step:.1f} tokens/s over {LC_STEADY} steady steps "
        f"({tokens} tokens/step, {1e3 * per_step:.3f} ms/step), MFU "
        f"{mfu(flops / per_step):.4f} of 989 TFLOP/s (full score matrix counted); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    profile_steps(step, [batch] * LC_PROFILE, label="sequence-parallel profile")
    return launches


def flagship_full_path(kernels, dev):
    """Phase 9: the flagship entry point at its real shape."""
    from autodist_tpu_torch.examples import flagship_lm
    from autodist_tpu_torch.models import transformer_lm as tlm

    argv = ["--device", str(dev), "--steps", str(FLAGSHIP_STEPS)]
    args = flagship_lm.parse_args(argv)
    cfg, step, _ = flagship_lm.build(args)
    log(f"flagship: {cfg}")
    # Reference on a small input: fused head (kernels) vs plain logits head.
    params = step.get_state().params
    small = {k: torch.as_tensor(a).to(dev)
             for k, a in tlm.synthetic_batch(cfg, 4, args.seq_len, seed=96).items()}
    plain_model = tlm.TransformerLM(dataclasses.replace(cfg, fused_head=False))
    with torch.no_grad():
        fused = float(tlm.make_loss_fn(tlm.TransformerLM(cfg))(params, small))
        plain = float(tlm.make_loss_fn(plain_model)(params, small))
    log(f"flagship reference: fused-head loss {fused:.6f} vs logits-head loss {plain:.6f}")
    if not (math.isfinite(fused) and abs(fused - plain) <= 1e-2 * abs(plain)):
        raise AssertionError("fused-head loss disagrees with the logits head")
    del step, params
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    result = flagship_lm.main(argv)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    steps = flagship_lm.WARMUP_STEPS + FLAGSHIP_STEPS
    log(f"flagship: main took {wall:.1f} s for {steps} steps; kernel launches {launches} "
        f"({steps} steps); {result['value']} tokens/s, MFU {result['mfu']} of 989 TFLOP/s, "
        f"max_memory_allocated {result['max_memory_allocated']} bytes, final loss "
        f"{result['final_loss']}; card {card_line()}")
    want = {"xent_fwd": FLAGSHIP_ACCUM, "xent_dh": FLAGSHIP_ACCUM,
            "xent_dwdb": FLAGSHIP_ACCUM, "xent_pack_w": 2 * FLAGSHIP_ACCUM}
    wrong = {name: launches[name] for name, per_step in want.items()
             if launches[name] != per_step * steps}
    if wrong or not math.isfinite(result["final_loss"]):
        raise AssertionError(f"flagship: launches {wrong} are not {want} a step, or the "
                             f"final loss {result['final_loss']} is not finite")
    torch.cuda.empty_cache()
    _, step, batch = flagship_lm.build(args)
    float(step(batch))
    profile_steps(step, [batch] * 2, label="flagship profile")
    # The bundled calibration's device rates: plan_costs' counts of this
    # step over its measured seconds.
    cost = step.runner.plan_costs(step.get_state().params, batch)
    step_s = FLAGSHIP_ACCUM * FLAGSHIP_ROWS / result["value"]
    log(f"flagship: calibration: plan_costs flops {cost['flops']:.6e}, bytes "
        f"{cost['bytes_accessed']:.6e}, launches {cost['launches']} a step; step "
        f"{step_s:.6f} s: flops_per_s {cost['flops'] / step_s:.4e}, bytes_per_s "
        f"{cost['bytes_accessed'] / step_s:.4e}; card {card_line()}")
    return launches


def train_path(kernels, dev):
    """Phase 10: train() with checkpoints, resume and the prefetching feed."""
    import tempfile

    from autodist_tpu_torch import AllReduce, AutoDist
    from autodist_tpu_torch.checkpoint.saver import Saver
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.training import train

    cfg = tlm.TransformerLMConfig(vocab_size=V, d_model=D, n_heads=8, n_layers=6,
                                  d_ff=2048, max_len=512, fused_head=True,
                                  tied_output=False, dtype=torch.bfloat16)
    model, params = tlm.init_params(cfg, seed=0, device=dev)
    micro, accum = 32, 2

    def batches(i):
        return tlm.synthetic_batch(cfg, micro * accum, 256, seed=1000 + i)

    def runner():
        ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                      strategy_builder=AllReduce(), device=dev)
        r = ad.create_distributed_session(tlm.make_loss_fn(model), params,
                                          lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
                                          accumulation_steps=accum)
        r.losses, run = [], r.run

        def recorded(state, batch):
            state, loss = run(state, batch)
            r.losses.append(loss)
            return state, loss

        r.run = recorded
        return r

    def state_tensors(state):
        out = {f"param {k}": v.detach() for k, v in state.params.items()}
        for k, p in state.params.items():
            for field, value in state.optimizer.state[p].items():
                out[f"{field} {k}"] = value
        return out

    def same(a, b):
        return a.keys() == b.keys() and all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)

    with tempfile.TemporaryDirectory() as tmp:
        for k in kernels:
            k.launches = 0
        straight = runner()
        t0 = time.perf_counter()
        want = train(straight, params, batches, steps=4, checkpoint_dir=f"{tmp}/a",
                     log_every=1, prefetch_depth=2)
        straight_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        first, second, sync = runner(), runner(), runner()
        saved = train(first, params, batches, steps=2, checkpoint_dir=f"{tmp}/b",
                      prefetch_depth=2)
        latest = Saver.latest_checkpoint(f"{tmp}/b", name="model")
        restored = Saver().restore(latest, runner=runner())
        restored_same = restored.step == saved.step == 2 and same(state_tensors(restored),
                                                                 state_tensors(saved))
        got = train(second, params, batches, steps=4, checkpoint_dir=f"{tmp}/b",
                    prefetch_depth=2)
        train(sync, params, batches, steps=4, prefetch_depth=0)
        files = sorted(os.listdir(f"{tmp}/b"))
    losses = [float(x) for x in straight.losses]
    resumed = [float(x) for x in first.losses + second.losses]
    synced = [float(x) for x in sync.losses]
    params_same = same({k: v.detach() for k, v in want.params.items()},
                       {k: v.detach() for k, v in got.params.items()})
    log(f"train: 4 straight steps (prefetch_depth=2) in {straight_s:.2f} s, losses {losses}; "
        f"2 + resume + 2 {resumed}; synchronous feed {synced}; checkpoint files {files}; "
        f"launches {launches}")
    log(f"train: restored state equals the saved one bit for bit: {restored_same}; "
        f"resumed losses and final params bit-identical: {losses == resumed and params_same}; "
        f"prefetch feed equals the synchronous feed: {losses == synced}")
    if not (restored_same and losses == resumed and params_same and losses == synced
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError("train(): the resumed run or the prefetching feed disagrees")
    return launches


def strategies_path(kernels, dev):
    """Phase 11: the flagship under every synchronous lowering on one card."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import strategy as st
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.parallel.plan import SYNC_ALLREDUCE, SYNC_PS

    micro, accum, seq = 32, 2, 256
    cfg = tlm.TransformerLMConfig(vocab_size=V, d_model=D, n_heads=8, n_layers=6,
                                  d_ff=2048, max_len=512, fused_head=True,
                                  tied_output=False, dtype=torch.bfloat16)
    model, params = tlm.init_params(cfg, seed=0, device=dev)
    batches = [tlm.synthetic_batch(cfg, micro * accum, seq, seed=2000 + i)
               for i in range(STRATEGY_STEPS)]
    one_card = {"nodes": [{"address": "localhost", "gpus": [0]}]}
    total = collections.Counter()
    ref_losses = ref_params = None
    failures = []
    for label, builder, options, session, codec in STRATEGY_LOWERINGS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ad = AutoDist(resource_info=one_card, device=dev,
                      strategy_builder=getattr(st, builder)(**options) if builder else None)
        # The walk marks pos_embed sparse at bf16 (the table is cast before
        # its gather), as the JAX package's strategy matrix does.
        step = ad.function(tlm.make_loss_fn(model), params,
                           lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
                           example_batch=batches[0], accumulation_steps=accum, **session)
        plans = step.runner.plan.params
        routes = {n: plans[n].sync for n in ("embed/embedding", "pos_embed")}
        sparse = sorted(n for n, p in plans.items() if p.sparse)
        if sparse != ["pos_embed"]:
            failures.append(f"{label}: sparse parameters {sparse}, not ['pos_embed']")
        if builder == "Parallax" and routes != {"embed/embedding": SYNC_ALLREDUCE,
                                                "pos_embed": SYNC_PS}:
            failures.append(f"{label}: routes {routes}: pos_embed must go to PS and "
                            f"embed/embedding to the all-reduce")
        placed = [step.runner.shard_batch(b) for b in batches]
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        losses = [float(step(placed[0]))]
        residual = None
        if codec == "error":
            residual = max(float(e["error"].abs().max())
                           for e in step.get_state().ef_state.values())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            losses += [float(step(batch)) for batch in placed[1:]]
            end.record()
            end.synchronize()
        timed = len(placed) - 1
        busy_ms = busy_us(device_kernels(prof)) / 1e3 / timed
        event_ms = start.elapsed_time(end) / timed
        launches = {k.__name__: k.launches for k in kernels}
        total.update(launches)
        state = step.get_state()
        final = {k: v.detach().cpu() for k, v in step.runner.logical_params(state).items()}
        if ref_params is None:
            ref_losses, ref_params = losses, final
        dist = max(float((final[k].float() - ref_params[k].float()).abs().max())
                   for k in final)
        per_step = {name: launches[name] / STRATEGY_STEPS
                    for name in ("xent_fwd", "xent_dh", "xent_dwdb")}
        log(f"strategies: {label}: mesh {dict(step.runner.plan.mesh_axes)}, sparse "
            f"{sparse}, routes {routes}, lowering "
            f"{'explicit' if step.runner._grad_fn.explicit else 'implicit'}; losses {losses}; "
            f"device busy {busy_ms:.3f} ms/step, {event_ms:.3f} event-timed (steps 2-3); "
            f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; "
            f"fused-head launches per step {per_step}; final params' max distance from "
            f"the reference {dist:.3e}"
            + (f"; largest residual after step 1 {residual:.3e}" if codec == "error" else ""))
        if not all(math.isfinite(x) for x in losses) or min(per_step.values()) <= 0:
            failures.append(f"{label}: non-finite losses or no fused-head launch")
        elif codec is None and not (losses == ref_losses and dist == 0.0):
            failures.append(f"{label}: differs from the reference ({losses} vs {ref_losses}, "
                            f"params {dist:.3e})")
        elif codec is not None and not (
                all(abs(a - b) <= 1e-2 * abs(b) for a, b in zip(losses, ref_losses))
                and dist > 0 and (codec != "error" or (residual or 0.0) > 0)):
            failures.append(f"{label}: the codec did not run as it should (losses {losses}, "
                            f"params {dist:.3e}, residual {residual})")
        del step, state, final, placed
    del ref_params
    gc.collect()
    torch.cuda.empty_cache()
    factor = torch.randn(V, 2, device=dev)
    torch.linalg.qr(factor)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.linalg.qr(factor)
    host_us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    log(f"strategies: torch.linalg.qr of a [{V}, 2] f32 factor: {host_us:.1f} us a call on "
        f"the host's clock (enqueue only, unless it synchronizes), "
        f"{1e3 * time_ms(lambda: torch.linalg.qr(factor), reps):.1f} us a call on the "
        f"card's (events)")
    if failures:
        raise AssertionError("strategies: " + "; ".join(failures))
    return dict(total)


def ulysses_path(kernels, dev):
    """Phase 12a: Ulysses training through the sequence-parallel session on
    one card."""
    from autodist_tpu_torch import AutoDist, SequenceParallel
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.parallel.sequence import (create_sequence_parallel_session,
                                                      make_sequence_parallel_loss_fn)
    from autodist_tpu_torch.runner import step_function
    from autodist_tpu_torch.utils.flops import mfu, transformer_flops_per_token

    cfg = tlm.TransformerLMConfig(vocab_size=V, d_model=D, n_heads=LC_HEADS, n_layers=6,
                                  d_ff=2048, max_len=LC_SEQ, dtype=torch.bfloat16,
                                  remat=True, attention_impl="ulysses", fused_head=True,
                                  tied_output=False)
    model, params = tlm.init_params(cfg, seed=0, device=dev)
    log(f"ulysses: {cfg}")
    small = {k: torch.as_tensor(a).to(dev)
             for k, a in tlm.synthetic_batch(cfg, 2, min(1024, LC_SEQ), seed=95).items()}
    flash_model = tlm.TransformerLM(dataclasses.replace(cfg, attention_impl="flash"))
    with torch.no_grad():
        ulysses = float(make_sequence_parallel_loss_fn(model)(params, small))
        flash = float(tlm.make_loss_fn(flash_model)(params, small))
    # A group of one calls flash directly (no exchange), so this holds the
    # model's and the session's wiring of Ulysses, not the all-to-alls.
    log(f"ulysses reference (a seq group of one: flash itself, no exchange): ulysses "
        f"loss {ulysses:.6f} vs flash loss {flash:.6f}")
    if not (math.isfinite(ulysses) and abs(ulysses - flash) <= 1e-2 * abs(flash)):
        raise AssertionError("Ulysses loss disagrees with flash attention")

    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                  strategy_builder=SequenceParallel(seq_axis_size=1), device=dev)
    runner = create_sequence_parallel_session(
        ad, model, params, lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8))
    step = step_function(runner, params)
    batch = runner.shard_batch(tlm.synthetic_batch(cfg, LC_BATCH, LC_SEQ))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = counted_steps(step, [batch] * LC_COUNTED, kernels)
    log(f"ulysses: losses {losses}; step seconds {times}")
    log(f"ulysses: kernel launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    flash_kernels = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
    if any(launches[name] == 0 for name in flash_kernels) or launches["flash_fwd_carry"]:
        raise AssertionError(f"ulysses path: launches {launches}: flash forward, dK/dV and "
                             f"dQ must launch and the carry never")
    tokens = LC_BATCH * LC_SEQ
    float(step(batch))
    t0 = time.perf_counter()
    for _ in range(LC_STEADY):
        loss = step(batch)
    float(loss)
    per_step = (time.perf_counter() - t0) / LC_STEADY
    flops = transformer_flops_per_token(D, 6, 2048, V, LC_SEQ) * tokens
    log(f"ulysses: {tokens / per_step:.1f} tokens/s over {LC_STEADY} steady steps "
        f"({tokens} tokens/step, {1e3 * per_step:.3f} ms/step), MFU "
        f"{mfu(flops / per_step):.4f} of 989 TFLOP/s (full score matrix counted); "
        f"launches a step {({n: launches[n] / LC_COUNTED for n in flash_kernels})}")
    profile_steps(step, [batch] * LC_PROFILE, label="ulysses profile")
    return launches


def _exchange(shards, split_axis: int, concat_axis: int):
    """One card's stand-in for the tiled all-to-all over ``len(shards)``
    ranks: rank j receives chunk j of every rank's ``split_axis``, and
    concatenates them along ``concat_axis`` in rank order."""
    n = len(shards)
    chunks = [x.chunk(n, dim=split_axis) for x in shards]
    return [torch.cat([chunks[r][j] for r in range(n)], dim=concat_axis).contiguous()
            for j in range(n)]


def check_ulysses_replay(fa, dev):
    """Phase 12b: Ulysses over 4 shards on one card. B = 8, L = 8,192 in 4
    sequence shards; the exchange to heads, flash forward and backward on
    each rank's 2 heads over the whole sequence, the exchange back; against
    the kernels on all 8 heads, tile by tile."""
    gen = torch.Generator().manual_seed(6)
    n, b, length = ULYSSES_SHARDS, LC_BATCH, LC_SEQ
    q, k, v, do = flash_inputs(b, length, length, gen, dev)
    seq = [x.chunk(n, dim=1) for x in (q, k, v, do)]
    qh, kh, vh, doh = (_exchange(list(x), 2, 1) for x in seq)
    outs, lses, dqs, dks, dvs = [], [], [], [], []
    for j in range(n):
        out, lse = fa.flash_fwd(qh[j], kh[j], vh[j], True)
        dd = fa.prepare_backward_q_side(out, doh[j])
        dk, dv = fa.flash_bwd_dkdv(qh[j], kh[j], vh[j], doh[j], lse, dd, True)
        dq = fa.flash_bwd_dq(qh[j], kh[j], vh[j], doh[j], lse, dd, True)
        outs.append(out)
        lses.append(lse.view(b, -1, length))
        dqs.append(dq)
        dks.append(dk)
        dvs.append(dv)
    got = {name: torch.cat(_exchange(parts, 1, 2), dim=1)
           for name, parts in (("out", outs), ("dq", dqs), ("dk", dks), ("dv", dvs))}
    lse = torch.cat(lses, dim=1).view(b * LC_HEADS, length)
    ref_out, ref_lse = fa.flash_fwd(q, k, v, True)
    ref_dd = fa.prepare_backward_q_side(ref_out, do)
    ref_dk, ref_dv = fa.flash_bwd_dkdv(q, k, v, do, ref_lse, ref_dd, True)
    ref_dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, ref_dd, True)
    torch.cuda.synchronize()
    e_lse = (lse - ref_lse).abs().max().item()
    e = {name: compare(got[name], want, 1)
         for name, want in (("out", ref_out), ("dq", ref_dq), ("dk", ref_dk), ("dv", ref_dv))}
    log(f"check ulysses replay B={b} L={length} in {n} shards (heads {LC_HEADS // n} a "
        f"rank): lse {e_lse:.3g}; " + "; ".join(f"{m} {describe(c)}" for m, c in e.items()))
    if not (math.isfinite(e_lse) and e_lse <= FLASH_LSE_ATOL
            and all(c[2] <= TILE_RTOL for c in e.values())):
        raise AssertionError("the Ulysses replay disagrees with flash on all heads")
    return {"flash_fwd": max(e_lse, e["out"][0]), "flash_bwd_dkdv": max(e["dk"][0], e["dv"][0]),
            "flash_bwd_dq": e["dq"][0]}


def data_plane_path():
    """Phase 13: the native loader against the numpy path."""
    import numpy as np

    from autodist_tpu_torch.data.loader import DataLoader

    rng = np.random.RandomState(0)
    arrays = {"images": rng.randint(0, 256, (1000, 32, 32, 3)).astype(np.uint8),
              "labels": np.arange(1000, dtype=np.int32)}
    native = DataLoader(arrays, batch_size=100, shuffle=False, native=True)
    plain = DataLoader(arrays, batch_size=100, shuffle=False, native=False)
    same = all(all(np.array_equal(a[key], b[key]) for key in arrays)
               for a, b in ((native.next(), plain.next()) for _ in range(15)))
    shuffled = DataLoader(arrays, batch_size=100, shuffle=True, seed=3)
    epoch = np.sort(np.concatenate([shuffled.next()["labels"] for _ in range(10)]))
    once = np.array_equal(epoch, arrays["labels"])
    is_native = native.is_native and shuffled.is_native
    log(f"data plane: native {is_native}; native batches equal the numpy path's "
        f"unshuffled: {same}; a shuffled epoch serves each row once: {once}")
    for loader in (native, plain, shuffled):
        loader.close()
    if not (is_native and same and once):
        raise AssertionError("data plane: the native loader is missing or disagrees")


def image_path(kernels, dev):
    """Phase 14: the image-classification family on the card."""
    import tempfile

    import numpy as np

    from autodist_tpu_torch.data import imagenet
    from autodist_tpu_torch.data.loader import save_shards
    from autodist_tpu_torch.examples import image_classifier
    from autodist_tpu_torch.examples.benchmark import imagenet as bench
    from autodist_tpu_torch.models import resnet

    for k in kernels:
        k.launches = 0
    losses = image_classifier.main(device=dev)
    log(f"images: image_classifier losses by epoch {losses}")

    cfg = resnet.ResNet50Config()
    model, params = resnet.init_params(cfg, seed=0, device=dev)
    f32 = resnet.ResNet(dataclasses.replace(cfg, dtype=torch.float32))
    small = {k: torch.as_tensor(a).to(dev) for k, a in resnet.synthetic_batch(cfg, 4).items()}
    with torch.no_grad():
        low = float(resnet.make_loss_fn(model)(params, small))
        full = float(resnet.make_loss_fn(f32)(params, small))
    log(f"images: ResNet-50 bf16 loss {low:.6f} vs f32 loss {full:.6f}")
    if not (math.isfinite(low) and abs(low - full) <= 1e-2 * abs(full)):
        raise AssertionError("ResNet-50's bf16 loss disagrees with its f32 loss")
    del model, params, f32
    torch.cuda.empty_cache()

    def run(argv, label, pool=False):
        args = bench.parse_args(argv + ["--device", str(dev), "--log_every", "1000"])
        b = bench.build(args)
        try:
            t0 = time.perf_counter()
            result = bench.train(b)
            log(f"images: {label}: {result} ({time.perf_counter() - t0:.1f} s); card "
                f"{card_line()}")
            profile_steps(b.step, [b.next_batch() for _ in range(2)],
                          label=f"images profile {label}")
            if pool:
                profile_pool(b, label=f"images host split {label}")
        finally:
            b.close()
        del b
        torch.cuda.empty_cache()
        if not math.isfinite(result["final_loss"]):
            raise AssertionError(f"images: {label}: non-finite loss")
        return result

    results = {}
    for strategy, per_card, steps in IMAGE_RUNS:
        results[(strategy, per_card)] = run(
            ["--strategy", strategy, "--batch_size", str(per_card), "--steps", str(steps)],
            f"resnet50 {strategy} {per_card}/card")
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.RandomState(1)
        side = IMAGE_RECORD_SIZE
        save_shards({"images": rng.randint(0, 256, (IMAGE_RECORDS, side, side, 3),
                                           dtype=np.uint8),
                     "labels": rng.randint(0, 1000, IMAGE_RECORDS).astype(np.int32)},
                    tmp, rows_per_shard=128)
        with open(os.path.join(tmp, imagenet.META_NAME), "w") as f:
            json.dump({"record_size": side, "rows": IMAGE_RECORDS,
                       "classes": [f"c{i}" for i in range(1000)]}, f)
        strategy, per_card, steps = IMAGE_CACHE_RUN
        run(["--strategy", strategy, "--batch_size", str(per_card), "--steps", str(steps),
             "--data_dir", tmp, "--input_mode", "cache", "--pool_rows",
             str(IMAGE_RECORDS // 2)], f"resnet50 record pool {strategy} {per_card}/card",
            pool=True)
    for name in ("vgg16", "densenet121", "inceptionv3"):
        run(["--model", name, "--batch_size", "8", "--steps", "3"], f"{name} 8/card")
    return {k.__name__: k.launches for k in kernels}, results


def write_corpus(path: str, seed: int = 5) -> None:
    """A text corpus of TEXT_LINES lines of 25 words drawn (Zipf) from a
    word list of TEXT_WORDS words."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ids = (rng.zipf(1.2, size=(TEXT_LINES, 25)) - 1) % TEXT_WORDS
    with open(path, "w") as f:
        f.write("\n".join(" ".join(f"word{i}" for i in row) for row in ids) + "\n")


def write_ratings(path: str, seed: int = 6) -> None:
    """A MovieLens-format CSV: RATING_USERS users, each rating 20 to 40
    distinct items of RATING_ITEMS, timestamps out of order."""
    import numpy as np

    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        f.write("user_id,item_id,rating,timestamp\n")
        for u in range(RATING_USERS):
            n = rng.randint(20, 41)
            items = rng.choice(RATING_ITEMS, n, replace=False)
            for t, i in zip(rng.permutation(n), items):
                f.write(f"{u + 1},{i + 1},{rng.randint(1, 6)},{978300000 + 60 * t}\n")


def text_path(kernels, dev, resnet_rate: float):
    """Phase 15: the text family and the rest of the benchmark suite."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from autodist_tpu_torch.checkpoint.saver import Saver
    from autodist_tpu_torch.examples.benchmark import bert as bert_bench
    from autodist_tpu_torch.examples.benchmark import disk_input
    from autodist_tpu_torch.examples.benchmark import ncf as ncf_bench
    from autodist_tpu_torch.examples.benchmark import raw_torch_baseline, run_all
    from autodist_tpu_torch.models import bert, ncf
    from autodist_tpu_torch.parallel.plan import SYNC_PS

    for k in kernels:
        k.launches = 0
    cfg = bert.BertConfig(max_len=128)
    model, params = bert.init_params(cfg, seed=0, device=dev)
    f32 = bert.Bert(dataclasses.replace(cfg, dtype=torch.float32))
    small = {k: torch.as_tensor(a).to(dev)
             for k, a in bert.synthetic_batch(cfg, 4, 128, n_predictions=20).items()}
    with torch.no_grad():
        low = float(bert.make_mlm_loss_fn(model)(params, small))
        full = float(bert.make_mlm_loss_fn(f32)(params, small))
    log(f"text: bert-base bf16 loss {low:.6f} vs f32 loss {full:.6f}; card {card_line()}")
    if not (math.isfinite(low) and abs(low - full) <= 1e-2 * abs(full)):
        raise AssertionError("bert-base's bf16 loss disagrees with its f32 loss")
    del model, params, f32, small
    torch.cuda.empty_cache()

    def run(module, argv, label, after=None):
        args = module.parse_args(argv + ["--device", str(dev), "--log_every", "1000"])
        b = module.build(args)
        try:
            t0 = time.perf_counter()
            result = module.train(b)
            log(f"text: {label}: {result} ({time.perf_counter() - t0:.1f} s); card "
                f"{card_line()}")
            profile_steps(b.step, [b.next_batch() for _ in range(2)],
                          label=f"text profile {label}")
            if after is not None:
                after(b)
        finally:
            b.close()
        del b
        torch.cuda.empty_cache()
        if not math.isfinite(result["final_loss"]):
            raise AssertionError(f"text: {label}: non-finite loss")
        return result

    for size, batch, accum, steps in BERT_RUNS:
        run(bert_bench, ["--size", size, "--batch_size", str(batch), "--accum", str(accum),
                         "--steps", str(steps)], f"bert-{size} {batch}/card accum {accum}")

    with tempfile.TemporaryDirectory() as tmp:
        corpus, data = os.path.join(tmp, "corpus.txt"), os.path.join(tmp, "mlm")
        write_corpus(corpus)
        bert_bench.main(["--tokenize_corpus", corpus, "--data_dir", data, "--seq_len", "128"])
        saved = []
        disk = ["--data_dir", data, "--batch_size", str(BERT_DISK_BATCH)]
        run(bert_bench, disk + ["--steps", str(BERT_DISK_STEPS)],
            f"bert-base from --data_dir, {BERT_DISK_BATCH}/card",
            after=lambda b: saved.append(Saver().save(b.step.get_state(),
                                                      os.path.join(tmp, "ckpt", "bert"))))
        acc = bert_bench.main(disk + ["--eval", "--restore", saved[0], "--device", str(dev)])
        log(f"text: bert-base --eval --restore {os.path.basename(saved[0])}: "
            f"masked_lm_accuracy {acc:.4f}; card {card_line()}")

    def tables_to_ps(b):
        plans = b.step.runner.plan.params
        tables = sorted(n for n in plans if n.endswith("_embed/embedding"))
        routes = {n: plans[n].sync for n in plans}
        log(f"text: ncf Parallax routes {routes}")
        if len(tables) != 4 or any(routes[n] != SYNC_PS for n in tables) or \
                any(routes[n] == SYNC_PS for n in plans if n not in tables):
            raise AssertionError(f"ncf: Parallax must send exactly the four tables to PS: "
                                 f"{routes}")

    run(ncf_bench, ["--steps", str(NCF_STEPS)], "ncf Parallax 65,536/card",
        after=tables_to_ps)
    # Parallax against AllReduce(): three steps of the real config from one
    # seed on the same batches; on one card they must agree bit for bit.
    host = [ncf.synthetic_batch(ncf.NeuMFConfig(), ncf_bench.DEFAULT_BATCH, seed=100 + i)
            for i in range(3)]
    finals = {}
    for strategy in ("Parallax", "AllReduce"):
        b = ncf_bench.build(ncf_bench.parse_args(["--device", str(dev), "--strategy",
                                                  strategy]))
        losses = [float(b.step(batch)) for batch in host]
        finals[strategy] = (losses, {k: v.detach().cpu() for k, v in
                                     b.step.runner.logical_params(b.step.get_state()).items()})
        b.close()
        del b
    (pl, pp), (al, ap) = finals["Parallax"], finals["AllReduce"]
    dist = max(float((pp[k] - ap[k]).abs().max()) for k in pp)
    log(f"text: ncf 3 steps, Parallax losses {pl} vs AllReduce {al}; final params' max "
        f"distance {dist:.3e}; card {card_line()}")
    if pl != al or dist != 0.0:
        raise AssertionError("ncf: Parallax and AllReduce() differ on one card")
    del finals, pp, ap
    with tempfile.TemporaryDirectory() as tmp:
        ratings = os.path.join(tmp, "ratings.csv")
        write_ratings(ratings)
        result = ncf_bench.main(["--ratings", ratings, "--steps", str(NCF_RATING_STEPS),
                                 "--device", str(dev)])
        log(f"text: ncf on MovieLens-format ratings ({RATING_USERS} users): {result}; card "
            f"{card_line()}")
        if not (math.isfinite(result["final_loss"]) and 0 <= result["ndcg"] <= result["hr"]):
            raise AssertionError("ncf: the ratings run's loss or metrics are wrong")
    torch.cuda.empty_cache()

    before = {k.__name__: k.launches for k in kernels}
    if any(before.values()):
        raise AssertionError(f"text: BERT and NCF launched the port's kernels: {before}")
    line = disk_input.main(["--device", str(dev), "--rows", str(DISK_ROWS), "--steps",
                            str(DISK_STEPS)])
    launches = {k.__name__: k.launches for k in kernels}
    per_step = {n: launches[n] / (2 * (disk_input.WARMUP_STEPS + DISK_STEPS))
                for n in ("xent_fwd", "xent_dh", "xent_dwdb")}
    log(f"text: disk_input {line}; launches {launches}, fused-head launches per step "
        f"{per_step}; card {card_line()}")
    if not line["native_loader"] or min(per_step.values()) < 1:
        raise AssertionError("disk_input: the native loader or a fused-head kernel did not run")
    torch.cuda.empty_cache()

    raw = raw_torch_baseline.main(["--device", str(dev), "--model", "resnet50",
                                   "--batch_size", "128", "--steps", str(RAW_STEPS)])
    log(f"text: raw_torch_baseline resnet50 128: {raw['images_per_sec']:.1f} images/s, mfu "
        f"{raw['mfu']}, against the ImageNet benchmark's AllReduce 128/card "
        f"{resnet_rate:.1f} in this run ({raw['images_per_sec'] / resnet_rate:.3f}x); card "
        f"{card_line()}")
    if not math.isfinite(raw["final_loss"]):
        raise AssertionError("raw_torch_baseline: non-finite loss")
    torch.cuda.empty_cache()

    listing = io.StringIO()
    with contextlib.redirect_stdout(listing):
        run_all.main(["--list"])
    log("text: run_all --list: " + "; ".join(listing.getvalue().splitlines()))
    t0 = time.perf_counter()
    rows = run_all.main(["--only", "ncf", "--steps", "5"])
    log(f"text: run_all --only ncf --steps 5: {rows} ({time.perf_counter() - t0:.1f} s); "
        f"card {card_line()}")
    if not rows or rows[0]["rate"] is None:
        raise AssertionError(f"run_all: the ncf row did not parse: {rows}")
    return launches



def rel_err(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in f32."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def moe_pipe_path(kernels, dev):
    """Phase 17: the MoE LM under ExpertParallel at the sweep's shape, the
    expert axis and the pipeline schedules replayed on one card."""
    import numpy as np

    from autodist_tpu_torch.examples import moe_lm
    from autodist_tpu_torch.examples.benchmark import run_all
    from autodist_tpu_torch.models import moe, pipeline_lm as plm
    from autodist_tpu_torch.parallel.mesh import replay_mesh
    from autodist_tpu_torch.utils.flops import mfu, transformer_flops_per_token

    t_phase = time.perf_counter()
    # --- the sweep's moe row in this process: launches a step, memory, a trace.
    args = moe_lm.parse_args(["--device", str(dev)] + MOE_SWEEP_ARGS)
    cfg, step, batch = moe_lm.build(args)
    float(step(batch))                       # the first step: the lazy state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = counted_steps(step, [batch] * MOE_COUNTED, kernels)
    per_step = {k: v / MOE_COUNTED for k, v in launches.items()}
    tokens = args.batch_size * args.seq_len
    flops = transformer_flops_per_token(cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab_size,
                                        args.seq_len) * tokens
    sec = min(times)
    log(f"moe: {args.batch_size} x {args.seq_len} ({args.accum} micro-batches), d{cfg.d_model} "
        f"x {cfg.n_layers}, {cfg.n_experts} experts, vocab {cfg.vocab_size}: losses {losses}; "
        f"step seconds {times}; {tokens / sec:.1f} tokens/s at the fastest step, MFU "
        f"{mfu(flops / sec):.4f} of 989 TFLOP/s (one active expert a token); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; launches a step "
        f"{per_step}; card {card_line()}")
    want = {"xent_fwd": args.accum, "xent_dh": args.accum, "xent_dwdb": args.accum,
            "xent_pack_w": 2 * args.accum}
    wrong = {k: (per_step[k], n) for k, n in want.items() if per_step[k] != n}
    if wrong:
        raise AssertionError(f"moe: fused-head launches a step (got, want) {wrong}")
    profile_steps(step, [batch] * 2, label="moe profile")
    del step, batch
    free_card()

    # --- the row as the sweep runs it, in its own process.
    t0 = time.perf_counter()
    rows = run_all.main(["--only", "moe", "--steps", str(MOE_SWEEP_STEPS)])
    log(f"moe: run_all --only moe --steps {MOE_SWEEP_STEPS}: {rows} "
        f"({time.perf_counter() - t0:.1f} s); card {card_line()}")
    if not rows or rows[0]["rate"] is None:
        raise AssertionError(f"run_all: the moe row did not parse: {rows}")

    # --- the expert axis replayed: 4 shards of 2 experts, partial FFNs summed.
    gen = torch.Generator(device=dev).manual_seed(17)
    b, s, m, f, e = args.batch_size // args.accum, args.seq_len, cfg.d_model, cfg.d_ff, \
        cfg.n_experts
    h = torch.randn(b, s, m, device=dev, generator=gen).to(torch.bfloat16).requires_grad_()
    router = torch.randn(m, e, device=dev, generator=gen) * m ** -0.5
    w_in = (torch.randn(e, m, f, device=dev, generator=gen) * (e * m) ** -0.5).requires_grad_()
    w_out = (torch.randn(e, f, m, device=dev, generator=gen) * (e * f) ** -0.5).requires_grad_()
    capacity = int(np.ceil(s * cfg.capacity_factor / e))
    dispatch, combine, _ = moe.switch_route(h.float() @ router, capacity)
    dispatch = dispatch.to(torch.bfloat16)
    combine = combine.to(torch.bfloat16).detach().requires_grad_()
    g_y = torch.randn(b, s, m, device=dev, generator=gen).to(torch.bfloat16)
    inputs = (h, combine, w_in, w_out)

    def run(shards):
        per = e // shards
        y = sum(moe.expert_ffn(h, dispatch[:, :, i * per:(i + 1) * per],
                               combine[:, :, i * per:(i + 1) * per], w_in[i * per:(i + 1) * per],
                               w_out[i * per:(i + 1) * per], torch.bfloat16)
                for i in range(shards))
        return y, torch.autograd.grad(y, inputs, g_y)

    whole_y, whole_g = run(1)
    shard_y, shard_g = run(EXPERT_SHARDS)
    errs = {"y": rel_err(shard_y, whole_y)}
    errs.update({name: rel_err(a, b_) for name, a, b_ in
                 zip(("dh", "dcombine", "dw_in", "dw_out"), shard_g, whole_g)})
    log(f"moe: expert axis replayed, {EXPERT_SHARDS} shards of {e // EXPERT_SHARDS} experts at "
        f"{b} x {s} (capacity {capacity}): ||shards - whole|| / ||whole|| {errs}")
    bad = {k: v for k, v in errs.items() if not v <= PIPE_RTOL}
    if bad:
        raise AssertionError(f"moe: the expert shards disagree with the whole FFN: {bad}")
    del h, w_in, w_out, dispatch, combine, whole_g, shard_g, inputs
    free_card()

    # --- the pipeline schedules replayed: S virtual stages on one card.
    pcfg = plm.PipelineLMConfig(**PIPE_SHAPE, dtype=torch.bfloat16)
    model, params = plm.init_params(pcfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(a).to(dev) for k, a in
             plm.synthetic_batch(pcfg, PIPE_BATCH, PIPE_SEQ).items()}
    tokens = batch["tokens"].long()

    def sequential(p):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        logits = plm.sequential_apply(plm.PipelineLM(pcfg), leaves, tokens[:, :-1])
        loss = plm._nll(logits, tokens[:, 1:]).mean()
        return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    def gpipe(p):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss = plm.make_loss_fn(model)(leaves, batch)
        return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    icfg = dataclasses.replace(pcfg, n_chunks=2)
    stored = dict(params, **{plm.BLOCKS + k: v for k, v in plm.blocks_from_execution_order(
        icfg, plm._blocks(params)).items()})
    want_loss, want = sequential(params)
    want_stored = dict(want, **{plm.BLOCKS + k: v for k, v in plm.blocks_from_execution_order(
        icfg, plm._blocks(want)).items()})
    schedules = {"gpipe": (gpipe, params, want),
                 "1f1b": (plm.make_onef_oneb_value_and_grad(model), params, want),
                 "interleaved": (plm.make_onef_oneb_value_and_grad(plm.PipelineLM(icfg)),
                                 stored, want_stored)}
    with replay_mesh({"pipe": pcfg.n_stages}):
        for name, (fn, p, ref) in schedules.items():
            args_ = (p,) if name == "gpipe" else (p, batch)
            fn(*args_)                                  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = fn(*args_)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            errs = {k: rel_err(grads[k], ref[k]) for k in ref}
            loss_err = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
            worst = max(errs, key=errs.get)
            log(f"pipeline {name}: S={pcfg.n_stages} x v={2 if name == 'interleaved' else 1}, "
                f"{PIPE_BATCH} x {PIPE_SEQ} in {pcfg.num_microbatches} micro-batches, d"
                f"{pcfg.d_model} x {pcfg.n_layers}: loss {float(loss):.6f} vs sequential "
                f"{float(want_loss):.6f}; worst leaf {worst} {errs[worst]:.2e}; "
                f"{ms:.3f} ms a step (replayed on one card)")
            if not (loss_err <= PIPE_RTOL and errs[worst] <= PIPE_RTOL):
                raise AssertionError(f"pipeline {name} disagrees with sequential_apply: loss "
                                     f"{loss_err:.2e}, {worst} {errs[worst]:.2e}")
    del model, params, stored, want, want_stored, schedules
    free_card()
    log(f"moe_pipe: phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return launches


def free_card():
    """Drop what the last run left on the card before the next one is built."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# Phase 16's launches, banked each time its counts are set to 0.
UNROLL_LAUNCHES = collections.Counter()


def bank(kernels):
    """Add the kernels' counts to phase 16's tally and set them to 0."""
    for k in kernels:
        UNROLL_LAUNCHES[k.__name__] += k.launches
        k.launches = 0


def same_params(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def host_params(runner, state):
    return {k: v.detach().cpu() for k, v in runner.logical_params(state).items()}


def fused_against_steps(build, batches, kernels, label, reference=None):
    """``run_many`` against ``run()`` on one runner's path: a fresh session
    runs every batch through ``run()`` (unless ``reference``, such a run's
    ``(losses, host params)``, is given); another runs the first two through
    ``run()`` (the card's warm-up), then the rest as blocks of 2 through
    ``run_many`` (the first block captured, then replayed), the launch
    counts set to 0 just before each block and read just after. Returns
    ``(bit-identical, launches of one run() step, launches of one replay,
    the reference)``; raises what ``run_many`` raised."""
    if reference is None:
        step = build()
        runner, state = step.runner, step.get_state()
        reference = ([float(runner.run(state, b)[1]) for b in batches],
                     host_params(runner, state))
        del step, runner, state
        free_card()
    want, want_params = reference
    step = build()
    runner, state = step.runner, step.get_state()
    got = [float(runner.run(state, batches[0])[1])]
    bank(kernels)
    got.append(float(runner.run(state, batches[1])[1]))
    per_step = {k.__name__: k.launches for k in kernels}
    per_replay = {}
    for i in range(2, len(batches), 2):
        bank(kernels)
        _, losses = runner.run_many(state, batches[i:i + 2])
        got += [float(x) for x in losses]
        per_replay = {k.__name__: k.launches for k in kernels}
    same = got == want and same_params(host_params(runner, state), want_params)
    log(f"unroll: {label}: run_many(2) {'equals' if same else 'DIFFERS FROM'} run() bit for "
        f"bit; losses {got} vs {want}; launches of one run() step {per_step}, of one replay "
        f"{per_replay}")
    del step, runner, state
    free_card()
    return same, per_step, per_replay, reference


def unroll_rate(runner, state, block, steps: int, kernels):
    """Blocks of ``block`` through ``run_many`` after one captured block:
    ``(steps/s, launches per step)`` over ``steps`` steps, the counts set to
    0 just before and read just after."""
    _, losses = runner.run_many(state, block)
    float(losses[-1])
    n = max(1, steps // block.length)
    bank(kernels)
    t0 = time.perf_counter()
    for _ in range(n):
        _, losses = runner.run_many(state, block)
    float(losses[-1])                         # the fence: the last block's loss
    dt = time.perf_counter() - t0
    done = n * block.length
    return done / dt, {k.__name__: k.launches / done for k in kernels}


def idle_share(fn, calls: int, steps_per_call: int, label: str):
    """A profiler window over ``calls`` calls of ``fn`` (each ``steps_per_call``
    steps): the device's busy ms a step and its idle share of the wall time
    (the card's activity only, as in :func:`profile_steps`)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn()
        float(out.reshape(-1)[-1])
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    steps = calls * steps_per_call
    if not kernels:
        log(f"{label}: the profiler recorded no device time; idle share not measured")
        return None
    busy = busy_us(kernels) / 1e6
    share = 1 - busy / wall
    log(f"{label}: {steps} steps, {1e3 * wall / steps:.3f} ms/step wall with the profiler "
        f"on, device busy {1e3 * busy / steps:.3f} ms/step, idle share {share:.3f}, "
        f"{len(kernels) / steps:.1f} kernels/step")
    return share


def unroll_path(kernels, dev):
    """Phase 16: run_many (CUDA graphs of K steps) and the strategy search."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import strategy as st
    from autodist_tpu_torch.examples import flagship_lm
    from autodist_tpu_torch.examples import long_context_lm as lc
    from autodist_tpu_torch.examples.benchmark import ncf as ncf_bench
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.runner import step_function

    for k in kernels:
        k.launches = 0
    UNROLL_LAUNCHES.clear()
    failures = []

    t_part = time.perf_counter()
    # The flagship at its real shape, accumulation off (bench.py's sweep).
    args = flagship_lm.parse_args(["--device", str(dev), "--accum", "1"])
    cfg = flagship_lm.model_config(args)
    tokens = args.micro_batch * args.seq_len
    batches = [tlm.synthetic_batch(cfg, args.micro_batch, args.seq_len, seed=3000 + i)
               for i in range(6)]
    same, per_step, per_replay, _ = fused_against_steps(
        lambda: flagship_lm.build(args)[1], batches, kernels, "flagship 384 x 256")
    if not same or any(per_replay[n] != 2 * per_step[n] for n in per_step):
        failures.append("flagship: run_many(2) is not two run() steps")
    rates = {}
    free_card()
    _, step, batch = flagship_lm.build(args)
    runner, state = step.runner, step.get_state()
    float(runner.run(state, batch)[1])
    for factor in FLAGSHIP_UNROLLS:
        torch.cuda.reset_peak_memory_stats()
        if factor == 0:     # run() itself, the per-step baseline
            bank(kernels)
            t0 = time.perf_counter()
            for _ in range(FLAGSHIP_UNROLL_STEPS):
                loss = runner.run(state, batch)[1]
            float(loss)
            rate = FLAGSHIP_UNROLL_STEPS / (time.perf_counter() - t0)
            launches = {k.__name__: k.launches / FLAGSHIP_UNROLL_STEPS for k in kernels}
        else:
            rate, launches = unroll_rate(runner, state, runner.shard_block([batch] * factor),
                                         FLAGSHIP_UNROLL_STEPS, kernels)
        label = "run()" if factor == 0 else f"K={factor}"
        rates[label] = (rate, launches)
        log(f"unroll: flagship {label}: {rate * tokens:.1f} tokens/s ({rate:.4f} steps/s), "
            f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, launches per "
            f"step {launches}; card {card_line()}")
    del step, runner, state, batch
    fused_head = ("xent_fwd", "xent_dh", "xent_dwdb", "xent_pack_w")
    if any(rates["K=4"][1][n] != rates["K=1"][1][n] or rates["K=1"][1][n] <= 0
           for n in fused_head):
        failures.append(f"flagship: fused-head launches per step at K=4 "
                        f"{rates['K=4'][1]} are not K=1's {rates['K=1'][1]}")

    log(f"unroll: the flagship in {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    # Long context (phase 6's model, flash, every block rematerialized): each
    # session a fresh state from phase 6's first weights on phase 6's runner.
    free_card()
    lc_args = lc.parse_args(["--seq_len", str(LC_SEQ), "--batch_size", str(LC_BATCH),
                             "--device", str(dev)])
    lc_cfg = lc.model_config(lc_args)
    lc_batches = [tlm.synthetic_batch(lc_cfg, LC_BATCH, LC_SEQ, seed=4000 + i)
                  for i in range(4)]
    lc_runner, lc_params = lc_session(dev)
    same, per_step, per_replay, _ = fused_against_steps(
        lambda: step_function(lc_runner, lc_params), lc_batches, kernels,
        "long context 8 x 8,192")
    del lc_runner
    LC_SESSION.clear()
    flash = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
    if not same or any(per_step[n] <= 0 or per_replay[n] != 2 * per_step[n] for n in flash):
        failures.append("long context: run_many(2) is not two run() steps, or the flash "
                        "launches per replay are not twice a step's")

    log(f"unroll: long context in {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    # Phase 11's lowerings at phase 4's size: each captured or refused.
    one_card = {"nodes": [{"address": "localhost", "gpus": [0]}]}
    model_cfg = tlm.TransformerLMConfig(vocab_size=V, d_model=D, n_heads=8, n_layers=6,
                                        d_ff=2048, max_len=512, fused_head=True,
                                        tied_output=False, dtype=torch.bfloat16)
    model, params = tlm.init_params(model_cfg, seed=0, device=dev)
    lw_batches = [tlm.synthetic_batch(model_cfg, 64, 256, seed=5000 + i) for i in range(4)]

    def lowering(builder, options, session):
        def build():
            ad = AutoDist(resource_info=one_card, device=dev,
                          strategy_builder=getattr(st, builder)(**options) if builder
                          else None)
            return ad.function(tlm.make_loss_fn(model), params,
                               lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8),
                               example_batch=lw_batches[0], accumulation_steps=2, **session)
        return build

    captured, uncompressed = {}, None
    for label, builder, options, session, codec in STRATEGY_LOWERINGS:
        t0 = time.perf_counter()
        try:
            # On one card every uncompressed lowering is AllReduce()'s step
            # bit for bit (phase 11): its run() reference serves them all.
            same, _, _, reference = fused_against_steps(
                lowering(builder, options, session), lw_batches, kernels,
                f"lowering {label}", reference=uncompressed if codec is None else None)
            if codec is None:
                uncompressed = reference
            captured[label] = "captured" if same else "captured, DIFFERS"
            if not same:
                failures.append(f"lowering {label}: run_many differs from run()")
        except RuntimeError as e:
            captured[label] = f"raises: {e}"
            log(f"unroll: lowering {label}: run_many raises: {e}")
            free_card()
        log(f"unroll: lowering {label} in {time.perf_counter() - t0:.1f} s")
    log(f"unroll: lowerings under run_many: {captured}")
    del model, params
    free_card()

    log(f"unroll: the lowerings in {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    # NCF at 65,536: the steps/s curve and the idle share at K = 1 and 8.
    strategy = "Parallax"
    for attempt in ("Parallax", "AllReduce"):
        strategy = attempt
        b = ncf_bench.build(ncf_bench.parse_args(["--device", str(dev), "--strategy",
                                                  strategy]))
        runner, state, batch = b.step.runner, b.step.get_state(), b.next_batch()
        float(runner.run(state, batch)[1])
        try:
            curve = {}
            for factor in NCF_UNROLLS:
                curve[factor] = unroll_rate(runner, state,
                                            runner.shard_block([batch] * factor),
                                            NCF_UNROLL_STEPS, kernels)[0]
        except RuntimeError as e:
            log(f"unroll: ncf {strategy}: run_many raises ({e}); the curve runs under "
                f"AllReduce() through the benchmark's --strategy flag")
            failures.append(f"ncf {strategy} not captured")
            b.close()
            del b, runner, state, batch
            free_card()
            continue
        eager, host_s = ncf_eager(runner, state, batch)
        launches_per_step = runner.plan_costs(runner.logical_params(state), b.example)["launches"]
        log(f"unroll: ncf {strategy} 65,536: steps/s run() {eager:.2f} "
            f"({eager * ncf_bench.DEFAULT_BATCH:.1f} examples/s), by K "
            + ", ".join(f"K={f} {r:.2f} ({r * ncf_bench.DEFAULT_BATCH:.1f} examples/s)"
                        for f, r in curve.items()) + f"; card {card_line()}")
        log(f"unroll: calibration: ncf run() enqueues a step in {1e3 * host_s:.4f} ms of "
            f"host time, {launches_per_step} launches by plan_costs: "
            f"host_s_per_dispatch {host_s / launches_per_step:.4e} s a launch")
        idle_share(lambda: runner.run(state, batch)[1], NCF_PROFILE_STEPS, 1,
                   f"unroll: ncf {strategy} K=1 profile")
        block = runner.shard_block([batch] * 8)
        idle_share(lambda: runner.run_many(state, block)[1],
                   NCF_PROFILE_STEPS // 8, 8, f"unroll: ncf {strategy} K=8 profile")
        b.close()
        del b, runner, state, batch, block
        free_card()
        break
    log(f"unroll: NCF in {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    failures += search_path(dev)
    log(f"unroll: the search in {time.perf_counter() - t_part:.1f} s")
    bank(kernels)
    launches = {k.__name__: UNROLL_LAUNCHES[k.__name__] for k in kernels}
    if failures:
        raise AssertionError("unroll: " + "; ".join(failures))
    return launches


def ncf_eager(runner, state, batch):
    """NCF's ``run()``: steps/s over NCF_UNROLL_STEPS steps, and the host's
    seconds to enqueue one step (the median of short runs started on an idle
    card, before the launch queue can fill)."""
    t0 = time.perf_counter()
    for _ in range(NCF_UNROLL_STEPS):
        loss = runner.run(state, batch)[1]
    float(loss)
    rate = NCF_UNROLL_STEPS / (time.perf_counter() - t0)
    host = []
    for _ in range(9):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            loss = runner.run(state, batch)[1]
        host.append((time.perf_counter() - t0) / 2)
    float(loss)
    return rate, sorted(host)[len(host) // 2]


def search_path(dev):
    """Phase 16b: the plan search on NCF at 65,536 through
    ``AutoDist(strategy_builder="autotune")``, then ``train()``."""
    from autodist_tpu_torch import AutoDist, PSLoadBalancing, const
    from autodist_tpu_torch.examples.benchmark import ncf as ncf_bench
    from autodist_tpu_torch.models import ncf
    from autodist_tpu_torch.strategy import measure_candidate
    from autodist_tpu_torch.training import train

    failures = []
    cfg = ncf.NeuMFConfig()
    model, params = ncf.init_params(cfg, seed=0, device=dev)
    example = ncf.synthetic_batch(cfg, ncf_bench.DEFAULT_BATCH)
    loss_fn = ncf.make_loss_fn(model)
    optimizer = lambda p: torch.optim.Adam(p, lr=1e-3)  # noqa: E731
    top_k = const.env_int(const.AUTODIST_TUNE_TOPK, const.TUNE_TOPK_DEFAULT)
    ad = AutoDist(resource_info={"nodes": [{"address": "localhost", "gpus": [0]}]},
                  strategy_builder="autotune", device=dev)
    runner = ad.create_distributed_session(loss_fn, params, optimizer, example_batch=example)
    plan = runner.tuned_plan
    if plan is None:
        free_card()
        return ["autotune: the search was not applied (tuned_plan is None): it failed and "
                "the session kept the default builder"]
    log(f"search: {plan.explain()}")
    log(f"search: enumerated {plan.enumerated}, probed {plan.probed} (top_k {top_k}), "
        f"search_s {plan.search_s:.2f}, winner {plan.name} at "
        f"{plan.measured_steps_per_s:.2f} steps/s; card {card_line()}")
    if plan.probed > top_k:
        failures.append(f"autotune probed {plan.probed} > top_k {top_k}")
    benign = ("oom:", "predicted ", "beyond top-k", "skipped:")
    for c in plan.candidates:
        error = c.probe.error if c.probe is not None else c.pruned
        if error and not error.startswith(benign):
            failures.append(f"autotune candidate {c.name} failed: {error}")
        if c.probe is not None and c.probe.steps_per_sec and c.predicted:
            log(f"search: {c.name}: predicted {1e3 * c.predicted['step_s']:.4f} ms/step "
                f"({c.predicted['bound']}-bound), measured "
                f"{1e3 / c.probe.steps_per_sec:.4f} ms/step")
    default = measure_candidate(PSLoadBalancing(), loss_fn, params, optimizer, example,
                                device=dev)
    if default.steps_per_sec is None:
        failures.append(f"the default plan failed: {default.error}")
    else:
        log(f"search: tuned {plan.measured_steps_per_s:.2f} steps/s against the default "
            f"(PSLoadBalancing, per step) {default.steps_per_sec:.2f} "
            f"({plan.measured_steps_per_s / default.steps_per_sec:.3f}x)")
    blocks = []
    run_many = runner.run_many

    def counted(state, batch, fetches=None):
        blocks.append(len(batch))
        return run_many(state, batch, fetches)

    runner.run_many = counted
    state = train(runner, params, lambda i: example, steps=SEARCH_TRAIN_STEPS, log_every=0)
    log(f"search: train() ran {state.step} steps in blocks {blocks} (the plan's unroll "
        f"{plan.unroll})")
    if state.step != SEARCH_TRAIN_STEPS or (plan.unroll > 1 and max(blocks or [0])
                                            != plan.unroll) or (plan.unroll == 1 and blocks):
        failures.append(f"train() did not adopt the plan's unroll {plan.unroll}: blocks "
                        f"{blocks}")
    del runner, state, ad, model, params
    free_card()
    return failures


def async_args(dev):
    """The flagship entry point's arguments at one micro-batch a step (an
    async plan takes no accumulation)."""
    from autodist_tpu_torch.examples import flagship_lm
    return flagship_lm.parse_args(["--device", str(dev), "--accum", "1", "--micro_batch",
                                   str(ASYNC_ROWS), "--seq_len", str(ASYNC_SEQ)]
                                  + ASYNC_MODEL_ARGS)


def async_batches(step, cfg, seeds):
    from autodist_tpu_torch.models import transformer_lm as tlm
    return [step.runner.shard_batch(tlm.synthetic_batch(cfg, ASYNC_ROWS, ASYNC_SEQ, seed=s))
            for s in seeds]


def async_session(dev, builder, **session):
    from autodist_tpu_torch.examples import flagship_lm
    cfg, step, _ = flagship_lm.build(async_args(dev), builder=builder, **session)
    return cfg, step


def device_params(state):
    return {k: v.detach().clone() for k, v in state.params.items()}


def check_launches(launches, steps, label):
    want = {"xent_fwd": steps, "xent_dh": steps, "xent_dwdb": steps, "xent_pack_w": 2 * steps}
    wrong = {k: launches[k] for k, n in want.items() if launches[k] != n}
    if wrong:
        raise AssertionError(f"{label}: launches {wrong}, want {want}")


def async_ps_worker():
    """Phase 18 (e)'s worker half, in the process the Coordinator launched:
    the flagship from the two-node spec under PS(sync=False), (a)'s 3 steps
    over the transport; the per-step pull and push bytes and seconds go to
    stderr and to the report the chief reads. No result line."""
    from autodist_tpu_torch import const
    from autodist_tpu_torch.parallel import ps_transport
    from autodist_tpu_torch.strategy import PS
    dev = torch.device("cuda:0")
    cfg, step = async_session(dev, PS(sync=False), resource_info=ASYNC_TWO_NODES)
    batches = async_batches(step, cfg, range(ASYNC_STEPS))
    rows, losses = [], []
    t0 = time.perf_counter()
    for batch in batches:
        remote = step.runner._remote_worker
        sent0, recv0 = remote.wire_bytes if remote is not None else (0, 0)
        ts = time.perf_counter()
        losses.append(float(step(batch)))
        remote = step.runner._remote_worker
        sent1, recv1 = remote.wire_bytes
        rows.append({"pull_bytes": recv1 - recv0, "push_bytes": sent1 - sent0,
                     "pull_ms": 1e3 * remote.last_pull_s, "push_ms": 1e3 * remote.last_push_s,
                     "step_ms": 1e3 * (time.perf_counter() - ts)})
    wall = time.perf_counter() - t0
    report = {"losses": losses, "steps": rows, "steps_per_s": ASYNC_STEPS / wall,
              "steps_per_s_after_first": (ASYNC_STEPS - 1) / (wall - rows[0]["step_ms"] / 1e3),
              "native_bytes": list(ps_transport.native_bytes()),
              "wire_dtype": const.env_str(const.AUTODIST_WIRE_DTYPE)}
    with open(os.path.join(const.DEFAULT_WORKING_DIR, "chip_async_worker.json"), "w") as f:
        json.dump(report, f)
    print(f"async_ps worker: {report}", file=sys.stderr, flush=True)
    return 0


def async_remote(dev, wire_dtype, reference_params):
    """Phase 18 (e)'s chief half: serve the flagship to the worker process
    the Coordinator launches, step nothing, and return the worker's report
    and whether the final parameters equal ``reference_params``."""
    from autodist_tpu_torch import const
    from autodist_tpu_torch.strategy import PS
    report_path = os.path.join(const.DEFAULT_WORKING_DIR, "chip_async_worker.json")
    if os.path.exists(report_path):
        os.remove(report_path)
    if wire_dtype:
        os.environ[const.AUTODIST_WIRE_DTYPE] = wire_dtype
    else:
        os.environ.pop(const.AUTODIST_WIRE_DTYPE, None)
    t0 = time.perf_counter()
    try:
        _, step = async_session(dev, PS(sync=False), resource_info=ASYNC_TWO_NODES)
        ad, runner = step.autodist, step.runner
        if not ad._coordinator.join(timeout=600.0):
            raise AssertionError("async_ps: the worker process did not finish in 600 s")
        wall = time.perf_counter() - t0
        applied = runner.service.updates_applied
        same = same_params(device_params(runner.service.state), reference_params)
        finite = all(torch.isfinite(v).all() for v in runner.service.state.params.values())
        ad._teardown()
    finally:
        os.environ.pop(const.AUTODIST_WIRE_DTYPE, None)
    with open(report_path) as f:
        report = json.load(f)
    if applied != ASYNC_STEPS or not finite:
        raise AssertionError(f"async_ps remote ({wire_dtype or 'f32'}): {applied} updates "
                             f"applied of {ASYNC_STEPS}, finite {finite}")
    log(f"async_ps remote ({wire_dtype or 'f32'} wire): chief wall {wall:.1f} s (worker "
        f"launch, build and {ASYNC_STEPS} steps); worker {report['steps_per_s']:.3f} steps/s "
        f"({report['steps_per_s_after_first']:.3f} after its first); losses "
        f"{report['losses']}; worker native bytes {report['native_bytes']}")
    for i, row in enumerate(report["steps"]):
        log(f"async_ps remote ({wire_dtype or 'f32'}) step {i}: pull {row['pull_bytes']} bytes "
            f"in {row['pull_ms']:.3f} ms, push {row['push_bytes']} bytes in "
            f"{row['push_ms']:.3f} ms, step {row['step_ms']:.3f} ms")
    return report, same


def async_in_process(counted, dev):
    """Phase 18 (a)-(d), in this process: ``(a)'s params, (a)'s steps/s, the
    two-worker run of (b)`` (which (f) runs again with a fault). ``counted(fn)``
    runs ``fn`` with every launch count set to 0 first and returns ``(out,
    launches)``."""
    from autodist_tpu_torch.strategy import PS
    from autodist_tpu_torch.testing import faults

    # (a) One worker equals the synchronous step.
    cfg, sync_step = async_session(dev, PS())
    seeds = range(ASYNC_STEPS)
    batches = async_batches(sync_step, cfg, seeds)
    sync_losses = [float(sync_step(b)) for b in batches]
    sync_params = device_params(sync_step.get_state())
    del sync_step
    free_card()
    _, step = async_session(dev, PS(sync=False))
    if type(step.runner).__name__ != "AsyncPSRunner":
        raise AssertionError(f"async_ps: PS(sync=False) built {type(step.runner).__name__}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, launches = counted(lambda: [float(step(b)) for b in batches])
    a_rate = ASYNC_STEPS / (time.perf_counter() - t0)
    a_params = device_params(step.runner.service.state)
    log(f"async_ps (a): sync losses {sync_losses}, async losses {losses}; launches "
        f"{launches}; {a_rate:.3f} steps/s (host clock, first step included)")
    if not same_params(a_params, sync_params):
        raise AssertionError("async_ps (a): PS(sync=False) with one worker differs from PS()")
    check_launches(launches, ASYNC_STEPS, "async_ps (a)")
    log("async_ps (a): PS(sync=False), one worker, equals PS() bit for bit over "
        f"{ASYNC_STEPS} steps")
    del step, sync_params
    free_card()

    # (b) Two in-process workers under PS(staleness=2), from two threads.
    def two_workers(fault=None):
        _, step = async_session(dev, PS(staleness=2), num_workers=2)
        runner = step.runner
        work = {w: async_batches(step, cfg, range(100 * (w + 1), 100 * (w + 1)
                                                  + ASYNC_THREAD_STEPS)) for w in (0, 1)}
        apply_s, wait_s = [], []
        service_apply, on_device = runner.service.apply, runner._apply_on_device

        def timed_apply(grads):
            # The service's whole apply: the wait for the card's execution
            # lock (held by the other worker's gradients), the optimizer
            # step and the published copy.
            t = time.perf_counter()
            out = service_apply(grads)
            torch.cuda.synchronize()
            wait_s.append(time.perf_counter() - t)
            return out

        def timed_on_device(state, grads):
            # The optimizer step alone, under the lock.
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = on_device(state, grads)
            torch.cuda.synchronize()
            apply_s.append(time.perf_counter() - t)
            return out

        runner.service.apply, runner._apply_on_device = timed_apply, timed_on_device
        losses, errors = [], []

        def drive(w):
            try:
                i = 0
                handle = runner.worker(w)
                while i < ASYNC_THREAD_STEPS:
                    try:
                        losses.append(float(handle.step(work[w][i], timeout=600.0)))
                        i += 1
                    except faults.WorkerCrashed:
                        handle = runner.add_worker(w)   # the replacement
                # A finished worker leaves the gate (as a worker process's
                # disconnect retires it), so the other is never parked on it.
                runner.controller.retire(w)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append((w, repr(e)))

        if fault:
            faults.install(fault)
        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=drive, args=(w,)) for w in (0, 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(900.0)
            wall = time.perf_counter() - t0
        finally:
            faults.clear()
        return step, runner, losses, errors, wall, (apply_s, wait_s)

    (step, runner, b_losses, errors, wall, (apply_s, wait_s)), launches = counted(two_workers)
    applied = runner.service.updates_applied
    lag = runner.controller.max_lag()
    finite = all(torch.isfinite(v).all() for v in runner.service.state.params.values())
    log(f"async_ps (b): 2 workers x {ASYNC_THREAD_STEPS} steps: {applied} updates, largest lag "
        f"{lag}, losses {b_losses}; {2 * ASYNC_THREAD_STEPS / wall:.3f} steps/s (host clock); "
        f"the apply's optimizer step {1e3 * sum(apply_s) / len(apply_s):.3f} ms, the "
        f"service's whole apply (lock wait and published copy included) "
        f"{1e3 * sum(wait_s) / len(wait_s):.3f} ms (means of {len(apply_s)}, host clock, "
        f"the card synchronized); launches {launches}")
    if (errors or applied != 2 * ASYNC_THREAD_STEPS or lag > 2 or not finite
            or not b_losses[-1] < b_losses[0]):
        raise AssertionError(f"async_ps (b): errors {errors}, {applied} updates, lag {lag}, "
                             f"finite {finite}, losses {b_losses}")
    check_launches(launches, 2 * ASYNC_THREAD_STEPS, "async_ps (b)")
    extra = async_batches(step, cfg, (900, 901))
    runner.add_worker(0)   # back into the gate it left when it finished
    profile_steps(lambda b: runner.worker(0).step(b), extra, label="async_ps profile")
    del step, runner
    free_card()

    # (c) A stale interleaving replayed.
    _, step = async_session(dev, PS(sync=False), num_workers=2)
    runner = step.runner
    service = runner.service
    (v0, _, _), (v0b, _, _) = service.read(), service.read()
    recorded = {k: v.detach().clone() for k, v in v0.items()}
    grad = lambda params, b: runner.grad_fn(params, b, {})[0]  # noqa: E731
    service.apply(grad(v0, batches[0]))
    service.apply(grad(v0b, batches[1]))
    held = same_params({k: v.detach() for k, v in v0b.items()}, recorded)
    trainable = {k for k, v in v0.items() if v.requires_grad}
    plain = {k: v.clone().requires_grad_(k in trainable) for k, v in recorded.items()}
    opt = torch.optim.Adam([plain[k] for k in plain if k in trainable], lr=1e-3, eps=1e-8,
                           capturable=dev.type == "cuda")
    for b in batches[:2]:
        replay_grads = grad({k: t.clone().requires_grad_(k in trainable)
                             for k, t in recorded.items()}, b)
        for k, g in replay_grads.items():
            plain[k].grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
    c_same = same_params(device_params(service.state), {k: v.detach() for k, v in plain.items()})
    log(f"async_ps (c): stale interleaving: held version unchanged {held}; service equals the "
        f"plain replay bit for bit {c_same}")
    if not (held and c_same):
        raise AssertionError("async_ps (c): the stale interleaving differs from its replay")
    del step, runner, service, plain, opt, v0, v0b
    free_card()

    # (d) zero=4 against the unsharded service.
    _, step = async_session(dev, PS(sync=False), zero=4)
    d_losses, launches = counted(lambda: [float(step(b)) for b in batches])
    service = step.runner.service
    d_same = same_params(device_params(service.state), a_params)
    log(f"async_ps (d): zero=4: {service.shards} shards, versions {service.shard_versions}, "
        f"losses {d_losses}; equals the unsharded service bit for bit {d_same}")
    if not d_same or service.shards != 4:
        raise AssertionError("async_ps (d): the sharded apply differs from the unsharded one")
    del step, service
    free_card()
    return a_params, a_rate, two_workers


def async_ps_path(kernels, dev):
    """Phase 18: the async PS plane on one card; the launches of its parts."""
    from autodist_tpu_torch.parallel import ps_transport

    launches_total = collections.Counter()

    def counted(fn):
        for k in kernels:
            k.launches = 0
        out = fn()
        launches = {k.__name__: k.launches for k in kernels}
        launches_total.update(launches)
        return out, launches

    a_params, a_rate, two_workers = async_in_process(counted, dev)

    # (e) Across processes, through the Coordinator.
    out = os.path.join(os.environ["AUTODIST_WORKING_DIR"], "async_ps_train.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "autodist_tpu_torch.examples.async_ps_train",
                           "--device", str(dev), "--out", out],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"async_ps_train failed: {proc.stderr[-2000:]}")
    with open(out) as f:
        summary = json.load(f)
    log(f"async_ps (e): async_ps_train in {time.perf_counter() - t0:.1f} s: {summary}")
    if summary["applied_updates"] != 2 * summary["chief_steps"]:
        raise AssertionError(f"async_ps_train: {summary}")
    native0 = ps_transport.native_bytes()
    (report, e_same), launches = counted(lambda: async_remote(dev, "", a_params))
    native = ps_transport.native_bytes()
    log(f"async_ps (e): chief native bytes sent {native[0] - native0[0]} received "
        f"{native[1] - native0[1]}; (a)'s in-process rate {a_rate:.3f} steps/s; chief-side "
        f"launches {launches}; equals (a) bit for bit {e_same}")
    if not e_same:
        raise AssertionError("async_ps (e): the chief's params differ from (a)'s one-worker run")
    if native[0] - native0[0] <= 0 or native[1] - native0[1] <= 0 or \
            min(report["native_bytes"]) <= 0:
        raise AssertionError(f"async_ps (e): the native transport carried no bytes "
                             f"(chief {native0} -> {native}, worker {report['native_bytes']})")
    bf16, _ = async_remote(dev, "bf16", a_params)
    ratio = bf16["steps"][-1]["push_bytes"] / report["steps"][-1]["push_bytes"]
    loss_gap = abs(bf16["losses"][-1] - report["losses"][-1]) / abs(report["losses"][-1])
    log(f"async_ps (e): bf16 push bytes {ratio:.4f} of f32's; final loss {bf16['losses'][-1]} "
        f"vs {report['losses'][-1]} (relative {loss_gap:.2e})")
    if not (0.45 < ratio < 0.55) or loss_gap > 1e-2:
        raise AssertionError(f"async_ps (e): bf16 push ratio {ratio}, loss gap {loss_gap}")
    free_card()

    # (f) Recovery: a worker crash in (b)'s run.
    (step, runner, f_losses, errors, wall, _), launches = counted(
        lambda: two_workers("worker_crash@step=2,worker=1"))
    applied = runner.service.updates_applied
    finite = all(torch.isfinite(v).all() for v in runner.service.state.params.values())
    from autodist_tpu_torch.parallel import recovery
    log(f"async_ps (f): worker_crash@step=2,worker=1: {applied} updates, finite {finite}, "
        f"errors {errors}, recovery {recovery.recovery_snapshot()['counts']}, gate steps "
        f"{runner.controller.steps}")
    if errors or applied != 2 * ASYNC_THREAD_STEPS or not finite:
        raise AssertionError(f"async_ps (f): {applied} updates, errors {errors}")
    del step, runner
    free_card()
    return dict(launches_total)


def check_cell_launches(launches, want, label):
    got = (launches["lstm_cell_fwd"], launches["lstm_cell_bwd"])
    if got != (want, want):
        raise AssertionError(f"{label}: lstm cell launches {got}, want {want} each way")


def check_lstm_cell(lc, dev, batch=128, steps=256, hidden=1024):
    """Phase 19's cell kernels against their plain versions at lm1b's shape
    (B = 128, H = 1,024, bf16 gates), on the strided step slices the
    recurrence hands them: every output within TILE_RTOL in every tile, the
    carry's gradient too. Returns the largest absolute error; logs their
    times beside the plain versions'."""
    gen = torch.Generator().manual_seed(3)
    g4, bf = 4 * hidden, torch.bfloat16
    x_gates = (torch.randn(batch, steps, g4, generator=gen) * 0.5).to(dev, bf)
    cs = (torch.randn(batch, steps, hidden, generator=gen) * 0.5).to(dev)
    hs = torch.empty(batch, steps, hidden, device=dev)
    acts = torch.empty(batch, steps, g4, dtype=bf, device=dev)
    yh = (torch.randn(batch, g4, generator=gen) * 0.5).to(dev, bf)
    bh = (torch.randn(g4, generator=gen) * 0.1).to(dev, bf)
    t = 5
    h_t = lc.lstm_cell_fwd(yh, bh, x_gates[:, t], cs[:, t - 1], cs[:, t], hs[:, t], acts[:, t])
    want = lc.cell_fwd_plain(yh, bh, x_gates[:, t], cs[:, t - 1])
    fwd = [compare(got, w, 0) for got, w in zip((cs[:, t], hs[:, t], h_t, acts[:, t]), want)]
    dhs = torch.randn(batch, steps, hidden, generator=gen).to(dev)
    dh_rec = (torch.randn(batch, hidden, generator=gen) * 0.1).to(dev, bf)
    dc0 = torch.randn(batch, hidden, generator=gen).to(dev)
    dys = torch.empty_like(acts)
    want_dy, want_dc = lc.cell_bwd_plain(dhs[:, t], dh_rec, dc0, acts[:, t], cs[:, t],
                                         cs[:, t - 1])
    dc = dc0.clone()
    lc.lstm_cell_bwd(dhs[:, t], dh_rec, dc, acts[:, t], cs[:, t], cs[:, t - 1], dys[:, t])
    bwd = [compare(dys[:, t], want_dy, 0), compare(dc, want_dc, 0)]
    torch.cuda.synchronize()
    fwd_ms = time_ms(lambda: lc.lstm_cell_fwd(yh, bh, x_gates[:, t], cs[:, t - 1], cs[:, t],
                                              hs[:, t], acts[:, t]), 50)
    bwd_ms = time_ms(lambda: lc.lstm_cell_bwd(dhs[:, t], dh_rec, dc0.clone(), acts[:, t],
                                              cs[:, t], cs[:, t - 1], dys[:, t]), 50)
    plain_ms = time_ms(lambda: lc.cell_fwd_plain(yh, bh, x_gates[:, t], cs[:, t - 1]), 50)
    log(f"check lstm cell B={batch} H={hidden} bf16: forward (c, h, h bf16, gates) "
        + "; ".join(describe(c) for c in fwd) + "; backward (dy, dc) "
        + "; ".join(describe(c) for c in bwd)
        + f"; forward {fwd_ms:.4f} ms (plain {plain_ms:.4f}), backward {bwd_ms:.4f} ms "
        f"(bound {bound(batch * hidden * (3 * 4 * 2 + 4 * 2 + 4 * 3 + 2), 0)[0]:.4f} ms, "
        f"bytes); card {card_line()}")
    if not all(c[2] <= TILE_RTOL for c in fwd + bwd):
        raise AssertionError("the lstm cell kernels disagree with their plain versions")
    # The whole recurrence, forward and backward, on the card's path (the
    # steps' addresses computed) against the host's (the plain versions).
    x = (torch.randn(16, 12, 256, generator=gen) * 0.5).to(bf)
    whs = (torch.randn(64, 256, generator=gen) * 0.2).to(bf)
    bhs = (torch.randn(256, generator=gen) * 0.1).to(bf)
    coef = torch.randn(16, 12, 64, generator=gen)
    runs = []
    for where in (dev, torch.device("cpu")):
        leaves = [t.to(where).requires_grad_(True) for t in (x, whs, bhs)]
        hseq = lc.lstm_recurrence(*leaves)
        (hseq * coef.to(where)).sum().backward()
        runs.append([hseq.detach().cpu()] + [t.grad.cpu() for t in leaves])
    seq = [compare(a, b, 0) for a, b in zip(*runs)]
    log(f"check lstm recurrence B=16 T=12 H=64 bf16, card against host: h, dx, dwh, dbh "
        + "; ".join(describe(c) for c in seq))
    if not all(c[2] <= TILE_RTOL for c in seq):
        raise AssertionError("the lstm recurrence on the card disagrees with the host's")
    return max(c[0] for c in fwd + bwd)


def lm_family_path(kernels, dev):
    """Phase 19: lm1b's LSTM LM (sampled and full softmax), scale_lm's three
    sizes and the sweep's lm1b_lstm row. Returns the fused head's launches
    over (b) and (c)."""
    import numpy as np

    from autodist_tpu_torch.examples import scale_lm
    from autodist_tpu_torch.examples.benchmark import run_all
    from autodist_tpu_torch.examples.lm1b import lm1b_train
    from autodist_tpu_torch.model_spec import ModelSpec
    from autodist_tpu_torch.models import lstm_lm, transformer_lm as tlm
    from autodist_tpu_torch.ops import lstm_cell
    from autodist_tpu_torch.utils.flops import (loss_and_grad_flops, mfu,
                                                transformer_flops_per_token)

    t_phase = time.perf_counter()
    total = collections.Counter()
    card = card_line()
    check_lstm_cell(lstm_cell, dev)
    kernels = tuple(kernels) + lstm_cell.KERNELS

    def lm1b(extra, steps):
        args = lm1b_train.parse_args(["--model", "lstm", "--device", str(dev)] + extra
                                     + LM_FAMILY_ARGS)
        run = lm1b_train.build(args)
        batch = run.step.runner.shard_batch(run.example)
        float(run.step(batch))                       # the first step: the lazy state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times, launches = counted_steps(run.step, [batch] * steps, kernels)
        words = args.batch_size * args.seq_len * steps / sum(times)
        return args, run, batch, losses, words, launches

    # (a) the sampled softmax at the defaults: the cell kernels run once a
    # step of each layer, each way.
    args, run, batch, losses, words, launches = lm1b([], LM1B_STEPS)
    check_cell_launches(launches, args.n_layers * args.seq_len * LM1B_STEPS, "lm1b")
    t0 = time.perf_counter()
    spec = ModelSpec.from_loss_fn(run.loss_fn, run.params, run.example)
    walk_s = time.perf_counter() - t0
    sparse = sorted(n for n, p in spec.params.items() if p.sparse)
    flops = loss_and_grad_flops(run.loss_fn, run.step.runner.logical_params(
        run.step.get_state()), batch)
    tokens = args.batch_size * args.seq_len
    log(f"lm1b lstm (sampled, {run.cfg.num_sampled} negatives): batch {args.batch_size} x "
        f"{args.seq_len}, emb {run.cfg.emb_dim}, hidden {run.cfg.hidden_dim}, "
        f"{run.cfg.n_layers} layers, vocab {run.cfg.vocab_size}, {run.choice.reason}: losses "
        f"{losses}; {words:.1f} words/s; MFU {mfu(flops * words / tokens):.4f} "
        f"({flops / 1e9:.1f} GFLOP a step counted); set-up {run.setup_s:.1f} s, of which "
        f"the sparse walk alone {walk_s:.1f} s (sparse: {sparse}); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes; lstm cell launches {launches}; "
        f"card {card}")
    if "lm/embed/embedding" not in sparse:
        raise AssertionError(f"lm1b: the walk did not mark the embedding sparse: {sparse}")
    profile_steps(run.step, [batch], label="lm1b lstm profile")
    del run, batch, spec
    free_card()

    # (b) the exact softmax at lm1b's vocabulary through the fused head.
    args, run, batch, losses, words, launches = lm1b(
        ["--full_softmax", "--vocab", str(LM1B_VOCAB)], LM1B_FULL_STEPS)
    run_dtype = run.cfg.dtype
    total.update(launches)
    per_step = {k: v / LM1B_FULL_STEPS for k, v in launches.items()}
    log(f"lm1b lstm full softmax: batch {args.batch_size} x {args.seq_len}, vocab "
        f"{run.cfg.vocab_size}, {run.choice.reason}: losses {losses}; {words:.1f} words/s; "
        f"launches a step {per_step}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes; card {card}")
    check_launches(launches, LM1B_FULL_STEPS, "lm1b full softmax")
    del run, batch
    free_card()
    # The fused loss against the plain f32 head at a cut of V, same weights and batch.
    cfg = lstm_lm.LSTMLMConfig(vocab_size=LM1B_CUT_VOCAB, emb_dim=args.d_model,
                               hidden_dim=2 * args.d_model, n_layers=args.n_layers,
                               dtype=run_dtype)
    model, params = lstm_lm.init_params(cfg, seed=0, device=dev)
    example = lstm_lm.synthetic_batch(cfg, args.batch_size, args.seq_len, sampled=False)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in example.items()}
    with torch.no_grad():
        fused = float(lstm_lm.make_fused_full_softmax_loss_fn(model)(params, tb))
        plain = float(lstm_lm.make_loss_fn(model)(params, tb))
    log(f"lm1b full softmax at V = {LM1B_CUT_VOCAB}: fused head (bf16 h) {fused:.6f}, plain "
        f"f32 head {plain:.6f}, rel {abs(fused - plain) / abs(plain):.3g}")
    if not abs(fused - plain) <= 1e-2 * abs(plain):
        raise AssertionError(f"lm1b: fused loss {fused} vs the plain f32 head's {plain}")
    del model, params, tb
    free_card()

    # (c) scale_lm's three sizes.
    for d, layers, bs in SCALE_RUNS:
        argv = ["--device", str(dev), "--d_model", str(d), "--n_layers", str(layers),
                "--batch_size", str(bs), "--steps", str(SCALE_STEPS)] + SCALE_ARGS
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rate_ = scale_lm.main(argv)
        launches = {k.__name__: k.launches for k in kernels}
        total.update(launches)
        steps = SCALE_STEPS + scale_lm.WARMUP_STEPS
        sargs = scale_lm.parse_args(argv)
        fpt = transformer_flops_per_token(d, layers, 4 * d, sargs.vocab, sargs.seq_len)
        log(f"scale_lm d{d} x {layers} bs{bs}: {rate_:.1f} tokens/s, MFU "
            f"{mfu(fpt * rate_):.4f}; fused-head launches a step "
            f"{ {k: v / steps for k, v in launches.items()} }; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} bytes; card {card}")
        check_launches(launches, steps, f"scale_lm d{d} x {layers}")
        free_card()
    # The first step's loss: the fused head against the plain one at d1024 x 12.
    d, layers, bs = SCALE_RUNS[1]
    args = scale_lm.parse_args(["--device", str(dev), "--d_model", str(d), "--n_layers",
                                str(layers), "--batch_size", str(bs)] + SCALE_ARGS)
    losses = {}
    for fused_head in (True, False):
        cfg = dataclasses.replace(scale_lm.model_config(args, on_card=True),
                                  fused_head=fused_head)
        model, params = tlm.init_params(cfg, seed=0, device=dev)
        tb = {k: torch.from_numpy(v).to(dev)
              for k, v in tlm.synthetic_batch(cfg, bs, args.seq_len).items()}
        with torch.no_grad():
            losses[fused_head] = float(tlm.make_loss_fn(model)(params, tb))
        del model, params, tb
        free_card()
    log(f"scale_lm d{d} x {layers} first-step loss: fused head {losses[True]:.6f}, plain head "
        f"{losses[False]:.6f}")
    if not abs(losses[True] - losses[False]) <= 1e-2 * abs(losses[False]):
        raise AssertionError(f"scale_lm: fused loss {losses[True]} vs plain {losses[False]}")

    # (d) the sweep's row, in its own process.
    t0 = time.perf_counter()
    rows = run_all.main(["--only", "lm1b_lstm", "--steps", str(LM1B_SWEEP_STEPS)])
    log(f"lm1b: run_all --only lm1b_lstm --steps {LM1B_SWEEP_STEPS}: {rows} "
        f"({time.perf_counter() - t0:.1f} s); card {card}")
    if not rows or rows[0]["rate"] is None or not np.isfinite(rows[0]["rate"]):
        raise AssertionError(f"run_all lm1b_lstm reported no rate: {rows}")
    log(f"lm_family: phase 19 in {time.perf_counter() - t_phase:.1f} s")
    return dict(total)


# Phase 20: the flagship's step at a cut batch (the real 384 x 256 x 8 step
# takes 1.25 s, and the phase's runs total about 90 steps).
TEL_MICRO, TEL_ACCUM, TEL_SEQ = 64, 2, 256
TEL_STEPS, TEL_LOG_EVERY = 13, 4          # (a)'s runs: periods close at 5, 9, 13
TEL_SPAN_REPS = 200_000                   # disabled spans timed
TEL_UNROLL = 8
TEL_REMOTE_STEPS = 4


def tel_bench():
    """Phase 20's helpers: the shape, batches, session and plane arming of
    ``python -m autodist_tpu_torch.examples.benchmark.telemetry``."""
    from autodist_tpu_torch.examples.benchmark import telemetry
    return telemetry


def tel_config():
    return tel_bench().config(vocab=V, d_model=D)


def tel_batch(cfg, i, poison=False):
    return tel_bench().make_batch(cfg, i, TEL_MICRO * TEL_ACCUM, TEL_SEQ, poison=poison)


def tel_runner(model, params, dev, health=None):
    return tel_bench().session(model, params, dev, TEL_ACCUM, health=health)


def tel_train(runner, params, batches, steps, **kw):
    """``train()``; ``(state, tokens/s of each log period)``."""
    return tel_bench().train_rates(runner, params, batches, steps, TEL_SEQ, **kw)


def tel_profile(runner, state, batches):
    """Device kernels and busy ms a step over ``run()`` steps of
    ``batches[1:]`` (``batches[0]`` in the profiler's warm-up), and the
    window's kernels by name."""
    from autodist_tpu_torch.examples.benchmark import step_kernels
    per_step, busy_ms, names, _ = step_kernels.kernels_a_step(runner, state, batches)
    return per_step, busy_ms, names


def host_norms(tensors) -> float:
    return math.sqrt(sum(float(torch.linalg.vector_norm(t.detach().double().cpu())) ** 2
                         for t in tensors))


def tel_check_bundle(runner, state, batch):
    """(b) per step: one ``run()``; the bundle against the norms computed on
    the host (f64) from the same gradients (recomputed from the params
    before the step), the step's change and the params before it."""
    before = {k: v.detach().clone() for k, v in state.params.items()}
    sharded = runner.shard_batch(batch)
    leaves = {k: v.clone().requires_grad_(k in state.opt_params) for k, v in before.items()}
    grads, _, _ = runner._accumulate(leaves, sharded, state.ef_state)
    runner.run(state, batch)
    got = runner.last_health.detach().cpu().numpy()
    want = [0.0, host_norms(grads.values()),
            host_norms(state.params[k].detach() - before[k] for k in grads),
            host_norms(t for t in before.values() if t.is_floating_point())]
    err = max(abs(float(g) - w) / max(abs(w), 1e-30) for g, w in zip(got[1:], want[1:]))
    log(f"telemetry (b): bundle {got.tolist()} vs host {want}: largest relative gap "
        f"{err:.2e}; card {card_line()}")
    if got[0] != 0 or err > 1e-3:
        raise AssertionError(f"telemetry (b): the bundle disagrees with the host norms ({err})")


def tel_recover(model, params, dev, unroll):
    """(c): a NaN step under ``AUTODIST_HEALTH_ACTION=recover`` rolls back and
    the run ends equal to a clean one; the fault is ``AUTODIST_FAULTS``'
    ``nan_grads`` per step (the batch's float mask NaN-filled), a batch
    poisoned on its first pull under ``unroll``. ``(rollback seconds, graph
    captures of the healed run)``."""
    from autodist_tpu_torch import telemetry
    from autodist_tpu_torch.testing import faults
    from autodist_tpu_torch.training import train
    cfg = tel_config()
    steps, log_every = (8, 2) if unroll == 1 else (3 * TEL_UNROLL, TEL_UNROLL)
    fault_at = 5 if unroll == 1 else 2 * TEL_UNROLL + TEL_UNROLL // 2
    fired = []

    def poisoned(i):
        poison = unroll > 1 and i == fault_at and not fired
        if poison:
            fired.append(i)
        return tel_batch(cfg, i, poison=poison)

    def run(batches, env):
        with tel_bench().Planes(None):
            os.environ.update(env)
            try:
                runner = tel_runner(model, params, dev, health=True)
                monitor = telemetry.HealthMonitor()
                t0 = time.perf_counter()
                state = train(runner, params, batches, steps=steps, log_every=log_every,
                              unroll=unroll, health_monitor=monitor)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                for k in env:
                    os.environ.pop(k, None)
                faults.clear()
        return state, monitor, wall, runner

    clean, mon, clean_s, _ = run(lambda i: tel_batch(cfg, i), {})
    env = {"AUTODIST_HEALTH_ACTION": "recover"}
    if unroll == 1:
        env["AUTODIST_FAULTS"] = f"nan_grads@step={fault_at}"
        faults.install(faults.parse(env["AUTODIST_FAULTS"]))
    healed, hmon, healed_s, runner = run(poisoned, env)
    same = same_params({k: v.detach() for k, v in healed.params.items()},
                       {k: v.detach() for k, v in clean.params.items()})
    kinds = [a["kind"] for a in hmon.anomalies]
    log(f"telemetry (c) unroll={unroll}: fault at step {fault_at + 1}, anomalies {kinds}; "
        f"healed run {healed_s:.2f} s against a clean {clean_s:.2f} s ({steps} steps, "
        f"log_every {log_every}: the rollback's deep copies, replayed steps and, under "
        f"unroll, the graph's re-capture cost {healed_s - clean_s:.2f} s); final params "
        f"equal the clean run's bit for bit: {same}; graphs held after the rollback "
        f"{len(runner._graphs)}; card {card_line()}")
    if not (same and healed.step == steps and kinds and set(kinds) == {"nonfinite"}
            and not mon.anomalies):
        raise AssertionError(f"telemetry (c) unroll={unroll}: the rollback did not heal "
                             f"the run (same {same}, anomalies {kinds})")
    return healed_s - clean_s


def tel_oom(dev) -> bool:
    """A 1 TiB allocation on the card: it must raise ``OutOfMemoryError``,
    which the memory plane recognises and books; whether it recognised it."""
    from autodist_tpu_torch.telemetry import memplane
    try:
        torch.empty(1 << 40, dtype=torch.uint8, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        memplane.record_oom("chip_smoke", e)
        return memplane.is_oom_error(e)
    raise AssertionError("telemetry (e): a 1 TiB torch.empty did not raise")


def telemetry_worker():
    """Phase 20 (g)'s worker half (``CHIP_SMOKE_WORKER=telemetry``): the
    flagship over the transport for ``TEL_REMOTE_STEPS`` steps with spans
    on, the step's split by its ``ps.*`` spans, and the copies timed apart;
    closing the runner pushes the span ring to the chief
    (``AUTODIST_TRACE_PULL``)."""
    from autodist_tpu_torch import const, telemetry
    from autodist_tpu_torch.parallel import ps_transport
    from autodist_tpu_torch.strategy import PS
    telemetry.enable()
    dev = torch.device("cuda:0")
    cfg, step = async_session(dev, PS(sync=False), resource_info=ASYNC_TWO_NODES)
    batches = async_batches(step, cfg, range(TEL_REMOTE_STEPS))
    t0_ns = time.perf_counter_ns()
    rows = []
    for batch in batches:
        ts = time.perf_counter()
        float(step(batch))
        rows.append(1e3 * (time.perf_counter() - ts))
    spans = collections.defaultdict(list)
    for name, _, t0, dur, _ in telemetry.snapshot_spans():
        if name.startswith("ps.") and t0 >= t0_ns:
            spans[name].append(dur / 1e6)
    remote = step.runner._remote_worker
    params = remote._cached_pull[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = ps_transport._to_host(params)
    d2h = time.perf_counter() - t0
    t0 = time.perf_counter()
    {k: v.to(dev) for k, v in host.items()}
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t0
    # The ring as JSONL too, on the chief's clock, for phase 22's tracedump.
    telemetry.dump_spans_jsonl(os.path.join(TOOLS_DIR, "spans_worker.jsonl"), worker_id=1,
                               clock_offset_ns=remote.clock_offset_ns or 0)
    step.runner.close()      # under AUTODIST_TRACE_PULL: pushes this ring to the chief
    report = {"step_ms": rows, "spans_ms": {k: v for k, v in sorted(spans.items())},
              "copy_ms": {"device_to_host": 1e3 * d2h, "host_to_device": 1e3 * h2d},
              "param_bytes": sum(v.numel() * v.element_size() for v in host.values()),
              "clock_offset_ns": remote.clock_offset_ns,
              "clock_offset_err_ns": remote.clock_offset_err_ns}
    with open(os.path.join(const.DEFAULT_WORKING_DIR, "chip_telemetry_worker.json"), "w") as f:
        json.dump(report, f)
    print(f"telemetry worker: {report}", file=sys.stderr, flush=True)
    return 0


def tel_remote(dev, tmp):
    """(g) the chief half: serve the flagship to one worker process with
    spans on and ``AUTODIST_TRACE_PULL=1``, merge the cluster trace."""
    from autodist_tpu_torch import const, telemetry
    from autodist_tpu_torch.strategy import PS
    report_path = os.path.join(const.DEFAULT_WORKING_DIR, "chip_telemetry_worker.json")
    if os.path.exists(report_path):
        os.remove(report_path)
    env = {"AUTODIST_TELEMETRY": "1", "AUTODIST_TRACE_PULL": "1",
           "CHIP_SMOKE_WORKER": "telemetry"}
    os.environ.update(env)
    telemetry.enable()
    adtop = []
    try:
        _, step = async_session(dev, PS(sync=False), resource_info=ASYNC_TWO_NODES)
        ad, runner = step.autodist, step.runner
        # Phase 22's console reading: the live server, while the worker trains.
        adtop.append(tool_proc("adtop", "%s:%d" % tuple(runner._ps_server.address), "--once",
                               "--raw"))
        TOOLS["adtop"] = json.loads(tool_result("adtop", adtop[0]))
        if not ad._coordinator.join(timeout=600.0):
            raise AssertionError("telemetry (g): the worker process did not finish in 600 s")
        path = runner.collect_cluster_trace(os.path.join(tmp, "cluster.json"))
        telemetry.dump_spans_jsonl(os.path.join(TOOLS_DIR, "spans_chief.jsonl"), worker_id=0)
        ad._teardown()
    finally:
        stop(adtop)
        for k in env:
            os.environ.pop(k, None)
        telemetry.disable()
    with open(path) as f:
        lanes = {e["pid"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    with open(report_path) as f:
        report = json.load(f)
    log(f"telemetry (g): the cluster trace merges {len(lanes)} lanes; worker step ms "
        f"{[round(x, 3) for x in report['step_ms']]}; clock offset {report['clock_offset_ns']} "
        f"+- {report['clock_offset_err_ns']} ns; card {card_line()}")
    for name, durs in report["spans_ms"].items():
        log(f"telemetry (g):   {name}: {len(durs)} spans, ms {[round(x, 3) for x in durs]}")
    log(f"telemetry (g):   copies of the {report['param_bytes']} parameter bytes: device to "
        f"host {report['copy_ms']['device_to_host']:.3f} ms, host to device "
        f"{report['copy_ms']['host_to_device']:.3f} ms")
    if len(lanes) != 2:
        raise AssertionError(f"telemetry (g): the cluster trace has lanes {lanes}, want 2")


def telemetry_path(kernels, dev):
    """Phase 20: the telemetry planes around the flagship's train()."""
    import tempfile
    import urllib.request

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from autodist_tpu_torch import telemetry
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.ops import fused_xent as fx
    from autodist_tpu_torch.strategy.autotune import _load_calibration
    from autodist_tpu_torch.telemetry import health, memplane, openmetrics, profiling
    from autodist_tpu_torch.utils import tracing

    cfg = tel_config()
    model, params = tlm.init_params(cfg, seed=0, device=dev)
    tokens = TEL_MICRO * TEL_ACCUM * TEL_SEQ
    log(f"telemetry: the flagship d512 x 6, vocab {V}, at micro {TEL_MICRO} x seq {TEL_SEQ} x "
        f"accum {TEL_ACCUM} ({tokens} tokens a step; the real 384 x 256 x 8 step is 1.25 s, "
        f"too long for the phase's ~90 steps); card {card_line()}")
    batches = lambda i: tel_batch(cfg, i)  # noqa: E731
    for k in kernels:
        k.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        exporter = openmetrics.MetricsExporter(port=0, host="127.0.0.1")
        openmetrics.set_exporter(exporter)
        armed = tel_bench().armed_env(tmp, exporter.address[1])
        try:
            # (a) Cost: every plane off and every plane armed, in turns (off,
            # armed, armed, off), before any profiler window: once a profiler
            # session has run, the process's launches stay slower.
            rates = {"off": [], "armed": []}
            for turn, which in enumerate(("off", "armed", "armed", "off")):
                with tel_bench().Planes(armed if which == "armed" else None):
                    r = tel_runner(model, params, dev)
                    telemetry.clear()
                    profiling.reset()
                    _, period_rates = tel_train(r, params, batches, TEL_STEPS,
                                                log_every=TEL_LOG_EVERY)
                    rates[which].append(tel_bench().mean_after_first(period_rates))
                    if turn == 2:   # the second armed run: its gauges and spans
                        on_rates = period_rates
                        spans_per_step = len(telemetry.snapshot_spans()) / TEL_STEPS
                        mfu_gauge = telemetry.gauge("train.mfu").value
                        attr = {p: telemetry.gauge(f"train.attr.{p}").value
                                for p in profiling.ATTR_PHASES}
                        recorded = {sig: (rec.flops, rec.dispatches, rec.source)
                                    for sig, rec in profiling.program_costs().items()}
                del r
                free_card()
            off_rate = sum(rates["off"]) / 2
            on_rate = sum(rates["armed"]) / 2
            with tel_bench().Planes(None):
                off = tel_runner(model, params, dev)
                st = off.init(params)
                off.run(st, batches(0))
                off_kernels, off_busy, off_names = tel_profile(
                    off, st, [batches(i) for i in (1, 2, 3)])
                span_t0 = time.perf_counter()
                for _ in range(TEL_SPAN_REPS):
                    with telemetry.span("x"):
                        pass
                span_ns = 1e9 * (time.perf_counter() - span_t0) / TEL_SPAN_REPS
                del off, st
            free_card()
            with tel_bench().Planes(armed):
                # Health off, every other plane armed: the same kernels a
                # step as every plane off (the planes add host work only).
                quiet = tel_runner(model, params, dev, health=False)
                quiet_state = quiet.init(params)
                quiet.run(quiet_state, batches(0))
                quiet_kernels, _, quiet_names = tel_profile(
                    quiet, quiet_state, [batches(i) for i in (1, 2, 3)])
                del quiet, quiet_state
                free_card()
                log(f"telemetry (a): health off, the other planes armed: {quiet_kernels:.0f} "
                    f"device kernels a step against {off_kernels:.0f} with every plane off; "
                    f"the same kernels by name: {quiet_names == off_names}; card "
                    f"{card_line()}")
                if quiet_names != off_names:
                    raise AssertionError(f"telemetry (a): with health off the armed planes "
                                         f"change the step's kernels: armed only "
                                         f"{dict(quiet_names - off_names)}, off only "
                                         f"{dict(off_names - quiet_names)}")
                on = tel_runner(model, params, dev)
                on_state = on.init(params)
                on.run(on_state, batches(0))
                on_kernels, on_busy, _ = tel_profile(on, on_state,
                                                     [batches(i) for i in (1, 2, 3)])
                step_s = TEL_SEQ * TEL_MICRO * TEL_ACCUM / on_rate
                log(f"telemetry (a): in turns off, armed, armed, off: planes off "
                    f"{[round(x, 1) for x in rates['off']]} tokens/s, every plane armed "
                    f"{[round(x, 1) for x in rates['armed']]} ({on_rate / off_rate:.4f} of off "
                    f"on the means); off {off_kernels:.0f} device kernels and {off_busy:.3f} "
                    f"busy ms a step, armed {on_kernels:.0f} and {on_busy:.3f}: health adds "
                    f"{on_kernels - off_kernels:.0f} launches and {on_busy - off_busy:.3f} "
                    f"device ms a step; a disabled span {span_ns:.1f} ns x "
                    f"{spans_per_step:.1f} spans a step = "
                    f"{span_ns * spans_per_step / 1e9 / step_s:.2e} of the step; card "
                    f"{card_line()}")

                # (d) Attribution: train.mfu against the phase's own count.
                # The phase's own count: FlopCounterMode over the step's loss
                # and gradient traced on fake CPU tensors, where the fused
                # head runs its plain version; the card runs the head's
                # kernels, so their own operation counts replace the plain
                # head's (counted apart the same way).
                n = TEL_MICRO * TEL_SEQ
                head_w = params["lm_head.kernel"]
                with FakeTensorMode():
                    fake = {k: torch.empty(v.shape, dtype=v.dtype).requires_grad_()
                            for k, v in params.items()}
                    micro = {"tokens": torch.empty((TEL_MICRO, TEL_SEQ + 1), dtype=torch.int32),
                             "mask": torch.empty((TEL_MICRO, TEL_SEQ + 1))}
                    with FlopCounterMode(display=False) as counter:
                        loss = tlm.make_loss_fn(model)(fake, micro)
                        torch.autograd.grad(loss, list(fake.values()))
                    h = torch.empty((n, D), dtype=torch.bfloat16, requires_grad=True)
                    w = torch.empty(tuple(head_w.shape), dtype=head_w.dtype,
                                    requires_grad=True)
                    with FlopCounterMode(display=False) as head_counter:
                        nll = fx.fused_softmax_xent(h, w, torch.zeros(n, dtype=torch.long))
                        torch.autograd.grad(nll.sum(), [h, w])
                counted = counter.get_total_flops()
                head_plain = head_counter.get_total_flops()
                head = sum(fx._kernel_cost(name, n, D, V, False)[1]
                           for name in ("xent_fwd", "xent_dh", "xent_dwdb"))
                own_flops = TEL_ACCUM * (counted - head_plain + head)
                peak = profiling.peak_spec(dev)
                # The gauge is the last period's: its step time.
                last_step_s = tokens / on_rates[-1]
                own_mfu = own_flops / last_step_s / peak.flops_per_s
                calib, source = _load_calibration(None)
                log(f"telemetry (d): train.mfu {mfu_gauge} against the phase's own "
                    f"{own_mfu:.4f} (FlopCounterMode {own_flops:.4e} a step over the last "
                    f"period's {last_step_s:.4f} s, peak {peak.to_dict()}); program costs "
                    f"{recorded}; attribution shares {attr}; "
                    f"calibration from the profile: {source} {calib}; card {card_line()}")
                if not (mfu_gauge and abs(mfu_gauge - own_mfu) <= 0.1 * own_mfu):
                    raise AssertionError(f"telemetry (d): train.mfu {mfu_gauge} vs {own_mfu}")
                if not source.startswith("profile:"):
                    raise AssertionError(f"telemetry (d): calibration source {source}")
                prof_dir = armed["AUTODIST_PROFILE_DIR"]
                newest = max((os.path.join(prof_dir, f) for f in os.listdir(prof_dir)
                              if f.endswith(".json")), key=os.path.getmtime)
                shutil.copy(newest, os.path.join(TOOLS_DIR, "profile.json"))

                # (e) Memory.
                memplane.tag("params", on_state.params)
                memplane.tag("opt_state", on_state.optimizer)
                census = memplane.census()
                p_bytes = sum(t.numel() * t.element_size() for t in on_state.params.values())
                o_bytes = sum(t.numel() * t.element_size()
                              for s in on_state.optimizer.state.values()
                              for t in s.values() if isinstance(t, torch.Tensor))
                budget, budget_source = memplane.device_budget()
                oom_before = telemetry.counter("mem.oom").value
                booked = tel_oom(dev)
                oom_booked = telemetry.counter("mem.oom").value - oom_before
                log(f"telemetry (e): census params {census.get('params')} vs {p_bytes} bytes, "
                    f"opt_state {census.get('opt_state')} vs {o_bytes}; budget {budget} "
                    f"({budget_source}); the 1 TiB allocation raised OutOfMemoryError, "
                    f"recognised {booked}, mem.oom +{oom_booked}; card {card_line()}")
                if (census.get("params"), census.get("opt_state")) != (p_bytes, o_bytes) \
                        or budget_source != "measured" or not booked or oom_booked != 1:
                    raise AssertionError("telemetry (e): the memory plane disagrees")

                # (f) Traces and the scrape.
                trace_dir = os.path.join(tmp, "trace")
                with tracing.trace(trace_dir=trace_dir, with_host_spans=True):
                    tel_train(on, params, batches, 2, log_every=1)
                with open(os.path.join(trace_dir, "device_trace.json")) as f:
                    names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
                with open(os.path.join(trace_dir, "host_spans_w0.json")) as f:
                    host = {e["name"] for e in json.load(f)["traceEvents"]}
                url = "http://127.0.0.1:%d/metrics" % exporter.address[1]
                with urllib.request.urlopen(url, timeout=10) as r:
                    scrape = r.read().decode()
                has = {m: m.replace(".", "_") in scrape for m in ("train.steps_per_s",
                                                                  "train.mfu")}
                log(f"telemetry (f): device trace kernels include xent_fwd_kernel "
                    f"{any('xent_fwd_kernel' in n for n in names)}; host spans "
                    f"{sorted(host)[:12]}; /metrics lists {has}")
                if not (any("xent_fwd_kernel" in n for n in names) and "train.dispatch" in host
                        and all(has.values())):
                    raise AssertionError("telemetry (f): a trace or the scrape lacks its names")
            del on, on_state
            free_card()

            # (b) The bundle per step, and reduced in the graph under unroll.
            with tel_bench().Planes(None):
                r = tel_runner(model, params, dev, health=True)
                st = r.init(params)
                r.run(st, batches(0))
                tel_check_bundle(r, st, batches(1))
                del r, st
                free_card()
                per_step = tel_runner(model, params, dev, health=True)
                st = per_step.init(params)
                eager = []
                for i in range(TEL_UNROLL):
                    per_step.run(st, batches(i))
                    eager.append(per_step.last_health.clone())
                want = health.reduce_bundle(torch.stack(eager)).cpu()
                del per_step, st
                free_card()
                fused = tel_runner(model, params, dev, health=True)
                t0 = time.perf_counter()
                tel_train(fused, params, batches, TEL_UNROLL, unroll=TEL_UNROLL,
                          log_every=TEL_UNROLL)
                torch.cuda.synchronize()
                got = fused.last_health.cpu()
                log(f"telemetry (b) unroll={TEL_UNROLL}: the graph's reduced bundle "
                    f"{got.tolist()} vs the max of {TEL_UNROLL} eager steps' {want.tolist()} "
                    f"(train() with the warm-up block and capture {time.perf_counter() - t0:.2f}"
                    f" s); card {card_line()}")
                if not torch.allclose(got, want, rtol=1e-3, equal_nan=False):
                    raise AssertionError("telemetry (b): the reduced bundle disagrees")
                del fused
                free_card()

            # (c) Recovery, per step and under unroll.
            for unroll in (1, TEL_UNROLL):
                tel_recover(model, params, dev, unroll)
                free_card()
        finally:
            openmetrics.set_exporter(None)
        launches = {k.__name__: k.launches for k in kernels}

        # (g) The remote async step, traced.
        tel_remote(dev, tmp)
    free_card()
    missing = [name for name, count in launches.items() if name.startswith("xent_") and not count]
    if missing:
        raise AssertionError(f"telemetry: the flagship never launched {missing}")
    return launches



# Phase 21: serving at the flagship's full width (bench.py:2503-2506 on the
# card: d512 x 6, 8 heads, d_ff 2048, vocab 32,000, max_len 512, untied head,
# bf16 activations, f32 params).
SERVE_MODEL = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6, d_ff=2048,
                   max_len=512, tied_output=False)
SERVE_SLOTS = 8                 # the dense engine's decode slots
SERVE_MIX = 24                  # bench.py:1290-1296's mix: prompts 4-48 tokens, 8 or 48 new
SERVE_LONG = (4, 256, 449, 32)  # the long-prompt leg: 4 prompts of 256-448 tokens, 32 new
SERVE_PREFIX = (4, 64)          # requests sharing a 64-token (4-page) prefix
SERVE_SHORT = 64                # short requests (12 + 12 tokens) for the concurrency ratio
SERVE_PAGE = 16
SERVE_CLIENTS = 8
SERVE_DECODE_BATCHES = (1, 8, 32)
SERVE_TIMED_STEPS = 20
SERVE_FLEET_REQUESTS = 16
SERVE_LOGIT_RTOL = 2e-2         # bf16 logits, decode against the full forward, of max |logit|
SERVE_LSTM = dict(batch=4, prompt=16, steps=8)
SERVE_EXAMPLE_ARGS = ["--d_model", "512", "--n_layers", "6", "--vocab", "32000",
                      "--max_len", "512"]


def serve_requests(vocab, seed=0):
    """bench.py's mix (prompts of 4-48 tokens, 8 or 48 new, alternating),
    the long-prompt leg, and prompts sharing a page-aligned prefix, as
    ``(prompt, max_new, seed)``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    mix = [(rng.randint(1, vocab, size=int(rng.randint(4, 48))).astype(np.int32),
            8 if i % 2 == 0 else 48, i) for i in range(SERVE_MIX)]
    n, lo, hi, new = SERVE_LONG
    long = [(rng.randint(1, vocab, size=int(rng.randint(lo, hi))).astype(np.int32), new,
             100 + i) for i in range(n)]
    n, plen = SERVE_PREFIX
    shared = rng.randint(1, vocab, size=plen).astype(np.int32)
    prefix = [(np.concatenate([shared, rng.randint(1, vocab, size=5 + 7 * i).astype(np.int32)]),
               12, 200 + i) for i in range(n)]
    return mix, long, prefix


def serve_drive(engine, config, requests):
    """``requests`` through a Batcher driven round by round: their token
    tuples and the most requests the engine held at once."""
    from autodist_tpu_torch.serving import Batcher
    b = Batcher(engine, config, start=False)
    reqs = [b.submit(p, n, seed=s) for p, n, s in requests]
    peak = 0
    for _ in range(100_000):
        if all(r.done.is_set() for r in reqs):
            break
        b.run_once()
        peak = max(peak, engine.num_active)
    bad = [r.error for r in reqs if r.error or not r.done.is_set()]
    if bad:
        raise AssertionError(f"serving: requests failed: {bad[:3]}")
    return [tuple(r.tokens) for r in reqs], peak


def first_difference(got, want):
    """``(request, token index)`` of the first token two runs disagree on."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i, next(j for j in range(min(len(a), len(b)) + 1)
                           if j == min(len(a), len(b)) or a[j] != b[j])
    return None


def check_tokens(label, got, want):
    diff = first_difference(got, want)
    log(f"{label}: {len(got)} requests, {sum(map(len, got))} tokens, "
        + ("all equal" if diff is None else f"first difference at request {diff[0]}, "
                                               f"token {diff[1]}"))
    if diff is not None:
        raise AssertionError(f"{label}: tokens differ (request {diff[0]}, token {diff[1]})")


def serve_load(engine_config, model, params, requests, clients=SERVE_CLIENTS):
    """An InferenceServer over a started Batcher, ``clients`` client threads
    sending ``requests``: (requests/s, {phase: (p50 ms, p99 ms)}, errors)."""
    import numpy as np

    from autodist_tpu_torch import serving
    engine = serving.LMEngine(model, params, engine_config)
    server = serving.InferenceServer(serving.Batcher(engine, engine_config))
    timings, errors, lock = [], [], threading.Lock()
    try:
        warm = serving.ServeClient(server.address)
        try:
            for b in sorted({serving.bucket_for(len(p), engine.buckets) for p, _, _ in requests}):
                warm.generate(np.arange(1, 1 + min(b, engine.max_len - 2), dtype=np.int32), 2)
        finally:
            warm.close()

        def client(w):
            c = serving.ServeClient(server.address)
            try:
                for p, n, s in requests[w::clients]:
                    try:
                        _, timing = c.generate(p, n, seed=s)
                        with lock:
                            timings.append(timing)
                    except serving.ServeError as e:
                        with lock:
                            errors.append(str(e))
            finally:
                c.close()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(w,)) for w in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        server.close()
    phases = {ph: (float(np.percentile([t[f"{ph}_s"] * 1e3 for t in timings], 50)),
                   float(np.percentile([t[f"{ph}_s"] * 1e3 for t in timings], 99)))
              for ph in ("queue", "prefill", "decode", "total")} if timings else {}
    return len(timings) / wall, phases, errors


def serving_lstm(dev):
    """(a)'s LSTM half: lm1b's LSTM at its defaults (embedding 512, hidden
    1,024, 6 layers, vocab 32,000, bf16): the recurrence from a non-zero
    carry on the card against its plain version on the host, and the decode
    path (prefill, then single-token steps, the carry rounded to bf16 between
    steps) against the same run on the host. Every tile within TILE_RTOL."""
    from autodist_tpu_torch.examples.lm1b import lm1b_train
    from autodist_tpu_torch.models import lstm_lm
    from autodist_tpu_torch.ops import lstm_cell

    args = lm1b_train.parse_args(["--model", "lstm"] + LM_FAMILY_ARGS)
    hidden = 2 * args.d_model
    gen = torch.Generator().manual_seed(11)
    bf = torch.bfloat16
    x = (torch.randn(SERVE_LSTM["batch"] * 32, 12, 4 * hidden, generator=gen) * 0.5).to(bf)
    wh = (torch.randn(hidden, 4 * hidden, generator=gen) / hidden ** 0.5).to(bf)
    bh = (torch.randn(4 * hidden, generator=gen) * 0.1).to(bf)
    c0 = torch.randn(x.shape[0], hidden, generator=gen)
    h0 = torch.randn(x.shape[0], hidden, generator=gen).to(bf)
    runs = []
    for where in (dev, torch.device("cpu")):
        with torch.no_grad():
            (c_t, h_t), hs = lstm_cell.lstm_recurrence(
                x.to(where), wh.to(where), bh.to(where),
                initial_carry=(c0.to(where), h0.to(where)), return_carry=True)
        runs.append([t.cpu() for t in (hs, c_t, h_t)])
    rec = [compare(a, b, 0) for a, b in zip(*runs)]
    cfg = lstm_lm.LSTMLMConfig(vocab_size=args.vocab, emb_dim=args.d_model, hidden_dim=hidden,
                               n_layers=args.n_layers, dtype=bf)
    model, params = lstm_lm.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(1, args.vocab, (SERVE_LSTM["batch"], SERVE_LSTM["prompt"]),
                           generator=gen)
    step_tokens = torch.randint(1, args.vocab, (SERVE_LSTM["batch"], SERVE_LSTM["steps"]),
                                generator=gen)
    fwd0 = lstm_cell.lstm_cell_fwd.launches
    outs = []
    for where in (dev, torch.device("cpu")):
        p = {k: v.to(where) for k, v in params.items()}
        cache = lstm_lm.init_cache(cfg, SERVE_LSTM["batch"], where)
        with torch.no_grad():
            hs = [lstm_lm.apply(model, p, prompt.to(where), decode=True, cache=cache)]
            for t in range(SERVE_LSTM["steps"]):
                hs.append(lstm_lm.apply(model, p, step_tokens[:, t:t + 1].to(where),
                                        decode=True, cache=cache))
        outs.append([torch.cat(hs, 1).cpu()] + [c.cpu() for pair in cache.values() for c in pair])
        if where == dev:
            launches = lstm_cell.lstm_cell_fwd.launches - fwd0
    dec = [compare(a, b, 0) for a, b in zip(*outs)]
    want = args.n_layers * (SERVE_LSTM["prompt"] + SERVE_LSTM["steps"])
    log(f"serving (a) lstm: the recurrence from a carry, B={x.shape[0]} T=12 H={hidden} bf16, "
        f"card against host (h, c, h): " + "; ".join(describe(c) for c in rec)
        + f"; decode at lm1b's defaults ({args.n_layers} x {hidden}, vocab {args.vocab}), "
        f"prompt {SERVE_LSTM['prompt']} then {SERVE_LSTM['steps']} steps, card against host "
        f"(h, then every carry): worst tile {max(c[2] for c in dec):.3g}, max abs "
        f"{max(c[0] for c in dec):.3g}; cell forward launches {launches} (want {want})")
    if not all(c[2] <= TILE_RTOL for c in rec + dec):
        raise AssertionError("serving: the lstm recurrence from a carry disagrees with the host's")
    if dev.type == "cuda" and launches != want:   # the host runs the plain version
        raise AssertionError(f"serving: lstm decode launched the cell kernel {launches} times, "
                             f"want {want}")


def serving_path(kernels, dev):
    """Phase 21: the serving plane at the flagship's full width. Returns the
    port kernels' launches in it (the serving path reaches no TPU-kernel
    counterpart: decode attention and the head are plain products, as in
    the JAX package)."""
    import numpy as np

    from autodist_tpu_torch import serving
    from autodist_tpu_torch.checkpoint.saved_model_builder import SavedModelBuilder
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.parallel import recovery
    from autodist_tpu_torch.serving.router import Router, RouterServer
    from autodist_tpu_torch.telemetry import reqtrace
    from autodist_tpu_torch.testing import sanitizer
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    card = card_line()
    for k in kernels:
        k.launches = 0
    cfg = tlm.TransformerLMConfig(**SERVE_MODEL, dtype=torch.bfloat16)
    model, params = tlm.init_params(cfg, seed=0, device=dev)
    V = cfg.vocab_size

    # (a) decode against the full forward; the LSTM's carry.
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(1, V, (2, 64), generator=gen).to(dev)
    with torch.no_grad():
        full = tlm.apply(model, params, toks).float()
        cache = tlm.init_cache(cfg, 2, dev)
        parts = [tlm.apply(model, params, toks[:, :48], decode=True, cache=cache)]
        parts += [tlm.apply(model, params, toks[:, i:i + 1], pos_offset=i, decode=True,
                            cache=cache) for i in range(48, 64)]
    dec = torch.cat(parts, 1).float()
    rel = float((dec - full).abs().max() / full.abs().max())
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    log(f"serving (a): d512 x 6 bf16, decode (prefill 48, then 16 steps) against the full "
        f"forward: max |diff| {rel:.3g} of max |logit| (tolerance {SERVE_LOGIT_RTOL}), "
        f"argmax agreement {agree:.4f}; card {card}")
    if not rel <= SERVE_LOGIT_RTOL:
        raise AssertionError(f"serving: decode logits differ from the full forward by {rel}")
    serving_lstm(dev)
    free_card()

    # (b) the dense engine: greedy served equals generate, alone and in company.
    mix, long, prefix = serve_requests(V)
    t0 = time.perf_counter()
    refs = {s: tuple(tlm.generate(model, params, torch.tensor(p[None]), n).cpu().numpy()[0])
            for p, n, s in mix + long + prefix}
    gen_s = time.perf_counter() - t0
    dense_cfg = serving.ServeConfig(max_batch=SERVE_SLOTS)
    dense = serving.LMEngine(model, params, dense_cfg)
    alone = [serve_drive(dense, dense_cfg, [r])[0][0] for r in mix[:4] + long[:2]]
    check_tokens("serving (b) batch-1 served against generate",
                 alone, [refs[s] for _, _, s in mix[:4] + long[:2]])
    t0 = time.perf_counter()
    together, dense_peak = serve_drive(dense, dense_cfg, mix + long)
    run_s = time.perf_counter() - t0
    check_tokens(f"serving (b) the mix and the long prompts together in {SERVE_SLOTS} slots "
                 f"({run_s:.1f} s; generate alone {gen_s:.1f} s for all)",
                 together, [refs[s] for _, _, s in mix + long])
    sampled_cfg = serving.ServeConfig(max_batch=SERVE_SLOTS, temperature=0.8, top_k=40)
    sampled = serving.LMEngine(model, params, sampled_cfg)
    picks = mix[:3] + long[:1]
    got = [serve_drive(sampled, sampled_cfg, [r])[0][0] for r in picks]
    want = [tuple(tlm.generate(model, params, torch.tensor(p[None]), n, temperature=0.8,
                               top_k=40, rng=s).cpu().numpy()[0]) for p, n, s in picks]
    check_tokens("serving (b) sampled (0.8, top-k 40) batch-1 served against generate",
                 got, want)
    del sampled

    # (c) the paged engine at the dense engine's KV bytes.
    paged_cfg = serving.ServeConfig(max_batch=SERVE_SLOTS, page_len=SERVE_PAGE)
    paged = serving.PagedLMEngine(model, params, paged_cfg)
    hits0 = serving_counter("serve.kv.prefix_hits")
    dense_prefix, _ = serve_drive(dense, dense_cfg, prefix)
    t0 = time.perf_counter()
    paged_tokens, paged_peak = serve_drive(paged, paged_cfg, mix + long + prefix)
    paged_s = time.perf_counter() - t0
    check_tokens("serving (c) paged against dense, greedy", paged_tokens,
                 together + dense_prefix)
    hits = serving_counter("serve.kv.prefix_hits") - hits0
    sampled_dense = serving.LMEngine(model, params, sampled_cfg)
    sampled_paged = serving.PagedLMEngine(
        model, params, dataclasses.replace(sampled_cfg, page_len=SERVE_PAGE))
    picks = mix[:8] + prefix
    check_tokens("serving (c) paged against dense, sampled",
                 serve_drive(sampled_paged, sampled_paged.config, picks)[0],
                 serve_drive(sampled_dense, sampled_cfg, picks)[0])
    del sampled_dense, sampled_paged
    free_pages = torch.tensor(paged._alloc._free, dtype=torch.long, device=dev)
    for leaf in paged._pool.values():
        leaf[free_pages] = 53.0
    check_tokens("serving (c) paged after every free page was poisoned with 53.0",
                 serve_drive(paged, paged_cfg, mix[:4] + prefix[:2])[0],
                 [refs[s] for _, _, s in mix[:4] + prefix[:2]])
    # Short requests: pages admit more of them at once than the dense slots do.
    shorts = [(np.resize(mix[i % len(mix)][0], 12), 12, 300 + i) for i in range(SERVE_SHORT)]
    _, dense_short_peak = serve_drive(dense, dense_cfg, shorts)
    _, paged_short_peak = serve_drive(paged, paged_cfg, shorts)
    log(f"serving (c): page_len {SERVE_PAGE}, {paged.capacity} usable pages; KV bytes dense "
        f"{dense.kv_bytes()}, paged {paged.kv_bytes()} (the scratch page more); prefix hits "
        f"{hits}; the mix's peak concurrency dense {dense_peak}, paged {paged_peak}; short "
        f"requests (12 + 12 tokens) dense {dense_short_peak}, paged {paged_short_peak}: "
        f"concurrency ratio {paged_short_peak / max(1, dense_short_peak):.3f} at equal KV "
        f"bytes; paged run {paged_s:.1f} s; step shapes run {paged.compiled_programs()} "
        f"(prefill, all)")
    if hits < 1:
        raise AssertionError("serving: the prefix cache was never hit")

    # (d) speed, not judged.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch in SERVE_DECODE_BATCHES:
        eng_cfg = serving.ServeConfig(max_batch=batch)
        eng = serving.LMEngine(model, params, eng_cfg)
        for slot in range(batch):
            eng.admit(slot, mix[slot % len(mix)][0], None)
        eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_TIMED_STEPS):
            eng.step()
        step_ms = 1e3 * (time.perf_counter() - t0) / SERVE_TIMED_STEPS
        line = (f"serving (d): decode step at B={batch}: {step_ms:.3f} ms "
                f"({batch / step_ms * 1e3:.1f} tokens/s), KV bytes {eng.kv_bytes()}")
        if batch == SERVE_SLOTS:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(5):
                    eng.step()
                wall = time.perf_counter() - t0
            kern = device_kernels(prof)
            if kern:
                line += (f"; profiler window of 5 steps: {len(kern) // 5} kernels a step, "
                         f"device busy {busy_us(kern) / 5 / 1e3:.3f} ms a step, idle share "
                         f"{1 - busy_us(kern) / 1e6 / wall:.3f}")
            else:
                line += "; the profiler recorded no device time: busy and idle not measured"
            prefill = {}
            for b in eng.buckets:
                p = np.resize(long[0][0], b)
                eng.free(0)
                eng.admit(0, p[:b], None)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    eng.free(0)
                    eng.admit(0, p[:b], None)
                prefill[b] = round(1e3 * (time.perf_counter() - t0) / 3, 3)
            line += f"; prefill ms a bucket {prefill}"
        log(line)
        del eng
    log(f"serving (d): max_memory_allocated {torch.cuda.max_memory_allocated()} bytes over the "
        f"decode timings; card {card}")
    for mode in ("continuous", "static"):
        rps, phases, errors = serve_load(
            dataclasses.replace(dense_cfg, mode=mode), model, params, mix)
        log(f"serving (d): InferenceServer, {mode}, {SERVE_CLIENTS} clients, {len(mix)} "
            f"requests: {rps:.2f} requests/s; p50/p99 ms "
            + ", ".join(f"{ph} {a:.2f}/{b:.2f}" for ph, (a, b) in phases.items())
            + f"; errors {errors[:2]}")
        if errors:
            raise AssertionError(f"serving: {mode} server rejected requests: {errors[:3]}")

    # (e) the fleet: two replicas on the one card, one killed mid-flight.
    recovery.reset()
    Router.RESPAWN_BACKOFF_S = 0.05

    def replica():
        rcfg = serving.ServeConfig(max_batch=4)
        return serving.InferenceServer(
            serving.Batcher(serving.LMEngine(model, params, rcfg), rcfg))

    reqtrace.clear()
    reqtrace.enable()        # for phase 22's adtrace
    router = Router(replica, n_replicas=2, start=False)
    front = RouterServer(router)
    fleet = mix[:SERVE_FLEET_REQUESTS]
    results, errors, lock = {}, [], threading.Lock()
    fleet_tools = {}
    try:
        victim = router.replicas()[0]

        def killer():
            deadline = time.monotonic() + 120.0
            while victim.load() == 0 and time.monotonic() < deadline:
                time.sleep(0.001)
            victim.server.kill()

        def client(w):
            c = serving.ServeClient(front.address)
            try:
                for p, n, s in fleet[w::SERVE_CLIENTS]:
                    try:
                        toks_, _ = c.generate(p, n, seed=s)
                        with lock:
                            results[s] = tuple(toks_)
                    except Exception as e:   # noqa: BLE001 - counted as a client failure
                        with lock:
                            errors.append(repr(e))
            finally:
                c.close()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=killer)] + [
            threading.Thread(target=client, args=(w,)) for w in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        fleet_s = time.perf_counter() - t0
        counts = recovery.recovery_snapshot()["counts"]
        replayed = serving_counter("serve.router.replayed")
        # Phase 22's fleet readings, while the fleet is up: the consoles
        # over the router and its live replicas, the traces through the router.
        t0 = time.perf_counter()
        front_addr = "%s:%d" % tuple(front.address)
        live = [r["replica"] for r in front.status_snapshot()["replicas"] if not r.get("down")]
        # A short deadline: the router's table still lists the killed replica.
        fleet_tools = {"adfleet": tool_proc("adfleet", front_addr, *live, "--once", "--raw",
                                            "--timeout", "1"),
                       "adtrace": tool_proc("adtrace", front_addr, "--top", "3",
                                            "--timeout", "1")}
        TOOLS["adfleet"] = json.loads(tool_result("adfleet", fleet_tools["adfleet"]))
        TOOLS["adtrace"] = tool_result("adtrace", fleet_tools["adtrace"])
        TOOLS["fleet"] = {"router": front_addr, "replicas": live, "served": len(results)}
        log(f"serving (e): adfleet and adtrace read the fleet in "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        stop(fleet_tools.values())
        reqtrace.disable()
        front.close()
    log(f"serving (e): RouterServer over 2 replicas, replica 0 killed in flight: "
        f"{len(results)}/{len(fleet)} completed in {fleet_s:.1f} s, client failures "
        f"{len(errors)}, replayed {replayed}, recovery {counts}")
    if errors or len(results) != len(fleet) or counts.get("respawns", 0) < 1:
        raise AssertionError(f"serving: the fleet lost requests or did not respawn: "
                             f"{errors[:3]}, {counts}")
    check_tokens("serving (e) the fleet's tokens against generate",
                 [results[s] for _, _, s in fleet], [refs[s] for _, _, s in fleet])

    # (f) the export.
    export_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                              "serving_export")
    xt = torch.randint(1, V, (2, 64), generator=gen).to(dev)

    def apply_fn(p, tokens):
        return tlm.apply(model, p, tokens)

    t0 = time.perf_counter()
    SavedModelBuilder(export_dir).save(params, {"family": "transformer_lm", **SERVE_MODEL},
                                       apply_fn=apply_fn, example_args=(xt,))
    export_s = time.perf_counter() - t0
    serve_fn = SavedModelBuilder.load_serving_fn(export_dir, device=dev)
    with torch.no_grad():
        want = apply_fn(params, xt).float()
    got = serve_fn(SavedModelBuilder.load_params(export_dir, device=dev), xt).float()
    rel = float((got - want).abs().max() / want.abs().max())
    nbytes = {f: os.path.getsize(os.path.join(export_dir, f)) for f in sorted(os.listdir(export_dir))}
    other = "cpu" if dev.type == "cuda" else "cuda"
    try:
        SavedModelBuilder.load_serving_fn(export_dir, device=other)
        refused = False
    except ValueError as e:
        refused = repr(dev.type) in str(e)
    log(f"serving (f): export in {export_s:.1f} s; the loaded graph against the eager apply: "
        f"max |diff| {rel:.3g} of max |logit| (tolerance {SERVE_LOGIT_RTOL}); a load for "
        f"{other} refused, naming {dev.type}: {refused}; artifact bytes {nbytes}")
    if not rel <= SERVE_LOGIT_RTOL or not refused:
        raise AssertionError(f"serving: the export differs ({rel}) or served another device")

    # (g) the example in its own process.
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "autodist_tpu_torch.examples.serve_lm"]
                          + SERVE_EXAMPLE_ARGS, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    summary = [l for l in proc.stdout.splitlines()
               if "requests ok" in l or l.strip().startswith(("queue", "prefill", "decode",
                                                              "total", "server:"))]
    log(f"serving (g): serve_lm {' '.join(SERVE_EXAMPLE_ARGS)} in {time.perf_counter() - t0:.1f}"
        f" s, exit {proc.returncode}: " + " | ".join(l.strip() for l in summary))
    ok = re.search(r"(\d+)/(\d+) requests ok", proc.stdout)
    if proc.returncode != 0 or not ok or ok.group(1) != ok.group(2):
        raise AssertionError(f"serving: serve_lm failed: {proc.stderr[-2000:]}")
    launches = {k.__name__: k.launches for k in kernels}

    # (h) the lock sanitizer armed for a short leg: its export is phase 22's
    # crosscheck input.
    t0 = time.perf_counter()
    with sanitizer.armed("locks"):
        scfg = serving.ServeConfig(max_batch=4)
        server = serving.InferenceServer(
            serving.Batcher(serving.LMEngine(model, params, scfg), scfg))
        try:
            client = serving.ServeClient(server.address)
            try:
                for p, n, s in mix[:SAN_REQUESTS]:
                    client.generate(p, n, seed=s)
            finally:
                client.close()
        finally:
            server.close()
        sanitizer.dump_observed(os.path.join(TOOLS_DIR, "observed_locks.jsonl"))
        edges = sanitizer.observed_edges()
    log(f"serving (h): {SAN_REQUESTS} requests through an InferenceServer with the lock "
        f"sanitizer armed in {time.perf_counter() - t0:.1f} s: {len(edges)} lock-order "
        f"edges observed, no violation")
    log(f"serving: phase 21 in {time.perf_counter() - t_phase:.1f} s; port kernel launches "
        f"{launches}")
    return launches


# ------------------------------------------------------ head width 128 (phase 23)

def check_flash_hd128(fa, dev):
    """Phases 5a and 7a at head width 128: the forward, the one-pass
    backward (``flash_bwd``), the row term and the carry against their plain
    versions on the same inputs, tile by tile: the long-context shape [8,
    8,192, 8, 128] causal, a ragged L = 1,000 causal and not, ring offsets
    ((1,024, 0); (0, 300) whose blind dq rows and unseen dk/dv keys must be
    exactly 0, with f32 outputs), the hd-128 tiling's edges (L = 50, 65, 127,
    129: one off a 64-row tile and a 128-key block, and a block whose second
    consumer holds no key), every backward twice, bit for bit (its dQ sums
    over key blocks in a fixed order); and the carry: no carry in at the
    path shape and ragged, a carry in (q_offset 2,048 at L = 2,048), and rows
    0-99 that see no key carried through bit for bit. Returns max abs errors
    by the hd-128 names."""
    hd = 128
    gen = torch.Generator().manual_seed(12)
    errs = {width(n, hd): 0.0 for n in ("flash_fwd", "flash_bwd", "flash_fwd_carry")}
    cases = [(LC_BATCH, LC_SEQ, LC_SEQ, True, 0, 0, None),
             (2, 1000, 1000, True, 0, 0, None),
             (2, 1000, 1000, False, 0, 0, None),
             (2, 1000, 1000, True, 1024, 0, None),
             (2, 1000, 1000, True, 0, 300, torch.float32)]
    cases += [(2, n, n, causal, 0, 0, None) for n in (50, 65, 127, 129)
              for causal in (True, False)]
    for b, lq, lk, causal, qo, ko, out_dtype in cases:
        q, k, v, do = flash_inputs(b, lq, lk, gen, dev, hd)
        out, lse = fa.flash_fwd(q, k, v, causal, qo, ko)
        dd = fa.prepare_backward_q_side(out, do)
        grads = fa.flash_bwd(q, k, v, do, lse, dd, causal, qo, ko, out_dtype)
        again = fa.flash_bwd(q, k, v, do, lse, dd, causal, qo, ko, out_dtype)
        torch.cuda.synchronize()
        same = all(torch.equal(g, a) for g, a in zip(grads, again))
        ref_out, ref_lse = fa.flash_forward_plain(q, k, v, causal, qo, ko)
        ref = fa.flash_backward_plain(q, k, v, do, lse, dd, causal, qo, ko, out_dtype)
        e_lse = (lse - ref_lse).abs().max().item()
        e_dd = compare(dd, fa.backward_q_side_plain(out, do), 1)
        e = {name: compare(got, want, 1)
             for name, got, want in (("out", out, ref_out), ("dq", grads[0], ref[0]),
                                     ("dk", grads[1], ref[1]), ("dv", grads[2], ref[2]))}
        log(f"check flash hd=128 b={b} lq={lq} lk={lk} causal={causal} offsets=({qo}, {ko}) "
            f"out_dtype={out_dtype}: lse {e_lse:.3g}; row term {describe(e_dd)}; "
            + "; ".join(f"{n} {describe(c)}" for n, c in e.items())
            + f"; two backward calls bit-equal: {same}")
        ok = (math.isfinite(e_lse) and e_lse <= FLASH_LSE_ATOL and e_dd[2] <= DD_RTOL
              and all(c[2] <= TILE_RTOL for c in e.values()) and same
              and (out_dtype is None or all(g.dtype == out_dtype for g in grads)))
        blind = min(lq, max(0, ko - qo)) if causal else 0
        unseen = min(lk, max(0, qo - ko + lq)) if causal else lk
        if blind or unseen < lk:
            ok = ok and not (grads[0][:, :blind].any() or grads[1][:, unseen:].any()
                             or grads[2][:, unseen:].any())
        if not ok:
            raise AssertionError(f"flash hd-128 kernel disagrees with its plain version at "
                                 f"b={b} lq={lq} causal={causal} offsets=({qo}, {ko})")
        errs["flash_fwd_hd128"] = max(errs["flash_fwd_hd128"], e["out"][0], e_lse)
        errs["flash_bwd_hd128"] = max(errs["flash_bwd_hd128"], e["dq"][0], e["dk"][0],
                                      e["dv"][0])
        del q, k, v, do, out, lse, dd, grads, again, ref_out, ref_lse, ref
    q, k, v, _ = flash_inputs(2, 1000, 1000, gen, dev, hd)
    diag = fa.flash_forward_carry_plain(q, k, v, None, True, 1024, 1024)
    qs, ks, vs, _ = flash_inputs(LC_BATCH, LC_SEQ // RING_SHARDS, LC_SEQ // RING_SHARDS, gen,
                                 dev, hd)
    cin = fa.flash_forward_carry_plain(qs, ks, vs, None, True, LC_SEQ // RING_SHARDS,
                                       LC_SEQ // RING_SHARDS)
    qp, kp, vp, _ = flash_inputs(LC_BATCH, LC_SEQ, LC_SEQ, gen, dev, hd)
    carry_cases = [("path shape, no carry", qp, kp, vp, None, 0, 0),
                   ("ragged, no carry", q, k, v, None, 0, 0),
                   ("carry in", qs, ks, vs, cin, LC_SEQ // RING_SHARDS, 0),
                   ("rows 0-99 see no key, carry in", q, k, v, diag, 0, 100)]
    for label, q_, k_, v_, c_in, qo, ko in carry_cases:
        e_acc, e_l, e_m, got = carry_case(fa, q_, k_, v_, c_in, qo, ko)
        log(f"check flash carry hd=128 {label} b={q_.shape[0]} L={q_.shape[1]} offsets=({qo}, "
            f"{ko}): acc {describe(e_acc)}; l {describe(e_l)}; m {e_m:.3g}")
        ok = (e_acc[2] <= TILE_RTOL and e_l[2] <= TILE_RTOL and math.isfinite(e_m)
              and e_m <= FLASH_LSE_ATOL)
        blind = ko - qo if c_in is not None else 0
        if blind > 0:
            ok = ok and all(torch.equal(g[:, :, :blind], c[:, :, :blind])
                            for g, c in zip(got, c_in))
        if not ok:
            raise AssertionError(f"carry hd-128 kernel disagrees with its plain version: {label}")
        errs["flash_fwd_carry_hd128"] = max(errs["flash_fwd_carry_hd128"], e_acc[0], e_l[0], e_m)
    return errs


def long_context_128_path(kernels, dev):
    """Phase 23: the long-context entry point at ``--d_model 1024`` (8 heads
    of 128, d_ff 4,096, vocab 32,000, seq 8,192, 6 layers, flash, every block
    rematerialized, the fused head at D = 1,024, bf16 activations, f32
    params, Adam 1e-3), 8 sequences a step: LC128_COUNTED counted steps
    (the hd-128 forward and the one-pass backward must launch, the backward
    6 times a step, one a layer, and no other flash kernel), its tokens/s
    and MFU over LC_STEADY steady steps with peak memory, and a profiler
    window over LC_PROFILE steps. Then phase 8's ring of one card at the same
    width: LC128_COUNTED counted steps, which must launch the hd-128 carry
    and the one-pass backward (f32 parts, 6 a step) and no other flash
    kernel.
    Then phase 7b's 4-shard ring replay at hd 128, a check only. Returns
    ``(flash launches, ring launches, the replay's worst error)``."""
    from autodist_tpu_torch.examples import long_context_lm as lc
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.utils.flops import mfu, transformer_flops_per_token

    t0 = time.perf_counter()
    argv = ["--d_model", str(LC128_D), "--seq_len", str(LC_SEQ), "--batch_size",
            str(LC_BATCH), "--device", str(dev)]
    cfg, step, batch = lc.build(lc.parse_args(argv))
    log(f"long context hd 128: {cfg}; built in {time.perf_counter() - t0:.1f} s")
    if cfg.d_model // cfg.n_heads != 128:
        raise AssertionError(f"long context hd 128: head width {cfg.d_model // cfg.n_heads}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches = counted_steps(step, [batch] * LC128_COUNTED, kernels)
    log(f"long context hd 128: losses {losses}; step seconds {times}; kernel launches "
        f"{launches}")
    wrong = [n for n in ("flash_fwd_hd128", "prepare_backward_q_side") if launches[n] == 0]
    wrong += [n for n in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq", "flash_fwd_carry",
                          "flash_fwd_carry_hd128") if launches[n]]
    wrong += [] if launches["flash_bwd_hd128"] == 6 * LC128_COUNTED else ["flash_bwd_hd128"]
    if wrong:
        raise AssertionError(f"long context hd 128: launches wrong for {wrong}: {launches}")
    tokens = LC_BATCH * LC_SEQ
    float(step(batch))
    t1 = time.perf_counter()
    for _ in range(LC_STEADY):
        loss = step(batch)
    float(loss)
    rate = tokens * LC_STEADY / (time.perf_counter() - t1)
    flops = transformer_flops_per_token(cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab_size,
                                        LC_SEQ) * tokens
    log(f"long context hd 128: {rate:.1f} tokens/s over {LC_STEADY} steady steps ({tokens} "
        f"tokens/step, {1e3 * tokens / rate:.3f} ms/step), MFU "
        f"{mfu(flops * rate / tokens):.4f} of 989 TFLOP/s (full score matrix counted); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; card {card_line()}")
    profile_steps(step, [batch] * LC_PROFILE, label="long-context hd 128 profile")
    del step, batch
    free_card()

    _, step, batch = ring_session(dev, cfg.d_model, cfg.d_ff)
    torch.cuda.reset_peak_memory_stats()
    losses, times, ring = counted_steps(step, [batch] * LC128_COUNTED, kernels)
    log(f"ring of one card at hd 128: losses {losses}; step seconds {times} ({tokens} "
        f"tokens/step); kernel launches {ring}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    wrong = [n for n in ("flash_fwd_carry_hd128", "prepare_backward_q_side") if ring[n] == 0]
    wrong += [n for n in ("flash_fwd_hd128", "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                          "flash_fwd_carry") if ring[n]]
    wrong += [] if ring["flash_bwd_hd128"] == 6 * LC128_COUNTED else ["flash_bwd_hd128"]
    if wrong:
        raise AssertionError(f"ring of one card at hd 128: launches wrong for {wrong}: {ring}")
    del step, batch
    free_card()
    return launches, ring, check_ring_replay(fa, dev, hd=128)


# ---------------------------------------------- the port's optimizers (phase 24)

def plain_adafactor_update(p, g, lr):
    """The first update of ``optax.adafactor(lr)`` (its count 0: decay 0,
    so the second moment is the squared gradient plus 1e-30), written out
    from optax's definitions in float64, independent of the port's module:
    factored over the two largest dims when the smaller is at least 128,
    clipped to block RMS 1, scaled by lr and the parameter's RMS (at least
    1e-3). Returns what optax subtracts from ``p``."""
    p, g = p.double(), g.double()
    gs = g * g + 1e-30
    shape = tuple(p.shape)
    order = sorted(range(len(shape)), key=lambda i: (shape[i], i))
    if len(shape) >= 2 and shape[order[-2]] >= 128:
        d1, d0 = order[-2], order[-1]
        vr, vc = gs.mean(d0), gs.mean(d1)
        rcm = vr.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
        u = g * (vr / rcm).rsqrt().unsqueeze(d0) * vc.rsqrt().unsqueeze(d1)
    else:
        u = g * gs.rsqrt()
    u = u / torch.clamp_min(u.square().mean().sqrt(), 1.0)
    return u * lr * torch.clamp_min(p.square().mean().sqrt(), 1e-3)


def same_state(a, b) -> bool:
    """Params and every optimizer state tensor of two TrainStates, bit for bit."""
    if not same_params(a.params, b.params):
        return False
    for key, p in a.opt_params.items():
        sa, sb = a.optimizer.state[p], b.optimizer.state[b.opt_params[key]]
        if sa.keys() != sb.keys() or not all(
                torch.equal(v, sb[f]) for f, v in sa.items() if isinstance(v, torch.Tensor)):
            return False
    return True


def optimizers_path(kernels, dev):
    """Phase 24: the port's optimizers on the card. (a) The flagship at full
    width (phase 4's shape, 32 x 256, no accumulation) under
    ``choose_optimizer``'s factored choice, forced by a 1 MiB budget (the
    port's Adafactor, optax.adafactor): ``run_many(2)`` against ``run()``
    bit for bit (phase 16's comparison). (b) NCF at 65,536 (its tables
    [138,000, 64] unfactored, [138,000, 128] factored) one step under the
    port's Adafactor against the plain float64 update of the same gradients
    (within 1e-5 of the update's largest magnitude, beyond half an f32 ulp
    of each stored parameter). (c) Save and restore on the card, v1 and v2,
    into the same runner, bit for bit: (b)'s Adafactor state, NCF one step
    under SGD with momentum 0.9 (optax.sgd's trace), and bf16 tensors in v1
    (the NCF tables cast)."""
    from autodist_tpu_torch import AllReduce, AutoDist
    from autodist_tpu_torch.checkpoint.saver import Saver
    from autodist_tpu_torch.models import ncf
    from autodist_tpu_torch.models import transformer_lm as tlm
    from autodist_tpu_torch.optimizers import Adafactor
    from autodist_tpu_torch.strategy import choose_optimizer

    for k in kernels:
        k.launches = 0
    UNROLL_LAUNCHES.clear()
    one_card = {"nodes": [{"address": "localhost", "gpus": [0]}]}
    t0 = time.perf_counter()
    cfg = tlm.TransformerLMConfig(vocab_size=V, d_model=D, n_heads=8, n_layers=6, d_ff=2048,
                                  max_len=512, fused_head=True, tied_output=False,
                                  dtype=torch.bfloat16)
    model, params = tlm.init_params(cfg, seed=0, device=dev)
    choice = choose_optimizer(params, learning_rate=1e-3, memory_budget_bytes=1 << 20)
    if not (choice.factored and isinstance(choice.optimizer([torch.zeros(1, device=dev,
                                                                        requires_grad=True)]),
                                           Adafactor)):
        raise AssertionError(f"choose_optimizer's factored choice is not the port's Adafactor: "
                             f"{choice}")
    batches = [tlm.synthetic_batch(cfg, 32, 256, seed=7000 + i) for i in range(6)]

    def build():
        ad = AutoDist(resource_info=one_card, strategy_builder=AllReduce(), device=dev)
        return ad.function(tlm.make_loss_fn(model), params, choice.optimizer,
                           example_batch=batches[0])

    same, per_step, per_replay, _ = fused_against_steps(build, batches, kernels,
                                                        "flagship 32 x 256 under Adafactor")
    if not same or any(per_replay[n] != 2 * per_step[n] for n in per_step):
        raise AssertionError("optimizers: run_many(2) under Adafactor is not two run() steps")
    del model, params
    free_card()
    log(f"optimizers (a) in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ncfg = ncf.NeuMFConfig()
    model, params = ncf.init_params(ncfg, seed=0, device=dev)
    host = ncf.synthetic_batch(ncfg, 65536, seed=8)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
    loss_fn = ncf.make_loss_fn(model)

    def session(optimizer):
        ad = AutoDist(resource_info=one_card, strategy_builder=AllReduce(), device=dev)
        runner = ad.create_distributed_session(loss_fn, params, optimizer, example_batch=host)
        return runner, runner.init(params)

    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    grads = dict(zip(leaves, torch.autograd.grad(loss_fn(leaves, batch), list(leaves.values()))))
    runner, state = session(lambda p: Adafactor(p, lr=1e-3))
    before = {k: v.detach().clone() for k, v in state.params.items()}
    runner.run(state, host)
    torch.cuda.synchronize()
    worst = 0.0
    for key, p0 in before.items():
        want = plain_adafactor_update(p0, grads[key], 1e-3)
        got = p0.double() - state.params[key].detach().double()
        slack = p0.abs().double() * 2.0 ** -24
        err = ((got - want).abs() - slack).clamp_min(0).max().item() / want.abs().max().item()
        worst = max(worst, err)
        log(f"optimizers (b): ncf {key} {tuple(p0.shape)}: update within {err:.3g} of the plain "
            f"float64 update's largest magnitude {want.abs().max().item():.4g}")
    if not worst <= 1e-5:
        raise AssertionError(f"optimizers: NCF's Adafactor step is {worst:.3g} off the plain update")
    log(f"optimizers (b) in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ckpt = os.path.join(ROOT, "build", "chip_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    results = {}
    sgd_runner, sgd_state = session(lambda p: torch.optim.SGD(p, lr=0.01, momentum=0.9))
    sgd_runner.run(sgd_state, host)
    for label, r, st in (("adafactor", runner, state), ("sgd momentum", sgd_runner, sgd_state)):
        for sharded in (False, True):
            prefix = Saver().save(st, os.path.join(ckpt, label.replace(" ", "_")),
                                  sharded=sharded)
            results[f"{label} {'v2' if sharded else 'v1'}"] = same_state(
                Saver().restore(prefix, runner=r), st)
    tables = {k: v.detach().to(torch.bfloat16) for k, v in params.items() if "embed" in k}
    back = Saver().restore_params(Saver().save(tables, os.path.join(ckpt, "bf16"),
                                               sharded=False))
    results["bf16 v1"] = all(back[k].dtype == torch.bfloat16 and torch.equal(back[k].to(dev), t)
                             for k, t in tables.items())
    log(f"optimizers (c): save and restore on the card, bit for bit: {results} in "
        f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(ckpt, ignore_errors=True)
    if not all(results.values()):
        raise AssertionError(f"optimizers: a checkpoint round trip differs: {results}")
    del runner, state, sgd_runner, sgd_state, model, params, leaves, grads
    free_card()
    bank(kernels)
    return {k.__name__: UNROLL_LAUNCHES[k.__name__] for k in kernels}


def tools_path():
    """Phase 22: the operator tools on what phases 20 and 21 wrote and read.
    Starts no model; every tool is a ``python -m`` process that must exit 0."""
    t0 = time.perf_counter()
    profile = os.path.join(TOOLS_DIR, "profile.json")
    trace = os.path.join(TOOLS_DIR, "tracedump.json")
    observed = os.path.join(TOOLS_DIR, "observed_locks.jsonl")
    spans = [os.path.join(TOOLS_DIR, f) for f in ("spans_chief.jsonl", "spans_worker.jsonl")]
    procs = {"adprof": tool_proc("adprof", profile),
             "adprof self-diff": tool_proc("adprof", profile, profile),
             "tracedump": tool_proc("tracedump", trace, *spans),
             "graftlint --crosscheck": tool_proc("graftlint", "--crosscheck", "--observed",
                                                 observed)}
    try:
        out = {name: tool_result(name, proc) for name, proc in procs.items()}
    finally:
        stop(procs.values())
    for line in out["adprof"].splitlines():
        log(f"tools: adprof: {line}")
    for line in out["adprof self-diff"].splitlines():
        log(f"tools: adprof self-diff: {line}")
    with open(trace) as f:
        lanes = {e["pid"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    log(f"tools: tracedump: {out['tracedump'].strip()}; span lanes {sorted(lanes)}")
    with open(observed) as f:
        edges = [json.loads(line) for line in f if '"outer"' in line]
    for e in edges:
        log(f"tools: observed edge {e['outer']['path']}:{e['outer']['name']} -> "
            f"{e['inner']['path']}:{e['inner']['name']} x{e['count']}")
    for line in out["graftlint --crosscheck"].splitlines():
        log(f"tools: graftlint: {line}")
    status = TOOLS["adtop"]
    log(f"tools: adtop read phase 20 (g)'s PS server: kind {status.get('kind')}, staleness "
        f"bound {status.get('staleness_bound')}, workers {sorted(status.get('per_worker') or {})}")
    fleet, polled = TOOLS["fleet"], TOOLS["adfleet"]
    routed = (polled.get(fleet["router"], {}).get("registry") or {}).get("serve.router.routed")
    log(f"tools: adfleet read phase 21 (e)'s router and replicas {fleet['replicas']}: kinds "
        f"{ {a: s.get('kind') for a, s in polled.items()} }, routed {routed}")
    head = TOOLS["adtrace"].splitlines()
    for line in head[:12]:
        log(f"tools: adtrace: {line}")
    completed = re.search(r"(\d+) completed request", head[0] if head else "")
    log(f"tools: phase 22 in {time.perf_counter() - t0:.1f} s; card {card_line()}")
    if not out["adprof"].startswith("profile") \
            or "no regression beyond" not in out["adprof self-diff"]:
        raise AssertionError("tools: adprof did not summarize or did not self-diff clean")
    if len(lanes) != 2:
        raise AssertionError(f"tools: tracedump's trace has span lanes {lanes}, want 2")
    if " 0 dynamic finding(s)" not in out["graftlint --crosscheck"]:
        raise AssertionError("tools: the crosscheck found a dynamic lock-order finding")
    if status.get("kind") != "ps":
        raise AssertionError(f"tools: adtop read a {status.get('kind')!r} status")
    if any(polled.get(a, {}).get("kind") is None for a in [fleet["router"], *fleet["replicas"]]) \
            or not isinstance(routed, (int, float)) or routed < fleet["served"]:
        raise AssertionError(f"tools: adfleet's fleet {polled}")
    if not completed or int(completed.group(1)) != fleet["served"]:
        raise AssertionError(f"tools: adtrace counted {head[:1]}, the router served "
                             f"{fleet['served']}")


def serving_counter(name) -> int:
    from autodist_tpu_torch import telemetry
    v = telemetry.snapshot().get(name)
    return int(v) if isinstance(v, (int, float)) else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = argv[argv.index("--only") + 1] if "--only" in argv else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    if os.environ.get("AUTODIST_WORKER"):
        # Launched by phase 18's or 20's Coordinator: the worker half only, no result.
        if os.environ.get("CHIP_SMOKE_WORKER") == "telemetry":
            return telemetry_worker()
        return async_ps_worker()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    from autodist_tpu_torch.ops import _build
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.ops import fused_xent as fx

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: float32 matmuls run in full float32")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    dev = torch.device("cuda:0")

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    serialized, spilled = [], []
    for name in built:
        for line in ptxas_summary(_build.build_log(name)):
            log(f"ptxas {name}: {line}")
            if all(word in line for word in SERIALIZED_WGMMA):
                serialized.append(line)
            if line.startswith(NO_SPILL) and re.search(r"[1-9]\d* bytes spill", line):
                spilled.append(line)
    if serialized:
        raise AssertionError(f"ptxas serialized the wgmma of a kernel: {serialized}")
    if spilled:
        raise AssertionError(f"ptxas spilled in a kernel that must not: {spilled}")
    log("flash forward kernels: dynamic shared memory a block "
        + ", ".join(f"{fa._lib().flash_fwd_smem_bytes(hd)} bytes at hd {hd}"
                    for hd in fa.KERNEL_HEAD_DIMS))
    from autodist_tpu_torch.data import loader as data_loader
    t0 = time.perf_counter()
    if data_loader._build_native() is None:
        raise AssertionError("the native data loader (data/native/loader.cc) did not build")
    log(f"build: native data loader (g++) in {time.perf_counter() - t0:.1f} s")
    every = fx.KERNELS + fa.KERNELS + fa.KERNELS_HD128 + (fx.xent_pack_w,
                                                          fa.prepare_backward_q_side)
    if only == "tools":
        # Phases 20, 21 and 22 (the tools phase reads what the first two
        # left); no kernel line.
        for label, path in (("20 telemetry", telemetry_path), ("21 serving", serving_path)):
            t0 = time.perf_counter()
            log(f"{label}: launches {path(every, dev)}")
            log(f"phase time: {label} {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tools_path()
        log(f"phase time: 22 tools {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if only == "long_context_128":
        # Phase 23 with the hd-128 kernel checks and times of phases 5 and 7;
        # no kernel line.
        check_flash_hd128(fa, dev)
        time_flash(fa, dev, 128)
        time_carry(fa, dev, 128)
        log(f"long_context_128: launches {long_context_128_path(every, dev)[:2]}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if only in ("unroll", "moe_pipe", "async_ps", "lm_family", "telemetry", "serving",
                "optimizers"):
        # Phase 16, 17, 18, 19, 20 or 21 alone (a shorter call while it is worked on); no
        # kernel line.
        path = {"unroll": unroll_path, "moe_pipe": moe_pipe_path,
                "async_ps": async_ps_path, "lm_family": lm_family_path,
                "telemetry": telemetry_path, "serving": serving_path,
                "optimizers": optimizers_path}[only]
        log(f"{only}: launches {path(every, dev)}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    t_run = time.perf_counter()

    def timed(label, fn, *args):
        """``fn(*args)``, its seconds logged (where a shorter run must cut depth)."""
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase time: {label} {time.perf_counter() - t0:.1f} s "
            f"({time.perf_counter() - t_run:.1f} s since the checks began)")
        return out

    errs = timed("3a fused head checks", check_kernels, fx, dev)
    timing = timed("3b fused head times", time_kernels, fx, dev)
    errs.update(timed("5 flash checks", check_flash, fa, dev))
    timing.update(timed("5 flash times", time_flash, fa, dev))
    errs.update(timed("7 carry checks", check_carry, fa, dev))
    ring_err = timed("7 ring replay", check_ring_replay, fa, dev)
    errs["flash_fwd_carry"] = max(errs["flash_fwd_carry"], ring_err)
    timing.update(timed("7 carry times", time_carry, fa, dev))
    errs.update(timed("5 and 7 flash checks at hd 128", check_flash_hd128, fa, dev))
    timing.update(timed("5 flash times at hd 128", time_flash, fa, dev, 128))
    timing.update(timed("7 carry times at hd 128", time_carry, fa, dev, 128))
    # The pack (it runs in the forward's and dh's wrappers) and the flash
    # backward's row term are counted with them, but they replace no TPU
    # kernel and have no row in the JSON line.
    by_phase = {"flagship": timed("4 flagship", main_path, every, dev),
                "long_context": timed("6 long context", long_context_path, every, dev),
                "sequence_parallel": timed("8 sequence parallel", sequence_parallel_path,
                                           every, dev),
                "flagship_full": timed("9 flagship uncut", flagship_full_path, every, dev),
                "train": timed("10 train", train_path, every, dev),
                "strategies": timed("11 strategies", strategies_path, every, dev),
                "ulysses": timed("12 ulysses", ulysses_path, every, dev)}
    ulysses_err = timed("12 ulysses replay", check_ulysses_replay, fa, dev)
    errs["flash_fwd"] = max(errs["flash_fwd"], ulysses_err["flash_fwd"])
    errs["flash_bwd_dkdv"] = max(errs["flash_bwd_dkdv"], ulysses_err["flash_bwd_dkdv"])
    errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], ulysses_err["flash_bwd_dq"])
    timed("13 data plane", data_plane_path)
    by_phase["images"], image_results = timed("14 images", image_path, every, dev)
    by_phase["text"] = timed("15 text", text_path, every, dev,
                             image_results[("AllReduce", 128)]["images_per_sec"])
    by_phase["unroll"] = timed("16 unroll", unroll_path, every, dev)
    by_phase["moe"] = timed("17 moe and pipelines", moe_pipe_path, every, dev)
    by_phase["async_ps"] = timed("18 async ps", async_ps_path, every, dev)
    by_phase["lm_family"] = timed("19 lm family", lm_family_path, every, dev)
    by_phase["telemetry"] = timed("20 telemetry", telemetry_path, every, dev)
    by_phase["serving"] = timed("21 serving", serving_path, every, dev)
    timed("22 tools", tools_path)
    by_phase["long_context_128"], by_phase["sequence_parallel_128"], ring128_err = timed(
        "23 long context at hd 128", long_context_128_path, every, dev)
    errs["flash_fwd_carry_hd128"] = max(errs["flash_fwd_carry_hd128"], ring128_err)
    by_phase["optimizers"] = timed("24 optimizers", optimizers_path, every, dev)

    # Each kernel's main path: the flagship at its real shape for the fused
    # head, the long-context run for flash attention, the sequence-parallel
    # run for the carry. Keyed by the name in the JSON line, with the wrapper's name.
    sites = {
        "xent_fwd": ("xent_fwd", "fused_xent", "autodist_tpu/ops/fused_xent.py:192",
                     "flagship_full"),
        "xent_dh": ("xent_dh", "fused_xent", "autodist_tpu/ops/fused_xent.py:287",
                    "flagship_full"),
        "xent_dwdb": ("xent_dwdb", "fused_xent", "autodist_tpu/ops/fused_xent.py:305",
                      "flagship_full"),
        "flash_fwd": ("flash_fwd", "flash_attention",
                      "autodist_tpu/ops/flash_attention.py:144", "long_context"),
        "flash_bwd_dkdv": ("flash_bwd_dkdv", "flash_attention",
                           "autodist_tpu/ops/flash_attention.py:332", "long_context"),
        "flash_bwd_dq": ("flash_bwd_dq", "flash_attention",
                         "autodist_tpu/ops/flash_attention.py:355", "long_context"),
        "flash_carry": ("flash_fwd_carry", "flash_attention",
                        "autodist_tpu/ops/flash_attention.py:480", "sequence_parallel"),
        # The hd-128 instantiations: the long-context entry point at d_model
        # 1,024, the carry in the ring of one card at that width.
        "flash_fwd_hd128": ("flash_fwd_hd128", "flash_attention",
                            "autodist_tpu/ops/flash_attention.py:144", "long_context_128"),
        # At head width 128 one kernel replaces both backward Pallas kernels.
        "flash_bwd_hd128": ("flash_bwd_hd128", "flash_attention",
                            "autodist_tpu/ops/flash_attention.py:332 and :355",
                            "long_context_128"),
        "flash_carry_hd128": ("flash_fwd_carry_hd128", "flash_attention",
                              "autodist_tpu/ops/flash_attention.py:480",
                              "sequence_parallel_128"),
    }
    kernels = [{"name": name, "route": "cuda",
                "source": f"autodist_tpu_torch/ops/csrc/{src}.cu",
                "replaces": replaces, "launches": by_phase[phase][fn],
                "launches_by_phase": {p: counts[fn] for p, counts in by_phase.items()},
                "max_abs_err": errs[fn], "ms": timing[fn]["ms"],
                "plain_ms": timing[fn]["plain_ms"],
                "bound_ms": timing[fn]["bound"][0],
                "bound_by": timing[fn]["bound"][1],
                "library_ms": timing[fn]["library_ms"],
                "tflops": timing[fn]["tflops"], "bound_share": timing[fn]["bound_share"],
                **({"by_width": {label: {"d": r["d"], "ms": r["ms"], "bound_ms": r["bound"][0],
                                         "bound_by": r["bound"][1],
                                         "plain_ms": r.get("plain_ms"),
                                         "library_ms": r["library_ms"]}
                                 for label, r in timing[fn]["wide"].items()}}
                   if "wide" in timing[fn] else {})}
               for name, (fn, src, replaces, phase) in sites.items()]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
