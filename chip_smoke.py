#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``bluefog_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. ``device``   — the card (``nvidia-smi``), torch and CUDA versions.
2. ``build``    — builds the flash-attention kernels from ``csrc/`` with
   ``nvcc`` (``-Xptxas -v``: registers, shared memory, spills) and requires
   K1, K2 and K3 to spill no register and to keep their wgmma products
   asynchronous (ptxas reports no serialization).
3. ``kernel``   — each of K1 (forward), K2 (dq) and K3 (dk/dv) against its
   plain PyTorch twin on the same inputs, at the training path's shape
   (B=2, S=2048, H=16, D=128, bf16, causal, q/k/v strided slices of a fused
   QKV tensor), at ragged S=1000, non-causal, with the Llama-style LM's
   GQA operands (q contiguous, k and v contiguous fan-outs of 4 kv heads)
   and at its generate prefill (S=512, K1 alone), with kernel, twin and
   SDPA times (SDPA's forward and backward on the kernels' operands as
   strided ``(B, H, S, D)`` views, which ``library_ms`` reports, and as
   contiguous copies; each the median of 3 readings, with the backend that
   ran) and the least time the card could take (989 TFLOP/s bf16,
   3.35 TB/s); then checked only: S=100 (shorter than one 128-row tile),
   head dim 64 (causal, and ragged non-causal), MHA with RoPE's
   operands (q and k contiguous, v a slice), and the sequence-parallel
   paths' shapes: ``ring_train``'s hop 0 (B=4 shards, S=4,096, H=16,
   causal) and later hops (B=3, non-causal), with RoPE's operands, and
   ``ulysses_train``'s gathered sequence (B=4, S=16,384, H=4, causal, the
   strided views of its head scatter), ``pp_train``'s microbatch (B=1,
   S=2048, H=16), the twins run a few batch rows at a time; and timed,
   ``tp_train``'s head shards (``tp-heads``: B = tp x 2 = 4 rows of 8
   heads, S=2048, causal).  K2 also returns the
   backward's delta, held to the plain op ``flash_delta`` (``REL_TOL``), and
   K3 reads that delta, as on the training path; the timed cases time
   ``flash_delta`` too.  At the main shape K1-K3 run twice on the same
   inputs and must agree bit for bit: they use no atomics, so a difference
   is a race in their pipelines.  Each line carries the kernel's
   registers, shared memory and spill bytes.
   Matmuls run with TF32 off.  Each output is held to its twin twice:
   by its relative error ``||kernel - twin|| / ||twin||`` (``REL_TOL``),
   which sees an error spread thinly over many rows, and element by element
   by ``max |kernel - twin| / (|twin| + rms(twin))`` (``ELEM_TOL``), which
   sees an error confined to a few rows; the lse by its largest absolute
   error (``LSE_TOL``).
   Case ``vit`` (timed): ViT-S/16's shape, B=64, S=197, H=6, D=64,
   non-causal.
4. ``reference`` — a small TransformerLM on the card: logits and gradients
   through the kernels against the same model with dense attention, by
   relative error (logits, and each parameter's gradient).
5. ``resnet_reference`` — the port's ResNet-18 on the card at 64x64, batch
   4, against the same weights on the CPU in float32 (the zero-initialised
   last BN scale of each block set to 0.2, so that no branch is idle and
   every parameter has a gradient): on the card in float32 (TF32 off)
   the logits, every parameter's gradient and the BN running statistics
   after the train-mode forward, by relative error; in bfloat16 (the
   training dtype) the logits and the running statistics.  The bf16
   gradients are reported, not limited: at this init bf16 itself moves the
   early layers' gradients by tens of percent (PERF.md).
6. ``train``    — ``bluefog_tpu_torch.benchmark``: TransformerLM 24 layers,
   width 2048, 16 heads, seq 2048, batch 2, vocab 32000, SGD momentum 0,
   4 virtual ranks on the card, ATC over the dynamic one-peer topology,
   1 warmup + 3 timed steps.  Launch counts of K1-K3 must equal
   layers x ranks x steps.
6a. ``train_host_data`` — ``--host-data`` on the same trainer: each batch
   from host memory through ``data.prefetch_to_device`` (depth 2: a
   pinned copy and an async transfer a batch), 1 warmup + 2 timed steps;
   finite losses, K1-K3 launches layers x ranks x steps; the step ms
   beside the device-resident feed's.
6b. ``native_build``, ``observe_train`` — the native library (the window
   transport's service and the timeline writer) built with g++
   (``bluefog_tpu_torch/native``); then ``train``'s LM, 1 warmup + 2 timed
   steps, with all of the observability armed (``BLUEFOG_TIMELINE``, the
   step profile's synced sample every step, the consensus gauge every 2
   steps, ``--metrics-file``, the ``/metrics`` + ``/healthz`` endpoint on an
   ephemeral port): K1-K3 launches layers x ranks x steps, the losses bit
   for bit ``train``'s, the timeline strict JSON with one
   ENQUEUE/COMMUNICATE span pair a combine and its clock anchor, the
   ``record_function`` ranges of the spans in a ``profile_step.trace`` of
   one step, ``bf_comm_calls_total`` and ``bf_comm_rounds_total`` the
   schedule's rounds x steps, the step-phase histograms one sample a timed
   step, the consensus gauge finite and smaller after a combine than after
   the local update before it, one metrics line a timed step, ``/metrics``
   parsing and ``/healthz`` ``ok``.  Then the synchronizing calls of a step
   with telemetry on and off (``torch.cuda.set_sync_debug_mode``, equal),
   and an eager ``neighbor_allreduce`` on (4, 2^24) float32 with telemetry
   on and off, in turns, three readings each (``cuda_ms`` and host
   microseconds a call), beside its byte bound.  The host tools over the
   timeline: ``tools.trace_merge`` (one lane, strict JSON) and
   ``tools.trace_summary`` of the merged file (ENQUEUE and COMMUNICATE
   rows).
7. ``resnet50`` — the benchmark with ``--model resnet50`` at 224x224, batch
   64 per rank, 4 ranks, ATC over the dynamic topology, momentum 0.9,
   2 warmup + 3 timed steps: img/s, step ms, peak memory, the spread.
   Checks: finite losses, the step count, the combine shrinks the spread,
   the BN running statistics differ between ranks and lie outside
   ``flat``, and ``flat`` has 25,557,032 columns.
8. ``resnet50_compression`` — the same under ``bf16`` and ``sparse:0.25``,
   1 warmup + 2 timed steps each, with the same checks, but on the rms
   deviation: ``sparse`` combines a quarter of the columns, and the
   ``bf16`` combine's own rounding (up to half a bf16 ulp, 0.002 at 1.0)
   is larger than the first step's largest deviation (0.0012 on the card),
   so neither need shrink the largest one.
9. ``vit``      — ViT-S/16 at 224x224 through the kernels, batch 64, 4
   ranks, 1 warmup + 2 timed steps; K1-K3 launches must equal 12 layers x
   ranks x steps; and a 2-layer ViT's logits and gradients through the
   kernels against dense attention, as in ``reference``.
10. ``llama_reference`` — a 2-layer Llama-style LM (width 512, 8 heads of
   64, 2 kv heads, RoPE, SwiGLU) through the kernels: against dense
   attention, as in ``reference``; with remat ``full`` and ``dots`` against
   without (logits and gradients, the largest difference reported; K1 runs
   again in each block's recompute); and the chunked lm-head loss against
   dense cross-entropy at B=2, S=2048, E=2048, V=32000 in float32
   (``CE_VALUE_TOL``, ``CE_GRAD_TOL``).
11. ``llama_train`` — the benchmark with the Llama-style LM at full width:
   24 layers, width 2048, 16 heads, 4 kv heads, RoPE, SwiGLU, remat,
   chunked loss, seq 2048, batch 2, vocab 32000, 4 ranks, ATC over the
   dynamic topology, ``--mfu`` (989 TFLOP/s), 1 warmup + 2 timed steps.
   Checks: 1,590,790,144 parameters a rank, finite losses, the combine
   shrinks the spread, peak memory under 80 GB, K1 launches 2 x layers x
   ranks x steps (forward and recompute) and K2, K3 layers x ranks x steps.
12. ``generate`` — rank 0's module of ``llama_train`` (bf16, the prefill
   through K1) continues a 2 x 512-token prompt by 64 greedy tokens:
   prefill ms, decode ms a token; the prefill launches K1 once a layer; the
   first token is the argmax of the full forward's last logits; 16
   teacher-forced decode steps match the full forward (``REF_LOGITS_TOL``);
   the cache holds the 4 shared kv heads.
13. ``text_generation`` — ``python -m bluefog_tpu_torch.text_generation``
   on the card: 300 Adam steps, then the exact greedy continuation.
14. ``resnet50_gradient_allreduce`` — ``resnet50`` under ``--dist-optimizer
   gradient_allreduce`` (batch 64, 4 ranks, 2 warmup + 2 timed steps): the
   ranks' largest deviation must be exactly 0.0 after every step.
15. ``moe_reference`` — a 2-layer switch-MoE LM (width 256, 2 heads of 128,
   8 experts, routing groups of 256 tokens) through the kernels against
   dense attention: the share of routing decisions that differ (bf16 and
   flash-versus-dense move near-ties), the logits of each sequence's
   tokens before its first flip, which reaches every later token through
   the next block's attention (``REF_LOGITS_TOL``), the gradients
   reported; and one ``SwitchMlp`` in float32 on the card (TF32 off)
   against the same weights and input on the CPU: the same routing, then
   output, aux loss and gradients (``SWITCH_F32_TOL``).
16. ``moe_train`` — the benchmark with the switch-MoE LM at the 1.3B LM's
   width: 6 layers, width 2048, 16 heads, 8 GELU experts, full remat, seq
   2048, batch 2, vocab 32000, 4 ranks, ATC over the dynamic topology,
   ``--mfu`` (which prints the JAX benchmark's MoE note instead), 1 warmup
   + 2 timed steps.  Checks: 1,846,667,264 parameters a rank, finite
   losses, the combine shrinks the spread, peak memory under 80 GB, K1
   launches 2 x layers x ranks x steps and K2, K3 layers x ranks x steps;
   then ``profile_step.profile`` on one more step gives the device time of
   the routing plan and of the dispatch and combine einsums (forward,
   recompute and backward) and their share of the step.
17. ``ring_reference`` — a 2-layer LM (width 512, 4 heads of 128) over 4
   rank-major sequence shards through ring attention (K1-K3 a hop, K2
   taking the merge's lse cotangent) against the same weights with dense
   attention: logits and gradients as in ``reference``, with learned
   positions at S = 1,024 and with RoPE at ragged shards of 1,000; K1-K3
   launch 4 times a layer; the ring over one shard gives the kernels' own
   bits.
18. ``ulysses_reference`` — the same for Ulysses all-to-all attention (one
   launch of each kernel a layer, on the gathered sequence).
19. ``ring_train`` — the slice's main path: ``long_context_training.
   SequenceParallelLM`` at the 1.3B LM's widths (``RING_LAYERS`` = 4
   layers, cut from 24, 12 and 6 for the smoke's time, width 2048, 16 heads of 128,
   vocab 32000, RoPE; 24 layers are 1,339,131,904 parameters), bf16 over
   float32 parameters, full remat, the chunked loss, Adam, one sequence of
   16,384 tokens over 4 rank-major ring shards of 4,096, ``RING_STEPS`` =
   3 steps (cut from 5 for the smoke's time): step ms
   (the first step left out), tokens/s, peak memory, launches (K1 2 x 4
   hops x 4 layers a step, K2 and K3 4 x 4) and a ``profile_step``
   profile of one more step (device idle share, K1-K3's device time).
20. ``ulysses_train`` — the same LM at 4 layers through Ulysses, with a
   ``profile_step`` profile of one more step: the copies of its two moves
   (``ulysses::scatter_heads`` and ``ulysses::gather_seq``, forward,
   recompute and backward), their count and device time (a move that is a
   view launches nothing and counts 0).
21. ``dp_sp_train`` — ``__graft_entry__.dryrun_multichip``'s dp x sp step at
   dp 2 x sp 2, 4 layers at the same widths, 8,192 tokens a dp rank over 2
   ring shards, ATC SGD over the one-peer Exp2 walk, 3 steps: the combine
   shrinks the spread every step.
22. ``long_context_example`` — ``python -m bluefog_tpu_torch.
   long_context_training``'s ``main`` on the card, ring and Ulysses: the
   loss falls.
23. ``dist_nccl`` — ``init_distributed`` over a world-size-1 NCCL group (a
   localhost rendezvous): the collectives, a nonblocking allreduce and its
   wait, a 2-step ATC run of a small LM through the transport, and a
   tensor-parallel forward and backward and a 1F1B step over
   ``process_ranks()``, bit for bit the single-process path on the card.
   One card: nothing crosses a wire.
24. ``tp_reference`` — a 2-layer SwiGLU LM (width 512, 4 heads of 128) cut
   over rank-major tp shards (``parallel.tensor_parallel.TensorParallelLM``,
   K1-K3 on the shards' heads stacked on the batch dim) against the same
   weights unsharded through K1-K3: MHA at tp 2, GQA with 2 kv heads at tp
   4 (half-group kv shards, gathered); logits and every gradient, as in
   ``reference``; K1 launches once a layer.
25. ``tp_train`` — ``__graft_entry__.dryrun_multichip``'s tensor-parallel
   step at dp 2 x tp 2 on 4 virtual ranks: ``tensor_parallel_training.
   DataTensorParallelLM`` at the 1.3B LM's widths with SwiGLU
   (``TP_LAYERS`` = 4 layers, cut from 24, 12 and 8 for the smoke's
   time, 403,720,192 parameters a dp replica, no remat), batch 2 x 2048 a dp
   rank, ATC SGD (lr 0.025) over the one-peer Exp2 walk, 4 steps: step ms
   (the first left out), tokens/s, peak memory under 80 GB, the spread
   exactly 0.0 after every combine, launches 4 layers x 2 dp ranks of
   each kernel a step; a ``profile_step`` profile of one more step (idle
   share, K1-K3, the tp sums ``tp::row_sum``).
26. ``pp_train`` — 1F1B (``parallel.pipeline.pipeline_train_step``) of the
   same model's blocks, ``PP_LAYERS`` = 4 (cut from 24, 12 and 8 for
   the smoke's time) in 4 rank-major stages of 1, 8 microbatches of one
   2048-token sequence, MSE against a synthetic target, 3 SGD steps: the
   first step's loss and gradients against autograd through the 4 blocks
   in sequence
   (``REF_LOGITS_TOL``, ``REF_GRAD_TOL``), step ms, tokens/s, the 22
   ticks, peak memory under 80 GB, launches K1 2 x 4 x 8 and K2, K3
   4 x 8 a step; ``profile_step.trace`` of one more step.
27. ``pp_variants`` — GPipe (autograd through ``pipeline_apply``),
   interleaved 1F1B (v = 2) and ZB-H1 at 8 blocks (the depth cut for the
   smoke's time), each warmed once, then one timed step against plain
   1F1B's gradients; launches per schedule (ZB-H1: K1 3, K2 and K3 2 a
   block and microbatch).
28. ``dp_tp_pp_ep`` — dryrun's dp x tp x pp and dp x tp x pp x ep steps
   (``parallel.composed``) at 8 virtual ranks and its shapes, float32,
   against the dense sequential step on the card (``COMPOSED_TOL``).
29. ``tp_example``, 30. ``pp_example`` — ``python -m bluefog_tpu_torch.
   tensor_parallel_training``'s and ``pipeline_training``'s ``main`` on the
   card (each schedule), 6 and 8 steps (15 and 20 before the bench rigs'
   legs, 8 and 10 before the interactive leg): the loss falls.
30a. ``elastic_example`` — ``python -m bluefog_tpu_torch.elastic_training``'s
   ``main`` on the card at its own size (60 steps of a small MLP on 4
   ranks, a checkpoint every 10), under neighbor_allreduce and under
   push-sum (its window store in the checkpoint): uninterrupted, then
   preempted at step 25 (exit 75) and run again: it resumes and ends bit
   for bit where the uninterrupted run did.
30b. ``examples_22a`` — the entry points of ROADMAP item 22a on the card,
   in this process, at their own widths with few steps:
   ``average_consensus`` (static ring, 8 ranks), ``decentralized_
   optimization`` (every method, 300 iterations), ``resource_allocation``
   (EXTRA, 500 iterations), ``moe_training`` (60 steps), ``resnet_
   training`` (its ResNet-18 at 32x32, batch 32 on 8 ranks, 2 epochs of
   4 steps where it runs 3 of 16; cuDNN's autotuning off, as the example
   leaves it) and ``mnist_lenet`` (its defaults); each error or loss must
   fall.
30c. ``interactive`` — ROADMAP item 22e.  Its two sessions start before
   ``tp_example`` and run while 29-30b run in this process (phases with
   no liveness check and no timing gate, ``IBF_RIDES``); the leg's line
   comes after ``examples_22a``'s.  (a) ``python -m
   bluefog_tpu_torch.run.interactive -np 4`` with the JAX package's three
   piped cells (``IBF_CELLS``): ``CELL1``-``CELL3`` True, the rows on
   ``cuda:0``; (c) ``-np 2 --hosts 127.0.0.1:2 --backend gloo``, process
   0 the line REPL and process 1 a worker, both on ``cuda:0``: the
   cluster notebook's cells (``CLUSTER-NB-OK True`` from both),
   ``%bfstat`` (a ``proc i/2`` block from each), a cell raising on rank 1
   only (``rank 1 raised`` on stderr), one more cell (run by both), and
   the exit (0, the workers gone on their own within ibfrun's 15 s); then
   after ``examples_22a`` (b) the port's helloworld notebook in this
   process at 8 ranks on the card: max deviation below 1e-3.  Each
   session's seconds to "ready", each cell's and the exit's, and the
   seconds the sessions rode.
31. ``hier_train`` — the benchmark with ``--dist-optimizer hierarchical
   --atc --dynamic``: the 1.3B LM at full width and depth, 4 ranks in 2
   machines of 2 (the machine topology's one-peer walk), 1 warmup + 2
   timed steps: step ms, tokens/s, peak memory, K1-K3 launches a step
   (layers x ranks), the combine's time on one more step beside its byte
   bound, the spread (it must shrink in the combine); and the hierarchical
   combines on the card against the CPU at (4, 2^24) float32, bit for bit.
32. ``winput_train`` — ``--dist-optimizer win_put``: the LM at full width
   and ``WINPUT_LAYERS`` = 10 blocks (flat, gradients, main, the
   combine's scaled copy of main, the 8 staging rows of in-degree 2 and a
   scratch row: 25 rows of 2.55 GB at the peak, 63.9 GB; at 11 layers,
   68.9 GB, the whole smoke ran out of memory, its cache fragmented; 24
   layers would need 134 GB), 1 warmup + 2 timed steps, then 2
   steps whose combine (the window ms, beside its bound of 28 row passes)
   is held to the same combine recomputed in float64 from the rows before
   and after the adapt, with ``_default_update_weights``, on 2^22 sampled
   columns (``WIN_TOL``).
32a. ``fused_train`` — the fused window step (``ops/fused_step.py``):
   ``winput_train``'s LM and depth, win_put in ``FUSED_BUCKETS`` = 4
   fusion buckets, ``FUSED_STEPS`` = 2 steps eagerly, then 2 fused from the
   same seed (the first uncaptured, then captured into a CUDA graph and
   replayed): the parameters bit for bit the eager ones after step 2 (the
   replayed step); ``bf_fused_step_active`` 1, one replay; each step's ms
   both ways, the window ms beside its bound of 28
   row passes, the capture seconds, the synchronizing calls of step 2
   both ways (``set_sync_debug_mode``), the probes' measured overlap
   beside ``modeled_overlap``'s, and K1-K3 launches (the graph holds no
   attention: the eager count).  Then the bench rigs' legs (ROADMAP item
   22d, ``fused_rig_legs``): ``bench_comm``'s ``--ffi-smoke`` (on the card
   the plans' pinned staging bytes equal the source rows put),
   ``--fused-smoke`` and ``--probe-smoke`` on card tensors through its
   loopback store, and the port bench's ``fused_step`` block with
   ``BLUEFOG_TPU_FUSED_STEP`` set, each JSON on a line of the phase.
33. ``win_variants`` — ``DistributedPullGetOptimizer``,
   ``DistributedPushSumOptimizer`` and ``DistributedWinPutOptimizer(
   overlap=True)`` on the LM at full width and 2 blocks, 3 steps each: the
   combine shrinks the rms spread every step; after push-sum's
   ``collect`` the P scalars sum to 4, each above 0, and the de-biased
   rows' mean is the adapted rows' within 1e-5.
34. ``win_ops`` — ``win_put`` with partial destinations, ``win_accumulate``,
   ``win_get``, ``win_update`` with partial weights (the left-out edges
   stay pending), ``win_update_then_collect``, the versions and P, a
   state-dict round trip and ``win_mutex`` against a writer in another
   thread, on a (4, 2^24) float32 tensor under ExponentialGraph(4): the
   card against the CPU bit for bit; ``win_update``'s time beside its
   bound.  Then ``window_benchmark``'s single-process leg (item 22d) at
   its ResNet-50 width, 8 ranks, ``WINDOW_BENCH_ROUNDS`` rounds.
35-41 across processes: one launch of 2 processes of 2 ranks runs the
   workers of ``win_dist_ops``, ``win_dist_train``, ``win_async_ops`` and
   ``win_async_train`` in turn (``dist_phases``: one start-up of the
   processes, where each phase had its own), the CPU run of
   ``win_async_ops`` alongside it; a wall line of each part precedes the
   phases' lines, which follow ``resnet50_win_put``'s.
35. ``win_dist_ops`` — ``win_ops``' sequence across 2 processes of 2
   ranks, both on card 0
   (``BFTPU_*`` rendezvous, gloo for the control, every remote row over
   the window transport's loopback socket; this script relaunched with
   ``--worker``), in the owned layout with a fence after each op, through
   the native and the Python transport paths: every owned row (by its
   sha256), counter and P scalar bit for bit the one-process card run;
   under bf16 window compression within ``WIN_DIST_BF16_TOL``; the bytes
   that crossed the socket, the wire, card-to-host and host-to-card ms and
   GB/s, beside what one pinned copy of 1 GiB each way and one loopback
   socket reach on this machine (the path's bounds).  Then the flight
   recorder armed in both processes with every data message traced: two
   accumulates sent back to back to a remote rank (the receiver's drain
   folds them), a fence, the ring dumped; ``utils.flightrec.load`` reads
   each process's dump back with events of all seven ``BF_REC_*`` types,
   and the host tool ``tools/tracegossip.py`` merges the two dumps (one
   lane a process, the per-edge delay table).  The four 2 x 2 phases run
   from one launch through the port's ``bfrun`` (``python -m
   bluefog_tpu_torch.run -np 2 --devices-per-proc 2 --tag-output``), as
   does the CPU run of ``win_async_ops``; bfrun's per-rank exit summary
   and the launch's clock (to the workers' start, their rendezvous,
   from their shutdown to bfrun's exit) are on the ``dist_workers``
   line.
36. ``resnet50_win_put`` — the ResNet-50 phase under ``--dist-optimizer
   win_put`` (batch 64, 4 ranks, 1 warmup + 2 timed steps), with the
   window combine's time beside its bound.
37. ``win_dist_train`` — across the same 2 x 2: the benchmark's win_put
   LM at full width cut to ``WIN_DIST_LAYERS`` = 1 block (at 10, a step
   took 25 s, at 4 11 s, at 2 more than the smoke's time allows; owned layout), 1 warmup + 1
   timed step (cut from 2):
   finite losses, K1-K3 launches layers x 2 ranks x 2 steps a process,
   the combine shrinks the world's spread; step ms, tokens/s, the window
   a step split into staging out, wire, the remote mutex's waits and
   commit, the bytes crossing a step, peak memory a process; ResNet-50
   under win_put (batch 64, 102 MB rows); pull-get and push-sum at 1
   block (cut from 2), a step each (cut from 2; pull-get shrinks the rms
   spread, push-sum's P sums to 4 after ``collect``); then the same LM in 2
   fusion buckets, one step each way from the same seed: eager with
   ``BLUEFOG_TPU_WIN_XLA=0`` (the host-staged puts) and fused (``=1``,
   the put plans inside the program), each window's staging rows after a
   fence bit for bit the ``=0`` run's; the fused run steps once more
   (captured, replayed once; in process 0 under ``profile_step.trace``,
   the device idle share of the step) with every put status 0 and
   ``xlaffi.armed()``; then the staging GB/s of the plan path beside
   ``_stage``'s, warm, one process at a time (the two share the card's
   host link), and ``bf_win_host_copy_bytes_total`` by path.
38. ``tp_moe_reference`` — the switch-MoE LM at the 1.3B LM's widths
   (``TP_MOE_LAYERS`` = 2 blocks of 8 GELU experts, vocab 32000, one
   sequence of 2048) in float32, dense attention, TF32 off: the card's
   ``TensorParallelLM`` at tp 2 with ``remat=True``, its experts whole on
   each shard and cut over an 8-rank expert axis (``moe_apply``), against
   the card's unsharded model on the same weights: the routing decisions
   that differ (reported), logits and every gradient (loss with the aux
   losses) by relative error (``REF_LOGITS_TOL``, ``REF_GRAD_TOL``), and
   remat against none.
39. ``tp_moe_train`` — dp 2 x tp 2 of that MoE LM (bf16 over float32,
   K1-K3 on the head shards, experts whole on each shard, full remat,
   batch 2 a dp rank), ATC SGD over the one-peer Exp2 walk,
   ``TP_MOE_STEPS`` steps: step ms (the first left out), tokens/s, peak
   memory, the spread exactly 0.0 after every combine, launches a step (K1
   2 x layers x dp, forward and recompute; K2, K3 layers x dp), and the
   recompute's share of the step (one more step without remat, timed).
40. ``win_async_ops`` — the async window mode across 2 processes of 2
   ranks on card 0 (as ``win_dist_ops``), on both transport paths, under
   ``reject`` and ``downweight:0.5`` with a bound of 1 step and every data
   message tagged: ``WIN_ASYNC_PHASES``, each setting the step clocks by
   hand, then tagged ``win_accumulate``s of (4, 2^20) float32 rows and a
   fence; the staging, the stale-residual store, P and the versions bit
   for bit the same sequence's run on the CPU (the same workers with
   ``--worker ... cpu``); after a fence and ``win_fold_stale_residuals``
   the staging is exactly what the senders shipped.
41. ``win_async_train`` — ``BLUEFOG_TPU_ASYNC=1``, ``TRACE_SAMPLE=1``,
   ``STALENESS_STEPS=1``, ``COLLECT_EVERY=2`` across the same 2 x 2, process
   1 sleeping ``WIN_ASYNC_SLEEP`` = 0.5 s (1.5 until cut for the smoke's
   time) before each step (a straggler): the
   benchmark's win_put LM and push-sum at 1 block each (win_put cut from
   4, then from 2, for the smoke's time), each
   ``WIN_ASYNC_LOCKSTEP_STEPS`` lockstep step then ``WIN_ASYNC_STEPS``
   async ones (1 and 2, cut from 2 and 3 for the smoke's time) in the same
   run: step ms of each,
   ``async_info()``'s step lag, the edges folded at each backstop, the
   remote mutex's grant waits, K1-K3 launches, and push-sum's P summing
   to 4.0 after each backstop; then ``bf.link_report()`` over both
   processes (every cross-process edge with a delay from its trace tags,
   each peer a goodput from its sent bytes) and one ``BLUEFOG_TPU_SLO``
   rule set to breach (``link_delay_us>=0``): ``bf_slo_breaches_total``
   and a flight-recorder dump in each process.
42. ``schedule_pipeline`` — the native round compiler
   (``native/src/schedule.cc``, built with g++) against its numpy oracle,
   bit for bit, with both times; then ``set_topology`` of a 16-rank
   ``ExponentialTwoGraph`` under ``BLUEFOG_TPU_FAKE_TORUS`` = 4x4 and 16
   (a ring, where the congestion repack and the synthesis move rounds):
   ``placement_info()``, ``synthesis_info()``, the permutation, and each
   dispatched schedule (static, and each one-peer phase) with its
   provenance, rounds against König's bound and modeled cost; then
   ``neighbor_allreduce`` and the dynamic combine of every phase on
   (16, 2^20) float32 rows over those schedules, bit for bit the same calls
   on the CPU, timed beside the byte bound.  Fails unless some dispatched
   schedule is congestion-packed or synthesized.  Then ``bench_comm``'s
   schedule bench (``--smoke``, item 22d) on the card.
43. ``sharded_moe_train`` — the switch-MoE LM at the 1.3B LM's widths
   (``SHARD_LAYERS`` = 2 blocks of 8 GELU experts, 705,734,656 parameters a
   rank, full remat, bf16 through K1-K3), 4 ranks, each row offset from the
   one init by seeded noise, ATC SGD (lr 0.0125 x 4) over the one-peer Exp2
   walk, ``experts_up`` and ``experts_down`` sharded on their expert axis
   over the groups {0, 1} and {2, 3}: one lr-0 step against the float64
   oracle (replicated columns: the walk's first phase; each rank's own
   slice: its group's mix; ``SHARD_ORACLE_TOL``; every ghost slice its
   input bit for bit), then ``SHARD_STEPS`` steps with the specs and as
   many without from the same start: step ms, tokens/s, the combine's ms
   (CUDA events) beside its bound (the gossiped columns read once and
   written once: 705.7M a rank without the specs, 437.3M with), the
   spread of the replicated columns and of each group's own slice after
   every combine, peak memory, K1-K3 launches a step.
44. ``win_sharded`` — one ``DistributedWinPutOptimizer`` step (lr 0) with
   ``shard_specs`` of a MoE-shaped tree (``WIN_SHARD_TREE``, rows of
   16,777,328 float32 columns), rank layout, ``fuse=True``: the windows
   ``.fused`` and ``.sharded``; on the card bit for bit the CPU run, each
   own slice the in-group combine, each ghost slice its input.
44a. ``churn_train`` — elasticity across processes (ROADMAP item 20): 4
   processes of one rank on card 0 (``BFTPU_*`` rendezvous, gloo for the
   control, the window transport for the rows), the 1.3B LM at full width
   and ``WIN_DIST_LAYERS`` = 1 block in the owned layout (a 0.74 GB row),
   ``DistributedWinPutOptimizer(fused=True)`` on ``ExponentialGraph(4)``,
   ``CHURN_STEPS`` = 12 steps under ``CHURN_KNOBS`` (the JAX package's
   ``tools/chaos.py`` demo: 80 ms heartbeats, 500 ms of suspicion, one
   retry of 25 ms, ``kill:rank=3:step=2``; 2 stripes, each heartbeat copy
   sent from its own thread as a frame of its own, which the receiver's
   control lane takes, so that none waits behind a row on the wire or in
   the drain).  Before the checks, a
   ``churn_liveness`` line: each survivor's longest heartbeat gaps from
   each peer, each gap over 250 ms split across the sender's pause, the
   wire, the wait from the read to the pop and from the pop to the note,
   its heartbeat thread's ticks, probes and proposals, the
   drain's slow calls and the longest stalls of its threads with where
   each thread stood.  Rank 3 SIGKILLs itself at the top
   of step 2 and must die of it; the survivors, without a leader or a
   collective, each commit epoch 1 with ranks (0, 1, 2), none evicted,
   observe ``bf_churn_recovery_seconds`` once, rebuild their window from
   the owned rows on the card (the rows' sha256 before and after equal),
   re-plan onto a doubly stochastic survivor topology with rank 3
   isolated, build and capture the fused program anew at the new epoch
   with statuses 0, keep finite losses, and at the last step the rms
   spread across them (over ``CHURN_SAMPLE`` sampled columns) is smaller
   after the combine than after the adapt; K1-K3 launch 1 x 12 times in
   each survivor (the processes drift apart: the survivors commit at their
   step 2 to 4).  The rebuilt staging is zero, as the JAX supervisor
   leaves it: a survivor's first combine after its rebuild takes a zero
   slot (the peer's first put of the new epoch lands a step later) and
   pulls its row toward zero (the spread 3.3e-3 against 5e-6 before);
   the lagged averaging then shrinks it by 3 a step, or, in turns, back
   to the floor and to a pull 9 times smaller two steps on.  12 steps (6
   while PR 15 seeded the staging with the rank's own row) take that
   pull below the floor at the last step whatever its parity; the spread
   of each step from the first commit on is reported.  Prints the detection time (rank 3's clock at the kill
   to each survivor's commit), the recovery seconds, the step ms before
   and after the commit and each survivor's peak memory.  The workers
   report through their JSON files only: after the kill nothing calls a
   collective.
44b. ``elastic_train`` — ``utils.elastic.run_elastic`` in this process: the
   LM at 1 block on 4 virtual ranks, static neighbor_allreduce, 4 steps
   in a temporary directory the phase removes: the 4 steps uninterrupted
   (the reference, no checkpoint), then under ``run_elastic`` a checkpoint
   (DCP, ``utils/checkpoint.py``) every 2
   steps, 2 kept, SIGTERM after step 3 (``Preempted`` after its save) and
   the restart, which resumes from step 3 (steps 2, 3 then 3, 4 on disk;
   6 steps until cut for the smoke's time):
   the final parameters bit for bit the uninterrupted run's (else the
   largest difference is reported and the phase fails).  Prints each
   save's pinned host copy and DCP write of the 2.97 GB of rows in GB/s,
   and the resume seconds.  Push-sum's resume with its window store in
   the checkpoint runs in ``elastic_example``: at these widths its store
   (main and staging, ~11 GB a save) would take the machine's disk past
   its 45 GiB of writes a call.
44c. ``chaos_tool`` — the port's chaos harness on the card (ROADMAP item
   22c): ``python -m bluefog_tpu_torch.tools chaos --join-leg --device
   cuda`` at the smoke profile's sizes with 40 s of gossip and a 10 ms
   pace (``CHAOS_TOOL_ARGS``; 4 processes of one rank under ``bfrun
   --elastic --chaos``, rows of 32 float32 on the card, 80 ms heartbeats,
   500 ms of suspicion, rank 2 killed at step 80, a fresh process
   admitted through the persisted gang directory by one grow epoch), and
   while that gang is live one ``tools top --once`` frame of its
   telemetry endpoints: the tool's verdict, the rows' device, the
   joiner's admission seconds, detection (the victim's clock at its kill
   to each member's shrink commit), recovery, the frame's lines and its
   endpoints up (4 of 4).
45. ``{"kernels": [...]}`` (launches from the ``train``,
   ``train_host_data``, ``llama_train``,
   ``moe_train``, ``ring_train``, ``ulysses_train``, ``dp_sp_train``,
   ``tp_train``, ``pp_train``, ``pp_variants``, ``hier_train``,
   ``winput_train``, ``fused_train``, ``win_variants``, ``win_dist_train``,
   ``tp_moe_train``, ``win_async_train``, ``sharded_moe_train``,
   ``churn_train``, ``elastic_train`` and ``observe_train`` phases,
   each path's beside), then the ``nvidia-smi`` line, then the last line
   ``{"ok": true, "device": {...}}``.

After each phase a ``{"phase": "wall", "of": ..., "seconds": ...}`` line
gives its wall seconds (from the previous phase's last line to its own
last).

Exits non-zero, printing no result, without a GPU or outside the repository.
"""

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
# Limits, a few times the errors of sound bf16 kernels on the card (the
# readings stand in PERF.md).  Both output measures scale with the typical
# output, not with the largest one.
REL_TOL = 1e-2               # K1-K3 outputs vs twin: ||err|| / ||twin||
ELEM_TOL = 0.15              # and max |err| / (|twin| + rms(twin))
LSE_TOL = 1e-4               # K1 lse vs twin: max |err| (f32, |lse| ~ 8)
REF_LOGITS_TOL = 2e-2        # flash vs dense model, both bf16: logits
REF_GRAD_TOL = 5e-2          # and each parameter's gradient
LAYERS = 24
LLAMA_LAYERS = 24
LLAMA_PARAMS = 1590790144    # a rank of the Llama-style LM at full width
LLAMA = dict(num_kv_heads=2, pos_encoding="rope", mlp="swiglu")
CE_VALUE_TOL = 1e-5          # chunked vs dense cross-entropy, f32: value
CE_GRAD_TOL = 2e-4           # and gradients, relative
RESNET50_PARAMS = 25557032
MOE_LAYERS = 6               # depth cut by memory: f32 parameters and
MOE_PARAMS = 1846667264      # gradients of 4 ranks take 59.1 GB at 6 layers
MOE_FLIP_TOL = 0.05          # bf16 flash vs dense: share of routing flips
SWITCH_F32_TOL = 1e-5        # SwitchMlp f32, card vs CPU: relative
VIT_LAYERS = 12
SEQ_TOKENS = 16384           # the long-context LM: one sequence of 16,384
SEQ_SHARDS = 4               # tokens over 4 rank-major shards of 4,096
RING_LAYERS = 4              # ring_train: 4 layers and 3 Adam steps
RING_STEPS = 3               # (24 and 5, then 12 and 6 layers: cut for time)
ULYSSES_LAYERS = 4           # ulysses_train and dp_sp_train at a reduced
DP_SP_LAYERS = 4             # depth, to keep the smoke within its time
TP_DP, TP_WAYS = 2, 2        # tp_train: dp 2 x tp 2, 4 virtual ranks
TP_LAYERS = 4                # tp_train's depth (24, 12, 8: cut for time)
TP_PARAMS = 403720192        # a dp replica: MHA, SwiGLU, learned positions
PP_STAGES, PP_MICROBATCHES = 4, 8   # pp_train: 4 blocks in 4 stages of 1,
PP_LAYERS = 4                       # 8 microbatches of one 2048 sequence
PP_BLOCK_PARAMS = 268451840         # (24, 12, 8 blocks: cut for time)
PP_VARIANT_LAYERS = 8        # pp_variants: depth cut to keep the smoke's time
COMPOSED_TOL = (2e-4, 2e-5)  # dp x tp x pp (x ep) vs dense, f32: rtol, atol
SEED = 0                     # inputs and weights are drawn from it
TWIN_SCORES_BYTES = 1 << 32  # the plain twins' f32 scores, at most, a call
SOURCE = "bluefog_tpu_torch/csrc/flash_attention.cu"
HIER_LAYERS = 24             # hier_train: full depth
WINPUT_LAYERS = 10           # winput_train: the windows' 25 rows a step fit
FUSED_BUCKETS = 4            # fused_train: winput_train's LM and depth in
FUSED_STEPS = 2              # 4 fusion buckets, 1 uncaptured + 1 replayed
                             # (3 until the bench rigs' legs joined)
FUSED_COMPARE_AT = (2,)      # steps after which the parameters must agree
WIN_DIST_LAYERS = 1          # win_dist_train, churn_train, elastic_train:
                             # the depth their time allows
WIN_VARIANT_LAYERS = 2       # win_variants: pull-get, push-sum, overlap
WIN_OPS_COLS = 1 << 24       # win_ops and the hierarchical card-vs-CPU check
WIN_CHECK_COLS = 1 << 22     # winput_train's float64 recheck: column sample
WIN_TOL = 1e-6               # window combine vs float64: ||err|| / ||ref||
WINDOW_BENCH_ROUNDS = 2      # win_ops' window benchmark leg (default 5)
WIN_DIST_PROCS = 2           # win_dist_*: processes, all on card 0 (NCCL
WIN_DIST_PER = 2             # refuses two ranks on one card): the world of
                             # 4 ranks, 2 a process, gloo for the control
WIN_DIST_VARIANT_LAYERS = 1  # win_dist_train's pull-get and push-sum,
WIN_DIST_VARIANT_STEPS = 1   # a step each (cut from 2 blocks and 2 steps
                             # for the smoke's time)
WIN_DIST_LM_ITERS = 1        # win_dist_train's timed steps of the LM and of
                             # ResNet-50 after 1 warmup (cut from 2)
WIN_DIST_BF16_TOL = 1e-2     # bf16 window compression vs exact: rtol, atol
WIN_DIST_TIMEOUT = 600       # seconds a worker group may take
TP_MOE_LAYERS = 2            # tp_moe_*: the MoE LM's depth, cut for time
TP_MOE_EXPERTS = 8           # GELU experts a block (docs/performance.md)
TP_MOE_STEPS = 3             # tp_moe_train: steps (the first left out)
WIN_ASYNC_COLS = 1 << 20     # win_async_ops: the rows' width (float32)
# win_async_ops: each phase's step of process 0 and 1 (the receiver's clock
# and the origin step its sends carry); with a bound of 1 step, phase 0's
# and phase 2's older rows are stale at their receivers.
WIN_ASYNC_PHASES = ((10, 7), (11, 11), (12, 14), (15, 14))
WIN_ASYNC_POLICIES = ("reject", "downweight:0.5")
WIN_ASYNC_PUT_LAYERS = 1     # win_async_train: win_put's depth and
WIN_ASYNC_PUSHSUM_LAYERS = 1  # push-sum's (cut from 2 for the smoke's time)
# Async steps of each (push-sum: a backstop at the 2nd), and the lockstep
# steps beside them; cut to keep the smoke's time.
WIN_ASYNC_STEPS = {"win_put": 1, "push_sum": 2}
WIN_ASYNC_LOCKSTEP_STEPS = 1
WIN_ASYNC_SLEEP = 0.5        # seconds process 1 sleeps before each step
WIN_ASYNC_KNOBS = dict(async_mode=True, trace_sample=1,
                       async_staleness_steps=1, async_collect_every=2)
BOUND_BYTES = 1 << 30        # path_bounds: one copy of 1 GiB a leg
SCHED_RANKS = 16             # schedule_pipeline: the virtual ranks,
SCHED_COLS = 1 << 20         # the rows' width (float32),
# the fake tori: the 4x4 of the 16 ranks, and a 16-ring, where the
# congestion repack and the synthesis move the Exp2 rounds.
SCHED_TORI = ("4x4", "16")
SHARD_LAYERS = 2             # sharded_moe_train: the MoE LM's depth (as
SHARD_EXPERTS = 8            # tp_moe_train's), its experts,
SHARD_GROUPS = 2             # the replica groups ({0, 1} and {2, 3}),
SHARD_STEPS = 3              # the steps each way (the first left out)
SHARD_PARAMS = 705734656     # a rank at 2 blocks
SHARD_NOISE = 1e-2           # the rows' seeded offsets from the one init
SHARD_ORACLE_TOL = 1e-6      # the lr-0 combine vs float64: ||err|| / ||ref||
# win_sharded: a MoE-shaped tree (bench.py's _sharding_summary) at
# win_ops' row size: router (replicated), experts (2 x 6,291,456, sharded
# on dim 0) and an indivisible head (replicated).
WIN_SHARD_TREE = {"experts": (2, 6291456), "head": (7, 16),
                  "router": (1 << 22,)}
# observe_train: item 21 armed on the train phase's LM (1 warmup step and
# 2 timed); the eager neighbor_allreduce timed with telemetry on and off.
OBSERVE_ITERS = 2
HOST_DATA_ITERS = 2          # train_host_data: timed steps (+1 warmup)
OBSERVE_KNOBS = {"BLUEFOG_TPU_PROFILE": "1", "BLUEFOG_TPU_PROFILE_EVERY": "1",
                 "BLUEFOG_TPU_TELEMETRY_CONSENSUS_EVERY": "2",
                 "BLUEFOG_TPU_TELEMETRY_PORT": "0"}
OBSERVE_NAR_SHAPE = (4, 1 << 24)
CHURN_PROCS = 4              # churn_train: 4 processes of one rank on
CHURN_STEPS = 12             # card 0, win_put steps; rank 3 killed at
CHURN_KILL_STEP = 2          # step 2 (rank 0 hosts the rendezvous)
CHURN_SAMPLE = 4096          # columns sampled for the spread across them
# tools/chaos.py run_demo's knobs (80 ms heartbeats, 500 ms of suspicion,
# retries), and 2 stripes: the row of a (window, rank) rides one, and every
# heartbeat is sent on each, as a frame of its own that the receiver's
# control lane takes (a heartbeat behind the drain's fold of a 0.94 GB row
# waited 0.4-0.9 s at 2 blocks: PERF.md section 6).
CHURN_KNOBS = {"BLUEFOG_TPU_CHURN": "1",
               "BLUEFOG_TPU_CHURN_HEARTBEAT_MS": "80",
               "BLUEFOG_TPU_CHURN_SUSPECT_MS": "500",
               "BLUEFOG_TPU_WIN_RETRIES": "1",
               "BLUEFOG_TPU_WIN_RETRY_BACKOFF_MS": "25",
               "BLUEFOG_TPU_WIN_STRIPES": "2",
               "BLUEFOG_TPU_CHAOS": f"kill:rank=3:step={CHURN_KILL_STEP}"}
ELASTIC_STEPS = 4            # elastic_train: the LM at WIN_DIST_LAYERS
ELASTIC_SAVE_EVERY = 2       # under run_elastic, SIGTERM after step 3;
ELASTIC_PREEMPT = 3          # saves of 2.97 GB at steps 2, 3 and 4 (the
                             # machine's disk takes 45 GiB of writes a
                             # call; 6 steps until cut for the smoke's time)
LM_WIDTHS = {"width": 2048, "heads": 16, "seq": 2048, "vocab": 32000}
DEVICE = "cuda"              # the new phases' device ("cpu" to rehearse)
KERNELS = {
    "K1": ("flash_fwd", "bluefog_tpu/ops/flash_attention.py:42"),
    "K2": ("flash_dq", "bluefog_tpu/ops/flash_attention.py:180"),
    "K3": ("flash_dkv", "bluefog_tpu/ops/flash_attention.py:211"),
}


def require(ok, what):
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


_WALL = {"phase": None, "seconds": 0.0, "t": time.perf_counter()}


def emit(phase, **kw):
    """One phase line; when the phase changes, the previous phase's wall
    seconds (the time since the line before its first, to its last) on a
    line of its own."""
    now = time.perf_counter()
    if phase != _WALL["phase"]:
        flush_wall()
        _WALL["phase"] = phase
    _WALL["seconds"] += now - _WALL["t"]
    _WALL["t"] = now
    print(json.dumps({"phase": phase, **kw}), flush=True)


def flush_wall():
    if _WALL["phase"] is not None:
        print(json.dumps({"phase": "wall", "of": _WALL["phase"],
                          "seconds": _WALL["seconds"]}), flush=True)
    _WALL["phase"], _WALL["seconds"] = None, 0.0


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, b):
    """``||a - b|| / ||b||`` in float32."""
    b = b.float()
    return float((a.float() - b).norm() / b.norm())


def elem_err(a, b):
    """``max |a - b| / (|b| + rms(b))`` in float32."""
    b = b.float()
    rms = b.square().mean().sqrt()
    return float(((a.float() - b).abs() / (b.abs() + rms)).max())


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ptxas_report(log):
    """Per kernel (``flash_fwd/D128`` ...): registers, static shared memory
    and spill bytes from the ``-Xptxas -v`` log."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function .*?(flash_(?:fwd|dq|dkv))_kernelILi(\d+)E",
                      ln)
        if m:
            cur = out.setdefault(f"{m.group(1)}/D{m.group(2)}", {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            cur["static_smem_bytes"] = int(m.group(2) or 0)
    return out


def operands(B, S, H, D, layout, g, kv_heads):
    """q, k, v in bf16 as a model path hands them to K1-K3: ``fused``,
    strided slices of one fused QKV tensor (the MHA LM); ``gqa``, q from its
    own projection and k, v contiguous ``repeat_interleave`` fan-outs of
    ``kv_heads`` shared heads that interleave K and V per head (the
    Llama-style LM); ``rope``, q and k rotated (contiguous), v a slice of
    the fused tensor (MHA with RoPE); ``ulysses``, RoPE's operands of
    ``SEQ_SHARDS`` rank-major shards of ``S / SEQ_SHARDS`` tokens with
    ``SEQ_SHARDS * H`` heads as ``parallel.ulysses`` hands them to its inner
    attention (at one sequence a shard, strided views, no copy)."""
    import torch
    dev = g.device
    if layout == "ulysses":
        from bluefog_tpu_torch.parallel.ulysses import ulysses_attention
        n, seen = SEQ_SHARDS, []

        def inner(q, k, v, causal):
            seen.extend((q, k, v))
            return q
        ulysses_attention(*operands(B, S // n, n * H, D, "rope", g, None),
                          axis=n, inner_attention=inner)
        return tuple(seen)
    if layout == "gqa":
        q = torch.randn(B, S, H, D, generator=g, device=dev).to(torch.bfloat16)
        kv = torch.randn(B, S, kv_heads, 2, D, generator=g,
                         device=dev).to(torch.bfloat16)
        rep = H // kv_heads
        return (q, kv[..., 0, :].repeat_interleave(rep, dim=2),
                kv[..., 1, :].repeat_interleave(rep, dim=2))
    qkv = torch.randn(B, S, H, 3, D, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    if layout == "rope":
        q, k = q.contiguous(), k.contiguous()
    return q, k, v


def by_batch(fn, H, S, *args):
    """``fn`` (a plain twin) over slices of the batch dim small enough that
    one slice's float32 scores ``(b, H, S, S)`` take at most
    ``TWIN_SCORES_BYTES``, the outputs concatenated: the batch rows are
    independent, so this is the twin's result."""
    import torch
    b = max(1, TWIN_SCORES_BYTES // (H * S * S * 4))
    B = args[0].shape[0]
    if b >= B:
        return fn(*args)
    parts = [fn(*(a[i:i + b] if isinstance(a, torch.Tensor) else a
                  for a in args)) for i in range(0, B, b)]
    return tuple(torch.cat(p) for p in zip(*parts))


def sdpa_backend(fn):
    """Which backend ``scaled_dot_product_attention`` ran in ``fn()``: the
    device kernels of one call under ``torch.profiler``, named by the
    first that matches (``cudnn``, whose kernels' names also hold
    "flash"; ``flash``; ``efficient``; else ``math``), with the name of
    its kernel that took the most device time."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda kv: -kv[1])
    for backend, marks in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                           ("efficient", ("fmha", "efficient",
                                          "attention_kernel"))):
        hit = [n for n, _ in kernels if any(m in n.lower() for m in marks)]
        if hit:
            return {"backend": backend, "kernel": hit[0][:90]}
    return {"backend": "math", "kernel": None}


def sdpa_times(q, k, v, do, causal, repeats=3):
    """The library yardstick (never called by the port): SDPA's forward
    and its backward (dq, dk and dv in one call) on ``(B, H, S, D)``
    operands, as the strided views of the kernels' own inputs and as
    contiguous copies; each the median of ``repeats`` ``cuda_ms`` readings
    (each of those beside it), with the backend that ran."""
    import statistics

    import torch
    import torch.nn.functional as F
    out = {}
    for layout in ("strided", "contiguous"):
        ts = [t.transpose(1, 2) for t in (q, k, v, do)]
        if layout == "contiguous":
            ts = [t.contiguous() for t in ts]
        qt, kt, vt = (t.detach().requires_grad_() for t in ts[:3])
        dot = ts[3]

        def fwd():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
        o = fwd()

        def bwd():
            return torch.autograd.grad(o, (qt, kt, vt), dot,
                                       retain_graph=True)
        fwd_runs = [cuda_ms(fwd) for _ in range(repeats)]
        bwd_runs = [cuda_ms(bwd) for _ in range(repeats)]
        out[layout] = {"fwd_ms": statistics.median(fwd_runs),
                       "bwd_ms": statistics.median(bwd_runs),
                       "fwd_runs_ms": fwd_runs, "bwd_runs_ms": bwd_runs,
                       "fwd": sdpa_backend(fwd), "bwd": sdpa_backend(bwd)}
    return out


def check_kernels(B, S, H, D, causal, seed, timed, repeat=False,
                  layout="fused", kv_heads=None, fwd_only=False):
    """K1-K3 (K1 alone with ``fwd_only``) against their twins at one shape
    and operand layout (``operands``); returns per-kernel dicts.  With
    ``repeat``, K1-K3 run again on the same inputs and must give the same
    bits."""
    import torch

    from bluefog_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = operands(B, S, H, D, layout, g, kv_heads)
    do = torch.randn(B, S, H, D, generator=g, device=dev).to(torch.bfloat16)
    dlse = 0.1 * torch.randn(B, S, H, generator=g, device=dev)
    f32 = [t.float() for t in (q, k, v, do)]

    o_k, lse_k = FA.flash_fwd_cuda(q, k, v, causal)
    o_r, lse_r = by_batch(FA.flash_fwd_ref, H, S, *f32[:3], causal)
    o = o_r.to(torch.bfloat16)
    lse_bhs = lse_r.transpose(1, 2).contiguous()
    if not fwd_only:
        delta = FA.flash_delta(o, do, dlse)
        dq_k, delta_k = FA.flash_dq_cuda(q, k, v, o, do, lse_bhs, dlse, causal)
        dk_k, dv_k = FA.flash_dkv_cuda(q, k, v, do, lse_bhs, delta_k, causal)
        dq_r, dk_r, dv_r = by_batch(FA.flash_bwd_ref, H, S, *f32[:3],
                                    o.float(), lse_r, f32[3], dlse, causal)
    torch.cuda.synchronize()

    def err(pairs):
        """Largest relative error and largest absolute error over the
        outputs."""
        rel = max(rel_err(a, b) for a, b in pairs)
        elem = max(elem_err(a, b) for a, b in pairs)
        e = max(float((a.float() - b).abs().max()) for a, b in pairs)
        require(math.isfinite(e) and rel <= REL_TOL,
                f"||kernel - twin|| / ||twin|| {rel} over {REL_TOL}")
        require(elem <= ELEM_TOL,
                f"max |kernel - twin| / (|twin| + rms(twin)) {elem} over "
                f"{ELEM_TOL}")
        return {"rel_err": rel, "elem_err": elem, "max_abs_err": e}

    res = {"K1": err([(o_k, o_r)])}
    if not fwd_only:
        res["K2"] = err([(dq_k, dq_r)])
        res["K3"] = err([(dk_k, dk_r), (dv_k, dv_r)])
        delta_err = rel_err(delta_k, delta)
        require(delta_err <= REL_TOL,
                f"K2 delta: ||kernel - flash_delta|| / ||flash_delta|| "
                f"{delta_err} over {REL_TOL}")
        res["K2"]["delta_rel_err"] = delta_err
    if repeat:
        o_2, lse_2 = FA.flash_fwd_cuda(q, k, v, causal)
        dq_2, delta_2 = FA.flash_dq_cuda(q, k, v, o, do, lse_bhs, dlse, causal)
        dk_2, dv_2 = FA.flash_dkv_cuda(q, k, v, do, lse_bhs, delta_k, causal)
        torch.cuda.synchronize()
        same = {"K1": torch.equal(o_2, o_k) and torch.equal(lse_2, lse_k),
                "K2": torch.equal(dq_2, dq_k) and torch.equal(delta_2, delta_k),
                "K3": torch.equal(dk_2, dk_k) and torch.equal(dv_2, dv_k)}
        for name, ok in same.items():
            require(ok, f"{name} gave other bits on a second run with the "
                        f"same inputs")
            res[name]["bitwise_repeat"] = ok
    strides = {"q": q.stride(), "k": k.stride(), "v": v.stride(),
               "do": do.stride(), "o": o.stride()}
    for name, kernel in (("K1", "fwd"), ("K2", "dq"), ("K3", "dkv")):
        if name not in res:
            continue
        res[name]["dynamic_smem_bytes"] = FA.launch_plan(
            kernel, (B, S, H, D), strides, causal).smem
    lse_err = float((lse_k.transpose(1, 2) - lse_r).abs().max())
    require(lse_err <= LSE_TOL, f"max |lse - twin| {lse_err} over {LSE_TOL}")
    res["K1"]["lse_max_abs_err"] = lse_err
    pairs = S * (S + 1) // 2 if causal else S * S
    bsd, bhs = B * S * H * D * 2, B * H * S * 4
    # K2 reads q, k, v, dO, O, lse and dlse, writes dq and delta.
    work = {"K1": (4 * B * H * pairs * D, 4 * bsd + bhs),
            "K2": (6 * B * H * pairs * D, 6 * bsd + 3 * bhs),
            "K3": (8 * B * H * pairs * D, 6 * bsd + 2 * bhs)}
    for name in res:
        res[name]["bound_ms"], res[name]["bound_by"] = bound(*work[name])
    if not timed:
        return res

    res["K1"]["ms"] = cuda_ms(lambda: FA.flash_fwd_cuda(q, k, v, causal))
    res["K1"]["plain_ms"] = cuda_ms(
        lambda: FA.flash_fwd_ref(q, k, v, causal), iters=5, warmup=1)
    # The library yardstick: the kernels' own operands as (B, H, S, D)
    # views (library_ms) and as contiguous copies, medians of 3.
    sdpa = sdpa_times(q, k, v, do, causal)
    res["K1"]["library_ms"] = sdpa["strided"]["fwd_ms"]
    res["K1"]["sdpa"] = {lay: {k_: v_ for k_, v_ in d.items()
                               if k_.startswith("fwd")}
                         for lay, d in sdpa.items()}
    if fwd_only:
        return res
    res["K2"]["ms"] = cuda_ms(
        lambda: FA.flash_dq_cuda(q, k, v, o, do, lse_bhs, dlse, causal))
    res["K3"]["ms"] = cuda_ms(
        lambda: FA.flash_dkv_cuda(q, k, v, do, lse_bhs, delta_k, causal))
    # The plain op that K2's fused delta replaces on the card.
    res["K2"]["flash_delta_ms"] = cuda_ms(lambda: FA.flash_delta(o, do, dlse))
    # The twin computes dq, dk and dv in one pass: its time stands for K2
    # and K3 together.
    bwd_plain = cuda_ms(lambda: FA.flash_bwd_ref(q, k, v, o, lse_r, do, dlse,
                                                 causal), iters=5, warmup=1)
    res["K2"]["plain_ms"] = res["K3"]["plain_ms"] = bwd_plain
    # SDPA's backward computes dq, dk and dv in one call: its time stands
    # for K2 and K3 together.
    res["K2"]["library_ms"] = res["K3"]["library_ms"] = \
        sdpa["strided"]["bwd_ms"]
    for name in ("K2", "K3"):
        res[name]["sdpa"] = {lay: {k_: v_ for k_, v_ in d.items()
                                   if k_.startswith("bwd")}
                             for lay, d in sdpa.items()}
    return res


def flash_vs_dense(dense, flash, inputs, targets, logits_shape):
    """One model with dense attention and the same weights through K1-K3:
    logits and every parameter's gradient, by relative error."""
    import torch
    import torch.nn.functional as F
    flash.load_state_dict(dense.state_dict())
    out, grads = {}, {}
    for name, model in (("dense", dense), ("flash", flash)):
        logits = model(inputs)
        require(logits.shape == logits_shape,
                f"{name} logits shape {tuple(logits.shape)}")
        require(bool(torch.isfinite(logits).all()), f"{name} logits finite")
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))
        loss.backward()
        out[name] = logits.detach()
        grads[name] = {k: p.grad for k, p in model.named_parameters()}
    logit_err = rel_err(out["flash"], out["dense"])
    grad_err = {k: rel_err(grads["flash"][k], g)
                for k, g in grads["dense"].items()}
    worst = max(grad_err, key=grad_err.get)
    require(logit_err <= REF_LOGITS_TOL,
            f"logits differ by {logit_err} (relative) over {REF_LOGITS_TOL}")
    require(grad_err[worst] <= REF_GRAD_TOL,
            f"gradient of {worst} differs by {grad_err[worst]} (relative) "
            f"over {REF_GRAD_TOL}")
    return {"logits_rel_err": logit_err, "grad_rel_err": grad_err[worst],
            "grad_rel_err_worst_param": worst,
            "logits_max_abs_err": float((out["flash"] - out["dense"]).abs().max()),
            "tol": {"logits": REF_LOGITS_TOL, "grad": REF_GRAD_TOL}}


def check_reference(seed):
    """A small LM through the kernels against dense attention."""
    import torch

    from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    from bluefog_tpu_torch.ops.flash_attention import flash_attention_impl

    dev = torch.device("cuda")
    cfg = TransformerConfig(vocab_size=512, num_layers=2, num_heads=2,
                            embed_dim=256, max_seq_len=256)
    g = torch.Generator(device=dev).manual_seed(seed)
    dense = TransformerLM(cfg).to(dev)
    dense.reset_parameters(g)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=g, device=dev)
    return flash_vs_dense(dense, TransformerLM(cfg, flash_attention_impl()).to(dev),
                          tokens, torch.roll(tokens, -1, 1),
                          (2, 256, cfg.vocab_size))


def check_vit_reference(seed):
    """A 2-layer ViT (S=65, D=64, non-causal) through the kernels against
    dense attention."""
    import torch

    from bluefog_tpu_torch.models import ViT
    from bluefog_tpu_torch.ops.flash_attention import flash_attention_impl

    dev = torch.device("cuda")
    kw = dict(image_size=64, patch_size=8, embed_dim=128, num_layers=2,
              num_heads=2)
    g = torch.Generator(device=dev).manual_seed(seed)
    dense = ViT(**kw).to(dev)
    dense.reset_parameters(g)
    images = torch.randn(4, 64, 64, 3, generator=g, device=dev).bfloat16()
    labels = torch.randint(0, 1000, (4,), generator=g, device=dev)
    return flash_vs_dense(dense, ViT(attn_impl=flash_attention_impl(), **kw).to(dev),
                          images, labels, (4, 1000))


def check_resnet_reference(seed):
    """ResNet-18 on the card against the same weights on the CPU in f32."""
    import torch
    import torch.nn.functional as F

    from bluefog_tpu_torch.models import ResNet18
    from bluefog_tpu_torch.models.layers import BatchNorm

    g = torch.Generator().manual_seed(seed)
    ref = ResNet18(dtype=torch.float32)
    ref.reset_parameters(g)
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, BatchNorm) and mod.zero_scale:
                mod.weight.fill_(0.2)
    init = {k: v.clone() for k, v in ref.state_dict().items()}
    images = torch.randn(4, 64, 64, 3, generator=g).bfloat16()
    labels = torch.randint(0, 1000, (4,), generator=g)

    def run(model, x, y):
        logits = model(x)
        F.cross_entropy(logits, y).backward()
        return (logits.detach().float().cpu(),
                {k: p.grad.float().cpu() for k, p in model.named_parameters()},
                {k: b.float().cpu() for k, b in model.named_buffers()})

    want = run(ref, images.float(), labels)
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        card = ResNet18(dtype=dtype).cuda()
        card.load_state_dict(init)
        logits, grads, stats = run(card, images.cuda().to(dtype), labels.cuda())
        grad_err = {k: rel_err(g, want[1][k]) for k, g in grads.items()}
        stat_err = {k: rel_err(b, want[2][k]) for k, b in stats.items()}
        worst, worst_stat = (max(e, key=e.get) for e in (grad_err, stat_err))
        res = {"logits_rel_err": rel_err(logits, want[0]),
               "grad_rel_err": grad_err[worst], "grad_rel_err_worst_param": worst,
               "stats_rel_err": stat_err[worst_stat],
               "stats_rel_err_worst": worst_stat}
        require(math.isfinite(res["grad_rel_err"]), f"{name} gradients finite")
        require(res["logits_rel_err"] <= REF_LOGITS_TOL,
                f"{name} logits differ by {res['logits_rel_err']} over "
                f"{REF_LOGITS_TOL}")
        require(res["stats_rel_err"] <= REF_LOGITS_TOL,
                f"{name} BN statistic {worst_stat} differs by "
                f"{res['stats_rel_err']} over {REF_LOGITS_TOL}")
        if dtype == torch.float32:
            require(res["grad_rel_err"] <= REF_GRAD_TOL,
                    f"f32 gradient of {worst} differs by "
                    f"{res['grad_rel_err']} over {REF_GRAD_TOL}")
        out[name] = res
    out["tol"] = {"logits": REF_LOGITS_TOL, "grad_f32": REF_GRAD_TOL,
                  "stats": REF_LOGITS_TOL}
    return out


def logits_and_grads(model, tokens):
    """The LM's logits and every parameter's gradient of its next-token
    cross-entropy."""
    import torch
    import torch.nn.functional as F
    logits = model(tokens)
    F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                    torch.roll(tokens, -1, 1).reshape(-1)).backward()
    return logits.detach(), {k: p.grad for k, p in model.named_parameters()}


def flash_launches():
    from bluefog_tpu_torch.ops import flash_attention as FA
    return {"K1": FA.flash_fwd_cuda.launches, "K2": FA.flash_dq_cuda.launches,
            "K3": FA.flash_dkv_cuda.launches}


def check_llama_reference(seed):
    """A 2-layer Llama-style LM (width 512, 8 heads of 64, 2 kv heads,
    RoPE, SwiGLU) through the kernels: against dense attention; with remat
    ``full`` and ``dots`` against without; and the chunked loss against
    dense cross-entropy at the full-width lm-head, float32."""
    import torch
    import torch.nn.functional as F

    from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.ops.chunked_loss import \
        chunked_softmax_cross_entropy

    dev = torch.device("cuda")
    kw = dict(vocab_size=512, num_layers=2, num_heads=8, embed_dim=512,
              max_seq_len=256, **LLAMA)
    g = torch.Generator(device=dev).manual_seed(seed)
    dense = TransformerLM(TransformerConfig(**kw)).to(dev)
    dense.reset_parameters(g)
    tokens = torch.randint(0, 512, (2, 256), generator=g, device=dev)
    out = {"flash_vs_dense": flash_vs_dense(
        dense, TransformerLM(TransformerConfig(**kw),
                             FA.flash_attention_impl()).to(dev),
        tokens, torch.roll(tokens, -1, 1), (2, 256, 512))}

    def run(policy):
        model = TransformerLM(TransformerConfig(
            remat=policy is not None, remat_policy=policy or "full", **kw),
            FA.flash_attention_impl()).to(dev)
        model.load_state_dict(dense.state_dict())
        FA.reset_launch_counts()
        res = logits_and_grads(model, tokens)
        torch.cuda.synchronize()
        return res, flash_launches()

    (want, want_g), plain = run(None)
    require(plain == {"K1": 2, "K2": 2, "K3": 2}, f"plain launches {plain}")
    for policy in ("full", "dots"):
        (logits, grads), launches = run(policy)
        # K1 runs again in each block's recompute.
        require(launches == {"K1": 4, "K2": 2, "K3": 2},
                f"remat {policy} launches {launches}")
        logit_err = rel_err(logits, want)
        grad_err = max(rel_err(grads[k], g) for k, g in want_g.items())
        require(logit_err <= REF_LOGITS_TOL and grad_err <= REF_GRAD_TOL,
                f"remat {policy}: logits {logit_err}, gradients {grad_err}")
        out[f"remat_{policy}"] = {
            "launches": launches, "logits_rel_err": logit_err,
            "grad_rel_err": grad_err,
            "logits_max_abs_diff": float((logits - want).abs().max()),
            "grad_max_abs_diff": max(float((grads[k] - g).abs().max())
                                     for k, g in want_g.items())}

    # The chunked loss at llama_train's lm-head: B=2, S=2048, E=2048,
    # V=32000, float32 (TF32 is off).
    h = torch.randn(2, 2048, 2048, generator=g, device=dev,
                    requires_grad=True)
    w = (torch.randn(32000, 2048, generator=g, device=dev)
         / math.sqrt(2048)).requires_grad_()
    t = torch.randint(0, 32000, (2, 2048), generator=g, device=dev)
    chunked = lambda: chunked_softmax_cross_entropy(h, w, t)  # noqa: E731
    full = lambda: F.cross_entropy(  # noqa: E731
        F.linear(h, w).reshape(-1, 32000), t.reshape(-1))
    got, want = chunked(), full()
    got_g = torch.autograd.grad(got, (h, w))
    want_g = torch.autograd.grad(want, (h, w))
    value_err = abs(got.item() - want.item()) / abs(want.item())
    grad_err = max(rel_err(a, b) for a, b in zip(got_g, want_g))
    require(value_err <= CE_VALUE_TOL and grad_err <= CE_GRAD_TOL,
            f"chunked loss: value {value_err}, gradients {grad_err}")
    out["chunked_loss"] = {
        "value_rel_err": value_err, "grad_rel_err": grad_err,
        "tol": {"value": CE_VALUE_TOL, "grad": CE_GRAD_TOL},
        "fwd_bwd_ms": cuda_ms(lambda: torch.autograd.grad(chunked(), (h, w)),
                              iters=3, warmup=1),
        "dense_fwd_bwd_ms": cuda_ms(lambda: torch.autograd.grad(full(), (h, w)),
                                    iters=3, warmup=1)}
    return out


def llama_train_phase(benchmark):
    """The Llama-style LM at full width, 4 ranks, remat and the chunked
    loss, through K1-K3; returns the trainer and the launches."""
    import torch

    from bluefog_tpu_torch.ops import flash_attention as FA

    args = benchmark.build_parser().parse_args([
        "--model", "transformer", "--flash-attention", "--atc", "--dynamic",
        "--num-layers", str(LLAMA_LAYERS), "--embed-dim", "2048",
        "--num-heads", "16", "--num-kv-heads", "4", "--rope", "--swiglu",
        "--remat", "--chunked-loss", "--seq-len", "2048", "--batch-size", "2",
        "--vocab-size", "32000", "--momentum", "0", "--ranks", "4", "--mfu",
        "--num-warmup-batches", "1", "--num-iters", "2",
        "--num-batches-per-iter", "1", "--seed", str(SEED)])
    tr = benchmark.Trainer(args)
    FA.reset_launch_counts()
    res = benchmark.measure(args, tr)
    launches = flash_launches()
    steps = args.num_warmup_batches + args.num_iters * args.num_batches_per_iter
    per = LLAMA_LAYERS * args.ranks * steps
    # Under remat K1 runs twice a block: the forward and the recompute.
    expected = {"K1": 2 * per, "K2": per, "K3": per}
    emit("llama_train", config={
        "num_layers": LLAMA_LAYERS, "embed_dim": 2048, "num_heads": 16,
        "num_kv_heads": 4, "pos_encoding": "rope", "mlp": "swiglu",
        "remat": "full", "chunked_loss": True, "seq_len": 2048,
        "batch_size": 2, "vocab_size": 32000, "momentum": 0.0,
        "ranks": args.ranks, "order": "atc",
        "topology": "dynamic one-peer ExponentialGraph(4)"},
        launches=launches, expected_launches=expected, **res)
    require(res["params_per_rank"] == LLAMA_PARAMS,
            f"flat has {res['params_per_rank']} columns, expected "
            f"{LLAMA_PARAMS}")
    require(all(math.isfinite(x) for x in res["losses"]),
            f"finite losses {res['losses']}")
    require(res["steps"] == steps, f"{res['steps']} steps, expected {steps}")
    require(launches == expected, f"launches {launches}, expected {expected}")
    require(res["spread"]["after_combine"] < res["spread"]["after_adapt"],
            f"the combine shrinks the spread {res['spread']}")
    require(res["peak_mem_gb"] < 80, f"peak {res['peak_mem_gb']} GB")
    torch.cuda.empty_cache()
    return tr, launches


def check_generate(tr, seed, prompt_len=512, new=64, forced=16):
    """KV-cache generation from rank 0's module of ``llama_train`` (bf16,
    the prefill through K1): timing, launches, the first token, and
    teacher-forced decode logits against the full forward."""
    import torch

    from bluefog_tpu_torch.models import transformer as T
    from bluefog_tpu_torch.ops import flash_attention as FA

    model = tr.rep.modules[0]
    cfg = model.cfg
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (2, prompt_len), generator=g,
                           device=dev)
    T.generate(model, prompt, 2)                          # warm-up
    torch.cuda.synchronize()
    FA.reset_launch_counts()
    t0 = time.perf_counter()
    first = T.generate(model, prompt, 1)                  # the prefill
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = flash_launches()
    FA.reset_launch_counts()
    t0 = time.perf_counter()
    out = T.generate(model, prompt, new)
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0 - prefill_s) / (new - 1)
    launches = flash_launches()
    # The prefill runs K1 once a block; the decode steps attend densely.
    for what, got in (("prefill", prefill_launches), ("generate", launches)):
        require(got == {"K1": cfg.num_layers, "K2": 0, "K3": 0},
                f"{what} launches {got}")
    with torch.no_grad():
        full = model(prompt)
        p0 = prompt_len - forced
        _, cache = T.prefill(model, prompt[:, :p0], prompt_len)
        steps = []
        for t in range(p0, prompt_len):
            logits, cache = model(prompt[:, t:t + 1],
                                  positions=torch.full((2, 1), t, device=dev),
                                  cache=cache)
            steps.append(logits[:, 0])
        cache = T.prefill(model, prompt, prompt_len + new)[1]
    require(out.shape == (2, new) and torch.equal(first[:, 0], out[:, 0]),
            "generate's first token")
    require(torch.equal(out[:, 0], full[:, -1].argmax(-1).to(out.dtype)),
            "the first token is the argmax of the last prompt logits")
    forced_err = rel_err(torch.stack(steps, 1), full[:, p0:])
    require(forced_err <= REF_LOGITS_TOL,
            f"teacher-forced decode logits differ by {forced_err}")
    kv_h, d = cfg.num_kv_heads, cfg.embed_dim // cfg.num_heads
    cache_bytes = sum(t.numel() * t.element_size() for kv in cache for t in kv)
    want_bytes = cfg.num_layers * 2 * 2 * (prompt_len + new) * kv_h * d * 2
    require(cache_bytes == want_bytes,
            f"cache {cache_bytes} bytes, expected {want_bytes}")
    return {"prompt": [2, prompt_len], "new_tokens": new,
            "prefill_ms": 1e3 * prefill_s, "decode_ms_per_token": 1e3 * decode_s,
            "decode_tokens_per_s": 2 / decode_s,
            "launches": launches,
            "teacher_forced_positions": forced,
            "teacher_forced_logits_rel_err": forced_err,
            "cache_bytes": cache_bytes,
            "mha_cache_bytes": cache_bytes * cfg.num_heads // kv_h,
            "tol": {"logits": REF_LOGITS_TOL}}


def moe_plans(routers, cfg, tokens):
    """The expert that keeps each token (-1: dropped), per block, from the
    router logits ``(G, g, E)`` each block's ``moe.router`` gave."""
    import torch

    from bluefog_tpu_torch.parallel import moe as M
    g = min(cfg.router_group_size, tokens)
    G = -(-tokens // g)
    cap = max(1, int(cfg.expert_capacity_factor * g / cfg.num_experts))
    valid = (torch.arange(G * g, device=routers[0].device) < tokens).float()
    out = []
    for lg in routers:
        _, keep, _ = M._plan(lg.float(), cfg.num_experts, cap,
                             valid.reshape(G, g))
        kept = keep.sum(-1) > 0
        out.append(torch.where(kept, keep.argmax(-1), -1).reshape(-1)[:tokens])
    return out


def routed(model, fn):
    """``fn()``'s result and the router logits of each of ``model``'s MoE
    blocks during it."""
    from bluefog_tpu_torch.models.transformer import SwitchMlp
    logits = []
    hooks = [m.router.register_forward_hook(
        lambda mod, args, out: logits.append(out.detach()))
        for m in model.modules() if isinstance(m, SwitchMlp)]
    try:
        return fn(), logits
    finally:
        for h in hooks:
            h.remove()


def check_moe_reference(seed):
    """A 2-layer MoE LM through the kernels against dense attention, and
    one float32 ``SwitchMlp`` on the card against the CPU."""
    import copy

    import torch

    from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    from bluefog_tpu_torch.ops.flash_attention import flash_attention_impl

    dev = torch.device("cuda")
    kw = dict(vocab_size=512, num_layers=2, num_heads=2, embed_dim=256,
              max_seq_len=256, num_experts=8, router_group_size=256)
    g = torch.Generator(device=dev).manual_seed(seed)
    dense = TransformerLM(TransformerConfig(**kw)).to(dev)
    dense.reset_parameters(g)
    flash = TransformerLM(TransformerConfig(**kw),
                          flash_attention_impl()).to(dev)
    flash.load_state_dict(dense.state_dict())
    tokens = torch.randint(0, 512, (2, 256), generator=g, device=dev)
    T = tokens.numel()
    runs = {}
    for name, model in (("dense", dense), ("flash", flash)):
        (logits, grads), routers = routed(
            model, lambda: logits_and_grads(model, tokens))
        runs[name] = (logits, grads, moe_plans(routers, model.cfg, T))
    agree = torch.ones(T, dtype=torch.bool, device=dev)
    flips = 0
    for a, b in zip(runs["dense"][2], runs["flash"][2]):
        flips += int((a != b).sum())
        agree &= a == b
    # A flipped token reaches every later token of its sequence through the
    # next block's causal attention: hold the tokens before the first flip.
    agree = agree.reshape(tokens.shape).cumprod(1).bool().reshape(-1)
    share = flips / (T * len(runs["dense"][2]))
    require(share <= MOE_FLIP_TOL,
            f"{share:.2%} of routing decisions differ, over {MOE_FLIP_TOL}")
    rows = lambda t: t.reshape(T, -1)[agree]  # noqa: E731
    logit_err = rel_err(rows(runs["flash"][0]), rows(runs["dense"][0]))
    require(logit_err <= REF_LOGITS_TOL,
            f"logits before the first routing flip differ by {logit_err} "
            f"over {REF_LOGITS_TOL}")
    grad_err = {k: rel_err(runs["flash"][1][k], gd)
                for k, gd in runs["dense"][1].items()}
    worst = max(grad_err, key=grad_err.get)
    require(math.isfinite(grad_err[worst]), "gradients finite")
    out = {"routing_flips": flips, "routing_decisions": T * 2,
           "flip_share": share, "agreeing_tokens": int(agree.sum()),
           "logits_rel_err_agreeing": logit_err,
           "grad_rel_err": grad_err[worst], "grad_rel_err_worst_param": worst,
           "tol": {"flip_share": MOE_FLIP_TOL, "logits": REF_LOGITS_TOL}}

    # One SwitchMlp in float32: the card (TF32 off) against the CPU.
    cfg = TransformerConfig(dtype=torch.float32, **kw)
    gc = torch.Generator().manual_seed(seed)
    lm = TransformerLM(cfg)
    lm.reset_parameters(gc)
    mlps = {"cpu": lm.blocks[0].moe,
            "card": copy.deepcopy(lm.blocks[0].moe).to(dev)}
    x0 = torch.randn(2, 256, 256, generator=gc)
    tgt = torch.randn(2, 256, 256, generator=gc)
    res = {}
    for where, mlp in mlps.items():
        at = next(mlp.parameters()).device
        x = x0.to(at, copy=True).requires_grad_()
        (y, aux), routers = routed(mlp, lambda: mlp(x))
        ((y * tgt.to(at)).sum() + aux).backward()
        res[where] = {"plan": moe_plans(routers, cfg, 512)[0].cpu(),
                      "y": y.detach().cpu(), "aux": float(aux.detach()),
                      "grads": {"x": x.grad.cpu(),
                                **{k: p.grad.cpu()
                                   for k, p in mlp.named_parameters()}}}
    moved = int((res["cpu"]["plan"] != res["card"]["plan"]).sum())
    require(moved == 0, f"f32 SwitchMlp routes {moved} tokens otherwise on "
                        f"the card")
    errs = {"y": rel_err(res["card"]["y"], res["cpu"]["y"]),
            "aux_abs": abs(res["card"]["aux"] - res["cpu"]["aux"]),
            **{f"grad_{k}": rel_err(v, res["cpu"]["grads"][k])
               for k, v in res["card"]["grads"].items()}}
    bad = {k: v for k, v in errs.items() if not v <= SWITCH_F32_TOL}
    require(not bad, f"f32 SwitchMlp card vs CPU over {SWITCH_F32_TOL}: {bad}")
    out["switch_f32"] = {**errs, "dropped_tokens": int(
        (res["cpu"]["plan"] < 0).sum()), "tol": SWITCH_F32_TOL}
    return out


def moe_train_phase(benchmark):
    """The switch-MoE LM at the 1.3B LM's width, 4 ranks, remat, through
    K1-K3; returns the launches."""
    import torch

    from bluefog_tpu_torch import profile_step
    from bluefog_tpu_torch.ops import flash_attention as FA

    args = benchmark.build_parser().parse_args([
        "--model", "transformer", "--flash-attention", "--atc", "--dynamic",
        "--num-layers", str(MOE_LAYERS), "--embed-dim", "2048",
        "--num-heads", "16", "--num-experts", "8", "--remat",
        "--seq-len", "2048", "--batch-size", "2", "--vocab-size", "32000",
        "--momentum", "0", "--ranks", "4", "--mfu",
        "--num-warmup-batches", "1", "--num-iters", "2",
        "--num-batches-per-iter", "1", "--seed", str(SEED)])
    tr = benchmark.Trainer(args)
    FA.reset_launch_counts()
    res = benchmark.measure(args, tr)
    launches = flash_launches()
    steps = args.num_warmup_batches + args.num_iters * args.num_batches_per_iter
    per = MOE_LAYERS * args.ranks * steps
    expected = {"K1": 2 * per, "K2": per, "K3": per}
    prof = profile_step.profile(tr, "transformer (MoE)")
    named = prof["named_ops"]
    moe_ms = {k: named[k]["device_ms"] for k in profile_step.MOE_OPS
              if k in named}
    einsum_ms = sum(v for k, v in moe_ms.items() if k != "moe::plan")
    step_ms = sum(prof["phases"].values())
    emit("moe_train", config={
        "num_layers": MOE_LAYERS, "embed_dim": 2048, "num_heads": 16,
        "num_experts": 8, "expert_capacity_factor": 2.0,
        "router_group_size": 4096, "mlp": "gelu experts", "remat": "full",
        "seq_len": 2048, "batch_size": 2, "vocab_size": 32000,
        "momentum": 0.0, "ranks": args.ranks, "order": "atc",
        "topology": "dynamic one-peer ExponentialGraph(4)"},
        launches=launches, expected_launches=expected,
        moe_device_ms=moe_ms, dispatch_combine_ms=einsum_ms,
        dispatch_combine_share_of_device=einsum_ms / prof["kernel_busy_ms"],
        dispatch_combine_share_of_step=einsum_ms / step_ms,
        profile={k: prof[k] for k in (
            "phases", "profiled_step_wall_ms", "kernel_busy_ms",
            "device_idle_share", "idle_share_of_event_step", "families_ms",
            "top_kernels", "top_ops")}, **res)
    require(res["params_per_rank"] == MOE_PARAMS,
            f"flat has {res['params_per_rank']} columns, expected "
            f"{MOE_PARAMS}")
    require(all(math.isfinite(x) for x in res["losses"]),
            f"finite losses {res['losses']}")
    require(res["steps"] == steps, f"{res['steps']} steps, expected {steps}")
    require(launches == expected, f"launches {launches}, expected {expected}")
    require(res["spread"]["after_combine"] < res["spread"]["after_adapt"],
            f"the combine shrinks the spread {res['spread']}")
    require(res["peak_mem_gb"] < 80, f"peak {res['peak_mem_gb']} GB")
    require("mfu" not in res and "mfu_note" in res, "MoE reports no MFU")
    require(einsum_ms > 0 and set(moe_ms) == set(profile_step.MOE_OPS),
            f"the profile names the MoE ops: {sorted(moe_ms)}")
    require(0 < prof["kernel_busy_ms"] <= prof["profiled_step_wall_ms"],
            f"device busy {prof['kernel_busy_ms']} ms within the profiled "
            f"step's {prof['profiled_step_wall_ms']} ms")
    del tr
    torch.cuda.empty_cache()
    return launches


def seq_lm(seed, seq, pos):
    """A bf16 TransformerLM on the card (width 512, 4 heads of 128, vocab
    512), its weights from ``seed``, and ``(1, seq)`` tokens."""
    import torch

    from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    dev = torch.device("cuda")
    cfg = TransformerConfig(vocab_size=512, num_layers=2, num_heads=4,
                            embed_dim=512, max_seq_len=seq, pos_encoding=pos)
    g = torch.Generator(device=dev).manual_seed(seed)
    dense = TransformerLM(cfg).to(dev)
    dense.reset_parameters(g)
    tokens = torch.randint(0, 512, (1, seq), generator=g, device=dev)
    return cfg, dense, tokens


def seq_vs_dense(which, seed, n, seq, pos):
    """The 2-layer LM over an ``n``-shard rank-major sequence axis through
    ring (K1-K3 a hop) or Ulysses (K1-K3 on the gathered sequence) against
    the same weights with dense attention on the card: logits and every
    parameter's gradient, by relative error; and the launches."""
    import torch
    import torch.nn.functional as F

    from bluefog_tpu_torch.models.transformer import TransformerLM
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.parallel import ring_attention as R
    from bluefog_tpu_torch.parallel.ulysses import ulysses_attention_impl

    cfg, dense, tokens = seq_lm(seed, seq, pos)
    impl = (R.ring_attention_impl(n) if which == "ring"
            else ulysses_attention_impl(n))
    model = TransformerLM(cfg, impl).cuda()
    model.load_state_dict(dense.state_dict())
    targets = torch.roll(tokens, -1, 1)
    want_logits, want = logits_and_grads(dense, tokens)
    FA.reset_launch_counts()
    positions = torch.arange(seq, device=tokens.device)[None]
    logits = R.unshard_sequence(model(R.shard_sequence(tokens, n),
                                      positions=R.shard_sequence(positions, n)),
                                n)
    F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                    targets.reshape(-1)).backward()
    torch.cuda.synchronize()
    launches = flash_launches()
    hops = n if which == "ring" else 1
    expected = {"K1": cfg.num_layers * hops, "K2": cfg.num_layers * hops,
                "K3": cfg.num_layers * hops}
    require(launches == expected,
            f"{which} n={n} launches {launches}, expected {expected}")
    logit_err = rel_err(logits.detach(), want_logits)
    grad_err = {k: rel_err(p.grad, want[k]) for k, p in model.named_parameters()}
    worst = max(grad_err, key=grad_err.get)
    require(logit_err <= REF_LOGITS_TOL,
            f"{which} n={n} S={seq}: logits differ by {logit_err} over "
            f"{REF_LOGITS_TOL}")
    require(grad_err[worst] <= REF_GRAD_TOL,
            f"{which} n={n} S={seq}: gradient of {worst} differs by "
            f"{grad_err[worst]} over {REF_GRAD_TOL}")
    return {"shards": n, "seq_len": seq, "seq_local": seq // n,
            "pos_encoding": pos, "launches": launches,
            "logits_rel_err": logit_err, "grad_rel_err": grad_err[worst],
            "grad_rel_err_worst_param": worst,
            "tol": {"logits": REF_LOGITS_TOL, "grad": REF_GRAD_TOL}}


def check_seq_reference(which, seed):
    """``ring_reference`` / ``ulysses_reference``: the 2-layer LM (D=128)
    at 4 shards against dense attention, with learned positions and with
    RoPE at a ragged shard (S_local = 1000); one shard against a direct
    call of the kernels (the same bits)."""
    import torch

    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.parallel.ring_attention import ring_attention
    from bluefog_tpu_torch.parallel.ulysses import ulysses_attention

    out = {"sp4": seq_vs_dense(which, seed, 4, 1024, "learned"),
           "sp4_ragged": seq_vs_dense(which, seed, 4, 4000, "rope")}
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(2, 1000, 4, 128, generator=g, device="cuda")
               .bfloat16() for _ in range(3))
    fn = ring_attention if which == "ring" else ulysses_attention
    same = torch.equal(fn(q, k, v, axis=1),
                       FA.flash_attention_lse(q, k, v, causal=True)[0])
    require(same, f"{which} over one shard is not the kernels' bits")
    out["one_shard_bitwise"] = same
    return out


def ring_param_count(cfg):
    E, L, V = cfg.embed_dim, cfg.num_layers, cfg.vocab_size
    return L * (12 * E * E + 2 * E) + 2 * V * E + E


def seq_train_phase(phase, attention, layers, steps=5, profile=False):
    """The long-context LM at the 1.3B LM's widths (width 2048, 16 heads
    of 128, vocab 32000, RoPE), bf16 over float32 parameters, full remat,
    the chunked loss, Adam, 16,384 tokens over 4 rank-major shards of
    4,096, ``steps`` steps; returns the launches."""
    import torch

    from bluefog_tpu_torch import long_context_training as LC
    from bluefog_tpu_torch import profile_step
    from bluefog_tpu_torch.models.transformer import TransformerConfig
    from bluefog_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    n, seq = SEQ_SHARDS, SEQ_TOKENS
    cfg = TransformerConfig(vocab_size=32000, num_layers=layers, num_heads=16,
                            embed_dim=2048, max_seq_len=seq,
                            pos_encoding="rope", remat=True)
    g = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, 32000, (1, seq + 1), generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    lm = LC.SequenceParallelLM(cfg, attention, n, toks[:, :seq], toks[:, 1:],
                               lr=1e-4, chunked_loss=True, seed=SEED)
    params = sum(p.numel() for p in lm.model.parameters())
    require(params == ring_param_count(cfg),
            f"{params} parameters, expected {ring_param_count(cfg)}")
    FA.reset_launch_counts()
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(lm.step())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = flash_launches()
    losses = [float(x) for x in losses]
    hops = n if attention == "ring" else 1
    per = {"K1": 2 * layers * hops, "K2": layers * hops, "K3": layers * hops}
    expected = {k: v * steps for k, v in per.items()}
    timed = step_s[1:]                    # the first step builds and tunes
    step_ms = 1e3 * sum(timed) / len(timed)
    res = {"config": {"num_layers": layers, "embed_dim": 2048, "num_heads": 16,
                      "head_dim": 128, "vocab_size": 32000,
                      "pos_encoding": "rope", "remat": "full",
                      "chunked_loss": True, "optimizer": "adam",
                      "seq_len": seq, "batch_size": 1, "shards": n,
                      "seq_local": seq // n, "attention": attention},
           "params": params, "losses": losses,
           "step_ms": step_ms, "step_ms_each": [1e3 * t for t in step_s],
           "tokens_per_s": seq / (step_ms / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": launches, "launches_per_step": per,
           "expected_launches": expected}
    if profile:
        prof = profile_step.profile(lm, f"transformer ({attention})")
        res["profile"] = {k: prof[k] for k in (
            "phases", "profiled_step_wall_ms", "kernel_busy_ms",
            "device_idle_share", "idle_share_of_event_step", "families_ms",
            "top_kernels", "top_ops")}
        res["k1_k3_ms"] = prof["families_ms"].get("flash attention (K1-K3)")
        if attention == "ulysses":
            # A move that launched no kernel (a view) is not in named_ops.
            res["moves"] = {k: prof["named_ops"].get(
                k, {"count": 0, "device_ms": 0.0})
                for k in profile_step.ULYSSES_OPS}
            res["moves_ms"] = sum(m["device_ms"]
                                  for m in res["moves"].values())
        require(0 < prof["kernel_busy_ms"] <= prof["profiled_step_wall_ms"],
                f"device busy {prof['kernel_busy_ms']} ms within the "
                f"profiled step's {prof['profiled_step_wall_ms']} ms")
    emit(phase, **res)
    require(all(math.isfinite(x) for x in losses), f"finite losses {losses}")
    require(launches == expected, f"launches {launches}, expected {expected}")
    require(res["peak_mem_gb"] < 80, f"peak {res['peak_mem_gb']} GB")
    del lm
    torch.cuda.empty_cache()
    return launches


def dp_sp_train_phase(layers=DP_SP_LAYERS, steps=3):
    """``__graft_entry__.dryrun_multichip``'s dp x sp composition at dp = 2 x
    sp = 2 on the card: each dp rank's LM (the 1.3B widths, RoPE, remat) over
    2 ring shards of 4,096 tokens, the loss's targets rolled over the local
    shard as there, the shards' gradients summed, ATC SGD with the dp ranks
    combined over the one-peer Exp2 walk; the combine must shrink the
    spread."""
    import torch
    import torch.nn.functional as F

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import benchmark
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.optim import optimizers as O
    from bluefog_tpu_torch.parallel import ring_attention as R
    from bluefog_tpu_torch.replicas import RankReplicas

    dp, sp, seq = 2, 2, 8192
    dev = torch.device("cuda")
    bf.init(dp)
    cfg = TransformerConfig(vocab_size=32000, num_layers=layers, num_heads=16,
                            embed_dim=2048, max_seq_len=seq,
                            pos_encoding="rope", remat=True)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rep = RankReplicas(lambda: TransformerLM(cfg, R.ring_attention_impl(sp)),
                       dp, dev, init=lambda m: m.reset_parameters(g))
    opt = O.DistributedAdaptThenCombineOptimizer(
        torch.optim.SGD([rep.flat], lr=0.0125 * dp), use_dynamic_topology=True,
        phases=topo.one_peer_exp2_phases(dp))
    tokens = torch.randint(0, 32000, (dp, 1, seq), generator=g, device=dev)
    pos = R.shard_sequence(torch.arange(seq, device=dev)[None], sp)
    FA.reset_launch_counts()
    losses, spreads, step_s = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep.zero_grad()
        step_loss = []
        for r, mod in enumerate(rep.modules):
            shards = R.shard_sequence(tokens[r], sp)
            logits = mod(shards, positions=pos)
            nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  torch.roll(shards, -1, 1).reshape(-1),
                                  reduction="none").reshape(sp, -1)
            local = nll.mean(1)
            local.sum().backward()
            step_loss.append(local.detach())
        opt.adapt()
        before = benchmark.consensus_spread(rep.flat)["max"]
        opt.combine()
        after = benchmark.consensus_spread(rep.flat)["max"]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(torch.stack(step_loss).mean()))
        spreads.append({"after_adapt": before, "after_combine": after})
    launches = flash_launches()
    per = {"K1": 2 * layers * dp * sp, "K2": layers * dp * sp,
           "K3": layers * dp * sp}
    expected = {k: v * steps for k, v in per.items()}
    emit("dp_sp_train", config={"dp": dp, "sp": sp, "num_layers": layers,
                                "embed_dim": 2048, "num_heads": 16,
                                "vocab_size": 32000, "pos_encoding": "rope",
                                "remat": "full", "seq_len": seq,
                                "seq_local": seq // sp, "optimizer":
                                "atc sgd, one-peer exp2", "lr": 0.0125 * dp},
         losses=losses, spreads=spreads,
         step_ms_each=[1e3 * t for t in step_s], launches=launches,
         launches_per_step=per, expected_launches=expected,
         params_per_rank=rep.numel)
    require(all(math.isfinite(x) for x in losses), f"finite losses {losses}")
    require(launches == expected, f"launches {launches}, expected {expected}")
    require(all(s["after_combine"] < s["after_adapt"] for s in spreads),
            f"the combine shrinks the spread {spreads}")
    del rep, opt
    bf.shutdown()
    torch.cuda.empty_cache()
    return launches


def check_long_context_example():
    """``long_context_training``'s own entry point on the card, both
    attentions (width 512 in bf16, heads of 64): the loss falls."""
    from bluefog_tpu_torch import long_context_training as LC
    out = {}
    for attention in ("ring", "ulysses"):
        res = LC.main(["--seq-len", "4096", "--steps", "12", "--attention",
                       attention, "--rope"])
        require(res["losses"][-1] < res["losses"][0],
                f"{attention}: loss {res['losses']}")
        out[attention] = {"first_loss": res["losses"][0],
                          "last_loss": res["losses"][-1]}
    return out


def model_parallel_step(axis):
    """A tensor-parallel forward and backward over ``axis`` (a 2-layer
    SwiGLU LM, width 256, 2 heads of 128, through K1-K3) and a 1F1B step of
    its 2 blocks as the stages of ``axis``: the logits, the loss, every
    gradient."""
    import torch
    import torch.nn.functional as F

    from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    from bluefog_tpu_torch.ops.p2p import shard_axis
    from bluefog_tpu_torch.parallel import pipeline as PP
    from bluefog_tpu_torch.parallel import tensor_parallel as TPL

    dev = torch.device("cuda")
    cfg = TransformerConfig(vocab_size=512, num_layers=2, num_heads=2,
                            embed_dim=256, max_seq_len=512, mlp="swiglu")
    g = torch.Generator(device=dev).manual_seed(SEED)
    full = TransformerLM(cfg).to(dev)
    full.reset_parameters(g)
    tokens = torch.randint(0, 512, (2, 512), generator=g, device=dev)
    model = TPL.TensorParallelLM(cfg, axis).to(dev)
    model.load_state_dict(TPL.tp_shard_params(full, full.state_dict(), axis))
    logits = model(tokens)
    loss = F.cross_entropy(logits.reshape(-1, 512),
                           torch.roll(tokens, -1, 1).reshape(-1))
    loss.backward()
    out = {"tp_logits": logits.detach(), "tp_loss": loss.detach()}
    out.update({f"tp_grad/{k}": p.grad for k, p in model.named_parameters()})
    blocks = stacked_blocks(cfg, shard_axis(axis)[0])
    x = torch.randn(4, 1, 512, 256, generator=g, device=dev).bfloat16()
    pp_loss, grads = PP.pipeline_train_step(PP.blocks_stage(cfg), blocks, x,
                                            torch.zeros_like(x), pp_mse,
                                            axis=axis)
    out["pp_loss"] = pp_loss
    out.update({f"pp_grad/{k}": v for k, v in grads.items()})
    return out


def check_dist_nccl():
    """A world-size-1 NCCL process group from ``init_distributed`` (a
    localhost rendezvous): the collectives, a nonblocking op and its wait,
    one ATC step of a small LM through the transport, and a tensor-parallel
    forward and backward and a 1F1B step over ``process_ranks()``
    (:func:`model_parallel_step`), each held bit for bit to the
    single-process path on the card.  One card: nothing here crosses a
    wire."""
    import socket

    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import benchmark

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"BFTPU_COORDINATOR": f"127.0.0.1:{port}",
           "BFTPU_NUM_PROCESSES": "1", "BFTPU_PROCESS_ID": "0",
           "BFTPU_LOCAL_ID": "0"}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(1, 1000, 37, generator=g, device="cuda")
    args = benchmark.build_parser().parse_args([
        "--model", "transformer", "--flash-attention", "--atc", "--dynamic",
        "--num-layers", "2", "--embed-dim", "256", "--num-heads", "2",
        "--seq-len", "512", "--batch-size", "2", "--vocab-size", "512",
        "--ranks", "1", "--num-warmup-batches", "1", "--num-iters", "1",
        "--num-batches-per-iter", "1", "--seed", str(SEED)])

    def run():
        out = {"allreduce": bf.allreduce(x), "sum": bf.allreduce(x, average=False),
               "local_allreduce": bf.local_allreduce(x),
               "broadcast": bf.broadcast(x, 0), "allgather": bf.allgather(x),
               "neighbor_allreduce": bf.neighbor_allreduce(x),
               "dynamic_neighbor_allreduce": bf.dynamic_neighbor_allreduce(x, 0),
               "neighbor_allgather": bf.neighbor_allgather(x)}
        h = bf.allreduce_nonblocking(x)
        out["allreduce_nonblocking"] = bf.wait(h)
        out["polled_after_wait"] = bf.poll(h)
        tr = benchmark.Trainer(args)
        benchmark.measure(args, tr, quiet=True)
        out["atc_flat"] = tr.rep.flat.detach().clone()
        out.update(model_parallel_step(bf.process_ranks() or 1))
        return out

    bf.init(1)
    want = run()
    bf.shutdown()
    os.environ.update(env)
    try:
        bf.init_distributed()
        backend = torch.distributed.get_backend()
        got = run()
        world = torch.distributed.get_world_size()
    finally:
        bf.shutdown()
        for k in env:
            os.environ.pop(k)
    same = {k: bool(torch.equal(got[k], want[k])) for k in want
            if isinstance(want[k], torch.Tensor)}
    require(backend == "nccl" and world == 1, f"{backend} world {world}")
    require(all(same.values()), f"NCCL path differs from one process: {same}")
    require(got["polled_after_wait"], "a waited handle polls done")
    return {"backend": backend, "world_size": world,
            "device_count": torch.cuda.device_count(), "bitwise": same}


def check_tp_reference(seed):
    """``tp_reference``: a 2-layer SwiGLU LM (width 512, 4 heads of 128,
    bf16) through K1-K3 cut over rank-major tp shards against the same
    weights unsharded through K1-K3: as MHA at tp 2, and as GQA with 2 kv
    heads at tp 4 (the kv shards are half groups, gathered back).  Logits
    and every parameter's gradient (the shards put back together) by
    relative error; K1 launches once a layer in the forward."""
    import torch
    import torch.nn.functional as F

    from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.parallel import tensor_parallel as TPL

    dev = torch.device("cuda")
    out = {}
    for case, kw, tp in (("mha", {}, 2), ("gqa", dict(num_kv_heads=2), 4)):
        cfg = TransformerConfig(vocab_size=512, num_layers=2, num_heads=4,
                                embed_dim=512, max_seq_len=1024, mlp="swiglu",
                                **kw)
        g = torch.Generator(device=dev).manual_seed(seed)
        full = TransformerLM(cfg, FA.flash_attention_impl()).to(dev)
        full.reset_parameters(g)
        tokens = torch.randint(0, 512, (2, 1024), generator=g, device=dev)
        want_logits, want = logits_and_grads(full, tokens)
        model = TPL.TensorParallelLM(cfg, tp).to(dev)
        model.load_state_dict(TPL.tp_shard_params(full, full.state_dict(), tp))
        FA.reset_launch_counts()
        logits = model(tokens)
        torch.cuda.synchronize()
        forward = flash_launches()
        F.cross_entropy(logits.reshape(-1, 512),
                        torch.roll(tokens, -1, 1).reshape(-1)).backward()
        torch.cuda.synchronize()
        launches = flash_launches()
        specs = TPL.tp_param_specs(full, tp)
        params = dict(model.named_parameters())
        grad_err = {}
        for k, spec in specs.items():
            got = params[k].grad
            if spec is not None:
                got = torch.cat(list(got), spec[1])
            grad_err[k] = rel_err(got, want[k])
        worst = max(grad_err, key=grad_err.get)
        logit_err = rel_err(logits.detach(), want_logits)
        layers = cfg.num_layers
        require(forward["K1"] == layers and launches == {
            "K1": layers, "K2": layers, "K3": layers},
            f"tp_reference {case}: launches {launches} (forward {forward})")
        require(logit_err <= REF_LOGITS_TOL,
                f"tp_reference {case}: logits differ by {logit_err}")
        require(grad_err[worst] <= REF_GRAD_TOL,
                f"tp_reference {case}: gradient of {worst} differs by "
                f"{grad_err[worst]}")
        out[case] = {"tp": tp, "num_kv_heads": cfg.num_kv_heads or 4,
                     "launches": launches, "logits_rel_err": logit_err,
                     "grad_rel_err": grad_err[worst],
                     "grad_rel_err_worst_param": worst}
        del full, model
    out["tol"] = {"logits": REF_LOGITS_TOL, "grad": REF_GRAD_TOL}
    return out


def tp_train_phase(layers=LAYERS, steps=4):
    """``__graft_entry__.dryrun_multichip``'s tensor-parallel step at dp 2 x
    tp 2 on 4 virtual ranks of the card: ``tensor_parallel_training.
    DataTensorParallelLM`` at the 1.3B LM's widths (MHA, SwiGLU, learned
    positions, no remat; bf16 over float32), batch 2 a dp rank, ATC SGD
    combined over dp by the one-peer Exp2 walk (at dp 2 the exact average:
    the spread is 0.0 after every combine); then a ``profile_step`` profile
    of one more step (idle share, K1-K3, the tp sums).  Returns the
    launches of the ``steps`` steps."""
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import benchmark, profile_step
    from bluefog_tpu_torch import tensor_parallel_training as TPT
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.models.transformer import TransformerConfig
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.optim import optimizers as O

    dp, tp, seq, batch = TP_DP, TP_WAYS, 2048, 2
    dev = torch.device("cuda")
    cfg = TransformerConfig(vocab_size=32000, num_layers=layers, num_heads=16,
                            embed_dim=2048, max_seq_len=seq, mlp="swiglu")
    g = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, 32000, (dp, batch, seq + 1), generator=g,
                         device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    bf.init(dp)
    lm = TPT.DataTensorParallelLM(
        cfg, tp, toks[..., :-1], toks[..., 1:], lambda params:
        O.DistributedAdaptThenCombineOptimizer(
            torch.optim.SGD(params, lr=0.0125 * dp), use_dynamic_topology=True,
            phases=topo.one_peer_exp2_phases(dp)), seed=SEED)
    require(lm.params_per_replica == TP_PARAMS,
            f"{lm.params_per_replica} parameters a replica, expected "
            f"{TP_PARAMS}")
    FA.reset_launch_counts()
    losses, spreads, step_s = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(lm.forward_backward())
        lm.opt.adapt()
        before = benchmark.consensus_spread(lm.rep.flat)["max"]
        lm.opt.combine()
        after = benchmark.consensus_spread(lm.rep.flat)["max"]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        spreads.append({"after_adapt": before, "after_combine": after})
    launches = flash_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [float(x) for x in losses]
    per = {k: layers * dp for k in ("K1", "K2", "K3")}
    expected = {k: v * steps for k, v in per.items()}
    step_ms = 1e3 * sum(step_s[1:]) / (steps - 1)  # the first step tunes
    prof = profile_step.profile(lm, "transformer (dp x tp)")
    res = {"config": {"dp": dp, "tp": tp, "num_layers": layers,
                      "embed_dim": 2048, "num_heads": 16,
                      "heads_per_shard": 16 // tp, "head_dim": 128,
                      "vocab_size": 32000, "mlp": "swiglu",
                      "pos_encoding": "learned", "remat": None,
                      "seq_len": seq, "batch_per_dp_rank": batch,
                      "optimizer": "atc sgd, one-peer exp2",
                      "lr": 0.0125 * dp},
           "params_per_replica": lm.params_per_replica, "losses": losses,
           "spreads": spreads, "step_ms": step_ms,
           "step_ms_each": [1e3 * t for t in step_s],
           "tokens_per_s": dp * batch * seq / (step_ms / 1e3),
           "peak_mem_gb": peak, "launches": launches,
           "launches_per_step": per, "expected_launches": expected,
           "k1_k3_ms": prof["families_ms"].get("flash attention (K1-K3)"),
           "tp_sum": prof["named_ops"].get("tp::row_sum"),
           "profile": {k: prof[k] for k in (
               "phases", "profiled_step_wall_ms", "kernel_busy_ms",
               "device_idle_share", "idle_share_of_event_step",
               "families_ms", "top_kernels", "top_ops")}}
    emit("tp_train", **res)
    require(all(math.isfinite(x) for x in losses), f"finite losses {losses}")
    require(launches == expected, f"launches {launches}, expected {expected}")
    require(all(s["after_combine"] == 0.0 for s in spreads),
            f"dp 2 combines to the exact average: {spreads}")
    require(peak < 80, f"peak {peak} GB")
    require(0 < prof["kernel_busy_ms"] <= prof["profiled_step_wall_ms"],
            f"device busy {prof['kernel_busy_ms']} ms")
    del lm
    bf.shutdown()
    torch.cuda.empty_cache()
    return launches


def moe_loss(model, tokens, routes=None):
    """Next-token cross-entropy plus 0.01 x the blocks' load-balancing
    losses; ``routes`` receives each block's routing decisions (a forward
    hook on the router, the first forward only)."""
    import torch
    import torch.nn.functional as F
    hooks = []
    if routes is not None:
        for blk in model.blocks:
            hooks.append(blk.moe.router.register_forward_hook(
                lambda m, i, o: routes.append(o.argmax(-1))))
    aux = []
    logits = model(tokens, moe_aux=aux)
    for h in hooks:
        h.remove()
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           torch.roll(tokens, -1, 1).reshape(-1))
    return logits, loss + 0.01 * torch.stack(aux).sum()


def check_tp_moe_reference(seed):
    """``tp_moe_reference``: the MoE LM at full width, float32, dense
    attention: ``TensorParallelLM`` at tp 2 with remat, experts whole and
    over an 8-rank expert axis, against the unsharded model on the card;
    and remat against none."""
    import torch

    from bluefog_tpu_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM,
                                                      local_attention)
    from bluefog_tpu_torch.parallel import tensor_parallel as TPL
    dev = torch.device(DEVICE)
    w = LM_WIDTHS

    def cfg(remat):
        return TransformerConfig(
            vocab_size=w["vocab"], num_layers=TP_MOE_LAYERS,
            num_heads=w["heads"], embed_dim=w["width"],
            max_seq_len=w["seq"], num_experts=TP_MOE_EXPERTS,
            dtype=torch.float32, remat=remat)
    g = torch.Generator(device=dev).manual_seed(seed)
    full = TransformerLM(cfg(False)).to(dev)
    full.reset_parameters(g)
    tokens = torch.randint(0, w["vocab"], (1, w["seq"]), generator=g,
                           device=dev)
    want_routes = []
    want_logits, loss = moe_loss(full, tokens, want_routes)
    loss.backward()
    want = {k: p.grad for k, p in full.named_parameters()}
    out = {"params": sum(p.numel() for p in full.parameters())}
    for layout, ep in (("whole", None), ("ep", TP_MOE_EXPERTS)):
        model = TPL.TensorParallelLM(cfg(True), 2, local_attention,
                                     ep_axis=ep).to(dev)
        model.load_state_dict(TPL.tp_shard_params(full, full.state_dict(),
                                                  2, ep_axis=ep))
        routes = []
        sync()
        t0 = time.perf_counter()
        logits, loss = moe_loss(model, tokens, routes)
        loss.backward()
        sync()
        seconds = time.perf_counter() - t0
        flips = sum(int((a != b).sum()) for a, b in zip(
            want_routes, routes[:len(want_routes)]))
        specs = TPL.tp_param_specs(full, 2, ep_axis=ep)
        grads = {}
        for k, p in model.named_parameters():
            got = p.grad
            if specs[k] is not None:
                got = torch.cat(list(got), specs[k][1])
            grads[k] = got.clone()
        grad_err = {k: rel_err(v, want[k]) for k, v in grads.items()}
        worst = max(grad_err, key=grad_err.get)
        logit_err = rel_err(logits.detach(), want_logits)
        # The same model without remat.
        model.cfg.remat = False
        model.zero_grad()
        plain_logits, loss = moe_loss(model, tokens)
        loss.backward()
        remat_err = max([rel_err(logits.detach(), plain_logits.detach())]
                        + [rel_err(grads[k], torch.cat(
                            list(p.grad), specs[k][1])
                            if specs[k] is not None else p.grad)
                           for k, p in model.named_parameters()])
        require(logit_err <= REF_LOGITS_TOL,
                f"tp_moe_reference {layout}: logits differ by {logit_err}")
        require(grad_err[worst] <= REF_GRAD_TOL,
                f"tp_moe_reference {layout}: gradient of {worst} differs "
                f"by {grad_err[worst]}")
        require(remat_err <= REF_LOGITS_TOL,
                f"tp_moe_reference {layout}: remat vs none {remat_err}")
        out[layout] = {"ep_axis": ep, "routing_flips": flips,
                       "tokens_routed": TP_MOE_LAYERS * w["seq"],
                       "logits_rel_err": logit_err,
                       "grad_rel_err": grad_err[worst],
                       "grad_rel_err_worst_param": worst,
                       "remat_vs_none_rel_err": remat_err,
                       "remat_step_s": seconds}
        del model, grads
        empty_cache()
    out["tol"] = {"logits": REF_LOGITS_TOL, "grad": REF_GRAD_TOL}
    del full, want
    empty_cache()
    return out


def tp_moe_train_phase(layers=TP_MOE_LAYERS, steps=TP_MOE_STEPS):
    """dp 2 x tp 2 of the switch-MoE LM (experts whole on each shard, full
    remat) through K1-K3: ``tensor_parallel_training.
    DataTensorParallelLM``, ATC SGD over the one-peer Exp2 walk; then one
    step without remat, timed, for the recompute's share.  Returns the
    launches of the ``steps`` steps."""
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import benchmark
    from bluefog_tpu_torch import tensor_parallel_training as TPT
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.models.transformer import TransformerConfig
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.optim import optimizers as O

    dp, tp, batch = TP_DP, TP_WAYS, 2
    w = LM_WIDTHS
    dev = torch.device(DEVICE)
    cfg = TransformerConfig(vocab_size=w["vocab"], num_layers=layers,
                            num_heads=w["heads"], embed_dim=w["width"],
                            max_seq_len=w["seq"], remat=True,
                            num_experts=TP_MOE_EXPERTS)
    g = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, w["vocab"], (dp, batch, w["seq"] + 1),
                         generator=g, device=dev)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    bf.init(dp, device=DEVICE)
    lm = TPT.DataTensorParallelLM(
        cfg, tp, toks[..., :-1], toks[..., 1:], lambda params:
        O.DistributedAdaptThenCombineOptimizer(
            torch.optim.SGD(params, lr=0.0125 * dp), use_dynamic_topology=True,
            phases=topo.one_peer_exp2_phases(dp)), seed=SEED)
    FA.reset_launch_counts()

    def step():
        sync()
        t0 = time.perf_counter()
        loss = lm.forward_backward()
        lm.opt.adapt()
        before = benchmark.consensus_spread(lm.rep.flat)["max"]
        lm.opt.combine()
        after = benchmark.consensus_spread(lm.rep.flat)["max"]
        sync()
        return (time.perf_counter() - t0, float(loss),
                {"after_adapt": before, "after_combine": after})
    runs = [step() for _ in range(steps)]
    launches = flash_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if DEVICE == "cuda" else None
    cfg.remat = False
    plain_s = step()[0]
    cfg.remat = True
    step_s = [r[0] for r in runs]
    losses = [r[1] for r in runs]
    step_ms = 1e3 * sum(step_s[1:]) / (steps - 1)
    per = {"K1": 2 * layers * dp, "K2": layers * dp, "K3": layers * dp}
    expected = {k: v * steps for k, v in per.items()}
    res = {"config": {"dp": dp, "tp": tp, "num_layers": layers,
                      "embed_dim": w["width"], "num_heads": w["heads"],
                      "num_experts": TP_MOE_EXPERTS, "experts": "whole",
                      "vocab_size": w["vocab"], "seq_len": w["seq"],
                      "batch_per_dp_rank": batch, "remat": "full",
                      "optimizer": "atc sgd, one-peer exp2"},
           "params_per_replica": lm.params_per_replica, "losses": losses,
           "spreads": [r[2] for r in runs], "step_ms": step_ms,
           "step_ms_each": [1e3 * t for t in step_s],
           "tokens_per_s": dp * batch * w["seq"] / (step_ms / 1e3),
           "peak_mem_gb": peak, "launches": launches,
           "launches_per_step": per, "expected_launches": expected,
           "step_ms_without_remat": 1e3 * plain_s,
           "recompute_share": (step_ms - 1e3 * plain_s) / step_ms}
    emit("tp_moe_train", **res)
    require(all(math.isfinite(x) for x in losses), f"finite losses {losses}")
    if DEVICE == "cuda":
        require(launches == expected,
                f"launches {launches}, expected {expected}")
        require(peak < 80, f"peak {peak} GB")
    require(all(r[2]["after_combine"] == 0.0 for r in runs),
            f"dp 2 combines to the exact average: {res['spreads']}")
    del lm
    bf.shutdown()
    empty_cache()
    return launches


def stacked_blocks(cfg, stages, seed=SEED):
    """The blocks of ``cfg``'s ``TransformerLM`` (``reset_parameters`` from
    ``seed`` on the card), stacked ``(stages, layers / stages, ...)`` by
    ``Block`` parameter name."""
    import torch

    from bluefog_tpu_torch.models.transformer import TransformerLM
    dev = torch.device("cuda")
    full = TransformerLM(cfg).to(dev)
    full.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    names = list(full.blocks[0].state_dict())
    per = cfg.num_layers // stages
    out = {k: torch.stack([blk.state_dict()[k] for blk in full.blocks])
           .reshape((stages, per) + tuple(full.blocks[0].state_dict()[k].shape))
           for k in names}
    del full
    torch.cuda.empty_cache()
    return out


def pp_inputs(cfg, M, seed=SEED):
    """``M`` microbatches of one 2048-token sequence of bf16 activations and
    their targets, from ``seed``."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    shape = (M, 1, cfg.max_seq_len, cfg.embed_dim)
    return tuple(torch.randn(shape, generator=g, device="cuda")
                 .to(cfg.dtype) for _ in range(2))


def pp_mse(y, t):
    return ((y.float() - t.float()) ** 2).mean()


def pp_train_phase(layers=PP_LAYERS, stages=PP_STAGES, M=PP_MICROBATCHES,
                   steps=3, lr=0.01):
    """``pp_train``: 1F1B (``parallel.pipeline.pipeline_train_step``) of
    ``PP_LAYERS`` = 8 blocks of the tp_train model over 4 rank-major
    stages of 2, ``M`` = 8 microbatches of one 2048-token sequence, the
    mean squared error of the last stage's output against a synthetic
    target, 3 SGD steps.  The first step's loss and gradients against
    autograd through the same blocks
    run in sequence on the card (each microbatch's loss / M backpropagated
    in turn), by relative error; then ``profile_step.trace`` of one more
    step.  Returns the steps' launches."""
    import torch

    from bluefog_tpu_torch import profile_step
    from bluefog_tpu_torch.models.transformer import TransformerConfig
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.parallel import pipeline as PP

    dev = torch.device("cuda")
    cfg = TransformerConfig(vocab_size=32000, num_layers=layers, num_heads=16,
                            embed_dim=2048, max_seq_len=2048, mlp="swiglu")
    params = stacked_blocks(cfg, stages)
    n_params = sum(v.numel() for v in params.values())
    require(n_params == PP_BLOCK_PARAMS,
            f"{n_params} block parameters, expected {PP_BLOCK_PARAMS}")
    x, tgt = pp_inputs(cfg, M)
    stage = PP.blocks_stage(cfg)
    flat = {k: v.detach().reshape((layers,) + tuple(v.shape[2:]))
            .requires_grad_() for k, v in params.items()}
    ref_loss = 0.0
    for m in range(M):
        loss = pp_mse(stage(flat, x[m]), tgt[m]) / M
        loss.backward()
        ref_loss += float(loss.detach())
    ref = {k: v.grad for k, v in flat.items()}
    del flat
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    FA.reset_launch_counts()
    losses, step_s, check = [], [], None
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = PP.pipeline_train_step(stage, params, x, tgt, pp_mse,
                                             axis=stages)
        with torch.no_grad():
            for k, gk in grads.items():
                params[k] -= lr * gk
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if step == 0:
            err = {k: rel_err(gk.reshape(ref[k].shape), ref[k])
                   for k, gk in grads.items()}
            worst = max(err, key=err.get)
            check = {"loss_rel_err": abs(losses[0] - ref_loss) / ref_loss,
                     "grad_rel_err": err[worst],
                     "grad_rel_err_worst_param": worst}
        del grads
    launches = flash_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    per = {"K1": 2 * layers * M, "K2": layers * M, "K3": layers * M}
    expected = {k: v * steps for k, v in per.items()}
    step_ms = 1e3 * sum(step_s[1:]) / (steps - 1)
    del ref
    prof = profile_step.trace(lambda: PP.pipeline_train_step(
        stage, params, x, tgt, pp_mse, axis=stages))
    emit("pp_train", config={"schedule": "1f1b", "stages": stages,
                             "blocks": layers, "blocks_per_stage":
                             layers // stages, "microbatches": M,
                             "microbatch": [1, 2048], "embed_dim": 2048,
                             "num_heads": 16, "mlp": "swiglu",
                             "loss": "mse", "optimizer": "sgd", "lr": lr},
         block_params=n_params, ticks=2 * M + 2 * stages - 2, losses=losses,
         sequential_loss=ref_loss, reference=check, step_ms=step_ms,
         step_ms_each=[1e3 * t for t in step_s],
         tokens_per_s=M * 2048 / (step_ms / 1e3), peak_mem_gb=peak,
         launches=launches, launches_per_step=per,
         expected_launches=expected,
         k1_k3_ms=prof["families_ms"].get("flash attention (K1-K3)"),
         profile={k: prof[k] for k in (
             "profiled_step_wall_ms", "kernel_busy_ms", "device_idle_share",
             "families_ms", "top_kernels", "top_ops")},
         tol={"loss": REF_LOGITS_TOL, "grad": REF_GRAD_TOL})
    require(all(math.isfinite(v) for v in losses), f"finite losses {losses}")
    require(launches == expected, f"launches {launches}, expected {expected}")
    require(check["loss_rel_err"] <= REF_LOGITS_TOL, f"pp_train loss {check}")
    require(check["grad_rel_err"] <= REF_GRAD_TOL, f"pp_train grads {check}")
    require(peak < 80, f"peak {peak} GB")
    del params
    torch.cuda.empty_cache()
    return launches


def pp_variants_phase(layers=PP_VARIANT_LAYERS, stages=PP_STAGES,
                      M=PP_MICROBATCHES):
    """``pp_variants``: the other schedules on ``layers`` blocks of the same
    model, 4 stages, 8 microbatches: plain 1F1B, then GPipe (autograd
    through ``pipeline_apply``), interleaved 1F1B with v = 2 (rank r's chunk
    c one block, global stage ``c * 4 + r``) and ZB-H1 (``split_backward``),
    each step's gradients against the plain 1F1B's by relative error; each
    schedule runs once to warm, then once timed and counted.  Returns the
    launches of the four counted runs together."""
    import torch

    from bluefog_tpu_torch.models.transformer import TransformerConfig
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.parallel import pipeline as PP

    cfg = TransformerConfig(vocab_size=32000, num_layers=layers, num_heads=16,
                            embed_dim=2048, max_seq_len=2048, mlp="swiglu")
    params = stacked_blocks(cfg, stages)
    x, tgt = pp_inputs(cfg, M)
    stage = PP.blocks_stage(cfg)
    per = layers // stages
    flat = lambda g: {k: v.reshape((layers,) + tuple(v.shape[2:]))  # noqa
                      for k, v in g.items()}
    v = 2
    order = [[c * stages + r for c in range(v)] for r in range(stages)]
    index = torch.tensor(order, device=x.device)
    chunked = {k: t[index][:, :, None] for k, t in flat(params).items()}

    def gpipe():
        leaves = {k: t.detach().requires_grad_() for k, t in params.items()}
        y = PP.pipeline_apply(stage, leaves, x, axis=stages)
        loss = torch.stack([pp_mse(y[m], tgt[m]) for m in range(M)]).mean()
        loss.backward()
        return loss.detach(), {k: t.grad for k, t in leaves.items()}

    def interleaved():
        loss, g = PP.pipeline_train_step_interleaved(
            stage, chunked, x, tgt, pp_mse, axis=stages)
        back = {}
        for k, t in g.items():
            out = torch.empty((layers,) + tuple(t.shape[3:]), dtype=t.dtype,
                              device=t.device)
            for r in range(stages):
                for c in range(v):
                    out[order[r][c]] = t[r, c, 0]
            back[k] = out.reshape(params[k].shape)
        return loss, back

    runs = {
        "1f1b": lambda: PP.pipeline_train_step(stage, params, x, tgt, pp_mse,
                                               axis=stages),
        "gpipe": gpipe, "interleaved_v2": interleaved,
        "zb_h1": lambda: PP.pipeline_train_step(stage, params, x, tgt, pp_mse,
                                                axis=stages,
                                                split_backward=True)}
    expected = {"1f1b": (2, 1, 1), "gpipe": (1, 1, 1),
                "interleaved_v2": (2, 1, 1), "zb_h1": (3, 2, 2)}
    out, total, base = {}, {"K1": 0, "K2": 0, "K3": 0}, None
    for name, run in runs.items():
        run()      # warm: the allocator grows once for each schedule
        FA.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = flash_launches()
        want = {k: n * layers * M for k, n in zip(("K1", "K2", "K3"),
                                                   expected[name])}
        require(launches == want, f"{name} launches {launches}, expected "
                f"{want}")
        grads = flat(grads)
        if base is None:
            base = (float(loss), grads)
            res = {}
        else:
            err = {k: rel_err(grads[k], base[1][k]) for k in grads}
            worst = max(err, key=err.get)
            res = {"loss_rel_err_vs_1f1b": abs(float(loss) - base[0])
                   / base[0], "grad_rel_err_vs_1f1b": err[worst],
                   "grad_rel_err_worst_param": worst}
            require(res["loss_rel_err_vs_1f1b"] <= REF_LOGITS_TOL
                    and err[worst] <= REF_GRAD_TOL, f"{name}: {res}")
        out[name] = {"loss": float(loss), "ms": ms, "launches": launches,
                     **res}
        for k in total:
            total[k] += launches[k]
        del grads
    emit("pp_variants", config={"blocks": layers, "stages": stages,
                                "blocks_per_stage": per, "microbatches": M,
                                "interleaved_chunks": v, "embed_dim": 2048,
                                "num_heads": 16, "mlp": "swiglu"},
         runs=out, launches=total,
         tol={"loss": REF_LOGITS_TOL, "grad": REF_GRAD_TOL})
    del params, chunked, base
    torch.cuda.empty_cache()
    return total


def check_compositions(seed):
    """``dp_tp_pp_ep``: the two compositions of ``__graft_entry__.
    dryrun_multichip`` at 8 virtual ranks and its shapes, ``parallel.
    composed``'s steps in float32 on the card (TF32 off), each dp replica
    its own data: dp x tp x pp (2 x 2 x 2; d 8, hidden 8, 4 microbatches of
    2) and dp x tp x pp x ep with tp and ep on one mp axis (2 x 2 x 2; d 6,
    hidden 8, 2 experts of capacity 4, 4 microbatches of 4).  Each against
    its dense sequential step on the card: every dp replica's SGD update of
    the unsharded weights, averaged over dp (the ring combine at dp 2)."""
    import torch

    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import schedule as S
    from bluefog_tpu_torch.parallel import composed as TC
    from bluefog_tpu_torch.parallel.moe import switch_dispatch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    sched = S.compile_static(topo.RingGraph(2), use_topo_weights=False)
    lr, dp, mp, pp = 0.1, 2, 2, 2
    out = {}
    for case, (d, hid, M, mb, E) in (("dp_tp_pp", (8, 8, 4, 2, 0)),
                                     ("dp_tp_pp_ep", (6, 8, 4, 4, 2))):
        hs = hid // mp
        full = [rnd(pp, d, hid) * 0.3, rnd(pp, hid, d) * 0.3]
        if E:
            full += [rnd(pp, E, d, d) * 0.3, rnd(pp, d, E) * 0.3]
        x, tgt = rnd(dp, M, mb, d), torch.zeros(dp, M, mb, d, device=dev)

        def stage(w, s, z):
            y = torch.relu(z @ w[0][s]) @ w[1][s]
            if not E:
                return y
            combine, dispatch = switch_dispatch(y @ w[3][s], E, 4)
            return y + sum(combine[:, e] @ torch.tanh(
                (dispatch[e] @ y) @ w[2][s, e]) for e in range(E))

        want, want_loss = [torch.zeros_like(w) for w in full], []
        for r in range(dp):
            w = [t.clone().requires_grad_() for t in full]
            losses = []
            for m in range(M):
                z = x[r, m]
                for s in range(pp):
                    z = stage(w, s, z)
                losses.append(((z - tgt[r, m]) ** 2).mean())
            loss = torch.stack(losses).mean()
            grads = torch.autograd.grad(loss, w)
            want_loss.append(float(loss.detach()))
            for acc, t, gr in zip(want, full, grads):
                acc += (t - lr * gr) / dp
        lead = lambda t: t[None].expand((dp,) + t.shape).clone()  # noqa
        shards = [full[0].reshape(pp, d, mp, hs).transpose(1, 2),
                  full[1].reshape(pp, mp, hs, d)]
        if E:
            shards += [full[2], full[3][:, None].expand(pp, mp, d, E)]
            new, loss = TC.dp_tp_pp_ep_step(tuple(lead(t) for t in shards), x,
                                            tgt, lr=lr, sched=sched,
                                            capacity=4)
        else:
            new, loss = TC.dp_tp_pp_step(tuple(lead(t) for t in shards), x,
                                         tgt, lr=lr, sched=sched)
        got = [new[0].transpose(2, 3).reshape(dp, pp, d, hid),
               new[1].reshape(dp, pp, hid, d)]
        if E:
            got += [new[2], new[3]]
        rtol, atol = COMPOSED_TOL
        errs = []
        for name, a, b in zip(("wi", "wo", "we", "wr"), got, want):
            for r in range(dp):
                if name == "wr":   # every mp rank's router copy
                    ok = torch.allclose(a[r], b[:, None].expand_as(a[r]),
                                        rtol=rtol, atol=atol)
                    errs.append(float((a[r] - b[:, None]).abs().max()))
                else:
                    ok = torch.allclose(a[r], b, rtol=rtol, atol=atol)
                    errs.append(float((a[r] - b).abs().max()))
                require(ok, f"{case}: {name} of dp rank {r} differs from "
                        f"the dense step by {errs[-1]}")
        losses = [float(v) for v in loss]
        require(all(math.isfinite(v) for v in losses), f"{case} {losses}")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_loss))
        require(loss_err <= 1e-5, f"{case}: losses {losses} vs {want_loss}")
        out[case] = {"dp": dp, "mp": mp, "pp": pp, "d": d, "hidden": hid,
                     "experts": E, "microbatches": M, "microbatch": mb,
                     "losses": losses, "loss_rel_err": loss_err,
                     "param_max_abs_err": max(errs)}
    out["tol"] = {"rtol": COMPOSED_TOL[0], "atol": COMPOSED_TOL[1],
                  "loss_rtol": 1e-5}
    return out


# ---------------------------------------------------------------------------
# Hierarchical gossip and the one-sided windows
# ---------------------------------------------------------------------------

def train_argv(iters):
    """The ``train`` phase's benchmark flags: the 1.3B MHA LM, 4 ranks,
    ATC over the dynamic one-peer walk, K1-K3, one warmup step and
    ``iters`` timed."""
    return ["--model", "transformer",
            "--num-layers", str(LAYERS), "--embed-dim", "2048",
            "--num-heads", "16", "--seq-len", "2048", "--batch-size", "2",
            "--vocab-size", "32000", "--momentum", "0", "--ranks", "4",
            "--atc", "--dynamic", "--flash-attention",
            "--num-warmup-batches", "1", "--num-iters", str(iters),
            "--num-batches-per-iter", "1", "--seed", str(SEED),
            "--device", DEVICE]


def _env_set(values):
    """Set (a value) or unset (None) environment variables and reload the
    port's config; returns the values they had."""
    from bluefog_tpu_torch.utils import config
    before = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    config.reload()
    return before


def rig_leg(phase, module, argv):
    """One leg of a bench rig (ROADMAP item 22d) in this process on
    ``DEVICE``: its JSON last line, which must say the rig passed, on a
    line of ``phase`` with the leg's seconds.  Returns that line."""
    import contextlib
    import importlib
    import io
    mod = importlib.import_module(f"bluefog_tpu_torch.{module}")
    argv = [*argv, "--device", DEVICE]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    require(lines, f"{module} {argv}: no output")
    # bench_comm returns its exit code, window_benchmark its summary.
    require(not isinstance(rc, int) or rc == 0,
            f"{module} {argv}: exit {rc}: {lines[-1][:2000]}")
    line = json.loads(lines[-1])
    emit(phase, leg=f"{module} {' '.join(argv)}", seconds=seconds,
         result=line)
    return line


def sync_warnings(tr, telemetry_on):
    """The synchronizing CUDA calls one training step of ``tr`` makes
    (``torch.cuda.set_sync_debug_mode("warn")``), with telemetry on or
    off and every opt-in sampler at its default (off).  The first such
    step after others makes one more than the next, whichever the
    setting: take a step before the counted ones."""
    import warnings

    import torch
    before = _env_set({"BLUEFOG_TPU_TELEMETRY":
                       "1" if telemetry_on else "0"})
    try:
        sync()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                tr.forward_backward()
                tr.opt.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        sync()
    finally:
        _env_set(before)
    return sum("synchroniz" in str(w.message) for w in caught)


def host_data_phase(benchmark, tr, train_res):
    """``benchmark --host-data`` on the ``train`` phase's trainer (the
    1.3B LM, 4 ranks, K1-K3): its batches from host memory through
    ``data.prefetch_to_device`` (depth 2: a pinned copy and an async
    transfer a batch), one warmup step and ``HOST_DATA_ITERS`` timed; the
    step ms beside the device-resident feed's.  Returns the launches."""
    from bluefog_tpu_torch.ops import flash_attention as FA
    args = benchmark.build_parser().parse_args(
        train_argv(HOST_DATA_ITERS) + ["--host-data"])
    FA.reset_launch_counts()
    res = benchmark.measure(args, tr)
    launches = flash_launches()
    steps = args.num_warmup_batches + HOST_DATA_ITERS
    expected = LAYERS * args.ranks * steps
    require(res["host_data"] and res["steps"] == train_res["steps"] + steps,
            f"host-data steps {res['steps']}")
    require(all(math.isfinite(x) for row in res["losses_by_step"]
                for x in row), f"host-data losses {res['losses_by_step']}")
    require(all(c == expected for c in launches.values()),
            f"host-data launches {launches}, expected {expected} of each")
    emit("train_host_data", config={"num_layers": LAYERS, **LM_WIDTHS,
                                    "batch_size": 2, "ranks": args.ranks,
                                    "feed": "prefetch_to_device(size=2)"},
         step_ms=res["step_ms"], device_feed_step_ms=train_res["step_ms"],
         tokens_per_s=res["tokens_per_s"],
         device_feed_tokens_per_s=train_res["tokens_per_s"],
         rates=res["rates"], losses_by_step=res["losses_by_step"],
         launches=launches, expected_launches=expected)
    return launches


def observe_train_phase(benchmark, train_res):
    """``observe_train``: the ``train`` phase's LM through
    ``benchmark.measure`` with all of item 21 armed: a timeline
    (``BLUEFOG_TIMELINE``, the native writer), the synced step profile
    every step, the consensus gauge every 2 steps, ``--metrics-file`` and
    the endpoint on an ephemeral port.  Requires the K1-K3 launches, the
    losses bit for bit ``train``'s, the timeline's spans and anchor, the
    ``record_function`` ranges in a ``profile_step.trace`` of one step,
    the comm counters, the step-phase histograms, the consensus gauge
    shrinking across a combine, one metrics line a step and the
    endpoint's answers; then the sync-warning counts of a step with
    telemetry on and off, and an eager ``neighbor_allreduce``'s times
    with telemetry on and off.  Returns the measured steps' launches."""
    import shutil
    import tempfile
    import urllib.request

    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import basics, profile_step
    from bluefog_tpu_torch.ops import collective as C
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.utils import telemetry as T
    from bluefog_tpu_torch.utils import timeline as TL

    tmp = tempfile.mkdtemp(prefix="observe_")
    prefix = os.path.join(tmp, "tl_")
    metrics = os.path.join(tmp, "metrics.jsonl")
    saved = _env_set({**OBSERVE_KNOBS, "BLUEFOG_TIMELINE": prefix,
                      "BLUEFOG_TPU_TELEMETRY": None,
                      "BLUEFOG_TPU_PYTHON_TIMELINE": None})
    try:
        T.reset()
        args = benchmark.build_parser().parse_args(
            train_argv(OBSERVE_ITERS) + ["--metrics-file", metrics])
        FA.reset_launch_counts()
        tr = benchmark.Trainer(args)
        res = benchmark.measure(args, tr)
        launches = flash_launches()
        snap = T.snapshot()
        TL.stop_timeline()
        _env_set({"BLUEFOG_TIMELINE": None})
        steps = args.num_warmup_batches + OBSERVE_ITERS
        timed = OBSERVE_ITERS * args.num_batches_per_iter
        expected = LAYERS * args.ranks * steps
        require(all(c == expected for c in launches.values()),
                f"observe_train launches {launches}, expected {expected}")
        want = train_res["losses_by_step"][:steps]
        require(res["losses_by_step"] == want,
                f"observe_train losses {res['losses_by_step']} are not "
                f"train's {want} bit for bit")
        # The timeline: strict JSON, one ENQUEUE/COMMUNICATE pair a
        # combine, the anchor in the native writer's sidecar.
        path = f"{prefix}0.json"
        with open(path) as f:
            events = json.load(f)
        op = "dynamic_neighbor_allreduce"
        pairs = {ph: sum(e["cat"] == op and e["name"] == ph and
                         e["ph"] == "B" for e in events)
                 for ph in ("ENQUEUE", "COMMUNICATE")}
        closed = sum(e["cat"] == op and e["ph"] == "E" for e in events)
        require(pairs == {"ENQUEUE": steps, "COMMUNICATE": steps}
                and closed == 2 * steps,
                f"timeline spans of {op}: {pairs}, {closed} closed")
        with open(path + ".anchor.json") as f:
            anchor = json.load(f)
        require({"monotonic_us", "unix_us", "rank"} <= set(anchor),
                f"clock anchor {anchor}")
        # The host tools over it: python -m bluefog_tpu_torch.tools
        # trace-merge <prefix>, then trace-summary of the merged file.
        from bluefog_tpu_torch import tools
        t_tools = time.perf_counter()
        merged_path = tools.trace_merge(prefix,
                                        os.path.join(tmp, "merged.json"))
        with open(merged_path) as f:
            merged = json.load(f)
        summary = tools.trace_summary(merged_path)
        lanes = sorted({e.get("pid") for e in merged if "ts" in e
                        and e.get("ph") in ("B", "E")})
        require(lanes == [0] and "COMMUNICATE" in summary
                and "ENQUEUE" in summary,
                f"trace-merge lanes {lanes}, trace-summary:\n{summary}")
        trace_tools = {"seconds": time.perf_counter() - t_tools,
                       "merged_events": len(merged), "lanes": lanes,
                       "summary": summary.splitlines()}
        # The counters: the schedule's rounds x steps.
        rounds = C.schedule_wire_stats(basics.dynamic_schedule())[0]
        calls = snap.get(f'bf_comm_calls_total{{op="{op}"}}')
        got_rounds = snap.get(f'bf_comm_rounds_total{{op="{op}"}}')
        require(calls == steps and got_rounds == rounds * steps,
                f"bf_comm_calls_total {calls}, bf_comm_rounds_total "
                f"{got_rounds}: expected {steps} and {rounds * steps}")
        phases = {ph: snap.get(
            f'bf_step_phase_seconds_count{{phase="{ph}"}}')
            for ph in ("optimizer-update", "host-sync")}
        require(all(v == timed for v in phases.values())
                and snap.get("bf_step_seconds_count") == timed,
                f"step-phase samples {phases}, expected {timed}")
        with open(metrics) as f:
            lines = [json.loads(ln) for ln in f]
        require(len(lines) == timed and all(
            math.isfinite(ln["tokens_per_sec"]) for ln in lines),
            f"metrics file: {len(lines)} lines, expected {timed}")
        # The endpoint, scraped once.
        port = T.server_port()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        prom = re.compile(r'^(# TYPE \w+ (counter|gauge|histogram)|'
                          r'[a-z_]+(\{[^}]*\})? \S+)$')
        bad = [ln for ln in text.splitlines() if not prom.match(ln)]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            health = json.loads(r.read().decode())
        T.stop_http_server()
        require(not bad and f'bf_comm_calls_total{{op="{op}"}}' in text,
                f"/metrics does not parse: {bad[:3]}")
        require(health["status"] == "ok", f"/healthz {health}")
        # The consensus gauge: finite, and smaller after a combine than
        # after the local update before it.
        gauge = "bf_consensus_distance"
        sampled = snap.get(gauge)
        tr.opt.adapt()
        tr.opt.sample_consensus_distance()
        after_adapt = T.snapshot()[gauge]
        tr.opt.combine()
        tr.opt.sample_consensus_distance()
        after_combine = T.snapshot()[gauge]
        require(sampled is not None and math.isfinite(sampled)
                and after_combine < after_adapt,
                f"consensus distance {sampled}; {after_adapt} after adapt, "
                f"{after_combine} after the combine")
        # One more step under torch.profiler: the op spans' ranges.
        prof = profile_step.trace(lambda: (tr.forward_backward(),
                                           tr.opt.step()))
        spans = prof["op_spans"]
        require(f"{op}:ENQUEUE" in spans and f"{op}:COMMUNICATE" in spans,
                f"record_function ranges in the trace: {sorted(spans)}")
        # Telemetry on by default must not synchronise the card.
        _env_set({k: None for k in OBSERVE_KNOBS})
        sync_warnings(tr, True)
        syncs = {"on": sync_warnings(tr, True),
                 "off": sync_warnings(tr, False)}
        require(syncs["on"] == syncs["off"],
                f"sync warnings with telemetry on and off: {syncs}")
        del tr
        empty_cache()
        x = torch.randn(OBSERVE_NAR_SHAPE, device=DEVICE)
        # In turns, on and off, three readings each.
        cost = {s_: {"cuda_ms": [], "host_us_per_call": []}
                for s_ in ("on", "off")}
        for state in ("on", "off") * 3:
            before = _env_set({"BLUEFOG_TPU_TELEMETRY":
                               "1" if state == "on" else "0"})
            try:
                def nar():
                    return bf.neighbor_allreduce(x)
                cost[state]["cuda_ms"].append(cuda_ms(nar))
                sync()
                t0 = time.perf_counter()
                for _ in range(50):
                    nar()
                cost[state]["host_us_per_call"].append(
                    1e6 * (time.perf_counter() - t0) / 50)
                sync()
            finally:
                _env_set(before)
        del x
    finally:
        TL.stop_timeline()
        T.stop_http_server()
        _env_set(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    emit("observe_train", config={
        "num_layers": LAYERS, **LM_WIDTHS, "batch_size": 2, "ranks": 4,
        "order": "atc", "topology": "dynamic one-peer ExponentialGraph(4)",
        "knobs": {**OBSERVE_KNOBS, "BLUEFOG_TIMELINE": "<tmp>/tl_",
                  "--metrics-file": "<tmp>/metrics.jsonl"}},
        step_ms=res["step_ms"], train_step_ms=train_res["step_ms"],
        step_ms_each=[1e3 * 4 * 2 * 2048 / r for r in res["rates"]],
        tokens_per_s=res["tokens_per_s"], peak_mem_gb=res.get("peak_mem_gb"),
        launches=launches, expected_launches=expected,
        losses_by_step=res["losses_by_step"],
        comm={"calls": calls, "rounds": got_rounds},
        step_phase_samples=phases, metrics_lines=len(lines),
        timeline_events=len(events), timeline_pairs=pairs,
        trace_tools=trace_tools, consensus_distance={"sampled": sampled, "after_adapt": after_adapt,
                            "after_combine": after_combine},
        profiled_step={k: prof[k] for k in (
            "profiled_step_wall_ms", "kernel_busy_ms", "device_idle_share")},
        op_spans=spans, healthz=health, metrics_text_lines=len(
            text.splitlines()),
        sync_warnings=syncs, neighbor_allreduce=dict(
            shape=list(OBSERVE_NAR_SHAPE), dtype="float32",
            bound_ms=1e3 * 2 * 4 * math.prod(OBSERVE_NAR_SHAPE) / PEAK_BYTES,
            **cost),
        telemetry={k: v for k, v in snap.items()
                   if "_bucket{" not in k})
    return launches


def lm_args(benchmark, layers, dist, extra=()):
    """The benchmark's flags for the 1.3B LM's widths at ``layers`` blocks,
    4 ranks, under ``--dist-optimizer dist``."""
    w = LM_WIDTHS
    return benchmark.build_parser().parse_args([
        "--model", "transformer", "--flash-attention",
        "--num-layers", str(layers), "--embed-dim", str(w["width"]),
        "--num-heads", str(w["heads"]), "--seq-len", str(w["seq"]),
        "--batch-size", "2", "--vocab-size", str(w["vocab"]),
        "--momentum", "0", "--ranks", "4", "--dist-optimizer", dist,
        "--device", DEVICE, "--seed", str(SEED)] + list(extra))


def timed_ms(fn):
    """One call of ``fn`` between CUDA events (a host clock on the CPU,
    where the smoke is rehearsed)."""
    import torch
    if DEVICE != "cuda":
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def timed_combine(tr):
    """One more step of ``tr``: its combine's time alone."""
    tr.forward_backward()
    tr.opt.adapt()
    return timed_ms(tr.opt.combine)


def per_step(launches, steps):
    return {k: v / steps for k, v in launches.items()}


def check_hier_card_vs_cpu():
    """The hierarchical combines on the card against the same functions on
    the CPU at (4, 2^24) float32, 2 machines of 2: the dynamic neighbor
    allreduce (each machine phase) and hierarchical gossip (each outer
    codec).  The same float32 products and sums in the same order, no
    multiply-add to contract, so bit for bit."""
    import torch

    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import collective as C
    from bluefog_tpu_torch.ops import schedule as S
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(4, WIN_OPS_COLS, generator=gen)
    dyn = S.compile_dynamic(topo.dynamic_phase_table(topo.ExponentialGraph(2)),
                            2)
    ht = topo.hierarchical_two_level(4, 2)
    inner = S.compile_static(ht.inner, use_topo_weights=True)
    outer = tuple(S._schedule_from_matrix(ht.outer_slice_matrix(p))
                  for p in range(len(ht.outer_phases)))
    cases = {f"neighbor_allreduce_phase{s}": lambda t, s=s:
             C.dynamic_hierarchical_neighbor_allreduce(t, s, dyn, 2)
             for s in range(dyn.period)}
    for comp, frac in (("none", None), ("bf16", None), ("sparse:0.25", 0.25)):
        cases[f"gossip_{comp}"] = lambda t, comp=comp, frac=frac: \
            C.hierarchical_gossip(t, 0, inner, outer, 2,
                                  outer_compression=comp, outer_frac=frac)
    out = {}
    xd = x.to(DEVICE)
    for name, fn in cases.items():
        want, got = fn(x), fn(xd).cpu()
        out[name] = {"bitwise": bool(torch.equal(got, want)),
                     "max_abs_err": float((got - want).abs().max())}
        require(out[name]["max_abs_err"] <= 1e-6 * float(x.abs().max()),
                f"hierarchical {name}: card vs CPU {out[name]}")
    return out


def hier_train_phase(benchmark):
    """``--dist-optimizer hierarchical --atc --dynamic``: the 1.3B LM, 4
    ranks in 2 machines of 2, through K1-K3; returns the launches."""
    import torch

    from bluefog_tpu_torch.ops import flash_attention as FA
    args = lm_args(benchmark, HIER_LAYERS, "hierarchical", [
        "--atc", "--dynamic", "--num-warmup-batches", "1", "--num-iters", "2",
        "--num-batches-per-iter", "1"])
    tr = benchmark.Trainer(args)
    FA.reset_launch_counts()
    res = benchmark.measure(args, tr, quiet=True)
    launches = flash_launches()
    steps = args.num_warmup_batches + args.num_iters * args.num_batches_per_iter
    expected = HIER_LAYERS * args.ranks * steps
    # The combine's least bytes: every rank's row read once, written once.
    row_bytes = 4 * tr.rep.numel
    combine_ms = timed_combine(tr)
    emit("hier_train", config={
        "num_layers": HIER_LAYERS, **LM_WIDTHS, "batch_size": 2,
        "momentum": 0.0, "ranks": args.ranks, "local_size": 2,
        "machines": 2, "order": "atc",
        "topology": "dynamic one-peer walk of the machine "
                    "ExponentialGraph(2)"},
        launches=launches, launches_per_step=per_step(launches, steps),
        expected_launches=expected, combine_ms=combine_ms,
        combine_bound_ms=1e3 * 2 * args.ranks * row_bytes / PEAK_BYTES,
        card_vs_cpu=check_hier_card_vs_cpu(), **res)
    require(all(math.isfinite(x) for x in res["losses"]),
            f"finite losses {res['losses']}")
    require(res["steps"] == steps, f"{res['steps']} steps, expected {steps}")
    require(all(c == expected for c in launches.values()),
            f"launches {launches}, expected {expected} of each")
    require(res["spread"]["after_combine"] < res["spread"]["after_adapt"],
            f"the combine shrinks the spread {res['spread']}")
    del tr
    empty_cache()
    return launches


def winput_train_phase(benchmark):
    """``--dist-optimizer win_put``: the LM at full width, cut to
    ``WINPUT_LAYERS`` blocks so that the windows fit; then two more steps
    whose combine is held to the same combine recomputed in float64 on a
    sample of columns.  Returns the launches."""
    import torch

    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.ops import window as W
    args = lm_args(benchmark, WINPUT_LAYERS, "win_put", [
        "--num-warmup-batches", "1", "--num-iters", "2",
        "--num-batches-per-iter", "1"])
    tr = benchmark.Trainer(args)
    FA.reset_launch_counts()
    res = benchmark.measure(args, tr, quiet=True)
    launches = flash_launches()
    steps = args.num_warmup_batches + args.num_iters * args.num_batches_per_iter
    expected = WINPUT_LAYERS * args.ranks * steps
    n, P = args.ranks, tr.rep.numel
    # The least bytes of the window combine, 28 row passes: the puts read
    # 4 rows and write 8 staging rows, win_update reads main and staging
    # (12 rows) and writes 4.
    bound_ms = 1e3 * 28 * 4 * P / PEAK_BYTES
    flat = tr.rep.flat
    win = W._store.get(tr.opt._names[0])
    self_w, nbr_w = W._default_update_weights(win)
    gen = torch.Generator(device=flat.device).manual_seed(SEED)
    cols = torch.randint(0, P, (WIN_CHECK_COLS,), generator=gen,
                         device=flat.device).sort().values
    checks, window_ms = [], []
    for _ in range(2):
        tr.forward_backward()
        pre = flat.detach().index_select(1, cols).double()
        tr.opt.adapt()
        adapted = flat.detach().index_select(1, cols).double()
        window_ms.append(timed_ms(tr.opt.combine))
        got = flat.detach().index_select(1, cols).double()
        # The self term is the window's memory, the previous combine.
        ref = torch.stack([
            self_w[r] * pre[r] + sum(nbr_w[(r, s)] * adapted[s]
                                     for s in win.in_nbrs[r])
            for r in range(n)])
        checks.append(float((got - ref).norm() / ref.norm()))
    emit("winput_train", config={
        "num_layers": WINPUT_LAYERS, **LM_WIDTHS, "batch_size": 2,
        "momentum": 0.0, "ranks": n, "optimizer": "DistributedWinPutOptimizer",
        "overlap": False, "topology": "ExponentialGraph(4), in-degree 2"},
        launches=launches, launches_per_step=per_step(launches, steps),
        expected_launches=expected, window_ms=window_ms,
        window_bound_ms=bound_ms, window_bound_by="bytes",
        row_gb=4 * P / 1e9, f64_recheck_rel_err=checks,
        f64_recheck_cols=WIN_CHECK_COLS, f64_recheck_tol=WIN_TOL, **res)
    require(all(math.isfinite(x) for x in res["losses"]),
            f"finite losses {res['losses']}")
    require(res["steps"] == steps, f"{res['steps']} steps, expected {steps}")
    require(all(c == expected for c in launches.values()),
            f"launches {launches}, expected {expected} of each")
    require(res["spread"]["after_combine"] < res["spread"]["after_adapt"],
            f"the combine shrinks the spread {res['spread']}")
    require(all(c <= WIN_TOL for c in checks),
            f"the window combine against float64: {checks}")
    tr.opt.free()
    del tr, flat, win
    empty_cache()
    return launches


def fused_train_phase(benchmark):
    """``fused_train``: the win_put step of ``winput_train``'s LM in
    ``FUSED_BUCKETS`` fusion buckets, ``FUSED_STEPS`` steps eagerly and then
    fused from the same seed (the first uncaptured, then a CUDA graph
    captured and replayed); the parameters after the steps of
    ``FUSED_COMPARE_AT`` bit for bit.  Returns the fused run's launches."""
    import warnings

    import torch

    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.ops import fused_step as F
    from bluefog_tpu_torch.optim import window_optimizers as WO
    from bluefog_tpu_torch.utils import probes, telemetry
    args = lm_args(benchmark, WINPUT_LAYERS, "win_put")
    runs, snaps = {}, {}
    for fused in (False, True):
        tr = benchmark.Trainer(args)
        tr.opt.free()
        tr.opt = opt = WO.DistributedWinPutOptimizer(
            tr.opt.base, fused=fused, fusion_buckets=FUSED_BUCKETS,
            leaf_shapes=tr.rep.leaf_shapes)
        require(len(opt._names) == FUSED_BUCKETS,
                f"fused_train windows {opt._names}")
        telemetry.reset()
        FA.reset_launch_counts()
        rec = {"step_ms": [], "window_ms": [], "sync_calls": None}
        for step in range(1, FUSED_STEPS + 1):
            tr.forward_backward()
            counted = step == FUSED_STEPS
            with warnings.catch_warnings(record=True) as caught:
                if counted:
                    warnings.simplefilter("always")
                    sync()
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    if fused:
                        rec["step_ms"].append(timed_ms(opt.step))
                        prog = opt._fused_impl.last_program_ms
                        rec["window_ms"].append(
                            None if prog is None  # (a CPU rehearsal)
                            else rec["step_ms"][-1] - prog)
                    else:
                        ms = timed_ms(opt.adapt)
                        window = timed_ms(opt.combine)
                        rec["step_ms"].append(ms + window)
                        rec["window_ms"].append(window)
                finally:
                    if counted:
                        torch.cuda.set_sync_debug_mode(0)
            if counted:
                rec["sync_calls"] = sum("synchroniz" in str(w.message)
                                        for w in caught)
            if step in FUSED_COMPARE_AT:
                flat = tr.rep.flat.detach()
                if not fused:
                    snaps[step] = flat.to("cpu", copy=True)
                else:
                    same = all(torch.equal(flat[r].cpu(), snaps[step][r])
                               for r in range(flat.shape[0]))
                    rec.setdefault("bitwise_at", {})[step] = same
        rec["launches"] = flash_launches()
        rec["params_per_rank"] = tr.rep.numel
        if fused:
            impl = opt._fused_impl
            snap = telemetry.snapshot()
            summary = probes.last_summary() or {}
            widths = [sum(b - a for a, b in r) for r in opt._bucket_ranges]
            modeled = F.modeled_overlap([4 * w for w in widths])
            rec.update(
                active=snap.get("bf_fused_step_active"),
                fused_steps=impl.fused_steps, replays=impl.replays,
                captures=impl.captures, builds=impl.builds,
                capture_s=impl.capture_seconds,
                bucket_columns=widths,
                measured_overlap=summary.get("measured_overlap"),
                modeled_overlap=sum(r["overlap"] for r in modeled)
                / len(modeled),
                overlap_divergence=summary.get("divergence"),
                bucket_issue_s=summary.get("bucket_issue_seconds"),
                probe_attributed=summary.get("attributed"))
        runs["fused" if fused else "eager"] = rec
        opt.free()
        del tr, opt
        empty_cache()
    snaps.clear()
    eager, fused = runs["eager"], runs["fused"]
    P = fused["params_per_rank"]
    expected = WINPUT_LAYERS * 4 * FUSED_STEPS
    emit("fused_train", config={
        "num_layers": WINPUT_LAYERS, **LM_WIDTHS, "batch_size": 2,
        "momentum": 0.0, "ranks": 4, "fusion_buckets": FUSED_BUCKETS,
        "optimizer": "DistributedWinPutOptimizer", "steps": FUSED_STEPS,
        "program": "CUDA graph: the SGD update, the bucket flats, the "
                   "probes' host nodes (one process: no remote edge)"},
        eager=eager, fused=fused, window_bound_ms=1e3 * 28 * 4 * P
        / PEAK_BYTES, window_bound_by="bytes", expected_launches=expected)
    require(fused["bitwise_at"] == {s: True for s in FUSED_COMPARE_AT},
            f"fused vs eager parameters: {fused['bitwise_at']}")
    require(fused["active"] == 1.0, f"bf_fused_step_active {fused['active']}")
    # The first step of the key runs uncaptured, the rest replay its
    # graph (a CPU rehearsal runs the program uncaptured throughout).
    graphs = DEVICE == "cuda"
    require(fused["fused_steps"] == FUSED_STEPS
            and fused["replays"] == (FUSED_STEPS - 1 if graphs else 0)
            and fused["captures"] == (1 if graphs else 0),
            f"fused steps, replays, captures: {fused}")
    for rec in (eager, fused):
        require(all(c == expected for c in rec["launches"].values()),
                f"fused_train launches {rec['launches']}, expected "
                f"{expected} of each")
    fused_rig_legs()
    return fused["launches"]


def fused_rig_legs():
    """bench_comm's put-plan, fused-step and probe smokes (item 22d) on
    card tensors through its loopback store, then the port bench's
    ``fused_step`` block with ``BLUEFOG_TPU_FUSED_STEP`` set (the rig's
    timing cell: 32 leaves of (8, 128) in 8 buckets, 4 + 20 steps)."""
    from bluefog_tpu_torch import bench
    for mode in ("--ffi-smoke", "--fused-smoke", "--probe-smoke"):
        rig_leg("fused_train", "bench_comm", [mode])
    before = _env_set({"BLUEFOG_TPU_FUSED_STEP": "1"})
    try:
        t0 = time.perf_counter()
        block = bench._fused_step_summary(DEVICE)
        seconds = time.perf_counter() - t0
    finally:
        _env_set(before)
    require(block.get("enabled") is True and block.get("fused_steps") == 24,
            f"bench fused_step block {block}")
    emit("fused_train", leg="bench fused_step block", seconds=seconds,
         fused_step=block)


def win_variants_phase(benchmark, steps=3):
    """Pull-get, push-sum and win_put with ``overlap=True`` on the LM at
    full width and ``WIN_VARIANT_LAYERS`` blocks, 3 steps each; returns the
    launches."""
    import torch

    from bluefog_tpu_torch.benchmark import consensus_spread
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.optim import window_optimizers as WO
    variants = {"pull_get": (WO.DistributedPullGetOptimizer, {}),
                "push_sum": (WO.DistributedPushSumOptimizer, {}),
                "win_put_overlap": (WO.DistributedWinPutOptimizer,
                                    {"overlap": True})}
    FA.reset_launch_counts()
    out = {}
    for name, (cls, kw) in variants.items():
        args = lm_args(benchmark, WIN_VARIANT_LAYERS, "empty")
        tr = benchmark.Trainer(args)
        tr.opt = opt = cls(torch.optim.SGD([tr.rep.flat], lr=0.0125 * 4),
                           **kw)
        flat, rec = tr.rep.flat, {"losses": [], "rms_after_adapt": [],
                                  "rms_after_combine": [], "step_ms": []}
        for step in range(steps):
            t0 = time.perf_counter()
            rec["losses"].append([float(v) for v in tr.forward_backward()])
            opt.adapt()
            rec["rms_after_adapt"].append(consensus_spread(flat)["rms"])
            if name == "push_sum" and step == steps - 1:
                adapted_mean = flat.detach().double().mean(0)
            opt.combine()
            sync()
            rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
            rec["rms_after_combine"].append(consensus_spread(flat)["rms"])
        require(all(math.isfinite(v) for ls in rec["losses"] for v in ls),
                f"{name}: finite losses")
        require(all(b < a for a, b in zip(rec["rms_after_adapt"],
                                          rec["rms_after_combine"])),
                f"{name}: the combine shrinks the spread {rec}")
        if name == "push_sum":
            opt.collect()
            p = opt.associated_p()
            deb_mean = opt.debias()[0].double().mean(0)
            rec["p"] = p.tolist()
            rec["debiased_mean_rel_err"] = float(
                (deb_mean - adapted_mean).norm() / adapted_mean.norm())
            require(abs(p.sum() - args.ranks) < 1e-9 and (p > 0).all(),
                    f"push-sum P {p}")
            require(rec["debiased_mean_rel_err"] <= 1e-5,
                    f"push-sum de-biased mean {rec['debiased_mean_rel_err']}")
            del adapted_mean, deb_mean
        opt.free()
        out[name] = rec
        del tr, opt, flat
        empty_cache()
    launches = flash_launches()
    expected = WIN_VARIANT_LAYERS * 4 * steps * len(variants)
    require(all(c == expected for c in launches.values()),
            f"launches {launches}, expected {expected} of each")
    emit("win_variants", config={
        "num_layers": WIN_VARIANT_LAYERS, **LM_WIDTHS, "batch_size": 2,
        "ranks": 4, "steps": steps, "topology": "ExponentialGraph(4)"},
        launches=launches, expected_launches=expected, **out)
    return launches


def window_sequence(bf, x, own, layout):
    """The window ops on ``x``, the rank-major ``(4, WIN_OPS_COLS)``
    float32 tensor on the windows' device, under ExponentialGraph(4), each
    followed by a fence (and a local read that a later remote write must
    not overtake by a barrier): the owned ranks' rows of every result,
    their counters and P scalars.  ``layout``: the windows take the
    rank-major tensor or the owned rows."""
    import threading

    rows = own if layout == "owned" else list(range(4))

    def t(a):
        return a[rows] if layout == "owned" else a

    def mine(out):
        return out if layout == "owned" else out[own]
    ring = {(r, (r + 1) % 4): 0.3 + 0.1 * r for r in range(4)}
    skip = {(r, (r + 2) % 4): 0.35 for r in range(4)}
    out = {}
    bf.turn_on_win_ops_with_associated_p()
    bf.win_create(t(x), "w", zero_init=True)
    bf.win_put(t(1.5 * x), "w", dst_weights=ring)        # partial dsts
    bf.win_fence()
    out["versions_put"] = [bf.get_win_version("w", r) for r in own]
    bf.barrier()
    bf.win_accumulate(t(x), "w", self_weight=0.45, dst_weights=skip)
    bf.win_fence()
    bf.win_get("w", src_weights={(r, (r - 1) % 4): 0.6 for r in range(4)})
    bf.win_fence()
    # Partial weights: the (r, r - 2) edges stay pending.
    out["update_partial"] = mine(bf.win_update(
        "w", self_weight=0.3, neighbor_weights={
            (r, (r - 1) % 4): 0.7 for r in range(4)}, reset_weights=True))
    out["versions_pending"] = [bf.get_win_version("w", r) for r in own]
    bf.win_fence()
    out["collect"] = mine(bf.win_update_then_collect("w"))
    out["p"] = [float(bf.win_associated_p("w", r)) for r in own]
    bf.turn_off_win_ops_with_associated_p()
    bf.win_fence()
    snap = bf.win_state_dict("w")
    bf.barrier()
    bf.win_put(t(x), "w")
    bf.win_fence()
    bf.win_load_state_dict("w", snap)
    bf.win_fence()
    bf.win_accumulate(t(0.5 * x), "w")
    bf.win_fence()
    out["after_restore"] = mine(bf.win_update("w"))
    bf.win_fence()
    # Mutex from two threads: a require_mutex put waits for its release
    # (across processes, ranks 1 and 2 sit in different processes, and the
    # put's edges into them wait on the remote mutex).
    done = threading.Event()
    with bf.win_mutex("w", ranks=[1, 2]):
        th = threading.Thread(target=lambda: (
            bf.win_put(t(x), "w", require_mutex=True), done.set()))
        th.start()
        time.sleep(0.2)
        out["blocked_while_held"] = not done.is_set()
    th.join(timeout=60)
    out["ran_after_release"] = done.is_set()
    bf.win_fence()
    out["after_mutex_put"] = mine(bf.win_update("w"))
    bf.win_fence()
    return out


def ops_input(dev):
    import torch
    gen = torch.Generator().manual_seed(SEED)
    return torch.randn(4, WIN_OPS_COLS, generator=gen).to(dev)


def window_ops(dev):
    """``window_sequence`` in one process (every rank owned) on ``dev``,
    every result on the CPU."""
    import torch

    import bluefog_tpu_torch as bf
    bf.init(4, device=dev)
    try:
        out = window_sequence(bf, ops_input(dev), [0, 1, 2, 3], "rank")
        if dev == "cuda":
            reps = 10
            out["win_update_ms"] = timed_ms(lambda: [
                bf.win_update("w") for _ in range(reps)]) / reps
        return {k: v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()}
    finally:
        bf.shutdown()


def win_ops_phase():
    """``window_ops`` on the card against the CPU, bit for bit; returns the
    card's results (``win_dist_ops`` holds the processes to them)."""
    import torch
    card, cpu = window_ops(DEVICE), window_ops("cpu")
    res = {}
    for k, want in cpu.items():
        got = card[k]
        if isinstance(want, torch.Tensor):
            res[k] = {"bitwise": bool(torch.equal(got, want)),
                      "max_abs_err": float((got - want).abs().max())}
            require(res[k]["bitwise"], f"win_ops {k}: card vs CPU {res[k]}")
        else:
            require(got == want, f"win_ops {k}: {got} vs {want}")
            res[k] = got
    require(cpu["blocked_while_held"] and cpu["ran_after_release"],
            "win_mutex excludes a require_mutex writer")
    # win_update reads main (4 rows) and staging (8), writes 4.
    emit("win_ops", shape=[4, WIN_OPS_COLS], dtype="float32",
         topology="ExponentialGraph(4)", win_update_ms=card.get(
             "win_update_ms"), win_update_bound_ms=1e3 * 16 * 4 *
         WIN_OPS_COLS / PEAK_BYTES, **res)
    # The window benchmark (item 22d) in one process at ResNet-50's width.
    rig_leg("win_ops", "window_benchmark", ["--json", "--rounds",
                                            str(WINDOW_BENCH_ROUNDS)])
    return card


# ---------------------------------------------------------------------------
# Windows across processes: WIN_DIST_PROCS processes of WIN_DIST_PER ranks,
# all on card 0, their control group on gloo; every remote row leaves the
# card, crosses the window transport's loopback socket and comes back.
# ---------------------------------------------------------------------------

def row_hashes(t):
    """sha256 of each row's bytes, hashed from the host copy's buffer (a
    ``.tobytes()`` copy of a 0.94 GB row held the GIL 0.43-0.49 s)."""
    import hashlib
    return [hashlib.sha256(r.contiguous().cpu().numpy().data).hexdigest()
            for r in t]


def launch_workers(phase, args=(), device=None, procs=WIN_DIST_PROCS,
                   per=WIN_DIST_PER, env=None, killed=()):
    """Run ``chip_smoke.py --worker <phase>`` in ``procs`` processes of
    ``per`` ranks (the ``BFTPU_*`` rendezvous on this host, card 0 for
    each) on ``device`` (default ``DEVICE``), with ``env`` added.  The
    port's ``bfrun`` launches them (``python -m bluefog_tpu_torch.run -np
    procs --devices-per-proc per --tag-output``) unless ``killed`` names
    processes that must die of SIGKILL: bfrun would stop the gang at that
    death, so those are started by hand.  Returns their results in
    process order (None for a killed one, which must leave none), the
    per-rank exit summary (bfrun's own line; the same words for a launch
    by hand) and the launch's clock: seconds from the launch to the
    first worker's start, from the last start to the last worker's
    rendezvous, and from the last worker's shutdown to the launch's end.
    Every process must exit with 0 but those of ``killed``.  Every
    process is stopped before this returns, also on a failure."""
    import signal
    import socket
    import tempfile

    from bluefog_tpu_torch.run import run as bfrun
    tmp = tempfile.mkdtemp(prefix="win_dist_")
    here = os.path.dirname(os.path.abspath(__file__))
    worker = [sys.executable, os.path.abspath(__file__), "--worker", phase]
    base = _launcher_free_env()
    base.update(BFTPU_WIN_HOST="127.0.0.1", **(env or {}))
    outs = [os.path.join(tmp, f"proc{p}.json") for p in range(procs)]
    children = []
    t0 = time.time()
    try:
        if not killed:
            cmd = [sys.executable, "-m", "bluefog_tpu_torch.run",
                   "-np", str(procs), "--devices-per-proc", str(per),
                   "--tag-output", *worker,
                   os.path.join(tmp, "proc{proc}.json"), device or DEVICE,
                   *args]
            # bfrun and the workers it starts share its process group.
            children.append(subprocess.Popen(
                cmd, cwd=here, env=base, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
                start_new_session=True))
            log = children[0].communicate(timeout=WIN_DIST_TIMEOUT)[0]
            lines = [ln for ln in log.splitlines()
                     if ln.startswith("bfrun: gang exit summary")]
            require(children[0].returncode == 0 and len(lines) == 1,
                    f"{phase}: bfrun exited {children[0].returncode}:\n"
                    f"{log[-6000:]}")
            summary = lines[0]
        else:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            for p in range(procs):
                child_env = dict(base, BFTPU_COORDINATOR=f"127.0.0.1:{port}",
                                 BFTPU_NUM_PROCESSES=str(procs),
                                 BFTPU_PROCESS_ID=str(p),
                                 BFTPU_LOCAL_DEVICES=str(per))
                children.append(subprocess.Popen(
                    [*worker, outs[p], device or DEVICE, *args], cwd=here,
                    env=child_env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
            deadline = time.monotonic() + WIN_DIST_TIMEOUT
            logs = [c.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
                for c in children]
            for p, c in enumerate(children):
                want = -signal.SIGKILL if p in killed else 0
                require(c.returncode == want,
                        f"{phase} process {p} exited {c.returncode}, "
                        f"expected {want}:\n{logs[p][-3000:]}")
            summary = bfrun._exit_summary([(c, "127.0.0.1", False)
                                           for c in children])
        t_end = time.time()
        want = "; ".join(f"rank {p}: " + ("killed by SIGKILL" if p in killed
                                          else "exit 0")
                         for p in range(procs))
        require(summary.endswith(want), f"{phase}: exit summary {summary}")
        res = _worker_results(phase, outs, killed)
        clocks = [r.pop("clock") for r in res if r is not None]
        clock = {"launch_to_first_start_s":
                 min(c["start"] for c in clocks) - t0,
                 "last_start_to_last_init_s":
                 max(c["init"] for c in clocks)
                 - max(c["start"] for c in clocks),
                 "last_shutdown_to_end_s":
                 t_end - max(c["done"] for c in clocks)}
        return res, summary, clock
    finally:
        for c in children:
            if c.poll() is None:
                if killed:
                    c.kill()
                else:
                    os.killpg(c.pid, signal.SIGKILL)
                c.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _launcher_free_env():
    """This process's environment less any launcher's rendezvous and the
    window transport's knobs, for the workers."""
    return {k: v for k, v in os.environ.items()
            if not k.startswith(("BFTPU_", "BLUEFOG_TPU_WIN", "MASTER_",
                                 "WORLD_SIZE", "RANK", "LOCAL_RANK"))}


def _worker_results(phase, outs, killed=()):
    """Each process's result file, in process order (None for a killed
    one, which must have left none)."""
    res = []
    for p, out in enumerate(outs):
        if p in killed:
            require(not os.path.exists(out),
                    f"{phase}: killed process {p} left a result")
            res.append(None)
            continue
        with open(out) as f:
            res.append(json.load(f))
    return res


def stats_since(W, before):
    after = W.stats.snapshot()
    return {k: after[k] - before[k] for k in after}


def ops_worker(bf, ref_path):
    """``window_sequence`` in the owned layout through both transport
    paths (row hashes, counters, the native path's bytes and seconds),
    then under bf16 compression against the one-process card run."""
    import torch

    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.utils import config
    x = ops_input(DEVICE)
    own = bf.owned_ranks()
    res = {"owned": own}
    for path, native_on in (("native", True), ("python", False)):
        with config.override(win_native=native_on):
            W._shutdown_transport()
            W.init_transport()
            require(W._store.distrib.transport.native_path == native_on,
                    f"{path} transport")
            before = W.stats.snapshot()
            out = window_sequence(bf, x, own, "owned")
            sync()
            res[path] = {
                "stats": stats_since(W, before),
                "hashes": {k: row_hashes(v) for k, v in out.items()
                           if isinstance(v, torch.Tensor)},
                "values": {k: v for k, v in out.items()
                           if not isinstance(v, torch.Tensor)}}
            bf.win_free("w")
            bf.barrier()
    W._shutdown_transport()
    W.init_transport()
    ref = torch.load(ref_path, mmap=True)
    with config.override(win_compression="bf16"):
        before = W.stats.snapshot()
        out = window_sequence(bf, x, own, "owned")
        res["bf16_stats"] = stats_since(W, before)
    res["bf16"] = {}
    for k, want in ref.items():
        got, want = out[k].cpu(), want[own]
        res["bf16"][k] = {
            "max_abs_err": float((got - want).abs().max()),
            "within": bool(torch.allclose(got, want, rtol=WIN_DIST_BF16_TOL,
                                          atol=WIN_DIST_BF16_TOL))}
    bf.win_free("w")
    res["flightrec"] = flightrec_worker(bf, f"{ref_path}.fr.{own[0]}.bin")
    return res


def flightrec_worker(bf, path):
    """The flight recorder armed on the native path with every data
    message traced: two accumulates from one owned rank to its remote
    out-neighbor, sent back to back so that one frame carries both and
    the receiver's drain folds them, then a fence; the ring dumped to
    ``path``.  Returns the dump's path and the event counts by type."""
    import numpy as np

    from bluefog_tpu_torch import topology as topology_util
    from bluefog_tpu_torch.ops import transport as TR
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.utils import config, flightrec
    own = bf.owned_ranks()
    flightrec.enable()
    with config.override(win_native=True, trace_sample=1):
        W._shutdown_transport()
        W.init_transport()
        flightrec.reset()
        x = ops_input(DEVICE)[:, :4096].contiguous()
        bf.win_create(x, "fr")
        bf.barrier()
        src = own[0]
        dst = next(d for d in topology_util.out_neighbor_ranks(
            bf.load_topology(), src) if d not in own)
        row = np.ones(4096, np.float32).view(np.uint8)
        for _ in range(2):
            W._send_to_rank_owner(dst, TR.OP_ACCUMULATE, "fr", src, dst,
                                  0.5, payload=row)
        W._flush_transport()
        bf.win_fence("fr")
        bf.barrier()
        dumped = flightrec.dump(path, reason="chip_smoke win_dist_ops")
        counts = {}
        for e in flightrec.snapshot():
            name = flightrec.ETYPE_NAMES.get(int(e["etype"]), "?")
            counts[name] = counts.get(name, 0) + 1
        bf.win_free("fr")
    W._shutdown_transport()
    W.init_transport()
    return {"path": dumped, "counts": counts}


def path_bounds():
    """What the path's three legs reach alone on this machine: one pinned
    copy of ``BOUND_BYTES`` card to host and host to card (CUDA events),
    and the same bytes through one loopback TCP socket."""
    import socket
    import threading

    import torch
    n = BOUND_BYTES
    out = {"bytes": n}
    host = torch.empty(n, dtype=torch.uint8, pin_memory=DEVICE == "cuda")
    if DEVICE == "cuda":
        dev = torch.empty(n, dtype=torch.uint8, device="cuda")
        for name, fn in (
                ("d2h", lambda: host.copy_(dev, non_blocking=True)),
                ("h2d", lambda: dev.copy_(host, non_blocking=True))):
            fn()
            ms = timed_ms(fn)
            out[f"{name}_ms"], out[f"{name}_gbps"] = ms, n / ms / 1e6
        del dev
        torch.cuda.empty_cache()
    sink = bytearray(n)
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def receive():
        conn, _ = srv.accept()
        with conn:
            view, got = memoryview(sink), 0
            while got < n:
                got += conn.recv_into(view[got:], n - got)
    th = threading.Thread(target=receive)
    th.start()
    with socket.create_connection(srv.getsockname()) as c:
        t0 = time.perf_counter()
        c.sendall(memoryview(host.numpy()))
        th.join()
        dt = time.perf_counter() - t0
    srv.close()
    out["socket_ms"], out["socket_gbps"] = 1e3 * dt, n / dt / 1e9
    return out


def rate(nbytes, seconds):
    return nbytes / seconds / 1e9 if seconds else None


def dist_worker(bf, ref_path):
    """One process of ``dist_phases``: ``ops_worker``, ``train_worker``,
    ``async_ops_worker`` and ``async_train_worker`` in turn (each ending
    in a barrier), with each one's wall seconds."""
    out, seconds = {}, {}
    for name, fn in (("ops", lambda: ops_worker(bf, ref_path)),
                     ("train", lambda: train_worker(bf)),
                     ("async_ops", lambda: async_ops_worker(bf)),
                     ("async_train", lambda: async_train_worker(bf))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name].setdefault("owned", bf.owned_ranks())
        bf.barrier()
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def dist_phases(card_ops):
    """The 2 x 2 phases across processes from one launch of the workers
    (``dist_worker``: one start-up for the four, where each had its own),
    the CPU run of ``async_ops_worker`` alongside it; then each phase's
    checks and line.  Before them, a wall line of each part (process 0's
    seconds; ``win_dist_train.*`` its sub-phases; ``dist.startup``: the
    launch, rendezvous and exit).  Returns the launches of K1-K3 of
    ``win_dist_train`` and of ``win_async_train``."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch
    ref_keys = [k for k, v in card_ops.items() if isinstance(v, torch.Tensor)]
    fd, ref_path = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    try:
        torch.save({k: card_ops[k] for k in ref_keys}, ref_path)
        with ThreadPoolExecutor(1) as pool:
            cpu_run = pool.submit(launch_workers, "async_ops", (), "cpu",
                                  env={"OMP_NUM_THREADS": "2"})
            t0 = time.perf_counter()
            parts, summary, clock = launch_workers("dist", [ref_path])
            wall = time.perf_counter() - t0
            cpu, _, _ = cpu_run.result()
    finally:
        os.remove(ref_path)
    # The launch's seconds go to this line's wall, not to the first phase's.
    emit("dist_workers", processes=WIN_DIST_PROCS,
         ranks_per_process=WIN_DIST_PER, seconds=wall,
         launcher="python -m bluefog_tpu_torch.run (bfrun)",
         exit_summary=summary, launch_clock=clock,
         phases=["win_dist_ops", "win_dist_train", "win_async_ops",
                 "win_async_train"])
    secs = parts[0]["seconds"]
    subs = parts[0]["train"]["sub_phase_s"]
    walls = [("dist.startup", wall - sum(secs.values())),
             ("win_dist_ops", secs["ops"])]
    walls += [(f"win_dist_train.{k}", v) for k, v in subs.items()]
    walls += [("win_async_ops", secs["async_ops"]),
              ("win_async_train", secs["async_train"])]
    for what, sec in walls:
        print(json.dumps({"phase": "wall", "of": what, "seconds": sec}),
              flush=True)
    win_dist_ops_phase(card_ops, [p["ops"] for p in parts])
    dist_launches = win_dist_train_phase([p["train"] for p in parts])
    win_async_ops_phase([p["async_ops"] for p in parts], cpu)
    async_launches = win_async_train_phase([p["async_train"]
                                            for p in parts])
    return dist_launches, async_launches


def win_dist_ops_phase(card, parts):
    """``window_sequence`` across processes (``parts``: the ``ops``
    results of ``dist_phases``' workers), owned layout, through both
    transport paths: every owned row, counter and P scalar bit for bit the
    one-process card run; bf16 within ``WIN_DIST_BF16_TOL``; the bytes
    that crossed, the seconds of each leg, beside ``path_bounds``."""
    import torch
    from bluefog_tpu_torch.utils import flightrec
    ref_keys = [k for k, v in card.items() if isinstance(v, torch.Tensor)]
    recorded = {}
    try:
        # Each process's flight-recorder dump, read back: events of every
        # type the native path records, and the Python commit.
        for part in parts:
            header, events = flightrec.load(part["flightrec"]["path"])
            kinds = sorted({flightrec.ETYPE_NAMES[int(e["etype"])]
                            for e in events})
            require(header["rank"] == part["owned"][0]
                    and header["count"] == len(events) > 0
                    and set(kinds) == set(flightrec.ETYPE_NAMES.values()),
                    f"flight recorder dump of process {part['owned']}: "
                    f"{header}, event types {kinds}")
            recorded[str(part["owned"][0])] = {
                "events": len(events), "by_type": part["flightrec"]["counts"]}
        # The host tool over the dumps: python -m bluefog_tpu_torch.tools
        # trace-gossip <prefix> (one lane a process, a flow arrow a traced
        # message seen at both ends, the per-edge delays).
        from bluefog_tpu_torch.tools import tracegossip as TG
        t0 = time.perf_counter()
        prefix = parts[0]["flightrec"]["path"].rsplit(".", 2)[0]
        merged_path = prefix + ".merged.json"
        dumps = TG.load_dumps(prefix)
        _, stats = TG.merge_gossip(prefix, merged_path, dumps=dumps)
        with open(merged_path) as f:
            merged = json.load(f)
        os.remove(merged_path)
        table = TG.delay_table(TG.edge_delays(dumps))
        require(stats["ranks"] == [p["owned"][0] for p in parts]
                and stats["events"] == sum(r["events"]
                                           for r in recorded.values())
                and any(e.get("ph") == "X" for e in merged),
                f"trace-gossip over the dumps: {stats}")
        recorded["trace_gossip"] = {
            "seconds": time.perf_counter() - t0, **stats,
            "merged_events": len(merged), "delay_table": table.splitlines()}
    finally:
        for part in parts:
            dump = part.get("flightrec", {}).get("path")
            if dump and os.path.exists(dump):
                os.remove(dump)
    want_hash = {k: row_hashes(card[k]) for k in ref_keys}
    res = {"per_process": []}
    for part in parts:
        own = part["owned"]
        mine = {"owned": own}
        for path in ("native", "python"):
            got = part[path]
            for k, hashes in got["hashes"].items():
                require(hashes == [want_hash[k][r] for r in own],
                        f"win_dist_ops {path} {k}: rows of {own} differ "
                        "from the one-process card run")
            for k, v in got["values"].items():
                if k in ("blocked_while_held", "ran_after_release"):
                    continue
                want = json.loads(json.dumps([card[k][r] for r in own]))
                require(v == want, f"win_dist_ops {path} {k}: {v} vs {want}")
            require(got["values"]["blocked_while_held"]
                    and got["values"]["ran_after_release"],
                    f"win_dist_ops {path}: the remote mutex excludes the "
                    "writer")
            mine[f"{path}_bitwise"] = True
        st = part["native"]["stats"]
        mine["native"] = {
            "tx_bytes": st["tx_bytes"],
            "wire_ms": 1e3 * st["wire_s"],
            "wire_gbps": rate(st["tx_bytes"], st["wire_s"]),
            "d2h_bytes": st["stage_bytes"], "d2h_ms": 1e3 * st["stage_s"],
            "d2h_gbps": rate(st["stage_bytes"], st["stage_s"]),
            "h2d_bytes": st["commit_bytes"], "h2d_ms": 1e3 * st["commit_s"],
            "h2d_gbps": rate(st["commit_bytes"], st["commit_s"])}
        mine["python_path_stats"] = part["python"]["stats"]
        mine["bf16"] = part["bf16"]
        mine["bf16_tx_bytes"] = part["bf16_stats"]["tx_bytes"]
        for k, v in part["bf16"].items():
            require(v["within"], f"win_dist_ops bf16 {k}: {v}")
        res["per_process"].append(mine)
    emit("win_dist_ops", processes=WIN_DIST_PROCS,
         ranks_per_process=WIN_DIST_PER, layout="owned",
         shape=[4, WIN_OPS_COLS], dtype="float32",
         topology="ExponentialGraph(4)", transport="loopback TCP, one card",
         bf16_tol=WIN_DIST_BF16_TOL, bounds=path_bounds(),
         flight_recorder=recorded, **res)


def train_worker(bf):
    """The benchmark's win_put LM at full width and ``WIN_DIST_LAYERS``,
    ResNet-50, and pull-get and push-sum at ``WIN_DIST_VARIANT_LAYERS``,
    across the processes."""
    import gc

    import torch

    from bluefog_tpu_torch import benchmark
    from bluefog_tpu_torch.benchmark import consensus_spread
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.optim import window_optimizers as WO

    def done(tr):
        # Nothing of this trainer's gossip may still be in flight when the
        # next one creates its windows under the same names.
        W.win_fence()
        tr.opt.free()
        del tr
        gc.collect()
        empty_cache()
        bf.barrier()
    out = {}
    # Each sub-phase's wall seconds, for win_dist_train's wall lines.
    marks = [("start", time.perf_counter())]

    def mark(what):
        marks.append((what, time.perf_counter()))
    args = lm_args(benchmark, WIN_DIST_LAYERS, "win_put", [
        "--num-warmup-batches", "1", "--num-iters", str(WIN_DIST_LM_ITERS),
        "--num-batches-per-iter", "1"])
    tr = benchmark.Trainer(args)
    FA.reset_launch_counts()
    res = benchmark.measure(args, tr, quiet=True)
    res["launches"] = flash_launches()
    res["row_gb"] = 4 * tr.rep.numel / 1e9
    out["lm"] = res
    done(tr)
    mark("lm")
    args = benchmark.build_parser().parse_args([
        "--model", "resnet50", "--batch-size", "64", "--momentum", "0.9",
        "--dist-optimizer", "win_put", "--num-warmup-batches", "1",
        "--num-iters", str(WIN_DIST_LM_ITERS), "--num-batches-per-iter", "1",
        "--seed", str(SEED)])
    tr = benchmark.Trainer(args)
    out["resnet50"] = benchmark.measure(args, tr, quiet=True)
    done(tr)
    mark("resnet50")
    FA.reset_launch_counts()
    comm = bf.process_ranks()
    for name, cls in (("pull_get", WO.DistributedPullGetOptimizer),
                      ("push_sum", WO.DistributedPushSumOptimizer)):
        args = lm_args(benchmark, WIN_DIST_VARIANT_LAYERS, "empty")
        tr = benchmark.Trainer(args)
        tr.opt = opt = cls(torch.optim.SGD([tr.rep.flat], lr=0.0125 * 4))
        flat, rec = tr.rep.flat, {"losses": [], "rms_after_adapt": [],
                                  "rms_after_combine": [], "step_ms": []}
        for _ in range(WIN_DIST_VARIANT_STEPS):
            t0 = time.perf_counter()
            rec["losses"].append([float(v) for v in tr.forward_backward()])
            opt.adapt()
            rec["rms_after_adapt"].append(consensus_spread(flat)["rms"])
            opt.combine()
            sync()
            rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
            rec["rms_after_combine"].append(consensus_spread(flat)["rms"])
        if name == "push_sum":
            opt.collect()
            p = opt.associated_p()[bf.owned_ranks()]
            rec["p_owned"] = p.tolist()
            rec["p_sum"] = float(comm.all_reduce(
                torch.tensor([float(p.sum())], dtype=torch.float64))
                .wait()[0])
        out[name] = rec
        done(tr)
    out["variant_launches"] = flash_launches()
    mark("variants")
    FA.reset_launch_counts()
    out["plan_fused"] = plan_fused_runs(bf, benchmark, done)
    out["plan_fused_launches"] = flash_launches()
    mark("plan_fused")
    out["sub_phase_s"] = {what: t - marks[i][1]
                          for i, (what, t) in enumerate(marks[1:])}
    return out


def plan_fused_runs(bf, benchmark, done):
    """The put plans and the fused step across the processes: the win_put
    LM at ``WIN_DIST_LAYERS`` in 2 fusion buckets, one step from the same
    seed eagerly with ``BLUEFOG_TPU_WIN_XLA=0`` (host-staged puts) and
    fused (``=1``: the plans inside the program); each window's staging
    rows at the owned ranks after a fence (the step's puts: deterministic,
    where the combine folds what has arrived).  The fused run steps once
    more, its graph captured and replayed, and then times the two paths'
    staging of one bucket's owned rows, warm (``staging_rates``)."""
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.ops import xlaffi
    from bluefog_tpu_torch.optim import window_optimizers as WO
    from bluefog_tpu_torch.utils import config, telemetry
    out = {}
    for mode in ("host", "fused"):
        with config.override(win_xla=mode == "fused"):
            # (An "empty" trainer: the optimizer's windows are made once.)
            tr = benchmark.Trainer(lm_args(benchmark, WIN_DIST_LAYERS,
                                           "empty"))
            tr.opt = opt = WO.DistributedWinPutOptimizer(
                tr.opt.base, fused=mode == "fused", fusion_buckets=2,
                leaf_shapes=tr.rep.leaf_shapes)
            telemetry.reset()
            before = W.stats.snapshot()
            tr.forward_backward()
            sync()
            t0 = time.perf_counter()
            opt.step()
            sync()
            rec = {"step_ms": 1e3 * (time.perf_counter() - t0),
                   "window": stats_since(W, before), "armed": xlaffi.armed()}
            W.win_fence()
            own = set(bf.owned_ranks())
            rec["staging"] = {name: state_digest(W._store.get(name),
                                                 own)["staging"]
                              for name in opt._names}
            if mode == "fused":
                # The replayed step, profiled in process 0 (its kernels
                # only: the other process shares the card), timed plain in
                # the other.
                if DEVICE == "cuda" and bf.process_ranks().process == 0:
                    from bluefog_tpu_torch import profile_step
                    prof = profile_step.trace(
                        lambda: (tr.forward_backward(), opt.step()))
                    rec["profile"] = {k: prof[k] for k in (
                        "profiled_step_wall_ms", "kernel_busy_ms",
                        "device_idle_share")}
                    rec["replay_step_ms"] = prof["profiled_step_wall_ms"]
                else:
                    tr.forward_backward()
                    sync()
                    t0 = time.perf_counter()
                    opt.step()
                    sync()
                    rec["replay_step_ms"] = 1e3 * (time.perf_counter() - t0)
                impl = opt._fused_impl
                rec.update(fused_steps=impl.fused_steps,
                           replays=impl.replays, captures=impl.captures,
                           capture_s=impl.capture_seconds,
                           statuses=impl.last_statuses,
                           program_ms=impl.last_program_ms,
                           active=telemetry.snapshot().get(
                               "bf_fused_step_active"))
                W.win_fence()
                # One process at a time: both share the card's host link.
                comm = bf.process_ranks()
                for p in range(comm.nprocs):
                    if p == comm.process:
                        rec["staging_gbps"] = staging_rates(opt)
                    bf.barrier()
            rec["host_copy_bytes"] = {
                k: v for k, v in telemetry.snapshot().items()
                if k.startswith("bf_win_host_copy_bytes_total")}
            out[mode] = rec
            done(tr)
    return out


def staging_rates(opt, reps=3):
    """GB/s of staging one bucket's owned rows for their remote edges,
    warm (the pinned buffers made by a first call): the put plan's one
    copy (``xlaffi.stage_rows``) against the host-staged path's copy and
    stream synchronize a row (``window._stage``); None on the CPU, where
    neither copies."""
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.ops import xlaffi
    if DEVICE != "cuda":
        return None
    name = opt._names[0]
    win = W._store.get(name)
    payload = opt._payloads()[0]
    remote = tuple(
        (e, w) for e, w in W._resolve_edge_weights(
            None, win.out_nbrs, 1.0, ranks=win.owned).items()
        if W._owns(e[0]) and not W._owns(e[1]))
    plan = xlaffi.prepare_put(W._store.distrib, win, name, W.OP_PUT, remote,
                              per_edge=False, compact=True)

    def planned():
        with plan.stage_lock:
            xlaffi.stage_rows(plan, payload, win)

    def host_staged():
        for src in plan.srcs:
            W._stage(win, (src, "raw", "put"),
                     payload[win.row_of[src]].contiguous())
    rates = {}
    for label, fn, key in (("plan", planned, "plan_stage"),
                           ("host_staged", host_staged, "stage")):
        fn()
        before = W.stats.snapshot()
        for _ in range(reps):
            fn()
        d = stats_since(W, before)
        rates[label] = rate(d[f"{key}_bytes"], d[f"{key}_s"])
    return rates


def state_digest(win, owned):
    """A window's state at the owned ranks' slots: each staging and
    residual row's sha256, the P scalars and the versions."""
    import hashlib

    def sha(t):
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                              ).hexdigest()
    with win.lock:
        return {
            "staging": {f"{d}:{s}": sha(v)
                        for (d, s), v in win.staging.items() if d in owned},
            "stale_residual": {
                f"{d}:{s}": sha(v) for (d, s), v in
                win.stale_residual.items() if d in owned},
            "p_staging": {f"{d}:{s}": v for (d, s), v in
                          win.p_staging.items() if d in owned},
            "p_stale_residual": {
                f"{d}:{s}": v for (d, s), v in
                win.p_stale_residual.items() if d in owned},
            "versions": {f"{d}:{s}": v for (d, s), v in
                         win.versions.items() if d in owned}}


def async_ops_worker(bf):
    """``WIN_ASYNC_PHASES`` under each policy on both transport paths: the
    digests of the state before and after the fold, the edges folded, the
    staging against the mass shipped, and the stats."""
    import torch

    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.utils import config
    comm = bf.process_ranks()
    own = bf.owned_ranks()
    n = bf.size()
    rows = ((torch.arange(n * WIN_ASYNC_COLS) % 7) + 1).float().reshape(
        n, WIN_ASYNC_COLS).to(DEVICE)
    edges = [(s, d) for s in range(n) for d in bf.out_neighbor_ranks(s)]
    weights = {e: 0.5 for e in edges}
    res = {}
    for policy in WIN_ASYNC_POLICIES:
        for path, native_on in (("native", True), ("python", False)):
            with config.override(async_staleness_policy=policy,
                                 win_native=native_on, **WIN_ASYNC_KNOBS):
                W._shutdown_transport()
                W.init_transport()
                tr = W._store.distrib.transport
                require(tr.native_path == native_on, f"{path} transport")
                W.turn_on_win_ops_with_associated_p()
                require(W.configure_async(), "the async mode arms")
                bf.win_create(torch.zeros(len(own), WIN_ASYNC_COLS,
                                          device=DEVICE), "aw",
                              zero_init=True)
                before = W.stats.snapshot()
                t0 = time.perf_counter()
                for phase, steps in enumerate(WIN_ASYNC_PHASES):
                    W.set_async_step(steps[comm.process])
                    bf.barrier()
                    bf.win_accumulate(rows[own] * float(phase + 1), "aw",
                                      dst_weights=weights)
                    bf.win_fence("aw")
                seconds = time.perf_counter() - t0
                win = W._store.get("aw")
                out = {"before": state_digest(win, own)}
                bf.win_fence("aw")
                out["folded"] = bf.win_fold_stale_residuals("aw")
                out["after"] = state_digest(win, own)
                shipped_ok = True
                with win.lock:
                    for (d, s), v in win.staging.items():
                        want = sum(rows[s] * float(k + 1) * 0.5
                                   for k in range(len(WIN_ASYNC_PHASES)))
                        shipped_ok &= bool(torch.equal(v, want))
                out.update(shipped_exact=shipped_ok, seconds=seconds,
                           stats=stats_since(W, before),
                           send_path=tr.send_path,
                           info=W.async_info())
                bf.win_free("aw")
                W.turn_off_win_ops_with_associated_p()
                bf.barrier()
            W.configure_async()
            res[f"{policy}/{path}"] = out
    return res


def win_async_ops_phase(card, cpu):
    """``async_ops_worker``'s results on the card (``dist_phases``'
    workers) and on the CPU: every digest the same, the policy fired, the
    mass shipped exactly; returns nothing."""
    per_process = []
    for p, (c, h) in enumerate(zip(card, cpu)):
        mine = {"owned": c["owned"]}
        for key in sorted(k for k in c if "/" in k):
            got, want = c[key], h[key]
            for when in ("before", "after"):
                require(got[when] == want[when],
                        f"win_async_ops {key} {when}: process {p}'s state "
                        "differs from the CPU run")
            require(got["folded"] == want["folded"]
                    and got["shipped_exact"] and want["shipped_exact"],
                    f"win_async_ops {key}: folded {got['folded']}, the "
                    "mass shipped exact on card and CPU")
            mine[key] = {
                "bitwise_cpu": True, "folded": got["folded"],
                "stale_edges": sorted(got["before"]["stale_residual"]),
                "shipped_exact": True, "send_path": got["send_path"],
                "seconds": got["seconds"], "cpu_seconds": want["seconds"],
                "tx_bytes": got["stats"]["tx_bytes"],
                "step_lag": (got["info"] or {}).get("step_lag")}
        per_process.append(mine)
    fired = [k for m in per_process for k, v in m.items()
             if isinstance(v, dict) and v["stale_edges"]]
    require(fired, "win_async_ops: the staleness policy never fired")
    emit("win_async_ops", processes=WIN_DIST_PROCS,
         ranks_per_process=WIN_DIST_PER, shape=[4, WIN_ASYNC_COLS],
         dtype="float32", topology="ExponentialGraph(4)",
         phases=WIN_ASYNC_PHASES, policies=WIN_ASYNC_POLICIES,
         staleness_steps=1, trace_sample=1, per_process=per_process)


def async_train_worker(bf):
    """win_put at ``WIN_ASYNC_PUT_LAYERS`` and push-sum at
    ``WIN_ASYNC_PUSHSUM_LAYERS``: lockstep steps, then async ones under
    ``WIN_ASYNC_KNOBS``, process 1 sleeping before every step."""
    import gc

    import torch

    from bluefog_tpu_torch import benchmark
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.optim import window_optimizers as WO
    from bluefog_tpu_torch.utils import config
    comm = bf.process_ranks()
    straggler = comm.process == 1

    def done(tr):
        W.win_fence()
        tr.opt.free()
        del tr
        gc.collect()
        empty_cache()
        bf.barrier()

    def trainer(kind):
        if kind == "win_put":
            return benchmark.Trainer(lm_args(
                benchmark, WIN_ASYNC_PUT_LAYERS, "win_put"))
        tr = benchmark.Trainer(lm_args(benchmark, WIN_ASYNC_PUSHSUM_LAYERS,
                                       "empty"))
        tr.opt = WO.DistributedPushSumOptimizer(
            torch.optim.SGD([tr.rep.flat], lr=0.0125 * 4))
        return tr

    def run(kind, steps):
        tr = trainer(kind)
        opt = tr.opt
        rec = {"step_ms": [], "losses": [], "mutex_wait_ms": [],
               "step_lag": [], "p_sum_after_backstop": []}
        for _ in range(steps):
            if straggler:
                time.sleep(WIN_ASYNC_SLEEP)
            before = W.stats.snapshot()
            backstops = getattr(opt, "backstops", 0)
            sync()
            t0 = time.perf_counter()
            rec["losses"].append([float(v) for v in tr.forward_backward()])
            opt.step()
            sync()
            rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
            rec["mutex_wait_ms"].append(
                1e3 * stats_since(W, before)["mutex_s"])
            info = W.async_info()
            rec["step_lag"].append(None if info is None
                                   else info["step_lag"])
            if getattr(opt, "backstops", 0) > backstops:
                # Every process takes the backstop at the same step.
                p = opt.associated_p()[bf.owned_ranks()]
                rec["p_sum_after_backstop"].append(float(comm.all_reduce(
                    torch.tensor([float(p.sum())], dtype=torch.float64))
                    .wait()[0]))
        rec["async_on"] = bool(opt._async_on)
        rec["folded_edges"] = list(getattr(opt, "folded_edges", []))
        rec["info"] = W.async_info()
        done(tr)
        return rec

    out = {}
    FA.reset_launch_counts()
    for kind in ("win_put", "push_sum"):
        out[kind] = {"lockstep": run(kind, WIN_ASYNC_LOCKSTEP_STEPS)}
        with config.override(**WIN_ASYNC_KNOBS):
            out[kind]["async"] = run(kind, WIN_ASYNC_STEPS[kind])
        W.configure_async()
    out["launches"] = flash_launches()
    out["send_path"] = W._store.distrib.transport.send_path
    out["links"] = links_and_slo(bf)
    return out


def links_and_slo(bf):
    """After the traced async runs: ``bf.link_report()`` over both
    processes, the topology's cross-process edges, and one SLO rule set to
    breach at a step boundary (``link_delay_us>=0``): the breach counter
    and this process's flight-recorder dump."""
    import shutil
    import tempfile

    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.utils import config, flightrec, telemetry
    rep = bf.link_report()
    owner = {r: W._store.distrib.rank_owner[r] for r in range(bf.size())}
    cross = sorted((s, d) for s, d in bf.load_topology().edges()
                   if s != d and owner[s] != owner[d])
    tmp = tempfile.mkdtemp(prefix="slo_")
    try:
        flightrec.enable()
        prefix = os.path.join(tmp, "fr")
        with config.override(slo="link_delay_us>=0",
                             flight_recorder_path=prefix):
            W.set_async_step(1 << 20)
            snap = telemetry.snapshot()
            health = telemetry.health().get("links")
        dumps = [f for f in os.listdir(tmp) if f.startswith("fr.")]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"report": rep, "cross_edges": cross, "health": health,
            "breaches": sum(v for k, v in snap.items()
                            if k.startswith("bf_slo_breaches_total")),
            "dumps": dumps}


def win_async_train_phase(parts):
    """``async_train_worker``'s results across the processes; returns the
    launches of K1-K3, summed over the processes."""
    expected = WIN_DIST_PER * sum(
        layers * (WIN_ASYNC_LOCKSTEP_STEPS + WIN_ASYNC_STEPS[kind])
        for kind, layers in (("win_put", WIN_ASYNC_PUT_LAYERS),
                             ("push_sum", WIN_ASYNC_PUSHSUM_LAYERS)))
    launches = {k: 0 for k in KERNELS}
    per_process = []
    for p, part in enumerate(parts):
        require(all(c == expected for c in part["launches"].values()),
                f"win_async_train launches {part['launches']}, expected "
                f"{expected} of each a process")
        mine = {"owned": part.get("owned"), "launches": part["launches"],
                "send_path": part["send_path"], "straggler": p == 1}
        for kind in ("win_put", "push_sum"):
            lock, asy = part[kind]["lockstep"], part[kind]["async"]
            for rec in (lock, asy):
                require(all(math.isfinite(v) for ls in rec["losses"]
                            for v in ls), f"{kind}: finite losses")
            require(asy["async_on"] and not lock["async_on"],
                    f"{kind}: the async mode armed only in the async run")
            mine[kind] = {
                "lockstep_step_ms": lock["step_ms"],
                "async_step_ms": asy["step_ms"],
                "lockstep_mutex_wait_ms": lock["mutex_wait_ms"],
                "async_mutex_wait_ms": asy["mutex_wait_ms"],
                "step_lag": asy["step_lag"], "info": asy["info"],
                "folded_edges": asy["folded_edges"],
                "p_sum_after_backstop": asy["p_sum_after_backstop"],
                "losses": {"lockstep": lock["losses"],
                           "async": asy["losses"]}}
        ps = part["push_sum"]["async"]
        require(len(ps["p_sum_after_backstop"]) >= 1
                and all(abs(v - 4.0) <= 1e-9
                        for v in ps["p_sum_after_backstop"]),
                f"push_sum: P after each backstop {ps}")
        links = part["links"]
        delayed = {(e["src"], e["dst"]) for e in links["report"]["edges"]
                   if e.get("delay_us", 0) > 0}
        require(links["cross_edges"]
                and {tuple(e) for e in links["cross_edges"]} <= delayed,
                f"link_report: cross-process edges {links['cross_edges']} "
                f"without a measured delay ({sorted(delayed)})")
        require(len({g["peer"] for g in links["report"]["goodput"]}) == 2
                and all(g["goodput_bytes_s"] > 0
                        for g in links["report"]["goodput"]),
                f"link_report goodput {links['report']['goodput']}")
        require(links["breaches"] >= 1 and len(links["dumps"]) == 1
                and links["health"]["slo"]["breached"]
                == ["link_delay_us>=0"],
                f"the SLO breach: {links}")
        mine["links"] = links
        for k in KERNELS:
            launches[k] += part["launches"][k]
        per_process.append(mine)
    emit("win_async_train", config={
        **LM_WIDTHS, "batch_size": 2, "processes": WIN_DIST_PROCS,
        "ranks_per_process": WIN_DIST_PER, "layout": "owned",
        "win_put_layers": WIN_ASYNC_PUT_LAYERS,
        "push_sum_layers": WIN_ASYNC_PUSHSUM_LAYERS,
        "knobs": WIN_ASYNC_KNOBS, "policy": "reject",
        "straggler_sleep_s": WIN_ASYNC_SLEEP,
        "lockstep_steps": WIN_ASYNC_LOCKSTEP_STEPS,
        "async_steps": WIN_ASYNC_STEPS},
        expected_launches_per_process=expected, per_process=per_process,
        launches=launches)
    return launches


def win_dist_train_phase(parts):
    """``train_worker``'s results across the processes; returns the
    launches of K1-K3, summed over the processes."""
    lm_expected = WIN_DIST_LAYERS * WIN_DIST_PER * (1 + WIN_DIST_LM_ITERS)
    var_expected = WIN_DIST_VARIANT_LAYERS * WIN_DIST_PER * \
        WIN_DIST_VARIANT_STEPS * 2
    # plan_fused_runs: a step eagerly, two fused steps.
    pf_expected = WIN_DIST_LAYERS * WIN_DIST_PER * 3
    launches = {k: 0 for k in KERNELS}
    per_process = []
    for part in parts:
        lm = part["lm"]
        require(all(math.isfinite(x) for x in lm["losses"]),
                f"win_dist_train: finite losses {lm['losses']}")
        require(all(c == lm_expected for c in lm["launches"].values()),
                f"win_dist_train launches {lm['launches']}, expected "
                f"{lm_expected} of each a process")
        require(lm["spread"]["after_combine"] < lm["spread"]["after_adapt"],
                f"win_dist_train: the combine shrinks the spread "
                f"{lm['spread']}")
        rn = part["resnet50"]
        require(all(math.isfinite(x) for x in rn["losses"]),
                f"resnet50 win_put: finite losses {rn['losses']}")
        require(rn["spread"]["after_combine"] < rn["spread"]["after_adapt"],
                f"resnet50 win_put: the spread {rn['spread']}")
        require(all(c == var_expected
                    for c in part["variant_launches"].values()),
                f"win_dist variants launches {part['variant_launches']}")
        for name in ("pull_get", "push_sum"):
            rec = part[name]
            require(all(math.isfinite(v) for ls in rec["losses"]
                        for v in ls), f"{name}: finite losses")
        pg = part["pull_get"]
        require(all(b < a for a, b in zip(pg["rms_after_adapt"],
                                          pg["rms_after_combine"])),
                f"pull_get: the combine shrinks the spread {pg}")
        ps = part["push_sum"]
        require(abs(ps["p_sum"] - 4.0) <= 1e-4 * 4.0
                and min(ps["p_owned"]) > 0, f"push_sum P {ps}")
        pf = part["plan_fused"]
        require(pf["fused"]["staging"] == pf["host"]["staging"],
                "fused: the staging rows differ from WIN_XLA=0's")
        fz = pf["fused"]
        # (A CPU rehearsal neither captures nor stages: the plans read the
        # tensors' memory.)
        card = DEVICE == "cuda"
        require(fz["armed"] and fz["active"] == 1.0
                and fz["fused_steps"] == 2 and fz["replays"] == int(card)
                and fz["captures"] == int(card)
                and fz["statuses"] == [0, 0],
                f"fused across processes: {fz}")
        require(not card or (pf["host"]["window"]["stage_bytes"] > 0
                             and pf["fused"]["window"]["stage_bytes"] == 0
                             and all(fz["staging_gbps"].values())),
                f"staging by path: {pf['host']['window']}, "
                f"{pf['fused']['window']}, {fz['staging_gbps']}")
        require(all(c == pf_expected
                    for c in part["plan_fused_launches"].values()),
                f"plan/fused launches {part['plan_fused_launches']}")
        for k in KERNELS:
            launches[k] += (lm["launches"][k] + part["variant_launches"][k]
                            + part["plan_fused_launches"][k])
        win = lm["window"]
        per_process.append({
            "owned": part.get("owned"), "step_ms": lm["step_ms"],
            "tokens_per_s": lm["tokens_per_s"],
            "peak_mem_gb": lm.get("peak_mem_gb"),
            "launches": lm["launches"],
            "window_ms": {"stage_out": 1e3 * win["stage_s"],
                          "wire": 1e3 * win["wire_s"],
                          "mutex_wait": 1e3 * win["mutex_s"],
                          "commit": 1e3 * win["commit_s"]},
            "tx_bytes_per_step": win["tx_bytes"],
            "wire_gbps": rate(win["tx_bytes"], win["wire_s"]),
            "d2h_gbps": rate(win["stage_bytes"], win["stage_s"]),
            "plan_d2h_gbps": rate(win["plan_stage_bytes"],
                                  win["plan_stage_s"]),
            "h2d_gbps": rate(win["commit_bytes"], win["commit_s"]),
            "profile": part["plan_fused"]["fused"].get("profile"),
            "losses": lm["losses"],
            "spread": lm["spread"],
            "plan_fused": {
                mode: {k: v for k, v in rec.items() if k != "staging"}
                for mode, rec in part["plan_fused"].items()},
            "staging_gbps": part["plan_fused"]["fused"]["staging_gbps"],
            "resnet50": {k: rn.get(k) for k in (
                "step_ms", "imgs_per_s", "losses", "spread", "window",
                "peak_mem_gb")},
            "pull_get": part["pull_get"], "push_sum": part["push_sum"]})
    emit("win_dist_train", config={
        "num_layers": WIN_DIST_LAYERS, **LM_WIDTHS, "batch_size": 2,
        "momentum": 0.0, "processes": WIN_DIST_PROCS,
        "ranks_per_process": WIN_DIST_PER, "layout": "owned",
        "optimizer": "DistributedWinPutOptimizer",
        "topology": "ExponentialGraph(4), processes {0,1} and {2,3}",
        "variant_layers": WIN_DIST_VARIANT_LAYERS,
        "control": "gloo", "payloads": "window transport, loopback TCP"},
        row_gb=parts[0]["lm"]["row_gb"],
        tx_bytes_per_step=sum(p["tx_bytes_per_step"] for p in per_process),
        tokens_per_s=sum(p["tokens_per_s"] for p in per_process),
        expected_launches_per_process=lm_expected,
        per_process=per_process, launches=launches)
    return launches


# ---------------------------------------------------------------------------
# Elasticity: the churn gang and the elastic run loop
# ---------------------------------------------------------------------------

def churn_worker(bf, out_dir):
    """One process of the churn gang: the win_put LM at full width and
    ``WIN_DIST_LAYERS`` in the owned layout, ``DistributedWinPutOptimizer(
    fused=True)`` on ``ExponentialGraph(4)``, ``CHURN_STEPS`` steps under
    ``CHURN_KNOBS``; rank 3 SIGKILLs itself at the top of step
    ``CHURN_KILL_STEP`` (after noting the time in ``kill_clock``).  Reports
    through its JSON file only: after the kill no collective runs."""
    import numpy as np
    import torch

    from bluefog_tpu_torch import benchmark
    from bluefog_tpu_torch import topology as T
    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.ops import window as W
    from bluefog_tpu_torch.optim import window_optimizers as WO
    from bluefog_tpu_torch.run import supervisor as S
    from bluefog_tpu_torch.utils import telemetry
    me = bf.process_ranks().process
    tr = benchmark.Trainer(lm_args(benchmark, WIN_DIST_LAYERS, "empty"))
    opt = tr.opt = WO.DistributedWinPutOptimizer(tr.opt.base, fused=True)
    name, flat = opt._names[0], tr.rep.flat
    lr = opt.base.param_groups[0]["lr"]
    cols = torch.from_numpy(np.sort(np.random.RandomState(SEED).choice(
        flat.shape[1], CHURN_SAMPLE, replace=False))).to(flat.device)
    sup = S.maybe_supervisor()
    rec = {"losses": [], "step_ms": [], "adapt": [], "combined": [],
           "captures": [], "builds": [], "commit_step": None}
    live = rec["liveness"] = _watch_liveness(sup)
    prev = {}

    def on_change(view):
        # Right after the rebuild: the owned rows against the window's
        # memory at the end of the previous step, which the recovery
        # snapshotted on the card.
        rec["commit_unix"] = sup.ctrl.last_change_unix
        win = W._store.get(name)
        rec["rebuilt_rows"] = row_hashes([win.main[r] for r in win.owned])
        rec["snapshot_rows"] = row_hashes([prev[r] for r in win.owned])
        wm = T.weight_matrix(bf.load_topology())
        rec["topology"] = {
            "row_sums": wm.sum(axis=1).tolist(),
            "col_sums": wm.sum(axis=0).tolist(),
            "isolated": [int(r) for r in range(wm.shape[0])
                         if wm[r, r] == 1.0
                         and np.count_nonzero(wm[r]) == 1
                         and np.count_nonzero(wm[:, r]) == 1]}
    sup.on_change = on_change
    FA.reset_launch_counts()
    clock = os.path.join(out_dir, "kill_clock")
    for t in range(CHURN_STEPS):
        if me == 3:
            with open(clock, "a") as f:
                f.write(f"{t} {time.time()!r} {time.monotonic()!r}\n")
        sync()
        t0 = time.perf_counter()
        rec["losses"].append([float(v) for v in tr.forward_backward()])
        with torch.no_grad():
            # The adapt (SGD, momentum 0) on the sampled columns.
            rec["adapt"].append((flat[:, cols] - lr * flat.grad[:, cols])
                                .cpu().tolist())
        seen = opt.membership_change
        # The window's memory as the step's recovery, if it runs one, will
        # find it (the other processes may be steps ahead or behind).
        win = W._store.get(name)
        prev = {r: win.main[r].clone() for r in win.owned}
        t_step = time.monotonic()
        try:
            opt.step()
        except RuntimeError:
            # Voted out: stop and report (the phase's checks fail on it).
            if not opt.evicted:
                raise
            rec["evicted_at_step"] = t
            break
        sync()
        live["steps"].append([t_step, time.monotonic()])
        rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
        if opt.membership_change is not seen:
            rec["commit_step"] = t
        rec["combined"].append(flat[:, cols].cpu().tolist())
        impl = opt._fused_impl
        rec["captures"].append(impl.captures if impl else 0)
        rec["builds"].append(impl.builds if impl else 0)
    # The survivors leave together (files, no collective): one that exits
    # early would look dead to the others, still stepping.
    view = opt.membership_change
    if view is not None and not opt.evicted:
        mine = os.path.join(out_dir, f"done.{me}")
        with open(mine, "w") as f:
            f.write("1")
        others = [p for p in view.active_procs if p != me]
        deadline = time.monotonic() + 120
        while not all(os.path.exists(os.path.join(out_dir, f"done.{p}"))
                      for p in others):
            require(time.monotonic() < deadline,
                    f"churn: survivors {others} did not finish")
            time.sleep(0.05)
    impl = opt._fused_impl
    snap = telemetry.snapshot()
    if os.path.exists(clock):
        with open(clock) as f:
            stamps = [ln.split() for ln in f if ln.strip()]
        rec["kill_clock"] = {int(t): float(u) for t, u, _ in stamps}
        rec["kill_mono"] = {int(t): float(m) for t, _, m in stamps}
    live["commit_mono"] = (None if sup.ctrl.last_change_unix is None else
                           sup.ctrl.last_change_unix - time.time()
                           + time.monotonic())
    rec.update(
        launches=flash_launches(), epoch=view.epoch if view else 0,
        active=list(view.active_ranks) if view else None,
        evicted=opt.evicted, membership=bf.membership_info(),
        recovery=sup.last_recovery,
        recoveries=snap.get("bf_churn_recovery_seconds_count", 0.0),
        fused={"builds": impl.builds, "captures": impl.captures,
               "replays": impl.replays, "fused_steps": impl.fused_steps,
               "statuses": impl.last_statuses},
        send_errors=opt.churn_send_errors,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9
        if DEVICE == "cuda" else None)
    return rec


def _watch_liveness(sup):
    """Record, on the host's monotonic clock (one clock for every process
    of the gang on this machine), each membership message's arrival from
    each peer (the drain thread's ``on_message``), each tick of this
    process's heartbeat thread (the round of sends and probes), each
    reachability probe, and each call of the drain thread that took
    over 50 ms; the lists live in the returned dict."""
    live = {"arrivals": {}, "stages": {}, "sent": {}, "ticks": [],
            "probes": [], "drain": [], "steps": [], "proposals": [],
            "own_proposals": [], "port": sup._d.transport.port,
            "startup_heard": sup.startup_heard}
    ctrl = sup.ctrl
    on_message, tick, probe = ctrl.on_message, ctrl.tick, ctrl.probe_fn
    tr = sup._d.transport
    owner = sup._d.rank_owner
    tr.member_rx.clear()

    def timed_on_message(msg):
        t = time.monotonic()
        p = msg.get("proc", -1)
        live["arrivals"].setdefault(str(p), []).append(t)
        # The frame's read and pop stamps (the transport keeps them a
        # source rank, in the order they are handed on).
        for r in sorted(q for q, o in owner.items() if o == p):
            stamps = tr.member_rx.get(r)
            if stamps:
                read, popped = stamps.popleft()
                live["stages"].setdefault(str(p), []).append(
                    [t, read, popped])
                break
        if msg.get("prop") is not None:
            live["proposals"].append([t, msg.get("proc"), msg.get("epoch"),
                                      sorted(msg["prop"])])
        on_message(msg)

    def tick_and_note():
        tick()
        # This process's proposal when it changes, with each peer's
        # silence then (seconds since its last message).
        own = ctrl.proposals.get(ctrl.my_proc)
        own = None if own is None else [own[0], sorted(own[1])]
        if not live["own_proposals"] or live["own_proposals"][-1][1] != own:
            now = time.monotonic()
            live["own_proposals"].append(
                [now, own, {str(p): ctrl.now_fn() - s
                            for p, s in ctrl.last_seen.items()}])

    def timed(fn, into):
        def call(*a):
            t0 = time.monotonic()
            try:
                return fn(*a)
            finally:
                into.append([t0, time.monotonic() - t0])
        return call

    def noted_probe(p):
        t0 = time.monotonic()
        ok = bool(probe(p))
        live["probes"].append([t0, p, ok, time.monotonic() - t0])
        return ok

    def slow_drain(fn, kind):
        def call(*a):
            t0 = time.monotonic()
            try:
                return fn(*a)
            finally:
                dt = time.monotonic() - t0
                if dt > 0.05:
                    live["drain"].append([t0, dt, kind])
        return call

    def watch_stalls():
        # A thread that sleeps 20 ms at a time: a wake-up over 250 ms late
        # means this process's threads were held off (the GIL, or no
        # core).  Where each thread stood just before (its three innermost
        # frames): the one that ran next held them off.
        me = threading.get_ident()
        while True:
            names = {t.ident: t.name for t in threading.enumerate()}
            where = {names.get(ident, str(ident)): [
                f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} "
                f"{f.f_code.co_name}" for f in _innermost(frame, 3)]
                for ident, frame in sys._current_frames().items()
                if ident != me}
            t0 = time.monotonic()
            time.sleep(0.02)
            late = time.monotonic() - t0
            if late > 0.25:
                live["stalls"].append([t0, late, where])

    send_copy = sup._send_copy

    def noted_send(key, payload):
        # Each heartbeat copy's enqueue, a peer's port at a time.
        live["sent"].setdefault(str(key[1]), []).append(time.monotonic())
        send_copy(key, payload)

    sup._send_copy = noted_send
    with sup._senders_lock:
        for sender in sup._senders.values():
            sender._send = noted_send
    live["stalls"] = []
    threading.Thread(target=watch_stalls, daemon=True,
                     name="smoke-stall-watch").start()
    ctrl.on_message = timed_on_message
    ctrl.tick = timed(tick_and_note, live["ticks"])
    ctrl.probe_fn = noted_probe
    for attr in ("_apply", "_apply_batch", "_apply_items"):
        if getattr(tr, attr, None) is not None:
            setattr(tr, attr, slow_drain(getattr(tr, attr), attr))
    return live


def _innermost(frame, k):
    out = []
    while frame is not None and len(out) < k:
        out.append(frame)
        frame = frame.f_back
    return out


GAP_SPLIT_S = 0.25            # heartbeat gaps split across their stages


def _gap_splits(stages, sent, kill_mono, until=None):
    """Every gap over ``GAP_SPLIT_S`` between two heartbeats of one peer
    (each ``[noted, read, popped]``) split across the stages: the longest
    pause of the sender's enqueues to this process inside the gap, the
    rest of the gap between the two frames' reads (the wire and the
    reader), the ending frame's wait from its read to its pop (behind the
    frames ahead of it), and from its pop to the controller's note.  Gaps
    that start at or after ``until`` are left out (a killed peer's)."""
    out = []
    for (n1, r1, q1), (n2, r2, q2) in zip(stages, stages[1:]):
        if n2 - n1 <= GAP_SPLIT_S or (until is not None and n1 >= until):
            continue
        inside = [t for t in sent if n1 - 1.0 <= t <= n2]
        pause = max((b - a for a, b in zip(inside, inside[1:])),
                    default=None)
        read_gap = r2 - r1
        out.append({
            "start": round(n1 - kill_mono, 4), "gap": round(n2 - n1, 4),
            "sender_pause": None if pause is None else round(pause, 4),
            "wire_and_reader": round(read_gap - (pause or 0.0), 4),
            "queued_to_pop": round(q2 - r2, 4),
            "pop_to_note": round(n2 - q2, 4)})
    return out


def _liveness_report(survivors, kill_mono, suspect_s):
    """Per survivor, on times relative to the kill: each peer's three
    longest gaps between heartbeats (start, seconds), every gap over
    ``GAP_SPLIT_S`` split across its stages (``_gap_splits``; a killed
    peer's from its kill on left out), the heartbeat thread's longest gap
    between ticks and longest tick, every probe, the three longest drain
    calls, the commit of the new view, and the three longest stalls of
    the process's threads with where each was."""
    out = []
    for p, rec in enumerate(survivors):
        live = rec.get("liveness") or {}
        # What each live peer enqueued to this process.
        sent_to_me = {str(q): (other.get("liveness") or {}).get(
            "sent", {}).get(str(live.get("port")), [])
            for q, other in enumerate(survivors) if q != p}
        splits = {}
        for q, st in sorted(live.get("stages", {}).items()):
            gaps = _gap_splits(st, sent_to_me.get(q, []), kill_mono,
                               until=None if q in sent_to_me else kill_mono)
            splits[q] = {
                "count": len(gaps),
                "sums": {k: round(sum(g[k] or 0.0 for g in gaps), 4)
                         for k in ("gap", "sender_pause", "wire_and_reader",
                                   "queued_to_pop", "pop_to_note")},
                "longest": sorted(gaps, key=lambda g: -g["gap"])[:5]}

        def longest(times, k=3):
            gaps = sorted(((b - a, a) for a, b in zip(times, times[1:])),
                          reverse=True)[:k]
            return [[round(a - kill_mono, 4), round(g, 4)] for g, a in gaps]
        ticks = live.get("ticks", [])
        out.append({
            "process": p, "epoch": rec.get("epoch"),
            "active": rec.get("active"), "evicted": rec.get("evicted"),
            "startup_heard_s": live.get("startup_heard"),
            "commit_s": (None if live.get("commit_mono") is None
                         else round(live["commit_mono"] - kill_mono, 4)),
            "heartbeat_gaps": {q: longest(ts) for q, ts in
                               sorted(live.get("arrivals", {}).items())},
            "gap_splits": splits,
            "longest_live_gap": max(
                (g["gap"] for sp in splits.values() for g in sp["longest"]),
                default=0.0),
            "gaps_over_suspicion": {
                q: sum(1 for a, b in zip(ts, ts[1:]) if b - a > suspect_s)
                for q, ts in sorted(live.get("arrivals", {}).items())},
            "tick_gaps": longest([t for t, _ in ticks], 2),
            "longest_ticks": [[round(t - kill_mono, 4), round(d, 4)]
                              for t, d in sorted(ticks, key=lambda x: -x[1])
                              [:2]],
            "probes": [[round(t - kill_mono, 4), q, ok, round(d, 4)]
                       for t, q, ok, d in live.get("probes", [])][:12],
            "longest_drain_calls": [
                [round(t - kill_mono, 4), round(d, 4), n] for t, d, n in
                sorted(live.get("drain", []), key=lambda x: -x[1])[:3]],
            "steps": [[round(a - kill_mono, 3), round(b - kill_mono, 3)]
                      for a, b in live.get("steps", [])],
            "own_proposals": [
                [round(t - kill_mono, 4), prop,
                 {q: round(s, 3) for q, s in ages.items()}]
                for t, prop, ages in live.get("own_proposals", [])][:8],
            "peer_proposals": [
                [round(t - kill_mono, 4), q, e, prop]
                for t, q, e, prop in live.get("proposals", [])][:8],
            "stalls": len(live.get("stalls", [])),
            "longest_stalls": [
                [round(t - kill_mono, 4), round(d, 4), where]
                for t, d, where in sorted(live.get("stalls", []),
                                          key=lambda x: -x[1])[:3]]})
    return out


def _spread(rows):
    """rms over the sampled columns of each process's deviation from the
    processes' mean."""
    import numpy as np
    x = np.asarray(rows, dtype=np.float64)
    return float(np.sqrt(((x - x.mean(axis=0)) ** 2).mean()))


def churn_train_phase():
    """``churn_worker`` in ``CHURN_PROCS`` processes of one rank, rank 3
    killed: the survivors' checks; returns the launches of K1-K3, summed
    over the survivors."""
    import gc

    import numpy as np
    import torch
    # Four processes of ~11 GB share the card with this one: it hands its
    # cached blocks back first (an archive run went out of memory here).
    gc.collect()
    empty_cache()
    main_gb = ({"allocated": torch.cuda.memory_allocated() / 1e9,
                "reserved": torch.cuda.memory_reserved() / 1e9}
               if DEVICE == "cuda" else None)
    t0 = time.perf_counter()
    parts, summary, clock = launch_workers(
        "churn", procs=CHURN_PROCS, per=1, env=CHURN_KNOBS, killed=(3,))
    wall = time.perf_counter() - t0
    survivors = parts[:3]
    kill_mono = (survivors[0].get("kill_mono") or {}).get(
        str(CHURN_KILL_STEP))
    # Before the checks, so that a failed run shows it too (its times from
    # process 0's first step where rank 3 left no kill time).
    suspect_s = float(CHURN_KNOBS["BLUEFOG_TPU_CHURN_SUSPECT_MS"]) / 1e3
    zero = (kill_mono if kill_mono is not None
            else survivors[0]["liveness"]["steps"][0][0])
    # The start-up skew: the latest first heartbeat of a peer, in seconds
    # from a supervisor's start (the supervisor's start-up window).
    skew = max((s for rec in survivors for s in ((rec.get("liveness") or {})
                .get("startup_heard") or {}).values()), default=None)
    emit("churn_liveness", exit_summary=summary, launch_clock=clock,
         suspect_s=suspect_s, startup_skew_s=skew,
         times_from="kill" if kill_mono is not None else "first step",
         survivors=_liveness_report(survivors, zero, suspect_s))
    require(kill_mono is not None, "churn: rank 3 left no kill time")
    for rec in survivors:
        rec.pop("liveness", None)
    expected = WIN_DIST_LAYERS * CHURN_STEPS
    launches = {k: 0 for k in KERNELS}
    per_process = []
    commits = []
    for p, rec in enumerate(survivors):
        require(rec["epoch"] == 1 and rec["active"] == [0, 1, 2]
                and not rec["evicted"],
                f"churn process {p}: committed {rec['epoch']} "
                f"{rec['active']} evicted={rec['evicted']}")
        require(rec["recoveries"] == 1.0,
                f"churn process {p}: bf_churn_recovery_seconds observed "
                f"{rec['recoveries']} times")
        require(rec["snapshot_rows"] == rec["rebuilt_rows"]
                and all(rec["recovery"]["rows_equal"].values()),
                f"churn process {p}: the rebuilt rows differ")
        topo = rec["topology"]
        require(np.allclose(topo["row_sums"], 1.0)
                and np.allclose(topo["col_sums"], 1.0)
                and topo["isolated"] == [3],
                f"churn process {p}: survivor topology {topo}")
        require(all(math.isfinite(v) for ls in rec["losses"] for v in ls),
                f"churn process {p}: losses {rec['losses']}")
        # The fused program re-keys at the commit's epoch: built anew at
        # the commit's step, captured (on the card) at the next.
        c = rec["commit_step"]
        card = DEVICE == "cuda"
        require(c is not None and c + 1 < CHURN_STEPS
                and rec["builds"][c] > (rec["builds"][c - 1] if c else 0)
                and (not card or rec["captures"][-1] > rec["captures"][c]),
                f"churn process {p}: no new program after the commit at "
                f"step {c}: builds {rec['builds']}, captures "
                f"{rec['captures']}")
        require(rec["fused"]["statuses"]
                and all(v == 0 for v in rec["fused"]["statuses"]),
                f"churn process {p}: statuses {rec['fused']}")
        require(all(v == expected for v in rec["launches"].values()),
                f"churn process {p}: launches {rec['launches']}, expected "
                f"{expected}")
        for k in KERNELS:
            launches[k] += rec["launches"][k]
        commits.append(rec["commit_unix"])
        before = rec["step_ms"][1:CHURN_KILL_STEP]
        after = rec["step_ms"][c + 2:]
        per_process.append({
            "commit_step": c, "recovery_s": rec["recovery"]["seconds"],
            "step_ms": rec["step_ms"],
            "step_ms_before_commit": before, "step_ms_after_commit": after,
            "peak_mem_gb": rec["peak_mem_gb"], "fused": rec["fused"],
            "send_errors": rec["send_errors"], "losses": rec["losses"],
            "captures": rec["captures"], "builds": rec["builds"],
            "launches": rec["launches"]})
    last = CHURN_STEPS - 1
    adapt = _spread([r["adapt"][last] for r in survivors])
    combined = _spread([r["combined"][last] for r in survivors])
    # Each step's spread from the first commit on: a survivor's first
    # combine after its rebuild takes a zero staging slot (the JAX
    # supervisor's zero_init; the peer's first put of the new epoch lands
    # later), which pulls its row toward zero; the delayed averaging then
    # shrinks the spread step by step (reported, the reference's
    # transient).
    first_commit = min(r["commit_step"] for r in survivors)
    spread_by_step = [
        {"step": t, "after_adapt": _spread([r["adapt"][t]
                                            for r in survivors]),
         "after_combine": _spread([r["combined"][t] for r in survivors])}
        for t in range(first_commit, CHURN_STEPS)]
    require(combined < adapt, f"churn: spread after the combine {combined} "
            f"not below after the adapt {adapt} at step {last}; by step "
            f"{spread_by_step}")
    # The kill: rank 3's clock at the top of its step CHURN_KILL_STEP,
    # read by the survivors from the file it left.
    kill_t = survivors[0].get("kill_clock", {}).get(str(CHURN_KILL_STEP))
    require(kill_t is not None, "churn: rank 3 left no kill time")
    detection = [c - kill_t for c in commits]
    require(all(d > 0 for d in detection),
            f"churn: commits {commits} before the kill {kill_t}")
    emit("churn_train", config={
        **LM_WIDTHS, "num_layers": WIN_DIST_LAYERS, "batch_size": 2,
        "processes": CHURN_PROCS, "ranks_per_process": 1, "layout": "owned",
        "optimizer": "DistributedWinPutOptimizer(fused=True)",
        "topology": "ExponentialGraph(4)", "steps": CHURN_STEPS,
        "knobs": CHURN_KNOBS},
        wall_s=wall, main_process_gb=main_gb,
        detection_s=detection,
        recovery_s=[p["recovery_s"] for p in per_process],
        spread_last_step={"after_adapt": adapt, "after_combine": combined},
        spread_by_step=spread_by_step,
        expected_launches_per_survivor=expected, per_process=per_process,
        launches=launches)
    return launches


# chaos_tool: the tool's join leg at its smoke profile's sizes (32-float
# rows, the kill at step 80) but 40 s of gossip where --join-smoke caps it at
# 24 and a 10 ms pace where it has 3: on a loaded host the joiner, which
# imports torch and opens its CUDA context after the shrink, came up after
# the members had stopped at the 24 s deadline (PERF.md section 6).
CHAOS_TOOL_ARGS = ("--join-leg", "--run-sec", "40", "--dim", "32",
                   "--pace-ms", "10", "--kill-step", "80")
CHAOS_TOOL_TIMEOUT = 300


# interactive: ibfrun's sessions (ROADMAP item 22e).  The JAX package's
# piped-session cells (tests/test_interactive.py), on the card's rows; each
# marker line is flushed so its arrival times the cell.
IBF_CELLS = """
import torch
x = torch.arange(bf.size(), dtype=torch.float32, device=bf.device())[:, None]
for _ in range(60): x = bf.neighbor_allreduce(x)

print('CELL1', float(abs(x - x.mean()).max()) < 1e-3, flush=True)
bf.suspend()
try:
    bf.neighbor_allreduce(x)
    print('CELL2 False', flush=True)
except RuntimeError:
    print('CELL2 True', flush=True)

bf.resume()
print('CELL3', float(bf.allreduce(x).mean()) >= 0, flush=True)
print('ROWS', tuple(x.shape), x.device, flush=True)
"""
# The gang's cells after the cluster notebook's: %bfstat, a cell that
# raises on process 1 only, one more cell, then EOF (the exit).
IBF_GANG_TAIL = ("%bfstat\n"
                 "print('RAISE-CELL', bf.rank(), flush=True)\n"
                 "if bf.rank() == 1: raise ValueError('only on rank 1')\n\n"
                 "print('AFTER', bf.rank(), bf.device(), flush=True)\n")
IBF_TIMEOUT = 240            # seconds a session may take
IBF_EXIT_DEADLINE = 15.0     # ibfrun's wait for the workers after the REPL


def _nb_cells(name):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bluefog_tpu_torch", "notebooks", name)
    with open(path) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def _ibf_session(argv, cells, env):
    """``python -m bluefog_tpu_torch.run.interactive argv`` with ``cells``
    piped in, under ``env``: the exit code, the stdout lines each with its
    seconds since the launch, stderr and the seconds to the exit."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, "-m", "bluefog_tpu_torch.run.interactive", *argv],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=here, env=env)
    lines, err = [], []
    pumps = [threading.Thread(target=lambda: lines.extend(
                 (time.perf_counter() - t0, ln) for ln in p.stdout)),
             threading.Thread(target=lambda: err.append(p.stderr.read()))]
    for t in pumps:
        t.start()
    try:
        p.stdin.write(cells)
        p.stdin.close()
        rc = p.wait(timeout=IBF_TIMEOUT)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    exit_s = time.perf_counter() - t0
    for t in pumps:
        t.join(timeout=10)
    return rc, lines, err[0] if err else "", exit_s


def _marks(lines, markers):
    """The seconds at which each marker's first line arrived (None if it
    never did), and each step's seconds from the marker before."""
    at = [next((t for t, ln in lines if m in ln), None) for m in markers]
    steps = [None if b is None or a is None else b - a
             for a, b in zip(at, at[1:])]
    return at, steps


def _session_report(rc, lines, err, exit_s, markers):
    at, steps = _marks(lines, markers)
    last = max((t for t in at if t is not None), default=None)
    return {"rc": rc, "ready_s": at[0],
            "cell_s": dict(zip(markers[1:], steps)),
            "exit_after_last_cell_s": None if last is None
            else exit_s - last, "wall_s": exit_s,
            "stderr_tail": err[-1500:] if rc else None}


def _helloworld_in_process():
    """The port's helloworld notebook cell by cell in this process, 8
    ranks on the card: its printed lines and each cell's seconds."""
    import bluefog_tpu_torch as bf
    before = _env_set({"BFTPU_DEVICE": DEVICE, "BFTPU_LOCAL_DEVICES": None})
    ns, cell_s = {}, []
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            for cell in _nb_cells("interactive_helloworld.ipynb"):
                t0 = time.perf_counter()
                exec(cell, ns)  # noqa: S102
                sync()
                cell_s.append(time.perf_counter() - t0)
        dev = str(bf.device())
    finally:
        bf.shutdown()
        _env_set(before)
    out = buf.getvalue()
    m = re.search(r"max deviation from mean: (\S+)", out)
    res = {"device": dev, "cell_s": cell_s,
           "ranks": "ranks: 8 | my rank: 0" in out,
           "suspended_refused": "comm while suspended -> RuntimeError" in out,
           "max_deviation": float(m.group(1)) if m else None}
    require(res["ranks"] and res["suspended_refused"]
            and dev.startswith(DEVICE) and res["max_deviation"] is not None
            and res["max_deviation"] < 1e-3,
            f"interactive helloworld notebook: {res}\n{out[-2000:]}")
    return res


# The phases the interactive leg's sessions ride: in this process, with no
# liveness check and no timing gate.
IBF_RIDES = ("tp_example", "pp_example", "elastic_example", "examples_22a")


def start_interactive_sessions():
    """(a) and (c) of the ``interactive`` leg, started before the phases
    of ``IBF_RIDES`` (most of a session is its processes' start-up, which
    then overlaps them): (a) ``ibfrun -np 4`` with the JAX package's three
    piped cells; (c) a two-process ``ibfrun -np 2 --hosts 127.0.0.1:2
    --backend gloo`` gang, process 0 the line REPL and process 1 a worker,
    with the cluster notebook's cells, ``%bfstat``, a cell that raises on
    rank 1 only, one more cell, and the exit.  Each session's environment
    is built here, before anything else of the leg runs.  Returns what
    :func:`interactive_leg` collects."""
    # (DEVICE "cpu" rehearses the leg: --device cpu.)
    dev_args = [] if DEVICE == "cuda" else ["--device", DEVICE]
    cells = "".join(c.rstrip("\n") + "\n\n"
                    for c in _nb_cells("cluster_notebook.ipynb"))
    env = _launcher_free_env()
    env["PYTHONUNBUFFERED"] = "1"
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(2)
    single = pool.submit(_ibf_session, ["-np", "4", *dev_args], IBF_CELLS,
                         dict(env))
    gang = pool.submit(_ibf_session, [
        "-np", "2", "--hosts", "127.0.0.1:2", "--backend", "gloo",
        *dev_args], cells + IBF_GANG_TAIL, dict(env))
    pool.shutdown(wait=False)
    return time.perf_counter(), single, gang


def interactive_leg(sessions):
    """ROADMAP item 22e on the card: (b) the port's helloworld notebook at
    8 ranks in this process, then the two sessions that
    :func:`start_interactive_sessions` started, collected and checked:
    (a) ``CELL1``-``CELL3`` True with the rows on ``cuda:0``; (c) the
    cluster notebook's ``CLUSTER-NB-OK True`` from both processes, a
    ``%bfstat`` block from each, ``rank 1 raised`` on stderr, the last
    cell run by both, and the gang's exit 0 within ibfrun's 15 s
    deadline.  The seconds from each launch to "ready", each cell's and
    the exit's, and the seconds the sessions ran before this call.
    (Kernel mode, ``--kernel-file``, is tested on the CPU only: the
    card's machine has no ``ipykernel``.)"""
    t0, single_run, gang_run = sessions
    ride_s = time.perf_counter() - t0
    want = "cuda:0" if DEVICE == "cuda" else DEVICE
    notebook = _helloworld_in_process()
    rc, lines, err, exit_s = single_run.result()
    out = "".join(ln for _, ln in lines)
    single = _session_report(rc, lines, err, exit_s,
                             ["rank(s) ready on", "CELL1", "CELL2",
                              "CELL3", "ROWS"])
    require(rc == 0 and all(f"CELL{i} True" in out for i in (1, 2, 3))
            and f"ROWS (4, 1) {want}" in out,
            f"interactive single-machine session: rc {rc}\n{out[-3000:]}\n"
            f"{err[-3000:]}")
    rc, lines, err, exit_s = gang_run.result()
    out = "".join(ln for _, ln in lines)
    gang = _session_report(
        rc, lines, err, exit_s,
        [f"2 rank(s) across 2 process(es) ready on {want}", "ranks: 2",
         "max deviation from mean", "CLUSTER-NB-OK", "[bfstat] proc 0/2",
         "RAISE-CELL 0", "AFTER 0"])
    gang.update(
        nb_ok=out.count("CLUSTER-NB-OK True"),
        bfstat=sorted(set(re.findall(r"\[bfstat\] proc (\d)/2", out))),
        raised="[ibfrun] rank 1 raised: ValueError: only on rank 1" in err,
        after=sorted(set(re.findall(r"AFTER (\d) (\S+)", out))),
        killed="gang exit summary" in err)
    require(rc == 0 and gang["nb_ok"] == 2 and gang["bfstat"] == ["0", "1"]
            and gang["raised"]
            and gang["after"] == [("0", want), ("1", want)]
            and not gang["killed"]
            and gang["exit_after_last_cell_s"] is not None
            and gang["exit_after_last_cell_s"] < IBF_EXIT_DEADLINE,
            f"interactive gang: {gang}\n{out[-3000:]}\n{err[-3000:]}")
    return {"single": single, "notebook": notebook, "gang": gang,
            "rode": list(IBF_RIDES), "ride_s": ride_s,
            "wall_s": time.perf_counter() - t0}


def chaos_tool_phase():
    """The port's chaos harness on the card, ``python -m
    bluefog_tpu_torch.tools chaos`` with ``CHAOS_TOOL_ARGS`` and
    ``--device cuda``, the tool's join leg at its own knobs: 4 processes
    of one rank under ``bfrun --elastic --chaos`` (rows of 32 float32 on
    the card, 80 ms heartbeats, 500 ms of suspicion), rank 2 killed at
    step 80, and a fresh process that joins through the persisted gang
    directory and takes its seat by one grow epoch; while that gang is
    live, ``tools top --once`` renders one frame from its telemetry
    endpoints.  The tool's verdict, the joiner's admission seconds,
    detection (the victim's clock at its kill to each member's shrink
    commit), recovery and the frame's lines."""
    import re
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.tools", "chaos",
         *CHAOS_TOOL_ARGS, "--device", DEVICE], cwd=here,
        env=_launcher_free_env(), capture_output=True, text=True,
        timeout=CHAOS_TOOL_TIMEOUT)
    wall = time.perf_counter() - t0
    out = p.stdout
    verdict = next((ln for ln in out.splitlines()
                    if re.match(r"chaos join (OK|FAILED)", ln)), None)
    m = re.search(r"chaos join: detection (\[.*?\]|None) s .*?recovery "
                  r"(\[.*?\]) s, joiner admitted after (\[.*?\]) s", out)
    t = re.search(r"tools top rendered (\d+) lines, (\d+)/(\d+) endpoints "
                  r"up \(rc (-?\d+)", out)
    rows_on = sorted(set(re.findall(r"rows on (\S+)", out)))
    frame = [ln for ln in out.splitlines() if ln.startswith("127.0.0.1:")]
    res = {"rc": p.returncode, "verdict": verdict, "wall_s": wall,
           "detection_s": json.loads(m.group(1)) if m else None,
           "recovery_s": json.loads(m.group(2)) if m else None,
           "admitted_after_s": json.loads(m.group(3)) if m else None,
           "top_lines": int(t.group(1)) if t else None,
           "top_up": int(t.group(2)) if t else None,
           "top_endpoints": int(t.group(3)) if t else None,
           "top_rc": int(t.group(4)) if t else None,
           "top_rows": frame, "rows_on": rows_on}
    emit("chaos_tool", args=list(CHAOS_TOOL_ARGS), device=DEVICE, **res)
    require(p.returncode == 0 and verdict and verdict.startswith(
        "chaos join OK"), f"chaos_tool: rc {p.returncode}, verdict "
        f"{verdict}:\n{out[-3000:]}\n{p.stderr[-3000:]}")
    require(t is not None and res["top_rc"] == 0 and res["top_up"] == 4
            and res["top_endpoints"] == 4,
            f"chaos_tool: the top frame {res}")
    want = "cuda:0" if DEVICE == "cuda" else "cpu"
    require(rows_on == [want], f"chaos_tool: rows on {rows_on}")
    require(m is not None and res["detection_s"]
            and all(d > 0 for d in res["detection_s"]),
            f"chaos_tool: detection {res}")
    return res


class _RecordingSaver:
    """``checkpoint.AsyncSaver`` that keeps each save's bytes and seconds
    (run_elastic makes its own saver; the phase reads its rates here)."""

    records = []

    @classmethod
    def make(cls, base):
        class Saver(base):
            def flush(self):
                # A write ends here (the next save, or the saver's end).
                pending = self._pending is not None
                super().flush()
                if pending:
                    cls.records.append((self.last_bytes,
                                        self.last_copy_seconds,
                                        self.last_write_seconds))
        return Saver


def elastic_train_phase(benchmark):
    """The LM at ``WIN_DIST_LAYERS`` under ``run_elastic`` (one process, 4
    virtual ranks, static neighbor_allreduce): the uninterrupted steps
    (outside it, no checkpoint), then with a checkpoint every
    ``ELASTIC_SAVE_EVERY`` steps,
    ``keep`` 2, SIGTERM after step ``ELASTIC_PREEMPT`` (``Preempted``
    after its save) and the restart that resumes; the final parameters
    bit for bit.  Returns the launches of K1-K3."""
    import signal
    import tempfile

    import torch

    from bluefog_tpu_torch.ops import flash_attention as FA
    from bluefog_tpu_torch.utils import checkpoint as CK
    from bluefog_tpu_torch.utils import elastic as EL
    tmp = tempfile.mkdtemp(prefix="elastic_")
    FA.reset_launch_counts()
    _RecordingSaver.records = []
    base_saver = CK.AsyncSaver
    CK.AsyncSaver = _RecordingSaver.make(base_saver)
    out = {}
    try:
        tr = benchmark.Trainer(lm_args(benchmark, WIN_DIST_LAYERS,
                                       "neighbor_allreduce"))
        flat = tr.rep.flat
        init = flat.detach().clone()

        def run(d, every, preempt=None):
            with torch.no_grad():
                flat.copy_(init)     # what a restarted process starts from
            seen = {}

            # A leaf a rank's row (views of flat): DCP writes them with a
            # thread each.
            rows = list(flat.unbind(0))

            def step_fn(state, step):
                tr.forward_backward()
                tr.opt.step()
                return {"rows": rows}

            def on_step(state, step):
                if preempt is not None and step + 1 == preempt:
                    os.kill(os.getpid(), signal.SIGTERM)

            def on_restore(state, step):
                seen["resume_s"] = time.perf_counter() - t0
                seen["start"] = step
                with torch.no_grad():
                    for row, saved in zip(rows, state["rows"]):
                        row.copy_(saved)

            t0 = time.perf_counter()
            try:
                EL.run_elastic(step_fn, {"rows": rows}, ckpt_dir=d,
                               num_steps=ELASTIC_STEPS, save_every=every,
                               keep=2, on_step=on_step,
                               on_restore=on_restore)
            except EL.Preempted as e:
                seen["preempted"] = e.step
            sync()
            seen["seconds"] = time.perf_counter() - t0
            seen["steps_on_disk"] = CK.list_steps(d)
            return flat.detach().clone(), seen

        # The uninterrupted reference: the same steps, no checkpoint.
        with torch.no_grad():
            flat.copy_(init)
        t0 = time.perf_counter()
        for _ in range(ELASTIC_STEPS):
            tr.forward_backward()
            tr.opt.step()
        sync()
        a, ra = flat.detach().clone(), {"seconds": time.perf_counter() - t0}
        _, rb = run(os.path.join(tmp, "b"), ELASTIC_SAVE_EVERY,
                    preempt=ELASTIC_PREEMPT)
        b, rc = run(os.path.join(tmp, "b"), ELASTIC_SAVE_EVERY)
        require(rb.get("preempted") == ELASTIC_PREEMPT
                and rb["steps_on_disk"] == [2, 3]
                and rc.get("start") == ELASTIC_PREEMPT
                and rc["steps_on_disk"] == [ELASTIC_PREEMPT, ELASTIC_STEPS],
                f"elastic: preempted {rb}, resumed {rc}")
        diff = float((a - b).abs().max())
        require(torch.equal(a, b),
                f"elastic: the resumed run differs from the uninterrupted "
                f"one by {diff} (max |difference|)")
        require(bool(torch.isfinite(a).all()), "elastic: finite")
        out.update(uninterrupted=ra, preempted=rb, resumed=rc,
                   max_abs_diff=diff)
        del tr
    finally:
        CK.AsyncSaver = base_saver
        shutil.rmtree(tmp, ignore_errors=True)
    empty_cache()
    saves = _RecordingSaver.records
    out["saves"] = [{"bytes": n, "host_copy_gbps": rate(n, c),
                     "write_gbps": rate(n, w)} for n, c, w in saves]
    launches = flash_launches()
    expected = WIN_DIST_LAYERS * 4 * 2 * ELASTIC_STEPS
    require(all(v == expected for v in launches.values()),
            f"elastic launches {launches}, expected {expected}")
    emit("elastic_train", config={
        **LM_WIDTHS, "num_layers": WIN_DIST_LAYERS, "ranks": 4,
        "steps": ELASTIC_STEPS, "save_every": ELASTIC_SAVE_EVERY,
        "keep": 2, "preempt_after": ELASTIC_PREEMPT,
        "checkpoint": "torch.distributed.checkpoint (DCP)"},
        expected_launches=expected, launches=launches, **out)
    return launches


# ---------------------------------------------------------------------------
# The schedule pipeline and sharded gossip
# ---------------------------------------------------------------------------

def _cost(c):
    return None if c is None else {k: getattr(c, k) for k in (
        "max_link_load", "hop_bytes", "serial_link_time", "rounds")}


def _sched_report(sched, model, perm):
    """A dispatched schedule's stamps, rounds against König's bound, and
    its modeled cost under the active placement."""
    from bluefog_tpu_torch.ops import placement as PL
    from bluefog_tpu_torch.ops import schedule as S
    from bluefog_tpu_torch.ops import schedule_opt as SO
    return {"provenance": S.schedule_provenance(sched),
            "sketch": getattr(sched, "sketch", None),
            "rounds": len(sched.rounds), "konig_bound": SO.min_rounds(sched),
            "modeled_cost": _cost(getattr(sched, "modeled_cost", None)),
            "priced": _cost(PL.schedule_cost(model, sched, perm))}


def check_native_rounds():
    """The native round compiler against its numpy oracle, on the
    schedule_pipeline's topologies and a dense random 512-rank matrix:
    the rounds bit for bit, and each one's host time."""
    import numpy as np

    from bluefog_tpu_torch import native
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import schedule as S
    t0 = time.perf_counter()
    native.schedule_lib()
    out = {"build_s": time.perf_counter() - t0,
           "library": native.schedule_library_path().name}
    rng = np.random.RandomState(SEED)
    dense = np.where(rng.rand(512, 512) < 0.5, rng.rand(512, 512), 0.0)
    cases = {
        "exp2_16": topo.weight_matrix(topo.ExponentialTwoGraph(SCHED_RANKS)),
        "rr4_16": topo.weight_matrix(
            topo.RandomRegularGraph(SCHED_RANKS, 4, seed=SEED)),
        "dense_512": dense}
    for name, w in cases.items():
        t0 = time.perf_counter()
        got = S._rounds_from_matrix_native(w)
        t1 = time.perf_counter()
        want = S._rounds_from_matrix_py(w)
        t2 = time.perf_counter()
        same = len(got) == len(want) and all(
            a.pairs == b.pairs and all(
                np.array_equal(getattr(a, f), getattr(b, f))
                and getattr(a, f).dtype == getattr(b, f).dtype
                for f in ("send_scale", "recv_mask", "src_of"))
            for a, b in zip(got, want))
        out[name] = {"rounds": len(got), "bitwise": same,
                     "native_ms": 1e3 * (t1 - t0),
                     "numpy_ms": 1e3 * (t2 - t1)}
        require(same, f"native rounds of {name} differ from numpy's")
    return out


def schedule_pipeline_phase():
    """``set_topology`` of a 16-rank Exp2 under ``BLUEFOG_TPU_FAKE_TORUS``
    (each of ``SCHED_TORI``): the placement, the synthesis selection and
    the dispatched static and one-peer schedules (provenance, rounds
    against König's bound, modeled cost); then ``neighbor_allreduce`` and
    the dynamic combine of every phase over them on the card, bit for bit
    the same calls on the CPU, timed beside their byte bound."""
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import basics
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.utils import config

    native_rounds = check_native_rounds()
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(SCHED_RANKS, SCHED_COLS, generator=gen)
    saved = os.environ.get("BLUEFOG_TPU_FAKE_TORUS")
    tori = {}
    try:
        for spec in SCHED_TORI:
            os.environ["BLUEFOG_TPU_FAKE_TORUS"] = spec
            config.reload()
            runs = {}
            for dev in (DEVICE, "cpu"):
                t0 = time.perf_counter()
                bf.init(SCHED_RANKS, device=dev, topology_fn=lambda:
                        topo.ExponentialTwoGraph(SCHED_RANKS))
                init_s = time.perf_counter() - t0
                model, perm = basics._ctx._placement_state
                static = basics._dispatch_static()
                dyn = basics._dispatch_dynamic()
                xd = x.to(dev)
                calls = [lambda: bf.neighbor_allreduce(xd)] + [
                    lambda s=s: bf.dynamic_neighbor_allreduce(xd, s)
                    for s in range(dyn.period)]
                res = {"outs": [c().cpu() for c in calls],
                       "init_s": init_s,
                       "placement_info": bf.placement_info(),
                       "synthesis_info": bf.synthesis_info(),
                       "static": _sched_report(static, model, perm),
                       "dynamic": [_sched_report(ph, model, perm)
                                   for ph in dyn.phases],
                       "perm": None if perm is None else
                       [int(p) for p in perm]}
                if dev == DEVICE and DEVICE == "cuda":
                    res["ms"] = {"neighbor_allreduce": cuda_ms(calls[0]),
                                 "dynamic_phase0": cuda_ms(calls[1])}
                bf.shutdown()
                runs[dev] = res
            card, cpu = runs[DEVICE], runs["cpu"]
            bitwise = [bool(torch.equal(a, b))
                       for a, b in zip(card["outs"], cpu["outs"])]
            require(all(bitwise), f"torus {spec}: card vs CPU {bitwise}")
            for k in ("placement_info", "synthesis_info", "static",
                      "dynamic", "perm"):
                require(card[k] == cpu[k],
                        f"torus {spec}: {k} differs by device")
            require(card["placement_info"] is not None,
                    f"torus {spec}: no placement model")
            for rep in [card["static"]] + card["dynamic"]:
                require(rep["rounds"] <= 2 * rep["konig_bound"],
                        f"torus {spec}: {rep['rounds']} rounds over the "
                        "budget")
            tori[spec] = {k: card[k] for k in (
                "init_s", "placement_info", "synthesis_info", "static",
                "dynamic", "perm")}
            tori[spec]["card_vs_cpu_bitwise"] = bitwise
            tori[spec]["ms"] = card.get("ms")
    finally:
        if saved is None:
            os.environ.pop("BLUEFOG_TPU_FAKE_TORUS", None)
        else:
            os.environ["BLUEFOG_TPU_FAKE_TORUS"] = saved
        config.reload()
    provs = {r["provenance"] for t in tori.values()
             for r in [t["static"]] + t["dynamic"]}
    require(provs & {"congestion", "synthesized:ring-within-slice",
                     "synthesized:hierarchical",
                     "synthesized:chunked-pipelined"},
            f"no packed or synthesized schedule dispatched: {provs}")
    # Each rank's row read once and its result written once.
    emit("schedule_pipeline", ranks=SCHED_RANKS, shape=[SCHED_RANKS,
         SCHED_COLS], dtype="float32",
         topology=f"ExponentialTwoGraph({SCHED_RANKS}), static and its "
                  "one-peer phases", native_rounds=native_rounds,
         tori=tori, combine_bound_ms=1e3 * 2 * 4 * SCHED_RANKS * SCHED_COLS
         / PEAK_BYTES)
    # bench_comm's schedule bench (item 22d) on the card: rounds against
    # König's bound, the outputs within 1e-6, ms an op by CUDA events.
    rig_leg("schedule_pipeline", "bench_comm", ["--smoke"])


def _col_spread(flat, ranges, rows):
    """The largest deviation of ``rows`` from their mean over the columns
    ``ranges``."""
    import torch
    worst = 0.0
    for a, b in ranges:
        for c0 in range(a, b, 1 << 24):
            blk = flat[rows, c0:min(b, c0 + (1 << 24))]
            worst = max(worst, float((blk - blk.mean(0)).abs().max()))
    return worst


def sharded_moe_train_phase(benchmark):
    """The switch-MoE LM at the 1.3B LM's widths (``SHARD_LAYERS`` blocks of
    ``SHARD_EXPERTS`` GELU experts, full remat, bf16 through K1-K3), 4
    ranks, ATC over the one-peer Exp2 walk, its expert kernels sharded on
    their expert axis over ``SHARD_GROUPS`` replica groups: an lr-0 step
    against a float64 oracle, then ``SHARD_STEPS`` steps with the specs and
    as many without, from the same start.  Returns the launches."""
    import torch

    from bluefog_tpu_torch import basics
    from bluefog_tpu_torch.models.convert import flax_leaf
    from bluefog_tpu_torch.optim import optimizers as O
    from bluefog_tpu_torch.ops import flash_attention as FA

    w = LM_WIDTHS
    args = benchmark.build_parser().parse_args([
        "--model", "transformer", "--flash-attention", "--atc", "--dynamic",
        "--num-layers", str(SHARD_LAYERS), "--embed-dim", str(w["width"]),
        "--num-heads", str(w["heads"]), "--num-experts", str(SHARD_EXPERTS),
        "--remat", "--seq-len", str(w["seq"]), "--batch-size", "2",
        "--vocab-size", str(w["vocab"]), "--momentum", "0", "--ranks", "4",
        "--device", DEVICE, "--seed", str(SEED)])
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tr = benchmark.Trainer(args)
    rep, n = tr.rep, tr.n
    flat, base = rep.flat, tr.opt.base
    lr = base.param_groups[0]["lr"]
    proto = rep.modules[0]
    specs = [("ep", None, None) if flax_leaf(proto, name)[1][-1] in (
        "experts_up", "experts_down") else None for name in rep.names]

    def make(sharded):
        return O.DistributedAdaptThenCombineOptimizer(
            base, use_dynamic_topology=True, leaf_shapes=rep.leaf_shapes,
            shard_specs=specs if sharded else None,
            num_shards=SHARD_GROUPS if sharded else None)

    with torch.no_grad():   # each rank its own seeded offset
        g = torch.Generator(device=flat.device).manual_seed(SEED + 1)
        for r in range(n):
            flat[r].add_(torch.randn(flat.shape[1], generator=g,
                                     device=flat.device), alpha=SHARD_NOISE)
    x0 = flat.detach().clone()
    opt = make(True)
    plan = opt._shard_plan()
    gsched, _ = opt._group_schedule(plan)
    starts = [0]
    for size in rep.leaf_sizes:
        starts.append(starts[-1] + size)
    rep_ranges = [(starts[i], starts[i + 1])
                  for i, m in enumerate(plan.mask) if not m]
    sh_idx = [i for i, m in enumerate(plan.mask) if m]

    def own_ranges(c):   # a leaf sharded on dim 0: a column range
        return [(starts[i] + c * (rep.leaf_sizes[i] // plan.n_shards),
                 starts[i] + (c + 1) * (rep.leaf_sizes[i] // plan.n_shards))
                for i in sh_idx]
    require(all(plan.dims[i] == 0 for i in sh_idx) and len(sh_idx)
            == 2 * SHARD_LAYERS, f"the plan: {plan.decisions}")
    gossiped = {"replicated": sum(b - a for a, b in rep_ranges),
                "own_slice": sum(b - a for a, b in own_ranges(0))}

    # -- the lr-0 step against a float64 oracle -------------------------------
    for grp in base.param_groups:
        grp["lr"] = 0.0
    rep.zero_grad()
    opt.step()
    for grp in base.param_groups:
        grp["lr"] = lr

    def matrix(sched):
        m = torch.diag(torch.as_tensor(sched.self_scale, dtype=torch.float64))
        for rnd in sched.rounds:
            for s_, d_ in rnd.pairs:
                m[s_, d_] = float(rnd.send_scale[s_])
        return m.to(flat.device)
    w_rep = matrix(basics.dynamic_schedule().phases[0])
    w_grp = matrix(gsched)
    err2 = ref2 = 0.0
    worst = 0.0

    def hold(ranges, rows, wm):
        nonlocal err2, ref2, worst
        for a, b in ranges:
            for c0 in range(a, b, 1 << 23):
                c1 = min(b, c0 + (1 << 23))
                ref = wm[:, rows].T @ x0[:, c0:c1].double()
                d = flat[rows, c0:c1].double() - ref
                err2 += float(d.square().sum())
                ref2 += float(ref.square().sum())
                worst = max(worst, float(d.abs().max()))
    hold(rep_ranges, list(range(n)), w_rep)
    ghost_bitwise = True
    for c, grp in enumerate(plan.groups):
        hold(own_ranges(c), list(grp), w_grp)
        for o in range(plan.n_shards):
            if o == c:
                continue
            for a, b in own_ranges(o):
                ghost_bitwise &= bool(torch.equal(flat[list(grp), a:b],
                                                  x0[list(grp), a:b]))
    oracle = {"rel_err": (err2 / ref2) ** 0.5, "max_abs_err": worst,
              "ghost_bitwise": ghost_bitwise, "tol": SHARD_ORACLE_TOL}
    require(oracle["rel_err"] <= SHARD_ORACLE_TOL,
            f"the lr-0 sharded combine vs float64: {oracle}")
    require(ghost_bitwise, "a ghost slice moved in the sharded combine")

    # -- the steps, with the specs and without ----------------------------------
    def run(sharded):
        with torch.no_grad():
            flat.copy_(x0)
        o = make(sharded)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        steps = []
        for _ in range(SHARD_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
                if DEVICE == "cuda" else None
            sync()
            t0 = time.perf_counter()
            if ev:
                ev[0].record()
            losses = tr.forward_backward()
            o.adapt()
            if ev:
                ev[1].record()
            t1 = time.perf_counter()
            o.combine()
            if ev:
                ev[2].record()
            sync()
            t2 = time.perf_counter()
            if ev:
                step_ms = ev[0].elapsed_time(ev[2])
                combine_ms = ev[1].elapsed_time(ev[2])
            else:
                step_ms, combine_ms = 1e3 * (t2 - t0), 1e3 * (t2 - t1)
            steps.append({
                "step_ms": step_ms, "combine_ms": combine_ms,
                "losses": [float(v) for v in losses],
                "spread_replicated": _col_spread(flat, rep_ranges,
                                                 list(range(n))),
                "spread_own_slice": [_col_spread(flat, own_ranges(c),
                                                 list(grp))
                                     for c, grp in enumerate(plan.groups)]})
        step_ms = sum(s["step_ms"] for s in steps[1:]) / (SHARD_STEPS - 1)
        comb = sum(s["combine_ms"] for s in steps[1:]) / (SHARD_STEPS - 1)
        cols = (gossiped["replicated"] + gossiped["own_slice"] if sharded
                else rep.numel)
        return {"steps": steps, "step_ms": step_ms, "combine_ms": comb,
                "tokens_per_s": n * 2 * w["seq"] / (step_ms / 1e3),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
                if DEVICE == "cuda" else None,
                "gossiped_columns": cols,
                # Each rank's gossiped columns read once, written once.
                "combine_bound_ms": 1e3 * 2 * n * 4 * cols / PEAK_BYTES}

    oracle_peak = torch.cuda.max_memory_allocated() / 1e9 \
        if DEVICE == "cuda" else None
    FA.reset_launch_counts()
    runs = {"sharded": run(True), "replicated": run(False)}
    launches = flash_launches()
    peak = None if DEVICE != "cuda" else max(
        oracle_peak, *(r["peak_mem_gb"] for r in runs.values()))
    per = {"K1": 2 * SHARD_LAYERS * n, "K2": SHARD_LAYERS * n,
           "K3": SHARD_LAYERS * n}
    expected = {k: 2 * SHARD_STEPS * v for k, v in per.items()}
    emit("sharded_moe_train", config={
        "num_layers": SHARD_LAYERS, **LM_WIDTHS, "num_experts":
        SHARD_EXPERTS, "remat": "full", "batch_size": 2, "ranks": n,
        "order": "atc", "momentum": 0.0, "lr": lr,
        "topology": "dynamic one-peer ExponentialGraph(4); experts over "
                    "the group schedule",
        "shard_specs": "experts_up, experts_down: (ep, None, None)",
        "groups": [list(g) for g in plan.groups]},
        params_per_rank=rep.numel, plan=plan.summary(),
        gossiped_columns_per_rank={**gossiped, "all": rep.numel,
                                   "share": (gossiped["replicated"]
                                             + gossiped["own_slice"])
                                   / rep.numel},
        oracle=oracle, launches=launches, launches_per_step=per,
        expected_launches=expected, peak_mem_gb=peak, **runs)
    require(rep.numel == SHARD_PARAMS,
            f"flat has {rep.numel} columns, expected {SHARD_PARAMS}")
    for name, r in runs.items():
        for st in r["steps"]:
            require(all(math.isfinite(v) for v in st["losses"]),
                    f"{name}: finite losses {st['losses']}")
    first = [runs[k]["steps"][0]["losses"] for k in runs]
    require(all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(*first)),
            f"the two runs start from the same weights: {first}")
    if DEVICE == "cuda":
        require(launches == expected,
                f"launches {launches}, expected {expected}")
        require(peak < 80, f"peak {peak} GB")
    del tr, opt, x0
    empty_cache()
    return launches


def win_sharded_phase():
    """One ``DistributedWinPutOptimizer`` step (lr 0: the combine alone) of
    a MoE-shaped tree at ``win_ops``' row size, rank layout, ``fuse=True``,
    its experts sharded over 2 replica groups: on the card, bit for bit
    the CPU run; each own slice the in-group combine of
    ``induced_window_weights``, each ghost slice its input."""
    import numpy as np
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology as topo
    from bluefog_tpu_torch.ops import sharded as SH
    from bluefog_tpu_torch.optim import window_optimizers as WO
    keys = sorted(WIN_SHARD_TREE)
    gen = torch.Generator().manual_seed(SEED)
    tree = {k: torch.randn((4,) + WIN_SHARD_TREE[k], generator=gen)
            for k in keys}
    specs = {"experts": ("ep", None), "head": ("ep", None), "router": None}
    outs = {}
    for dev in (DEVICE, "cpu"):
        bf.init(4, device=dev,
                topology_fn=lambda: topo.ExponentialTwoGraph(4))
        ps = [tree[k].to(dev, copy=True) for k in keys]
        opt = WO.DistributedWinPutOptimizer(
            torch.optim.SGD(ps, lr=0.0), window_prefix="winshard",
            shard_specs=[specs[k] for k in keys], num_shards=2)
        plan = opt._shard_plan
        names = list(opt._names)
        ms = timed_ms(opt.step)
        outs[dev] = ([p.cpu() for p in ps], ms, names, plan)
        opt.free()
        bf.shutdown()
    (card, card_ms, names, plan), (cpu, _ms, _n, _p) = outs[DEVICE], \
        outs["cpu"]
    bitwise = {k: bool(torch.equal(a, b)) for k, a, b in zip(keys, card,
                                                             cpu)}
    require(all(bitwise.values()), f"win_sharded card vs CPU {bitwise}")
    _pe, self_w, nbr_w = SH.induced_window_weights(
        plan, topo.ExponentialTwoGraph(4))
    e0, e1 = tree["experts"].double(), card[0].double()
    half = WIN_SHARD_TREE["experts"][0] // 2
    worst, ghost = 0.0, True
    for r in range(4):
        c = plan.coords[r]
        ref = self_w[r] * e0[r, c * half:(c + 1) * half]
        for (d, s_), wt in nbr_w.items():
            if d == r:
                ref = ref + wt * e0[s_, c * half:(c + 1) * half]
        worst = max(worst, float((e1[r, c * half:(c + 1) * half] - ref)
                                 .abs().max()))
        o = 1 - c
        ghost &= bool(torch.equal(card[0][r, o * half:(o + 1) * half],
                                  tree["experts"][r, o * half:(o + 1)
                                                  * half]))
    require(worst <= 1e-5 and ghost,
            f"win_sharded in-group oracle {worst}, ghosts {ghost}")
    cols = {k: int(np.prod(WIN_SHARD_TREE[k])) for k in keys}
    emit("win_sharded", tree={k: [4, *WIN_SHARD_TREE[k]] for k in keys},
         row_columns=sum(cols.values()), windows=names,
         plan=plan.summary(), card_vs_cpu_bitwise=bitwise,
         in_group_max_abs_err=worst, ghost_bitwise=ghost, step_ms=card_ms)


def worker_main(phase, out_path, device, *args):
    """One process of a ``win_dist_*`` phase (``launch_workers``), on the
    phase's ``device``."""
    global DEVICE
    t_start = time.time()
    import torch
    DEVICE = device
    if "{proc}" in out_path:
        # Launched by bfrun: one command for every process.
        out_path = out_path.format(proc=os.environ["BFTPU_PROCESS_ID"])
    # Every process shares card 0 (bfrun numbers the local slots).
    os.environ["BFTPU_LOCAL_ID"] = "0"
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bluefog_tpu_torch as bf
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = {"start": t_start}
    bf.init_distributed(backend="gloo", device=DEVICE)
    clock["init"] = time.time()
    try:
        res = {"dist": lambda: dist_worker(bf, *args),
               "async_ops": lambda: async_ops_worker(bf),
               "churn": lambda: churn_worker(
                   bf, os.path.dirname(out_path))}[phase]()
        res.setdefault("owned", bf.owned_ranks())
        if phase != "churn":
            # (After a kill no collective may run: a dead peer hangs it.)
            bf.barrier()
    finally:
        bf.shutdown()
    clock["done"] = time.time()
    res["clock"] = clock
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def build_native():
    """Build (or load) the host libraries; the seconds it took."""
    from bluefog_tpu_torch import native
    from bluefog_tpu_torch.ops import hostfn
    t0 = time.perf_counter()
    native.lib()
    native.fastcall()
    native.schedule_lib()
    hostfn.load()
    return time.perf_counter() - t0


def sync():
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def empty_cache():
    import torch
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def check_mp_examples():
    """``tensor_parallel_training`` and ``pipeline_training``'s own entry
    points on the card, each schedule: the loss falls."""
    from bluefog_tpu_torch import pipeline_training as PT
    from bluefog_tpu_torch import tensor_parallel_training as TPT
    res = TPT.main(["--steps", "6"])
    require(res["losses"][-1] < res["losses"][0], f"tp: {res['losses']}")
    tp = {"dp": res["dp"], "tp": res["tp"], "qkv_shards": res["qkv_shards"],
          "first_loss": res["losses"][0], "last_loss": res["losses"][-1]}
    pp = {}
    for schedule in ("gpipe", "1f1b", "zb"):
        res = PT.main(["--steps", "8", "--schedule", schedule])
        require(res["losses"][-1] < res["losses"][0],
                f"pp {schedule}: {res['losses']}")
        pp[schedule] = {"first_loss": res["losses"][0],
                        "last_loss": res["losses"][-1],
                        "forward_max_abs_err": res["forward_max_abs_err"]}
    return tp, pp, check_elastic_example()


def check_22a_examples():
    """The entry points of ROADMAP item 22a on the card, in this process,
    each at its own widths with few steps: the consensus error, the
    optimizers' distance to the minimizer, the allocation error and the
    MoE, ResNet-18 and LeNet losses must fall."""
    import numpy as np
    import torch

    from bluefog_tpu_torch import (average_consensus,
                                   decentralized_optimization, mnist_lenet,
                                   moe_training, resnet_training,
                                   resource_allocation)
    out = {}

    def run(name, fn, argv):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = fn(argv)
        require(res["device"].startswith("cuda"), f"{name} ran on "
                f"{res['device']}")
        out[name] = {"seconds": time.perf_counter() - t0}
        return res

    np.random.seed(SEED)     # the example draws its rows from numpy's
    res = run("average_consensus", average_consensus.main, [])
    require(res["errors"][-1] < 1e-4 <= res["errors"][0],
            f"average_consensus errors {res['errors'][0]} -> "
            f"{res['errors'][-1]}")
    out["average_consensus"].update(iterations=res["iterations"],
                                    first=res["errors"][0],
                                    last=res["errors"][-1])
    res = run("decentralized_optimization", decentralized_optimization.main,
              ["--max-iters", "300"])
    # Every method starts at x = 0, a relative error of 1.
    require(all(e < 1.0 for e in res["errors"].values()),
            f"decentralized_optimization errors {res['errors']}")
    out["decentralized_optimization"]["relative_errors"] = res["errors"]
    res = run("resource_allocation", resource_allocation.main,
              ["--method", "extra", "--iters", "500"])
    require(res["errors"][-1] < res["errors"][0],
            f"resource_allocation errors {res['errors']}")
    out["resource_allocation"].update(first=res["errors"][0],
                                      last=res["errors"][-1])
    res = run("moe_training", moe_training.main, ["--steps", "60"])
    out["moe_training"].update(first=res["first"], last=res["last"])
    # Its own model and widths (ResNet-18 at 32x32, batch 32 on 8 ranks),
    # 2 epochs of 128 samples a rank (4 steps each) where it runs 3 of
    # 512; cuDNN's autotuning off, as the example leaves it (earlier
    # phases turned it on in this process).
    bench_mode = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        res = run("resnet_training", resnet_training.main,
                  ["--epochs", "2", "--samples-per-rank", "128"])
    finally:
        torch.backends.cudnn.benchmark = bench_mode
    require(res["model"] == "resnet18"
            and res["epoch_losses"][-1] < res["epoch_losses"][0],
            f"resnet_training {res['model']} epoch losses "
            f"{res['epoch_losses']}")
    out["resnet_training"].update(model=res["model"],
                                  epoch_losses=res["epoch_losses"],
                                  val_acc=res["val_acc"])
    res = run("mnist_lenet", mnist_lenet.main, [])
    require(res["loss_last"] < res["loss_first"],
            f"mnist_lenet losses {res['loss_first']} -> {res['loss_last']}")
    out["mnist_lenet"].update(loss_first=res["loss_first"],
                              loss_last=res["loss_last"],
                              accuracy=res["accuracy"])
    return out


def check_elastic_example():
    """``elastic_training``'s own entry point on the card at its own size,
    under each optimizer (push-sum carries its window store in the
    checkpoint): uninterrupted, then preempted (exit 75) and resumed from
    its checkpoint, bit for bit the uninterrupted parameters."""
    import tempfile

    import torch

    from bluefog_tpu_torch import elastic_training as ET
    out = {}
    for opt in ("neighbor_allreduce", "push_sum"):
        tmp = tempfile.mkdtemp(prefix="elastic_example_")
        try:
            args = ["--optimizer", opt]
            a = ET.main(args + ["--ckpt-dir", os.path.join(tmp, "a")])
            try:
                ET.main(args + ["--ckpt-dir", os.path.join(tmp, "b"),
                                "--preempt-at-step", "25"])
                code = 0
            except SystemExit as e:
                code = e.code
            b = ET.main(args + ["--ckpt-dir", os.path.join(tmp, "b")])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        require(code == 75, f"elastic_training {opt} preempted: exit {code}")
        require(a["device"].startswith("cuda")
                and torch.equal(a["params"], b["params"]),
                f"elastic_training {opt}: the resumed run differs")
        out[opt] = {"final_loss": a["final_loss"], "steps": a["steps"],
                    "preempted_exit": code, "bitwise": True}
    return out


def image_phase(benchmark, argv, checks_spread_by="max", time_combine=False):
    """One benchmark run of an image model; the common checks
    (``checks_spread_by``: ``max`` or ``rms`` must shrink in the combine;
    ``exact``: gradient allreduce, 0.0 after every step); with
    ``time_combine``, one more step's combine time (``combine_ms``)."""
    import torch
    args = benchmark.build_parser().parse_args(argv + ["--seed", str(SEED)])
    tr = benchmark.Trainer(args)
    res = benchmark.measure(args, tr)
    steps = args.num_warmup_batches + args.num_iters * args.num_batches_per_iter
    require(all(math.isfinite(x) for x in res["losses"]),
            f"finite losses {res['losses']}")
    require(res["steps"] == steps, f"{res['steps']} steps, expected {steps}")
    sp = res["spread"]
    if checks_spread_by == "exact":
        require(sp["after_step"] == [0.0] * steps,
                f"the replicas differ after a step: {sp}")
    else:
        key = ("after_combine" if checks_spread_by == "max"
               else "rms_after_combine")
        require(sp[key] < sp[key.replace("combine", "adapt")],
                f"the combine shrinks the spread {sp}")
    flat_ptr = tr.rep.flat.untyped_storage().data_ptr()
    bufs = [tr.rep.rank_buffers(r) for r in range(tr.n)]
    if bufs[0]:
        require(all(b.untyped_storage().data_ptr() != flat_ptr
                    for rank in bufs for b in rank.values()),
                "BN statistics lie outside flat")
        differ = max(float((bufs[0][k] - bufs[1][k]).abs().max())
                     for k in bufs[0])
        require(differ > 0, "BN statistics differ between ranks")
        res["bn_stats_rank_diff"] = differ
    res["steps_expected"] = steps
    if time_combine:
        res["combine_ms"] = timed_combine(tr)
    del tr
    torch.cuda.empty_cache()
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on the GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from bluefog_tpu_torch import benchmark
    from bluefog_tpu_torch.ops import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # The host libraries build with g++ and nvcc in a thread meanwhile
    # (the window transport's service and the timeline writer, its
    # METH_FASTCALL binding, the round compiler, csrc/hostfn.cu): the
    # worker processes later load what this one built.
    from concurrent.futures import ThreadPoolExecutor
    host_builds = ThreadPoolExecutor(1)
    native_built = host_builds.submit(build_native)
    t0 = time.perf_counter()
    _, log = FA.load_library(verbose=True)
    ptxas = ptxas_report(log)
    serialized = [ln.strip() for ln in log.splitlines()
                  if "wgmma.mma_async instructions are serialized" in ln]
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas,
         wgmma_serialized=serialized)
    for fn, _ in KERNELS.values():
        for d in (64, 128):
            info = ptxas.get(f"{fn}/D{d}", {})
            require(info.get("spill_bytes") == 0,
                    f"{fn} (D={d}) spills registers: {info}")
    require(not serialized, f"ptxas serialized wgmma: {serialized}")

    main_res = None
    # (case, B, S, H, D, causal, timed, layout, kv heads, forward only):
    # the LM's training shape, ragged S, non-causal, ViT-S/16's shape, the
    # Llama-style LM's GQA operands at its training shape and its generate
    # prefill (K1 alone); checked, not timed: S shorter than one tile, the
    # head dim 64 instantiation, MHA with RoPE's operands, and the
    # sequence-parallel paths' shapes (ring_train: 4 shards of 4,096
    # tokens, causal at hop 0, then the non-causal blocks of 3 of them;
    # ulysses_train: the gathered 16,384 tokens, 4 heads a shard), each
    # with K2 taking a nonzero lse cotangent, as every case does; tp_train's
    # head shards (timed: tp x B = 4 rows of 8 heads) and pp_train's
    # microbatch of one sequence.
    for case, B, S, H, D, causal, timed, layout, kv_h, fwd_only in (
            ("main", 2, 2048, 16, 128, True, True, "fused", None, False),
            ("ragged", 2, 1000, 16, 128, True, True, "fused", None, False),
            ("noncausal", 2, 2048, 16, 128, False, True, "fused", None,
             False),
            ("vit", 64, 197, 6, 64, False, True, "fused", None, False),
            ("gqa", 2, 2048, 16, 128, True, True, "gqa", 4, False),
            ("prefill", 2, 512, 16, 128, True, True, "gqa", 4, True),
            ("short", 2, 100, 16, 128, True, False, "fused", None, False),
            ("d64", 2, 512, 8, 64, True, False, "fused", None, False),
            ("d64-ragged-noncausal", 1, 777, 4, 64, False, False, "fused",
             None, False),
            ("mha-rope", 2, 1024, 16, 128, True, False, "rope", None,
             False),
            ("ring-hop0", 4, 4096, 16, 128, True, False, "rope", None,
             False),
            ("ring-hop1", 3, 4096, 16, 128, False, False, "rope", None,
             False),
            ("ulysses", 4, 16384, 4, 128, True, False, "ulysses", None,
             False),
            ("tp-heads", TP_WAYS * 2, 2048, 16 // TP_WAYS, 128, True, True,
             "fused", None, False),
            ("pp-microbatch", 1, 2048, 16, 128, True, False, "fused", None,
             False)):
        res = check_kernels(B, S, H, D, causal, SEED, timed=timed,
                            repeat=case == "main", layout=layout,
                            kv_heads=kv_h, fwd_only=fwd_only)
        for kname, r in res.items():
            emit("kernel", kernel=kname, case=case, B=B, S=S, H=H, D=D,
                 dtype="bfloat16", causal=causal, layout=layout,
                 kv_heads=kv_h, rel_tol=REL_TOL, elem_tol=ELEM_TOL,
                 lse_tol=LSE_TOL if kname == "K1" else None,
                 **ptxas.get(f"{KERNELS[kname][0]}/D{D}", {}), **r)
        if case == "main":
            main_res = res

    emit("reference", **check_reference(SEED))
    emit("resnet_reference", **check_resnet_reference(SEED))

    args = benchmark.build_parser().parse_args(train_argv(3))
    FA.reset_launch_counts()
    tr = benchmark.Trainer(args)
    res = train_res = benchmark.measure(args, tr)
    launches = {"K1": FA.flash_fwd_cuda.launches,
                "K2": FA.flash_dq_cuda.launches,
                "K3": FA.flash_dkv_cuda.launches}
    steps = args.num_warmup_batches + args.num_iters * args.num_batches_per_iter
    expected = LAYERS * args.ranks * steps
    emit("train", config={"num_layers": LAYERS, "embed_dim": 2048,
                          "num_heads": 16, "seq_len": 2048, "batch_size": 2,
                          "vocab_size": 32000, "momentum": 0.0,
                          "ranks": args.ranks, "order": "atc",
                          "topology": "dynamic one-peer ExponentialGraph(4)"},
         launches=launches, expected_launches=expected, **res)
    require(all(math.isfinite(x) for x in res["losses"]),
            f"finite losses {res['losses']}")
    require(res["steps"] == steps, f"{res['steps']} steps, expected {steps}")
    require(all(c == expected for c in launches.values()),
            f"launches {launches}, expected {expected} of each")
    require(res["spread"]["after_combine"] < res["spread"]["after_adapt"],
            f"the combine shrinks the spread {res['spread']}")
    host_launches = host_data_phase(benchmark, tr, train_res)
    del tr
    torch.cuda.empty_cache()
    from bluefog_tpu_torch import native
    t0 = time.perf_counter()
    build_s = native_built.result()
    host_builds.shutdown()
    emit("native_build", seconds=build_s,
         waited_s=time.perf_counter() - t0,
         library=str(native.library_path().name))
    observe_launches = observe_train_phase(benchmark, train_res)
    torch.cuda.empty_cache()

    image = ["--model", "resnet50", "--batch-size", "64", "--ranks", "4",
             "--atc", "--dynamic", "--momentum", "0.9"]
    res = image_phase(benchmark, image + [
        "--num-warmup-batches", "2", "--num-iters", "3",
        "--num-batches-per-iter", "1"])
    emit("resnet50", config={"model": "resnet50", "image_size": 224,
                             "batch_size": 64, "ranks": 4, "momentum": 0.9,
                             "order": "atc", "compression": "none"}, **res)
    require(res["params_per_rank"] == RESNET50_PARAMS,
            f"flat has {res['params_per_rank']} columns, expected "
            f"{RESNET50_PARAMS}")
    for comp in ("bf16", "sparse:0.25"):
        res = image_phase(benchmark, image + [
            "--compression", comp, "--num-warmup-batches", "1",
            "--num-iters", "2", "--num-batches-per-iter", "1"],
            checks_spread_by="rms")
        require(res["params_per_rank"] == RESNET50_PARAMS,
                f"flat has {res['params_per_rank']} columns")
        emit("resnet50_compression", compression=comp, **res)
    res = image_phase(benchmark, image + [
        "--dist-optimizer", "gradient_allreduce", "--num-warmup-batches", "2",
        "--num-iters", "2", "--num-batches-per-iter", "1"],
        checks_spread_by="exact")
    require(res["params_per_rank"] == RESNET50_PARAMS,
            f"flat has {res['params_per_rank']} columns")
    emit("resnet50_gradient_allreduce", **res)

    FA.reset_launch_counts()
    vit_args = ["--model", "vit", "--batch-size", "64", "--ranks", "4",
                "--atc", "--dynamic", "--momentum", "0.9", "--flash-attention",
                "--num-warmup-batches", "1", "--num-iters", "2",
                "--num-batches-per-iter", "1"]
    res = image_phase(benchmark, vit_args)
    vit_launches = {"K1": FA.flash_fwd_cuda.launches,
                    "K2": FA.flash_dq_cuda.launches,
                    "K3": FA.flash_dkv_cuda.launches}
    vit_expected = VIT_LAYERS * 4 * res["steps_expected"]
    require(all(c == vit_expected for c in vit_launches.values()),
            f"ViT launches {vit_launches}, expected {vit_expected} of each")
    emit("vit", config={"model": "vit (ViT-S/16)", "image_size": 224,
                        "batch_size": 64, "ranks": 4, "seq_len": 197,
                        "heads": 6, "head_dim": 64},
         launches=vit_launches, expected_launches=vit_expected,
         reference=check_vit_reference(SEED), **res)

    emit("llama_reference", **check_llama_reference(SEED))
    tr, llama_launches = llama_train_phase(benchmark)
    gen = check_generate(tr, SEED)
    emit("generate", **gen)
    gen_launches = gen["launches"]
    del tr
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    # The entry point's main, in this process (a process of its own cost
    # ~8 s of start-up).
    from bluefog_tpu_torch import text_generation
    res = text_generation.main([])
    require(res["matches_text"] is True and res["device"].startswith("cuda"),
            f"text_generation {res}")
    emit("text_generation", seconds=time.perf_counter() - t0, **res)

    emit("moe_reference", **check_moe_reference(SEED))
    moe_launches = moe_train_phase(benchmark)

    emit("ring_reference", **check_seq_reference("ring", SEED))
    emit("ulysses_reference", **check_seq_reference("ulysses", SEED))
    ring_launches = seq_train_phase("ring_train", "ring", RING_LAYERS,
                                    steps=RING_STEPS, profile=True)
    ulysses_launches = seq_train_phase("ulysses_train", "ulysses",
                                       ULYSSES_LAYERS, profile=True)
    dp_sp_launches = dp_sp_train_phase()
    emit("long_context_example", **check_long_context_example())
    emit("dist_nccl", **check_dist_nccl())
    emit("tp_reference", **check_tp_reference(SEED))
    tp_launches = tp_train_phase(layers=TP_LAYERS)
    pp_launches = pp_train_phase()
    pp_variant_launches = pp_variants_phase()
    emit("dp_tp_pp_ep", **check_compositions(SEED))
    sessions = start_interactive_sessions()   # they ride IBF_RIDES
    tp_example, pp_example, elastic_example = check_mp_examples()
    emit("tp_example", **tp_example)
    emit("pp_example", **pp_example)
    emit("elastic_example", **elastic_example)
    emit("examples_22a", **check_22a_examples())
    emit("interactive", **interactive_leg(sessions))
    hier_launches = hier_train_phase(benchmark)
    winput_launches = winput_train_phase(benchmark)
    fused_launches = fused_train_phase(benchmark)
    win_variant_launches = win_variants_phase(benchmark)
    card_ops = win_ops_phase()
    win_dist_launches, win_async_launches = dist_phases(card_ops)
    del card_ops
    res = image_phase(benchmark, image + [
        "--dist-optimizer", "win_put", "--num-warmup-batches", "1",
        "--num-iters", "2", "--num-batches-per-iter", "1"],
        time_combine=True)
    require(res["params_per_rank"] == RESNET50_PARAMS,
            f"flat has {res['params_per_rank']} columns")
    # The window combine's 28 row passes, as in winput_train.
    emit("resnet50_win_put", window_ms=res.pop("combine_ms"),
         window_bound_ms=1e3 * 28 * 4 * RESNET50_PARAMS / PEAK_BYTES, **res)
    torch.cuda.empty_cache()
    emit("tp_moe_reference", **check_tp_moe_reference(SEED))
    tp_moe_launches = tp_moe_train_phase()
    schedule_pipeline_phase()
    sharded_launches = sharded_moe_train_phase(benchmark)
    win_sharded_phase()
    churn_launches = churn_train_phase()
    elastic_launches = elastic_train_phase(benchmark)
    chaos_tool_phase()
    flush_wall()

    kernels = []
    for kname, (fn, replaces) in KERNELS.items():
        r = main_res[kname]
        kernels.append({"name": f"{kname} {fn}", "route": "cuda",
                        "source": SOURCE, "replaces": replaces,
                        "launches": (launches[kname]
                                     + host_launches[kname]
                                     + observe_launches[kname]
                                     + llama_launches[kname]
                                     + moe_launches[kname]
                                     + ring_launches[kname]
                                     + ulysses_launches[kname]
                                     + dp_sp_launches[kname]
                                     + tp_launches[kname]
                                     + pp_launches[kname]
                                     + pp_variant_launches[kname]
                                     + hier_launches[kname]
                                     + winput_launches[kname]
                                     + fused_launches[kname]
                                     + win_variant_launches[kname]
                                     + win_dist_launches[kname]
                                     + tp_moe_launches[kname]
                                     + win_async_launches[kname]
                                     + sharded_launches[kname]
                                     + churn_launches[kname]
                                     + elastic_launches[kname]),
                        "launches_by_path": {
                            "train": launches[kname],
                            "train_host_data": host_launches[kname],
                            "observe_train": observe_launches[kname],
                            "llama_train": llama_launches[kname],
                            "moe_train": moe_launches[kname],
                            "ring_train": ring_launches[kname],
                            "ulysses_train": ulysses_launches[kname],
                            "dp_sp_train": dp_sp_launches[kname],
                            "tp_train": tp_launches[kname],
                            "pp_train": pp_launches[kname],
                            "pp_variants": pp_variant_launches[kname],
                            "hier_train": hier_launches[kname],
                            "winput_train": winput_launches[kname],
                            "fused_train": fused_launches[kname],
                            "win_variants": win_variant_launches[kname],
                            "win_dist_train": win_dist_launches[kname],
                            "tp_moe_train": tp_moe_launches[kname],
                            "win_async_train": win_async_launches[kname],
                            "sharded_moe_train": sharded_launches[kname],
                            "churn_train": churn_launches[kname],
                            "elastic_train": elastic_launches[kname],
                            "generate": gen_launches[kname],
                            "vit": vit_launches[kname]},
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def churn_runs(runs):
    """``--churn-runs N``: ``churn_train`` alone, N times at
    ``CHURN_KNOBS`` (the heartbeat-liveness measurement), each run's
    ``churn_liveness`` and verdict on lines of their own; exits 0 iff
    every run passed."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bluefog_tpu_torch.ops import flash_attention as FA
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0))
    FA.load_library()
    build_native()
    passed = 0
    for run in range(runs):
        t0 = time.perf_counter()
        try:
            churn_train_phase()
            ok, why = True, None
        except Exception as e:  # noqa: BLE001 — the next run still runs
            ok, why = False, str(e)[-2000:]
        passed += ok
        emit("churn_run", run=run, ok=ok, error=why,
             wall_s=time.perf_counter() - t0)
    flush_wall()
    return 0 if passed == runs else 1


if __name__ == "__main__":
    if len(sys.argv) > 4 and sys.argv[1] == "--worker":
        sys.exit(worker_main(*sys.argv[2:]))
    if len(sys.argv) > 2 and sys.argv[1] == "--churn-runs":
        import argparse
        ap = argparse.ArgumentParser(prog="chip_smoke.py --churn-runs")
        ap.add_argument("--churn-runs", type=int, required=True)
        sys.exit(churn_runs(ap.parse_args().churn_runs))
    sys.exit(main())
