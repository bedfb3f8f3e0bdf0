#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (any failure exits non-zero before the result line):

1. device: the ``nvidia-smi`` name and power limit; CUDA must be present.
2. kernels: build ``kernels/gp_gram/csrc/gp_gram.cu`` with nvcc for sm_90a,
   hold ``matern52_gram`` / ``matern52_cross`` against their plain-torch
   versions on the card (atol 2e-4) over the reference's test shapes, the
   main path's shapes, the tuning daemon's (d 327-332, 3939 candidates,
   a 128-row multi-task corpus) and a stress shape, and time both (CUDA
   events); at d 327 also a config's one-knob neighbours (r near 0)
   against the float64 formula.
   The backward kernel ``matern52_gram_bwd`` at every case's Gram (n x n,
   with repeated rows and pad rows of 0.5): within relative L2 1e-3 of
   its plain version and of that formula in float64, and at the cases
   with n = m of autograd through the plain Matérn (recorded elsewhere);
   a planted fault (the formula without its (1+s) factor) above each
   limit; two calls bit-equal; timed at the fit's Gram [64,16], a daemon
   session's [64,327] and the multi-task prior's [128,327] (the forward
   and cross there too), with their bounds; at [64,327] the backward's
   device time must be below its plain version's.
3. main path: ``Sapphire(arch="yi-6b", shape="train_4k").tune()`` at the
   paper's budgets with ``batch_size`` 1 and 8; the kernel launch counters
   (forward, cross and backward) are zeroed before each run and must have
   risen after it.  The rank stage alone on the CPU must pick the same
   top-16 set.  Then both runs again with the fit loop as it was before
   the graphed step (eager Adam, autograd through the plain Gram), for
   the stage walls before and after in one call.
4. GP round: one fit + q-EI selection at the main path's shapes under
   ``torch.profiler`` (device busy time against wall time), with the eager
   plain-autograd fit loop (before) and the graphed kernel fit (after);
   the graphed fit bit-equal to the same steps run eagerly (150 cold, 50
   warm), and within 5e-3 of the plain-autograd fit.
5. flash kernels: hold ``kernels/flash_attention`` against its plain-torch
   versions over the reference's ``FLASH_CASES`` through both routes:
   bf16 at D 64/128 through the wgmma kernel against the plain version
   that rounds P to bf16 and against the one that keeps P in f32, the
   Pallas kernel's function (atol 2e-2 each), float32 through the FMA kernel
   (2e-5; bf16 at D 32 takes it too); at yi-6b's prefill shape (B=2,
   S=4096, H=32, Kh=4, D=128, causal, bf16) and at the ``prefill_32k``
   shape (B=1, S=32768, the heads of the first and last KV groups), each
   within relative L2 1e-2 (a planted dropped-tile fault, emulated with
   the plain version, must land above it; at the prefill shape the f32-P
   version too).  At the prefill shape the wgmma kernel is timed beside the plain version and ``scaled_dot_product_attention`` (the
   yardstick, never called by the port), with its bound, and must be
   within 3x of the yardstick; ptxas's report of it is printed.
6. serving path, prefill: ``Model(yi-6b, full width).prefill`` with
   ``attention_impl="flash"`` at B=2, S=4096 against the same prefill
   under ``"reference"`` (and ``"chunked"``, the reference's own
   flash stand-in): last-token logits within relative L2 0.1 with bf16
   weights, within atol 1e-3 with float32 weights; exactly 32 wgmma
   launches (and no FMA launch) per bf16 flash prefill, 32 FMA launches
   per float32 one, none otherwise; 16 greedy
   ``decode_step``s; then the ``prefill_32k`` cell at one card's share
   (B=1, S=32768; S=16384 when the kernel's measured time projects the
   32k prefill past 150 s): tokens/s and the flash kernel's share of
   device time.
7. serving path, engine: ``python -m repro_torch.launch.serve --arch yi-6b
   --full --device cuda`` with its default traffic (12 requests).
8. mLSTM kernels: hold ``kernels/mlstm_chunk`` against its plain-torch
   versions over the reference's ``MLSTM_CASES`` and the layer of phase
   9's float32 check ([1,256,4,1024], chunk 64) (all on the FMA route:
   atol 5e-5 in float32), chunk invariance at chunks 32/64/256 (2e-4), and
   at xlstm-1.3b's layer shape (q/k/v [2,4096,4,1024], bf16) at chunk 256
   and 1024, where the wgmma kernel runs: within relative L2 1e-3 of its
   plain version (bf16 operands where the kernel rounds) and 1e-2 of the
   float32 version, and the FMA kernel at the same inputs within 1e-3 of
   the float32 version (a planted fault, every chunk without its
   inter-chunk term, must land above every limit); timed beside the plain
   version and the FMA kernel, with its bound, and failing above 2.0 ms
   per call; ptxas's report of each of its passes is printed.
9. serving path, xLSTM: ``Model(xlstm-1.3b, full width, 24 of 48
   layers).prefill`` at B=2,
   S=4096 with random bf16 weights: exactly 21 wgmma mLSTM launches and no
   FMA one per prefill (also under ``torch.profiler``, with the device ms
   of each of its four kernels) and none per ``decode_step``;
   the sLSTM time loops' share of the wall; 16 greedy ``decode_step``s;
   peak memory.  Then float32 weights: last-token logits of a 256-token
   prefill in chunks of 64 against teacher-forced ``decode_step``s (the
   sequential recurrence), as initialised (recorded: the sLSTM recurrence
   is chaotic at this width) and with the sLSTM recurrent weights scaled
   by 0.1 (relative L2 1e-3); that prefill runs the FMA kernel (float32).
10. the tuning daemon: ``TuningServer(device="cuda")`` served over HTTP on
   127.0.0.1 to 8 ``TuningClient`` threads on yi-6b and qwen1.5-4b at
   train_4k (one recipe per workload, BOConfig's budget: 8 + 48
   evaluations, 150 fit steps, 2048 + 256 candidates, over the full
   327-knob spaces), the launch counters zeroed just before and read just
   after (forward, cross and backward must have risen).  Gates: cache hit
   rate >= 0.40, fewer evaluator calls than 8 local runs, every server
   trace bit-identical to a local ``run_async`` on the card at the same
   seed.  A ``transfer_bo`` session on codeqwen1.5-7b (``transfer_from``:
   the corpus mined from the daemon's log of the two) whose multi-task
   prior, refit graphed, is bit-equal to the session's and to its eager
   steps; the kernel fit within 5e-3 of the plain-autograd fit on a
   corpus of that shape with distinct rows (on the daemon's own, whose
   sessions repeat each other's probes, recorded beside the fit's
   sensitivity to one ulp of its inputs); an xlstm-1.3b one
   (another space signature) gets no corpus.  One GP round at d = 327
   under the profiler: wall, device busy, idle share, and the Gram
   forward's and backward's shares of the device time.  ``benchmarks/perf_transfer.py``'s full folds
   through the port (no-corpus identity; every fold at 0.99 of the scratch
   best within 60 % of the budget of 16).  A BO session at 20 % transient
   faults (``FaultInjectingService``) bit-identical to the fault-free one.
11. the kernels' tile knobs and the autotune loop: every instantiation
   of every kernel against its plain version (gp_gram: each of its
   tilings bit-equal to the default launch, which holds atol 2e-4 of
   plain; flash: each route's set at the reference's cases, 2e-5 / 2e-2,
   float32 tilings within 1e-5 of the default launch; mLSTM: 5e-5 on the
   FMA route, relative L2 1e-3 against the bf16-operand version on the
   wgmma route), a planted fault (one instantiation fed inputs rolled by
   one tile) above each limit; then, the launch counters zeroed just
   before, ``tune_kernel`` for each kernel at its bench's default shape
   and at the path's (the daemon's cross-Gram, yi-6b's bf16 prefill,
   xlstm-1.3b's bf16 mLSTM layer), budget 24, batch 2, repeats 5 at the
   path's shapes and, at the bench shapes (host-bound calls), 12 warm-up
   calls and the best of 12, each call's device time (CUDA events behind
   a hold kernel, so that the host's dispatch is not timed); the tuned
   config
   re-measured head to head (one call each in turns, best of 36) against
   the space's default, or against the default launch where the card refuses
   that default, held to 1.15x, each config's reading in the tuner's
   trace printed beside its head-to-head one; the refused configs
   printed.  Then ``gp.select_batch_sharded`` over 1, 2 and 3 shards of
   the card at the tuner's and the daemon's shapes: picks array-equal to
   ``select_batch``, wall time printed.
12. the MoE, Mamba and whisper families at full width, every earlier
   model freed first (memory printed at the start and after each part).
   Flash at the new paths' shapes, held as in phase 5 (atol 2e-2,
   relative L2 1e-2 against both plain versions, a planted fault of
   keys 0..63 dropped above it) and timed beside the plain version and
   SDPA, with its bound: whisper's encoder self-attention (2,1500,1500,
   6,6,64, non-causal, a ragged last key tile), its cross-attention
   (2,448,1500,6,6,64) and qwen2-moe's MHA prefill (2,4096,4096,16,16,
   128, causal).  ``Model(qwen2-moe-a2.7b, full width and depth)``:
   prefill B=2 S=4096 with exactly 24 wgmma flash launches (counted from
   0 around it) and none on the FMA route; flash vs reference logits.  A
   random-weight MoE model in bf16 is chaotic as initialised (a rounding
   difference flips a routing near-tie and the flip cascades), so each
   model-level comparison is printed as initialised and held to relative
   L2 0.1 with the other run's routing replayed (``routing_replay``);
   ``moe_impl="dropping"`` at capacity T (factor E/K = 15) against dense
   on every MoE layer's own prefill input (1e-2) and for the whole prefill
   (0.1 replayed), the default factor printed; the MoE and attention
   layers' shares of the prefill (CUDA events) and flash's (profiler);
   a 256-token prefill + 8 teacher-forced decode steps against
   ``transformer.forward``; ``launch.serve --arch qwen2-moe-a2.7b --full
   --device cuda`` (12 requests).  jamba-1.5-large-398b cut to positions
   0-4 of its period (5 layers, ~24 B parameters): prefill B=1 S=4096
   with 1 wgmma launch, logits flash vs reference (0.1) and the attention
   layer's output on its own input (1e-2); 248 + 8 teacher-forced steps
   (replayed routing, 0.1); peak memory; one full-width mamba layer in
   float32 at S=1024, chunk 256 against ``ssd_reference`` (relative L2
   1e-4, a planted fault of chunks without their carried state above
   it).  whisper-tiny: prefill B=2 at S=448 and 4096 with exactly 12
   wgmma launches each (4 encoder, 4 decoder self, 4 cross; device ms of
   each kind under the profiler), flash vs reference (0.1); 16 greedy
   decode steps; 432 + 16 teacher-forced steps against ``decode_train``
   (0.1); ``Engine`` must refuse it.
13. training.  The flash backward kernels (through ``flash_attention``'s
   ``autograd.Function``) over ``BWD_CASES``: yi-6b's layer causal bf16 at
   the train step's microbatch (1,4096,4096,32,4,128) and at B=2, the MoE
   and hybrid steps' layers (qwen2-moe's MHA (1,4096,4096,16,16,128) and
   jamba's (1,4096,4096,64,8,128)), yi-6b's on one chip of the 16 x 16
   mesh (1,4096,4096,2,1,128) and qwen2-moe's and grok-1's there
   ((1,4096,4096,1,1,128); (1,4096,4096,3,1,128) soft-capped at 30,
   beside SDPA's uncapped backward), each timed as yi-6b's, GQA 8/1,
   a window of 256, soft-cap 30, Sq != Sk, whisper's encoder and cross
   shapes (bf16 at D 64/128: ``flash_attention_bwd_wgmma.cu``, the tensor
   cores), and float32 at D 16/32/64/128 (``flash_attention_bwd.cu``, the
   FMA route); relative L2 of dq, dk, dv within 1e-2 (bf16) and 1e-5
   (float32) of ``ref.attention_grads`` (autograd of the plain forward
   with P in float32), and on the wgmma route within 5e-3 of
   ``attention_grads(operand_dtype=bfloat16)`` (P and dS rounded where the
   kernel rounds them), a planted fault (the D_i term dropped) above each
   limit, two calls bit-equal, the route's launch counter; ptxas must
   report no spill in the wgmma backward.  At yi-6b's layer (B=1 and
   B=2) the route's backward is timed (CUDA events and profiler device
   time, which must be recorded) beside its plain version and SDPA's
   backward (``enable_gqa``), with its bound, and must be within 3x of
   SDPA's backward at B=1; the FMA backward is timed once at B=1 too.
   Then ``Model(yi-6b full width, 2 of 32 layers)``
   trained with AdamW (float32 master weights) on ``SyntheticDataset``
   batches of 2 x 4096 made on the card, microbatch 1 (two accumulation
   steps), remat ``block``, flash: step 1's loss and gradients,
   accumulated over its microbatches as the step accumulates them,
   against reference attention (1e-2, 2e-2 per leaf), exactly 8 wgmma forward
   launches (2 layers x 2 microbatches x forward and recompute), no FMA
   launch and 4 backward sets, all on the wgmma backward, in each of 4
   steps (counted from 0 around
   the steps), step time, tokens/s, peak memory, the profiled step's
   device shares (flash forward, flash backward, cuBLAS, other; they
   must be recorded with every flash kernel: step 3, else step 4, else
   the resumed run's step 4) and idle share, the backward's device time
   per set; a checkpoint at step 2 restored and step 3 run again,
   bit-equal to the uninterrupted run.  whisper-tiny at full width
   (B=2, 1500 frames, S=448), float32 and bf16: gradients against
   reference attention within the same limits, 4 steps with 12 forward
   launches and 12 backward sets each (bf16 on the wgmma backward,
   float32 on the FMA one).
   The mLSTM backward kernels (through ``mlstm_chunk``'s
   ``autograd.Function``, which takes the forward's route) over
   ``MLSTM_BWD_CASES``: xlstm-1.3b's layer at the train step's microbatch
   (1,4096,4,1024), chunk 256, and smaller bf16 cases after the wgmma
   forward (``mlstm_chunk_bwd_wgmma.cu``, the tensor cores), bf16 after
   the FMA forward and float32 (``mlstm_chunk_bwd.cu``, fp32 FMAs);
   relative L2 of dq, dk, dv, d logi, d logf within 1e-2 (bf16) and 1e-5
   (float32) of ``ref.mlstm_chunkwise_grads`` and, on the wgmma route,
   within 5e-3 of ``mlstm_chunkwise_grads(operand_dtype=bfloat16,
   grad_operand_dtype=bfloat16)``; at the wgmma cases the FMA backward
   too, called directly with the forward's roundings, within 1e-2 and
   5e-3 of ``operand_dtype=bfloat16``; a planted fault (d logf one row
   off) above each limit; two calls bit-equal; each route's launch
   counter; ptxas must report no spill in the wgmma backward.  At the
   layer shape both routes are timed in turns (CUDA events; profiler
   device time, kernel by kernel) beside the plain version, with the
   bound.  Then
   ``Model(xlstm-1.3b full width, 8 of 48 layers: 7 mLSTM, 1 sLSTM)``
   trained as yi-6b (AdamW, 1 x 4096 tokens: 2 until PR 31, microbatch
   1, remat ``block``, chunk 256), the sLSTM's recurrent weights x0.1:
   exactly 14 wgmma forward launches (7 x 1 microbatch x forward and
   recompute), no FMA one and 7 wgmma backward launches (no FMA one) in
   each of 2 steps; step 1's loss within 1e-2 of the same step's with the
   mLSTM's plain version (``ref.mlstm_chunkwise`` through autograd on the
   card), and each of its 7 backward launches on its own inputs within 1e-2 /
   5e-3 of the plain versions (the latter with both keywords); step 2's
   time, tokens/s, peak memory, a profiled microbatch's device shares
   (mLSTM forward, mLSTM backward, cuBLAS, other) with every mLSTM kernel
   recorded, the idle share.  A microbatch of the same cell in float32
   (FMA forward and backward): loss and every gradient
   within 1e-2 and 2e-2 of the plain mLSTM's (in bf16 the stack's
   gradient moves ~100x a forward perturbation, so no model-level
   gradient limit holds there: ``tools/xlstm_grad_sensitivity.py``).
   Then the MoE and hybrid train steps at full width (both within 90 s):
   ``Model(qwen2-moe-a2.7b)`` at the depth ``launch.dryrun.fit_depth``
   gives for yi-6b's step RunConfig at 2 x 4096 (3 of 24 layers; AdamW,
   float32 masters, microbatch 1, remat ``block``, flash, dense MoE) and
   jamba-1.5-large-398b cut to pattern positions 0 and 4 (mamba + dense,
   attention + dense; its family's Adafactor without masters, remat
   ``full``, microbatch 1): step 1's loss and every leaf's gradient,
   accumulated over the microbatches, flash against reference attention
   (1e-2, 2e-2; the MoE's routing recorded in the flash run and its top-k
   indices replayed into the reference run, the gate weights and aux loss
   keeping their gradient), qwen2-moe's router gradient finite and
   nonzero; 4 steps on one ``SyntheticDataset`` batch with exactly
   microbatches x attention layers x 2 wgmma forward launches (forward and
   recompute), as many wgmma backward sets and none on the FMA routes, in
   each; the loss's drop from step 1 to step 4; jamba's Adafactor update
   at step 2 against ``train/optimizer.py`` on the host on the same
   gradients and state (each leaf of the new parameters and moments
   within 1e-5); step time, tokens/s, peak memory, the MoE or mamba
   layers' share of a step's device span (CUDA events in their forward,
   recompute and backward), the optimizer's, and the profiled step's
   kernel shares and idle share.
14. the product cluster: ``CompiledEvaluator(yi-6b full width,
   train_4k, device="cuda", share="chip")`` runs each probe's train step
   on the card at one chip's share of the 16 x 16 production mesh, at 2
   of the chip share's cell depth of 32 layers (``reduced`` lists the
   cut): chip (0, 0)'s blocks of the state, data rank 0's 16 x
   4096 tokens, 2 of the 32 q heads (the kv head they read gathered),
   1 / 16 of ff and vocab, its FSDP gathers, under a virtual mesh whose
   collectives act locally and are counted by kind: a counted warm-up
   step (FLOPs, bytes, the kernels' own work, collective bytes) and 2
   timed steps.  First the flash forward at the chip's layer (1 x 4096,
   2 q heads over 1 kv head) against its plain version (relative L2
   1e-2), timed beside the plain version and SDPA.  Probes: the space's
   default (``space.project(space.default_config())``), it with
   ``attention_impl="flash"``, ``remat_policy`` ``"dots"`` and
   ``"full"``, ``optimizer="adafactor"``, ``grad_allreduce_dtype=
   "bfloat16"``, phase 3's batch-8 recommendation and
   ``expert_manual_config``, and the flash probe and the recommendation
   again with ``sequence_parallel=True`` (the stream between blocks the
   chip's 256-token block of the sequence: ``PRODUCT_SP``), each printed
   beside its SP-off twin; then the default once at one replica's
   share (2 layers, the replica cell scored before the chip share).
   Each prints its depth, ``reduced``, the measured step,
   ``collective_s``, the bytes by kind, ``scored_step_s``, peak memory,
   ``mfu`` and its step-1 loss, or that it ran out of the card's memory;
   then the measured speedups default/recommended and default/expert
   (of ``scored_step_s``) beside ``tune()``'s analytic ones (a finding,
   not a gate).  Gates: every chip probe fits (the recommendation and
   the expert rule too), runs the chip share and counts collectives;
   every step-1 loss within 1e-2 (relative) of the default's; the
   ``dots``, ``full``, Adafactor and bf16 probes' step-1 gradient norm
   within 1e-2 of the default's; the loss's drop over the timed steps
   (the one update the warm-up's lr 0 leaves) of the ``dots``, ``full``
   and bf16 probes within 0.1 of the default's, and the default's and
   Adafactor's drop above 0; the repeated default is a cache hit; the
   flash probe launches exactly (warm-up + timed steps) x microbatches x
   layers wgmma forwards (twice under a recomputing remat policy) and as
   many wgmma backward sets, counted from 0 around it, all at q [1,
   4096, 2, 128] / k [1, 4096, 1, 128]; the SP flash probe exactly the
   flash probe's launches at its shapes (attention runs on the gathered
   sequence); each SP probe sequence-parallel, its step-1 loss within
   1e-2 of the other's and 3e-2 of its twin's (``PRODUCT_SP_TWIN_REL``:
   on the virtual chip the two compute different functions), its
   gradient norm finite and its loss dropping;
   the replica probe scores its measured step; the yi-6b part within
   240 s.
   (expert parallelism, ``PRODUCT_MOE``): qwen2-moe-a2.7b at 4 of 24
   layers (its 60 experts do not divide the model axis: each chip holds
   88 of every expert's 1408 columns) with the space's default, flash,
   ``moe_impl="dropping"`` (the capacity and slots of every data rank's
   tokens) and ``expert_parallel=False`` (the same layout: its step-1
   loss and bytes by kind equal the default's, bit for bit), and
   grok-1-314b at 2 of 64 layers (2048 of 32768 expert columns, 3 q
   heads over one gathered kv head, soft cap 30) with the default and
   flash; first each cell's ``cell_depth`` at the chip share and the
   flash forward at its chip layer (``CHIP_FLASH_MOE``) against its
   plain version and SDPA.  Each probe prints its measured and scored
   step, ``collective_s``, bytes by kind, peak, ``mfu``, roofline and
   step-1 loss (its distance from the default's printed, not gated: a
   random MoE in bf16 is chaotic).  Gates: every probe fits, runs the
   chip share with its collectives counted and finite losses; the twin;
   each flash probe's launches exact at the chip's heads (q [1, 4096, 1,
   128] / [1, 4096, 3, 128], k [1, 4096, 1, 128]); within 200 s.  Then
   the SSM families' train_4k cells at the chip's share (``ssm_inner``
   over the model axis, ``PRODUCT_SSM``), one 4096-token sequence a data
   rank (``reduced``: batch 16 -> 1): xlstm-1.3b's one period (7 mLSTM,
   1 sLSTM; the chip runs its mLSTM head whole, 256 of its 1024 channels
   its own) with the space's default, 1 warm-up + 1 timed step; jamba at
   pattern positions 0 and 1 (mamba with the dense MLP and with the MoE:
   one of the 16 experts a chip) with the default, ``moe_impl=
   "dropping"`` and ``expert_parallel=False`` (every expert's columns
   split instead: another layout, its bytes by kind must differ); first
   the mLSTM forward and backward at the chip's layer (1, 4096, 1, 1024)
   against their plain versions (relative L2 1e-3 and 5e-3 of the
   route's rounded versions), timed beside them, device time and bound
   printed, and each cell's ``cell_depth`` at the chip share (recorded,
   not run).  Each probe prints its measured and scored step,
   ``collective_s``, bytes by kind, peak beside ``estimate_bytes``,
   ``mfu``, step-1 loss and gradient norm.  Gates: every probe fits,
   runs the chip share with its collectives counted, the regroup's
   all-to-all among them; a finite step-1 loss, and for jamba finite
   losses and gradient norm (xlstm-1.3b's sLSTM recurrence overflows its
   gradient at its own initialisation, on one device as on the chip);
   the mLSTM wrapper's launches counted from 0 around each probe exact:
   (warm-up + timed steps) x microbatches x 7 wgmma forwards and as many
   wgmma backwards, none FMA (none in jamba's); the chip holds one of
   jamba's experts; within 150 s.  Then the serving cells at one chip's
   share (prefill and decode under the mesh, ``PRODUCT_SERVE``): first
   the flash forward at yi-6b's prefill_32k chip layer (2 x 32768, 2 q
   heads over 1 kv head; its plain version one sequence and head at a
   time, relative L2 1e-2, beside SDPA) and the mLSTM forward at
   xlstm-1.3b's prefill chip layer (2, 4096, 1, 1024) against its plain
   version; then yi-6b prefill_32k at 2 layers (the family default:
   chunked attention; and under flash), decode_32k at 2 layers (beside
   its replica reading), qwen2-moe prefill_32k at 2 layers, xlstm-1.3b's
   prefill at one period and 4096 tokens (``reduced``; 1 warm-up + 1
   timed step) and jamba's long_500k decode at pattern positions 0-4
   (its attention layer last; ``shard_kv_seq``, the cell's default,
   splits the cache's sequence over the data axis: the combine's
   all-reduces are in its bytes).  Each prints its depth, ``reduced``,
   step, ``collective_s``, bytes by kind, peak and ``mfu``.  Gates: every
   probe fits, runs the chip share with its collectives counted and
   finite logits; the flash probe launches exactly (1 + 2) x 2 = 6 wgmma
   forwards at q [2, 32768, 2, 128] / k [2, 32768, 1, 128] and no FMA,
   the xLSTM probe exactly 7 wgmma mLSTM forwards a step and no FMA, no
   other probe flash; the probes within 120 s.
15. the sharded train step: yi-6b at full width, 2 of 32 layers, on a
   2 x 2 (data, model) mesh of four processes (``launch.mesh.spawn``;
   NCCL when the host has a card for each rank, else gloo with the four
   sharing the card; the backend is printed), the reference's layout
   (ZeRO-3 over data, Megatron TP over model), global batch 4 x 2048,
   microbatch 1, bf16, flash, remat ``block``, AdamW with float32
   masters, 2 steps.  The kernels are built before the spawn.  Gates:
   step 1's gradients (every leaf gathered) within relative L2 2e-2 of
   the one-process step's at the same seed and shape (run on rank 0),
   its loss within 1e-3, no non-finite leaf; each rank's flash launches
   counted from 0 around its 2 steps: 16 wgmma forwards and 8 wgmma
   backward sets at Hq 16 / Hkv 2, none on an FMA route.  Each rank
   counts its collectives' bytes by kind over those steps; then, in this
   process, the virtual 2 x 2 mesh's chip (0, 0) runs the same steps
   alone and must give rank 0's bytes by kind and flash launches
   exactly.  Under sequence parallelism, in the same world: step 1's
   gathered gradients and loss from the same state against the same
   one-process step at the same limits, counted: a rank's flash
   launches are one SP-off step's (8 wgmma forwards, 4 backward sets),
   and the virtual chip's SP forward and backward must give rank 0's
   bytes by kind and launches exactly; the phase within 90 s.
   Prints each rank's step times, peak GiB, bytes by kind and the
   backend.  Then qwen2-moe-a2.7b at full width, 2 of 24 layers, on the
   same mesh in float32 (its 60 experts 30 a model rank; global batch 4
   x 1024, one microbatch, remat none; ``mesh_moe_rank``): rank 0 takes
   the one-process step's gradients first, recording its routing; every
   rank takes step 1's gradients on its block of each global microbatch
   with its tokens' rows of that routing replayed (``routing_replay``;
   each rank prints how many of its tokens' own top-k differed), the
   gradients gathered to rank 0's host.  Gates: loss within 1e-3 and
   every gathered leaf within relative L2 2e-2 of one process, no
   non-finite leaf, as many routing calls as the one-process step made,
   2 FMA flash forwards and 2 FMA backward sets a rank (float32), none
   wgmma; within 60 s of its own.  Then sharded serving on the same mesh
   (``mesh_serve_rank``): yi-6b at 2 layers, flash, bf16, each rank's
   blocks of the weights and its rows of 4 prompts of 2048, the prefill
   and 4 decode steps.  Gates: exactly 2 wgmma flash forwards a rank at
   q [2, 2048, 16, 128] / k [2, 2048, 2, 128], none FMA; each rank's
   logits its 2 rows over the whole vocab, finite; rank 0's last-token
   and decode logits within relative L2 2e-2 of the one-process run
   (bf16); within 60 s of its own.

Every device time read from ``torch.profiler`` in phases 2-13 comes
from a session that recorded the window whole (``whole_profile``: the
path's kernels number what its launch counters say; with no counter, two
sessions in a row agree); a partial session is retried, never reported,
and the smoke fails when none is whole.

The kernels are built at the start of phase 2, one ``nvcc`` per source,
all started together.  The line before the last is ``{"kernels": [...]}`` with each
kernel's launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
ATOL = 2e-4                    # the reference's gp_gram test tolerance
# the backward kernel against its plain version, that formula in float64
# and autograd through the plain Matérn: relative L2 of (dL/dls, dL/dsv),
# each (the CPU tests hold the plain version to 1e-4 of the reference's
# jax.grad).  Autograd differentiates the expanded |a|²+|b|²−2a·b: with
# repeated rows its gradient of a zero distance is rounding noise (the
# on-card test read 1.2e-2 between it and the kernel at n 300, d 40, where
# the kernel holds 1e-3 of the float64 formula; NVIDIA H100 80GB HBM3,
# 700 W), so it is held only at the cases with n = m
GRAM_BWD_REL = 1e-3
PARAM_ATOL = 5e-3              # tests/test_torch_gp.py: fitted log-params

BF16_FLOPS_PER_S = 989e12      # H100 SXM, dense bf16 tensor cores

GRAM_SOURCE = "src/repro_torch/kernels/gp_gram/csrc/gp_gram.cu"
GRAM_REPLACES = "src/repro/kernels/gp_gram/kernel.py:45"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention_wgmma.cu")
FLASH_FMA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:103"
MLSTM_SOURCE = ("src/repro_torch/kernels/mlstm_chunk/csrc/"
                "mlstm_chunk_wgmma.cu")
MLSTM_FMA_SOURCE = "src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu"
MLSTM_REPLACES = "src/repro/kernels/mlstm_chunk/kernel.py:90"
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
# at the path's shapes (bf16 outputs that average over up to S keys, ~0.03
# in size) the reference's per-element atol is loose: the kernel is held to
# a relative L2 error of the whole output, between its measured error and
# that of a planted fault (one 64-key tile dropped from every row)
FLASH_REL_L2 = 1e-2
FLASH_LIBRARY_FACTOR = 3.0     # the wgmma kernel within 3x of SDPA
# the reference's FLASH_CASES: (B, Sq, Sk, H, Kh, D, causal, window, softcap)
FLASH_CASES = [(2, 256, 256, 4, 2, 64, True, None, None),
               (1, 128, 384, 8, 8, 128, True, None, 30.0),
               (2, 200, 200, 4, 1, 64, True, 64, None),
               (1, 512, 512, 2, 2, 128, False, None, None),
               (1, 96, 96, 6, 6, 64, True, None, None),
               (2, 64, 64, 4, 4, 32, True, 16, 10.0)]
PREFILL = (2, 4096, 32, 4, 128)  # yi-6b prefill: B, S, H, Kh, D
LONG_S, LONG_S_CUT, LONG_LIMIT_S = 32768, 16384, 150.0
DECODE_STEPS = 16
# prefill logits, flash vs reference attention.  bf16 weights: relative
# L2 error 0.1.  The reference path rounds the normalised p to bf16 before
# PV, the wgmma kernel the unnormalised exp against its running max, the
# chunked path keeps it in f32, and 32 bf16 layers amplify those
# differences (and every bf16 re-rounding they flip) to a few percent of
# the logits: the reference package's own chunked path lands as far from
# its reference path as the kernel does (both printed).  float32 weights
# (the FMA kernel): atol 1e-3 — the same function in float32, summed in
# another order.
LOGIT_REL_L2_BF16, LOGIT_ATOL_F32 = 0.1, 1e-3

# the reference's MLSTM_CASES: (B, S, H, P, chunk)
MLSTM_CASES = [(2, 128, 2, 32, 32), (1, 256, 4, 64, 64), (2, 64, 1, 16, 16),
               (1, 512, 2, 32, 128), (1, 128, 2, 32, 128)]
MLSTM_ATOL = 5e-5                # tests/test_kernels.py, float32
# bf16 inputs: both versions compute in float32 from the same bf16 numbers
# and round h once; one bf16 step at |h| <= 2 is 7.8e-3
MLSTM_BF16_TOL = (2e-2, 1e-2)    # atol, rtol
MLSTM_LAYER = (2, 4096, 4, 1024)  # xlstm-1.3b's mLSTM layer at B=2: B S H P
MLSTM_CHUNKS = (256, 1024)       # the default and one more of the knob's range
# at the layer shape the whole output is held to a relative L2 error: the
# limits sit between the kernel's readings and those of a planted fault
# (every chunk without its inter-chunk term), all printed below.  Against
# each kernel's own plain version 1e-3: the FMA kernel read 2.3e-5 against
# the float32 version, the wgmma kernel 1.1e-4 against the one that rounds
# where it rounds, the fault 5.0e-2-5.6e-2 (NVIDIA H100 80GB HBM3, 700 W).
# The wgmma kernel against the float32 version 1e-2: its three bf16
# roundings read 2.8e-3 there
MLSTM_REL_L2, MLSTM_REL_L2_F32 = 1e-3, 1e-2
MLSTM_MAX_MS = 2.0               # the wgmma kernel at the layer shape, chunk 256
MLSTM_PASSES = ("mlstm_chunk_gates_kernel", "mlstm_chunk_chain_kernel",
                "mlstm_chunk_state_kernel", "mlstm_chunk_out_kernel")
XLSTM_PREFILL = (2, 4096)        # B, S of the bf16 serving prefill
# its depth: 48 -> 24 (three periods of 7 mLSTM + 1 sLSTM; 48 until the
# MoE cells of phases 14 and 15 came: the script's 1200 s)
XLSTM_PREFILL_LAYERS = 24
# float32 check: a prompt in several chunks against teacher-forced decode.
# As initialised, the sLSTM recurrence amplifies float rounding (x10 every
# ~4 tokens at this width: ``python -m repro_torch.launch.drift``), so that
# comparison is recorded only; with the sLSTM recurrent weights scaled by
# 0.1 it is not chaotic and is held to relative L2 1e-3
XLSTM_CHECK_S, XLSTM_CHECK_CHUNK = 256, 64
XLSTM_WREC_SCALE, XLSTM_LOGIT_REL_L2 = 0.1, 1e-3
# that check's mLSTM layer (xlstm-1.3b: 4 heads of P 1024), on the FMA
# route: held in phase 8 beside MLSTM_CASES, at their tolerances
MLSTM_F32_PATH_CASE = (1, XLSTM_CHECK_S, 4, 1024, XLSTM_CHECK_CHUNK)

# (n, m, d): the reference's GRAM_CASES, its off-ladder case, one knob,
# the main path's shapes (56 observations padded to 64; 2048 LHS + 256
# local + 5·16 sweeps = 2384 candidates; top-16 knobs), a stress shape
# whose d spans two staged chunks, and the tuning daemon's (phase 10):
# sessions search the whole cleaned space, d 327 (train_4k) to 332
# (decode_32k), with 2048 + 256 + 5·d candidates, and the multi-task
# prior stacks two corpus tasks of up to 64 rows each
CASES = [(40, 17, 5), (130, 200, 16), (8, 8, 2), (300, 1, 24),
         (128, 128, 8), (136, 77, 9), (50, 30, 1), (64, 64, 16),
         (2384, 64, 16), (3000, 1000, 40), (64, 64, 327), (64, 64, 332),
         (3939, 64, 327), (2304, 64, 332), (128, 128, 327)]
MAIN_GRAM = (64, 64, 16)
MAIN_CROSS = (2384, 64, 16)
SERVICE_GRAM = (64, 64, 327)
SERVICE_CROSS = (3939, 64, 327)
MTGP_GRAM = (128, 128, 327)   # the multi-task prior: two tasks of 64 rows

# phase 10: the tuning daemon, as benchmarks/perf_tuning_service.py sets
# it up (8 clients, two workloads, one recipe per workload) at BOConfig's
# own per-session budget over the full 327-knob spaces
SERVICE_WORKLOADS = ("yi-6b:train_4k", "qwen1.5-4b:train_4k")
SERVICE_CLIENTS, SERVICE_SEED = 8, 5
SERVICE_CFG = {"n_init": 8, "n_iter": 48, "fit_steps": 150,
               "n_candidates": 2048, "n_local": 256}
HIT_RATE_GATE = 0.40
# the transfer_bo session: a dense-family workload whose space signature
# equals the two donors' (xlstm-1.3b's train_4k space has 328 knobs, so no
# dense log transfers to it)
TRANSFER_ARCH, TRANSFER_SHAPE = "codeqwen1.5-7b", "train_4k"
TRANSFER_BUDGET = 24
# benchmarks/perf_transfer.py's full folds
FOLD_ARCHS, FOLD_RANK_ARCH, FOLD_TOP_K = (
    ("yi-6b", "codeqwen1.5-7b", "mistral-nemo-12b"), "qwen1.5-4b", 8)
FOLD_BUDGET, FOLD_RATIO, FOLD_FRACTION = 16, 0.99, 0.60
CHAOS_RATE, CHAOS_BUDGET, CHAOS_WIDTH = 0.2, 24, 4


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, in ms per call, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


MARKER = "spin_kernel"          # torch.cuda._sleep's kernel


def profiled_device_us(fn, cpu: bool = True, warm=None, pad: float = 0.0):
    """(result of ``fn()``, {kernel name: [summed device µs, count]})
    from ``torch.profiler`` over one call of ``fn`` that ends in a sync;
    the dict is empty when the profiler recorded no device activity.
    ``cpu=False`` records device activity only (fewer events for a run
    of many small kernels).

    ``warm``: first, inside the session, ``warm()``, a sync, ``pad``
    seconds of host sleep and a marker kernel (``MARKER``); only device
    events that start after the marker ends are kept (none when the
    marker was not recorded).  The profiler has dropped a session's
    first launches from a library, the same number again on a retry (1-4
    of 20 Gram kernels, and every kernel of a session; PERF §7), as if
    tracing a library began some launches after its first in the
    session: the warm-up takes that loss outside the window.

    The device events are read from the profiler's raw trace (each
    event's duration, as ``FunctionEvent.device_time`` is), not through
    ``prof.events()``: building those objects took the profiler ~2
    minutes for the ~870k kernels of an xlstm microbatch and its
    warm-up."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        if warm is not None:
            warm()
            torch.cuda.synchronize()
            time.sleep(pad)
            torch.cuda._sleep(1000)
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_hidden_event", lambda: False)()]
    if warm is not None:
        ends = [e.end_ns() for e in events if MARKER in e.name()]
        start = max(ends) if ends else math.inf
        events = [e for e in events if e.start_ns() >= start]
    by_name = {}
    for e in events:
        acc = by_name.setdefault(e.name(), [0.0, 0])
        acc[0] += e.duration_ns() / 1e3
        acc[1] += 1
    return out, by_name


def _flash_wgmma_launches() -> int:
    from repro_torch.kernels.flash_attention import ops
    return ops.launches_wgmma


# the flash forward's wgmma kernel, one per wrapper call (whole_profile)
FLASH_COUNTED = (("flash_wgmma_kernel", _flash_wgmma_launches, 1),)
# a retried session's warm-up (whole_profile): host sleep (s) between the
# warm-up and the window, by retry
PROFILE_PADS = (0.0, 0.2, 1.0)


def whole_profile(fn, counted=(), cpu: bool = True, what: str = "",
                  sessions: int = 3, required: bool = True,
                  resets: bool = False, warm=None):
    """(result of ``fn()``, {kernel name: [µs, count]}) from the first
    profiler session (``profiled_device_us``) over one call of ``fn`` that
    recorded the window whole.  Late in a full run a session has come
    back with none or only some of its kernels, reading low (PERF §7),
    so a session counts only when, for each ``(name, counter,
    per_launch)`` in ``counted``, the kernels whose name holds ``name``
    number ``per_launch`` times the rise of ``counter()`` (a wrapper's
    launch counter) over that session (``resets``: ``fn`` sets the
    counters to 0 first, so the rise is the reading after it); with
    nothing counted (plain torch,
    a decode step) two sessions in a row must record the same number of
    device events, each session after a warm-up (a loss at a session's
    start would repeat alike).  Up to ``sessions`` tries (one more with
    nothing counted); a retry, or a session with nothing counted, first
    runs ``fn`` once inside the session as a warm-up, outside the window
    (``profiled_device_us``'s ``warm``, with ``PROFILE_PADS`` of sleep
    after it on a retry).  ``warm``: a cheap call that launches the
    counted kernels, run inside the first session as its warm-up (a long
    window's retry, warmed by ``fn``, costs two windows more).  Then
    fails, or returns None when ``required`` is false (the caller
    measures in a fresh process).  A partial session is never
    returned."""
    last = None
    tries = sessions + (0 if counted else 1)
    before = []

    def window():
        before[:] = [c() for _, c, _ in counted]
        return fn()
    for attempt in range(1, tries + 1):
        retry = attempt - 1 if counted else max(attempt - 2, 0)
        pad = PROFILE_PADS[min(retry, len(PROFILE_PADS) - 1)]
        out, by_name = profiled_device_us(
            window, cpu=cpu, warm=fn if retry or not counted else warm,
            pad=pad)
        got = [sum(n for k, (_, n) in by_name.items() if name in k)
               for name, _, _ in counted]
        want = [per * (c() - (0 if resets else b))
                for (_, c, per), b in zip(counted, before)]
        total = sum(n for _, n in by_name.values())
        whole = (total > 0 and got == want and all(w > 0 for w in want)
                 if counted else total > 0 and total == last)
        if whole:
            if attempt > (1 if counted else 2):
                print(f"  {what}: profiler session {attempt} of {tries} "
                      f"recorded the window whole", flush=True)
            return out, by_name
        if counted or last is not None:
            print(f"  {what}: profiler session {attempt} of {tries} "
                  + (f"(after a warm-up and {pad} s) " if retry or
                     not counted else "")
                  + f"recorded {total} device events"
                  + (f", kernels {got} of {want}" if counted else
                     f" (the one before {last})"), flush=True)
        last = total
    check(not required, f"{what}: no whole profiler session in {tries}")
    return None


def device_ms(fn, calls: int = 20, counted=(), what: str = "device_ms",
              fresh=None, detail: bool = False, breakdown=None):
    """Mean device time per call, in ms: the summed duration of the CUDA
    kernels ``fn`` launches, from ``torch.profiler`` (host time excluded),
    over a session that recorded them all (``whole_profile``: ``counted``
    names the wrapper's kernels and launch counter, if it has one).  When
    no session is whole, ``fresh()`` measures the same in a new process
    (a session there has recorded the same window whole where this
    process's did not, PERF §7); fails when neither can.  ``detail``
    prints each kernel's device ms per call; ``breakdown`` (a dict) gets
    them by kernel name."""
    import torch
    fn()
    torch.cuda.synchronize()
    got = whole_profile(lambda: [fn() for _ in range(calls)], counted,
                        what=what, required=fresh is None)
    if got is not None:
        if detail:
            for name, (us, n) in sorted(got[1].items(),
                                        key=lambda kv: -kv[1][0]):
                print(f"    {us / calls / 1e3:.4f} ms a call ({n} "
                      f"launches) {name[:90]}", flush=True)
        if breakdown is not None:
            breakdown.update({name: us / calls / 1e3
                              for name, (us, _) in got[1].items()})
        return sum(t for t, _ in got[1].values()) / calls / 1e3
    ms = fresh()
    check(ms > 0, f"{what}: the profiler recorded no whole session")
    print(f"  {what}: device ms per call measured in a fresh process: "
          f"{ms:.6f}", flush=True)
    return ms


# phase 2's kernels' (or their plain versions') profiled device ms per call
# in a process of its own: argv = kind, plain (0/1), n, m, d (JSON), the
# repo's root, its src/
FRESH_GRAM = """
import json, sys
sys.path[:0] = sys.argv[2:4]
import torch
import chip_smoke
from repro_torch.kernels.gp_gram import ops, ref
kind, plain, n, m, d = json.loads(sys.argv[1])
gen = torch.Generator().manual_seed(0)
xa, xb = (torch.rand(s, generator=gen).cuda() for s in ((n, d), (m, d)))
ls = (0.1 + 0.9 * torch.rand((d,), generator=gen)).cuda()
sv = torch.tensor(1.7, device="cuda")
g = torch.randn((n, n), generator=gen).cuda()
args, name = {"gram": ((xa, ls, sv), "matern52_kernel"),
              "cross": ((xa, xb, ls, sv), "matern52_kernel"),
              "gram_bwd": ((xa, ls, sv, g), "matern52_gram_bwd_kernel")}[kind]
fn = {"gram": (ops.matern52_gram, ref.matern52_gram_ref),
      "cross": (ops.matern52_cross, ref.matern52_cross_ref),
      "gram_bwd": (ops.matern52_gram_bwd, ref.matern52_gram_bwd)}[kind][plain]
counted = () if plain else (
    (name, lambda: getattr(ops, f"{kind}_launches"), 1),)
print(json.dumps(chip_smoke.device_ms(lambda: fn(*args), counted=counted,
                                      what=f"fresh {kind}")))
"""


def fresh_device_ms(script: str, arg) -> float:
    """Run ``script`` (FRESH_GRAM, FRESH_BWD, FRESH_FWD, FRESH_MLSTM_BWD)
    in a new process with the JSON of ``arg``; its last line is the device
    ms per call."""
    r = subprocess.run([sys.executable, "-c", script, json.dumps(arg),
                        str(ROOT), str(SRC)], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    check(r.returncode == 0, f"the fresh-process profile failed: "
          f"{r.stderr[-2000:]}")
    return float(r.stdout.strip().splitlines()[-1])


def gram_device_ms(kind: str, fn, args, shape, plain: bool = False):
    """``device_ms`` of a Gram kernel (its launch counter counted) or of
    its plain version, with FRESH_GRAM as the fresh process."""
    from repro_torch.kernels.gp_gram import ops
    name = ("matern52_gram_bwd_kernel" if kind == "gram_bwd"
            else "matern52_kernel")
    counted = () if plain else (
        (name, lambda: getattr(ops, f"{kind}_launches"), 1),)
    return device_ms(lambda: fn(*args), counted=counted,
                     what=f"{kind} {shape}" + (" plain" if plain else ""),
                     fresh=lambda: fresh_device_ms(
                         FRESH_GRAM, [kind, int(plain), *shape]))


def gram_bound(n: int, m: int, d: int, gram: bool):
    """(bound_ms, bound_by): each input read once and the output written
    once at the HBM rate, against the float32 operations at the
    non-tensor-core peak.  Per output: 2d for the dot product and 14 for
    the epilogue; per input row: 3d for scaling and its squared norm."""
    in_rows = n if gram else n + m
    nbytes = 4 * (in_rows * d + d + 1 + n * m)
    ops = n * m * (2 * d + 14) + 3 * d * in_rows
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gram_bwd_bound(n: int, d: int):
    """(bound_ms, bound_by) of the Gram's backward: x, g, ls and sv read
    once and (dL/dls, dL/dsv) written once at the HBM rate, against the
    float32 operations at the non-tensor-core peak.  Per pair (i, j): 2d
    for r² (a dot product; the norms' 3d per row are counted once), 3d for
    the differences, their squares and the weighted sums into dL/dls, and
    20 for s, exp(-s) and the two weights."""
    nbytes = 4 * (n * d + n * n + d + 1 + d + 1)
    ops = n * n * (5 * d + 20) + 3 * d * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gram_bwd_without_one_plus_s(x, lengthscale, signal_var, g):
    """A planted fault: the plain backward with w missing its (1 + s)."""
    import torch
    from repro_torch.kernels.gp_gram.ref import SQRT5, sqdist
    d2 = sqdist(x, x, 1.0 / lengthscale)
    pos = d2 > 1e-12
    s = SQRT5 * torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)
    e = torch.exp(-s)
    w = torch.where(pos, g * (5.0 / 3.0) * signal_var * e, 0.0)
    acc = torch.zeros_like(lengthscale)
    for i0 in range(0, x.shape[0], 256):
        diff = x[i0:i0 + 256, None, :] - x[None, :, :]
        acc = acc + torch.einsum("ij,ijk->k", w[i0:i0 + 256], diff * diff)
    return acc / lengthscale ** 3, torch.sum(g * (1.0 + s + s * s / 3.0) * e)


def build_all() -> None:
    """Build every kernel of the port from the checkout's sources, one
    ``nvcc`` each, all started together; print ptxas's reports."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gp_gram import ops as gram_ops
    from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops

    def timed(src, build):
        t0 = time.perf_counter()
        build(verbose=True)
        return src, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        futs = [pool.submit(timed, GRAM_SOURCE, gram_ops.build),
                pool.submit(timed, FLASH_SOURCE, lambda verbose: flash_ops
                            .build(verbose, which="wgmma")),
                pool.submit(timed, FLASH_FMA_SOURCE, lambda verbose: flash_ops
                            .build(verbose, which="fma")),
                pool.submit(timed, FLASH_BWD_SOURCE, lambda verbose: flash_ops
                            .build(verbose, which="bwd_wgmma")),
                pool.submit(timed, FLASH_BWD_FMA_SOURCE, lambda verbose:
                            flash_ops.build(verbose, which="bwd")),
                pool.submit(timed, MLSTM_SOURCE, lambda verbose: mlstm_ops
                            .build(verbose, which="wgmma")),
                pool.submit(timed, MLSTM_FMA_SOURCE, lambda verbose: mlstm_ops
                            .build(verbose, which="fma")),
                pool.submit(timed, MLSTM_BWD_SOURCE, lambda verbose: mlstm_ops
                            .build(verbose, which="bwd_wgmma")),
                pool.submit(timed, MLSTM_BWD_FMA_SOURCE, lambda verbose:
                            mlstm_ops.build(verbose, which="bwd"))]
        for f in futs:
            src, dt = f.result()
            print(f"nvcc build of {src}: {dt:.2f} s", flush=True)
    print(f"all kernels built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    # load every library before any profiler session: a library first
    # loaded after one has run showed no device time under later sessions
    gram_ops._LIB.load()
    flash_ops.load()
    mlstm_ops.load()


def phase_device():
    import torch
    print("== phase 1: device", flush=True)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print("card (nvidia-smi name, power.limit):")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    return card


def phase_kernels(card: str):
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels.gp_gram import ops, ref

    print("== phase 2: kernels vs plain torch on the card", flush=True)
    dev = resolve_device("cuda")
    build_all()

    gen = torch.Generator().manual_seed(0)
    err = {"gram": 0.0, "cross": 0.0}
    timing = {}
    print(f"timings on {card}: kernel_ms/plain_ms = CUDA events, median "
          "of 25 windows of 10 back-to-back calls, ms per call (host "
          "dispatch included); device_ms = profiled kernel time per call")
    for n, m, d in CASES:
        xa = torch.rand((n, d), generator=gen).to(dev)
        xb = torch.rand((m, d), generator=gen).to(dev)
        ls = (0.1 + 0.9 * torch.rand((d,), generator=gen)).to(dev)
        sv = torch.tensor(1.7, device=dev)
        for kind in ("gram", "cross"):
            if kind == "gram":
                args = (xa, ls, sv)
                fn, plain, shape = (ops.matern52_gram,
                                    ref.matern52_gram_ref, (n, n, d))
            else:
                args = (xa, xb, ls, sv)
                fn, plain, shape = (ops.matern52_cross,
                                    ref.matern52_cross_ref, (n, m, d))
            out = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            check(out.shape == want.shape,
                  f"{kind} {shape}: shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()),
                  f"{kind} {shape}: non-finite output")
            e = float((out - want).abs().max())
            err[kind] = max(err[kind], e)
            check(e <= ATOL, f"{kind} {shape}: max |kernel - plain| = {e}")
            k_ms = cuda_ms(lambda: fn(*args))
            p_ms = cuda_ms(lambda: plain(*args))
            b_ms, b_by = gram_bound(*shape, gram=kind == "gram")
            dev_ms = {}
            if shape in (MAIN_GRAM, MAIN_CROSS, SERVICE_GRAM,
                         SERVICE_CROSS, MTGP_GRAM):
                dev_ms = {"device_ms": gram_device_ms(kind, fn, args,
                                                      shape),
                          "plain_device_ms": gram_device_ms(
                              kind, plain, args, shape, plain=True)}
            timing[(kind, shape)] = (k_ms, p_ms, b_ms, b_by, dev_ms)
            extra = "".join(f" {k}={v:.5f}" for k, v in dev_ms.items())
            print(f"  {kind:5s} n={shape[0]:5d} m={shape[1]:5d} "
                  f"d={shape[2]:3d}: max_abs_err={e:.3e} kernel_ms={k_ms:.5f}"
                  f" plain_ms={p_ms:.5f} bound_ms={b_ms:.6f} ({b_by})"
                  f" library_ms=none{extra}", flush=True)

    # duplicated rows: r² cancels to ~0 but not exactly, in the reference
    # too; the entries must land within atol of sv
    base = torch.rand((16, 16), generator=gen).to(dev)
    x = base[torch.arange(64, device=dev) % 16].contiguous()
    ls = torch.full((16,), 0.3, device=dev)
    g = ops.matern52_gram(x, ls, torch.tensor(1.7, device=dev))
    c = ops.matern52_cross(x, base, ls, torch.tensor(1.7, device=dev))
    same = (torch.arange(64, device=dev)[:, None] % 16
            == torch.arange(64, device=dev)[None, :] % 16)
    e_dup = max(float((g[same] - 1.7).abs().max()),
                float((c[same[:, :16]] - 1.7).abs().max()))
    check(e_dup <= ATOL, f"duplicated rows: max |K - sv| = {e_dup}")
    print(f"  duplicated rows: max |K - sv| = {e_dup:.3e}", flush=True)

    # a config's one-knob neighbours (the candidates' axis sweeps) at the
    # daemon's 327 knobs and the fit's initial lengthscale 0.3: r near 0,
    # where the expanded |a|² + |b|² − 2a·b (the reference's arithmetic,
    # recorded here) cancels; beyond 64 features the kernel sums direct
    # differences
    d = SERVICE_GRAM[2]
    x = torch.rand((64, d), generator=gen).to(dev)
    sweeps = x[:1].repeat(5 * d, 1)
    for j in range(d):
        sweeps[5 * j:5 * j + 5, j] = torch.linspace(0, 1, 5, device=dev)
    ls = torch.full((d,), 0.3, device=dev)
    sv = torch.tensor(1.7, device=dev)
    got = ops.matern52_cross(sweeps, x, ls, sv)
    exact = ref.matern52_cross_ref(sweeps.double(), x.double(), ls.double(),
                                   sv.double())
    e_plain = float((got - ref.matern52_cross_ref(sweeps, x, ls, sv))
                    .abs().max())
    e_exact = float((got.double() - exact).abs().max())
    a, b = sweeps / ls, x / ls
    d2 = torch.clamp_min((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
                         - 2.0 * (a @ b.T), 0.0)
    r = torch.where(d2 > 1e-12, torch.sqrt(torch.where(d2 > 1e-12, d2, 1.0)),
                    0.0) * math.sqrt(5.0)
    e_expanded = float((sv * (1 + r + r * r / 3) * torch.exp(-r)).double()
                       .sub(exact).abs().max())
    print(f"  one-knob neighbours [{5 * d},{d}] x [64,{d}], lengthscale "
          f"0.3: max |kernel - plain| = {e_plain:.3e}, |kernel - float64| "
          f"= {e_exact:.3e}; the expanded form in float32: "
          f"{e_expanded:.3e} (recorded)", flush=True)
    check(max(e_plain, e_exact) <= ATOL,
          f"one-knob neighbours: {e_plain}, {e_exact}")
    timing["gram_bwd"] = phase_gram_bwd(gen, dev)
    err["gram_bwd"] = timing["gram_bwd"].pop("rel_l2")
    return err, timing


def phase_gram_bwd(gen, dev):
    """The backward kernel at every case's Gram against its plain version,
    that formula in float64 and autograd through the plain Matérn, with a
    planted fault; two calls bit-equal; timed at the fit's Gram, a daemon
    session's and the multi-task prior's, where a daemon session's device
    time must be below its plain version's."""
    import torch
    from repro_torch.kernels.gp_gram import ops, ref

    def rel2(got, want):                  # the larger of the two parts'
        return max(rel_l2(got[0], want[0]),
                   rel_l2(got[1].reshape(1), want[1].reshape(1)))

    print(f"  backward kernel (relative L2 of dL/dls and dL/dsv, the larger;"
          f" limit {GRAM_BWD_REL}; autograd held at n = m only):",
          flush=True)
    worst, worst_abs, out = 0.0, 0.0, {}
    for n, m, d in CASES:
        x = torch.rand((n, d), generator=gen)
        x[-min(8, n // 2):] = 0.5             # the fit's pad rows
        x[:n // 8] = x[n // 8:2 * (n // 8)].clone()   # repeated rows
        x = x.to(dev)
        ls = (0.1 + 0.9 * torch.rand((d,), generator=gen)).to(dev)
        sv = torch.tensor(1.7, device=dev)
        g = torch.randn((n, n), generator=gen).to(dev)
        args = (x, ls, sv, g)
        got = ops.matern52_gram_bwd(*args)
        again = ops.matern52_gram_bwd(*args)
        plain = ref.matern52_gram_bwd(*args)
        exact = ref.matern52_gram_bwd(*(t.double() for t in args))
        ls_ = ls.clone().requires_grad_(True)
        sv_ = sv.clone().requires_grad_(True)
        auto = torch.autograd.grad(
            torch.sum(g * ref.matern52(x, x, ls_, sv_)), [ls_, sv_])
        fault = gram_bwd_without_one_plus_s(*args)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"gram_bwd n={n} d={d}: non-finite output")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"gram_bwd n={n} d={d}: two calls gave different bits")
        e_plain, e_exact, e_auto = (rel2(got, w) for w in (plain, exact,
                                                           auto))
        f_plain, f_exact, f_auto = (rel2(fault, w) for w in (plain, exact,
                                                             auto))
        held = [e_plain, e_exact] + ([e_auto] if n == m else [])
        worst = max([worst] + held)
        worst_abs = max([worst_abs] + [float((a - b).abs().max())
                                       for a, b in zip(got, plain)])
        print(f"  gram_bwd n={n:5d} d={d:3d}: rel_l2 vs plain={e_plain:.3e} "
              f"vs float64={e_exact:.3e} vs autograd={e_auto:.3e}"
              f"{'' if n == m else ' (recorded)'}; planted fault "
              f"{f_plain:.3e} / {f_exact:.3e} / {f_auto:.3e}; two calls "
              "bit-equal", flush=True)
        check(max(held) <= GRAM_BWD_REL,
              f"gram_bwd n={n} d={d}: relative L2 {held}")
        check(min(f_plain, f_exact, f_auto) > GRAM_BWD_REL,
              f"gram_bwd n={n} d={d}: the planted fault reads "
              f"{f_plain} / {f_exact} / {f_auto}, within the limit")
        if (n, n, d) in (MAIN_GRAM, SERVICE_GRAM, MTGP_GRAM):
            k_ms = cuda_ms(lambda: ops.matern52_gram_bwd(*args))
            p_ms = cuda_ms(lambda: ref.matern52_gram_bwd(*args))
            b_ms, b_by = gram_bwd_bound(n, d)
            t = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by,
                 "device_ms": gram_device_ms(
                     "gram_bwd", ops.matern52_gram_bwd, args, (n, n, d)),
                 "plain_device_ms": gram_device_ms(
                     "gram_bwd", ref.matern52_gram_bwd, args, (n, n, d),
                     plain=True)}
            if (n, n, d) == MAIN_GRAM:
                out.update(t)
            else:
                out["service" if (n, n, d) == SERVICE_GRAM else "mtgp"] = t
            print(f"  gram_bwd n={n:5d} d={d:3d}: kernel_ms={k_ms:.5f} "
                  f"plain_ms={p_ms:.5f} bound_ms={b_ms:.7f} ({b_by}) "
                  f"library_ms=none device_ms={t['device_ms']:.7f} "
                  f"plain_device_ms={t['plain_device_ms']:.5f}",
                  flush=True)
    out["rel_l2"], out["max_abs_err"] = worst, worst_abs
    print(f"  gram_bwd max |kernel - plain| over the cases: {worst_abs:.3e}",
          flush=True)
    svc = out["service"]
    check(svc["device_ms"] < svc["plain_device_ms"],
          f"gram_bwd {SERVICE_GRAM}: device ms {svc['device_ms']} not below "
          f"the plain version's {svc['plain_device_ms']}")
    return out


def eager_plain_fit(params, x, y, kind: str, steps: int = 200,
                    lr: float = 0.05, extra_noise=None, use_kernel=False):
    """The fit loop as it was before the graphed step, kept here for the
    before/after comparison only: Adam stepped from Python, autograd
    through the plain Gram (``use_kernel`` is ignored: the CUDA kernel had
    no backward), bias corrections computed on the host every step."""
    import numpy as np
    import torch
    from repro_torch.core import gp
    p = [t.detach().clone() for t in params]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    t = np.float32(0.0)
    for _ in range(steps):
        leaves = [pi.requires_grad_(True) for pi in p]
        loss = gp.neg_log_marginal(gp.GPParams(*leaves), x, y, kind,
                                   extra_noise)
        grads = torch.autograd.grad(loss, leaves)
        t = t + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.float32(0.9) ** t)
        bc2 = float(np.float32(1.0) - np.float32(0.999) ** t)
        with torch.no_grad():
            for i, (lo, hi) in enumerate(gp._BOXES):
                g = torch.nan_to_num(grads[i])
                m[i] = 0.9 * m[i] + 0.1 * g
                v[i] = 0.999 * v[i] + 0.001 * g * g
                step = lr * (m[i] / bc1) / (torch.sqrt(v[i] / bc2) + 1e-8)
                p[i] = torch.clamp(leaves[i] - step, lo, hi)
    return gp.GPParams(*p)


@contextlib.contextmanager
def fit_loop_before():
    """Within this context ``gp.fit`` (and so ``tune()``) runs
    :func:`eager_plain_fit` in place of the graphed fit."""
    from repro_torch.core import gp
    fit, gp._fit = gp._fit, eager_plain_fit
    try:
        yield
    finally:
        gp._fit = fit


def _timed_sapphire(**kw):
    """A ``Sapphire`` whose stage methods record their wall time in
    ``stage_s`` (each ends in a device sync); ``tune()`` is what runs."""
    import torch
    from repro_torch.core.tuner import Sapphire

    class TimedSapphire(Sapphire):
        def _timed(self, name, fn, *a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.__dict__.setdefault("stage_s", {})[name] = \
                time.perf_counter() - t0
            return out

        def rank_stage(self, *a, **k):
            return self._timed("rank", super().rank_stage, *a, **k)

        def search_stage(self, *a, **k):
            return self._timed("search", super().search_stage, *a, **k)

        def validate_stage(self, *a, **k):
            return self._timed("validate", super().validate_stage, *a, **k)

    return TimedSapphire(**kw)


def phase_main_path(card: str):
    import numpy as np
    import torch
    from repro_torch.core import ranking
    from repro_torch.core.lasso import lasso_path
    from repro_torch.core.tuner import Sapphire
    from repro_torch.kernels.gp_gram import ops

    print("== phase 3: Sapphire(arch='yi-6b', shape='train_4k').tune() "
          "at the paper's budgets (300 rank samples, top-16, BOConfig "
          "defaults)", flush=True)
    launches = {"gram": 0, "cross": 0, "gram_bwd": 0}
    results = {}
    for bs in (1, 8):
        s = _timed_sapphire(arch="yi-6b", shape="train_4k", batch_size=bs,
                           device="cuda")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = s.tune()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g, c, b = ops.gram_launches, ops.cross_launches, ops.gram_bwd_launches
        check(g > 0 and c > 0 and b > 0,
              f"batch_size={bs}: kernel launches gram={g} cross={c} "
              f"gram_bwd={b}")
        launches["gram"] += g
        launches["cross"] += c
        launches["gram_bwd"] += b
        check(math.isfinite(res.best_value) and res.best_value > 0,
              f"batch_size={bs}: best value {res.best_value}")
        check(res.best_value <= res.default_value,
              f"batch_size={bs}: best {res.best_value} worse than default "
              f"{res.default_value}")
        sub = {k: v for k, v in res.best_config.items()
               if k in res.final_space.names}
        errs = res.final_space.validate(sub)
        check(errs == [], f"batch_size={bs}: invalid recommendation {errs}")
        check(res.n_evaluations == 300 + 8 + 48,
              f"batch_size={bs}: {res.n_evaluations} evaluations")
        stages = " ".join(f"{k}={v:.3f}s" for k, v in s.stage_s.items())
        print(f"batch_size={bs} on {card}: tune wall={wall:.3f}s {stages}")
        print(f"  speedup_vs_default={res.speedup_vs_default:.4f} "
              f"speedup_vs_expert={res.speedup_vs_expert:.4f} "
              f"best_step_s={res.best_value:.6f} "
              f"default_step_s={res.default_value:.6f}")
        print(f"  kernel launches: matern52_gram={g} matern52_cross={c} "
              f"matern52_gram_bwd={b}")
        print(f"  top-16: {res.ranking.top(16)}", flush=True)
        results[bs] = (res, s.stage_s)

    # before: the same runs with the fit loop as it was (eager Adam,
    # autograd through the plain Gram), in this call on this card
    for bs in (1, 8):
        s = _timed_sapphire(arch="yi-6b", shape="train_4k", batch_size=bs,
                           device="cuda")
        t0 = time.perf_counter()
        with fit_loop_before():
            res = s.tune()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(math.isfinite(res.best_value)
              and res.best_value <= res.default_value,
              f"batch_size={bs}, fit loop before: best {res.best_value}")
        stages = " ".join(f"{k}={v:.3f}s" for k, v in s.stage_s.items())
        after = results[bs][1]
        print(f"batch_size={bs} on {card}, fit loop before (eager, plain "
              f"autograd): tune wall={wall:.3f}s {stages}; search stage "
              f"before/after = {s.stage_s['search'] / after['search']:.2f}x")
        print(f"  speedup_vs_default={res.speedup_vs_default:.4f} "
              f"best_step_s={res.best_value:.6f}", flush=True)
    results = {bs: r for bs, (r, _) in results.items()}

    # the lasso path alone on the card, on the ranking's own samples: its
    # per-iteration stopping test is one host read per FISTA step
    rk = results[1].ranking
    x, _ = ranking.encode(rk.space, rk.samples)
    y = ranking.encode_target(rk.values)
    lasso_path(x, y, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lasso_path(x, y, device="cuda")
    torch.cuda.synchronize()
    print(f"lasso path on {card} ({x.shape[0]} samples x {x.shape[1]} "
          f"features, 50 lambdas): {time.perf_counter() - t0:.3f}s",
          flush=True)

    # the rank stage alone on the host at the same seed: the same samples
    # and values; only the lasso's float order differs
    s_cpu = Sapphire(arch="yi-6b", shape="train_4k", device="cpu")
    *_, space, _, _, ctrl = s_cpu._setup()
    t0 = time.perf_counter()
    rk_cpu = s_cpu.rank_stage(ctrl, space)
    print(f"rank stage on the host CPU: {time.perf_counter() - t0:.3f}s")
    check(np.allclose(rk_cpu.values, rk.values, rtol=1e-6, atol=0),
          "CPU rank stage scored different values")
    print(f"  top-16 (cuda): {rk.top(16)}")
    print(f"  top-16 (cpu):  {rk_cpu.top(16)}", flush=True)
    check(set(rk_cpu.top(16)) == set(rk.top(16)),
          "CPU and CUDA rank stages picked different top-16 sets")
    # the batch-8 recommendation and its analytic values, which phase 14
    # runs on the card
    r8 = results[8]
    tuned = {"best_config": dict(r8.best_config),
             "default_value": r8.default_value,
             "best_value": r8.best_value, "expert_value": r8.expert_value}
    return launches, tuned


def phase_profile(card: str):
    import numpy as np
    import torch
    from repro_torch.core import gp

    print("== phase 4: one GP fit (150 Adam steps) + q=8 selection at the "
          "main path's shapes under torch.profiler, before (eager Adam, "
          "autograd through the plain Gram) and after (graphed kernel fit)",
          flush=True)
    rng = np.random.default_rng(0)
    x = rng.random((56, 16))
    y = np.log(1.0 + x[:, 0] + (x[:, 1] - 0.4) ** 2
               + 0.05 * rng.normal(size=56))
    cand = rng.random((2384, 16)).astype(np.float32)
    y_raw = np.zeros(64, np.float32)
    y_raw[:56] = y

    def round_():
        st = gp.fit(x, y, steps=150, pad_to=64, use_kernel=True,
                    device="cuda")
        return gp.select_batch(st, cand, y_raw, 56, float(y.min()), 8,
                               use_kernel=True).cpu()

    def wall_ms(before: bool):
        with (fit_loop_before() if before else contextlib.nullcontext()):
            t0 = time.perf_counter()
            round_()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

    for before in (True, False):          # warm both
        wall_ms(before)
    walls = {"before": [], "after": []}
    for before in (True, False, False, True):
        walls["before" if before else "after"].append(wall_ms(before))
    print(f"GP round wall on {card}, unprofiled, in turns before/after/"
          f"after/before: before {walls['before'][0]:.3f}, "
          f"{walls['before'][1]:.3f} ms; after {walls['after'][0]:.3f}, "
          f"{walls['after'][1]:.3f} ms", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for label, before in (("before", True), ("after", False)):
        with (fit_loop_before() if before else contextlib.nullcontext()):
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                round_()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.device_time for e in events)
        check(busy_us > 0, f"GP round {label}: no device time profiled")
        idle = 1 - busy_us / 1e3 / (wall * 1e3)
        out[label] = (wall * 1e3, busy_us / 1e3, idle)
        print(f"GP round ({label}) on {card}: wall={wall * 1e3:.3f}ms "
              f"device_busy={busy_us / 1e3:.3f}ms idle_share={idle:.4f} "
              f"device_kernels={len(events)}")
        by_name = {}
        for e in events:
            t, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.device_time, k + 1)
        for name, (t, k) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
            print(f"  {t / 1e3:9.3f}ms {k:6d}x {name[:90]}")
        sys.stdout.flush()

    # the fit alone: CUDA events around the 150 replays
    xj, yj, ej, _, _ = gp._prepare(x, y, True, torch.device("cuda"), 64)
    p0 = gp.init_params(16, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    cold = gp._fit(p0, xj, yj, "matern52", steps=150, extra_noise=ej,
                   use_kernel=True)
    end.record()
    end.synchronize()
    print(f"graphed fit alone (150 steps, cached graph): wall "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms, device span "
          f"{start.elapsed_time(end):.3f} ms "
          f"({start.elapsed_time(end) / 150 * 1e3:.2f} us per step)",
          flush=True)

    # the graph against the same steps run eagerly, cold and warm
    eager = gp._eager_fit(p0, xj, yj, "matern52", 150, 0.05, ej, True)
    check(all(torch.equal(a, b) for a, b in zip(cold, eager)),
          "graphed fit (150 steps) differs from the eager steps")
    warm = gp._fit(cold, xj, yj, "matern52", steps=50, extra_noise=ej,
                   use_kernel=True)
    eager_w = gp._eager_fit(cold, xj, yj, "matern52", 50, 0.05, ej, True)
    check(all(torch.equal(a, b) for a, b in zip(warm, eager_w)),
          "graphed warm fit (50 steps) differs from the eager steps")
    plain = eager_plain_fit(p0, xj, yj, "matern52", steps=150,
                            extra_noise=ej)
    dev_p = max(float((a - b).abs().max()) for a, b in zip(cold, plain))
    print(f"graphed fit bit-equal to the eager steps (150 cold, 50 warm); "
          f"max |kernel fit - plain-autograd fit| over the log-params = "
          f"{dev_p:.3e} (limit {PARAM_ATOL})", flush=True)
    check(dev_p <= PARAM_ATOL, f"kernel fit {dev_p} from the plain fit")
    print(f"graph captures this process: {gp.graph_captures}", flush=True)
    return out


def rel_l2(a, b) -> float:
    """|a - b| / |b| over the whole tensor, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _bound(flops, nbytes, flops_per_s):
    """(bound_ms, bound_by, flops): the larger of ``nbytes`` at the HBM
    rate and ``flops`` at ``flops_per_s``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops)


def flash_bound(B, Sq, Sk, H, Kh, D, causal, itemsize, flops_per_s):
    """(bound_ms, bound_by, flops) of a flash forward launch from the
    wrapper's own count (``ops.fwd_work``: q, k, v read and o written
    once; QK^T and PV over the visible pairs)."""
    from repro_torch.kernels.flash_attention import ops
    return _bound(*ops.fwd_work(B, Sq, Sk, H, Kh, D, causal, None,
                                itemsize), flops_per_s)


def ptxas_summary(report: str, kernel: str) -> str:
    """The registers / spills / shared-memory lines of ``kernel``'s
    instantiations in a verbose nvcc build's output."""
    keep, take = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            take = kernel in line
            if take and "Compiling" in line:
                keep.append(line.split("'")[1] if "'" in line else line)
        elif take and ("spill" in line or "registers" in line
                       or "smem" in line):
            keep.append("    " + line.strip())
    return "\n".join(keep)


def phase_flash(card: str):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref

    print("== phase 5: flash-attention kernels vs plain torch on the card",
          flush=True)
    print("ptxas, the wgmma kernel (flash_wgmma_kernel<D>):\n" + ptxas_summary(
              ops._LIBS["wgmma"].report, "flash_wgmma_kernel"), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def qkv(B, Sq, Sk, H, Kh, D, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((B, Sq, H, D), (B, Sk, Kh, D), (B, Sk, Kh, D))]

    err = {}
    for B, Sq, Sk, H, Kh, D, causal, window, softcap in FLASH_CASES:
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            q, k, v = qkv(B, Sq, Sk, H, Kh, D, dt)
            kw = dict(causal=causal, window=window, softcap=softcap)
            route = ops.route(dt, D)
            before = (ops.launches_wgmma, ops.launches_fma)
            out = ops.flash_attention(q, k, v, **kw)
            want = ops.plain_version(q, k, v, **kw)
            torch.cuda.synchronize()
            tag = (f"{name} B={B} Sq={Sq} Sk={Sk} H={H} Kh={Kh} D={D} "
                   f"causal={causal} window={window} softcap={softcap} "
                   f"({route})")
            check((ops.launches_wgmma, ops.launches_fma) == (
                before[0] + (route == "wgmma"), before[1] + (route == "fma")),
                f"{tag}: launched the wrong route")
            check(out.shape == want.shape and out.dtype == dt,
                  f"{tag}: {tuple(out.shape)} {out.dtype}")
            check(bool(torch.isfinite(out).all()), f"{tag}: non-finite")
            e = float((out.float() - want.float()).abs().max())
            key = f"{name}_{route}"
            err[key] = max(err.get(key, 0.0), e)
            check(e <= FLASH_TOL[name], f"{tag}: max |kernel - plain| = {e}")
            line = f"  {tag}: max_abs_err={e:.3e}"
            if route == "wgmma":
                # the Pallas kernel's function keeps P in f32: the kernel
                # is held to the reference's tolerance against that too
                e32 = float((out.float() - ref.reference_attention(
                    q, k, v, **kw).float()).abs().max())
                err["bfloat16_wgmma_vs_f32p"] = max(
                    err.get("bfloat16_wgmma_vs_f32p", 0.0), e32)
                check(e32 <= FLASH_TOL[name],
                      f"{tag}: max |kernel - plain with P in f32| = {e32}")
                line += f" (vs P in f32: {e32:.3e})"
            print(line, flush=True)

    B, S, H, Kh, D = PREFILL
    q, k, v = qkv(B, S, S, H, Kh, D, torch.bfloat16)
    check(ops.route(q.dtype, D) == "wgmma", "the prefill shape is not on "
          "the wgmma route")

    def kernel():
        return ops.flash_attention(q, k, v, causal=True)

    def plain_bf16p():
        return ref.reference_attention(q, k, v, causal=True,
                                       p_dtype=torch.bfloat16)

    # the yardstick: one PyTorch call over [B, H, S, D] with the K/V heads
    # repeated outside the timed calls; the port never calls it
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(H // Kh, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(H // Kh, dim=2).transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    out, want = kernel(), plain_bf16p()
    want_f32p = ref.reference_attention(q, k, v, causal=True)
    lib_out = library().transpose(1, 2)
    # the planted fault: rows past the first tile lose keys 0..63 (the
    # top-left causal alignment makes the plain version on q, k, v from
    # key 64 on exactly that)
    fault = want.clone()
    fault[:, 64:] = ref.reference_attention(q[:, 64:], k[:, 64:], v[:, 64:],
                                            causal=True,
                                            p_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    e = float((out.float() - want.float()).abs().max())
    rel = rel_l2(out, want)
    rel_f32p, rel_lib = rel_l2(out, want_f32p), rel_l2(lib_out, want)
    rel_fault = rel_l2(fault, want)
    print(f"  prefill shape B={B} S={S}: kernel vs plain (P in bf16) "
          f"max_abs_err={e:.3e} rel_l2={rel:.4e}; kernel vs plain with P in "
          f"f32 rel_l2={rel_f32p:.4e};"
          f" sdpa vs plain rel_l2={rel_lib:.4e}; planted fault vs plain "
          f"rel_l2={rel_fault:.4e}; limit {FLASH_REL_L2}", flush=True)
    check(e <= FLASH_TOL["bfloat16"],
          f"prefill shape: max |kernel - plain| = {e}")
    for name, r in (("plain", rel), ("plain with P in f32", rel_f32p)):
        check(r <= FLASH_REL_L2, f"prefill shape: kernel vs {name} relative "
              f"L2 {r} > {FLASH_REL_L2}")
    check(rel_fault > FLASH_REL_L2, f"prefill shape: the planted fault's "
          f"relative L2 {rel_fault} is within {FLASH_REL_L2}")
    del out, want, want_f32p, lib_out, fault
    # the kernel's device time comes from phase 6's profiled prefill (32
    # launches among the model's other kernels): profiling back-to-back
    # launches of this kernel alone kept only some of them.  Turns:
    # library, kernel, kernel, library
    l_ms1 = cuda_ms(library, reps=5, inner=4)
    k_ms1 = cuda_ms(kernel, reps=5, inner=4)
    k_ms2 = cuda_ms(kernel, reps=5, inner=4)
    l_ms2 = cuda_ms(library, reps=5, inner=4)
    k_ms, l_ms = min(k_ms1, k_ms2), min(l_ms1, l_ms2)
    p_ms = cuda_ms(plain_bf16p, reps=3, inner=2)
    b_ms, b_by, flops = flash_bound(B, S, S, H, Kh, D, True, 2,
                                    BF16_FLOPS_PER_S)
    print(f"  prefill shape B={B} S={S} H={H} Kh={Kh} D={D} causal bf16 on "
          f"{card}: kernel_ms={k_ms:.4f} ({k_ms1:.4f}, {k_ms2:.4f}) "
          f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
          f"({l_ms1:.4f}, {l_ms2:.4f}) bound_ms={b_ms:.4f} ({b_by}; "
          f"{flops / 1e9:.1f} GFLOP) achieved={flops / k_ms / 1e9:.2f} "
          f"TFLOP/s (bound share {b_ms / k_ms:.4f}); kernel / library {k_ms / l_ms:.3f}", flush=True)
    check(k_ms <= FLASH_LIBRARY_FACTOR * l_ms, f"prefill shape: the kernel's "
          f"{k_ms:.4f} ms is more than {FLASH_LIBRARY_FACTOR}x the library "
          f"call's {l_ms:.4f} ms")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # the prefill_32k shape: the kernel over all heads, held against the
    # plain version one head at a time (4.3 GB of float32 scores each) on
    # the first and the last KV group
    S = LONG_S
    q, k, v = qkv(1, S, S, H, Kh, D, torch.bfloat16)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = ops.flash_attention(q, k, v, causal=True)
    end.record()
    end.synchronize()
    rep = H // Kh
    d2 = w2 = 0.0
    e_long = 0.0
    for g in (0, Kh - 1):
        kg, vg = k[:, :, g:g + 1], v[:, :, g:g + 1]
        for h in range(g * rep, (g + 1) * rep):
            want = ref.reference_attention(q[:, :, h:h + 1], kg, vg,
                                           causal=True,
                                           p_dtype=torch.bfloat16).float()
            diff = out[:, :, h:h + 1].float() - want
            d2 += float(diff.square().sum())
            w2 += float(want.square().sum())
            e_long = max(e_long, float(diff.abs().max()))
            if h == 0:
                fault = want.clone()
                fault[:, 64:] = ref.reference_attention(
                    q[:, 64:, :1], kg[:, 64:], vg[:, 64:], causal=True,
                    p_dtype=torch.bfloat16)
                rel_fault_long = rel_l2(fault, want)
            del want, diff
    rel_long = math.sqrt(d2 / w2)
    print(f"  prefill_32k shape B=1 S={S} H={H} Kh={Kh} D={D} causal bf16, "
          f"heads of KV groups 0 and {Kh - 1}: max_abs_err={e_long:.3e} "
          f"rel_l2={rel_long:.4e}; planted fault (head 0) rel_l2="
          f"{rel_fault_long:.4e}; one call {start.elapsed_time(end):.3f} ms "
          f"(CUDA events, first call at this shape)", flush=True)
    check(e_long <= FLASH_TOL["bfloat16"],
          f"prefill_32k shape: max |kernel - plain| = {e_long}")
    check(rel_long <= FLASH_REL_L2, f"prefill_32k shape: kernel vs plain "
          f"relative L2 {rel_long} > {FLASH_REL_L2}")
    check(rel_fault_long > FLASH_REL_L2, f"prefill_32k shape: the planted "
          f"fault's relative L2 {rel_fault_long} is within {FLASH_REL_L2}")
    del q, k, v, out, fault
    return {"max_abs_err": e, "rel_l2": rel, "err": err, "ms": k_ms,
            "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": [B, PREFILL[1], PREFILL[1], H, Kh, D],
            "max_abs_err_32k": e_long, "rel_l2_32k": rel_long}


def profile_report(what: str, wall_s: float, by_name: dict, calls: int,
                   kernels=("flash_wgmma_kernel",), label: str = "flash"):
    """Print a profiled run's device busy time, idle share, kernel count
    and top kernels; fails unless the profile holds exactly the run's
    ``calls`` launches of ``kernels[0]`` (one per wrapper call), and
    returns the device ms per call of all ``kernels`` (a wrapper's
    passes) together (None when ``calls`` is 0)."""
    busy = sum(t for t, _ in by_name.values()) / 1e6
    ours = lambda n: any(k in n for k in kernels)          # noqa: E731
    k_s = sum(t for n, (t, _) in by_name.items() if ours(n)) / 1e6
    k_n = sum(k for n, (_, k) in by_name.items() if kernels[0] in n)
    print(f"  {what} under torch.profiler: wall={wall_s:.3f}s device "
          f"busy={busy:.4f}s idle share={1 - busy / wall_s:.4f} device "
          f"events={sum(k for _, k in by_name.values())}; {label} "
          f"kernel={k_s:.4f}s (share of device time "
          f"{k_s / busy if busy else float('nan'):.4f})", flush=True)
    for n, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"    {t / 1e3:10.3f}ms {k:6d}x {n[:90]}")
    check(k_n == calls, f"{what}: the profile holds {k_n} {label} kernel "
          f"launches, want {calls}")
    return k_s * 1e3 / calls if calls else None


def phase_prefill(card: str, flash: dict):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.common import tree_flatten
    from repro_torch.models.model import Model
    from repro_torch.runconfig import RunConfig

    cfg = get_config("yi-6b")
    B, S = PREFILL[:2]
    print(f"== phase 6: Model(yi-6b: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}).prefill at B={B} S={S}, "
          f"'flash' vs 'reference'; {DECODE_STEPS} greedy decode steps; "
          "the prefill_32k cell", flush=True)
    m = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = m.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    print(f"random bf16 weights made on the card: {n_params} parameters in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rc_flash = RunConfig(attention_impl="flash")
    rc_ref = RunConfig(attention_impl="reference")

    def prefill(tokens, rc, route="wgmma"):
        """One prefill; a flash one must launch the kernel of ``route``
        once per layer and the other kernel never."""
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, st = m.prefill(params, {"tokens": tokens},
                               tokens.shape[1] + 64, rc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (ops.launches, ops.launches_wgmma, ops.launches_fma)
        n = cfg.n_layers if rc.attention_impl == "flash" else 0
        want = (n, n * (route == "wgmma"), n * (route == "fma"))
        check(got == want, f"{rc.attention_impl} prefill at S="
              f"{tokens.shape[1]}: (all, wgmma, fma) flash launches {got}, "
              f"want {want}")
        check(bool(torch.isfinite(logits).all()),
              f"{rc.attention_impl} prefill: non-finite logits")
        return logits, st, wall

    def compare(a, b):
        d = (a - b).abs()
        return (float(d.norm() / b.norm()), float(d.max()),
                float((a.argmax(-1) == b.argmax(-1)).float().mean()))

    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    _, _, wall_warm = prefill(tokens, rc_flash)   # first use of each shape
    lf, st, wall = prefill(tokens, rc_flash)
    launches_4k = {"launches": ops.launches,     # the main path's bf16 prefill
                   "launches_wgmma": ops.launches_wgmma,
                   "launches_fma": ops.launches_fma}
    lc, _, wall_chunk = prefill(tokens, RunConfig(attention_impl="chunked"))
    lr, _, wall_ref = prefill(tokens, rc_ref)
    print(f"prefill B={B} S={S} bf16 on {card}: flash wall={wall:.3f}s "
          f"({B * S / wall:.1f} tok/s; first call {wall_warm:.3f}s), "
          f"chunked wall={wall_chunk:.3f}s, reference wall={wall_ref:.3f}s; "
          f"max|ref logit|={float(lr.abs().max()):.3f}", flush=True)
    for name, a, b in (("flash vs reference", lf, lr),
                       ("chunked vs reference", lc, lr),
                       ("flash vs chunked", lf, lc)):
        print("  last-token logits %s: rel_l2=%.4e max_abs=%.4e "
              "argmax_agreement=%s" % ((name,) + compare(a, b)), flush=True)
    rel = compare(lf, lr)[0]
    check(rel <= LOGIT_REL_L2_BF16, f"bf16 prefill logits: flash vs "
          f"reference relative L2 {rel} > {LOGIT_REL_L2_BF16}")
    del lc
    (_, _, wall_p), by_name = whole_profile(
        lambda: prefill(tokens, rc_flash), FLASH_COUNTED,
        what=f"prefill B={B} S={S}", resets=True)
    flash_dev_ms = profile_report(f"prefill B={B} S={S}", wall_p, by_name,
                                  cfg.n_layers)

    before = ops.launches
    tok = lf[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        logits, st = m.decode_step(params, tok, st, rc_flash)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), "decode: non-finite logits")
    check(bool((st.pos == S + DECODE_STEPS).all()),
          f"decode: pos {st.pos.tolist()}")
    check(ops.launches == before, "decode_step launched the flash kernel")
    print(f"{DECODE_STEPS} greedy decode steps at B={B} from S={S}: "
          f"{dt / DECODE_STEPS * 1e3:.3f} ms/step, "
          f"{B * DECODE_STEPS / dt:.1f} tok/s; last tokens "
          f"{tok[:, 0].tolist()}", flush=True)

    def one_step():
        t0 = time.perf_counter()
        m.decode_step(params, tok, st, rc_flash)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall_p, by_name = whole_profile(one_step, what="one decode step")
    profile_report(f"one decode step B={B} at pos {S + DECODE_STEPS}",
                   wall_p, by_name, 0)
    del lf, lr, st, logits

    # the prefill_32k cell at one card's share: its work is (32768² · 1) /
    # (4096² · 2) = 32 times the prefill shape's per layer
    projected = flash["ms"] * (LONG_S ** 2 / (B * S ** 2)) \
        * cfg.n_layers / 1e3
    s_long = LONG_S if projected <= LONG_LIMIT_S else LONG_S_CUT
    print(f"prefill_32k: the kernel's {flash['ms']:.3f} ms at S={S} "
          f"projects {projected:.1f} s of flash time at S={LONG_S}; "
          f"running S={s_long}", flush=True)
    tokens_4k = tokens
    tokens = torch.randint(1, cfg.vocab_size, (1, s_long), generator=gen,
                           device="cuda", dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    _, _, wall_l = prefill(tokens, rc_flash)
    launches_long = ops.launches
    print(f"prefill B=1 S={s_long} on {card}: wall={wall_l:.3f}s "
          f"({s_long / wall_l:.1f} tok/s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    (_, _, wall_p), by_name = whole_profile(
        lambda: prefill(tokens, rc_flash), FLASH_COUNTED,
        what=f"prefill B=1 S={s_long}", resets=True)
    profile_report(f"prefill B=1 S={s_long}", wall_p, by_name, cfg.n_layers)
    del params
    torch.cuda.empty_cache()

    # the same prefill with float32 weights: the kernel's f32 path against
    # the reference attention, both in full float32
    params = m.init(seed=0, dtype=torch.float32)
    tokens = tokens_4k
    f32 = dict(kv_cache_dtype="float32")
    lf, _, wall32 = prefill(tokens, RunConfig(attention_impl="flash", **f32),
                            route="fma")
    lr, _, _ = prefill(tokens, RunConfig(attention_impl="reference", **f32))
    rel, mx, agree = compare(lf, lr)
    print(f"prefill B={B} S={S} float32 weights: flash wall={wall32:.3f}s "
          f"({cfg.n_layers} FMA-kernel launches); "
          f"last-token logits flash vs reference: rel_l2={rel:.4e} "
          f"max_abs={mx:.4e} argmax_agreement={agree}", flush=True)
    check(mx <= LOGIT_ATOL_F32, f"f32 prefill logits: flash vs reference "
          f"max |diff| {mx} > {LOGIT_ATOL_F32}")
    return {**launches_4k, "launches_long": launches_long,
            "long_s": s_long, "device_ms": flash_dev_ms}


def phase_engine(card: str):
    from repro_torch.launch import serve

    argv = ["--arch", "yi-6b", "--full", "--device", "cuda"]
    print("== phase 7: python -m repro_torch.launch.serve " + " ".join(argv)
          + " (default traffic: 12 requests, prompts 4-23 tokens, 4 slots,"
          " s_max 128, 16 new tokens)", flush=True)
    res = serve.main(argv)
    check(res["requests"] == 12 and res["tokens"] == 12 * 16,
          f"engine served {res['requests']} requests, {res['tokens']} "
          "tokens")
    check(all(r.done and len(r.out_tokens) == 16 for r in res["finished"]),
          "engine: a request did not finish with 16 tokens")
    print(f"engine on {card}: {res['requests']} requests, {res['tokens']} "
          f"tokens, {res['tokens'] / res['wall_s']:.2f} tok/s, "
          f"{res['steps']} engine steps, "
          f"{res['wall_s'] / res['steps'] * 1e3:.3f} ms per step "
          "(decode_step + host scheduling)", flush=True)


def mlstm_bound(B, S, H, P, chunk, itemsize, flops_per_s):
    """(bound_ms, bound_by, flops) of an mLSTM forward launch from the
    wrapper's own count (``ops.fwd_work``)."""
    from repro_torch.kernels.mlstm_chunk import ops
    return _bound(*ops.fwd_work(B, S, H, P, chunk, itemsize), flops_per_s)


def phase_mlstm(card: str):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.mlstm_chunk import ops, ref

    print("== phase 8: mLSTM kernels vs plain torch on the card", flush=True)
    for name in MLSTM_PASSES:
        print(f"ptxas, the wgmma route's {name}:\n" + ptxas_summary(
            ops._LIBS["wgmma"].report, name), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def inputs(B, S, H, P, dtype, scale=0.5):
        """The reference test's distributions, drawn on the card."""
        def n(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        q, k, v = (n(B, S, H, P) * scale, n(B, S, H, P) * scale / P ** 0.5,
                   n(B, S, H, P) * scale)
        logi, logf = n(B, S, H), -F.softplus(-n(B, S, H) * 2.0)
        return [t.to(dtype) for t in (q, k, v)] + [logi, logf]

    err = {"float32": 0.0, "bfloat16": 0.0}
    for B, S, H, P, chunk in MLSTM_CASES + [MLSTM_F32_PATH_CASE]:
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            args = inputs(B, S, H, P, dt)
            route = ops.route(dt, P, min(chunk, S))
            before = (ops.launches_wgmma, ops.launches_fma)
            out = ops.mlstm_chunk(*args, chunk=chunk)
            plain = ops.plain_version(*args, chunk)
            oracle = ref.mlstm_sequential(*args)
            torch.cuda.synchronize()
            tag = f"{name} B={B} S={S} H={H} P={P} chunk={chunk} ({route})"
            check((ops.launches_wgmma, ops.launches_fma) == (
                before[0] + (route == "wgmma"), before[1] + (route == "fma")),
                f"{tag}: launched the wrong route")
            check(out.shape == plain.shape and out.dtype == dt,
                  f"{tag}: {tuple(out.shape)} {out.dtype}")
            check(bool(torch.isfinite(out.float()).all()),
                  f"{tag}: non-finite")
            e = max(float((out.float() - w.float()).abs().max())
                    for w in (plain, oracle))
            err[name] = max(err[name], e)
            if dt == torch.float32:
                check(e <= MLSTM_ATOL, f"{tag}: max |kernel - plain| = {e}")
            else:
                atol, rtol = MLSTM_BF16_TOL
                over = float(((out.float() - plain.float()).abs()
                              - atol - rtol * plain.float().abs()).max())
                check(over <= 0, f"{tag}: kernel exceeds atol {atol} + "
                      f"rtol {rtol} by {over}")
            print(f"  {tag}: max_abs_err={e:.3e} (vs chunkwise and "
                  "sequential plain versions)", flush=True)
    args = inputs(1, 256, 2, 32, torch.float32, scale=1.0)
    outs = [ops.mlstm_chunk(*args, chunk=c) for c in (32, 64, 256)]
    inv = max(float((o - outs[0]).abs().max()) for o in outs[1:])
    print(f"  chunk invariance (32/64/256, f32): max |diff| = {inv:.3e}",
          flush=True)
    check(inv <= 2e-4, f"chunk invariance: {inv} > 2e-4")

    B, S, H, P = MLSTM_LAYER
    args = inputs(B, S, H, P, torch.bfloat16)
    res, res_fma = {}, {}
    for chunk in MLSTM_CHUNKS:
        check(ops.route(torch.bfloat16, P, chunk) == "wgmma",
              f"the layer shape at chunk {chunk} is not on the wgmma route")
        before = (ops.launches_wgmma, ops.launches_fma)
        out = ops.mlstm_chunk(*args, chunk=chunk)
        # the FMA kernel at the same inputs: it still serves every float32
        # prefill, and its plain version is the float32 one
        out_fma = ops._fma(*args, chunk)
        want = ops.plain_version(*args, chunk)
        want32 = ref.mlstm_chunkwise(*args, chunk)
        torch.cuda.synchronize()
        check((ops.launches_wgmma, ops.launches_fma) == (
            before[0] + 1, before[1] + 1),
            f"layer shape chunk={chunk}: not one launch of each kernel")
        res[chunk] = (float((out.float() - want.float()).abs().max()),
                      rel_l2(out, want), rel_l2(out, want32))
        res_fma[chunk] = (float((out_fma.float() - want32.float()).abs()
                                .max()), rel_l2(out_fma, want32))
        if chunk == MLSTM_CHUNKS[0]:
            # the planted fault: every chunk loses its inter-chunk term
            # (each chunk run alone, from a zero carry)
            fault = torch.cat([ref.mlstm_chunkwise(
                *(t[:, i:i + chunk] for t in args), chunk)
                for i in range(0, S, chunk)], dim=1)
            rel_fault = (rel_l2(fault, want), rel_l2(fault, want32))
            del fault
        print(f"  layer shape B={B} S={S} H={H} P={P} bf16 chunk={chunk} "
              f"(wgmma): kernel vs plain max_abs_err={res[chunk][0]:.3e} "
              f"rel_l2={res[chunk][1]:.4e} (limit {MLSTM_REL_L2}); vs the "
              f"float32 version rel_l2={res[chunk][2]:.4e} (limit "
              f"{MLSTM_REL_L2_F32})", flush=True)
        print(f"  layer shape B={B} S={S} H={H} P={P} bf16 chunk={chunk} "
              f"(FMA kernel): vs its plain version (float32) max_abs_err="
              f"{res_fma[chunk][0]:.3e} rel_l2={res_fma[chunk][1]:.4e} "
              f"(limit {MLSTM_REL_L2})", flush=True)
        for tag, o in (("wgmma", out), ("FMA", out_fma)):
            check(bool(torch.isfinite(o.float()).all()),
                  f"layer shape chunk={chunk} ({tag}): non-finite")
        check(res_fma[chunk][1] <= MLSTM_REL_L2, f"layer shape chunk="
              f"{chunk}: the FMA kernel's relative L2 {res_fma[chunk][1]} > "
              f"{MLSTM_REL_L2}")
        check(res[chunk][1] <= MLSTM_REL_L2, f"layer shape chunk={chunk}: "
              f"relative L2 {res[chunk][1]} > {MLSTM_REL_L2}")
        check(res[chunk][2] <= MLSTM_REL_L2_F32, f"layer shape chunk="
              f"{chunk}: relative L2 against the float32 version "
              f"{res[chunk][2]} > {MLSTM_REL_L2_F32}")
        del out, out_fma, want, want32
    # the fault is held against the float32 version at the larger limit,
    # so it also stays above the FMA kernel's
    print(f"  planted fault (no inter-chunk term, chunk {MLSTM_CHUNKS[0]}) "
          f"rel_l2 vs plain={rel_fault[0]:.4e}, vs the float32 version="
          f"{rel_fault[1]:.4e}", flush=True)
    check(rel_fault[0] > MLSTM_REL_L2, f"the planted fault's relative L2 "
          f"{rel_fault[0]} is within {MLSTM_REL_L2}")
    check(rel_fault[1] > max(MLSTM_REL_L2, MLSTM_REL_L2_F32), f"the "
          f"planted fault's relative L2 {rel_fault[1]} against the float32 "
          f"version is within {max(MLSTM_REL_L2, MLSTM_REL_L2_F32)}")
    chunk = MLSTM_CHUNKS[0]

    # one timing window each, the same for all three (the passes' device
    # times come from phase 9's profiled prefill)
    k_ms = cuda_ms(lambda: ops.mlstm_chunk(*args, chunk=chunk), reps=5,
                   inner=4)
    f_ms = cuda_ms(lambda: ops._fma(*args, chunk), reps=5, inner=4)
    p_ms = cuda_ms(lambda: ops.plain_version(*args, chunk), reps=5, inner=4)
    b_ms, b_by, flops = mlstm_bound(B, S, H, P, chunk, 2, BF16_FLOPS_PER_S)
    print(f"  layer shape B={B} S={S} H={H} P={P} chunk={chunk} bf16 on "
          f"{card}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"fma_kernel_ms={f_ms:.4f} library_ms=none bound_ms={b_ms:.4f} "
          f"({b_by}; {flops / 1e9:.1f} GFLOP) achieved="
          f"{flops / k_ms / 1e9:.2f} TFLOP/s (bound share "
          f"{b_ms / k_ms:.4f})", flush=True)
    check(k_ms <= MLSTM_MAX_MS, f"layer shape: the wgmma kernel's "
          f"{k_ms:.4f} ms per call is over {MLSTM_MAX_MS} ms")
    del args
    return {"max_abs_err": res[chunk][0], "rel_l2": res[chunk][1],
            "rel_l2_f32": res[chunk][2], "err": err, "ms": k_ms,
            "plain_ms": p_ms, "fma_ms": f_ms, "bound_ms": b_ms,
            "bound_by": b_by, "shape": [B, S, H, P, chunk],
            "max_abs_err_fma": res_fma[chunk][0],
            "rel_l2_fma": res_fma[chunk][1],
            f"rel_l2_chunk{MLSTM_CHUNKS[1]}": res[MLSTM_CHUNKS[1]][1],
            f"rel_l2_fma_chunk{MLSTM_CHUNKS[1]}":
                res_fma[MLSTM_CHUNKS[1]][1],
            f"rel_l2_f32_chunk{MLSTM_CHUNKS[1]}": res[MLSTM_CHUNKS[1]][2],
            "rel_l2_fault": rel_fault[0], "rel_l2_f32_fault": rel_fault[1]}


def phase_xlstm(card: str):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mlstm_chunk import ops
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_flatten
    from repro_torch.models.config import MLSTM, SLSTM
    from repro_torch.models.model import Model
    from repro_torch.runconfig import RunConfig

    cfg = get_config("xlstm-1.3b").scaled(n_layers=XLSTM_PREFILL_LAYERS)
    n_mlstm = sum(sp.kind == MLSTM for sp in cfg.pattern) * cfg.n_groups
    n_slstm = sum(sp.kind == SLSTM for sp in cfg.pattern) * cfg.n_groups
    B, S = XLSTM_PREFILL
    print(f"== phase 9: Model(xlstm-1.3b: {cfg.n_layers} of 48 layers = "
          f"{n_mlstm} mLSTM + {n_slstm} sLSTM, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, mlstm_expand {cfg.mlstm_expand}, vocab "
          f"{cfg.vocab_size}).prefill at B={B} S={S}; {DECODE_STEPS} "
          "greedy decode steps; float32 prefill vs teacher-forced decode",
          flush=True)
    m = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = m.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    print(f"random bf16 weights made on the card: {n_params} parameters in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    # the output pass first: one launch per wrapper call on the wgmma
    # route; then the FMA kernel's two passes
    mlstm_kernels = ("mlstm_chunk_out_kernel", "mlstm_chunk_state_kernel",
                     "mlstm_chunk_gates_kernel", "mlstm_chunk_chain_kernel",
                     "mlstm_chunk_kernel", "mlstm_qk_kernel")

    def prefill(p, tokens, rc, route="wgmma"):
        ops.reset_launch_counts()
        flash_ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, st = m.prefill(p, {"tokens": tokens},
                               tokens.shape[1] + DECODE_STEPS, rc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = (n_mlstm, n_mlstm if route == "wgmma" else 0,
                n_mlstm if route == "fma" else 0)
        got = (ops.launches, ops.launches_wgmma, ops.launches_fma)
        check(got == want, f"xlstm prefill at S={tokens.shape[1]}: "
              f"(all, wgmma, fma) mLSTM launches {got}, want {want}")
        check(flash_ops.launches == 0, "xlstm prefill launched flash")
        check(bool(torch.isfinite(logits).all()),
              "xlstm prefill: non-finite logits")
        return logits, st, wall

    rc = RunConfig()
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    _, _, wall_warm = prefill(params, tokens, rc)
    torch.cuda.reset_peak_memory_stats()
    logits, st, wall = prefill(params, tokens, rc)
    launches = {"launches": ops.launches,    # the main path's bf16 prefill
                "launches_wgmma": ops.launches_wgmma,
                "launches_fma": ops.launches_fma}
    print(f"prefill B={B} S={S} bf16 chunk={rc.mlstm_chunk} on {card}: "
          f"wall={wall:.3f}s ({B * S / wall:.1f} tok/s; first call "
          f"{wall_warm:.3f}s); mLSTM kernel launches {launches}",
          flush=True)

    # the sLSTM time loops' share of the wall: each loop timed between
    # device syncs in one more prefill
    slstm_s = []
    plain_slstm = transformer._slstm_prefill

    def timed_slstm(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_slstm(*a, **k)
        torch.cuda.synchronize()
        slstm_s.append(time.perf_counter() - t0)
        return out

    transformer._slstm_prefill = timed_slstm
    try:
        _, _, wall_t = prefill(params, tokens, rc)
    finally:
        transformer._slstm_prefill = plain_slstm
    check(len(slstm_s) == n_slstm, f"{len(slstm_s)} sLSTM loops timed")
    print(f"  the {n_slstm} sLSTM time loops ({S} steps each): "
          f"{sum(slstm_s):.3f}s of a {wall_t:.3f}s prefill (share "
          f"{sum(slstm_s) / wall_t:.4f}; per loop "
          f"{min(slstm_s):.3f}-{max(slstm_s):.3f}s)", flush=True)

    t0 = time.perf_counter()
    (_, _, wall_p), by_name = whole_profile(
        lambda: prefill(params, tokens, rc),
        [(name, lambda: ops.launches_wgmma, 1) for name in MLSTM_PASSES],
        cpu=False, what=f"xlstm prefill B={B} S={S}", resets=True)
    t_read = time.perf_counter() - t0 - wall_p
    dev_ms = profile_report(f"prefill B={B} S={S}", wall_p, by_name,
                            n_mlstm, kernels=mlstm_kernels, label="mLSTM")
    pass_ms = {}
    for name in MLSTM_PASSES:
        t_us, count = (sum(v[i] for n, v in by_name.items() if name in n)
                       for i in (0, 1))
        check(count == n_mlstm, f"the prefill's profile holds {count} "
              f"launches of {name}, want {n_mlstm}")
        pass_ms[name] = t_us / count / 1e3
    print(f"  mLSTM kernel device ms per launch: {dev_ms:.4f} (" + ", ".join(
        f"{n} {t:.4f}" for n, t in pass_ms.items())
        + f"); profile read in {t_read:.1f}s", flush=True)

    before = ops.launches
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        logits, st = m.decode_step(params, tok, st, rc)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), "decode: non-finite logits")
    check(bool((st.pos == S + DECODE_STEPS).all()),
          f"decode: pos {st.pos.tolist()}")
    check(ops.launches == before, "decode_step launched the mLSTM kernel")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{DECODE_STEPS} greedy decode steps at B={B} from S={S}: "
          f"{dt / DECODE_STEPS * 1e3:.3f} ms/step, "
          f"{B * DECODE_STEPS / dt:.1f} tok/s; last tokens "
          f"{tok[:, 0].tolist()}; peak device memory {peak:.2f} GiB "
          "(prefill + decode)", flush=True)

    def one_step():
        t0 = time.perf_counter()
        m.decode_step(params, tok, st, rc)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall_p, by_name = whole_profile(one_step, what="one xlstm decode step")
    profile_report(f"one decode step B={B} at pos {S + DECODE_STEPS}",
                   wall_p, by_name, 0, kernels=mlstm_kernels, label="mLSTM")
    check(not any(k in n for n in by_name for k in mlstm_kernels),
          "a decode step ran an mLSTM kernel")
    del params, st, logits
    torch.cuda.empty_cache()

    # float32 weights: the prefill (the kernel, several chunks) against
    # teacher-forced decode (the sequential recurrence, no kernel)
    params = m.init(seed=0, dtype=torch.float32)
    rc32 = RunConfig(param_dtype="float32", activation_dtype="float32",
                     mlstm_chunk=XLSTM_CHECK_CHUNK)
    toks = torch.randint(1, cfg.vocab_size, (1, XLSTM_CHECK_S),
                         generator=gen, device="cuda", dtype=torch.int32)

    def prefill_vs_decode():          # float32: the FMA kernel
        lp, _, _ = prefill(params, toks, rc32, route="fma")
        ds = m.init_decode_state(1, XLSTM_CHECK_S + 1, rc32)
        for t in range(XLSTM_CHECK_S):
            ld, ds = m.decode_step(params, toks[:, t:t + 1], ds, rc32)
        d = (lp - ld).float()
        return (float(d.norm() / ld.float().norm()), float(d.abs().max()),
                bool(lp.argmax() == ld.argmax()),
                float(ld.abs().max()))

    t0 = time.perf_counter()
    rel0, mx0, agree0, mag0 = prefill_vs_decode()
    print(f"float32 prefill (S={XLSTM_CHECK_S}, chunk {XLSTM_CHECK_CHUNK}) "
          f"vs teacher-forced decode, weights as initialised: last-token "
          f"logits rel_l2={rel0:.4e} max_abs={mx0:.4e} (max |logit| "
          f"{mag0:.3f}) argmax_agreement={agree0}; recorded, no limit "
          f"(chaotic sLSTM recurrence); {time.perf_counter() - t0:.1f}s",
          flush=True)
    for p in params["layers"]:
        if "slstm" in p:
            p["slstm"]["w_rec"].mul_(XLSTM_WREC_SCALE)
    rel1, mx1, agree1, mag1 = prefill_vs_decode()
    print(f"  with the sLSTM recurrent weights x{XLSTM_WREC_SCALE}: "
          f"rel_l2={rel1:.4e} max_abs={mx1:.4e} (max |logit| {mag1:.3f}) "
          f"argmax_agreement={agree1}; limit rel_l2 {XLSTM_LOGIT_REL_L2}",
          flush=True)
    check(rel1 <= XLSTM_LOGIT_REL_L2, f"f32 prefill vs teacher-forced "
          f"decode: relative L2 {rel1} > {XLSTM_LOGIT_REL_L2}")
    return {**launches, "device_ms": dev_ms, "pass_device_ms": pass_ms}


def service_local_run(workload: str, budget: int, seed: int, cfg: dict,
                      device: str):
    """One client tuning alone (``benchmarks/perf_tuning_service.py``'s
    baseline): a local ``run_async`` on an immediate service over a fresh
    evaluator.  Returns (trace, evaluator calls)."""
    from repro_torch.core.controller import Controller, EvalDB
    from repro_torch.core.service import ImmediateEvaluationService
    from repro_torch.core.strategy import BOConfig, make_strategy
    from repro_torch.service import default_catalog
    space, backend = default_catalog()[workload].build()
    strat = make_strategy("bo", space, budget=budget, seed=seed,
                          cfg=BOConfig(**cfg, device=device))
    ctrl = Controller(ImmediateEvaluationService(backend), db=EvalDB(),
                      tag="bo", workload=workload, seed=seed)
    trace = ctrl.run_async(strat, budget=budget, max_in_flight=1,
                           min_ask=1)
    return trace, backend.calls


def service_daemon(device: str, cfg: dict, clients: int = SERVICE_CLIENTS):
    """The daemon on ``device`` behind HTTP on 127.0.0.1, ``clients``
    ``TuningClient`` threads each creating a session on one of
    ``SERVICE_WORKLOADS`` (alternating) and having the server drive it.
    Returns (server, httpd, url, {client: (workload, reply)}, wall s)."""
    import threading
    from repro_torch.service import (TuningClient, TuningServer,
                                     default_catalog, serve_background)
    from repro_torch.service.server import _analytic_spec
    catalog = default_catalog()
    target = _analytic_spec(TRANSFER_ARCH, TRANSFER_SHAPE)
    catalog[target.name] = target
    srv = TuningServer(catalog, max_workers=4, device=device)
    httpd, _ = serve_background(srv, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_port}"
    budget = cfg["n_init"] + cfg["n_iter"]
    replies, errors = {}, []

    def client(i: int):
        wl = SERVICE_WORKLOADS[i % len(SERVICE_WORKLOADS)]
        try:
            sess = TuningClient(url).create_session(
                wl, budget=budget, seed=SERVICE_SEED,
                strategy_kwargs={"cfg": cfg})
            replies[i] = (wl, sess.run())
        except Exception as e:             # reported below, fails the run
            errors.append(f"client {i}: {e!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,), name=f"client-{i}")
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not errors, f"daemon clients failed: {errors}")
    return srv, httpd, url, replies, wall


def transfer_folds(device: str, budget: int = FOLD_BUDGET,
                   fit_steps: int = 40, corpus_fit_steps: int = 100,
                   seed: int = 7):
    """``benchmarks/perf_transfer.py``'s full leave-one-out folds through
    the port on ``device``: rank once on the donor-only arch, tune every
    arch from scratch (each run is its fold's baseline and the others'
    corpus), the no-corpus identity, then per fold a ``transfer_bo`` run
    on the corpus of the other archs.  Returns the per-fold results and
    whether the identity held."""
    import numpy as np
    from dataclasses import replace
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import ranking
    from repro_torch.core.controller import EvalRecord
    from repro_torch.core.costmodel import SINGLE_POD
    from repro_torch.core.evaluators import AnalyticEvaluator
    from repro_torch.core.knobs import clean_space
    from repro_torch.core.strategy import BOConfig, BOStrategy, make_strategy
    from repro_torch.models.config import SHAPES_BY_NAME
    from repro_torch.transfer import (TransferBOStrategy, TransferCorpus,
                                      build_corpus, space_signature)

    def drive(strategy, f):
        while not strategy.finished:
            cfgs = strategy.ask()
            if not cfgs:
                break
            strategy.tell(cfgs, [f(c) for c in cfgs])
        return strategy.trace

    def objective(space, ev, base):
        def f(c):
            full = dict(base)
            full.update(c)
            return float(ev(space.project(full)))
        return f

    cfg = BOConfig(n_init=6, n_iter=budget - 6, n_candidates=256,
                   fit_steps=fit_steps, seed=seed, device=device)
    tcfg = replace(cfg, n_init=3, n_iter=budget - 3, local_sigma=0.02)
    archs = (FOLD_RANK_ARCH,) + FOLD_ARCHS
    work = {}
    for a in archs:
        space, _, _ = clean_space(get_smoke_config(a),
                                  SHAPES_BY_NAME["train_4k"], SINGLE_POD)
        ev = AnalyticEvaluator(get_smoke_config(a),
                               SHAPES_BY_NAME["train_4k"], SINGLE_POD,
                               noise_sigma=0.0, seed=0)
        work[a] = (space, ev, space.default_config())
    sig = space_signature(work[FOLD_RANK_ARCH][0])
    check(all(space_signature(w[0]) == sig for w in work.values()),
          "the fold archs do not share one space signature")
    t0 = time.perf_counter()
    rk = ranking.rank(work[FOLD_RANK_ARCH][0], work[FOLD_RANK_ARCH][1],
                      n_samples=300, seed=0, stability_rounds=8,
                      device=device)
    sub = rk.top_space(FOLD_TOP_K)
    rank_s = time.perf_counter() - t0
    scratch, records = {}, []
    t0 = time.perf_counter()
    for a in archs:
        f = objective(*work[a])
        trace = drive(make_strategy("bo", sub, budget=budget, cfg=cfg), f)
        scratch[a] = trace
        records += [EvalRecord(dict(c), float(v), 0.0, "scratch", a)
                    for c, v in zip(trace.configs, trace.values)]
    scratch_s = time.perf_counter() - t0
    f = objective(*work[FOLD_ARCHS[0]])
    plain = drive(BOStrategy(sub, tcfg), f)
    identical = True
    for corpus in (None, TransferCorpus(sub, [])):
        twin = drive(TransferBOStrategy(sub, tcfg, corpus=corpus), f)
        identical &= (twin.configs == plain.configs
                      and twin.values == plain.values)
    out = {}
    t0 = time.perf_counter()
    for target in FOLD_ARCHS:
        corpus = build_corpus(sub, [records], exclude=(target,))
        check(corpus.n_tasks == len(archs) - 1,
              f"fold {target}: corpus of {corpus.n_tasks} tasks")
        trace = drive(make_strategy("transfer_bo", sub, budget=budget,
                                    cfg=tcfg, corpus=corpus,
                                    corpus_fit_steps=corpus_fit_steps),
                      objective(*work[target]))
        best = min(scratch[target].values)
        matched = next((i + 1 for i, v in enumerate(trace.best_values)
                        if v <= best / FOLD_RATIO), None)
        out[target] = {"scratch_best": best,
                       "transfer_best": min(trace.values),
                       "evals_to_match": matched,
                       "transfer_best_values": list(trace.best_values),
                       "scratch_best_values": list(
                           scratch[target].best_values)}
    transfer_s = time.perf_counter() - t0
    return out, identical, {"rank_s": rank_s, "scratch_s": scratch_s,
                            "transfer_s": transfer_s, "top": rk.top(
                                FOLD_TOP_K)}


def chaos_arm(device: str, plan):
    """One BO session on yi-6b:train_4k behind a one-worker pool, under
    ``plan`` (or none), with retries; the daemon's barrier cadence.
    Returns (trace, injected counts)."""
    from repro_torch.core.controller import Controller, EvalDB
    from repro_torch.core.faults import FaultInjectingService
    from repro_torch.core.resilience import RetryPolicy
    from repro_torch.core.service import WorkerPoolEvaluationService
    from repro_torch.core.strategy import BOConfig, make_strategy
    from repro_torch.service import default_catalog
    space, backend = default_catalog()["yi-6b:train_4k"].build()
    inner = WorkerPoolEvaluationService(backend, max_workers=1)
    svc = inner if plan is None else FaultInjectingService(inner, plan)
    ctrl = Controller(svc, EvalDB(), tag="chaos", workload="yi-6b:train_4k",
                      seed=SERVICE_SEED,
                      resilience=RetryPolicy(max_attempts=8, backoff_s=0.0))
    strat = make_strategy("bo", space, budget=CHAOS_BUDGET,
                          seed=SERVICE_SEED, batch_size=CHAOS_WIDTH,
                          cfg=BOConfig(device=device))
    try:
        trace = ctrl.run_async(strat, batch_size=CHAOS_WIDTH,
                               max_in_flight=CHAOS_WIDTH,
                               min_ask=CHAOS_WIDTH)
        return trace, dict(getattr(svc, "injected", {}))
    finally:
        svc.close()


def gp_round_327(card: str):
    """One GP round of a daemon session at d = 327 (a 150-step fit at 56
    observations padded to 64, then the q = 1 pick over 2048 + 256 + 5·327
    candidates) under ``torch.profiler`` (a session that recorded every
    backward launch, ``whole_profile``): wall, device busy, idle share,
    and the Gram forward's (``matern52_kernel``: the fit's Gram and the
    pick's cross-Gram) and backward's shares of the device time."""
    import numpy as np
    import torch
    from repro_torch.core import gp
    from repro_torch.kernels.gp_gram import ops
    n, d = 56, SERVICE_GRAM[2]
    rng = np.random.default_rng(1)
    x = rng.random((n, d))
    y = np.log(1.0 + x[:, 0] + (x[:, 1] - 0.4) ** 2
               + 0.05 * rng.normal(size=n))
    cand = rng.random((SERVICE_CROSS[0], d)).astype(np.float32)
    y_raw = np.zeros(64, np.float32)
    y_raw[:n] = y

    def round_():
        st = gp.fit(x, y, steps=150, pad_to=64, use_kernel=True,
                    device="cuda")
        return gp.select_batch(st, cand, y_raw, n, float(y.min()), 1,
                               use_kernel=True).cpu()

    round_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    round_()
    torch.cuda.synchronize()
    wall_unprofiled = (time.perf_counter() - t0) * 1e3
    walls, rises = [], []

    def timed():
        before = (ops.gram_launches, ops.cross_launches,
                  ops.gram_bwd_launches)
        t0 = time.perf_counter()
        round_()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        rises.append((ops.gram_launches - before[0],
                      ops.cross_launches - before[1],
                      ops.gram_bwd_launches - before[2]))
    _, by_name = whole_profile(
        timed, (("matern52_gram_bwd_kernel", lambda: ops.gram_bwd_launches,
                 1),), what=f"GP round at d={d}")
    busy = sum(us for us, _ in by_name.values()) / 1e3
    check(busy > 0, "GP round at d=327: no device time profiled")
    wall = walls[-1]
    idle = 1 - busy / wall
    share = {kind: sum(us for name, (us, _) in by_name.items()
                       if key in name) / 1e3 / busy
             for kind, key in (("forward", "matern52_kernel"),
                               ("backward", "matern52_gram_bwd"))}
    gram, cross, bwd = rises[-1]
    print(f"GP round at d={d} (fit 150 steps [64,{d}], q=1 over "
          f"{SERVICE_CROSS[0]} candidates) on {card}: unprofiled wall "
          f"{wall_unprofiled:.3f} ms; profiled wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {idle:.4f}; Gram forward "
          f"(matern52_kernel: {gram} Gram + {cross} cross launches) "
          f"{share['forward']:.4f} and backward ({bwd} launches) "
          f"{share['backward']:.4f} of the device time", flush=True)
    return {"wall_ms": wall_unprofiled, "profiled_wall_ms": wall,
            "busy_ms": busy, "idle_share": idle,
            "forward_share": share["forward"],
            "backward_share": share["backward"],
            "launches": {"gram": gram, "cross": cross, "gram_bwd": bwd}}


def mtgp_fits(p0, x, tasks, y, extra, steps: int):
    """(graphed kernel fit, the same steps eager, the plain-autograd fit)
    of the multi-task GP from ``p0``."""
    from repro_torch.core import gp
    args = (p0, x, tasks, y, "matern52")
    return (gp._mt_fit(*args, steps=steps, extra_noise=extra,
                       use_kernel=True),
            gp._mt_fit(*args, steps=steps, extra_noise=extra,
                       use_kernel=True, graphed=False),
            gp._mt_fit(*args, steps=steps, extra_noise=extra,
                       use_kernel=False, graphed=False))


def mtgp_check(srv, sid: str, card: str, steps: int = 200):
    """The transfer session's multi-task prior, refit on its corpus from
    the same init: graphed, bit-equal to the session's prior and to the
    same steps run eagerly; device µs per graphed step.  The kernel fit
    against the plain-autograd fit: on that corpus recorded beside the
    fit's own sensitivity (the plain fit again with one float32 ulp added
    to 1 % of x), since the daemon's sessions repeat each other's probes
    and leave it ill-conditioned; held to ``PARAM_ATOL`` on a corpus of
    the same shape whose rows are distinct (two tasks of 64 at 327
    knobs)."""
    import numpy as np
    import torch
    from repro_torch.core import gp
    sess = srv.session(sid)
    strat = sess.strategy
    prior = strat._prior
    check(prior is not None and prior.multitask,
          f"transfer session {sid}: no multi-task prior")
    corpus = srv._build_transfer_corpus(sess.workload, strat.space, True)
    x, y, var, tasks = corpus.stacked(log_objective=strat.cfg.log_objective,
                                      max_per_task=64)
    obs = var if np.any(var > 0) else None
    dev = torch.device("cuda")
    xj, tj, yj, extra, _, _, off = gp._mt_prepare(x, y, tasks, obs, dev)
    p0 = gp.init_mt_params(x.shape[1], len(off), offsets=off, device=dev)
    graphed, eager, plain = mtgp_fits(p0, xj, tj, yj, extra, steps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    gp._mt_fit(p0, xj, tj, yj, "matern52", steps=steps, extra_noise=extra,
               use_kernel=True)
    end.record()
    end.synchronize()
    step_us = start.elapsed_time(end) / steps * 1e3
    check(all(torch.equal(a, b) for a, b in zip(graphed,
                                                 prior.state.params)),
          "the refit multi-task prior differs from the session's")
    check(all(torch.equal(a, b) for a, b in zip(graphed, eager)),
          "graphed multi-task fit differs from its eager steps")
    dev_p = max(float((a - b).abs().max()) for a, b in zip(graphed, plain))
    bump = torch.from_numpy(np.random.default_rng(0).random(x.shape)
                            < 0.01).to(dev)
    x_ulp = torch.where(bump, torch.nextafter(xj, torch.full_like(xj, 2.0)),
                        xj)
    plain_ulp = gp._mt_fit(p0, x_ulp, tj, yj, "matern52", steps=steps,
                           extra_noise=extra, use_kernel=False, graphed=False)
    floor = max(float((a - b).abs().max()) for a, b in zip(plain, plain_ulp))
    unique = len(np.unique(x, axis=0))
    print(f"transfer session {sid}: multi-task prior over "
          f"{corpus.workloads}, x [{x.shape[0]},{x.shape[1]}] ({unique} "
          f"distinct rows), T {corpus.n_tasks}; graphed fit ({steps} "
          f"steps) bit-equal to the session's prior and to its eager "
          f"steps; {step_us:.2f} us device per graphed step on {card}; "
          f"max |kernel fit - plain fit| = {dev_p:.3e}, |plain fit - plain "
          f"fit of x + 1 ulp on 1 %| = {floor:.3e} (both recorded)",
          flush=True)

    # the same shape with distinct rows: the kernel fit held to PARAM_ATOL
    rng = np.random.default_rng(1)
    xs = rng.random((128, x.shape[1]))
    ts = np.repeat(np.arange(2, dtype=np.int32), 64)
    ys = np.log(1.0 + xs[:, 0] + (xs[:, 1] - 0.4) ** 2 + 0.3 * ts
                + 0.05 * rng.normal(size=128))
    xd, td, yd, ed, _, _, od = gp._mt_prepare(xs, ys, ts, None, dev)
    q0 = gp.init_mt_params(xs.shape[1], 2, offsets=od, device=dev)
    g2, e2, p2 = mtgp_fits(q0, xd, td, yd, ed, steps)
    check(all(torch.equal(a, b) for a, b in zip(g2, e2)),
          "graphed multi-task fit differs from its eager steps (distinct "
          "rows)")
    dev_d = max(float((a - b).abs().max()) for a, b in zip(g2, p2))
    print(f"  distinct rows [128,{xs.shape[1]}], T 2: graphed fit bit-equal "
          f"to its eager steps; max |kernel fit - plain fit| = {dev_d:.3e} "
          f"(limit {PARAM_ATOL})", flush=True)
    check(dev_d <= PARAM_ATOL,
          f"multi-task kernel fit {dev_d} from the plain fit")
    return {"rows": int(x.shape[0]), "distinct_rows": unique,
            "d": int(x.shape[1]), "tasks": corpus.n_tasks,
            "param_dev_daemon_corpus": dev_p, "plain_ulp_floor": floor,
            "param_dev": dev_d, "step_us": step_us}


def phase_service(card: str):
    import warnings
    import torch
    from repro_torch.core import gp
    from repro_torch.core.faults import FaultPlan
    from repro_torch.kernels.gp_gram import ops
    from repro_torch.service import TuningClient
    from repro_torch.service.wire import trace_to_json
    from repro_torch.transfer import CorpusMismatch

    budget = SERVICE_CFG["n_init"] + SERVICE_CFG["n_iter"]
    print(f"== phase 10: the tuning daemon on the card: "
          f"{SERVICE_CLIENTS} HTTP clients x budget {budget} on "
          f"{SERVICE_WORKLOADS} (BOConfig {SERVICE_CFG}), a transfer_bo "
          f"session, perf_transfer's folds, 20 % transient faults",
          flush=True)
    t_phase = time.perf_counter()
    local = {}
    t0 = time.perf_counter()
    for wl in SERVICE_WORKLOADS:
        local[wl] = service_local_run(wl, budget, SERVICE_SEED, SERVICE_CFG,
                                      "cuda")
        check(local[wl][1] == budget, f"local {wl}: {local[wl][1]} calls")
    torch.cuda.synchronize()
    print(f"local baseline: {len(SERVICE_WORKLOADS)} sessions alone in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    captures, evictions = gp.graph_captures, gp.graph_evictions
    ops.reset_launch_counts()
    srv, httpd, url, replies, wall = service_daemon("cuda", SERVICE_CFG)
    torch.cuda.synchronize()
    launches = {"gram": ops.gram_launches, "cross": ops.cross_launches,
                "gram_bwd": ops.gram_bwd_launches}
    try:
        cache = srv.pool.cache.snapshot()
        calls = sum(srv.pool.inner.backends[wl].calls
                    for wl in SERVICE_WORKLOADS)
        independent = SERVICE_CLIENTS * budget
        print(f"daemon on {card}: {SERVICE_CLIENTS} sessions in "
              f"{wall:.3f} s = {SERVICE_CLIENTS / wall:.4f} sessions/s; "
              f"evaluator calls {calls} (independent runs: "
              f"{independent}); cache {cache['hits']}/{cache['requests']} "
              f"hits = {cache['hit_rate']:.4f} ({cache['hits_inflight']} "
              f"in flight); graph captures {gp.graph_captures - captures}, "
              f"evictions {gp.graph_evictions - evictions}; kernel "
              f"launches matern52_gram={launches['gram']} "
              f"matern52_cross={launches['cross']} "
              f"matern52_gram_bwd={launches['gram_bwd']}", flush=True)
        check(all(v > 0 for v in launches.values()),
              f"daemon: gp_gram launches {launches}")
        check(cache["hit_rate"] >= HIT_RATE_GATE,
              f"cache hit rate {cache['hit_rate']} < {HIT_RATE_GATE}")
        check(calls < independent,
              f"evaluator calls {calls} not fewer than {independent}")
        for i, (wl, reply) in sorted(replies.items()):
            check(reply["n_evaluations"] == budget,
                  f"client {i}: {reply['n_evaluations']} evaluations")
            check(reply["trace"] == trace_to_json(local[wl][0]),
                  f"client {i} ({wl}): server trace differs from the "
                  "local run_async")
        print(f"all {SERVICE_CLIENTS} server traces bit-identical to the "
              "local run_async at the same seed; best "
              + ", ".join(f"{wl} {min(local[wl][0].values):.6g}"
                          for wl in SERVICE_WORKLOADS), flush=True)

        # transfer_bo, its corpus mined from the daemon's own log
        client = TuningClient(url)
        target = f"{TRANSFER_ARCH}:{TRANSFER_SHAPE}"
        captures = gp.graph_captures
        t0 = time.perf_counter()
        sess = client.create_session(
            target, strategy="transfer_bo", budget=TRANSFER_BUDGET,
            seed=SERVICE_SEED, transfer_from=True,
            strategy_kwargs={"cfg": {**SERVICE_CFG, "n_iter":
                                     TRANSFER_BUDGET - SERVICE_CFG["n_init"]}})
        create_s = time.perf_counter() - t0
        mtgp = mtgp_check(srv, sess.session_id, card)
        mtgp["captures"] = gp.graph_captures - captures
        mtgp["create_s"] = create_s
        t0 = time.perf_counter()
        out = sess.run()
        mtgp["run_s"] = time.perf_counter() - t0
        check(out["n_evaluations"] == TRANSFER_BUDGET,
              f"transfer session: {out['n_evaluations']} evaluations")
        print(f"transfer_bo on {target}: created (corpus fit, pseudo "
              f"rows) in {create_s:.3f} s, ran {TRANSFER_BUDGET} "
              f"evaluations in {mtgp['run_s']:.3f} s, best "
              f"{out['best_value']:.6g}", flush=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            xl = client.create_session(
                "xlstm-1.3b:train_4k", strategy="transfer_bo", budget=8,
                transfer_from=True, strategy_kwargs={"cfg": SERVICE_CFG})
        check(srv.session(xl.session_id).strategy._prior is None
              and any(issubclass(w.category, CorpusMismatch)
                      for w in caught),
              "xlstm-1.3b took a corpus of another space signature")
        xl.close()
        print("transfer_bo on xlstm-1.3b:train_4k: the dense logs skipped "
              "with a CorpusMismatch warning (328 knobs, another "
              "signature): plain BO", flush=True)
    finally:
        httpd.shutdown()
        srv.close()
    round327 = gp_round_327(card)

    t0 = time.perf_counter()
    folds, identical, walls = transfer_folds("cuda")
    torch.cuda.synchronize()
    folds_s = time.perf_counter() - t0
    max_evals = int(FOLD_FRACTION * FOLD_BUDGET)
    print(f"perf_transfer folds on {card} in {folds_s:.3f} s (rank "
          f"{walls['rank_s']:.3f}, scratch {walls['scratch_s']:.3f}, "
          f"transfer {walls['transfer_s']:.3f}); top-{FOLD_TOP_K} "
          f"{walls['top']}", flush=True)
    for target, r in folds.items():
        print(f"  {target:18s} scratch {r['scratch_best']:.6g} transfer "
              f"{r['transfer_best']:.6g} (ratio "
              f"{r['scratch_best'] / r['transfer_best']:.4f}) matched at "
              f"eval {r['evals_to_match']} (gate <= {max_evals})",
              flush=True)
    check(identical, "transfer_bo with no corpus is not trace-identical "
          "to plain BO")
    for target, r in folds.items():
        m = r["evals_to_match"]
        check(m is not None and m <= max_evals,
              f"fold {target}: reached {FOLD_RATIO} of the scratch best at "
              f"eval {m}, gate {max_evals}")
    print("no-corpus identity: transfer_bo == plain BO at equal seed",
          flush=True)

    t0 = time.perf_counter()
    clean, _ = chaos_arm("cuda", None)
    chaotic, injected = chaos_arm("cuda", FaultPlan(
        transient_rate=CHAOS_RATE, seed=11))
    chaos_s = time.perf_counter() - t0
    print(f"chaos: {CHAOS_BUDGET} evaluations in waves of {CHAOS_WIDTH}, "
          f"{CHAOS_RATE:.0%} transient faults injected {injected}; "
          f"{chaos_s:.3f} s both arms", flush=True)
    check(injected.get("transient", 0) > 0, "no fault injected")
    check(chaotic.configs == clean.configs
          and chaotic.values == clean.values
          and chaotic.best_values == clean.best_values,
          "the trace under faults differs from the fault-free one")
    print("trace under 20 % transient faults bit-identical to the "
          "fault-free one", flush=True)
    total = time.perf_counter() - t_phase
    print(f"phase 10 total {total:.1f} s", flush=True)
    return {"launches": launches, "sessions_per_s": SERVICE_CLIENTS / wall,
            "wall_s": wall, "hit_rate": cache["hit_rate"],
            "evaluator_calls": calls, "round327": round327, "mtgp": mtgp,
            "folds": folds, "phase_s": total}


# phase 11: the kernels' tile knobs and the autotune loop on the card.
# tune_kernel at the benches' default shapes and at the path's shapes:
# the daemon's candidate cross-Gram, yi-6b's bf16 prefill, xlstm-1.3b's
# bf16 mLSTM layer; then each tuned config re-measured head to head against
# the space's default (or, where the card refuses that TPU-sized default,
# the default launch), held to benchmarks/perf_multi_device.py's 1.15.
# At the bench shapes a call is mostly host dispatch (~0.1-0.2 ms): its
# wall time spread by a quarter between readings of one config in one
# tuning run (tools/autotune_bench_spread.py), the tuner's best was the
# luckiest of them, and a config it picked read 1.17-1.27x the default
# launch head to head (PERF §7).  KernelEvaluator times a call's device
# time instead (the stream held busy while the host queues the call:
# kernels.autotune.HOLD_CYCLES).  At the bench shapes tune_kernel still
# times each config with AUTOTUNE_RECHECK warm-up calls and the best of
# AUTOTUNE_RECHECK (the reference's own repeats / warmup), and
# head_to_head takes turns call by call.
AUTOTUNE_BUDGET, AUTOTUNE_BATCH, AUTOTUNE_REPEATS = 24, 2, 5
AUTOTUNE_RECHECK, AUTOTUNE_ROUNDS, AUTOTUNE_GATE = 12, 3, 1.15
AUTOTUNE_RUNS = (
    ("gp_gram", "bench", {}),
    ("gp_gram", "path", {"n": SERVICE_CROSS[0], "m": SERVICE_CROSS[1],
                         "d": SERVICE_CROSS[2]}),
    ("flash_attention", "bench", {}),
    ("flash_attention", "path", {"B": PREFILL[0], "S": PREFILL[1],
                                 "H": PREFILL[2], "Kh": PREFILL[3],
                                 "D": PREFILL[4], "dtype": "bfloat16"}),
    ("mlstm_chunk", "bench", {}),
    ("mlstm_chunk", "path", {"B": MLSTM_LAYER[0], "S": MLSTM_LAYER[1],
                             "H": MLSTM_LAYER[2], "P": MLSTM_LAYER[3],
                             "dtype": "bfloat16"}),
)
# every instantiation against the plain version: gp_gram at the
# reference's off-ladder case (Gram and cross) and the daemon's cross
TILE_GRAM_CASES = ((136, 77, 9), (SERVICE_CROSS[0], 64, SERVICE_CROSS[2]))
TILE_MLSTM_WGMMA = (1, 1024, 2, 1024)   # B S H P, chunks 128, 256, 512
# sharded candidate scoring on one card: (d, candidates, q), the tuner's
# and the daemon's
SHARD_CASES = ((16, MAIN_CROSS[0], 8), (SERVICE_CROSS[2], SERVICE_CROSS[0],
                                        8))


def tiles_gp_gram(dev) -> dict:
    """Every gp_gram instantiation bit-equal to the default launch, which
    holds 2e-4 of the plain version; a planted fault (one instantiation
    fed rows one tile off) above both gates."""
    import torch
    from repro_torch.kernels.gp_gram import ops, ref
    gen = torch.Generator(device=dev).manual_seed(11)
    err, n_inst = 0.0, 0
    tiles = ops.supported_tiles()
    for n, m, d in TILE_GRAM_CASES:
        xa = torch.rand((n, d), generator=gen, device=dev)
        xb = torch.rand((m, d), generator=gen, device=dev)
        xb[:2] = xa[:2]
        ls = 0.1 + torch.rand((d,), generator=gen, device=dev)
        for kind, call, plain in (
                ("cross", lambda **kw: ops.matern52_cross(xa, xb, ls, 0.8,
                                                          **kw),
                 ref.matern52(xa, xb, ls, 0.8)),
                ("gram", lambda **kw: ops.matern52_gram(xa, ls, 1.3, **kw),
                 ref.matern52(xa, xa, ls, 1.3))):
            base = call()
            e = float((base - plain).abs().max())
            err = max(err, e)
            check(e <= ATOL, f"gp_gram {kind} [{n},{d}]x[{m},{d}]: default "
                  f"launch vs plain {e}")
            for bn in tiles["block_n"]:
                for bm in tiles["block_m"]:
                    for nw in tiles["num_warps"]:
                        for st in tiles["pipeline"]:
                            out = call(block=bn, block_m=bm, num_warps=nw,
                                       pipeline=st)
                            n_inst += 1
                            check(torch.equal(out, base),
                                  f"gp_gram {kind} [{n},{d}] tile "
                                  f"{(bn, bm, nw, st)}: not bit-equal to "
                                  f"the default launch (max diff "
                                  f"{float((out - base).abs().max())})")
    # the planted fault: the 64 x 64 tile fed xa rolled by one tile
    n, m, d = TILE_GRAM_CASES[0]
    xa = torch.rand((n, d), generator=gen, device=dev)
    xb = torch.rand((m, d), generator=gen, device=dev)
    ls = 0.1 + torch.rand((d,), generator=gen, device=dev)
    fault = ops.matern52_cross(torch.roll(xa, 64, 0), xb, ls, 0.8, block=64,
                               block_m=64)
    e_fault = float((fault - ref.matern52(xa, xb, ls, 0.8)).abs().max())
    check(e_fault > ATOL and not torch.equal(
        fault, ops.matern52_cross(xa, xb, ls, 0.8)),
        f"gp_gram planted fault within the gates ({e_fault})")
    print(f"  gp_gram: {n_inst} launches of {len(tiles['block_n'])}x"
          f"{len(tiles['block_m'])}x{len(tiles['num_warps'])}x"
          f"{len(tiles['pipeline'])} tilings over {len(TILE_GRAM_CASES)} "
          f"shapes (Gram and cross) bit-equal to the default launch, "
          f"which is {err:.3e} from plain (limit {ATOL}); planted fault "
          f"{e_fault:.3e}", flush=True)
    return {"max_abs_err": err, "instantiations": n_inst,
            "fault": e_fault}


def tiles_flash(dev) -> dict:
    """Every flash instantiation of each route at the reference's cases
    against the route's plain version (2e-5 / 2e-2), float32 tilings
    within 1e-5 of the default launch; a planted fault (one instantiation
    fed keys rolled by one tile) above the limit."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    gen = torch.Generator(device=dev).manual_seed(12)
    err, inv, n_inst = {}, 0.0, 0
    for B, Sq, Sk, H, Kh, D, causal, window, softcap in FLASH_CASES:
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            q, k, v = [torch.randn(s, generator=gen, device=dev).to(dt)
                       for s in ((B, Sq, H, D), (B, Sk, Kh, D),
                                 (B, Sk, Kh, D))]
            kw = dict(causal=causal, window=window, softcap=softcap)
            want = ops.plain_version(q, k, v, **kw).float()
            base = ops.flash_attention(q, k, v, **kw).float()
            route = ops.route(dt, D)
            for t in ops.supported_tiles(route, dt, D):
                out = ops.flash_attention(q, k, v, block_q=t[0],
                                          block_k=t[1], num_warps=t[2],
                                          pipeline=t[3], **kw).float()
                n_inst += 1
                e = float((out - want).abs().max())
                key = f"{name}_{route}"
                err[key] = max(err.get(key, 0.0), e)
                check(e <= FLASH_TOL[name], f"flash {name} {route} D={D} "
                      f"Sq={Sq} tile {t}: max |kernel - plain| = {e}")
                if name == "float32":
                    i = float((out - base).abs().max())
                    inv = max(inv, i)
                    check(i <= 1e-5, f"flash float32 D={D} Sq={Sq} tile {t}:"
                          f" {i} from the default launch (limit 1e-5)")
    # the planted fault: one wgmma instantiation fed keys rolled by a tile
    q, k, v = [torch.randn(s, generator=gen, device=dev).bfloat16()
               for s in ((1, 256, 4, 128), (1, 256, 2, 128), (1, 256, 2, 128))]
    want = ops.plain_version(q, k, v).float()
    fault = ops.flash_attention(q, torch.roll(k, 64, 1), torch.roll(v, 64, 1),
                                block_q=64, block_k=64).float()
    e_fault = float((fault - want).abs().max())
    check(e_fault > FLASH_TOL["bfloat16"],
          f"flash planted fault within the limit ({e_fault})")
    print(f"  flash: {n_inst} launches over the reference's cases, every "
          f"instantiation of each route; max |kernel - plain| "
          f"{ {k: f'{v:.3e}' for k, v in err.items()} }, float32 tilings "
          f"{inv:.3e} from the default launch (limit 1e-5); planted fault "
          f"{e_fault:.3e}", flush=True)
    return {"max_abs_err": err, "invariance": inv, "instantiations": n_inst,
            "fault": e_fault}


def tiles_mlstm(dev) -> dict:
    """Every mLSTM launch of each route against its plain version:
    float32 (FMA) at the reference's cases within 5e-5, bf16 (wgmma) at
    P 1024 and chunks 128-512 within relative L2 1e-3 of the bf16-operand
    version; a planted fault (one launch fed q rolled by one chunk) above
    the limit."""
    import torch
    from repro_torch.kernels.mlstm_chunk import ops

    gen = torch.Generator(device=dev).manual_seed(13)

    def inputs(B, S, H, P, dt):
        def n(*s):
            return torch.randn(s, generator=gen, device=dev)
        q, k, v = n(B, S, H, P) * 0.5, n(B, S, H, P) * 0.5 / P ** 0.5, \
            n(B, S, H, P) * 0.5
        return (q.to(dt), k.to(dt), v.to(dt), n(B, S, H),
                -torch.nn.functional.softplus(-n(B, S, H) * 2.0))

    err, rel, n_inst = 0.0, 0.0, 0
    for B, S, H, P, chunk in MLSTM_CASES:
        args = inputs(B, S, H, P, torch.float32)
        want = ops.plain_version(*args, chunk)
        for nw, st in ops.supported_tiles("fma", P, chunk):
            out = ops.mlstm_chunk(*args, chunk=chunk, num_warps=nw,
                                  pipeline=st)
            n_inst += 1
            e = float((out - want).abs().max())
            err = max(err, e)
            check(e <= MLSTM_ATOL, f"mlstm fma {(B, S, H, P, chunk)} "
                  f"num_warps={nw}: {e}")
    B, S, H, P = TILE_MLSTM_WGMMA
    args = inputs(B, S, H, P, torch.bfloat16)
    for chunk in (128, 256, 512):
        want = ops.plain_version(*args, chunk)
        for nw, st in ops.supported_tiles("wgmma", P, chunk):
            out = ops.mlstm_chunk(*args, chunk=chunk, num_warps=nw,
                                  pipeline=st)
            n_inst += 1
            r = rel_l2(out, want)
            rel = max(rel, r)
            check(r <= MLSTM_REL_L2, f"mlstm wgmma chunk {chunk} "
                  f"num_warps={nw} pipeline={st}: rel L2 {r}")
    fault = ops.mlstm_chunk(torch.roll(args[0], 256, 1), *args[1:],
                            chunk=256, num_warps=4, pipeline=2)
    r_fault = rel_l2(fault, ops.plain_version(*args, 256))
    check(r_fault > MLSTM_REL_L2, f"mlstm planted fault within the limit "
          f"({r_fault})")
    print(f"  mlstm: {n_inst} launches; fma max |kernel - plain| "
          f"{err:.3e} (limit {MLSTM_ATOL}), wgmma rel L2 {rel:.3e} (limit "
          f"{MLSTM_REL_L2}); planted fault {r_fault:.3e}", flush=True)
    return {"max_abs_err": err, "rel_l2": rel, "instantiations": n_inst,
            "fault": r_fault}


def head_to_head(kernel: str, shape: dict, configs: dict) -> dict:
    """ms of each named config (None: the default launch) at ``shape``:
    the tuner's own timing of one call after a warm-up call, the configs
    taking turns call by call (the order reversed every turn), best of
    AUTOTUNE_ROUNDS x AUTOTUNE_RECHECK calls each.  At a host-bound shape
    the host's speed drifts by ~15 % over seconds, so readings taken a
    block apart compared two phases of the host; the device times
    ``KernelEvaluator.time`` reads now are steadier, and turns call by
    call still compare one phase of the card."""
    from repro_torch.kernels import autotune
    ev = autotune.KernelEvaluator(kernel, shape=shape, warmup=1)
    runs = {name: ev._build(cfg) for name, cfg in configs.items()}
    best = {name: math.inf for name in configs}
    order = list(configs)
    for _ in range(AUTOTUNE_ROUNDS * AUTOTUNE_RECHECK):
        for name in order:
            best[name] = min(best[name], ev.time(runs[name], 1))
        order.reverse()
    return best


def select_sharded(dev) -> dict:
    """select_batch_sharded over 1-3 shards of one card at the tuner's and
    the daemon's shapes: picks array-equal to select_batch; wall per k."""
    import numpy as np
    import torch
    from repro_torch.core import gp
    out = {}
    for d, n_cand, q in SHARD_CASES:
        rng = np.random.default_rng(d)
        x = rng.random((56, d))
        y = (np.sin(3 * x[:, 0]) + (x[:, 1] - 0.4) ** 2
             + 0.1 * rng.normal(size=56))
        st = gp.fit(x, y, steps=60, pad_to=64, use_kernel=True, device=dev)
        y_raw = np.zeros(64, np.float32)
        y_raw[:56] = y
        cand = rng.random((n_cand, d)).astype(np.float32)
        best_y = float(y.min())
        want = gp.select_batch(st, cand, y_raw, 56, best_y, q,
                               use_kernel=True).cpu()
        walls = {}
        for k in (1, 2, 3):
            gp.select_batch_sharded(st, cand, y_raw, 56, best_y, q,
                                    use_kernel=True, devices=(dev,) * k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = gp.select_batch_sharded(st, cand, y_raw, 56, best_y, q,
                                          use_kernel=True,
                                          devices=(dev,) * k).cpu()
            walls[k] = (time.perf_counter() - t0) * 1e3
            check(torch.equal(got, want), f"select_batch_sharded d={d} "
                  f"k={k}: picks {got.tolist()} != select_batch's "
                  f"{want.tolist()}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp.select_batch(st, cand, y_raw, 56, best_y, q, use_kernel=True).cpu()
        base = (time.perf_counter() - t0) * 1e3
        print(f"  select_batch_sharded d={d}, {n_cand} candidates, q={q}: "
              f"picks array-equal to select_batch at 1-3 shards of one card;"
              f" wall ms "
              f"{', '.join(f'{k}: {w:.3f}' for k, w in walls.items())}"
              f" (select_batch {base:.3f}; one card: no gate)", flush=True)
        out[f"d{d}"] = {"wall_ms": walls, "select_batch_ms": base,
                        "picks": want.tolist()}
    return out


def fresh_thread_launches(dev) -> list:
    """Each tensor-core forward launched from a new thread that has made no
    CUDA call, its memory served from PyTorch's cache (as in a tuner's
    worker thread): its launcher binds the device's context before it
    encodes a tensor map, so the launch must not fail there and must equal
    the same launch from this thread bit for bit."""
    import threading
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops

    gen = torch.Generator().manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    q, k, v = rand(2, 512, 8, 128), rand(2, 512, 2, 128), rand(2, 512, 2, 128)
    mq, mk, mv = rand(1, 512, 2, 256), rand(1, 512, 2, 256) / 16, \
        rand(1, 512, 2, 256)
    li = rand(1, 512, 2, dtype=torch.float32)
    lf = -torch.nn.functional.softplus(-2 * rand(1, 512, 2,
                                                 dtype=torch.float32))
    check(flash_ops.route(q.dtype, 128) == "wgmma"
          and mlstm_ops.route(mq.dtype, 256, 256) == "wgmma",
          "fresh thread: the inputs do not reach the wgmma routes")
    cases = (("flash_attention_wgmma", lambda: flash_ops.flash_attention(
                  q, k, v)),
             ("mlstm_chunk_wgmma", lambda: mlstm_ops.mlstm_chunk(
                  mq, mk, mv, li, lf, chunk=256)))
    names = []
    for name, fn in cases:
        want = fn()
        fn()                        # freed: the thread's call reuses it
        torch.cuda.synchronize()
        got, errs = [], []

        def work():
            try:
                got.append(fn())
                torch.cuda.synchronize()
            except Exception as e:  # reported below
                errs.append(e)
        worker = threading.Thread(target=work)
        worker.start()
        worker.join()
        check(not errs, f"{name} launched from a fresh thread failed: "
              f"{errs[0]!r}" if errs else "")
        check(torch.equal(got[0], want), f"{name} from a fresh thread "
              "differs from the same launch on the main thread")
        names.append(name)
    return names


def phase_autotune(card: str):
    import torch
    from repro_torch.core.strategy import _config_key
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gp_gram import ops as gram_ops
    from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops

    print("== phase 11: the kernels' tile knobs and tune_kernel on the card "
          f"(budget {AUTOTUNE_BUDGET}, batch {AUTOTUNE_BATCH}, repeats "
          f"{AUTOTUNE_REPEATS}, {AUTOTUNE_RECHECK} at the bench shapes; "
          f"head to head best of {AUTOTUNE_RECHECK} x {AUTOTUNE_ROUNDS} "
          f"calls in turns, gate {AUTOTUNE_GATE})", flush=True)
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    tiles = {"gp_gram": tiles_gp_gram(dev), "flash_attention":
             tiles_flash(dev), "mlstm_chunk": tiles_mlstm(dev)}
    torch.cuda.synchronize()
    t_tiles = time.perf_counter() - t_phase
    fresh = fresh_thread_launches(dev)
    print(f"  launched from a fresh thread (memory from the cache), bit-equal"
          f" to the main thread's launch: {', '.join(fresh)}", flush=True)

    # the path: tune_kernel, launches counted from 0 just before it
    gram_ops.reset_launch_counts()
    flash_ops.reset_launch_counts()
    mlstm_ops.reset_launch_counts()
    tuned = {}
    for kernel, label, shape in AUTOTUNE_RUNS:
        t0 = time.perf_counter()
        reps = AUTOTUNE_RECHECK if label == "bench" else AUTOTUNE_REPEATS
        res = autotune.tune_kernel(kernel, shape=shape,
                                   budget=AUTOTUNE_BUDGET,
                                   batch_size=AUTOTUNE_BATCH,
                                   repeats=reps, warmup=max(reps, 2))
        wall = time.perf_counter() - t0
        failed = [r.config for r in res["db"].records if not r.ok]
        ok = [r for r in res["db"].records if r.ok]
        check(ok, f"tune_kernel({kernel}, {label}): every evaluation failed")
        tuned[(kernel, label)] = (res, wall, failed)
    torch.cuda.synchronize()
    launches = {"gp_gram": gram_ops.gram_launches + gram_ops.cross_launches
                + gram_ops.gram_bwd_launches,
                "flash_attention": flash_ops.launches,
                "mlstm_chunk": mlstm_ops.launches}
    for k, n in launches.items():
        check(n > 0, f"phase 11: no {k} launch while tuning")

    # head to head: tuned vs the space's default (when the card takes it)
    # vs the default launch
    summary = {}
    for (kernel, label, shape) in AUTOTUNE_RUNS:
        res, wall, failed = tuned[(kernel, label)]
        dflt_ok = res["default_value"] is not None
        configs = {"tuned": res["best_config"], "no_knob": None}
        if dflt_ok:
            configs["default"] = res["default_config"]
        ms = head_to_head(kernel, shape, configs)
        ref_name = "default" if dflt_ok else "no_knob"
        # the default launch's tiles as a point of the space, seeded second
        # into the tuner's design: its reading in the trace
        spec = autotune.kernel_spec(kernel)
        nkey = _config_key(spec.space.project(spec.native(**shape)))
        native_trace = next((float(r.value) for r in res["db"].records
                             if r.ok and _config_key(r.config) == nkey),
                            math.nan)
        ratio = ms["tuned"] / ms[ref_name]
        print(f"  tune_kernel({kernel}, {label} {shape or 'bench default'})"
              f" in {wall:.1f} s: {len(res['trace'].values)} evaluations, "
              f"{len(failed)} refused by the card: {failed}", flush=True)
        print(f"    tuned {res['best_config']} {ms['tuned']:.5f} ms (its "
              f"reading in the tuner's trace {res['best_value']:.5f}); space "
              f"default {res['default_config']} "
              + (f"{ms['default']:.5f} ms (in the trace "
                 f"{res['default_value']:.5f})" if dflt_ok else
                 "refused (no instantiation): gate against the default "
                 "launch")
              + f"; default launch {ms['no_knob']:.5f} ms (its tiles in "
              f"the trace {native_trace:.5f}); tuned/{ref_name} {ratio:.4f} "
              f"(gate {AUTOTUNE_GATE})", flush=True)
        check(ratio <= AUTOTUNE_GATE, f"tune_kernel({kernel}, {label}): "
              f"tuned {ms['tuned']} ms > {AUTOTUNE_GATE} x {ref_name} "
              f"{ms[ref_name]} ms")
        summary.setdefault(kernel, {})[label] = {
            "shape": shape, "config": res["best_config"],
            "ms": ms["tuned"], "trace_ms": res["best_value"],
            "default_config": res["default_config"],
            "default_ms": ms.get("default"), "no_knob_ms": ms["no_knob"],
            "gate_against": ref_name, "ratio": ratio,
            "evaluations": len(res["trace"].values),
            "refused": len(failed), "tune_wall_s": wall}
    shard = select_sharded(dev)
    total = time.perf_counter() - t_phase
    print(f"phase 11: launches while tuning {launches}; instantiation "
          f"checks {t_tiles:.1f} s; total {total:.1f} s", flush=True)
    return {"tiles": tiles, "tuned": summary, "launches": launches,
            "shard": shard, "phase_s": total}


# ---------------------------------------------------------------------------
# phase 12: the MoE, Mamba and whisper families at full width
# ---------------------------------------------------------------------------

# flash at the new paths' shapes, (B, Sq, Sk, H, Kh, D, causal, what):
# whisper's encoder self-attention (Sk 1500 = 11 tiles of 128 keys and a
# ragged 92, without the causal mask), its cross-attention (Sq 448, the
# product's cap, against the 1500 frames) and qwen2-moe's MHA prefill
FAMILY_FLASH = [(2, 1500, 1500, 6, 6, 64, False, "whisper encoder"),
                (2, 448, 1500, 6, 6, 64, False, "whisper cross"),
                (2, 4096, 4096, 16, 16, 128, True, "qwen2-moe MHA")]
MOE_PREFILL = (2, 4096)          # qwen2-moe-a2.7b: B, S
TF_PROMPT, TF_STEPS = 256, 8     # teacher-forced decode after the prompt
# dropping at capacity T against dense: the same function, summed in
# another order over bf16 weights (each kept token's expert product and
# the combine round in bf16 at other places)
DROPPING_REL_L2 = 1e-2
JAMBA_DEPTH = 5                  # positions 0-4 of the 8-layer period
JAMBA_PREFILL = (1, 4096)
# jamba's teacher-forced check: a 248-token prompt + 8 steps, so that the
# forward's 256 tokens are one chunk of 256 (the chunk must divide S)
JAMBA_TF_PROMPT = 248
MAMBA_LAYER_S = 1024
# one full-width mamba layer in float32, chunked SSD (chunk 256) against
# the sequential recurrence: the same sums in another order.  1.3e-6 at
# d_model 512 on the host (float64 oracle 1.4e-6); the limit leaves two
# orders for the card's products at 16384 channels
MAMBA_REL_L2 = 1e-4
WHISPER_B = 2
WHISPER_S = (448, 4096)          # the product's cap, and the 4k cell
WHISPER_TF_PROMPT = 432          # + 16 teacher-forced steps = 448
FAMILY_DECODE_STEPS = 16
PHASE12_BUDGET_S = 150.0


def flash_events(fn):
    """(fn(), [device µs of each flash wgmma launch, in launch order])
    from ``torch.profiler`` over one call that ends in a sync."""
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    evs = sorted((e.time_range.start, e.device_time) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "flash_wgmma_kernel" in e.name)
    return out, [t for _, t in evs]


@contextlib.contextmanager
def layer_spans(targets):
    """Wrap ``(module, attr, key)`` layer functions (``fn(params, x, ...)``
    whose output, or its first item, is the layer's output) with CUDA
    events; yields {key: [(start, end), ...]} (read after a sync): each
    call's forward (the remat recompute too) and, under autograd, its
    backward, from the output's gradient arriving (after the recompute
    that gradient sets off: the marker saves its input, whose unpacking
    runs the recompute first) to the input's gradient leaving."""
    import torch
    spans = {key: [] for _, _, key in targets}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, box, end):
            ctx.box, ctx.end = box, end
            if not end:
                ctx.save_for_backward(x)
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            if ctx.end:
                ctx.box["out"].append((ctx.box.pop("start"), event()))
            else:
                ctx.saved_tensors            # the recompute runs here
                ctx.box["start"] = event()
            return g, None, None

    def timed(fn, key):
        def run(params, x, *a, **k):
            box = {"out": spans[key]}
            grad = torch.is_grad_enabled() and x.requires_grad
            if grad:
                x = Mark.apply(x, box, True)
            s = event()
            out = fn(params, x, *a, **k)
            spans[key].append((s, event()))
            if grad:
                if isinstance(out, tuple):
                    out = (Mark.apply(out[0], box, False),) + out[1:]
                else:
                    out = Mark.apply(out, box, False)
            return out
        return run

    for (mod, attr, key), (_, _, fn) in zip(targets, saved):
        setattr(mod, attr, timed(fn, key))
    try:
        yield spans
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def families_flash(card: str):
    """Flash against its plain version at the new paths' shapes, with a
    planted fault, and timed beside the plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for B, Sq, Sk, H, Kh, D, causal, what in FAMILY_FLASH:
        q, k, v = (torch.randn(s, generator=gen, device=dev).bfloat16()
                   for s in ((B, Sq, H, D), (B, Sk, Kh, D), (B, Sk, Kh, D)))
        check(ops.route(q.dtype, D) == "wgmma", f"{what}: not on the wgmma "
              "route")

        def kernel():
            return ops.flash_attention(q, k, v, causal=causal)

        def plain():
            return ops.plain_version(q, k, v, causal=causal)

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))     # Kh == H

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)

        before = ops.launches_wgmma
        out, want = kernel(), plain()
        torch.cuda.synchronize()
        check(ops.launches_wgmma == before + 1, f"{what}: no wgmma launch")
        want_f32p = ref.reference_attention(q, k, v, causal=causal)
        # the planted fault: every row loses keys 0..63 (non-causal: the
        # plain version over keys 64..; causal: rows past the first tile,
        # as in phase 5)
        if causal:
            fault = want.clone()
            fault[:, 64:] = ops.plain_version(q[:, 64:], k[:, 64:],
                                              v[:, 64:], causal=True)
        else:
            fault = ops.plain_version(q, k[:, 64:], v[:, 64:], causal=False)
        e = float((out.float() - want.float()).abs().max())
        rel, rel_f32p = rel_l2(out, want), rel_l2(out, want_f32p)
        rel_lib, rel_fault = rel_l2(library().transpose(1, 2), want), \
            rel_l2(fault, want)
        tag = (f"{what} B={B} Sq={Sq} Sk={Sk} H={H} Kh={Kh} D={D} "
               f"causal={causal}")
        print(f"  {tag}: max_abs_err={e:.3e} rel_l2={rel:.4e}; vs P in f32 "
              f"rel_l2={rel_f32p:.4e}; sdpa vs plain rel_l2={rel_lib:.4e}; "
              f"planted fault rel_l2={rel_fault:.4e}; limit {FLASH_REL_L2}",
              flush=True)
        check(bool(torch.isfinite(out).all()), f"{tag}: non-finite")
        check(e <= FLASH_TOL["bfloat16"], f"{tag}: max |kernel - plain| {e}")
        for name, r in (("plain", rel), ("plain with P in f32", rel_f32p)):
            check(r <= FLASH_REL_L2, f"{tag}: kernel vs {name} relative L2 "
                  f"{r} > {FLASH_REL_L2}")
        check(rel_fault > FLASH_REL_L2, f"{tag}: the planted fault's "
              f"relative L2 {rel_fault} is within {FLASH_REL_L2}")
        del out, want, want_f32p, fault
        # turns: library, kernel, kernel, library
        l1 = cuda_ms(library, reps=5, inner=4)
        k1 = cuda_ms(kernel, reps=5, inner=4)
        k2 = cuda_ms(kernel, reps=5, inner=4)
        l2 = cuda_ms(library, reps=5, inner=4)
        p_ms = cuda_ms(plain, reps=3, inner=2)
        b_ms, b_by, flops = flash_bound(B, Sq, Sk, H, Kh, D, causal, 2,
                                        BF16_FLOPS_PER_S)
        k_ms, l_ms = min(k1, k2), min(l1, l2)
        print(f"  {tag} bf16 on {card}: kernel_ms={k_ms:.4f} ({k1:.4f}, "
              f"{k2:.4f}) plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"({l1:.4f}, {l2:.4f}) bound_ms={b_ms:.4f} ({b_by}; "
              f"{flops / 1e9:.2f} GFLOP); kernel / library "
              f"{k_ms / l_ms:.3f}", flush=True)
        rows.append({"what": what, "shape": [B, Sq, Sk, H, Kh, D],
                     "causal": causal, "max_abs_err": e, "rel_l2": rel,
                     "rel_l2_f32p": rel_f32p, "ms": k_ms, "plain_ms": p_ms,
                     "library_ms": l_ms, "bound_ms": b_ms,
                     "bound_by": b_by})
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def capture_calls(mod, attr):
    """Wrap ``mod.attr``; yields the list of (args, kwargs, output) of
    its calls."""
    fn, calls = getattr(mod, attr), []

    def run(*a, **k):
        out = fn(*a, **k)
        calls.append((a, k, out))
        return out

    setattr(mod, attr, run)
    try:
        yield calls
    finally:
        setattr(mod, attr, fn)


@contextlib.contextmanager
def routing_replay(plan=None):
    """With ``plan`` None, record: yields the list of each
    ``moe._routing`` call's top-k indices [T, K].  Otherwise replay: the
    i-th call routes to ``plan(i)`` instead, its weights renormalised from
    its own float32 probabilities at those experts and its aux loss formed
    from them (only the indices are replayed: the gate weights and the aux
    loss keep their gradient); the yielded list then holds, per call, the
    number of tokens whose own top-k set differed.

    A random-weight MoE model in bf16 is chaotic as initialised: a
    rounding difference flips a routing near-tie, and the flipped expert's
    output moves the next layers' routing.  Replaying one run's routing
    into another separates that discontinuity from the arithmetic."""
    import torch
    from repro_torch.models import moe
    routing, log = moe._routing, []

    def patched(params, x, cfg, data_axes=()):
        w, aux, topi, topv = routing(params, x, cfg, data_axes)
        if plan is None:
            log.append(topi)
            return w, aux, topi, topv
        want = plan(len(log)).to(topi.device)
        log.append(int((topi.sort(-1).values != want.sort(-1).values)
                       .any(-1).sum()))
        # the probabilities and the aux loss as moe._routing forms them
        # (on a mesh: a split router's logits gathered, the fractions
        # reduced over the data axes)
        probs = moe._router_probs(params, x, cfg)
        topv = probs.gather(-1, want)
        topv = topv / topv.sum(dim=-1, keepdim=True)
        w = torch.zeros_like(probs).scatter(-1, want, topv)
        return w, moe._aux_loss(w, probs, cfg, data_axes), want, topv

    moe._routing = patched
    try:
        yield log
    finally:
        moe._routing = routing


def _logit_gap(a, b):
    """(relative L2, max |a - b|, argmax agreement) of two logit tensors."""
    d = (a.float() - b.float())
    return (float(d.norm() / b.float().norm()), float(d.abs().max()),
            float((a.argmax(-1) == b.argmax(-1)).float().mean()))


def _family_prefill(m, params, inputs, s_max, rc, want_flash, what):
    """One prefill through ``Model.prefill``; the flash counters are set to
    0 just before and read just after: a flash prefill must launch the
    wgmma kernel ``want_flash`` times and the FMA kernel never."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, st = m.prefill(params, inputs, s_max, rc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = want_flash if rc.attention_impl == "flash" else 0
    got = (ops.launches, ops.launches_wgmma, ops.launches_fma)
    check(got == (n, n, 0), f"{what} {rc.attention_impl} prefill: (all, "
          f"wgmma, fma) flash launches {got}, want {(n, n, 0)}")
    check(bool(torch.isfinite(logits).all()),
          f"{what} {rc.attention_impl} prefill: non-finite logits")
    return logits, st, wall


def _teacher_forced(m, params, tokens, prompt, rc, forward, what,
                    extra=None, moe_calls=0):
    """Prefill ``prompt`` tokens, then decode the rest teacher-forced; the
    logits of every position from the prompt's last on against
    ``forward()``'s (the full-sequence pass), at the bf16 logit limit.
    With MoE layers (``moe_calls`` routings per pass) the comparison as
    initialised is recorded, and the one with the forward's routing
    replayed into the prefill and every step is held to the limit.
    Returns (relative L2, ms per decode step)."""
    import torch
    B, S = tokens.shape
    routes = []
    with (routing_replay() if moe_calls else contextlib.nullcontext(
            routes)) as routes:
        full = forward()

    def at(pos):                 # the forward's routing of these positions
        return lambda i: routes[i].view(B, S, -1)[:, pos].reshape(
            -1, routes[i].shape[-1])

    def run(replay):
        flips = []
        ctx = routing_replay(at(slice(0, prompt))) if replay \
            else contextlib.nullcontext([])
        with ctx as f:
            logits, st = m.prefill(
                params, {"tokens": tokens[:, :prompt], **(extra or {})}, S,
                rc)
        flips += f
        outs = [logits[:, 0]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(prompt, S):
            ctx = routing_replay(at(t)) if replay \
                else contextlib.nullcontext([])
            with ctx as f:
                logits, st = m.decode_step(params, tokens[:, t:t + 1], st,
                                           rc)
            flips += f
            outs.append(logits[:, 0])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (S - prompt) * 1e3
        return _logit_gap(torch.stack(outs, dim=1), full[:, prompt - 1:]) \
            + (ms, sum(flips))

    head = (f"  {what}: {prompt}-token prefill + {S - prompt} teacher-"
            "forced decode steps vs the full-sequence forward")
    if moe_calls:
        rel0, mx0, agree0, _, _ = run(False)
        print(f"{head}, as initialised: rel_l2={rel0:.4e} max_abs="
              f"{mx0:.4e} argmax_agreement={agree0} (recorded)", flush=True)
    rel, mx, agree, ms, flips = run(bool(moe_calls))
    routed = (f"with the forward's routing replayed ({flips} of "
              f"{B * S * moe_calls} token routings had flipped)"
              if moe_calls else "")
    print(f"{head}{', ' + routed if routed else ''}: rel_l2={rel:.4e} "
          f"max_abs={mx:.4e} argmax_agreement={agree}; limit "
          f"{LOGIT_REL_L2_BF16}; {ms:.3f} ms/step", flush=True)
    check(rel <= LOGIT_REL_L2_BF16, f"{what}: teacher-forced decode vs "
          f"forward relative L2 {rel} > {LOGIT_REL_L2_BF16}")
    return rel, ms


def families_moe(card: str):
    import gc

    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import attention, moe, transformer
    from repro_torch.models.common import tree_flatten
    from repro_torch.models.model import Model
    from repro_torch.runconfig import RunConfig

    cfg = get_config("qwen2-moe-a2.7b")
    B, S = MOE_PREFILL
    L = cfg.n_layers
    print(f"-- qwen2-moe-a2.7b: {L} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads (MHA, D {cfg.resolved_head_dim}), "
          f"{cfg.n_experts} experts top-{cfg.n_experts_per_tok} of width "
          f"{cfg.moe_d_ff} + {cfg.n_shared_experts} shared, vocab "
          f"{cfg.vocab_size}; prefill B={B} S={S}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    m = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = m.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    print(f"random bf16 weights made on the card: {n_params} parameters "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(13)
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    rc_flash = RunConfig(attention_impl="flash")
    rc_ref = RunConfig(attention_impl="reference")
    n_route = B * S * L

    def prefill(rc):
        return _family_prefill(m, params, {"tokens": tokens}, S + 64, rc, L,
                               "qwen2-moe")

    _, _, wall_warm = prefill(rc_flash)
    # the main path's prefill; its MoE layers' inputs and routing kept
    with capture_calls(moe, "apply") as moe_calls, \
            routing_replay() as flash_routes:
        lf, _, wall = prefill(rc_flash)
    launches = flash_ops.launches
    with routing_replay() as ref_routes:
        lr, _, wall_ref = prefill(rc_ref)
    rel0, mx0, agree0 = _logit_gap(lf, lr)
    with routing_replay(lambda i: ref_routes[i]) as flips:
        lfr, _, _ = prefill(rc_flash)
    rel, mx, agree = _logit_gap(lfr, lr)
    print(f"prefill B={B} S={S} bf16 on {card}: flash wall={wall:.3f}s "
          f"({B * S / wall:.1f} tok/s; first call {wall_warm:.3f}s), "
          f"reference wall={wall_ref:.3f}s; last-token logits flash vs "
          f"reference as initialised rel_l2={rel0:.4e} max_abs={mx0:.4e} "
          f"argmax_agreement={agree0} (recorded: routing flips cascade); "
          f"with the reference's routing replayed ({sum(flips)} of "
          f"{n_route} token routings had flipped) rel_l2={rel:.4e} "
          f"max_abs={mx:.4e} argmax_agreement={agree}; max|ref logit|="
          f"{float(lr.abs().max()):.3f}; limit {LOGIT_REL_L2_BF16}",
          flush=True)
    check(rel <= LOGIT_REL_L2_BF16, f"qwen2-moe prefill logits with the "
          f"routing replayed: flash vs reference relative L2 {rel} > "
          f"{LOGIT_REL_L2_BF16}")
    del lr, lfr

    # dropping at capacity T: each MoE layer on its own input from the
    # main path's prefill against dense (the same function, summed in
    # another order), then the whole prefill
    cf = cfg.n_experts / cfg.n_experts_per_tok
    rc_cap = RunConfig(attention_impl="flash", moe_impl="dropping",
                       moe_capacity_factor=cf)
    check(moe._capacity(B * S, cfg, rc_cap) == B * S, "capacity is not T")
    # (a comprehension: no name outlives it holding views of the weights)
    layer_rel = [rel_l2(moe.apply(a[0], a[1], cfg, rc_cap)[0], y)
                 for a, _, (y, _) in moe_calls]
    del moe_calls
    ld0, _, _ = prefill(rc_cap)
    rel_d0 = _logit_gap(ld0, lf)[0]
    with routing_replay(lambda i: flash_routes[i]) as flips_d:
        ld, _, wall_drop = prefill(rc_cap)
    rel_d = _logit_gap(ld, lf)[0]
    ld2, _, wall_drop2 = prefill(RunConfig(attention_impl="flash",
                                           moe_impl="dropping"))
    rel_d2 = _logit_gap(ld2, lf)[0]
    print(f"  moe_impl='dropping' at capacity factor {cf:g} (capacity = T "
          f"= {B * S}, nothing dropped) vs 'dense', each of the {L} MoE "
          f"layers on its prefill input: rel_l2 {min(layer_rel):.4e}-"
          f"{max(layer_rel):.4e} (limit {DROPPING_REL_L2}); whole prefill "
          f"as initialised rel_l2={rel_d0:.4e} (recorded), with the dense "
          f"run's routing replayed ({sum(flips_d)} flipped) rel_l2="
          f"{rel_d:.4e} (limit {LOGIT_REL_L2_BF16}), wall {wall_drop:.3f}s;"
          f" at the default factor 1.25 (capacity "
          f"{moe._capacity(B * S, cfg, RunConfig())}, tokens dropped by "
          f"design, not gated) rel_l2={rel_d2:.4e}, wall {wall_drop2:.3f}s",
          flush=True)
    check(max(layer_rel) <= DROPPING_REL_L2, f"qwen2-moe dropping at "
          f"capacity T vs dense: a layer's relative L2 {max(layer_rel)} > "
          f"{DROPPING_REL_L2}")
    check(rel_d <= LOGIT_REL_L2_BF16, f"qwen2-moe dropping at capacity T "
          f"vs dense, routing replayed: relative L2 {rel_d} > "
          f"{LOGIT_REL_L2_BF16}")
    del ld0, ld, ld2, flash_routes, ref_routes

    # where the time goes: MoE and attention layers timed by CUDA events
    # in one prefill, then the device's busy share and flash's under the
    # profiler in another
    torch.cuda.synchronize()
    with layer_spans([(moe, "apply", "moe"),
                        (attention, "apply", "attention")]) as spans:
        s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s0.record()
        prefill(rc_flash)
        s1.record()
        torch.cuda.synchronize()
    span_ms = s0.elapsed_time(s1)
    share = {k: sum(a.elapsed_time(b) for a, b in v) / span_ms
             for k, v in spans.items()}
    (_, _, wall_p), by_name = whole_profile(
        lambda: prefill(rc_flash), FLASH_COUNTED,
        what=f"qwen2-moe prefill B={B} S={S}", resets=True)
    flash_dev_ms = profile_report(f"qwen2-moe prefill B={B} S={S}", wall_p,
                                  by_name, L)
    print(f"  shares of the prefill's {span_ms:.1f} ms device span (CUDA "
          f"events): MoE layers {share['moe']:.4f}, attention layers "
          f"{share['attention']:.4f}; flash device ms per launch "
          f"{flash_dev_ms:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # teacher-forced decode through the caches against the forward
    toks = torch.randint(1, cfg.vocab_size, (B, TF_PROMPT + TF_STEPS),
                         generator=gen, device="cuda", dtype=torch.int32)
    rel_tf, ms_step = _teacher_forced(
        m, params, toks, TF_PROMPT, rc_flash,
        lambda: transformer.forward(params, toks, cfg, rc_flash)[0],
        "qwen2-moe", moe_calls=L)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, lf
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  memory allocated before the engine's own model "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)

    argv = ["--arch", "qwen2-moe-a2.7b", "--full", "--device", "cuda"]
    print("  python -m repro_torch.launch.serve " + " ".join(argv)
          + " (12 requests, 4 slots, s_max 128, 16 new tokens)", flush=True)
    res = serve.main(argv)
    check(res["requests"] == 12 and res["tokens"] == 12 * 16,
          f"qwen2-moe engine served {res['requests']} requests, "
          f"{res['tokens']} tokens")
    check(all(r.done and len(r.out_tokens) == 16 for r in res["finished"]),
          "qwen2-moe engine: a request did not finish with 16 tokens")
    print(f"  engine on {card}: {res['tokens'] / res['wall_s']:.2f} tok/s, "
          f"{res['steps']} steps, {res['wall_s'] / res['steps'] * 1e3:.3f} "
          f"ms per step", flush=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "wall": wall, "tok_s": B * S / wall,
            "rel_l2": rel, "rel_l2_as_init": rel0,
            "rel_dropping_layers": max(layer_rel), "rel_dropping": rel_d,
            "share": share, "flash_device_ms": flash_dev_ms,
            "decode_ms": ms_step, "rel_tf": rel_tf, "peak_gib": peak,
            "engine_tok_s": res["tokens"] / res["wall_s"],
            "engine_ms_step": res["wall_s"] / res["steps"] * 1e3}


def families_jamba(card: str):
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.configs import get_config
    from repro_torch.models import attention, moe, ssm, transformer
    from repro_torch.models.common import tree_flatten
    from repro_torch.models.config import MAMBA, MLP_MOE
    from repro_torch.models.model import Model
    from repro_torch.runconfig import RunConfig

    full_cfg = get_config("jamba-1.5-large-398b")
    cfg = full_cfg.scaled(n_layers=JAMBA_DEPTH,
                          pattern=full_cfg.pattern[:JAMBA_DEPTH])
    B, S = JAMBA_PREFILL
    kinds = ", ".join(f"{sp.kind}+{sp.mlp}" for sp in cfg.pattern)
    print(f"-- jamba-1.5-large-398b cut to {cfg.n_layers} layers ({kinds}; "
          f"full depth {full_cfg.n_layers}): d_model {cfg.d_model}, d_inner "
          f"{cfg.d_inner}, {ssm.dims(cfg)[1]} SSD heads of {ssm.HEAD_P}, N "
          f"{cfg.ssm_state_dim}, {cfg.n_experts} experts top-"
          f"{cfg.n_experts_per_tok} of width {cfg.moe_d_ff}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads; prefill B={B} S={S}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    m = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = m.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    w_gib = torch.cuda.memory_allocated() / 2**30
    print(f"random bf16 weights made on the card: {n_params} parameters "
          f"({w_gib:.2f} GiB) in {time.perf_counter() - t0:.2f} s; "
          f"reckoned transients: dense MoE [{S}x{cfg.n_experts}x"
          f"{cfg.moe_d_ff}] bf16 "
          f"{cfg.n_experts * S * cfg.moe_d_ff * 2 / 2**30:.2f} GiB x 2 plus "
          f"one relaid expert matrix "
          f"{cfg.n_experts * cfg.d_model * cfg.moe_d_ff * 2 / 2**30:.2f} GiB;"
          f" reference scores [{B},{cfg.n_heads},{S},{S}] f32 "
          f"{B * cfg.n_heads * S * S * 4 / 2**30:.2f} GiB x 3", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(14)
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    n_attn = cfg.attn_layer_count
    n_moe = sum(sp.mlp == MLP_MOE for sp in cfg.pattern)
    n_mamba = sum(sp.kind == MAMBA for sp in cfg.pattern)

    def prefill(rc):
        return _family_prefill(m, params, {"tokens": tokens}, S + 64, rc,
                               n_attn, "jamba")

    rc_flash = RunConfig(attention_impl="flash")
    _, _, wall_warm = prefill(rc_flash)
    with capture_calls(attention, "apply") as attn_calls, \
            capture_calls(moe, "apply") as moe_calls:
        lf, st, wall = prefill(rc_flash)
    launches = flash_ops.launches           # the main path's prefill
    lr, _, wall_ref = prefill(RunConfig(attention_impl="reference"))
    rel, mx, agree = _logit_gap(lf, lr)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the attention layer on its own input from the main path's prefill,
    # flash against reference.  The reference init's experts (fan-in E)
    # add ~1e4 to the residual at each MoE layer; a layer of unit scale
    # after that is below bf16's spacing there, so the logits cannot see
    # the attention layer
    a_args, a_kw, y_flash = attn_calls[0]
    y_ref = attention.apply(*a_args[:4], RunConfig(attention_impl="reference"),
                            **a_kw)
    rel_attn = rel_l2(y_flash, y_ref)
    moe_max = max(float(y.abs().max()) for _, _, (y, _) in moe_calls)
    del attn_calls, moe_calls, y_ref, y_flash, a_args
    print(f"prefill B={B} S={S} bf16 on {card}: flash wall={wall:.3f}s "
          f"({B * S / wall:.1f} tok/s; first call {wall_warm:.3f}s), "
          f"reference wall={wall_ref:.3f}s; last-token logits flash vs "
          f"reference rel_l2={rel:.4e} max_abs={mx:.4e} argmax_agreement="
          f"{agree} (limit {LOGIT_REL_L2_BF16}); the attention layer's "
          f"output flash vs reference on its prefill input rel_l2="
          f"{rel_attn:.4e} (limit {FLASH_REL_L2}); max |MoE layer output| "
          f"{moe_max:.1f}; peak memory {peak:.2f} GiB", flush=True)
    check(rel <= LOGIT_REL_L2_BF16, f"jamba prefill logits: flash vs "
          f"reference relative L2 {rel} > {LOGIT_REL_L2_BF16}")
    check(rel_attn <= FLASH_REL_L2, f"jamba attention layer: flash vs "
          f"reference relative L2 {rel_attn} > {FLASH_REL_L2}")
    check(all(bool(torch.isfinite(t).all()) for p_i, sp in
              enumerate(cfg.pattern) if sp.kind == MAMBA
              for t in st.slots[p_i]), "jamba: a non-finite SSM state")
    del lr, st
    (_, _, wall_p), by_name = whole_profile(
        lambda: prefill(rc_flash), FLASH_COUNTED,
        what=f"jamba prefill B={B} S={S}", resets=True)
    flash_dev_ms = profile_report(f"jamba prefill B={B} S={S}", wall_p,
                                  by_name, n_attn)

    toks = torch.randint(1, cfg.vocab_size, (B, JAMBA_TF_PROMPT + TF_STEPS),
                         generator=gen, device="cuda", dtype=torch.int32)
    rel_tf, ms_step = _teacher_forced(
        m, params, toks, JAMBA_TF_PROMPT, rc_flash,
        lambda: transformer.forward(params, toks, cfg, rc_flash)[0],
        "jamba", moe_calls=n_moe)
    del params, lf
    torch.cuda.empty_cache()

    # one full-width mamba layer in float32: chunked SSD vs the recurrence
    gen32 = torch.Generator(device="cuda").manual_seed(15)
    p = ssm.init(gen32, cfg, torch.float32)
    u = torch.randn((1, MAMBA_LAYER_S, cfg.d_model), generator=gen32,
                    device="cuda")
    rc = RunConfig(ssm_chunk=256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = ssm.apply(p, u, cfg, rc)
    torch.cuda.synchronize()
    t_chunk = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = ssm.ssd_reference(p, u, cfg)
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    # the planted fault: every chunk of 256 without its carried state
    fault = torch.cat([ssm.apply(p, u[:, i:i + 256], cfg, rc)
                       for i in range(0, MAMBA_LAYER_S, 256)], dim=1)
    rel_m, rel_fault = rel_l2(y, want), rel_l2(fault, want)
    print(f"  one mamba layer, float32, [1,{MAMBA_LAYER_S},{cfg.d_model}], "
          f"chunk 256 vs the sequential recurrence: rel_l2={rel_m:.4e} "
          f"(limit {MAMBA_REL_L2}); planted fault (chunks without their "
          f"carried state) rel_l2={rel_fault:.4e}; chunked {t_chunk:.3f}s, "
          f"sequential {t_seq:.3f}s", flush=True)
    check(bool(torch.isfinite(y).all()), "mamba layer: non-finite output")
    check(rel_m <= MAMBA_REL_L2, f"mamba layer: chunked vs sequential "
          f"relative L2 {rel_m} > {MAMBA_REL_L2}")
    check(rel_fault > MAMBA_REL_L2, f"mamba layer: the planted fault's "
          f"relative L2 {rel_fault} is within {MAMBA_REL_L2}")
    del p, u, y, want, fault
    torch.cuda.empty_cache()
    return {"launches": launches, "wall": wall, "tok_s": B * S / wall,
            "rel_l2": rel, "rel_attn": rel_attn, "moe_max": moe_max,
            "flash_device_ms": flash_dev_ms, "decode_ms": ms_step,
            "rel_tf": rel_tf, "peak_gib": peak, "weights_gib": w_gib,
            "n_params": n_params, "mamba": n_mamba, "moe": n_moe,
            "rel_mamba": rel_m, "S": S}


def families_whisper(card: str):
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.configs import get_config
    from repro_torch.models import whisper
    from repro_torch.models.common import tree_flatten
    from repro_torch.models.model import Model
    from repro_torch.runconfig import RunConfig
    from repro_torch.serve.engine import Engine

    cfg = get_config("whisper-tiny")
    B = WHISPER_B
    print(f"-- whisper-tiny: {cfg.n_encoder_layers} + {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads (D "
          f"{cfg.resolved_head_dim}), encoder_seq {cfg.encoder_seq}, vocab "
          f"{cfg.vocab_size}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    m = Model(cfg, device="cuda")
    params = m.init(seed=0)
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    gen = torch.Generator(device="cuda").manual_seed(16)
    frames = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device="cuda").bfloat16()
    L = cfg.n_encoder_layers + 2 * cfg.n_layers
    rc_flash = RunConfig(attention_impl="flash")
    out = {"n_params": n_params}
    for S in WHISPER_S:
        tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                               device="cuda", dtype=torch.int32)
        inputs = {"tokens": tokens, "frames": frames}

        def prefill(rc):
            return _family_prefill(m, params, inputs,
                                   S + FAMILY_DECODE_STEPS, rc, L,
                                   f"whisper S={S}")

        _, _, wall_warm = prefill(rc_flash)
        lf, st, wall = prefill(rc_flash)
        if S == WHISPER_S[0]:               # the main path's prefill
            out["launches"] = flash_ops.launches
        lr, _, wall_ref = prefill(RunConfig(attention_impl="reference"))
        rel, mx, agree = _logit_gap(lf, lr)
        print(f"prefill B={B} S={S} bf16 on {card}: flash wall="
              f"{wall:.3f}s ({B * S / wall:.1f} tok/s; first call "
              f"{wall_warm:.3f}s), reference wall={wall_ref:.3f}s; last-"
              f"token logits flash vs reference rel_l2={rel:.4e} max_abs="
              f"{mx:.4e} argmax_agreement={agree}; limit "
              f"{LOGIT_REL_L2_BF16}", flush=True)
        check(rel <= LOGIT_REL_L2_BF16, f"whisper S={S} prefill logits: "
              f"flash vs reference relative L2 {rel} > {LOGIT_REL_L2_BF16}")
        out[f"wall_{S}"], out[f"rel_l2_{S}"] = wall, rel
        if S == WHISPER_S[0]:
            # device time of each flash launch, in launch order: 4 encoder
            # (1500 x 1500), then per decoder layer self (S x S), cross
            (_, _, wall_p), by_name = whole_profile(
                lambda: prefill(rc_flash), FLASH_COUNTED,
                what=f"whisper prefill B={B} S={S}", resets=True)
            out["flash_device_ms"] = profile_report(
                f"whisper prefill B={B} S={S}", wall_p, by_name, L)
            _, us = flash_events(lambda: prefill(rc_flash))
            check(len(us) == L, f"whisper: {len(us)} flash events, want {L}")
            ne = cfg.n_encoder_layers
            out["device_ms"] = {
                "encoder": statistics.mean(us[:ne]) / 1e3,
                "self": statistics.mean(us[ne::2]) / 1e3,
                "cross": statistics.mean(us[ne + 1::2]) / 1e3}
            print("  flash device ms per launch: " + ", ".join(
                f"{k} {v:.4f}" for k, v in out["device_ms"].items()),
                flush=True)
            tok = lf[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FAMILY_DECODE_STEPS):
                logits, st = m.decode_step(params, tok, st, rc_flash)
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(bool(torch.isfinite(logits).all()),
                  "whisper decode: non-finite logits")
            check(bool((st.pos == S + FAMILY_DECODE_STEPS).all()),
                  f"whisper decode: pos {st.pos.tolist()}")
            out["decode_ms"] = dt / FAMILY_DECODE_STEPS * 1e3
            print(f"  {FAMILY_DECODE_STEPS} greedy decode steps at B={B} "
                  f"from S={S}: {out['decode_ms']:.3f} ms/step, "
                  f"{B * FAMILY_DECODE_STEPS / dt:.1f} tok/s", flush=True)
        del lf, lr, st
    toks = torch.randint(1, cfg.vocab_size,
                         (B, WHISPER_TF_PROMPT + FAMILY_DECODE_STEPS),
                         generator=gen, device="cuda", dtype=torch.int32)
    out["rel_tf"], _ = _teacher_forced(
        m, params, toks, WHISPER_TF_PROMPT, rc_flash,
        lambda: whisper.decode_train(
            params, toks, whisper.encode(params, frames, cfg, rc_flash), cfg,
            rc_flash), "whisper", extra={"frames": frames})
    try:
        Engine(m, params, RunConfig())
    except NotImplementedError as e:
        print(f"  Engine(whisper-tiny) raises NotImplementedError: {e}",
              flush=True)
    else:
        fail("Engine accepted the encoder-decoder whisper-tiny")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak memory {out['peak_gib']:.2f} GiB", flush=True)
    del params
    torch.cuda.empty_cache()
    return out


def phase_families(card: str):
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    print("== phase 12: MoE, Mamba and whisper at full width "
          f"(memory allocated at the start "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB)", flush=True)
    t_phase = time.perf_counter()
    out = {}
    for name, run in (("flash", families_flash), ("qwen2-moe", families_moe),
                      ("jamba", families_jamba),
                      ("whisper", families_whisper)):
        out[name] = run(card)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  memory allocated after {name}: "
              f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    total = time.perf_counter() - t_phase
    print(f"phase 12 total {total:.1f} s (budget {PHASE12_BUDGET_S:.0f} s)",
          flush=True)
    return {**out, "phase_s": total}


# ---------------------------------------------------------------------------
# phase 13: training (the flash backward kernel, yi-6b and whisper-tiny)
# ---------------------------------------------------------------------------

FLASH_BWD_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_bwd_wgmma.cu")
FLASH_BWD_FMA_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention_bwd.cu")
# the layers of the MoE and hybrid train steps at their microbatch of 1:
# qwen2-moe's MHA (Kh = H) and jamba's 64 heads over 8; yi-6b's on one
# chip of the production mesh
BWD_LAYER_CASES = {
    "qwen2-moe": (1, 4096, 4096, 16, 16, 128, True, None, None, "bfloat16"),
    "jamba": (1, 4096, 4096, 64, 8, 128, True, None, None, "bfloat16"),
    # yi-6b's layer on one chip of the 16 x 16 mesh (phase 14's probes)
    "yi-6b-chip": (1, 4096, 4096, 2, 1, 128, True, None, None, "bfloat16"),
    # qwen2-moe's and grok-1's (soft cap 30) on that chip (phase 14's MoE
    # cells: CHIP_FLASH_MOE)
    "qwen2-moe-chip": (1, 4096, 4096, 1, 1, 128, True, None, None,
                       "bfloat16"),
    "grok-1-chip": (1, 4096, 4096, 3, 1, 128, True, None, 30.0, "bfloat16"),
}
# B, Sq, Sk, H, Kh, D, causal, window, softcap, dtype: yi-6b's layer at
# the train step's microbatch of 1 (the path's shape) first, then at
# B=2, the MoE and hybrid steps' layers, GQA 8/1, a window of 256,
# grok-1's soft-cap, Sq != Sk without the mask, whisper's encoder (a
# ragged last tile of 1500 keys) and cross-attention, and the float32 FMA
# route at every head dim of the models.  The first four are timed.  bf16
# at D 64/128 takes the wgmma backward, float32 the FMA one.
BWD_CASES = [
    (1, 4096, 4096, 32, 4, 128, True, None, None, "bfloat16"),
    (2, 4096, 4096, 32, 4, 128, True, None, None, "bfloat16"),
    *BWD_LAYER_CASES.values(),
    (1, 512, 512, 8, 1, 128, True, None, None, "bfloat16"),
    (1, 1024, 1024, 8, 2, 128, True, 256, None, "bfloat16"),
    (1, 512, 512, 8, 8, 128, True, None, 30.0, "bfloat16"),
    (1, 300, 700, 4, 2, 64, False, None, None, "bfloat16"),
    (2, 1500, 1500, 6, 6, 64, False, None, None, "bfloat16"),
    (2, 448, 1500, 6, 6, 64, False, None, None, "bfloat16"),
    (1, 333, 333, 4, 2, 16, True, None, None, "float32"),
    (1, 333, 333, 4, 2, 32, True, 100, None, "float32"),
    (1, 333, 500, 4, 2, 64, False, None, 30.0, "float32"),
    (1, 333, 333, 4, 2, 128, True, None, None, "float32"),
]
BWD_REL = {"float32": 1e-5, "bfloat16": 1e-2}
# the wgmma backward against its plain version with P and dS rounded to
# bf16 where it rounds them (ref.attention_grads(operand_dtype=bfloat16))
BWD_REL_ROUNDED = 5e-3
FLASH_BWD_LIBRARY_FACTOR = 3.0   # the wgmma backward within 3x of SDPA's
TRAIN_ARCH = "yi-6b"
TRAIN_LAYERS = 2                 # depth 32 -> 2 (8 until phase 15 came,
                                 # 4 until phase 14's MoE cells: the
                                 # script's 1200 s); full width
TRAIN_B, TRAIN_S = 2, 4096       # global batch, sequence
TRAIN_MICRO = 1                  # two accumulation steps
TRAIN_STEPS = 4
TRAIN_CKPT_STEP = 2
TRAIN_LOSS_REL = 1e-2            # flash vs reference attention, step 1
TRAIN_GRAD_REL = 2e-2            # per leaf
WHISPER_TRAIN = (2, 448)         # B, S of the decoder; 1500 frames
WHISPER_STEPS = 4
TRAIN_SEED = 0
MLSTM_BWD_SOURCE = ("src/repro_torch/kernels/mlstm_chunk/csrc/"
                    "mlstm_chunk_bwd_wgmma.cu")
MLSTM_BWD_FMA_SOURCE = ("src/repro_torch/kernels/mlstm_chunk/csrc/"
                        "mlstm_chunk_bwd.cu")
# B, S, H, P, chunk, dtype: xlstm-1.3b's layer at the train step's
# microbatch (the path's shape, timed) first; bf16 after the wgmma forward
# at P 128 and at chunk 1024, after the FMA forward (chunk 64); float32 at
# P 16 with a chunk that is no power of two and at P 1024
MLSTM_BWD_CASES = [
    (1, 4096, 4, 1024, 256, "bfloat16"),
    (1, 512, 2, 128, 128, "bfloat16"),
    (1, 2048, 1, 64, 1024, "bfloat16"),
    (1, 256, 2, 64, 64, "bfloat16"),
    (1, 300, 2, 16, 60, "float32"),
    (1, 256, 1, 1024, 64, "float32"),
]
MLSTM_BWD_REL = {"float32": 1e-5, "bfloat16": 1e-2}
MLSTM_BWD_REL_ROUNDED = 5e-3     # against the wgmma route's rounded version
XLSTM_TRAIN_LAYERS = 8           # one period of xLSTM[7:1]: 7 mLSTM, 1 sLSTM
XLSTM_TRAIN_STEPS = 2           # step 1 pays first-use costs; step 2 is timed
XLSTM_TRAIN_B = 1               # one sequence (2 until PR 31: its sLSTM loop
                                # is ~13 s a sequence, and phase 14's SSM
                                # cells came within the script's 1200 s)


def flash_bwd_bound(B, Sq, Sk, H, Kh, D, causal, window, itemsize,
                    flops_per_s):
    """(bound_ms, bound_by, flops) of a flash backward launch set from the
    wrapper's own count (``ops.bwd_work``: the five products over the
    visible pairs; q, o, dO, dq, k, v, dk, dv moved once)."""
    from repro_torch.kernels.flash_attention import ops
    return _bound(*ops.bwd_work(B, Sq, Sk, H, Kh, D, causal, window,
                                itemsize), flops_per_s)


def bwd_without_di(q, k, v, dout, causal, window, softcap):
    """A planted fault: the plain backward with dS = P dP (the D_i term
    dropped), float32, GQA summed over each group."""
    import torch
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    rep = H // Kh
    kr = k.float().repeat_interleave(rep, dim=2)
    vr = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= ki > qi - window
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vr)
    ds = p * dp
    if softcap:
        ds = ds * (1 - (s / softcap) ** 2)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) / math.sqrt(D)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) / math.sqrt(D)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return (dq, dk.reshape(B, Sk, Kh, rep, D).sum(3),
            dv.reshape(B, Sk, Kh, rep, D).sum(3))


def train_bwd_kernel(card: str) -> dict:
    """The backward kernels against their plain versions over BWD_CASES
    (the wgmma route also against the rounded one), the planted fault
    above each limit, two calls bit-equal, the route's counter; timed at
    yi-6b's layer shape, B=1 (the train step's) and B=2, beside the plain
    version and SDPA's backward."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    print("ptxas, the wgmma backward's kernels (flash_bwd_*):\n"
          + ptxas_summary(ops._LIBS["bwd_wgmma"].report, "flash_bwd_")
          + "\nptxas, the FMA backward's kernels (flash_bwd_*):\n"
          + ptxas_summary(ops._LIBS["bwd"].report, "flash_bwd_"),
          flush=True)
    for line in ops._LIBS["bwd_wgmma"].report.splitlines():
        if "spill" in line:
            check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                  f"the wgmma backward spills: {line.strip()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {"err": {}, "rel_l2": {}}
    for case in BWD_CASES:
        B, Sq, Sk, H, Kh, D, causal, window, softcap, name = case
        dt = getattr(torch, name)
        q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(dt)
                       for s in ((B, Sq, H, D), (B, Sk, Kh, D),
                                 (B, Sk, Kh, D), (B, Sq, H, D)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        tag = (f"{name} B={B} Sq={Sq} Sk={Sk} H={H} Kh={Kh} D={D} "
               f"causal={causal} window={window} softcap={softcap} "
               f"({ops.route(dt, D)} forward)")

        def grads():
            qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
            o = ops.flash_attention(qs, ks, vs, **kw)
            check(o.grad_fn is not None, f"{tag}: no grad_fn")
            return torch.autograd.grad(o, (qs, ks, vs), do)
        which = ops.route(dt, D)
        n_bwd = (ops.launches_bwd, ops.launches_bwd_wgmma,
                 ops.launches_bwd_fma)
        got = grads()
        again = grads()
        torch.cuda.synchronize()
        d_bwd = [a - b for a, b in zip((ops.launches_bwd,
                                        ops.launches_bwd_wgmma,
                                        ops.launches_bwd_fma), n_bwd)]
        check(d_bwd == [2, 2 * (which == "wgmma"), 2 * (which == "fma")],
              f"{tag}: backward launches (all, wgmma, fma) {d_bwd}")
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        # (name, plain version, limit): the float32 one, and on the wgmma
        # route the one that rounds P and dS where the kernel does
        plains = [("float32", ref.attention_grads(q, k, v, do, **kw),
                   BWD_REL[name])]
        if which == "wgmma":
            plains.append(("rounded", ref.attention_grads(
                q, k, v, do, operand_dtype=torch.bfloat16, **kw),
                BWD_REL_ROUNDED))
        fault = bwd_without_di(q, k, v, do, causal, window, softcap)
        for g, t in zip(got, (q, k, v)):
            check(g.dtype == dt and g.shape == t.shape, f"{tag}: dtype/shape")
            check(bool(torch.isfinite(g).all()), f"{tag}: non-finite")
        for pname, want, lim in plains:
            rels = [rel_l2(g, w) for g, w in zip(got, want)]
            errs = [float((g.float() - w).abs().max())
                    for g, w in zip(got, want)]
            rel_fault = max(rel_l2(f, w) for f, w in zip(fault, want))
            print(f"  {tag} vs the {pname} plain version: rel_l2 dq/dk/dv "
                  f"= {rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e}, "
                  f"max_abs_err {max(errs):.3e}, planted fault (D_i "
                  f"dropped) {rel_fault:.3e}, limit {lim}", flush=True)
            check(max(rels) <= lim, f"{tag} vs the {pname} plain version: "
                  f"relative L2 {max(rels)} > {lim}")
            check(rel_fault > lim, f"{tag}: the planted fault's relative L2 "
                  f"{rel_fault} is within {lim} of the {pname} plain version")
            key = name if pname == "float32" else f"{name}_rounded"
            out["err"][key] = max(out["err"].get(key, 0.0), max(errs))
            out["rel_l2"][key] = max(out["rel_l2"].get(key, 0.0), max(rels))
        print(f"  {tag}: {which} backward, two calls bit-equal {same}",
              flush=True)
        check(same, f"{tag}: two calls differ")
        del fault, plains
        if case is BWD_CASES[0]:        # the path's shape
            out.update(train_bwd_timing(card, case, q, k, v, do, kw,
                                        fma=True))
        elif case is BWD_CASES[1]:
            out["b2"] = train_bwd_timing(card, case, q, k, v, do, kw)
        for arch, layer in BWD_LAYER_CASES.items():
            if case is layer:
                out.setdefault("layers", {})[arch] = train_bwd_timing(
                    card, case, q, k, v, do, kw, what=f"{arch}'s layer")
        del q, k, v, do, got
        torch.cuda.empty_cache()
    out["max_abs_err"] = max(out["err"].values())
    factor = out["ms"] / out["library_ms"]
    print(f"  the wgmma backward at the path's shape is {factor:.3f}x SDPA's "
          f"backward (limit {FLASH_BWD_LIBRARY_FACTOR}) on {card}",
          flush=True)
    check(factor <= FLASH_BWD_LIBRARY_FACTOR, f"the wgmma backward is "
          f"{factor:.3f}x SDPA's backward at the path's shape, above "
          f"{FLASH_BWD_LIBRARY_FACTOR}")
    return out


# the flash backward's profiled device ms per call in a process of its
# own: argv = case (JSON), the repo's root, its src/
FRESH_BWD = """
import json, sys
sys.path[:0] = sys.argv[2:4]
import torch
import chip_smoke
from repro_torch.kernels.flash_attention import ops
B, Sq, Sk, H, Kh, D, causal, window, softcap, name = json.loads(sys.argv[1])
dt = getattr(torch, name)
gen = torch.Generator(device="cuda").manual_seed(13)
q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(dt)
               for s in ((B, Sq, H, D), (B, Sk, Kh, D), (B, Sk, Kh, D),
                         (B, Sq, H, D)))
which = ops.route(dt, D)
o, lse = ops._forward(q, k, v, causal, window, softcap, which,
                      ops.DEFAULT_TILES[which], lse=True)
fn = lambda: ops._backward(q, k, v, o, do, lse, causal, window, softcap)
print(json.dumps(chip_smoke.device_ms(
    fn, 4, chip_smoke.bwd_counted(which), what="fresh backward")))
"""


def bwd_counted(which: str):
    """``whole_profile``'s count of a backward launch set of route
    ``which``: its kernels (names holding ``flash_bwd``) per set."""
    from repro_torch.kernels.flash_attention import ops
    return (("flash_bwd", lambda: ops.launches_bwd, ops.BWD_KERNELS[which]),)


def train_bwd_timing(card, case, q, k, v, do, kw, fma=False,
                     what="yi-6b's layer") -> dict:
    """The route's backward launch set (``ops._backward``) timed with CUDA
    events and the profiler beside SDPA's backward (in turns), the plain
    version and the bound; ``fma`` also times the FMA backward once at the
    same inputs (the earlier kernel's row in PERF).  ``what`` names the
    shape's layer."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    B, Sq, Sk, H, Kh, D = case[:6]
    which = ops.route(q.dtype, D)
    o, lse = ops._forward(q, k, v, kw["causal"], kw["window"],
                          kw["softcap"], which, ops.DEFAULT_TILES[which],
                          lse=True)

    def kernel():
        return ops._backward(q, k, v, o, do, lse, kw["causal"],
                             kw["window"], kw["softcap"])

    def plain():
        return ref.attention_grads(
            q, k, v, do, **kw,
            operand_dtype=torch.bfloat16 if which == "wgmma" else None)

    # the library: SDPA's backward on [B, H, S, D] views, GQA inside the
    # call where this torch has it (enable_gqa), else K/V repeated first
    qt = q.transpose(1, 2).detach().requires_grad_()
    try:
        kt = k.transpose(1, 2).detach().requires_grad_()
        vt = v.transpose(1, 2).detach().requires_grad_()
        lo = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
        gqa = "enable_gqa"
    except TypeError:
        kt = k.repeat_interleave(H // Kh, 2).transpose(1, 2).detach() \
            .requires_grad_()
        vt = v.repeat_interleave(H // Kh, 2).transpose(1, 2).detach() \
            .requires_grad_()
        lo = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        gqa = "K/V repeated"
    dot = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(lo, (qt, kt, vt), dot, retain_graph=True)
    lib_rel = rel_l2(library()[0].transpose(1, 2), kernel()[0])
    k_ms1 = cuda_ms(kernel, reps=5, inner=2)
    l_ms1 = cuda_ms(library, reps=5, inner=2)
    l_ms2 = cuda_ms(library, reps=5, inner=2)
    k_ms2 = cuda_ms(kernel, reps=5, inner=2)
    k_ms, l_ms = min(k_ms1, k_ms2), min(l_ms1, l_ms2)
    dev_ms = device_ms(kernel, calls=4, counted=bwd_counted(which),
                       fresh=lambda: fresh_device_ms(FRESH_BWD, list(case)),
                       what=f"backward {case[:6]}", detail=True)
    p_ms = cuda_ms(plain, reps=3, inner=1)
    fma_ms = None
    if fma:                 # the FMA backward at the same inputs, once
        n = ops.launches_bwd_fma
        fma_ms = cuda_ms(lambda: ops._backward_fma(
            q, k, v, o, do, lse, kw["causal"], kw["window"], kw["softcap"]),
            reps=2, inner=1)
        check(ops.launches_bwd_fma > n, "the FMA backward did not launch")
    b_ms, b_by, flops = flash_bwd_bound(B, Sq, Sk, H, Kh, D, True, None, 2,
                                        BF16_FLOPS_PER_S)
    print(f"  backward at {what} shape {case[:6]} causal bf16"
          + (" (the train step's microbatch)" if B == TRAIN_MICRO else "")
          + f" on "
          f"{card}: kernel_ms={k_ms:.4f} ({k_ms1:.4f}, {k_ms2:.4f}) "
          f"device_ms={dev_ms:.4f} plain_ms={p_ms:.4f} library_ms="
          f"{l_ms:.4f} ({l_ms1:.4f}, {l_ms2:.4f}; SDPA backward, {gqa}"
          f"{', no soft cap' if kw['softcap'] else ''}; "
          f"its dq vs the kernel's rel_l2 {lib_rel:.3e}) bound_ms="
          f"{b_ms:.4f} ({b_by}; {flops / 1e9:.1f} GFLOP) achieved="
          f"{flops / k_ms / 1e9:.2f} TFLOP/s (bound share "
          f"{b_ms / k_ms:.4f}); kernel / library {k_ms / l_ms:.3f}; "
          f"route {which}"
          + (f"; the FMA backward at the same inputs {fma_ms:.4f} ms "
             f"({fma_ms / k_ms:.2f}x this route)" if fma else ""),
          flush=True)
    return {"ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
            "shape": list(case[:6]), "route": which,
            **({"fma_ms": fma_ms} if fma else {})}


def compare_grads(tag, got, want, loss, loss_ref, what="flash"):
    """Loss within TRAIN_LOSS_REL and each leaf's gradient within
    TRAIN_GRAD_REL (relative L2) of the reference run (``what``: the
    kernel run's name).  The attention keys' bias has a zero gradient in
    exact arithmetic (softmax is shift-invariant along a row): it is held
    to 1e-3 of the whole gradient's norm instead."""
    import torch
    from repro_torch.models.common import tree_flatten_with_path
    pairs, w_pairs = (tree_flatten_with_path(t)[0] for t in (got, want))
    check([p for p, _ in pairs] == [p for p, _ in w_pairs],
          f"{tag}: the two gradient trees differ")
    paths = ["/" + "/".join(map(str, p)) for p, _ in pairs]
    g, w = [x for _, x in pairs], [x for _, x in w_pairs]
    total = float(torch.sqrt(sum(x.float().pow(2).sum() for x in w)))
    worst, worst_path, zero_bias = 0.0, "", 0.0
    for path, a, b in zip(paths, g, w):
        if path.endswith("/k/b"):
            zero_bias = max(zero_bias, float((a.float() - b.float()).norm()))
            continue
        r = rel_l2(a, b)
        if not r <= worst:         # a non-finite leaf is the worst
            worst, worst_path = (r if math.isfinite(r) else math.inf), path
    loss_rel = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
    print(f"  {tag}: loss {what} {float(loss):.6f} reference "
          f"{float(loss_ref):.6f} (rel {loss_rel:.3e}, limit "
          f"{TRAIN_LOSS_REL}); worst leaf gradient rel_l2 {worst:.3e} at "
          f"{worst_path} (limit {TRAIN_GRAD_REL}) over {len(g)} leaves"
          + (f"; keys' bias |diff| {zero_bias:.3e} vs gradient norm "
             f"{total:.3e}" if zero_bias else ""), flush=True)
    check(loss_rel <= TRAIN_LOSS_REL, f"{tag}: loss rel {loss_rel}")
    check(worst <= TRAIN_GRAD_REL, f"{tag}: gradient rel_l2 {worst} at "
          f"{worst_path}")
    check(zero_bias <= 1e-3 * total, f"{tag}: keys' bias gradient "
          f"{zero_bias} vs {total}")
    return {"loss_rel": loss_rel, "grad_rel_l2": worst}


def micro_grads(model, params, batch, rc, n_micro: int):
    """(loss, gradients) as the train step accumulates them over
    ``n_micro`` microbatches: float32 sums over ``loss_and_grads`` of
    each, divided by ``n_micro``."""
    from repro_torch.models.common import tree_flatten, tree_unflatten
    from repro_torch.train import train_loop as ttl
    mbs = ttl._split_micro(batch, n_micro)
    acc, loss_sum, treedef = None, 0.0, None
    for j in range(n_micro):
        loss, _, g = ttl.loss_and_grads(model, params,
                                        {key: x[j] for key, x in mbs.items()},
                                        rc)
        leaves, treedef = tree_flatten(g)
        del g
        if acc is None:
            acc = [x.float() for x in leaves]
        else:
            for a, x in zip(acc, leaves):
                a.add_(x.float())
        del leaves
        loss_sum += float(loss)
    return loss_sum / n_micro, tree_unflatten(
        treedef, [a.div_(n_micro) for a in acc])


def fingerprint(tree) -> list:
    """An exact per-leaf fingerprint: the bit patterns summed with
    position weights, in int64 on the device."""
    import torch
    from repro_torch.models.common import tree_flatten
    out = []
    for t in tree_flatten(tree)[0]:
        bits = t.detach().reshape(-1)
        bits = bits.view(torch.int16 if bits.element_size() == 2
                         else torch.int32).long()
        w = torch.arange(1, bits.numel() + 1, device=bits.device) % 1000003
        out.append((int((bits * w).sum()), int(bits.sum())))
    return out


FLASH_KINDS = (("flash_bwd", ("flash_bwd",)),
               ("flash_fwd", ("flash_wgmma", "flash_fwd")))
MLSTM_KINDS = (("mlstm_bwd", ("mlstm_bwd_",)),
               ("mlstm_fwd", ("mlstm_chunk_",)))


def train_shares(by_name: dict, named=FLASH_KINDS):
    """({kind: device µs}, {kind: kernels recorded}) by kind: each of
    ``named`` (kind, substrings of its kernels' names), in order, then
    cuBLAS, then other."""
    kinds = {**{k: 0.0 for k, _ in named}, "cublas": 0.0, "other": 0.0}
    counts = dict.fromkeys(kinds, 0)
    for name, (us, n) in by_name.items():
        kind = next((k for k, subs in named
                     if any(sub in name for sub in subs)), None)
        if kind is None:
            kind = "cublas" if any(s in name.lower() for s in (
                "gemm", "cutlass", "xmma", "nvjet", "cublas")) else "other"
        kinds[kind] += us
        counts[kind] += n
    return kinds, counts


def train_yi(card: str) -> dict:
    """yi-6b at full width, 2 layers: the train step on the flash forward
    and backward kernels, against reference attention, launch counts,
    step time, memory and shares, checkpoint-resume bit-equal."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.common import tree_flatten, tree_map
    from repro_torch.models.model import Model
    from repro_torch.runconfig import RunConfig
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as ttl
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import SyntheticDataset

    cfg = get_config(TRAIN_ARCH).scaled(n_layers=TRAIN_LAYERS)
    rc = RunConfig(microbatch=TRAIN_MICRO, remat_policy="block",
                   attention_impl="flash")
    rc_ref = RunConfig(microbatch=TRAIN_MICRO, remat_policy="block",
                       attention_impl="reference")
    model = Model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state = ttl.init_state(model, TRAIN_SEED, rc)
    n_params = sum(t.numel() for t in tree_flatten(state.params)[0])
    t0 = time.perf_counter()
    data = SyntheticDataset(TRAIN_SEED, TRAIN_B, TRAIN_S, cfg.vocab_size,
                            device="cuda")
    batches = [next(data) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    print(f"  {TRAIN_ARCH} full width, {TRAIN_LAYERS} of {32} layers: "
          f"{n_params / 1e9:.3f} B parameters (bf16, AdamW with float32 "
          f"master weights); {TRAIN_STEPS} batches of {TRAIN_B}x{TRAIN_S} "
          f"tokens made on the card in {data_s:.2f} s "
          f"(SyntheticDataset)", flush=True)

    # step 1's gradients, flash against reference attention, accumulated
    # over the microbatches as the train step accumulates them (the
    # kernels run at the step's shapes)
    n_micro = TRAIN_B // TRAIN_MICRO
    n_bwd = (ops.launches_bwd, ops.launches_bwd_wgmma)
    loss, g_flash = micro_grads(model, state.params, batches[0], rc, n_micro)
    d_bwd = (ops.launches_bwd - n_bwd[0], ops.launches_bwd_wgmma - n_bwd[1])
    check(d_bwd == (n_micro * TRAIN_LAYERS,) * 2,
          f"step-1 gradients: (all, wgmma) backward sets {d_bwd}, want "
          f"{n_micro * TRAIN_LAYERS} each")
    loss_ref, g_ref = micro_grads(model, state.params, batches[0], rc_ref,
                                  n_micro)
    cmp = compare_grads(f"{TRAIN_ARCH} step-1 gradients ({n_micro} "
                        f"microbatches of {TRAIN_MICRO}), flash vs "
                        f"reference attention", g_flash, g_ref, loss,
                        loss_ref)
    del g_flash, g_ref
    torch.cuda.empty_cache()

    step = ttl.make_train_step(model, rc, donate=True)
    want = (2 * 2 * TRAIN_LAYERS, 2 * TRAIN_LAYERS)   # micro x (fwd+remat)
    # the optimizer's share: CUDA events around each step's opt_update
    real_update, opt_ms = topt.opt_update, []

    def timed_update(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = real_update(*args, **kw)
        end.record()
        end.synchronize()
        opt_ms.append(start.elapsed_time(end))
        return out
    topt.opt_update = timed_update
    ops.reset_launch_counts()
    totals = {"fwd": 0, "bwd": 0}
    times, metrics = [], []
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cm = CheckpointManager(str(ckpt_dir))
    ckpt_s = None
    profiled = []            # steps run under the profiler
    prof = {}

    def read_profile(by_name, dt, label):
        """The shares from a profiled step, kept only when it recorded
        every flash kernel of the step: one per forward launch,
        BWD_KERNELS per backward set."""
        kinds, counts = train_shares(by_name)
        n_bwd_kernels = ops.BWD_KERNELS["wgmma"] * want[1]
        if counts != {**counts, "flash_fwd": want[0],
                      "flash_bwd": n_bwd_kernels}:
            print(f"  the profile of {label} recorded {counts} kernels, "
                  f"want flash_fwd {want[0]} and flash_bwd "
                  f"{n_bwd_kernels}", flush=True)
            return
        busy_s = sum(t for t, _ in by_name.values()) / 1e6
        shares = {k: v / 1e6 / busy_s for k, v in kinds.items()}
        shares["idle_profiled"] = max(0.0, 1.0 - busy_s / dt)
        # the backward's device time per launch set at the step's own
        # shape (B=TRAIN_MICRO)
        prof.update(shares=shares, busy_s=busy_s, label=label,
                    bwd_set_ms=kinds["flash_bwd"] / 1e3 / want[1])

    for i in range(TRAIN_STEPS):
        before = (ops.launches, ops.launches_wgmma, ops.launches_fma,
                  ops.launches_bwd, ops.launches_bwd_wgmma,
                  ops.launches_bwd_fma)
        # step 3 under the profiler for the shares; step 4 as well if
        # step 3's profile came back without all of the flash kernels
        under = i == 2 or (i == 3 and not prof)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if under:
            profiled.append(i)
            (state, met), by_name = profiled_device_us(
                lambda: step(state, batches[i]), cpu=False)
        else:
            state, met = step(state, batches[i])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = (ops.launches, ops.launches_wgmma, ops.launches_fma,
                 ops.launches_bwd, ops.launches_bwd_wgmma,
                 ops.launches_bwd_fma)
        d = [a - b for a, b in zip(after, before)]
        check(d == [want[0], want[0], 0, want[1], want[1], 0],
              f"{TRAIN_ARCH} step {i + 1}: launches (fwd, wgmma, fma, bwd, "
              f"bwd wgmma, bwd fma) {d}, want {want[0]}, {want[0]}, 0, "
              f"{want[1]}, {want[1]}, 0")
        totals["fwd"] += d[0]
        totals["bwd"] += d[3]
        m = {k: float(v) for k, v in met.items()}
        metrics.append(m)
        check(all(math.isfinite(v) for v in m.values()),
              f"step {i + 1}: {m}")
        times.append(dt)
        print(f"  step {i + 1}: loss {m['loss']:.4f} gnorm "
              f"{m['grad_norm']:.3f} lr {m['lr']:.2e}; {dt:.3f} s"
              + (" (under the profiler)" if under else "")
              + f"; launches fwd {d[0]} (wgmma {d[1]}, fma {d[2]}), "
              f"bwd {d[3]} (wgmma {d[4]}, fma {d[5]})", flush=True)
        if under:
            read_profile(by_name, dt, f"step {i + 1}")
        if i == 2:
            fp_straight = fingerprint(state)
            straight_metrics = m
        if i + 1 == TRAIN_CKPT_STEP:
            t0 = time.perf_counter()
            cm.save(TRAIN_CKPT_STEP, state)
            ckpt_s = time.perf_counter() - t0
    topt.opt_update = real_update
    peak = torch.cuda.max_memory_allocated() / 2**30
    # resume: restore step 2's checkpoint and run step 3 again
    template = tree_map(lambda t: t.to("meta"), state)
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    restored, at = cm.restore(template, device="cuda")
    restore_s = time.perf_counter() - t0
    check(at == TRAIN_CKPT_STEP, f"restored step {at}")
    restored, met = step(restored, batches[TRAIN_CKPT_STEP])
    resumed = {k: float(v) for k, v in met.items()}
    same = fingerprint(restored) == fp_straight and \
        resumed == straight_metrics
    print(f"  checkpoint at step {TRAIN_CKPT_STEP}: save {ckpt_s:.1f} s, "
          f"restore {restore_s:.1f} s ({sum(p.stat().st_size for p in ckpt_dir.rglob('*') if p.is_file()) / 2**30:.2f} GiB); step "
          f"{TRAIN_CKPT_STEP + 1} resumed bit-equal to the uninterrupted "
          f"run: {same}", flush=True)
    check(same, "checkpoint resume: step 3 differs from the uninterrupted run")
    if not prof:              # a third chance: the resumed run's step 4
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, by_name = profiled_device_us(
            lambda: step(restored, batches[TRAIN_CKPT_STEP + 1]), cpu=False)
        torch.cuda.synchronize()
        read_profile(by_name, time.perf_counter() - t0,
                     "the resumed run's step 4")
        check(bool(prof), "no profiled step recorded the flash kernels")
    del restored
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    plain_steps = [j for j in range(1, TRAIN_STEPS) if j not in profiled]
    step_s = statistics.median([times[j] for j in plain_steps])
    # the idle share against an unprofiled step's wall (the profiler
    # stretches the step it records)
    shares, busy_s, bwd_set_ms = (prof[k] for k in ("shares", "busy_s",
                                                    "bwd_set_ms"))
    shares["idle"] = max(0.0, 1.0 - busy_s / step_s)
    shares["busy_s"] = busy_s
    opt_step_ms = statistics.median([opt_ms[j] for j in plain_steps])
    shares["optimizer_of_step"] = opt_step_ms / 1e3 / step_s
    tokens = TRAIN_B * TRAIN_S
    print(f"  {TRAIN_ARCH} train step (B={TRAIN_B}, S={TRAIN_S}, microbatch "
          f"{TRAIN_MICRO}, remat block, flash) on {card}: step_s={step_s:.4f}"
          f" (steps {', '.join(f'{t:.4f}' for t in times)}), tokens/s="
          f"{tokens / step_s:.1f}, peak memory {peak:.2f} GiB; device "
          f"shares of busy time (profiled {prof['label']}; idle "
          f"against the unprofiled steps): "
          + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
          + f"; flash backward {bwd_set_ms:.4f} ms of device time a set "
          f"(B={TRAIN_MICRO}), {want[1]} x {bwd_set_ms:.4f} = "
          f"{want[1] * bwd_set_ms / 1e3:.4f} s of the step"
          + f"; the optimizer (AdamW over {n_params / 1e9:.3f} B "
          f"parameters, CUDA events) {opt_step_ms:.2f} ms a step (steps "
          + ", ".join(f"{t:.2f}" for t in opt_ms) + ")"
          + f"; launches per step fwd {want[0]}, bwd sets {want[1]}",
          flush=True)
    return {"launches_fwd": totals["fwd"], "launches_bwd": totals["bwd"],
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "optimizer_ms": opt_step_ms,
            "peak_gib": peak, "shares": shares, "steps_s": times,
            "bwd_set_device_ms": bwd_set_ms,
            "loss": [m["loss"] for m in metrics], **cmp,
            "ckpt_save_s": ckpt_s, "ckpt_restore_s": restore_s}


def train_whisper(card: str) -> dict:
    """whisper-tiny at full width: flash forward and backward on every
    attention layer (4 encoder, 4 decoder self, 4 cross), float32 and
    bf16, against reference attention; then WHISPER_STEPS steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.model import Model
    from repro_torch.runconfig import RunConfig
    from repro_torch.train import train_loop as ttl
    from repro_torch.train.data import batch_at

    cfg = get_config("whisper-tiny")
    B, S = WHISPER_TRAIN
    out = {"launches_fwd": 0, "launches_bwd": 0, "launches_bwd_wgmma": 0,
           "launches_bwd_fma": 0}
    layers = cfg.n_encoder_layers + 2 * cfg.n_layers
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        kw = dict(param_dtype=name, activation_dtype=name,
                  kv_cache_dtype=name)
        rc = RunConfig(attention_impl="flash", **kw)
        rc_ref = RunConfig(attention_impl="reference", **kw)
        model = Model(cfg, device="cuda")
        state = ttl.init_state(model, TRAIN_SEED, rc,
                               params=model.init(TRAIN_SEED, dtype=dt))
        gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
        batch = batch_at(TRAIN_SEED, 0, global_batch=B, seq_len=S,
                         vocab_size=cfg.vocab_size, device="cuda")
        batch["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device="cuda").to(dt)
        loss, _, g = ttl.loss_and_grads(model, state.params, batch, rc)
        loss_ref, _, g_ref = ttl.loss_and_grads(model, state.params, batch,
                                                rc_ref)
        cmp = compare_grads(f"whisper-tiny {name} gradients, flash vs "
                            f"reference attention", g, g_ref, loss,
                            loss_ref)
        del g, g_ref
        step = ttl.make_train_step(model, rc)
        losses = []
        which = ops.route(dt, cfg.resolved_head_dim)
        for i in range(WHISPER_STEPS):
            before = (ops.launches, ops.launches_bwd,
                      ops.launches_bwd_wgmma, ops.launches_bwd_fma)
            state, met = step(state, batch)
            torch.cuda.synchronize()
            d = (ops.launches - before[0], ops.launches_bwd - before[1],
                 ops.launches_bwd_wgmma - before[2],
                 ops.launches_bwd_fma - before[3])
            w = (layers, layers, layers * (which == "wgmma"),
                 layers * (which == "fma"))
            check(d == w, f"whisper-tiny {name} step {i + 1}: launches "
                  f"(fwd, bwd, bwd wgmma, bwd fma) {d}, want {w}")
            for key, n in zip(("launches_fwd", "launches_bwd",
                               "launches_bwd_wgmma", "launches_bwd_fma"), d):
                out[key] += n
            losses.append(float(met["loss"]))
            check(math.isfinite(losses[-1]), f"whisper {name}: loss")
        print(f"  whisper-tiny {name} (B={B}, {cfg.encoder_seq} frames, "
              f"S={S}, {which} forward and backward): "
              f"{WHISPER_STEPS} steps, losses "
              + ", ".join(f"{x:.4f}" for x in losses)
              + f"; {layers} forward launches and {layers} backward sets "
              f"per step", flush=True)
        out[name] = {**cmp, "losses": losses}
        del state, model
        torch.cuda.empty_cache()
    return out


def mlstm_bwd_bound(B, S, H, P, chunk, itemsize, flops_per_s):
    """(bound_ms, bound_by, flops) of the mLSTM backward from the
    wrapper's own count (``ops.bwd_work``)."""
    from repro_torch.kernels.mlstm_chunk import ops
    return _bound(*ops.bwd_work(B, S, H, P, chunk, itemsize), flops_per_s)


def mlstm_bwd_inputs(B, S, H, P, dt, gen):
    """q (rows scaled by 0.05 or 3 at random, so both branches of the
    denominator are taken), k ~ 2 N / sqrt(P), v ~ N, the gates and dh,
    made on the card from ``gen``; q, k, v, dh in ``dt``."""
    import torch
    dev = gen.device

    def n(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    scale = torch.where(torch.rand((B, S, H, 1), generator=gen,
                                   device=dev) < 0.5, 0.05, 3.0)
    q, k, v = n(B, S, H, P) * scale, n(B, S, H, P) * 2.0 / P ** 0.5, \
        n(B, S, H, P)
    logi = n(B, S, H)
    logf = -torch.nn.functional.softplus(-(n(B, S, H) * 2.0 + 2.0))
    return [q.to(dt), k.to(dt), v.to(dt), logi, logf], n(B, S, H, P).to(dt)


def mlstm_bwd_fault(want):
    """A planted fault: d logf of each row written to the next one."""
    import torch
    dlf = torch.roll(want[4], 1, dims=1)
    dlf[:, 0] = 0
    return (*want[:4], dlf)


def mlstm_bwd_counted(which: str = "wgmma"):
    """``whole_profile``'s count of the mLSTM backward on route ``which``:
    its kernels (names holding ``mlstm_bwd_``) per launch of that route
    (a window runs one route's backward only)."""
    from repro_torch.kernels.mlstm_chunk import ops
    counter = {"wgmma": lambda: ops.launches_bwd_wgmma,
               "fma": lambda: ops.launches_bwd_fma}[which]
    return (("mlstm_bwd_", counter, ops.BWD_KERNELS[which]),)


def train_mlstm_bwd(card: str) -> dict:
    """The mLSTM backward kernels against their plain versions over
    MLSTM_BWD_CASES: through ``mlstm_chunk``'s autograd each case takes
    its route (the wgmma backward after the wgmma forward, held also
    against the rounded plain version with both keywords; the FMA one
    otherwise), and at the wgmma cases the FMA backward runs too, called
    directly with the forward's roundings (``ops._backward(..., True)``)
    and held against ``operand_dtype=bfloat16``; the planted fault above
    each limit, two calls bit-equal, each route's counter; timed at the
    path's shape (the first case), both routes in turns."""
    import torch
    from repro_torch.kernels.mlstm_chunk import ops, ref
    print("ptxas, the wgmma backward's kernels (mlstm_bwd_wgmma_*):\n"
          + ptxas_summary(ops._LIBS["bwd_wgmma"].report, "mlstm_bwd_")
          + "\nptxas, the FMA backward's kernels (mlstm_bwd_*):\n"
          + ptxas_summary(ops._LIBS["bwd"].report, "mlstm_bwd_"),
          flush=True)
    for line in ops._LIBS["bwd_wgmma"].report.splitlines():
        if "spill" in line:
            check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                  f"the mLSTM wgmma backward spills: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(17)
    out = {"err": {}, "rel_l2": {}}
    both = dict(operand_dtype=torch.bfloat16,
                grad_operand_dtype=torch.bfloat16)

    def hold(tag, pname, got, want, lim, key):
        rels = [rel_l2(g, w) for g, w in zip(got, want)]
        errs = [float((g.float() - w).abs().max()) for g, w in zip(got, want)]
        rel_fault = max(rel_l2(f, w) for f, w in
                        zip(mlstm_bwd_fault(want), want))
        print(f"  {tag} vs the {pname} plain version: rel_l2 dq/dk/dv/"
              f"dlogi/dlogf = " + "/".join(f"{r:.3e}" for r in rels)
              + f", max_abs_err {max(errs):.3e}, planted fault (d logf "
              f"one row off) {rel_fault:.3e}, limit {lim}", flush=True)
        check(max(rels) <= lim, f"{tag} vs the {pname} plain version: "
              f"relative L2 {max(rels)} > {lim}")
        check(rel_fault > lim, f"{tag}: the planted fault's relative L2 "
              f"{rel_fault} is within {lim} of the {pname} plain version")
        out["err"][key] = max(out["err"].get(key, 0.0), max(errs))
        out["rel_l2"][key] = max(out["rel_l2"].get(key, 0.0), max(rels))

    for case in MLSTM_BWD_CASES:
        B, S, H, P, chunk, name = case
        dt = getattr(torch, name)
        args, dh = mlstm_bwd_inputs(B, S, H, P, dt, gen)
        which = ops.route(dt, P, min(chunk, S))
        tag = f"{name} B={B} S={S} H={H} P={P} chunk={chunk} ({which} route)"

        def grads():
            ins = [t.clone().requires_grad_() for t in args]
            h = ops.mlstm_chunk(*ins, chunk=chunk)
            check(h.grad_fn is not None, f"{tag}: no grad_fn")
            return h.detach(), torch.autograd.grad(h, ins, dh)
        n_bwd = (ops.launches_bwd, ops.launches_bwd_wgmma,
                 ops.launches_bwd_fma)
        h, got = grads()
        again = grads()[1]
        torch.cuda.synchronize()
        d = (ops.launches_bwd - n_bwd[0], ops.launches_bwd_wgmma - n_bwd[1],
             ops.launches_bwd_fma - n_bwd[2])
        want_d = (2, 2 * (which == "wgmma"), 2 * (which == "fma"))
        check(d == want_d, f"{tag}: backward launches (all, wgmma, fma) {d}, "
              f"want {want_d}")
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        for g, t in zip(got, args):
            check(g.dtype == t.dtype and g.shape == t.shape,
                  f"{tag}: dtype/shape")
            check(bool(torch.isfinite(g.float()).all()), f"{tag}: non-finite")
        f32 = ref.mlstm_chunkwise_grads(*args, h, dh, chunk)
        hold(tag, "float32", got, f32, MLSTM_BWD_REL[name], name)
        if which == "wgmma":
            hold(tag, "rounded (both keywords)", got,
                 ref.mlstm_chunkwise_grads(*args, h, dh, chunk, **both),
                 MLSTM_BWD_REL_ROUNDED, f"{name}_rounded")
            # the FMA backward at the same case, with the forward's
            # roundings only
            n_fma = ops.launches_bwd_fma
            fma = ops._backward(*args, h, dh, chunk, True)
            check(ops.launches_bwd_fma - n_fma == 1,
                  f"{tag}: the FMA backward did not launch once")
            ftag = f"{name} B={B} S={S} H={H} P={P} chunk={chunk} (FMA " \
                   f"backward, the forward's roundings)"
            hold(ftag, "float32", fma, f32, MLSTM_BWD_REL[name],
                 f"{name}_fma")
            hold(ftag, "forward-rounded", fma, ref.mlstm_chunkwise_grads(
                *args, h, dh, chunk, operand_dtype=torch.bfloat16),
                MLSTM_BWD_REL_ROUNDED, f"{name}_fma_rounded")
            del fma
        del f32
        print(f"  {tag}: two calls bit-equal {same}", flush=True)
        check(same, f"{tag}: two calls differ")
        if case is MLSTM_BWD_CASES[0]:
            out.update(mlstm_bwd_timing(card, case, args, h, dh))
        del args, h, dh, got
        torch.cuda.empty_cache()
    out["max_abs_err"] = max(v for k, v in out["err"].items()
                             if "fma" not in k)
    return out


# the mLSTM backward's profiled device ms per call in a process of its
# own: argv = case + route (JSON), the repo's root, its src/
FRESH_MLSTM_BWD = """
import json, sys
sys.path[:0] = sys.argv[2:4]
import torch
import chip_smoke
from repro_torch.kernels.mlstm_chunk import ops
B, S, H, P, chunk, name, which = json.loads(sys.argv[1])
gen = torch.Generator(device="cuda").manual_seed(17)
args, dh = chip_smoke.mlstm_bwd_inputs(B, S, H, P, getattr(torch, name), gen)
h = ops.mlstm_chunk(*args, chunk=chunk)
fn = (lambda: ops._backward_wgmma(*args, h, dh, chunk)) if which == "wgmma" \
    else (lambda: ops._backward(*args, h, dh, chunk, True))
print(json.dumps(chip_smoke.device_ms(
    fn, 4 if which == "wgmma" else 2, chip_smoke.mlstm_bwd_counted(which),
    what=f"fresh mLSTM {which} backward")))
"""


def mlstm_bwd_timing(card, case, args, h, dh) -> dict:
    """The wgmma backward launch (``ops._backward_wgmma``) and the FMA
    backward (``ops._backward`` with the forward's roundings) timed in
    turns with CUDA events (wgmma, FMA, FMA, wgmma), each one's device time
    and per-kernel device times under the profiler, the plain version
    (both keywords) with CUDA events, the bound and the workspace."""
    import torch
    from repro_torch.kernels.mlstm_chunk import ops, ref
    B, S, H, P, chunk, name = case
    check(ops.route(args[0].dtype, P, chunk) == "wgmma",
          f"the timed case {case} is not on the wgmma route")

    def kernel():
        return ops._backward_wgmma(*args, h, dh, chunk)

    def fma():
        return ops._backward(*args, h, dh, chunk, True)

    def plain():
        return ref.mlstm_chunkwise_grads(
            *args, h, dh, chunk, operand_dtype=torch.bfloat16,
            grad_operand_dtype=torch.bfloat16)
    turns = {"wgmma": [], "fma": []}
    for which in ("wgmma", "fma", "fma", "wgmma"):
        turns[which].append(cuda_ms(kernel if which == "wgmma" else fma,
                                    reps=5, inner=2 if which == "fma"
                                    else 10))
    k_ms, f_ms = (statistics.median(turns[w]) for w in ("wgmma", "fma"))
    per_kernel = {}
    dev_ms = device_ms(kernel, calls=4, counted=mlstm_bwd_counted("wgmma"),
                       what=f"mLSTM wgmma backward {case[:5]}", detail=True,
                       breakdown=per_kernel, fresh=lambda: fresh_device_ms(
                           FRESH_MLSTM_BWD, [*case, "wgmma"]))
    fma_kernels = {}
    fma_dev_ms = device_ms(fma, calls=2, counted=mlstm_bwd_counted("fma"),
                           what=f"mLSTM FMA backward {case[:5]}",
                           detail=True, breakdown=fma_kernels,
                           fresh=lambda: fresh_device_ms(
                               FRESH_MLSTM_BWD, [*case, "fma"]))
    p_ms = cuda_ms(plain, reps=3, inner=1)
    b_ms, b_by, flops = mlstm_bwd_bound(B, S, H, P, chunk, 2,
                                        BF16_FLOPS_PER_S)
    work = ops.wgmma_workspace_bytes(B, S, H, P, chunk)
    print(f"  mLSTM backward at xlstm-1.3b's layer {case[:5]} {name} (the "
          f"train step's microbatch) on {card}: wgmma kernel_ms={k_ms:.4f} "
          f"(turns {', '.join(f'{x:.4f}' for x in turns['wgmma'])}) "
          f"device_ms={dev_ms:.4f}; FMA backward kernel_ms={f_ms:.4f} "
          f"(turns {', '.join(f'{x:.4f}' for x in turns['fma'])}) "
          f"device_ms={fma_dev_ms:.4f}; plain_ms={p_ms:.4f} library_ms=None "
          f"(no one PyTorch call computes it) bound_ms={b_ms:.4f} ({b_by}; "
          f"{flops / 1e9:.1f} GFLOP) achieved={flops / k_ms / 1e9:.2f} "
          f"TFLOP/s (bound share {b_ms / k_ms:.4f}, FMA {b_ms / f_ms:.4f}); "
          f"wgmma workspace {work / 1e6:.1f} MB", flush=True)
    return {"ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
            "fma_ms": f_ms, "fma_device_ms": fma_dev_ms,
            "turns_ms": turns, "kernel_device_ms": per_kernel,
            "fma_kernel_device_ms": fma_kernels, "workspace_mb": work / 1e6,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "shape": list(case[:5]), "gflop": flops / 1e9}


def xlstm_train_model(dtype: str, layers: int = XLSTM_TRAIN_LAYERS):
    """(model, params, rc, n_mlstm): xlstm-1.3b at full width, the first
    ``layers`` positions of its pattern (one period by default), ``dtype``
    weights and activations, the sLSTM's recurrent weights x
    XLSTM_WREC_SCALE."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.runconfig import RunConfig
    full = get_config("xlstm-1.3b")
    cfg = full.scaled(n_layers=layers, pattern=full.pattern[:layers])
    kinds = [cfg.pattern[i % len(cfg.pattern)].kind
             for i in range(cfg.n_layers)]
    rc = RunConfig(microbatch=TRAIN_MICRO, remat_policy="block",
                   param_dtype=dtype, activation_dtype=dtype)
    model = Model(cfg, device="cuda")
    params = model.init(TRAIN_SEED, dtype=getattr(torch, dtype))
    for p in params["layers"]:
        if "slstm" in p:
            p["slstm"]["w_rec"].mul_(XLSTM_WREC_SCALE)
    return model, params, rc, kinds.count("mlstm")


@contextlib.contextmanager
def plain_mlstm():
    """The model's mLSTM runs its plain version (``ref.mlstm_chunkwise``,
    float32, no rounding) through autograd on the card: the reference."""
    from types import SimpleNamespace
    from repro_torch.kernels.mlstm_chunk import ops, ref
    from repro_torch.models import xlstm

    def plain(q, k, v, logi, logf, *, chunk):
        return ref.mlstm_chunkwise(q, k, v, logi, logf, min(chunk, q.shape[1]))
    kernel_ops, n0 = xlstm.mlstm_ops, (ops.launches, ops.launches_bwd)
    xlstm.mlstm_ops = SimpleNamespace(mlstm_chunk=plain)
    try:
        yield
    finally:
        xlstm.mlstm_ops = kernel_ops
    check((ops.launches, ops.launches_bwd) == n0,
          "the plain-version reference launched an mLSTM kernel")


def xlstm_float32_grads(card: str) -> dict:
    """A microbatch of step 1 (1 x 4096 tokens) of the same cell in
    float32 (the FMA forward, the backward without roundings): loss and
    gradients of the kernels against the plain mLSTM through autograd
    (TRAIN_LOSS_REL, TRAIN_GRAD_REL)."""
    import torch
    from repro_torch.kernels.mlstm_chunk import ops
    from repro_torch.train.data import batch_at
    model, params, rc, n_mlstm = xlstm_train_model("float32")
    batch = batch_at(TRAIN_SEED, 0, global_batch=TRAIN_MICRO,
                     seq_len=TRAIN_S, vocab_size=model.cfg.vocab_size,
                     device="cuda")
    n_micro = 1
    before = (ops.launches_fma, ops.launches_bwd, ops.launches_bwd_fma,
              ops.launches_bwd_wgmma)
    t0 = time.perf_counter()
    loss, g = micro_grads(model, params, batch, rc, n_micro)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    d = (ops.launches_fma - before[0], ops.launches_bwd - before[1],
         ops.launches_bwd_fma - before[2], ops.launches_bwd_wgmma - before[3])
    check(d == (2 * n_micro * n_mlstm, n_micro * n_mlstm, n_micro * n_mlstm,
                0), f"xlstm float32 step 1: (FMA forward, backward, FMA "
          f"backward, wgmma backward) launches {d}")
    with plain_mlstm():
        loss_ref, g_ref = micro_grads(model, params, batch, rc, n_micro)
    torch.cuda.synchronize()
    cmp = compare_grads(
        f"xlstm-1.3b float32 gradients of a microbatch of {TRAIN_MICRO}x"
        f"{TRAIN_S} (kernels {t1 - t0:.1f} s, reference "
        f"{time.perf_counter() - t1:.1f} s; {d[0]} FMA forward and {d[2]} "
        f"FMA backward launches)", g, g_ref, loss, loss_ref, what="kernels")
    del g, g_ref, params, model
    torch.cuda.empty_cache()
    return cmp


def train_xlstm(card: str) -> dict:
    """xlstm-1.3b at full width, one period of its pattern (7 mLSTM, 1
    sLSTM), bf16: XLSTM_TRAIN_STEPS train steps on the mLSTM forward and
    backward kernels with exact launch counts, step time (the last step)
    and memory; step 1's loss against the plain mLSTM's, and each of its
    backward launches held on its own inputs against the plain versions;
    the device shares of one microbatch's forward and backward under the
    profiler (half a step: the sLSTM loop's ~420k kernels; a whole step's
    ~875k took the profiler ~2 minutes to read).  Then a microbatch in
    float32 against the plain mLSTM, loss and every gradient
    (``xlstm_float32_grads``).  The bf16 step's gradients are not
    compared with the plain mLSTM's at the model level: the stack's
    gradient moves ~100x any perturbation of its forward, so the rounded
    plain version is itself ~0.3 (relative L2) from the unrounded one
    there (``tools/xlstm_grad_sensitivity.py``)."""
    import torch
    from repro_torch.kernels.mlstm_chunk import ops, ref
    from repro_torch.models.common import tree_flatten
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as ttl
    from repro_torch.train.data import SyntheticDataset

    torch.cuda.reset_peak_memory_stats()
    model, params, rc, n_mlstm = xlstm_train_model("bfloat16")
    cfg = model.cfg
    state = ttl.init_state(model, TRAIN_SEED, rc, params=params)
    del params
    n_params = sum(t.numel() for t in tree_flatten(state.params)[0])
    data = SyntheticDataset(TRAIN_SEED, XLSTM_TRAIN_B, TRAIN_S,
                            cfg.vocab_size, device="cuda")
    batches = [next(data) for _ in range(XLSTM_TRAIN_STEPS)]
    n_micro = XLSTM_TRAIN_B // TRAIN_MICRO
    print(f"  xlstm-1.3b full width, {cfg.n_layers} of 48 layers ({n_mlstm} "
          f"mLSTM, {cfg.n_layers - n_mlstm} sLSTM; sLSTM recurrent weights "
          f"x{XLSTM_WREC_SCALE}): {n_params / 1e9:.3f} B parameters (bf16, "
          f"AdamW with float32 master weights); {XLSTM_TRAIN_STEPS} batches "
          f"of {XLSTM_TRAIN_B}x{TRAIN_S} tokens, microbatch {TRAIN_MICRO}, "
          f"remat "
          f"block, chunk {rc.mlstm_chunk}", flush=True)
    # the reference loss: step 1's batch through the plain mLSTM (forward)
    mbs = ttl._split_micro(batches[0], n_micro)
    with plain_mlstm(), torch.no_grad():
        loss_ref = sum(float(model.loss(state.params, {k: x[j] for k, x in
                                                       mbs.items()}, rc)[0])
                       for j in range(n_micro)) / n_micro

    step = ttl.make_train_step(model, rc, donate=True)
    want = (2 * n_micro * n_mlstm, n_micro * n_mlstm)  # fwd (+ remat), bwd
    real_update, real_backward, opt_ms = (topt.opt_update,
                                          ops._backward_wgmma, [])
    launches_seen = []         # step 1's backward launches: inputs, outputs

    def timed_update(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = real_update(*args, **kw)
        end.record()
        end.synchronize()
        opt_ms.append(start.elapsed_time(end))
        return out

    def recording_backward(*args):
        out = real_backward(*args)
        launches_seen.append((args, out))
        return out

    def counters():
        return (ops.launches, ops.launches_wgmma, ops.launches_fma,
                ops.launches_bwd, ops.launches_bwd_wgmma,
                ops.launches_bwd_fma)
    calls = []                 # (launch deltas, wall s, metrics, optimizer ms)

    def one(i):
        nonlocal state
        before = counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batches[i])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d = [a - b for a, b in zip(counters(), before)]
        check(d == [want[0], want[0], 0, want[1], want[1], 0],
              f"xlstm step {i + 1}: launches (fwd, wgmma, fma, bwd, bwd "
              f"wgmma, bwd fma) {d}, want {want[0]}, {want[0]}, 0, "
              f"{want[1]}, {want[1]}, 0")
        calls.append((d, dt, {k: float(v) for k, v in met.items()},
                      opt_ms[-1]))
    topt.opt_update = timed_update
    ops.reset_launch_counts()
    times, metrics, step_opt_ms = [], [], []
    t_steps = time.perf_counter()
    try:
        for i in range(XLSTM_TRAIN_STEPS):
            ops._backward_wgmma = (recording_backward if i == 0
                                   else real_backward)
            one(i)
            d, dt, m, o = calls[-1]
            times.append(dt)
            metrics.append(m)
            step_opt_ms.append(o)
            check(all(math.isfinite(v) for v in m.values()),
                  f"xlstm step {i + 1}: {m}")
            print(f"  step {i + 1}: loss {m['loss']:.4f} gnorm "
                  f"{m['grad_norm']:.3f} lr {m['lr']:.2e}; {dt:.3f} s"
                  + f"; launches fwd {d[0]} (wgmma {d[1]}, fma {d[2]}), "
                  f"bwd {d[3]} (wgmma {d[4]}, fma {d[5]})", flush=True)
    finally:
        topt.opt_update, ops._backward_wgmma = real_update, real_backward
    t_steps = time.perf_counter() - t_steps
    # the device shares: one microbatch of the next batch, every mLSTM
    # kernel recorded (else retried)
    counted = (("mlstm_chunk_", lambda: ops.launches_wgmma,
                len(MLSTM_PASSES)),) + mlstm_bwd_counted("wgmma")
    mb = {k: x[0] for k, x in ttl._split_micro(batches[-1], n_micro).items()}
    small, small_dh = mlstm_bwd_inputs(1, 2 * rc.mlstm_chunk, 1, 1024,
                                       torch.bfloat16, torch.Generator(
                                           device="cuda").manual_seed(0))

    def warm():                # one forward and backward launch, small (two
        # chunks: the backward's carries run too)
        ins = [t.clone().requires_grad_() for t in small]
        torch.autograd.grad(ops.mlstm_chunk(*ins, chunk=rc.mlstm_chunk),
                            ins, small_dh)
    t0 = time.perf_counter()
    _, by_name = whole_profile(
        lambda: ttl.loss_and_grads(model, state.params, mb, rc), counted,
        cpu=False, what="xlstm microbatch", sessions=2, warm=warm)
    t_prof = time.perf_counter() - t0
    kinds_us, counts = train_shares(by_name, MLSTM_KINDS)
    busy_s = sum(t for t, _ in by_name.values()) / 1e6
    prof = {"shares": {k: v / 1e6 / busy_s for k, v in kinds_us.items()},
            "counts": counts,
            "bwd_ms": kinds_us["mlstm_bwd"] / 1e3 / (want[1] // n_micro),
            "fwd_ms": kinds_us["mlstm_fwd"] / 1e3 / (want[0] // n_micro)}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    torch.cuda.empty_cache()
    loss_rel = abs(metrics[0]["loss"] - loss_ref) / abs(loss_ref)
    # step 1's backward launches, each on its own inputs
    check(len(launches_seen) == want[1], f"step 1 recorded "
          f"{len(launches_seen)} backward launches, want {want[1]}")
    worst = {"float32": 0.0, "rounded": 0.0}
    for args, got in launches_seen:
        q, k, v, logi, logf, h, dh, c = args
        for key, od, lim in (("float32", None, MLSTM_BWD_REL["bfloat16"]),
                             ("rounded", torch.bfloat16,
                              MLSTM_BWD_REL_ROUNDED)):
            want_g = ref.mlstm_chunkwise_grads(q, k, v, logi, logf, h, dh, c,
                                               operand_dtype=od,
                                               grad_operand_dtype=od)
            r = max(rel_l2(g, w) for g, w in zip(got, want_g))
            worst[key] = max(worst[key], r)
            check(r <= lim, f"xlstm step 1, a backward launch on its own "
                  f"inputs vs the {key} plain version: relative L2 {r} > "
                  f"{lim}")
    del launches_seen
    torch.cuda.empty_cache()
    print(f"  xlstm-1.3b bf16 step 1: loss kernels {metrics[0]['loss']:.6f} "
          f"plain mLSTM {loss_ref:.6f} (rel {loss_rel:.3e}, limit "
          f"{TRAIN_LOSS_REL}); its {want[1]} backward launches on their own "
          f"inputs: worst relative L2 {worst['float32']:.3e} vs the float32 "
          f"plain version (limit {MLSTM_BWD_REL['bfloat16']}), "
          f"{worst['rounded']:.3e} vs the rounded one (limit "
          f"{MLSTM_BWD_REL_ROUNDED})", flush=True)
    check(loss_rel <= TRAIN_LOSS_REL, f"xlstm step 1: loss rel {loss_rel}")
    t0 = time.perf_counter()
    f32 = xlstm_float32_grads(card)
    t_f32 = time.perf_counter() - t0
    step_s, opt_step_ms = times[-1], step_opt_ms[-1]
    # the step's device busy time: its microbatches' as profiled, and the
    # optimizer's (CUDA events)
    busy_s = n_micro * busy_s + opt_step_ms / 1e3
    shares = dict(prof["shares"])
    shares["idle"] = max(0.0, 1.0 - busy_s / step_s)
    shares["busy_s"] = busy_s
    tokens = XLSTM_TRAIN_B * TRAIN_S
    print(f"  xlstm-1.3b train step (B={XLSTM_TRAIN_B}, S={TRAIN_S}, "
          f"microbatch {TRAIN_MICRO}, remat block, chunk {rc.mlstm_chunk}) "
          f"on {card}: "
          f"step_s={step_s:.4f} (step {XLSTM_TRAIN_STEPS}; steps "
          + ", ".join(f"{t:.4f}" for t in times) + f"), tokens/s="
          f"{tokens / step_s:.1f}, peak memory {peak:.2f} GiB; device "
          f"shares of busy time (a profiled microbatch; idle against the "
          f"step, busy = {n_micro} microbatches + the optimizer): "
          + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
          + f"; kernels recorded {prof['counts']}; mLSTM backward "
          f"{prof['bwd_ms']:.4f} ms of device time a launch, forward "
          f"{prof['fwd_ms']:.4f} ms ({want[1]} and {want[0]} a step); the "
          f"optimizer {opt_step_ms:.2f} ms a step (CUDA events); steps "
          f"{t_steps:.1f} s, profiled microbatch {t_prof:.1f} s, float32 "
          f"check {t_f32:.1f} s", flush=True)
    return {"launches_fwd": sum(c[0][0] for c in calls),
            "launches_bwd": sum(c[0][3] for c in calls),
            "launches_bwd_wgmma": sum(c[0][4] for c in calls),
            "launches_bwd_fma": sum(c[0][5] for c in calls),
            "per_step": {"fwd_wgmma": want[0], "fwd_fma": 0,
                         "bwd_wgmma": want[1], "bwd_fma": 0},
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "optimizer_ms": opt_step_ms, "peak_gib": peak, "shares": shares,
            "steps_s": times, "bwd_step_device_ms": prof["bwd_ms"],
            "fwd_step_device_ms": prof["fwd_ms"],
            "loss": [m["loss"] for m in metrics], "loss_rel": loss_rel,
            "launch_rel_l2": worst, "float32": f32}


# ---------------------------------------------------------------------------
# phase 13, continued: the MoE and hybrid train steps
# ---------------------------------------------------------------------------

MOE_TRAIN_ARCH = "qwen2-moe-a2.7b"
MOE_TRAIN_MIN_LAYERS = 2          # fewer is no stack: the phase fails
JAMBA_TRAIN_ARCH = "jamba-1.5-large-398b"
JAMBA_TRAIN_KEEP = (0, 4)         # mamba + dense, attention + dense
# step 1 runs at lr 0 (the schedule's warm-up starts there); steps 2 and 3
# are timed (jamba's step 2 also holds Adafactor against the host); step 4
# runs under the profiler.  Every step takes the same batch, so the loss's
# drop from step 1 to step 4 is the two updates' own effect
FAMILY_TRAIN_STEPS = 4
ADAFACTOR_REL = 1e-5              # the card's update vs the host's, per leaf
FAMILY_TRAIN_BUDGET_S = 90.0      # both steps together


def family_train_cut(arch: str):
    """(config, RunConfig, reduced) of the MoE or the hybrid train step at
    full width: qwen2-moe-a2.7b at the depth ``launch.dryrun.fit_depth``
    gives for the step's RunConfig (yi-6b's: microbatch 1, remat
    ``block``, flash) at TRAIN_B x TRAIN_S, at least MOE_TRAIN_MIN_LAYERS;
    jamba-1.5-large-398b cut to the pattern positions JAMBA_TRAIN_KEEP (as
    ``tests/test_torch_train._cut`` cuts) under its family's
    ``RUN_OVERRIDES`` (Adafactor, no float32 masters, remat ``full``,
    microbatch 1) with flash attention."""
    import importlib
    from repro_torch.configs import canonical, get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.runconfig import RunConfig
    full = get_config(arch)
    if arch == MOE_TRAIN_ARCH:
        rc = RunConfig(microbatch=TRAIN_MICRO, remat_policy="block",
                       attention_impl="flash")
        n = dryrun.fit_depth(full, rc, roofline.H100.hbm_bytes,
                             mode="train", batch=TRAIN_B, seq=TRAIN_S)
        check(n >= MOE_TRAIN_MIN_LAYERS, f"{arch}: fit_depth gives {n} "
              f"layers, fewer than {MOE_TRAIN_MIN_LAYERS}")
        return (full.scaled(n_layers=n), rc,
                [f"depth {full.n_layers} -> {n}"])
    check(arch == JAMBA_TRAIN_ARCH, f"no train cut for {arch}")
    over = importlib.import_module(
        f"repro_torch.configs.{canonical(arch)}").RUN_OVERRIDES
    keep = JAMBA_TRAIN_KEEP
    cfg = full.scaled(n_layers=len(keep),
                      pattern=tuple(full.pattern[i] for i in keep))
    return (cfg, RunConfig(attention_impl="flash", **over),
            [f"depth {full.n_layers} -> {len(keep)}", "MoE layers cut"])


@contextlib.contextmanager
def reused_host_heap():
    """While a host computation allocates and frees many large tensors,
    keep the freed memory in this process's heap (glibc's ``mallopt``: no
    mmap for large blocks, no trimming) so that each page is touched once
    instead of once per temporary (fresh outputs cost 3-5x preallocated
    ones on the card's host: two elementwise passes over 201M float32
    0.308-0.368 s against 0.069-0.092 s, ``tools/train_memory_stages.py``);
    then restore glibc's defaults and give the memory back
    (``malloc_trim``).  A no-op where libc has no ``mallopt``."""
    import ctypes
    try:
        libc = ctypes.CDLL("libc.so.6")
        mallopt, trim = libc.mallopt, libc.malloc_trim
    except (OSError, AttributeError):
        yield
        return
    mallopt.argtypes, mallopt.restype = [ctypes.c_int, ctypes.c_int], \
        ctypes.c_int
    trim.argtypes, trim.restype = [ctypes.c_size_t], ctypes.c_int
    m_trim_threshold, m_mmap_max = -1, -4
    mallopt(m_mmap_max, 0)
    mallopt(m_trim_threshold, -1)          # as size_t: never trim
    try:
        yield
    finally:
        mallopt(m_mmap_max, 65536)          # glibc's defaults
        mallopt(m_trim_threshold, 128 * 1024)
        trim(0)


def adafactor_vs_host(card_in, card_out, lr, rc) -> dict:
    """The card's Adafactor update (``card_out``: new parameters and state,
    copied to the host) against ``train/optimizer.py`` run on the host on
    the same gradients, state and parameters (``card_in``, copied before
    the card's update): each leaf of the new parameters and of the new
    row, column and full second moments within ADAFACTOR_REL (relative
    L2; a leaf whose host value is 0 by its absolute L2)."""
    with reused_host_heap():
        return _adafactor_vs_host(card_in, card_out, lr, rc)


def _adafactor_vs_host(card_in, card_out, lr, rc) -> dict:
    import torch
    from repro_torch.models.common import tree_flatten_with_path
    from repro_torch.train import optimizer as topt
    grads, st, params = card_in
    old = [p.clone() for _, p in tree_flatten_with_path(params)[0]]
    t0 = time.perf_counter()
    host = topt.opt_update(grads, st, params, rc, lr, donate=True)
    host_s = time.perf_counter() - t0
    worst, where, n = 0.0, "", 0
    for part, got, want in (("params", card_out[0], host[0]),
                            ("vr", card_out[1].vr, host[1].vr),
                            ("vc", card_out[1].vc, host[1].vc),
                            ("v", card_out[1].v, host[1].v)):
        pairs = tree_flatten_with_path(got)[0]
        for (path, a), (_, b) in zip(pairs, tree_flatten_with_path(want)[0]):
            if b.numel() == 0:
                continue
            n += 1
            d = float((a.float() - b.float()).norm())
            ref_norm = float(b.float().norm())
            r = d / ref_norm if ref_norm > 0 else d
            if r > worst:
                worst, where = r, f"{part}/" + "/".join(map(str, path))
    moved, differ = 0, 0
    for (_, a), (_, b), o in zip(tree_flatten_with_path(card_out[0])[0],
                                 tree_flatten_with_path(host[0])[0], old):
        moved += int((a != o).sum())
        differ += int((a != b).sum())
    total = sum(o.numel() for o in old)
    print(f"  Adafactor's update on the card vs train/optimizer.py on the "
          f"host ({torch.get_num_threads()} threads, {host_s:.1f} s) on the "
          f"same gradients and state at lr {float(lr):.3e}: worst of {n} "
          f"leaves (new parameters, vr, vc, v) relative L2 {worst:.3e} at "
          f"{where} (limit {ADAFACTOR_REL}); bf16 parameters the update "
          f"moved {moved} of {total}, {differ} differ between the card and "
          f"the host", flush=True)
    check(worst <= ADAFACTOR_REL, f"Adafactor's update on the card vs the "
          f"host: relative L2 {worst} at {where} > {ADAFACTOR_REL}")
    return {"rel_l2": worst, "leaves": n, "host_s": host_s, "moved": moved,
            "of": total, "differ": differ}


def train_family(card: str, arch: str) -> dict:
    """The MoE (qwen2-moe-a2.7b) or hybrid (the jamba cut) train step at
    full width (``family_train_cut``) on the flash forward and backward
    kernels: step 1's loss and per-leaf gradients against reference
    attention, accumulated over the microbatches as the step accumulates
    them (the MoE's routing recorded in the flash run and its top-k
    indices replayed into the reference run: a random-weight bf16 MoE is
    chaotic, PERF §6), the router's gradient finite and nonzero; then
    FAMILY_TRAIN_STEPS steps of ``make_train_step`` on one batch, each
    with exact flash launch counts; the loss's drop; jamba's Adafactor
    update against the host's (``adafactor_vs_host``); step time,
    tokens/s, peak memory, the MoE or mamba layers' share of the step's
    device span (``layer_spans``), the optimizer's (CUDA events), the
    profiled step's kernel shares and the idle share."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import moe, ssm
    from repro_torch.models.common import (tree_flatten,
                                           tree_flatten_with_path, tree_map)
    from repro_torch.models.model import Model
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as ttl
    from repro_torch.train.data import SyntheticDataset

    t_start = time.perf_counter()
    # a process's first profiler session starts CUPTI, which failed to
    # initialise when that session came with the card nearly full (after
    # a 4-layer qwen2-moe step): start it before the model is built
    profiled_device_us(lambda: torch.ones(1, device="cuda").add_(1))
    cfg, rc, reduced = family_train_cut(arch)
    rc_ref = rc.replace(attention_impl="reference")
    n_micro = TRAIN_B // TRAIN_MICRO
    n_attn = cfg.attn_layer_count
    n_moe = sum(sp.mlp == "moe" for sp in cfg.pattern) * cfg.n_groups
    kinds = ", ".join(f"{sp.kind}+{sp.mlp}" for sp in cfg.pattern)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda")
    params = model.init(TRAIN_SEED)
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    batch = next(SyntheticDataset(TRAIN_SEED, TRAIN_B, TRAIN_S,
                                  cfg.vocab_size, device="cuda"))
    print(f"-- {arch} train step: full width, {cfg.n_layers} layers "
          f"({kinds} x {cfg.n_groups}), reduced {reduced}: {n_params / 1e9:.3f}"
          f" B parameters ({rc.optimizer}, float32 masters "
          f"{rc.master_weights_f32}); one batch of {TRAIN_B}x{TRAIN_S} "
          f"(SyntheticDataset on the card), microbatch {rc.microbatch}, "
          f"remat {rc.remat_policy}, flash", flush=True)

    # step 1's gradients, flash vs reference attention (before the
    # optimizer state exists: the two float32 trees fit beside the weights)
    want = (2 * n_micro * n_attn, n_micro * n_attn)   # fwd (+ remat), bwd
    ops.reset_launch_counts()
    with (routing_replay() if n_moe else contextlib.nullcontext([])) \
            as routes:
        loss, g = micro_grads(model, params, batch, rc, n_micro)
    got = (ops.launches, ops.launches_wgmma, ops.launches_fma,
           ops.launches_bwd, ops.launches_bwd_wgmma, ops.launches_bwd_fma)
    check(got == (want[0], want[0], 0, want[1], want[1], 0),
          f"{arch} step-1 gradients: launches (fwd, wgmma, fma, bwd, bwd "
          f"wgmma, bwd fma) {got}, want {want[0]}, {want[0]}, 0, {want[1]}, "
          f"{want[1]}, 0")
    with (routing_replay(lambda i: routes[i]) if n_moe
          else contextlib.nullcontext([])) as flips:
        loss_ref, g_ref = micro_grads(model, params, batch, rc_ref, n_micro)
    routed = ""
    if n_moe:
        check(len(flips) == len(routes) == 2 * n_micro * n_moe,
              f"{arch}: {len(routes)} routings recorded, {len(flips)} "
              f"replayed, want {2 * n_micro * n_moe}")
        routed = (f" (the flash run's routing replayed into the reference "
                  f"run: {sum(flips)} of {len(flips) * TRAIN_S * TRAIN_MICRO}"
                  f" token routings had flipped)")
    cmp = compare_grads(f"{arch} step-1 gradients ({n_micro} microbatches "
                        f"of {TRAIN_MICRO}), flash vs reference attention"
                        + routed, g, g_ref, loss, loss_ref)
    if n_moe:
        router = [(p, x) for p, x in tree_flatten_with_path(g)[0]
                  if "router" in p]
        norms = [float(x.float().norm()) for _, x in router]
        print(f"  {arch}: the router's gradient norm per leaf "
              + ", ".join(f"{v:.4e}" for v in norms), flush=True)
        check(bool(router) and all(math.isfinite(v) and v > 0
                                   for v in norms),
              f"{arch}: the router's gradient {norms}")
        cmp["router_grad_norm"] = norms
    del g, g_ref, routes
    torch.cuda.empty_cache()
    t_grads = time.perf_counter() - t_start

    state = ttl.init_state(model, TRAIN_SEED, rc, params=params)
    del params
    step = ttl.make_train_step(model, rc, donate=True)
    real_update, opt_ms, held = topt.opt_update, [], {}

    def timed_update(grads, st, params, rc_, lr, donate=False,
                     placements=None):
        if len(opt_ms) == 1 and rc_.optimizer == "adafactor":
            # step 2 (the first at lr > 0): its inputs to the host first
            t0 = time.perf_counter()
            held["in"] = tree_map(lambda t: t.to("cpu"), (grads, st, params))
            held["lr"] = lr.to("cpu")
            held["copy_s"] = time.perf_counter() - t0
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = real_update(grads, st, params, rc_, lr, donate, placements)
        end.record()
        end.synchronize()
        opt_ms.append(start.elapsed_time(end))
        if "in" in held and "out" not in held:
            t0 = time.perf_counter()
            held["out"] = tree_map(lambda t: t.to("cpu"), out)
            held["copy_s"] += time.perf_counter() - t0
        return out

    def counters():
        return (ops.launches, ops.launches_wgmma, ops.launches_fma,
                ops.launches_bwd, ops.launches_bwd_wgmma,
                ops.launches_bwd_fma)
    layers = [(moe, "apply", "moe")] if n_moe else [(ssm, "apply", "mamba")]
    times, metrics, totals, prof, spans_ms = [], [], [0, 0], {}, {}
    topt.opt_update = timed_update
    ops.reset_launch_counts()
    try:
        for i in range(FAMILY_TRAIN_STEPS):
            before = counters()
            under = i == FAMILY_TRAIN_STEPS - 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if under:                  # every flash kernel recorded
                (state, met), by_name = whole_profile(
                    lambda: step(state, batch),
                    (("flash_wgmma_kernel", lambda: ops.launches_wgmma, 1),)
                    + bwd_counted("wgmma"), what=f"{arch} train step")
            elif i == 2:               # the layers' share of a timed step
                with layer_spans(layers) as spans:
                    s0, s1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    s0.record()
                    state, met = step(state, batch)
                    s1.record()
            else:
                state, met = step(state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            d = [a - b for a, b in zip(counters(), before)]
            if under:                  # a retried session ran more steps
                d = [x // (len(opt_ms) - i) for x in d]
            check(d == [want[0], want[0], 0, want[1], want[1], 0],
                  f"{arch} step {i + 1}: launches (fwd, wgmma, fma, bwd, bwd "
                  f"wgmma, bwd fma) {d}, want {want[0]}, {want[0]}, 0, "
                  f"{want[1]}, {want[1]}, 0")
            totals[0] += d[0]
            totals[1] += d[3]
            m = {k: float(v) for k, v in met.items()}
            metrics.append(m)
            times.append(dt)
            check(all(math.isfinite(v) for v in m.values()),
                  f"{arch} step {i + 1}: {m}")
            print(f"  step {i + 1}: loss {m['loss']:.6f} gnorm "
                  f"{m['grad_norm']:.4f} lr {m['lr']:.2e}; {dt:.3f} s"
                  + (" (under the profiler)" if under else "")
                  + (" (inputs and outputs of the update copied to the "
                     "host)" if i == 1 and "in" in held else "")
                  + f"; launches fwd {d[0]} (wgmma {d[1]}, fma {d[2]}), "
                  f"bwd {d[3]} (wgmma {d[4]}, fma {d[5]})", flush=True)
            if i == 2:
                span = s0.elapsed_time(s1)
                spans_ms = {k: sum(a.elapsed_time(b) for a, b in v)
                            for k, v in spans.items()}
                spans_ms["span"] = span
                spans_ms["calls"] = {k: len(v) for k, v in spans.items()}
            if under:
                kinds_us, counts = train_shares(by_name)
                busy_s = sum(t for t, _ in by_name.values()) / 1e6
                prof = {"shares": {k: v / 1e6 / busy_s
                                   for k, v in kinds_us.items()},
                        "counts": counts, "busy_s": busy_s,
                        "bwd_set_ms": kinds_us["flash_bwd"] / 1e3 / want[1],
                        "fwd_ms": kinds_us["flash_fwd"] / 1e3 / want[0]}
    finally:
        topt.opt_update = real_update
    peak = torch.cuda.max_memory_allocated() / 2**30
    drop = metrics[0]["loss"] - metrics[-1]["loss"]
    print(f"  {arch}: the loss's drop from step 1 to step "
          f"{FAMILY_TRAIN_STEPS} on one batch (updates at lr "
          + ", ".join(f"{m['lr']:.2e}" for m in metrics[:-1])
          + f" between them): {drop:.6e}", flush=True)
    check(drop > 0, f"{arch}: the loss did not drop over the steps "
          f"({[m['loss'] for m in metrics]})")
    del state
    torch.cuda.empty_cache()
    # the timed steps: 2 and 3, but a step whose update was copied out
    timed = [j for j in range(1, FAMILY_TRAIN_STEPS - 1)
             if not (j == 1 and "in" in held)]
    t_steps = time.perf_counter() - t_start - t_grads
    ada = None
    if "in" in held:
        check("out" in held, f"{arch}: the update's outputs were not held")
        ada = adafactor_vs_host(held["in"], held["out"], held["lr"], rc)
        ada["copy_s"] = held["copy_s"]
    del held
    step_s = statistics.median([times[j] for j in timed])
    opt_step_ms = statistics.median([opt_ms[j] for j in timed])
    shares = dict(prof["shares"])
    shares["idle"] = max(0.0, 1.0 - prof["busy_s"] / step_s)
    shares["busy_s"] = prof["busy_s"]
    shares["optimizer_of_step"] = opt_step_ms / 1e3 / step_s
    layer_key = "moe" if n_moe else "mamba"
    shares[f"{layer_key}_layers_of_span"] = spans_ms[layer_key] \
        / spans_ms["span"]
    tokens = TRAIN_B * TRAIN_S
    wall = time.perf_counter() - t_start
    print(f"  {arch} train step (B={TRAIN_B}, S={TRAIN_S}, microbatch "
          f"{rc.microbatch}, remat {rc.remat_policy}, {rc.optimizer}, flash)"
          f" on {card}: step_s={step_s:.4f} (step(s) "
          + ", ".join(str(j + 1) for j in timed) + "; all steps "
          + ", ".join(f"{t:.4f}" for t in times) + f"), tokens/s="
          f"{tokens / step_s:.1f}, peak memory {peak:.2f} GiB; device "
          f"shares of busy time (the profiled step; idle against the "
          f"timed steps): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                      shares.items())
          + f"; kernels recorded {prof['counts']}; the {layer_key} layers' "
          f"forward, recompute and backward {spans_ms[layer_key]:.1f} ms of "
          f"step 3's {spans_ms['span']:.1f} ms device span (CUDA events, "
          f"{spans_ms['calls'][layer_key]} spans); flash forward "
          f"{prof['fwd_ms']:.4f} ms and backward {prof['bwd_set_ms']:.4f} ms "
          f"of device time a launch ({want[0]} and {want[1]} a step); the "
          f"optimizer {opt_step_ms:.2f} ms a step (CUDA events; steps "
          + ", ".join(f"{t:.2f}" for t in opt_ms) + f"); {wall:.1f} s in "
          f"all: the model and step 1's gradients {t_grads:.1f} s, the "
          f"steps {t_steps:.1f} s"
          + (f" (the update's copies to the host {ada['copy_s']:.1f} s), "
             f"the host's Adafactor {ada['host_s']:.1f} s" if ada else ""),
          flush=True)
    return {"arch": arch, "n_layers": cfg.n_layers, "reduced": reduced,
            "params_b": n_params / 1e9, "launches_fwd": totals[0],
            "launches_bwd": totals[1],
            "per_step": {"fwd_wgmma": want[0], "bwd_wgmma": want[1]},
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "optimizer_ms": opt_step_ms, "peak_gib": peak, "shares": shares,
            "steps_s": times, "bwd_set_device_ms": prof["bwd_set_ms"],
            "fwd_device_ms": prof["fwd_ms"],
            "loss": [m["loss"] for m in metrics], "loss_drop": drop, **cmp,
            "adafactor": ada, "wall_s": wall}


def phase_train(card: str) -> dict:
    import torch
    print("== phase 13: training: the flash and mLSTM backward kernels, "
          f"yi-6b ({TRAIN_LAYERS} layers) and xlstm-1.3b "
          f"({XLSTM_TRAIN_LAYERS} layers) at full width, whisper-tiny, "
          "qwen2-moe-a2.7b (cut in depth) and the jamba cut's train steps",
          flush=True)
    t0 = time.perf_counter()
    bwd = train_bwd_kernel(card)
    torch.cuda.empty_cache()
    yi = train_yi(card)
    torch.cuda.empty_cache()
    wh = train_whisper(card)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    mlstm_bwd = train_mlstm_bwd(card)
    torch.cuda.empty_cache()
    xl = train_xlstm(card)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    fam = {}
    for name, arch in (("qwen2-moe", MOE_TRAIN_ARCH),
                       ("jamba", JAMBA_TRAIN_ARCH)):
        fam[name] = train_family(card, arch)
        torch.cuda.empty_cache()
    t3 = time.perf_counter()
    print(f"the MoE and hybrid train steps took {t3 - t2:.1f} s (budget "
          f"{FAMILY_TRAIN_BUDGET_S:.0f} s) on {card}", flush=True)
    print(f"phase 13 took {t3 - t0:.1f} s (the mLSTM backward and xlstm "
          f"training {t2 - t1:.1f} s of it)", flush=True)
    return {"bwd": bwd, "yi": yi, "whisper": wh, "mlstm_bwd": mlstm_bwd,
            "xlstm": xl, **fam, "family_s": t3 - t2}


# ---------------------------------------------------------------------------
# phase 14: the product cluster (CompiledEvaluator on the card)
# ---------------------------------------------------------------------------

PRODUCT_ARCH = "yi-6b"
# the chip's probes' depth (the chip share's cell_depth is 32 of 32): 2,
# the replica probe's.  tune()'s recommendation (microbatch 16, remat
# none, reference attention) keeps every layer's activations and float32
# scores of the chip's 16 rows, ~10.5 GiB a layer (the default, 1 row,
# peaked at 23.2 GiB over 32 layers): it ran out of the card's memory
# at 32 layers; at 4 (until the MoE cells of phase 14 came: the script's
# 1200 s) and 2 every probe fits.  `reduced` lists the cut.
PRODUCT_CHIP_LAYERS = 2
PRODUCT_LAYERS = 2               # the replica share's probes: depth 32 -> 2
PRODUCT_STEPS = 2                # timed steps after the counted warm-up
PRODUCT_LOSS_REL = 1e-2          # each probe's step-1 loss vs the default's
# step 1's gradient norm vs the default's, for the probes whose gradient is
# the default's (remat recomputes it, Adafactor only updates with it) or
# its bf16 rounding (the reduction dtype)
PRODUCT_GRAD_REL = 1e-2
PRODUCT_SAME_GRAD = ("remat-dots", "remat-full", "adafactor",
                     "bf16-allreduce")
# the loss's drop over the timed steps (the batch is the same every step,
# and step 1 is the schedule's lr 0, so the drop is the second step's
# update) vs the default's, for the probes whose update is AdamW's on that
# gradient; Adafactor's update differs and must only lower the loss
PRODUCT_DROP_REL = 0.1
PRODUCT_SAME_UPDATE = ("remat-dots", "remat-full", "bf16-allreduce")
PRODUCT_BUDGET_S = 240.0
# probes of train_4k: (name, knobs over the space's default); "recommended"
# and "expert" are filled in from phase 3 and the expert rule
PRODUCT_KNOBS = (("flash", {"attention_impl": "flash"}),
                 ("remat-dots", {"remat_policy": "dots"}),
                 ("remat-full", {"remat_policy": "full"}),
                 ("adafactor", {"optimizer": "adafactor"}),
                 ("bf16-allreduce", {"grad_allreduce_dtype": "bfloat16"}))
# the chip's probes under sequence parallelism: (name, its SP-off twin);
# each is its twin's knobs with sequence_parallel on
PRODUCT_SP = (("flash-sp", "flash"), ("recommended-sp", "recommended"))
# an SP probe's step-1 loss vs its twin's.  On the virtual chip the two
# are different functions: under SP the chip computes its 256-token block
# of the stream and its gathers tile that block 16 times, so 15/16 of the
# labels meet another position's hidden state, where the SP-off chip
# meets each label with its own.  With random weights the loss is
# logsumexp minus 16 x the label's logit (the virtual reduce of the
# chip's vocab columns), a mean over the chip's 65536 tokens of logits
# of std ~1: the two draws differ by 16 sqrt(2 x 15/16 / 65536) ~ 0.086
# nats (~0.74 % of ~11.57) at one sigma; measured 1.357e-2 on an
# NVIDIA H100 80GB HBM3.  Limit: 4 sigma.  The SP step's function is held
# on the real mesh instead (phase 15: 1e-3 of one process).
PRODUCT_SP_TWIN_REL = 3e-2
PRODUCT_MUST_FIT = {name for name, _ in PRODUCT_KNOBS} | {
    "recommended", "expert"} | {name for name, _ in PRODUCT_SP}
# yi-6b's attention layer on one chip of the 16 x 16 mesh at the space
# default's microbatch of 1: 32 / 16 q heads and the one kv head they read
# (kv_dim 512 / 16 is a quarter head: the kv columns are gathered)
CHIP_FLASH = (1, 4096, 4096, 2, 1, 128)


# the MoE families' train_4k cells at one chip's share (expert
# parallelism): (arch, depth, probes), each probe (name, knobs over the
# space's default).  qwen2-moe's 60 experts and grok-1's 8 do not divide
# the model axis of 16: the guard releases it to the experts' columns
# (1408 / 16 = 88, 32768 / 16 = 2048), so ``expert_parallel`` off is the
# same layout ("no-ep", held bit-equal to the default in its step-1 loss
# and its bytes by kind)
PRODUCT_MOE = (
    ("qwen2-moe-a2.7b", 4, (("default", {}),
                            ("flash", {"attention_impl": "flash"}),
                            ("dropping", {"moe_impl": "dropping"}),
                            ("no-ep", {"expert_parallel": False}))),
    ("grok-1-314b", 2, (("default", {}),
                        ("flash", {"attention_impl": "flash"}))))
# their layers on chip (0, 0): B, Sq, Sk, H, Kh, D and the soft cap.
# qwen2-moe: 16 / 16 MHA heads; grok-1: 48 / 16 q heads, and the chip's 3
# read kv head 0 (8 kv heads of 128 columns, 1024 / 16 = 64: half a head,
# gathered)
CHIP_FLASH_MOE = {"qwen2-moe-a2.7b": ((1, 4096, 4096, 1, 1, 128), None),
                  "grok-1-314b": ((1, 4096, 4096, 3, 1, 128), 30.0)}
PRODUCT_MOE_BUDGET_S = 200.0


def product_probe(ev, name: str, knobs: dict, base: dict) -> dict:
    """One ``CompiledEvaluator`` probe with flash's launches counted from
    0 around it (and the q / k shapes its calls saw); prints what it
    changed and what the card measured.  An out-of-memory step is an
    infeasible probe, not a failure."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops

    changed = {k: v for k, v in knobs.items() if base.get(k) != v}
    fops.reset_launch_counts()
    calls = ev.calls
    shapes, fn = set(), fops.flash_attention

    def recording(q, k, v, **kw):
        shapes.add((tuple(q.shape), tuple(k.shape)))
        return fn(q, k, v, **kw)
    fops.flash_attention = recording
    try:
        step_s = ev(knobs)
    except torch.cuda.OutOfMemoryError as e:
        step_s, oom = None, str(e).splitlines()[0][:160]
    finally:
        fops.flash_attention = fn
    launches = {"fwd": fops.launches, "fwd_wgmma": fops.launches_wgmma,
                "fwd_fma": fops.launches_fma, "bwd": fops.launches_bwd,
                "bwd_wgmma": fops.launches_bwd_wgmma}
    if step_s is None:
        print(f"  {name}: OOM ({oom}); changed {changed}", flush=True)
        return {"name": name, "feasible": False, "changed": changed,
                "launches": launches}
    rec = ev.records[ev._key(knobs)]
    r = rec["roofline"]
    loss = rec["step1_loss"]
    print(f"  {name} ({rec['share']} share, mesh {rec['mesh']}, chip "
          f"{rec['chip']}): depth {rec['n_layers']} reduced {rec['reduced']} "
          f"measured_step_s={rec['measured_step_s']:.6f} collective_s="
          f"{r['collective_s']:.6f} coll_by_kind={r['coll_by_kind']} "
          f"scored_step_s={step_s:.6f} "
          f"peak={rec['memory']['max_memory_allocated_gb']:.2f} GiB "
          f"(estimated {rec['memory']['estimated_gb']:.2f}) "
          f"mfu={rec['mfu']:.4f} tokens/s={rec['tokens_per_s']:.1f} "
          f"roofline step={r['step_s']:.6f} (compute {r['compute_s']:.6f}, "
          f"memory {r['memory_s']:.6f}; {r['dominant']}; kernels "
          f"{r['kernel_flops']:.4g} flop, {r['kernel_bytes']:.4g} B) "
          f"step1_loss={'-' if loss is None else f'{loss:.6f}'} "
          f"step_losses={rec['step_losses']} "
          f"step1_grad_norm={rec['step1_grad_norm']} "
          f"compile_s={rec['compile_s']:.2f} steps={rec['step_times_s']} "
          f"calls {calls}->{ev.calls}", flush=True)
    print(f"    changed {changed}; runconfig {rec['runconfig']}; "
          f"{rec['batch']} x {rec['seq_len']} tokens; flash launches "
          f"{launches}, q/k shapes {sorted(shapes)}", flush=True)
    return {"name": name, "feasible": True, "changed": changed,
            "step_s": step_s, "record": rec, "launches": launches,
            "shapes": sorted(shapes)}


# the flash forward's profiled device ms per call in a process of its own:
# argv = shape (JSON: B, Sq, Sk, H, Kh, D[, soft cap]; causal bf16), the
# repo's root, its src/
FRESH_FWD = """
import json, sys
sys.path[:0] = sys.argv[2:4]
import torch
import chip_smoke
from repro_torch.kernels.flash_attention import ops
B, Sq, Sk, H, Kh, D, *cap = json.loads(sys.argv[1])
gen = torch.Generator(device="cuda").manual_seed(17)
q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
           for s in ((B, Sq, H, D), (B, Sk, Kh, D), (B, Sk, Kh, D)))
print(json.dumps(chip_smoke.device_ms(
    lambda: ops.flash_attention(q, k, v, causal=True,
                                softcap=cap[0] if cap else None), 20,
    chip_smoke.FLASH_COUNTED, what="fresh forward")))
"""


def chip_flash_forward(card: str, shape=CHIP_FLASH, softcap=None,
                       what: str = "the chip's layer",
                       per_head: bool = False) -> dict:
    """The flash forward at a chip's layer (``CHIP_FLASH``, yi-6b's, by
    default; ``softcap`` grok-1's tanh cap): the kernel against its plain
    version (P rounded to bf16, relative L2 1e-2; with ``per_head`` one
    sequence and q head at a time, as phase 5 holds the prefill_32k shape:
    its float32 scores are 4.3 GB a head at 32k), timed with CUDA events
    in turns with SDPA (K/V repeated outside the timed calls; SDPA has no
    soft cap, so under one it times the uncapped function), its device
    time from a whole profiler session (here, or in a fresh process:
    ``FRESH_FWD``), the plain version's time and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref

    B, Sq, Sk, H, Kh, D = shape
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(
        torch.bfloat16) for s in ((B, Sq, H, D), (B, Sk, Kh, D),
                                  (B, Sk, Kh, D)))

    def kernel():
        return ops.flash_attention(q, k, v, causal=True, softcap=softcap)

    def plain():
        if not per_head:
            return ref.reference_attention(q, k, v, causal=True,
                                           softcap=softcap,
                                           p_dtype=torch.bfloat16)
        rep = H // Kh
        return torch.cat([torch.cat([ref.reference_attention(
            q[b:b + 1, :, h:h + 1], k[b:b + 1, :, h // rep:h // rep + 1],
            v[b:b + 1, :, h // rep:h // rep + 1], causal=True,
            softcap=softcap, p_dtype=torch.bfloat16) for h in range(H)],
            dim=2) for b in range(B)])
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(H // Kh, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(H // Kh, dim=2).transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    rel = rel_l2(kernel(), plain())
    check(rel <= FLASH_REL_L2, f"the flash layer {shape} ({what}): "
          f"kernel vs plain relative L2 {rel} > {FLASH_REL_L2}")
    l_ms1 = cuda_ms(library, reps=5, inner=10)
    k_ms1 = cuda_ms(kernel, reps=5, inner=10)
    k_ms2 = cuda_ms(kernel, reps=5, inner=10)
    l_ms2 = cuda_ms(library, reps=5, inner=10)
    k_ms, l_ms = min(k_ms1, k_ms2), min(l_ms1, l_ms2)
    p_ms = cuda_ms(plain, reps=3, inner=2)
    fresh_args = list(shape) + ([softcap] if softcap else [])
    dev_ms = device_ms(kernel, calls=20, counted=FLASH_COUNTED,
                       fresh=lambda: fresh_device_ms(FRESH_FWD, fresh_args),
                       what=f"the flash forward at {what}")
    b_ms, b_by, flops = flash_bound(B, Sq, Sk, H, Kh, D, True, 2,
                                    BF16_FLOPS_PER_S)
    print(f"  flash forward at {what} {shape} causal bf16"
          + (f" soft cap {softcap}" if softcap else "") + f" on "
          f"{card}: kernel_ms={k_ms:.4f} ({k_ms1:.4f}, {k_ms2:.4f}) "
          f"device_ms={dev_ms:.4f} plain_ms={p_ms:.4f} library_ms="
          f"{l_ms:.4f} ({l_ms1:.4f}, "
          f"{l_ms2:.4f}; SDPA{', no soft cap' if softcap else ''}) "
          f"bound_ms={b_ms:.4f} ({b_by}; "
          f"{flops / 1e9:.2f} GFLOP) kernel / library {k_ms / l_ms:.3f}; "
          f"kernel vs plain rel_l2 {rel:.3e}", flush=True)
    return {"ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
            "rel_l2": rel, "shape": list(shape), "softcap": softcap}


def check_flash_probe(f: dict, H: int, Kh: int, D: int, tag: str) -> None:
    """A flash probe's launches, counted from 0 around it: per step,
    microbatches x layers wgmma forwards (twice where the remat policy
    recomputes the group) and as many wgmma backward sets, over the
    warm-up and the timed steps, all at the chip's heads (q [micro, S, H,
    D], k [micro, S, Kh, D])."""
    rec = f["record"]
    micro = rec["runconfig"]["microbatch"] or rec["batch"]
    n_micro = rec["batch"] // min(micro, rec["batch"])
    again_fwd = 1 if rec["runconfig"]["remat_policy"] == "none" else 2
    steps = 1 + PRODUCT_STEPS
    want_fwd = steps * n_micro * rec["n_layers"] * again_fwd
    want_bwd = steps * n_micro * rec["n_layers"]
    got = f["launches"]
    check(got["fwd"] == got["fwd_wgmma"] == want_fwd and got["fwd_fma"] == 0
          and got["bwd"] == got["bwd_wgmma"] == want_bwd,
          f"{tag}: flash launches {got}, want {want_fwd} wgmma forward "
          f"and {want_bwd} wgmma backward sets")
    want_shapes = [((micro, rec["seq_len"], H, D),
                    (micro, rec["seq_len"], Kh, D))]
    check(f["shapes"] == want_shapes, f"{tag}: the flash probe's q / k "
          f"shapes {f['shapes']}, want {want_shapes} (the chip's heads)")


def product_moe(card: str) -> dict:
    """Phase 14's MoE cells: qwen2-moe's and grok-1's train_4k at one
    chip's share of the 16 x 16 mesh (``PRODUCT_MOE``), each probe a
    ``CompiledEvaluator`` call with flash counted from 0 around it; the
    flash forward at each chip's layer first (``CHIP_FLASH_MOE``), and
    each cell's ``cell_depth`` (``fit_depth`` at the chip share)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import SINGLE_POD
    from repro_torch.core.evaluators import CompiledEvaluator
    from repro_torch.core.knobs import clean_space
    from repro_torch.launch import dryrun
    from repro_torch.models.config import SHAPES_BY_NAME

    cell = SHAPES_BY_NAME["train_4k"]
    t0 = time.perf_counter()
    out = {}
    for arch, layers, probes in PRODUCT_MOE:
        cfg = get_config(arch)
        check(dryrun.resolve_share(cfg, cell) == "chip", f"phase 14: "
              f"{arch} train_4k should run at one chip's share")
        depth = dryrun.cell_depth(cfg, cell)
        print(f"  {arch} train_4k at one chip of 16 x 16: fit_depth at the "
              f"chip share {depth} of {cfg.n_layers} layers; the probes "
              f"run {layers}", flush=True)
        shape, cap = CHIP_FLASH_MOE[arch]
        layer = chip_flash_forward(card, shape, cap, f"{arch}'s chip layer")
        space, _, _ = clean_space(cfg, cell, SINGLE_POD)
        default = space.project(space.default_config())
        ev = CompiledEvaluator(cfg, cell, device="cuda", n_layers=layers,
                               steps=PRODUCT_STEPS, share="chip")
        res = {}
        for name, kn in probes:
            res[name] = product_probe(ev, f"{arch} {name}",
                                      space.project({**default, **kn}),
                                      default)
            torch.cuda.empty_cache()
        d = res["default"]
        for name, p in res.items():
            check(p["feasible"], f"phase 14: {arch}'s {name} probe ran out "
                  f"of the card's memory")
            rec = p["record"]
            check(rec["share"] == "chip" and rec["n_layers"] == layers
                  and rec["roofline"]["collective_s"] > 0
                  and all(math.isfinite(x) for x in rec["step_losses"])
                  and math.isfinite(rec["step1_grad_norm"]),
                  f"phase 14: {arch}'s {name} did not run one chip's "
                  f"share with its collectives counted and finite losses "
                  f"({rec['step_losses']}, {rec['step1_grad_norm']})")
            b = d["record"]["step1_loss"]
            p["loss_rel"] = abs(rec["step1_loss"] - b) / abs(b)
            r = rec["roofline"]
            print(f"  {arch} {name}: measured_step_s="
                  f"{rec['measured_step_s']:.6f} scored_step_s="
                  f"{p['step_s']:.6f} collective_s={r['collective_s']:.6f} "
                  f"({r['collective_bytes_per_device'] / 1e9:.3f} GB: "
                  f"{r['coll_by_kind']}) peak="
                  f"{rec['memory']['max_memory_allocated_gb']:.2f} GiB mfu="
                  f"{rec['mfu']:.4f} roofline step {r['step_s']:.6f} "
                  f"({r['dominant']}); step-1 loss {rec['step1_loss']:.6f} "
                  f"({p['loss_rel']:.3e} from the default's)", flush=True)
        if "no-ep" in res:
            t = res["no-ep"]["record"]
            check(t["step1_loss"] == d["record"]["step1_loss"]
                  and t["roofline"]["coll_by_kind"]
                  == d["record"]["roofline"]["coll_by_kind"],
                  f"phase 14: {arch} with expert_parallel off is not the "
                  f"default's layout: loss {t['step1_loss']} vs "
                  f"{d['record']['step1_loss']}, bytes "
                  f"{t['roofline']['coll_by_kind']} vs "
                  f"{d['record']['roofline']['coll_by_kind']}")
        H, Kh, D = shape[3:]
        check_flash_probe(res["flash"], H, Kh, D, f"phase 14 {arch}")
        out[arch] = {"probes": res, "flash_layer": layer, "depth": depth,
                     "layers": layers}
    total = time.perf_counter() - t0
    print(f"phase 14's MoE cells {total:.1f} s (budget "
          f"{PRODUCT_MOE_BUDGET_S:.0f} s)", flush=True)
    check(total <= PRODUCT_MOE_BUDGET_S, f"phase 14's MoE cells took "
          f"{total:.1f} s")
    return {"cells": out, "seconds": total,
            "launches_fwd": sum(p["launches"]["fwd"] for c in out.values()
                                for p in c["probes"].values()),
            "launches_bwd": sum(p["launches"]["bwd"] for c in out.values()
                                for p in c["probes"].values())}


# the SSM families' train_4k cells at one chip's share (``ssm_inner`` over
# the model axis): (arch, pattern positions kept, timed steps, probes).
# Each data rank runs one 4096-token sequence (``PRODUCT_SSM_REDUCE``,
# listed in the record's ``reduced``): at the default's microbatch of 1 its
# 16 would be 16 sLSTM loops of ~13 s a step.  xlstm-1.3b: one period (7
# mLSTM, 1 sLSTM), the space's default only (no attention: no flash
# probe); jamba: positions 0 and 1 (mamba with the dense MLP, mamba with
# the MoE: 16 experts over the model axis of 16, one a chip) with the
# default, the dropping MoE and ``expert_parallel`` off (every expert's
# columns split instead: another layout, so expected to differ)
PRODUCT_SSM = (
    ("xlstm-1.3b", tuple(range(8)), 1, (("default", {}),)),
    ("jamba-1.5-large-398b", (0, 1), PRODUCT_STEPS,
     (("default", {}), ("dropping", {"moe_impl": "dropping"}),
      ("no-ep", {"expert_parallel": False}))))
PRODUCT_SSM_REDUCE = {"batch": 1}
# xlstm-1.3b's sLSTM recurrence is chaotic at its own initialisation: its
# gradient through the 4096-step loop overflows, on one device as on the
# chip (ROADMAP C), so that cell gates its step-1 loss, not its gradient
# norm or the losses after that update
PRODUCT_SSM_OVERFLOWS = ("xlstm-1.3b",)
# xlstm-1.3b's mLSTM layer on chip (0, 0): its 4 heads of 1024 over 16
# ranks of 256 channels, so the chip runs its head whole (B S H P)
CHIP_MLSTM = (1, 4096, 1, 1024)
PRODUCT_SSM_BUDGET_S = 150.0

# the mLSTM forward's profiled device ms per call in a process of its own:
# argv = B, S, H, P, chunk (JSON; bf16), the repo's root, its src/
FRESH_MLSTM_FWD = """
import json, sys
sys.path[:0] = sys.argv[2:4]
import torch
import chip_smoke
from repro_torch.kernels.mlstm_chunk import ops
B, S, H, P, chunk = json.loads(sys.argv[1])
gen = torch.Generator(device="cuda").manual_seed(17)
args, _ = chip_smoke.mlstm_bwd_inputs(B, S, H, P, torch.bfloat16, gen)
print(json.dumps(chip_smoke.device_ms(
    lambda: ops.mlstm_chunk(*args, chunk=chunk), 10,
    [(n, lambda: ops.launches_wgmma, 1) for n in chip_smoke.MLSTM_PASSES],
    what="fresh mLSTM forward")))
"""


def chip_mlstm_layer(card: str, shape=CHIP_MLSTM,
                     kinds=("fwd", "bwd"), what: str = "chip layer") -> dict:
    """The mLSTM kernels at xlstm-1.3b's chip layer (``shape``,
    ``CHIP_MLSTM`` by default, bf16, chunk 256): one wgmma forward and one
    wgmma backward launch against their plain versions with the route's
    roundings (relative L2 ``MLSTM_REL_L2`` and
    ``MLSTM_BWD_REL_ROUNDED``), each of ``kinds`` timed with CUDA events
    beside its plain version, its device time from a whole profiler
    session (or a fresh process: ``FRESH_MLSTM_FWD``,
    ``FRESH_MLSTM_BWD``) and its bound."""
    import torch
    from repro_torch.kernels.mlstm_chunk import ops, ref

    B, S, H, P = shape
    chunk = MLSTM_CHUNKS[0]
    check(ops.route(torch.bfloat16, P, chunk) == "wgmma",
          f"the {what} of the mLSTM {shape} is not on the wgmma route")
    gen = torch.Generator(device="cuda").manual_seed(17)
    args, dh = mlstm_bwd_inputs(B, S, H, P, torch.bfloat16, gen)
    before = (ops.launches_wgmma, ops.launches_fma, ops.launches_bwd_wgmma,
              ops.launches_bwd_fma)
    h = ops.mlstm_chunk(*args, chunk=chunk)
    got = ops._backward_wgmma(*args, h, dh, chunk)
    torch.cuda.synchronize()
    after = (ops.launches_wgmma, ops.launches_fma, ops.launches_bwd_wgmma,
             ops.launches_bwd_fma)
    check(tuple(a - b for a, b in zip(after, before)) == (1, 0, 1, 0),
          f"the chip's mLSTM layer: launches {before} -> {after}, want one "
          f"wgmma forward and one wgmma backward")
    want = ops.plain_version(*args, chunk)
    rel_f = rel_l2(h, want)
    err_f = float((h.float() - want.float()).abs().max())
    grads = ref.mlstm_chunkwise_grads(
        *args, h, dh, chunk, operand_dtype=torch.bfloat16,
        grad_operand_dtype=torch.bfloat16)
    rels_b = [rel_l2(g, w) for g, w in zip(got, grads)]
    err_b = max(float((g.float() - w).abs().max())
                for g, w in zip(got, grads))
    for t in (h, *got):
        check(bool(torch.isfinite(t.float()).all()),
              "the chip's mLSTM layer: a non-finite output")
    check(rel_f <= MLSTM_REL_L2, f"the mLSTM forward at the {what} {shape}: "
          f"relative L2 {rel_f} > {MLSTM_REL_L2}")
    check(max(rels_b) <= MLSTM_BWD_REL_ROUNDED, f"the mLSTM backward at the "
          f"{what} {shape}: relative L2 {max(rels_b)} > "
          f"{MLSTM_BWD_REL_ROUNDED}")
    del want, grads

    def fwd():
        return ops.mlstm_chunk(*args, chunk=chunk)

    def bwd():
        return ops._backward_wgmma(*args, h, dh, chunk)
    out = {}
    for kind, kernel, plain, counted, script, bound in (
            ("fwd", fwd, lambda: ops.plain_version(*args, chunk),
             [(n, lambda: ops.launches_wgmma, 1) for n in MLSTM_PASSES],
             FRESH_MLSTM_FWD, mlstm_bound),
            ("bwd", bwd, lambda: ref.mlstm_chunkwise_grads(
                *args, h, dh, chunk, operand_dtype=torch.bfloat16,
                grad_operand_dtype=torch.bfloat16),
             mlstm_bwd_counted("wgmma"), FRESH_MLSTM_BWD, mlstm_bwd_bound)):
        if kind not in kinds:
            continue
        k_ms = cuda_ms(kernel, reps=5, inner=4)
        p_ms = cuda_ms(plain, reps=3, inner=1)
        arg = [B, S, H, P, chunk] if kind == "fwd" \
            else [B, S, H, P, chunk, "bfloat16", "wgmma"]
        dev = device_ms(kernel, calls=10 if kind == "fwd" else 4,
                        counted=counted, what=f"the mLSTM {kind} at the "
                        f"{what} {shape}",
                        fresh=lambda a=arg, sc=script: fresh_device_ms(sc, a))
        b_ms, b_by, flops = bound(B, S, H, P, chunk, 2, BF16_FLOPS_PER_S)
        out[kind] = {"ms": k_ms, "device_ms": dev, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "shape": [B, S, H, P, chunk],
                     "rel_l2": rel_f if kind == "fwd" else max(rels_b),
                     "max_abs_err": err_f if kind == "fwd" else err_b}
        print(f"  mLSTM {kind} at xlstm-1.3b's {what} {shape} "
              f"chunk {chunk} bf16 on {card}: kernel_ms={k_ms:.4f} "
              f"device_ms={dev:.4f} plain_ms={p_ms:.4f} library_ms=None "
              f"bound_ms={b_ms:.4f} ({b_by}; {flops / 1e9:.1f} GFLOP; "
              f"device / bound {dev / b_ms:.2f}); kernel vs plain rel_l2 "
              f"{out[kind]['rel_l2']:.3e}, max_abs_err "
              f"{out[kind]['max_abs_err']:.3e}", flush=True)
    del args, dh, h, got
    torch.cuda.empty_cache()
    return out


def ssm_probe(ev, name: str, knobs: dict, base: dict) -> dict:
    """``product_probe`` with the mLSTM wrapper's launches counted from 0
    around it too."""
    from repro_torch.kernels.mlstm_chunk import ops

    ops.reset_launch_counts()
    p = product_probe(ev, name, knobs, base)
    p["mlstm"] = {k: getattr(ops, f"launches{s}") for k, s in (
        ("fwd", ""), ("fwd_wgmma", "_wgmma"), ("fwd_fma", "_fma"),
        ("bwd", "_bwd"), ("bwd_wgmma", "_bwd_wgmma"),
        ("bwd_fma", "_bwd_fma"))}
    print(f"    mLSTM launches {p['mlstm']}", flush=True)
    return p


def product_ssm(card: str) -> dict:
    """Phase 14's SSM cells: xlstm-1.3b's and jamba's train_4k at one
    chip's share of the 16 x 16 mesh (``PRODUCT_SSM``), each probe a
    ``CompiledEvaluator`` call with the mLSTM and flash wrappers' launches
    counted from 0 around it; first the mLSTM kernels at the chip's layer
    (``chip_mlstm_layer``), and each cell's ``cell_depth`` at the chip
    share (recorded, not run)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import SINGLE_POD
    from repro_torch.core.evaluators import CompiledEvaluator
    from repro_torch.core.knobs import clean_space
    from repro_torch.launch import dryrun
    from repro_torch.models.config import SHAPES_BY_NAME
    from repro_torch.models.moe import EXPERT_AXES, _expert_ff
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import compute_range

    cell = SHAPES_BY_NAME["train_4k"]
    t0 = time.perf_counter()
    layer = chip_mlstm_layer(card)
    out = {}
    for arch, keep, steps, probes in PRODUCT_SSM:
        full = get_config(arch)
        check(dryrun.resolve_share(full, cell) == "chip", f"phase 14: "
              f"{arch} train_4k should run at one chip's share")
        depth = dryrun.cell_depth(full, cell, reduce=PRODUCT_SSM_REDUCE)
        cfg = full.scaled(n_layers=len(keep),
                          pattern=tuple(full.pattern[i] for i in keep))
        print(f"  {arch} train_4k at one chip of 16 x 16, one sequence a "
              f"data rank: fit_depth at the chip share {depth} of "
              f"{full.n_layers} layers (recorded, not run); the probes run "
              f"pattern positions {list(keep)}, 1 warm-up + {steps} timed "
              f"step(s)", flush=True)
        space, _, _ = clean_space(full, cell, SINGLE_POD)
        default = space.project(space.default_config())
        ev = CompiledEvaluator(cfg, cell, device="cuda", n_layers=len(keep),
                               steps=steps, share="chip",
                               reduce=PRODUCT_SSM_REDUCE)
        res = {}
        for name, kn in probes:
            res[name] = ssm_probe(ev, f"{arch} {name}",
                                  space.project({**default, **kn}), default)
            torch.cuda.empty_cache()
        n_mlstm = sum(s.kind == "mlstm" for s in cfg.pattern)
        for name, p in res.items():
            check(p["feasible"], f"phase 14: {arch}'s {name} probe ran out "
                  f"of the card's memory")
            rec = p["record"]
            r = rec["roofline"]
            if arch in PRODUCT_SSM_OVERFLOWS:
                finite, what = [rec["step1_loss"]], "step-1 loss"
            else:
                finite = rec["step_losses"] + [rec["step1_grad_norm"]]
                what = "losses and gradient norm"
            check(rec["share"] == "chip" and rec["n_layers"] == len(keep)
                  and r["collective_s"] > 0
                  and r["coll_by_kind"].get(collectives.ALL_TO_ALL, 0) > 0
                  and all(math.isfinite(x) for x in finite),
                  f"phase 14: {arch}'s {name} did not run one chip's share "
                  f"with its collectives (the [x | z] regroup's all-to-all "
                  f"among them) and finite {what} ({rec['step_losses']}, "
                  f"{rec['step1_grad_norm']}, {r['coll_by_kind']})")
            micro = rec["runconfig"]["microbatch"] or rec["batch"]
            n_micro = rec["batch"] // min(micro, rec["batch"])
            again = 1 if rec["runconfig"]["remat_policy"] == "none" else 2
            want_fwd = (1 + steps) * n_micro * n_mlstm * again
            want_bwd = (1 + steps) * n_micro * n_mlstm
            m = p["mlstm"]
            check(m["fwd"] == m["fwd_wgmma"] == want_fwd and m["fwd_fma"] == 0
                  and m["bwd"] == m["bwd_wgmma"] == want_bwd
                  and m["bwd_fma"] == 0, f"phase 14: {arch}'s {name}: "
                  f"mLSTM launches {m}, want {want_fwd} wgmma forwards and "
                  f"{want_bwd} wgmma backwards, no FMA")
            print(f"  {arch} {name}: measured_step_s="
                  f"{rec['measured_step_s']:.6f} scored_step_s="
                  f"{p['step_s']:.6f} collective_s={r['collective_s']:.6f} "
                  f"({r['collective_bytes_per_device'] / 1e9:.3f} GB: "
                  f"{r['coll_by_kind']}) peak="
                  f"{rec['memory']['max_memory_allocated_gb']:.2f} GiB "
                  f"(estimate_bytes {rec['memory']['estimated_gb']:.2f}) "
                  f"mfu={rec['mfu']:.4f}; step-1 loss "
                  f"{rec['step1_loss']:.6f}, gradient norm "
                  f"{rec['step1_grad_norm']}; reduced {rec['reduced']}",
                  flush=True)
        d = res["default"]["record"]
        if "no-ep" in res:
            rc = dryrun.default_runconfig(full, cell)
            dims = (full.n_experts, full.d_model, _expert_ff(full))
            chip = dryrun.production_chip()
            check(compute_range(EXPERT_AXES, dims, 0, rc.shard, chip)
                  == (0, 1), f"phase 14: {arch}'s chip does not hold one "
                  f"expert")
            t = res["no-ep"]["record"]
            check(t["roofline"]["coll_by_kind"]
                  != d["roofline"]["coll_by_kind"], f"phase 14: {arch} with "
                  f"expert_parallel off moved the default's bytes "
                  f"{d['roofline']['coll_by_kind']}: the layouts should "
                  f"differ")
        out[arch] = {"probes": res, "depth": depth, "keep": list(keep)}
    total = time.perf_counter() - t0
    print(f"phase 14's SSM cells {total:.1f} s (budget "
          f"{PRODUCT_SSM_BUDGET_S:.0f} s)", flush=True)
    check(total <= PRODUCT_SSM_BUDGET_S, f"phase 14's SSM cells took "
          f"{total:.1f} s")
    probes = [p for c in out.values() for p in c["probes"].values()]
    return {"cells": out, "chip_layer": layer, "seconds": total,
            "launches_fwd": sum(p["mlstm"]["fwd"] for p in probes),
            "launches_bwd": sum(p["mlstm"]["bwd"] for p in probes)}


# the serving cells at one chip's share of the 16 x 16 mesh (prefill and
# decode under the mesh): (name, arch, shape, pattern positions kept (None:
# the first PRODUCT_CHIP_LAYERS layers), reduce, timed steps, knobs over
# the family default).  xlstm-1.3b: one period at 4096 tokens (its sLSTM
# loop is ~8 s a 4096-token prefill, and prefill_32k's 32768 would be
# ~65 s a step), 1 timed step; jamba's long_500k decode at pattern
# positions 0-4, whose last is its attention layer: one token against
# the chip's 32768 of the 524288 cached positions (``shard_kv_seq``, the
# cell's default, splits the cache's sequence over the 16 data ranks:
# the batch of 1 does not divide them)
PRODUCT_SERVE = (
    ("yi-6b prefill_32k", "yi-6b", "prefill_32k", None, None,
     PRODUCT_STEPS, {}),
    ("yi-6b prefill_32k flash", "yi-6b", "prefill_32k", None, None,
     PRODUCT_STEPS, {"attention_impl": "flash"}),
    ("yi-6b decode_32k", "yi-6b", "decode_32k", None, None, PRODUCT_STEPS,
     {}),
    ("qwen2-moe prefill_32k", "qwen2-moe-a2.7b", "prefill_32k", None, None,
     PRODUCT_STEPS, {}),
    ("xlstm-1.3b prefill", "xlstm-1.3b", "prefill_32k", tuple(range(8)),
     {"seq": 4096}, 1, {}),
    ("jamba long_500k", "jamba-1.5-large-398b", "long_500k",
     (0, 1, 2, 3, 4), None, PRODUCT_STEPS, {}),
)
# yi-6b's prefill_32k layer on chip (0, 0): its data rank's 2 sequences of
# 32768, 2 q heads over the one kv head they read
CHIP_FLASH_32K = (2, 32768, 32768, 2, 1, 128)
# xlstm-1.3b's prefill layer on chip (0, 0): 2 sequences, its cut head whole
CHIP_MLSTM_PREFILL = (2, 4096, 1, 1024)
PRODUCT_SERVE_BUDGET_S = 120.0       # the probes, not the kernel checks


def product_serving(card: str) -> dict:
    """Phase 14's serving cells at one chip's share of the 16 x 16 mesh
    (``PRODUCT_SERVE``), each probe a ``CompiledEvaluator`` call with the
    flash and mLSTM wrappers' launches counted from 0 around it; first
    the flash forward at yi-6b's prefill_32k chip layer
    (``CHIP_FLASH_32K``) and the mLSTM forward at xlstm-1.3b's prefill
    chip layer (``CHIP_MLSTM_PREFILL``) against their plain versions,
    timed beside them (and SDPA); decode_32k once more at one replica's
    share, its reading before the chip share."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.evaluators import CompiledEvaluator
    from repro_torch.launch import dryrun
    from repro_torch.models.config import SHAPES_BY_NAME

    print(f"  the serving cells at one chip's share of the 16 x 16 mesh "
          f"(prefill and decode under the mesh)", flush=True)
    t_k = time.perf_counter()
    flash32k = chip_flash_forward(card, CHIP_FLASH_32K, per_head=True,
                                  what="yi-6b's prefill_32k chip layer")
    torch.cuda.empty_cache()
    mlstm = chip_mlstm_layer(card, CHIP_MLSTM_PREFILL, kinds=("fwd",),
                             what="prefill chip layer")["fwd"]
    torch.cuda.empty_cache()
    kernels_s = time.perf_counter() - t_k
    t0 = time.perf_counter()
    out = {}
    for name, arch, shape, keep, reduce, steps, knobs in PRODUCT_SERVE:
        full, cell = get_config(arch), SHAPES_BY_NAME[shape]
        check(dryrun.resolve_share(full, cell) == "chip", f"phase 14: "
              f"{arch} {shape} should run at one chip's share")
        if keep is None:
            cfg, depth = full, PRODUCT_CHIP_LAYERS
        else:
            cfg = full.scaled(n_layers=len(keep),
                              pattern=tuple(full.pattern[i] for i in keep))
            depth = len(keep)
        ev = CompiledEvaluator(cfg, cell, device="cuda", n_layers=depth,
                               steps=steps, share="chip", reduce=reduce)
        p = ssm_probe(ev, name, knobs, {})
        check(p["feasible"], f"phase 14: {name} ran out of the card's "
              f"memory")
        rec = p["record"]
        check(rec["share"] == "chip" and rec["outputs_finite"]
              and rec["roofline"]["collective_s"] > 0, f"phase 14: {name} "
              f"did not run one chip's share with its collectives counted "
              f"and finite logits")
        p["steps"] = steps
        out[name] = p
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    # yi-6b's prefill under flash: one wgmma forward a layer and step at
    # the chip's heads
    f = out["yi-6b prefill_32k flash"]
    want = (1 + PRODUCT_STEPS) * PRODUCT_CHIP_LAYERS
    B, S, _, H, Kh, D = CHIP_FLASH_32K
    check(f["launches"]["fwd"] == f["launches"]["fwd_wgmma"] == want
          and f["launches"]["fwd_fma"] == 0, f"phase 14: the prefill_32k "
          f"flash probe's launches {f['launches']}, want {want} wgmma "
          f"forwards and no FMA")
    check(f["shapes"] == [((B, S, H, D), (B, S, Kh, D))], f"phase 14: the "
          f"prefill_32k flash probe's q / k shapes {f['shapes']}, want the "
          f"chip's {[((B, S, H, D), (B, S, Kh, D))]}")
    x = out["xlstm-1.3b prefill"]
    want = (1 + x["steps"]) * 7
    m = x["mlstm"]
    check(m["fwd"] == m["fwd_wgmma"] == want and m["fwd_fma"] == 0,
          f"phase 14: the xLSTM prefill's mLSTM launches {m}, want {want} "
          f"wgmma forwards (7 a step) and no FMA")
    for name, p in out.items():
        if name != "yi-6b prefill_32k flash":
            check(p["launches"]["fwd"] == 0, f"phase 14: {name} launched "
                  f"flash ({p['launches']}) without attention_impl=flash")
    rev = CompiledEvaluator(get_config("yi-6b"), SHAPES_BY_NAME["decode_32k"],
                            device="cuda", n_layers=PRODUCT_CHIP_LAYERS,
                            steps=PRODUCT_STEPS, share="replica")
    replica = product_probe(rev, "yi-6b decode_32k (replica share)", {}, {})
    check(replica["feasible"] and replica["record"]["outputs_finite"],
          "phase 14: decode_32k at the replica's share did not run")
    d, r = out["yi-6b decode_32k"]["record"], replica["record"]
    print(f"  yi-6b decode_32k, {PRODUCT_CHIP_LAYERS} layers: one chip's "
          f"share (8 rows, 2 q heads, the 4 kv heads' cache whole) "
          f"measured_step_s={d['measured_step_s']:.6f} scored_step_s="
          f"{d['scored_step_s']:.6f} peak "
          f"{d['memory']['max_memory_allocated_gb']:.2f} GiB; one "
          f"replica's (8 rows, every head) measured_step_s="
          f"{r['measured_step_s']:.6f} peak "
          f"{r['memory']['max_memory_allocated_gb']:.2f} GiB", flush=True)
    print(f"phase 14's serving cells {wall:.1f} s (budget "
          f"{PRODUCT_SERVE_BUDGET_S:.0f} s; the kernel checks before them "
          f"{kernels_s:.1f} s)", flush=True)
    check(wall <= PRODUCT_SERVE_BUDGET_S, f"phase 14's serving cells took "
          f"{wall:.1f} s")
    return {"probes": out, "replica": replica, "flash_layer": flash32k,
            "mlstm_layer": mlstm, "seconds": wall,
            "launches_fwd": sum(p["launches"]["fwd"] for p in out.values())
            + replica["launches"]["fwd"],
            "mlstm_launches": m["fwd"]}


def phase_product(card: str, tuned: dict) -> dict:
    """Phase 14: the config probes of yi-6b's train_4k at one chip's share
    of the 16 x 16 mesh (and the default once at the replica's share),
    run on the card by ``CompiledEvaluator``, the measured speedups beside
    the analytic ones of phase 3; then the MoE, SSM and serving cells at
    the chip's share (``product_moe``, ``product_ssm``,
    ``product_serving``)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import SINGLE_POD
    from repro_torch.core.evaluators import CompiledEvaluator
    from repro_torch.core.knobs import clean_space
    from repro_torch.core.tuner import expert_manual_config
    from repro_torch.launch import dryrun
    from repro_torch.models.config import SHAPES_BY_NAME

    cfg = get_config(PRODUCT_ARCH)
    cell = SHAPES_BY_NAME["train_4k"]
    gc.collect()
    torch.cuda.empty_cache()
    depth = PRODUCT_CHIP_LAYERS or dryrun.cell_depth(cfg, cell, share="chip")
    print(f"== phase 14: the product cluster: CompiledEvaluator on "
          f"{PRODUCT_ARCH} (full width) at train_4k's share of one chip of "
          f"the 16 x 16 mesh, {depth} of {cfg.n_layers} layers (the chip "
          f"share's cell depth {dryrun.cell_depth(cfg, cell, share='chip')}"
          f"; the replica's share once at {PRODUCT_LAYERS}), 1 warm-up + "
          f"{PRODUCT_STEPS} timed steps a probe (memory allocated at the "
          f"start {torch.cuda.memory_allocated() / 2**30:.3f} GiB)",
          flush=True)
    t0 = time.perf_counter()
    flash_layer = chip_flash_forward(card)
    space, _, _ = clean_space(cfg, cell, SINGLE_POD)
    default = space.project(space.default_config())
    probes = [("default", default)]
    probes += [(name, space.project({**default, **kn}))
               for name, kn in PRODUCT_KNOBS]
    probes += [("recommended", dict(tuned["best_config"])),
               ("expert", expert_manual_config(space))]
    twins = dict(probes)
    probes += [(name, space.project({**twins[twin],
                                     "sequence_parallel": True}))
               for name, twin in PRODUCT_SP]
    ev = CompiledEvaluator(cfg, cell, device="cuda",
                           n_layers=PRODUCT_CHIP_LAYERS, steps=PRODUCT_STEPS,
                           share="chip")
    out = {}
    for name, knobs in probes:
        out[name] = product_probe(ev, name, knobs, default)
        torch.cuda.empty_cache()
    for name in ["default", *sorted(PRODUCT_MUST_FIT)]:
        check(out[name]["feasible"], f"phase 14: the {name} probe ran out "
              f"of the card's memory")
    d = out["default"]
    # the SP probes compute one function (the virtual chip's under
    # sequence parallelism, PRODUCT_SP_TWIN_REL): the first is theirs
    sp_base = PRODUCT_SP[0][0]
    for name, p in out.items():
        check(p["record"]["share"] == "chip"
              and p["record"]["roofline"]["collective_s"] > 0,
              f"phase 14: {name} did not run one chip's share with its "
              f"collectives counted")
        base = sp_base if name in dict(PRODUCT_SP) else "default"
        b = out[base]["record"]["step1_loss"]
        rel = abs(p["record"]["step1_loss"] - b) / abs(b)
        p["loss_rel"] = rel
        check(rel <= PRODUCT_LOSS_REL, f"phase 14: {name}'s step-1 loss "
              f"is {rel:.3e} from {base}'s (limit {PRODUCT_LOSS_REL})")

    # what the step-1 loss cannot see: the gradient and the update
    def drop(p):
        losses = p["record"]["step_losses"]
        return losses[0] - losses[-1]
    d_norm, d_drop = d["record"]["step1_grad_norm"], drop(d)
    check(d_drop > 0, f"phase 14: the default's loss did not drop over its "
          f"timed steps ({d['record']['step_losses']})")
    for name, p in out.items():
        if name == "default":
            continue
        g_rel = abs(p["record"]["step1_grad_norm"] - d_norm) / d_norm
        u_rel = abs(drop(p) - d_drop) / d_drop
        p["grad_norm_rel"], p["drop_rel"] = g_rel, u_rel
        print(f"  {name}: step-1 gradient norm {g_rel:.3e} from the "
              f"default's, loss drop {drop(p):.6g} ({u_rel:.3e} from the "
              f"default's {d_drop:.6g})", flush=True)
        if name in PRODUCT_SAME_GRAD:
            check(g_rel <= PRODUCT_GRAD_REL, f"phase 14: {name}'s step-1 "
                  f"gradient norm is {g_rel:.3e} from the default's (limit "
                  f"{PRODUCT_GRAD_REL})")
        if name in PRODUCT_SAME_UPDATE:
            check(u_rel <= PRODUCT_DROP_REL, f"phase 14: {name}'s loss drop "
                  f"is {u_rel:.3e} from the default's (limit "
                  f"{PRODUCT_DROP_REL})")
    check(drop(out["adafactor"]) > 0, f"phase 14: Adafactor's loss did not "
          f"drop ({out['adafactor']['record']['step_losses']})")

    # the repeat is the cache's: no new measurement
    calls = ev.calls
    again = ev(default)
    check(again == d["step_s"] and ev.calls == calls,
          f"phase 14: the repeated default was not a cache hit "
          f"({again} vs {d['step_s']}, calls {calls} -> {ev.calls})")
    print(f"  default again: {again:.6f} s, a cache hit (calls {ev.calls})",
          flush=True)

    # flash's launches at the chip's heads (yi-6b: 2 q heads over 1 kv)
    _, _, _, H, Kh, D = CHIP_FLASH
    check_flash_probe(out["flash"], H, Kh, D, "phase 14")

    # sequence parallelism: each SP probe beside its SP-off twin; the flash
    # probe's kernels run at the same shapes, so its launches are the twin's
    for name, twin in PRODUCT_SP:
        p, t = out[name], out[twin]
        pr, tr = p["record"], t["record"]
        rel = abs(pr["step1_loss"] - tr["step1_loss"]) / abs(tr["step1_loss"])
        p["twin_loss_rel"] = rel
        for q, qr in ((p, pr), (t, tr)):
            r = qr["roofline"]
            print(f"  {q['name']} (sequence_parallel "
                  f"{qr['sequence_parallel']}): measured_step_s="
                  f"{qr['measured_step_s']:.6f} collective_s="
                  f"{r['collective_s']:.6f} coll_by_kind={r['coll_by_kind']} "
                  f"({r['collective_bytes_per_device'] / 1e9:.3f} GB) "
                  f"scored_step_s={q['step_s']:.6f} peak="
                  f"{qr['memory']['max_memory_allocated_gb']:.2f} GiB mfu="
                  f"{qr['mfu']:.4f} step1_loss={qr['step1_loss']:.6f} "
                  f"grad_norm={qr['step1_grad_norm']}", flush=True)
        check(pr["sequence_parallel"] and not tr["sequence_parallel"],
              f"phase 14: {name} did not run sequence-parallel, or its twin "
              f"{twin} did")
        check(rel <= PRODUCT_SP_TWIN_REL, f"phase 14: {name}'s step-1 loss "
              f"is {rel:.3e} from {twin}'s (limit {PRODUCT_SP_TWIN_REL})")
        check(math.isfinite(pr["step1_grad_norm"]) and drop(p) > 0,
              f"phase 14: {name}: gradient norm {pr['step1_grad_norm']}, "
              f"losses {pr['step_losses']}")
    fs, f0 = out["flash-sp"], out["flash"]
    check(fs["launches"] == f0["launches"] and fs["shapes"] == f0["shapes"],
          f"phase 14: flash-sp's launches {fs['launches']} at "
          f"{fs['shapes']}, want the flash probe's {f0['launches']} at "
          f"{f0['shapes']}")

    def speedup(name):
        p = out[name]
        return d["step_s"] / p["step_s"] if p["feasible"] else None

    a_best = tuned["default_value"] / tuned["best_value"]
    a_expert = tuned["default_value"] / tuned["expert_value"]
    m_best, m_expert = speedup("recommended"), speedup("expert")
    print(f"  transfer on {card}, one chip of 16 x 16 at depth {depth} "
          f"(scored_step_s): default/recommended measured {m_best:.4f}x, "
          f"analytic (tune, batch 8) {a_best:.4f}x; default/expert measured "
          f"{m_expert:.4f}x, analytic {a_expert:.4f}x", flush=True)

    # the replica's share once, as it was scored before the chip share
    rev = CompiledEvaluator(cfg, cell, device="cuda", n_layers=PRODUCT_LAYERS,
                            steps=PRODUCT_STEPS, share="replica")
    replica = product_probe(rev, "default (replica share)", default, default)
    check(replica["feasible"] and replica["record"]["roofline"][
        "collective_s"] == 0.0 and replica["step_s"] ==
        replica["record"]["measured_step_s"], "phase 14: the replica "
        "share's default did not run, or scored more than its measured step")
    torch.cuda.empty_cache()
    fwd_total = sum(p["launches"]["fwd"] for p in out.values()) \
        + replica["launches"]["fwd"]
    bwd_total = sum(p["launches"]["bwd"] for p in out.values()) \
        + replica["launches"]["bwd"]
    total = time.perf_counter() - t0
    print(f"phase 14's yi-6b cells {total:.1f} s (budget "
          f"{PRODUCT_BUDGET_S:.0f} s)", flush=True)
    check(total <= PRODUCT_BUDGET_S, f"phase 14 took {total:.1f} s")
    torch.cuda.empty_cache()
    moe = product_moe(card)
    torch.cuda.empty_cache()
    ssm = product_ssm(card)
    torch.cuda.empty_cache()
    serving = product_serving(card)
    return {"probes": out, "replica": replica, "serving": serving,
            "flash_layer": flash_layer, "depth": depth, "moe": moe,
            "ssm": ssm,
            "launches_fwd": fwd_total, "launches_bwd": bwd_total,
            "launches_fwd_per_probe": {n: p["launches"]["fwd"]
                                       for n, p in out.items()},
            "launches_bwd_per_probe": {n: p["launches"]["bwd"]
                                       for n, p in out.items()},
            "measured_speedup": m_best, "measured_expert_speedup": m_expert,
            "analytic_speedup": a_best, "analytic_expert_speedup": a_expert,
            "seconds": total}


# ---------------------------------------------------------------------------
# phase 15: the sharded train step on a (data, model) mesh
# ---------------------------------------------------------------------------

MESH_ARCH = "yi-6b"
MESH_LAYERS = 2                  # depth 32 -> 2; full width (~0.87 B)
MESH_SHAPE = (2, 2)              # data x model: four processes
MESH_B, MESH_S = 4, 2048         # global batch
MESH_MICRO = 1                   # per replica: 2 microbatches
MESH_STEPS = 2
MESH_SEED = 0
MESH_LOSS_REL = 1e-3             # step-1 loss vs the one-process step
MESH_GRAD_REL = TRAIN_GRAD_REL   # per gathered leaf (phase 13's limit)
MESH_BUDGET_S = 90.0
MESH_TIMEOUT_S = 600.0           # the spawn's join


def mesh_rank(mesh, out_dir: str) -> None:
    """One rank of phase 15 (spawned; runs under ``with mesh:``): this
    rank's blocks of yi-6b's state, its data rank's rows (its block of
    each global microbatch), step 1's
    gradients gathered (rank 0 also runs the one-process step's, off the
    mesh, and compares), then the counted steps.  Writes
    ``rank<r>.json`` under ``out_dir``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.common import (tree_flatten,
                                           tree_flatten_with_path)
    from repro_torch.models.model import Model, gather_tree
    from repro_torch.parallel.collectives import counting_collectives
    from repro_torch.parallel.sharding import (reset_ambient_mesh,
                                               sequence_parallel_on,
                                               set_ambient_mesh)
    from repro_torch.train import train_loop as ttl
    from repro_torch.train.data import SyntheticDataset

    cfg = get_config(MESH_ARCH).scaled(n_layers=MESH_LAYERS)
    rc, rc_sp = mesh_runconfig(False), mesh_runconfig(True)
    model = Model(cfg, device=mesh.device)
    ops.load()
    out = {"rank": mesh.rank, "coords": mesh.coords,
           "backend": mesh.backend, "device": str(mesh.device)}
    torch.cuda.reset_peak_memory_stats()
    params = model.init(MESH_SEED)
    state = ttl.shard_state(model, rc, params, mesh)
    out["state_gib"] = sum(t.numel() * t.element_size() for t in
                           tree_flatten(state)[0]) / 2 ** 30
    if mesh.rank != 0:
        del params
    torch.cuda.empty_cache()
    data = SyntheticDataset(MESH_SEED, MESH_B, MESH_S, cfg.vocab_size,
                            data_index=mesh.coords["data"],
                            data_count=mesh.shape["data"],
                            n_micro=ttl.micro_count(
                                rc, MESH_B // mesh.shape["data"]),
                            device=mesh.device)
    batches = [next(data) for _ in range(MESH_STEPS)]

    # step 1's gradients, every leaf gathered, without and with sequence
    # parallelism (the same placements); on rank 0 against the
    # one-process step at the same seed, shape and global batch
    pls = ttl.param_placements(model, rc)
    got = {}
    loss, _, grads = ttl.step_grads(model, state.params, batches[0], rc,
                                    placements=pls)
    got[""] = (float(loss), gather_tree(grads, pls))
    # the SP step's forward and backward, counted on their own: its flash
    # launches are one SP-off step's, its bytes by kind the virtual chip's
    del grads
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with counting_collectives() as coll:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, grads = ttl.step_grads(model, state.params, batches[0],
                                        rc_sp, placements=pls)
        torch.cuda.synchronize()
    out.update(sp_step_s=time.perf_counter() - t0,
               sp_coll_by_kind=dict(coll), sp_launches=flash_counts(ops),
               sp_step_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               sp_on=sequence_parallel_on(rc_sp.shard, mesh, MESH_S))
    got["sp_"] = (float(loss), gather_tree(grads, pls))
    del grads
    if mesh.rank == 0:
        token = set_ambient_mesh(None)
        try:
            full = SyntheticDataset(MESH_SEED, MESH_B, MESH_S,
                                    cfg.vocab_size, device=mesh.device)
            loss1, _, want = ttl.step_grads(model, params, next(full), rc)
        finally:
            reset_ambient_mesh(token)
        del params
        want_leaves = tree_flatten_with_path(want)[0]
        for tag, (loss, grads) in got.items():
            worst, worst_path, finite = 0.0, "", True
            for (path, g), (_, w) in zip(tree_flatten_with_path(grads)[0],
                                         want_leaves):
                finite &= bool(torch.isfinite(g).all())
                r = rel_l2(g, w)
                if not r <= worst:
                    worst, worst_path = (r if math.isfinite(r)
                                         else math.inf,
                                         "/".join(map(str, path)))
            out.update({f"{tag}loss_step1": loss,
                        f"{tag}grad_rel_l2": worst,
                        f"{tag}grad_worst_leaf": worst_path,
                        f"{tag}grads_finite": finite})
        out.update(loss_one_process=float(loss1),
                   n_leaves=len(want_leaves))
        del want, want_leaves
    else:
        out["loss_step1"], out["sp_loss_step1"] = got[""][0], got["sp_"][0]
    del got
    import gc
    gc.collect()        # rank 0's one-process step left reference cycles
    torch.cuda.empty_cache()

    # the main path: MESH_STEPS steps, flash counted from 0 around them
    step = ttl.make_train_step(model, rc, donate=True)
    shapes = set()
    fn = ops.flash_attention

    def recording(q, k, v, **kw):
        shapes.add((tuple(q.shape), tuple(k.shape), str(q.dtype)))
        return fn(q, k, v, **kw)
    out["setup_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ops.flash_attention = recording
    try:
        times = []
        with counting_collectives() as coll:
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, mets = step(state, b)
                out.setdefault("losses", []).append(float(mets["loss"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
    finally:
        ops.flash_attention = fn
    out.update(step_s=times, shapes=sorted(map(list, shapes)),
               coll_by_kind=dict(coll), launches=flash_counts(ops),
               step_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    Path(out_dir, f"rank{mesh.rank}.json").write_text(json.dumps(out))


# phase 15's MoE step (expert parallelism): qwen2-moe at full width, its 60
# experts split over the model axis (30 a rank), on the same 2 x 2 mesh
# (~1.8 B parameters).  In float32: a random-weight MoE in bf16 is
# chaotic (each MoE layer adds ~80 to the residual stream, and the norms'
# backward cancels against it): in bf16 the sharded step's embedding
# gradient was 7.3e-2 from one process with the routing replayed, every
# other leaf within 7e-3 (on an NVIDIA H100 80GB HBM3, 700 W).
# Flash then takes its float32 FMA route.  The expert weights' ZeRO-3
# gathers go through host memory under gloo, once a microbatch and layer
# (1 GB a layer in float32; 22.2 s of a 62.1 s phase at two microbatches
# on that card): one microbatch a rank (the reference's global
# microbatch is the whole batch, its routing statistics still reduced
# over both data ranks; two microbatches of two data ranks are held on
# the CPU, tests/test_torch_expert_parallel.py) and remat none (no
# gathers again in the backward)
MESH_MOE_ARCH = "qwen2-moe-a2.7b"
MESH_MOE_LAYERS = 2              # depth 24 -> 2; full width
MESH_MOE_B, MESH_MOE_S = 4, 1024  # global batch
MESH_MOE_MICRO = 2               # per replica: one microbatch
MESH_MOE_GRAD_REL = 2e-2         # per gathered leaf, the routing replayed
MESH_MOE_BUDGET_S = 60.0


def mesh_moe_runconfig():
    """Phase 15's MoE RunConfig: the family default's layout in float32,
    one microbatch a replica, remat none, flash."""
    from repro_torch.runconfig import RunConfig
    return RunConfig(microbatch=MESH_MOE_MICRO, remat_policy="none",
                     attention_impl="flash", param_dtype="float32",
                     activation_dtype="float32", kv_cache_dtype="float32")


def mesh_moe_rank(mesh, out_dir: str) -> None:
    """One rank of phase 15's MoE step (spawned; runs under ``with
    mesh:``): rank 0 first takes the one-process step's gradients off the
    mesh, recording its routing (``routing_replay``), and writes the
    top-k indices of every ``moe._routing`` call; every rank then takes
    step 1's gradients on its rows of the same global batch
    (``train_loop.rank_batch``: its block of each global microbatch) with
    its tokens' rows of that routing replayed, flash counted from 0
    around it; the gradients are gathered and rank 0 compares.  Writes
    ``moe-rank<r>.json`` under ``out_dir``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.common import tree_flatten_with_path
    from repro_torch.models.model import (Model, gather_tree_to_host,
                                          shard_tree)
    from repro_torch.parallel.collectives import counting_collectives
    from repro_torch.parallel.sharding import (reset_ambient_mesh,
                                               set_ambient_mesh)
    from repro_torch.train import train_loop as ttl
    from repro_torch.train.data import batch_at

    import gc
    t_start = time.perf_counter()
    cfg = get_config(MESH_MOE_ARCH).scaled(n_layers=MESH_MOE_LAYERS)
    rc = mesh_moe_runconfig()
    model = Model(cfg, device=mesh.device)
    ops.load()
    D = mesh.shape["data"]
    out = {"rank": mesh.rank, "coords": mesh.coords, "times": {}}
    params = model.init(MESH_SEED, dtype=torch.float32)
    # the parameters' blocks alone: no optimizer state (four ranks share
    # the card)
    pls = ttl.param_placements(model, rc, mesh)
    blocks = shard_tree(params, pls, mesh.rank)
    full = batch_at(MESH_SEED, 0, global_batch=MESH_MOE_B,
                    seq_len=MESH_MOE_S, vocab_size=cfg.vocab_size,
                    device=mesh.device)
    local = ttl.rank_batch(full, rc, mesh)
    plan_path = Path(out_dir, "moe-routes.pt")
    out["times"]["setup"] = time.perf_counter() - t_start
    if mesh.rank == 0:
        token = set_ambient_mesh(None)
        try:
            with routing_replay() as routes:
                loss1, _, want = ttl.step_grads(model, params, full, rc,
                                                mesh={"data": D})
        finally:
            reset_ambient_mesh(token)
        torch.save([t.cpu() for t in routes], plan_path)
        out["loss_one_process"] = float(loss1)
        del routes
    del params
    gc.collect()        # the one-process step left reference cycles
    torch.cuda.empty_cache()
    dist.barrier()
    out["times"]["one_process"] = time.perf_counter() - t_start
    routes = torch.load(plan_path)
    # this data rank's tokens of each global microbatch's routing
    n_micro = ttl.micro_count(rc, MESH_MOE_B // D)
    rows = MESH_MOE_B // n_micro // D * MESH_MOE_S
    lo = mesh.coords["data"] * rows
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with counting_collectives() as coll, routing_replay(
            lambda i: routes[i][lo:lo + rows]) as flips:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, grads = ttl.step_grads(model, blocks, local, rc,
                                        placements=pls)
        torch.cuda.synchronize()
    out.update(step_s=time.perf_counter() - t0, loss_step1=float(loss),
               launches=flash_counts(ops), coll_by_kind=dict(coll),
               routing_calls=len(flips), plan_calls=len(routes),
               flips=list(flips), tokens_per_call=rows,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    out["times"]["sharded"] = time.perf_counter() - t_start
    # on rank 0's host, one leaf at a time: four ranks share the card
    torch.cuda.empty_cache()
    grads = gather_tree_to_host(grads, pls, mesh)
    out["times"]["gathered"] = time.perf_counter() - t_start
    if mesh.rank == 0:
        worst, worst_path, finite, rels = 0.0, "", True, {}
        for (path, g), (_, w) in zip(tree_flatten_with_path(grads)[0],
                                     tree_flatten_with_path(want)[0]):
            g = g.to(w.device)
            finite &= bool(torch.isfinite(g).all())
            name = "/".join(map(str, path))
            if name.endswith("k/b"):
                continue        # zero in exact arithmetic (phase 13)
            r = rels[name] = rel_l2(g, w)
            if not r <= worst:
                worst, worst_path = (r if math.isfinite(r) else math.inf,
                                     name)
        out.update(grad_rel_l2=worst, grad_worst_leaf=worst_path,
                   grads_finite=finite, grad_rel_top=sorted(
                       rels.items(), key=lambda kv: -kv[1])[:6])
    out["times"]["compared"] = time.perf_counter() - t_start
    Path(out_dir, f"moe-rank{mesh.rank}.json").write_text(json.dumps(out))


def phase_mesh_moe(card: str, backend: str) -> dict:
    """Phase 15's MoE step: qwen2-moe at full width on the 2 x 2 mesh
    against one process, its routing replayed (``mesh_moe_rank``)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn

    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    cfg = get_config(MESH_MOE_ARCH)
    print(f"  {MESH_MOE_ARCH} full width, {MESH_MOE_LAYERS} layers, "
          f"{cfg.n_experts} experts ({cfg.n_experts // MESH_SHAPE[1]} a "
          f"model rank), mesh {MESH_SHAPE[0]}x{MESH_SHAPE[1]}, global batch "
          f"{MESH_MOE_B}x{MESH_MOE_S}, float32, {backend}", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh-moe-", dir=ROOT) as tmp:
        spawn(mesh_moe_rank, MESH_SHAPE, (tmp,), device="cuda",
              backend=backend, timeout_s=MESH_TIMEOUT_S)
        ranks = [json.loads(Path(tmp, f"moe-rank{r}.json").read_text())
                 for r in range(world)]
    wall = time.perf_counter() - t0
    # remat none: one forward a microbatch and layer, float32: FMA
    want = MESH_MOE_B // MESH_SHAPE[0] // MESH_MOE_MICRO * MESH_MOE_LAYERS
    for r in ranks:
        c = r["launches"]
        print(f"  rank {r['rank']} {r['coords']}: step 1's gradients "
              f"{r['step_s']:.3f} s (cumulative s: {r['times']}), peak "
              f"{r['peak_gib']:.2f} GiB, loss "
              f"{r['loss_step1']:.6f}, flash {c}, collective bytes "
              f"{r['coll_by_kind']}; routing replayed over "
              f"{r['routing_calls']} calls of {r['tokens_per_call']} tokens,"
              f" own top-k differing at {sum(r['flips'])} ({r['flips']})",
              flush=True)
        check(r["routing_calls"] == r["plan_calls"] > 0,
              f"phase 15 MoE rank {r['rank']}: {r['routing_calls']} "
              f"routing calls, the one-process step made "
              f"{r['plan_calls']}")
        check(c["launches"] == c["launches_fma"] == want
              and c["launches_wgmma"] == 0
              and c["launches_bwd"] == c["launches_bwd_fma"] == want
              and c["launches_bwd_wgmma"] == 0,
              f"phase 15 MoE rank {r['rank']}: flash launches {c}, want "
              f"{want} FMA forwards and {want} FMA backward sets "
              f"(float32)")
        check(math.isfinite(r["loss_step1"]),
              f"phase 15 MoE rank {r['rank']}: loss {r['loss_step1']}")
    r0 = ranks[0]
    loss_rel = abs(r0["loss_step1"] - r0["loss_one_process"]) \
        / abs(r0["loss_one_process"])
    print(f"  {MESH_MOE_ARCH} step-1 loss sharded {r0['loss_step1']:.6f} "
          f"one process {r0['loss_one_process']:.6f} (rel {loss_rel:.3e}, "
          f"limit {MESH_LOSS_REL}); worst gathered gradient leaf rel_l2 "
          f"{r0['grad_rel_l2']:.3e} at {r0['grad_worst_leaf']} (limit "
          f"{MESH_MOE_GRAD_REL}; the largest {r0['grad_rel_top']}); wall "
          f"{wall:.1f} s (budget "
          f"{MESH_MOE_BUDGET_S:.0f} s) on {card}", flush=True)
    check(loss_rel <= MESH_LOSS_REL, f"phase 15 MoE: step-1 loss rel "
          f"{loss_rel}")
    check(r0["grads_finite"], "phase 15 MoE: a non-finite gradient leaf")
    check(r0["grad_rel_l2"] <= MESH_MOE_GRAD_REL, f"phase 15 MoE: gradient "
          f"rel_l2 {r0['grad_rel_l2']} at {r0['grad_worst_leaf']}")
    check(wall <= MESH_MOE_BUDGET_S, f"phase 15's MoE step took {wall:.1f} s")
    return {"ranks": ranks, "wall_s": wall, "loss_rel": loss_rel,
            "grad_rel_l2": r0["grad_rel_l2"],
            "launches_fwd": sum(r["launches"]["launches"] for r in ranks),
            "launches_bwd": sum(r["launches"]["launches_bwd"]
                                for r in ranks)}


# phase 15's sharded serving: yi-6b at the train step's width and depth,
# flash, bf16, the global batch's 4 prompts of 2048 and 4 decode steps
MESH_DECODE = 4
MESH_SERVE_REL = 2e-2            # rank 0's logits vs one process (bf16)
MESH_SERVE_BUDGET_S = 60.0


def mesh_serve_rank(mesh, out_dir: str) -> None:
    """One rank of phase 15's sharded serving (spawned; under ``with
    mesh:``): its blocks of yi-6b's weights, its rows of the global
    prompts, ``Model.prefill`` and ``MESH_DECODE`` ``decode_step`` s with
    flash's launches and the collectives' bytes counted from 0 around
    them; rank 0 then runs the one-process prefill and decode off the
    mesh and compares its rows.  Writes ``serve<r>.json`` under
    ``out_dir``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models import transformer
    from repro_torch.models.model import Model, shard_tree
    from repro_torch.parallel.collectives import counting_collectives
    from repro_torch.parallel.sharding import (reset_ambient_mesh,
                                               set_ambient_mesh)
    from repro_torch.runconfig import RunConfig
    from repro_torch.train import train_loop as ttl

    cfg = get_config(MESH_ARCH).scaled(n_layers=MESH_LAYERS)
    rc = RunConfig(attention_impl="flash")
    model = Model(cfg, device=mesh.device)
    ops.load()
    params = model.init(MESH_SEED)
    local = shard_tree(params, ttl.param_placements(model, rc, mesh),
                       mesh.rank)
    if mesh.rank != 0:
        del params
    gen = torch.Generator(device=mesh.device).manual_seed(MESH_SEED)
    tokens = torch.randint(0, cfg.vocab_size, (MESH_B, MESH_S + MESH_DECODE),
                           generator=gen, device=mesh.device,
                           dtype=torch.int32)
    rows = transformer.serve_rows(MESH_B, rc, mesh)
    mine, s_max = tokens[rows], MESH_S + MESH_DECODE
    shapes, first, fn = set(), [], ops.flash_attention

    def recording(q, k, v, **kw):
        shapes.add((tuple(q.shape), tuple(k.shape), str(q.dtype)))
        if not first:
            first.append((q.clone(), k.clone(), v.clone(), kw))
        return fn(q, k, v, **kw)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.flash_attention = recording
    try:
        with torch.no_grad(), counting_collectives() as coll:
            t0 = time.perf_counter()
            logits, state = model.prefill(local, {"tokens": mine[:, :MESH_S]},
                                          s_max, rc, batch=MESH_B)
            got = [logits]
            for t in range(MESH_DECODE):
                logits, state = model.decode_step(
                    local, mine[:, MESH_S + t:MESH_S + t + 1], state, rc)
                got.append(logits)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        ops.flash_attention = fn
    out = {"rank": mesh.rank, "coords": mesh.coords, "rows": [rows.start,
                                                              rows.stop],
           "launches": flash_counts(ops), "shapes": sorted(map(list, shapes)),
           "coll_by_kind": dict(coll), "serve_s": wall,
           "finite": all(bool(torch.isfinite(x).all()) for x in got),
           "logits_shape": list(got[0].shape)}
    # the kernel at this rank's shape against its plain version, on the
    # q, k, v the prefill's first layer gave it (after the counts were read)
    q, k, v, kw = first[0]
    kern = fn(q, k, v, **kw)
    plain = ref.reference_attention(q, k, v, p_dtype=torch.bfloat16, **kw)
    out["flash_rel_l2"] = rel_l2(kern, plain)
    out["flash_max_abs_err"] = float((kern.float() - plain.float()).abs()
                                     .max())
    out["flash_kw"] = {a: b for a, b in kw.items() if b is not None}
    del q, k, v, kern, plain, first[:]
    if mesh.rank == 0:
        token = set_ambient_mesh(None)
        try:
            with torch.no_grad():
                logits, state = model.prefill(
                    params, {"tokens": tokens[:, :MESH_S]}, s_max, rc)
                want = [logits]
                for t in range(MESH_DECODE):
                    logits, state = model.decode_step(
                        params, tokens[:, MESH_S + t:MESH_S + t + 1], state,
                        rc)
                    want.append(logits)
        finally:
            reset_ambient_mesh(token)
        out["logits_rel_l2"] = [rel_l2(g, w[rows]) for g, w in zip(got, want)]
    Path(out_dir, f"serve{mesh.rank}.json").write_text(json.dumps(out))


def phase_mesh_serve(card: str, backend: str) -> dict:
    """Phase 15's sharded serving: yi-6b's prefill and decode on the
    2 x 2 mesh (``mesh_serve_rank``) against one process."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn

    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    print(f"  sharded serving: {MESH_ARCH} full width, {MESH_LAYERS} layers, "
          f"flash, bf16, {MESH_B} prompts of {MESH_S} and {MESH_DECODE} "
          f"decode steps on the {MESH_SHAPE[0]}x{MESH_SHAPE[1]} mesh "
          f"({backend})", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="serve-", dir=ROOT) as tmp:
        spawn(mesh_serve_rank, MESH_SHAPE, (tmp,), device="cuda",
              backend=backend, timeout_s=MESH_TIMEOUT_S)
        ranks = [json.loads(Path(tmp, f"serve{r}.json").read_text())
                 for r in range(world)]
    wall = time.perf_counter() - t0
    cfg = get_config(MESH_ARCH)
    D, M = MESH_SHAPE
    hq, hkv = cfg.n_heads // M, cfg.n_kv_heads // M
    want_shape = [[MESH_B // D, MESH_S, hq, cfg.resolved_head_dim],
                  [MESH_B // D, MESH_S, hkv, cfg.resolved_head_dim],
                  "torch.bfloat16"]
    for r in ranks:
        c = r["launches"]
        print(f"  rank {r['rank']} {r['coords']} rows {r['rows']}: prefill + "
              f"{MESH_DECODE} decode steps {r['serve_s']:.3f} s; flash fwd "
              f"{c['launches_wgmma']} wgmma + {c['launches_fma']} FMA at "
              f"{r['shapes']} {r['flash_kw']}, kernel vs plain rel_l2 "
              f"{r['flash_rel_l2']:.3e} max_abs_err "
              f"{r['flash_max_abs_err']:.3e} (limit {FLASH_REL_L2}); logits "
              f"{r['logits_shape']}; collective bytes "
              f"{r['coll_by_kind']}", flush=True)
        check(r["flash_rel_l2"] <= FLASH_REL_L2, f"phase 15 serving rank "
              f"{r['rank']}: the flash forward at {r['shapes']} vs its "
              f"plain version relative L2 {r['flash_rel_l2']} > "
              f"{FLASH_REL_L2}")
        check(c["launches"] == c["launches_wgmma"] == MESH_LAYERS
              and c["launches_fma"] == 0, f"phase 15 serving rank "
              f"{r['rank']}: flash forwards {c}, want {MESH_LAYERS} wgmma "
              f"(one a layer of the prefill) and no FMA")
        check(r["shapes"] == [want_shape], f"phase 15 serving rank "
              f"{r['rank']}: flash shapes {r['shapes']}, want {want_shape}")
        check(r["finite"] and r["logits_shape"] == [MESH_B // D, 1,
                                                    cfg.vocab_size],
              f"phase 15 serving rank {r['rank']}: logits "
              f"{r['logits_shape']} finite {r['finite']}")
    rels = ranks[0]["logits_rel_l2"]
    print(f"  rank 0's last-token logits and {MESH_DECODE} decode steps' vs "
          f"one process: relative L2 {[f'{x:.3e}' for x in rels]} (limit "
          f"{MESH_SERVE_REL}); {wall:.1f} s (budget "
          f"{MESH_SERVE_BUDGET_S:.0f} s) on {card}", flush=True)
    check(max(rels) <= MESH_SERVE_REL, f"phase 15 serving: logits relative "
          f"L2 {rels} above {MESH_SERVE_REL}")
    check(wall <= MESH_SERVE_BUDGET_S, f"phase 15's sharded serving took "
          f"{wall:.1f} s")
    return {"ranks": ranks, "wall_s": wall, "logits_rel_l2": rels,
            "flash_rel_l2": max(r["flash_rel_l2"] for r in ranks),
            "flash_max_abs_err": max(r["flash_max_abs_err"] for r in ranks),
            "launches_fwd": sum(r["launches"]["launches"] for r in ranks)}


def mesh_runconfig(sp: bool):
    """Phase 15's RunConfig: the family default's layout, with sequence
    parallelism where ``sp``."""
    from repro_torch.parallel.sharding import ShardConfig
    from repro_torch.runconfig import RunConfig
    return RunConfig(microbatch=MESH_MICRO, remat_policy="block",
                     attention_impl="flash",
                     shard=ShardConfig(sequence_parallel=sp))


def flash_counts(ops) -> dict:
    """The flash wrapper's launch counters."""
    return {k: getattr(ops, k) for k in (
        "launches", "launches_wgmma", "launches_fma", "launches_bwd",
        "launches_bwd_wgmma", "launches_bwd_fma")}


def mesh_virtual_chip() -> dict:
    """Rank 0's share of phase 15 run alone in this process: the virtual
    2 x 2 mesh's chip (0, 0) (``launch.mesh.make_virtual_mesh``), its
    blocks of the state drawn alone (``init_local_state``), data rank 0's
    rows, the counted steps with flash's launches and the collectives'
    bytes by kind counted around them; then step 1's forward and
    backward under sequence parallelism, counted on their own."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_virtual_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel.collectives import counting_collectives
    from repro_torch.train import train_loop as ttl
    from repro_torch.train.data import SyntheticDataset

    cfg = get_config(MESH_ARCH).scaled(n_layers=MESH_LAYERS)
    rc = mesh_runconfig(False)
    model = Model(cfg, device="cuda")
    mesh = make_virtual_mesh(MESH_SHAPE, device="cuda")
    with mesh:
        state = ttl.init_local_state(model, MESH_SEED, rc)
        data = SyntheticDataset(MESH_SEED, MESH_B, MESH_S, cfg.vocab_size,
                                data_index=0, data_count=MESH_SHAPE[0],
                                n_micro=ttl.micro_count(
                                    rc, MESH_B // MESH_SHAPE[0]),
                                device="cuda")
        batches = [next(data) for _ in range(MESH_STEPS)]
        step = ttl.make_train_step(model, rc, donate=True)
        ops.reset_launch_counts()
        losses = []
        t0 = time.perf_counter()
        with counting_collectives() as coll:
            for b in batches:
                state, mets = step(state, b)
                losses.append(float(mets["loss"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_counts(ops)
        ops.reset_launch_counts()
        with counting_collectives() as coll_sp:
            loss, _, _ = ttl.step_grads(
                model, state.params, batches[0], mesh_runconfig(True),
                placements=ttl.param_placements(model, rc))
        sp_loss = float(loss)
    return {"coll_by_kind": dict(coll), "losses": losses, "wall_s": wall,
            "launches": launches, "sp_coll_by_kind": dict(coll_sp),
            "sp_launches": flash_counts(ops), "sp_loss": sp_loss}


def phase_mesh(card: str) -> dict:
    """Phase 15: yi-6b's train step sharded over a 2 x 2 mesh of four
    processes against the one-process step (module docstring)."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import backend_for, spawn

    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    print(f"== phase 15: the sharded train step, {MESH_ARCH} full width, "
          f"{MESH_LAYERS} layers, mesh {MESH_SHAPE[0]}x{MESH_SHAPE[1]} "
          f"(data x model), global batch {MESH_B}x{MESH_S}", flush=True)
    t0 = time.perf_counter()
    for which in ("wgmma", "fma", "bwd", "bwd_wgmma"):
        ops.build(which=which)      # before the spawn: ranks only load
    backend = backend_for("cuda", world)
    print(f"  backend {backend} ({torch.cuda.device_count()} card(s) for "
          f"{world} ranks{'' if backend == 'nccl' else ': all ranks share card 0, collectives staged through pinned host memory'})",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="mesh-", dir=ROOT) as tmp:
        spawn(mesh_rank, MESH_SHAPE, (tmp,), device="cuda", backend=backend,
              timeout_s=MESH_TIMEOUT_S)
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(world)]
    wall = time.perf_counter() - t0
    cfg = get_config(MESH_ARCH)
    per_rank_micro = MESH_B // MESH_SHAPE[0] // MESH_MICRO
    want_fwd = MESH_STEPS * per_rank_micro * MESH_LAYERS * 2   # + remat
    want_bwd = MESH_STEPS * per_rank_micro * MESH_LAYERS
    hq, hkv = cfg.n_heads // MESH_SHAPE[1], cfg.n_kv_heads // MESH_SHAPE[1]
    for r in ranks:
        c = r["launches"]
        print(f"  rank {r['rank']} {r['coords']} on {r['device']} "
              f"({r['backend']}): steps "
              + ", ".join(f"{t:.3f} s" for t in r["step_s"])
              + f"; state {r['state_gib']:.3f} GiB, peak "
              f"{r['step_peak_gib']:.2f} GiB in the counted steps "
              f"({r['setup_peak_gib']:.2f} GiB in the setup); flash fwd "
              f"{c['launches_wgmma']} wgmma + {c['launches_fma']} FMA, bwd "
              f"{c['launches_bwd_wgmma']} wgmma + {c['launches_bwd_fma']} "
              f"FMA; shapes {r['shapes']}; losses {r['losses']}", flush=True)
        check(c["launches"] == c["launches_wgmma"] == want_fwd
              and c["launches_fma"] == 0,
              f"phase 15 rank {r['rank']}: flash forwards {c}, want "
              f"{want_fwd} wgmma and no FMA")
        check(c["launches_bwd"] == c["launches_bwd_wgmma"] == want_bwd
              and c["launches_bwd_fma"] == 0,
              f"phase 15 rank {r['rank']}: flash backward sets {c}, want "
              f"{want_bwd} wgmma and no FMA")
        check(all(q[2] == hq and k[2] == hkv and d == "torch.bfloat16"
                  for q, k, d in r["shapes"]) and r["shapes"],
              f"phase 15 rank {r['rank']}: flash shapes {r['shapes']}, "
              f"want Hq {hq} / Hkv {hkv} bf16")
        check(all(math.isfinite(x) for x in r["losses"]),
              f"phase 15 rank {r['rank']}: losses {r['losses']}")
        # the SP step: the same kernels at the same shapes, once a step
        s = r["sp_launches"]
        print(f"  rank {r['rank']} under sequence parallelism (on: "
              f"{r['sp_on']}): step 1's gradients {r['sp_step_s']:.3f} s, "
              f"peak {r['sp_step_peak_gib']:.2f} GiB, loss "
              f"{r['sp_loss_step1']:.6f}, flash {s}, collective bytes "
              f"{r['sp_coll_by_kind']}", flush=True)
        check(r["sp_on"] and s["launches"] == s["launches_wgmma"]
              == want_fwd // MESH_STEPS and s["launches_fma"] == 0
              and s["launches_bwd"] == s["launches_bwd_wgmma"]
              == want_bwd // MESH_STEPS and s["launches_bwd_fma"] == 0,
              f"phase 15 rank {r['rank']}: the SP step's flash launches "
              f"{s}, want one SP-off step's ({want_fwd // MESH_STEPS} "
              f"forward, {want_bwd // MESH_STEPS} backward sets, wgmma)")
        check(math.isfinite(r["sp_loss_step1"]),
              f"phase 15 rank {r['rank']}: SP loss {r['sp_loss_step1']}")
    r0 = ranks[0]
    loss_rel = abs(r0["loss_step1"] - r0["loss_one_process"]) \
        / abs(r0["loss_one_process"])
    print(f"  step-1 loss sharded {r0['loss_step1']:.6f} one process "
          f"{r0['loss_one_process']:.6f} (rel {loss_rel:.3e}, limit "
          f"{MESH_LOSS_REL}); worst gathered gradient leaf rel_l2 "
          f"{r0['grad_rel_l2']:.3e} at {r0['grad_worst_leaf']} (limit "
          f"{MESH_GRAD_REL}) over {r0['n_leaves']} leaves; phase wall "
          f"{wall:.1f} s (budget {MESH_BUDGET_S:.0f} s) on {card}",
          flush=True)
    check(loss_rel <= MESH_LOSS_REL, f"phase 15: step-1 loss rel {loss_rel}")
    check(r0["grads_finite"], "phase 15: a non-finite gradient leaf")
    check(r0["grad_rel_l2"] <= MESH_GRAD_REL,
          f"phase 15: gradient rel_l2 {r0['grad_rel_l2']} at "
          f"{r0['grad_worst_leaf']}")
    sp_loss_rel = abs(r0["sp_loss_step1"] - r0["loss_one_process"]) \
        / abs(r0["loss_one_process"])
    print(f"  under sequence parallelism: step-1 loss "
          f"{r0['sp_loss_step1']:.6f} (rel {sp_loss_rel:.3e} to one "
          f"process, limit {MESH_LOSS_REL}); worst gathered gradient leaf "
          f"rel_l2 {r0['sp_grad_rel_l2']:.3e} at "
          f"{r0['sp_grad_worst_leaf']} (limit {MESH_GRAD_REL})", flush=True)
    check(sp_loss_rel <= MESH_LOSS_REL,
          f"phase 15: SP step-1 loss rel {sp_loss_rel}")
    check(r0["sp_grads_finite"], "phase 15: a non-finite SP gradient leaf")
    check(r0["sp_grad_rel_l2"] <= MESH_GRAD_REL,
          f"phase 15: SP gradient rel_l2 {r0['sp_grad_rel_l2']} at "
          f"{r0['sp_grad_worst_leaf']}")
    # the virtual chip is a real rank: rank 0's bytes and launches exactly
    virtual = mesh_virtual_chip()
    print(f"  collective bytes by kind over the {MESH_STEPS} counted steps: "
          + "; ".join(f"rank {r['rank']} {r['coll_by_kind']}" for r in ranks)
          + f"; the virtual 2x2 chip (0, 0) {virtual['coll_by_kind']} "
          f"(launches {virtual['launches']}, losses {virtual['losses']}, "
          f"{virtual['wall_s']:.2f} s)", flush=True)
    check(virtual["coll_by_kind"] == r0["coll_by_kind"]
          and virtual["launches"] == r0["launches"],
          f"phase 15: the virtual chip's bytes {virtual['coll_by_kind']} and "
          f"launches {virtual['launches']} are not rank 0's "
          f"{r0['coll_by_kind']} / {r0['launches']}")
    check(all(math.isfinite(x) for x in virtual["losses"]),
          f"phase 15: the virtual chip's losses {virtual['losses']}")
    print(f"  step 1 under SP: rank 0 {r0['sp_coll_by_kind']} (launches "
          f"{r0['sp_launches']}); the virtual chip "
          f"{virtual['sp_coll_by_kind']} (launches "
          f"{virtual['sp_launches']}, loss {virtual['sp_loss']:.6f})",
          flush=True)
    check(virtual["sp_coll_by_kind"] == r0["sp_coll_by_kind"]
          and virtual["sp_launches"] == r0["sp_launches"]
          and math.isfinite(virtual["sp_loss"]),
          f"phase 15: the virtual chip's SP bytes "
          f"{virtual['sp_coll_by_kind']} and launches "
          f"{virtual['sp_launches']} are not rank 0's "
          f"{r0['sp_coll_by_kind']} / {r0['sp_launches']}")
    wall = time.perf_counter() - t0
    check(wall <= MESH_BUDGET_S, f"phase 15 took {wall:.1f} s")
    moe = phase_mesh_moe(card, backend)
    serve = phase_mesh_serve(card, backend)
    return {"backend": backend, "ranks": ranks, "wall_s": wall,
            "virtual": virtual, "moe": moe, "serve": serve,
            "loss_rel": loss_rel, "grad_rel_l2": r0["grad_rel_l2"],
            "sp_loss_rel": sp_loss_rel, "sp_grad_rel_l2": r0["sp_grad_rel_l2"],
            "launches_fwd": sum(r["launches"]["launches"]
                                + r["sp_launches"]["launches"]
                                for r in ranks),
            "launches_bwd": sum(r["launches"]["launches_bwd"]
                                + r["sp_launches"]["launches_bwd"]
                                for r in ranks)}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    if not (SRC / "repro_torch" / "__init__.py").exists():
        fail(f"{SRC / 'repro_torch'} is missing: run from a checkout")
    sys.path.insert(0, str(SRC))

    t_all = time.perf_counter()
    card = phase_device()
    err, timing = phase_kernels(card)
    launches, tuned = phase_main_path(card)
    gp_round = phase_profile(card)
    torch.cuda.empty_cache()
    flash = phase_flash(card)
    torch.cuda.empty_cache()
    serving = phase_prefill(card, flash)
    torch.cuda.empty_cache()
    phase_engine(card)
    torch.cuda.empty_cache()
    mlstm = phase_mlstm(card)
    torch.cuda.empty_cache()
    xlstm = phase_xlstm(card)
    torch.cuda.empty_cache()
    service = phase_service(card)
    torch.cuda.empty_cache()
    autotune = phase_autotune(card)
    torch.cuda.empty_cache()
    families = phase_families(card)
    torch.cuda.empty_cache()
    train = phase_train(card)
    torch.cuda.empty_cache()
    product = phase_product(card, tuned)
    torch.cuda.empty_cache()
    sharded = phase_mesh(card)

    kernels = []
    for kind, shape, svc_shape in (("gram", MAIN_GRAM, SERVICE_GRAM),
                                   ("cross", MAIN_CROSS, SERVICE_CROSS)):
        k_ms, p_ms, b_ms, b_by, dev_ms = timing[(kind, shape)]
        s_ms, s_p_ms, s_b_ms, s_b_by, s_dev = timing[(kind, svc_shape)]
        m_ms, m_p_ms, m_b_ms, m_b_by, m_dev = timing[(kind, MTGP_GRAM)]
        kernels.append({
            "name": f"matern52_{kind}", "route": "cuda",
            "source": GRAM_SOURCE, "replaces": GRAM_REPLACES,
            "launches": launches[kind], "max_abs_err": err[kind],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": list(shape), **dev_ms,
            "launches_phase10": service["launches"][kind],
            "phase10_shape": list(svc_shape), "phase10_ms": s_ms,
            "phase10_plain_ms": s_p_ms, "phase10_bound_ms": s_b_ms,
            "phase10_bound_by": s_b_by,
            "phase10_device_ms": s_dev["device_ms"],
            "phase10_plain_device_ms": s_dev["plain_device_ms"],
            "mtgp_shape": list(MTGP_GRAM), "mtgp_ms": m_ms,
            "mtgp_plain_ms": m_p_ms, "mtgp_bound_ms": m_b_ms,
            "mtgp_bound_by": m_b_by, "mtgp_device_ms": m_dev["device_ms"],
            "mtgp_plain_device_ms": m_dev["plain_device_ms"],
            "launches_phase11": autotune["launches"]["gp_gram"],
            "tiles_phase11": autotune["tiles"]["gp_gram"],
            "tuned_phase11": autotune["tuned"]["gp_gram"],
        })
    bwd = timing["gram_bwd"]
    svc_bwd = bwd["service"]
    kernels.append({
        "name": "matern52_gram_bwd", "route": "cuda",
        "source": GRAM_SOURCE, "replaces": GRAM_REPLACES,
        "launches": launches["gram_bwd"], "max_abs_err": bwd["max_abs_err"],
        "rel_l2": err["gram_bwd"], "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "library_ms": None,
        "shape": [MAIN_GRAM[0], MAIN_GRAM[2]],
        "device_ms": bwd["device_ms"],
        "plain_device_ms": bwd["plain_device_ms"],
        "gp_round_ms_before_after": [gp_round["before"][0],
                                     gp_round["after"][0]],
        "launches_phase10": service["launches"]["gram_bwd"],
        "phase10_shape": [SERVICE_GRAM[0], SERVICE_GRAM[2]],
        "phase10_ms": svc_bwd["ms"], "phase10_plain_ms": svc_bwd["plain_ms"],
        "phase10_bound_ms": svc_bwd["bound_ms"],
        "phase10_bound_by": svc_bwd["bound_by"],
        "phase10_device_ms": svc_bwd["device_ms"],
        "phase10_plain_device_ms": svc_bwd["plain_device_ms"],
        "mtgp_shape": [MTGP_GRAM[0], MTGP_GRAM[2]],
        **{f"mtgp_{k}": v for k, v in bwd["mtgp"].items()},
        "mtgp_step_us": service["mtgp"]["step_us"],
        "gp_round_327": service["round327"],
    })
    # flash's launches on every main path, each counted from 0: yi-6b's
    # 4k prefill (phase 6), qwen2-moe's, the jamba cut's and whisper's
    # (phase 12)
    by_path = {"yi-6b": serving["launches"],
               **{k: families[k]["launches"]
                  for k in ("qwen2-moe", "jamba", "whisper")},
               "train-yi-6b": train["yi"]["launches_fwd"],
               "train-whisper": train["whisper"]["launches_fwd"],
               "train-qwen2-moe": train["qwen2-moe"]["launches_fwd"],
               "train-jamba": train["jamba"]["launches_fwd"],
               "product-yi-6b": product["launches_fwd"],
               "product-moe": product["moe"]["launches_fwd"],
               "train-yi-6b-mesh-2x2": sharded["launches_fwd"],
               "train-qwen2-moe-mesh-2x2": sharded["moe"]["launches_fwd"],
               "product-serving": product["serving"]["launches_fwd"],
               "serve-yi-6b-mesh-2x2": sharded["serve"]["launches_fwd"]}
    kernels.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": FLASH_SOURCE, "fma_source": FLASH_FMA_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "launches_wgmma": serving["launches_wgmma"] + sum(
            families[k]["launches"] for k in ("qwen2-moe", "jamba",
                                              "whisper"))
        + sum(train[k]["launches_fwd"] for k in ("yi", "qwen2-moe",
                                                  "jamba"))
        + product["launches_fwd"] + product["moe"]["launches_fwd"]
        + sharded["launches_fwd"] + product["serving"]["launches_fwd"]
        + sharded["serve"]["launches_fwd"],
        "launches_fma": serving["launches_fma"]
        + sharded["moe"]["launches_fwd"],
        f"launches_{serving['long_s'] // 1024}k": serving["launches_long"],
        "max_abs_err": flash["max_abs_err"], "rel_l2": flash["rel_l2"],
        "max_abs_err_32k": flash["max_abs_err_32k"],
        "rel_l2_32k": flash["rel_l2_32k"], "ms": flash["ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "shape": flash["shape"],
        "device_ms": serving["device_ms"],
        "max_abs_err_cases": flash["err"],
        "launches_phase11": autotune["launches"]["flash_attention"],
        "tiles_phase11": autotune["tiles"]["flash_attention"],
        "tuned_phase11": autotune["tuned"]["flash_attention"],
        "phase12_shapes": families["flash"],
        "phase12_device_ms": {
            "qwen2-moe": families["qwen2-moe"]["flash_device_ms"],
            "jamba": families["jamba"]["flash_device_ms"],
            "whisper": families["whisper"]["device_ms"]},
        "chip_layer": product["flash_layer"],
        "chip_layers_moe": {a: c["flash_layer"] for a, c in
                            product["moe"]["cells"].items()},
        "chip_layer_prefill_32k": product["serving"]["flash_layer"],
        "launches_phase14_per_probe": product["launches_fwd_per_probe"],
        "serving_chip_probes": {n: {k: p["record"][k] for k in (
            "measured_step_s", "scored_step_s", "mfu", "n_layers",
            "reduced", "batch", "seq_len")}
            | {"collective_s": p["record"]["roofline"]["collective_s"],
               "coll_by_kind": p["record"]["roofline"]["coll_by_kind"],
               "peak_gib": p["record"]["memory"]["max_memory_allocated_gb"],
               "flash": p["launches"], "mlstm": p["mlstm"]}
            for n, p in product["serving"]["probes"].items()},
        "serve_mesh_2x2": {k: sharded["serve"][k] for k in (
            "wall_s", "logits_rel_l2", "flash_rel_l2", "flash_max_abs_err")},
    })
    xl, mbwd = train["xlstm"], train["mlstm_bwd"]
    ssm = product["ssm"]
    ssm_probes = {a: {n: {k: p["record"][k] for k in (
        "measured_step_s", "scored_step_s", "mfu", "step1_loss", "reduced")}
        | {"collective_s": p["record"]["roofline"]["collective_s"],
           "coll_by_kind": p["record"]["roofline"]["coll_by_kind"],
           "peak_gib": p["record"]["memory"]["max_memory_allocated_gb"],
           "estimated_gib": p["record"]["memory"]["estimated_gb"],
           "mlstm_launches": p["mlstm"]}
        for n, p in c["probes"].items()} | {"depth": c["depth"],
                                             "positions": c["keep"]}
        for a, c in ssm["cells"].items()}
    kernels.append({
        "name": "mlstm_chunk_fwd", "route": "cuda",
        "source": MLSTM_SOURCE, "fma_source": MLSTM_FMA_SOURCE,
        "replaces": MLSTM_REPLACES,
        "launches": xlstm["launches"] + xl["launches_fwd"]
        + ssm["launches_fwd"] + product["serving"]["mlstm_launches"],
        "launches_by_path": {"xlstm-1.3b": xlstm["launches"],
                             "train-xlstm-1.3b": xl["launches_fwd"],
                             "product-xlstm-1.3b": ssm["launches_fwd"],
                             "product-xlstm-1.3b-prefill":
                             product["serving"]["mlstm_launches"]},
        "launches_wgmma": xlstm["launches_wgmma"] + xl["launches_fwd"]
        + ssm["launches_fwd"] + product["serving"]["mlstm_launches"],
        "chip_layer": ssm["chip_layer"]["fwd"],
        "chip_layer_prefill": product["serving"]["mlstm_layer"],
        "launches_fma": xlstm["launches_fma"],
        "max_abs_err": mlstm["max_abs_err"], "rel_l2": mlstm["rel_l2"],
        "ms": mlstm["ms"], "plain_ms": mlstm["plain_ms"],
        "fma_ms": mlstm["fma_ms"],
        "bound_ms": mlstm["bound_ms"], "bound_by": mlstm["bound_by"],
        "library_ms": None, "shape": mlstm["shape"],
        "device_ms": xlstm["device_ms"],
        "pass_device_ms": xlstm["pass_device_ms"],
        "max_abs_err_fma": mlstm["max_abs_err_fma"],
        **{k: v for k, v in mlstm.items() if k.startswith("rel_l2_")},
        "max_abs_err_cases": mlstm["err"],
        "launches_phase11": autotune["launches"]["mlstm_chunk"],
        "tiles_phase11": autotune["tiles"]["mlstm_chunk"],
        "tuned_phase11": autotune["tuned"]["mlstm_chunk"],
    })
    bwd, yi, wh = train["bwd"], train["yi"], train["whisper"]
    fam = {k: train[k] for k in ("qwen2-moe", "jamba")}
    fam_bwd = sum(f["launches_bwd"] for f in fam.values())
    moe_bwd = product["moe"]["launches_bwd"] + sharded["moe"]["launches_bwd"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": FLASH_BWD_SOURCE, "fma_source": FLASH_BWD_FMA_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": yi["launches_bwd"] + fam_bwd + product["launches_bwd"]
        + sharded["launches_bwd"] + moe_bwd,
        "launches_wgmma": yi["launches_bwd"] + wh["launches_bwd_wgmma"]
        + fam_bwd + product["launches_bwd"] + sharded["launches_bwd"]
        + moe_bwd,
        "launches_fma": wh["launches_bwd_fma"],
        "launches_by_path": {"train-yi-6b": yi["launches_bwd"],
                             "train-whisper": wh["launches_bwd"],
                             **{f"train-{k}": f["launches_bwd"]
                                for k, f in fam.items()},
                             "product-yi-6b": product["launches_bwd"],
                             "product-moe": product["moe"]["launches_bwd"],
                             "train-yi-6b-mesh-2x2":
                             sharded["launches_bwd"],
                             "train-qwen2-moe-mesh-2x2":
                             sharded["moe"]["launches_bwd"]},
        "layers": {k: {**bwd["layers"][k],
                       "step_device_ms": f["bwd_set_device_ms"],
                       "launches_per_step": f["per_step"]["bwd_wgmma"]}
                   for k, f in fam.items()},
        "fma_ms": bwd["fma_ms"],
        "max_abs_err": bwd["max_abs_err"], "rel_l2": bwd["rel_l2"],
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"], "shape": bwd["shape"],
        "device_ms": bwd["device_ms"],
        "step_device_ms": yi["bwd_set_device_ms"],
        "b2": bwd["b2"],
        "chip_layer": bwd["layers"]["yi-6b-chip"],
        "chip_layers_moe": {k: bwd["layers"][k] for k in
                            ("qwen2-moe-chip", "grok-1-chip")},
        "moe_chip_probes": {a: {n: {k: p["record"][k] for k in (
            "measured_step_s", "scored_step_s", "mfu", "step1_loss")}
            | {"collective_s": p["record"]["roofline"]["collective_s"],
               "coll_by_kind": p["record"]["roofline"]["coll_by_kind"],
               "peak_gib": p["record"]["memory"]["max_memory_allocated_gb"],
               "launches": p["launches"]}
            for n, p in c["probes"].items()} | {"depth": c["depth"]}
            for a, c in product["moe"]["cells"].items()},
        "train_moe_mesh_2x2": {k: sharded["moe"][k] for k in (
            "wall_s", "loss_rel", "grad_rel_l2")},
        "launches_phase14_per_probe": product["launches_bwd_per_probe"],
        "max_abs_err_cases": bwd["err"],
        "train_mesh_2x2": {
            "backend": sharded["backend"], "wall_s": sharded["wall_s"],
            "coll_by_kind": [r["coll_by_kind"] for r in sharded["ranks"]],
            "loss_rel": sharded["loss_rel"],
            "grad_rel_l2": sharded["grad_rel_l2"],
            "sp_loss_rel": sharded["sp_loss_rel"],
            "sp_grad_rel_l2": sharded["sp_grad_rel_l2"],
            **{k: [r[k] for r in sharded["ranks"]]
               for k in ("step_s", "step_peak_gib", "setup_peak_gib",
                         "state_gib", "sp_step_s", "sp_step_peak_gib",
                         "sp_coll_by_kind")}},
        "train_step_s": yi["step_s"], "train_tokens_per_s":
        yi["tokens_per_s"], "train_peak_gib": yi["peak_gib"],
        "train_shares": yi["shares"],
        "family_train": {k: {key: f[key] for key in (
            "n_layers", "reduced", "step_s", "tokens_per_s", "peak_gib",
            "shares", "loss_rel", "grad_rel_l2", "loss_drop", "adafactor",
            "wall_s")} for k, f in fam.items()},
    })
    kernels.append({
        "name": "mlstm_chunk_bwd", "route": "cuda",
        "source": MLSTM_BWD_SOURCE, "fma_source": MLSTM_BWD_FMA_SOURCE,
        "replaces": MLSTM_REPLACES,
        "launches": xl["launches_bwd"] + ssm["launches_bwd"],
        "launches_wgmma": xl["launches_bwd_wgmma"] + ssm["launches_bwd"],
        "launches_fma": xl["launches_bwd_fma"],
        "launches_by_path": {"train-xlstm-1.3b": xl["launches_bwd"],
                             "product-xlstm-1.3b": ssm["launches_bwd"]},
        "chip_layer": ssm["chip_layer"]["bwd"],
        "ssm_chip_probes": ssm_probes,
        "launches_per_step": xl["per_step"],
        "max_abs_err": mbwd["max_abs_err"], "rel_l2": mbwd["rel_l2"],
        "ms": mbwd["ms"], "plain_ms": mbwd["plain_ms"],
        "fma_ms": mbwd["fma_ms"], "fma_device_ms": mbwd["fma_device_ms"],
        "turns_ms": mbwd["turns_ms"],
        "kernel_device_ms": mbwd["kernel_device_ms"],
        "workspace_mb": mbwd["workspace_mb"],
        "bound_ms": mbwd["bound_ms"], "bound_by": mbwd["bound_by"],
        "library_ms": None, "shape": mbwd["shape"],
        "device_ms": mbwd["device_ms"],
        "step_device_ms": xl["bwd_step_device_ms"],
        "max_abs_err_cases": mbwd["err"],
        "train_step_s": xl["step_s"],
        "train_tokens_per_s": xl["tokens_per_s"],
        "train_peak_gib": xl["peak_gib"], "train_shares": xl["shares"],
        "train_loss_rel": xl["loss_rel"],
        "train_launch_rel_l2": xl["launch_rel_l2"],
        "train_float32": xl["float32"],
    })
    print(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
