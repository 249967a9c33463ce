#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and the CUDA toolkit.  Phases, one line each or more, and any failure
exits non-zero:

1. environment: torch, the card, ``nvidia-smi`` name and power limit;
2. build: every CUDA source of the port with ``nvcc`` for ``sm_90a``, one
   process per source, all started together;
3. kernel parity: each kernel against its plain PyTorch version at the main
   paths' shapes (cached flash: f32 at 1e-4 with TF32 off, bf16 at 3e-2
   and within 3e-2 |want| + min(3e-2, 0.1 rms(want)) element by element,
   over the whole output and slot by slot (rms of each batch row's own
   output, so a long slot's small outputs set its own term), two runs
   bit-equal, and a 4096-row cache; paged flash: the same
   tolerances at page sizes 1, 5 and 16, NaN in every page row no query can
   see, two runs bit-equal, and exactly the cached kernel's output on the
   same rows laid out contiguously, at the 4096-row cache too; the launch
   geometry of both at the main shape, at least 128 CTAs, and their time
   also as launches replayed from a CUDA graph; both again past D 128, on
   the tensor cores with Q read from shared memory, at gemma-2b's block
   prefill (D 256, one kv head) and stablelm-12b's (D 160, 32 heads over
   8): f32 and bf16 parity, the fixed max |err| <= 3e-2, paged equal to
   cached, two runs bit-equal, the empty slot exactly 0, each launch held
   to ``flash_attention.block_plan_model`` with ptxas's registers and
   spill stores, each timed beside its bound, its plain version, SDPA and
   a page gather + SDPA; no bf16 instantiation built on the FMA loops;
   Fisher: f32 at 1e-5, bf16
   inputs at 2e-2, masked rows holding NaN, the tap-gradient launch held
   to its host-side model, and its task axis (T = 1, 3, 4 stacked d_ff
   groups with ragged masks: one launch, each task bit-equal to a
   one-task launch, timed at T = 4 beside ``torch.einsum``), and its
   (N, D, C) route at (4, 1024, 512), (6, 7, 77) and ``FISHER_GENERAL``'s
   four shapes, f32 and bf16, masked (NaN rows) and unmasked, two runs
   bit-equal, each launch held to ``fisher.general_plan`` (at least a
   wave of CTAs at the bench's and the wide shape), timed beside its
   bound, its plain version and the einsum pair; grad_quant: codes, scale and
   residual exactly equal, f32 and bf16 g, a ragged multi-block size, ties,
   zeros and a NaN, on each of its paths (one CTA, on chip, two passes:
   one element either side of the on-chip capacity, two leaves), its one
   launch held to its host-side model, and the tree compressor with no
   host read; SSD scan: the forward kernel against the sequential oracle
   (with the final state and without it, the main path's launch of
   several heads a CTA) and the backward kernel against autograd of the
   plain chunked body, f32 at 1e-4 and bf16 at 2e-2 of max(1, max |want|)
   (the forward at 1e-4 in both), at the mamba2 adapt shape, over five
   tiles with an initial state, and at the chunk of 256, then both launch
   geometries (held to their host-side models) and the backward's time
   split by launch (torch.profiler); aligned flash (kernel 3): f32
   at 1e-4 with TF32 off and bf16 at 3e-2 at the kernel bench's two shapes
   (causal), at qwen2-1.5b's attention width as a long cache-free prefill
   (1, 4096, 12, 2, 128) in bf16, at mixtral-8x7b's sliding window (1,
   8192, 32, 8, 128, window 4096) in bf16, at gemma-2b's (1, 4096, 8, 1,
   256) and stablelm-12b's (1, 4096, 32, 8, 160) prefill widths in bf16,
   without the causal mask, with Sk != Sq both ways, a window smaller than
   a tile and D = 256, and on its TMA + wgmma path (bf16, D 64, 128 and
   160 to 256) a window smaller than its tile and Sq, Sk off multiples of
   128 both ways, f32 (TF32 tensor cores) at the same shapes), then its
   median time beside its bound (f32: three TF32 products at the TF32
   rate, the CUDA cores' bound beside it), the plain version's time and
   one PyTorch library call's time where one computes the same function
   (a yardstick the port never calls), each path's launch geometry (held
   to its host-side model, with ptxas's registers and spills) and the
   wgmma path's time with and without a GQA group sharing K/V;
4. small-input checks on qwen2-smoke in f32, card against the plain path
   on the CPU: the serving engine's greedy streams (contiguous, paged, and
   paged under half the page budget with at least one requeue), and
   TinyTrain's adaptation (the same policy, losses within 1e-4, the same
   streams from the engine with the deltas folded in), and two users'
   deltas served per slot through the personalisation arena (the same
   streams as on the CPU and as each user's folded engine on the card);
   sampled streams (T 0.7, top-k 8, seed 11) of the eager loop and the
   fused engine at blocks 1 and 8, all equal on the card and the CPU and
   unlike the greedy ones; one sampled paged run at half the pages with
   backfill and a fault plan (forced preemption, an exhaustion window, NaN
   logits), its streams and tally equal to the CPU's; a paged run whose
   head waits on pages, in fewer ticks with ``admit_backfill=2`` than
   with FIFO admission and with the same streams; the Threefry bits at
   vocab 151,936 over a grid of (seed, sid, token) keys, bit-equal to the
   CPU's;
   then TinyTrain on mamba2-smoke f32 through the SSD kernels, card
   against the CPU: the same policy of SSD units, losses within 1e-4, the
   same folded streams;
5. serve: qwen2-1.5b at its published width in bf16 (random weights from
   a seeded generator), 8 requests through ``ServeEngine``; every request
   must end ``done`` with 16 tokens, and the cached flash kernel's launch
   count over the run must be a positive multiple of the layer count;
7. paged serve, on phase 5's weights and requests: ``kv_paging=True``,
   page size 16, the default budget (256 pages); every request ``done``
   with 16 tokens, streams identical to phase 5's, the paged flash kernel
   launched a positive multiple of 28 times and the cached one never,
   and at least the fixed-stripe bytes in pages;
8. pressure: the same model at half the page budget (128 pages) and
   eight longer requests whose pages outgrow it; every request ``done``,
   at least one preemption with requeue, the paged kernel launched; the
   streams that equal an unpressured run of the same requests are
   counted, not gated (a recompute in bf16 may round otherwise);
9. int8 pages, phase 5's requests: every request ``done`` with 16 tokens
   and 59,637,760 bytes of pages and scales; block prefill gathers the
   int8 pages and runs the cached kernel;
17. sampling, on phase 5's weights and requests: a sampled fused serve
   at T 0.7, top-k 50, seed 11 (its streams counted against the greedy
   ones, beside the greedy token's lead over its runner-up, which makes
   them the argmax on these random weights), then at T 3 twice: every
   request ``done`` with 16 tokens, the two runs bit-equal, no stream
   equal to its greedy one, the cached flash kernel launched a positive
   multiple of 28 times in each serve, one sync a chunk; the streams of
   fused B1 and the eager loop (on the four shortest prompts) and of a
   run evacuated once a stream holds 8 tokens and resubmitted to a fresh
   engine, counted equal to fused B8's (printed, not gated: a bf16
   recompute may round otherwise); phase 5's greedy serve again with the
   sampler's functions refusing to run: its streams and its flash
   launches a live tick equal phase 5's; one pick's time and kernel
   launches, sampled and greedy; then phase 8's pressure run with
   ``admit_backfill=2`` (phase 4 gates that a bypass happens) and a
   fault plan (NaN logits at two (request, token) coordinates, one
   forced preemption): every request ends with a
   typed outcome, ``numerics`` exactly at the two coordinates and
   ``done`` elsewhere, at least one requeue, the paged kernel launched,
   one sync a chunk;
6. adapt: the twin of ``examples/serve_batched.py`` at qwen2-1.5b's full
   width in bf16: ``TinyTrainSession.adapt`` (Fisher probe through the
   Fisher kernel, Eq. 3 selection, 10 fused fine-tune steps) under the
   example's own ``edge-lm`` profile scaled to this width (2 GB of
   backward memory, compute fraction 0.8, half of each unit's channels:
   whatever the order of the Fisher scores, it selects both attention
   and MLP units here), then
   ``fold_into`` a ``ServeEngine`` and 10 requests; finite losses that
   fall, two host transfers, two Fisher launches (one per tap group), the
   flash kernel launched, every request ``done``;
10. personalise, on phase 6's session, weights and policy: a
   ``ServeEngine(slots=8, max_len=128, chunk=16, personalise=policy)``
   serves 16 requests of 4-23 prompt tokens and 16 new tokens for 4 users
   (``uid = i % 4``) through ``Personaliser(iters=8, seq=32).run_online``:
   between chunks the users with two finished streams adapt together
   (``adapt_many``), their deltas go through the int8 error-feedback
   exchange (the grad_quant kernel) and hot-swap into their slots; every
   request ``done``, at least one refresh, grad_quant launched once per
   leaf of every refreshed delta set, a payload ratio above 3.9, the
   cached flash kernel launched a positive multiple of 28 times;
11. mamba2: the twin of ``launch.serve --arch mamba2-1.3b --preset full
   --adapt`` at mamba2-1.3b's published width and depth in bf16 (48
   layers, d_model 2048, 64 SSD heads of 64, state 128; random weights
   from a seeded generator): ``TinyTrainSession.adapt`` on phase 6's
   episode shape under phase 6's profile (the SSD scan kernels forward
   and backward, the Fisher kernel), ``fold_into`` a ``ServeEngine`` (4
   slots, max_len 96) and 10 requests; finite losses, two host transfers,
   one Fisher launch (one tap group), forward SSD launches a positive
   multiple of 48, backward launches, each backward two device kernels
   (the fused backward and the cluster groups' sum; the forward is not
   re-run), SSD units selected, every request ``done``; then the folded
   weights serve the same requests from a paged engine (``kv_paging``:
   the pool and admission in pages, no page store), every request
   ``done``, one sync a chunk, streams equal to the contiguous ones.

12. kernel bench: ``benchmarks_torch/kernel_bench.py --full`` in this
   process (its record appended to ``build/BENCH_torch_kernels.json``),
   the path that runs kernel 3: every row within its tolerance, every
   field of the record present, the aligned flash kernel launched.
13. quickstart: the twin of ``examples/quickstart.py`` on the edge CNN
   (tiny-cnn at in_res 32, batch 64, a 'glyphs' task of 64 support and 96
   query rows, ``RPI_ZERO``, 30 fused fine-tune steps): the policy, the
   memory report against the budget, fisher and train seconds, accuracy
   before and after; two card runs with bit-equal losses and deltas, two
   host transfers; card against the CPU (``device="cpu"``, the same
   weights) over 4 steps: the same policy, losses within 1e-4, equal
   accuracy (over 30 the gap is printed: the CPU differs from itself at
   another thread count by more than 1e-4 there);
14. the paper's backbones: mcunet, mobilenetv2 and proxylessnas at their
   builders' in_res 84 and batch 64, each adapting one task under
   ``STM32F746.scaled(mem=1.6)`` (20 steps, at least one unit selected,
   card against CPU as in phase 13), then the twin of
   ``examples/ondevice_adaptation.py`` up to its ``mesh=`` part on
   mcunet: four users through ``adapt``, the same users through
   ``adapt_many`` under the first user's policy, a heterogeneous mix of 8
   through bucketed ``adapt_many`` (buckets and groups printed), each
   fleet task held to its own ``adapt`` on the card over 4 steps (losses
   within 1e-4, equal accuracy), and one user's deltas
   folded (the folded copy's features equal the delta forward's within
   1e-5).  The CNN path launches none of the port's kernels (its
   convolutions are cuDNN's, as the JAX package's are XLA's): every launch
   count stays 0 over phases 13 and 14.
15. the paper's baselines and criteria on mcunet at phase 14's shape and
   profile: ``none``, ``fulltrain``, ``lastlayer``, ``tinytl``,
   ``adapterdrop50``, ``sparseupdate`` (its ES policy searched on a
   'gratings' proxy task) through ``TinyTrainSession.baseline``, and the
   criteria ``tinytrain``, ``fisher_only``, ``fisher_mem``,
   ``fisher_compute``, ``random``, ``l2norm``: each once over 20 steps
   (accuracy, train_seconds, peak memory printed), then over 4 steps on
   the card and on the CPU from the same weights: the same policy, losses
   within 1e-4 (for fulltrain, tinytl and adapterdrop50, which train a
   dense tree, the first 2 under Adam and all 4 under SGD at the same lr;
   their first gradient in float64 within 1e-9 of the CPU's, and in
   float32 at most 3x as far from it as the CPU's float32 one, since
   float32 leaves it 5e-4 to 1e-2 off on both devices and Adam's
   sign-like steps carry that into the 3rd and 4th losses; TinyTL's own
   ops alone within 1e-5 of float64; the gaps printed step by step beside
   the CPU at 1 thread against all, and the accuracies); the session's
   params bit-equal after all twelve; no kernel launched.
16. ``adapt_many``'s criterion route (no policy override): 4 qwen2-1.5b
   tasks at phase 6's width, depth, sequence length and profile in 2
   buckets (phase 6's task of 48 support rows, and three 3-way tasks of
   12), probed a shape group at a time
   (the group's rows through one forward and backward, then kernel 1's
   task axis): exactly one Fisher launch per tap group per shape group; each task's scores bit-equal to
   a one-task launch on its tap gradients and within 1e-5 of the plain
   version; each task's policy its own ``adapt``'s, or differing only in
   channels whose scores sit within the bf16 Fisher tolerance of the
   unit's k-th score; then the same route on mcunet with phase 14's four
   users (plain reduction, no launch).
18. the moe family: (a) mixtral-smoke and deepseek-smoke in f32 (TF32
   off), card against the plain path on the CPU from the same weights:
   greedy streams on contiguous, paged and int8 caches and mixtral's
   rolling window (prompts of 8, 30, 45 and 70 tokens at max_len 80),
   TinyTrain's policy and losses (within 1e-4) and folded streams, and
   two users' deltas over every unit kind served per slot (also against
   the folded engines); (b) kernels 2 and 4 at mixtral's block prefill (8
   slots, Hq 32, Hkv 8, D 128, max_len 512; f32 at 1e-4, bf16 under the
   per-slot gate, paged equal to cached) and kernel 1 at both models' tap
   groups (8 and 256 experts, 32 and 128 heads, deepseek's dense-head
   d_ff of 18,432; f32 at 1e-5, the padding rows NaN), each timed beside
   its bound, its plain version and SDPA, a page gather + SDPA or
   ``torch.einsum``; (c) mixtral-8x7b at 16 of its 32 layers and
   deepseek-v3-671b at 4 of its 61 (the 3 dense-head layers, one MoE
   layer of 256 experts and the MTP block), published widths, bf16,
   random weights from seed 0: ``TinyTrainSession.adapt`` on phase 6's
   episode shape under phase 6's profile scaled to the width (one Fisher
   launch a tap group, two host transfers, finite losses), ``fold_into``
   and phase 5's traffic on contiguous and paged caches (every request
   ``done`` with 16 tokens, one sync a chunk, mixtral's flash kernel a
   positive multiple of its 16 layers, none for deepseek's MLA, paged
   streams equal to contiguous ones), and mixtral's rolling serve at 8
   layers (two prompts of 4,150 and 4,200 tokens at max_len 4,224: every
   request ``done``, a 4,096-row cache, one sync a chunk).
19. the ssm-based families finished: (a) zamba2-smoke and mamba2-smoke
   in f32 (TF32 off), card against the plain path on the CPU from the
   same weights: greedy streams on contiguous, paged, int8 and pressured
   (half the pages) caches, TinyTrain's policy and losses (within 1e-4)
   and folded streams, and two users' SSD-head deltas served per slot
   (also against the folded engines); (b) kernels 2 and 4 at zamba2's
   shared-block prefill (8 slots, Hq = Hkv = 32, D 64, max_len 512; f32
   at 1e-4, bf16 under the per-slot gate, paged equal to cached), kernels
   5 and 5b at zamba2's adapt shape (48 rows of 64 tokens, 64 heads of
   64, state 64) against the plain version, the same under
   ``torch.func.vmap`` of a gradient over 4 tasks (each task's y and
   gradients bit-equal to its own launch's, one launch each way), and
   kernel 1 at zamba2's tap group (38, 48, 64), each timed beside its
   bound, its plain version and SDPA, a page gather + SDPA or
   ``torch.einsum``; (c) zamba2-1.2b at its published width and depth in
   bf16 (38 SSD layers, d_model 2048, 64 SSD heads of 64, state 64,
   one shared attention + MLP block of 32 heads of 64 and d_ff 8,192
   after every 6th layer; random weights from seed 0):
   ``TinyTrainSession.adapt`` on phase 6's episode shape under phase 6's
   profile, ``fold_into`` and phase 5's traffic on contiguous and paged
   caches (every request ``done`` with 16 tokens, one sync a chunk, the
   flash kernel a positive multiple of the 6 shared-block applications,
   paged streams equal to contiguous ones, the shared block's KV
   25,165,824 B a slot in the engine's report); (d) phase 10's traffic
   and ``Personaliser(iters=8, seq=32)`` on zamba2-1.2b with (c)'s
   policy: at least one refresh, the SSD kernels launched under
   ``torch.func.vmap`` (``adapt_many``), grad_quant once a leaf of every
   refreshed delta set, every request ``done``, one sync a chunk.
20. the encoder-decoder and VLM families: (a) whisper-smoke and
   paligemma-smoke in f32 (TF32 off), card against the plain path on the
   CPU from the same weights, every request with its own encoder inputs:
   greedy streams on contiguous, paged, int8 and pressured (half the
   pages: at least one preemption) caches, TinyTrain's policy and losses
   (within 1e-4) on a conditioned task and folded streams, and two users'
   deltas over every unit kind (whisper's cross-attention heads
   included) served per slot (also against the folded engines); then per
   model, (b) whisper-base and (c) paligemma-3b: kernels 2 and 4 at its
   block prefill (8 slots, max_len 512; whisper Hq = Hkv = 8, D 64;
   paligemma's gemma decoder Hq 8 over one kv head, D 256) and kernel 1
   at its tap groups over 48 rows, against their plain versions and timed
   beside the bound and SDPA, a page gather + SDPA or ``torch.einsum``;
   whisper's encoder attention (``chunked_attention`` over 1500 frames,
   plain torch) timed beside SDPA; then the model at its published
   config, nothing cut, bf16, random weights from seed 0:
   ``TinyTrainSession.adapt`` on phase 6's episode shape with encoder
   inputs (``sample_encdec_task``; paligemma's rows cut from 48 to 24,
   each with its 256-position prefix, for the probe's memory) under phase
   6's profile scaled to the width (one Fisher launch a tap group, whisper's cross-attention group
   included, two host transfers, finite losses), ``fold_into`` and phase
   5's traffic with encoder inputs on contiguous and paged caches
   (paligemma's 256-token prefix inside max_len 768; the paged pool sized
   for eight residents' KV and encoder runs): every request ``done`` with
   16 tokens, one sync a chunk, the flash kernel a positive multiple of
   the decoder's layers, a run of 1,536,000 B (whisper) or 1,048,576 B
   (paligemma) a resident, paged streams equal to contiguous ones.
21. block scoring and the fleet, on qwen2-1.5b at its published width in
   bf16 with phase 5's weights unless named: (a) kernel 2 at
   ``block_score``'s block (8 sequences, 32 queries, 12 heads over 2 of
   128, cursors to a full 512-row cache) against its plain version (f32
   at 1e-4, bf16 under the per-slot gate, two runs bit-equal) and timed
   beside its bound, plain version and SDPA; ``score_stream`` over 8
   sequences of 512 tokens at block 32: one host fetch, kernel 2 once a
   block a layer (448), each mean NLL within 1e-2 of max(1, |want|) of a
   whole-sequence forward (``T.forward_hidden`` + ``unembed``);
   qwen2-smoke f32 (TF32 off) scores card against CPU to 1e-5; (b)
   ``FleetRouter(replicas=2)`` on the one card with phase 5's traffic,
   contiguous then paged, greedy and sampled (T 3, top-k 50): every
   request's stream equal to one engine's, the work on both replicas,
   ``host_syncs == chunks`` on each; replica 1 failed after the first
   round: its backlog re-routed, every request ``done`` with the engine's
   stream; the router on qwen2-smoke f32, card against CPU; (c) the
   ``Personaliser`` over ``FleetRouter(replicas=2, personalise=...)`` (8
   slots each) with phase 10's traffic and phase 6's policy: every refresh
   shipped as serialized bytes (kernel 6 once a delta leaf a refreshed
   user, payload ratio above 3.9), the streams equal to one personalised
   engine's of 16 slots; (d) ``adapt_many`` over phase 10's four users'
   episodes on qwen2-1.5b in f32 (TF32 off), the probe route, with no
   mesh, over ``make_debug_mesh(2)`` on the one card, with ``hosts=2``,
   and with no mesh a shard's two tasks at a time: the same policies,
   each mesh task bit for bit the single-device fleet of its shard's
   tasks, ``hosts=2`` bit for bit with the global mesh, kernel 1 once a
   tap group a shard; the losses' distance to the four-task single-device
   fleet printed against rtol 1e-4 / atol 1e-5.
22. the training launcher, in bf16 unless named, its checkpoints in a
   temporary directory removed at the end: (a) ``launch.train.main``
   in-process with ``examples/distributed_finetune.py``'s arguments on
   qwen2-1.5b's published config (60 tinytrain steps of 8 x 128 tokens
   under an 8 MB, half-compute profile, which selects no unit at this
   width), then again under phase 6's envelope (2,000 MB, 0.8 of the
   compute; a policy must select units): the policy and probe seconds,
   ms a step warm, each save's seconds and the checkpoint's bytes; (b)
   its pieces, under phase 6's envelope, with ``Trainer`` for 12 steps
   with a checkpoint every 4, a
   failure injected at step 9 and a restart: the final deltas and Adam
   state bit for bit the uninterrupted run's, the restore's seconds; (c)
   ``--mode full`` at the published width, 2 of 28 layers, 3 steps and one
   save: peak memory, checkpoint bytes, a restore bit-equal to the saved
   state; (d) mamba2-1.3b's published config, tinytrain under phase 6's
   envelope: kernels 5 and 5b
   launched (counted in the kernels' record); (e) qwen2-smoke in f32,
   weights drawn on the CPU and copied to the card: the launcher's
   probe, policy, sparse steps and ``Trainer`` card against CPU, the same
   policy and losses within 1e-5 of max(1, |CPU's|).
23. the planning tools: (a) ``launch.dryrun``'s cells on the meta device,
   counted by processes of their own started right after the build
   (every LM arch at train_4k, decode_32k and long_500k on the 16 x 16
   mesh, qwen2-1.5b's prefill_32k and its train_4k on 2 x 16 x 16):
   every record counted, or skipped exactly where ``shape_applicable``
   skips, none with an error, each count's wall printed; (b)
   ``reanalyze`` from the saved op tables and the roofline table of both
   meshes; (c) qwen2-1.5b's published config in bf16, random weights and
   tokens from seed 0: ``launch.dryrun``'s train step at 1 x 4,096 (the
   dry-run policy, Adam), its prefill at 1 x 32,768 (1 of 28 layers: a
   32k layer is ~131k dispatched ops) and its decode over a 32,768-row
   cache, each on the card: the op analyser's FLOPs equal to its count
   on the meta device at the same shape, ``torch.profiler``'s FLOPs, the
   warm wall and device busy share beside max(t_compute, t_memory) over
   the card's peaks, the peak memory's rise beside ``peak_live_bytes``,
   no port kernel launched; (d) ``launch.train --production-mesh`` for 2
   steps on qwen2-smoke on the card: the mesh line ``{'data': 16,
   'model': 16}``.
24. the overlay registry and the capped MoE decode: (a) qwen2-1.5b's
   published config in bf16, a spec registered over the built-in
   ``mlp`` from outside the package (``w_up`` and ``w_down`` only,
   through ``serving.engine.register_unit_overlay``, the built-in
   restored after), two users' seeded deltas on 128 neurons of 4 layers,
   phase 5's traffic split between them: ``ServeEngine(personalise=)``'s
   streams identical to each user's folded engine's and unlike the base
   model's, kernel 2 launched; (b) a raw folder
   (``register_unit_folder``) folds one layer's ``w_down`` rows on the
   card bit for bit as on the CPU, and ``ServeEngine(personalise=)``
   refuses it; (c) mixtral-8x7b at its published width, 8 of 32 layers,
   one decode step of 8 slots after a 16-token prefill:
   ``decode_step(drop_free=False)`` (the capped queue) against
   ``drop_free=True``, the dropped assignments printed, the rows with
   none dropped equal to bf16 rounding, and ``op_analysis``'s FLOPs of
   ``dryrun.build_decode_step`` on the card equal to its meta count.

Phases 7 to 9 and 17 run right after phase 5, on its weights.  The
fused serves of phases 5, 7 to 11 and 17 print ``host_syncs`` beside
``chunks`` and fail unless they are equal (one blocking read a chunk, none
inside the tick loop; the eager loop reads every tick by design); phases
5, 7, 8, 10, 11 and 17's fused serves run their tick loops under
``torch.cuda.set_sync_debug_mode("error")``, so a hidden sync there fails
the run.  The kernel launch
counts are set to 0 just before each main path (phases 5 to 24) and read
just after; phase 18's, 19's, 20's and 21's fused serves also run under
sync debug mode "error".  The last three lines are the card's
``nvidia-smi`` name and power limit, the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12,  # dense, non-TC f32 / TC bf16
            "tf32": 495e12}  # dense TF32 tensor cores

# main-path shapes of the cached flash kernel: qwen2-1.5b block prefill with
# 8 slots, prefill_block 8 and max_len 512
MAIN = dict(B=8, Sq=8, Hq=12, Hkv=2, D=128, Sk=512)
# ragged cursors: an empty cache (kv_len 0), a block past its valid rows
# (q_offset + Sq > kv_len), and a block ending at the last cache row
Q_OFFSET = [0, 0, 37, 100, 255, 300, 504, 128]
KV_LEN = [0, 8, 40, 108, 263, 305, 512, 136]
# a long cache (max_len 4096) for kernels 2 and 4: each CTA of a cluster
# walks up to 8 tiles
LONG = dict(Sk=4096, kv_len=[0, 8, 700, 1500, 2600, 3333, 4000, 4096])
PLAN_KEYS = ("CTAs", "cluster", "threads", "smem_bytes", "registers",
             "stages")
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# kernels 2, 3 and 4 in bf16: the absolute term is the smaller of 3e-2 and
# 0.1 rms(want).  An attention output's typical value shrinks as 1 / sqrt(
# visible keys) (rms 0.05 at mixtral's window), so 3e-2 alone would pass a
# dropped or unmasked kv tile at long sequences; kernel 3's own error
# beyond 3e-2 |want| is about 0.03 rms(want) at these shapes (bf16 P).
# Kernels 2 and 4 keep their fixed max |err| <= 3e-2 beside it
BF16_RMS_TOL = 0.1
FISHER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PAGE_SIZE = 16        # cfg.kv_page_size: the paged serve's page size
DEFAULT_PAGES = 256   # the default budget: 8 slots x ceil(512 / 16)
# phase 8: eight requests of 160-320 prompt tokens and 48 new tokens each
# need ceil((P + 48) / 16) = 13 to 23 pages at their ends, about 144 in
# all for this seed (145), against a pool of 128; admission prices only the
# prompts (10 to 20 pages each), so growth runs the pool dry mid-stream
PRESSURE = dict(pages=128, lo=160, hi=321, max_new=48, seed=3)
# the adaptation slice: examples/serve_batched.py at qwen2-1.5b's width
ADAPT = dict(batch_size=48, seq=64, max_way=8, task_way=5, pad=48, iters=10)
# phase 10: the personalised serve and its online refresh loop
PERSONALISE = dict(slots=8, max_len=128, chunk=16, requests=16, users=4,
                   max_new=16, iters=8, seq=32)
# the SSD scan's main-path shape: mamba2-1.3b's cache-free forward over the
# adapt episode (48 rows of 64 tokens, 64 heads of 64, state 128)
SSD = dict(b=48, s=64, h=64, p=64, n=128, chunk=256)
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # relative to max |want|
SSD_TILE = 32  # csrc/ssd_scan.cu's tokens per tile
# kernel 3 (aligned flash): (what, B, Sq, Sk, Hq, Hkv, D, causal, window,
# dtypes); the cases of ALIGNED_TIMED are timed, in their first dtype
ALIGNED = [
    ("bench quick", 1, 512, 512, 4, 2, 64, True, 0, ("float32", "bfloat16")),
    ("bench full", 2, 2048, 2048, 8, 2, 128, True, 0,
     ("float32", "bfloat16")),
    ("qwen2-1.5b prefill", 1, 4096, 4096, 12, 2, 128, True, 0,
     ("bfloat16",)),
    ("mixtral-8x7b window", 1, 8192, 8192, 32, 8, 128, True, 4096,
     ("bfloat16",)),
    # the head dims of gemma-2b and paligemma-3b (256) and stablelm-12b
    # (160, padded to 192 on the wgmma path) at a 4096-token prefill
    ("gemma-2b prefill", 1, 4096, 4096, 8, 1, 256, True, 0, ("bfloat16",)),
    ("stablelm-12b prefill", 1, 4096, 4096, 32, 8, 160, True, 0,
     ("bfloat16",)),
    ("not causal", 2, 256, 256, 2, 2, 128, False, 0, ("float32", "bfloat16")),
    ("Sk < Sq", 1, 300, 200, 4, 2, 64, True, 0, ("float32", "bfloat16")),
    ("Sk > Sq, not causal", 1, 150, 333, 4, 2, 64, False, 0,
     ("float32", "bfloat16")),
    ("window 5 < tile", 2, 130, 130, 2, 1, 16, True, 5,
     ("float32", "bfloat16")),
    ("D 256", 1, 96, 90, 2, 2, 256, True, 40, ("float32", "bfloat16")),
    # the TMA + wgmma path (bf16, D 64 and 128) off its main shapes: a
    # window smaller than its 128-row tile, Sq and Sk not multiples of 128
    # either way, rows that see no key
    ("wgmma window 5 < tile", 2, 130, 130, 2, 1, 64, True, 5, ("bfloat16",)),
    ("wgmma Sk < Sq, window 7", 2, 300, 200, 2, 1, 128, True, 7,
     ("bfloat16",)),
    ("wgmma Sk > Sq, not causal", 1, 150, 333, 4, 2, 128, False, 0,
     ("bfloat16",)),
    # ... and past D 128 (64-row kv tiles, padding columns zero-filled by
    # TMA and never stored), with the float32 path at the same shapes
    ("wgmma D 160, Sk < Sq, window 7", 2, 300, 200, 2, 1, 160, True, 7,
     ("bfloat16", "float32")),
    ("wgmma D 192, window 5 < tile", 2, 130, 130, 2, 1, 192, True, 5,
     ("bfloat16", "float32")),
    ("wgmma D 256, Sk > Sq, not causal", 1, 150, 333, 4, 2, 256, False, 0,
     ("bfloat16", "float32")),
]
ALIGNED_TIMED = ("bench quick", "bench full", "qwen2-1.5b prefill",
                 "mixtral-8x7b window", "gemma-2b prefill",
                 "stablelm-12b prefill")
# phase 13: examples/quickstart.py (tiny-cnn, a 'glyphs' task, RPI_ZERO)
QUICKSTART = dict(arch="tiny-cnn", in_res=32, batch_size=64, max_way=8,
                  domain="glyphs", support_pad=64, query_pad=96, iters=30)
# phase 14: the paper's backbones at their builders' resolution, 64 support
# rows a task, and examples/ondevice_adaptation.py's users on mcunet
PAPER = dict(archs=("mcunet", "mobilenetv2", "proxylessnas"), in_res=84,
             batch_size=64, max_way=8, domain="glyphs", support_pad=64,
             query_pad=96, support_total=64, per_class=16, iters=20, mem=1.6)
# phases 13 and 14 hold the card to the CPU, and adapt_many to adapt, over
# 4 fine-tune steps.  Over 20 to 30, Adam on these random-weight backbones
# carries a 1e-7 rounding difference to losses 1e-4 to 1e-3 apart and to
# another query accuracy: so does the CPU against itself at 1 and 8
# threads (benchmarks_torch/adapt_profile.py prints both gaps step by step)
PARITY_ITERS = 4
USERS = (("user-a", "stripes"), ("user-b", "spots"), ("user-c", "waves"),
         ("user-d", "stripes"))
# phase 15: every baseline and criterion of the paper's tables on mcunet at
# phase 14's shape, the ES baseline's proxy task from a source domain
BASELINES = ("none", "fulltrain", "lastlayer", "tinytl", "adapterdrop50",
             "sparseupdate")
CRITERIA = ("tinytrain", "fisher_only", "fisher_mem", "fisher_compute",
            "random", "l2norm")
PROXY_DOMAIN = "gratings"
# the baselines that train a dense tree (the whole backbone, TinyTL's
# adapters) are held to the CPU on their first gradient, over their first
# DENSE_PARITY_LOSSES losses under Adam (one update) and over all
# PARITY_ITERS under SGD at the same lr.  Taken in float64 on both devices,
# the first gradient agrees to GRAD_F64_TOL of each leaf's largest value;
# in float32 it lies 5e-4 to 1e-2 of that from the float64 one on the card
# and on the CPU alike (the backward through mcunet's ReLU6 layers cancels),
# and the card's may lie at most GRAD_F32_FACTOR times as far as the CPU's.
# Adam's first steps move each weight by about lr in the sign of its
# gradient, so the elements whose sign float32 cannot settle part the two
# devices' 3rd and 4th losses; TinyTL's own ops alone, which do not cancel,
# agree with float64 to TINYTL_OP_TOL of their largest value
DENSE_BASELINES = ("fulltrain", "tinytl", "adapterdrop50")
DENSE_PARITY_LOSSES = 2
GRAD_F64_TOL = 1e-9
GRAD_F32_FACTOR = 3.0
TINYTL_OP_TOL = 1e-5
BASELINE_LR = 1e-3  # TinyTrainSession's baseline_lr
# phase 16: adapt_many's criterion route, 4 LM tasks in 2 buckets at
# phase 6's width, depth, sequence length and profile: phase 6's own task
# (48 support rows, bucket 64) and three 3-way 4-shot tasks (12 rows,
# bucket 16).  Two of phase 6's tasks do not fit on an 80 GB card: their
# batched probe alone holds 47 GB above the weights, against 17.7 GB for
# one task's whole adapt, and adapt_many of the two runs out of memory
# (benchmarks_torch/fleet_memory.py)
FLEET_SHOTS = (4, 4, 4)
FLEET_ITERS = 4
# kernel 1's task axis at the adapt's d_ff group, the masks ragged
FISHER_TASKS = (1, 3, 4)
# kernel 1's (N, D, C) route: the kernel bench's row, qwen2-1.5b's d_ff
# over phase 6's episode (48 rows of 64 tokens), materialised, and two
# edge-CNN layers at 84 px: the first (64 support images, a 42 x 42 map,
# 8 channels) and a late depthwise one of mcunet-5fps (576 at 3 x 3)
FISHER_GENERAL = {"bench": (16, 2048, 1024), "wide": (48, 64, 8960),
                  "cnn-early": (64, 1764, 8), "cnn-head": (64, 9, 576)}
# phase 17's sampling temperature: the random-weight qwen2-1.5b's next
# token leads its runner-up by about 17 logits (phase 17 prints the lead
# over requests 0 and 1), so at T 0.7 every draw is the argmax; at 3 the
# draws leave it
SAMPLE_T = 3.0
# kernels 2 and 4 past D 128, where their tensor-core path reads Q from
# shared memory: gemma-2b's block prefill (D 256, 8 heads over one kv
# head, its 18 layers' buffers cycled) and stablelm-12b's (D 160, 32 heads
# over 8, its 40 layers), phase 3's cursors at max_len 512; each held to
# the same gates as phase 3's main shape and timed beside SDPA and a page
# gather + SDPA
WIDE_BLOCK = dict(B=8, Sq=8, Hq=8, Hkv=1, D=256, Sk=512, layers=18)
STABLELM_BLOCK = dict(B=8, Sq=8, Hq=32, Hkv=8, D=160, Sk=512, layers=40)
WIDE_BLOCKS = (("gemma-2b's", WIDE_BLOCK), ("stablelm-12b's", STABLELM_BLOCK))
# phase 18, the moe family at its published widths with the depth cut to
# fit one 80 GB card: mixtral-8x7b at 16 of 32 layers (46.9 GB of bf16
# weights), deepseek-v3-671b at 4 of 61 (its 3 dense-head layers and one
# MoE layer of 256 experts, plus the MTP block, itself a MoE layer: 53.4 GB);
# benchmarks_torch/serve_profile.py imports this cut
MOE_LAYERS = {"mixtral-8x7b": 16, "deepseek-v3-671b": 4}
# the least free device memory phase 18's adapt must leave at its peak
# (mixtral's 16 layers peak about 2.5 GB below the card's 80 GB)
MOE_HEADROOM = 1 << 30
# mixtral's rolling serve: two prompts that wrap its 4096-row window, on
# 8 of its layers (from seed 0, after the 16-layer model is freed): its
# ~520 block ticks fold the window position by position in every layer,
# the script's longest serve
MOE_ROLLING = dict(slots=2, max_len=4224, chunk=64, lens=(4150, 4200),
                   max_new=16, layers=8)
# phase 18's card-vs-CPU checks on the smoke configs: contiguous, paged and
# int8 caches (mixtral-smoke's 24 rows stay below its 32-row window) and
# tests/test_serve_scan.py's rolling case at max_len 80
MOE_SMOKE = dict(slots=3, max_len=24, chunk=4, page=4, max_new=6,
                 lens=(3, 5, 8, 9, 17), rolling_lens=(8, 30, 45, 70),
                 rolling=dict(slots=2, max_len=80, chunk=16))
# kernels 2 and 4 at mixtral's block prefill (8 slots, prefill_block 8,
# max_len 512, 32 query heads over 8 kv heads), its 16 layers' buffers
# cycled; kernel 1 at the probe's tap groups of both models, with the
# adapt task's 48 rows and their padding mask
MOE_BLOCK = dict(B=8, Sq=8, Hq=32, Hkv=8, D=128, Sk=512, layers=16)
MOE_TAPS = {"mixtral-8x7b": ((16, 32), (16, 8)),
            "deepseek-v3-671b": ((3, 128), (1, 128), (3, 18432), (1, 256))}
# phase 19: the ssm-based families' smoke configs held card against CPU;
# kernels 2 and 4 at zamba2's shared-block prefill (a group of 1, D 64,
# the 6 applications' buffers cycled), kernels 5 and 5b at zamba2's adapt
# shape and under vmap over VMAP_TASKS tasks, kernel 1 at its tap group
HYBRID_SMOKE = ("zamba2-1.2b", "mamba2-1.3b")
SHARED_BLOCK = dict(B=8, Sq=8, Hq=32, Hkv=32, D=64, Sk=512, layers=6)
ZAMBA_SSD = dict(b=48, s=64, h=64, p=64, n=64, chunk=256)
VMAP_TASKS = 4
ZAMBA_TAPS = {"zamba2-1.2b": ((38, 64),)}
# a zamba2-1.2b slot's shared-block KV at max_len 512: 6 applications x
# K and V x 32 heads x 64 x 2 B (bf16) = 49,152 B a token
SHARED_KV_BYTES = 6 * 2 * 32 * 64 * 2 * 512
# phase 20: the encoder-decoder and VLM families.  (a) their smoke configs
# card against CPU, every request with its own encoder inputs, at a size
# where half the pages preempt; (b) and (c) whisper-base and paligemma-3b
# at their published configs, nothing cut
ENC_ARCHS = ("whisper-base", "paligemma-3b")
ENC_SMOKE = dict(slots=3, max_len=48, chunk=4, page=4, max_new=14,
                 lens=(3, 5, 8, 9, 17))
# the serve's cache: paligemma's 256-row image prefix ahead of phase 5's
# prompts (32-256 tokens) and 16 new tokens
ENC_MAX_LEN = {"whisper-base": 512, "paligemma-3b": 768}
# kernels 2 and 4 at each decoder's block prefill (8 slots, prefill_block
# 8) over its serve's cache: whisper's 8 heads of 64 over 8 kv heads, 6
# layers, at max_len 512 and phase 3's cursors; paligemma's heads are
# gemma-2b's (8 of 256 over one kv head, 18 layers), at max_len 768 with
# phase 3's cursors past the first block moved past the 256-row prefix,
# so rows beyond 512 are read (8 x 48 pages of 16 rows)
ENC_BLOCK = {"whisper-base": dict(B=8, Sq=8, Hq=8, Hkv=8, D=64, Sk=512,
                                  layers=6),
             "paligemma-3b": dict(
                 WIDE_BLOCK, Sk=ENC_MAX_LEN["paligemma-3b"],
                 pages=8 * ENC_MAX_LEN["paligemma-3b"] // PAGE_SIZE,
                 q_offset=[o + 256 if o else o for o in Q_OFFSET],
                 kv_len=[n + 256 if o else n
                         for o, n in zip(Q_OFFSET, KV_LEN)])}
# kernel 1 at their probe's tap groups over the adapt's support rows
# (ENC_EPISODE, with that task's padding mask): whisper's heads (self-
# and cross-attention alike) and d_ff, paligemma's heads and d_ff
ENC_TAPS = {"whisper-base": ((6, 8), (6, 2048)),
            "paligemma-3b": ((18, 8), (18, 16384))}
# the adapt's episode: phase 6's (48 rows of 64 tokens) on whisper; on
# paligemma every row also carries the 256-position image prefix, and the
# probe's graph through 18 layers of 16,384-wide GeGLU MLPs over 96 such
# rows (support and query) does not fit 80 GB (77 GB were held in the
# query forward when it failed): cut to 4 shots a class, 24 rows, whose
# adapt figures are not comparable with phase 6's
ENC_EPISODE = {"whisper-base": dict(rows=ADAPT["pad"]),
               "paligemma-3b": dict(rows=24, shots=4, query_per_class=4)}
# a request's encoder run in bf16, its rows x d_model x 2 B (a stripe
# when unpaged; paged, whole pages of 16 rows)
ENC_RUN_BYTES = {"whisper-base": 1500 * 512 * 2,
                 "paligemma-3b": 256 * 2048 * 2}
# phase 21: block scoring and the fleet on qwen2-1.5b's published width.
# (a) score_stream over 8 sequences of 512 tokens at block 32
SCORE = dict(n=8, seq=512, block=32)
# the card-vs-CPU scoring check on qwen2-smoke in f32: a ragged tail
SCORE_SMOKE = dict(n=4, seq=27, block=8)
# score_stream against a whole-sequence forward in bf16, relative to
# max(1, |want|): the two paths round the same products in other orders
# (the block path's K/V through a bf16 cache and kernel 2, the forward's
# through its cache-free attention), so the logits part by a few bf16
# ulps (2^-9 = 0.2 % relative); a mean over 511 positions is held to five
# of them
SCORE_TOL = 1e-2
# kernel 2 at block_score's shape: 8 sequences, a block of 32 queries,
# qwen2's 12 heads over 2 of 128, a 512-row cache; cursors from an empty
# cache to a full one
SCORE_BLOCK = dict(B=8, Sq=32, Hq=12, Hkv=2, D=128, Sk=512,
                   q_offset=[0, 32, 64, 128, 256, 320, 448, 480],
                   kv_len=[32, 64, 96, 160, 288, 352, 480, 512])
# (b) the router: two replicas on the one card, phase 5's traffic, its
# engine settings, sampled at phase 17's settings
FLEET_REPLICAS = 2
FLEET_ENGINE = dict(slots=8, max_len=512, chunk=32)
FLEET_SAMPLED = dict(temperature=SAMPLE_T, top_k=50, sample_seed=11)
# the router on qwen2-smoke in f32, card against CPU
FLEET_SMOKE = dict(slots=2, max_len=48, chunk=4, requests=8, max_new=6)
# (d) the mesh fleet: two data positions on the one card
MESH_POSITIONS = 2
# phase 22: the training launcher (launch.train, runtime.Trainer,
# checkpoint).  (a) examples/distributed_finetune.py's arguments at
# qwen2-1.5b's published config
TRAIN_BUDGET = ["--mem-budget-mb", "8", "--compute-frac", "0.5"]
TRAIN_EXAMPLE = ["--steps", "60", "--batch", "8", "--seq", "128",
                 "--mode", "tinytrain"]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 128, 1e-3
# at the published width the example's 8 MB selects no unit (the
# cheapest at half its channels, an attention unit's 6 heads, needs
# 39,321,600 B by core.criterion.policy_memory_bytes at 8 x 128 tokens),
# so (a) runs again, and (b) and (d) run, under phase 6's envelope
# (edge-lm scaled by mem=500, compute=1.6)
TRAIN_WIDE = ["--mem-budget-mb", "2000", "--compute-frac", "0.8"]
TRAIN_PROFILE = dict(name="cli", mem_kb=2e6, compute_frac=0.8)
# (e)'s smoke model under the example's own envelope
TRAIN_SMOKE_PROFILE = dict(name="cli", mem_kb=8e3, compute_frac=0.5)
# (b) the fault path: a failure at step 9, checkpoints every 4 steps
TRAIN_FAULT = dict(steps=12, ckpt_every=4, fail_at=9)
# (c) --mode full at the published width, the depth cut: the whole
# model's Adam checkpoint (params, m, v in bf16) is ~9.3 GB
TRAIN_FULL = dict(layers=2, steps=3)
# (d) mamba2-1.3b's tinytrain through kernels 5 and 5b
TRAIN_SSD_STEPS = 8
# (e) qwen2-smoke in f32, card against CPU
TRAIN_SMOKE = dict(steps=6, batch=4, seq=32, ckpt_every=3)
TRAIN_LOSS_TOL = 1e-5  # relative to max(1, |want|)
# phase 23, the planning tools: (a)'s dry-run cells on the meta device,
# every LM arch at three shapes on the 16 x 16 mesh, qwen2-1.5b's 32k
# prefill and one 2 x 16 x 16 cell (whose count the 16 x 16 one's reuses);
# each 32k prefill cell counts ~3.7M ops (~2 min), so the other archs'
# prefill cells are left to ``launch.dryrun --all``
PLAN_SHAPES = ("train_4k", "decode_32k", "long_500k")
PLAN_EXTRA = (("qwen2-1.5b", "prefill_32k", False),
              ("qwen2-1.5b", "train_4k", True))
PLAN_WAIT = 600  # s phase 23 waits for the planner's processes at most
# (c)'s steps on the card, qwen2-1.5b at full width in bf16: (batch, seq);
# the prefill at 1 of 28 layers (a layer of 32k is 2,048 chunk pairs of
# chunked_attention, ~131k dispatched ops, each under the analyser and the
# profiler in turn; the script's wall keeps it to one)
PLAN_ARCH = "qwen2-1.5b"
PLAN_STEPS = {"train": (1, 4096), "prefill": (1, 32768), "decode": (1, 32768)}
PLAN_PREFILL_LAYERS = 1
TRAIN_POD = ["--preset", "smoke", "--steps", "2", "--batch", "4", "--seq",
             "32", "--mem-budget-mb", "8", "--production-mesh"]
# phase 24, the overlay registry and the capped MoE decode: (a) a spec
# registered over the built-in mlp (w_up and w_down only), two users'
# seeded deltas on REG_CHANS d_ff neurons of REG_LAYERS of qwen2-1.5b,
# phase 5's traffic split between the users
REG_LAYERS = (2, 9, 16, 23)
REG_CHANS = 128
REG_SCALE = 0.2  # the deltas' std (the weights' is ~0.015 and ~0.006)
REG_ENGINE = dict(slots=8, max_len=512, chunk=32)
# (c) mixtral-8x7b at its published width, 8 of 32 layers (phase 18's
# rolling serve's depth): a decode batch of 8 slots after a 16-token prefill
CAPPED = dict(layers=8, slots=8, prompt=16, max_len=64)



def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def one_sync_a_chunk(report, what: str) -> None:
    """The JAX engine's contract: one blocking host read a serving chunk."""
    if report["host_syncs"] != report["chunks"]:
        fail(f"{what}: {report['host_syncs']} host syncs for "
             f"{report['chunks']} chunks")


def max_err(got, want, tol: float, what: str, atol=None) -> float:
    """Max abs error of ``got`` against ``want``; fails unless every
    element is finite and within ``atol + tol * |want|`` (atol defaults
    to ``tol``)."""
    import torch

    atol = tol if atol is None else atol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    worst = err.max().item()
    if not (torch.isfinite(got).all().item()
            and (err <= atol + tol * want.abs()).all().item()):
        fail(f"{what}: max abs error {worst} beyond {atol:.3g} + {tol:g} "
             f"|want| (or non-finite)")
    return worst


def rms(t) -> float:
    """Root mean square of ``t``."""
    return t.float().pow(2).mean().sqrt().item()


# the largest err / allowed of kernels 2 and 4's per-slot bf16 gate
GATE_WORST = {"ratio": 0.0, "what": ""}


def bf16_gate(got, want, dname: str, what: str) -> None:
    """Kernels 2 and 4 in bf16: every element within ``3e-2 |want| +
    min(3e-2, 0.1 rms(want))`` over the whole output, and each slot (batch
    row) b within ``3e-2 |want[b]| + min(3e-2, 0.1 rms(want[b]))``: a slot
    with thousands of visible keys has outputs of rms ~0.02, which the
    short slots' rms near 1 would otherwise set the absolute term for
    (float32 keeps its fixed 1e-4)."""
    if dname != "bfloat16":
        return
    tol = TOL[dname]
    max_err(got, want, tol, what, atol=min(tol, BF16_RMS_TOL * rms(want)))
    for b in range(got.shape[0]):
        atol = min(tol, BF16_RMS_TOL * rms(want[b]))
        max_err(got[b], want[b], tol, f"{what}, slot {b}", atol=atol)
        err = (got[b].float() - want[b].float()).abs()
        allowed = atol + tol * want[b].float().abs()
        ratio = (err / allowed.clamp_min(1e-30)).max().item()
        if ratio > GATE_WORST["ratio"]:
            GATE_WORST.update(ratio=ratio, what=f"{what}, slot {b}")


def kernel_launches(ops, zero: bool = False) -> dict:
    """Every launch count of the port's kernel wrappers, by name (set to 0
    first with ``zero``)."""
    counts = {}
    for name, attr in (("flash_attention", "launches"),
                       ("flash_attention_cached", "launches"),
                       ("flash_attention_paged", "launches"),
                       ("fisher", "launches"), ("fisher_tapgrads", "launches"),
                       ("grad_quant", "launches"), ("ssd_scan", "launches"),
                       ("ssd_scan", "bwd_launches")):
        if zero:
            setattr(getattr(ops, name), attr, 0)
        counts[f"{name}.{attr}"] = getattr(getattr(ops, name), attr)
    return counts


def same_adapt(a, b) -> bool:
    """Two adaptations with bit-equal losses and deltas."""
    import torch

    return a.losses == b.losses and all(
        torch.equal(x["conv"]["w"].cpu(), y["conv"]["w"].cpu())
        for x, y in zip(a.deltas.values(), b.deltas.values()))


def adapt_gap(a, b) -> tuple:
    """(max loss difference, max delta difference) of two adaptations of
    one policy structure, wherever their deltas lie."""
    loss = max((abs(x - y) for x, y in zip(a.losses, b.losses)),
               default=0.0)
    delta = max(((x["conv"]["w"].cpu().double() - y["conv"]["w"].cpu()
                  .double()).abs().max().item()
                 for x, y in zip(a.deltas.values(), b.deltas.values())),
                default=0.0)
    return loss, delta


def card_vs_cpu(api, session, task, profile, full, what: str) -> None:
    """An adapt of PARITY_ITERS steps on the card and on the CPU, on
    ``session``'s weights: the same policy, losses within 1e-4 and equal
    query accuracy, or fail.  Then the CPU's run at ``full``'s length,
    whose gap to ``full`` (the card's) is printed, not gated."""
    from repro_torch.utils import tree_map

    cpu = api.TinyTrainSession(session.backbone,
                               tree_map(lambda t: t.cpu(), session.params),
                               max_way=session.max_way)
    card = session.adapt(task, profile, iters=PARITY_ITERS)
    ref = cpu.adapt(task, profile, iters=PARITY_ITERS)
    loss_err, delta_err = adapt_gap(card, ref)
    acc, acc_cpu = card.accuracy(), ref.accuracy()
    same_policy = card.policy.units == ref.policy.units
    long_ref = cpu.adapt(task, profile, iters=len(full.losses))
    long_loss, long_delta = adapt_gap(full, long_ref)
    print(f"[{what}] card vs CPU plain path, {PARITY_ITERS} steps: policy "
          f"{'identical' if same_policy else 'DIFFERENT'}, max loss diff "
          f"{loss_err:.3g} (tol 1e-4), max delta diff {delta_err:.3g}, "
          f"accuracy {acc:.4f} vs {acc_cpu:.4f}; {len(full.losses)} steps "
          f"(not gated): max loss diff {long_loss:.3g}, max delta diff "
          f"{long_delta:.3g}, accuracy {full.accuracy():.4f} vs "
          f"{long_ref.accuracy():.4f}", flush=True)
    if not same_policy:
        fail(f"{what}: policies differ: card {card.policy.describe()}, "
             f"CPU {ref.policy.describe()}")
    if not loss_err <= 1e-4:
        fail(f"{what}: card and CPU losses differ by {loss_err}")
    if acc != acc_cpu:
        fail(f"{what}: card accuracy {acc} against CPU {acc_cpu}")


def launch_plan(lib, entry: str, *args: int) -> dict:
    """The launch a block flash kernel's C entry would make for these
    shapes (``flash_cached_plan``/``flash_paged_plan``), without making it."""
    import ctypes

    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    err = fn(*args, out)
    if err:
        fail(f"{entry} returned cudaError {err}")
    return dict(zip(PLAN_KEYS, out))


def ptxas_report(log: str, *parts: str, what: str = "registers"):
    """What ptxas reports for the one entry function of ``log`` whose
    mangled name holds every one of ``parts``: its ``registers`` or its
    bytes of ``spill`` stores (None when absent)."""
    pattern = (r"Used (\d+) registers" if what == "registers"
               else r"(\d+) bytes spill stores")
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if all(x in name for x in parts):
            m = re.search(pattern, block)
            return int(m.group(1)) if m else None
    return None


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, n_inner: int, trials: int = 5) -> float:
    """Median over ``trials`` of CUDA-event time per call of ``fn``."""
    import torch

    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_inner):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / n_inner)
    return statistics.median(per)


def graph_ms(launch, n: int) -> float:
    """Device time per call of ``launch(stream)`` without the host's
    launch cost: ``n`` calls captured in one CUDA graph, replayed."""
    import torch

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        st = torch.cuda.current_stream().cuda_stream
        for _ in range(n):
            launch(st)
    return time_ms(g.replay, 1) / n


def flash_work(q_offset, kv_len, sq, hq, hkv, d, elt, window):
    """(bytes, operations) the cached attention needs for these cursors:
    q read and out written once, the K/V rows some query can see read
    once, two multiply-adds per (query, visible key, feature)."""
    kv_rows = keys = 0
    for qo, kl in zip(q_offset, kv_len):
        lo = max(0, qo - window + 1) if window else 0
        kv_rows += max(0, min(kl, qo + sq) - lo)
        for i in range(sq):
            qpos = qo + i
            first = max(0, qpos - window + 1) if window else 0
            keys += max(0, min(kl - 1, qpos) - first + 1)
    b = len(q_offset)
    nbytes = (2 * b * sq * hq * d * elt          # q in, out
              + 2 * kv_rows * hkv * d * elt      # k, v rows
              + 2 * b * 4)                       # q_offset, kv_len
    return nbytes, 4 * d * hq * keys


def aligned_work(b, sq, sk, hq, hkv, d, causal, window, elt):
    """(bytes, operations) of one aligned attention call: q, k, v read and
    out written once, two multiply-adds per (query, visible key, feature);
    positions from 0 on both axes."""
    pairs = 0
    for i in range(sq):
        hi = min(sk - 1, i) if causal else sk - 1
        lo = max(0, i - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    return (elt * (2 * b * sq * hq * d + 2 * b * sk * hkv * d),
            4 * d * hq * b * pairs)


def page_table(kv_len, ps, mp, n_pages, gen, device):
    """A (B, mp) int32 table over a randomly permuted arena of ``n_pages``
    pages: sample b maps ceil(kv_len[b] / ps) pages, the rest is -1."""
    import torch

    perm = torch.randperm(n_pages, generator=gen, device=device).tolist()
    table = torch.full((len(kv_len), mp), -1, dtype=torch.int32)
    nxt = 0
    for b, n in enumerate(kv_len):
        used = -(-int(n) // ps)
        table[b, :used] = torch.tensor(perm[nxt:nxt + used])
        nxt += used
    return table.to(device)


def fill_pages(arena, x, table, rows):
    """Copy sample b's logical rows [0, rows[b]) of contiguous ``x`` (B,
    S, Hkv, D) into its pages of ``arena`` (n_pages, ps, Hkv, D), in
    place; every other row of the arena keeps what it held."""
    ps = arena.shape[1]
    tab = table.tolist()
    for b, n in enumerate(rows):
        for j in range(-(-int(n) // ps)):
            m = min(ps, int(n) - j * ps)
            arena[tab[b][j], :m] = x[b, j * ps:j * ps + m]
    return arena


def ssd_work(b, s, h, p, n, elt, backward, zero_init=True):
    """(bytes, operations) of one SSD scan call at these dims, with no
    final state asked for: each input read once and each output written
    once (x, B and C of ``elt`` bytes, dt, a, y and the gradients float32,
    dx/dB/dC back in x's dtype), and the multiply-adds of the tile
    algebra on this data (two operations each, tile by tile of 32 tokens;
    the state terms skipped where the state is known to be zero or no
    output needs it).  The forward kernel tiles by 64; the count keeps
    the tile of 32, so the bound stays comparable with earlier designs."""
    bshp, bsh, bsn = b * s * h * p, b * s * h, b * s * n
    tiles = [min(SSD_TILE, s - t0) for t0 in range(0, s, SSD_TILE)]
    pairs = SSD_TILE * (SSD_TILE + 1) // 2
    if not backward:
        nbytes = bshp * elt + 4 * bsh + 4 * h + 2 * bsn * elt + 4 * bshp
        macs = 0
        for t, rows in enumerate(tiles):
            macs += pairs * n + p * rows * (rows + 1) // 2
            macs += (0 if t == 0 and zero_init else rows * n * p)
            macs += SSD_TILE * p * n if t < len(tiles) - 1 else 0
        return nbytes, 2 * macs * b * h
    nbytes = (4 * bshp + bshp * elt + 4 * bsh + 4 * h + 2 * bsn * elt
              + bshp * elt + 4 * bsh + 2 * bsn * elt)
    macs = 0
    for t, rows in enumerate(tiles):
        state_in = not (t == 0 and zero_init)
        ds = t < len(tiles) - 1
        macs += SSD_TILE * p * n if ds else 0                # recompute
        macs += pairs * (n + p)                              # W and dy.u
        macs += pairs * p + (SSD_TILE * p * n if ds else 0)  # du
        macs += pairs * n + (SSD_TILE * p * n if state_in else 0)  # dC
        macs += pairs * n + (SSD_TILE * p * n if ds else 0)  # dB
        macs += SSD_TILE * p * n if t > 0 else 0             # dS
    return nbytes, 2 * macs * b * h + 2 * bsn * h  # + the head sums


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def peak_reset(dev) -> int:
    """Reset the card's peak memory; the bytes allocated at the reset."""
    import torch

    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_bytes(dev, base: int = 0) -> int:
    """The card's peak memory since the last reset, less ``base``."""
    import torch

    return (torch.cuda.max_memory_allocated() - base if dev.type == "cuda"
            else 0)


def policy_gap(got, want, chans_got, chans_want, tol: float):
    """Whether two policies of one task agree, under the port's rule for a
    difference of precision: the same units and channel counts, and every
    channel one picks and the other does not scored within ``tol`` (of
    the unit's largest score) of that unit's k-th score, in both score
    sets, which agree within ``tol`` themselves.  Returns (equal, within
    the rule, the largest such distance)."""
    import torch

    if got.units == want.units:
        return True, True, 0.0
    sg = [(u.layer, u.kind, u.n_channels) for u in got.units]
    sw = [(u.layer, u.kind, u.n_channels) for u in want.units]
    if sg != sw or got.horizon != want.horizon:
        return False, False, float("inf")
    worst = 0.0
    for ug, uw in zip(got.units, want.units):
        if ug.channels == uw.channels:
            continue
        swapped = sorted(set(ug.channels) ^ set(uw.channels))
        for sc in (chans_got, chans_want):
            s_ = torch.as_tensor(sc[(ug.layer, ug.kind)]).double()
            top = s_.abs().max().item() or 1.0
            kth = s_.sort(descending=True).values[ug.n_channels - 1].item()
            worst = max(worst, max(abs(s_[c].item() - kth)
                                   for c in swapped) / top)
        a = torch.as_tensor(chans_got[(ug.layer, ug.kind)]).double()
        b = torch.as_tensor(chans_want[(ug.layer, ug.kind)]).double()
        worst = max(worst, ((a - b).abs().max() / b.abs().max()).item())
    return False, worst <= tol, worst


def paper_baselines(api, dev, pp, pprofile, methods, iters, parity_iters):
    """Phase 15: each of ``methods`` (a ``baseline`` name or a criterion)
    once on ``dev`` at ``iters`` steps (accuracy, train_seconds, peak
    memory printed), then at ``parity_iters`` steps on ``dev`` and on the
    CPU from the same weights: the same policy (the ES policy too) and
    losses within 1e-4 (a dense baseline's first ``DENSE_PARITY_LOSSES``,
    and all of them again under SGD at the same lr; its first gradient
    through :func:`gradient_gate`, and TinyTL's ops through
    :func:`tinytl_op_gate`); the session's frozen
    params unchanged bit for bit.  The CPU at one
    thread against the CPU at all its threads, step by step, is printed
    beside it: the same code in another reduction order, the noise floor.
    The accuracies are printed, not gated: fulltrain's first Adam steps
    move every weight of the backbone by about lr in the sign of its
    gradient, so a query near a tie may flip (one of 96 on mcunet over 4
    steps).  Returns {method: the ``dev`` run}."""
    import numpy as np
    import torch

    from repro_torch.optim import sgd
    from repro_torch.utils import tree_leaves, tree_map

    bb = api.backbone(pp["arch"], in_res=pp["in_res"],
                      batch_size=pp["batch_size"])
    session = api.TinyTrainSession(bb, max_way=pp["max_way"], seed=0,
                                   device=dev)
    frozen = [t.clone() for t in tree_leaves(session.params)]
    cpu = api.TinyTrainSession(bb, tree_map(lambda t: t.cpu(),
                                            session.params),
                               max_way=pp["max_way"])

    def task_of(seed, domain):
        return api.sample_task(
            np.random.default_rng(seed), domain, res=pp["in_res"],
            max_way=pp["max_way"], support_pad=pp["support_pad"],
            query_pad=pp["query_pad"],
            max_support_total=pp["support_total"],
            max_support_per_class=pp["per_class"])

    task, proxy = task_of(0, pp["domain"]), task_of(1, PROXY_DOMAIN)
    if "tinytl" in methods:
        tinytl_op_gate(bb, dev, pp["support_pad"])
    out = {}
    for name in methods:
        base = peak_reset(dev)
        t0 = time.perf_counter()
        a = session.baseline(name, task, pprofile, iters=iters,
                             proxy_task=proxy)
        sync(dev)
        wall = time.perf_counter() - t0
        peak = peak_bytes(dev, base)
        card = session.baseline(name, task, pprofile, iters=parity_iters,
                                proxy_task=proxy)
        ref = cpu.baseline(name, task, pprofile, iters=parity_iters,
                           proxy_task=proxy)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        ref1 = cpu.baseline(name, task, pprofile, iters=parity_iters,
                            proxy_task=proxy)
        torch.set_num_threads(threads)
        steps = [abs(x - y) for x, y in zip(card.losses, ref.losses)]
        floor = [abs(x - y) for x, y in zip(ref1.losses, ref.losses)]
        n_gate = (DENSE_PARITY_LOSSES if name in DENSE_BASELINES
                  else parity_iters)
        gap = max(steps[:n_gate], default=0.0)
        same = ((card.policy is None and ref.policy is None)
                or card.policy.units == ref.policy.units)
        acc, acc_ref = card.accuracy(), ref.accuracy()
        pol = a.policy.describe() if a.policy is not None else "none"
        print(f"[baselines] {pp['arch']} {name}: accuracy {a.accuracy():.4f}"
              f", fisher_seconds {a.fisher_seconds:.4f}, train_seconds "
              f"{a.train_seconds:.4f} ({len(a.losses)} steps), wall "
              f"{wall:.4f} s, peak {peak} B over the allocation before, host "
              f"transfers "
              f"{a.host_transfers:g}, policy {pol}; {parity_iters} steps "
              f"against the CPU: policy "
              f"{'identical' if same else 'DIFFERENT'}, loss diff by step "
              f"{[float(f'{x:.3g}') for x in steps]} (tol 1e-4 over the "
              f"first {n_gate}), the CPU at 1 thread against {threads} "
              f"{[float(f'{x:.3g}') for x in floor]}, accuracy {acc:.4f} vs "
              f"{acc_ref:.4f}", flush=True)
        if not all(math.isfinite(x) for x in a.losses):
            fail(f"{name}: losses must be finite: {a.losses}")
        if name != "none" and len(a.losses) != iters:
            fail(f"{name}: {len(a.losses)} losses for {iters} steps")
        if a.policy is not None and a.policy.n_units < 1:
            fail(f"{name}: the policy selects no unit")
        if not same:
            fail(f"{name}: policies differ: {card.policy.describe()} "
                 f"against the CPU's {ref.policy.describe()}")
        if not gap <= 1e-4:
            fail(f"{name}: losses differ from the CPU's by {gap} over the "
                 f"first {n_gate}")
        if name in DENSE_BASELINES:
            gradient_gate(bb, cpu.params, task, name, pp["max_way"], dev)
            # the same training loop with a linear update, card and CPU
            sgd_runs = []
            for params in (session.params, cpu.params):
                s_ = api.TinyTrainSession(bb, params, max_way=pp["max_way"])
                s_.baseline_optimizer = sgd(BASELINE_LR)
                sgd_runs.append(s_.baseline(name, task, pprofile,
                                            iters=parity_iters).losses)
            sgd_gap = max(abs(x - y) for x, y in zip(*sgd_runs))
            print(f"[baselines] {pp['arch']} {name} under SGD (lr "
                  f"{BASELINE_LR:g}), {parity_iters} steps against the CPU: "
                  f"max loss diff {sgd_gap:.3g} (tol 1e-4)", flush=True)
            if not sgd_gap <= 1e-4:
                fail(f"{name} under SGD: losses differ from the CPU's by "
                     f"{sgd_gap}")
        out[name] = a
    unchanged = all(torch.equal(x, y) for x, y in
                    zip(tree_leaves(session.params), frozen))
    print(f"[baselines] the session's frozen params after every method: "
          f"{'bit-equal' if unchanged else 'CHANGED'}", flush=True)
    if not unchanged:
        fail("a baseline changed the session's frozen params")
    return out


def first_gradient(bb, params, task, name, max_way, dev, dtype) -> list:
    """The gradient of dense baseline ``name``'s first loss (fulltrain:
    every backbone leaf; tinytl/adapterdrop: the adapters, drawn as the
    session draws them) from ``params``, on ``dev`` in ``dtype``: its
    leaves in float64 on the CPU."""
    import torch

    from repro_torch.core import baselines as B
    from repro_torch.core.protonet import episode_loss
    from repro_torch.utils import tree_leaves, tree_map

    def on(tree):
        ts = {k: torch.as_tensor(v, device=dev) for k, v in tree.items()}
        return {k: t.to(dtype) if t.is_floating_point() else t
                for k, t in ts.items()}

    p = tree_map(lambda t: t.detach().to(dev, dtype), params)
    if name == "fulltrain":
        x, feats = p, bb.features
    else:
        drop = B.adapter_dropped_blocks(bb.cfg, name)
        x = tree_map(lambda t: t.to(dev, dtype), B.tinytl_adapter_init(
            bb.cfg, torch.Generator().manual_seed(0)))

        def feats(a, b):
            return B.tinytl_features(bb.cfg, p, a, b["images"],
                                     dropped_blocks=drop)
    leaves = [t.requires_grad_() for t in tree_leaves(x)]
    loss = episode_loss(feats, x, on(task.support), on(task.pseudo_query),
                        max_way)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [(torch.zeros_like(t) if g is None else g).cpu().double()
            for t, g in zip(leaves, grads)]


def gradient_gate(bb, params, task, name, max_way, dev) -> None:
    """Dense baseline ``name``'s first gradient on ``dev`` against the
    CPU's: in float64 within GRAD_F64_TOL of each leaf's largest value,
    and in float32 no farther from the float64 gradient than
    GRAD_F32_FACTOR times the CPU's float32 one, or fail."""
    import torch

    cpu = torch.device("cpu")
    exact = first_gradient(bb, params, task, name, max_way, cpu,
                           torch.float64)

    def dist(dev_, dtype):
        got = first_gradient(bb, params, task, name, max_way, dev_, dtype)
        return max((a - b).abs().max().item() / (b.abs().max().item() or 1.0)
                   for a, b in zip(got, exact))

    e64, e_card, e_cpu = (dist(dev, torch.float64), dist(dev, torch.float32),
                          dist(cpu, torch.float32))
    print(f"[baselines] {name} first gradient ({len(exact)} leaves, "
          f"{sum(t.numel() for t in exact)} elements), the largest distance "
          f"from the CPU's float64 one, of its leaf's largest value: card "
          f"float64 {e64:.3g} (tol {GRAD_F64_TOL:g}); float32 card "
          f"{e_card:.3g}, CPU {e_cpu:.3g} (the card's at most "
          f"{GRAD_F32_FACTOR:g}x the CPU's)", flush=True)
    if not e64 <= GRAD_F64_TOL:
        fail(f"{name}: the card's float64 first gradient is {e64} off")
    if not e_card <= GRAD_F32_FACTOR * e_cpu:
        fail(f"{name}: the card's float32 first gradient is {e_card} off "
             f"the float64 one, the CPU's {e_cpu}")


def tinytl_op_gate(bb, dev, rows: int) -> None:
    """TinyTL's own ops alone at each block's shapes on ``dev`` in float32
    against the CPU in float64: the "SAME" 2x2 pool, the 3x3 and pointwise
    adapter convs and the nearest-exact resize, each op's value and the
    gradients of all its inputs under a random cotangent within
    TINYTL_OP_TOL of their largest value, or fail."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.baselines import _pool_same, tinytl_blocks

    cfg = bb.cfg
    size, start, end = cfg.in_res, {}, {}
    for spec in cfg.layers:
        start.setdefault(spec.block, size)
        size = -(-size // spec.stride)
        end[spec.block] = size
    gen = torch.Generator().manual_seed(15)
    worst, cases = 0.0, set()
    for b, cin, r, cout in tinytl_blocks(cfg):
        s0, s1 = start[b], end[b]
        sp = -(-s0 // 2)
        for op, shapes, fn in (
                ("pool", [(rows, cin, s0, s0)], _pool_same),
                ("conv3x3", [(rows, cin, sp, sp), (r, cin, 3, 3)],
                 lambda h, w: F.conv2d(h, w, padding=1)),
                ("conv1x1", [(rows, r, sp, sp), (cout, r, 1, 1)], F.conv2d),
                ("resize", [(rows, cout, sp, sp)],
                 lambda h: F.interpolate(h, size=(s1, s1),
                                         mode="nearest-exact"))):
            key = (op, *shapes)
            if key in cases:
                continue
            cases.add(key)
            xs = [torch.randn(sh, generator=gen, dtype=torch.float64)
                  for sh in shapes]
            runs = []
            for d, dt in ((dev, torch.float32), ("cpu", torch.float64)):
                ins = [x.to(d, dt).requires_grad_() for x in xs]
                y = fn(*ins)
                cot = torch.randn(y.shape, generator=torch.Generator()
                                  .manual_seed(len(cases)),
                                  dtype=torch.float64).to(d, dt)
                grads = torch.autograd.grad(y, ins, cot)
                runs.append([t.detach().cpu().double() for t in (y, *grads)])
            for got, want in zip(*runs):
                err = ((got - want).abs().max().item()
                       / (want.abs().max().item() or 1.0))
                worst = max(worst, err)
                if not err <= TINYTL_OP_TOL:
                    fail(f"TinyTL's {op} at {shapes}: {err} of the largest "
                         f"value off float64")
    print(f"[baselines] TinyTL's ops alone ({len(cases)} cases: pool, 3x3 and "
          f"pointwise adapter convs, nearest-exact resize at every block's "
          f"shapes, {rows} rows), card float32 against CPU float64, values "
          f"and input gradients: the largest error {worst:.3g} of the "
          f"largest value (tol {TINYTL_OP_TOL:g})", flush=True)


def fleet_probe(api, ops, session, tasks, profile, iters, tol, what):
    """Phase 16: ``adapt_many`` of ``tasks`` with no policy override (the
    criterion route: a batched probe a shape group) on ``session``; returns
    (fleet, wall, launches of the task-axis reduction, the captured (tap
    gradients, ns, mask, scores) of each reduction).  Each task's policy is
    held to its own ``adapt``'s under ``policy_gap``'s rule at ``tol``."""
    import torch

    bb = session.backbone
    captured = []
    real = bb.fisher_reduce_batch

    def capture(tg, ns, mask=None):
        out = real(tg, ns, mask)
        captured.append((tg, ns, mask, out))
        return out

    bb.fisher_reduce_batch = capture
    try:
        for name in ("fisher_tapgrads", "fisher"):
            getattr(ops, name).launches = 0
        peak_reset(session.device)
        t0 = time.perf_counter()
        fleet = session.adapt_many(tasks, profile, iters=iters)
        sync(session.device)
        wall = time.perf_counter() - t0
        counts = ops.fisher_tapgrads.launches + ops.fisher.launches
        peak = peak_bytes(session.device)
    finally:
        bb.fisher_reduce_batch = real
    rep = session.last_fleet_report
    print(f"[fleet] {what}: adapt_many of {len(tasks)} tasks, no override: "
          f"{rep['buckets']} buckets, {rep['groups']} fine-tune groups, "
          f"wall {wall:.4f} s, probe (fisher_seconds a task) "
          f"{', '.join(f'{a.fisher_seconds:.4f}' for a in fleet)}, "
          f"train_seconds a task {fleet[0].train_seconds:.4f} ({iters} "
          f"steps), peak {peak} B, Fisher launches {counts}, host transfers "
          f"{sum(a.host_transfers for a in fleet):g}", flush=True)
    groups = _fleet_groups(session, tasks)
    for i, (t, f) in enumerate(zip(tasks, fleet)):
        labels = torch.as_tensor(t.support["episode_labels"],
                                 device=session.device)
        taps = bb.make_taps(labels.shape[0], session.device)
        sup = {k: torch.as_tensor(v, device=session.device)
               for k, v in t.support.items()}
        pq = {k: torch.as_tensor(v, device=session.device)
              for k, v in t.pseudo_query.items()}
        own_chans = session.step_cache.probe_fisher()(
            session.params, sup, pq, taps, float(t.n_support))
        one = session.adapt(t, profile, iters=1)
        j = next(j for j, idxs in enumerate(groups) if i in idxs)
        k = groups[j].index(i)
        fleet_chans = {key: v[k] for key, v in captured[j][3].items()}
        equal, ok, worst = policy_gap(f.policy, one.policy, fleet_chans,
                                      own_chans, tol)
        print(f"[fleet] {what} task {i} ({t.n_support} support rows of "
              f"{labels.shape[0]}): {f.policy.describe()}; its own adapt's "
              f"policy {'identical' if equal else 'differs'}"
              + ("" if equal else f" (largest swapped-channel distance "
                 f"{worst:.3g} of the unit's top score, rule {tol:g}: "
                 f"{'a difference of precision' if ok else 'A FAULT'})"),
              flush=True)
        if not ok:
            fail(f"{what} task {i}: adapt_many's policy "
                 f"{f.policy.describe()} against its own adapt's "
                 f"{one.policy.describe()}")
        if not all(math.isfinite(x) for x in f.losses):
            fail(f"{what} task {i}: losses must be finite: {f.losses}")
    return fleet, wall, counts, captured


def _fleet_groups(session, tasks):
    """The probe's shape groups of ``tasks`` (input indices), in the order
    ``adapt_many`` probes them."""
    from repro_torch.core.session import (
        _bucket_episode, _episode_shape_key, _group_indices,
    )

    keys = [_episode_shape_key(*_bucket_episode(t)) for t in tasks]
    return list(_group_indices(keys).values())


def smoke_card_vs_cpu(api, configs, T, ServeEngine, Request, DeltaSet,
                      SelectedUnit, SparseUpdatePolicy, fold_deltas, tree_map,
                      dev, archs=tuple(MOE_LAYERS), tag="moe",
                      pressured=False, settings=None) -> None:
    """Phases 18 (a), 19 (a) and 20 (a): the smoke configs of ``archs`` in
    f32 (TF32 off), the card against the plain path on the CPU from the
    same weights: greedy streams on contiguous, paged and int8 caches (and
    half the pages, ``pressured``) and mixtral's rolling window,
    TinyTrain's policy, losses and folded streams, and two users' deltas
    (one unit of every kind) served per slot.  ``settings`` (default
    MOE_SMOKE) sizes the engines; on an encoder-decoder or vlm config
    every request carries its own encoder inputs, the adapt's task is a
    conditioned one, and the pressured serve must preempt."""
    import numpy as np
    import torch

    M = MOE_SMOKE if settings is None else settings
    base = dict(slots=M["slots"], max_len=M["max_len"], chunk=M["chunk"])
    paged = dict(base, kv_paging=True, kv_page_size=M["page"])
    stripe = M["slots"] * -(-M["max_len"] // M["page"])

    def serve(small, params, where, kw, prompts, uid=lambda i: i, pol=None,
              deltas=None, feats=None):
        eng = ServeEngine(small, params, device=where, personalise=pol, **kw)
        for u, d in (deltas or {}).items():
            eng.swap_deltas(u, DeltaSet.from_policy(pol, tree_map(
                lambda t: t.to(params["embed"].device), d)))
        reqs = [Request(uid=uid(i), prompt=p, max_new=M["max_new"],
                        enc_feats=None if feats is None else feats[i])
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        return [(r.out, r.outcome) for r in reqs], eng

    for arch in archs:
        small = configs.get_reduced(arch)
        p_cpu = T.init_params(small, torch.Generator().manual_seed(0),
                              device="cpu")
        p_gpu = tree_map(lambda t: t.to(dev), p_cpu)  # the same weights
        both = (("cpu", p_cpu), ("cuda", p_gpu))
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, small.vocab, n).astype(np.int32)
                   for n in M["lens"]]
        shape = small.enc_feats_shape
        feats = (None if shape is None else
                 [rng.standard_normal(shape).astype(np.float32)
                  for _ in prompts])
        cases = {"contiguous": (base, prompts), "paged": (paged, prompts),
                 "int8 pages": (dict(paged, kv_int8=True), prompts)}
        if pressured:
            cases[f"pressured ({stripe // 2} of {stripe} pages)"] = (
                dict(paged, page_budget=stripe // 2), prompts)
        if small.sliding_window:
            cases["rolling (window 32, max_len 80)"] = (M["rolling"], [
                rng.integers(0, small.vocab, n).astype(np.int32)
                for n in M["rolling_lens"]])
        for what, (kw, ps) in cases.items():
            runs = {w: serve(small, p, w, kw, ps,
                             feats=feats if ps is prompts else None)
                    for w, p in both}
            got = {w: r[0] for w, r in runs.items()}
            same = got["cpu"] == got["cuda"]
            done = all(o == "done" for _, o in got["cuda"])
            requeued = runs["cuda"][1].last_run_report["outcomes"].get(
                "requeued", 0)
            print(f"[{tag}] {small.name} f32 {what} greedy streams, card vs "
                  f"CPU plain path: {'identical' if same else 'DIFFERENT'} "
                  f"over {len(ps)} requests, "
                  f"{'all done' if done else 'NOT ALL DONE'}"
                  + (f", {requeued} requeued" if "pressured" in what else ""),
                  flush=True)
            if not same or not done:
                fail(f"{small.name} {what} streams: cpu {got['cpu']} cuda "
                     f"{got['cuda']}")
            if "pressured" in what and shape is not None and not requeued:
                fail(f"{small.name} {what}: no request was preempted")
        # TinyTrain: the card's probe (the Fisher kernel at the MoE's
        # expert taps) and fine-tune against the CPU's, then folded streams
        sbb = api.backbone(arch, preset="smoke", batch_size=32, seq=16)
        task_rng = np.random.default_rng(0)
        stask = (api.sample_lm_task(task_rng, small.vocab, seq=16, max_way=5,
                                    support_pad=32, query_pad=32)
                 if shape is None else
                 api.sample_encdec_task(task_rng, small, seq=16, max_way=5,
                                        support_pad=32, query_pad=32))
        adapted = {}
        for where, params in both:
            ad = api.TinyTrainSession(sbb, params, max_way=5).adapt(
                stask, api.JETSON_NANO, iters=4)
            eng = ServeEngine(small, params, device=where, **base)
            ad.fold_into(eng)
            reqs = [Request(uid=i, prompt=p, max_new=M["max_new"],
                            enc_feats=None if feats is None else feats[i])
                    for i, p in enumerate(prompts)]
            eng.run(reqs)
            adapted[where] = (ad, [(r.out, r.outcome) for r in reqs])
        (a_cpu, s_cpu), (a_gpu, s_gpu) = adapted["cpu"], adapted["cuda"]
        loss_err = max(abs(x - y) for x, y in zip(a_cpu.losses,
                                                  a_gpu.losses))
        same_pol = a_cpu.policy.units == a_gpu.policy.units
        print(f"[{tag}] {small.name} f32 TinyTrain, card vs CPU plain path: "
              f"policy {'identical' if same_pol else 'DIFFERENT'} "
              f"({a_gpu.policy.describe()}), max loss diff {loss_err:.3g} "
              f"(tol 1e-4), folded-engine streams "
              f"{'identical' if s_cpu == s_gpu else 'DIFFERENT'}", flush=True)
        if not same_pol or not loss_err <= 1e-4 or s_cpu != s_gpu:
            fail(f"{small.name} adapt differs: {a_cpu.policy.describe()} "
                 f"{a_cpu.losses} vs {a_gpu.policy.describe()} "
                 f"{a_gpu.losses}; streams {s_cpu} vs {s_gpu}")
        # personalised: one unit of every kind (MLA heads, the dense head's
        # MLP, a MoE unit's experts per slot), two users' random deltas
        units, seen = [], set()
        for c in reversed(sbb.unit_costs):
            if c.kind not in seen:
                seen.add(c.kind)
                units.append(SelectedUnit(c.layer, c.kind,
                                          tuple(sorted({0, c.n_channels - 1}))))
        pol = SparseUpdatePolicy(horizon=0, units=tuple(
            sorted(units, key=lambda u: (u.layer, u.kind))))
        dgen = torch.Generator().manual_seed(7)
        udeltas = {u: tree_map(lambda z: 0.05 * torch.randn(
            z.shape, generator=dgen), sbb.init_deltas(pol, "cpu"))
            for u in (0, 1)}
        got = {w: serve(small, p, w, base, prompts, lambda i: i % 2, pol,
                        udeltas, feats)[0] for w, p in both}
        folded = {u: serve(small, fold_deltas(small, p_gpu, tree_map(
            lambda t: t.to(dev), d), pol), "cuda", base, prompts,
            lambda i: i % 2, feats=feats)[0] for u, d in udeltas.items()}
        oracle = [folded[i % 2][i] for i in range(len(prompts))]
        print(f"[{tag}] {small.name} f32 personalised (2 users, "
              f"{pol.describe()}): card vs CPU "
              f"{'identical' if got['cpu'] == got['cuda'] else 'DIFFERENT'}"
              f", card overlay vs card folded engines "
              f"{'identical' if oracle == got['cuda'] else 'DIFFERENT'}",
              flush=True)
        if got["cpu"] != got["cuda"] or oracle != got["cuda"]:
            fail(f"{small.name} personalised streams differ: cpu "
                 f"{got['cpu']} cuda {got['cuda']} folded {oracle}")


def moe_kernels(ops, flash_attention, flash_paged, fisher_kernel,
                cached_ref, tapgrads_ref, row_mask, n_valid, dev,
                gen) -> dict:
    """Phase 18 (b): kernels 2 and 4 at mixtral's block prefill (a GQA
    group of 4) and kernel 1 at both models' tap groups (see
    :func:`block_kernels` and :func:`tap_kernels`).  Returns the largest
    errors, keyed by kernel."""
    worst = block_kernels(ops, flash_attention, flash_paged, cached_ref,
                          MOE_BLOCK, "mixtral's", "moe", dev, gen)
    worst["fisher"] = tap_kernels(ops, fisher_kernel, tapgrads_ref,
                                  row_mask, n_valid, MOE_TAPS, "moe", dev,
                                  gen)
    return worst


def block_kernels(ops, flash_attention, flash_paged, cached_ref, blk,
                  model: str, tag: str, dev, gen) -> dict:
    """Kernels 2 and 4 at a model's block prefill ``blk`` (its
    ``q_offset`` / ``kv_len`` / ``pages`` where it has them, else phase 3's
    cursors over 256 pages), f32 at 1e-4 and bf16 under the per-slot gate, the paged
    kernel equal to the cached one on the same rows, each kernel's second
    run bit-equal to its first, and exactly 0 for a slot that sees no key;
    then each timed in bf16 over ``blk["layers"]`` buffer sets cycled,
    beside its bound, its plain version and SDPA or a page gather + SDPA.
    Returns the largest errors, keyed by kernel."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref as kref

    B, Sq, Hq, Hkv, D, Sk, nl = (blk[k] for k in (
        "B", "Sq", "Hq", "Hkv", "D", "Sk", "layers"))
    q_off = blk.get("q_offset", Q_OFFSET)
    kv_len = blk.get("kv_len", KV_LEN)
    n_pages = blk.get("pages", DEFAULT_PAGES)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    mp = Sk // PAGE_SIZE
    table = page_table(kv_len, PAGE_SIZE, mp, n_pages, gen, dev)
    worst = {"flash_cached": 0.0, "flash_paged": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
        kp = fill_pages(torch.zeros((n_pages, PAGE_SIZE, Hkv, D),
                                    dtype=dtype, device=dev), k, table, kv_len)
        vp = fill_pages(torch.zeros_like(kp), v, table, kv_len)
        got, again = (ops.flash_attention_cached(q, k, v, q_offset=qo,
                                                 kv_len=kl, causal=True)
                      for _ in range(2))
        pgot, pagain = (ops.flash_attention_paged(q, kp, vp, table,
                                                  q_offset=qo, kv_len=kl)
                        for _ in range(2))
        want = cached_ref(q, k, v, q_offset=qo, kv_len=kl, causal=True)
        pwant = kref.flash_attention_paged_ref(q, kp, vp, table,
                                               q_offset=qo, kv_len=kl)
        torch.cuda.synchronize()
        tol = TOL[dname]
        err = max_err(got, want, tol, f"flash_cached {dname} {model} block")
        perr = max_err(pgot, pwant, tol, f"flash_paged {dname} {model} block")
        bf16_gate(got, want, dname, f"flash_cached {model} block")
        bf16_gate(pgot, pwant, dname, f"flash_paged {model} block")
        same = torch.equal(pgot, got)
        rerun = torch.equal(got, again) and torch.equal(pgot, pagain)
        blind = [i for i, (o, n) in enumerate(zip(q_off, kv_len))
                 if min(n, o + Sq) <= 0]
        zero = all(not got[i].any() and not pgot[i].any() for i in blind)
        print(f"[{tag}-kernel] flash_cached / flash_paged {dname} at {model} "
              f"block prefill (B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} "
              f"Sk={Sk}, kv_len {kv_len}): max abs err {err:.3g} / {perr:.3g} (tol {tol:g}"
              f"{', per-slot bf16 gate' if dname == 'bfloat16' else ''}); "
              f"paged {'equal to' if same else 'DIFFERS FROM'} cached on the "
              f"same rows; a second run {'bit-equal' if rerun else 'DIFFERS'}"
              f"; slots {blind} (no key) {'exactly 0' if zero else 'NOT 0'}",
              flush=True)
        if not same:
            fail(f"flash_paged differs from flash_cached at {model} block "
                 f"prefill ({dname})")
        if not rerun:
            fail(f"kernels 2 and 4 at {model} block prefill ({dname}): two "
                 "runs on the same inputs differ")
        if not zero:
            fail(f"kernels 2 and 4 at {model} block prefill ({dname}): a "
                 "slot that sees no key does not give exactly 0")
        worst["flash_cached"] = max(worst["flash_cached"], err)
        worst["flash_paged"] = max(worst["flash_paged"], perr)

    # bf16 times, one buffer set a layer cycled (mixtral: 16 x 8 MiB of K
    # and V)
    bf = torch.bfloat16
    q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(bf)
    ks = torch.randn((nl, B, Sk, Hkv, D), generator=gen, device=dev).to(bf)
    vs = torch.randn((nl, B, Sk, Hkv, D), generator=gen, device=dev).to(bf)
    kps = torch.zeros((nl, n_pages, PAGE_SIZE, Hkv, D), dtype=bf,
                      device=dev)
    vps = torch.zeros_like(kps)
    for i in range(nl):
        fill_pages(kps[i], ks[i], table, kv_len)
        fill_pages(vps[i], vs[i], table, kv_len)
    out = torch.empty_like(q)
    c_entry, p_entry = flash_attention._entry(), flash_paged._entry()
    stream = torch.cuda.current_stream().cuda_stream
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % nl
        return it["i"]

    def run_cached():
        i = nxt()
        rc = c_entry(q.data_ptr(), ks[i].data_ptr(), vs[i].data_ptr(),
                     out.data_ptr(), qo.data_ptr(), kl.data_ptr(), B, Sq,
                     Sk, Hq, Hkv, D, 1, 0, 1, stream)
        if rc:
            fail(f"flash_cached_fwd returned cudaError {rc}")

    def run_paged():
        i = nxt()
        rc = p_entry(q.data_ptr(), kps[i].data_ptr(), vps[i].data_ptr(),
                     out.data_ptr(), table.data_ptr(), qo.data_ptr(),
                     kl.data_ptr(), B, Sq, Hq, Hkv, D, n_pages,
                     PAGE_SIZE, mp, 1, stream)
        if rc:
            fail(f"flash_paged_fwd returned cudaError {rc}")

    pos = torch.arange(Sk, device=dev)
    qpos = qo[:, None].long() + torch.arange(Sq, device=dev)[None, :]
    mask = ((pos[None, None, :] < kl[:, None, None])
            & (pos[None, None, :] <= qpos[..., None]))[:, None]
    qt = q.transpose(1, 2)
    rows_ok = (table >= 0).repeat_interleave(PAGE_SIZE, dim=1)
    idx = table.long().clamp(min=0)

    def run_sdpa():
        i = nxt()
        F.scaled_dot_product_attention(qt, ks[i].transpose(1, 2),
                                       vs[i].transpose(1, 2),
                                       attn_mask=mask, enable_gqa=True)

    def run_gather_sdpa():
        i = nxt()
        kk = kps[i][idx].reshape(B, Sk, Hkv, D).transpose(1, 2)
        vv = vps[i][idx].reshape(B, Sk, Hkv, D).transpose(1, 2)
        F.scaled_dot_product_attention(
            qt, kk, vv, attn_mask=mask & rows_ok[:, None, None],
            enable_gqa=True)

    def run_cached_plain():
        i = nxt()
        cached_ref(q, ks[i], vs[i], q_offset=qo, kv_len=kl, causal=True)

    def run_paged_plain():
        i = nxt()
        kref.flash_attention_paged_ref(q, kps[i], vps[i], table,
                                       q_offset=qo, kv_len=kl)

    nbytes, nops = flash_work(q_off, kv_len, Sq, Hq, Hkv, D, 2, 0)
    for what, run, lib, plain, extra in (
            ("flash_cached", run_cached, run_sdpa, run_cached_plain, 0),
            ("flash_paged", run_paged, run_gather_sdpa, run_paged_plain,
             4 * table.numel())):
        k_ms = time_ms(run, 4 * nl)
        l_ms = time_ms(lib, 4 * nl)
        p_ms = time_ms(plain, nl)
        t_bytes = (nbytes + extra) / HBM_BYTES_PER_S
        t_ops = nops / PEAK_OPS["bfloat16"]
        print(f"[{tag}-time] {what} bf16 {model} block prefill B={B} Sq={Sq} "
              f"Hq={Hq} Hkv={Hkv} D={D} max_len={Sk}: kernel {k_ms:.4f} ms, "
              f"bound {1e3 * max(t_bytes, t_ops):.5f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}), plain "
              f"{p_ms:.4f} ms, "
              f"{'sdpa' if what == 'flash_cached' else 'page gather + sdpa'}"
              f" {l_ms:.4f} ms", flush=True)
    del ks, vs, kps, vps
    torch.cuda.empty_cache()
    return worst


NO_LOG = "none: the library was loaded from build/, not compiled in this run"


def block_geometry(build, flash_attention, blk, model: str) -> dict:
    """The launch kernels 2 and 4 make in bf16 at block prefill ``blk``
    (pages of 16 over ``blk["pages"]`` or 256 pages), read through
    ``flash_cached_plan``/``flash_paged_plan`` and held to the host-side
    model ``flash_attention.block_plan_model``, printed with ptxas's
    registers and spill stores of the tensor-core instantiation it runs
    (fails if this build has none; says so where the library was loaded
    from ``build/`` and no ptxas log exists).  Returns the plans, keyed by
    kernel."""
    import torch

    B, Sq, Hq, Hkv, D, Sk = (blk[k] for k in ("B", "Sq", "Hq", "Hkv", "D",
                                              "Sk"))
    n_pages, mp = blk.get("pages", DEFAULT_PAGES), Sk // PAGE_SIZE
    plans = {}
    for what, entry, args, rows, src in (
            ("flash_cached", "flash_cached_plan", (B, Sq, Sk, Hq, Hkv, D, 1),
             ("contig", Sk), "ContigRows"),
            ("flash_paged", "flash_paged_plan",
             (B, Sq, Hq, Hkv, D, n_pages, PAGE_SIZE, mp, 1),
             ("paged", PAGE_SIZE, mp), "PagedRows")):
        plan = launch_plan(build.load(what), entry, *args)
        want = flash_attention.block_plan_model(B, Sq, Hq, Hkv, D,
                                                torch.bfloat16, rows)
        log = build.BUILD_LOG.get(what, (0, ""))[1]
        parts = ("flash_block_kernel", "13__nv_bfloat16", f"Li{D}E", "Lb1E",
                 src)
        regs = ptxas_report(log, *parts)
        spill = ptxas_report(log, *parts, what="spill")
        print(f"[geometry] {what} bf16 {model} B={B} Sq={Sq} Hq={Hq} "
              f"Hkv={Hkv} D={D} "
              f"{'Sk=' + str(Sk) if src == 'ContigRows' else f'pages of {PAGE_SIZE}'}: "
              f"{plan['CTAs']} CTAs in clusters of {plan['cluster']}, "
              f"{plan['threads']} threads, {plan['smem_bytes']} B of dynamic "
              f"shared memory, {plan['stages']} stages, {plan['registers']} "
              f"registers a thread; tensor cores, Q from {want['q_tile']} "
              f"(ptxas log: "
              f"{NO_LOG if not log else f'{regs} registers, {spill} bytes of spill stores'})",
              flush=True)
        diff = {k: (plan[k], want[k]) for k in PLAN_KEYS
                if k != "registers" and plan[k] != want[k]}
        if diff:
            fail(f"{what} at {model} block prefill: launch (card, model) "
                 f"differ: {diff}")
        if log and regs is None:
            fail(f"{what}: this build has no tensor-core bf16 instantiation "
                 f"at D {D}")
        plans[what] = plan
    return plans


def tap_kernels(ops, fisher_kernel, tapgrads_ref, row_mask, n_valid, taps,
                tag: str, dev, gen) -> float:
    """Kernel 1 at the probe's tap groups ``taps`` ({model: ((layers,
    channels), ...)}), f32 at 1e-5 with the adapt task's padding rows
    holding NaN, each timed beside its bound, its plain version and
    ``torch.einsum``.  Returns the largest error."""
    import torch

    worst = 0.0
    it = {"i": 0}
    stream = torch.cuda.current_stream().cuda_stream
    f_entry = fisher_kernel._tap_entry()
    n_rows = row_mask.shape[0]
    n_one = torch.full((1,), float(n_valid), device=dev)
    scale = 1.0 / (2.0 * n_valid)
    for arch, shapes in taps.items():
        for nlay, c in shapes:
            shape = (nlay, n_rows, c)
            g = torch.randn(shape, generator=gen, device=dev)
            gm = g.clone()
            gm[:, row_mask == 0] = float("nan")
            got = ops.fisher_tapgrads(gm, float(n_valid), row_mask)
            want = tapgrads_ref(gm, float(n_valid), row_mask)
            torch.cuda.synchronize()
            err = max_err(got, want, FISHER_TOL["float32"],
                          f"fisher_tapgrads f32 {arch} {shape}")
            worst = max(worst, err)
            gs = [torch.randn(shape, generator=gen, device=dev)
                  for _ in range(8)]
            fout = torch.empty((nlay, c), device=dev)
            it["i"] = 0

            def next_g(gs=gs):
                it["i"] = (it["i"] + 1) % len(gs)
                return gs[it["i"]]

            def run_fisher(shape=shape, fout=fout, next_g=next_g):
                rc = f_entry(next_g().data_ptr(), row_mask.data_ptr(),
                             n_one.data_ptr(), fout.data_ptr(), 1, shape[0],
                             shape[1], shape[2], 0, stream, None)
                if rc:
                    fail(f"fisher_tapgrads_fwd returned cudaError {rc}")

            def run_plain(next_g=next_g):
                tapgrads_ref(next_g(), float(n_valid), row_mask)

            def run_einsum(next_g=next_g):
                x = next_g()
                torch.einsum("lbc,lbc,b->lc", x, x, row_mask).mul_(scale)

            f_ms = time_ms(run_fisher, 50)
            p_ms = time_ms(run_plain, 10)
            l_ms = time_ms(run_einsum, 20)
            cells = nlay * c
            f_bytes = 4 * (n_valid * cells + n_rows + 1 + cells)
            f_ops = 3 * n_valid * cells
            t_bytes = f_bytes / HBM_BYTES_PER_S
            t_ops = f_ops / PEAK_OPS["float32"]
            print(f"[{tag}-kernel] fisher_tapgrads f32 {arch} {shape} "
                  f"({n_valid} of {n_rows} rows valid, the rest NaN): max "
                  f"abs err {err:.3g} (tol {FISHER_TOL['float32']:g}); "
                  f"kernel {f_ms:.4f} ms, bound "
                  f"{1e3 * max(t_bytes, t_ops):.5f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'}), plain "
                  f"{p_ms:.4f} ms, einsum {l_ms:.4f} ms", flush=True)
    torch.cuda.empty_cache()
    return worst


def moe_full(api, configs, ops, T, ServeEngine, Request, tree_leaves, dev,
             arch: str) -> dict:
    """Phase 18 (c): one model of the moe family at its published width in
    bf16 (random weights from a seeded generator, depth cut to
    MOE_LAYERS): TinyTrain on phase 6's episode shape under phase 6's
    profile scaled to the width, ``fold_into`` an engine, phase 5's
    traffic on contiguous and paged caches, and (mixtral) a rolling serve
    past the window.  Returns the kernel launches of its main paths."""
    import dataclasses

    import numpy as np
    import torch

    cfg = dataclasses.replace(configs.get_config(arch),
                              n_layers=MOE_LAYERS[arch])
    nl = cfg.n_layers
    bb = api.backbone("lm", cfg=cfg, batch_size=ADAPT["batch_size"],
                      seq=ADAPT["seq"])
    t0 = time.perf_counter()
    session = api.TinyTrainSession(bb, max_way=ADAPT["max_way"], seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves(session.params))
    n_params = sum(t.numel() for t in tree_leaves(session.params))
    task = api.sample_lm_task(np.random.default_rng(0), cfg.vocab,
                              seq=ADAPT["seq"], max_way=ADAPT["task_way"],
                              support_pad=ADAPT["pad"], query_pad=ADAPT["pad"])
    # phase 6's profile scaled to this width: a unit's saved input grows
    # with d_model
    profile = api.DeviceProfile(name="edge-lm", mem_kb=4000,
                                compute_frac=0.5).scaled(
        mem=500 * cfg.d_model / 1536, compute=1.6)
    groups = sum(len(grp) for grp in bb.make_taps(1, "cpu").values())
    torch.cuda.empty_cache()  # earlier phases' cached blocks fragment it
    base = peak_reset(dev)
    others = base - weights  # what earlier phases still hold
    total = torch.cuda.get_device_properties(0).total_memory
    kernel_launches(ops, zero=True)
    t0 = time.perf_counter()
    try:
        ad = session.adapt(task, profile, iters=ADAPT["iters"])
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as exc:
        fail(f"{arch} at {nl} layers: the adapt ran out of the card's "
             f"{total} B ({weights} B of weights, {others} B of other "
             f"allocations); cut MOE_LAYERS: {exc}")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    counts = kernel_launches(ops)
    fisher_n = counts["fisher_tapgrads.launches"] + counts["fisher.launches"]
    losses = ad.losses
    print(f"[moe-adapt] {arch} bf16 published width, {nl} of "
          f"{configs.get_config(arch).n_layers} layers ({n_params} "
          f"parameters, {weights} B of weights, initialised in "
          f"{init_s:.1f} s), {profile.name} ({profile.budget().mem_bytes:.0f}"
          f" B, compute {profile.compute_frac}): {ad.policy.describe()}",
          flush=True)
    print(f"[moe-adapt] {arch} fisher_seconds {ad.fisher_seconds:.4f}, "
          f"train_seconds {ad.train_seconds:.4f} ({ADAPT['iters']} steps), "
          f"adapt wall {wall:.4f} s, peak device memory {peak} B ({peak - base}"
          f" B above the weights and {others} B of other allocations), "
          f"host_transfers {ad.host_transfers:g}, "
          f"fisher launches {fisher_n} ({groups} tap groups), losses "
          f"{[round(x, 6) for x in losses]}", flush=True)
    print(f"[moe-adapt] {arch} headroom at the peak: {total - peak} B of "
          f"{total} B free of allocations, {total - reserved} B free of the "
          f"allocator's reservation (peak reserved {reserved} B; gate "
          f"{MOE_HEADROOM} B)", flush=True)
    if total - peak < MOE_HEADROOM:
        fail(f"{arch} at {nl} layers: the adapt's peak {peak} B leaves "
             f"{total - peak} B of the card's {total} B, under the "
             f"{MOE_HEADROOM} B margin; cut MOE_LAYERS")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{arch}: adaptation losses not finite: {losses}")
    if ad.host_transfers != 2:
        fail(f"{arch}: fused adapt made {ad.host_transfers} host transfers")
    if fisher_n != groups:
        fail(f"{arch}: the probe launched the Fisher kernel {fisher_n} "
             f"times, not once per tap group ({groups})")
    if ad.policy.n_units < 1:
        fail(f"{arch}: the profile selected no unit")

    launches = {"flash_cached": 0, "flash_paged": 0, "fisher": fisher_n}
    served = {}
    for what, kw in (("contiguous", {}),
                     ("paged", dict(kv_paging=True, kv_page_size=PAGE_SIZE))):
        eng = ServeEngine(cfg, session.params, slots=8, max_len=512,
                          chunk=32, **kw)
        ad.fold_into(eng)
        eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                         max_new=2)])
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab, int(n)).astype(np.int32), max_new=16)
            for i, n in enumerate(rng.integers(32, 257, 8))]
        eng.tick_sync_debug = "error"
        torch.cuda.synchronize()
        kernel_launches(ops, zero=True)
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        counts = kernel_launches(ops)
        rep, mem = eng.last_run_report, eng.memory_report()
        new = sum(len(r.out) for r in reqs)
        flash = (counts["flash_attention_cached.launches"]
                 + counts["flash_attention_paged.launches"])
        launches["flash_cached"] += counts["flash_attention_cached.launches"]
        launches["flash_paged"] += counts["flash_attention_paged.launches"]
        row = (cfg.kv_lora_rank + cfg.qk_rope_dim if cfg.mla
               else 2 * cfg.n_kv_heads * cfg.head_dim)
        print(f"[moe-serve] {arch} bf16 {what}, 8 slots, max_len 512, chunk "
              f"32, prefill_block {eng.prefill_block}: {len(reqs)} requests "
              f"(prompts {sum(len(r.prompt) for r in reqs)} tokens), {new} "
              f"new tokens in {swall:.3f} s = {new / swall:.2f} tok/s, "
              f"{rep['ticks']} ticks ({rep['ticks_issued']} issued), "
              f"{rep['host_syncs']} host syncs for {rep['chunks']} chunks, "
              f"flash launches a live tick {flash / rep['ticks']:.3f} "
              f"({counts['flash_attention_cached.launches']} cached, "
              f"{counts['flash_attention_paged.launches']} paged), KV "
              f"{mem['kv_bytes_per_stream']} B a stream ({row} values a row "
              f"a layer), kv_cache_bytes {mem['kv_cache_bytes']}, outcomes "
              f"{rep['outcomes']}", flush=True)
        one_sync_a_chunk(rep, f"{arch} {what} serve")
        bad = [(r.uid, r.outcome, len(r.out)) for r in reqs
               if r.outcome != "done" or len(r.out) != 16]
        if bad:
            fail(f"{arch} {what}: requests not done with 16 tokens: {bad}")
        kernel = ("flash_attention_cached" if what == "contiguous"
                  else "flash_attention_paged")
        n_k = counts[f"{kernel}.launches"]
        if cfg.mla:
            # MLA's cached attention is the absorbed einsum, as in the JAX
            # package: no flash kernel on this path
            if flash:
                fail(f"{arch}: the MLA serve launched a flash kernel")
        elif n_k <= 0 or n_k % nl or (what == "paged" and counts[
                "flash_attention_cached.launches"]):
            fail(f"{arch} {what}: {kernel} launches {n_k} (a positive "
                 f"multiple of {nl} wanted), counts {counts}")
        served[what] = [list(r.out) for r in reqs]
        del eng
    if served["paged"] != served["contiguous"]:
        fail(f"{arch}: the paged serve's streams differ from the "
             "contiguous one's")
    print(f"[moe-serve] {arch}: the paged streams equal the contiguous "
          f"ones over {len(served['paged'])} requests", flush=True)

    del session, ad
    torch.cuda.empty_cache()
    if cfg.sliding_window:
        R = MOE_ROLLING
        cfg = dataclasses.replace(cfg, n_layers=R["layers"])
        eng = ServeEngine(cfg, T.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0)),
            slots=R["slots"], max_len=R["max_len"], chunk=R["chunk"])
        rng = np.random.default_rng(5)
        reqs = [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab, n).astype(np.int32), max_new=R["max_new"])
            for i, n in enumerate(R["lens"])]
        eng.tick_sync_debug = "error"
        torch.cuda.synchronize()
        kernel_launches(ops, zero=True)
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        rwall = time.perf_counter() - t0
        counts = kernel_launches(ops)
        rep = eng.last_run_report
        rows = eng.caches["g0"]["attn"]["k"].shape[2]
        new = sum(len(r.out) for r in reqs)
        print(f"[moe-rolling] {arch} bf16 at {cfg.n_layers} layers, "
              f"{R['slots']} slots, max_len "
              f"{R['max_len']} over a {cfg.sliding_window}-row window, "
              f"prompts {list(R['lens'])}: {new} new tokens in {rwall:.3f} s, "
              f"{rep['ticks']} ticks ({rep['ticks_issued']} issued), "
              f"{rep['host_syncs']} host syncs for {rep['chunks']} chunks, "
              f"cache rows {rows}, outcomes {rep['outcomes']}, flash "
              f"launches {counts['flash_attention_cached.launches']} (the "
              f"rolling fold attends through plain torch, as the JAX "
              f"package's dot_attention)", flush=True)
        one_sync_a_chunk(rep, f"{arch} rolling serve")
        if rows != cfg.sliding_window:
            fail(f"{arch}: the rolling cache holds {rows} rows, not "
                 f"{cfg.sliding_window}")
        if not all(r.outcome == "done" and len(r.out) == R["max_new"]
                   for r in reqs):
            fail(f"{arch} rolling: {[(r.outcome, len(r.out)) for r in reqs]}")
        del eng
        torch.cuda.empty_cache()
    return launches


def phase18(api, configs, ops, T, ServeEngine, Request, DeltaSet,
            SelectedUnit, SparseUpdatePolicy, fold_deltas, tree_map,
            tree_leaves, flash_attention, flash_paged, fisher_kernel,
            cached_ref, tapgrads_ref, dev, gen) -> dict:
    """Phase 18, the moe family: (a) card against CPU on the smoke
    configs, (b) kernels 1, 2 and 4 at the family's shapes, (c) the
    full-width runs.  Returns the launches of the main paths by kernel and
    the largest kernel errors of (b)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    smoke_card_vs_cpu(api, configs, T, ServeEngine, Request, DeltaSet,
                      SelectedUnit, SparseUpdatePolicy, fold_deltas, tree_map,
                      dev)
    task = api.sample_lm_task(np.random.default_rng(0), 32000,
                              seq=ADAPT["seq"], max_way=ADAPT["task_way"],
                              support_pad=ADAPT["pad"], query_pad=ADAPT["pad"])
    labels = torch.from_numpy(task.support["episode_labels"]).to(dev)
    worst = moe_kernels(ops, flash_attention, flash_paged, fisher_kernel,
                        cached_ref, tapgrads_ref, (labels >= 0).float(),
                        task.n_support, dev, gen)
    launches = {"flash_cached": 0, "flash_paged": 0, "fisher": 0}
    for arch in MOE_LAYERS:
        for k, n in moe_full(api, configs, ops, T, ServeEngine, Request,
                             tree_leaves, dev, arch).items():
            launches[k] += n
    print(f"[phase18] {time.perf_counter() - t0:.1f} s; main-path launches "
          f"{launches}; largest kernel errors {worst}", flush=True)
    return {"launches": launches, "max_abs_err": worst}


def ssd_kernels(ops, ssm, ssd_kernel, ssd_scan_ref, dev, gen) -> dict:
    """Phase 19 (b): kernels 5 and 5b at zamba2's adapt shape (ZAMBA_SSD:
    48 rows of 64 tokens, 64 heads of 64, state 64) in f32 at 1e-4 and
    bf16 within SSD_TOL of the plain version, each timed beside its bound
    and its plain version; then both under ``torch.func.vmap`` of
    ``torch.func.grad_and_value`` over VMAP_TASKS tasks in bf16: each
    task's y and gradients bit-equal to its own launch's, one launch each
    way for all tasks, timed against the tasks' launches one by one.
    Returns the largest errors, keyed by kernel."""
    import torch
    import torch.nn.functional as F

    b, s, h, p, n, chunk = (ZAMBA_SSD[k] for k in ("b", "s", "h", "p", "n",
                                                   "chunk"))

    def inputs(dtype, lead=()):
        x = (0.5 * torch.randn(lead + (b, s, h, p), generator=gen,
                               device=dev)).to(dtype)
        dt = F.softplus(torch.randn(lead + (b, s, h), generator=gen,
                                    device=dev))
        bm = (0.5 * torch.randn(lead + (b, s, n), generator=gen,
                                device=dev)).to(dtype)
        cm = (0.5 * torch.randn(lead + (b, s, n), generator=gen,
                                device=dev)).to(dtype)
        w = torch.randn(lead + (b, s, h, p), generator=gen, device=dev)
        return x, dt, bm, cm, w

    a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
    worst = {"ssd_scan": 0.0, "ssd_scan_bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        x, dt, bm, cm, w = inputs(dtype)
        leaves = [t.clone().requires_grad_() for t in (x, dt, bm, cm)]
        y, _ = ssm.ssd_chunked(leaves[0], leaves[1], a, leaves[2], leaves[3],
                               chunk, None, need_state=False)
        got = torch.autograd.grad((y.float() * w).sum(), leaves)
        refl = [t.float().clone().requires_grad_() for t in (x, dt, bm, cm)]
        yp, _ = ssm.ssd_chunked_plain(refl[0], refl[1], a, refl[2], refl[3],
                                      chunk)
        want = torch.autograd.grad((yp * w).sum(), refl)
        yr, _ = ssd_scan_ref(x.float(), dt, a, bm, cm)
        torch.cuda.synchronize()
        scale = max(1.0, yr.abs().max().item())
        e_f = (y.float() - yr).abs().max().item()
        if not math.isfinite(e_f) or e_f / scale > 1e-4:
            fail(f"ssd_scan {dname} at zamba2's shape: error {e_f}")
        e_b = 0.0
        for name, g, wv in zip(("dx", "d(dt)", "dB", "dC"), got, want):
            e = (g.float() - wv).abs().max().item()
            if not math.isfinite(e) or e / max(1.0, wv.abs().max().item()) \
                    > SSD_TOL[dname]:
                fail(f"ssd_scan_bwd {name} {dname} at zamba2's shape: "
                     f"error {e}")
            e_b = max(e_b, e)
        worst["ssd_scan"] = max(worst["ssd_scan"], e_f)
        worst["ssd_scan_bwd"] = max(worst["ssd_scan_bwd"], e_b)
        print(f"[hybrid-kernel] ssd_scan / ssd_scan_bwd {dname} at zamba2's "
              f"adapt shape (B={b} S={s} H={h} P={p} N={n}): max abs err "
              f"{e_f:.3g} (tol 1e-4 of max(1, max |y|)) / {e_b:.3g} (tol "
              f"{SSD_TOL[dname]:g})", flush=True)

    # bf16 times, the kernels through their C entries (as phase 3 times
    # mamba2's shape), two input sets cycled
    sets = [inputs(torch.bfloat16) for _ in range(2)]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(sets)
        return sets[it["i"]]

    geo = ssd_kernel.bwd_geometry(b, s, h)
    f32 = dict(dtype=torch.float32, device=dev)
    y_o, dx_o = torch.empty((b, s, h, p), **f32), torch.empty((b, s, h, p),
                                                              **f32)
    ddt_o, dbc_o = torch.empty((b, s, h), **f32), torch.empty((2, b, s, n),
                                                              **f32)
    part = (torch.empty((2, b, geo["groups"], s, n), **f32)
            if geo["groups"] > 1 else None)
    states = (torch.empty((b, h, geo["state_slots"], p, n), **f32)
              if geo["state_slots"] else None)
    launched = ctypes.c_int(0)
    fwd_entry, bwd_entry = ssd_kernel._entry(), ssd_kernel._bwd_entry()
    stream = torch.cuda.current_stream().cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    def run_fwd():
        x, dt, bm, cm, _ = nxt()
        rc = fwd_entry(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                       bm.data_ptr(), cm.data_ptr(), None, y_o.data_ptr(),
                       None, b, s, h, p, n, 1, stream)
        if rc:
            fail(f"ssd_scan_fwd returned cudaError {rc}")

    def run_bwd():
        x, dt, bm, cm, w = nxt()
        rc = bwd_entry(w.data_ptr(), x.data_ptr(), dt.data_ptr(),
                       a.data_ptr(), bm.data_ptr(), cm.data_ptr(), None,
                       ptr(states), dx_o.data_ptr(), ddt_o.data_ptr(),
                       ptr(part), dbc_o.data_ptr(), b, s, h, p, n, 1, stream,
                       ctypes.byref(launched))
        if rc:
            fail(f"ssd_scan_bwd returned cudaError {rc}")

    def run_fwd_plain():
        x, dt, bm, cm, _ = nxt()
        ssd_scan_ref(x, dt, a, bm, cm)

    def run_bwd_plain():
        x, dt, bm, cm, w = nxt()
        lv = [t.detach().requires_grad_() for t in (x, dt, bm, cm)]
        y, _ = ssm.ssd_chunked_plain(lv[0], lv[1], a, lv[2], lv[3], chunk)
        torch.autograd.grad(y, lv, w.to(y.dtype))

    for what, run, plain, backward in (("forward", run_fwd, run_fwd_plain,
                                        False),
                                       ("backward", run_bwd, run_bwd_plain,
                                        True)):
        ms, p_ms = time_ms(run, 20 if backward else 50), time_ms(plain, 2)
        nbytes, nops = ssd_work(b, s, h, p, n, 2, backward)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS["bfloat16"]
        print(f"[hybrid-time] ssd_scan {what} bf16 at zamba2's adapt shape "
              f"(B={b} S={s} H={h} P={p} N={n}): kernel {ms:.4f} ms, bound "
              f"{1e3 * max(t_bytes, t_ops):.5f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}), plain "
              f"{p_ms:.4f} ms, no single library call", flush=True)
    del y_o, dx_o, ddt_o, dbc_o, part, states

    # under torch.func.vmap: the task axis folds into the kernels' batch
    tv = VMAP_TASKS
    x, dt, bm, cm, w = inputs(torch.bfloat16, (tv,))

    def loss(x, dt, bm, cm, w):
        y, _ = ssm.ssd_chunked(x, dt, a, bm, cm, chunk, None,
                               need_state=False)
        return (y.float() * w).sum()

    def fwd(x, dt, bm, cm):
        return ssm.ssd_chunked(x, dt, a, bm, cm, chunk, None,
                               need_state=False)[0]

    step = torch.func.grad(loss, argnums=(0, 1, 2, 3))
    fleet = torch.func.vmap(step)
    before = (ops.ssd_scan.launches, ops.ssd_scan.bwd_launches)
    ys = torch.func.vmap(fwd)(x, dt, bm, cm)
    torch.cuda.synchronize()
    y_launches = ops.ssd_scan.launches - before[0]
    before = (ops.ssd_scan.launches, ops.ssd_scan.bwd_launches)
    grads = fleet(x, dt, bm, cm, w)
    torch.cuda.synchronize()
    folded = (ops.ssd_scan.launches - before[0],
              ops.ssd_scan.bwd_launches - before[1])
    same = True
    for k in range(tv):
        g_k = step(x[k], dt[k], bm[k], cm[k], w[k])
        same = same and torch.equal(fwd(x[k], dt[k], bm[k], cm[k]),
                                    ys[k]) and all(
            torch.equal(g[k], gk) for g, gk in zip(grads, g_k))
    torch.cuda.synchronize()
    v_ms = time_ms(lambda: fleet(x, dt, bm, cm, w), 5)

    def one_by_one():
        for k in range(tv):
            step(x[k], dt[k], bm[k], cm[k], w[k])

    l_ms = time_ms(one_by_one, 5)
    print(f"[hybrid-kernel] ssd_scan under vmap over {tv} tasks bf16 at "
          f"zamba2's adapt shape: y in {y_launches} forward launch(es), "
          f"vmap(grad) in {folded[0]} forward and {folded[1]} backward "
          f"launch(es) for all tasks; each task's y and dx, d(dt), dB, dC "
          f"{'bit-equal to' if same else 'DIFFER FROM'} its own launch's; "
          f"vmap(grad) {v_ms:.4f} ms against {l_ms:.4f} ms for the tasks "
          f"one by one", flush=True)
    if y_launches != 1:
        fail(f"the vmapped SSD forward launched {y_launches} times, not 1")
    if folded != (1, 1):
        fail(f"the vmapped SSD scan launched {folded}, not one each way")
    if not same:
        fail("a vmapped task's SSD scan differs from its own launch")
    del sets, x, dt, bm, cm, w, grads, ys
    torch.cuda.empty_cache()
    return worst


def zamba2_full(api, configs, ops, ServeEngine, Request, tree_leaves, dev,
                profile):
    """Phase 19 (c): zamba2-1.2b at its published width and depth in bf16
    (random weights from a seeded generator): TinyTrain on phase 6's
    episode shape under ``profile`` (phase 6's), ``fold_into`` an engine,
    phase 5's traffic on contiguous and paged caches.  Returns (the kernel
    launches of its main paths, the session, the adaptation)."""
    import numpy as np
    import torch

    arch = "zamba2-1.2b"
    cfg = configs.get_config(arch)
    nl, every = cfg.n_layers, cfg.hybrid_attn_every
    shared = nl // every
    bb = api.backbone(arch, preset="full", batch_size=ADAPT["batch_size"],
                      seq=ADAPT["seq"])
    t0 = time.perf_counter()
    session = api.TinyTrainSession(bb, max_way=ADAPT["max_way"], seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves(session.params))
    n_params = sum(t.numel() for t in tree_leaves(session.params))
    task = api.sample_lm_task(np.random.default_rng(0), cfg.vocab,
                              seq=ADAPT["seq"], max_way=ADAPT["task_way"],
                              support_pad=ADAPT["pad"], query_pad=ADAPT["pad"])
    groups = sum(len(grp) for grp in bb.make_taps(1, "cpu").values())
    torch.cuda.empty_cache()
    base = peak_reset(dev)
    kernel_launches(ops, zero=True)
    t0 = time.perf_counter()
    ad = session.adapt(task, profile, iters=ADAPT["iters"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = kernel_launches(ops)
    fisher_n = counts["fisher_tapgrads.launches"] + counts["fisher.launches"]
    fwd, bwd = (counts["ssd_scan.launches"], counts["ssd_scan.bwd_launches"])
    losses = ad.losses
    print(f"[zamba2] zamba2-1.2b bf16 published width and depth ({nl} SSD "
          f"layers, d_model {cfg.d_model}, {cfg.n_ssm_heads} SSD heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}; a shared block of "
          f"{cfg.n_heads} heads of {cfg.head_dim} and d_ff {cfg.d_ff} after "
          f"every {every}th layer, {shared} applications; {n_params} "
          f"parameters, {weights} B of weights, initialised in "
          f"{init_s:.1f} s), {profile.name}, task {task.n_support} support "
          f"rows of {len(task.support['episode_labels'])}: "
          f"{ad.policy.describe()}", flush=True)
    print(f"[zamba2] fisher_seconds {ad.fisher_seconds:.4f}, train_seconds "
          f"{ad.train_seconds:.4f} ({ADAPT['iters']} steps), adapt wall "
          f"{wall:.4f} s, peak device memory {peak} B ({peak - base} B above "
          f"the weights and earlier allocations), host_transfers "
          f"{ad.host_transfers:g}, fisher launches {fisher_n} ({groups} tap "
          f"group), ssd_scan launches {fwd} forward, {bwd} backward, flash "
          f"launches {counts['flash_attention_cached.launches']} "
          f"(the adapt's shared block attends through plain torch, as the "
          f"JAX package's dot_attention), losses "
          f"{[round(x, 6) for x in losses]}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"zamba2: adaptation losses not finite: {losses}")
    if ad.host_transfers != 2:
        fail(f"zamba2: fused adapt made {ad.host_transfers} host transfers")
    if fisher_n != groups or groups != 1:
        fail(f"zamba2: the probe launched the Fisher kernel {fisher_n} times "
             f"for {groups} tap groups (one wanted)")
    if {u.kind for u in ad.policy.units} != {"ssm"}:
        fail(f"zamba2: the profile selected no SSD unit only: "
             f"{ad.policy.describe()}")
    if fwd <= 0 or fwd % nl or bwd <= 0:
        fail(f"zamba2: ssd_scan launches {fwd} forward (a positive multiple "
             f"of {nl} wanted), {bwd} backward")

    launches = {"flash_cached": 0, "flash_paged": 0, "fisher": fisher_n,
                "ssd_scan": fwd, "ssd_scan_bwd": bwd}
    served = {}
    for what, kw in (("contiguous", {}),
                     ("paged", dict(kv_paging=True, kv_page_size=PAGE_SIZE))):
        eng = ServeEngine(cfg, session.params, slots=8, max_len=512,
                          chunk=32, **kw)
        ad.fold_into(eng)
        eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                         max_new=2)])
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab, int(n)).astype(np.int32), max_new=16)
            for i, n in enumerate(rng.integers(32, 257, 8))]
        eng.tick_sync_debug = "error"
        torch.cuda.synchronize()
        kernel_launches(ops, zero=True)
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        counts = kernel_launches(ops)
        rep, mem = eng.last_run_report, eng.memory_report()
        new = sum(len(r.out) for r in reqs)
        n_c = counts["flash_attention_cached.launches"]
        n_p = counts["flash_attention_paged.launches"]
        launches["flash_cached"] += n_c
        launches["flash_paged"] += n_p
        lens = sum(t.numel() * t.element_size() for g in eng.caches.values()
                   for t in ([g["len"]] if "len" in g
                             else [c["len"] for c in g.values()]))
        if what == "paged":
            kv_slot = mem["kv_bytes_per_stream"]  # worst case, engine empty
        else:
            kv_slot = ((mem["kv_cache_bytes"] - lens) // 8
                       - eng.ssm_state_bytes_per_slot)
        print(f"[zamba2-serve] zamba2-1.2b bf16 {what}, 8 slots, max_len "
              f"512, chunk 32, prefill_block {eng.prefill_block}: "
              f"{len(reqs)} requests (prompts "
              f"{sum(len(r.prompt) for r in reqs)} tokens), {new} new tokens "
              f"in {swall:.3f} s = {new / swall:.2f} tok/s, {rep['ticks']} "
              f"ticks ({rep['ticks_issued']} issued), {rep['host_syncs']} "
              f"host syncs for {rep['chunks']} chunks, flash launches "
              f"{n_c} cached, {n_p} paged ({(n_c + n_p) / rep['ticks']:.3f} "
              f"a live tick), shared-block KV {kv_slot} B a slot (want "
              f"{SHARED_KV_BYTES}), SSD state "
              f"{eng.ssm_state_bytes_per_slot} B a slot, kv_cache_bytes "
              f"{mem['kv_cache_bytes']}, outcomes {rep['outcomes']}",
              flush=True)
        one_sync_a_chunk(rep, f"zamba2 {what} serve")
        bad = [(r.uid, r.outcome, len(r.out)) for r in reqs
               if r.outcome != "done" or len(r.out) != 16]
        if bad:
            fail(f"zamba2 {what}: requests not done with 16 tokens: {bad}")
        n_k = n_c if what == "contiguous" else n_p
        if n_k <= 0 or n_k % shared or (what == "paged" and n_c):
            fail(f"zamba2 {what}: flash launches {counts} (a positive "
                 f"multiple of {shared} of one kernel wanted)")
        if kv_slot != SHARED_KV_BYTES:
            fail(f"zamba2 {what}: the shared block's KV is {kv_slot} B a "
                 f"slot, not {SHARED_KV_BYTES}")
        served[what] = [list(r.out) for r in reqs]
        del eng
    if served["paged"] != served["contiguous"]:
        fail("zamba2: the paged serve's streams differ from the contiguous "
             "one's")
    print(f"[zamba2-serve] the paged streams equal the contiguous ones over "
          f"{len(served['paged'])} requests", flush=True)
    torch.cuda.empty_cache()
    return launches, session, ad


def zamba2_personalise(api, ops, ServeEngine, Request, Personaliser,
                       tree_leaves, session, policy, profile, dev) -> dict:
    """Phase 19 (d): phase 10's traffic and ``Personaliser(iters=8,
    seq=32)`` on zamba2-1.2b with (c)'s policy: each refresh's
    ``adapt_many`` runs the SSD kernels under ``torch.func.vmap``, its
    exchange kernel 6.  Returns the kernel launches of this path."""
    import numpy as np
    import torch

    cfg = session.backbone.cfg
    P = PERSONALISE
    eng = ServeEngine(cfg, session.params, slots=P["slots"],
                      max_len=P["max_len"], chunk=P["chunk"],
                      personalise=policy)
    eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                     max_new=2)])
    eng.tick_sync_debug = "error"
    pers = Personaliser(session, eng, policy, profile=profile,
                        iters=P["iters"], seq=P["seq"])
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i % P["users"], prompt=rng.integers(
        0, cfg.vocab, size=int(rng.integers(4, 24))).astype(np.int32),
        max_new=P["max_new"]) for i in range(P["requests"])]
    leaves_per_user = len(tree_leaves(session.backbone.init_deltas(policy,
                                                                   dev)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel_launches(ops, zero=True)
    t0 = time.perf_counter()
    online = pers.run_online(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_launches(ops)
    peak = torch.cuda.max_memory_allocated()
    refreshes = online["refreshes"]
    refreshed = sum(len(r["users"]) for r in refreshes)
    gq = counts["grad_quant.launches"]
    fwd, bwd = counts["ssd_scan.launches"], counts["ssd_scan.bwd_launches"]
    new = sum(len(r.out) for r in reqs)
    print(f"[zamba2-personalise] zamba2-1.2b bf16, {P['slots']} slots, "
          f"max_len {P['max_len']}, chunk {P['chunk']}, {P['users']} users, "
          f"policy {policy.describe()} ({leaves_per_user} delta leaves a "
          f"user): {len(reqs)} requests, {new} new tokens in {wall:.3f} s "
          f"with {len(refreshes)} refreshes ({refreshed} users), "
          f"{online['rounds']} rounds, {online['host_syncs']} host syncs for "
          f"{online['chunks']} chunks, peak device memory {peak} B; "
          f"launches: ssd_scan {fwd} forward / {bwd} backward (adapt_many "
          f"under vmap), grad_quant {gq}, flash_cached "
          f"{counts['flash_attention_cached.launches']}", flush=True)
    for r in refreshes:
        print(f"[zamba2-personalise] refresh {r['round']}: users "
              f"{r['users']} (deferred {r['deferred_users']}), adapt_seconds "
              f"{r['adapt_seconds']:.4f}, swap_seconds "
              f"{r['swap_seconds']:.6f}, resident rows swapped "
              f"{r['resident_rows_swapped']}, wire {r['payload_bytes_wire']}"
              f" B vs f32 {r['payload_bytes_f32']} B", flush=True)
    if not refreshes:
        fail("the zamba2 personalised serve refreshed no user")
    one_sync_a_chunk(online, "zamba2 personalise")
    bad = [(r.uid, r.outcome) for r in reqs if r.outcome != "done"]
    if bad:
        fail(f"zamba2 personalise: requests not done: {bad}")
    if fwd <= 0 or bwd <= 0:
        fail(f"the zamba2 refreshes launched the SSD kernels {fwd} / {bwd} "
             "times")
    if gq <= 0 or gq != refreshed * leaves_per_user:
        fail(f"grad_quant launched {gq} times for {refreshed} refreshed "
             f"users of {leaves_per_user} leaves each")
    del eng, pers
    torch.cuda.empty_cache()
    return {"ssd_scan": fwd, "ssd_scan_bwd": bwd, "grad_quant": gq,
            "flash_cached": counts["flash_attention_cached.launches"]}


def phase19(dev, gen, profile) -> dict:
    """Phase 19, the ssm-based families finished: (a) card against CPU on
    zamba2-smoke and mamba2-smoke, (b) kernels 2, 4, 5, 5b (and under
    vmap) and 1 at zamba2's shapes, (c) zamba2-1.2b at full width and
    depth, (d) its personalised serve.  Returns the launches of the main
    paths by kernel and the largest kernel errors of (b)."""
    import numpy as np
    import torch

    from repro_torch import api, configs
    from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
    from repro_torch.kernels import flash_attention, flash_paged, ops
    from repro_torch.kernels import fisher as fisher_kernel
    from repro_torch.kernels import ssd_scan as ssd_kernel
    from repro_torch.kernels.ref import (
        fisher_tapgrads_ref, flash_attention_cached_ref, ssd_scan_ref,
    )
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    from repro_torch.models.overlay import fold_deltas
    from repro_torch.serving import (
        DeltaSet, Personaliser, Request, ServeEngine,
    )
    from repro_torch.utils import tree_leaves, tree_map

    t0 = time.perf_counter()
    smoke_card_vs_cpu(api, configs, T, ServeEngine, Request, DeltaSet,
                      SelectedUnit, SparseUpdatePolicy, fold_deltas, tree_map,
                      dev, archs=HYBRID_SMOKE, tag="hybrid", pressured=True)
    t_a = time.perf_counter() - t0
    worst = block_kernels(ops, flash_attention, flash_paged,
                          flash_attention_cached_ref, SHARED_BLOCK,
                          "zamba2's shared", "hybrid", dev, gen)
    worst.update(ssd_kernels(ops, ssm, ssd_kernel, ssd_scan_ref, dev, gen))
    task = api.sample_lm_task(np.random.default_rng(0), 32000,
                              seq=ADAPT["seq"], max_way=ADAPT["task_way"],
                              support_pad=ADAPT["pad"], query_pad=ADAPT["pad"])
    labels = torch.from_numpy(task.support["episode_labels"]).to(dev)
    worst["fisher"] = tap_kernels(ops, fisher_kernel, fisher_tapgrads_ref,
                                  (labels >= 0).float(), task.n_support,
                                  ZAMBA_TAPS, "hybrid", dev, gen)
    t_b = time.perf_counter() - t0 - t_a
    launches, session, ad = zamba2_full(api, configs, ops, ServeEngine,
                                        Request, tree_leaves, dev, profile)
    t_c = time.perf_counter() - t0 - t_a - t_b
    for k, v in zamba2_personalise(api, ops, ServeEngine, Request,
                                   Personaliser, tree_leaves, session,
                                   ad.policy, profile, dev).items():
        launches[k] = launches.get(k, 0) + v
    del session, ad
    torch.cuda.empty_cache()
    total = time.perf_counter() - t0
    print(f"[phase19] {total:.1f} s ((a) {t_a:.1f}, (b) {t_b:.1f}, (c) "
          f"{t_c:.1f}, (d) {total - t_a - t_b - t_c:.1f}); main-path "
          f"launches {launches}; largest kernel errors {worst}", flush=True)
    return {"launches": launches, "max_abs_err": worst}


def enc_requests(cfg, Request, np, n: int = 8) -> list:
    """Phase 5's traffic with encoder inputs: ``n`` requests of 32-256
    prompt tokens and 16 new ones, each with its own random encoder inputs
    (the config's stub frontend: whisper's (1500, 512) frames,
    paligemma's (256, 1152) patch embeddings), from seed 0."""
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(m)).astype(
        np.int32), max_new=16, enc_feats=rng.standard_normal(
            cfg.enc_feats_shape).astype(np.float32))
        for i, m in enumerate(rng.integers(32, 257, n))]


def enc_page_budget(cfg, slots: int, max_len: int) -> int:
    """Pages for ``slots`` residents of a paged encoder-decoder or vlm
    engine: each holds its KV stripe and its encoder run (whisper's 1500
    frames take 94 pages of 16 rows)."""
    rows = cfg.enc_len if cfg.is_encoder_decoder else cfg.n_img_tokens
    return slots * (-(-max_len // PAGE_SIZE) + -(-rows // PAGE_SIZE))


def encoder_attention(L, dev, gen) -> None:
    """The whisper encoder's attention (``layers.chunked_attention``, plain
    torch as in the JAX package: 8 heads of 64 over 1500 frames, chunks of
    500 and 750) at one request and at the adapt's 48 rows, bf16, beside
    its bound and SDPA on the same inputs."""
    import torch
    import torch.nn.functional as F

    h, s, d = 8, 1500, 64
    for b in (1, ADAPT["batch_size"]):
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        got = L.chunked_attention(q, k, v, causal=False)
        want = F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in (q, k, v))).transpose(1, 2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= TOL["bfloat16"]:
            fail(f"chunked_attention at ({b}, {s}, {h}, {d}): max abs err "
                 f"{err}")
        c_ms = time_ms(lambda: L.chunked_attention(q, k, v, causal=False), 3)
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in (q, k, v))), 10)
        nbytes = 4 * b * s * h * d * 2
        nops = 4 * b * h * s * s * d
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS["bfloat16"]
        print(f"[encdec-time] whisper encoder attention (chunked_attention, "
              f"plain torch) bf16 B={b} S={s} H={h} D={d}: {c_ms:.4f} ms, "
              f"bound {1e3 * max(t_bytes, t_ops):.5f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}), sdpa "
              f"{l_ms:.4f} ms; max abs err vs sdpa {err:.3g}", flush=True)


def enc_task(api, cfg, arch: str):
    """Phase 20's adapt task for ``arch``: ``sample_encdec_task`` from seed
    0 at phase 6's episode shape (48 rows of 64 tokens; paligemma's cut to
    24 rows, ENC_EPISODE), with its encoder inputs."""
    import numpy as np

    episode = dict(ENC_EPISODE[arch])
    rows = episode.pop("rows")
    return api.sample_encdec_task(np.random.default_rng(0), cfg,
                                  seq=ADAPT["seq"],
                                  max_way=ADAPT["task_way"],
                                  support_pad=rows, query_pad=rows,
                                  **episode)


def enc_full(api, configs, ops, L, T, ServeEngine, Request, tree_leaves,
             dev, arch: str, task) -> dict:
    """Phase 20 (b) and (c): ``arch`` (whisper-base or paligemma-3b) at its
    published config, nothing cut, bf16, random weights from seed 0:
    TinyTrain on ``task`` (:func:`enc_task`: phase 6's episode shape with
    encoder inputs; paligemma's cut to 24 rows, ENC_EPISODE) under phase
    6's profile scaled to the width,
    ``fold_into`` an engine, phase 5's traffic with encoder inputs on
    contiguous and paged caches (a paged pool sized for eight residents'
    KV and encoder runs).  Returns the kernel launches of its main
    paths."""
    import numpy as np
    import torch

    cfg = configs.get_config(arch)
    nl = cfg.n_layers
    rows = ENC_EPISODE[arch]["rows"]
    bb = api.backbone(arch, preset="full", batch_size=rows, seq=ADAPT["seq"])
    t0 = time.perf_counter()
    session = api.TinyTrainSession(bb, max_way=ADAPT["max_way"], seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves(session.params))
    n_params = sum(t.numel() for t in tree_leaves(session.params))
    # phase 6's profile scaled to this width: a unit's saved input grows
    # with d_model
    profile = api.DeviceProfile(name="edge-lm", mem_kb=4000,
                                compute_frac=0.5).scaled(
        mem=500 * cfg.d_model / 1536, compute=1.6)
    groups = sum(len(grp) for grp in bb.make_taps(1, "cpu").values())
    torch.cuda.empty_cache()
    base = peak_reset(dev)
    kernel_launches(ops, zero=True)
    t0 = time.perf_counter()
    ad = session.adapt(task, profile, iters=ADAPT["iters"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = kernel_launches(ops)
    fisher_n = counts["fisher_tapgrads.launches"] + counts["fisher.launches"]
    losses = ad.losses
    key = "frames" if cfg.is_encoder_decoder else "image_embeds"
    print(f"[encdec] {arch} bf16 published config ({nl} decoder layers"
          + (f", {cfg.n_enc_layers} encoder layers over {cfg.enc_len} "
             f"frames" if cfg.is_encoder_decoder else
             f", a {cfg.n_img_tokens}-token image prefix from "
             f"{cfg.img_embed_dim}-wide patches")
          + f", d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim} over {cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}; {n_params} parameters, {weights} B of "
          f"weights, initialised in {init_s:.1f} s), {profile.name} "
          f"({profile.budget().mem_bytes:.0f} B, compute "
          f"{profile.compute_frac}), task {task.n_support} support rows of "
          f"{len(task.support['episode_labels'])} with {key} "
          f"{tuple(task.support[key].shape[1:])}: {ad.policy.describe()}",
          flush=True)
    print(f"[encdec] {arch} fisher_seconds {ad.fisher_seconds:.4f}, "
          f"train_seconds {ad.train_seconds:.4f} ({ADAPT['iters']} steps), "
          f"adapt wall {wall:.4f} s, peak device memory {peak} B ({peak - base}"
          f" B above the weights and earlier allocations), host_transfers "
          f"{ad.host_transfers:g}, fisher launches {fisher_n} ({groups} tap "
          f"groups), flash launches "
          f"{counts['flash_attention_cached.launches']} (the adapt attends "
          f"through plain torch, as the JAX package's dot_attention), losses "
          f"{[round(x, 6) for x in losses]}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{arch}: adaptation losses not finite: {losses}")
    if ad.host_transfers != 2:
        fail(f"{arch}: fused adapt made {ad.host_transfers} host transfers")
    if fisher_n != groups:
        fail(f"{arch}: the probe launched the Fisher kernel {fisher_n} times "
             f"for {groups} tap groups (one a group wanted)")
    if not ad.policy.units:
        fail(f"{arch}: the profile selected no unit")

    launches = {"flash_cached": 0, "flash_paged": 0, "fisher": fisher_n}
    max_len, chunk = ENC_MAX_LEN[arch], 32
    served = {}
    for what, kw in (("contiguous", {}),
                     ("paged", dict(kv_paging=True, kv_page_size=PAGE_SIZE,
                                    page_budget=enc_page_budget(
                                        cfg, 8, max_len)))):
        eng = ServeEngine(cfg, session.params, slots=8, max_len=max_len,
                          chunk=chunk, **kw)
        ad.fold_into(eng)
        eng.run(enc_requests(cfg, Request, np, n=1))  # warm
        reqs = enc_requests(cfg, Request, np)
        eng.tick_sync_debug = "error"
        torch.cuda.synchronize()
        kernel_launches(ops, zero=True)
        t0 = time.perf_counter()
        # one chunk, then the report of the resident streams' runs, then
        # the rest: both runs hold one sync a chunk
        eng.run(reqs, max_ticks=chunk)
        mem = eng.memory_report()
        rep1 = eng.last_run_report
        eng.run([])
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        counts = kernel_launches(ops)
        rep = eng.last_run_report
        ticks = rep1["ticks"] + rep["ticks"]
        new = sum(len(r.out) for r in reqs)
        n_c = counts["flash_attention_cached.launches"]
        n_p = counts["flash_attention_paged.launches"]
        launches["flash_cached"] += n_c
        launches["flash_paged"] += n_p
        run_b = mem["enc_run_bytes"] // max(mem["resident_streams"], 1)
        print(f"[encdec-serve] {arch} bf16 {what}, 8 slots, max_len "
              f"{max_len}, chunk {chunk}, prefill_block {eng.prefill_block}"
              + (f", {mem['n_pages']} pages of {PAGE_SIZE} rows"
                 if what == "paged" else "")
              + f": {len(reqs)} requests (prompts "
              f"{sum(len(r.prompt) for r in reqs)} tokens), {new} new tokens "
              f"in {swall:.3f} s = {new / swall:.2f} tok/s, {ticks} ticks, "
              f"{rep1['host_syncs'] + rep['host_syncs']} host syncs for "
              f"{rep1['chunks'] + rep['chunks']} chunks, flash launches "
              f"{n_c} cached, {n_p} paged ({(n_c + n_p) / ticks:.3f} a live "
              f"tick), enc_run_bytes {mem['enc_run_bytes']} over "
              f"{mem['resident_streams']} resident streams ({run_b} B a "
              f"run), kv_cache_bytes {mem['kv_cache_bytes']}, outcomes "
              f"{rep['outcomes']}", flush=True)
        one_sync_a_chunk(rep1, f"{arch} {what} serve, first chunk")
        one_sync_a_chunk(rep, f"{arch} {what} serve")
        bad = [(r.uid, r.outcome, len(r.out)) for r in reqs
               if r.outcome != "done" or len(r.out) != 16]
        if bad:
            fail(f"{arch} {what}: requests not done with 16 tokens: {bad}")
        n_k = n_c if what == "contiguous" else n_p
        if n_k <= 0 or n_k % nl or (what == "paged" and n_c):
            fail(f"{arch} {what}: flash launches {counts} (a positive "
                 f"multiple of {nl} of one kernel wanted)")
        want = ENC_RUN_BYTES[arch]
        if what == "paged":
            want = -(-want // (PAGE_SIZE * cfg.d_model * 2)) * (
                PAGE_SIZE * cfg.d_model * 2)
        if not mem["resident_streams"] or run_b != want:
            fail(f"{arch} {what}: {mem['enc_run_bytes']} B of encoder runs "
                 f"for {mem['resident_streams']} residents ({want} B a run "
                 "wanted)")
        served[what] = [list(r.out) for r in reqs]
        del eng
    if served["paged"] != served["contiguous"]:
        fail(f"{arch}: the paged serve's streams differ from the contiguous "
             "one's")
    print(f"[encdec-serve] {arch}: the paged streams equal the contiguous "
          f"ones over {len(served['paged'])} requests", flush=True)
    del session, ad
    torch.cuda.empty_cache()
    return launches


def phase20(dev, gen) -> dict:
    """Phase 20, the encoder-decoder and VLM families: (a) card against CPU
    on whisper-smoke and paligemma-smoke; then per model (b) whisper-base
    and (c) paligemma-3b: kernels 2 and 4 at its block prefill and kernel
    1 at its tap groups against their plain versions, each timed beside
    its bound and library call, and the model at its published config
    adapted, folded and served (whisper's encoder attention timed too).
    Returns the launches of the main paths by kernel and the largest
    kernel errors."""
    import torch

    from repro_torch import api, configs
    from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
    from repro_torch.kernels import flash_attention, flash_paged, ops
    from repro_torch.kernels import fisher as fisher_kernel
    from repro_torch.kernels.ref import (
        fisher_tapgrads_ref, flash_attention_cached_ref,
    )
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.overlay import fold_deltas
    from repro_torch.serving import DeltaSet, Request, ServeEngine
    from repro_torch.utils import tree_leaves, tree_map

    t0 = time.perf_counter()
    smoke_card_vs_cpu(api, configs, T, ServeEngine, Request, DeltaSet,
                      SelectedUnit, SparseUpdatePolicy, fold_deltas, tree_map,
                      dev, archs=ENC_ARCHS, tag="encdec", pressured=True,
                      settings=ENC_SMOKE)
    times = {"(a)": time.perf_counter() - t0}
    worst = {"flash_cached": 0.0, "flash_paged": 0.0, "fisher": 0.0}
    launches = {"flash_cached": 0, "flash_paged": 0, "fisher": 0}
    for part, arch in zip(("(b)", "(c)"), ENC_ARCHS):
        t1 = time.perf_counter()
        task = enc_task(api, configs.get_config(arch), arch)
        labels = torch.from_numpy(task.support["episode_labels"]).to(dev)
        err = block_kernels(ops, flash_attention, flash_paged,
                            flash_attention_cached_ref, ENC_BLOCK[arch],
                            f"{arch}'s", "encdec", dev, gen)
        # kernel 1 over this model's own adapt task: its rows, its mask
        err["fisher"] = tap_kernels(ops, fisher_kernel, fisher_tapgrads_ref,
                                    (labels >= 0).float(), task.n_support,
                                    {arch: ENC_TAPS[arch]}, "encdec", dev,
                                    gen)
        for k, v in err.items():
            worst[k] = max(worst[k], v)
        if arch == "whisper-base":
            encoder_attention(L, dev, gen)
        for k, v in enc_full(api, configs, ops, L, T, ServeEngine, Request,
                             tree_leaves, dev, arch, task).items():
            launches[k] += v
        times[part] = time.perf_counter() - t1
    total = time.perf_counter() - t0
    print(f"[phase20] {total:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
          + f"); main-path launches {launches}; largest kernel errors "
          f"{worst}", flush=True)
    return {"launches": launches, "max_abs_err": worst}


def phase5_requests(cfg, Request, np, **kw) -> list:
    """Phase 5's traffic: 8 requests of 32-256 prompt tokens, 16 new each
    (the same draws from seed 0)."""
    rng = np.random.default_rng(0)
    return [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new=16, **kw)
            for i, n in enumerate(rng.integers(32, 257, 8))]


def phase10_requests(cfg, Request, np) -> list:
    """Phase 10's traffic: 16 requests from 4 users, 4-23 prompt tokens."""
    P = PERSONALISE
    rng = np.random.default_rng(0)
    return [Request(uid=i % P["users"], prompt=rng.integers(
        0, cfg.vocab, size=int(rng.integers(4, 24))).astype(np.int32),
        max_new=P["max_new"]) for i in range(P["requests"])]


def streams_of(reqs) -> list:
    return [(list(r.out), r.outcome) for r in reqs]


def score_kernel(ops, flash_attention, cached_ref, dev, gen) -> dict:
    """Kernel 2 at block_score's shape (SCORE_BLOCK): f32 at 1e-4 and bf16
    under the per-slot gate against the plain version, two runs bit-equal;
    then timed in bf16 over one K/V buffer set a qwen2-1.5b layer cycled,
    beside its bound, its plain version and SDPA.  Returns the kernel
    record's numbers."""
    import torch
    import torch.nn.functional as F

    blk = SCORE_BLOCK
    B, Sq, Hq, Hkv, D, Sk = (blk[k] for k in ("B", "Sq", "Hq", "Hkv", "D",
                                              "Sk"))
    q_off, kv_len = blk["q_offset"], blk["kv_len"]
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
        got = ops.flash_attention_cached(q, k, v, q_offset=qo, kv_len=kl,
                                         causal=True)
        again = ops.flash_attention_cached(q, k, v, q_offset=qo, kv_len=kl,
                                           causal=True)
        want = cached_ref(q, k, v, q_offset=qo, kv_len=kl, causal=True)
        sync(dev)
        err = max_err(got, want, TOL[dname], f"flash_cached {dname} Sq 32")
        bf16_gate(got, want, dname, "flash_cached Sq 32")
        same = torch.equal(got, again)
        print(f"[score-kernel] flash_cached {dname} at block_score's block "
              f"(B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} Sk={Sk}, q_offset "
              f"{q_off}, kv_len {kv_len}): max abs err {err:.3g} (tol "
              f"{TOL[dname]:g}"
              f"{', per-slot bf16 gate' if dname == 'bfloat16' else ''}); a "
              f"second run {'bit-equal' if same else 'DIFFERS'}", flush=True)
        if not same:
            fail(f"flash_cached {dname} at Sq 32: two runs differ")
        worst = max(worst, err)

    nl = 28  # qwen2-1.5b's layers: one K/V buffer set each, cycled
    bf = torch.bfloat16
    q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(bf)
    ks = torch.randn((nl, B, Sk, Hkv, D), generator=gen, device=dev).to(bf)
    vs = torch.randn((nl, B, Sk, Hkv, D), generator=gen, device=dev).to(bf)
    out = torch.empty_like(q)
    entry = flash_attention._entry()
    stream = torch.cuda.current_stream().cuda_stream
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % nl
        return it["i"]

    def run_kernel():
        i = nxt()
        rc = entry(q.data_ptr(), ks[i].data_ptr(), vs[i].data_ptr(),
                   out.data_ptr(), qo.data_ptr(), kl.data_ptr(), B, Sq, Sk,
                   Hq, Hkv, D, 1, 0, 1, stream)
        if rc:
            fail(f"flash_cached_fwd returned cudaError {rc}")

    def run_plain():
        i = nxt()
        cached_ref(q, ks[i], vs[i], q_offset=qo, kv_len=kl, causal=True)

    pos = torch.arange(Sk, device=dev)
    qpos = qo[:, None].long() + torch.arange(Sq, device=dev)[None, :]
    mask = ((pos[None, None, :] < kl[:, None, None])
            & (pos[None, None, :] <= qpos[..., None]))[:, None]
    qt = q.transpose(1, 2)

    def run_sdpa():
        i = nxt()
        F.scaled_dot_product_attention(qt, ks[i].transpose(1, 2),
                                       vs[i].transpose(1, 2), attn_mask=mask,
                                       enable_gqa=True)

    ms = time_ms(run_kernel, 4 * nl)
    plain_ms = time_ms(run_plain, nl)
    library_ms = time_ms(run_sdpa, 4 * nl)
    nbytes, nops = flash_work(q_off, kv_len, Sq, Hq, Hkv, D, 2, 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS["bfloat16"]
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[score-time] flash_cached bf16 B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} "
          f"D={D} Sk={Sk}: kernel {ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}: {nbytes} B, {nops} ops), plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms", flush=True)
    del ks, vs
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": worst}


def score_full(api, ops, T, telemetry, tree_map, session, dev) -> int:
    """Phase 21 (a): ``score_stream`` on qwen2-1.5b (bf16, phase 5's
    weights) over 8 sequences of 512 tokens at block 32, one host fetch,
    kernel 2 once a block a layer, held to a whole-sequence forward; then
    qwen2-smoke in f32, card against CPU to 1e-5.  Returns kernel 2's
    launches."""
    import numpy as np
    import torch

    cfg, params = session.backbone.cfg, session.params
    n, s, blk = SCORE["n"], SCORE["seq"], SCORE["block"]
    toks = np.random.default_rng(21).integers(0, cfg.vocab, (n, s)
                                              ).astype(np.int32)
    session.score_stream(toks[:, :2 * blk], block=blk)  # warm-up
    sync(dev)
    ops.flash_attention_cached.launches = 0
    telemetry.reset_host_sync_count()
    t0 = time.perf_counter()
    got = session.score_stream(toks, block=blk)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = ops.flash_attention_cached.launches
    fetches = telemetry.host_sync_count()
    with torch.no_grad():
        t = torch.as_tensor(toks, device=dev).long()
        x, positions, _ = T.build_inputs(cfg, params, {"tokens": t})
        h = T.forward_hidden(cfg, params, x, positions)[0]
        lg = T.unembed(cfg, params, h)[:, :-1].float()
        del h
        want = (torch.logsumexp(lg, dim=-1) - torch.gather(
            lg, -1, t[:, 1:, None])[..., 0]).mean(dim=-1).cpu().numpy()
        del lg
    gap = np.abs(got - want)
    rel = float(np.max(gap / np.maximum(1.0, np.abs(want))))
    nb = -(-s // blk)
    print(f"[score] qwen2-1.5b bf16 score_stream of {n} x {s} tokens at "
          f"block {blk}: {wall:.4f} s, {fetches} host fetch(es), "
          f"flash_cached launches {launches} ({nb} blocks x "
          f"{cfg.n_layers} layers); mean NLL {np.round(got, 4).tolist()}; "
          f"against a whole-sequence forward max abs gap "
          f"{float(gap.max()):.3g}, relative {rel:.3g} (tol {SCORE_TOL:g})",
          flush=True)
    if got.shape != (n,) or not np.isfinite(got).all():
        fail(f"score_stream gave {got}")
    if fetches != 1:
        fail(f"score_stream made {fetches} host fetches, not 1")
    if launches != nb * cfg.n_layers:
        fail(f"score_stream launched flash_cached {launches} times, not "
             f"{nb * cfg.n_layers}")
    if rel > SCORE_TOL:
        fail(f"score_stream parts from the whole-sequence forward by {rel}")

    # qwen2-smoke in f32, TF32 off: the card's scores are the CPU's
    sm = SCORE_SMOKE
    sbb = api.backbone("qwen2-1.5b", preset="smoke", batch_size=sm["n"],
                       seq=sm["seq"])
    cpu = api.TinyTrainSession(sbb, max_way=4, seed=0, device="cpu")
    card = api.TinyTrainSession(sbb, tree_map(lambda x: x.to(dev),
                                              cpu.params), max_way=4)
    stoks = np.random.default_rng(27).integers(
        0, sbb.cfg.vocab, (sm["n"], sm["seq"])).astype(np.int32)
    want = cpu.score_stream(stoks, block=sm["block"])
    got = card.score_stream(stoks, block=sm["block"])
    gap = float(np.abs(got - want).max())
    print(f"[score] qwen2-smoke f32 {sm['n']} x {sm['seq']} at block "
          f"{sm['block']} (a ragged tail): card against CPU max abs gap "
          f"{gap:.3g} (tol 1e-5)", flush=True)
    if not gap <= 1e-5:
        fail(f"qwen2-smoke scores: card against CPU {gap}")
    return launches


def fleet_serves(configs, ops, T, FleetRouter, ServeEngine, Request,
                 tree_map, params, cfg, dev) -> dict:
    """Phase 21 (b): ``FleetRouter(replicas=2)`` on the one card with
    phase 5's traffic, contiguous then paged, greedy and sampled: each
    request's stream equal to one engine's, one host sync a chunk on each
    replica; a replica killed after the first round (every request done
    once, the resumed streams the engine's); then qwen2-smoke in f32, card
    against CPU.  Returns the router runs' kernel 2 and 4 launches."""
    import numpy as np
    import torch

    devs = [dev] * FLEET_REPLICAS
    launches = {"flash_cached": 0, "flash_paged": 0}
    layouts = (("contiguous", {}),
               ("paged", dict(kv_paging=True, kv_page_size=PAGE_SIZE)))
    one_greedy = None
    for layout, lkw in layouts:
        for decoding, dkw in (("greedy", {}), ("sampled", FLEET_SAMPLED)):
            kw = dict(FLEET_ENGINE, **lkw, **dkw)
            one = phase5_requests(cfg, Request, np)
            sync(dev)
            t0 = time.perf_counter()
            ServeEngine(cfg, params, **kw).run(one)
            sync(dev)
            one_wall = time.perf_counter() - t0
            if layout == "contiguous" and decoding == "greedy":
                one_greedy = one
            router = FleetRouter(cfg, params, replicas=FLEET_REPLICAS,
                                 devices=devs, **kw)
            for e in router.engines:
                e.tick_sync_debug = "error"
            reqs = phase5_requests(cfg, Request, np)
            sync(dev)
            ops.flash_attention_cached.launches = 0
            ops.flash_attention_paged.launches = 0
            t0 = time.perf_counter()
            router.run(reqs)
            sync(dev)
            wall = time.perf_counter() - t0
            launches["flash_cached"] += ops.flash_attention_cached.launches
            launches["flash_paged"] += ops.flash_attention_paged.launches
            rep = router.last_run_report
            same = sum(a == b for a, b in zip(streams_of(reqs),
                                              streams_of(one)))
            per = [(r["ticks"], r["chunks"], r["host_syncs"])
                   for r in rep["replicas"]]
            print(f"[fleet] {layout} {decoding}: {FLEET_REPLICAS} replicas "
                  f"on {dev}, {len(reqs)} requests, "
                  f"{sum(len(r.out) for r in reqs)} new tokens in "
                  f"{wall:.3f} s (one engine: {one_wall:.3f} s), (ticks, "
                  f"chunks, host syncs) a replica "
                  f"{per}, outcomes {rep['outcomes']}; streams equal to one "
                  f"engine's: {same} of {len(reqs)}; flash_cached / "
                  f"flash_paged launches {ops.flash_attention_cached.launches}"
                  f" / {ops.flash_attention_paged.launches}", flush=True)
            for r in rep["replicas"]:
                one_sync_a_chunk(r, f"fleet {layout} {decoding} replica "
                                 f"{r['replica']}")
            if sum(1 for r in rep["replicas"] if r["chunks"]) < 2:
                fail(f"fleet {layout} {decoding}: the work did not spread")
            if same != len(reqs):
                fail(f"fleet {layout} {decoding}: streams differ from one "
                     "engine's")
            if any(r.outcome != "done" or len(r.out) != 16 for r in reqs):
                fail(f"fleet {layout} {decoding}: outcomes "
                     f"{[r.outcome for r in reqs]}")
            count = (ops.flash_attention_paged if lkw
                     else ops.flash_attention_cached).launches
            if count <= 0 or count % cfg.n_layers:
                fail(f"fleet {layout} {decoding}: the flash kernel launched "
                     f"{count} times")

    # a replica dies after the first round: its backlog re-routes
    router = FleetRouter(cfg, params, replicas=FLEET_REPLICAS, devices=devs,
                         **FLEET_ENGINE)
    reqs = phase5_requests(cfg, Request, np)
    for r in reqs:
        if not router.submit(r).accepted:
            fail("the fleet refused a request below its queue limit")
    sync(dev)
    ops.flash_attention_cached.launches = 0
    router.scan_chunks(rounds=1)
    moved = router.fail_replica(1)
    router.scan_chunks()
    sync(dev)
    launches["flash_cached"] += ops.flash_attention_cached.launches
    terminal = [r.outcome for r in reqs]
    same = sum(a == b for a, b in zip(streams_of(reqs),
                                      streams_of(one_greedy)))
    print(f"[fleet] replica 1 failed after the first round: {moved}; "
          f"outcomes {terminal}; resumed streams equal to one engine's: "
          f"{same} of {len(reqs)}", flush=True)
    if moved["rerouted"] < 1 or moved["shed"]:
        fail(f"the failed replica's backlog: {moved}")
    if any(o != "done" for o in terminal) or any(
            len(r.out) != 16 for r in reqs):
        fail(f"after the replica's failure: outcomes {terminal}")
    if same != len(reqs):
        fail("the resumed streams differ from one engine's")

    # qwen2-smoke in f32: the router on the card serves the CPU's streams
    sm = FLEET_SMOKE
    scfg = configs.get_reduced("qwen2-1.5b")
    sp = T.init_params(scfg, torch.Generator().manual_seed(0), device="cpu")
    kw = dict(slots=sm["slots"], max_len=sm["max_len"], chunk=sm["chunk"])
    for what, extra in (("contiguous greedy", {}),
                        ("paged sampled", dict(kv_paging=True, kv_page_size=4,
                                               **FLEET_SAMPLED))):
        out = []
        for d, p in (("cpu", sp), (dev, tree_map(lambda x: x.to(dev), sp))):
            rng = np.random.default_rng(5)
            reqs = [Request(uid=i % 3, prompt=rng.integers(
                0, scfg.vocab, int(rng.integers(3, 13))).astype(np.int32),
                max_new=sm["max_new"]) for i in range(sm["requests"])]
            FleetRouter(scfg, p, replicas=FLEET_REPLICAS, devices=[d] * 2,
                        **kw, **extra).run(reqs)
            out.append(streams_of(reqs))
        print(f"[fleet] qwen2-smoke f32 {what}: card against CPU "
              f"{'identical' if out[0] == out[1] else 'DIFFERENT'}",
              flush=True)
        if out[0] != out[1]:
            fail(f"qwen2-smoke fleet {what}: card streams differ from the "
                 "CPU's")
    return launches


def personalised_fleet(api, ops, FleetRouter, ServeEngine, Personaliser,
                       Request, tree_leaves, session, pol, profile,
                       dev) -> tuple:
    """Phase 21 (c): the ``Personaliser`` over ``FleetRouter(replicas=2,
    personalise=pol)`` with phase 10's traffic: every refresh crosses as
    serialized bytes (kernel 6 once a delta leaf), one sync a chunk, the
    streams those of one personalised engine with both replicas' slots
    (all 16 requests resident from the first tick in both, so each
    refresh sees the same finished streams).  Returns (the router run's
    grad_quant and flash_cached launches, the engine run's requests)."""
    import numpy as np

    P = PERSONALISE
    cfg = session.backbone.cfg
    kw = dict(max_len=P["max_len"], chunk=P["chunk"], personalise=pol)
    pkw = dict(profile=profile, iters=P["iters"], seq=P["seq"])
    one = ServeEngine(cfg, session.params, slots=FLEET_REPLICAS * P["slots"],
                      **kw)
    one_reqs = phase10_requests(cfg, Request, np)
    one_rep = Personaliser(session, one, pol, **pkw).run_online(one_reqs)
    router = FleetRouter(cfg, session.params, replicas=FLEET_REPLICAS,
                         devices=[dev] * FLEET_REPLICAS, slots=P["slots"],
                         **kw)
    for e in router.engines:
        e.tick_sync_debug = "error"
    pers = Personaliser(session, router, pol, **pkw)
    reqs = phase10_requests(cfg, Request, np)
    leaves = len(tree_leaves(session.backbone.init_deltas(pol, dev)))
    sync(dev)
    ops.grad_quant.launches = ops.flash_attention_cached.launches = 0
    t0 = time.perf_counter()
    online = pers.run_online(reqs)
    sync(dev)
    wall = time.perf_counter() - t0
    gq, fc = ops.grad_quant.launches, ops.flash_attention_cached.launches
    refreshes = online["refreshes"]
    refreshed = sum(len(r["users"]) for r in refreshes)
    same = sum(a == b for a, b in zip(streams_of(reqs), streams_of(one_reqs)))
    print(f"[pfleet] Personaliser over {FLEET_REPLICAS} replicas "
          f"({P['slots']} slots each), phase 10's traffic: {wall:.3f} s, "
          f"{online['rounds']} rounds, {online['host_syncs']} host syncs for "
          f"{online['chunks']} chunks, {len(refreshes)} refreshes of "
          f"{refreshed} users (one engine of {FLEET_REPLICAS * P['slots']} "
          f"slots: {len(one_rep['refreshes'])} of "
          f"{sum(len(r['users']) for r in one_rep['refreshes'])}); "
          f"grad_quant launches {gq} ({leaves} leaves a user), flash_cached "
          f"launches {fc}; streams equal to the engine's: {same} of "
          f"{len(reqs)}", flush=True)
    for r in refreshes:
        print(f"[pfleet] refresh {r['round']}: users {r['users']}, "
              f"wire_serialized {r['wire_serialized']}, wire_bytes "
              f"{r['payload_bytes_wire']} B vs f32 {r['payload_bytes_f32']} "
              f"B, payload_ratio {r['payload_ratio']:.4f}, swap_seconds "
              f"{r['swap_seconds']:.6f}, adapt_seconds "
              f"{r['adapt_seconds']:.4f}", flush=True)
    one_sync_a_chunk(online, "personalised fleet")
    if not refreshes or not all(r["wire_serialized"] for r in refreshes):
        fail("the personalised fleet's refreshes did not ship bytes")
    if gq <= 0 or gq != refreshed * leaves:
        fail(f"grad_quant launched {gq} times for {refreshed} refreshed "
             f"users of {leaves} leaves each")
    if min(r["payload_ratio"] for r in refreshes) <= 3.9:
        fail(f"payload ratio {[r['payload_ratio'] for r in refreshes]} not "
             "above 3.9")
    if any(r.outcome != "done" for r in reqs) or same != len(reqs):
        fail("the personalised fleet's streams differ from one engine's")
    if fc <= 0 or fc % cfg.n_layers:
        fail(f"the personalised fleet launched flash_cached {fc} times")
    return gq, fc, one_reqs, one


def mesh_fleet(api, ops, Personaliser, tree_leaves, session, pol, profile,
               one_reqs, one_engine, dev) -> int:
    """Phase 21 (d): ``adapt_many`` over phase 10's four users' episodes
    (as the Personaliser builds them from the users' finished streams) on
    qwen2-1.5b in f32, the probe route: with no mesh, over a mesh of two
    positions on the one card, with ``hosts=2``, and with no mesh a
    shard's tasks at a time.  Gates: the same policies; each mesh task's
    losses and deltas those of the single-device fleet of its shard's
    tasks, bit for bit (the mesh runs the single-device program a shard
    a position); ``hosts=2`` the global mesh's bit for bit; kernel 1 once
    a tap group a shard.  The losses' distance to the four-task
    single-device fleet is printed against the JAX mesh test's rtol 1e-4
    / atol 1e-5: a vmap of four tasks rounds its float32 products in
    other orders than one of two (larger GEMMs), and Adam's first step,
    g / (|g| + eps), carries that rounding at noise-level gradients into
    the later losses.  Returns kernel 1's launches over the mesh runs."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.backbones import lm_backbone
    from repro_torch.launch.mesh import make_debug_mesh

    P = PERSONALISE
    cfg32 = dataclasses.replace(session.backbone.cfg, dtype="float32")
    bb = session.backbone
    s32 = api.TinyTrainSession(
        lm_backbone(cfg32, tokens_per_batch=ADAPT["batch_size"] * ADAPT["seq"],
                    batch_size=ADAPT["batch_size"]),
        max_way=ADAPT["max_way"], seed=0)
    helper = Personaliser(session, one_engine, pol, seq=P["seq"])
    helper.observe(one_reqs)
    rng = np.random.default_rng(10)
    tasks = [api.Task.from_episode(helper._episode(u), rng, s32.max_way,
                                   name=f"user{u}")
             for u in range(P["users"])]
    # f32 activations are twice bf16's: twice the memory envelope keeps
    # phase 6's selection
    prof32 = profile.scaled(mem=2)
    mesh = make_debug_mesh(MESH_POSITIONS, devices=[dev] * MESH_POSITIONS)
    runs, counts, reports = {}, {}, {}
    for name, kw in (("single", {}), ("mesh", dict(mesh=mesh)),
                     ("hosts=2", dict(mesh=mesh, hosts=2))):
        sync(dev)
        ops.fisher_tapgrads.launches = ops.fisher.launches = 0
        t0 = time.perf_counter()
        runs[name] = s32.adapt_many(tasks, prof32, iters=P["iters"], **kw)
        sync(dev)
        counts[name] = ops.fisher_tapgrads.launches + ops.fisher.launches
        reports[name] = dict(s32.last_fleet_report)
        print(f"[mesh] qwen2-1.5b f32 adapt_many of {len(tasks)} users' "
              f"episodes ({tasks[0].support['tokens'].shape[0]} support "
              f"rows of {P['seq']} tokens), {name}: "
              f"{time.perf_counter() - t0:.3f} s, mesh_axes "
              f"{reports[name]['mesh_axes']}, hosts {reports[name]['hosts']}"
              f", ingestion {reports[name]['ingestion']}, Fisher launches "
              f"{counts[name]}; losses "
              f"{[round(x, 6) for x in runs[name][0].losses]} (user 0)",
              flush=True)
    # the single-device fleet of each shard's tasks (the mesh's shards
    # take contiguous blocks of the task axis)
    per = len(tasks) // MESH_POSITIONS
    runs["shards"] = [a for k in range(MESH_POSITIONS) for a in
                      s32.adapt_many(tasks[k * per:(k + 1) * per], prof32,
                                     iters=P["iters"])]

    def same(a, b):
        return a.policy.units == b.policy.units and a.losses == b.losses \
            and all(torch.equal(x, y) for x, y in zip(
                tree_leaves(a.deltas), tree_leaves(b.deltas)))

    tap_groups = sum(len(g) for g in bb.make_taps(1, "cpu").values())
    shape_groups = reports["single"]["buckets"]
    pols = {n: [a.policy.units for a in r] for n, r in runs.items()}
    gaps = [float(np.max(np.abs(np.asarray(m.losses) - np.asarray(s.losses))
                         / (1e-5 + 1e-4 * np.abs(np.asarray(s.losses)))))
            for m, s in zip(runs["mesh"], runs["single"])]
    shard_bits = all(same(m, s) for m, s in zip(runs["mesh"],
                                                 runs["shards"]))
    bits = all(same(m, h) for m, h in zip(runs["mesh"], runs["hosts=2"]))
    print(f"[mesh] policies: {[a.policy.describe() for a in runs['single']]}"
          f"; mesh and hosts=2 equal to single: "
          f"{pols['mesh'] == pols['single']} / "
          f"{pols['hosts=2'] == pols['single']}; mesh bit for bit with the "
          f"single-device fleets of its shards' tasks: {shard_bits}; "
          f"hosts=2 bit for bit with the global mesh: {bits}; mesh losses "
          f"against the four-task single-device fleet, largest |gap| / "
          f"(1e-5 + 1e-4 |want|) by user {[round(g, 4) for g in gaps]} "
          f"(printed: the vmap of four tasks rounds otherwise)", flush=True)
    if not all(a.policy.n_units for a in runs["single"]):
        fail("the f32 fleet selected no unit for a user")
    if pols["mesh"] != pols["single"] or pols["hosts=2"] != pols["single"]:
        fail("the mesh fleet's policies differ from the single-device run's")
    if not shard_bits:
        fail("a mesh shard differs from the single-device fleet of its tasks")
    if not bits:
        fail("hosts=2 differs from the global mesh")
    if not all(math.isfinite(x) for a in runs["mesh"] for x in a.losses):
        fail("the mesh fleet's losses are not finite")
    want = tap_groups * shape_groups
    if counts["single"] != want or any(
            counts[n] != MESH_POSITIONS * want for n in ("mesh", "hosts=2")):
        fail(f"Fisher launches {counts}: not {want} on one device and "
             f"{MESH_POSITIONS * want} over {MESH_POSITIONS} shards")
    if reports["mesh"]["mesh_axes"] != {"data": MESH_POSITIONS, "model": 1} \
            or reports["hosts=2"]["ingestion"] != "per-host":
        fail(f"mesh reports {reports}")
    del s32
    return counts["mesh"] + counts["hosts=2"]


def phase21(dev, gen, pol, profile) -> dict:
    """Phase 21, block scoring and the fleet, on qwen2-1.5b's published
    width in bf16 with phase 5's weights unless named: (a) ``score_stream``
    and kernel 2 at its block of 32; (b) the router's replicas; (c) the
    personalised fleet (the refresh as payload bytes); (d) the mesh fleet.
    ``pol`` and ``profile`` are phase 6's policy and profile.  Returns the
    launches of the main paths by kernel, the largest kernel error and the
    Sq-32 kernel record."""
    import torch

    from repro_torch import api, configs
    from repro_torch.core import adapt as telemetry
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.kernels.ref import flash_attention_cached_ref
    from repro_torch.models import transformer as T
    from repro_torch.serving import (
        FleetRouter, Personaliser, Request, ServeEngine,
    )
    from repro_torch.utils import tree_leaves, tree_map

    t0 = time.perf_counter()
    times = {}
    rec = score_kernel(ops, flash_attention, flash_attention_cached_ref, dev,
                       gen)
    bb = api.backbone("qwen2-1.5b", preset="full",
                      batch_size=ADAPT["batch_size"], seq=ADAPT["seq"])
    session = api.TinyTrainSession(bb, max_way=ADAPT["max_way"], seed=0)
    launches = {"score": score_full(api, ops, T, telemetry, tree_map,
                                    session, dev)}
    times["(a)"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    launches.update(fleet_serves(configs, ops, T, FleetRouter, ServeEngine,
                                 Request, tree_map, session.params, bb.cfg,
                                 dev))
    times["(b)"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    gq, fc, one_reqs, one = personalised_fleet(
        api, ops, FleetRouter, ServeEngine, Personaliser, Request,
        tree_leaves, session, pol, profile, dev)
    launches["grad_quant"] = gq
    launches["flash_cached"] += fc
    times["(c)"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    launches["fisher_tasks"] = mesh_fleet(api, ops, Personaliser, tree_leaves,
                                          session, pol, profile, one_reqs,
                                          one, dev)
    times["(d)"] = time.perf_counter() - t1
    del session, one
    torch.cuda.empty_cache()
    print(f"[phase21] {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
          + f"); main-path launches {launches}", flush=True)
    return {"launches": launches, "score_kernel": rec}


def recorded(Trainer, rec: dict):
    """``Trainer`` recording into ``rec`` each step's wall (up to the loss
    on the host, which the trainer reads next), each save's and the
    restore's seconds, and the trainer and the final state of its run."""
    rec.update(step_s=[], save_s=[], restore_s=[])

    class Recorded(Trainer):
        def __init__(self, cfg, step_fn, loader, **kw):
            def timed(ts, batch):
                t0 = time.perf_counter()
                out = step_fn(ts, batch)
                float(out[1])
                rec["step_s"].append(time.perf_counter() - t0)
                return out

            super().__init__(cfg, timed, loader, **kw)

        def _save(self, state):
            t0 = time.perf_counter()
            super()._save(state)
            rec["save_s"].append(time.perf_counter() - t0)

        def _try_restore(self, init_state):
            import torch

            t0 = time.perf_counter()
            out = super()._try_restore(init_state)
            torch.cuda.synchronize()
            rec["restore_s"].append(time.perf_counter() - t0)
            return out

        def run(self, init_state):
            rec["trainer"] = self
            rec["state"] = super().run(init_state)
            return rec["state"]

    return Recorded


def dir_bytes(path: str) -> int:
    """Bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def same_leaves(got, want, what: str) -> int:
    """Fails unless the two trees are bit-equal leaf by leaf, naming the
    leaves that part (in the checkpoints' order); returns the leaf
    count."""
    import torch

    from repro_torch.checkpoint.manager import _flatten

    (g, gdef), (w, wdef) = _flatten(got), _flatten(want)
    if gdef != wdef:
        fail(f"{what}: the trees' structures differ")
    bad = [(i, (a.float() - b.float()).abs().max().item())
           for i, (a, b) in enumerate(zip(g, w))
           if a.dtype != b.dtype or not torch.equal(a, b)]
    if bad:
        fail(f"{what}: {len(bad)} of {len(g)} leaves differ (leaf, largest "
             f"difference): {bad[:8]}")
    return len(g)


def finished(rec, steps: int, what: str) -> None:
    """Fails unless the recorded run reached ``steps`` with finite losses
    and no skipped step."""
    st, losses = rec["state"], rec["trainer"].losses
    if (st.step != steps or st.skipped
            or not all(math.isfinite(x) for x in losses)):
        fail(f"{what}: reached step {st.step} of {steps}, {st.skipped} "
             f"skipped, losses {losses}")


def train_main(train_mod, Trainer, argv, rec) -> None:
    """``launch.train.main(argv)`` in-process with a recording Trainer."""
    from unittest import mock

    with mock.patch.object(train_mod, "Trainer", recorded(Trainer, rec)):
        train_mod.main(argv)


def train_example(ops, train_mod, rt, tree_leaves, root, budget,
                  need_units: bool) -> None:
    """Phase 22 (a): ``launch.train`` with distributed_finetune.py's
    arguments at qwen2-1.5b's published config, in bf16, under the
    ``budget`` flags; ``need_units`` fails a policy that selects
    nothing."""
    rec, d = {}, os.path.join(root, "a" + budget[1])
    n = int(TRAIN_EXAMPLE[1])
    kernel_launches(ops, zero=True)
    train_main(train_mod, rt.Trainer, [
        "--arch", "qwen2-1.5b", "--preset", "full", *TRAIN_EXAMPLE, *budget,
        "--ckpt-dir", d], rec)
    counts = {k: v for k, v in kernel_launches(ops).items() if v}
    finished(rec, n, "train (a)")
    n_delta = sum(t.numel() for t in tree_leaves(rec["state"].train_state[0]))
    if need_units and not n_delta:
        fail(f"train (a) {' '.join(budget)}: the policy selected nothing")
    steps, losses = rec["step_s"], rec["trainer"].losses
    warm = sorted(steps[1:])
    step_dir = os.path.join(d, f"step_{n}")
    print(f"[train] (a) qwen2-1.5b tinytrain {' '.join(budget)}: {n} steps;"
          f" first {steps[0] * 1e3:.2f} ms, warm "
          f"{statistics.median(warm) * 1e3:.3f} ms a step (median of "
          f"{len(warm)}, {warm[0] * 1e3:.3f} .. {warm[-1] * 1e3:.3f}); loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; {n_delta} delta parameters;"
          " saves " + ", ".join(f"{x:.4f}" for x in rec["save_s"])
          + f" s; step_{n} {dir_bytes(step_dir)} B on disk; kernel launches "
          f"{counts or 'none'}", flush=True)


def train_fault(api, configs, T, train_mod, rt, TokenLoader, dev,
                root) -> None:
    """Phase 22 (b): the launcher's sparse pieces under ``Trainer`` at
    qwen2-1.5b's published config: a failure injected at step 9, the
    restart from the step-8 checkpoint (probe and policy anew, as the
    launcher restarts), and an uninterrupted run; the restarted deltas
    and Adam state bit-equal to the uninterrupted run's."""
    import torch

    F = TRAIN_FAULT
    cfg = configs.get_config("qwen2-1.5b")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    bb = api.backbone("qwen2-1.5b", preset="full", batch_size=TRAIN_BATCH,
                      seq=TRAIN_SEQ)
    profile = api.DeviceProfile(**TRAIN_PROFILE)

    def run(d, hook=None):
        rec = {}
        loader = TokenLoader(cfg.vocab, global_batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ, seed=0)
        step_fn, init, rec["policy"], _ = train_mod.sparse_training(
            bb, params, loader, profile,
            train_mod.train_optimizer(TRAIN_LR, F["steps"]), dev,
            n_samples=TRAIN_BATCH)
        tc = rt.TrainerConfig(total_steps=F["steps"],
                              ckpt_every=F["ckpt_every"], ckpt_dir=d)
        recorded(rt.Trainer, rec)(tc, step_fn, loader, failure_hook=hook,
                                  log_fn=lambda s: None).run(init)
        return rec

    d = os.path.join(root, "b")
    try:
        run(d, rt.failure_at(F["fail_at"]))
        fail("train (b): the injected failure did not fire")
    except rt.SimulatedFailure:
        pass
    restarted = run(d)
    whole = run(os.path.join(root, "b-whole"))
    for rec, what in ((restarted, "restarted"), (whole, "uninterrupted")):
        finished(rec, F["steps"], f"train (b), {what}")
    if (restarted["policy"].horizon, restarted["policy"].units) != (
            whole["policy"].horizon, whole["policy"].units):
        fail("train (b): the restart's probe chose another policy")
    resumed = F["fail_at"] // F["ckpt_every"] * F["ckpt_every"]
    if restarted["trainer"].losses != whole["trainer"].losses[resumed:]:
        print(f"[train] (b) losses after the restart "
              f"{restarted['trainer'].losses}, uninterrupted "
              f"{whole['trainer'].losses}", flush=True)
    n = same_leaves(restarted["state"].train_state,
                    whole["state"].train_state,
                    "train (b), restart against the uninterrupted run")
    if restarted["trainer"].losses != whole["trainer"].losses[resumed:]:
        fail("train (b): the losses after the restart differ")
    print(f"[train] (b) qwen2-1.5b fault path: failure at step "
          f"{F['fail_at']}, restart from step_{resumed} (restore "
          f"{restarted['restore_s'][0]:.4f} s): {n} leaves (deltas, Adam m "
          f"and v, the step) bit-equal to the uninterrupted run's after "
          f"{F['steps']} steps, and the losses after the restart",
          flush=True)


def train_full(configs, train_mod, rt, CheckpointManager, tree_leaves, dev,
               root) -> None:
    """Phase 22 (c): ``launch.train --mode full`` at qwen2-1.5b's published
    width, its depth cut to TRAIN_FULL["layers"], a few steps and one final
    save; the peak memory, the checkpoint's bytes and a restore bit-equal
    to the saved state."""
    import dataclasses

    import torch

    from unittest import mock

    C, rec, d = TRAIN_FULL, {}, os.path.join(root, "c")
    cut = dataclasses.replace(configs.get_config("qwen2-1.5b"),
                              n_layers=C["layers"])
    whole = configs.preset_config

    def preset_config(arch, preset="smoke"):
        if (arch, preset) == ("qwen2-1.5b", "full"):
            return cut
        return whole(arch, preset)

    base = peak_reset(dev)
    with mock.patch.object(configs, "preset_config", preset_config):
        train_main(train_mod, rt.Trainer, [
            "--arch", "qwen2-1.5b", "--preset", "full", "--mode", "full",
            "--steps", str(C["steps"]), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--ckpt-every", str(10 ** 6),
            "--ckpt-dir", d], rec)
    peak = peak_bytes(dev)
    finished(rec, C["steps"], "train (c)")
    if len(rec["save_s"]) != 1:
        fail(f"train (c): {len(rec['save_s'])} saves, not one")
    state = rec["state"].train_state
    t0 = time.perf_counter()
    back, _ = CheckpointManager(d).restore(C["steps"], state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    n = same_leaves(back, state, "train (c), restore against the saved state")
    leaves = tree_leaves(state[0])
    step_dir = os.path.join(d, f"step_{C['steps']}")
    print(f"[train] (c) qwen2-1.5b --mode full at {C['layers']} of 28 "
          f"layers ({sum(t.numel() for t in leaves)} parameters, "
          f"{leaves[0].dtype}): {C['steps']} steps, "
          "losses " + ", ".join(f"{x:.4f}" for x in rec["trainer"].losses)
          + f"; peak {peak} B above the {base} B held before "
          f"(torch.cuda.max_memory_allocated); save {rec['save_s'][0]:.3f} "
          f"s, step_{C['steps']} {dir_bytes(step_dir)} B on disk; restore "
          f"{restore_s:.3f} s (a warm read), {n} leaves bit-equal",
          flush=True)


def train_ssd(ops, train_mod, rt, tree_leaves, root) -> dict:
    """Phase 22 (d): ``launch.train`` on mamba2-1.3b's published config in
    bf16 (tinytrain): every forward through kernel 5, every backward
    through 5b.  Returns their launches."""
    rec = {}
    kernel_launches(ops, zero=True)
    train_main(train_mod, rt.Trainer, [
        "--arch", "mamba2-1.3b", "--preset", "full", "--mode", "tinytrain",
        "--steps", str(TRAIN_SSD_STEPS), "--batch", str(TRAIN_BATCH),
        "--seq", str(TRAIN_SEQ), *TRAIN_WIDE,
        "--ckpt-dir", os.path.join(root, "d")], rec)
    counts = kernel_launches(ops)
    finished(rec, TRAIN_SSD_STEPS, "train (d)")
    fwd = counts["ssd_scan.launches"]
    bwd = counts["ssd_scan.bwd_launches"]
    if fwd <= 0 or bwd <= 0:
        fail(f"train (d): kernel 5 launched {fwd} times, 5b {bwd}")
    others = {k: v for k, v in counts.items() if v and "ssd_scan" not in k}
    warm = sorted(rec["step_s"][1:])
    n_delta = sum(t.numel() for t in tree_leaves(rec["state"].train_state[0]))
    print(f"[train] (d) mamba2-1.3b tinytrain: {TRAIN_SSD_STEPS} steps, "
          f"warm {statistics.median(warm) * 1e3:.3f} ms a step; loss "
          f"{rec['trainer'].losses[0]:.4f} -> {rec['trainer'].losses[-1]:.4f};"
          f" {n_delta} delta parameters; kernel 5 {fwd} launches, 5b {bwd} "
          f"(probe and steps); other kernels {others or 'none'}", flush=True)
    return {"ssd_scan": fwd, "ssd_scan_bwd": bwd}


def train_card_vs_cpu(api, configs, T, train_mod, rt, TokenLoader,
                      tree_map, dev, root) -> None:
    """Phase 22 (e): qwen2-smoke in f32 (TF32 off), the weights drawn once
    on the CPU and copied to the card, through the launcher's pieces
    (``plan_sparse_update``, ``make_sparse_train_step`` under its Adam
    and schedule, ``Trainer``): the same policy, losses within
    TRAIN_LOSS_TOL of max(1, |CPU's|)."""
    import torch

    S = TRAIN_SMOKE
    cfg = configs.get_reduced("qwen2-1.5b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    runs = []
    for i, d in enumerate((torch.device("cpu"), dev)):
        loader = TokenLoader(cfg.vocab, global_batch=S["batch"],
                             seq=S["seq"], seed=0)
        bb = api.backbone("qwen2-1.5b", preset="smoke",
                          batch_size=S["batch"], seq=S["seq"])
        step_fn, init, policy, _ = train_mod.sparse_training(
            bb, tree_map(lambda t: t.to(d), params), loader,
            api.DeviceProfile(**TRAIN_SMOKE_PROFILE),
            train_mod.train_optimizer(TRAIN_LR, S["steps"]), d,
            n_samples=S["batch"])
        tc = rt.TrainerConfig(total_steps=S["steps"],
                              ckpt_every=S["ckpt_every"],
                              ckpt_dir=os.path.join(root, f"e{i}"))
        tr = rt.Trainer(tc, step_fn, loader, log_fn=lambda s: None)
        tr.run(init)
        runs.append((policy, tr.losses))
    (pc, lc), (pg, lg) = runs
    if (pc.horizon, pc.units) != (pg.horizon, pg.units):
        fail(f"train (e): card policy {pg.describe()} against the CPU's "
             f"{pc.describe()}")
    gap = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(lg, lc))
    print(f"[train] (e) qwen2-smoke f32 card against CPU: policy "
          f"{pc.describe()} on both; {len(lc)} losses, largest gap {gap:.3g}"
          f" of max(1, |CPU's|) (gate {TRAIN_LOSS_TOL:g})", flush=True)
    if len(lg) != len(lc) or gap > TRAIN_LOSS_TOL:
        fail(f"train (e): losses {lg} on the card against {lc}")


def phase22(dev) -> dict:
    """Phase 22, the training launcher (``launch.train``, ``runtime.Trainer``,
    ``checkpoint``) on one card: (a) distributed_finetune.py's run on
    qwen2-1.5b, under its own and under phase 6's envelope, (b) its
    fault path, (c) ``--mode full`` at 2 layers, (d)
    mamba2-1.3b through kernels 5 and 5b, (e) qwen2-smoke card against
    CPU.  Checkpoints go to a temporary directory, removed at the end.
    Returns the launches of kernels 5 and 5b on (d)'s path."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch import api, configs, runtime as rt
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import TokenLoader
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree_leaves, tree_map

    t0 = time.perf_counter()
    times = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        parts = (
            ("(a)", lambda: train_example(ops, train_mod, rt, tree_leaves,
                                          root, TRAIN_BUDGET, False)),
            ("(a) wide", lambda: train_example(ops, train_mod, rt,
                                               tree_leaves, root, TRAIN_WIDE,
                                               True)),
            ("(b)", lambda: train_fault(api, configs, T, train_mod, rt,
                                        TokenLoader, dev, root)),
            ("(c)", lambda: train_full(configs, train_mod, rt,
                                       CheckpointManager, tree_leaves, dev,
                                       root)),
            ("(d)", lambda: train_ssd(ops, train_mod, rt, tree_leaves,
                                      root)),
            ("(e)", lambda: train_card_vs_cpu(api, configs, T, train_mod,
                                              rt, TokenLoader, tree_map,
                                              dev, root)))
        out = {}
        for name, part in parts:
            t1 = time.perf_counter()
            out[name] = part()
            gc.collect()  # a recorded run's trainer and rec form a cycle
            torch.cuda.empty_cache()
            times[name] = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = out["(d)"]
    print(f"[phase22] {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
          + f"); main-path launches {launches}", flush=True)
    return launches


def plan_step(kind: str, dev, gen):
    """(fn, args) of phase 23 (c)'s ``kind`` step on qwen2-1.5b's published
    config: ``launch.dryrun``'s step builders on tensors on ``dev`` (random
    weights and tokens from ``gen``; on the meta device, with no
    generator, shapes only).  The decode step attends to a cache holding
    seq - 1 rows and writes the last."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.core.backbones import lm_backbone
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T

    cfg = configs.get_config(PLAN_ARCH)
    if kind == "prefill":
        cfg = dataclasses.replace(cfg, n_layers=PLAN_PREFILL_LAYERS)
    b, s = PLAN_STEPS[kind]
    params = T.init_params(cfg, gen, device=dev)

    def tokens(*shape):
        if gen is None:
            return torch.empty(shape, dtype=torch.int32, device=dev)
        return torch.randint(0, cfg.vocab, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    if kind == "train":
        pol = dryrun.dryrun_policy(cfg)
        deltas = lm_backbone(cfg, tokens_per_batch=1,
                             batch_size=1).init_deltas(pol, dev)
        step, opt = dryrun.build_train_step(cfg, pol)
        return step, (params, deltas, opt.init(deltas),
                      {"tokens": tokens(b, s), "labels": tokens(b, s)})
    if kind == "prefill":
        return dryrun.build_prefill_step(cfg), (params,
                                                {"tokens": tokens(b, s)})
    caches = T.init_caches(cfg, b, s, device=dev)
    for g in caches.values():
        g["attn"]["len"].fill_(s - 1)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    return dryrun.build_decode_step(cfg), (params, {"tokens": tokens(b, 1)},
                                           caches, pos)


def plan_worker(src: str, out: str, cells, steps) -> None:
    """A planner process of phase 23 (no card): the dry-run ``cells``
    (arch, shape, multi_pod) on the meta device, each record to
    ``out/<tag>.json`` and its op table to ``out/ops`` (a failed cell
    recorded with its error, as ``launch.dryrun.main`` does), then the
    meta counts of (c)'s ``steps`` to ``out/steps.json``."""
    import traceback

    sys.path.insert(0, src)
    import torch

    torch.set_num_threads(1)
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import analyse_ops

    os.makedirs(os.path.join(out, "ops"), exist_ok=True)
    counts = {}
    for arch, shape, mp in cells:
        tag = dryrun.cell_tag(arch, shape, mp)
        try:
            rec = dryrun.run_cell(arch, shape, multi_pod=mp, verbose=False,
                                  ops_path=os.path.join(out, "ops",
                                                        tag + ".json.gz"),
                                  counts=counts)
        except Exception as e:  # recorded; phase 23 fails on it
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        with open(os.path.join(out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=2, default=str)
    if steps:
        res = {}
        for kind in steps:
            t0 = time.perf_counter()
            fn, args = plan_step(kind, torch.device("meta"), None)
            res[kind] = {"flops": analyse_ops(fn, *args)["flops"],
                         "count_s": time.perf_counter() - t0}
        with open(os.path.join(out, "steps.json"), "w") as f:
            json.dump(res, f)


def plan_start(src: str):
    """Starts phase 23's planner processes (spawned, daemonic: an exit
    that skips phase 23 ends them): (a)'s cells but the 32k prefill, the
    32k prefill, and (c)'s meta counts, each in its own process on a core
    of its own.  Returns (the processes, their output directory)."""
    import multiprocessing
    import tempfile

    from repro_torch import configs

    out = tempfile.mkdtemp(prefix="chip_smoke_plan_")
    cells = [(a, s, False) for a in configs.lm_arch_ids()
             for s in PLAN_SHAPES]
    work = ((cells + [PLAN_EXTRA[1]], ()), ([PLAN_EXTRA[0]], ()),
            ([], tuple(PLAN_STEPS)))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=plan_worker, args=(src, out, c, st),
                         daemon=True) for c, st in work]
    for p in procs:
        p.start()
    return procs, out


def plan_profile(fn, args):
    """One run of ``fn(*args)`` under ``torch.profiler`` (CPU and CUDA,
    ``with_flops``): (the profiler's FLOPs, the device's busy seconds (the
    union of its activities), the traced window's seconds, the device
    activities).  Reads the raw Kineto events: ``key_averages`` takes
    minutes over a million of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        fn(*args)
        torch.cuda.synchronize()
    evs = prof.profiler.kineto_results.events()
    flops = sum(e.flops() for e in evs)
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in evs
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    t0 = min(e.start_ns() for e in evs)
    t1 = max(e.start_ns() + e.duration_ns() for e in evs)
    busy, end = 0, 0
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return flops, busy * 1e-9, (t1 - t0) * 1e-9, len(spans)


def plan_card(ops, dev, gen, meta: dict) -> None:
    """Phase 23 (c): each of qwen2-1.5b's three steps on the card in bf16,
    its analyser count against the meta count at the same shape (equal
    FLOPs), the profiler's FLOPs, the warm wall and device busy share
    against max(t_compute, t_memory), and the peak memory's rise against
    ``peak_live_bytes``; no port kernel launched."""
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.launch.dryrun import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.op_analysis import analyse_ops

    for kind in PLAN_STEPS:
        fn, args = plan_step(kind, dev, gen)
        kernel_launches(ops, zero=True)
        got = analyse_ops(fn, *args)
        if got["flops"] != meta[kind]["flops"]:
            fail(f"phase 23 {kind}: the analyser counts {got['flops']} "
                 f"FLOPs on the card, {meta[kind]['flops']} on meta")
        walls, rises = [], []
        for _ in range(2):  # the analyser's run warmed it; time the second
            base = peak_reset(dev)
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rises.append(peak_bytes(dev, base))
        pflops, busy_s, window_s, n_dev = plan_profile(fn, args)
        busy = busy_s / max(window_s, 1e-9)
        launched = {k: v for k, v in kernel_launches(ops).items() if v}
        if launched:
            fail(f"phase 23 {kind}: port kernels launched {launched}")
        t_c = got["flops"] / PEAK_FLOPS["bfloat16"]
        t_m = got["bytes"] / HBM_BW
        wall = walls[-1]
        b, s = PLAN_STEPS[kind]
        depth = (f", {PLAN_PREFILL_LAYERS} of "
                 f"{configs.get_config(PLAN_ARCH).n_layers} layers"
                 if kind == "prefill" else "")
        print(f"[plan-card] {kind} {b} x {s}{depth}: analyser "
              f"{got['flops']:.6e} FLOPs on the card == meta (counted in "
              f"{meta[kind]['count_s']:.1f} s); profiler "
              f"{pflops:.6e} (ratio {pflops / got['flops']:.4f}); warm wall "
              f"{wall * 1e3:.2f} ms (first {walls[0] * 1e3:.2f}); traced: "
              f"device busy {busy_s * 1e3:.2f} ms of a "
              f"{window_s * 1e3:.2f} ms window ({busy:.3f}) over {n_dev} "
              f"device activities; bound "
              f"max(t_compute {t_c * 1e3:.3f}, t_memory {t_m * 1e3:.3f}) ms"
              f", achieved {max(t_c, t_m) / wall:.4f}; peak rise "
              f"{rises[-1]} B vs peak_live_bytes "
              f"{got['peak_live_bytes']:.0f} (ratio "
              f"{rises[-1] / max(got['peak_live_bytes'], 1):.4f})",
              flush=True)
        del fn, args
        gc.collect()
        torch.cuda.empty_cache()


def phase23(ops, dev, gen, planner) -> None:
    """Phase 23, the planning tools: (a) the planner processes' dry-run
    cells (every record ``ok`` or skipped exactly where ``shape_applicable``
    skips, none with an error, each count's wall), (b) ``reanalyze`` over
    them and the roofline table, (c) :func:`plan_card`, (d) ``launch.train
    --production-mesh`` on qwen2-smoke on the card."""
    import contextlib
    import glob
    import io
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.launch import reanalyze
    from repro_torch.launch import train as train_mod
    from repro_torch.models.api import SHAPES_BY_NAME, shape_applicable

    sys.path.insert(0, ROOT)
    from benchmarks_torch import roofline

    t0 = time.perf_counter()
    procs, out = planner
    try:
        # (c) runs while the planner's counts finish
        t_c = time.perf_counter()
        steps = os.path.join(out, "steps.json")
        procs[2].join(PLAN_WAIT)
        if procs[2].exitcode != 0 or not os.path.exists(steps):
            fail(f"phase 23: the meta counts of (c) ended with "
                 f"{procs[2].exitcode}")
        with open(steps) as f:
            meta = json.load(f)
        plan_card(ops, dev, gen, meta)
        t_c = time.perf_counter() - t_c

        t_a = time.perf_counter()
        for p in procs[:2]:
            p.join(max(1.0, PLAN_WAIT - (time.perf_counter() - t0)))
            if p.is_alive() or p.exitcode != 0:
                fail(f"phase 23: a planner process ended with "
                     f"{p.exitcode} (alive: {p.is_alive()})")
        t_a = time.perf_counter() - t_a
        recs = {}
        for path in sorted(glob.glob(os.path.join(out, "*__*.json"))):
            with open(path) as f:
                recs[os.path.basename(path)] = json.load(f)
        want = len(configs.lm_arch_ids()) * len(PLAN_SHAPES) + len(PLAN_EXTRA)
        if len(recs) != want:
            fail(f"phase 23 (a): {len(recs)} records of {want}")
        for tag, rec in recs.items():
            ok, _ = shape_applicable(configs.get_config(rec["arch"]),
                                     SHAPES_BY_NAME[rec["shape"]])
            if "error" in rec:
                fail(f"phase 23 (a) {tag}: {rec['error']}\n"
                     f"{rec.get('traceback', '')}")
            if ok == ("skipped" in rec) or (ok and not rec["flops_total"]):
                fail(f"phase 23 (a) {tag}: skipped {rec.get('skipped')!r} "
                     f"where shape_applicable says {ok}")
            print(f"[plan] {tag}: " + (
                f"skipped ({rec['skipped']})" if "skipped" in rec else
                f"count {rec['count_s']} s"
                f"{' (reused)' if rec.get('count_reused') else ''}, "
                f"{rec['flops_total']:.4e} FLOPs, {rec['bytes_total']:.4e} "
                f"B, peak live {rec['peak_live_bytes']:.4e} B, args "
                f"{rec['argument_size_in_bytes']} B/device, "
                f"{rec['bottleneck']}, model_flops_ratio "
                f"{rec['model_flops_ratio']:.4f}"), flush=True)

        # (b) reanalyze from the saved op tables, then the table
        n = sum(reanalyze.reanalyze(os.path.join(out, t),
                                    os.path.join(out, "ops"))
                for t in recs)
        print(f"[plan] reanalyze: {n} cells updated", flush=True)
        for mesh in ("16x16", "2x16x16"):
            for row in roofline.table(out, mesh):
                print(f"[roofline] {row}", flush=True)

        # (d) the launcher on the production mesh
        buf = io.StringIO()
        root = tempfile.mkdtemp(prefix="chip_smoke_pod_")
        try:
            with contextlib.redirect_stdout(buf):
                train_mod.main(TRAIN_POD + ["--ckpt-dir", root])
        finally:
            shutil.rmtree(root, ignore_errors=True)
        text = buf.getvalue()
        if ("mesh={'data': 16, 'model': 16}" not in text
                or "[train] done: 2 steps" not in text):
            fail(f"phase 23 (d): launch.train --production-mesh printed "
                 f"{text[-600:]!r}")
        print("[plan] (d) launch.train --production-mesh on qwen2-smoke: "
              + " | ".join(line for line in text.splitlines()
                           if "mesh=" in line or "done:" in line),
              flush=True)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
        shutil.rmtree(out, ignore_errors=True)
    print(f"[phase23] {time.perf_counter() - t0:.1f} s ((c) {t_c:.1f}, "
          f"then (a)'s wait {t_a:.1f})", flush=True)


def registry_serve(ops, dev, gen) -> tuple:
    """Phase 24 (a): a declarative spec registered over the built-in
    ``mlp`` from outside the package (through ``serving.engine``'s
    re-export), then restored: two users' deltas served per slot through
    ``ServeEngine(personalise=)`` and through each user's folded engine,
    the same streams, kernel 2 launched.  Returns (qwen2-1.5b's config,
    its params, kernel 2's launches)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
    from repro_torch.models import layers as L
    from repro_torch.models import overlay as OV
    from repro_torch.models import transformer as T
    from repro_torch.serving import DeltaSet, Request, ServeEngine
    from repro_torch.serving import engine as serving_engine

    cfg = configs.get_config("qwen2-1.5b")
    params = T.init_params(cfg, gen, device=dev)
    dt, d = T.torch_dtype(cfg), cfg.d_model
    rng = np.random.default_rng(24)
    pol = SparseUpdatePolicy(horizon=min(REG_LAYERS), units=tuple(
        SelectedUnit(lid, "mlp", tuple(int(c) for c in np.sort(rng.choice(
            cfg.d_ff, REG_CHANS, replace=False)))) for lid in REG_LAYERS))

    def randn(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                * REG_SCALE).to(dt)

    users = {u: {f"L{lid}": {"mlp": {"w_up": randn(d, REG_CHANS),
                                      "w_down": randn(REG_CHANS, d)}}
                 for lid in REG_LAYERS} for u in (0, 1)}

    def zero_pack(cfg_, lid, k, dtype, device):
        return {"w_up": torch.zeros((cfg_.d_model, k), dtype=dtype,
                                    device=device),
                "w_down": torch.zeros((k, cfg_.d_model), dtype=dtype,
                                      device=device)}

    def requests():
        r = np.random.default_rng(0)
        return [Request(uid=i % 2, prompt=r.integers(
            0, cfg.vocab, int(n)).astype(np.int32), max_new=16)
            for i, n in enumerate(r.integers(32, 257, 8))]

    builtin = OV.get_overlay("mlp")
    serving_engine.register_unit_overlay(OV.UnitOverlay(
        "mlp", "mlp", (OV.Edit("w_up", "w_up", "out"),
                       OV.Edit("w_down", "w_down", "in")),
        delta_init=zero_pack))
    try:
        kernel_launches(ops, zero=True)
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, params, personalise=pol, device=dev,
                          **REG_ENGINE)
        arena = sorted(eng._delta_tmpl[REG_LAYERS[0]]["mlp"][0])
        for u, dd in users.items():
            eng.swap_deltas(u, DeltaSet.from_policy(pol, dd))
        eng.tick_sync_debug = "error"
        reqs = requests()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = eng.last_run_report
        got = streams_of(reqs)
        del eng
        folded = {}
        for u, dd in users.items():
            fe = ServeEngine(cfg, OV.fold_deltas(cfg, params, dd, pol),
                             device=dev, **REG_ENGINE)
            folded[u] = streams_of(fe.run(requests()))
            del fe
        launches = ops.flash_attention_cached.launches
        oracle = [folded[i % 2][i] for i in range(len(reqs))]
        base = streams_of(ServeEngine(cfg, params, device=dev,
                                      **REG_ENGINE).run(requests()))
    finally:
        OV.register_unit_overlay(builtin)
    torch.cuda.empty_cache()
    # why a slot's rows come from the whole block's product: a batched
    # product reduces in another order than a folded copy's x @ W
    probe = []
    slots = REG_ENGINE["slots"]
    for name in ("w_up", "w_down"):
        w = params["stacks"]["g0"]["mlp"][name][REG_LAYERS[0]]
        stk = w.expand(slots, *w.shape).contiguous()
        for rows in (1, 8):  # a decode tick's rows a slot, a block's
            x = torch.randn((slots, rows, w.shape[0]), generator=gen,
                            device=dev).to(dt)
            ref = x.reshape(-1, w.shape[0]) @ w
            bat = torch.bmm(x, stk).reshape(ref.shape)
            port = L.bmm(x, stk).reshape(ref.shape)
            probe.append((name, rows, (bat.float() - ref.float()).abs().max()
                          .item(), torch.equal(port, ref)))
    same = got == oracle
    print(f"[registry] (a) per-slot products at {slots} slots against the "
          f"shared x @ W: " + "; ".join(
              f"{n} {r} row(s) a slot: torch.bmm max |diff| {e:.4g}, "
              f"layers.bmm {'bit-equal' if q else 'DIFFERS'}"
              for n, r, e, q in probe), flush=True)
    if not all(q for *_, q in probe):
        fail("phase 24 (a): layers.bmm's per-slot product is not the "
             "shared product's")
    print(f"[registry] (a) qwen2-1.5b bf16 published width: a spec "
          f"registered over the built-in mlp (edits w_up, w_down; the "
          f"arena's packs {arena}), {pol.describe()}, two users: "
          f"{len(reqs)} requests, {sum(len(o) for o, _ in got)} new tokens "
          f"per slot in {wall:.3f} s ({rep['ticks']} ticks, "
          f"{rep['host_syncs']} host syncs for {rep['chunks']} chunks); "
          f"per-slot vs folded engines "
          f"{'identical' if same else 'DIFFERENT'}, base "
          f"{'differs' if base != got else 'EQUAL'}; flash_cached launches "
          f"{launches}; the built-in mlp restored "
          f"({OV.get_overlay('mlp') is builtin})", flush=True)
    one_sync_a_chunk(rep, "phase 24 (a)")
    if arena != ["w_down", "w_up"]:
        fail(f"phase 24 (a): the arena's packs {arena} are not the "
             "registered spec's")
    if not all(o == "done" for _, o in got):
        fail(f"phase 24 (a): requests not done: {got}")
    if not same:
        fail(f"phase 24 (a): per-slot streams {got} differ from the folded "
             f"engines' {oracle}")
    if base == got:
        fail("phase 24 (a): the deltas changed no stream")
    if launches <= 0 or launches % cfg.n_layers:
        fail(f"phase 24 (a): flash_cached launched {launches} times")
    if OV.get_overlay("mlp") is not builtin:
        fail("phase 24 (a): the built-in mlp spec was not restored")
    return cfg, params, launches


def registry_raw(cfg, params, dev) -> None:
    """Phase 24 (b): a raw folder (``register_unit_folder``) folds one
    layer's ``w_down`` rows on the card bit for bit as on the CPU, and
    ``ServeEngine(personalise=)`` refuses it."""
    import dataclasses

    import torch

    from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
    from repro_torch.models import overlay as OV
    from repro_torch.serving import ServeEngine
    from repro_torch.serving import engine as serving_engine

    @serving_engine.register_unit_folder("mlp_rows")
    def fold_rows(cfg_, stack, j, dd, idx):
        w = stack["mlp"]["w_down"].clone()
        w[j, torch.as_tensor(idx, device=w.device).long(), :] += dd["w"].to(
            w.dtype)
        stack["mlp"]["w_down"] = w

    one = dataclasses.replace(cfg, n_layers=1)
    chans = tuple(range(0, cfg.d_ff, cfg.d_ff // 64))
    pol = SparseUpdatePolicy(horizon=0, units=(
        SelectedUnit(0, "mlp_rows", chans),))
    gen = torch.Generator(device=dev).manual_seed(24)
    dw = (torch.randn((len(chans), cfg.d_model), generator=gen, device=dev)
          * REG_SCALE).to(params["embed"].dtype)
    w = params["stacks"]["g0"]["mlp"]["w_down"][:1]
    card, host = (OV.fold_deltas(
        one, {"stacks": {"g0": {"mlp": {"w_down": w.to(where)}}}},
        {"L0": {"mlp_rows": {"w": dw.to(where)}}},
        pol)["stacks"]["g0"]["mlp"]["w_down"]
        for where in (dev, torch.device("cpu")))
    same = torch.equal(card.cpu(), host)
    moved = int((host != w.cpu()).sum())
    try:
        ServeEngine(cfg, params, personalise=pol, device=dev, **REG_ENGINE)
        refused = None
    except ValueError as e:
        refused = str(e)
    finally:
        OV._UNIT_OVERLAYS.pop("mlp_rows")  # the phase's kind, unregistered
    print(f"[registry] (b) a raw folder of {len(chans)} w_down rows of "
          f"qwen2-1.5b's layer 0 ({moved} elements changed): card "
          f"{'bit-equal to' if same else 'DIFFERS FROM'} the CPU; "
          f"ServeEngine(personalise=) refused it: {refused!r}", flush=True)
    if not same or not moved:
        fail("phase 24 (b): the raw folder's card fold is not the CPU's")
    if refused is None or "no per-slot overlay" not in refused:
        fail(f"phase 24 (b): the engine did not refuse a raw folder "
             f"({refused!r})")


def capped_decode(dev, gen) -> None:
    """Phase 24 (c): mixtral-8x7b at its published width (CAPPED's depth):
    one decode step of 8 slots with the capped expert queues
    (``drop_free=False``, the dry run's) against the drop-free one, the
    dropped assignments counted, rows with none dropped equal to bf16
    rounding; ``op_analysis``'s FLOPs of ``dryrun.build_decode_step`` on
    the card equal to its count on the meta device."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import analyse_ops
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree_map

    cfg = dataclasses.replace(configs.get_config("mixtral-8x7b"),
                              n_layers=CAPPED["layers"])
    b, s, max_len = CAPPED["slots"], CAPPED["prompt"], CAPPED["max_len"]
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device=dev)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    tok = torch.randint(0, cfg.vocab, (b, 1), generator=gen, device=dev)
    pos = torch.full((b,), s, dtype=torch.int32, device=dev)
    caches = T.init_caches(cfg, b, max_len, device=dev)
    with torch.no_grad():
        T.prefill_block(cfg, params, prompt, caches,
                        torch.zeros((b,), dtype=torch.int32, device=dev))
    keeps = []
    real = L._queue_slots

    def spy(sel, e, cap):
        out = real(sel, e, cap)
        keeps.append((cap, out[1].reshape(b, -1)))
        return out

    L._queue_slots = spy
    try:
        with torch.no_grad():
            capped, _ = T.decode_step(cfg, params, tok, tree_map(
                lambda t: t.clone(), caches), pos, drop_free=False)
    finally:
        L._queue_slots = real
    with torch.no_grad():
        free, _ = T.decode_step(cfg, params, tok, tree_map(
            lambda t: t.clone(), caches), pos, drop_free=True)
    dropped = sum(int((~k).sum()) for _, k in keeps)
    hit = torch.zeros(b, dtype=torch.bool, device=dev)
    for _, k in keeps:
        hit |= ~k.all(dim=1)
    ok = ~hit
    gap = ((capped[ok].float() - free[ok].float()).abs().max().item()
           if ok.any() else 0.0)
    caps = sorted({c for c, _ in keeps})
    step = dryrun.build_decode_step(cfg)
    card = analyse_ops(step, params, {"tokens": tok}, caches, pos)
    meta = analyse_ops(step, T.init_params(cfg, None, device="meta"),
                       {"tokens": torch.empty((b, 1), dtype=tok.dtype,
                                              device="meta")},
                       T.init_caches(cfg, b, max_len, device="meta"),
                       torch.empty((b,), dtype=torch.int32, device="meta"))
    print(f"[capped] (c) mixtral-8x7b bf16 published width, "
          f"{cfg.n_layers} of {configs.get_config('mixtral-8x7b').n_layers}"
          f" layers, decode of {b} slots after a {s}-token prefill: capped "
          f"queues of {caps} slots over {len(keeps)} MoE layers dropped "
          f"{dropped} of {sum(k.numel() for _, k in keeps)} assignments "
          f"(slots hit {int(hit.sum())}); rows with none dropped: max |capped"
          f" - drop-free| {gap:.6g} (max |logit| "
          f"{free.float().abs().max().item():.4g}); build_decode_step "
          f"{card['flops']:.6e} FLOPs on the card, {meta['flops']:.6e} on "
          f"meta; {time.perf_counter() - t0:.1f} s", flush=True)
    if len(keeps) != cfg.n_layers or caps != [max(4, int(
            cfg.capacity_factor * b * cfg.top_k / cfg.n_experts))]:
        fail(f"phase 24 (c): {len(keeps)} capped dispatches of {caps} slots")
    if not (torch.isfinite(capped).all() and torch.isfinite(free).all()):
        fail("phase 24 (c): non-finite logits")
    if ok.any():
        max_err(capped[ok], free[ok], TOL["bfloat16"],
                "phase 24 (c): rows with no dropped assignment",
                atol=BF16_RMS_TOL * rms(free[ok]))
    if card["flops"] != meta["flops"]:
        fail(f"phase 24 (c): the analyser counts {card['flops']} FLOPs on "
             f"the card, {meta['flops']} on meta")
    del params, caches
    torch.cuda.empty_cache()


def phase24(ops, dev, gen) -> int:
    """Phase 24, the overlay registry and the capped MoE decode:
    :func:`registry_serve`, :func:`registry_raw`, :func:`capped_decode`.
    Returns kernel 2's launches on (a)'s serves."""
    import torch

    t0 = time.perf_counter()
    cfg, params, launches = registry_serve(ops, dev, gen)
    t_a = time.perf_counter() - t0
    registry_raw(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    t_b = time.perf_counter() - t0 - t_a
    capped_decode(dev, gen)
    total = time.perf_counter() - t0
    print(f"[phase24] {total:.1f} s ((a) {t_a:.1f}, (b) {t_b:.1f}, (c) "
          f"{total - t_a - t_b:.1f})", flush=True)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no port package under {src}; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import api, configs
    from repro_torch.kernels import (
        build, flash_aligned, flash_attention, flash_paged, ops,
    )
    from repro_torch.kernels import fisher as fisher_kernel
    from repro_torch.kernels import grad_quant as gq_kernel
    from repro_torch.kernels import ssd_scan as ssd_kernel
    from repro_torch.kernels.ref import (
        fisher_ref, fisher_tapgrads_ref, flash_attention_cached_ref,
        flash_attention_paged_ref, flash_attention_ref, grad_quant_ref,
        ssd_scan_ref,
    )
    from repro_torch.core.policy import SelectedUnit, SparseUpdatePolicy
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    from repro_torch.models.overlay import fold_deltas
    from repro_torch.optim import compress
    from repro_torch.serving import (
        DeltaSet, FaultConfig, Personaliser, Request, ServeEngine,
    )
    from repro_torch.serving import prng
    from repro_torch.serving.engine import OUTCOME_NAMES
    from repro_torch.utils import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{name} | nvidia-smi: {smi}", flush=True)

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    secs = time.perf_counter() - t0
    logs = " ".join(build.BUILD_LOG[n][1] for n in built)
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", logs)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", logs))
    print(f"[build] {', '.join(build.SOURCES)} for sm_90a in {secs:.1f} s "
          f"(compiled {built or 'none: cached'}; max {max(regs, default=0)} "
          f"registers/thread, {spills} bytes of spill stores)", flush=True)

    # phase 23's planner counts on the meta device in processes of their
    # own, beside the phases below
    planner = plan_start(src)

    gen = torch.Generator(device=dev).manual_seed(0)

    # -- kernel parity and timing -------------------------------------------
    B, Sq, Hq, Hkv, D, Sk = (MAIN[k] for k in ("B", "Sq", "Hq", "Hkv", "D", "Sk"))
    qo = torch.tensor(Q_OFFSET, dtype=torch.int32, device=dev)
    kl = torch.tensor(KV_LEN, dtype=torch.int32, device=dev)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
        for window in (0, 64):
            got = ops.flash_attention_cached(q, k, v, q_offset=qo, kv_len=kl,
                                             causal=True, window=window)
            again = ops.flash_attention_cached(q, k, v, q_offset=qo,
                                               kv_len=kl, causal=True,
                                               window=window)
            want = flash_attention_cached_ref(q, k, v, q_offset=qo, kv_len=kl,
                                              causal=True, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            zero_row = got[0].float().abs().max().item()
            print(f"[parity] flash_cached {dname} window={window}: max abs "
                  f"err {err:.3g} (tol {TOL[dname]:g}); kv_len=0 row max "
                  f"{zero_row:g}; a second run "
                  f"{'bit-equal' if torch.equal(got, again) else 'DIFFERS'}",
                  flush=True)
            if not math.isfinite(err) or err > TOL[dname]:
                fail(f"flash_cached {dname} window={window} error {err}")
            bf16_gate(got, want, dname, f"flash_cached window={window}")
            if zero_row != 0.0:
                fail("a kv_len = 0 row must give 0")
            if not torch.equal(got, again):
                fail(f"flash_cached {dname} window={window}: two runs on the "
                     "same inputs differ")
            worst = max(worst, err)

    # time at the main path's shapes in bf16, cycling through one K/V
    # buffer per layer (28 x 4 MiB > the 50 MB L2) as a prefill tick does
    cfg = configs.get_config("qwen2-1.5b")
    nl = cfg.n_layers
    q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    ks = torch.randn((nl, B, Sk, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    vs = torch.randn((nl, B, Sk, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    it = {"i": 0}

    def layer():
        i = it["i"] = (it["i"] + 1) % nl
        return ks[i], vs[i]

    # the kernel is timed through its C entry so that the wrapper's Python
    # checks (host time, overlapped with the previous launch) stay out
    entry, out = flash_attention._entry(), torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def run_kernel(st=stream):
        k, v = layer()
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    qo.data_ptr(), kl.data_ptr(), B, Sq, Sk, Hq, Hkv, D, 1, 0,
                    1, st)
        if err:
            fail(f"flash_cached_fwd returned cudaError {err}")

    def run_plain():
        k, v = layer()
        flash_attention_cached_ref(q, k, v, q_offset=qo, kv_len=kl)

    pos = torch.arange(Sk, device=dev)
    qpos = qo[:, None].long() + torch.arange(Sq, device=dev)[None, :]
    mask = ((pos[None, None, :] < kl[:, None, None])
            & (pos[None, None, :] <= qpos[..., None]))[:, None]
    qt = q.transpose(1, 2)
    kts, vts = ks.transpose(2, 3), vs.transpose(2, 3)

    def run_library():
        i = it["i"] = (it["i"] + 1) % nl
        F.scaled_dot_product_attention(qt, kts[i], vts[i], attn_mask=mask,
                                       enable_gqa=True)

    ms = time_ms(run_kernel, 4 * nl)
    device_ms = graph_ms(run_kernel, 4 * nl)
    plain_ms = time_ms(run_plain, nl)
    library_ms = time_ms(run_library, 4 * nl)
    nbytes, nops = flash_work(Q_OFFSET, KV_LEN, Sq, Hq, Hkv, D, 2, 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS["bfloat16"]
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] flash_cached bf16 B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} "
          f"Sk={Sk}: kernel {ms:.4f} ms ({device_ms:.4f} ms a launch in a "
          f"CUDA graph), bound {bound_ms:.5f} ms ({bound_by}: "
          f"{nbytes} B, {nops} ops), plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms", flush=True)
    flash = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": worst}

    # -- paged flash kernel: parity at the paged serve's shapes ---------------
    # the cached kernel's cursors and rows, laid out in pages of 1, 5 and 16
    # rows over a randomly permuted arena with unmapped tails
    p_worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dtype)
        cached = ops.flash_attention_cached(q, k, v, q_offset=qo, kv_len=kl)
        for ps in (1, 5, PAGE_SIZE):
            mp = -(-Sk // ps)
            n_pages = sum(-(-n // ps) for n in KV_LEN) + 7
            table = page_table(KV_LEN, ps, mp, n_pages, gen, dev)
            shape = (n_pages, ps, Hkv, D)
            kp = fill_pages(torch.randn(shape, generator=gen, device=dev)
                            .to(dtype), k, table, KV_LEN)
            vp = fill_pages(torch.randn(shape, generator=gen, device=dev)
                            .to(dtype), v, table, KV_LEN)
            got = ops.flash_attention_paged(q, kp, vp, table, q_offset=qo,
                                            kv_len=kl)
            again = ops.flash_attention_paged(q, kp, vp, table, q_offset=qo,
                                              kv_len=kl)
            want = flash_attention_paged_ref(q, kp, vp, table, q_offset=qo,
                                             kv_len=kl)
            # NaN in every arena row, but the rows some query can see
            seen = [min(n, o + Sq) for o, n in zip(Q_OFFSET, KV_LEN)]
            nan = torch.full(shape, float("nan"), device=dev).to(dtype)
            pk = fill_pages(nan.clone(), k, table, seen)
            pv = fill_pages(nan, v, table, seen)
            poisoned = ops.flash_attention_paged(q, pk, pv, table,
                                                 q_offset=qo, kv_len=kl)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            vs_cached = (got.float() - cached.float()).abs().max().item()
            zero_row = got[0].float().abs().max().item()
            print(f"[parity] flash_paged {dname} page_size={ps} ({mp} table "
                  f"columns): max abs err {err:.3g} (tol {TOL[dname]:g}); "
                  f"max abs diff vs flash_cached on the same rows "
                  f"{vs_cached:g} (gate 0.0); kv_len=0 row max {zero_row:g}; "
                  f"NaN in unseen rows: "
                  f"{'output unchanged' if torch.equal(poisoned, got) else 'OUTPUT CHANGED'}"
                  f"; a second run "
                  f"{'bit-equal' if torch.equal(got, again) else 'DIFFERS'}",
                  flush=True)
            if not math.isfinite(err) or err > TOL[dname]:
                fail(f"flash_paged {dname} page_size={ps} error {err}")
            bf16_gate(got, want, dname, f"flash_paged page_size={ps}")
            if not torch.equal(got, cached):
                fail(f"flash_paged {dname} page_size={ps} differs from "
                     f"flash_cached on the same rows by {vs_cached}")
            if zero_row != 0.0:
                fail("a kv_len = 0 row must give 0")
            if not torch.equal(poisoned, got):
                fail(f"flash_paged {dname} page_size={ps}: a NaN in a row no "
                     "query can see reached the output")
            if not torch.equal(got, again):
                fail(f"flash_paged {dname} page_size={ps}: two runs on the "
                     "same inputs differ")
            p_worst = max(p_worst, err)

    # a 4096-row cache: both kernels against their plain versions, and the
    # paged one (pages of 16) equal to the cached one on the same rows
    long_sk, long_kl = LONG["Sk"], LONG["kv_len"]
    long_qo = [max(0, n - Sq) for n in long_kl]
    lqo = torch.tensor(long_qo, dtype=torch.int32, device=dev)
    lkl = torch.tensor(long_kl, dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, long_sk, Hkv, D), generator=gen,
                        device=dev).to(dtype)
        v = torch.randn((B, long_sk, Hkv, D), generator=gen,
                        device=dev).to(dtype)
        mp = long_sk // PAGE_SIZE
        n_pages = sum(-(-n // PAGE_SIZE) for n in long_kl) + 7
        table = page_table(long_kl, PAGE_SIZE, mp, n_pages, gen, dev)
        shape = (n_pages, PAGE_SIZE, Hkv, D)
        kp = fill_pages(torch.zeros(shape, device=dev, dtype=dtype), k, table,
                        long_kl)
        vp = fill_pages(torch.zeros(shape, device=dev, dtype=dtype), v, table,
                        long_kl)
        got = ops.flash_attention_cached(q, k, v, q_offset=lqo, kv_len=lkl)
        want = flash_attention_cached_ref(q, k, v, q_offset=lqo, kv_len=lkl)
        pgot = ops.flash_attention_paged(q, kp, vp, table, q_offset=lqo,
                                         kv_len=lkl)
        pwant = flash_attention_paged_ref(q, kp, vp, table, q_offset=lqo,
                                          kv_len=lkl)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        perr = (pgot.float() - pwant.float()).abs().max().item()
        print(f"[parity] 4096-row cache, {dname}: flash_cached max abs err "
              f"{err:.3g}, flash_paged (pages of {PAGE_SIZE}) {perr:.3g} "
              f"(tol {TOL[dname]:g}); paged "
              f"{'equal to' if torch.equal(pgot, got) else 'DIFFERS FROM'} "
              f"cached", flush=True)
        for what, e in (("flash_cached", err), ("flash_paged", perr)):
            if not math.isfinite(e) or e > TOL[dname]:
                fail(f"{what} {dname} error {e} on a 4096-row cache")
        bf16_gate(got, want, dname, "flash_cached on a 4096-row cache")
        bf16_gate(pgot, pwant, dname, "flash_paged on a 4096-row cache")
        if not torch.equal(pgot, got):
            fail(f"flash_paged {dname} differs from flash_cached on a "
                 "4096-row cache")
        if got[0].abs().max().item() != 0.0:
            fail("a kv_len = 0 row must give 0")
        worst, p_worst = max(worst, err), max(p_worst, perr)
    del k, v, kp, vp

    # the launch each kernel makes at the main shape (bf16), and no bf16
    # instantiation of either kernel built on the FMA loops
    logs = " ".join(build.BUILD_LOG.get(n, (0, ""))[1]
                    for n in ("flash_cached", "flash_paged"))
    fma_bf16 = re.findall(r"flash_block_kernelI13__nv_bfloat16Li(\d+)ELb0E",
                          logs)
    if fma_bf16:
        fail("kernels 2 and 4 built bf16 FMA loops at D "
             f"{sorted(set(fma_bf16))}")
    if not logs.strip():
        print(f"[geometry] no bf16 FMA instantiation: not checked ({NO_LOG})",
              flush=True)
    for what, plan in block_geometry(build, flash_attention, MAIN,
                                     "qwen2-1.5b's").items():
        if plan["CTAs"] < 128:
            fail(f"{what} spans {plan['CTAs']} CTAs at the main shape, "
                 "fewer than 128")

    # time at the paged serve's block-prefill shapes in bf16: page size 16,
    # 32 table columns over a permuted arena of the default 256 pages, one
    # arena per layer (28 x 4 MiB > the 50 MB L2) cycled as a tick does
    mp = Sk // PAGE_SIZE
    table = page_table(KV_LEN, PAGE_SIZE, mp, DEFAULT_PAGES, gen, dev)
    arena = (nl, DEFAULT_PAGES, PAGE_SIZE, Hkv, D)
    kps = torch.randn(arena, generator=gen, device=dev).to(torch.bfloat16)
    vps = torch.randn(arena, generator=gen, device=dev).to(torch.bfloat16)
    p_entry = flash_paged._entry()
    it["i"] = 0

    def pages():
        i = it["i"] = (it["i"] + 1) % nl
        return kps[i], vps[i]

    def run_paged(st=stream):
        kp, vp = pages()
        err = p_entry(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                      out.data_ptr(), table.data_ptr(), qo.data_ptr(),
                      kl.data_ptr(), B, Sq, Hq, Hkv, D, DEFAULT_PAGES,
                      PAGE_SIZE, mp, 1, st)
        if err:
            fail(f"flash_paged_fwd returned cudaError {err}")

    def run_paged_plain():
        kp, vp = pages()
        flash_attention_paged_ref(q, kp, vp, table, q_offset=qo, kv_len=kl)

    rows_ok = (table >= 0).repeat_interleave(PAGE_SIZE, dim=1)  # (B, 512)
    gather_idx = table.long().clamp(min=0)

    def run_paged_library():
        # a gather of the pages into the logical view, then SDPA
        kp, vp = pages()
        kk = kp[gather_idx].reshape(B, Sk, Hkv, D).transpose(1, 2)
        vv = vp[gather_idx].reshape(B, Sk, Hkv, D).transpose(1, 2)
        F.scaled_dot_product_attention(qt, kk, vv,
                                       attn_mask=mask & rows_ok[:, None, None],
                                       enable_gqa=True)

    p_ms = time_ms(run_paged, 4 * nl)
    p_device_ms = graph_ms(run_paged, 4 * nl)
    p_plain_ms = time_ms(run_paged_plain, nl)
    p_library_ms = time_ms(run_paged_library, 4 * nl)
    nbytes, nops = flash_work(Q_OFFSET, KV_LEN, Sq, Hq, Hkv, D, 2, 0)
    nbytes += table.numel() * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS["bfloat16"]
    p_bound_ms = 1e3 * max(t_bytes, t_ops)
    p_bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] flash_paged bf16 B={B} Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} "
          f"page_size={PAGE_SIZE} table {B}x{mp} over {DEFAULT_PAGES} pages: "
          f"kernel {p_ms:.4f} ms ({p_device_ms:.4f} ms a launch in a CUDA "
          f"graph), bound {p_bound_ms:.5f} ms ({p_bound_by}: "
          f"{nbytes} B, {nops} ops), plain {p_plain_ms:.4f} ms, page gather "
          f"+ sdpa {p_library_ms:.4f} ms", flush=True)
    paged = {"ms": p_ms, "plain_ms": p_plain_ms, "library_ms": p_library_ms,
             "bound_ms": p_bound_ms, "bound_by": p_bound_by,
             "max_abs_err": p_worst}
    del kps, vps

    # kernels 2 and 4 past D 128 (gemma-2b's D 256, stablelm-12b's D 160:
    # the tensor-core path with Q read from shared memory): block_kernels'
    # gates and the fixed max |err| <= 3e-2, then each timed beside SDPA
    # and a page gather + SDPA; each launch held to its model
    for model, blk in WIDE_BLOCKS:
        err = block_kernels(ops, flash_attention, flash_paged,
                            flash_attention_cached_ref, blk, model, "wide",
                            dev, gen)
        if not max(err.values()) <= TOL["bfloat16"]:
            fail(f"kernels 2 and 4 at {model} block prefill: max abs error "
                 f"{err}")
        flash["max_abs_err"] = max(flash["max_abs_err"], err["flash_cached"])
        paged["max_abs_err"] = max(paged["max_abs_err"], err["flash_paged"])
        block_geometry(build, flash_attention, blk, model)
    print(f"[gate] kernels 2 and 4, bf16, per slot: every slot within 3e-2 "
          f"|want| + min(3e-2, 0.1 rms(want[slot])); the largest err / "
          f"allowed {GATE_WORST['ratio']:.4f} ({GATE_WORST['what']})",
          flush=True)

    # -- Fisher kernel: parity at the adaptation path's shapes ---------------
    # the main path's tap-gradient groups: (layers, support rows, channels)
    # for the attention heads and the d_ff neurons of qwen2-1.5b, with the
    # padding rows of its episode masked (and filled with NaN here: a
    # masked row must never be read)
    task = api.sample_lm_task(np.random.default_rng(0), cfg.vocab,
                              seq=ADAPT["seq"], max_way=ADAPT["task_way"],
                              support_pad=ADAPT["pad"], query_pad=ADAPT["pad"])
    labels = torch.from_numpy(task.support["episode_labels"]).to(dev)
    n_rows, n_valid = labels.shape[0], task.n_support
    row_mask = (labels >= 0).float()
    tap_shapes = [(nl, n_rows, cfg.n_heads), (nl, n_rows, cfg.d_ff)]
    f_worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = FISHER_TOL[dname]
        for shape in tap_shapes:
            g = torch.randn(shape, generator=gen, device=dev).to(dtype)
            for m in (None, row_mask):
                gm = g.clone()
                if m is not None:
                    gm[:, m == 0] = float("nan")
                got = ops.fisher_tapgrads(gm, float(n_valid), m)
                want = fisher_tapgrads_ref(gm, float(n_valid), m)
                torch.cuda.synchronize()
                err = max_err(got, want, tol, f"fisher_tapgrads {dname} "
                              f"{shape} masked={m is not None}")
                f_worst = max(f_worst, err)
                print(f"[parity] fisher_tapgrads {dname} {shape} masked="
                      f"{m is not None}: max abs err {err:.3g} (tol {tol:g} "
                      f"rel+abs)", flush=True)
        # kernel 1's (N, D, C) route: two earlier shapes and FISHER_GENERAL's,
        # masked (NaN in the masked rows) and unmasked, each run twice
        # (bit-equal), its launch held to the host-side model
        for shape in ((4, 1024, 512), (6, 7, 77), *FISHER_GENERAL.values()):
            a = torch.randn(shape, generator=gen, device=dev).to(dtype)
            g = (0.1 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
            m = (torch.arange(shape[0], device=dev) < shape[0] - 2).float()
            m[shape[0] // 2] = 0.0
            an, gn = a.clone(), g.clone()
            an[m == 0], gn[m == 0] = float("nan"), float("nan")
            got = ops.fisher(an, gn, mask=m)
            bits = torch.equal(got, ops.fisher(an, gn, mask=m))
            want = fisher_ref(an, gn, m)
            torch.cuda.synchronize()
            err = max_err(got, want, tol, f"fisher {dname} {shape}")
            got = ops.fisher(a, g)
            bits = bits and torch.equal(got, ops.fisher(a, g))
            err2 = max_err(got, fisher_ref(a, g), tol,
                           f"fisher {dname} {shape} unmasked")
            f_worst = max(f_worst, err, err2)
            gp = fisher_kernel.general_launch_plan(a, g)
            gm = fisher_kernel.general_plan(*shape, dtype)
            print(f"[parity] fisher {dname} {shape}: masked (NaN rows) max "
                  f"abs err {err:.3g}, unmasked {err2:.3g} (tol {tol:g} "
                  f"rel+abs), two runs {'bit-equal' if bits else 'DIFFER'}; "
                  f"launch {gp['blocks']} CTAs in clusters of "
                  f"{gp['cluster']} ({gp['d_ranks']} d x {gp['row_ranks']} "
                  f"row ranks), {gp['threads_x']} x {gp['threads_y']} "
                  f"threads, {gp['vec']} columns a thread, "
                  f"{gp['registers']} registers", flush=True)
            if not bits:
                fail(f"fisher {dname} {shape}: two runs differ")
            if any(gp[k] != gm[k] for k in fisher_kernel.GENERAL_PLAN_KEYS):
                fail(f"fisher {dname} {shape}: launch {gp} differs from the "
                     f"model")
            least = {FISHER_GENERAL["bench"]: fisher_kernel.GWAVE,
                     FISHER_GENERAL["wide"]: fisher_kernel.GWAVE,
                     FISHER_GENERAL["cnn-early"]: 2,
                     FISHER_GENERAL["cnn-head"]: 19}.get(shape, 1)
            if gp["blocks"] < least:  # a wave; the first design's, beaten
                fail(f"fisher {dname} {shape}: {gp['blocks']} CTAs")
            del a, g, an, gn
    # the (N, D, C) route's time at FISHER_GENERAL's shapes through its C
    # entry, beside the plain version and the einsum pair, buffer sets
    # cycled past the L2
    g_entry = fisher_kernel._entry()
    for gname, shape in FISHER_GENERAL.items():
        for dtype in ((torch.float32, torch.bfloat16)
                      if gname in ("bench", "wide") else (torch.float32,)):
            dname = str(dtype).split(".")[-1]
            n, d, c = shape
            elt = torch.empty((), dtype=dtype).element_size()
            gbytes = 2 * n * d * c * elt
            sets = max(1, -(-100 * 2 ** 20 // gbytes))
            bufs = [(torch.randn(shape, generator=gen, device=dev).to(dtype),
                     torch.randn(shape, generator=gen, device=dev).to(dtype))
                    for _ in range(sets)]
            g_out = torch.empty((c,), device=dev)
            it["i"] = 0

            def next_ag(bufs=bufs):
                i = it["i"] = (it["i"] + 1) % len(bufs)
                return bufs[i]

            def run_general(n=n, d=d, c=c, code=int(dtype != torch.float32),
                            g_out=g_out, next_ag=next_ag):
                a, g = next_ag()
                err = g_entry(a.data_ptr(), g.data_ptr(), None,
                              g_out.data_ptr(), n, d, c, 1.0 / (2 * n), 0,
                              code, stream)
                if err:
                    fail(f"fisher_fwd returned cudaError {err}")

            def run_general_plain(next_ag=next_ag):
                fisher_ref(*next_ag())

            def run_general_einsum(n=n, next_ag=next_ag):
                a, g = next_ag()
                u = torch.einsum("ndc,ndc->nc", a, g)
                torch.einsum("nc,nc->c", u, u).div_(2 * n)

            k_ms = time_ms(run_general, 50)
            p_ms = time_ms(run_general_plain, 20)
            l_ms = time_ms(run_general_einsum, 20)
            t_bytes = (gbytes + 4 * c) / HBM_BYTES_PER_S
            t_ops = (2 * n * d * c + 3 * n * c) / PEAK_OPS[dname]
            b_ms = 1e3 * max(t_bytes, t_ops)
            print(f"[time] fisher (N, D, C) {gname} {dname} {shape}: kernel "
                  f"{k_ms:.4f} ms, bound {b_ms:.5f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'}), plain "
                  f"{p_ms:.4f} ms, einsum pair {l_ms:.4f} ms", flush=True)
            del bufs

    # time the ffn group's reduction, f32 tap gradients as the probe makes
    # them, cycling through 4 buffers (4 x 48 MB > the 50 MB L2) since the
    # probe's gradients are fresh; the kernel through its C entry
    shape = tap_shapes[1]
    gs = [torch.randn(shape, generator=gen, device=dev) for _ in range(4)]
    out = torch.empty(shape[::2], device=dev)
    f_entry = fisher_kernel._tap_entry()
    scale = 1.0 / (2.0 * n_valid)
    n_one = torch.full((1,), float(n_valid), device=dev)
    it["i"] = 0

    def next_g():
        i = it["i"] = (it["i"] + 1) % len(gs)
        return gs[i]

    def run_fisher():
        err = f_entry(next_g().data_ptr(), row_mask.data_ptr(),
                      n_one.data_ptr(), out.data_ptr(), 1, shape[0],
                      shape[1], shape[2], 0, stream, None)
        if err:
            fail(f"fisher_tapgrads_fwd returned cudaError {err}")

    def run_fisher_plain():
        fisher_tapgrads_ref(next_g(), n_valid, row_mask)

    def run_fisher_library():
        g = next_g()
        torch.einsum("lbc,lbc,b->lc", g, g, row_mask).mul_(scale)

    f_ms = time_ms(run_fisher, 100)
    f_plain_ms = time_ms(run_fisher_plain, 20)
    f_library_ms = time_ms(run_fisher_library, 50)
    cells = shape[0] * shape[2]
    # valid rows, mask, count, out
    f_bytes = 4 * (n_valid * cells + n_rows + 1 + cells)
    f_ops = 3 * n_valid * cells                         # square, weight, add
    t_bytes, t_ops = f_bytes / HBM_BYTES_PER_S, f_ops / PEAK_OPS["float32"]
    f_bound_ms = 1e3 * max(t_bytes, t_ops)
    f_bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] fisher_tapgrads f32 {shape} ({n_valid} of {n_rows} rows "
          f"valid): kernel {f_ms:.4f} ms, bound {f_bound_ms:.5f} ms "
          f"({f_bound_by}: {f_bytes} B, {f_ops} ops), plain "
          f"{f_plain_ms:.4f} ms, einsum {f_library_ms:.4f} ms", flush=True)
    fisher = {"ms": f_ms, "plain_ms": f_plain_ms,
              "library_ms": f_library_ms, "bound_ms": f_bound_ms,
              "bound_by": f_bound_by, "max_abs_err": f_worst}
    # the launch at the main shape, held to the host-side model: 16-byte
    # loads, every block resident at once (one wave)
    f_plan = fisher_kernel.plan(gs[0][None])
    f_model = fisher_kernel.rows_plan(*shape, torch.float32)
    print(f"[geometry] fisher_tapgrads f32 {shape}: {f_plan['blocks']} "
          f"blocks of {f_plan['threads']} threads, {f_plan['vec']} columns "
          f"a thread, {f_plan['rows_ahead']} rows loaded ahead, valid rows "
          f"compacted {f_plan['rows_a_pass']} a pass", flush=True)
    if any(f_plan[k] != f_model[k] for k in fisher_kernel.PLAN_KEYS):
        fail(f"fisher's launch {f_plan} differs from the model")

    # kernel 1's task axis (a fleet's probe, phase 16): T stacked d_ff
    # groups with ragged masks (NaN in the masked rows), one launch, each
    # task bit-equal to a one-task (T = 1) launch on its slice, within
    # FISHER_TOL of the plain version
    t_worst = 0.0
    for nt in FISHER_TASKS:
        g = torch.randn((nt, *shape), generator=gen, device=dev)
        tm = torch.ones((nt, n_rows), device=dev)
        for t in range(nt):
            tm[t, n_rows - 8 * t - (n_rows - n_valid):] = 0.0
        g[tm[:, None, :, None].expand_as(g) == 0] = float("nan")
        tn = tm.sum(1)
        got = ops.fisher_tapgrads(g, tn, tm)
        want = fisher_tapgrads_ref(g, tn, tm)
        ones = [ops.fisher_tapgrads(g[t].contiguous(), float(tn[t]),
                                    tm[t].contiguous()) for t in range(nt)]
        sync(dev)
        err = max_err(got, want, FISHER_TOL["float32"],
                      f"fisher_tapgrads task axis T={nt}")
        bits = all(torch.equal(got[t], ones[t]) for t in range(nt))
        t_plan = fisher_kernel.plan(g)
        t_model = fisher_kernel.rows_plan(*shape, torch.float32, tasks=nt)
        print(f"[parity] fisher_tapgrads task axis f32 T={nt} x {shape} "
              f"(valid rows {[int(x) for x in tn.tolist()]}): max abs err "
              f"{err:.3g} (tol {FISHER_TOL['float32']:g} rel+abs), each task "
              f"{'bit-equal to' if bits else 'DIFFERS FROM'} a one-task "
              f"launch; launch {t_plan['blocks']} x {t_plan['tasks']} blocks "
              f"of {t_plan['threads']}, {t_plan['vec']} columns a thread",
              flush=True)
        if not bits:
            fail(f"the task-axis launch at T={nt} differs from one-task "
                 "launches")
        if any(t_plan[k] != t_model[k] for k in (*fisher_kernel.PLAN_KEYS,
                                                  "tasks")):
            fail(f"fisher's task-axis launch {t_plan} differs from the model")
        t_worst = max(t_worst, err)
    # its time at T = 4, four stacks cycled past the L2 as in the probe
    nt = FISHER_TASKS[-1]
    tgs = [torch.randn((nt, *shape), generator=gen, device=dev)
           for _ in range(4)]
    tmask = torch.ones((nt, n_rows), device=dev)
    tmask[:, n_valid:] = 0.0
    tn = tmask.sum(1)
    t_out = torch.empty((nt, shape[0], shape[2]), device=dev)
    t_entry = fisher_kernel._tap_entry()
    it["i"] = 0

    def next_tg():
        i = it["i"] = (it["i"] + 1) % len(tgs)
        return tgs[i]

    def run_tasks():
        err = t_entry(next_tg().data_ptr(), tmask.data_ptr(), tn.data_ptr(),
                      t_out.data_ptr(), nt, shape[0], shape[1], shape[2], 0,
                      stream, None)
        if err:
            fail(f"fisher_tapgrads_fwd returned cudaError {err}")

    def run_tasks_plain():
        fisher_tapgrads_ref(next_tg(), tn, tmask)

    def run_tasks_library():
        g = next_tg()
        torch.einsum("tlbc,tlbc,tb->tlc", g, g, tmask).mul_(
            (0.5 / tn)[:, None, None])

    ft_ms = time_ms(run_tasks, 50)
    ft_plain_ms = time_ms(run_tasks_plain, 10)
    ft_library_ms = time_ms(run_tasks_library, 20)
    ft_bytes = 4 * (nt * (n_valid * cells + n_rows + cells) + nt)
    ft_ops = 3 * nt * n_valid * cells
    t_bytes, t_ops = ft_bytes / HBM_BYTES_PER_S, ft_ops / PEAK_OPS["float32"]
    ft_bound_ms = 1e3 * max(t_bytes, t_ops)
    ft_bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] fisher_tapgrads task axis f32 T={nt} x {shape} ({n_valid} "
          f"of {n_rows} rows valid a task): kernel {ft_ms:.4f} ms, bound "
          f"{ft_bound_ms:.5f} ms ({ft_bound_by}: {ft_bytes} B, {ft_ops} ops), "
          f"plain {ft_plain_ms:.4f} ms, einsum {ft_library_ms:.4f} ms",
          flush=True)
    fisher_tasks = {"ms": ft_ms, "plain_ms": ft_plain_ms,
                    "library_ms": ft_library_ms, "bound_ms": ft_bound_ms,
                    "bound_by": ft_bound_by, "max_abs_err": t_worst}
    del gs, tgs

    # -- grad_quant kernel: exact parity with its plain version ---------------
    # the kernel's largest leaf on phase 10's path: an MLP unit's w_gate
    # delta, d_model x half of d_ff (the scaled edge-lm profile keeps half
    # of each unit's channels; phase 10 checks it against its policy)
    GQ_LEAF = (cfg.d_model, cfg.d_ff // 2)
    # a ragged multi-block size, the main path's largest leaf, ties (absmax
    # 127 makes the scale exactly 1, so k + 0.5 rounds half to even), zeros
    # and a NaN; codes, scale and residual must be equal, not close
    def gq_case(n, dtype, kind):
        if kind == "ties":
            g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 3.25],
                             device=dev)
            return g.to(dtype), torch.zeros(g.shape, device=dev)
        g = torch.randn(n, generator=gen, device=dev)
        err = 0.01 * torch.randn(n, generator=gen, device=dev)
        if kind == "zeros":
            g, err = torch.zeros_like(g), torch.zeros_like(err)
        if kind == "nan":
            g[n // 3] = float("nan")
        return g.to(dtype), err

    # the paths by size: one CTA (<= 8192), on chip (the leaf, up to the
    # SMs' shared memory, gq_cap) and two passes (one element past gq_cap,
    # two leaves)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gq_cap = gq_kernel.capacity(sms)
    n_leaf = GQ_LEAF[0] * GQ_LEAF[1]
    gq_cases = [(1, "normal"), (5000, "normal"), (6151, "normal"),
                (1_000_003, "normal"), (n_leaf, "normal"),
                (gq_cap - 1, "normal"), (gq_cap, "normal"),
                (gq_cap + 1, "normal"), (2 * n_leaf, "normal"),
                (8, "ties"), (4099, "zeros"), (4099, "nan"),
                (gq_cap + 1, "nan")]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for n, kind in gq_cases:
            g, err = gq_case(n, dtype, kind)
            got = ops.grad_quant(g, err)
            want = grad_quant_ref(g, err)
            torch.cuda.synchronize()
            same = all(a.dtype == b.dtype and a.shape == b.shape
                       and torch.equal(torch.nan_to_num(a.float(), nan=7.0),
                                       torch.nan_to_num(b.float(), nan=7.0))
                       and torch.equal(a.isnan(), b.isnan())
                       for a, b in zip(got, want))
            path = gq_kernel.PATHS[gq_kernel.plan_model(n, sms)["path"]]
            print(f"[parity] grad_quant {dname} n={n} {kind} ({path}): "
                  f"codes, scale and residual "
                  f"{'equal' if same else 'DIFFERENT'} (gate: equal); scale "
                  f"{got[1].item():.6g}", flush=True)
            if not same:
                fail(f"grad_quant {dname} n={n} {kind} differs from its "
                     "plain version")
            if kind == "ties" and got[0].tolist() != [127, 0, 2, 2, 0, -2,
                                                      126, 3]:
                fail(f"grad_quant ties rounded {got[0].tolist()}")
    # the tree compressor launches once per leaf and reads nothing back
    tree = {"L0": {"mlp": {
        "w_up": torch.randn(GQ_LEAF, generator=gen, device=dev).bfloat16(),
        "w_down": torch.randn(GQ_LEAF[::-1], generator=gen,
                              device=dev).bfloat16()}}}
    ef = compress.ef_state_init(tree)
    before = ops.grad_quant.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q_t, s_t, ef = compress.int8_compress(tree, ef)
        compress.int8_decompress(q_t, s_t, torch.bfloat16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"[parity] int8_compress of a 2-leaf tree on the card: "
          f"{ops.grad_quant.launches - before} grad_quant launches, no "
          "synchronising call (sync debug mode 'error')", flush=True)
    if ops.grad_quant.launches - before != 2:
        fail("int8_compress did not launch grad_quant once per leaf")

    # one launch a call, on the path and grid of the host-side model
    gq_log = build.BUILD_LOG.get("grad_quant", (0, ""))[1]
    for n in (5000, n_leaf, gq_cap, gq_cap + 1):
        plan = gq_kernel.grad_quant_plan(n, torch.bfloat16)
        model = gq_kernel.plan_model(n, sms)
        ptx = ptxas_report(gq_log, "grad_quant_kernel", "13__nv_bfloat16",
                              f"Li{plan['path']}E")
        path = gq_kernel.PATHS[plan["path"]]
        print(f"[geometry] grad_quant bf16 n={n}: {path}, {plan['ctas']} "
              f"CTAs of {plan['threads']} threads on "
              f"{plan['sms']} SMs, {plan['smem_bytes']} B of dynamic shared "
              f"memory, {plan['registers']} registers a thread (ptxas log: "
              f"{'not in this build' if ptx is None else ptx}), one launch",
              flush=True)
        if (plan["path"], plan["ctas"], plan["threads"],
                plan["smem_bytes"]) != (model["path"], model["ctas"],
                                        model["threads"], model["smem_bytes"]):
            fail(f"grad_quant launch {plan} differs from the model {model}")

    # time at the largest leaf: bf16 g and a float32 residual, cycling 4
    # buffers (4 x 41 MB > the 50 MB L2), the kernel through its C entry
    n_gq = GQ_LEAF[0] * GQ_LEAF[1]
    gbufs = [(torch.randn(n_gq, generator=gen, device=dev).bfloat16(),
              0.01 * torch.randn(n_gq, generator=gen, device=dev))
             for _ in range(4)]
    q_out = torch.empty(n_gq, dtype=torch.int8, device=dev)
    e_out = torch.empty(n_gq, device=dev)
    scratch = torch.empty(2 + gq_kernel.MAX_CTAS, device=dev)
    gq_entry = gq_kernel._entry()
    it["i"] = 0

    def next_gq():
        i = it["i"] = (it["i"] + 1) % len(gbufs)
        return gbufs[i]

    def run_gq():
        g, e = next_gq()
        rc = gq_entry(g.data_ptr(), e.data_ptr(), q_out.data_ptr(),
                      e_out.data_ptr(), scratch.data_ptr(), n_gq, 1, stream)
        if rc:
            fail(f"grad_quant_fwd returned cudaError {rc}")

    def run_gq_plain():
        grad_quant_ref(*next_gq())

    gq_ms = time_ms(run_gq, 40)
    gq_plain_ms = time_ms(run_gq_plain, 10)
    # each input read once and each output written once: g (bf16), err,
    # q (int8), new_err and the scale; add, abs, max, divide, round,
    # clip, multiply, subtract per element
    gq_bytes = n_gq * (2 + 4 + 1 + 4) + 4
    gq_ops = 8 * n_gq
    t_bytes, t_ops = gq_bytes / HBM_BYTES_PER_S, gq_ops / PEAK_OPS["float32"]
    gq_bound_ms = 1e3 * max(t_bytes, t_ops)
    gq_bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[time] grad_quant bf16 g, f32 err, {GQ_LEAF[0]}x{GQ_LEAF[1]} = "
          f"{n_gq} elements: kernel {gq_ms:.4f} ms, bound {gq_bound_ms:.5f} "
          f"ms ({gq_bound_by}: {gq_bytes} B, {gq_ops} ops), plain "
          f"{gq_plain_ms:.4f} ms, no single library call", flush=True)
    gquant = {"ms": gq_ms, "plain_ms": gq_plain_ms, "library_ms": None,
              "bound_ms": gq_bound_ms, "bound_by": gq_bound_by,
              "max_abs_err": 0.0}
    del gbufs, tree, ef, q_t, s_t

    # -- SSD scan kernels: forward and backward against their plain versions
    # forward against the sequential oracle, backward against autograd of
    # the plain chunked body in float32 on the same (rounded) inputs; at
    # the main path's shape, over several tiles with an initial state, and
    # at the Pallas chunk of 256
    def ssd_inputs(b, s, h, p, n, dtype, init=False):
        x = (0.5 * torch.randn((b, s, h, p), generator=gen, device=dev)
             ).to(dtype)
        dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev))
        a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
        bm = (0.5 * torch.randn((b, s, n), generator=gen, device=dev)
              ).to(dtype)
        cm = (0.5 * torch.randn((b, s, n), generator=gen, device=dev)
              ).to(dtype)
        st = (0.5 * torch.randn((b, h, p, n), generator=gen, device=dev)
              if init else None)
        return x, dt, a, bm, cm, st

    def rel_err(got, want, tol, what):
        """Max abs error; fails unless finite and within ``tol`` of
        max(1, max |want|)."""
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        e = err / max(1.0, want.abs().max().item())
        if not (torch.isfinite(got).all().item() and e <= tol):
            fail(f"{what}: error {e} (relative to max |want|) beyond {tol:g}")
        return err

    ssd_cases = [dict(SSD), dict(b=2, s=160, h=4, p=32, n=64, chunk=80,
                                 init=True),
                 dict(b=1, s=512, h=2, p=64, n=128, chunk=256)]
    ssd_worst = ssd_bwd_worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = SSD_TOL[dname]
        for case in ssd_cases:
            chunk = case["chunk"]
            dims = {k: case[k] for k in ("b", "s", "h", "p", "n")}
            x, dt, a, bm, cm, st = ssd_inputs(**dims, dtype=dtype,
                                              init=case.get("init", False))
            y, fin = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                  init_state=st, out_dtype=torch.float32)
            yr, sr = ssd_scan_ref(x.float(), dt, a, bm, cm, st)
            # and the main path's launch: no final state asked for, so
            # several heads a CTA and the states kept only where a tile
            # needs one
            y0, _ = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                 init_state=st, want_state=False,
                                 out_dtype=torch.float32)
            e_fwd = max(rel_err(y, yr, 1e-4, f"ssd_scan y {dname} {case}"),
                        rel_err(fin, sr, 1e-4, f"ssd_scan state {dname}"),
                        rel_err(y0, yr, 1e-4, f"ssd_scan y without the "
                                f"final state {dname} {case}"))
            y0_same = torch.equal(y0, y)
            w = torch.randn(y.shape, generator=gen, device=dev)
            leaves = [t.clone().requires_grad_() for t in (x, dt, bm, cm)]
            y, _ = ssm.ssd_chunked(leaves[0], leaves[1], a, leaves[2],
                                   leaves[3], chunk, st, need_state=False)
            got = torch.autograd.grad((y * w).sum(), leaves)
            y, _ = ssm.ssd_chunked(leaves[0], leaves[1], a, leaves[2],
                                   leaves[3], chunk, st, need_state=False)
            again = torch.autograd.grad((y * w).sum(), leaves)
            if not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
                fail(f"ssd_scan_bwd {dname} {case}: two runs differ")
            refl = [t.float().clone().requires_grad_()
                    for t in (x, dt, bm, cm)]
            yp, _ = ssm.ssd_chunked_plain(refl[0], refl[1], a, refl[2],
                                          refl[3], chunk, st)
            want = torch.autograd.grad((yp * w).sum(), refl)
            torch.cuda.synchronize()
            e_bwd = max(rel_err(g, wv, tol, f"ssd_scan_bwd {name_} {dname} "
                                f"{case}")
                        for g, wv, name_ in zip(got, want, ("dx", "d(dt)",
                                                            "dB", "dC")))
            ssd_worst, ssd_bwd_worst = (max(ssd_worst, e_fwd),
                                        max(ssd_bwd_worst, e_bwd))
            print(f"[parity] ssd_scan {dname} {case}: forward (with and "
                  f"without the final state, y "
                  f"{'bit-equal' if y0_same else 'not bit-equal'} between "
                  f"them) max abs error {e_fwd:.3g} (tol "
                  f"1e-4 of max(1, max |y|)), backward (dx, "
                  f"d(dt), dB, dC) {e_bwd:.3g} (tol {tol:g} of the same), "
                  f"two runs bit-equal", flush=True)
    del (x, dt, a, bm, cm, st, y, y0, yp, yr, w, leaves, refl, got, again,
         want)

    # time at the main path's shape in bf16, two input sets cycled (each
    # call moves 78 MB, above the 50 MB L2), the kernels through their C
    # entries
    b_, s_, h_, p_, n_ = (SSD[k] for k in ("b", "s", "h", "p", "n"))
    sets = [ssd_inputs(b_, s_, h_, p_, n_, torch.bfloat16) for _ in range(2)]
    dys = [torch.randn((b_, s_, h_, p_), generator=gen, device=dev)
           for _ in range(2)]
    y_out = torch.empty((b_, s_, h_, p_), device=dev)
    dx_o, ddt_o = torch.empty_like(y_out), torch.empty((b_, s_, h_),
                                                       device=dev)
    geo = ssd_kernel.bwd_geometry(b_, s_, h_)
    part = (torch.empty((2, b_, geo["groups"], s_, n_), device=dev)
            if geo["groups"] > 1 else None)
    dbc_o = torch.empty((2, b_, s_, n_), device=dev)
    states = (torch.empty((b_, h_, geo["state_slots"], p_, n_), device=dev)
              if geo["state_slots"] else None)
    launched = ctypes.c_int(0)
    fwd_entry, bwd_entry = ssd_kernel._entry(), ssd_kernel._bwd_entry()
    it["i"] = 0

    def next_set():
        i = it["i"] = (it["i"] + 1) % len(sets)
        return sets[i], dys[i]

    def run_ssd():
        (x, dt, a, bm, cm, _), _ = next_set()
        rc = fwd_entry(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                       bm.data_ptr(), cm.data_ptr(), None, y_out.data_ptr(),
                       None, b_, s_, h_, p_, n_, 1, stream)
        if rc:
            fail(f"ssd_scan_fwd returned cudaError {rc}")

    def run_ssd_bwd():
        (x, dt, a, bm, cm, _), dy = next_set()
        rc = bwd_entry(dy.data_ptr(), x.data_ptr(), dt.data_ptr(),
                       a.data_ptr(), bm.data_ptr(), cm.data_ptr(), None,
                       None if states is None else states.data_ptr(),
                       dx_o.data_ptr(), ddt_o.data_ptr(),
                       None if part is None else part.data_ptr(),
                       dbc_o.data_ptr(), b_, s_, h_, p_, n_, 1, stream,
                       ctypes.byref(launched))
        if rc:
            fail(f"ssd_scan_bwd returned cudaError {rc}")

    def run_ssd_plain():
        (x, dt, a, bm, cm, _), _ = next_set()
        ssd_scan_ref(x, dt, a, bm, cm)

    def run_ssd_bwd_plain():
        (x, dt, a, bm, cm, _), dy = next_set()
        lv = [t.detach().requires_grad_() for t in (x, dt, bm, cm)]
        y, _ = ssm.ssd_chunked_plain(lv[0], lv[1], a, lv[2], lv[3],
                                     SSD["chunk"])
        torch.autograd.grad(y, lv, dy)

    ssd_ms = time_ms(run_ssd, 20)
    ssd_bwd_ms = time_ms(run_ssd_bwd, 10)
    # the backward's launch and its time split by launch (device time from
    # torch.profiler over ten calls)
    plan = ssd_kernel.bwd_plan(b_, s_, h_, p_, n_, torch.bfloat16)
    want_plan = dict(CTAs=geo["ctas"], cluster=geo["cluster"], threads=512,
                     smem_bytes=ssd_kernel.bwd_smem_bytes(p_, n_, 2),
                     state_slots=geo["state_slots"])
    ptx = ptxas_report(build.BUILD_LOG.get("ssd_scan", (0, ""))[1],
                          "ssd_bwd_kernel", "13__nv_bfloat16")
    print(f"[geometry] ssd_scan_bwd bf16 B={b_} S={s_} H={h_} P={p_} N={n_}: "
          f"{plan['CTAs']} CTAs in clusters of {plan['cluster']} heads, "
          f"{plan['threads']} threads, {plan['smem_bytes']} B of dynamic "
          f"shared memory, {plan['registers']} registers a thread (ptxas "
          f"log: {'not in this build' if ptx is None else ptx}), "
          f"{plan['state_slots']} tile states in a scratch, {launched.value} "
          f"launches a call ({geo['groups']} group partials a (b, s))",
          flush=True)
    if any(plan[k] != v for k, v in want_plan.items()):
        fail(f"ssd_scan_bwd launch {plan} differs from the model {want_plan}")
    if launched.value != geo["launches"]:
        fail(f"ssd_scan_bwd launched {launched.value} kernels a call, not "
             f"{geo['launches']}")
    # the forward's launch at the main path's call (no initial or final
    # state): heads a CTA and shared memory as the host-side model sets them
    fplan = ssd_kernel.fwd_plan(b_, s_, h_, p_, n_, torch.bfloat16)
    fgeo = ssd_kernel.fwd_geometry(b_, s_, h_, p_, n_, 2)
    ptx = ptxas_report(build.BUILD_LOG.get("ssd_scan", (0, ""))[1],
                          "ssd_fwd_kernel", "13__nv_bfloat16", "Lb1E")
    per_sm = ("two CTAs" if fgeo["smem_bytes"] <= ssd_kernel.HALF_SM_SMEM
              else "one CTA")
    print(f"[geometry] ssd_scan_fwd bf16 B={b_} S={s_} H={h_} P={p_} N={n_}: "
          f"{fplan['CTAs']} CTAs of {fplan['heads']} heads, "
          f"{fplan['threads']} threads, {fplan['smem_bytes']} B of dynamic "
          f"shared memory ({per_sm} an SM), {fplan['registers']} registers "
          f"a thread (ptxas log: "
          f"{'not in this build' if ptx is None else ptx}), "
          f"{fplan['stages']} staging area(s), states "
          f"{'kept' if fplan['state'] else 'not kept'}, {fgeo['tiles']} "
          f"tile(s) of {ssd_kernel.FWD_TILE} tokens", flush=True)
    want_f = dict(CTAs=fgeo["ctas"], heads=fgeo["heads"],
                  threads=fgeo["threads"], smem_bytes=fgeo["smem_bytes"],
                  stages=fgeo["stages"], state=int(fgeo["state"]))
    if any(fplan[k] != v for k, v in want_f.items()):
        fail(f"ssd_scan_fwd launch {fplan} differs from the model {want_f}")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run_ssd_bwd()
        torch.cuda.synchronize()
    split = {next((n for n in ("ssd_bwd_kernel", "reduce_groups")
                   if n in ev.key), ev.key[:40]):
             ev.device_time_total / max(ev.count, 1) / 1e3
             for ev in prof.key_averages()
             if getattr(ev, "device_time_total", 0) > 0}
    print("[time] ssd_scan_bwd split by launch (torch.profiler, device ms a "
          "call): " + (", ".join(f"{k} {v:.4f}" for k, v in split.items())
                       or "not measured (no device events)"), flush=True)
    ssd_plain_ms = time_ms(run_ssd_plain, 2)
    ssd_bwd_plain_ms = time_ms(run_ssd_bwd_plain, 2)
    ssd_rec = {}
    for what, backward, ms, plain_ms, worst_ in (
            ("forward", False, ssd_ms, ssd_plain_ms, ssd_worst),
            ("backward", True, ssd_bwd_ms, ssd_bwd_plain_ms, ssd_bwd_worst)):
        nbytes, nops = ssd_work(b_, s_, h_, p_, n_, 2, backward)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS["bfloat16"]
        bound_ms = 1e3 * max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        f32_ms = 1e3 * nops / PEAK_OPS["float32"]
        print(f"[time] ssd_scan {what} bf16 B={b_} S={s_} H={h_} P={p_} "
              f"N={n_}: kernel {ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}: {nbytes} B, {nops} ops; the same operations on "
              f"float32 CUDA cores {f32_ms:.4f} ms), plain {plain_ms:.4f} ms"
              f", no single library call", flush=True)
        ssd_rec[what] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "max_abs_err": worst_}
    del sets, dys, y_out, dx_o, ddt_o, part, dbc_o, states

    # -- kernel 3, aligned flash attention: parity against the plain version
    # at every case of ALIGNED, then the timed cases (kernel through its C
    # entry; their K/V fit the L2, as a long prefill's do layer by layer)
    fa_entry = flash_aligned._entry()
    fa_worst, fa_times = 0.0, {}
    for (what, b_, sq_, sk_, hq_, hkv_, d_, causal_, window_,
         dnames) in ALIGNED:
        for dname in dnames:
            dtype = getattr(torch, dname)
            q = torch.randn((b_, sq_, hq_, d_), generator=gen,
                            device=dev).to(dtype)
            k = torch.randn((b_, sk_, hkv_, d_), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn((b_, sk_, hkv_, d_), generator=gen,
                            device=dev).to(dtype)
            got = ops.flash_attention(q, k, v, causal=causal_,
                                      window=window_)
            again = ops.flash_attention(q, k, v, causal=causal_,
                                        window=window_)
            want = flash_attention_ref(q, k, v, causal=causal_,
                                       window=window_)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"flash_attention {what} {dname}: two runs differ")
            scale = rms(want)
            atol = (min(TOL[dname], BF16_RMS_TOL * scale)
                    if dtype == torch.bfloat16 else TOL[dname])
            err = max_err(got, want, TOL[dname], f"flash_attention {what} "
                          f"{dname}", atol)
            fa_worst = max(fa_worst, err)
            print(f"[parity] flash_attention {what} {dname} (B={b_} Sq={sq_} "
                  f"Sk={sk_} Hq={hq_} Hkv={hkv_} D={d_} causal={causal_} "
                  f"window={window_}): max abs err {err:.3g} = "
                  f"{err / scale:.3g} rms(want) (gate {atol:.3g} + "
                  f"{TOL[dname]:g} |want|), two runs bit-equal", flush=True)
            if (what not in ALIGNED_TIMED or dname != dnames[0]
                    or what in fa_times):
                continue
            out = torch.empty_like(q)

            def run_fa():
                rc = fa_entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), b_, sq_, sk_, hq_, hkv_, d_,
                              int(causal_), window_,
                              0 if dtype == torch.float32 else 1, stream)
                if rc:
                    fail(f"flash_aligned_fwd returned cudaError {rc}")

            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            pos = torch.arange(sk_, device=dev)
            qp = torch.arange(sq_, device=dev)[:, None]
            band = (pos[None, :] <= qp) & (pos[None, :] > qp - window_)

            def run_sdpa():
                if window_:
                    F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=band,
                                                   enable_gqa=True)
                else:
                    F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal_,
                                                   enable_gqa=True)

            ms = time_ms(run_fa, 10)
            plain_ms = time_ms(lambda: flash_attention_ref(
                q, k, v, causal=causal_, window=window_), 1)
            library_ms = time_ms(run_sdpa, 10)
            nbytes, nops = aligned_work(b_, sq_, sk_, hq_, hkv_, d_, causal_,
                                        window_, q.element_size())
            # float32 runs three TF32 products a multiply-add: its bound is
            # theirs at the TF32 rate; the CUDA cores' is printed beside
            rate = "tf32" if dtype == torch.float32 else dname
            k_ops = 3 * nops if dtype == torch.float32 else nops
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, k_ops / PEAK_OPS[rate]
            bound_ms = 1e3 * max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            fa_times[what] = {"ms": ms, "plain_ms": plain_ms,
                              "library_ms": library_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by}
            cores = ("" if dtype != torch.float32 else
                     f"; on the CUDA cores {1e3 * max(t_bytes, nops / PEAK_OPS['float32']):.5f} ms")
            print(f"[time] flash_attention {what} {dname} (B={b_} S={sq_} "
                  f"Hq={hq_} Hkv={hkv_} D={d_} causal window={window_}, "
                  f"{flash_aligned.path(d_, dtype)} path): kernel {ms:.4f} "
                  f"ms, bound {bound_ms:.5f} ms ({bound_by}: {nbytes} B, "
                  f"{k_ops} ops at the {rate} peak{cores}), plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms", flush=True)
    aligned = dict(fa_times["bench full"], max_abs_err=fa_worst)
    # each path's launch at its timed shapes, held to the host-side models:
    # the wgmma path at qwen2-1.5b's, gemma-2b's and stablelm-12b's prefill
    # widths (head dims 128, 256 and 160 padded to 192), the float32 path
    # at the bench's full shape; ptxas's registers and spills of each
    fa_log = build.BUILD_LOG.get("flash_aligned", (0, ""))[1]
    for b_, sq_, hq_, hkv_, d_, dtype in (
            (1, 4096, 12, 2, 128, torch.bfloat16),
            (1, 4096, 8, 1, 256, torch.bfloat16),
            (1, 4096, 32, 8, 160, torch.bfloat16),
            (2, 2048, 8, 2, 128, torch.float32)):
        plan = flash_aligned.plan(b_, sq_, sq_, hq_, hkv_, d_, dtype)
        if dtype == torch.float32:
            sched = flash_aligned.tf32_schedule(b_, sq_, sq_, hq_)
            smem, threads, stages = (flash_aligned.tf32_smem(d_),
                                     flash_aligned.TF_THREADS,
                                     flash_aligned.TF_STAGES)
            kern, dp = "flash_aligned_tf32", d_
            who = "four warps"
        else:
            sched = flash_aligned.wgmma_schedule(b_, sq_, sq_, hq_, d=d_)
            smem, threads, stages = (flash_aligned.wgmma_smem(d_),
                                     flash_aligned.WG_THREADS,
                                     flash_aligned.WG_STAGES)
            kern = "flash_aligned_wgmma"
            dp = flash_aligned.wgmma_tiles(d_)["dp"]
            who = ("a producer warpgroup, two consumer warpgroups; "
                   "setmaxnreg: producer 24, consumers 240")
        tiles = sum(len(o["tiles"]) for o in sched["order"])
        masked = sum(m for o in sched["order"] for _, m in o["tiles"])
        spill = ptxas_report(fa_log, kern, f"Li{dp}E", what="spill")
        ptx = ptxas_report(fa_log, kern, f"Li{dp}E")
        print(f"[geometry] flash_aligned {flash_aligned.path(d_, dtype)} "
              f"{str(dtype).split('.')[-1]} B={b_} S={sq_} Hq={hq_} "
              f"Hkv={hkv_} D={d_} causal: {plan['CTAs']} CTAs (grid "
              f"{sched['grid']}, longest bands first), {plan['threads']} "
              f"threads ({who}), {plan['smem_bytes']} B of dynamic shared "
              f"memory, {plan['stages']} K/V stages, {plan['registers']} "
              f"registers a thread at launch (ptxas log: "
              f"{'not in this build' if ptx is None else ptx} registers, "
              f"{'?' if spill is None else spill} bytes of spill stores); "
              f"{tiles} kv tiles of {sched['bn']}, {masked} masked",
              flush=True)
        if (plan["CTAs"] != sched["grid"][0] * sched["grid"][1]
                or plan["threads"] != threads
                or plan["smem_bytes"] != smem or plan["stages"] != stages):
            fail(f"flash_aligned's launch {plan} at D={d_} {dtype} differs "
                 "from the model")
    # whether L2 serves a GQA group's K/V on the wgmma path: the same work
    # with one kv head a query head, at qwen2-1.5b's prefill width
    b_, sq_, hq_, hkv_, d_ = 1, 4096, 12, 2, 128
    q = torch.randn((b_, sq_, hq_, d_), generator=gen, device=dev).bfloat16()
    k = torch.randn((b_, sq_, hkv_, d_), generator=gen, device=dev).bfloat16()
    v = torch.randn((b_, sq_, hkv_, d_), generator=gen, device=dev).bfloat16()
    kf, vf = (x.repeat_interleave(hq_ // hkv_, dim=2).contiguous()
              for x in (k, v))
    gqa_ms = time_ms(lambda: flash_aligned.flash_attention_aligned_cuda(
        q, k, v), 10)
    mha_ms = time_ms(lambda: flash_aligned.flash_attention_aligned_cuda(
        q, kf, vf), 10)
    print(f"[time] flash_aligned wgmma, GQA group of {hq_ // hkv_} sharing "
          f"K/V through L2: {gqa_ms:.4f} ms; the same work with a kv head "
          f"a query head: {mha_ms:.4f} ms", flush=True)
    del q, k, v, kf, vf, got, again, want, out, qt, kt, vt, band
    torch.cuda.empty_cache()

    # -- small-input check: kernel path on the card vs plain path on the CPU
    small = configs.get_reduced("qwen2-1.5b")
    sp_cpu = T.init_params(small, torch.Generator().manual_seed(0),
                           device="cpu")
    sp_gpu = tree_map(lambda t: t.to(dev), sp_cpu)  # the same weights
    streams = {}
    rng = np.random.default_rng(1)
    lens = [3, 5, 8, 9, 17, 20]
    prompts = [rng.integers(0, small.vocab, n).astype(np.int32) for n in lens]
    for where, params in (("cpu", sp_cpu), ("cuda", sp_gpu)):
        eng = ServeEngine(small, params, slots=3, max_len=48, chunk=4,
                          device=where)
        reqs = [Request(uid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        streams[where] = [(r.out, r.outcome) for r in reqs]
    same = streams["cpu"] == streams["cuda"]
    print(f"[check] qwen2-smoke f32 greedy streams, card vs CPU plain path: "
          f"{'identical' if same else 'DIFFERENT'} over {len(lens)} requests",
          flush=True)
    if not same:
        fail(f"streams differ: cpu {streams['cpu']} cuda {streams['cuda']}")
    # the paged engine: fp pages, then half the page budget (16 pages of 8
    # rows for 4 slots of 32; 8 short prompts that generate 16 tokens each
    # outgrow 8 pages, so streams are preempted and requeued)
    rng = np.random.default_rng(1)
    short = [rng.integers(0, small.vocab, int(rng.integers(3, 9)))
             .astype(np.int32) for _ in range(8)]
    paged_cases = {
        "paged": (dict(slots=3, max_len=48, chunk=4, kv_paging=True,
                       kv_page_size=8), prompts, 6),
        "paged, half the pages": (dict(slots=4, max_len=32, chunk=8,
                                       kv_paging=True, kv_page_size=8,
                                       page_budget=8), short, 16),
    }
    for what, (kw, ps_, max_new) in paged_cases.items():
        got, tally = {}, {}
        for where, params in (("cpu", sp_cpu), ("cuda", sp_gpu)):
            eng = ServeEngine(small, params, device=where, **kw)
            reqs = [Request(uid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(ps_)]
            eng.run(reqs)
            got[where] = [(r.out, r.outcome) for r in reqs]
            tally[where] = eng.last_run_report["outcomes"]
        same = got["cpu"] == got["cuda"]
        print(f"[check] qwen2-smoke f32 {what} greedy streams, card vs CPU "
              f"plain path: {'identical' if same else 'DIFFERENT'} over "
              f"{len(ps_)} requests (outcomes {tally['cuda']})", flush=True)
        if not same or tally["cpu"] != tally["cuda"]:
            fail(f"{what} streams differ: cpu {got['cpu']} {tally['cpu']} "
                 f"cuda {got['cuda']} {tally['cuda']}")
        if "page_budget" in kw and tally["cuda"].get("requeued", 0) < 1:
            fail(f"{what}: no stream was requeued ({tally['cuda']})")

    # sampled decoding (the JAX engine's own Threefry draws, keyed on
    # request and token): the eager loop and the fused engine at blocks 1
    # and 8, card against CPU, all five equal
    sampled = dict(temperature=0.7, top_k=8, sample_seed=11)
    got = {}
    for where, params in (("cpu", sp_cpu), ("cuda", sp_gpu)):
        for mode, kw in (("eager", dict(fused=False)),
                         ("fused B1", dict(prefill_block=1)),
                         ("fused B8", dict(prefill_block=8))):
            eng = ServeEngine(small, params, slots=3, max_len=48, chunk=4,
                              device=where, **kw, **sampled)
            if kw.get("fused", True):
                eng.tick_sync_debug = "error"
            reqs = [Request(uid=i, prompt=p, max_new=6)
                    for i, p in enumerate(prompts)]
            eng.run(reqs)
            got[(where, mode)] = [(r.out, r.outcome) for r in reqs]
            if kw.get("fused", True):
                one_sync_a_chunk(eng.last_run_report, f"sampled {mode}")
    same = all(v == got[("cpu", "eager")] for v in got.values())
    print(f"[check] qwen2-smoke f32 sampled streams (T 0.7, top-k 8, seed "
          f"11), eager, fused B1 and fused B8, card and CPU: "
          f"{'identical' if same else 'DIFFERENT'} over {len(prompts)} "
          f"requests; equal to the greedy streams: "
          f"{got[('cuda', 'fused B8')] == streams['cuda']}", flush=True)
    if not same:
        fail(f"sampled streams differ: {got}")
    if got[("cuda", "fused B8")] == streams["cuda"]:
        fail("the sampled streams equal the greedy ones")
    # one faulted paged run with backfill, half the pages, sampled: the
    # plan's forced preemption, exhaustion window and NaN logits
    fkw = dict(slots=4, max_len=32, chunk=8, kv_paging=True, kv_page_size=8,
               page_budget=8, admit_backfill=2, faults=FaultConfig(
                   force_preempt=((1, 2),), exhaust_ticks=(4, 8),
                   nan_logits=((5, 1),)), **sampled)
    got, tally = {}, {}
    for where, params in (("cpu", sp_cpu), ("cuda", sp_gpu)):
        eng = ServeEngine(small, params, device=where, **fkw)
        eng.tick_sync_debug = "error"
        reqs = [Request(uid=i, prompt=p, max_new=16)
                for i, p in enumerate(short)]
        eng.run(reqs)
        got[where] = [(r.out, r.outcome, r.preempts) for r in reqs]
        tally[where] = eng.last_run_report["outcomes"]
        one_sync_a_chunk(eng.last_run_report, f"faulted paged run ({where})")
    same = got["cpu"] == got["cuda"] and tally["cpu"] == tally["cuda"]
    print(f"[check] qwen2-smoke f32 faulted paged run with backfill (half "
          f"the pages, sampled, {fkw['faults']}): card vs CPU "
          f"{'identical' if same else 'DIFFERENT'} over {len(short)} "
          f"requests, outcomes {tally['cuda']}", flush=True)
    if not same:
        fail(f"faulted streams differ: cpu {got['cpu']} {tally['cpu']} "
             f"cuda {got['cuda']} {tally['cuda']}")
    if got["cuda"][5][1] != "numerics" or tally["cuda"].get("requeued",
                                                             0) < 1:
        fail(f"the fault plan did not land: {got['cuda']} {tally['cuda']}")
    # page-demand backfill bypasses on the card: the two 16-token prompts
    # hold the pool, so the head waits on pages while the 4-token prompts
    # behind it fit; with admit_backfill they admit in its place, and the
    # run takes fewer ticks than FIFO admission, with the same streams
    bkw = dict(slots=2, max_len=24, chunk=8, prefill_block=4,
               kv_paging=True, kv_page_size=4, page_budget=7,
               reserve="asyougo")
    brng = np.random.default_rng(21)
    bprompts = [brng.integers(0, 64, size=n).astype(np.int32)
                for n in (16, 16, 4, 4)]
    bf_ticks, bf_got = {}, {}
    for bf in (None, 2):
        eng = ServeEngine(small, sp_gpu, device=dev, admit_backfill=bf,
                          **bkw)
        eng.tick_sync_debug = "error"
        reqs = [Request(uid=i, prompt=p, max_new=4)
                for i, p in enumerate(bprompts)]
        eng.run(reqs)
        one_sync_a_chunk(eng.last_run_report, f"admit_backfill={bf}")
        bf_ticks[bf] = eng.last_run_report["ticks"]
        bf_got[bf] = [(r.out, r.outcome) for r in reqs]
    print(f"[check] qwen2-smoke f32 page-demand backfill (7 pages of 4 "
          f"rows, prompts 16, 16, 4, 4): {bf_ticks[2]} ticks with "
          f"admit_backfill=2, {bf_ticks[None]} with FIFO admission; "
          f"streams {'identical' if bf_got[2] == bf_got[None] else 'DIFFERENT'}",
          flush=True)
    if bf_ticks[2] >= bf_ticks[None]:
        fail(f"backfill bypassed no blocked head: {bf_ticks}")
    if (bf_got[2] != bf_got[None]
            or any(o != "done" for _, o in bf_got[2])):
        fail(f"backfilled streams differ: {bf_got}")
    # the sampler's bits at qwen2's vocabulary on a grid of keys
    grid = [(seed, sid, tok) for seed in (0, 11, 2 ** 31 - 1)
            for sid in (-1, 0, 7, 49) for tok in (0, 5, 1000)]
    keys = torch.stack([prng.fold_in(prng.fold_in(
        prng.key(seed)[None], torch.tensor([sid])), torch.tensor([tok]))[0]
        for seed, sid, tok in grid])
    bits_cpu = prng.bits(keys, cfg.vocab)
    bits_gpu = prng.bits(keys.to(dev), cfg.vocab).cpu()
    g_err = (prng.gumbel(keys, cfg.vocab)
             - prng.gumbel(keys.to(dev), cfg.vocab).cpu()).abs().max().item()
    print(f"[check] Threefry bits at vocab {cfg.vocab} over {len(grid)} "
          f"(seed, sid, token) keys, card vs CPU: "
          f"{'identical' if torch.equal(bits_cpu, bits_gpu) else 'DIFFERENT'}"
          f"; Gumbel noise max abs diff {g_err:.3g}", flush=True)
    if not torch.equal(bits_cpu, bits_gpu):
        fail("the card's Threefry bits differ from the CPU's")

    # TinyTrain on qwen2-smoke: the card (Fisher kernel, flash kernel in
    # the folded engine) against the plain path on the CPU, same weights
    sbb = api.backbone("qwen2-1.5b", preset="smoke", batch_size=32, seq=16)
    stask = api.sample_lm_task(np.random.default_rng(0), small.vocab,
                               seq=16, max_way=5, support_pad=32,
                               query_pad=32)
    adapted = {}
    for where, params in (("cpu", sp_cpu), ("cuda", sp_gpu)):
        sess = api.TinyTrainSession(sbb, params, max_way=5)
        ad = sess.adapt(stask, api.JETSON_NANO, iters=4)
        eng = ServeEngine(small, params, slots=3, max_len=48, chunk=4,
                          device=where)
        ad.fold_into(eng)
        reqs = [Request(uid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        adapted[where] = (ad, [(r.out, r.outcome) for r in reqs])
    (a_cpu, s_cpu), (a_gpu, s_gpu) = adapted["cpu"], adapted["cuda"]
    loss_err = max(abs(x - y) for x, y in zip(a_cpu.losses, a_gpu.losses))
    print(f"[check] qwen2-smoke f32 TinyTrain, card vs CPU plain path: "
          f"policy {'identical' if a_cpu.policy.units == a_gpu.policy.units else 'DIFFERENT'} "
          f"({a_gpu.policy.describe()}), max loss diff {loss_err:.3g} "
          f"(tol 1e-4), folded-engine streams "
          f"{'identical' if s_cpu == s_gpu else 'DIFFERENT'}", flush=True)
    if a_cpu.policy.units != a_gpu.policy.units:
        fail(f"policies differ: {a_cpu.policy.describe()} vs "
             f"{a_gpu.policy.describe()}")
    if not loss_err <= 1e-4:
        fail(f"losses differ: {a_cpu.losses} vs {a_gpu.losses}")
    if s_cpu != s_gpu:
        fail(f"folded streams differ: cpu {s_cpu} cuda {s_gpu}")

    # personalisation on qwen2-smoke: two users' deltas resident at once in
    # the per-slot arena, card against CPU and against each user's folded
    # engine on the card (block 1 and 8, contiguous and paged)
    spol = SparseUpdatePolicy(horizon=0, units=(
        SelectedUnit(1, "attn", (0, small.n_heads - 1)),
        SelectedUnit(2, "mlp", (0, 7, small.d_ff - 1))))
    dgen = torch.Generator().manual_seed(7)
    udeltas = {u: tree_map(lambda z: 0.5 * torch.randn(
        z.shape, generator=dgen), sbb.init_deltas(spol, "cpu"))
        for u in (0, 1)}
    pers_streams = {}
    for mode, kw in (("block8", {}), ("block1", dict(prefill_block=1)),
                     ("paged", dict(kv_paging=True, kv_page_size=8))):
        for where, params in (("cpu", sp_cpu), ("cuda", sp_gpu)):
            kw_all = dict(slots=3, max_len=48, chunk=4, device=where, **kw)
            eng = ServeEngine(small, params, personalise=spol, **kw_all)
            on = params["embed"].device
            for u, d in udeltas.items():
                eng.swap_deltas(u, DeltaSet.from_policy(
                    spol, tree_map(lambda t: t.to(on), d)))
            reqs = [Request(uid=i % 2, prompt=p, max_new=6)
                    for i, p in enumerate(prompts)]
            eng.run(reqs)
            pers_streams[(mode, where)] = [(r.out, r.outcome) for r in reqs]
            if where == "cuda":
                folded = {}
                for u, d in udeltas.items():
                    fe = ServeEngine(small, fold_deltas(
                        small, params, tree_map(lambda t: t.to(on), d),
                        spol), **kw_all)
                    rr = [Request(uid=i % 2, prompt=p, max_new=6)
                          for i, p in enumerate(prompts)]
                    fe.run(rr)
                    folded[u] = [(r.out, r.outcome) for r in rr]
                pers_streams[(mode, "folded")] = [
                    folded[i % 2][i] for i in range(len(prompts))]
        same_cpu = pers_streams[(mode, "cpu")] == pers_streams[(mode, "cuda")]
        same_fold = (pers_streams[(mode, "folded")]
                     == pers_streams[(mode, "cuda")])
        print(f"[check] qwen2-smoke f32 personalised ({mode}, 2 users, "
              f"{spol.describe()}): card vs CPU "
              f"{'identical' if same_cpu else 'DIFFERENT'}, card overlay vs "
              f"card folded engines {'identical' if same_fold else 'DIFFERENT'}"
              f" over {len(prompts)} requests", flush=True)
        if not same_cpu:
            fail(f"personalised streams differ, card vs CPU ({mode}): "
                 f"{pers_streams[(mode, 'cpu')]} vs "
                 f"{pers_streams[(mode, 'cuda')]}")
        if not same_fold:
            fail(f"personalised streams differ from the folded engines on "
                 f"the card ({mode}): {pers_streams[(mode, 'cuda')]} vs "
                 f"{pers_streams[(mode, 'folded')]}")

    # TinyTrain on mamba2-smoke: the SSD kernels (forward and backward)
    # and the Fisher kernel on the card against the plain path on the CPU,
    # same weights; the folded engines serve through the recurrence
    msmall = configs.get_reduced("mamba2-1.3b")
    mp_cpu = T.init_params(msmall, torch.Generator().manual_seed(0),
                           device="cpu")
    mp_gpu = tree_map(lambda t: t.to(dev), mp_cpu)
    mbb = api.backbone("mamba2-1.3b", preset="smoke", batch_size=32, seq=16)
    mtask = api.sample_lm_task(np.random.default_rng(0), msmall.vocab,
                               seq=16, max_way=5, support_pad=32,
                               query_pad=32)
    mrng = np.random.default_rng(2)
    mprompts = [mrng.integers(0, msmall.vocab, n).astype(np.int32)
                for n in lens]
    madapted = {}
    ssd_before = (ops.ssd_scan.launches, ops.ssd_scan.bwd_launches)
    for where, params in (("cpu", mp_cpu), ("cuda", mp_gpu)):
        sess = api.TinyTrainSession(mbb, params, max_way=5)
        ad = sess.adapt(mtask, api.JETSON_NANO, iters=4)
        eng = ServeEngine(msmall, params, slots=3, max_len=48, chunk=4,
                          device=where)
        ad.fold_into(eng)
        reqs = [Request(uid=i, prompt=p, max_new=6)
                for i, p in enumerate(mprompts)]
        eng.run(reqs)
        madapted[where] = (ad, [(r.out, r.outcome) for r in reqs])
    ssd_smoke = (ops.ssd_scan.launches - ssd_before[0],
                 ops.ssd_scan.bwd_launches - ssd_before[1])
    (a_cpu, s_cpu), (a_gpu, s_gpu) = madapted["cpu"], madapted["cuda"]
    loss_err = max(abs(x - y) for x, y in zip(a_cpu.losses, a_gpu.losses))
    print(f"[check] mamba2-smoke f32 TinyTrain, card vs CPU plain path: "
          f"policy {'identical' if a_cpu.policy.units == a_gpu.policy.units else 'DIFFERENT'} "
          f"({a_gpu.policy.describe()}), max loss diff {loss_err:.3g} "
          f"(tol 1e-4), folded-engine streams "
          f"{'identical' if s_cpu == s_gpu else 'DIFFERENT'}; ssd_scan "
          f"launches {ssd_smoke[0]} forward, {ssd_smoke[1]} backward",
          flush=True)
    if a_cpu.policy.units != a_gpu.policy.units:
        fail(f"mamba2 policies differ: {a_cpu.policy.describe()} vs "
             f"{a_gpu.policy.describe()}")
    if not {u.kind for u in a_gpu.policy.units} == {"ssm"}:
        fail(f"mamba2-smoke selected no SSD unit: {a_gpu.policy.describe()}")
    if not loss_err <= 1e-4:
        fail(f"mamba2 losses differ: {a_cpu.losses} vs {a_gpu.losses}")
    if s_cpu != s_gpu:
        fail(f"mamba2 folded streams differ: cpu {s_cpu} cuda {s_gpu}")
    if min(ssd_smoke) <= 0:
        fail(f"the card's mamba2-smoke adapt launched the SSD kernels "
             f"{ssd_smoke} times")
    del mp_cpu, mp_gpu, madapted

    # -- serve: qwen2-1.5b at full width -----------------------------------
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(cfg, params, slots=8, max_len=512, chunk=32)
    eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32), max_new=2)])
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new=16)
            for i, n in enumerate(rng.integers(32, 257, 8))]
    eng.tick_sync_debug = "error"
    torch.cuda.synchronize()
    ops.flash_attention_cached.launches = 0
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.flash_attention_cached.launches
    rep = eng.last_run_report
    new_tokens = sum(len(r.out) for r in reqs)
    print(f"[serve] qwen2-1.5b bf16 full width, 8 slots, max_len 512, chunk "
          f"32, prefill_block {eng.prefill_block}: {len(reqs)} requests "
          f"(prompts {sum(len(r.prompt) for r in reqs)} tokens), "
          f"{new_tokens} new tokens in {wall:.3f} s = "
          f"{new_tokens / wall:.2f} tok/s, {rep['ticks']} ticks "
          f"({rep['ticks_issued']} issued), {rep['host_syncs']} host syncs "
          f"for {rep['chunks']} chunks, kv_cache_bytes "
          f"{eng.memory_report()['kv_cache_bytes']}, flash_cached launches "
          f"{launches}", flush=True)
    one_sync_a_chunk(rep, "serve")
    bad = [(r.uid, r.outcome, len(r.out)) for r in reqs
           if r.outcome != "done" or len(r.out) != 16
           or not all(0 <= t < cfg.vocab for t in r.out)]
    if bad:
        fail(f"requests not done with 16 in-vocabulary tokens: {bad}")
    if launches <= 0 or launches % nl:
        fail(f"flash_cached launches {launches} is not a positive multiple "
             f"of n_layers = {nl}")
    phase5 = [list(r.out) for r in reqs]
    prompts5 = [r.prompt for r in reqs]
    phase5_ticks, phase5_wall = rep["ticks"], wall
    phase5_rate = launches / phase5_ticks  # kernel 2 a live tick
    del eng

    def full_serve(reqs, sync_debug="error", **kw):
        """Serve ``reqs`` through a fresh engine on phase 5's weights: a
        warm-up request, then the kernel counts set to 0, the run (its tick
        loops under ``sync_debug``), and the counts read just after.
        Returns (engine, wall seconds, paged launches, cached launches)."""
        eng = ServeEngine(cfg, params, slots=8, max_len=512, chunk=32, **kw)
        eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                         max_new=2)])
        eng.tick_sync_debug = sync_debug
        torch.cuda.synchronize()
        ops.flash_attention_paged.launches = 0
        ops.flash_attention_cached.launches = 0
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        return (eng, time.perf_counter() - t0,
                ops.flash_attention_paged.launches,
                ops.flash_attention_cached.launches)

    def all_done(reqs, n_new, what):
        bad = [(r.uid, r.outcome, len(r.out)) for r in reqs
               if r.outcome != "done" or len(r.out) != n_new
               or not all(0 <= t < cfg.vocab for t in r.out)]
        if bad:
            fail(f"{what}: requests not done with {n_new} in-vocabulary "
                 f"tokens: {bad}")

    # -- paged serve: phase 5's requests on a paged KV cache ------------------
    row_bytes = 2 * cfg.n_kv_heads * cfg.head_dim  # K and V of one row, bf16
    stripe_bytes = DEFAULT_PAGES * PAGE_SIZE * nl * row_bytes * 2
    reqs = [Request(uid=i, prompt=p, max_new=16)
            for i, p in enumerate(prompts5)]
    eng, wall, paged_launches, cached_in_paged = full_serve(
        reqs, kv_paging=True, kv_page_size=PAGE_SIZE)
    rep, mem = eng.last_run_report, eng.last_run_report["memory"]
    table_bytes = sum(g["attn"]["page_table"].numel() * 4
                      for g in eng.caches.values())
    same = sum(list(r.out) == want for r, want in zip(reqs, phase5))
    # what a stream holds at its end, in pages, against a max_len stripe
    held = statistics.mean(-(-(len(r.prompt) + len(r.out)) // PAGE_SIZE)
                           for r in reqs)
    stripe = DEFAULT_PAGES // 8  # pages in one slot's 512-row stripe
    print(f"[paged] qwen2-1.5b bf16 full width, 8 slots, max_len 512, chunk "
          f"32, page size {PAGE_SIZE}, {mem['n_pages']} pages: "
          f"{sum(len(r.out) for r in reqs)} new tokens in {wall:.3f} s = "
          f"{sum(len(r.out) for r in reqs) / wall:.2f} tok/s, {rep['ticks']} "
          f"ticks ({rep['ticks_issued']} issued), {rep['host_syncs']} host "
          f"syncs for {rep['chunks']} chunks, peak {rep['peak_resident']} "
          f"resident; streams equal to phase 5's: {same} of {len(reqs)}; "
          f"kv_cache_bytes {mem['kv_cache_bytes']} (pages "
          f"{mem['page_bytes'] * mem['n_pages']}, fixed-stripe bytes "
          f"{stripe_bytes}, page table {table_bytes}); a stream holds "
          f"{held:.2f} pages at its end, {held * mem['page_bytes']:.0f} B = "
          f"{held / stripe:.3f}x a {stripe}-page stripe; flash_paged launches "
          f"{paged_launches}, flash_cached launches {cached_in_paged}",
          flush=True)
    all_done(reqs, 16, "paged serve")
    one_sync_a_chunk(rep, "paged serve")
    if same != len(reqs):
        fail("the paged serve's streams differ from phase 5's")
    if paged_launches <= 0 or paged_launches % nl:
        fail(f"flash_paged launches {paged_launches} is not a positive "
             f"multiple of n_layers = {nl}")
    if cached_in_paged:
        fail(f"fp pages fell through to flash_cached ({cached_in_paged} "
             "launches)")
    if mem["kv_cache_bytes"] < stripe_bytes:
        fail(f"kv_cache_bytes {mem['kv_cache_bytes']} below the fixed-stripe "
             f"bytes {stripe_bytes}")
    del eng

    # -- pressure: half the pages, streams outgrow the pool -------------------
    rng = np.random.default_rng(PRESSURE["seed"])
    lens8 = rng.integers(PRESSURE["lo"], PRESSURE["hi"], 8)
    prompts8 = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
                for n in lens8]
    demand = sum(-(-(int(n) + PRESSURE["max_new"]) // PAGE_SIZE)
                 for n in lens8)
    admit = sum(-(-int(n) // PAGE_SIZE) for n in lens8)

    def requests8():
        return [Request(uid=i, prompt=p, max_new=PRESSURE["max_new"])
                for i, p in enumerate(prompts8)]

    reqs = requests8()
    eng, wall, pressure_launches, _ = full_serve(
        reqs, kv_paging=True, kv_page_size=PAGE_SIZE,
        page_budget=PRESSURE["pages"])
    rep = eng.last_run_report
    del eng
    roomy = requests8()
    ServeEngine(cfg, params, slots=8, max_len=512, chunk=32, kv_paging=True,
                kv_page_size=PAGE_SIZE).run(roomy)
    same = sum(list(a.out) == list(b.out) for a, b in zip(reqs, roomy))
    new_tokens = sum(len(r.out) for r in reqs)
    print(f"[pressure] {PRESSURE['pages']} pages of {PAGE_SIZE} rows (half of "
          f"{DEFAULT_PAGES}); prompts {sorted(int(n) for n in lens8)} + "
          f"{PRESSURE['max_new']} new tokens need {demand} pages at their "
          f"ends ({admit} at admission): {new_tokens} new tokens in "
          f"{wall:.3f} s = {new_tokens / wall:.2f} tok/s, {rep['ticks']} "
          f"ticks ({rep['ticks_issued']} issued), {rep['host_syncs']} host "
          f"syncs for {rep['chunks']} chunks, outcomes "
          f"{rep['outcomes']}, preemptions {sum(r.preempts for r in reqs)}, "
          f"peak {rep['peak_resident']} resident where the same pages hold "
          f"{PRESSURE['pages'] // stripe} fixed stripes; streams equal to an "
          f"unpressured run: {same} of {len(reqs)} (reported, not gated); "
          f"flash_paged launches {pressure_launches}", flush=True)
    all_done(reqs, PRESSURE["max_new"], "pressure")
    one_sync_a_chunk(rep, "pressure")
    if rep["outcomes"].get("requeued", 0) < 1:
        fail(f"half the pages preempted nothing: {rep['outcomes']}")
    if pressure_launches <= 0:
        fail("the pressure phase never launched flash_paged")

    # -- int8 pages: phase 5's requests ---------------------------------------
    int8_bytes = DEFAULT_PAGES * PAGE_SIZE * nl * 2 * (
        cfg.n_kv_heads * cfg.head_dim + 4)  # int8 codes + a f32 scale a row
    reqs = [Request(uid=i, prompt=p, max_new=16)
            for i, p in enumerate(prompts5)]
    eng, wall, paged_in_int8, int8_launches = full_serve(
        reqs, sync_debug=None, kv_paging=True, kv_page_size=PAGE_SIZE,
        kv_int8=True)
    rep, mem = eng.last_run_report, eng.last_run_report["memory"]
    pages_bytes = mem["page_bytes"] * mem["n_pages"]
    same = sum(list(r.out) == want for r, want in zip(reqs, phase5))
    print(f"[int8] int8 pages + per-row scales {pages_bytes} B (expected "
          f"{int8_bytes}; bf16 pages {stripe_bytes} B: "
          f"{pages_bytes / stripe_bytes:.3f}x), kv_cache_bytes "
          f"{mem['kv_cache_bytes']}: {sum(len(r.out) for r in reqs)} new "
          f"tokens in {wall:.3f} s = {sum(len(r.out) for r in reqs) / wall:.2f}"
          f" tok/s, {rep['ticks']} ticks, {rep['host_syncs']} host syncs "
          f"for {rep['chunks']} chunks; streams equal to phase 5's: {same} "
          f"of {len(reqs)} (reported, not gated); flash_cached launches "
          f"{int8_launches} (block prefill over the gathered int8 view), "
          f"flash_paged launches {paged_in_int8}", flush=True)
    all_done(reqs, 16, "int8 pages")
    one_sync_a_chunk(rep, "int8 pages")
    if pages_bytes != int8_bytes:
        fail(f"int8 pages hold {pages_bytes} B, not {int8_bytes}")
    del eng

    # -- phase 17: sampling, the eager loop, evacuate, faults and backfill --
    t17 = time.perf_counter()

    def requests5():
        # sample ids fixed, so every engine below draws the same keys
        return [Request(uid=i, prompt=p, max_new=16, sample_id=i)
                for i, p in enumerate(prompts5)]

    def sampled_serve(what, **kw):
        reqs = requests5()
        eng, wall, _, cached = full_serve(reqs, **kw)
        rep = eng.last_run_report
        all_done(reqs, 16, what)
        one_sync_a_chunk(rep, what)
        if cached <= 0 or cached % nl:
            fail(f"{what}: flash_cached launches {cached} is not a "
                 f"positive multiple of n_layers = {nl}")
        return [list(r.out) for r in reqs], wall, rep, cached

    # the random-weight model's next token leads its runner-up by
    # ~15 logits: at T 0.7 the draws are its argmax (printed, not gated),
    # and at SAMPLE_T they are not
    cold = sampled_serve("sampled serve at T 0.7", temperature=0.7,
                         top_k=50, sample_seed=11)
    gaps = []
    for p, out in zip(prompts5[:2], phase5[:2]):
        seq = torch.tensor(np.concatenate([p, np.asarray(out, np.int32)]),
                           device=dev).long()[None]
        lg, _ = T.prefill_block(cfg, params, seq, T.init_caches(
            cfg, 1, 512), torch.zeros(1, dtype=torch.int32, device=dev))
        top = lg[0, len(p) - 1:-1].float().topk(2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
    gaps = torch.cat(gaps)
    print(f"[sampled] qwen2-1.5b bf16 full width, fused B8, T 0.7, top-k "
          f"50, seed 11: {cold[1]:.3f} s; streams equal to phase 5's greedy "
          f"ones: {sum(a == b for a, b in zip(cold[0], phase5))} of 8 (the "
          f"greedy token leads its runner-up by {gaps.min().item():.2f} to "
          f"{gaps.max().item():.2f} logits over requests 0 and 1's 16 "
          f"tokens)", flush=True)
    samp = dict(temperature=SAMPLE_T, top_k=50, sample_seed=11)
    runs17 = [sampled_serve("sampled serve", **samp) for _ in range(2)]
    s8 = runs17[0][0]
    samp_launches = cold[3] + sum(r[3] for r in runs17)
    like_greedy = sum(a == b for a, b in zip(s8, phase5))
    print(f"[sampled] fused B8, T {SAMPLE_T}, top-k 50, seed 11: "
          f"{sum(map(len, s8))} new tokens in "
          f"{runs17[0][1]:.3f} s and {runs17[1][1]:.3f} s (greedy, phase 5: "
          f"{phase5_wall:.3f} s), {runs17[0][2]['ticks']} ticks "
          f"({runs17[0][2]['ticks_issued']} issued), "
          f"{runs17[0][2]['host_syncs']} host syncs for "
          f"{runs17[0][2]['chunks']} chunks; two runs "
          f"{'bit-equal' if s8 == runs17[1][0] else 'DIFFERENT'}; streams "
          f"equal to phase 5's greedy ones: {like_greedy} of {len(s8)} "
          f"({sum(x == y for a, b in zip(s8, phase5) for x, y in zip(a, b))}"
          f" of {sum(map(len, s8))} tokens); flash_cached launches "
          f"{runs17[0][3]} a run", flush=True)
    if s8 != runs17[1][0]:
        fail("two sampled serves of the same requests differ")
    if like_greedy:
        fail(f"{like_greedy} sampled streams equal their greedy ones")

    def run_streams(reqs, **kw):
        ServeEngine(cfg, params, slots=8, max_len=512, chunk=32, **samp,
                    **kw).run(reqs)
        return [list(r.out) for r in reqs]

    # token-by-token prefill takes a tick a prompt token: fused B1 and the
    # eager loop serve the four shortest prompts (35 to 92 tokens)
    few = sorted(range(len(prompts5)), key=lambda i: len(prompts5[i]))[:4]

    def requests_few():
        return [r for i, r in enumerate(requests5()) if i in few]

    s8_few = [s8[i] for i in sorted(few)]
    t0 = time.perf_counter()
    b1 = run_streams(requests_few(), prefill_block=1)
    t_b1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    eager = run_streams(requests_few(), fused=False)
    t_eager = time.perf_counter() - t0
    # evacuate mid-run, once a stream holds half its tokens; a fresh
    # engine finishes the orphans
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, slots=8, max_len=512, chunk=4, **samp)
    reqs = requests5()
    for r in reqs:
        eng.submit(r)
    eng.fused_begin()
    while not any(len(r.out) >= 8 for r in reqs):
        eng.fused_drain(eng.fused_dispatch())
    orphans = eng.evacuate()
    drawn = sum(len(r.out) for r in orphans)
    del eng
    ServeEngine(cfg, params, slots=8, max_len=512, chunk=32,
                **samp).run(orphans)
    evac = [list(r.out) for r in reqs]
    t_evac = time.perf_counter() - t0
    print(f"[sampled] streams equal to fused B8's (printed, not gated: a bf16 "
          f"recompute may round otherwise): fused B1 "
          f"{sum(a == b for a, b in zip(b1, s8_few))} of {len(few)} "
          f"({t_b1:.3f} s), eager {sum(a == b for a, b in zip(eager, s8_few))}"
          f" of {len(few)} ({t_eager:.3f} s; equal to fused B1's: "
          f"{sum(a == b for a, b in zip(eager, b1))} of {len(few)}), "
          f"evacuated mid-run with {len(orphans)} orphans "
          f"holding {drawn} drawn tokens and resubmitted "
          f"{sum(a == b for a, b in zip(evac, s8))} of 8 ({t_evac:.3f} s)",
          flush=True)

    # greedy: phase 5's serve again with every sampler function refusing,
    # the flash kernel's launches a live tick as phase 5's
    def refuse(*a, **k):
        raise AssertionError("a greedy tick drew a sample")

    saved = {n: getattr(prng, n) for n in ("fold_in", "bits", "uniform",
                                           "gumbel")}
    for n in saved:
        setattr(prng, n, refuse)
    try:
        reqs = [Request(uid=i, prompt=p, max_new=16)
                for i, p in enumerate(prompts5)]
        eng, wall, _, cached = full_serve(reqs)
    finally:
        for n, f in saved.items():
            setattr(prng, n, f)
    rate = cached / eng.last_run_report["ticks"]
    print(f"[greedy] phase 5's serve again: no sampler call, streams "
          f"{'equal to' if [list(r.out) for r in reqs] == phase5 else 'DIFFERENT from'}"
          f" phase 5's, flash_cached launches a live tick {rate:.3f} "
          f"(phase 5: {phase5_rate:.3f})", flush=True)
    if [list(r.out) for r in reqs] != phase5 or rate != phase5_rate:
        fail("the greedy serve changed against phase 5")
    del eng

    # the sampler alone at the serve's shape: (8 slots, vocab) bf16 logits
    from torch.profiler import ProfilerActivity, profile

    lg8 = torch.randn((8, cfg.vocab), device=dev, dtype=torch.bfloat16,
                      generator=torch.Generator(device=dev).manual_seed(1))
    sid8 = torch.arange(8, dtype=torch.int32, device=dev)
    idx8 = torch.full((8,), 5, dtype=torch.int32, device=dev)
    picks = {}
    for what, kw in (("sampled", samp), ("greedy", {})):
        e = ServeEngine(cfg, params, slots=8, max_len=16, **kw)
        e._pick(lg8, sid8, idx8)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            e._pick(lg8, sid8, idx8)
            torch.cuda.synchronize()
        n_launch = sum(1 for ev in prof.events()
                       if ev.name.startswith("cudaLaunchKernel"))
        picks[what] = (time_ms(lambda e=e: e._pick(lg8, sid8, idx8), 20),
                       n_launch)
        del e
    print(f"[sampler] one pick over (8, {cfg.vocab}) bf16 logits: sampled "
          f"{picks['sampled'][0]:.4f} ms in {picks['sampled'][1]} kernel "
          f"launches, greedy {picks['greedy'][0]:.4f} ms in "
          f"{picks['greedy'][1]}; a sampled serve tick took "
          f"{1e3 * runs17[0][1] / runs17[0][2]['ticks']:.2f} ms of wall, a "
          f"greedy one {1e3 * phase5_wall / phase5_ticks:.2f} ms",
          flush=True)

    # faults and backfill on phase 8's pressure setup: NaN logits at two
    # (request, token) coordinates and one forced preemption, the rids
    # counted after full_serve's warm-up request (rid 0)
    plan = FaultConfig(nan_logits=((3, 5), (7, 20)), force_preempt=((2, 8),))
    reqs = requests8()
    eng, wall, fault_launches, _ = full_serve(
        reqs, kv_paging=True, kv_page_size=PAGE_SIZE,
        page_budget=PRESSURE["pages"], admit_backfill=2, faults=plan)
    rep = eng.last_run_report
    del eng
    typed = set(OUTCOME_NAMES.values())
    nan_at = {i: len(r.out) for i, r in enumerate(reqs)
              if r.outcome == "numerics"}
    same = sum(list(a.out) == list(b.out) for a, b in zip(reqs, roomy)
               if a.outcome == "done")
    print(f"[faults] phase 8's pressure with admit_backfill=2 and {plan}: "
          f"{sum(len(r.out) for r in reqs)} new tokens in {wall:.3f} s, "
          f"{rep['ticks']} ticks, {rep['host_syncs']} host syncs for "
          f"{rep['chunks']} chunks, outcomes {rep['outcomes']}, numerics at "
          f"(request: tokens) {nan_at}, preemptions "
          f"{sum(r.preempts for r in reqs)}; finished streams equal to the "
          f"unpressured run: {same} (reported, not gated); flash_paged "
          f"launches {fault_launches}", flush=True)
    if any(r.outcome not in typed for r in reqs):
        fail(f"faulted run: outcomes {[r.outcome for r in reqs]}")
    if nan_at != {2: 5, 6: 20}:
        fail(f"numerics at {nan_at}, not at the injected coordinates")
    if any(r.outcome != "done" for i, r in enumerate(reqs) if i not in nan_at):
        fail(f"faulted run: outcomes {[r.outcome for r in reqs]}")
    if rep["outcomes"].get("requeued", 0) < 1 or reqs[1].preempts < 1:
        fail(f"faulted run preempted nothing: {rep['outcomes']}")
    if fault_launches <= 0:
        fail("the faulted run never launched flash_paged")
    one_sync_a_chunk(rep, "faulted run")
    print(f"[phase17] {time.perf_counter() - t17:.1f} s", flush=True)
    del params
    torch.cuda.empty_cache()

    # -- adapt: examples/serve_batched.py at qwen2-1.5b's full width --------
    bb = api.backbone("qwen2-1.5b", preset="full",
                      batch_size=ADAPT["batch_size"], seq=ADAPT["seq"])
    session = api.TinyTrainSession(bb, max_way=ADAPT["max_way"], seed=0)
    # examples/serve_batched.py's profile (4 MB, compute 0.5) selects no
    # unit at this width: each unit's saved input alone is 18.9 MB
    profile = api.DeviceProfile(name="edge-lm", mem_kb=4000,
                                compute_frac=0.5).scaled(mem=500, compute=1.6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.fisher_tapgrads.launches = ops.fisher.launches = 0
    ops.flash_attention_cached.launches = 0
    t0 = time.perf_counter()
    adaptation = session.adapt(task, profile, iters=ADAPT["iters"])
    torch.cuda.synchronize()
    adapt_wall = time.perf_counter() - t0
    adapt_peak = torch.cuda.max_memory_allocated()
    eng = ServeEngine(cfg, session.params, slots=4, max_len=96, chunk=16)
    adaptation.fold_into(eng)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, size=int(rng.integers(4, 16))).astype(np.int32),
        max_new=12) for i in range(10)]
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    adapt_serve_wall = time.perf_counter() - t0
    fisher_launches = ops.fisher_tapgrads.launches + ops.fisher.launches
    adapt_flash_launches = ops.flash_attention_cached.launches
    rep = eng.last_run_report
    pol = adaptation.policy
    kinds = sorted({u.kind for u in pol.units})
    losses = adaptation.losses
    print(f"[adapt] qwen2-1.5b bf16 full width, {profile.name} "
          f"({profile.budget().mem_bytes:.0f} B, compute "
          f"{profile.compute_frac}), task {task.n_support} support rows "
          f"of {n_rows}: {pol.describe()}", flush=True)
    print(f"[adapt] fisher_seconds {adaptation.fisher_seconds:.4f}, "
          f"train_seconds {adaptation.train_seconds:.4f} "
          f"({ADAPT['iters']} steps), adapt wall {adapt_wall:.4f} s, peak "
          f"device memory {adapt_peak} B, host_transfers "
          f"{adaptation.host_transfers:g}, skipped {adaptation.skipped_steps}, "
          f"fisher launches {fisher_launches}, memory_report total_bytes "
          f"{adaptation.memory_report()['total_bytes']}", flush=True)
    print(f"[adapt] losses {[round(x, 6) for x in losses]}", flush=True)
    print(f"[adapt] folded engine: {len(reqs)} requests, "
          f"{sum(len(r.out) for r in reqs)} new tokens in "
          f"{adapt_serve_wall:.3f} s, {rep['ticks']} ticks, "
          f"{rep['host_syncs']} host syncs, outcomes {rep['outcomes']}, "
          f"flash_cached launches {adapt_flash_launches}", flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"adaptation losses must be finite and fall: {losses}")
    if adaptation.host_transfers != 2:
        fail(f"fused adapt made {adaptation.host_transfers} host transfers, "
             "not 2")
    if fisher_launches != 2:
        fail(f"the probe launched the Fisher kernel {fisher_launches} times, "
             "not once per tap group (2)")
    if kinds != ["attn", "mlp"]:
        fail(f"the profile selected {kinds}, not attention and MLP units")
    if not all(r.done and r.outcome == "done" for r in reqs):
        fail(f"folded-engine requests not done: "
             f"{[(r.uid, r.outcome) for r in reqs]}")
    if adapt_flash_launches <= 0 or adapt_flash_launches % nl:
        fail(f"the folded engine launched flash_cached "
             f"{adapt_flash_launches} times")
    del eng

    # -- personalise: per-slot deltas and the online refresh loop -----------
    P = PERSONALISE
    eng = ServeEngine(cfg, session.params, slots=P["slots"],
                      max_len=P["max_len"], chunk=P["chunk"],
                      personalise=pol)
    eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                     max_new=2)])
    eng.tick_sync_debug = "error"
    pers = Personaliser(session, eng, pol, profile=profile,
                        iters=P["iters"], seq=P["seq"])
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i % P["users"], prompt=rng.integers(
        0, cfg.vocab, size=int(rng.integers(4, 24))).astype(np.int32),
        max_new=P["max_new"]) for i in range(P["requests"])]
    leaves = tree_leaves(session.backbone.init_deltas(pol, dev))
    leaves_per_user = len(leaves)
    largest = max(t.numel() for t in leaves)
    if largest != GQ_LEAF[0] * GQ_LEAF[1]:
        fail(f"phase 10's largest delta leaf has {largest} elements; "
             f"grad_quant was timed at {GQ_LEAF}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.grad_quant.launches = ops.flash_attention_cached.launches = 0
    t0 = time.perf_counter()
    online = pers.run_online(reqs)
    torch.cuda.synchronize()
    pers_wall = time.perf_counter() - t0
    gq_launches = ops.grad_quant.launches
    pers_flash_launches = ops.flash_attention_cached.launches
    pers_peak = torch.cuda.max_memory_allocated()
    mem = eng.memory_report()
    refreshes = online["refreshes"]
    refreshed = sum(len(r["users"]) for r in refreshes)
    new_tokens = sum(len(r.out) for r in reqs)
    adapt_s = sum(r["adapt_seconds"] for r in refreshes)
    swap_s = sum(r["swap_seconds"] for r in refreshes)
    print(f"[personalise] qwen2-1.5b bf16 full width, {P['slots']} slots, "
          f"max_len {P['max_len']}, chunk {P['chunk']}, {P['users']} users, "
          f"policy {len(pol.units)} units ({leaves_per_user} delta leaves a "
          f"user, the largest {largest} elements, grad_quant's timing "
          f"shape): {len(reqs)} requests, {new_tokens} new tokens in "
          f"{pers_wall:.3f} s = {new_tokens / pers_wall:.2f} tok/s with "
          f"refreshes (wall less adapt and swap {pers_wall - adapt_s - swap_s:.3f}"
          f" s), "
          f"{online['rounds']} rounds, {online['ticks']} ticks, "
          f"{online['host_syncs']} host syncs for {online['chunks']} chunks; "
          f"peak device memory "
          f"{pers_peak} B, delta arena {mem['delta_arena_bytes']} B "
          f"({mem['delta_bytes_per_stream']} B a slot; a folded copy "
          f"{mem['params_bytes_folded_copy']} B); grad_quant launches "
          f"{gq_launches}, flash_cached launches {pers_flash_launches}",
          flush=True)
    for r in refreshes:
        print(f"[personalise] refresh {r['round']}: users {r['users']} "
              f"(deferred {r['deferred_users']}), adapt_seconds "
              f"{r['adapt_seconds']:.4f}, swap_seconds {r['swap_seconds']:.6f}"
              f", resident rows swapped {r['resident_rows_swapped']}, wire "
              f"{r['payload_bytes_wire']} B vs f32 {r['payload_bytes_f32']} B"
              f" = {r['payload_ratio']:.4f}x", flush=True)
    all_done(reqs, P["max_new"], "personalise")
    one_sync_a_chunk(online, "personalise")
    if not refreshes:
        fail("the personalised serve refreshed no user")
    if gq_launches <= 0 or gq_launches != refreshed * leaves_per_user:
        fail(f"grad_quant launched {gq_launches} times for {refreshed} "
             f"refreshed users of {leaves_per_user} leaves each")
    if min(r["payload_ratio"] for r in refreshes) <= 3.9:
        fail(f"payload ratio {[r['payload_ratio'] for r in refreshes]} not "
             "above 3.9")
    if pers_flash_launches <= 0 or pers_flash_launches % nl:
        fail(f"the personalised serve launched flash_cached "
             f"{pers_flash_launches} times")

    del eng, pers, session, adaptation
    torch.cuda.empty_cache()

    # -- adapt mamba2: mamba2-1.3b at full width, adapt -> fold -> serve ----
    # phase 6's episode shape and profile on the ssm family: the probe and
    # the fine-tune run every SSD layer's scan through the forward kernel
    # and back-propagate through the backward kernel; the folded engine
    # serves through the recurrence (no SSD kernel)
    mcfg = configs.get_config("mamba2-1.3b")
    mnl = mcfg.n_layers
    mbb = api.backbone("mamba2-1.3b", preset="full",
                       batch_size=ADAPT["batch_size"], seq=ADAPT["seq"])
    msession = api.TinyTrainSession(mbb, max_way=ADAPT["max_way"], seed=0)
    mtask = api.sample_lm_task(np.random.default_rng(0), mcfg.vocab,
                               seq=ADAPT["seq"], max_way=ADAPT["task_way"],
                               support_pad=ADAPT["pad"],
                               query_pad=ADAPT["pad"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.fisher_tapgrads.launches = ops.fisher.launches = 0
    ops.ssd_scan.launches = ops.ssd_scan.bwd_launches = 0
    ssd_kernel.bwd_kernels = 0
    t0 = time.perf_counter()
    madapt = msession.adapt(mtask, profile, iters=ADAPT["iters"])
    torch.cuda.synchronize()
    madapt_wall = time.perf_counter() - t0
    madapt_peak = torch.cuda.max_memory_allocated()
    m_fisher = ops.fisher_tapgrads.launches + ops.fisher.launches
    ssd_launches = ops.ssd_scan.launches
    ssd_bwd_launches = ops.ssd_scan.bwd_launches
    ssd_bwd_kernels = ssd_kernel.bwd_kernels
    ssd_geo = ssd_kernel.bwd_geometry(ADAPT["batch_size"], ADAPT["seq"],
                                      mcfg.n_ssm_heads)
    eng = ServeEngine(mcfg, msession.params, slots=4, max_len=96, chunk=16)
    madapt.fold_into(eng)
    eng.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                     max_new=2)])
    eng.tick_sync_debug = "error"
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, mcfg.vocab, size=int(rng.integers(4, 16))).astype(np.int32),
        max_new=12) for i in range(10)]
    ops.ssd_scan.launches = 0
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    mserve_wall = time.perf_counter() - t0
    serve_ssd = ops.ssd_scan.launches
    rep = eng.last_run_report
    mpol = madapt.policy
    mlosses = madapt.losses
    new_tokens = sum(len(r.out) for r in reqs)
    print(f"[mamba2] mamba2-1.3b bf16 full width ({mnl} layers, d_model "
          f"{mcfg.d_model}, {mcfg.n_ssm_heads} SSD heads of "
          f"{mcfg.ssm_head_dim}, state {mcfg.ssm_state}), {profile.name}, "
          f"task {mtask.n_support} support rows of "
          f"{len(mtask.support['episode_labels'])}: {mpol.describe()}",
          flush=True)
    print(f"[mamba2] fisher_seconds {madapt.fisher_seconds:.4f}, "
          f"train_seconds {madapt.train_seconds:.4f} ({ADAPT['iters']} "
          f"steps), adapt wall {madapt_wall:.4f} s, peak device memory "
          f"{madapt_peak} B, host_transfers {madapt.host_transfers:g}, "
          f"skipped {madapt.skipped_steps}, fisher launches {m_fisher}, "
          f"ssd_scan launches {ssd_launches} forward, {ssd_bwd_launches} "
          f"backward ({ssd_bwd_kernels} device kernels: "
          f"{ssd_geo['launches']} a backward, the forward never re-run)",
          flush=True)
    print(f"[mamba2] losses {[round(x, 6) for x in mlosses]}", flush=True)
    print(f"[mamba2] folded engine: {len(reqs)} requests, {new_tokens} new "
          f"tokens in {mserve_wall:.3f} s = {new_tokens / mserve_wall:.2f} "
          f"tok/s, {rep['ticks']} ticks ({rep['ticks_issued']} issued), "
          f"{rep['host_syncs']} host syncs for {rep['chunks']} chunks, "
          f"outcomes {rep['outcomes']}, recurrent state "
          f"{rep['memory']['kv_cache_bytes']} B, ssd_scan launches "
          f"{serve_ssd} (the serve runs the recurrence)", flush=True)
    if not all(math.isfinite(x) for x in mlosses):
        fail(f"mamba2 adaptation losses must be finite: {mlosses}")
    if madapt.host_transfers != 2:
        fail(f"the mamba2 adapt made {madapt.host_transfers} host transfers, "
             "not 2")
    if m_fisher != 1:
        fail(f"the mamba2 probe launched the Fisher kernel {m_fisher} times, "
             "not once (one tap group)")
    if {u.kind for u in mpol.units} != {"ssm"}:
        fail(f"the profile selected no SSD unit: {mpol.describe()}")
    if ssd_launches <= 0 or ssd_launches % mnl:
        fail(f"ssd_scan forward launches {ssd_launches} is not a positive "
             f"multiple of n_layers = {mnl}")
    if ssd_bwd_launches <= 0:
        fail("the mamba2 adapt never launched the SSD backward kernel")
    if ssd_bwd_kernels != ssd_geo["launches"] * ssd_bwd_launches:
        fail(f"the mamba2 adapt's {ssd_bwd_launches} SSD backwards launched "
             f"{ssd_bwd_kernels} kernels, not {ssd_geo['launches']} each")
    if not all(r.done and r.outcome == "done" for r in reqs):
        fail(f"mamba2 folded-engine requests not done: "
             f"{[(r.uid, r.outcome) for r in reqs]}")
    one_sync_a_chunk(rep, "mamba2 serve")
    # the same folded weights and requests from a paged engine: the pool
    # and admission in pages, and no page store (the SSD state is not paged)
    del eng
    eng = ServeEngine(mcfg, msession.params, slots=4, max_len=96, chunk=16,
                      kv_paging=True, kv_page_size=PAGE_SIZE)
    madapt.fold_into(eng)
    eng.tick_sync_debug = "error"
    preqs = [Request(uid=r.uid, prompt=r.prompt, max_new=12) for r in reqs]
    t0 = time.perf_counter()
    eng.run(preqs)
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t0
    prep = eng.last_run_report
    psame = [r.out for r in preqs] == [r.out for r in reqs]
    print(f"[mamba2] paged folded engine ({eng.spec.n_pages} pages of "
          f"{PAGE_SIZE}, no page store, SSD state "
          f"{eng.ssm_state_bytes_per_slot} B a slot): {len(preqs)} requests "
          f"in {pwall:.3f} s, {prep['ticks']} ticks, {prep['host_syncs']} "
          f"host syncs for {prep['chunks']} chunks, outcomes "
          f"{prep['outcomes']}, streams "
          f"{'equal to' if psame else 'DIFFERENT FROM'} the contiguous ones",
          flush=True)
    if not all(r.outcome == "done" for r in preqs) or not psame:
        fail(f"the paged mamba2 serve: {[(r.outcome, r.out) for r in preqs]}"
             f" against {[r.out for r in reqs]}")
    one_sync_a_chunk(prep, "mamba2 paged serve")
    del eng, msession, madapt
    torch.cuda.empty_cache()

    # -- kernel bench: the twin of benchmarks/kernel_bench.py --------------
    # the path that runs kernel 3 (and every other kernel at the reference
    # bench's full shapes); its record goes to the build directory
    spec = importlib.util.spec_from_file_location(
        "kernel_bench", os.path.join(ROOT, "benchmarks_torch",
                                     "kernel_bench.py"))
    kb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kb)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    bench = kb.main(quick=False, device="cuda",
                    out=os.path.join(ROOT, "build", "BENCH_torch_kernels.json"))
    bench_launches = ops.flash_attention.launches
    for r in bench["rows"]:
        lib = ("-" if r["library_ms"] is None else f"{r['library_ms']:.4f}")
        print(f"[bench] {r['name']} {r['shape']}: {r['ms']:.4f} ms "
              f"({r['ms_min']:.4f}-{r['ms_max']:.4f} over {r['trials']} "
              f"trials of {r['inner']}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), library {lib} ms, "
              f"max abs err {r['max_abs_err']:.3g} (tol {r['tol']:g})",
              flush=True)
    print(f"[bench] kernel_bench --full in {time.perf_counter() - t0:.1f} s, "
          f"{len(bench['rows'])} rows, flash_aligned launches "
          f"{bench_launches}", flush=True)
    bad = kb.check(bench)
    if bad:
        fail(f"kernel_bench: {bad}")
    if bench_launches <= 0:
        fail("the kernel bench never launched the aligned flash kernel")
    torch.cuda.empty_cache()

    # -- phase 13: examples/quickstart.py on the card -----------------------
    # the edge-CNN path's convolutions are cuDNN's; none of the port's
    # kernels lies on it, so every launch count stays 0 over 13 and 14
    from repro_torch.core import adapt as telemetry
    from repro_torch.models.edge_cnn import cnn_total_costs

    kernel_launches(ops, zero=True)
    qs = QUICKSTART
    qbb = api.backbone(qs["arch"], in_res=qs["in_res"],
                       batch_size=qs["batch_size"])
    qsession = api.TinyTrainSession(qbb, max_way=qs["max_way"], seed=0)
    qtask = api.sample_task(np.random.default_rng(0), qs["domain"],
                            res=qs["in_res"], max_way=qs["max_way"],
                            support_pad=qs["support_pad"],
                            query_pad=qs["query_pad"])
    qprofile = api.RPI_ZERO
    acc_before = qsession.evaluate(qtask)
    syncs = telemetry.host_sync_count()
    t0 = time.perf_counter()
    qa = qsession.adapt(qtask, qprofile, iters=qs["iters"])
    torch.cuda.synchronize()
    q_wall = time.perf_counter() - t0
    syncs = telemetry.host_sync_count() - syncs
    report = qa.memory_report()
    print(f"[quickstart] {qs['arch']} in_res {qs['in_res']} "
          f"({qbb.cfg.n_layers} conv layers), task {qtask.name} "
          f"{qtask.n_support} support rows of "
          f"{len(qtask.support['episode_labels'])}, {qprofile.name}: "
          f"policy {qa.policy.describe()}", flush=True)
    print(f"[quickstart] fisher probe {qa.fisher_seconds:.4f} s, fine-tune "
          f"{qa.train_seconds:.4f} s ({qs['iters']} steps), adapt wall "
          f"{q_wall:.4f} s, backward memory {report['total_bytes'] / 1e3:.1f}"
          f" KB (budget {qprofile.mem_kb:.0f} KB on {qprofile.name}), "
          f"host transfers {syncs}, accuracy {acc_before * 100:.1f}% -> "
          f"{qa.accuracy() * 100:.1f}%", flush=True)
    if qa.policy.n_units < 1:
        fail("the quickstart's policy selects no unit")
    if not all(math.isfinite(x) for x in qa.losses):
        fail(f"quickstart losses must be finite: {qa.losses}")
    if report["total_bytes"] > qprofile.mem_kb * 1e3:
        fail(f"the quickstart's policy needs {report['total_bytes']} B, "
             f"over the budget")
    if qa.host_transfers != 2 or syncs != 2:
        fail(f"the quickstart's fused adapt made {syncs} host transfers, "
             "not 2")
    again = qsession.adapt(qtask, qprofile, iters=qs["iters"])
    print(f"[quickstart] a second card run: losses and deltas "
          f"{'bit-equal' if same_adapt(qa, again) else 'DIFFER'}", flush=True)
    if not same_adapt(qa, again):
        fail(f"two card runs of the quickstart differ by "
             f"{adapt_gap(qa, again)}")
    card_vs_cpu(api, qsession, qtask, qprofile, qa, "quickstart")
    del qsession, qa, again

    # -- phase 14: the paper's backbones at in_res 84, then the users -------
    pp = PAPER
    pprofile = api.STM32F746.scaled(mem=pp["mem"])

    def paper_task(rng, domain, **kw):
        kw = {"support_pad": pp["support_pad"], "query_pad": pp["query_pad"],
              "max_support_total": pp["support_total"],
              "max_support_per_class": pp["per_class"], **kw}
        return api.sample_task(rng, domain, res=pp["in_res"],
                               max_way=pp["max_way"], **kw)

    sessions = {}
    for arch in pp["archs"]:
        bb = api.backbone(arch, in_res=pp["in_res"],
                          batch_size=pp["batch_size"])
        session = api.TinyTrainSession(bb, max_way=pp["max_way"], seed=0)
        task = paper_task(np.random.default_rng(0), pp["domain"])
        acc0 = session.evaluate(task)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        syncs = telemetry.host_sync_count()
        t0 = time.perf_counter()
        a = session.adapt(task, pprofile, iters=pp["iters"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        syncs = telemetry.host_sync_count() - syncs
        n_params, macs = cnn_total_costs(bb.cfg)
        print(f"[paper] {arch} ({bb.cfg.name}, {bb.cfg.n_layers} conv "
              f"layers, {n_params} params, {macs} MACs an image at in_res "
              f"{pp['in_res']}), batch {len(task.support['episode_labels'])}"
              f", {pprofile.name}: {a.policy.describe()}; fisher_seconds "
              f"{a.fisher_seconds:.4f}, train_seconds {a.train_seconds:.4f} "
              f"({pp['iters']} steps), adapt wall {wall:.4f} s, peak "
              f"{torch.cuda.max_memory_allocated()} B, backward memory "
              f"{a.memory_report()['total_bytes']:.0f} B, host transfers "
              f"{syncs}, accuracy {acc0:.4f} -> {a.accuracy():.4f}",
              flush=True)
        if a.policy.n_units < 1:
            fail(f"{arch}: {pprofile.name} selects no unit, so no fine-tune "
                 "ran")
        if not all(math.isfinite(x) for x in a.losses):
            fail(f"{arch} losses must be finite: {a.losses}")
        if a.host_transfers != 2 or syncs != 2:
            fail(f"{arch}: the fused adapt made {syncs} host transfers")
        card_vs_cpu(api, session, task, pprofile, a, f"paper {arch}")
        sessions[arch] = session

    # examples/ondevice_adaptation.py on mcunet, up to its mesh= part
    session = sessions["mcunet"]
    for arch in pp["archs"][1:]:
        del sessions[arch]
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    user_tasks, store = [], {}
    for uid, domain in USERS:
        task = paper_task(rng, domain)
        t0 = time.perf_counter()
        a = session.adapt(task, pprofile, iters=pp["iters"])
        dt = time.perf_counter() - t0
        user_tasks.append(task)
        store[uid] = a
        print(f"[users] {uid} ({domain}): adapted in {dt:.3f} s (fisher "
              f"{a.fisher_seconds:.4f} s), {a.delta_param_count()} delta "
              f"params, {a.policy.describe()}, query acc "
              f"{a.accuracy() * 100:.1f}%", flush=True)
    policy = store["user-a"].policy

    def fleet_vs_adapt(tasks, what):
        """``adapt_many`` of ``tasks`` at the parity steps against each
        task's own ``adapt``, held as the card is held to the CPU: losses
        within 1e-4 and equal accuracy (the deltas' gap is printed: Adam
        turns a rounding difference in a gradient near its eps into one of
        up to lr a step)."""
        worst, bits, accs = (0.0, 0.0), True, True
        fleet = session.adapt_many(tasks, pprofile, iters=PARITY_ITERS,
                                   policy_override=policy)
        for t, f in zip(tasks, fleet):
            one = session.adapt(t, pprofile, iters=PARITY_ITERS,
                                policy_override=policy)
            gap = adapt_gap(f, one)
            worst = tuple(max(x, y) for x, y in zip(worst, gap))
            bits = bits and same_adapt(f, one)
            accs = accs and f.accuracy() == one.accuracy()
        print(f"[users] {what} against each task's own adapt on the card: "
              f"max loss diff {worst[0]:.3g} (tol 1e-4), max delta diff "
              f"{worst[1]:.3g}, accuracies {'equal' if accs else 'DIFFER'}, "
              f"{'bit-equal' if bits else 'not bit-equal'}", flush=True)
        if not worst[0] <= 1e-4 or not accs:
            fail(f"{what}: adapt_many differs from adapt by {worst}"
                 f"{'' if accs else ' and in accuracy'}")

    t0 = time.perf_counter()
    fleet = session.adapt_many(user_tasks, pprofile, iters=pp["iters"],
                               policy_override=policy)
    dt = time.perf_counter() - t0
    print(f"[users] adapt_many: {len(fleet)} users in {dt:.3f} s under "
          f"user-a's policy (query accs "
          f"{', '.join(f'{a.accuracy() * 100:.0f}%' for a in fleet)}), "
          f"{session.last_fleet_report['groups']} group(s)", flush=True)
    fleet_vs_adapt(user_tasks, "adapt_many of the four users")
    het = [paper_task(rng, domain, min_way=2 + i % 4, support_pad=None,
                      query_pad=None, max_support_total=6 + 7 * (i % 3),
                      max_support_per_class=8, query_per_class=4)
           for i, (_, domain) in enumerate(USERS * 2)]
    shapes = {t.support["episode_labels"].shape[0] for t in het}
    t0 = time.perf_counter()
    het_fleet = session.adapt_many(het, pprofile, iters=pp["iters"],
                                   policy_override=policy)
    dt = time.perf_counter() - t0
    rep = session.last_fleet_report
    print(f"[users] heterogeneous fleet: {len(het)} users, {len(shapes)} "
          f"episode shapes -> {rep['buckets']} buckets, {rep['groups']} "
          f"groups in {dt:.3f} s", flush=True)
    if rep["buckets"] >= len(shapes) or rep["groups"] != rep["buckets"]:
        fail(f"the heterogeneous fleet's grouping: {rep}")
    if not all(math.isfinite(x) for a in het_fleet for x in a.losses):
        fail("heterogeneous fleet losses must be finite")
    fleet_vs_adapt(het, "the heterogeneous fleet")
    a = store["user-b"]
    folded = a.fold_into(session.params)
    batch = {"images": torch.as_tensor(user_tasks[1].query["images"],
                                       device=dev)}
    with torch.no_grad():
        want = session.backbone.features(session.params, batch,
                                         deltas=a.deltas, plan=a.policy)
        got = session.backbone.features(folded, batch)
    torch.cuda.synchronize()
    fold_err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"[users] user-b's deltas folded into a serving copy: features "
          f"max abs diff {fold_err:.3g} against the delta forward (tol "
          f"{1e-5 * scale:.3g} = 1e-5 max |want|)", flush=True)
    if not fold_err <= 1e-5 * scale:
        fail(f"folded features differ from the delta forward by {fold_err}")
    cnn_launches = kernel_launches(ops)
    print(f"[paper] the port's kernel launches over phases 13 and 14: "
          f"{cnn_launches}", flush=True)
    if any(cnn_launches.values()):
        fail(f"the edge-CNN path launched a kernel: {cnn_launches}")
    del session, sessions, folded
    torch.cuda.empty_cache()

    # -- phase 15: the paper's baselines and criteria on mcunet -------------
    # f32 with TF32 off, phase 14's task shape and profile; none of the
    # port's kernels lies on this path (cuDNN convolutions)
    kernel_launches(ops, zero=True)
    paper_baselines(api, dev, dict(pp, arch="mcunet"), pprofile,
                    BASELINES + CRITERIA, pp["iters"], PARITY_ITERS)
    base_launches = kernel_launches(ops)
    print(f"[baselines] the port's kernel launches over phase 15: "
          f"{base_launches}", flush=True)
    if any(base_launches.values()):
        fail(f"the baselines' CNN path launched a kernel: {base_launches}")
    torch.cuda.empty_cache()

    # -- phase 16: adapt_many's criterion route (kernel 1's task axis) ------
    # phase 6's backbone, profile and task (48 support rows, bucket 64) and
    # three tasks of 12 rows (bucket 16), 64 tokens, no override
    from repro_torch.data import lm_episode

    bb = api.backbone("qwen2-1.5b", preset="full",
                      batch_size=ADAPT["batch_size"], seq=ADAPT["seq"])
    session = api.TinyTrainSession(bb, max_way=ADAPT["max_way"], seed=0)
    rng = np.random.default_rng(16)
    ftasks = [api.sample_lm_task(
        np.random.default_rng(0), cfg.vocab, seq=ADAPT["seq"],
        max_way=ADAPT["task_way"], support_pad=ADAPT["pad"],
        query_pad=ADAPT["pad"])]
    for shots in FLEET_SHOTS:
        ep = lm_episode(rng, cfg.vocab, ADAPT["seq"], max_way=3, min_way=3,
                        shots=shots, query_per_class=8)
        ftasks.append(api.Task.from_episode(ep, rng, ADAPT["task_way"]))
    kernel_launches(ops, zero=True)
    fleet, fleet_wall, fleet_launches, captured = fleet_probe(
        api, ops, session, ftasks, profile, FLEET_ITERS,
        FISHER_TOL["bfloat16"], "qwen2-1.5b bf16")
    tap_groups = sum(len(grp) for grp in bb.make_taps(1, "cpu").values())
    want_launches = tap_groups * session.last_fleet_report["buckets"]
    if fleet_launches != want_launches or len(captured) != \
            session.last_fleet_report["buckets"]:
        fail(f"the fleet probe launched the Fisher kernel {fleet_launches} "
             f"times, not once per tap group per shape group "
             f"({want_launches})")
    # each task's scores: bit-equal to a one-task launch on its own tap
    # gradients, within FISHER_TOL of the plain version
    ops.fisher_tapgrads.launches = 0
    c_worst, c_bits = 0.0, True
    for tg, ns, mask, _ in captured:
        for gk, grp in tg.items():
            for kind, g in grp.items():
                got = ops.fisher_tapgrads(g, ns, mask)
                want = fisher_tapgrads_ref(g, ns, mask)
                c_worst = max(c_worst, max_err(
                    got, want, FISHER_TOL["float32"],
                    f"the fleet's {gk}/{kind} reduction"))
                for t in range(g.shape[0]):
                    one = ops.fisher_tapgrads(g[t].contiguous(), float(ns[t]),
                                              mask[t].contiguous())
                    c_bits = c_bits and torch.equal(got[t], one)
    sync(dev)
    fleet_single = ops.fisher_tapgrads.launches  # the checks', not counted
    shapes = [tuple(g.shape) for tg, *_ in captured for grp in tg.values()
              for g in grp.values()]
    print(f"[fleet] the captured reductions {shapes} ({g.dtype}): max abs "
          f"err against the plain version "
          f"{c_worst:.3g} (tol {FISHER_TOL['float32']:g}), each task "
          f"{'bit-equal to' if c_bits else 'DIFFERS FROM'} a one-task launch "
          f"({fleet_single} check launches)", flush=True)
    if not c_bits:
        fail("a fleet task's scores differ from a one-task launch's")
    fisher_tasks["max_abs_err"] = max(fisher_tasks["max_abs_err"], c_worst)
    del session, fleet, captured
    torch.cuda.empty_cache()
    # the same route on mcunet: the CNN's reduction is plain torch
    bb = api.backbone("mcunet", in_res=pp["in_res"],
                      batch_size=pp["batch_size"])
    session = api.TinyTrainSession(bb, max_way=pp["max_way"], seed=0)
    kernel_launches(ops, zero=True)
    fleet_probe(api, ops, session, user_tasks, pprofile, FLEET_ITERS,
                FISHER_TOL["float32"], "mcunet f32")
    cnn_fleet_launches = kernel_launches(ops)
    if any(cnn_fleet_launches.values()):
        fail(f"the CNN fleet probe launched a kernel: {cnn_fleet_launches}")
    del session
    torch.cuda.empty_cache()

    # -- phase 18: the moe family (mixtral-8x7b, deepseek-v3-671b) ----------
    moe = phase18(api, configs, ops, T, ServeEngine, Request, DeltaSet,
                  SelectedUnit, SparseUpdatePolicy, fold_deltas, tree_map,
                  tree_leaves, flash_attention, flash_paged, fisher_kernel,
                  flash_attention_cached_ref, fisher_tapgrads_ref, dev, gen)
    moe_launches = moe["launches"]

    # -- phase 19: the ssm-based families finished (zamba2, paging and
    # personalisation of mamba2 and zamba2) ------------------------------
    hyb = phase19(dev, gen, profile)
    hyb_launches, hyb_err = hyb["launches"], hyb["max_abs_err"]
    flash["max_abs_err"] = max(flash["max_abs_err"], hyb_err["flash_cached"])
    paged["max_abs_err"] = max(paged["max_abs_err"], hyb_err["flash_paged"])
    fisher["max_abs_err"] = max(fisher["max_abs_err"], hyb_err["fisher"])
    for what in ("forward", "backward"):
        key = "ssd_scan" if what == "forward" else "ssd_scan_bwd"
        ssd_rec[what]["max_abs_err"] = max(ssd_rec[what]["max_abs_err"],
                                           hyb_err[key])

    # -- phase 20: the encoder-decoder and VLM families (whisper-base,
    # paligemma-3b) ------------------------------------------------------
    enc = phase20(dev, gen)
    enc_launches, enc_err = enc["launches"], enc["max_abs_err"]
    flash["max_abs_err"] = max(flash["max_abs_err"], enc_err["flash_cached"])
    paged["max_abs_err"] = max(paged["max_abs_err"], enc_err["flash_paged"])
    fisher["max_abs_err"] = max(fisher["max_abs_err"], enc_err["fisher"])

    # -- phase 21: block scoring and the fleet (score_stream, FleetRouter,
    # the delta payload exchange, the mesh fleet) -----------------------
    fl = phase21(dev, gen, pol, profile)
    fl_launches = fl["launches"]

    # -- phase 22: the training launcher (launch.train, runtime.Trainer,
    # checkpoints) --------------------------------------------------------
    tr_launches = phase22(dev)

    # -- phase 23: the planning tools (launch.dryrun, reanalyze, the
    # roofline table, the analyser on the card, --production-mesh) -------
    phase23(ops, dev, gen, planner)

    # -- phase 24: the overlay registry (a declarative kind and a raw
    # folder from outside the package) and the capped MoE decode -------
    reg_launches = phase24(ops, dev, gen)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_aligned.cu",
        "replaces": "src/repro/kernels/flash_attention.py:38",
        "launches": bench_launches,
        **aligned,
    }, {
        "name": "flash_attention_cached",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_cached.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "launches": (launches + int8_launches + adapt_flash_launches
                     + pers_flash_launches + samp_launches
                     + moe_launches["flash_cached"]
                     + hyb_launches["flash_cached"]
                     + enc_launches["flash_cached"]
                     + fl_launches["flash_cached"] + reg_launches),
        **flash,
    }, {
        "name": "flash_attention_cached_sq32",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_cached.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "launches": fl_launches["score"],
        **fl["score_kernel"],
    }, {
        "name": "flash_attention_paged",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_paged.cu",
        "replaces": "src/repro/kernels/flash_attention.py:157",
        "launches": (paged_launches + pressure_launches + fault_launches
                     + moe_launches["flash_paged"]
                     + hyb_launches["flash_paged"]
                     + enc_launches["flash_paged"]
                     + fl_launches["flash_paged"]),
        **paged,
    }, {
        "name": "fisher_tapgrads",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fisher.cu",
        "replaces": "src/repro/kernels/fisher.py:66",
        "launches": (fisher_launches + m_fisher + moe_launches["fisher"]
                     + hyb_launches["fisher"] + enc_launches["fisher"]),
        **fisher,
    }, {
        "name": "fisher_tapgrads_tasks",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fisher.cu",
        "replaces": "src/repro/kernels/fisher.py:66",
        "launches": fleet_launches + fl_launches["fisher_tasks"],
        **fisher_tasks,
    }, {
        "name": "grad_quant",
        "route": "cuda",
        "source": "src/repro_torch/csrc/grad_quant.cu",
        "replaces": "src/repro/kernels/grad_quant.py:57",
        "launches": (gq_launches + hyb_launches["grad_quant"]
                     + fl_launches["grad_quant"]),
        **gquant,
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:22",
        "launches": (ssd_launches + hyb_launches["ssd_scan"]
                     + tr_launches["ssd_scan"]),
        **ssd_rec["forward"],
    }, {
        "name": "ssd_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "none: no TPU kernel (XLA autodiff of "
                    "src/repro/models/ssm.py:78 ssd_chunked)",
        "launches": (ssd_bwd_launches + hyb_launches["ssd_scan_bwd"]
                     + tr_launches["ssd_scan_bwd"]),
        **ssd_rec["backward"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
