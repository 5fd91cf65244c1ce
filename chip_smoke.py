#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100):
builds the CUDA kernels from this checkout, holds each against its plain
PyTorch version at its path's full-width shapes, serves qwen2.5-3b at its
published width through ``repro_torch.api.Session`` (direct, wave,
continuous and speculative continuous modes), trains it on the fused and on
the barrier DP tier at full width and 12 layers (the barrier tier also
under the per-leaf policy), clips its per-example gradients on both routes,
serves rwkv6-7b and zamba2-7b at published width and full depth (direct
and wave), runs the wire tier's protocol rounds on MNIST-MLP3 at its
published width (serial and pipelined), trains rwkv6-7b and zamba2-7b at
published width and cut depth on the fused and barrier tiers (the scans'
backward kernels), and checks a serving slice of each
family (plain and speculative for the dense one), a training step of each
tier (packed and perleaf), per-example clipping and the wire tier's rounds
against the host CPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --scans [--src DIR]   # phase 11's scans alone
    python3 chip_smoke.py --pool [--src DIR]    # phase 3's page pool alone
    python3 chip_smoke.py --wire [--src DIR]    # phase 16's wire tier alone
    python3 chip_smoke.py --bwd [--src DIR]     # phase 17's backward kernels
    python3 chip_smoke.py --streams [--src DIR] # rows 8, 13, 14 alone
    python3 chip_smoke.py --slice15             # phase 18 alone
    python3 chip_smoke.py --persist             # phase 19 alone
    python3 chip_smoke.py --cifar               # phase 20 alone
    python3 chip_smoke.py --prng [--src DIR]    # WRN28's per-leaf noise
    python3 chip_smoke.py --normal              # phase 21 alone
    python3 chip_smoke.py --tree                # phase 22 alone
    python3 chip_smoke.py --bf16                # phase 23 alone
    python3 chip_smoke.py --families            # phase 24 (not in the full run)
    python3 chip_smoke.py --bf16train           # phase 25 (not in the full run)
    python3 chip_smoke.py --flashtrain          # phase 26 (not in the full run)
    python3 chip_smoke.py --bf16families        # phase 27 (not in the full run)
    python3 chip_smoke.py --longctx             # phase 28 (not in the full run)
    python3 chip_smoke.py --moespec             # phase 29 (not in the full run)

``--scans`` runs only the card line, the build and phase 11's scans (their
checks and times, no launch configuration), from the ``repro_torch`` under
DIR (default: this checkout's ``src``), and prints their JSON record on the
line before the last (the last is the full run's ``{"ok": true, ...}``, as
in every phase mode). It is the standing tool for a change to a scan kernel: two trees
(an unpacked parent and this one) are timed in one call by running it once
for each, since it uses only the wrappers every tree has. ``--pool`` does
the same for phase 3's page-pool events, on trees that have
``PagePool.rollback_many`` and ``ops.pool_zero``; ``--wire`` for phase 16
(with ``clip_mask``'s SASS read for its bound), on trees that have
``repro_torch.core.tee``; ``--bwd`` for phase 17(a), the scans' backward
kernels, on trees that have ``wkv_bwd_cuda`` and ``ssd_bwd_cuda``;
``--streams`` for the wire tier's stream kernels (``clip_mask`` at the
training and the wire shape, ``noise_stream`` and the external-stream
``clip_mask`` at the wire shape, as phases 6 and 16 check and time them,
against the pinned bound), on trees that have ``ops.noise_stream``.
``--prng`` times the scan tier's per-leaf noise stage on WRN28's layout
and prints the hash of what it drew (no kernel is built for a tree
without the normal kernels): a parent and a change in one call, trees
that have the scan tier. ``--normal`` runs that noise stage with its
launches, then phase 21; ``--tree`` runs phase 22; ``--bf16`` phase 23;
``--families`` phase 24; ``--bf16train`` phase 25; ``--flashtrain``
phase 3's flash training rows, then phase 26; ``--bf16families`` phase
27; ``--longctx`` phase 28; ``--moespec`` phase 29.

Phases (any failed check raises, and the script exits non-zero):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. the kernel build (nvcc, sm_90a) into ``build/``, with its time;
  3. each kernel against its plain version on the card at the main path's
     shapes, timed beside the plain version and one PyTorch call for the
     same function (a yardstick only: the port never calls it); paged
     attention at C 1 (decode), 4 (a speculative verify) and 16 (a prefill
     chunk) from q_starts {0, S/3, S - C, -1}, with the wrapper's split
     plan logged (read from its plan(), not measured); flash attention
     (on the tensor cores) also within the gate of its split model, two
     launches bit-equal; every attention row
     and its SDPA yardstick timed both as calls (``ms``, host-clocked:
     back-to-back calls between CUDA events, so the longer of the host's
     enqueue and the card's work) and on the card alone (``device_ms``: 50
     calls in one CUDA graph); the page pools' zeroing kernel bit-equal to
     its plain version over both whole pools (36 + 4 layers), then each
     event as ``PagePool`` runs it, one launch each: an admission's reset
     (4 fresh pages; target alone, and with the draft), a speculative
     tick's rollback (4 tails of 3 tokens, both pools) and two single
     ranges, beside ``index_fill_`` and the launch floor (an empty kernel
     of the library in the same 50-launch graph); for the single ranges,
     where a call's host time goes (the wrapper's Python, its C entry);
     the training pair of flash attention, the lse forward and the
     backward (``flash_attention_bwd``), against their plain versions at
     qwen2.5-3b's silo at S 4096 (B 1, causal; fp32 and bf16), at
     hubert-xlarge's frames (B 4, S 512, MHA, d_head 80, non-causal) and
     at S 1000, each in fp32 and bf16 (fp32 within FLASH_TRAIN_REL of each
     output's largest value, bf16 within one ulp past it, two launches
     bit-equal; both pairs on the tensor cores: HMMA in the SASS of each
     flash kernel, the serving forwards' included), timed beside SDPA's
     forward and its backward, the bf16 rows beside the split's floor
     too; then the main path that
     launches them: one fused step of qwen2.5-3b at full width and 2
     layers, 4 x 4096 over 4 silos, through ``build_model(remat=True,
     use_flash=True)`` (2 x layers lse forwards and 1 x layers backwards a
     silo);
  4. qwen2.5-3b, all 36 layers, fp32, random weights from a seed: direct
     serve (batch 4, prompt 32, 16 new tokens), then 8 Zipf requests through
     4 slots in wave and continuous mode (page 16, chunk 16), and twice more
     in continuous mode with speculative decoding at spec_k 4: a self-draft,
     and a 4-layer early-exit draft over prefix sharing (rejected almost
     every tick with random weights, so its rollbacks run); continuous must
     equal wave, and each speculative run continuous, token for token, and
     every kernel's launch counter, zeroed just before each path, must show
     the path went through it: ``paged_reset`` once an admission and
     ``paged_rollback`` once a tick that rolled back (a spy on
     ``PagePool.rollback_many`` counts those ticks);
  5. the same weights cut to 2 layers, run on the card with the kernels and
     on the host CPU with the plain versions: the logits must agree, and a
     speculative serve with a 1-layer draft must give the same tokens,
     proposals and acceptances; then ``python -m repro_torch.launch.serve
     --scheduler continuous --speculative`` on the card in a subprocess;
  6. the DP kernels at the training paths' shapes (4 silos, P =
     1,547,255,808, the packed length of qwen2.5-3b at 12 layers): each
     bit-equal to its plain version over all P columns (the plain version
     run on windows of 2**22 columns; ``clip_mask`` at the barrier tier's
     flags and a partial ring, its other three flag combinations on one
     window each; ``zsmask`` over each of the 146 leaf tensors at its
     counter offset), timed beside the plain version on a window and, for
     the aggregate, cuBLAS's ``s @ g``; the stream kernels' bounds read off
     their SASS; on the same (4, P) buffer, as 4 examples,
     ``per_example_sumsq`` on every leaf's columns and ``clip_sum``, within
     SUMSQ_RTOL of their plain versions, bit-identical across launches, the
     clipped sum bit-equal to the plain fold at the kernel's norms;
  7. qwen2.5-3b at full width, 12 of 36 layers, trained 3 steps through
     ``Session.train`` with the quickstart privacy settings (4 silos, sigma
     0.3, dynamic clipping, lambda 0.7) and AdamW lr 1e-3, batch 16 x 64:
     finite loss, rising epsilon, each DP kernel launched once per step;
     step and per-stage times and peak memory;
 7b. ``per_example_clipped_grad`` at the same width and depth, 4 examples
     of 64 tokens, on the packed route (``clip_sum`` once) and the perleaf
     route (``per_example_sumsq_tree`` and ``clip_accumulate`` once):
     the two agree within ROUTES_RTOL; times and peak memory;
  8. one training step of a narrow config (P of a few million) on the card
     (kernels) and on the host CPU (plain versions) from the same weights:
     loss, bound (below its cap, so the percentile protocol ran), noisy
     gradient and parameters agree, and the carried noise key is bit-equal;
  9. the barrier tier at the same width and depth: from one set of weights
     and one batch, ``_fused_grads`` and ``_barrier_grads`` (no optimizer
     state) give the same aggregate within the masks' fp32 residue, and one
     silo's contribution minus its clipped gradient shows the mask (std
     about B*sqrt(2)); then 3 steps through ``Session.train`` on a
     ``(4,)`` data mesh: finite loss, rising epsilon, ``clip_mask`` 4 times a
     step and the fused tier's kernels never; step and stage times, peak
     memory;
 9b. the barrier tier under ``force_impl("perleaf", kernel="dp_noise_tree")``:
     one primed step, whose aggregate minus sum_i clip(g_i) must have the
     std of sigma_c (xi_t - lam xi_{t-1}) (the +-b r terms cancel), then 3
     steps of ``Session.train``: ``zsmask_buffer`` once a silo, 4 times a
     step, each its lambda-corrected instantiation, and no other kernel;
     step and stage times, peak memory;
 10. one barrier step of the narrow config on the card and on the host CPU
     from the same weights, silo 1 dropped and the noise state primed with
     silo 2 absent at t-1: loss, bound, every silo's contribution, the
     aggregate and the carried key agree (the key bit-equal); then
     ``python -m repro_torch.launch.train --sync-path barrier`` on the card
     in a subprocess;
10b. the narrow config's ``per_example_clipped_grad`` on both routes, one
     fused step and one barrier step under the perleaf policy, card vs CPU
     from the same weights; then the training CLI under
     ``REPRO_KERNEL_IMPL=dp_noise_tree=perleaf``;
 11. the scans of the ssm and hybrid families at their main path's shapes:
     ``wkv`` at (4, 32, 64, 64) and ``ssd`` at (4, 32, 112, 64), N 64, each
     with an incoming state, against their plain chunked versions within
     the JAX package's own bounds (also at S 512, at a ragged length past
     two staged passes, and ``wkv`` under strong decay), timed at the main
     shape and at S 512, each with its bound; each kernel's launch
     configuration (blocks, threads, tokens a pass, shared bytes, blocks an
     SM) logged as the built library reports it (not a measurement: it is
     not in the ``kernels`` line); and flash attention at zamba2's d_head
     112;
12-13. rwkv6-7b (32 layers) and zamba2-7b (81 layers) at published width,
     fp32, random weights from a seed: direct serve (batch 4, prompt 32, 16
     new; rwkv6 prefills recurrently there and launches no ``wkv``), a
     timed whole-prompt prefill (4 x 32), and the 8 Zipf requests through
     4 wave slots: ``wkv`` 32 and ``ssd`` 81 launches a prefill (flash 13),
     counts zeroed just before each run; continuous batching must refuse;
 14. narrow configs of both families at the kernels' widths (N = 64, P =
     64, d_head 112), card vs CPU from the same weights: logits after a
     prefill and 3 decode steps within CROSS_ATOL / CROSS_RTOL, and equal
     wave tokens;
 15. ``python -m repro_torch.launch.serve --arch rwkv6-7b|zamba2-7b
     --scheduler wave`` on the card in a subprocess;
 16. the wire tier: ``clip_mask`` at MNIST-MLP3's packed length (P =
     235,520) bit-equal to its plain version (both ``use_prev`` settings, a
     partial ring), timed as a call and on the card beside the launch floor
     and its SASS bound; the speculative rounds' two port kernels there:
     ``noise_stream`` bit-equal to its plain version (at P and a ragged P),
     the external-stream ``clip_mask`` given its buffers bit-equal to its
     plain version and to ``clip_mask``'s in-kernel draw, both timed
     likewise; MNIST-MLP3 at its published width over 4 silos of synthetic
     MNIST (4096 examples, sigma 0.5, C 1, lambda 0.7) through
     ``CollaborativeSession``: 10 serial, 10 pipelined and 10 speculative
     rounds from three sessions with the same seeds, bit-equal (params,
     losses, bytes on the wire), the launch counts zeroed before each run
     (``clip_mask`` once per silo per round; speculative: the variant once
     per silo per round, ``noise_stream`` 11 times a silo, 18 cache hits a
     silo), the loss falling, the median round and each party's share of
     it (admin plane, broadcast, each handler's round trip, its compute on
     the card between CUDA events and its seal, the updater's ingest and
     close; read by wrapping the components' methods on their instances);
     then 3 rounds with silo 1 out in round 1 and resynced in round 2, on
     the card and on the host CPU from the same weights (losses
     WIRE_LOSS_RTOL, params WIRE_PARAM_ATOL, epsilon and participation
     equal); ``python -m repro_torch.launch.train --wire-rounds 4`` on the
     card in a subprocess; then the fault-tolerant rounds: 5 fault-free
     tolerant rounds of 6 silos (worker threads, a CUDA stream a handler)
     bit-equal to the serial loop, whose warm median round sets the
     deadline (4x); a chaos run (seed 6: an updater crash, a hang, a dropped
     and a corrupted blob, KDS denials; 6 silos, quorum 4, 12 rounds) bit-equal
     to its elastic oracle; a journal resumed after a driver restart
     bit-equal to an uninterrupted run; and the CLI's chaos rounds with a
     journal (``--wire-rounds 6 --chaos-seed 1 --round-timeout <deadline>
     --journal``);
 17. training the ssm and hybrid families: (a) the scans' backward kernels
     ``wkv_bwd`` and ``ssd_bwd`` against their plain reverse scans at the
     training shapes (one silo's share of 16 x 64: (4, 64, 64, 64) and
     (4, 64, 112, 64, 64)), at S 61, S 512 and under strong decay, with an
     incoming state and a final-state cotangent, each gradient within
     BWD_REL of its largest |value|, two launches bit-identical, timed as
     a call and on the card beside the plain version and the bound, each
     kernel's launch configuration logged as the built library reports it
     (threads, blocks an SM, shared bytes) with the checkpoint scratch a
     call allocates at each timed shape (``--bwd --src`` on the parent's
     tree times the parent's kernels the same way, without the
     configuration its library does not report); (b)
     rwkv6-7b at 4 of 32 layers and zamba2-7b at 12 of 81, published
     width, 3 steps each through ``Session.train`` on the fused tier (the
     quickstart's settings, 4 silos, batch 16 x 64): finite losses, the
     weights moved, epsilon the ledger's (phase 7's), ``wkv`` and
     ``wkv_bwd`` 16 a step, ``ssd`` and ``ssd_bwd`` 48 a step, each DP
     kernel once; step and stage times, peak memory; (c) one barrier step
     of each on a ``(4,)`` mesh (``clip_mask`` 4 times); (d) the narrow
     configs of phase 14, 2 fused steps and 1 barrier step with a drop,
     card vs CPU; (e) ``python -m repro_torch.launch.train --arch
     rwkv6-7b|zamba2-7b --steps 1`` on the card in a subprocess;
 18. the other dense archs, the admin masks and the scan tier: (a) flash
     attention at stablelm-3b's and phi3-mini-3.8b's prefill shapes (B 4,
     S 32, 32 heads, d_head 80 and 96) and paged attention at C 1, 4 and
     16 with Hkv 32, each against its plain version, timed as phase 3's
     rows; (b) both archs at published width and depth, random weights
     from a seed: direct serve (batch 4, prompt 32, 16 new), 8 Zipf
     requests through 4 wave and 4 continuous slots (pages 16, chunk 16),
     continuous == wave token for token, launches counted (flash once a
     layer a prefill, paged_reset once an admission), tok/s, decode ms a
     step, peak memory; narrow configs of stablelm-3b, phi3-mini-3.8b and
     mistral-large-123b at their d_heads, card vs CPU (logits within
     CROSS_ATOL / CROSS_RTOL, wave and continuous tokens equal); (c) admin
     masks on qwen2.5-3b at 12 layers, phase 7's settings: one primed step
     of the fused and the barrier tier from one set of weights (aggregates
     within MASK_ATOL_PER_B units of B), 2 fused steps (clip_accumulate
     once a step, ``normal_combine`` once a window) and 1 barrier step
     (``normal`` 6 times a window, ``normal_combine`` once) through
     ``Session.train``, then 10 serial and 10 pipelined admin rounds of
     MNIST-MLP3 bit-equal and 3 rounds with a drop card vs CPU (WIRE_*
     tolerances); (d) the silo-serial scan tier on qwen2.5-3b at the
     largest of 36, 30, ... layers that fits (2 steps, step and stage
     times, peak memory, ``normal_combine`` once a leaf tensor a step),
     and a narrow scan step against the vmap step under the per-leaf
     policy, card vs CPU (NOISY_ATOL);
 19. the Trainer's ledger wiring and persistence at qwen2.5-3b's published
     width and 2 of 36 layers (P = 776,485,888; an AdamW checkpoint in
     JAX's layout is 12.4 GB, written to a temporary directory outside the
     repo whose free space is read first; phase 7's privacy settings, a
     ``FederatedBatcher`` over synthetic token rows as ``batch_state``):
     (a) 2 fused steps, a checkpoint, a fresh Trainer and 2 more steps
     bit-equal to 4 steps without a break (master, m, v, clip bound, noise
     state, ledger, losses), the buffers never rebound, the padding zero,
     the checkpoint's bytes and its save (device to host, write, hash) and
     restore (read, hash, host to device) seconds, reckoned for 12 and 36
     layers; (b) the barrier tier with a budget silo 3 spends in step 1:
     ``clip_mask`` 3 times in step 2, silo 3's epsilon still, the budget
     enforced after a resume without budget flags; (c) an escalation under
     a step deadline drops the latency hook's slow silo for a 2-step
     cooldown and it rejoins, and barrier == fused over the 3-silo ring
     (MASK_ATOL_PER_B); (d) SIGTERM from inside ``next_batch``, resumed ==
     uninterrupted bit for bit; (e) the training CLI's ``--checkpoint-dir``
     (then a resume), ``--elastic`` and ``--silo-epsilon-budget``; (f) a
     narrow checkpoint written on the card restored on the CPU, the next
     step's loss within TRAIN_RTOL;
 20. the paper's CIFAR models (CIFAR10-CNN6, P = 308,224; CIFAR10-WRN28-4,
     P = 5,851,136) at their published configs, random weights from a
     seed, 4 silos, sigma 0.5, C 1, dynamic clipping, lambda 0.7,
     momentum at lr 0.1, CNN6 at batch 256 and WRN28 at 64, their
     convolutions in fp32 on deterministic cuDNN algorithms: rows 5-10 at
     both P (``clip_accumulate``, ``noise_batch``, ``clip_mask``, one
     ``zsmask`` pass) and per-example clipping's (16, P) of WRN28
     (``per_example_sumsq``, ``clip_sum``) against their plain versions,
     timed as a call and on the card; (a) 3 steps of each model through
     the Trainer on the fused tier, the barrier tier, the barrier tier
     under perleaf and the scan tier, with each tier's launches, step and
     stage ms and peak memory, and barrier == fused on one step's inputs
     (MASK_ATOL_PER_B); (b) CNN6 falling over 20 fused steps of 32; (c)
     per-example clipping of 16 WRN28 examples on both routes; (d) 5
     serial, pipelined and speculative wire rounds of each model bit-equal,
     their round split and the card's busy share; (e) CNN6's Trainer, 2
     steps + checkpoint + 2 == 4 steps bit for bit; (f) one fused step of
     CNN6 and of a narrow WRN card vs CPU (TRAIN_RTOL, CIFAR_CARD_TOL),
     and TF32 convolutions shown to miss that gate; the scan tier's noise
     stage on WRN28's layout (``--prng``: ``normal_combine`` once a leaf);
 21. the per-leaf normal draw (``kernels/prng/csrc/normal.cu``):
     ``normal`` and ``normal_combine`` (two keys at
     gate 0.7 added and gate 0 written, one key added) bit-equal to their
     plain versions at 1, 7, 2**22, 2**22 + 3 and 311,164,928 elements
     (qwen2.5-3b's embedding leaf, one launch) and at 3,000,000 counters
     across 2**32; each kernel's SASS counts a normal (pinned,
     NORMAL_OPS) for its bound, its launch configuration, its call and
     card ms beside the plain version's; the launches of both on phase
     18's admin and scan cells and phase 20's scan tiers, where no plain
     draw ran on the card (a spy on the plain draw; ``--normal`` alone:
     WRN28's noise stage);
 22. the per-leaf wrappers at one launch a tree: ``zsmask_buffer`` (both
     instantiations: the mask alone, and the lambda correction's pass
     fused in) over every tensor of CNN6 (14), WRN28 (80) and qwen2.5-3b
     at 12 layers (147), bit-equal to the per-leaf route's launches (a
     ``zsmask`` a tensor, a second over zeros on prev_key, a multiply and
     a subtraction) and to its plain version over every element, the
     padding untouched, two launches bit-identical;
     ``per_example_sumsq_tree`` on WRN28's (16, P) and qwen2.5-3b's (4, P)
     buffers, bit-equal to a ``per_example_sumsq`` launch a leaf for every
     (row, leaf) and for the leaf-order totals, within SUMSQ_RTOL of its
     plain version, and the per-leaf clip route's one ``clip_accumulate``
     bit-equal to a launch a leaf; each timed as a call and on the card
     beside the per-leaf launches (and the norms beside ``vector_norm`` a
     leaf and over the whole buffer) and its bound (the mask's from
     ZSMASK_OPS, pinned); then the per-leaf kernels' launches on the APIs
     that keep them (``pairwise_mask_tree(impl="perleaf")``, bit-equal to
     the tree kernel, and ``sumsq`` a leaf);
 23. bf16 serving: (a) the bf16 instantiations of flash attention at
     d_head 128, 112, 80 and 96 (B 4, S 32), on the tensor cores, each
     element within one bf16 ulp of the plain version past the fp32 gate
     and within the gate of its split model, two launches bit-equal (the
     share not bit-equal to the plain version and the largest gap in ulps
     reported); of paged attention
     at C 1, 4 and 16 for qwen2.5-3b and at Hkv 32 (d_head 80, 96), on the
     tensor cores, within KERNEL_ATOL of the plain version and of its split
     model, two launches bit-equal; the zeroing kernel on bf16 pools bit-equal to its
     plain version (36 + 4 layers), and an admission's reset and a tick's
     rollback as ``PagePool`` runs them; each timed as phase 3's rows,
     beside SDPA in bf16, the bound from bf16 bytes; (b) qwen2.5-3b at 36
     layers in bf16 (fp32 weights) through ``Session.serve``: direct, wave,
     continuous and speculative (a 4-layer draft over prefix sharing), only
     the bf16 instantiations launched, peak memory of each (phase 4 records
     fp32's); continuous held to wave and speculative to continuous token
     for token, a split allowed only at a near-tie (BF16_TIE; the position
     and the margin printed); ``api.serve`` direct equal to the session's;
     ``run_soak`` in bf16 and the soak CLI (``--soak 4``, fp32: the CLI has
     no dtype flag) into temporary files; bf16 weights through
     ``build_model(param_dtype=bf16)``, direct and continuous; (c)
     zamba2-7b (direct, wave), stablelm-3b and phi3-mini-3.8b (continuous)
     and rwkv6-7b (direct, and a whole-prompt prefill: the scans run fp32)
     in bf16 at published width and depth; (d) a narrow qwen2.5-3b in bf16,
     card vs CPU within BF16_ATOL; no plain attention or page-pool call on
     the card through (b)-(d);
 24. (``--families`` only: the full run with it took 1029.6 s of its 1200
     on an H100 80GB HBM3 at 700 W) the MoE, VLM and encoder families at
     published width: (a) flash
     attention (B 4, S 32) and paged attention (C 1, 4 and 16) at
     phi3.5-moe's heads (32/8, G 4) and qwen3-moe's (64/4, G 16, where a
     chunk folds 256 rows into four row tiles), flash at qwen2-vl's
     (64/8) and flash without the causal mask at hubert-xlarge's shape (B
     4, S 64, 16 heads, MHA, d_head 80; on no main path yet), each
     against its plain version and timed as phase 3's rows; (b)
     phi3.5-moe at 8 of 32 layers (42.7 GB) through ``Session.serve``:
     direct, wave and continuous at the defaults (4 slots, page 16, chunk
     16, max_len 512), launches counted, and at 1 layer card vs CPU
     (logits after a prefill and 3 decode steps within CROSS_ATOL /
     CROSS_RTOL, wave and continuous tokens equal); (c) qwen3-moe at 4 of
     94 layers, direct and continuous; (d) qwen2-vl at 8 of 80 layers,
     direct over tokens, and a prefill on embeds with distinct (3, B, S)
     M-RoPE ids through flash, its last logits held to ``forward``
     without a cache; (e) hubert-xlarge at its published size (1.26 B), 3
     fused steps and 1 barrier step on frame embeds (B 16, S 64) over 4
     silos; (f) phi3.5-moe at 1 layer (P 1.56 B), 2 fused steps with the
     aux loss, and every silo's packed gradient computed twice,
     bit-equal; peak memory and ms a step of each; no plain attention or
     page-pool call on the card through (b)-(f).
 25. (``--bf16train`` only, as phase 24: the full run already takes most
     of its 1200 s) training in bf16 on the JAX package's two routes, (A)
     bf16 compute over fp32 weights and (B) bf16 weights over an fp32
     master, beside fp32 in the same call: qwen2.5-3b at full width and 12
     layers, phase 7's privacy, 16 x 64 over 4 silos, (a) 3 fused steps
     each way (``clip_accumulate`` and ``noise_batch`` once a step), (b) 3
     barrier steps each way with silo 2 out at the second (4, 3, 4
     ``clip_mask`` launches); (c) the scan tier under route (B) at the
     largest of SCAN_DEPTHS that fits, 2 steps; (d) phase 8's narrow step
     under route (B), card vs CPU within the BF16_* tolerances, the
     carried key bit-equal; (e) silo 0's bf16 gradient at 12 layers
     computed twice, bit-equal. Step and stage ms and peak GB of every
     cell; under route (B) the bf16 weights the fp32 master rounded to
     nearest even, bit for bit, after every cell.
 26. (``--flashtrain`` only, with phase 3's flash training rows first: the
     full run already takes most of its 1200 s) training through flash
     attention with remat at JAX's train_4k length (S 4096), through
     ``build_model(remat=True, use_flash=True)`` in a session: (a)
     qwen2.5-3b at full width and 12 layers, fp32, fused tier, phase 7's
     privacy over 4 silos, 4 x 4096: 2 steps with flash, 2 with the plain
     attention; (b) the barrier tier once at that cell, silo 2 out; (c)
     JAX's production cell, the scan tier under route (B) at 36 layers over
     8 silos with JAX's dry-run privacy, 2 steps at a sequence a silo, then
     the largest per-silo batch of 8, 4, 2 that fits, tried in that order
     and the first that fits run once (its peak is AdamW's, not the silo
     gradient's: it does not extrapolate); (d) hubert-xlarge at published width and
     8 layers, frames of S 512, 16 x 512, fused, 2 steps; (e) phase 8's
     narrow config, one silo's loss and gradient card vs CPU; (f) one
     silo's gradient at 12 layers twice, bit-equal. Each cell: finite
     losses, rising epsilon, each DP kernel's launches as in phases 7 and
     25, 2 x layers lse forwards and 1 x layers backwards a silo a step, no
     plain attention call on the card; step and stage ms, the time in
     attention (reckoned from one layer's attention timed alone at a
     silo's shape), peak GB.
 27. (``--bf16families`` only) training in bf16 for every family on the
     JAX package's two routes, at published width, phase 7's privacy, 16
     x 64 over 4 silos: (a) rwkv6-7b at 4 of 32 layers and zamba2-7b at
     12 of 81 (its shared block through the flash pair), and (b)
     phi3.5-moe at 1 layer and hubert-xlarge at 48 under ``remat`` and
     ``use_flash``: 3 fused steps under routes (A) and (B), a barrier
     step under (B) with silo 2 out, 2 scan-tier steps under (B), each
     with the model's and the DP kernels' launches and nothing else; (c)
     qwen2-vl-72b's scan tier under (B) at the deepest of VL_SCAN_DEPTHS
     that fits, its fused tier reckoned; (d) qwen2.5-3b at 12 layers under
     (B): 3 perleaf barrier steps (4 bf16 ``zsmask_buffer`` launches a
     step, the corrected instantiation), per-example clipping at 4 x 64
     (one ``clip_sum``) and per-microbatch clipping (one
     ``clip_accumulate``), and rows 5, 7 and 9 on the card at that shape;
     (e) each family's narrow config under (B) card vs CPU within phase
     25's gates (the loss within FAM_LOSS_RTOL). Step and stage ms and
     peak GB of every cell; under (B) the bf16 weights the rounded master
     over the bf16 leaves after every cell; no plain attention, scan or
     tree-mask call on the card.
 28. (``--longctx`` only) JAX's long-context cells on one card, at
     published width in bf16 and JAX's seq_len: qwen2.5-3b and zamba2-7b
     at prefill_32k and decode_32k, rwkv6-7b at long_500k, each through
     ``python -m repro_torch.launch.dryrun --run`` at the plan's batch in
     a process of its own (prefill on an empty dense cache; one decode
     step against a cache filled at depth seq_len - 1 with seeded values;
     rwkv6's state by prefilling 524,288 seeded tokens in calls of
     32,768), its batch, ms, planned and measured peak and launches
     printed; zamba2-7b at long_500k is the plan's "does not fit". Gates:
     (a) the flash serving forward in bf16 at S 32768 (qwen2.5-3b's and
     zamba2-7b's heads) against its plain version at 256 sampled query
     rows, one bf16 ulp past the fp32 gate; (b) a 2-layer slice of
     qwen2.5-3b's prefill and one group of zamba2-7b's (6 Mamba-2 layers
     and the shared block) at S 32768 through the kernels against the
     same slice through the plain versions on the card (flash by query
     blocks of 2048, the scans' chunked forms): last logits within
     BF16_ATOL, a token split only within BF16_TIE; (c) the ``wkv`` scan
     over S 32768 in 4 calls with the state carried against one call and
     the plain version (WKV_ATOL), and rwkv6-7b's prefill at S 32768 in 4
     calls against one (the serving gate); (d) rwkv6-7b cut to 2 layers at
     depth 524,288, kernels against plain versions (the serving gate);
     (e) each cell's measured peak (``max_memory_allocated`` over the
     step) at or under the plan and the plan within 10% of it. Then rows
     1, 2, 11 and 12 at the cells' shapes (flash bf16 at S 32768 at each
     prefill's batch, qwen2.5-3b's and zamba2-7b's heads, beside SDPA
     bf16; ``wkv`` at the long prefill's
     call, ``ssd`` at zamba2's prefill; bf16 paged attention over a
     32,768-deep table at the decode's batch), and where the card's time
     goes (``torch.profiler``) in a cut of each prefill (qwen2.5-3b at 2
     layers, zamba2-7b's first group) and of qwen2.5-3b's decode at the
     cells' batches: the shares of the flash kernel and the SSD scan.
     Each cell's counted FLOPs and bytes a step (the dry run's
     ``hlo_cost``, ``analysis/op_cost.py``) beside its measured step: the
     share of the card's bf16 peak the step reached.
 29. (``--moespec`` only) speculative serving of the MoE family: the page
     pools' zeroing kernel at phi3.5-moe's Hkv 8 and qwen3-moe's Hkv 4
     (d_head 128) in fp32 and bf16, bit-equal to its plain version over
     both whole pools, then an admission's reset and a speculative tick's
     rollback as ``PagePool`` runs them, timed as phase 3 times row 4;
     phi3.5-moe at 8 of 32 layers and qwen3-moe at 4 of 94, published
     width and capacity factor 1.25, 8 Zipf requests through 4 slots at
     spec_k 4 with a 1-layer draft and with the self-draft, in fp32 and
     bf16 compute: each drains, paged attention launches once a layer of
     every paged forward (draft steps, verifies, prefill chunks),
     ``paged_reset`` once an admission, ``paged_rollback`` once a tick
     with a tail, all on the compute type's instantiation; ms a tick,
     tok/s, acceptance and peak GB beside the card's name and power limit;
     phi3.5-moe at 1 layer card vs CPU (self-draft, fp32 and bf16): the
     same tokens, proposals and acceptances, logits within phase 24's gate
     (fp32) or phase 23's (bf16), a request parting only at a near-tie; no
     plain attention or page-pool call on the card.

Every kernel's bound in these phases comes from its work formula in
``src/repro_torch/analysis/op_cost.py`` (:func:`work`), the formula the dry
run counts the kernel by.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

import torch

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# the fp32 rate outside the tensor cores (the path holds fp32 without TF32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# the dense bf16 rate of the tensor cores: a bf16 row's least time for its
# products
BF16_FLOP_PER_S = 989e12

# per-SM issue rates of Hopper in thread-operations per clock (H100
# architecture white paper: 4 sub-partitions, each dispatching one warp
# instruction a clock to 32 FP32 lanes, 16 INT32 lanes and 4 SFU lanes; the
# integer multiply-add IMAD runs on the FP32 pipe's heavy half, 16 lanes),
# 132 SMs, at the 1.98 GHz boost clock behind the 67 TFLOP/s above
SM_OPS_PER_S = 132 * 1.98e9
LANES = {"alu": 64, "imad": 64, "fp32+imad": 128, "mufu": 16, "issue": 128}
# SASS opcodes of arithmetic by the pipe that runs them; OTHER_OPS issue on
# a pipe not bounded here. Moves (MOV, IMAD.MOV), branches, barriers and
# loads are not counted: they are how this build schedules the work, not
# the work, so the bound from these counts stays a lower bound.
ALU_OPS = {"IADD3", "LOP3", "SHF", "PRMT", "LEA", "ISETP", "IMNMX", "SEL",
           "FSETP", "FSEL", "FMNMX", "PLOP3", "IABS", "BMSK", "SGXT"}
IMAD_OPS = {"IMAD", "IMUL"}
OTHER_OPS = {"VIADD", "I2FP", "I2F", "F2I", "F2F", "POPC", "FLO"}
FP32_OPS = {"FFMA", "FMUL", "FADD"}
# The yardstick of rows 8, 13 and 14 (clip_mask_kernel<false>,
# noise_stream_kernel, clip_mask_kernel<true>): arithmetic instructions a
# normal by pipe in clip_mask's loop as the one-element-a-thread layout
# compiled it (four normals a loop, before csrc/stream_grid.cuh), pinned,
# so that a redesigned body and its parent are held to one bound; the live
# count of the running build is logged beside it as a report only.
# noise_batch and zsmask, whose kernels keep their loops, read their own
# live counts.
CLIP_MASK_OPS = {"normals_in_loop": 4, "alu": 62.75, "imad": 15.25,
                 "fp32+imad": 59.75, "mufu": 1.0, "issue": 128.75}
# The yardstick of the buffer mask (zsmask_buffer, both instantiations):
# zsmask_kernel's arithmetic a normal by pipe, the per-leaf kernel it
# replaces, as its build compiled it, pinned, so that the tree and the
# per-leaf launches are held to one bound
ZSMASK_OPS = {"normals_in_loop": 3, "rotations": 20.0,
              "alu": 63.666666666666664, "imad": 15.333333333333334,
              "fp32+imad": 59.0, "mufu": 1.0, "issue": 129.0}
# kernel vs plain version on the same inputs, fp32 on the card: the two sum
# in different orders, so they agree to fp32 rounding (about 1e-6 here)
KERNEL_ATOL = KERNEL_RTOL = 1e-5
DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}
SERVING_KERNELS = ("flash_attention", "paged_attention", "paged_reset",
                   "paged_rollback")
# per_example_sumsq and clip_sum's norms (fp64 sums rounded once) against
# the plain version's chunked fp32 dot products (cuBLAS, about 1e-7
# relative at any length); clip_sum's sum against the plain version's, whose
# clip factors move with its norms, to the same share of its largest value
SUMSQ_RTOL = 1e-6
# the two per-example routes (sums of squares over the whole row, or per
# leaf and then added in fp32) and the per-example gradients recomputed for
# each: fp32 rounding of the norms and the clip factors
ROUTES_RTOL = 1e-5
# the DP kernels keep the plain versions' operations and order (no FMA, the
# same libm log and sqrt): bit-equal, a max |difference| of 0 over the
# whole buffer, the plain version run on DP_WINDOW columns at a time
DP_WINDOW = 1 << 22
# training step of the narrow config, card vs CPU: fp32 products in other
# orders move the loss, norms and bound in the 6th digit and the noisy
# gradient (noise std about 0.3) by about 1e-6
TRAIN_RTOL = 1e-5
NOISY_ATOL = 1e-5
# AdamW's first step moves each weight by lr * g / (|g| + eps): equal to
# ~1e-9 unless g is within rounding of 0 and flips sign between devices
# (2 * lr); a handful of such elements is allowed in a few million
PARAM_ATOL, PARAM_FLIPS = 1e-6, 8
# clip_percentile_max of the narrow step: above its noisy median norm
NARROW_CAP = 8.0
# barrier vs fused aggregate at P = 1.5e9: each contribution carries
# +-b * r terms up to 10 B (|r_i - r_nxt| reaches 9.5 over 1.5e9 draws),
# which cancel only in the sum, in another order than the fused tier's
# noise; each contribution rounds at 10 B and each of the 3 adds at up to
# 20 B: 8 ulps of 20 B bound the residue
MASK_ATOL_PER_B = 8 * 2.0 ** -23 * 20
# barrier step card vs CPU: every contribution scales b by the bound, which
# the two devices agree on to TRAIN_RTOL, so contributions (up to 10 B) and
# the aggregate are held to TRAIN_RTOL * 10 B plus the masks' residue
BARRIER_ATOL_PER_B = TRAIN_RTOL * 10 + 8 * 2.0 ** -23 * 10
# the 2-layer full-width slice, card (kernels, cuBLAS) vs host CPU (plain
# versions, CPU BLAS): fp32 products over d_model 2048 and d_ff 11008 in
# different orders; the same bound holds the narrow SSM and hybrid slices
CROSS_ATOL, CROSS_RTOL = 2e-3, 1e-3
# the scans against their plain chunked versions: the JAX package's own
# bounds for its kernels against the recurrence (tests/test_kernels.py:
# 66-96, 164-180); the per-token recurrence rounds differently from the
# chunked exp(L_t - L_s) form
WKV_ATOL, WKV_STRONG_ATOL, SSD_ATOL = 2e-5, 1e-4, 5e-5


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls,
    between CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, n: int = 50, reps: int = 20) -> float:
    """Device time of one ``fn()`` without the host's share: ``n`` calls
    captured into one CUDA graph, the graph replayed under ``cuda_ms``."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return cuda_ms(g.replay, reps=reps) / n


def bound(nbytes: float, flops: float,
          flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_WORK: list = []


def work():
    """The kernels' work formulas, ``(bytes, operations)`` of a call: the
    module ``src/repro_torch/analysis/op_cost.py`` of this checkout, read
    by its path (it imports nothing of the port), so a tree timed with
    ``--src`` is bounded by the same formulas, and the dry run's counted
    step cost by the same numbers as these rows."""
    if not _WORK:
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "op_cost_formulas", ROOT / "src/repro_torch/analysis/op_cost.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod  # its dataclasses look it up
        spec.loader.exec_module(mod)
        _WORK.append(mod)
    return _WORK[0]


# ---------------------------------------------------------------- phase 3

def paged_case(cfg, dev, gen, B, C, nP, P, q_start):
    """Main-path paged attention inputs: B slots, each with its own nP
    distinct pages of a pool of B*nP pages."""
    N = B * nP
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.randn(B, C, Hq, D, device=dev, generator=gen)
    kp = torch.randn(N, P, Hkv, D, device=dev, generator=gen)
    vp = torch.randn(N, P, Hkv, D, device=dev, generator=gen)
    perm = torch.randperm(N, device=dev, generator=gen)
    tables = perm.reshape(B, nP).to(torch.int32).contiguous()
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, qs


def paged_work(q, tables, q_start, P, Hkv):
    """(bytes, flops) the call needs for these inputs (``op_cost.paged_work``:
    q read and the output written once, the K/V of every page holding a
    visible position read once, 2 products of D per visible (query head,
    key) pair)."""
    return work().paged_work(q, tables, q_start, P, Hkv)


def check_paged_attention(cfg, dev, gen, B, nP, P, C, ops, ref, F,
                          dtype=torch.float32):
    """Paged attention at C new tokens a slot (1: decode, 4: a speculative
    verify at spec_k 4, 16: a prefill chunk) from q_starts {0, S/3, S - C,
    -1} (the slots' lengths), q and the pools in ``dtype`` (the output
    fp32): held to the plain version, timed as calls (``ms``, host-clocked:
    the wrapper's enqueue when it is the longer) and on the card alone
    (``device_ms``), beside SDPA in ``dtype`` timed both ways. A bf16 call
    (the tensor-core kernel) is also held to
    ``ref.paged_attention_split_model`` at the same tolerance, and a second
    launch to the first bit for bit."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention.paged_attention import (
        TC_THREADS, plan, plan_tc)
    S = nP * P
    # one inactive slot (q_start -1) and one full slot (ends at S - 1)
    q_start = [0, S // 3, S - C, -1][:B]
    q, kp, vp, tables, qs = paged_case(cfg, dev, gen, B, C, nP, P, q_start)
    q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
    got = ops.paged_attention(q, kp, vp, tables, qs)
    want = ref.paged_attention_ref(q, kp, vp, tables, qs)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()) and got.dtype == torch.float32,
          "paged_attention: non-finite or not fp32")
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
          f"paged_attention C={C} {DTYPE_NAMES[dtype]} disagrees with its "
          f"plain version ({err})")
    extra = {}
    if dtype != torch.float32:
        again = ops.paged_attention(q, kp, vp, tables, qs)
        model = ref.paged_attention_split_model(q, kp, vp, tables, qs)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"paged_attention C={C} "
              f"{DTYPE_NAMES[dtype]}: two launches differ")
        merr = (got - model).abs().max().item()
        check(torch.allclose(got, model, atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
              f"paged_attention C={C} {DTYPE_NAMES[dtype]} disagrees with "
              f"its split model ({merr})")
        extra.update(model_max_abs_err=merr, bit_equal_launches=True)
    # yardstick: SDPA over the gathered K/V with the same causal+length mask
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kg = kp[tables.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    vg = vp[tables.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    qpos = qs.long()[:, None] + torch.arange(C, device=dev)[None]
    mask = (torch.arange(S, device=dev)[None, None] <= qpos[:, :, None])[:, None]
    nbytes, flops = paged_work(q, tables.cpu(), qs.cpu(), P, Hkv)
    bms, by = bound(nbytes, flops, FP32_FLOP_PER_S if dtype == torch.float32
                    else BF16_FLOP_PER_S)
    GC = Hq // Hkv * C
    if dtype == torch.float32:
        rows, splits = plan(B, Hkv, GC, nP, P, _build.sm_count(dev))
        pl = {"splits": splits, "row_tile": rows,
              "blocks": B * Hkv * -(-GC // rows) * splits}
    else:  # token chunks of ref.TC_CHUNK_TOKENS, 4 warps a block
        rows, chunks = plan_tc(GC, nP, P)
        pl = {"chunks": chunks, "chunk_tokens": ref.TC_CHUNK_TOKENS,
              "row_tile": rows, "threads": TC_THREADS,
              "blocks": B * Hkv * -(-GC // rows) * chunks}
    call = lambda: ops.paged_attention(q, kp, vp, tables, qs)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kg, vg, attn_mask=mask, enable_gqa=True)
    return {
        "max_abs_err": err,
        "ms": cuda_ms(call),
        "device_ms": graph_ms(call),
        "plain_ms": cuda_ms(lambda: ref.paged_attention_ref(q, kp, vp, tables,
                                                            qs)),
        "library_ms": cuda_ms(sdpa),
        "library_device_ms": graph_ms(sdpa),
        "bound_ms": bms, "bound_by": by,
        # the wrapper's own plan for this call, read from plan() or
        # plan_tc(), not measured: the log line carries it, the kernels line
        # does not
        "plan": pl,
        "at": f"B={B} C={C} Hq={Hq} Hkv={Hkv} D={D} P={P} nP={nP} "
              f"q_start={q_start} {DTYPE_NAMES[dtype]}",
        **extra,
    }


def log_attention(name, r) -> None:
    """One attention row: the kernel and SDPA, each timed as calls
    (host-clocked: back-to-back calls between CUDA events, so the longer of
    the host's enqueue and the card's work) and on the card alone (50
    calls in one CUDA graph); compare like with like."""
    pl = r.get("plan")
    grid = ""
    if pl and "chunks" in pl:
        grid = (f" | the wrapper's plan: {pl['chunks']} chunks of "
                f"{pl['chunk_tokens']} tokens, {pl['blocks']} blocks of "
                f"{pl['threads']} threads, row tile {pl['row_tile']}")
    elif pl:
        grid = (f" | the wrapper's plan: {pl['splits']} splits, "
                f"{pl['blocks']} blocks of {pl['row_tile']} rows")
    log(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g} | kernel "
        f"{r['ms']:.4f} ms (on the card {r['device_ms']:.4f}) | SDPA "
        f"{r['library_ms']:.4f} ms (on the card "
        f"{r['library_device_ms']:.4f}) | plain {r['plain_ms']:.4f} ms | "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){grid} | {r['at']}")


def bits(t):
    """The fp32 or bf16 tensor's bit patterns: +0.0 and -0.0 differ, NaN ==
    NaN."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


# the page pools at the serving shape (Session.serve's defaults): 4 slots of
# 32 pages of 16 tokens, 128 pages; an admission's 4 fresh pages; one
# speculative tick's 4 rejected tails of 3 tokens (spec_k 4 rejects at most
# 3), each across a page boundary; the draft an early exit of 4 layers
POOL_SLOTS, POOL_PAGE, POOL_WIDTH, POOL_FRESH, POOL_DRAFT = 4, 16, 32, 4, 4
TICK_TAILS = ((0, 47, 50), (1, 15, 18), (2, 95, 98), (3, 63, 66))
SINGLE_RANGES = ((47, 50), (14, 40))


def stub_model(cfg, dev, gen, layers: int, dtype=torch.float32):
    """What ``PagePool`` reads of a model: a stacked pool of ``layers``
    layers at ``cfg``'s kv heads and head dim on ``dev`` in ``dtype``,
    filled with negative values and NaNs (a zeroed lane must be +0.0)."""
    def init_paged_cache(n_pages, page_size):
        shape = (layers, n_pages, page_size, cfg.n_kv_heads, cfg.d_head)
        pool = {}
        for name in ("k_pages", "v_pages"):
            t = -torch.rand(shape, device=dev, generator=gen).to(dtype)
            t[:, ::7, :, 0, :3] = float("nan")
            pool[name] = t
        return pool

    return types.SimpleNamespace(cfg=cfg, init_paged_cache=init_paged_cache)


def launch_floor() -> dict:
    """An empty kernel of the port's library launched through the same
    ctypes path, as a call (``cuda_ms``) and on the card (``graph_ms``, 50
    launches in a CUDA graph)."""
    import ctypes

    from repro_torch.kernels import _build
    entry = _build.Entry("repro_empty_launch", [ctypes.c_void_p])
    dev = torch.device("cuda", torch.cuda.current_device())

    def launch():
        _build.check(entry.launch(dev), "empty kernel")

    return {"ms": cuda_ms(launch), "device_ms": graph_ms(launch)}


def zero_event(kv, call, dead, width, at, card=None) -> dict:
    """One zeroing event: ``call()`` run once and held to an independent
    reference (slabs ``dead`` of every (L, limit, width) view of the pools
    ``kv`` +0.0, every other lane's bits as they were), then timed as a call
    (``cuda_ms``: the host included) and on the card (``graph_ms`` of
    ``card``, by default ``call``), beside ``index_fill_`` of the same slabs
    (one call a tensor)."""
    views = [t.view(t.shape[0], -1, width) for pair in kv for t in pair]
    before = [bits(t).clone() for t in views]
    call()
    torch.cuda.synchronize()
    ix = torch.as_tensor(dead, dtype=torch.long, device=views[0].device)
    for t, t0 in zip(views, before):
        keep = torch.ones(t.shape[1], dtype=torch.bool, device=t.device)
        keep[ix] = False
        check(bool((bits(t)[:, ix] == 0).all()), f"{at}: a listed lane is "
                                                  f"not +0.0")
        check(torch.equal(bits(t)[:, keep], t0[:, keep]),
              f"{at}: a lane outside the list was written")
    del before

    def fill():
        for t in views:
            t.index_fill_(1, ix, 0.0)

    nbytes = views[0].element_size() * len(dead) * width * sum(
        t.shape[0] for t in views)
    return {"ms": cuda_ms(call), "device_ms": graph_ms(card or call),
            "library_ms": cuda_ms(fill), "library_device_ms": graph_ms(fill),
            "bound_ms": bound(nbytes, 0)[0], "at": at}


def host_ms(fn, n: int = 200) -> float:
    """Host milliseconds a call of ``fn()``: the least of 5 runs of ``n``
    calls, the card synchronised before and after each run."""
    best = math.inf
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best / n * 1e3


def host_split(target, dead) -> dict:
    """Where a single range's call spends its host time, host-clocked
    (``time.perf_counter``, ms a call, the least of 5 runs of 200 calls,
    the card synchronised before and after each run): the whole
    ``ops.pool_zero``; its CUDA wrapper with the C entry stubbed (the
    checks, the set and sort of the indices, their int32 array); and the C
    entry alone with its arguments built beforehand (ctypes' conversion,
    the copy into the parameter block, the launch). The stub's calls are
    taken off the launch counter again."""
    import array

    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention import paged_attention as pa

    (k, v), = target
    L, N, P, H, D = k.shape
    ids = array.array("i", sorted(set(dead)))
    args = (k.data_ptr(), v.data_ptr(), L, 0, 0, 0, N * P * H * D, N * P,
            H * D, ids.buffer_info()[0], len(ids))

    # one C entry a dtype since the bf16 pools (a tree before them: one)
    real = pa._ZERO
    entry = real["f32"] if isinstance(real, dict) else real
    out = {"indices": len(ids),
           "call_ms": host_ms(lambda: ops.pool_zero(target, dead, "token")),
           "entry_ms": host_ms(lambda: entry.launch(k.device, *args))}
    counted = pa.PAGED_ROLLBACK.launches
    variants = dict(getattr(pa.PAGED_ROLLBACK, "variants", {}))
    stub = types.SimpleNamespace(launch=lambda *a: 1)
    pa._ZERO = dict.fromkeys(real, stub) if isinstance(real, dict) else stub
    try:
        out["wrapper_ms"] = host_ms(
            lambda: pa.pool_zero_cuda(target, dead, "token"))
    finally:
        pa._ZERO, pa.PAGED_ROLLBACK.launches = real, counted
        if variants:
            pa.PAGED_ROLLBACK.variants.update(variants)
    return out


def pool_events(cfg, dev, seed: int, dtype=torch.float32,
                ranges: bool = True) -> dict:
    """The page pools' zeroing events as ``PagePool`` runs them, on pools
    of ``dtype``: an admission's reset (4 fresh pages; the target pool
    alone, then with a 4-layer draft), one speculative tick's rollback
    (``TICK_TAILS``, both pools) and, with ``ranges``, the single ranges
    ``SINGLE_RANGES`` of the target pool (a tick in which one slot rolled
    back), each by ``zero_event`` beside its plain version; the single
    ranges also by ``host_split``."""
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.runtime.serving import PagePool

    gen = torch.Generator(device=dev).manual_seed(seed)
    P, H, D = POOL_PAGE, cfg.n_kv_heads, cfg.d_head
    N = POOL_SLOTS * POOL_WIDTH
    shape = f"N={N} P={P} H={H} D={D} {DTYPE_NAMES[dtype]}"
    out = {"floor": launch_floor()}

    def make(draft):
        pool = PagePool(stub_model(cfg, dev, gen, cfg.n_layers, dtype),
                        n_slots=POOL_SLOTS, n_pages=N, page_size=P,
                        pages_per_slot=POOL_WIDTH,
                        draft_model=stub_model(cfg, dev, gen, POOL_DRAFT,
                                               dtype)
                        if draft else None)
        for s in range(POOL_SLOTS):
            check(pool.alloc(s, POOL_WIDTH), "PagePool.alloc refused")
        kv = [(p["k_pages"], p["v_pages"]) for p in (pool.pages,
                                                     pool.draft_pages)
              if p is not None]
        return pool, kv

    def event(kv, call, dead, slab, width, at):
        r = zero_event(kv, call, dead, width, at)
        r["plain_ms"] = cuda_ms(lambda: ref.pool_zero_ref(kv, dead, slab))
        return r

    for name, draft in (("reset", False), ("reset_draft", True)):
        pool, kv = make(draft)
        fresh = pool.slot_pages(1)[:POOL_FRESH]
        layers = sum(k.shape[0] for k, _ in kv)
        out[name] = event(
            kv, lambda: ops.pool_zero(kv, fresh, "page"), fresh, "page",
            P * H * D, f"{POOL_FRESH} fresh pages, {layers} layers "
            f"({'target + draft' if draft else 'target'}), {shape}")

    pool, kv = make(True)
    tokens = sum((ops.token_indices(pool.tables[s], P, a, b)
                  for s, a, b in TICK_TAILS), [])
    out["tick"] = event(
        kv, lambda: pool.rollback_many(TICK_TAILS), tokens, "token", H * D,
        f"{len(TICK_TAILS)} tails of 3 tokens across a page boundary, "
        f"{cfg.n_layers + POOL_DRAFT} layers (target + draft), {shape}")

    target = kv[:1]
    for a, b in SINGLE_RANGES if ranges else ():
        dead = ops.token_indices(pool.tables[0], P, a, b)
        r = event(target, lambda: ops.pool_zero(target, dead, "token"), dead,
                  "token", H * D, f"positions [{a}, {b}) of a row of "
                  f"{POOL_WIDTH} pages, {cfg.n_layers} layers (target), "
                  f"{shape}")
        out[f"range_{a}_{b}"] = {**r, "host": host_split(target, dead)}
    return out


def log_pool_events(ev: dict) -> None:
    f = ev["floor"]
    log(f"[kernel] launch floor (an empty kernel of the library, 1 block "
        f"of 32 threads): {f['device_ms']:.4f} ms on the card (50 launches "
        f"in a CUDA graph) | {f['ms']:.4f} ms a call")
    for name in ("reset", "reset_draft", "tick",
                 *(f"range_{a}_{b}" for a, b in SINGLE_RANGES)):
        if name not in ev:  # pool_events(ranges=False)
            continue
        r = ev[name]
        log(f"[kernel] page pool {name}: call {r['ms']:.4f} ms | card "
            f"{r['device_ms']:.4f} ms | index_fill_ {r['library_ms']:.4f} ms "
            f"(card {r['library_device_ms']:.4f}) | plain "
            f"{r['plain_ms']:.4f} ms | bound {r['bound_ms']:.6f} ms (bytes) "
            f"| {r['at']}")
        if "host" in r:
            h = r["host"]
            log(f"[kernel] page pool {name} host, {h['indices']} indices "
                f"(perf_counter, ms a call): ops.pool_zero {h['call_ms']:.5f}"
                f" | wrapper, C entry stubbed {h['wrapper_ms']:.5f} | C entry "
                f"alone {h['entry_ms']:.5f}")


@contextlib.contextmanager
def rollback_ticks(PagePool):
    """Counts, in the one-element list it yields, the
    ``PagePool.rollback_many`` calls (one a speculative tick) that had a
    tail to erase: each must be one ``paged_rollback`` launch."""
    ticks = [0]
    real = PagePool.rollback_many

    def spy(self, ranges):
        ranges = list(ranges)
        ticks[0] += any(end > start for _, start, end in ranges)
        return real(self, ranges)

    PagePool.rollback_many = spy
    try:
        yield ticks
    finally:
        PagePool.rollback_many = real


def check_pool_zero(cfg, dev, gen, ops, ref, dtype=torch.float32) -> None:
    """The zeroing kernel against its plain version at the serving pools'
    shape (36 + 4 layers, 128 pages) in ``dtype``, bit for bit over both
    whole pools (+0.0 over NaN and negative lanes): a padded reset row (its
    first page repeated), the tick's tokens, and a list past one launch's
    capacity with repeats and indices outside the pool (600 distinct: three
    launches of 256, csrc/pool_zero.cu)."""
    P, H, D = POOL_PAGE, cfg.n_kv_heads, cfg.d_head
    N = POOL_SLOTS * POOL_WIDTH
    kv = []
    for L in (cfg.n_layers, POOL_DRAFT):
        k = -torch.rand(L, N, P, H, D, device=dev, generator=gen).to(dtype)
        v = torch.randn(L, N, P, H, D, device=dev, generator=gen).to(dtype)
        k[:, ::5, :, 1] = float("nan")
        kv.append((k, v))
    pages = torch.randperm(N, device=dev, generator=gen)[:POOL_FRESH].tolist()
    toks = torch.randperm(N * P, device=dev, generator=gen).tolist()
    cases = (("page", pages + [pages[0]] * (POOL_WIDTH - POOL_FRESH)),
             ("token", toks[:12]),
             ("token", toks[:600] + toks[:9] + [-1, N * P]))
    for slab, idx in cases:
        want = [(k.clone(), v.clone()) for k, v in kv]
        ops.pool_zero(kv, idx, slab)
        ref.pool_zero_ref(want, idx, slab)
        torch.cuda.synchronize()
        check(all(torch.equal(bits(a), bits(b)) for (k, v), (kw, vw) in
                  zip(kv, want) for a, b in ((k, kw), (v, vw))),
              f"pool_zero ({slab}, {len(idx)} indices, "
              f"{DTYPE_NAMES[dtype]}) differs from its plain version")


def flash_model_gate(got, q, k, v, causal: bool, what: str) -> float:
    """The serving forward against ``ref.flash_forward_split_model`` (the
    tensor-core kernels' arithmetic: ``terms=2`` in bf16, 3 in fp32) on the
    CPU from the same inputs: within KERNEL_ATOL plus KERNEL_RTOL of the
    model's largest |value|, and one bf16 ulp more in bf16 (the flash
    pair's gate). Returns the largest gap."""
    from repro_torch.kernels.flash_attention import ref
    bf = got.dtype == torch.bfloat16
    model, _ = ref.flash_forward_split_model(
        q.cpu(), k.cpu(), v.cpu(), causal, terms=2 if bf else 3)
    g, m = got.cpu().float(), model.float()
    diff = (g - m).abs()
    gate = KERNEL_ATOL + KERNEL_RTOL * m.abs().max()
    if bf:
        gate = gate + bf16_ulp(torch.maximum(g.abs(), m.abs()))
    err = diff.max().item()
    check(bool((diff <= gate).all()), f"{what}: off its split model ({err})")
    return err


def check_flash(cfg, dev, gen, B, S, ops, ref, F, causal: bool = True):
    """fp32 flash attention (the serving forward, on the tensor cores) at
    ``cfg``'s heads: within KERNEL_ATOL / KERNEL_RTOL of the plain version,
    within the gate of its split model (:func:`flash_model_gate`), two
    launches bit-equal; timed beside SDPA."""
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.randn(B, S, Hq, D, device=dev, generator=gen)
    k = torch.randn(B, S, Hkv, D, device=dev, generator=gen)
    v = torch.randn(B, S, Hkv, D, device=dev, generator=gen)
    got = ops.flash_attention(q, k, v, causal=causal)
    again = ops.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
          f"flash_attention (causal={causal}) disagrees with its plain "
          f"version ({err})")
    check(torch.equal(got, again), f"flash_attention d_head {D}: two "
                                   f"launches differ")
    merr = flash_model_gate(got, q, k, v, causal, f"flash_attention d_head "
                                                  f"{D}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bms, by = bound(*work().flash_work(q, k, v, causal))
    call = lambda: ops.flash_attention(q, k, v, causal=causal)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    return {
        "max_abs_err": err,
        "model_max_abs_err": merr,
        "bit_equal_launches": True,
        "ms": cuda_ms(call),
        "device_ms": graph_ms(call),
        "plain_ms": cuda_ms(lambda: ref.attention_ref(q, k, v,
                                                      causal=causal)),
        "library_ms": cuda_ms(sdpa),
        "library_device_ms": graph_ms(sdpa),
        "bound_ms": bms, "bound_by": by,
        "at": f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
              f"{'causal' if causal else 'non-causal'} fp32",
    }


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def check_flash_bf16(cfg, dev, gen, B, S, ops, ref, F):
    """bf16 flash attention (q, k, v and out bf16, fp32 sums, on the tensor
    cores) at ``cfg``'s heads: every element within one bf16 ulp of the
    plain version past the fp32 gate (the two fp32 results agree within
    KERNEL_ATOL / RTOL and each rounds once; the ulp at the larger
    magnitude), within the gate of its split model (:func:`flash_model_gate`,
    P as three bf16 terms), two launches bit-equal. Reports the share of
    elements not bit-equal to the plain version and the largest gap in
    ulps; timed as :func:`check_flash`, beside SDPA in bf16, the bound from
    bf16 bytes."""
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    bf = torch.bfloat16
    q = torch.randn(B, S, Hq, D, device=dev, generator=gen).to(bf)
    k = torch.randn(B, S, Hkv, D, device=dev, generator=gen).to(bf)
    v = torch.randn(B, S, Hkv, D, device=dev, generator=gen).to(bf)
    got = ops.flash_attention(q, k, v, causal=True)
    again = ops.flash_attention(q, k, v, causal=True)
    want = ref.attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype == bf, "flash bf16: output not bf16")
    diff = (got.float() - want.float()).abs()
    ulp = bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
    gate = KERNEL_ATOL + KERNEL_RTOL * want.float().abs() + ulp
    err = diff.max().item()
    check(bool((diff <= gate).all()),
          f"flash_attention bf16 d_head {D}: past one ulp of its plain "
          f"version ({err})")
    check(torch.equal(bits(got), bits(again)),
          f"flash_attention bf16 d_head {D}: two launches differ")
    merr = flash_model_gate(got, q, k, v, True, f"flash_attention bf16 "
                                                f"d_head {D}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bms, by = bound(*work().flash_work(q, k, v, True), BF16_FLOP_PER_S)
    call = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    return {
        "max_abs_err": err,
        "not_bit_equal_share": (bits(got) != bits(want)).float().mean()
        .item(),
        "max_ulps": (diff / ulp).max().item(),
        "past_one_ulp": int((diff > ulp).sum()),
        "model_max_abs_err": merr,
        "bit_equal_launches": True,
        "ms": cuda_ms(call),
        "device_ms": graph_ms(call),
        "plain_ms": cuda_ms(lambda: ref.attention_ref(q, k, v, causal=True)),
        "library_ms": cuda_ms(sdpa),
        "library_device_ms": graph_ms(sdpa),
        "bound_ms": bms, "bound_by": by,
        "at": f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal bf16",
    }


# --------------------------------------------------------------- phase 16

# the wire tier's runs: MNIST-MLP3 at its published width, 4 silos of
# synthetic MNIST (4096 examples), sigma 0.5, C 1 (B = 4); lr 0.1, where 10
# rounds take the loss down (the example's 0.5 raises it over its first 10
# rounds at this noise: the mean update's noise is sigma C / 4 an element);
# lambda 0.7 in the serial, pipelined and speculative runs, so that a
# speculative round reads both of its streams from memory (xi_{t-1} the
# round before's cached xi)
WIRE_SILOS, WIRE_ROUNDS, WIRE_LR, WIRE_LAM = 4, 10, 0.1, 0.7
# the fault-tolerant runs: 6 silos, quorum 4 (tests/test_faults.py:123);
# the chaos plan's seed 6 schedules an updater crash, a dropped blob, a
# hang (silo 4 in round 7, which finishes late beside round 8) with a
# corrupted blob, and KDS denials; the journal's resume plan (seed 7, 4
# silos, no hang) crashes a silo before the restart and corrupts a blob
# after it; the CLI's (seed 1) corrupts a blob and crashes the updater
CHAOS_SILOS, CHAOS_QUORUM, CHAOS_ROUNDS, CHAOS_SEED = 6, 4, 12, 6
# 3 rounds card vs CPU: each round's mean update carries the masks' fp32
# residue (contributions reach 10 B; 8 ulps of 10 B a sum), moved by lr
WIRE_PARAM_ATOL = 3 * WIRE_LR * 8 * 2.0 ** -23 * 10 * 4.0
# the losses move with the params by that much over 784 inputs
WIRE_LOSS_RTOL = 1e-4


def wire_update(p, update, lr):
    """The model owner's update: the numpy mean update onto the params'
    device, then one SGD step."""
    return {k: v - lr * torch.as_tensor(update[k], device=v.device)
            for k, v in p.items()}


def instrument_wire(sess) -> dict:
    """Per-party times of a session's rounds, read by wrapping methods on
    its component instances (the path's code is untouched): the host ms of
    the admin plane (keys, verdicts, set; the advance; the batch tag), the
    broadcast's encode, each handler's round trip (the times the session
    feeds ``SiloTelemetry``) and seal, the updater's ingest (open, decode,
    accumulate) and close; and each handler's compute on the card (its
    forward/backward and ``clip_mask``, between CUDA events). ``grad_fn``
    wraps the model owner's gradient code to record the first event."""
    t = {k: [] for k in ("admin_plane", "advance", "batch_tag", "broadcast",
                         "handler_round_trip", "seal", "ingest", "close")}
    events, starts = [], []

    def host(name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                t[name].append((time.perf_counter() - t0) * 1e3)
        return wrapped

    sess._admin_plane = host("admin_plane", sess._admin_plane)
    sess._params_broadcast = host("broadcast", sess._params_broadcast)
    sess._batch_tag = host("batch_tag", sess._batch_tag)
    sess.admin.advance = host("advance", sess.admin.advance)
    sess.updater.ingest = host("ingest", sess.updater.ingest)
    sess.updater.close_round = host("close", sess.updater.close_round)
    observe = sess.telemetry.observe

    def telemetry(silo, seconds):
        t["handler_round_trip"].append(seconds * 1e3)
        observe(silo, seconds)

    sess.telemetry.observe = telemetry
    for h in sess.handlers:
        h.channel.send = host("seal", h.channel.send)

        def contrib(*a, _fn=h._masked_contrib, **k):
            out = _fn(*a, **k)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events.append((starts.pop(), end))
            return out

        h._masked_contrib = contrib

    def grad_fn(inner):
        def timed_grad(params, data):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            starts.append(start)
            return inner(params, data)
        return timed_grad

    def read(rounds: int) -> dict:
        torch.cuda.synchronize()
        t["handler_compute_card"] = [a.elapsed_time(b) for a, b in events]
        return {k: {"per_round_ms": sum(v) / rounds,
                    "median_call_ms": float(np.median(v)) if v else None,
                    "calls": len(v)} for k, v in t.items()}

    return {"grad_fn": grad_fn, "read": read}


def check_clip_mask_wire(dev, P, ops, ref, keys, prev, per_stream) -> dict:
    """``clip_mask`` at the wire tier's shape, silo 1 of 4 over a partial
    ring (silo 2 out: nxt 3, 3 streams at t, 4 at t-1) at the phase's
    sigma 0.5 and C 1, both ``use_prev`` settings bit-equal to the plain
    version; timed as a call and on the card (50 launches in a CUDA graph,
    every scalar a device tensor), beside the launch floor and the bound of
    its 4 streams from the SASS issue count."""
    gen = torch.Generator(device=dev).manual_seed(16)
    g = torch.randn(P, generator=gen, device=dev) * 0.01
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    sc = f32(0.5) * f32(1.0)
    args = (f32(0.731), keys.key_r, keys.key_xi, prev, 1, 4, sc,
            f32(8.0) * sc, f32(0.7))
    kw = dict(nxt=3, noise_scale=sc / torch.sqrt(f32(3.0)),
              prev_noise_scale=sc / torch.sqrt(f32(4.0)))
    errs = {}
    for use_prev in (True, False):
        out = ops.clip_mask(g, *args, True, use_prev, **kw)
        plain = ref.clip_mask_ref(g, *args, True, use_prev, **kw)
        errs[f"use_prev={use_prev}"] = (out - plain).abs().max().item()
        check(errs[f"use_prev={use_prev}"] == 0.0,
              f"clip_mask at the wire shape differs: {errs}")
    call = lambda: ops.clip_mask(g, *args, **kw)
    parts = stream_bound(P, 4, per_stream)
    bms = max(parts.values())
    floor = launch_floor()
    return {
        "max_abs_err": 0.0, "checked": errs,
        "ms": cuda_ms(call), "device_ms": graph_ms(call),
        "plain_ms": cuda_ms(lambda: ref.clip_mask_ref(g, *args, **kw)),
        "library_ms": None, "launch_floor_ms": floor["device_ms"],
        "launch_floor_call_ms": floor["ms"],
        "bound_ms": bms,
        "bound_by": "bytes" if bms == parts["bytes"] else "operations",
        "bound_detail": {"ms_by_limit": parts},
        "at": f"P={P} (MNIST-MLP3) silo 1 nxt 3 use_pairwise use_prev fp32",
    }


def ext_host_split(dev, ops, g, xi, xp, args, kw) -> dict:
    """Where one call of row 14 (``ops.clip_mask`` with external streams,
    as the speculative handler makes it) spends its host time, host-clocked
    (:func:`host_ms`): the whole call; its defaults (``nxt`` and the two
    stream scales, ``ref.clip_mask_defaults``); its five scalars'
    ``torch.as_tensor`` and their ``torch.stack`` (a device launch); the
    CUDA wrapper with the scalars built and the C entry stubbed (its
    checks); the C entry alone with its arguments built beforehand. The
    stub's calls are taken off the launch counter again."""
    from repro_torch.kernels.dispatch import check_key
    from repro_torch.kernels.dp_fused import dp_fused as dp
    from repro_torch.kernels.dp_fused import ref

    scale, kr, kx, kp, silo, n, sc, b, lam = args
    kr, kx, kp = (check_key("key", k) for k in (kr, kx, kp))
    out = torch.empty_like(g)
    defaults = lambda: ref.clip_mask_defaults(
        silo, n, sc, dev, kw["nxt"], kw["noise_scale"], kw["prev_noise_scale"])
    nxt, s, s_prev = defaults()
    stack = lambda: torch.stack([
        torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())
        for x in (scale, s, b, lam, s_prev)])
    scalars = stack()
    entry = (g.data_ptr(), xi.data_ptr(), xp.data_ptr(), out.data_ptr(),
             g.shape[0], *kr, *kx, *kp, silo, nxt, scalars.data_ptr(), 1, 1)
    launch = lambda: dp._CLIP_MASK_EXT.launch(g.device, *entry)
    res = {"call_ms": host_ms(lambda: ops.clip_mask(g, *args, xi=xi, xp=xp,
                                                    **kw)),
           "defaults_ms": host_ms(defaults), "scalars_ms": host_ms(stack),
           "entry_ms": host_ms(launch)}
    real, counted = dp._CLIP_MASK_EXT, dp.CLIP_MASK_EXT.launches
    dp._CLIP_MASK_EXT = types.SimpleNamespace(launch=lambda *a: 0)
    try:
        res["wrapper_ms"] = host_ms(lambda: dp.clip_mask_ext_cuda(
            g, xi, xp, scalars, kr, kx, kp, silo, nxt, out=out))
    finally:
        dp._CLIP_MASK_EXT, dp.CLIP_MASK_EXT.launches = real, counted
    return res


def check_stream_kernels(dev, P, ops, ref, keys, prev, per_stream) -> dict:
    """The speculative rounds' two port kernels at the wire tier's shape.
    ``noise_stream`` bit-equal to its plain version at P and at a ragged
    length; the external-stream ``clip_mask``, given ``noise_stream``'s
    buffers, bit-equal to its plain version and to ``clip_mask``'s
    in-kernel draw (silo 1 of 4 over the partial ring of
    ``check_clip_mask_wire``, both ``use_prev`` settings). Each timed as a
    call and on the card beside the launch floor and its bound: one normal
    an element and the output written for ``noise_stream``, two normals
    (r_i, r_nxt) and g, xi, xp read and the output written for the
    variant, at ``clip_mask``'s SASS cost a normal (the same device
    function)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    g = torch.randn(P, generator=gen, device=dev) * 0.01
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    sc = f32(0.5) * f32(1.0)
    args = (f32(0.731), keys.key_r, keys.key_xi, prev, 1, 4, sc,
            f32(8.0) * sc, f32(0.7))
    kw = dict(nxt=3, noise_scale=sc / torch.sqrt(f32(3.0)),
              prev_noise_scale=sc / torch.sqrt(f32(4.0)))
    ns_err = {}
    for n in (P, P - 333):
        out = ops.noise_stream(keys.key_xi, 1, torch.empty(n, device=dev))
        ns_err[f"P={n}"] = (out - ref.noise_stream_ref(
            keys.key_xi, 1, n, dev)).abs().max().item()
    check(all(e == 0.0 for e in ns_err.values()),
          f"noise_stream differs from its plain version: {ns_err}")
    xi = ops.noise_stream(keys.key_xi, 1, torch.empty(P, device=dev))
    xp = ops.noise_stream(prev, 1, torch.empty(P, device=dev))
    ext_err = {}
    for use_prev in (True, False):
        out = ops.clip_mask(g, *args, True, use_prev, xi=xi, xp=xp, **kw)
        plain = ref.clip_mask_ref(g, *args, True, use_prev, xi=xi, xp=xp,
                                  **kw)
        drawn = ops.clip_mask(g, *args, True, use_prev, **kw)
        ext_err[f"use_prev={use_prev}"] = {
            "plain": (out - plain).abs().max().item(),
            "in_kernel_draw": (out - drawn).abs().max().item()}
    check(all(e == 0.0 for d in ext_err.values() for e in d.values()),
          f"clip_mask with external streams differs: {ext_err}")
    floor = launch_floor()
    out = torch.empty(P, device=dev)
    rows = {}
    for name, call, plain, streams, words, errs in (
            ("noise_stream",
             lambda: ops.noise_stream(keys.key_xi, 1, out),
             lambda: ref.noise_stream_ref(keys.key_xi, 1, P, dev), 1, 1,
             ns_err),
            ("clip_mask_ext",
             lambda: ops.clip_mask(g, *args, xi=xi, xp=xp, **kw),
             lambda: ref.clip_mask_ref(g, *args, xi=xi, xp=xp, **kw), 2, 4,
             ext_err)):
        parts = stream_bound(P, streams, per_stream, words)
        bms = max(parts.values())
        rows[name] = {
            "max_abs_err": 0.0, "checked": errs,
            "ms": cuda_ms(call), "device_ms": graph_ms(call),
            "plain_ms": cuda_ms(plain), "library_ms": None,
            "library_call": "none (no PyTorch call draws keyed threefry "
                            "normals)",
            "launch_floor_ms": floor["device_ms"],
            "launch_floor_call_ms": floor["ms"], "bound_ms": bms,
            "bound_by": "bytes" if bms == parts["bytes"] else "operations",
            "bound_detail": {"ms_by_limit": parts, "streams": streams,
                             "fp32_words_an_element": words},
            "at": f"P={P} (MNIST-MLP3) silo 1 fp32"
                  + (" nxt 3 use_pairwise use_prev" if words > 1 else "")}
        r = rows[name]
        if name == "clip_mask_ext":
            r["host_split"] = ext_host_split(dev, ops, g, xi, xp, args, kw)
            log(f"[kernel] clip_mask_ext wire, host ms a call: "
                f"{json.dumps(r['host_split'])}")
        log(f"[kernel] {name} wire: max_abs_err {json.dumps(errs)} | kernel "
            f"{r['ms']:.4f} ms (on the card {r['device_ms']:.4f}) | launch "
            f"floor {floor['ms']:.4f} ms (on the card "
            f"{floor['device_ms']:.4f}) | plain {r['plain_ms']:.4f} ms | "
            f"bound {bms:.4f} ms ({r['bound_by']}: {json.dumps(parts)}) | "
            f"{r['at']}")
    return rows


def oracle_replay(make, journal, grad_fn, lr) -> tuple:
    """A fresh session (``make()``: (session, params)) scheduling each
    journaled round's realized set as an elastic membership change, then
    the serial ``step`` loop: the fault-free run a quorum-closed run must
    equal bit for bit. Returns (session, params, losses)."""
    sess, params = make()
    losses = []
    for rec in journal.rounds:
        t, want = rec["round"], np.asarray(rec["active"], bool)
        cur = sess.membership.active_at(t)
        for silo in range(sess.n_silos):
            if cur[silo] and not want[silo]:
                check(sess.drop_silo(silo, step=t), "oracle: drop refused")
            elif not cur[silo] and want[silo]:
                sess.rejoin_silo(silo, step=t)
        params, loss = sess.step(t, params, grad_fn, wire_update, lr)
        losses.append(loss)
    return sess, params, losses


def tolerant_phase(dev, init, wpriv, grad_fn, src: Path) -> dict:
    """Phase 16's fault-tolerant rounds on the card: a fault-free tolerant
    run of 6 silos (each handler on a worker thread and its own CUDA
    stream) bit-equal to the serial loop, its warm rounds setting the
    deadline; a seeded chaos run (6 silos, quorum 4, 12 rounds, the plan's
    hangs twice the deadline) that closes every round and equals the
    elastic oracle bit for bit; a journal resumed after a driver restart
    (no deadline) equal to a run that never stopped; and the CLI's chaos
    rounds with a journal."""
    import tempfile

    from repro_torch.api import CollaborativeSession
    from repro_torch.core import flatbuf
    from repro_torch.core.tee import wire
    from repro_torch.core.tee.faults import (FaultInjector, FaultPlan,
                                             RoundJournal)
    from repro_torch.data.synthetic import synthetic_mnist

    def make(n):
        silos = [{"x": s.x, "y": s.y} for s in synthetic_mnist(
            n_train=4096, n_test=16)[0].split(n)]

        def new():
            sess = CollaborativeSession.from_silos(silos, wpriv, device=dev)
            return sess, {k: v.clone() for k, v in init.items()}
        return new

    def bits(params):
        return wire.pack_np(flatbuf.layout_of(params), params).view(np.uint32)

    out = {}
    six = make(CHAOS_SILOS)
    rounds = 5
    sa, pa = six()
    pa, la = sa.run(pa, grad_fn, wire_update, WIRE_LR, rounds,
                    pipelined=False)
    sb, pb = six()
    stamps = []

    def upd(p, update, lr):
        q = wire_update(p, update, lr)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return q

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pb, lb = sb.run(pb, grad_fn, upd, WIRE_LR, rounds, round_timeout_s=60.0,
                    quorum=CHAOS_SILOS)
    round_ms = np.diff([t0] + stamps) * 1e3
    check(np.array_equal(bits(pa), bits(pb)) and la == lb
          and sa.wire_stats == sb.wire_stats,
          "fault-free tolerant rounds are not bit-equal to serial on the card")
    warm_ms = float(np.median(round_ms[1:]))
    deadline = max(0.05, 4 * warm_ms / 1e3)
    out["fault_free"] = {"rounds": rounds, "round_ms": round_ms.tolist(),
                         "warm_median_ms": warm_ms, "deadline_s": deadline}
    log(f"[wire] fault-free tolerant == serial bit for bit (6 silos, "
        f"{rounds} rounds; rounds {json.dumps([round(x, 3) for x in round_ms])}"
        f" ms): deadline 4 x the warm median {warm_ms:.3f} ms = "
        f"{deadline:.4f} s")

    sess, params = six()
    inj = FaultInjector(FaultPlan.from_seed(
        CHAOS_SEED, CHAOS_SILOS, CHAOS_ROUNDS, quorum=CHAOS_QUORUM,
        hang_s=2 * deadline))
    journal = RoundJournal()
    t0 = time.perf_counter()
    params, losses = sess.run(params, grad_fn, wire_update, WIRE_LR,
                              CHAOS_ROUNDS, round_timeout_s=deadline,
                              quorum=CHAOS_QUORUM, chaos=inj,
                              journal=journal)
    chaos_s = time.perf_counter() - t0
    check(journal.rounds_done == CHAOS_ROUNDS and bool(inj.fired),
          f"chaos: {journal.rounds_done} rounds closed, fired {inj.fired}")
    osess, oparams, olosses = oracle_replay(six, journal, grad_fn, WIRE_LR)
    check(np.array_equal(bits(params), bits(oparams)) and losses == olosses
          and sess.accountant.contributions == osess.accountant.contributions,
          "chaos run is not bit-equal to its elastic oracle on the card")
    st = dict(sess.fault_stats)
    st["integrity_failures"] = [f"{f['round']}:{f['silo']}"
                                for f in st["integrity_failures"]]
    out["chaos"] = {"seed": CHAOS_SEED, "silos": CHAOS_SILOS,
                    "quorum": CHAOS_QUORUM, "rounds": CHAOS_ROUNDS,
                    "deadline_s": deadline, "plan": inj.plan.counts(),
                    "fired": inj.fired, "fault_stats": st, "s": chaos_s,
                    "contributions": sess.accountant.contributions,
                    "loss": [losses[0], losses[-1]]}
    log(f"[wire] chaos (seed {CHAOS_SEED}, {CHAOS_SILOS} silos, quorum "
        f"{CHAOS_QUORUM}, {CHAOS_ROUNDS} rounds, deadline {deadline:.4f} s) "
        f"in {chaos_s:.2f} s == elastic oracle bit for bit | plan "
        f"{json.dumps(inj.plan.counts())} | fired {json.dumps(inj.fired)} | "
        f"fault stats {json.dumps(st)} | contributions "
        f"{sess.accountant.contributions}")

    four = make(4)
    plan = FaultPlan.from_seed(7, 4, 4, quorum=2, hang_rate=0.0)
    ref_sess, ref_params = four()
    ref_journal = RoundJournal()
    ref_params, ref_losses = ref_sess.run(
        ref_params, grad_fn, wire_update, WIRE_LR, 4, quorum=2,
        chaos=FaultInjector(plan), journal=ref_journal)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rounds.journal")
        s1, p1 = four()
        inj = FaultInjector(plan)
        _, l1 = s1.run(p1, grad_fn, wire_update, WIRE_LR, 2, quorum=2,
                       chaos=inj, journal=RoundJournal(path=path))
        s2, _ = four()
        j2 = RoundJournal.load(path)
        p2 = s2.resume(j2)
        p2, l2 = s2.run(p2, grad_fn, wire_update, WIRE_LR, 2, quorum=2,
                        chaos=inj, journal=j2)
        check(j2.rounds == ref_journal.rounds
              and np.array_equal(bits(p2), bits(ref_params))
              and l1 + l2 == ref_losses and bool(inj.fired),
              "journal resume is not bit-equal to an uninterrupted run")
        out["resume"] = {"rounds": 4, "cut": 2, "fired": inj.fired,
                         "sets": [r["active"] for r in j2.rounds]}
        log(f"[wire] journal resume after 2 of 4 rounds == uninterrupted bit "
            f"for bit | fired {json.dumps(inj.fired)} | sets "
            f"{json.dumps(out['resume']['sets'])}")

        cli = [sys.executable, "-m", "repro_torch.launch.train",
               "--wire-rounds", "6", "--chaos-seed", "1", "--round-timeout",
               f"{deadline:.4f}", "--journal",
               os.path.join(tmp, "cli.journal")]
        t0 = time.perf_counter()
        r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                           timeout=300,
                           env={**os.environ, "PYTHONPATH": str(src)})
        check(r.returncode == 0 and "wire tier: 6 rounds closed on cuda"
              in r.stdout and "fault stats:" in r.stdout,
              f"wire chaos CLI failed ({r.returncode}):\n{r.stdout}\n"
              f"{r.stderr}")
        lines = [x for x in r.stdout.splitlines()
                 if x.startswith(("wire", "fault", "chaos"))]
        out["cli"] = {"cmd": " ".join(cli[1:-1] + ["<tmp>/cli.journal"]),
                      "s": time.perf_counter() - t0, "last": lines}
        log(f"[cli] {out['cli']['cmd']}: exit 0 in {out['cli']['s']:.1f} s | "
            + " | ".join(lines))
    return out


def wire_phase(dev, per_stream: dict, src: Path = ROOT / "src") -> tuple:
    """Phase 16, the wire tier on the card: MNIST-MLP3 at its published
    width over 4 silos, ``clip_mask``, ``noise_stream`` and the
    external-stream ``clip_mask`` at its shape against their plain
    versions, 10 serial, 10 pipelined and 10 speculative rounds (bit-equal;
    ``clip_mask`` once per silo per round, or in speculative rounds the
    variant once and ``noise_stream`` on each miss and prefetch; the loss
    falling; each round's time split by party), 3 rounds card vs CPU with a
    drop and a full resync, the ``--wire-rounds`` CLI (from ``src``), and
    the fault-tolerant rounds (:func:`tolerant_phase`). Returns ``(record,
    clip_mask's wire row, the two port kernels' rows)``."""
    from repro_torch.api import CollaborativeSession
    from repro_torch.configs.base import PrivacyConfig
    from repro_torch.configs.paper_models import MNIST_MLP3
    from repro_torch.core import flatbuf, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.core.tee import wire
    from repro_torch.data.synthetic import synthetic_mnist
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.dp_fused import ops as noise_ops
    from repro_torch.kernels.dp_fused import ref as noise_ref
    from repro_torch.models.small import build_small_model, value_and_grad

    t16 = time.perf_counter()
    sm = build_small_model(MNIST_MLP3)
    silos = [{"x": s.x, "y": s.y} for s in synthetic_mnist(
        n_train=4096, n_test=16)[0].split(WIRE_SILOS)]
    wpriv = PrivacyConfig(enabled=True, sigma=0.5, clip_bound=1.0,
                          noise_lambda=WIRE_LAM)
    init = sm.init(torch.Generator(device=dev).manual_seed(1))
    P_WIRE = flatbuf.layout_of(init).total
    grad_fn = value_and_grad(sm.loss)
    row = check_clip_mask_wire(
        dev, P_WIRE, noise_ops, noise_ref, step_keys(prng.PRNGKey(0), 0),
        step_keys(prng.PRNGKey(0), 1).key_xi, per_stream)
    stream_rows = check_stream_kernels(
        dev, P_WIRE, noise_ops, noise_ref, step_keys(prng.PRNGKey(0), 0),
        step_keys(prng.PRNGKey(0), 1).key_xi, per_stream)
    log(f"[kernel] clip_mask wire: max_abs_err {row['checked']} | kernel "
        f"{row['ms']:.4f} ms (on the card {row['device_ms']:.4f}) | launch "
        f"floor {row['launch_floor_call_ms']:.4f} ms (on the card "
        f"{row['launch_floor_ms']:.4f}) | plain {row['plain_ms']:.4f} ms | "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
        f"{json.dumps(row['bound_detail']['ms_by_limit'])}) | {row['at']}")
    runs = {}
    for mode in ("serial", "pipelined", "speculative"):
        sess = CollaborativeSession.from_silos(silos, wpriv,
                                               params_template=init)
        parts = instrument_wire(sess)
        stamps = []

        def upd(p, update, lr, _stamps=stamps):
            out = wire_update(p, update, lr)
            torch.cuda.synchronize()
            _stamps.append(time.perf_counter())
            return out

        params = {k: v.clone() for k, v in init.items()}
        dispatch.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, losses = sess.run(params, parts["grad_fn"](grad_fn), upd,
                                  WIRE_LR, WIRE_ROUNDS,
                                  pipelined=mode != "serial",
                                  speculative=mode == "speculative")
        counts = dispatch.launch_counts()
        hits = [h._spec_hits for h in sess.handlers]
        if mode == "speculative":
            # per handler: round 0 draws xi and xi_{t-1}, every later
            # round's xi is prefetched, and both of its streams hit
            want = {"clip_mask_ext": WIRE_SILOS * WIRE_ROUNDS,
                    "noise_stream": WIRE_SILOS * (WIRE_ROUNDS + 1)}
            check(hits == [2 * (WIRE_ROUNDS - 1)] * WIRE_SILOS,
                  f"wire speculative: cache hits {hits}")
        else:
            want = {"clip_mask": WIRE_SILOS * WIRE_ROUNDS}
        check({k: v for k, v in counts.items() if v} == want,
              f"wire {mode}: launches {counts}, expected {want}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"wire {mode}: loss {losses[0]} -> {losses[-1]}")
        rounds_ms = np.diff([t0] + stamps) * 1e3
        runs[mode] = {"sess": sess, "losses": losses,
                      "packed": wire.pack_np(flatbuf.layout_of(params),
                                             params),
                      "round_ms": rounds_ms.tolist(),
                      "median_round_ms": float(np.median(rounds_ms)),
                      "parts": parts["read"](WIRE_ROUNDS),
                      "launches": {k: v for k, v in counts.items() if v},
                      "spec_hits": hits}
    a = runs["serial"]
    for mode in ("pipelined", "speculative"):
        b = runs[mode]
        check(np.array_equal(a["packed"].view(np.uint32),
                             b["packed"].view(np.uint32))
              and a["losses"] == b["losses"]
              and a["sess"].wire_stats == b["sess"].wire_stats,
              f"{mode} wire rounds are not bit-equal to serial on the card")
    report = {mode: {k: v for k, v in r.items()
                             if k not in ("sess", "packed")}
                      for mode, r in runs.items()}
    report["wire_stats"] = a["sess"].wire_stats
    report["P"] = P_WIRE
    for mode, r in runs.items():
        log(f"[wire] {mode}: {WIRE_ROUNDS} rounds, median "
            f"{r['median_round_ms']:.3f} ms a round (rounds "
            f"{json.dumps([round(x, 3) for x in r['round_ms']])}) | loss "
            f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} | launches "
            f"{json.dumps(r['launches'])} | cache hits {r['spec_hits']}")
        log(f"[wire] {mode} split, ms a round (median call ms, calls): "
            + ", ".join(f"{k} {v['per_round_ms']:.3f} "
                        f"({v['median_call_ms'] or 0:.4f}, {v['calls']})"
                        for k, v in r["parts"].items()))
    log(f"[wire] pipelined == serial == speculative bit for bit; bytes on "
        f"the wire {json.dumps(a['sess'].wire_stats)}")
    # the card's busy share of 3 serial rounds (torch.profiler; a first
    # round outside the window warms the new session)
    from repro_torch.launch.profile_serve import _window
    sess = CollaborativeSession.from_silos(silos, wpriv, params_template=init)
    params, _ = sess.step(0, {k: v.clone() for k, v in init.items()},
                          grad_fn, wire_update, WIRE_LR)
    prof = _window(lambda: sess.run(params, grad_fn, wire_update, WIRE_LR, 3,
                                    pipelined=False), 8)
    report["profile_3_serial_rounds"] = prof
    log(f"[wire] 3 serial rounds under torch.profiler: wall "
        f"{prof['wall_ms']:.2f} ms | card busy {prof['device_busy_ms']:.3f} "
        f"ms ({prof['busy_share']:.2%}) | by device time: "
        + "; ".join(f"{r['name'][:48]} x{r['count']} {r['device_ms']:.3f}"
                    for r in prof["top"]))

    # 3 rounds at lambda 0.7, silo 1 out in round 1 and back (a full
    # resync) in round 2, on the card and on the host CPU, same weights
    def three(device):
        sess = CollaborativeSession.from_silos(silos, wpriv, device=device)
        params = {k: v.to(device) for k, v in init.items()}
        dispatch.reset_launches()
        losses = []
        for t in range(3):
            if t == 1:
                check(sess.drop_silo(1), "wire: drop refused")
            if t == 2:
                check(sess.rejoin_silo(1), "wire: rejoin refused")
            params, loss = sess.step(t, params, grad_fn, wire_update,
                                     WIRE_LR)
            losses.append(loss)
        return (sess, wire.pack_np(flatbuf.layout_of(params), params),
                losses, dispatch.launch_counts())

    gs, gp, gl, gcounts = three(dev)
    cs, cp, cl, ccounts = three("cpu")
    check(gcounts["clip_mask"] == 4 + 3 + 4
          and sum(ccounts.values()) == 0, f"wire card vs CPU launches "
          f"{gcounts['clip_mask']} (card), {sum(ccounts.values())} (CPU)")
    check(gs.wire_stats["resync_bytes"] > 0, "wire: no full resync")
    loss_rel = float(np.max(np.abs(np.subtract(gl, cl)) / np.abs(cl)))
    param_err = float(np.abs(gp - cp).max())
    check(loss_rel <= WIRE_LOSS_RTOL and param_err <= WIRE_PARAM_ATOL
          and gs.epsilon() == cs.epsilon()
          and gs.accountant.history == cs.accountant.history,
          f"wire card vs CPU: loss {loss_rel} params {param_err} eps "
          f"{gs.epsilon()} / {cs.epsilon()} history "
          f"{gs.accountant.history} / {cs.accountant.history}")
    report["card_vs_cpu"] = {
        "loss_max_rel": loss_rel, "loss_rtol": WIRE_LOSS_RTOL,
        "param_max_abs": param_err, "param_atol": WIRE_PARAM_ATOL,
        "epsilon": gs.epsilon(), "history": gs.accountant.history}
    log(f"[wire] card vs CPU, 3 rounds (lambda 0.7, silo 1 out in round 1, "
        f"resynced in round 2): loss {loss_rel:.2e} rel (<= "
        f"{WIRE_LOSS_RTOL}), params {param_err:.2e} (<= "
        f"{WIRE_PARAM_ATOL:.2e}), eps {gs.epsilon():.4f} equal, "
        f"participation {gs.accountant.contributions}")
    cli = [sys.executable, "-m", "repro_torch.launch.train", "--wire-rounds",
           "4"]
    t0 = time.perf_counter()
    r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": str(src)})
    check(r.returncode == 0 and "wire tier: 4 rounds closed on cuda"
          in r.stdout, f"wire CLI failed ({r.returncode}):\n{r.stdout}\n"
          f"{r.stderr}")
    done = next(x for x in r.stdout.splitlines() if x.startswith("wire"))
    report["cli"] = {"cmd": " ".join(cli[1:]),
                     "s": time.perf_counter() - t0, "last": done}
    log(f"[cli] {' '.join(cli[1:])}: exit 0 in {report['cli']['s']:.1f} s "
        f"| {done}")
    row["launches"] = runs["serial"]["launches"]["clip_mask"]
    for name in stream_rows:
        stream_rows[name]["launches"] = runs["speculative"]["launches"][name]
    report["tolerant"] = tolerant_phase(dev, init, wpriv, grad_fn, src)
    report["phase_s"] = time.perf_counter() - t16
    log(f"[wire] phase 16 in {report['phase_s']:.1f} s")
    return report, row, stream_rows



# --------------------------------------------------------------- phase 11

def wkv_inputs(dev, gen, B, S, H, N, w=None):
    """The JAX package's test distribution at the path's shapes: r, k, v ~
    0.5 N(0, 1), decay in (0.45, 0.95) (or a constant ``w``), u ~ 0.3
    N(0, 1), an incoming state ~ 0.1 N(0, 1)."""
    n = lambda *s: torch.randn(*s, device=dev, generator=gen)
    r, k, v = n(B, S, H, N) * 0.5, n(B, S, H, N) * 0.5, n(B, S, H, N) * 0.5
    w = torch.sigmoid(n(B, S, H, N)) * 0.5 + 0.45 if w is None \
        else torch.full((B, S, H, N), w, device=dev)
    return r, k, v, w, n(H, N) * 0.3, n(B, H, N, N) * 0.1


def scan_timing(kernel, plain, nbytes: float, flops: float, at: str,
                graph_n: int = 50, plain_reps: int = 20) -> dict:
    """A scan's call and card times at one shape (``graph_n`` calls in the
    CUDA graph), beside its plain version's (``plain_reps`` calls) and its
    bound."""
    bms, by = bound(nbytes, flops)
    return {"ms": cuda_ms(kernel), "device_ms": graph_ms(kernel, graph_n),
            "plain_ms": cuda_ms(plain, reps=plain_reps),
            "bound_ms": bms, "bound_by": by, "at": at}


def check_wkv(dev, gen, B, S, H, N, ops, ref):
    """``wkv`` against its plain chunked version: at the main path's shape
    and at S 512 (both timed), at a ragged length past two staged passes
    (the plain version runs the recurrence) and under strong decay (w =
    0.05), within the JAX package's own bounds."""
    cases, timed_at = {}, {}
    for name, S_, w, tol in (("main", S, None, WKV_ATOL),
                             ("s512", 512, None, WKV_ATOL),
                             ("ragged", 37, None, WKV_ATOL),
                             ("strong decay", S, 0.05, WKV_STRONG_ATOL)):
        xs = wkv_inputs(dev, gen, B, S_, H, N, w)
        o, st = ops.wkv_chunked(*xs)
        po, pst = ref.wkv_chunked_ref(*xs)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(o).all() and torch.isfinite(st).all()),
              f"wkv {name}: non-finite")
        err = max((o - po).abs().max().item(), (st - pst).abs().max().item())
        check(err <= tol, f"wkv {name} (S={S_}) differs from its plain "
                          f"version by {err} (tolerance {tol})")
        cases[name] = {"S": S_, "max_abs_err": err, "tolerance": tol}
        if name in ("main", "s512"):
            timed_at[name] = xs
    out = {}
    for name, xs in timed_at.items():
        r, u, s0 = xs[0], xs[4], xs[5]
        S_ = r.shape[1]
        out[name] = scan_timing(
            lambda: ops.wkv_chunked(*xs), lambda: ref.wkv_chunked_ref(*xs),
            *work().wkv_work(r, u, s0),
            f"B={B} S={S_} H={H} N={N} fp32, with an incoming state")
        out[name]["max_abs_err"] = cases[name]["max_abs_err"]
    return {
        **out["main"], "s512": out["s512"], "cases": cases,
        "tolerance": f"{WKV_ATOL} ({WKV_STRONG_ATOL} under strong decay)",
        "library_ms": None,
        "library_call": "none (no single PyTorch call computes the scan)",
    }


def ssd_inputs(dev, gen, B, S, nh, P, N):
    """The JAX package's test distribution at the path's shapes."""
    n = lambda *s: torch.randn(*s, device=dev, generator=gen)
    return (n(B, S, nh, P) * 0.5,
            torch.nn.functional.softplus(n(B, S, nh)),
            -n(B, S, nh).abs() * 0.5, n(B, S, N) * 0.5, n(B, S, N) * 0.5,
            n(B, nh, P, N) * 0.1)


def check_ssd(dev, gen, B, S, nh, P, N, ops, ref):
    """``ssd`` against its plain chunked version at the main path's shape
    and at S 512 (both timed) and at a ragged length past two staged
    passes, within the JAX package's bound."""
    cases, timed_at = {}, {}
    for name, S_ in (("main", S), ("s512", 512), ("ragged", 37)):
        xs = ssd_inputs(dev, gen, B, S_, nh, P, N)
        y, h = ops.ssd_chunked(*xs)
        py, ph = ref.ssd_chunked_ref(*xs)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
              f"ssd {name}: non-finite")
        err = max((y - py).abs().max().item(), (h - ph).abs().max().item())
        check(err <= SSD_ATOL, f"ssd {name} (S={S_}) differs from its plain "
                               f"version by {err} (tolerance {SSD_ATOL})")
        cases[name] = {"S": S_, "max_abs_err": err, "tolerance": SSD_ATOL}
        if name in ("main", "s512"):
            timed_at[name] = xs
    out = {}
    for name, xs in timed_at.items():
        x, dt, _, Bc, _, h0 = xs
        S_ = x.shape[1]
        out[name] = scan_timing(
            lambda: ops.ssd_chunked(*xs), lambda: ref.ssd_chunked_ref(*xs),
            *work().ssd_work(x, dt, Bc, h0),
            f"B={B} S={S_} nh={nh} P={P} N={N} fp32, with an incoming state")
        out[name]["max_abs_err"] = cases[name]["max_abs_err"]
    return {
        **out["main"], "s512": out["s512"], "cases": cases,
        "tolerance": SSD_ATOL, "library_ms": None,
        "library_call": "none (no single PyTorch call computes the scan)",
    }


def log_scan(name: str, r: dict) -> None:
    """One line for the main shape, one for S 512."""
    log(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g} "
        f"(cases {json.dumps(r['cases'])}) | kernel {r['ms']:.4f} ms "
        f"(on the card {r['device_ms']:.4f}) | plain {r['plain_ms']:.4f} "
        f"ms | library none | bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}) | {r['at']}")
    x = r["s512"]
    log(f"[kernel] {name} S 512: max_abs_err {x['max_abs_err']:.3g} | kernel "
        f"{x['ms']:.4f} ms (on the card {x['device_ms']:.4f}) | plain "
        f"{x['plain_ms']:.4f} ms | bound {x['bound_ms']:.4f} ms "
        f"({x['bound_by']}) | {x['at']}")


def check_scans(dev, seed: int) -> dict:
    """Phase 11's scans, from the ``repro_torch`` first on ``sys.path``:
    ``wkv`` at rwkv6-7b's and ``ssd`` at zamba2-7b's whole-prompt prefill
    (batch 4, prompt 32) and at S 512, each logged."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.models.mamba2 import dims as mamba2_dims

    rcfg = get_config("rwkv6-7b")
    _, nh, P, N, _ = mamba2_dims(get_config("zamba2-7b"))
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"wkv": check_wkv(dev, gen, 4, 32, rcfg.n_heads,
                            rcfg.rwkv_head_size, wkv_ops, wkv_ref),
           "ssd": check_ssd(dev, gen, 4, 32, nh, P, N, ssd_ops, ssd_ref)}
    for name, r in out.items():
        log_scan(name, r)
    return out


def log_scan_launches(rcfg, zcfg) -> None:
    """Each scan's launch configuration at the main path's shapes, as this
    checkout's built library reports it: a configuration, not a
    measurement, so it stays out of the ``kernels`` line."""
    from repro_torch.kernels.mamba2.mamba2 import kernel_config as ssd_config
    from repro_torch.kernels.rwkv6.rwkv6 import kernel_config as wkv_config
    from repro_torch.models.mamba2 import dims as mamba2_dims

    _, nh, P, N, _ = mamba2_dims(zcfg)
    for name, blocks, cfg in (
            ("wkv", 4 * rcfg.n_heads, wkv_config(rcfg.rwkv_head_size)),
            ("ssd", 4 * nh, ssd_config(P, N))):
        log(f"[kernel] {name} launch (the library's configuration, not "
            f"measured): {json.dumps({'blocks': blocks, **cfg})}")


def streams_phase(dev, src: Path) -> dict:
    """``--streams``: the wire tier's stream kernels alone, rows 8, 13 and
    14 as phases 6 and 16 check and time them (row 8 at the training shape,
    qwen2.5-3b at 12 layers, and at the wire shape; ``noise_stream`` and
    the external-stream ``clip_mask`` at the wire shape), each held to the
    pinned bound, with the live SASS count of the build as a report. Uses
    only wrappers every tree with ``ops.noise_stream`` has, so two trees
    are timed in one call."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.core import flatbuf, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.kernels.dp_fused import ops as noise_ops
    from repro_torch.kernels.dp_fused import ref as noise_ref
    from repro_torch.models.packing import param_tree
    from repro_torch.models.transformer import Transformer

    live = stream_ops(library_sass(), ROW8_SASS)
    log(f"[kernel] clip_mask SASS, live (a report; the bound uses "
        f"{json.dumps(CLIP_MASK_OPS)}): {json.dumps(live)}")
    configs = stream_configs()
    log(f"[kernel] stream kernels' launch configuration: "
        f"{json.dumps(configs) if configs else 'not reported by this tree'}")
    cut12 = dc.replace(get_config("qwen2.5-3b"), n_layers=12)
    P = flatbuf.layout_of(param_tree(Transformer(cut12, "meta"))).total
    g = torch.randn(P, generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev)
    train = check_clip_mask(dev, P, g, noise_ops, noise_ref,
                            step_keys(prng.PRNGKey(1), 0),
                            step_keys(prng.PRNGKey(1), 1).key_xi,
                            CLIP_MASK_OPS)
    del g
    torch.cuda.empty_cache()
    log(f"[kernel] clip_mask train: max_abs_err {train['max_abs_err']} | "
        f"kernel {train['ms']:.4f} ms (on the card {train['device_ms']:.4f})"
        f" | plain {train['plain_ms']:.4f} ms ({train['plain_at']}) | bound "
        f"{train['bound_ms']:.4f} ms ({train['bound_by']}) | {train['at']}")
    P_WIRE = 235_520  # MNIST-MLP3's packed length, as phase 16 derives it
    keys = step_keys(prng.PRNGKey(0), 0)
    prev = step_keys(prng.PRNGKey(0), 1).key_xi
    wire = check_clip_mask_wire(dev, P_WIRE, noise_ops, noise_ref, keys, prev,
                                CLIP_MASK_OPS)
    log(f"[kernel] clip_mask wire: max_abs_err {wire['checked']} | kernel "
        f"{wire['ms']:.4f} ms (on the card {wire['device_ms']:.4f}) | plain "
        f"{wire['plain_ms']:.4f} ms | bound {wire['bound_ms']:.4f} ms "
        f"({wire['bound_by']}) | {wire['at']}")
    rows = check_stream_kernels(dev, P_WIRE, noise_ops, noise_ref, keys, prev,
                                CLIP_MASK_OPS)
    return {"clip_mask": train, "clip_mask_wire": wire, **rows,
            "live_sass": live, "pinned_sass": CLIP_MASK_OPS,
            "configs": configs}


# --------------------------------------------------------------- phase 19
# qwen2.5-3b at published width cut to 2 of 36 layers for the disk: an
# AdamW checkpoint in JAX's layout holds params, master, m and v (16 bytes a
# parameter: 12.4 GB here, 24.8 GB at phase 7's 12 layers, 54.4 GB at 36)
PERSIST_LAYERS = 2
PERSIST_P = 776_485_888  # its packed length
# the budget silo 3 spends in step 1 (sigma 0.3 gives eps ~ 15 a step)
PERSIST_BUDGET = 1e-3


def padding_max(layout, buf) -> float:
    """Largest |value| at the packed padding of ``buf``."""
    worst = 0.0
    for size, pad, off in zip(layout.sizes, layout.padded, layout.offsets):
        if pad > size:
            worst = max(worst, buf[off + size:off + pad].abs().max().item())
    tail = buf[layout.offsets[-1] + layout.padded[-1]:]
    return max(worst, tail.abs().max().item() if tail.numel() else 0.0)


def persist_phase(dev) -> dict:
    """Phase 19: the Trainer's checkpoint/resume, per-silo budgets, elastic
    membership, the deadline and SIGTERM preemption on the card, at
    qwen2.5-3b's published width and 2 layers (4 silos, batch 16 x 64,
    sigma 0.3, dynamic clipping, lambda 0.7, AdamW 1e-3, a FederatedBatcher
    over synthetic token rows as ``batch_state``): (a) fused tier, 2 steps,
    a checkpoint, a fresh Trainer and 2 more steps bit-equal to 4 steps
    without a break (master, m, v, clip bound, noise state, the ledger's
    state dict, the losses), the buffers never rebound and the padding
    zero; the checkpoint's bytes and its save and restore split; (b) the
    barrier tier with a budget silo 3 spends in step 1: ``clip_mask`` 3
    times in step 2, silo 3's epsilon still, and the checkpoint's budgets
    enforced on a resume without budget flags; (c) elastic: an escalation
    driven as JAX's test drives it drops silo 2 (the latency hook's slow
    silo) for a 2-step cooldown, then it rejoins, under a step deadline;
    barrier == fused over the 3-silo ring; (d) SIGTERM from inside
    ``next_batch``: the checkpoint written, the resumed run == (a)'s
    uninterrupted one; (e) the training CLI's --checkpoint-dir (then a
    resume), --elastic and --silo-epsilon-budget; (f) a narrow checkpoint
    written on the card restored on the CPU, its next step's loss within
    TRAIN_RTOL of the card's. Checkpoints go to a temporary directory
    outside the repo, whose free space is read first."""
    import shutil
    import signal
    import tempfile

    from repro_torch.api import Session
    from repro_torch.checkpoint import checkpointer
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          PrivacyConfig, reduce_for_smoke)
    from repro_torch.core import flatbuf, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.core.noise_correction import NoiseState
    from repro_torch.data.pipeline import FederatedBatcher
    from repro_torch.data.synthetic import ArrayDataset, synthetic_tokens
    from repro_torch.distributed import steps as steps_mod
    from repro_torch.kernels import dispatch
    from repro_torch.models.packing import pack_params
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    t19 = time.perf_counter()
    cut = dataclasses.replace(get_config("qwen2.5-3b"),
                              n_layers=PERSIST_LAYERS)
    narrow = reduce_for_smoke(get_config("qwen2.5-3b"), n_layers=2,
                              d_model=256, n_heads=4, n_kv_heads=2,
                              d_head=64, d_ff=512, vocab_size=4096)
    priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=4)
    priv_b = dataclasses.replace(priv, sync_path="barrier")
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    mesh4 = MeshConfig((4,), ("data",))

    def rows(vocab: int):
        t = synthetic_tokens(64, 64, vocab, seed=19)
        return ArrayDataset(t[:, :-1], t[:, 1:]).split(4)

    rows_cut, rows_narrow = rows(cut.vocab_size), rows(narrow.vocab_size)
    totals: dict = {}
    report: dict = {}

    def run(p, mesh, steps, ckpt=None, cfg=cut, data=rows_cut, device=None,
            sigterm_at=None, hook=None, prime=None, **tk):
        """One Trainer over a fresh session and state: each next_batch
        snapshots the launch counts (zeroed before the fit), and
        ``sigterm_at`` sends SIGTERM from inside that call."""
        sess = Session.from_config(cfg, privacy=p, optimizer=opt, mesh=mesh,
                                   seed=0, device=device)
        fb = FederatedBatcher(data, per_silo_batch=4)
        counts = []

        def next_batch():
            if len(counts) == sigterm_at:
                os.kill(os.getpid(), signal.SIGTERM)
            counts.append(dispatch.launch_counts())
            b = fb.next()
            return {"tokens": torch.as_tensor(b["x"], dtype=torch.long).to(
                sess.device), "labels": torch.as_tensor(
                b["y"], dtype=torch.long).to(sess.device)}

        tr = Trainer(sess.model, sess.run_cfg, TrainerConfig(
            total_steps=steps, checkpoint_dir=None if ckpt is None
            else str(ckpt), keep_checkpoints=1, log_every=0, **tk),
            next_batch, batch_state=fb, silo_latency_hook=hook)
        if prime is not None:
            prime(tr)
        state = sess.init_state()
        ptrs = {k: v.data_ptr() for k, v in state.opt_state.items()
                if isinstance(v, torch.Tensor)}
        old = tr.install_preemption_handler()
        dispatch.reset_launches()
        try:
            state, step = tr.fit(state, prng.PRNGKey(1))
        finally:
            signal.signal(signal.SIGTERM, old)
        counts.append(dispatch.launch_counts())
        for k, v in counts[-1].items():
            if v:
                totals[k] = totals.get(k, 0) + v
        mst = state.opt_state["master"]
        base = mst.untyped_storage().data_ptr()
        kept = all(state.opt_state[k].data_ptr() == ptr
                   for k, ptr in ptrs.items()) and all(
            q.untyped_storage().data_ptr() == base
            for q in state.params.parameters())
        return types.SimpleNamespace(tr=tr, state=state, step=step,
                                     counts=counts, kept=kept, sess=sess)

    def delta(r, i, name):
        """``name``'s launches in the run's step i (counts snapshot at each
        next_batch, and once after the fit)."""
        return r.counts[i + 1].get(name, 0) - r.counts[i].get(name, 0)

    def same(x, y) -> dict:
        a, b = x.state, y.state
        out = {k: torch.equal(a.opt_state[k], b.opt_state[k])
               for k in ("master", "m", "v")}
        out["count"] = a.opt_state["count"] == b.opt_state["count"]
        out["clip_bound"] = torch.equal(a.clip_bound, b.clip_bound)
        na, nb = a.noise_state, b.noise_state
        out["noise_state"] = (na.prev_key == nb.prev_key
                              and na.has_prev == nb.has_prev
                              and np.array_equal(na.prev_active,
                                                 nb.prev_active))
        out["ledger"] = json.dumps(x.tr.accountant.state_dict(),
                                   sort_keys=True) == json.dumps(
            y.tr.accountant.state_dict(), sort_keys=True)
        out["losses"] = [m["loss"] for m in x.tr.metrics_log] == \
            [m["loss"] for m in y.tr.metrics_log]
        return out

    def hold_resumed(ref, resumed, what: str) -> dict:
        eq = same(ref, resumed)
        if not all(eq.values()):
            # first show whether two uninterrupted runs differ the same way
            again = run(priv, None, ref.step)
            check(False, f"{what}: resumed vs uninterrupted {eq}; two "
                         f"uninterrupted runs {same(ref, again)}")
        return eq

    root = Path(tempfile.mkdtemp(prefix="persist_"))
    try:
        # (a) fused tier: resume == uninterrupted
        t0 = time.perf_counter()
        U = run(priv, None, 4)
        layout = U.state.layout
        check(layout.total == PERSIST_P,
              f"phase 19 packed length {layout.total} != {PERSIST_P}")
        per_layer = sum(s // k for s, k in zip(layout.sizes, layout.stacks)
                        if k)
        need = 2 * 16 * layout.n_params + (1 << 30)
        free = shutil.disk_usage(root).free
        report["disk"] = {"dir": str(root), "free_bytes": free,
                          "need_bytes": need}
        log(f"[persist] {root}: {free / 1e9:.1f} GB free, two checkpoints "
            f"need {need / 1e9:.1f} GB")
        check(free >= need,
              f"phase 19: {free / 1e9:.1f} GB free under {root}, but two "
              f"AdamW checkpoints of P = {layout.n_params} need "
              f"{need / 1e9:.1f} GB (set TMPDIR to a larger disk)")
        I1 = run(priv, None, 2, ckpt=root / "a")
        save = I1.tr.checkpoint_log[-1]
        del I1
        torch.cuda.empty_cache()
        I2 = run(priv, None, 4, ckpt=root / "a")
        check(I2.tr.restored_step == 2, f"(a) resumed at "
                                        f"{I2.tr.restored_step}, not 2")
        restore = I2.tr.checkpoint_log[0]
        eq_a = hold_resumed(U, I2, "(a)")
        pad = max(padding_max(layout, I2.state.opt_state[k])
                  for k in ("master", "m", "v"))
        check(I2.kept and pad == 0.0,
              f"(a) after the restore: buffers kept {I2.kept}, padding "
              f"max {pad}")
        n_layers = {n: layout.n_params + (n - PERSIST_LAYERS) * per_layer
                    for n in (PERSIST_LAYERS, 12, 36)}
        report["a"] = {"equal": eq_a, "buffers_kept": I2.kept,
                       "padding_max": pad, "save": save, "restore": restore,
                       "n_params": n_layers,
                       "reckoned": {n: {"bytes": save["bytes"] * p
                                        / layout.n_params,
                                        "save_s": save["s"] * p
                                        / layout.n_params,
                                        "restore_s": restore["s"] * p
                                        / layout.n_params}
                                    for n, p in n_layers.items()},
                       "s": time.perf_counter() - t0}
        log(f"[persist] (a) fused: 2 steps + checkpoint + fresh Trainer + "
            f"2 steps == 4 steps bit for bit {eq_a} | buffers kept, "
            f"padding 0 | checkpoint {save['bytes'] / 1e9:.3f} GB: save "
            f"{save['s']:.2f} s (d2h {save['d2h_s']:.2f}, write "
            f"{save['write_s']:.2f}, hash {save['hash_s']:.2f}), restore "
            f"{restore['s']:.2f} s (read {restore['read_s']:.2f}, hash "
            f"{restore['hash_s']:.2f}, h2d {restore['h2d_s']:.2f}) | "
            f"reckoned at 12 / 36 layers: "
            + " / ".join(f"{r['bytes'] / 1e9:.1f} GB save {r['save_s']:.1f} "
                         f"s restore {r['restore_s']:.1f} s"
                         for n, r in report["a"]["reckoned"].items()
                         if n != PERSIST_LAYERS)
            + f" | {report['a']['s']:.1f} s")
        del I2
        shutil.rmtree(root / "a")
        torch.cuda.empty_cache()

        # (b) the barrier tier with a budget silo 3 spends in step 1
        t0 = time.perf_counter()
        B1 = run(priv_b, mesh4, 2, ckpt=root / "b",
                 silo_budgets={3: PERSIST_BUDGET})
        m = B1.tr.metrics_log
        eps3 = [e["epsilon_per_silo"][3] for e in m]
        eps0 = [e["epsilon_per_silo"][0] for e in m]
        step2 = delta(B1, 1, "clip_mask")
        check([e["n_contributions"] for e in m] == [4.0, 3.0]
              and delta(B1, 0, "clip_mask") == 4 and step2 == 3
              and eps3[1] == eps3[0] and eps0[1] > eps0[0]
              and B1.tr.membership.excluded == (3,),
              f"(b) contributions {[e['n_contributions'] for e in m]}, "
              f"clip_mask {B1.counts}, silo 3 eps {eps3}, excluded "
              f"{B1.tr.membership.excluded}")
        del B1
        torch.cuda.empty_cache()
        B2 = run(priv_b, mesh4, 3, ckpt=root / "b")  # no budget flags
        check(B2.tr.restored_step == 2
              and B2.tr.accountant.budget_for(3) == PERSIST_BUDGET
              and B2.tr.membership.excluded == (3,)
              and B2.tr.metrics_log[-1]["n_contributions"] == 3.0
              and delta(B2, 0, "clip_mask") == 3,
              f"(b) resumed without budget flags: step "
              f"{B2.tr.restored_step}, budget "
              f"{B2.tr.accountant.budget_for(3)}, excluded "
              f"{B2.tr.membership.excluded}, launches {B2.counts}")
        report["b"] = {"contributions": [e["n_contributions"] for e in
                                         B2.tr.metrics_log],
                       "silo3_eps": eps3, "clip_mask_step2": step2,
                       "s": time.perf_counter() - t0}
        log(f"[persist] (b) barrier, budget {PERSIST_BUDGET} for silo 3: "
            f"contributions {report['b']['contributions']}, clip_mask 4 / 3 "
            f"/ 3 a step, silo 3 eps {eps3[0]:.4f} -> {eps3[1]:.4f}, kept "
            f"out after a resume without budget flags | "
            f"{report['b']['s']:.1f} s")
        del B2
        shutil.rmtree(root / "b")
        torch.cuda.empty_cache()

        # (c) elastic: an escalation drops silo 2 for 2 steps
        t0 = time.perf_counter()
        slow = [0.1, 0.1, 0.7, 0.1]

        def escalate(tr):
            tr.telemetry.observe_all(slow)  # the hook's first feed
            for _ in range(tr.straggler.escalate_after):
                tr.straggler.observe(1e9)

        E = run(priv_b, mesh4, 3, elastic=True, elastic_cooldown=2,
                step_deadline_s=600.0, hook=lambda step: slow,
                prime=escalate)
        ev = [(e["action"], e["silo"], e["step"])
              for e in E.tr.membership.events]
        contrib = [e["n_contributions"] for e in E.tr.metrics_log]
        check(ev == [("drop", 2, 0), ("rejoin", 2, 2)]
              and contrib == [3.0, 3.0, 4.0]
              and [delta(E, i, "clip_mask") for i in range(3)] == [3, 3, 4],
              f"(c) membership {ev}, contributions {contrib}, launches "
              f"{E.counts}")
        del E
        torch.cuda.empty_cache()
        bsess = Session.from_config(cut, privacy=priv_b, optimizer=opt,
                                    mesh=mesh4, seed=0)
        params = bsess.init_params()
        lay, _ = pack_params(params)
        fb = FederatedBatcher(rows_cut, per_silo_batch=4)
        b = fb.next()
        batch = {"tokens": torch.as_tensor(b["x"], dtype=torch.long).to(dev),
                 "labels": torch.as_tensor(b["y"], dtype=torch.long).to(dev)}
        keys = step_keys(prng.PRNGKey(1), 0)
        primed = NoiseState(step_keys(prng.PRNGKey(4), 0).key_xi, True,
                            np.ones(4, bool))
        c0 = torch.tensor(1.0, dtype=torch.float32, device=dev)
        active = np.array([True, True, False, True])
        args = (keys, primed, c0, keys.key_clip, lay)
        f_agg, f_loss, _, _, f_bound = steps_mod._fused_grads(
            bsess.model, priv, params, batch, 4, *args,
            steps_mod.StageTimer(dev), active=active)
        flatbuf.zero_padding(lay, f_agg)
        b_agg, b_loss, _, _, b_bound = steps_mod._barrier_grads(
            bsess.model, priv_b, mesh4, params, batch, *args,
            steps_mod.StageTimer(dev), active=active)
        flatbuf.zero_padding(lay, b_agg)
        B = priv.mask_scale * priv.sigma * float(b_bound)
        err = chunked_max_diff(b_agg, f_agg)
        check(err <= MASK_ATOL_PER_B * B
              and math.isclose(float(b_loss), float(f_loss),
                               rel_tol=TRAIN_RTOL),
              f"(c) barrier vs fused over silos 0, 1, 3: aggregate differs "
              f"by {err} (tolerance {MASK_ATOL_PER_B * B}), loss "
              f"{float(b_loss)} / {float(f_loss)}")
        report["c"] = {"events": ev, "contributions": contrib,
                       "aggregate_max_abs_err": err,
                       "tolerance": MASK_ATOL_PER_B * B,
                       "s": time.perf_counter() - t0}
        log(f"[persist] (c) elastic: escalation drops silo 2 at step 0, "
            f"rejoins at 2 {ev}, contributions {contrib} | barrier vs fused "
            f"over silos 0, 1, 3 (primed noise state, silo 2 in at t-1): "
            f"max |diff| {err:.3g} (<= {MASK_ATOL_PER_B * B:.3g}) | "
            f"{report['c']['s']:.1f} s")
        del bsess, params, f_agg, b_agg, batch
        torch.cuda.empty_cache()

        # (d) SIGTERM from inside next_batch
        t0 = time.perf_counter()
        D1 = run(priv, None, 4, ckpt=root / "d", sigterm_at=2)
        check(D1.step == 3
              and checkpointer.latest_step(root / "d") == 3,
              f"(d) SIGTERM: returned at {D1.step}, latest checkpoint "
              f"{checkpointer.latest_step(root / 'd')}")
        del D1
        torch.cuda.empty_cache()
        D2 = run(priv, None, 4, ckpt=root / "d")
        check(D2.tr.restored_step == 3, f"(d) resumed at "
                                        f"{D2.tr.restored_step}")
        eq_d = hold_resumed(U, D2, "(d)")
        report["d"] = {"equal": eq_d, "s": time.perf_counter() - t0}
        log(f"[persist] (d) SIGTERM in step 2's next_batch: saved at step 3,"
            f" resumed == uninterrupted bit for bit {eq_d} | "
            f"{report['d']['s']:.1f} s")
        del D2, U
        shutil.rmtree(root / "d")
        torch.cuda.empty_cache()

        # (e) the training CLI
        t0 = time.perf_counter()
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        base = [sys.executable, "-m", "repro_torch.launch.train"]
        ck = ["--checkpoint-dir", str(root / "e")]
        report["e"] = []
        for flags, want in ((ck + ["--steps", "2"], ["done at step 2"]),
                            (ck + ["--steps", "3"],
                             [f"resumed from {root / 'e'} at step 2",
                              "done at step 3"]),
                            (["--elastic", "--silo-epsilon-budget", "1000",
                              "--steps", "2"], ["done at step 2"])):
            t1 = time.perf_counter()
            r = subprocess.run(base + flags, cwd=ROOT, capture_output=True,
                               text=True, timeout=600, env=env)
            check(r.returncode == 0 and all(w in r.stdout for w in want),
                  f"training CLI {flags} failed ({r.returncode}):\n"
                  f"{r.stdout}\n{r.stderr}")
            done = next(x for x in r.stdout.splitlines()
                        if x.startswith("done"))
            report["e"].append({"flags": " ".join(flags),
                                "s": time.perf_counter() - t1, "last": done})
            log(f"[persist] (e) {' '.join(flags)}: exit 0 in "
                f"{time.perf_counter() - t1:.1f} s | {done}")

        # (f) a checkpoint written on the card, restored on the CPU
        t0 = time.perf_counter()
        run(priv, None, 2, ckpt=root / "f", cfg=narrow, data=rows_narrow)
        shutil.copytree(root / "f", root / "f_cpu")
        Fg = run(priv, None, 3, ckpt=root / "f", cfg=narrow,
                 data=rows_narrow)
        Fc = run(priv, None, 3, ckpt=root / "f_cpu", cfg=narrow,
                 data=rows_narrow, device="cpu")
        lg, lc = Fg.tr.metrics_log[-1]["loss"], Fc.tr.metrics_log[-1]["loss"]
        check(Fg.tr.restored_step == Fc.tr.restored_step == 2
              and not any(Fc.counts[-1].values())
              and math.isclose(lg, lc, rel_tol=TRAIN_RTOL),
              f"(f) card checkpoint on the CPU: resumed at "
              f"{Fg.tr.restored_step} / {Fc.tr.restored_step}, step-2 loss "
              f"{lg} / {lc}, CPU launches {Fc.counts[-1]}")
        report["f"] = {"loss": [lg, lc], "s": time.perf_counter() - t0}
        log(f"[persist] (f) narrow checkpoint from the card restored on the "
            f"CPU: step-2 loss {lg:.6f} (card) / {lc:.6f} (CPU), within "
            f"{TRAIN_RTOL} | {report['f']['s']:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["launches"] = totals
    report["phase_s"] = time.perf_counter() - t19
    log(f"[persist] phase 19 in {report['phase_s']:.1f} s, launches "
        f"{json.dumps(totals)}")
    return report


# --------------------------------------------------------------- phase 20
# the paper's CIFAR models at their published configs, with
# barrier_overhead.py's barrier settings and sota_comparison.py's optimizer:
# 4 silos, sigma 0.5, C 1, dynamic clipping, lambda 0.7, momentum at lr 0.1,
# seed 0; CNN6 at batch 256 (64 a silo), WRN28 at 64 (16 a silo)
CIFAR_BATCH = {"cifar10-cnn6": 256, "cifar10-wrn28": 64}
# their packed lengths (307,498 and 5,849,050 parameters; 14 and 80 leaves)
CIFAR_P = {"cifar10-cnn6": 308_224, "cifar10-wrn28": 5_851_136}
CIFAR_STEPS, CIFAR_WIRE_ROUNDS, CIFAR_LR = 3, 5, 0.1
# per-example clipping of WRN28: 16 examples, one silo's share
CIFAR_PE = 16
# card vs CPU, one fused step (sigma 0): every silo's norm (relative) and
# the clipped aggregate (its relative L2 difference). The narrow WRN, fp32
# sums in other orders: measured 7e-8 and 9e-7. CNN6 at batch 256 adds
# max-pool windows whose two largest values sit within rounding of each
# other: the card and the CPU send such a window's gradient to different
# elements, and one such term in a weight gradient summed over 65,536
# positions moves it by about 1/256 (measured 5.3e-5 and 5.6e-4, the same
# every run: the inputs are seeded and both devices deterministic). TF32
# convolutions, 10 mantissa bits in every product, measured 4.5e-4 and
# 1.7e-2 (CNN6), 9.2e-4 and 3.8e-3 (WRN): past both gates
CIFAR_CARD_TOL = {
    "cifar10-cnn6": {"norms_rel": 2e-4, "aggregate_l2_rel": 2e-3},
    "wrn10x1": {"norms_rel": 1e-5, "aggregate_l2_rel": 1e-5},
}


def wrn_shapes(depth: int = 28, widen: int = 4) -> dict:
    """WRN's leaf paths and shapes (``repro/models/small.py:93-138``),
    computed here so that a tree without the CIFAR models can be timed on
    WRN28's layout (``--prng``)."""
    n = (depth - 4) // 6
    widths = [16, 16 * widen, 32 * widen, 64 * widen]
    out, cin = {"stem": (3, 3, 3, 16)}, 16
    for g in range(3):
        for b in range(n):
            c = widths[g + 1]
            p = f"g{g}b{b}"
            out.update({f"{p}.gn1.s": (cin,), f"{p}.gn1.b": (cin,),
                        f"{p}.conv1": (3, 3, cin, c), f"{p}.gn2.s": (c,),
                        f"{p}.gn2.b": (c,), f"{p}.conv2": (3, 3, c, c)})
            if cin != c:
                out[f"{p}.proj"] = (1, 1, cin, c)
            cin = c
    out.update({"gn_f.s": (cin,), "gn_f.b": (cin,), "fc.w": (cin, 10),
                "fc.b": (10,)})
    return out


def prng_phase(dev) -> dict:
    """``--prng``: the scan tier's noise stage on WRN28's layout (80 leaves,
    5,849,050 parameters), as ``_fused_grads_scan`` runs it: the per-leaf
    policy's ``corrected_noise_tree`` (xi_t and lambda xi_{t-1} of 4 silos,
    one silo out at t-1) added into a zero accumulator, timed with CUDA
    events over 5 calls after one warm call, the kernels the warm call
    launched (``normal_combine`` once a leaf on a tree with the normal
    kernels, none before), and the result's sha256: two trees' draws are
    bit-equal when their hashes are. Any tree with the scan tier and the
    per-leaf policy (no CIFAR model needed)."""
    import hashlib

    from repro_torch.configs.base import PrivacyConfig
    from repro_torch.core import flatbuf, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.core.dp_pipeline import DPPipeline
    from repro_torch.core.noise_correction import NoiseState

    shapes = wrn_shapes()
    paths = sorted(shapes, key=lambda p: tuple(p.split(".")))
    layout = flatbuf.build_layout(paths, [shapes[p] for p in paths],
                                  [0] * len(paths))
    check(layout.total == CIFAR_P["cifar10-wrn28"],
          f"WRN28 layout {layout.total}")
    priv = PrivacyConfig(enabled=True, sigma=0.5, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=4,
                         silo_mode="scan")
    pipe = DPPipeline(priv, layout, 4, policy="perleaf")
    keys = step_keys(prng.PRNGKey(1), 1)
    ns = NoiseState(step_keys(prng.PRNGKey(1), 0).key_xi, True,
                    np.array([True, True, False, True]))
    bound = torch.full((), 1.7, dtype=torch.float32, device=dev)
    acc = torch.zeros(layout.total, dtype=torch.float32, device=dev)

    def once():
        acc.zero_()
        pipe.corrected_noise_tree(flatbuf.unpack(layout, acc), keys, ns,
                                  bound, None)

    from repro_torch.kernels import dispatch
    dispatch.reset_launches()
    once()
    launches = {k: v for k, v in dispatch.launch_counts().items() if v}
    torch.cuda.synchronize()
    digest = hashlib.sha256(acc.cpu().numpy().tobytes()).hexdigest()
    ms = []
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        once()
        t1.record()
        t1.synchronize()
        ms.append(t0.elapsed_time(t1))
    rec = {"at": f"WRN28 layout, {layout.n_leaves} leaves, P "
                 f"{layout.total}, 2 streams x 4 silos, one out at t-1",
           "noise_ms": ms, "median_ms": float(np.median(ms)),
           "sha256": digest, "launches": launches}
    log(f"[prng] scan-tier noise stage on WRN28: median "
        f"{rec['median_ms']:.2f} ms ({', '.join(f'{x:.2f}' for x in ms)}) "
        f"| sha256 {digest[:16]} | launches a stage {json.dumps(launches)}")
    return rec


def wrn_noise_stage(dev) -> dict:
    """:func:`prng_phase` on this tree: ``normal_combine`` once a leaf (80)
    and no other kernel, no plain draw on the card."""
    spy: dict = {}
    with plain_draw_spy(spy):
        rec = prng_phase(dev)
    check(spy["plain_draws_on_card"] == 0
          and rec["launches"] == {"normal_combine": 80},
          f"WRN28's noise stage: launches {rec['launches']}, "
          f"{spy['plain_draws_on_card']} plain draws on the card")
    return {**rec, **spy}


def cifar_setup(cfg, dev):
    """``(SmallModel, Model)``: the small model as the training path takes
    it, ``Model(cfg=None, ...)`` as the JAX package's tests build it."""
    from repro_torch.models.registry import Model
    from repro_torch.models.small import build_small_model
    sm = build_small_model(cfg)
    return sm, Model(cfg=None, device=dev, init=sm.init, loss=sm.loss,
                     init_cache=None, prefill=None, decode_step=None)


@contextlib.contextmanager
def conv_route(route: str):
    """The small models' convolutions for a block: ``exact`` as the port
    runs them (fp32, deterministic cuDNN algorithms), ``plain`` as
    ``F.conv2d`` under cuDNN's default algorithms without TF32, ``tf32``
    as ``F.conv2d`` under cuDNN's defaults (TF32 on). The last two are
    yardsticks: what determinism costs, and what the card-vs-CPU gate
    must catch."""
    import torch.nn.functional as F

    from repro_torch.models import small
    if route == "exact":
        yield
        return
    exact = small._conv2d
    small._conv2d = lambda x, w, st, pd: F.conv2d(x, w, stride=st, padding=pd)
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=route == "tf32"):
            yield
    finally:
        small._conv2d = exact


def cifar_kernel_rows(dev, sass) -> dict:
    """Rows 5-10 at the CIFAR shapes: ``clip_accumulate``, ``noise_batch``,
    ``clip_mask`` and one ``zsmask`` pass at each model's P (4 silos), and
    ``per_example_sumsq`` (every leaf) and ``clip_sum`` at WRN28's (16, P);
    each held to its plain version as phase 6 holds it, timed as a call and
    on the card (a CUDA graph of 20 calls)."""
    from repro_torch.configs.paper_models import CIFAR10_CNN6, CIFAR10_WRN28
    from repro_torch.core import flatbuf, masking, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.kernels.dp_clip import ref as clip_ref
    from repro_torch.kernels.dp_fused import ops as noise_ops
    from repro_torch.kernels.dp_fused import ref as noise_ref
    from repro_torch.kernels.zsmask import ops as zs_ops
    from repro_torch.kernels.zsmask import ref as zs_ref

    rows: dict = {k: {} for k in ("clip_accumulate", "noise_batch",
                                  "clip_mask", "zsmask", "per_example_sumsq",
                                  "clip_sum")}
    per_nb = live_stream_ops(sass, "noise_batch_kernel")
    per_zs = live_stream_ops(sass, "zsmask_kernel")
    keys, prev = step_keys(prng.PRNGKey(1), 0), \
        step_keys(prng.PRNGKey(1), 1).key_xi
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=dev)
    for cfg, sub in ((CIFAR10_CNN6, "cnn6"), (CIFAR10_WRN28, "wrn28")):
        sm, _ = cifar_setup(cfg, dev)
        layout = flatbuf.layout_of(sm.init(torch.Generator().manual_seed(0)))
        P = layout.total
        check(P == CIFAR_P[cfg.name], f"{cfg.name}: P {P}")
        gen = torch.Generator(device=dev).manual_seed(20)
        r, g_sum, stacked = check_clip_accumulate(dev, gen, 4, P, clip_ops,
                                                  clip_ref)
        scale = torch.tensor([0.731, 1.0, 0.0, 0.418], device=dev)
        r["device_ms"] = graph_ms(lambda: clip_ops.clip_accumulate(
            stacked, scale), n=20, reps=5)
        rows["clip_accumulate"][sub] = r
        del stacked
        r = check_noise_batch(dev, 4, P, g_sum, noise_ops, noise_ref,
                              step_keys, prng.PRNGKey, per_nb)
        sc = torch.tensor([0.075, 0.075, 0.0, 0.075], device=dev)
        lam = torch.tensor([0.7, 0.0, 0.0, 0.7], device=dev)
        r["device_ms"] = graph_ms(lambda: noise_ops.noise_batch(
            g_sum, keys.key_xi, prev, sc, lam, 0.075), n=20, reps=5)
        rows["noise_batch"][sub] = r
        rows["clip_mask"][sub] = check_clip_mask(dev, P, g_sum, noise_ops,
                                                 noise_ref, keys, prev,
                                                 CLIP_MASK_OPS)
        r = check_zsmask(dev, layout, g_sum, zs_ops, zs_ref,
                         masking.fold_leaf, (masking.R_FOLD,
                                             masking.XI_FOLD), keys, per_zs)
        slices = leaf_slices(layout)
        kr = [masking.fold_leaf(keys.key_r, masking.R_FOLD, i)
              for i in range(layout.n_leaves)]
        kx = [masking.fold_leaf(keys.key_xi, masking.XI_FOLD, i)
              for i in range(layout.n_leaves)]
        out = torch.empty_like(g_sum)
        sc4, b4 = f32(0.3) * f32(4.0), f32(8.0) * f32(0.3) * f32(4.0)

        def one_pass():
            for i, o, a, m in slices:
                zs_ops.apply_zsmask(g_sum[a:a + m], kr[i], kx[i], 1, 4, sc4,
                                    b4, offset=o, out=out[a:a + m])

        r["device_ms"] = graph_ms(one_pass, n=4, reps=5)
        rows["zsmask"][sub] = r
        del g_sum, out
        if sub == "wrn28":
            # per-example clipping's (16, P) buffer: 16 examples of WRN28
            pe = torch.randn(CIFAR_PE, P, device=dev, generator=gen)
            r = check_sumsq(pe, layout, clip_ops, clip_ref)
            cols = leaf_columns(pe, layout)
            r["device_ms"] = graph_ms(lambda: [clip_ops.sumsq(c)
                                               for c in cols], n=2, reps=5)
            r["at"] = (f"B={CIFAR_PE}, the {len(cols)} leaves of WRN28 "
                       f"({layout.n_params} columns), rows P apart, fp32")
            rows["per_example_sumsq"]["pe16"] = r
            r = check_clip_sum(dev, pe, noise_ops, noise_ref, clip_ref, P)
            c = torch.ones((), device=dev)
            r["device_ms"] = graph_ms(lambda: noise_ops.clip_sum_packed(
                pe, c), n=10, reps=5)
            rows["clip_sum"]["pe16"] = r
            del pe
        torch.cuda.empty_cache()
    for name, subs in rows.items():
        for sub, r in subs.items():
            lib = "n/a" if r["library_ms"] is None \
                else f"{r['library_ms']:.4f} ms"
            log(f"[cifar-kernel] {name} {sub}: max_abs_err "
                f"{r['max_abs_err']} | call {r['ms']:.4f} ms | card "
                f"{r['device_ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | "
                f"library {lib} | bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}) | {r['at']}")
    return rows


def cifar_batcher(cfg, dev, seed: int = 20):
    """A ``FederatedBatcher`` over synthetic CIFAR-10 (4 silos of 256), the
    model's batch a step; ``next_batch`` moves it to the card."""
    from repro_torch.data.pipeline import FederatedBatcher
    from repro_torch.data.synthetic import synthetic_cifar10
    train, _ = synthetic_cifar10(n_train=1024, n_test=16, seed=seed)
    fb = FederatedBatcher(train.split(4),
                          per_silo_batch=CIFAR_BATCH[cfg.name] // 4)

    def next_batch():
        b = fb.next()
        return {"x": torch.as_tensor(b["x"]).to(dev),
                "y": torch.as_tensor(b["y"]).to(dev)}
    return fb, next_batch


def cifar_trainer(cfg, dev, priv, mesh_n, steps, ckpt=None, perleaf=False,
                  route="exact"):
    """One Trainer on ``cfg`` from random weights (seed 0), its launches
    zeroed just before the fit and no plain per-leaf draw on the card in
    it, the convolutions on ``route`` (:func:`conv_route`): ``(trainer,
    state, step, launches)``."""
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          RunConfig)
    from repro_torch.core import prng
    from repro_torch.distributed import steps as steps_mod
    from repro_torch.kernels import dispatch
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    sm, model = cifar_setup(cfg, dev)
    rc = RunConfig(model=None, mesh=MeshConfig((mesh_n,), ("data",)),
                   privacy=priv, optimizer=OptimizerConfig(name="momentum",
                                                           lr=CIFAR_LR))
    fb, next_batch = cifar_batcher(cfg, dev)
    tr = Trainer(model, rc, TrainerConfig(
        total_steps=steps, log_every=0, checkpoint_dir=None if ckpt is None
        else str(ckpt), checkpoint_every=2, keep_checkpoints=1),
        next_batch, batch_state=fb)
    state = steps_mod.init_train_state(
        model, rc, prng.PRNGKey(0),
        gen=torch.Generator(device=dev).manual_seed(0))
    ctx = dispatch.force_impl("perleaf", kernel="dp_noise_tree") if perleaf \
        else contextlib.nullcontext()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spy: dict = {}
    dispatch.reset_launches()
    with ctx, conv_route(route), plain_draw_spy(spy):
        state, step = tr.fit(state, prng.PRNGKey(1))
    n = {k: v for k, v in dispatch.launch_counts().items() if v}
    check(spy["plain_draws_on_card"] == 0, f"{cfg.name}: "
          f"{spy['plain_draws_on_card']} plain draws on the card")
    return tr, state, step, n


def cifar_tiers(dev) -> dict:
    """(a) 3 steps of each model on each tier through the Trainer: fused,
    barrier on a (4,) mesh, barrier under the perleaf policy, and the scan
    tier; the launches of rows 5, 8, 9, 10 (its tree kernel) and 18 per
    step as each tier
    makes them, losses finite, epsilon rising; step ms after the first, the
    stage split, peak memory. Then the masks cancel: one step's
    ``_barrier_grads`` == ``_fused_grads`` from one set of weights and one
    batch within MASK_ATOL_PER_B units of B."""
    from repro_torch.configs.base import MeshConfig, PrivacyConfig
    from repro_torch.configs.paper_models import CIFAR10_CNN6, CIFAR10_WRN28
    from repro_torch.core import flatbuf, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.core.noise_correction import init_state as init_noise
    from repro_torch.distributed import steps as steps_mod
    from repro_torch.kernels import dispatch
    from repro_torch.models.packing import pack_params

    priv = PrivacyConfig(enabled=True, sigma=0.5, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=4)
    out: dict = {}
    for cfg in (CIFAR10_CNN6, CIFAR10_WRN28):
        n_leaves = 14 if cfg is CIFAR10_CNN6 else 80
        tiers = {
            "fused": (priv, 1, False,
                      {"clip_accumulate": 1, "noise_batch": 1}),
            "barrier": (dataclasses.replace(priv, sync_path="barrier"), 4,
                        False, {"clip_mask": 4}),
            "perleaf": (dataclasses.replace(priv, sync_path="barrier"), 4,
                        True, {"zsmask_buffer": 4}),
            "scan": (dataclasses.replace(priv, silo_mode="scan"), 1, False,
                     {"normal_combine": n_leaves}),
        }
        rec: dict = {}
        for tier, (p, mesh_n, perleaf, want) in tiers.items():
            tr, state, step, n = cifar_trainer(cfg, dev, p, mesh_n,
                                               CIFAR_STEPS, perleaf=perleaf)
            variants = dispatch.variant_counts()  # of the same run
            peak = torch.cuda.max_memory_allocated()
            want = {k: v * CIFAR_STEPS for k, v in want.items()}
            losses = [m["loss"] for m in tr.metrics_log]
            eps = [m["epsilon"] for m in tr.metrics_log]
            check(step == CIFAR_STEPS and all(map(math.isfinite, losses)),
                  f"cifar {cfg.name} {tier}: {step} steps, loss {losses}")
            check(all(b > a for a, b in zip([0.0] + eps, eps)),
                  f"cifar {cfg.name} {tier}: epsilon {eps}")
            check(n == want, f"cifar {cfg.name} {tier}: launches {n}, "
                             f"expected {want}")
            if perleaf:  # lambda 0.7: the corrected instantiation only
                check(variants["zsmask_buffer"] == {
                    "plain": 0, "prev": want["zsmask_buffer"], "bf16": 0,
                    "bf16_prev": 0},
                      f"cifar {cfg.name} perleaf: zsmask_buffer "
                      f"instantiations {variants['zsmask_buffer']}")
            step_ms = [m["step_time_s"] * 1e3 for m in tr.metrics_log]
            stages = {k: [st.get(k, 0.0) for st in tr.stage_log]
                      for k in tr.stage_log[0]}
            rec[tier] = {"loss": losses, "epsilon": eps, "step_ms": step_ms,
                         "step_ms_after_first": step_ms[1:],
                         "stage_ms": stages, "peak_mem_gb": peak / 1e9,
                         "launches": n,
                         "launches_by_instantiation": variants,
                         "clip_bound": [m["clip_bound"]
                                        for m in tr.metrics_log]}
            log(f"[cifar] {cfg.name} {tier}: {CIFAR_STEPS} steps of "
                f"{CIFAR_BATCH[cfg.name]} over 4 silos | loss "
                f"{[round(x, 4) for x in losses]} | step ms after the first "
                f"{[round(t, 2) for t in step_ms[1:]]} | peak "
                f"{peak / 1e9:.3f} GB | launches {n}")
            log(f"[cifar] {cfg.name} {tier} stage ms: " + " | ".join(
                f"{k} {[round(t, 3) for t in v]}" for k, v in stages.items()))
            if tier == "fused":
                fused_master = state.opt_state["master"].clone()
            del tr, state
        # what deterministic convolutions cost: the fused cell again, warm,
        # on cuDNN's default fp32 algorithms (twice: are they run-to-run
        # identical?) and on the port's, which must repeat the first fused
        # run bit for bit
        cost, masters = {}, {}
        for i, route in enumerate(("plain", "exact", "plain")):
            tr, state, _, _ = cifar_trainer(cfg, dev, priv, 1, CIFAR_STEPS,
                                            route=route)
            masters[i] = state.opt_state["master"].clone()
            cost.setdefault(route, {
                "step_ms_after_first": [m["step_time_s"] * 1e3
                                        for m in tr.metrics_log][1:],
                "silo_grads_ms": [st["silo_grads"] for st in tr.stage_log]})
            del tr, state
        cost["plain"]["bit_equal_across_runs"] = torch.equal(masters[0],
                                                             masters[2])
        check(torch.equal(masters[1], fused_master),
              f"cifar {cfg.name}: two fused runs on deterministic "
              f"convolutions differ")
        rec["deterministic_convs_cost"] = cost
        log(f"[cifar] {cfg.name} fused, warm: step ms after the first / "
            f"silo_grads ms, cuDNN's default fp32 algorithms "
            f"{[round(t, 2) for t in cost['plain']['step_ms_after_first']]}"
            f" / {[round(t, 2) for t in cost['plain']['silo_grads_ms']]} "
            f"(two runs bit-equal: {cost['plain']['bit_equal_across_runs']})"
            f", deterministic "
            f"{[round(t, 2) for t in cost['exact']['step_ms_after_first']]}"
            f" / {[round(t, 2) for t in cost['exact']['silo_grads_ms']]} "
            f"(bit-equal to the first fused run)")
        del masters, fused_master
        # the masks cancel: barrier == fused on one step's inputs
        sm, model = cifar_setup(cfg, dev)
        params = sm.init(torch.Generator(device=dev).manual_seed(0))
        layout, _ = pack_params(params)
        _, next_batch = cifar_batcher(cfg, dev)
        batch = next_batch()
        keys = step_keys(prng.PRNGKey(1), 0)
        ns = init_noise(prng.fold_in(prng.PRNGKey(0), 0xD0), 4)
        c0 = torch.full((), 1.0, dtype=torch.float32, device=dev)
        args = (batch, keys, ns, c0, keys.key_clip, layout,
                steps_mod.StageTimer(dev))
        f_agg, f_loss, _, _, f_bound = steps_mod._fused_grads(
            model, priv, params, batch, 4, *args[1:])
        b_agg, b_loss, _, _, b_bound = steps_mod._barrier_grads(
            model, dataclasses.replace(priv, sync_path="barrier"),
            MeshConfig((4,), ("data",)), params, *args)
        flatbuf.zero_padding(layout, f_agg)
        flatbuf.zero_padding(layout, b_agg)
        B = priv.mask_scale * priv.sigma * float(b_bound)
        err = (b_agg - f_agg).abs().max().item()
        tol = MASK_ATOL_PER_B * B
        check(err <= tol and math.isclose(float(b_loss), float(f_loss),
                                          rel_tol=TRAIN_RTOL)
              and math.isclose(float(b_bound), float(f_bound),
                               rel_tol=TRAIN_RTOL),
              f"cifar {cfg.name} barrier vs fused: aggregate {err} (tol "
              f"{tol}), loss {float(b_loss)} / {float(f_loss)}, bound "
              f"{float(b_bound)} / {float(f_bound)}")
        rec["barrier_vs_fused"] = {"aggregate_max_abs_err": err,
                                   "tolerance": tol, "B": B,
                                   "bound": float(b_bound)}
        log(f"[cifar] {cfg.name} barrier vs fused, one step: aggregate max "
            f"|diff| {err:.3g} (tolerance {tol:.3g}, B {B:.4f}) | loss and "
            f"bound within {TRAIN_RTOL}")
        out[cfg.name] = rec
        del params, f_agg, b_agg
        torch.cuda.empty_cache()
    return out


def cifar_convergence(dev) -> dict:
    """(b) CNN6 falls over 20 fused steps on synthetic_cifar10(256, 128),
    as JAX's ``test_cnn6_trains_under_barrier`` (batch 32, sigma 0.02,
    momentum lr 0.1)."""
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          PrivacyConfig, RunConfig)
    from repro_torch.configs.paper_models import CIFAR10_CNN6
    from repro_torch.core import prng
    from repro_torch.data.synthetic import synthetic_cifar10
    from repro_torch.distributed import steps as steps_mod

    sm, model = cifar_setup(CIFAR10_CNN6, dev)
    rc = RunConfig(model=None, mesh=MeshConfig((1,), ("data",)),
                   privacy=PrivacyConfig(enabled=True, sigma=0.02,
                                         clip_bound=1.0, n_silos=4),
                   optimizer=OptimizerConfig(name="momentum", lr=CIFAR_LR))
    train, _ = synthetic_cifar10(n_train=256, n_test=128)
    state = steps_mod.init_train_state(
        model, rc, prng.PRNGKey(0),
        gen=torch.Generator(device=dev).manual_seed(0))
    step = steps_mod.build_train_step(model, rc)
    losses = []
    for i in range(20):
        idx = np.random.default_rng(i).integers(0, 256, 32)
        b = {"x": torch.as_tensor(train.x[idx]).to(dev),
             "y": torch.as_tensor(train.y[idx]).to(dev)}
        state, m = step(state, b, prng.PRNGKey(5),
                        timer=steps_mod.StageTimer(dev))
        losses.append(float(m["loss"]))
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"cifar CNN6 does not train: {losses[0]} -> {losses[-1]}")
    log(f"[cifar] CNN6, 20 fused steps of 32 (sigma 0.02): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"loss": losses}


def cifar_per_example(dev) -> dict:
    """(c) per-example clipping of WRN28 over 16 examples (a batch of one
    a forward), packed (``clip_sum`` once) and perleaf
    (``per_example_sumsq_tree`` and ``clip_accumulate`` once each): the
    two routes within ROUTES_RTOL; times and peak memory."""
    from repro_torch.configs.paper_models import CIFAR10_WRN28
    from repro_torch.core import clipping, flatbuf
    from repro_torch.kernels import dispatch

    sm, _ = cifar_setup(CIFAR10_WRN28, dev)
    params = sm.init(torch.Generator(device=dev).manual_seed(0))
    _, next_batch = cifar_batcher(CIFAR10_WRN28, dev)
    batch = {k: v[:CIFAR_PE] for k, v in next_batch().items()}
    res, rec = {}, {}
    for impl, want in (("packed", {"clip_sum": 1}),
                       ("perleaf", {"per_example_sumsq_tree": 1,
                                    "clip_accumulate": 1})):
        dispatch.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        (s, norms, loss), sec = timed(lambda: clipping.per_example_clipped_grad(
            sm.loss, params, batch, 1.0, impl=impl))
        n = {k: v for k, v in dispatch.launch_counts().items() if v}
        check(n == want, f"cifar per-example {impl}: launches {n}")
        res[impl] = (flatbuf.pack(flatbuf.layout_of(s), s), norms)
        rec[impl] = {"s": sec, "launches": n, "loss": float(loss),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    (a, na), (b, nb) = res["packed"], res["perleaf"]
    rel = max_rel(na, nb)
    err = (a - b).abs().max().item()
    top = b.abs().max().item()
    check(rel <= ROUTES_RTOL and err <= ROUTES_RTOL * top,
          f"cifar per-example routes differ: norms {rel}, sum {err} of {top}")
    rec["routes"] = {"norms_max_rel": rel, "sum_max_abs": err,
                     "largest": top}
    log(f"[cifar] WRN28 per-example clipping of {CIFAR_PE} examples: packed "
        f"{rec['packed']['s'] * 1e3:.1f} ms, perleaf "
        f"{rec['perleaf']['s'] * 1e3:.1f} ms; routes agree (norms {rel:.2e} "
        f"rel, sum {err:.2e} of {top:.3g}) | peak "
        f"{rec['packed']['peak_mem_gb']:.2f} / "
        f"{rec['perleaf']['peak_mem_gb']:.2f} GB")
    return rec


def cifar_wire(dev) -> dict:
    """(d) 5 rounds each of serial, pipelined and speculative
    ``CollaborativeSession`` rounds of CNN6 and WRN28 (4 silos of 64 and of
    16 examples, sigma 0.5, C 1, lambda 0.7, lr 0.1) from the same weights:
    bit-equal; ``clip_mask`` once a silo a round (speculative:
    ``clip_mask_ext`` once, ``noise_stream`` on each miss and prefetch);
    the median round, each party's share and the card's busy share of 2
    serial rounds (``torch.profiler``)."""
    from repro_torch.api import CollaborativeSession
    from repro_torch.configs.base import PrivacyConfig
    from repro_torch.configs.paper_models import CIFAR10_CNN6, CIFAR10_WRN28
    from repro_torch.core import flatbuf
    from repro_torch.core.tee import wire
    from repro_torch.data.synthetic import synthetic_cifar10
    from repro_torch.kernels import dispatch
    from repro_torch.launch.profile_serve import _window
    from repro_torch.models.small import value_and_grad

    wpriv = PrivacyConfig(enabled=True, sigma=0.5, clip_bound=1.0,
                          noise_lambda=WIRE_LAM)
    R = CIFAR_WIRE_ROUNDS
    out: dict = {}
    for cfg in (CIFAR10_CNN6, CIFAR10_WRN28):
        sm, _ = cifar_setup(cfg, dev)
        per = CIFAR_BATCH[cfg.name] // 4
        silos = [{"x": s.x, "y": s.y} for s in synthetic_cifar10(
            n_train=4 * per, n_test=16, seed=21)[0].split(4)]
        init = sm.init(torch.Generator(device=dev).manual_seed(1))
        grad_fn = value_and_grad(sm.loss)
        runs = {}
        for mode in ("serial", "pipelined", "speculative"):
            sess = CollaborativeSession.from_silos(silos, wpriv,
                                                   params_template=init)
            parts = instrument_wire(sess)
            stamps = []

            def upd(p, update, lr, _stamps=stamps):
                res = wire_update(p, update, lr)
                torch.cuda.synchronize()
                _stamps.append(time.perf_counter())
                return res

            params = {k: v.clone() for k, v in init.items()}
            dispatch.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, losses = sess.run(params, parts["grad_fn"](grad_fn), upd,
                                      CIFAR_LR, R,
                                      pipelined=mode != "serial",
                                      speculative=mode == "speculative")
            counts = {k: v for k, v in dispatch.launch_counts().items() if v}
            want = {"clip_mask_ext": 4 * R, "noise_stream": 4 * (R + 1)} \
                if mode == "speculative" else {"clip_mask": 4 * R}
            check(counts == want, f"cifar wire {cfg.name} {mode}: launches "
                                  f"{counts}, expected {want}")
            check(all(map(math.isfinite, losses)),
                  f"cifar wire {cfg.name} {mode}: losses {losses}")
            rounds_ms = np.diff([t0] + stamps) * 1e3
            runs[mode] = {"sess": sess, "losses": losses,
                          "packed": wire.pack_np(flatbuf.layout_of(params),
                                                 params),
                          "round_ms": rounds_ms.tolist(),
                          "median_round_ms": float(np.median(rounds_ms)),
                          "parts": parts["read"](R), "launches": counts}
        a = runs["serial"]
        for mode in ("pipelined", "speculative"):
            b = runs[mode]
            check(np.array_equal(a["packed"].view(np.uint32),
                                 b["packed"].view(np.uint32))
                  and a["losses"] == b["losses"]
                  and a["sess"].wire_stats == b["sess"].wire_stats,
                  f"cifar wire {cfg.name}: {mode} is not bit-equal to "
                  f"serial on the card")
        rec = {mode: {k: v for k, v in r.items()
                      if k not in ("sess", "packed")}
               for mode, r in runs.items()}
        rec["wire_stats"] = a["sess"].wire_stats
        sess = CollaborativeSession.from_silos(silos, wpriv,
                                               params_template=init)
        params, _ = sess.step(0, {k: v.clone() for k, v in init.items()},
                              grad_fn, wire_update, CIFAR_LR)
        prof = _window(lambda: sess.run(params, grad_fn, wire_update,
                                        CIFAR_LR, 2, pipelined=False), 6)
        rec["profile_2_serial_rounds"] = prof
        for mode, r in runs.items():
            log(f"[cifar-wire] {cfg.name} {mode}: {R} rounds, median "
                f"{r['median_round_ms']:.2f} ms (rounds "
                f"{[round(x, 2) for x in r['round_ms']]}) | launches "
                f"{json.dumps(r['launches'])}")
            log(f"[cifar-wire] {cfg.name} {mode} split, ms a round: "
                + ", ".join(f"{k} {v['per_round_ms']:.3f}"
                            for k, v in r["parts"].items()))
        log(f"[cifar-wire] {cfg.name}: pipelined == speculative == serial "
            f"bit for bit | bytes {json.dumps(rec['wire_stats'])} | 2 "
            f"serial rounds under torch.profiler: wall "
            f"{prof['wall_ms']:.1f} ms, card busy {prof['device_busy_ms']:.2f}"
            f" ms ({prof['busy_share']:.2%})")
        out[cfg.name] = rec
        del runs, sess
        torch.cuda.empty_cache()
    return out


def cifar_resume(dev) -> dict:
    """(e) CNN6 in the Trainer: 2 steps, a checkpoint, a fresh Trainer and 2
    more steps == 4 steps without a break, bit for bit on the card (master,
    momentum, clip bound, noise key, losses, ledger)."""
    import shutil
    import tempfile

    from repro_torch.configs.base import PrivacyConfig
    from repro_torch.configs.paper_models import CIFAR10_CNN6

    priv = PrivacyConfig(enabled=True, sigma=0.5, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=4)
    root = Path(tempfile.mkdtemp(prefix="cifar_"))
    try:
        full = cifar_trainer(CIFAR10_CNN6, dev, priv, 1, 4)
        cifar_trainer(CIFAR10_CNN6, dev, priv, 1, 2, ckpt=root)
        resumed = cifar_trainer(CIFAR10_CNN6, dev, priv, 1, 4, ckpt=root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    (ta, sa, _, _), (tb, sb, _, _) = full, resumed
    eq = {k: torch.equal(sa.opt_state[k], sb.opt_state[k])
          for k in ("master", "mu")}
    eq["clip_bound"] = torch.equal(sa.clip_bound, sb.clip_bound)
    eq["noise_key"] = sa.noise_state.prev_key == sb.noise_state.prev_key
    eq["losses"] = [m["loss"] for m in ta.metrics_log] == \
        [m["loss"] for m in tb.metrics_log]
    eq["ledger"] = json.dumps(ta.accountant.state_dict()) == \
        json.dumps(tb.accountant.state_dict())
    check(tb.restored_step == 2 and all(eq.values()),
          f"cifar Trainer: resumed (from {tb.restored_step}) vs "
          f"uninterrupted {eq}")
    log(f"[cifar] CNN6 Trainer: 2 steps + checkpoint + 2 == 4 steps bit for "
        f"bit ({', '.join(eq)}) | losses "
        f"{[round(m['loss'], 4) for m in ta.metrics_log]}")
    return {"equal": eq, "losses": [m["loss"] for m in ta.metrics_log]}


def cifar_cross_device(dev) -> dict:
    """(f) one fused step of CNN6 and of a narrow WRN
    (``WRNConfig(depth=10, widen=1)``) on the card and on the host CPU from
    the same weights and batch (sigma 0, so the aggregate is the clipped
    sum): loss and bound within TRAIN_RTOL, every silo's norm and the
    aggregate's relative L2 difference within the model's CIFAR_CARD_TOL;
    the card once more with TF32 convolutions (:func:`conv_route`), which
    must miss those bounds: the gate sees TF32. Logged beside: the card on
    cuDNN's default fp32 algorithms."""
    from repro_torch.configs.base import PrivacyConfig
    from repro_torch.configs.paper_models import CIFAR10_CNN6, WRNConfig
    from repro_torch.core import flatbuf, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.core.noise_correction import init_state as init_noise
    from repro_torch.data.synthetic import synthetic_cifar10
    from repro_torch.distributed import steps as steps_mod
    from repro_torch.models.packing import pack_params

    priv = PrivacyConfig(enabled=True, sigma=0.0, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=4,
                         clip_percentile_max=64.0)

    def diff(x, y) -> dict:
        return {"loss_rel": abs(x[1] - y[1]) / abs(y[1]),
                "bound_rel": abs(x[3] - y[3]) / abs(y[3]),
                "norms_max_rel": max_rel(x[2], y[2]),
                "aggregate_l2_rel": ((x[0] - y[0]).double().norm()
                                     / y[0].double().norm()).item(),
                "aggregate_max_abs": (x[0] - y[0]).abs().max().item(),
                "aggregate_largest": y[0].abs().max().item()}

    out: dict = {}
    for cfg, B in ((CIFAR10_CNN6, 256),
                   (WRNConfig(name="wrn10x1", depth=10, widen=1), 64)):
        sm, model = cifar_setup(cfg, dev)
        w = sm.init(torch.Generator().manual_seed(3))
        data = synthetic_cifar10(n_train=B, n_test=16, seed=22)[0]

        def step(d, route="exact"):
            params = {k: v.clone().to(d) for k, v in w.items()}
            layout, _ = pack_params(params)
            batch = {"x": torch.as_tensor(data.x).to(d),
                     "y": torch.as_tensor(data.y).to(d)}
            keys = step_keys(prng.PRNGKey(1), 0)
            ns = init_noise(prng.fold_in(prng.PRNGKey(0), 0xD0), 4)
            c0 = torch.full((), 1.0, dtype=torch.float32, device=d)
            with conv_route(route):
                agg, loss, norms, _, bound = steps_mod._fused_grads(
                    model, priv, params, batch, 4, keys, ns, c0,
                    keys.key_clip, layout, steps_mod.StageTimer(d))
            return (flatbuf.zero_padding(layout, agg).cpu(), float(loss),
                    norms.cpu(), float(bound))

        cpu = step("cpu")
        rec = {"batch": B, "card_vs_cpu": diff(step("cuda"), cpu),
               "tf32_card_vs_cpu": diff(step("cuda", "tf32"), cpu),
               "plain_card_vs_cpu": diff(step("cuda", "plain"), cpu),
               "tolerance": {"loss_bound_rel": TRAIN_RTOL,
                             **CIFAR_CARD_TOL[cfg.name]}}
        out[cfg.name] = rec
        for k in ("card_vs_cpu", "tf32_card_vs_cpu", "plain_card_vs_cpu"):
            log(f"[cifar] {cfg.name} one fused step (batch {B}), {k}: "
                + ", ".join(f"{m} {v:.3g}" for m, v in rec[k].items()))
    for name, rec in out.items():
        d, t, tol = rec["card_vs_cpu"], rec["tf32_card_vs_cpu"], \
            CIFAR_CARD_TOL[name]
        check(d["loss_rel"] <= TRAIN_RTOL and d["bound_rel"] <= TRAIN_RTOL
              and d["norms_max_rel"] <= tol["norms_rel"]
              and d["aggregate_l2_rel"] <= tol["aggregate_l2_rel"],
              f"cifar card vs CPU {name}: {d} (tolerance {tol})")
        check(t["norms_max_rel"] > tol["norms_rel"]
              or t["aggregate_l2_rel"] > tol["aggregate_l2_rel"],
              f"cifar {name}: TF32 convolutions stay within the gate {t}")
        log(f"[cifar] {name} card vs CPU within {tol}; TF32 misses it")
    return out


def cifar_phase(dev, sass=None) -> tuple:
    """Phase 20: the paper's CIFAR models on the card. Returns ``(record,
    the DP kernels' sub-rows at the CIFAR shapes, launches on the main
    path)``."""
    t20 = time.perf_counter()
    rec: dict = {"card_vs_cpu": cifar_cross_device(dev)}
    rec["prng_scan_noise_wrn28"] = wrn_noise_stage(dev)
    rows = cifar_kernel_rows(dev, sass if sass is not None
                             else library_sass())
    rec["tiers"] = cifar_tiers(dev)
    rec["convergence"] = cifar_convergence(dev)
    rec["per_example"] = cifar_per_example(dev)
    rec["wire"] = cifar_wire(dev)
    rec["resume"] = cifar_resume(dev)
    tiers = rec["tiers"]
    # the per-leaf kernels (zsmask, per_example_sumsq) launch on none of
    # these paths: the perleaf tier and route run the tree kernels (phase
    # 22's rows)
    for name, tier, sub in (("clip_accumulate", "fused", None),
                            ("noise_batch", "fused", None),
                            ("clip_mask", "barrier", None),
                            ("zsmask", "perleaf", None)):
        for model, short in (("cifar10-cnn6", "cnn6"),
                             ("cifar10-wrn28", "wrn28")):
            rows[name][short]["launches"] = \
                tiers[model][tier]["launches"].get(name, 0)
    for name in ("per_example_sumsq", "clip_sum"):
        impl = "packed" if name == "clip_sum" else "perleaf"
        rows[name]["pe16"]["launches"] = \
            rec["per_example"][impl]["launches"].get(name, 0)
    rec["phase_s"] = time.perf_counter() - t20
    log(f"[cifar] phase 20 in {rec['phase_s']:.1f} s")
    return rec, rows


# --------------------------------------------------------------- phase 21
# the per-leaf normal draw (kernels/prng/csrc/normal.cu) at the sizes the
# main paths give it: one element, a few, an admin window of 2**22 and one
# past it, and qwen2.5-3b's embedding leaf (151,936 x 2,048) in one launch;
# then counters that cross 2**32, which no leaf of today's configs reaches
NORMAL_SIZES = (1, 7, 1 << 22, (1 << 22) + 3, 311_164_928)
NORMAL_PAST_2_32 = ((1 << 32) - 1_000_003, 3_000_000)  # offset, n
NORMAL_KEYS = ((2705940334, 2639757084), (4086990474, 1067026239))
FP64_OPS = {"DMUL", "DADD", "DFMA"}
# per-SM rates of Hopper (CUDA C++ programming guide, arithmetic
# instruction throughput, compute capability 9.0): 64 float64 adds,
# multiplies and multiply-adds a clock, and 16 conversions to or from a
# 64-bit type
NORMAL_LANES = {**LANES, "fp64": 64, "conv64": 16}
# the SASS of normal_kernel<0> (normal) and normal_kernel<2> (two keys:
# corrected_noise's window) in the anonymous namespace of normal.cu
NORMAL_SASS = {"normal": r"normal_kernelILi0E", "normal_combine":
               r"normal_kernelILi2E"}
# arithmetic instructions a normal by pipe in each kernel's loop as this
# design compiled it for the H100 (four elements a thread, one float64
# multiply-add an erf_inv step), pinned so that a redesign is held to one
# bound; the live count of the running build is logged beside it as a
# report only
NORMAL_OPS = {
    "normal": {"normals_in_loop": 4.0, "alu": 84.0, "imad": 23.75,
               "fp32+imad": 53.75, "mufu": 1.0, "fp64": 8.0,
               "conv64": 17.0, "issue": 168.75},
    "normal_combine": {"normals_in_loop": 8.0, "alu": 83.875, "imad": 23.5,
                       "fp32+imad": 56.0, "mufu": 1.0, "fp64": 8.0,
                       "conv64": 17.0, "issue": 172.875}}


def normal_ops(sass: str, kernel: str) -> dict:
    """Arithmetic instructions one normal costs in ``kernel`` (a regular
    expression of its mangled name), by pipe: the innermost loop with the
    most float64 operations, over its normals (erf_inv's eight steps, one
    ``DFMA`` each). ``conv64`` counts the float32 <-> float64 conversions
    (``F2F`` with an ``F64`` side), ``fp64`` the float64 adds, multiplies
    and multiply-adds; moves, branches and memory are left out, as in
    :func:`stream_ops`, so the bound from these counts is a lower bound."""
    loops = sass_loops(sass, kernel)
    fp64 = lambda ops: sum(o.split(".")[0] in FP64_OPS for o in ops)
    best = max(loops, key=fp64, default=[])
    n = fp64(best) / 8
    check(n >= 1, f"no loop of {kernel} draws a normal")
    count = dict.fromkeys(("alu", "imad", "fp32", "mufu", "fp64", "conv64",
                           "other"), 0)
    for o in best:
        if ".MOV" in o:
            continue
        base = o.split(".")[0]
        if base == "F2F" and "F64" in o:
            count["conv64"] += 1
        else:
            for c, ops in (("alu", ALU_OPS), ("imad", IMAD_OPS),
                           ("fp32", FP32_OPS), ("mufu", {"MUFU"}),
                           ("fp64", FP64_OPS), ("other", OTHER_OPS)):
                if base in ops:
                    count[c] += 1
    per = {k: v / n for k, v in count.items()}
    return {"normals_in_loop": n, "alu": per["alu"], "imad": per["imad"],
            "fp32+imad": per["fp32"] + per["imad"], "mufu": per["mufu"],
            "fp64": per["fp64"], "conv64": per["conv64"],
            "issue": sum(per.values())}


def normal_bound(n: int, streams: int, words: int, per_normal: dict) -> dict:
    """Milliseconds by limit for ``streams`` normals an element over n
    elements: bytes (``words`` fp32 words an element, each read or written
    once) and each pipe's count a normal over its lanes."""
    parts = {"bytes": words * n * 4 / HBM_BYTES_PER_S * 1e3}
    for pipe, lanes in NORMAL_LANES.items():
        parts[pipe] = streams * n * per_normal[pipe] / (lanes * SM_OPS_PER_S) \
            * 1e3
    return parts


@contextlib.contextmanager
def plain_draw_spy(counts: dict):
    """Counts into ``counts["plain_draws_on_card"]`` the plain per-leaf
    draws (``kernels/prng/ref.py``'s ``_draw``, under every plain
    ``normal`` and ``normal_combine``) made on a CUDA device inside the
    block: a main path must make none (a CUDA tensor goes to its
    kernel)."""
    from repro_torch.kernels.prng import ref
    real = ref._draw
    counts.setdefault("plain_draws_on_card", 0)

    def spy(key, n, offset, device):
        if torch.device(device).type == "cuda":
            counts["plain_draws_on_card"] += 1
        return real(key, n, offset, device)

    ref._draw = spy
    try:
        yield counts
    finally:
        ref._draw = real


def compare_normal(dev, n: int, offset: int, ops, ref) -> dict:
    """Both entries against their plain versions on the card at ``n``
    elements from counter ``offset``: ``normal``, and ``normal_combine``
    with two keys at gate 0.7 (accumulating) and 0 (written) and with one
    key (accumulating). Returns each case's count of unequal elements and
    largest difference; all must be 0."""
    (ka, kb), f = NORMAL_KEYS, lambda x: torch.full((), x, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    out = {}
    a = ops.normal(ka, offset, torch.empty(n, device=dev))
    b = ref.normal_ref(ka, n, offset, dev)
    out["normal"] = (int((a != b).sum()), (a - b).abs().max().item())
    del a, b
    for name, key_b, g, acc in (("gate 0.7, added", kb, 0.7, True),
                                ("gate 0, written", kb, 0.0, False),
                                ("one key, added", None, 0.0, True)):
        base = torch.empty(n, device=dev).uniform_(-1.0, 1.0, generator=gen)
        a = ops.normal_combine(base.clone(), ka, key_b, offset, f(1.3),
                               f(1.1), f(g), acc)
        b = ref.normal_combine_ref(base, ka, key_b, offset, f(1.3), f(1.1),
                                   f(g), acc)
        out[f"normal_combine {name}"] = (int((a != b).sum()),
                                         (a - b).abs().max().item())
        del a, b, base
    torch.cuda.empty_cache()
    check(not any(c for c, _ in out.values()),
          f"the normal kernels differ from their plain versions at n {n}, "
          f"offset {offset}: {out}")
    return out


def normal_phase(dev, sass: str) -> tuple:
    """Phase 21: the per-leaf normal draw. (a) Both entries bit-equal to
    their plain versions at every size of NORMAL_SIZES and past 2**32
    (NORMAL_PAST_2_32), for both gates; the plain version's ``log1p`` is
    torch's CUDA one, the kernel's CUDA's ``log1pf``, so this also holds
    the two to each other; (b) each entry's SASS counts a normal (pinned,
    NORMAL_OPS; the live ones logged), its launch configuration, its call
    and card ms beside the plain version's and its bound. Returns ``(record, the two rows of
    the kernels line without their launches)``."""
    from repro_torch.kernels.prng import ops, ref

    t0 = time.perf_counter()
    ka, kb = NORMAL_KEYS
    f = lambda x: torch.full((), x, dtype=torch.float32, device=dev)
    n22 = 1 << 22
    checked = {}
    cases = [(n, 0) for n in NORMAL_SIZES] + [NORMAL_PAST_2_32[::-1]]
    for n, off in cases:
        checked[f"n {n} offset {off}"] = compare_normal(dev, n, off, ops,
                                                        ref)
    log(f"[normal] both entries bit-equal to their plain versions at "
        f"{', '.join(checked)} (normal; normal_combine with two keys at "
        f"gate 0.7 and 0, and with one key)")
    live = {k: normal_ops(sass, r) for k, r in NORMAL_SASS.items()}
    pinned = NORMAL_OPS
    configs = {k: ops.config(k) for k in NORMAL_SASS}
    for k in live:
        log(f"[normal] {k} SASS a normal, live (a report; the bound uses "
            f"{json.dumps(pinned[k])}): {json.dumps(live[k])} | launch "
            f"configuration {json.dumps(configs[k])}")

    leaf = NORMAL_SIZES[-1]
    rows = {}
    o22 = torch.empty(n22, device=dev)
    parts = normal_bound(n22, 1, 1, pinned["normal"])
    bms = max(parts.values())
    rows["normal"] = {
        "max_abs_err": 0.0, "checked": checked,
        "ms": cuda_ms(lambda: ops.normal(ka, 0, o22)),
        "device_ms": graph_ms(lambda: ops.normal(ka, 0, o22)),
        "plain_ms": cuda_ms(lambda: ref.normal_ref(ka, n22, 0, dev), reps=5),
        "library_ms": None,
        "library_call": "none (torch.randn is Philox, another function)",
        "bound_ms": bms,
        "bound_by": "bytes" if bms == parts["bytes"] else "operations",
        "bound_detail": {"ms_by_limit": parts, "per_normal": pinned["normal"],
                         "live": live["normal"]},
        "config": configs["normal"],
        "at": f"n={n22} (an admin row's window), one key, fp32"}
    del o22
    big = torch.zeros(leaf, device=dev)
    rows["normal"]["leaf311m"] = {
        "ms": cuda_ms(lambda: ops.normal(ka, 0, big), reps=5, warmup=1),
        "device_ms": graph_ms(lambda: ops.normal(ka, 0, big), n=5, reps=5),
        "bound_ms": max(normal_bound(leaf, 1, 1, pinned["normal"]).values()),
        "at": f"n={leaf} (qwen2.5-3b's embedding leaf), one launch"}
    big.zero_()
    sc, sp, g = f(1.3), f(1.3), f(0.7)

    def comb(out):
        return lambda: ops.normal_combine(out, ka, kb, 0, sc, sp, g, True)

    parts = normal_bound(leaf, 2, 2, pinned["normal_combine"])
    bms = max(parts.values())
    rows["normal_combine"] = {
        "max_abs_err": 0.0, "checked": checked,
        "ms": cuda_ms(comb(big), reps=5, warmup=1),
        "device_ms": graph_ms(comb(big), n=5, reps=5),
        "plain_ms": cuda_ms(lambda: ref.normal_combine_ref(
            big, ka, kb, 0, sc, sp, g, True), reps=2, warmup=1),
        "library_ms": None,
        "library_call": "none (torch.randn is Philox, another function)",
        "bound_ms": bms,
        "bound_by": "bytes" if bms == parts["bytes"] else "operations",
        "bound_detail": {"ms_by_limit": parts,
                         "per_normal": pinned["normal_combine"],
                         "live": live["normal_combine"]},
        "config": configs["normal_combine"],
        "at": f"n={leaf} (qwen2.5-3b's embedding leaf), xi_t and lam "
              f"xi_(t-1) added in place, fp32"}
    del big
    w = torch.zeros(n22, device=dev)
    rows["normal_combine"]["w22"] = {
        "ms": cuda_ms(comb(w)), "device_ms": graph_ms(comb(w)),
        "plain_ms": cuda_ms(lambda: ref.normal_combine_ref(
            w, ka, kb, 0, sc, sp, g, True), reps=5),
        "bound_ms": max(normal_bound(n22, 2, 2,
                                     pinned["normal_combine"]).values()),
        "at": f"n={n22}, two keys, added"}
    del w
    torch.cuda.empty_cache()
    for k, r in rows.items():
        sub = r.get("leaf311m") or r.get("w22")
        log(f"[kernel] {k}: call {r['ms']:.4f} ms, card {r['device_ms']:.4f} "
            f"ms (plain {r['plain_ms']:.2f} ms; bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}) at {r['at']} | {json.dumps(sub)}")
    rec = {"checked": checked, "sass_live": live,
           "sass_pinned": pinned, "configs": configs,
           "phase_s": time.perf_counter() - t0}
    return rec, rows


# --------------------------------------------------------------- phase 22
# the per-leaf wrappers at one launch a tree (kernels/zsmask/csrc/zsmask.cu,
# zsmask_buffer_kernel; kernels/dp_clip/csrc/sumsq.cu, rowsq_tree_*): the
# layouts of CNN6 (14 leaf tensors), WRN28 (80) and qwen2.5-3b at 12 layers
# (147), silo 1 of 4 at sigma 0.3 and C 4 with lambda 0.7 for the mask;
# WRN28's (16, P) per-example buffer and qwen2.5-3b's (4, P) for the norms
TREE_PAD = 3.25  # every padding position's value: no tree kernel touches it
# zsmask_buffer_kernel<false, float> and <true, float> in the SASS (the
# bf16 instantiations, <PREV, __nv_bfloat16>, are TREE_SASS_BF16)
TREE_SASS = {False: r"zsmask_buffer_kernelILb0EfE",
             True: r"zsmask_buffer_kernelILb1EfE"}
TREE_SASS_BF16 = {False: r"zsmask_buffer_kernelILb0E\d+__nv_bfloat16E",
                  True: r"zsmask_buffer_kernelILb1E\d+__nv_bfloat16E"}


def tree_layouts() -> dict:
    """name -> (layout, per-example rows or None, timing reps) of phase
    22's cells."""
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_models import CIFAR10_CNN6, CIFAR10_WRN28
    from repro_torch.core import flatbuf
    from repro_torch.models.packing import param_tree
    from repro_torch.models.transformer import Transformer
    out = {}
    for cfg, name in ((CIFAR10_CNN6, "cnn6"), (CIFAR10_WRN28, "wrn28")):
        sm, _ = cifar_setup(cfg, torch.device("cpu"))
        out[name] = flatbuf.layout_of(sm.init(torch.Generator().manual_seed(0)))
    cut12 = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=12)
    out["qwen12"] = flatbuf.layout_of(param_tree(Transformer(cut12, "meta")))
    return out


def padding_of(layout, dev) -> torch.Tensor:
    """A (P,) bool tensor on ``dev``: True where no tensor of the layout
    lies."""
    from repro_torch.core import flatbuf
    pad = torch.ones(layout.total, dtype=torch.bool)
    for off, numel, *_ in flatbuf.leaf_table(layout):
        pad[off:off + numel] = False
    return pad.to(dev)


def perleaf_mask_route(buf, layout, keys, prev_key, sigma_c, b, lam):
    """The per-leaf route the tree kernel replaces, in place over the
    packed buffer: a ``zsmask`` per tensor (``masking.mask_leaf``), then
    with ``prev_key`` a second over zeros on it with ``b = 0`` into
    scratch and ``lam * prev`` subtracted (what ``_contribution_perleaf``
    launched before the tree kernel)."""
    from repro_torch.core import flatbuf, masking
    tree = flatbuf.unpack(layout, buf)
    most = max(n for _, n, *_ in flatbuf.leaf_table(layout))
    if prev_key is not None:
        zeros = torch.zeros(most, device=buf.device)
        scratch = torch.empty(most, device=buf.device)
    for i, offset, t in flatbuf.leaf_slices(layout, tree):
        flat = t.view(-1)
        masking.mask_leaf(flat, keys.key_r, keys.key_xi, i, offset, 1, 4,
                          sigma_c, b, out=flat)
        if prev_key is not None:
            n = flat.numel()
            prev = masking.mask_leaf(zeros[:n], keys.key_r, prev_key, i,
                                     offset, 1, 4, sigma_c, 0.0,
                                     out=scratch[:n])
            flat.sub_(lam * prev)
    return buf


def check_zsmask_buffer(dev, name, layout, per_normal, keys, prev) -> dict:
    """``zsmask_buffer`` over every tensor of ``layout`` (both
    instantiations): bit-equal to the per-leaf route's launches and to its
    plain version over every element, the padding untouched, two launches
    bit-identical; one launch against the route's; call and card ms of
    both beside the bound (the pinned per-normal counts, 3 normals an
    element, 4 with the correction). Returns ``{use_prev: row}``."""
    from repro_torch.core import flatbuf, masking
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.zsmask import ref as zs_ref
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=dev)
    sigma_c = f32(0.3) * f32(4.0)
    b = f32(8.0) * sigma_c
    lam = 0.7 * f32(1.0) * 1.0
    P, n = layout.total, layout.n_params
    table = flatbuf.leaf_table(layout)
    big = name == "qwen12"
    g = torch.randn(P, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(22))
    pad = padding_of(layout, dev)
    g[pad] = TREE_PAD
    rows = {}
    for use_prev in (False, True):
        pk = prev if use_prev else None
        tree_call = lambda buf: masking.mask_buffer(
            buf, layout, keys.key_r, keys.key_xi, 1, 4, sigma_c, b, pk, lam)
        leaf_call = lambda buf: perleaf_mask_route(buf, layout, keys, pk,
                                                   sigma_c, b, lam)
        dispatch.reset_launches()
        want = leaf_call(g.clone())
        torch.cuda.synchronize()
        n_leaf = {k: v for k, v in dispatch.launch_counts().items() if v}
        dispatch.reset_launches()
        got = tree_call(g.clone())
        torch.cuda.synchronize()
        n_tree = {k: v for k, v in dispatch.launch_counts().items() if v}
        n_var = dispatch.variant_counts()["zsmask_buffer"]
        check(n_tree == {"zsmask_buffer": 1}
              and n_var == {"plain": int(not use_prev), "prev": int(use_prev),
                            "bf16": 0, "bf16_prev": 0}
              and n_leaf == {"zsmask": len(table) * (2 if use_prev else 1)},
              f"zsmask_buffer {name}: launches {n_tree} ({n_var}), per-leaf "
              f"{n_leaf}")
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"zsmask_buffer {name} prev {use_prev} differs from the "
              f"per-leaf launches")
        del want
        again = tree_call(g.clone())
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"zsmask_buffer {name}: two launches differ")
        del again
        check(bool((got[pad] == TREE_PAD).all()),
              f"zsmask_buffer {name}: padding touched")
        plain = zs_ref.zsmask_buffer_ref(
            g.clone(), table, keys.key_r, keys.key_xi, 1, 4, sigma_c, b, pk,
            lam)
        err = max_err_by_window(got, lambda a, z: plain[a:z], P)
        check(err == 0.0 and torch.equal(got.view(torch.int32),
                                          plain.view(torch.int32)),
              f"zsmask_buffer {name} differs from its plain version by {err}")
        check(bool(torch.isfinite(got).all()),
              f"zsmask_buffer {name}: non-finite")
        del got, plain
        work = g.clone()
        w = min(DP_WINDOW, P)
        reps = (3, 1) if big else (20, 3)
        gn = 2 if big else 20
        parts = stream_bound(n, 4 if use_prev else 3, per_normal)
        bms = max(parts.values())
        leaf_ms = cuda_ms(lambda: leaf_call(work), reps=reps[0],
                          warmup=reps[1])
        rows[use_prev] = {
            "max_abs_err": err, "bit_equal_per_leaf": True,
            "bit_identical_relaunch": True, "padding_untouched": True,
            "checked_at": f"all {n} elements of {len(table)} tensors and "
                          f"the padding",
            "launches_tree_vs_per_leaf": [1, n_leaf["zsmask"]],
            "ms": cuda_ms(lambda: tree_call(work), reps=reps[0],
                          warmup=reps[1]),
            "device_ms": graph_ms(lambda: tree_call(work), n=gn, reps=5),
            "per_leaf_ms": leaf_ms,
            "per_leaf_device_ms": graph_ms(lambda: leaf_call(work),
                                           n=1 if big else 4, reps=3),
            "plain_ms": cuda_ms(lambda: zs_ref.zsmask_buffer_ref(
                work[:w], ((0, w, 0, 0, 0),), keys.key_r, keys.key_xi, 1, 4,
                sigma_c, b, pk, lam), reps=5),
            "plain_at": f"window of {w} elements",
            "library_ms": None,
            "library_call": "none (no PyTorch call draws keyed threefry "
                            "normals)",
            "bound_ms": bms,
            "bound_by": "bytes" if bms == parts["bytes"] else "operations",
            "bound_detail": {"ms_by_limit": parts, "per_stream": per_normal},
            "at": f"{name}: one silo's pass over the {len(table)} tensors "
                  f"({n} elements), "
                  + ("the correction fused in (4 normals an element)"
                     if use_prev else "no correction (3 normals)")}
        del work
    del g
    torch.cuda.empty_cache()
    return rows


def bf16_layout(layout):
    """``layout`` with every leaf bf16 (route (B)'s tree of the same
    shapes: the same offsets and total)."""
    from repro_torch.core import flatbuf
    return flatbuf.build_layout(layout.paths, layout.shapes, layout.stacks,
                                ("bfloat16",) * layout.n_leaves)


def check_zsmask_buffer_bf16(dev, name, layout, per_normal, keys, prev,
                             variants=(False, True)) -> dict:
    """The bf16 instantiations of ``zsmask_buffer`` over every tensor of
    ``layout`` made bf16 (:func:`bf16_layout`), with and without the
    correction (``variants``: the ``use_prev`` values checked): the
    clipped leaves' packed bf16 buffer in, the fp32 contribution row out;
    bit-equal to the plain version
    (``ref.zsmask_buffer_bf16_ref``) over every element, the padding of
    the row untouched, two launches bit-identical; call and card ms beside
    the bound (the pinned per-normal counts over 6 bytes an element: a bf16
    read, an fp32 write); the launch configuration. Returns
    ``{use_prev: row}``."""
    from repro_torch.core import flatbuf
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.zsmask import ops as zs_ops
    from repro_torch.kernels.zsmask import ref as zs_ref
    from repro_torch.kernels.zsmask.zsmask import buffer_config
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=dev)
    sigma_c = f32(0.3) * f32(4.0)
    b = f32(8.0) * sigma_c
    lam = 0.7 * f32(1.0) * 1.0
    lay = bf16_layout(layout)
    P, n = lay.total, lay.n_params
    table = flatbuf.leaf_table(lay, "bfloat16")
    big = name == "qwen12"
    src = torch.randn(P, device=dev, generator=torch.Generator(
        device=dev).manual_seed(27)).to(torch.bfloat16)
    pad = padding_of(lay, dev)
    rows = {}
    for use_prev in variants:
        pk = prev if use_prev else None
        call = lambda out: zs_ops.zsmask_buffer_bf16(
            src, out, lay, keys.key_r, keys.key_xi, 1, 4, sigma_c, b, pk, lam)
        fresh = lambda: torch.full((P,), TREE_PAD, device=dev)
        dispatch.reset_launches()
        got = call(fresh())
        torch.cuda.synchronize()
        n_tree = {k: v for k, v in dispatch.launch_counts().items() if v}
        n_var = dispatch.variant_counts()["zsmask_buffer"]
        v = "bf16_prev" if use_prev else "bf16"
        check(n_tree == {"zsmask_buffer": 1} and n_var[v] == 1
              and sum(n_var.values()) == 1,
              f"zsmask_buffer bf16 {name}: launches {n_tree} ({n_var})")
        again = call(fresh())
        check(torch.equal(bits(got), bits(again)),
              f"zsmask_buffer bf16 {name}: two launches differ")
        del again
        check(bool((got[pad] == TREE_PAD).all()),
              f"zsmask_buffer bf16 {name}: padding touched")
        plain = zs_ref.zsmask_buffer_bf16_ref(
            src, fresh(), table, keys.key_r, keys.key_xi, 1, 4, sigma_c, b,
            pk, lam)
        err = max_err_by_window(got, lambda a, z: plain[a:z], P)
        check(err == 0.0 and torch.equal(bits(got), bits(plain)),
              f"zsmask_buffer bf16 {name} differs from its plain version by "
              f"{err}")
        check(bool(torch.isfinite(got).all()),
              f"zsmask_buffer bf16 {name}: non-finite")
        del got, plain
        work = fresh()
        w = min(DP_WINDOW, P)
        reps = (3, 1) if big else (20, 3)
        parts = stream_bound(n, 4 if use_prev else 3, per_normal, words=1.5)
        bms = max(parts.values())
        rows[use_prev] = {
            "max_abs_err": err, "bit_identical_relaunch": True,
            "padding_untouched": True,
            "checked_at": f"all {n} elements of {len(table)} bf16 tensors "
                          f"and the padding",
            "ms": cuda_ms(lambda: call(work), reps=reps[0], warmup=reps[1]),
            "device_ms": graph_ms(lambda: call(work), n=2 if big else 20,
                                  reps=5),
            "plain_ms": cuda_ms(lambda: zs_ref.zsmask_buffer_bf16_ref(
                src[:w], work[:w], ((0, w, 0, 0, 0),), keys.key_r,
                keys.key_xi, 1, 4, sigma_c, b, pk, lam), reps=5),
            "plain_at": f"window of {w} elements",
            "library_ms": None,
            "library_call": "none (no PyTorch call draws keyed threefry "
                            "normals)",
            "bound_ms": bms,
            "bound_by": "bytes" if bms == parts["bytes"] else "operations",
            "bound_detail": {"ms_by_limit": parts, "per_stream": per_normal,
                             "bytes_an_element": 6},
            "config": buffer_config(use_prev, bf16=True),
            "at": f"{name} in bf16: one silo's pass over the {len(table)} "
                  f"tensors ({n} elements), bf16 in, fp32 out, "
                  + ("the correction fused in (4 normals an element)"
                     if use_prev else "no correction (3 normals)")}
        del work
    del src
    torch.cuda.empty_cache()
    return rows


def check_sumsq_tree(dev, name, layout, B) -> dict:
    """``per_example_sumsq_tree`` on a (B, P) buffer of ``layout``: its
    per-leaf sums bit-equal to a ``per_example_sumsq`` launch a leaf, its
    totals to their sum in leaf order, within SUMSQ_RTOL of the plain
    version, two launches bit-identical; the per-leaf clip route's one
    ``clip_accumulate`` over the buffer bit-equal to a launch a leaf; call
    and card ms beside the per-leaf launches, the per-leaf
    ``vector_norm`` loop and one ``vector_norm`` over the buffer (both
    host-clocked calls), and the bound."""
    from repro_torch.core import flatbuf
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.kernels.dp_clip import ref as clip_ref
    P, n, L = layout.total, layout.n_params, layout.n_leaves
    pe = torch.randn(B, P, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(23))
    pe *= torch.logspace(-1, 1, B, device=dev)[:, None]
    cols = leaf_columns(pe, layout)
    dispatch.reset_launches()
    per = [clip_ops.sumsq(c) for c in cols]
    n_leaf = dispatch.launch_counts()["per_example_sumsq"]
    dispatch.reset_launches()
    total, leaves = clip_ops.sumsq_tree(pe, layout, per_leaf=True)
    again = clip_ops.sumsq_tree(pe, layout)
    n_tree = {k: v for k, v in dispatch.launch_counts().items() if v}
    check(n_tree == {"per_example_sumsq_tree": 2} and n_leaf == L,
          f"per_example_sumsq_tree {name}: launches {n_tree}, per-leaf "
          f"{n_leaf}")
    check(torch.equal(leaves, torch.stack(per))
          and torch.equal(total, sum(per)) and torch.equal(total, again),
          f"per_example_sumsq_tree {name} differs from the per-leaf "
          f"launches or between two launches")
    plain = clip_ref.per_example_sumsq_tree_ref(pe, layout.offsets,
                                                layout.sizes)
    rel = max_rel(total, plain)
    check(rel <= SUMSQ_RTOL, f"per_example_sumsq_tree {name} off its plain "
                             f"version by {rel} relative")
    err = (total - plain).abs().max().item()
    # the clip route: one clip_accumulate over the buffer
    scale = clip_ref.clip_scales(total, 1.0)
    want = torch.empty(P, device=dev)
    for off, size, c in zip(layout.offsets, layout.sizes, cols):
        want[off:off + size] = clip_ops.clip_accumulate(c, scale)
    flatbuf.zero_padding(layout, want)
    dispatch.reset_launches()
    tree, norms = clip_ops.clip_and_sum_tree(pe, 1.0, "perleaf",
                                             layout=layout)
    n_route = {k: v for k, v in dispatch.launch_counts().items() if v}
    check(n_route == {"per_example_sumsq_tree": 1, "clip_accumulate": 1}
          and torch.equal(flatbuf.pack(layout, tree), want)
          and torch.equal(norms, torch.sqrt(total)),
          f"per-leaf clip route {name}: launches {n_route}, or its sum "
          f"differs from a clip_accumulate a leaf")
    del tree, want
    bms, by = bound(B * n * 4 + B * 4, 2 * B * n)
    reps = (3, 1) if name == "qwen12" else (20, 3)
    gn = 2 if name == "qwen12" else 20
    call = lambda: clip_ops.sumsq_tree(pe, layout)
    route = lambda: clip_ops.clip_and_sum_tree(pe, 1.0, "perleaf",
                                               layout=layout)
    summed = torch.empty(P, device=dev)
    row = {
        "max_abs_err": err, "max_rel_err": rel, "tolerance_rel": SUMSQ_RTOL,
        "bit_equal_per_leaf": True, "bit_identical_relaunch": True,
        "checked_at": f"every (row, leaf) of {L} leaves and the {B} totals",
        "launches_tree_vs_per_leaf": [1, n_leaf],
        "ms": cuda_ms(call, reps=reps[0], warmup=reps[1]),
        "device_ms": graph_ms(call, n=gn, reps=5),
        "per_leaf_ms": cuda_ms(lambda: [clip_ops.sumsq(c) for c in cols],
                               reps=reps[0], warmup=reps[1]),
        "per_leaf_device_ms": graph_ms(lambda: [clip_ops.sumsq(c)
                                                for c in cols], n=2, reps=5),
        "plain_ms": cuda_ms(lambda: clip_ref.per_example_sumsq_tree_ref(
            pe, layout.offsets, layout.sizes), reps=3, warmup=1),
        "plain_at": "every leaf (chunked dot products)",
        "library_ms": cuda_ms(lambda: torch.linalg.vector_norm(pe, dim=1),
                              reps=reps[0], warmup=reps[1]),
        "library_call": "torch.linalg.vector_norm(pe, dim=1), the whole "
                        "buffer (call)",
        "library_per_leaf_ms": cuda_ms(
            lambda: [torch.linalg.vector_norm(c, dim=1) for c in cols],
            reps=reps[0], warmup=reps[1]),
        "route_ms": cuda_ms(route, reps=reps[0], warmup=reps[1]),
        "route_device_ms": graph_ms(route, n=gn, reps=5),
        # the route's parts, each a call timed alone
        "route_parts_ms": {
            "sumsq_tree": cuda_ms(call, reps=reps[0], warmup=reps[1]),
            "clip_scales": cuda_ms(lambda: clip_ref.clip_scales(total, 1.0),
                                   reps=reps[0], warmup=reps[1]),
            "clip_accumulate": cuda_ms(lambda: clip_ops.clip_accumulate(
                pe, scale, out=summed), reps=reps[0], warmup=reps[1]),
            "zero_padding": cuda_ms(lambda: flatbuf.zero_padding(
                layout, summed), reps=reps[0], warmup=reps[1]),
            "unpack": cuda_ms(lambda: flatbuf.unpack(layout, summed),
                              reps=reps[0], warmup=reps[1]),
            "sqrt": cuda_ms(lambda: torch.sqrt(total), reps=reps[0],
                            warmup=reps[1])},
        "bound_ms": bms, "bound_by": by,
        "at": f"{name}: B={B}, {L} leaves ({n} columns), fp32"}
    del pe, cols
    torch.cuda.empty_cache()
    return row


def tree_phase(dev, sass: str) -> tuple:
    """Phase 22: the tree kernels on every cell of :func:`tree_layouts`
    (:func:`check_zsmask_buffer`, :func:`check_sumsq_tree`), their SASS
    counts a normal (live, logged; the bound uses ZSMASK_OPS, pinned) and
    launch configurations; then the per-leaf kernels on the APIs that keep
    them: ``pairwise_mask_tree(impl="perleaf")`` over qwen2.5-3b's tree at
    12 layers (a ``zsmask`` a tensor, bit-equal to the tree kernel's
    pass) and ``sumsq`` a leaf of its (4, P) buffer. Returns ``(record,
    the two rows of the kernels line, launches of the per-leaf kernels on
    those APIs)``."""
    from repro_torch.core import flatbuf, masking, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.kernels.zsmask.zsmask import buffer_config

    t0 = time.perf_counter()
    keys = step_keys(prng.PRNGKey(1), 0)
    prev = step_keys(prng.PRNGKey(1), 1).key_xi
    live = {p: stream_ops(sass, r) for p, r in TREE_SASS.items()}
    live.update({f"bf16_{int(p)}": stream_ops(sass, r)
                 for p, r in TREE_SASS_BF16.items()})
    live["zsmask"] = live_stream_ops(sass, "zsmask_kernel")
    pinned = ZSMASK_OPS
    configs = {p: buffer_config(p) for p in (False, True)}
    configs.update({f"bf16_{int(p)}": buffer_config(p, bf16=True)
                    for p in (False, True)})
    log(f"[tree] SASS a normal, live (a report; the bound uses zsmask's, "
        f"pinned: {json.dumps(pinned)}): "
        f"{json.dumps({str(k): v for k, v in live.items()})} | zsmask_buffer "
        f"launch configuration "
        f"{json.dumps({str(k): v for k, v in configs.items()})}")
    layouts = tree_layouts()
    zs, sq = {}, {}
    for name, layout in layouts.items():
        zs[name] = check_zsmask_buffer(dev, name, layout, pinned, keys, prev)
        for use_prev, r in zs[name].items():
            log(f"[tree] zsmask_buffer {name} prev {int(use_prev)}: bit-equal "
                f"to {r['launches_tree_vs_per_leaf'][1]} per-leaf launches "
                f"and the plain version | call {r['ms']:.4f} ms, card "
                f"{r['device_ms']:.4f} ms | per-leaf call "
                f"{r['per_leaf_ms']:.4f}, card {r['per_leaf_device_ms']:.4f}"
                f" ms | bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | "
                f"{r['at']}")
    # the bf16 instantiations at the same layouts made bf16 (route B's):
    # both at CNN6's and WRN28's, at qwen2.5-3b's the corrected one, which
    # every main path runs (lambda 0.7; the uncorrected one is its subset)
    t_bf16 = time.perf_counter()
    zs16 = {}
    for name, layout in layouts.items():
        zs16[name] = check_zsmask_buffer_bf16(
            dev, name, layout, pinned, keys, prev,
            (True,) if name == "qwen12" else (False, True))
        for use_prev, r in zs16[name].items():
            log(f"[tree] zsmask_buffer bf16 {name} prev {int(use_prev)}: "
                f"bit-equal to the plain version, two launches bit-equal | "
                f"call {r['ms']:.4f} ms, card {r['device_ms']:.4f} ms | "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | "
                f"registers {r['config']['registers']} | {r['at']}")
    bf16_s = time.perf_counter() - t_bf16
    log(f"[tree] the bf16 instantiations took {bf16_s:.1f} s of phase 22")
    for name, B in (("wrn28", CIFAR_PE), ("qwen12", 4)):
        sq[name] = r = check_sumsq_tree(dev, name, layouts[name], B)
        log(f"[tree] per_example_sumsq_tree {name}: bit-equal to "
            f"{r['launches_tree_vs_per_leaf'][1]} per-leaf launches, "
            f"{r['max_rel_err']:.3g} rel of the plain version | call "
            f"{r['ms']:.4f} ms, card {r['device_ms']:.4f} ms | per-leaf call "
            f"{r['per_leaf_ms']:.4f}, card {r['per_leaf_device_ms']:.4f} ms |"
            f" vector_norm per leaf {r['library_per_leaf_ms']:.4f} ms, whole "
            f"buffer {r['library_ms']:.4f} ms | clip route call "
            f"{r['route_ms']:.4f} ms, card {r['route_device_ms']:.4f} ms, "
            f"its parts' calls (ms) {json.dumps(r['route_parts_ms'])} | "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | {r['at']}")
    # the per-leaf kernels where they stay: the tree-level pairwise mask's
    # perleaf route and the tensor-level sumsq, counts zeroed just before
    layout = layouts["qwen12"]
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=dev)
    sigma_c = f32(0.3) * f32(4.0)
    b = f32(8.0) * sigma_c
    g = torch.randn(layout.total, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(24))
    flatbuf.zero_padding(layout, g)
    dispatch.reset_launches()
    masked = masking.pairwise_mask_tree(flatbuf.unpack(layout, g),
                                        keys.key_r, keys.key_xi, 1, 4,
                                        sigma_c, b, impl="perleaf")
    torch.cuda.synchronize()
    n_zs = dispatch.launch_counts()["zsmask"]
    masked = flatbuf.pack(layout, masked)
    masking.mask_buffer(g, layout, keys.key_r, keys.key_xi, 1, 4, sigma_c, b)
    check(n_zs == len(flatbuf.leaf_table(layout))
          and torch.equal(masked.view(torch.int32), g.view(torch.int32)),
          f"pairwise_mask_tree perleaf: {n_zs} zsmask launches, or it "
          f"differs from zsmask_buffer")
    del masked, g
    pe = torch.randn(4, layout.total, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(25))
    dispatch.reset_launches()
    for c in leaf_columns(pe, layout):
        clip_ops.sumsq(c)
    torch.cuda.synchronize()
    n_sq = dispatch.launch_counts()["per_example_sumsq"]
    del pe
    torch.cuda.empty_cache()
    per_leaf = {"zsmask": n_zs, "per_example_sumsq": n_sq}
    log(f"[tree] the per-leaf kernels on the APIs that keep them: "
        f"pairwise_mask_tree(impl='perleaf') over qwen2.5-3b's 147 tensors "
        f"{n_zs} zsmask (bit-equal to one zsmask_buffer), sumsq a leaf of its "
        f"(4, P) buffer {n_sq} per_example_sumsq")
    main_zs = zs["qwen12"][True]
    main_zs.update({"prev0": zs["qwen12"][False]})
    for name in ("cnn6", "wrn28"):
        main_zs[name] = zs[name][True]
        main_zs[f"{name}_prev0"] = zs[name][False]
    # the bf16 instantiations' sub-rows: launches on a main path are phase
    # 27's (--bf16families), none in this run
    main_zs["bf16"] = dict(zs16["qwen12"][True], launches=0)
    main_zs["bf16_prev0"] = dict(zs16["wrn28"][False], launches=0)
    main_sq = dict(sq["qwen12"])
    main_sq["pe16"] = sq["wrn28"]
    rec = {"sass_live": {str(k): v for k, v in live.items()},
           "sass_pinned": pinned,
           "configs": {str(k): v for k, v in configs.items()},
           "zsmask_buffer_bf16": {name: {str(int(p)): r for p, r in
                                         rows.items()}
                                  for name, rows in zs16.items()},
           "bf16_s": bf16_s,
           "per_leaf_launches_on_their_apis": per_leaf,
           "phase_s": time.perf_counter() - t0}
    log(f"[tree] phase 22 in {rec['phase_s']:.1f} s")
    return rec, {"zsmask_buffer": main_zs,
                 "per_example_sumsq_tree": main_sq}, per_leaf


def one_phase(phase: str, src: Path) -> int:
    """``--scans`` / ``--pool`` / ``--wire`` / ``--bwd`` / ``--streams`` /
    ``--slice15`` / ``--persist`` / ``--cifar`` / ``--prng`` /
    ``--normal`` / ``--tree``: the card, the build and phase 11's scans,
    phase 3's page-pool events, phase 16's wire tier, phase 17's backward
    kernels, the wire tier's stream kernels (:func:`streams_phase`), phase
    18 (:func:`slice15_phase`), phase 19 (:func:`persist_phase`), phase 20
    (:func:`cifar_phase`), the scan tier's noise stage on WRN28
    (:func:`prng_phase`; no build for a tree without the normal kernels),
    phase 21 (:func:`normal_phase`, after WRN28's noise stage with its
    launches), phase 22 (:func:`tree_phase`), phase 23 (:func:`bf16_phase`),
    phase 24 (:func:`families_phase`), phase 25 (``--bf16train``,
    :func:`bf16train_phase`), phase 3's flash training rows and phase 26
    (``--flashtrain``, :func:`flashtrain_phase`) or phase 27
    (``--bf16families``, :func:`bf16families_phase`) or phase 28
    (``--longctx``, :func:`longctx_phase`) or phase 29 (``--moespec``,
    :func:`moespec_phase`) alone, from the
    ``repro_torch`` under ``src``
    (another tree's, to time two trees in one call); the last line is their
    JSON record."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    card = card_line()
    log(card)
    # a tree from before the normal kernels draws --prng in plain torch
    if phase != "prng" or (src / "repro_torch/kernels/prng").is_dir():
        build_s = _build.build()
        log(f"[build] {_build.library_path()} in {build_s:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if phase == "scans":
        record = check_scans(dev, 11)
    elif phase == "pool":
        record = pool_events(get_config("qwen2.5-3b"), dev, 0)
        log_pool_events(record)
    elif phase == "bwd":
        record = check_scan_backward(dev, 17)
    elif phase == "streams":
        record = streams_phase(dev, src)
    elif phase == "slice15":
        record, rows = slice15_phase(dev)
        record["rows"] = rows
    elif phase == "persist":
        record = persist_phase(dev)
    elif phase == "cifar":
        record, rows = cifar_phase(dev)
        record["rows"] = rows
    elif phase == "prng":
        record = prng_phase(dev)
    elif phase == "normal":
        wrn = wrn_noise_stage(dev)
        record, rows = normal_phase(dev, library_sass())
        record.update(rows=rows, prng_scan_noise_wrn28=wrn)
    elif phase == "tree":
        record, rows, per_leaf = tree_phase(dev, library_sass())
        record["rows"] = rows
    elif phase == "bf16":
        record, rows = bf16_phase(dev)
        record["rows"] = rows
    elif phase == "families":
        record, rows = families_phase(dev)
        record["rows"] = rows
    elif phase == "bf16train":
        record = bf16train_phase(dev)
    elif phase == "bf16families":
        record = bf16families_phase(dev)
    elif phase == "longctx":
        record = longctx_phase(dev, src)
    elif phase == "moespec":
        record, rows = moespec_phase(dev, card)
        record["rows"] = rows
    elif phase == "flashtrain":
        import torch.nn.functional as F
        record = {"rows": flash_train_rows(dev, F)}
        record.update(flashtrain_phase(dev))
    else:
        log(f"[kernel] clip_mask SASS, live (a report; the bound uses "
            f"{json.dumps(CLIP_MASK_OPS)}): "
            f"{json.dumps(stream_ops(library_sass(), ROW8_SASS))}")
        record, row, rows = wire_phase(dev, CLIP_MASK_OPS, src)
        record["clip_mask_wire"] = row
        record["stream_kernels"] = rows
    log(json.dumps({"src": str(src), "card": card, phase: record}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def timed(fn):
    """(result, host seconds) of ``fn()``, the card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve_family(Session, arch, kernels, per_prefill, reqs, log_name):
    """One full-width family through ``Session.serve``: direct (batch 4,
    prompt 32, 16 new) and wave (``reqs`` through 4 slots), the launch
    counts zeroed just before each and read just after, plus one timed
    whole-prompt prefill (batch 4 x 32: the wave scheduler's scan path).
    ``per_prefill`` is each kernel's launches a whole-prompt prefill;
    ``kernels`` the direct mode's launches (the ssm family prefills
    recurrently there, so none). Continuous batching must raise."""
    from repro_torch.kernels import dispatch

    sess = Session.from_config(arch, full=True, seed=0)
    cfg, V = sess.cfg, sess.cfg.vocab_size
    params, init_s = timed(sess.init_params)
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[{log_name}] {arch} full width ({cfg.n_layers} layers): "
        f"{n_params / 1e9:.3f} B fp32 params ({n_params * 4 / 1e9:.2f} GB) "
        f"on the card in {init_s:.1f} s")
    sess.serve(batch_size=4, prompt_len=8, max_new_tokens=2, params=params)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    direct = sess.serve(batch_size=4, prompt_len=32, max_new_tokens=16,
                        params=params)
    n_direct = dispatch.launch_counts()
    check(direct.tokens.shape == (4, 16)
          and bool(((direct.tokens >= 0) & (direct.tokens < V)).all()),
          f"{arch} direct tokens")
    check(tuple(direct.logits.shape) == (4, V)
          and bool(torch.isfinite(direct.logits).all()),
          f"{arch} direct logits")
    check(n_direct == {k: kernels.get(k, 0) for k in n_direct},
          f"{arch} direct launches {n_direct}, expected {kernels}")
    prompt = torch.randint(0, V, (4, 32), generator=torch.Generator(
        ).manual_seed(5)).to(sess.device)
    cache = sess.model.init_cache(4, 48)
    dispatch.reset_launches()
    with torch.inference_mode():
        logits, scan_s = timed(lambda: sess.model.prefill(params, prompt,
                                                          cache))
    n_scan = dispatch.launch_counts()
    check(n_scan == {k: per_prefill.get(k, 0) for k in n_scan},
          f"{arch} whole-prompt prefill launches {n_scan}, expected "
          f"{per_prefill}")
    check(bool(torch.isfinite(logits).all()), f"{arch} prefill logits")
    del cache, logits
    dispatch.reset_launches()
    wave = sess.serve(scheduler="wave", requests=copy.deepcopy(reqs),
                      params=params, max_batch=4, max_len=512)
    n_wave = dispatch.launch_counts()
    check(wave.stats.drained and len(wave.stats.latencies) == len(reqs),
          f"{arch} wave did not drain")
    want = {k: v * wave.stats.waves for k, v in per_prefill.items()}
    check(n_wave == {k: want.get(k, 0) for k in n_wave},
          f"{arch} wave launches {n_wave} for {wave.stats.waves} waves, "
          f"expected {want}")
    peak = torch.cuda.max_memory_allocated()
    try:
        sess.serve(scheduler="continuous", batch_size=2, prompt_len=4,
                   max_new_tokens=2, params=params)
        raised = ""
    except ValueError as e:
        raised = str(e)
    check("no paged serving path" in raised,
          f"{arch}: continuous batching did not refuse ({raised!r})")
    st = wave.stats
    out = {
        "config": f"{arch} published width, {cfg.n_layers} layers, fp32",
        "n_params": n_params, "init_s": init_s,
        "direct": {"prefill_ms": direct.prefill_s * 1e3,
                   "decode_ms_per_token": direct.decode_s_per_token * 1e3,
                   "decode_tok_per_s": 4 / direct.decode_s_per_token,
                   "launches": n_direct},
        "scan_prefill": {"ms": scan_s * 1e3, "batch": 4, "prompt": 32,
                         "launches": n_scan},
        "wave": {"useful_tokens": st.useful_tokens,
                 "tok_per_s": 1 / wave.decode_s_per_token,
                 "waves": st.waves, "utilization": st.utilization,
                 "p50_latency_steps": st.p50_latency_steps,
                 "p99_latency_steps": st.p99_latency_steps,
                 "decode_steps": st.decode_steps, "launches": n_wave},
        "peak_mem_gb": peak / 1e9}
    log(f"[{log_name}] direct batch 4, prompt 32, 16 new: prefill "
        f"{direct.prefill_s * 1e3:.2f} ms | decode "
        f"{direct.decode_s_per_token * 1e3:.2f} ms/token step | "
        f"{4 / direct.decode_s_per_token:.1f} tok/s | launches "
        f"{ {k: v for k, v in n_direct.items() if v} }")
    log(f"[{log_name}] whole-prompt prefill, batch 4 x 32: {scan_s * 1e3:.2f}"
        f" ms | launches { {k: v for k, v in n_scan.items() if v} }")
    log(f"[{log_name}] wave: {len(reqs)} requests, 4 slots, {st.waves} "
        f"waves: {st.useful_tokens} tokens at {1 / wave.decode_s_per_token:.1f}"
        f" tok/s | utilization {st.utilization:.3f} | p50 "
        f"{st.p50_latency_steps} p99 {st.p99_latency_steps} steps | launches "
        f"{ {k: v for k, v in n_wave.items() if v} } | peak "
        f"{peak / 1e9:.2f} GB | continuous refused")
    return out


def family_cross_device(Session, cfg, reqs, log_name):
    """A narrow config of one family (the kernels' widths) on the card and
    on the host CPU from the same weights: the logits after a whole-prompt
    prefill and after 3 decode steps agree within CROSS_ATOL / CROSS_RTOL,
    and a wave serve gives the same greedy tokens."""
    from repro_torch.kernels import dispatch

    on = {d: Session.from_config(cfg, device=d, seed=7)
          for d in ("cuda", "cpu")}
    p_cpu = on["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to(on["cuda"].device)
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    steps = [torch.randint(0, cfg.vocab_size, (2, 1), generator=g)
             for _ in range(3)]
    logits, launches = {}, {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        m = on[d].model
        dispatch.reset_launches()
        with torch.inference_mode():
            cache = m.init_cache(2, 32)
            out = [m.prefill(p, prompt.to(m.device), cache)]
            out += [m.decode_step(p, t.to(m.device), cache) for t in steps]
        launches[d] = {k: v for k, v in dispatch.launch_counts().items() if v}
        logits[d] = [o.float().cpu() for o in out]
    err = max((a - b).abs().max().item()
              for a, b in zip(logits["cuda"], logits["cpu"]))
    top = max(b.abs().max().item() for b in logits["cpu"])
    check(all(torch.allclose(a, b, atol=CROSS_ATOL, rtol=CROSS_RTOL)
              for a, b in zip(logits["cuda"], logits["cpu"])),
          f"{cfg.name} card vs CPU logits differ by {err} (|logit| up to "
          f"{top})")
    check(not launches["cpu"] and launches["cuda"],
          f"{cfg.name} launches: card {launches['cuda']}, CPU "
          f"{launches['cpu']}")
    toks = {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        res = on[d].serve(scheduler="wave", requests=copy.deepcopy(reqs),
                          params=p, max_batch=2, max_len=64)
        toks[d] = res.tokens
    check(bool((toks["cuda"] == toks["cpu"]).all()),
          f"{cfg.name} wave tokens differ between card and CPU")
    log(f"[{log_name}] {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}), card vs CPU: prefill + 3 decode steps max |logit "
        f"diff| {err:.3g} (|logit| up to {top:.3g}; atol {CROSS_ATOL}, rtol "
        f"{CROSS_RTOL}) | card launches {launches['cuda']} | wave tokens "
        f"equal ({int((toks['cpu'] >= 0).sum())})")
    return {"max_abs_err": err, "max_abs_logit": top, "atol": CROSS_ATOL,
            "rtol": CROSS_RTOL, "card_launches": launches["cuda"],
            "wave_tokens_equal": int((toks["cpu"] >= 0).sum())}


# --------------------------------------------------------------- phase 17
# the scans' backward at the training shapes: one silo's share of a 16 x 64
# batch over 4 silos; (B, S, H, N) of rwkv6-7b, (B, S, nh, P, N) of zamba2-7b
WKV_TRAIN = (4, 64, 64, 64)
SSD_TRAIN = (4, 64, 112, 64, 64)
# each backward kernel's gradients against its plain reverse scan: within
# this share of the gradient's largest |value| (at least 1), the forward
# scans' bounds; fp32 sums in other orders, and the kernel's fused
# multiply-adds
BWD_REL, BWD_STRONG_REL = 2e-5, 1e-4
WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "dstate0")
SSD_GRADS = ("dxh", "ddt", "dla", "dBc", "dCc", "dh0")
# the training cells' depth cut to fit one card's 80 GB with 7 fp32 copies
# of P (PERF.md section 4): rwkv6-7b 4 of 32 layers (P about 1.42 B),
# zamba2-7b 12 of 81 (P about 1.37 B, two calls of the shared block)
SSM_TRAIN_LAYERS = {"rwkv6-7b": 4, "zamba2-7b": 12}
# the narrow training slices, card vs CPU after 2 fused steps and after 1
# barrier step: AdamW moves each weight by about lr a step whatever |g|,
# so a weight differs only where g sits within rounding of 0 and flips
# sign (up to 2 lr a step); the share of such weights allowed
SSM_FLIP_SHARE = 1e-4


def bwd_case(fn, plain, xs, cot, names, rel) -> dict:
    """One backward kernel call against its plain version: each gradient's
    max |difference| and tolerance, and two launches bit-identical."""
    got, again = fn(*xs, *cot), fn(*xs, *cot)
    want = plain(*xs, *cot)
    torch.cuda.synchronize()
    errs, tols = {}, {}
    for name, a, b in zip(names, got, want):
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite")
        errs[name] = (a - b).abs().max().item()
        tols[name] = rel * max(1.0, b.abs().max().item())
        check(errs[name] <= tols[name],
              f"{name} differs from its plain version by {errs[name]} "
              f"(tolerance {tols[name]})")
    identical = all(torch.equal(a, b) for a, b in zip(got, again))
    check(identical, f"two launches of {fn.__name__} differ")
    return {"max_abs_err": max(errs.values()), "errs": errs, "tols": tols,
            "bit_identical": identical}


def check_wkv_bwd(dev, gen, fn, ref) -> dict:
    """``wkv_bwd`` against ``ref.wkv_backward_ref`` at rwkv6-7b's training
    shape, at S 61 (a ragged last chunk), S 512 and under strong decay (w
    near 0.02), each with an incoming state ~ 0.1 N(0, 1) and dstate ~ 0.1
    N(0, 1) (do ~ N(0, 1)); timed at the main shape and S 512."""
    B, S, H, N = WKV_TRAIN
    cases, out = {}, {}
    for name, S_, w, rel in (("main", S, None, BWD_REL),
                             ("s61", 61, None, BWD_REL),
                             ("s512", 512, None, BWD_REL),
                             ("strong decay", S, 0.02, BWD_STRONG_REL)):
        xs = wkv_inputs(dev, gen, B, S_, H, N, w)
        cot = (torch.randn(B, S_, H, N, device=dev, generator=gen),
               torch.randn(B, H, N, N, device=dev, generator=gen) * 0.1)
        cases[name] = {"S": S_, **bwd_case(fn, ref.wkv_backward_ref, xs, cot,
                                            WKV_GRADS, rel)}
        if name in ("main", "s512"):
            r, u, s0 = xs[0], xs[4], xs[5]
            out[name] = scan_timing(
                lambda: fn(*xs, *cot),
                lambda: ref.wkv_backward_ref(*xs, *cot),
                *work().wkv_bwd_work(r, u, s0),
                f"B={B} S={S_} H={H} N={N} fp32, with a state and dstate",
                graph_n=20, plain_reps=3)
            out[name]["max_abs_err"] = cases[name]["max_abs_err"]
        del xs, cot
    return {**out["main"], "s512": out["s512"], "cases": cases,
            "tolerance": f"{BWD_REL} of each gradient's largest |value| "
                         f"({BWD_STRONG_REL} under strong decay)",
            "library_ms": None,
            "library_call": "none (no single PyTorch call computes the "
                            "scan's backward)"}


def check_ssd_bwd(dev, gen, fn, ref) -> dict:
    """``ssd_bwd`` against ``ref.ssd_backward_ref`` at zamba2-7b's training
    shape, at S 61, S 512 and under strong decay (la near -16, a_t about
    1e-7), each with an incoming state and dh ~ 0.1 N(0, 1) (dy ~ N(0, 1));
    timed at the main shape and S 512."""
    B, S, nh, P, N = SSD_TRAIN
    cases, out = {}, {}
    for name, S_, strong, rel in (("main", S, False, BWD_REL),
                                  ("s61", 61, False, BWD_REL),
                                  ("s512", 512, False, BWD_REL),
                                  ("strong decay", S, True, BWD_STRONG_REL)):
        xs = list(ssd_inputs(dev, gen, B, S_, nh, P, N))
        if strong:
            xs[2] = xs[2] - 16.0
        cot = (torch.randn(B, S_, nh, P, device=dev, generator=gen),
               torch.randn(B, nh, P, N, device=dev, generator=gen) * 0.1)
        cases[name] = {"S": S_, **bwd_case(fn, ref.ssd_backward_ref, xs, cot,
                                            SSD_GRADS, rel)}
        if name in ("main", "s512"):
            x, dt, Bc, h0 = xs[0], xs[1], xs[3], xs[5]
            out[name] = scan_timing(
                lambda: fn(*xs, *cot),
                lambda: ref.ssd_backward_ref(*xs, *cot),
                *work().ssd_bwd_work(x, dt, Bc, h0),
                f"B={B} S={S_} nh={nh} P={P} N={N} fp32, with a state and dh",
                graph_n=20, plain_reps=3)
            out[name]["max_abs_err"] = cases[name]["max_abs_err"]
        del xs, cot
    return {**out["main"], "s512": out["s512"], "cases": cases,
            "tolerance": f"{BWD_REL} of each gradient's largest |value| "
                         f"({BWD_STRONG_REL} under strong decay)",
            "library_ms": None,
            "library_call": "none (no single PyTorch call computes the "
                            "scan's backward)"}


def log_bwd(name: str, r: dict) -> None:
    cases = {k: {x: c[x] for x in ("S", "max_abs_err", "bit_identical")}
             for k, c in r["cases"].items()}
    log(f"[kernel] {name}: max_abs_err {r['max_abs_err']:.3g} (cases "
        f"{json.dumps(cases)}) | kernel {r['ms']:.4f} ms (on the card "
        f"{r['device_ms']:.4f}) | plain {r['plain_ms']:.4f} ms | library "
        f"none | bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | {r['at']}")
    x = r["s512"]
    log(f"[kernel] {name} S 512: max_abs_err {x['max_abs_err']:.3g} | kernel "
        f"{x['ms']:.4f} ms (on the card {x['device_ms']:.4f}) | plain "
        f"{x['plain_ms']:.4f} ms | bound {x['bound_ms']:.4f} ms "
        f"({x['bound_by']}) | {x['at']}")


def bwd_configs() -> dict:
    """Each backward kernel's launch configuration at the training shapes,
    as the built library of the ``repro_torch`` first on ``sys.path``
    reports it, and the checkpoint scratch a call allocates at the main
    shape and at S 512: a configuration, not a measurement. Empty for an
    older tree, whose library does not report it."""
    from repro_torch.kernels.mamba2 import mamba2
    from repro_torch.kernels.rwkv6 import rwkv6
    if not hasattr(rwkv6, "bwd_config"):
        return {}
    B, S, H, N = WKV_TRAIN
    Bs, Ss, nh, P, Ns = SSD_TRAIN
    out = {"wkv_bwd": {"blocks": B * H, **rwkv6.bwd_config(N)},
           "ssd_bwd": {"blocks": Bs * nh, **mamba2.bwd_config(P, Ns)}}
    for S_ in (S, 512):
        out["wkv_bwd"][f"scratch_bytes_s{S_}"] = \
            4 * rwkv6.bwd_scratch_floats(B, S_, H, N)
        out["ssd_bwd"][f"scratch_bytes_s{S_}"] = \
            4 * mamba2.bwd_scratch_floats(Bs, S_, nh, P, Ns)
    return out


def check_scan_backward(dev, seed: int) -> dict:
    """Phase 17(a): both backward kernels, from the ``repro_torch`` first
    on ``sys.path``, each logged with its launch configuration."""
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    from repro_torch.kernels.mamba2.mamba2 import ssd_bwd_cuda
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.kernels.rwkv6.rwkv6 import wkv_bwd_cuda

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"wkv_bwd": check_wkv_bwd(dev, gen, wkv_bwd_cuda, wkv_ref),
           "ssd_bwd": check_ssd_bwd(dev, gen, ssd_bwd_cuda, ssd_ref)}
    torch.cuda.empty_cache()
    configs = bwd_configs()
    for name, r in out.items():
        log_bwd(name, r)
        if name in configs:
            r["config"] = configs[name]
            log(f"[kernel] {name} launch (the library's configuration, not "
                f"measured): {json.dumps(configs[name])}")
    return out


ROUTE_LABELS = {"fp32": "fp32",
                "A": "bf16 compute over fp32 weights (route A)",
                "B": "bf16 weights over an fp32 master (route B)"}


def route_session(Session, cfg, route: str, **kw):
    """A session of ``cfg`` under ``route``: ``fp32``; ``A``, bf16 compute
    over fp32 weights (``compute_dtype``); ``B``, bf16 weights over an fp32
    master (``build_model(param_dtype=bf16, compute_dtype=bf16)`` in the
    session, ``from_config`` having set the card's matmul flags)."""
    from repro_torch.models.registry import build_model

    sess = Session.from_config(cfg, compute_dtype=torch.float32
                               if route == "fp32" else torch.bfloat16, **kw)
    if route == "B":
        sess = dataclasses.replace(sess, model=build_model(
            sess.cfg, sess.device, param_dtype=torch.bfloat16,
            compute_dtype=torch.bfloat16))
    return sess


def weights_are_rounded_master(state, chunk: int = 1 << 26) -> bool:
    """Route (B)'s invariant: the bf16 weights are the fp32 master rounded
    to nearest even, bit for bit, over the bf16 leaves' ranges (a mixed
    tree's fp32 leaves are the master's own views; a chunk at a time)."""
    from repro_torch.core import flatbuf
    w, m = state.weights, state.opt_state["master"]
    return all(torch.equal(bits(w[i:min(i + chunk, z)]),
                           bits(m[i:min(i + chunk, z)].to(torch.bfloat16)))
               for a, z in flatbuf.dtype_runs(state.layout, "bfloat16")
               for i in range(a, z, chunk))


def train_cell(Session, cfg, priv, opt, mesh, steps: int, want: dict,
               log_name: str, next_batch=None, route: str = "fp32",
               silo_schedule=None, batch: int = 16, seq_len: int = 64,
               use_flash=None, make_session=None) -> dict:
    """One training cell through ``Session.train``: ``steps`` steps at
    ``batch x seq_len`` (synthetic tokens, or ``next_batch``'s batches)
    from random weights (seed 0) under ``route`` (:func:`route_session`;
    with ``use_flash`` True or False, :func:`flash_session`), the
    launch counts zeroed just before and read just after and equal to
    ``want`` a step (a count given as a function takes the cell's layout;
    as a list, one count a step), nothing else, and no plain per-leaf draw
    on the card; ``make_session(**kw)`` builds the session instead, when
    given. ``silo_schedule`` pins each step's participation set.
    Losses finite, epsilon rising, the weights moved (under route B, the
    bf16 weights the rounded master); step and stage times and peak
    memory."""
    from repro_torch.kernels import dispatch

    kw = dict(privacy=priv, optimizer=opt, mesh=mesh, seed=0)
    if make_session is not None:
        sess = make_session(**kw)
    elif use_flash is None:
        sess = route_session(Session, cfg, route, **kw)
    else:
        sess = flash_session(Session, cfg, route, use_flash, **kw)
    state, init_s = timed(sess.init_state)
    P = state.layout.total
    master = state.opt_state["master"]
    probe = torch.arange(0, P, max(1, P // (1 << 20)), device=master.device)
    before = master[probe].clone()
    torch.cuda.reset_peak_memory_stats()
    spy: dict = {}
    dispatch.reset_launches()
    with plain_draw_spy(spy):
        res = sess.train(steps=steps, batch_size=batch, seq_len=seq_len,
                         state=state, log_every=1, next_batch=next_batch,
                         silo_schedule=silo_schedule)
    n = {k: v for k, v in dispatch.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    moved = (master[probe] - before).abs().max().item()
    losses = [m["loss"] for m in res.metrics]
    eps = [m["epsilon"] for m in res.metrics]
    want = {k: sum(v) if isinstance(v, list) else
            (v(state.layout) if callable(v) else v) * steps
            for k, v in want.items()}
    check(spy["plain_draws_on_card"] == 0, f"{log_name} {cfg.name}: "
          f"{spy['plain_draws_on_card']} plain draws on the card")
    check(res.step == steps and all(math.isfinite(x) for x in losses),
          f"{log_name} {cfg.name}: {res.step} steps, losses {losses}")
    check(all(b > a for a, b in zip([0.0] + eps, eps)),
          f"{log_name} {cfg.name}: epsilon does not rise: {eps}")
    check(moved > 0, f"{log_name} {cfg.name}: the weights did not move")
    check(n == want, f"{log_name} {cfg.name} launches {n}, expected {want}")
    if route == "B":
        check(weights_are_rounded_master(res.state),
              f"{log_name} {cfg.name}: the bf16 weights are not the "
              f"rounded master")
    step_ms = [m["step_time_s"] * 1e3 for m in res.metrics]
    stages = {k: [st.get(k, 0.0) for st in res.trainer.stage_log]
              for k in res.trainer.stage_log[0]}
    out = {"config": f"{cfg.name}, n_layers {cfg.n_layers} (d_model "
                     f"{cfg.d_model}, vocab {cfg.vocab_size}), "
                     f"{ROUTE_LABELS[route]}",
           "P": P, "n_params": state.layout.n_params, "init_s": init_s,
           "steps": steps, "batch": batch, "seq_len": seq_len,
           "loss": losses,
           "clip_bound": [m["clip_bound"] for m in res.metrics],
           "epsilon": eps, "step_ms": step_ms, "stage_ms": stages,
           "peak_mem_gb": peak / 1e9, "launches": n,
           "weights_moved_max": moved}
    log(f"[{log_name}] {cfg.name} at {cfg.n_layers} layers, "
        f"{ROUTE_LABELS[route]}, P {P} "
        f"({state.layout.n_params} parameters, in {init_s:.1f} s), {steps} "
        f"steps of {batch} x {seq_len} over "
        f"{sess.run_cfg.privacy.n_silos or 4} silos: loss "
        f"{[round(x, 4) for x in losses]} | epsilon "
        f"{[round(e, 3) for e in eps]} | step ms "
        f"{[round(t, 1) for t in step_ms]} | peak {peak / 1e9:.2f} GB | "
        f"launches {n}")
    log(f"[{log_name}] stage ms per step: " + " | ".join(
        f"{k} {[round(t, 2) for t in v]}" for k, v in stages.items()))
    del res, state, sess, master, before
    torch.cuda.empty_cache()
    return out


def ssm_train_cross_device(Session, cfg, priv, priv_b, opt, mesh, scan: str,
                           log_name: str) -> dict:
    """A narrow config of one family on the card (kernels) and on the host
    CPU (plain versions) from the same weights: 2 fused steps, then 1
    barrier step with silo 2 out. Losses and bounds within TRAIN_RTOL,
    epsilon and the carried key equal, the weights within 2 lr a step of
    each other and beyond PARAM_ATOL on at most SSM_FLIP_SHARE of them."""
    from repro_torch.kernels import dispatch

    out = {}
    for tier, p_cfg, m_cfg, steps, sched in (
            ("fused", priv, None, 2, None),
            ("barrier", priv_b, mesh, 1, lambda t: [True, True, False, True])):
        on = {d: Session.from_config(cfg, privacy=p_cfg, optimizer=opt,
                                     mesh=m_cfg, seed=5, device=d)
              for d in ("cuda", "cpu")}
        p_cpu = on["cpu"].init_params()
        p_gpu = copy.deepcopy(p_cpu).to("cuda")
        res, launches = {}, {}
        for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
            dispatch.reset_launches()
            res[d] = on[d].train(steps=steps, batch_size=8, seq_len=32,
                                 log_every=0, silo_schedule=sched,
                                 state=on[d].init_state(params=p))
            launches[d] = {k: v for k, v in dispatch.launch_counts().items()
                           if v}
        a, b = res["cuda"], res["cpu"]
        check(not launches["cpu"] and launches["cuda"].get(scan + "_bwd")
              == launches["cuda"].get(scan) == 4 * cfg.n_layers * steps,
              f"{cfg.name} {tier} launches: card {launches['cuda']}, CPU "
              f"{launches['cpu']}")
        for ma, mb in zip(a.metrics, b.metrics):
            check(ma["epsilon"] == mb["epsilon"],
                  f"{cfg.name} {tier}: epsilon {ma['epsilon']} vs "
                  f"{mb['epsilon']}")
            for k in ("loss", "clip_bound"):
                check(math.isclose(ma[k], mb[k], rel_tol=TRAIN_RTOL),
                      f"{cfg.name} {tier} {k}: card {ma[k]} vs CPU {mb[k]}")
        check(a.state.noise_state.prev_key == b.state.noise_state.prev_key,
              f"{cfg.name} {tier}: the carried noise key differs")
        dp = (a.state.opt_state["master"].cpu()
              - b.state.opt_state["master"]).abs()
        flips = int((dp > PARAM_ATOL).sum())
        P = dp.numel()
        check(dp.max().item() <= 2 * opt.lr * steps * 1.001
              and flips <= SSM_FLIP_SHARE * P,
              f"{cfg.name} {tier}: params differ by up to {dp.max().item()}"
              f", {flips} of {P} beyond {PARAM_ATOL}")
        out[tier] = {"P": P, "steps": steps,
                     "loss": [[m["loss"] for m in x.metrics] for x in (a, b)],
                     "param_max_abs_err": dp.max().item(),
                     "param_beyond_atol": flips,
                     "card_launches": launches["cuda"]}
        log(f"[{log_name}] {cfg.name} ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, P {P}) {tier}, {steps} step(s), card vs CPU: "
            f"loss {out[tier]['loss'][0]} / {out[tier]['loss'][1]} | params "
            f"max |diff| {dp.max().item():.3g}, {flips} beyond {PARAM_ATOL} "
            f"| card launches {launches['cuda']} | keys and epsilon equal")
        del on, p_cpu, p_gpu, res, a, b, dp
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 5

def cut_layers(params, cfg_cut, device, Transformer):
    """The first ``cfg_cut.n_layers`` layers of ``params`` (with its
    embedding, final norm and head), copied onto ``device``."""
    out = Transformer(cfg_cut, device)
    keep = {k: v for k, v in params.state_dict().items()
            if not k.startswith("layers.")
            or int(k.split(".")[1]) < cfg_cut.n_layers}
    out.load_state_dict(keep)
    return out


def slice_logits(model, params, PagePool, prompt, steps):
    """Logits of the slice on one device: dense prefill + decode, then a
    paged prefill chunk + decode through a PagePool (reset included). Each
    step feeds the token ids in ``steps`` (the same on every device), so the
    two devices see identical inputs."""
    dev = model.device
    B, S = prompt.shape
    out = []
    with torch.inference_mode():
        cache = model.init_cache(B, S + len(steps))
        out.append(model.prefill(params, prompt.to(dev), cache))
        for t in steps:
            out.append(model.decode_step(params, t.to(dev)[:, None], cache))
        pool = PagePool(model, n_slots=B, n_pages=4 * B, page_size=16,
                        pages_per_slot=4)
        for b in range(B):
            check(pool.alloc(b, 2), "slice pool alloc")
        n_valid = torch.tensor([S - 3 * b for b in range(B)], dtype=torch.int32)
        tables = torch.as_tensor(pool.tables, device=dev)
        lengths = torch.zeros(B, dtype=torch.int32)
        lg, _ = model.paged_step(params, prompt.to(dev), pool.pages, tables,
                                 lengths.to(dev), n_valid.to(dev))
        out.append(lg)
        lengths += n_valid
        for t in steps:
            lg, _ = model.paged_step(params, t.to(dev)[:, None], pool.pages,
                                     tables, lengths.to(dev),
                                     torch.ones(B, dtype=torch.int32,
                                                device=dev))
            out.append(lg)
            lengths += 1
    return [o.float().cpu() for o in out]



# ---------------------------------------------------------------- phase 6

def max_err_by_window(out, plain, P: int) -> float:
    """Max |out - plain(a, b)| over all P columns, the plain version run on
    one window [a, b) of DP_WINDOW columns at a time."""
    err = torch.zeros((), device=out.device)
    for a in range(0, P, DP_WINDOW):
        b = min(a + DP_WINDOW, P)
        err = torch.maximum(err, (out[a:b] - plain(a, b)).abs().max())
    return err.item()


def check_clip_accumulate(dev, gen, n, P, ops, ref):
    g = torch.randn(n, P, device=dev, generator=gen)
    # clip factors as the path makes them, one silo dropped (factor 0)
    scale = torch.tensor([0.731, 1.0, 0.0, 0.418][:n], device=dev)
    out = ops.clip_accumulate(g, scale)
    err = max_err_by_window(
        out, lambda a, b: ref.clip_accumulate_ref(g[:, a:b], scale), P)
    check(err == 0.0, f"clip_accumulate differs from its plain version by "
                      f"{err}")
    w = g[:, :DP_WINDOW]
    bms, by = bound((n + 1) * P * 4, 2 * n * P)
    res = {
        "max_abs_err": err,
        "checked_at": f"all {P} columns, windows of {DP_WINDOW}",
        "ms": cuda_ms(lambda: ops.clip_accumulate(g, scale), reps=5,
                      warmup=1),
        "plain_ms": cuda_ms(lambda: ref.clip_accumulate_ref(w, scale)),
        "plain_at": f"window of {DP_WINDOW} columns",
        "library_ms": cuda_ms(lambda: scale @ g, reps=5, warmup=1),
        "library_call": "scale @ g (cuBLAS)",
        "bound_ms": bms, "bound_by": by,
        "at": f"n={n} P={P} fp32",
    }
    return res, out, g


def check_noise_batch(dev, n, P, g_sum, ops, ref, step_keys, PRNGKey,
                      per_stream):
    keys = step_keys(PRNGKey(1), 0)
    prev = step_keys(PRNGKey(1), 1).key_xi
    # per-silo noise scales and lambda gates as corrected_noise_packed makes
    # them: silo 2 gated off (both 0), silo 1 with a lambda gate of 0
    s = 0.0750
    scales = torch.tensor([s, s, 0.0, s][:n], device=dev)
    lams = torch.tensor([0.7, 0.0, 0.0, 0.7][:n], device=dev)
    out = ops.noise_batch(g_sum, keys.key_xi, prev, scales, lams, s)
    check(bool(torch.isfinite(out).all()), "noise_batch: non-finite")
    err = max_err_by_window(out, lambda a, b: ref.noise_batch_ref(
        g_sum[a:b], keys.key_xi, prev, scales, lams, s, base=a), P)
    check(err == 0.0, f"noise_batch differs from its plain version by {err}")
    del out
    w = g_sum[:DP_WINDOW]
    parts = stream_bound(P, 2 * n, per_stream)  # xi_t, xi_{t-1} of each silo
    bms = max(parts.values())
    return {
        "max_abs_err": err,
        "checked_at": f"all {P} columns, windows of {DP_WINDOW}",
        "ms": cuda_ms(lambda: ops.noise_batch(g_sum, keys.key_xi, prev,
                                              scales, lams, s),
                      reps=3, warmup=1),
        "plain_ms": cuda_ms(lambda: ref.noise_batch_ref(
            w, keys.key_xi, prev, scales, lams, s), reps=5),
        "plain_at": f"window of {DP_WINDOW} columns",
        "library_ms": None,
        "library_call": "none (no PyTorch call draws keyed threefry normals)",
        "bound_ms": bms,
        "bound_by": "bytes" if bms == parts["bytes"] else "operations",
        "bound_detail": {"ms_by_limit": parts, "per_stream": per_stream},
        "at": f"n={n} P={P} use_prev fp32",
    }


def stream_bound(P: int, streams: int, per_stream: dict,
                 words: int = 2) -> dict:
    """Milliseconds by limit for ``streams`` keyed normals an element over P
    elements: bytes (``words`` fp32 words an element, each read or written
    once: g in and the output out by default) and each pipe's share of the
    compiled stream body over its lanes, all of it over issue."""
    parts = {"bytes": words * P * 4 / HBM_BYTES_PER_S * 1e3}
    for pipe, lanes in LANES.items():
        parts[pipe] = (streams * P * per_stream[pipe]
                       / (lanes * SM_OPS_PER_S) * 1e3)
    return parts


def check_clip_mask(dev, P, g, ops, ref, keys, prev, per_stream):
    """Silo 1's contribution at the barrier tier's flags over a partial
    ring (silo 2 dropped, so its next active silo is 3), the scalars as
    ``silo_contribution`` makes them at sigma 0.3 and C 4 with 3 of 4 silos
    active, bit-equal to the plain version over all P columns; the other
    three flag combinations on the first window; timed as a call and on
    the card (2 launches in a CUDA graph, replayed 3 times)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    sc = f32(0.3) * f32(4.0)  # sigma * C
    args = (f32(0.731), keys.key_r, keys.key_xi, prev, 1, 4, sc,
            f32(8.0) * sc, f32(0.7))
    kw = dict(nxt=3, noise_scale=sc / torch.sqrt(f32(3.0)),
              prev_noise_scale=sc / torch.sqrt(f32(4.0)))
    out = ops.clip_mask(g, *args, **kw)
    check(bool(torch.isfinite(out).all()), "clip_mask: non-finite")
    err = max_err_by_window(out, lambda a, b: ref.clip_mask_ref(
        g[a:b], *args, base=a, **kw), P)
    check(err == 0.0, f"clip_mask differs from its plain version by {err}")
    del out
    w = g[:DP_WINDOW]
    flags = {}
    for up, uv in ((True, False), (False, True), (False, False)):
        e = (ops.clip_mask(w, *args, up, uv, **kw)
             - ref.clip_mask_ref(w, *args, up, uv, **kw)).abs().max().item()
        check(e == 0.0, f"clip_mask pairwise={up} prev={uv} differs by {e}")
        flags[f"use_pairwise={up} use_prev={uv}"] = e
    parts = stream_bound(P, 4, per_stream)  # r_i, r_nxt, xi_t, xi_{t-1}
    bms = max(parts.values())
    o = torch.empty_like(g)
    return {
        "max_abs_err": err,
        "checked_at": f"all {P} columns, windows of {DP_WINDOW}; other "
                      f"flags on the first window: {flags}",
        "ms": cuda_ms(lambda: ops.clip_mask(g, *args, **kw), reps=3,
                      warmup=1),
        "device_ms": graph_ms(lambda: ops.clip_mask(g, *args, out=o, **kw),
                              n=2, reps=3),
        "plain_ms": cuda_ms(lambda: ref.clip_mask_ref(w, *args, **kw),
                            reps=5),
        "plain_at": f"window of {DP_WINDOW} columns",
        "library_ms": None,
        "library_call": "none (no PyTorch call draws keyed threefry normals)",
        "bound_ms": bms,
        "bound_by": "bytes" if bms == parts["bytes"] else "operations",
        "bound_detail": {"ms_by_limit": parts, "per_stream": per_stream},
        "at": f"P={P} silo 1 nxt 3 use_pairwise use_prev fp32",
    }


# row 8's kernel in the SASS: clip_mask_kernel<false> (mangled ILb0E), or
# the untemplated clip_mask_kernel of a tree from before the external-stream
# variant; never clip_mask_kernel<true>
ROW8_SASS = r"clip_mask_kernel(ILb0E)?E"


def sass_loops(sass: str, kernel: str) -> list:
    """The innermost loops of ``kernel`` (a regular expression searched in
    the mangled name) in ``cuobjdump -sass`` text: one opcode list per loop
    body (from a backward branch's target through the branch), innermost
    meaning that no other loop lies inside it; none when the kernel has no
    backward branch."""
    body, found = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(kernel, line) is not None
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if found and m:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
            op = text.split()[0]
            tgt = re.search(r"0x([0-9a-f]+)", text) \
                if op.startswith("BRA") else None
            body.append((int(m.group(1), 16), op, tgt and int(tgt.group(1), 16)))
    check(bool(body), f"no SASS of {kernel}")
    loops = [(t, a) for a, _, t in body if t is not None and t <= a]
    inner = [(t, a) for t, a in loops
             if not any((t, a) != (u, b) and t <= u and b <= a
                        for u, b in loops)]
    return [[op for a2, op, _ in body if t <= a2 <= a] for t, a in inner]


def library_sass() -> str:
    """``cuobjdump -sass`` of the built kernel library (next to ``nvcc``)."""
    from repro_torch.kernels import _build
    res = subprocess.run([str(Path(_build.nvcc()).with_name("cuobjdump")),
                          "-sass", str(_build.library_path())],
                         capture_output=True, text=True, timeout=120)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr}")
    return res.stdout


def stream_ops(sass: str, kernel: str) -> dict:
    """Arithmetic instructions one noise stream element costs in
    ``kernel``, by pipe: the innermost loop that draws the most normals
    (one ``MUFU.RSQ`` of ``sqrtf`` each), divided by that count, whatever
    the loop holds (one element, or several unrolled). The grid-stride
    loop's own per-element work (load, store, index) is left out, which
    keeps the bound from these counts a lower bound. ``rotations`` is the
    loop's rotations a normal: 20 where each threefry2x32 rotates inside
    the loop, fewer where the compiler moved a rotation out of it (a
    first-round rotation of a counter that is the same for every element).
    Where no loop draws a normal the result says so (``"loop": None`` and
    why) and has no counts."""
    loops = sass_loops(sass, kernel)
    rsq = lambda ops: sum(o.startswith("MUFU.RSQ") for o in ops)
    best = max(loops, key=rsq, default=[])
    n = rsq(best)
    if n == 0:
        return {"loop": None, "why": f"no loop of {kernel} draws a normal "
                                     f"({len(loops)} innermost loops)"}
    rot = sum(o.startswith(("SHF.L.W", "PRMT")) for o in best)
    base = [o.split(".")[0] for o in best if ".MOV" not in o]
    count = {c: sum(o in ops for o in base) for c, ops in (
        ("alu", ALU_OPS), ("imad", IMAD_OPS), ("fp32", FP32_OPS),
        ("mufu", {"MUFU"}), ("other", OTHER_OPS))}
    per = {k: v / n for k, v in count.items()}
    return {"normals_in_loop": n, "rotations": rot / n, "alu": per["alu"],
            "imad": per["imad"], "fp32+imad": per["fp32"] + per["imad"],
            "mufu": per["mufu"], "issue": sum(per.values())}


def stream_configs() -> dict:
    """The wire stream kernels' launch configurations as the tree's built
    library reports them (threads, elements a thread, blocks an SM,
    registers, local bytes), or {} for a tree whose library reports none
    (one from before ``csrc/stream_grid.cuh``)."""
    try:
        from repro_torch.kernels.dp_fused.dp_fused import stream_config
    except ImportError:
        return {}
    return {k: stream_config(k)
            for k in ("clip_mask", "clip_mask_ext", "noise_stream")}


def live_stream_ops(sass: str, kernel: str) -> dict:
    """:func:`stream_ops` for a kernel bounded by its own live counts
    (``noise_batch``, ``zsmask``): fails where there are none, or where the
    loop does not hold every normal's 20 rotations (its count would then
    miss work the bound must see)."""
    r = stream_ops(sass, kernel)
    check(r.get("loop", True) is not None,
          f"no per-normal count of {kernel}: {r.get('why')}")
    check(r["rotations"] >= 20, f"no per-normal count of {kernel}: "
                                f"{r['rotations']} rotations a normal")
    return r


def leaf_slices(layout) -> list:
    """``(leaf index, offset in the leaf, offset in the buffer, numel)`` of
    every tensor of a layout's tree: what the perleaf mask launches on."""
    out = []
    for i, (k, size, off) in enumerate(zip(layout.stacks, layout.sizes,
                                           layout.offsets)):
        m = size // k if k else size
        out += [(i, j * m, off + j * m, m) for j in range(k or 1)]
    return out


def draw_windows(layout) -> int:
    """The admin masks' windows over a layout's tensors: one draw of each
    stream a window (``core/masking.WINDOW`` elements)."""
    from repro_torch.core import masking
    return sum(-(-n // masking.WINDOW) for *_, n in leaf_slices(layout))


def check_zsmask(dev, layout, g, zs_ops, zs_ref, fold_leaf, folds, keys,
                 per_stream):
    """One pass of silo 1 of 4's perleaf mask over every tensor of the
    layout's tree (keys folded per leaf, counters at each tensor's offset in
    its leaf), the scalars as the barrier tier makes them at sigma 0.3 and
    C 4, bit-equal to the plain version over every element (windows of
    DP_WINDOW)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    sc = f32(0.3) * f32(4.0)
    b = f32(8.0) * sc
    slices = leaf_slices(layout)
    kr = [fold_leaf(keys.key_r, folds[0], i) for i in range(layout.n_leaves)]
    kx = [fold_leaf(keys.key_xi, folds[1], i) for i in range(layout.n_leaves)]
    out = torch.empty_like(g)

    def one_pass():
        for i, o, a, m in slices:
            zs_ops.apply_zsmask(g[a:a + m], kr[i], kx[i], 1, 4, sc, b,
                                offset=o, out=out[a:a + m])

    one_pass()
    err = torch.zeros((), device=dev)
    for i, o, a, m in slices:
        for w in range(0, m, DP_WINDOW):
            e = min(w + DP_WINDOW, m)
            plain = zs_ref.zsmask_ref(g[a + w:a + e], kr[i], kx[i], 1, 4, sc,
                                      b, offset=o + w)
            err = torch.maximum(err, (out[a + w:a + e] - plain).abs().max())
    err = err.item()
    check(err == 0.0, f"zsmask differs from its plain version by {err}")
    check(bool(torch.isfinite(out[:layout.offsets[-1]]).all()),
          "zsmask: non-finite")
    n = layout.n_params
    parts = stream_bound(n, 3, per_stream)  # r_i, r_nxt, xi
    bms = max(parts.values())
    w = g[:DP_WINDOW]
    res = {
        "max_abs_err": err,
        "checked_at": f"all {n} elements of {len(slices)} leaf tensors, "
                      f"windows of {DP_WINDOW}",
        "ms": cuda_ms(one_pass, reps=3, warmup=1),
        "plain_ms": cuda_ms(lambda: zs_ref.zsmask_ref(w, kr[0], kx[0], 1, 4,
                                                      sc, b), reps=5),
        "plain_at": f"window of {DP_WINDOW} elements",
        "library_ms": None,
        "library_call": "none (no PyTorch call draws keyed threefry normals)",
        "bound_ms": bms,
        "bound_by": "bytes" if bms == parts["bytes"] else "operations",
        "bound_detail": {"ms_by_limit": parts, "per_stream": per_stream},
        "at": f"one pass over the {len(slices)} leaf tensors ({n} "
              f"elements), silo 1 of 4, fp32",
    }
    del out
    return res


def leaf_columns(stacked, layout) -> list:
    """Each leaf's columns of a (B, P) buffer, rows P apart, as views."""
    return [stacked[:, off:off + size]
            for off, size in zip(layout.offsets, layout.sizes)]


def max_rel(a, b) -> float:
    return ((a - b).abs() / b.abs()).max().item()


def check_sumsq(stacked, layout, clip_ops, clip_ref):
    """``per_example_sumsq`` on every leaf's columns of the (4, P) buffer
    in place, as the perleaf clip route runs it: within SUMSQ_RTOL of the
    plain version and bit-identical across two launches."""
    cols = leaf_columns(stacked, layout)
    run = lambda: [clip_ops.sumsq(c) for c in cols]
    out, again = run(), run()
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          "per_example_sumsq differs between two launches")
    plain = [clip_ref.per_example_sumsq_ref(c) for c in cols]
    err = max((a - b).abs().max().item() for a, b in zip(out, plain))
    rel = max(max_rel(a, b) for a, b in zip(out, plain))
    check(rel <= SUMSQ_RTOL, f"per_example_sumsq off its plain version by "
                             f"{rel} relative")
    B, n = stacked.shape[0], layout.n_params
    bms, by = bound(B * n * 4 + len(cols) * B * 4, 2 * B * n)
    return {
        "max_abs_err": err, "max_rel_err": rel, "tolerance_rel": SUMSQ_RTOL,
        "bit_identical_relaunch": True,
        "checked_at": f"every leaf's columns, all {n} per row",
        "ms": cuda_ms(run, reps=3, warmup=1),
        "plain_ms": cuda_ms(lambda: [clip_ref.per_example_sumsq_ref(c)
                                     for c in cols], reps=3, warmup=1),
        "plain_at": "every leaf (chunked dot products)",
        "library_ms": cuda_ms(lambda: [torch.linalg.vector_norm(c, dim=1)
                                       for c in cols], reps=3, warmup=1),
        "library_call": "torch.linalg.vector_norm(g, dim=1) per leaf",
        "bound_ms": bms, "bound_by": by,
        "at": f"B={B}, {len(cols)} leaves of qwen2.5-3b at 12 layers "
              f"({n} columns), rows P apart, fp32",
    }


def check_clip_sum(dev, stacked, noise_ops, noise_ref, clip_ref, P):
    """``clip_sum`` at C = 1 on the (4, P) buffer: norms within SUMSQ_RTOL
    of the plain version's, the sum bit-equal to the plain fold at the
    kernel's norms and within SUMSQ_RTOL of the largest value of the plain
    version's (its own norms), bit-identical across two launches."""
    c = torch.ones((), device=dev)
    s, n = noise_ops.clip_sum_packed(stacked, c)
    s2, n2 = noise_ops.clip_sum_packed(stacked, c)
    check(torch.equal(n, n2) and torch.equal(s, s2),
          "clip_sum differs between two launches")
    del s2
    ss = clip_ref.per_example_sumsq_ref(stacked)
    n_plain, scale_plain = noise_ref.clip_sum_scales(ss, c)
    rel = max_rel(n, n_plain)
    check(rel <= SUMSQ_RTOL, f"clip_sum norms off by {rel} relative")
    scale_k = torch.clamp(c / n, max=1.0)
    same = max_err_by_window(s, lambda a, b: clip_ref.clip_accumulate_ref(
        stacked[:, a:b], scale_k), P)
    check(same == 0.0, f"clip_sum's sum differs from the plain fold at its "
                       f"own norms by {same}")
    err = max_err_by_window(s, lambda a, b: clip_ref.clip_accumulate_ref(
        stacked[:, a:b], scale_plain), P)
    top = s.abs().max().item()
    check(err <= SUMSQ_RTOL * top, f"clip_sum differs from its plain version "
                                   f"by {err} (largest value {top})")
    del s
    B = stacked.shape[0]
    w = stacked[:, :DP_WINDOW]
    bms, by = bound((B * P + P + B) * 4, 4 * B * P)
    return {
        "max_abs_err": err, "norms_max_rel_err": rel,
        "sum_max_abs_err_at_kernel_norms": same, "largest_value": top,
        "tolerance": f"norms {SUMSQ_RTOL} relative; sum {SUMSQ_RTOL} of the "
                     f"largest value",
        "bit_identical_relaunch": True,
        "checked_at": f"all {P} columns, windows of {DP_WINDOW}",
        "ms": cuda_ms(lambda: noise_ops.clip_sum_packed(stacked, c), reps=3,
                      warmup=1),
        "plain_ms": cuda_ms(lambda: noise_ref.clip_sum_ref(w, c), reps=5),
        "plain_at": f"window of {DP_WINDOW} columns",
        "library_ms": cuda_ms(lambda: torch.clamp(
            c / torch.linalg.vector_norm(stacked, dim=1), max=1.0) @ stacked,
            reps=3, warmup=1),
        "library_call": "min(1, C / vector_norm(g, dim=1)) @ g (cuBLAS)",
        "bound_ms": bms, "bound_by": by,
        "two_pass_floor_ms": (2 * B * P + P) * 4 / HBM_BYTES_PER_S * 1e3,
        "at": f"B={B} P={P} C=1 fp32",
    }


# ---------------------------------------------------------------- phase 8

def narrow_step(sess, params, batch, steps, step_keys, prng):
    """One fused-grads pass and one train step of ``sess`` from ``params``
    (moved into a fresh state): (noisy gradient, metrics, state)."""
    state = sess.init_state(params=params)
    root = prng.PRNGKey(sess.seed + 1)
    keys = step_keys(root, 0)
    dev = state.clip_bound.device
    noisy, loss, norms, ns, bound = steps._fused_grads(
        sess.model, sess.run_cfg.privacy, state.params, batch, 4, keys,
        state.noise_state, state.clip_bound, keys.key_clip, state.layout,
        steps.StageTimer(dev))
    noisy = noisy.float().cpu()
    step = steps.build_train_step(sess.model, sess.run_cfg)
    state, metrics = step(state, batch, root, timer=steps.StageTimer(dev))
    return noisy, {k: float(v) for k, v in metrics.items()}, \
        {"norms": norms.cpu(), "loss": float(loss), "bound": float(bound),
         "prev_key": ns.prev_key}, state


# ---------------------------------------------------------- phases 9, 10

def chunked_max_diff(a, b, chunk: int = 1 << 26) -> float:
    """max |a - b| over two (P,) buffers, a chunk at a time (no P-sized
    temporary)."""
    err = torch.zeros((), device=a.device)
    for i in range(0, a.shape[0], chunk):
        err = torch.maximum(err, (a[i:i + chunk] - b[i:i + chunk]).abs().max())
    return err.item()


def mask_std(contrib, g, scale, chunk: int = 1 << 26) -> float:
    """std of ``contrib - g * scale`` (a silo's contribution minus its
    clipped gradient), accumulated in float64 a chunk at a time."""
    s1 = s2 = 0.0
    for i in range(0, g.shape[0], chunk):
        d = (contrib[i:i + chunk] - g[i:i + chunk] * scale).double()
        s1 += d.sum().item()
        s2 += (d * d).sum().item()
    n = g.shape[0]
    return math.sqrt(s2 / n - (s1 / n) ** 2)


def silo_grads_packed(model, params, batch, layout, i, n, flatbuf, param_tree):
    """Silo i's rows of ``batch``: its gradient packed into a (P,) buffer,
    and its gradient tree's norm (the barrier tier's ``norm_tree``)."""
    from repro_torch.core import clipping
    rows = batch["tokens"].shape[0] // n
    b = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
    tensors = flatbuf.flat_tensors(layout, param_tree(params))
    grads = torch.autograd.grad(model.loss(params, b), tensors)
    with torch.no_grad():
        return flatbuf.pack_tensors(layout, grads), clipping.global_norm(grads)


def barrier_step_parts(sess, params, batch, ns, active, steps, step_keys,
                       prng, flatbuf, param_tree, pack_params, DPPipeline):
    """One ``_barrier_grads`` call on ``sess``'s device from ``params``
    (moved into a packed buffer), and every silo's contribution rebuilt
    from its own gradient at the step's bound."""
    layout, _ = pack_params(params)
    priv, mesh = sess.run_cfg.privacy, sess.run_cfg.mesh
    n = mesh.n_silos
    keys = step_keys(prng.PRNGKey(sess.seed + 1), 0)
    dev = sess.device
    c0 = torch.tensor(priv.clip_bound, dtype=torch.float32, device=dev)
    agg, loss, norms, new_ns, bound = steps._barrier_grads(
        sess.model, priv, mesh, params, batch, keys, ns, c0, keys.key_clip,
        layout, steps.StageTimer(dev), active=active)
    agg = flatbuf.zero_padding(layout, agg).cpu()
    pipe = DPPipeline(priv, layout, n)
    contribs = []
    for i in range(n):
        g, norm = silo_grads_packed(sess.model, params, batch, layout, i, n,
                                    flatbuf, param_tree)
        with torch.no_grad():  # in place: a tree of views under perleaf
            pipe.silo_contribution(g, i, pipe.clip_scale(norm, bound), active,
                                   keys, ns, bound, out=g)
            contribs.append(g.cpu())
    return {"agg": agg, "loss": float(loss), "bound": float(bound),
            "norms": norms.cpu(), "prev_key": new_ns.prev_key,
            "prev_active": new_ns.prev_active, "contribs": contribs}


# ------------------------------------------------------------------- main

# --------------------------------------------------------------- phase 18
# the other dense archs (stablelm-3b at d_head 80, phi3-mini-3.8b at 96:
# MHA, 32 kv heads), the admin masks on every tier and the silo-serial scan
# tier

DENSE_ARCHS = ("stablelm-3b", "phi3-mini-3.8b")
# the scan tier's depths, tried from the published one down in steps of 6
# until one fits the card (the depth run is reported, never as full depth)
SCAN_DEPTHS = (36, 30, 24, 18, 12)


def check_new_widths(dev, seed: int) -> dict:
    """Phase 18(a): flash attention at both archs' prefill shapes (B 4,
    S 32, 32 heads) and paged attention at decode (C 1), a verify (C 4)
    and a chunk (C 16) at Hkv 32, each against its plain version and timed
    as phase 3 times its rows (calls and on the card, beside SDPA and the
    bound). Returns ``{kernel: {sub-row name: row}}``."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows: dict = {"flash_attention": {}, "paged_attention": {}}
    for arch in DENSE_ARCHS:
        cfg = get_config(arch)
        d = f"d{cfg.d_head}"
        r = check_flash(cfg, dev, gen, 4, 32, flash_ops, flash_ref, F)
        rows["flash_attention"][d] = r
        log_attention(f"flash_attention d_head {cfg.d_head} ({arch})", r)
        for C, sub in ((1, d), (4, f"{d}_verify4"), (16, f"{d}_chunk16")):
            r = check_paged_attention(cfg, dev, gen, 4, 32, 16, C, paged_ops,
                                      paged_ref, F)
            rows["paged_attention"][sub] = r
            log_attention(f"paged_attention {sub} ({arch})", r)
    return rows


def serve_modes(Session, cfg, modes: tuple, log_name: str) -> tuple:
    """One arch's config (published width, its depth or a cut) through
    ``Session.serve`` in each of ``modes`` (direct: batch 4, prompt 32, 16
    new; wave and continuous: 8 Zipf requests through 4 slots, pages 16,
    chunk 16, max_len 512, the defaults), random weights from a seed, the
    launch counts zeroed just before each mode and read just after: flash
    once a layer a prefill, paged attention a positive multiple of the
    depth and ``paged_reset`` once an admission, nothing else. Returns
    ``(record, session, params, {mode: tokens})``; the caller frees the
    weights."""
    from repro_torch.kernels import dispatch
    from repro_torch.runtime.serving import zipf_requests

    arch = cfg.name
    sess = Session.from_config(cfg, seed=0)
    L, V = cfg.n_layers, cfg.vocab_size
    params, init_s = timed(sess.init_params)
    n_params = sum(p.numel() for p in params.parameters())
    moe = (f", {cfg.n_experts} experts top-{cfg.top_k}, capacity factor "
           f"{cfg.moe_capacity_factor}" if cfg.is_moe() else "")
    log(f"[{log_name}] {arch} full width, {L} layers ({cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, d_head {cfg.d_head}{moe}): "
        f"{n_params / 1e9:.3f} B fp32 params ({n_params * 4 / 1e9:.2f} GB) "
        f"on the card in {init_s:.1f} s")
    sess.serve(batch_size=4, prompt_len=32, max_new_tokens=2, params=params)
    torch.cuda.reset_peak_memory_stats()
    reqs = zipf_requests(8, V, min_len=8, max_len=48, max_new_low=8,
                         max_new_high=24, seed=0)
    out = {"config": f"{arch} published width, {L} layers (d_head "
                     f"{cfg.d_head}, Hkv {cfg.n_kv_heads}), fp32",
           "n_params": n_params, "init_s": init_s}
    tokens = {}
    for mode in modes:
        dispatch.reset_launches()
        if mode == "direct":
            res, wall = timed(lambda: sess.serve(
                batch_size=4, prompt_len=32, max_new_tokens=16,
                params=params))
        else:
            res, wall = timed(lambda: sess.serve(
                scheduler=mode, requests=copy.deepcopy(reqs), params=params,
                max_batch=4, max_len=512, page_size=16, prefill_chunk=16))
        n = {k: v for k, v in dispatch.launch_counts().items() if v}
        toks = tokens[mode] = res.tokens
        check(bool((toks < V).all()) and bool((toks >= 0).any()),
              f"{arch} {mode} tokens")
        if mode == "direct":
            check(toks.shape == (4, 16) and bool((toks >= 0).all())
                  and tuple(res.logits.shape) == (4, V)
                  and bool(torch.isfinite(res.logits).all()),
                  f"{arch} direct tokens or logits")
            check(n == {"flash_attention": L},
                  f"{arch} direct launches {n}, expected flash {L}x")
            out[mode] = {"prefill_ms": res.prefill_s * 1e3,
                         "decode_ms_per_token":
                             res.decode_s_per_token * 1e3,
                         "decode_tok_per_s": 4 / res.decode_s_per_token,
                         "launches": n}
            log(f"[{log_name}] direct batch 4, prompt 32, 16 new: prefill "
                f"{res.prefill_s * 1e3:.2f} ms | decode "
                f"{res.decode_s_per_token * 1e3:.2f} ms/token step | "
                f"launches {n}")
            continue
        st = res.stats
        check(st.drained and len(st.latencies) == len(reqs),
              f"{arch} {mode} did not drain")
        if mode == "wave":
            check(n == {"flash_attention": L * st.waves},
                  f"{arch} wave launches {n} for {st.waves} waves")
        else:
            admissions = len(reqs) + st.preemptions
            check(set(n) == {"paged_attention", "paged_reset"}
                  and n["paged_reset"] == admissions
                  and n["paged_attention"] % L == 0,
                  f"{arch} continuous launches {n}: paged_reset "
                  f"{admissions}, paged_attention a multiple of {L}")
        out[mode] = {"wall_s": wall, "useful_tokens": st.useful_tokens,
                     "tok_per_s": 1 / res.decode_s_per_token,
                     "decode_ms_per_step": res.decode_s_per_token * 1e3
                     * st.useful_tokens / max(st.decode_steps, 1),
                     "decode_steps": st.decode_steps,
                     "utilization": st.utilization,
                     "p50_latency_steps": st.p50_latency_steps,
                     "p99_latency_steps": st.p99_latency_steps,
                     "launches": n}
        r = out[mode]
        log(f"[{log_name}] {mode}: 8 requests, 4 slots: "
            f"{r['useful_tokens']} tokens in {wall:.2f} s, "
            f"{r['tok_per_s']:.1f} tok/s | decode "
            f"{r['decode_ms_per_step']:.2f} ms a step | p50 "
            f"{r['p50_latency_steps']} p99 {r['p99_latency_steps']} steps | "
            f"launches {n}")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{log_name}] {arch}: peak {out['peak_mem_gb']:.2f} GB")
    return out, sess, params, tokens


def serve_dense(Session, arch: str, log_name: str) -> dict:
    """Phase 18(b): one dense arch at published width and depth through
    :func:`serve_modes` in every mode; continuous equals wave token for
    token."""
    from repro_torch.configs import get_config

    out, sess, params, toks = serve_modes(
        Session, get_config(arch), ("direct", "wave", "continuous"), log_name)
    check(bool((toks["continuous"] == toks["wave"]).all()),
          f"{arch}: continuous tokens differ from wave tokens")
    log(f"[{log_name}] continuous == wave token for token")
    del params, sess
    torch.cuda.empty_cache()
    return out


def dense_cross_device(Session, cfg, reqs, log_name: str) -> dict:
    """A narrow config of a dense arch at its kernels' width, card vs CPU
    from the same weights: :func:`family_cross_device` (prefill and 3
    decode steps, wave tokens), then continuous tokens equal (the paged
    kernels on the card)."""
    from repro_torch.kernels import dispatch

    out = family_cross_device(Session, cfg, reqs, log_name)
    on = {d: Session.from_config(cfg, device=d, seed=7)
          for d in ("cuda", "cpu")}
    p_cpu = on["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to(on["cuda"].device)
    toks, launches = {}, {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        dispatch.reset_launches()
        res = on[d].serve(scheduler="continuous",
                          requests=copy.deepcopy(reqs), params=p,
                          max_batch=2, max_len=64, page_size=16,
                          prefill_chunk=16)
        launches[d] = {k: v for k, v in dispatch.launch_counts().items()
                       if v}
        toks[d] = res.tokens
    check(bool((toks["cuda"] == toks["cpu"]).all()),
          f"{cfg.name} continuous tokens differ between card and CPU")
    check(not launches["cpu"] and set(launches["cuda"]) == {
        "paged_attention", "paged_reset"},
          f"{cfg.name} continuous launches: card {launches['cuda']}, CPU "
          f"{launches['cpu']}")
    log(f"[{log_name}] {cfg.name} continuous, card vs CPU: tokens equal | "
        f"card launches {launches['cuda']}")
    out["continuous_card_launches"] = launches["cuda"]
    return out


def admin_phase(dev) -> dict:
    """Phase 18(c): admin masks on qwen2.5-3b at full width and 12 layers,
    phase 7's settings. One primed step from one set of weights: the fused
    tier's aggregate (``clip_accumulate``, then the admin's xi_t - lam
    xi_{t-1}, one ``normal_combine`` a window) against the barrier tier's
    summed contributions (each silo's ``g * scale + row``, the rows'
    draws ``normal`` and ``normal_combine`` launches a window) within the
    masks' residue (MASK_ATOL_PER_B units of B); then 2 fused steps and 1
    barrier step through ``Session.train`` with their launches; then the
    wire tier on MNIST-MLP3: 10 serial and 10 pipelined admin rounds,
    bit-equal, only the normal kernels launched (the rest of the
    contributions is plain torch, as JAX's is jnp), and 3 rounds with a
    drop, card vs CPU."""
    from repro_torch.api import CollaborativeSession, Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          PrivacyConfig)
    from repro_torch.configs.paper_models import MNIST_MLP3
    from repro_torch.core import flatbuf, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.core.noise_correction import NoiseState
    from repro_torch.core.tee import wire
    from repro_torch.data.synthetic import synthetic_mnist
    from repro_torch.distributed import steps as steps_mod
    from repro_torch.kernels import dispatch
    from repro_torch.models.packing import pack_params
    from repro_torch.models.small import build_small_model, value_and_grad

    t0 = time.perf_counter()
    cut12 = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=12)
    priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=4,
                         mask_mode="admin")
    priv_b = dataclasses.replace(priv, sync_path="barrier")
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    mesh4 = MeshConfig((4,), ("data",))
    report: dict = {}

    bsess = Session.from_config(cut12, privacy=priv_b, optimizer=opt,
                                mesh=mesh4, seed=0)
    params = bsess.init_params()
    layout, _ = pack_params(params)
    batch = bsess.synthetic_batches(16, 64)()
    keys = step_keys(prng.PRNGKey(1), 0)
    primed = NoiseState(step_keys(prng.PRNGKey(4), 0).key_xi, True,
                        np.ones(4, bool))
    c0 = torch.tensor(1.0, dtype=torch.float32, device=dev)
    args = (batch, keys, primed, c0, keys.key_clip, layout)
    dispatch.reset_launches()
    f_timer = steps_mod.StageTimer(dev)
    f_agg, f_loss, _, _, f_bound = steps_mod._fused_grads(
        bsess.model, priv, params, batch, 4, *args[1:], f_timer)
    n_f = {k: v for k, v in dispatch.launch_counts().items() if v}
    flatbuf.zero_padding(layout, f_agg)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    b_timer = steps_mod.StageTimer(dev)
    b_agg, b_loss, _, _, b_bound = steps_mod._barrier_grads(
        bsess.model, priv_b, mesh4, params, *args, b_timer)
    n_b = {k: v for k, v in dispatch.launch_counts().items() if v}
    peak_b = torch.cuda.max_memory_allocated()
    flatbuf.zero_padding(layout, b_agg)
    B = priv.mask_scale * priv.sigma * float(b_bound)
    err = chunked_max_diff(b_agg, f_agg)
    # a window: the fused noise one normal_combine (xi with its
    # correction); the barrier rows one normal_combine (the closing row's
    # xi) and 6 normal (3 silos' u, and the 3 the closing row subtracts)
    wins = draw_windows(layout)
    check(n_f == {"clip_accumulate": 1, "normal_combine": wins}
          and n_b == {"normal": 6 * wins, "normal_combine": wins},
          f"admin one-step launches: fused {n_f}, barrier {n_b} ({wins} "
          f"windows)")
    check(err <= MASK_ATOL_PER_B * B, f"admin barrier vs fused aggregate "
          f"differ by {err} (tolerance {MASK_ATOL_PER_B * B}, B {B})")
    check(math.isclose(float(b_loss), float(f_loss), rel_tol=TRAIN_RTOL)
          and math.isclose(float(b_bound), float(f_bound),
                           rel_tol=TRAIN_RTOL),
          f"admin barrier vs fused loss {float(b_loss)} / {float(f_loss)}")
    f_ms, b_ms = f_timer.ms(), b_timer.ms()
    report["barrier_vs_fused"] = {
        "aggregate_max_abs_err": err, "tolerance": MASK_ATOL_PER_B * B,
        "B": B, "aggregate_max_abs": f_agg.abs().max().item(),
        "fused_stage_ms": f_ms, "barrier_stage_ms": b_ms,
        "peak_mem_gb_barrier_grads": peak_b / 1e9}
    log(f"[admin] qwen2.5-3b full width, 12 layers, P {layout.total}, one "
        f"primed step: barrier vs fused aggregate max |diff| {err:.3g} "
        f"(tolerance {MASK_ATOL_PER_B * B:.3g} from B {B:.4f}) | fused "
        f"stages {json.dumps({k: round(v, 1) for k, v in f_ms.items()})} | "
        f"barrier stages "
        f"{json.dumps({k: round(v, 1) for k, v in b_ms.items()})} | peak "
        f"{peak_b / 1e9:.2f} GB in _barrier_grads | launches fused {n_f}, "
        f"barrier {n_b}")
    del f_agg, b_agg, params, bsess
    torch.cuda.empty_cache()
    report["fused"] = train_cell(Session, cut12, priv, opt, None, 2, {
        "clip_accumulate": 1, "normal_combine": draw_windows},
        "admin-fused")
    report["barrier"] = train_cell(Session, cut12, priv_b, opt, mesh4, 1, {
        "normal": lambda lay: 6 * draw_windows(lay),
        "normal_combine": draw_windows}, "admin-barrier")

    # the wire tier under admin masks (phase 16's setup)
    sm = build_small_model(MNIST_MLP3)
    silos = [{"x": s.x, "y": s.y} for s in synthetic_mnist(
        n_train=4096, n_test=16)[0].split(WIRE_SILOS)]
    wpriv = PrivacyConfig(enabled=True, sigma=0.5, clip_bound=1.0,
                          noise_lambda=WIRE_LAM, mask_mode="admin")
    init = sm.init(torch.Generator(device=dev).manual_seed(1))
    grad_fn = value_and_grad(sm.loss)
    runs, runs_n = {}, {}
    for mode in ("serial", "pipelined"):
        sess = CollaborativeSession.from_silos(silos, wpriv,
                                               params_template=init)
        params = {k: v.clone() for k, v in init.items()}
        dispatch.reset_launches()
        (params, losses), s = timed(lambda: sess.run(
            params, grad_fn, wire_update, WIRE_LR, WIRE_ROUNDS,
            pipelined=mode == "pipelined"))
        n = {k: v for k, v in dispatch.launch_counts().items() if v}
        check(set(n) == {"normal", "normal_combine"},
              f"admin wire {mode} launched {n}")
        runs_n[mode] = n
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"admin wire {mode}: loss {losses[0]} -> {losses[-1]}")
        runs[mode] = (sess, losses, wire.pack_np(flatbuf.layout_of(params),
                                                 params), s)
    (sa, la, pa, s_a), (sb, lb, pb, s_b) = runs["serial"], runs["pipelined"]
    check(np.array_equal(pa.view(np.uint32), pb.view(np.uint32))
          and la == lb and sa.wire_stats == sb.wire_stats,
          "admin wire: pipelined rounds are not bit-equal to serial")

    def three(device):
        sess = CollaborativeSession.from_silos(silos, wpriv, device=device)
        params = {k: v.to(device) for k, v in init.items()}
        losses = []
        for t in range(3):
            if t == 1:
                check(sess.drop_silo(1), "admin wire: drop refused")
            if t == 2:
                check(sess.rejoin_silo(1), "admin wire: rejoin refused")
            params, loss = sess.step(t, params, grad_fn, wire_update,
                                     WIRE_LR)
            losses.append(loss)
        return sess, wire.pack_np(flatbuf.layout_of(params), params), losses

    gs, gp, gl = three(dev)
    cs, cp, cl = three("cpu")
    loss_rel = float(np.max(np.abs(np.subtract(gl, cl)) / np.abs(cl)))
    param_err = float(np.abs(gp - cp).max())
    check(loss_rel <= WIRE_LOSS_RTOL and param_err <= WIRE_PARAM_ATOL
          and gs.epsilon() == cs.epsilon()
          and gs.accountant.history == cs.accountant.history,
          f"admin wire card vs CPU: loss {loss_rel} params {param_err}")
    report["wire"] = {
        "rounds": WIRE_ROUNDS, "serial_s": s_a, "pipelined_s": s_b,
        "loss": la, "wire_stats": sa.wire_stats, "launches": runs_n,
        "card_vs_cpu": {"loss_max_rel": loss_rel, "param_max_abs": param_err,
                        "contributions": gs.accountant.contributions}}
    log(f"[admin-wire] MNIST-MLP3, 4 silos: {WIRE_ROUNDS} serial rounds in "
        f"{s_a * 1e3:.1f} ms, {WIRE_ROUNDS} pipelined in {s_b * 1e3:.1f} ms, "
        f"bit-equal, launches {json.dumps(runs_n)} | loss {la[0]:.4f} -> "
        f"{la[-1]:.4f} | "
        f"3 rounds with a drop, card vs CPU: loss {loss_rel:.2e} rel, params "
        f"{param_err:.2e}, participation {gs.accountant.contributions}")
    report["phase_s"] = time.perf_counter() - t0
    return report


def scan_phase(dev) -> dict:
    """Phase 18(d): the silo-serial scan tier on qwen2.5-3b at full width,
    at the largest of SCAN_DEPTHS that fits the card (36, its published
    depth, first): 2 steps through ``Session.train`` (phase 7's privacy
    settings), step and stage times and peak memory, the per-leaf noise one
    ``normal_combine`` a leaf tensor and no other kernel (the scan tier's
    other stages are plain torch, as JAX's are jnp); then a narrow scan
    step against the vmap fused step under the per-leaf policy at the same
    keys (static clipping, so both clip at one bound), card vs CPU."""
    import gc

    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (OptimizerConfig, PrivacyConfig,
                                          reduce_for_smoke)
    from repro_torch.core import flatbuf, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.core.noise_correction import NoiseState
    from repro_torch.distributed import steps as steps_mod
    from repro_torch.kernels import dispatch

    t0 = time.perf_counter()
    cfg = get_config("qwen2.5-3b")
    priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=4,
                         silo_mode="scan")
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    report: dict = {"tried": []}
    for depth in SCAN_DEPTHS:
        cut = dataclasses.replace(cfg, n_layers=depth)
        try:
            cell = train_cell(Session, cut, priv, opt, None, 2, {
                "normal_combine": lambda lay: len(leaf_slices(lay))},
                "scan-tier")
        except torch.cuda.OutOfMemoryError as e:
            report["tried"].append({"n_layers": depth, "error": str(e)[:200]})
            log(f"[scan-tier] {depth} layers do not fit the card: "
                f"{str(e)[:160]}")
            gc.collect()
            torch.cuda.empty_cache()
            continue
        report.update(n_layers=depth, full_depth=depth == cfg.n_layers,
                      **cell)
        break
    check("n_layers" in report, f"the scan tier fits at none of "
                                f"{SCAN_DEPTHS} layers")
    report["card_memory_gb"] = \
        torch.cuda.get_device_properties(dev).total_memory / 1e9
    log(f"[scan-tier] qwen2.5-3b at {report['n_layers']} of {cfg.n_layers} "
        f"layers (P {report['P']}): peak {report['peak_mem_gb']:.2f} GB of "
        f"the card's {report['card_memory_gb']:.2f} GB")

    narrow = reduce_for_smoke(cfg, n_layers=2, d_model=256, n_heads=4,
                              n_kv_heads=2, d_head=64, d_ff=512,
                              vocab_size=4096)
    npriv = dataclasses.replace(priv, dynamic_clip=False)
    keys = step_keys(prng.PRNGKey(1), 0)
    primed = NoiseState(step_keys(prng.PRNGKey(4), 0).key_xi, True,
                        np.ones(4, bool))
    weights = Session.from_config(narrow, seed=3, device="cpu").init_params()
    out = {}
    for d in ("cuda", "cpu"):
        sess = Session.from_config(narrow, privacy=npriv, optimizer=opt,
                                   seed=3, device=d)
        on = sess.device
        state = sess.init_state(params=copy.deepcopy(weights).to(on))
        batch = {k: v.to(on) for k, v in
                 sess.synthetic_batches(16, 32)().items()}
        args = (sess.model, npriv, state.params, batch, 4, keys, primed,
                state.clip_bound, keys.key_clip, state.layout)
        dispatch.reset_launches()
        scan, s_loss = steps_mod._fused_grads_scan(
            *args, steps_mod.StageTimer(on))[:2]
        n_scan = {k: v for k, v in dispatch.launch_counts().items() if v}
        with dispatch.force_impl("perleaf", kernel="dp_noise_tree"):
            dispatch.reset_launches()
            vmap, v_loss = steps_mod._fused_grads(
                *args, steps_mod.StageTimer(on))[:2]
            n_vmap = {k: v for k, v in dispatch.launch_counts().items() if v}
        out[d] = (flatbuf.zero_padding(state.layout, scan).cpu(),
                  flatbuf.zero_padding(state.layout, vmap).cpu(),
                  float(s_loss), float(v_loss), n_scan, n_vmap)
    (sg, vg, lsg, lvg, nsg, nvg), (sc, vc, lsc, lvc, nsc, nvc) = \
        out["cuda"], out["cpu"]
    n_t = len(leaf_slices(state.layout))  # the CPU session's: the same
    check(nsg == {"normal_combine": n_t}
          and nvg == {"clip_accumulate": 1, "normal_combine": n_t}
          and not nsc and not nvc,
          f"narrow scan/vmap launches: card {nsg} / {nvg}, CPU {nsc} / {nvc} "
          f"({n_t} leaf tensors)")
    errs = {"scan_card_vs_cpu": (sg - sc).abs().max().item(),
            "vmap_card_vs_cpu": (vg - vc).abs().max().item(),
            "scan_vs_vmap_card": (sg - vg).abs().max().item(),
            "scan_vs_vmap_cpu": (sc - vc).abs().max().item()}
    check(max(errs.values()) <= NOISY_ATOL
          and math.isclose(lsg, lsc, rel_tol=TRAIN_RTOL)
          and math.isclose(lsg, lvg, rel_tol=TRAIN_RTOL),
          f"narrow scan step: {errs}, loss {lsg} / {lsc} / {lvg}")
    report["narrow"] = {"P": sc.shape[0], "max_abs_err": errs,
                        "tolerance": NOISY_ATOL,
                        "noisy_max_abs": sc.abs().max().item(),
                        "loss": [lsg, lsc, lvg, lvc]}
    log(f"[scan-slice] narrow config (P {sc.shape[0]}), one primed step: "
        f"scan vs vmap (perleaf policy) and card vs CPU, max |diff| "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})} "
        f"(<= {NOISY_ATOL}) | loss {lsg:.6f} / {lsc:.6f}")
    report["phase_s"] = time.perf_counter() - t0
    return report


def slice15_phase(dev) -> tuple:
    """Phase 18: (a) the attention kernels at d_head 80 and 96, (b) both
    archs served at published width and depth and the narrow configs of the
    three newly ported dense archs card vs CPU, (c) the admin masks on
    every tier, (d) the scan tier. Returns ``(record, the attention
    kernels' new sub-rows)``."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.runtime.serving import zipf_requests

    t18 = time.perf_counter()
    rows = check_new_widths(dev, 18)
    report: dict = {"serve": {}, "narrow": {}}
    for arch in DENSE_ARCHS:
        report["serve"][arch] = serve_dense(Session, arch, "dense-serve")
        d = f"d{get_config(arch).d_head}"
        for kernel, sub in (("flash_attention", "direct"),
                            ("paged_attention", "continuous")):
            rows[kernel][d]["launches"] = \
                report["serve"][arch][sub]["launches"].get(kernel, 0)
    x_reqs = zipf_requests(4, 4096, min_len=8, max_len=24, max_new_low=4,
                           max_new_high=8, seed=3)
    widths = {"stablelm-3b": dict(d_model=320, n_heads=4, n_kv_heads=4,
                                  d_head=80),
              "phi3-mini-3.8b": dict(d_model=384, n_heads=4, n_kv_heads=4,
                                     d_head=96),
              "mistral-large-123b": dict(d_model=512, n_heads=4,
                                         n_kv_heads=2, d_head=128)}
    for arch, w in widths.items():
        ncfg = reduce_for_smoke(get_config(arch), n_layers=2, d_ff=512,
                                vocab_size=4096, **w)
        report["narrow"][arch] = dense_cross_device(Session, ncfg, x_reqs,
                                                    "dense-slice")
    report["admin"] = admin_phase(dev)
    report["scan"] = scan_phase(dev)
    report["phase_s"] = time.perf_counter() - t18
    log(f"[slice] phase 18 in {report['phase_s']:.1f} s (admin "
        f"{report['admin']['phase_s']:.1f} s, scan "
        f"{report['scan']['phase_s']:.1f} s)")
    return report, rows


# --------------------------------------------------------------- phase 23
# bf16 serving. Logits of two bf16 runs that round at other places (the
# card's cuBLAS and kernels against the CPU's products and plain versions;
# one serving mode against another on the card, whose attention and batch
# shapes differ) are held to BF16_ATOL, the bound of the port against the
# JAX package in bf16 on the CPU (tests/test_torch_bf16_serving.py: 0.042
# measured at |logit| 3.6, bound 0.1). Two runs' greedy tokens may part
# only at a near-tie: where the reference run's top-2 margin is within
# BF16_TIE; the position and the margin there are printed, and past it
# the two continue from different prefixes and are not compared.
BF16_ATOL = 0.1
BF16_TIE = 2 * BF16_ATOL
# the kernels line's bf16 sub-rows (phase 23(a))
BF16_SUBROWS = ("bf16", "bf16_target", "bf16_verify4", "bf16_chunk16",
                "bf16_d112", "bf16_d80", "bf16_d80_verify4",
                "bf16_d80_chunk16", "bf16_d96", "bf16_d96_verify4",
                "bf16_d96_chunk16")
# the other families in bf16 at published width and depth, and the modes
# each serves in
BF16_FAMILIES = {"zamba2-7b": ("direct", "wave"),
                 "stablelm-3b": ("continuous",),
                 "phi3-mini-3.8b": ("continuous",),
                 "rwkv6-7b": ("direct",)}


@contextlib.contextmanager
def plain_attention_spy(counts: dict):
    """Counts, under ``counts["plain_calls_on_card"]``, the calls of the
    attention and page-pool kernels' plain versions that got a CUDA
    tensor: a bf16 (or fp32) CUDA tensor must reach its kernel or raise."""
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.paged_attention import ref as paged_ref

    counts["plain_calls_on_card"] = 0

    def on_card(x) -> bool:
        if isinstance(x, torch.Tensor):
            return x.is_cuda
        if isinstance(x, (list, tuple)):
            return any(on_card(y) for y in x)
        return False

    real = {}
    for mod, names in ((flash_ref, ("attention_ref", "flash_forward_ref",
                                    "flash_backward_ref")),
                       (paged_ref, ("paged_attention_ref", "paged_reset_ref",
                                    "paged_rollback_ref", "pool_zero_ref"))):
        for name in names:
            fn = getattr(mod, name)
            real[mod, name] = fn

            def spy(*a, _fn=fn, **k):
                counts["plain_calls_on_card"] += on_card(a)
                return _fn(*a, **k)

            setattr(mod, name, spy)
    try:
        yield counts
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def bf16_kernel_rows(dev) -> dict:
    """Phase 23(a): bf16 flash attention at d_head 128 (qwen2.5-3b), 112
    (zamba2-7b), 80 and 96 (stablelm-3b, phi3-mini-3.8b), B 4, S 32; bf16
    paged attention at C 1, 4 and 16 for qwen2.5-3b and at Hkv 32 (d_head
    80, 96); the zeroing kernel on bf16 target and draft pools bit-equal to
    its plain version, then an admission's reset and a tick's rollback as
    ``PagePool`` runs them. Returns ``{kernel: {sub-row: row}}``."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(23)
    rows: dict = {k: {} for k in SERVING_KERNELS}
    qwen = get_config("qwen2.5-3b")
    for arch in ("qwen2.5-3b", "zamba2-7b", *DENSE_ARCHS):
        cfg = get_config(arch)
        sub = "bf16" if arch == "qwen2.5-3b" else f"bf16_d{cfg.d_head}"
        r = check_flash_bf16(cfg, dev, gen, 4, 32, flash_ops, flash_ref, F)
        rows["flash_attention"][sub] = r
        log_attention(f"flash_attention {sub} ({arch})", r)
        log(f"[kernel] flash_attention {sub}: {r['not_bit_equal_share']:.3g}"
            f" of the elements not bit-equal to the plain version, at most "
            f"{r['max_ulps']:.3g} ulps apart ({r['past_one_ulp']} past one "
            f"ulp); {r['model_max_abs_err']:.3g} from its split model; "
            f"two launches bit-equal")
    for arch in ("qwen2.5-3b", *DENSE_ARCHS):
        cfg = get_config(arch)
        d = "bf16" if arch == "qwen2.5-3b" else f"bf16_d{cfg.d_head}"
        for C, sub in ((1, d), (4, f"{d}_verify4"), (16, f"{d}_chunk16")):
            r = check_paged_attention(cfg, dev, gen, 4, 32, 16, C, paged_ops,
                                      paged_ref, F, dtype=bf)
            rows["paged_attention"][sub] = r
            log_attention(f"paged_attention {sub} ({arch})", r)
    check_pool_zero(qwen, dev, gen, paged_ops, paged_ref, dtype=bf)
    events = pool_events(qwen, dev, 23, dtype=bf, ranges=False)
    log_pool_events(events)
    for kernel, name in (("paged_reset", "reset_draft"),
                         ("paged_rollback", "tick")):
        r = {k: x for k, x in events[name].items() if k != "host"}
        rows[kernel]["bf16"] = {
            **r, "max_abs_err": 0.0, "bound_by": "bytes",
            "launch_floor_ms": events["floor"]["device_ms"],
            "library_call": "index_fill_, one call a tensor"}
    rows["paged_reset"]["bf16_target"] = {
        **{k: x for k, x in events["reset"].items() if k != "host"},
        "max_abs_err": 0.0, "bound_by": "bytes"}
    log("[kernel] pool_zero bf16: bit-equal to its plain version over both "
        "whole pools (36 + 4 layers)")
    return rows


def first_splits(ref_reqs, reqs) -> list:
    """(rid, position) of each request's first token that differs."""
    out = []
    for a, b in zip(ref_reqs, reqs):
        j = next((i for i, (x, y) in enumerate(zip(a.generated, b.generated))
                  if x != y), None)
        if j is not None:
            out.append((a.rid, j))
        else:
            check(a.generated == b.generated, f"rid {a.rid}: lengths differ")
    return out


def traced_run(model, params, reqs, kind: str, kw: dict) -> dict:
    """``reqs`` served again in mode ``kind`` with every step's logits kept:
    the continuous scheduler's ``trace_logits``, and for a wave the model's
    prefill and decode calls recorded row by row (keyed by the prompt).
    Returns ``{rid: [logits (V,) a token]}``."""
    from repro_torch.runtime.server import WaveServer
    from repro_torch.runtime.serving import ContinuousServer

    if kind == "wave":
        rows: dict = {}
        wave: list = []

        def add(logits):
            for row, x in zip(wave, logits.float().cpu().numpy()):
                row.append(x)

        def prefill(p, tokens, cache):
            logits = model.prefill(p, tokens, cache)
            wave[:] = [rows.setdefault(t.tobytes(), []) for t in
                       tokens.cpu().numpy().astype(np.int32)]
            add(logits)
            return logits

        def decode(p, tokens, cache):
            logits = model.decode_step(p, tokens, cache)
            add(logits)
            return logits

        srv = WaveServer(dataclasses.replace(model, prefill=prefill,
                                             decode_step=decode), params,
                         max_batch=kw["max_batch"], max_len=kw["max_len"])
        for r in reqs:
            srv.submit(r)
        srv.run_until_drained()
        return {r.rid: rows[np.asarray(r.prompt, np.int32).tobytes()]
                for r in reqs}
    srv = ContinuousServer(model, params, trace_logits=True, **kw)
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return dict(srv.logit_trace)


def hold_modes(model, params, reqs, runs: dict, ref: str, other: str,
               kw: dict, name: str) -> dict:
    """Mode ``other`` held to mode ``ref`` token for token. Where they part,
    both are served again with their logits traced (the same tokens as
    the untraced runs, checked), and each request's logits are held to
    BF16_ATOL up to its first split, where the reference's top-2 margin
    must be within BF16_TIE; the position and the margin are printed."""
    ra, rb = runs[ref][0], runs[other][0]
    splits = first_splits(ra.requests, rb.requests)
    out = {"equal": not splits, "splits": []}
    if not splits:
        log(f"[bf16] {name}: {other} == {ref} token for token")
        return out
    traces, again = {}, {}
    for kind in (ref, other):
        rs = copy.deepcopy(reqs)
        mode = "wave" if kind == "wave" else "continuous"
        traces[kind] = traced_run(model, params, rs, mode,
                                  {**kw, **(runs[kind][2] or {})})
        again[kind] = rs
    for kind, res in ((ref, ra), (other, rb)):
        check([r.generated for r in again[kind]]
              == [r.generated for r in res.requests],
              f"{name}: the traced {kind} run gave other tokens")
    worst = 0.0
    for rid, j in splits:
        ta, tb = traces[ref][rid], traces[other][rid]
        for i in range(j + 1):
            worst = max(worst, float(np.abs(ta[i] - tb[i]).max()))
        top = np.sort(ta[j])[-2:]
        margin = float(top[1] - top[0])
        log(f"[bf16] {name}: rid {rid} parts at token {j}: {ref}'s top-2 "
            f"margin there {margin:.4g} (tie bound {BF16_TIE})")
        check(margin <= BF16_TIE,
              f"{name}: rid {rid} parts at token {j} where {ref}'s margin "
              f"is {margin} > {BF16_TIE}")
        out["splits"].append({"rid": rid, "token": j, "margin": margin})
    check(worst <= BF16_ATOL, f"{name}: logits {worst} apart before a split")
    out["max_abs_logit_diff_to_split"] = worst
    return out


def serve_qwen_bf16(dev) -> dict:
    """Phase 23(b): qwen2.5-3b at 36 layers in bf16 (fp32 weights cast in
    the forward pass) through ``Session.serve``: direct, wave, continuous
    and speculative (spec_k 4, a 4-layer draft over prefix sharing), the
    variant counts zeroed just before each and read just after, peak
    memory of each; the mode invariants (continuous == wave, speculative
    == continuous, up to near-ties); ``api.serve`` direct equal to the
    session's; the soak through ``run_soak`` and through the CLI
    (``--soak`` writes to a temporary ``--out``); bf16 weights through
    ``build_model(param_dtype=bf16)`` in a ``Session``, direct and
    continuous."""
    import tempfile

    from repro_torch import api
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import run_soak
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serving import PagePool, zipf_requests

    bf = torch.bfloat16
    sess = api.Session.from_config("qwen2.5-3b", full=True, compute_dtype=bf,
                                   seed=0)
    cfg, L, V = sess.cfg, sess.cfg.n_layers, sess.cfg.vocab_size
    params = sess.init_params()
    sess.serve(batch_size=4, prompt_len=32, max_new_tokens=2, params=params)
    reqs = zipf_requests(8, V, min_len=8, max_len=48, max_new_low=8,
                         max_new_high=24, seed=0)
    kw = dict(max_batch=4, max_len=512, page_size=16, prefill_chunk=16)
    spec = dict(speculative=True, spec_k=4, draft_layers=4,
                prefix_sharing=True)
    out: dict = {"config": f"qwen2.5-3b published width, {L} layers, bf16 "
                           f"compute, fp32 weights"}
    runs = {}
    for kind, opts in (("direct", None), ("wave", {}), ("continuous", {}),
                       ("speculative", spec)):
        torch.cuda.reset_peak_memory_stats()
        with rollback_ticks(PagePool) as ticks:
            dispatch.reset_launches()
            if opts is None:
                res = sess.serve(batch_size=4, prompt_len=32,
                                 max_new_tokens=16, params=params)
            else:
                res = sess.serve(scheduler="wave" if kind == "wave"
                                 else "continuous",
                                 requests=copy.deepcopy(reqs), params=params,
                                 **kw, **opts)
            var = dispatch.variant_counts()
            n = {k: v for k, v in dispatch.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated()
        runs[kind] = (res, var, opts)
        check(all(v.get("f32", 0) == 0 for v in var.values()),
              f"bf16 {kind} launched an fp32 instantiation: {var}")
        if opts is None:
            check(res.tokens.shape == (4, 16) and res.logits.dtype == bf
                  and bool(torch.isfinite(res.logits).all()),
                  "bf16 direct tokens or logits")
            check(n == {"flash_attention": L}
                  and var["flash_attention"]["bf16"] == L,
                  f"bf16 direct launches {n}")
            rec = {"prefill_ms": res.prefill_s * 1e3,
                   "decode_ms_per_token": res.decode_s_per_token * 1e3,
                   "decode_tok_per_s": 4 / res.decode_s_per_token}
        else:
            st = res.stats
            check(st.drained, f"bf16 {kind} did not drain")
            admissions = len(reqs) + st.preemptions
            if kind == "wave":
                check(n == {"flash_attention": L * st.waves},
                      f"bf16 wave launches {n} for {st.waves} waves")
            else:
                check(var["paged_reset"]["bf16"] == admissions
                      and var["paged_attention"]["bf16"] > 0
                      and "flash_attention" not in n,
                      f"bf16 {kind} launches {n} for {admissions} "
                      f"admissions")
            if kind == "speculative":
                check(var["paged_rollback"]["bf16"] == ticks[0] > 0,
                      f"bf16 speculative rolled back "
                      f"{var['paged_rollback']['bf16']}x for {ticks[0]} "
                      f"ticks with a tail")
            rec = {"useful_tokens": st.useful_tokens,
                   "tok_per_s": 1 / res.decode_s_per_token,
                   "decode_ms_per_step": res.decode_s_per_token * 1e3
                   * st.useful_tokens / max(st.decode_steps, 1),
                   "decode_steps": st.decode_steps,
                   "utilization": st.utilization,
                   "p50_latency_steps": st.p50_latency_steps,
                   "p99_latency_steps": st.p99_latency_steps}
            if kind == "speculative":
                rec.update(acceptance=st.acceptance_rate,
                           ticks_rolled_back=ticks[0])
        out[kind] = {**rec, "launches": n, "variants": var,
                     "peak_mem_gb": peak / 1e9}
        log(f"[bf16] qwen2.5-3b {kind}: " + json.dumps(
            {k: x for k, x in out[kind].items() if k != "variants"}))
    out["continuous_vs_wave"] = hold_modes(
        sess.model, params, reqs, runs, "wave", "continuous", kw,
        "continuous vs wave")
    out["speculative_vs_continuous"] = hold_modes(
        sess.model, params, reqs, runs, "continuous", "speculative", kw,
        "speculative vs continuous")
    # the one-call entry point: the same seed, the same weights, the tokens
    # of the session's direct run
    dispatch.reset_launches()
    one = api.serve("qwen2.5-3b", full=True, compute_dtype=bf, seed=0,
                    batch_size=4, prompt_len=32, max_new_tokens=16)
    var = dispatch.variant_counts()
    check(bool((one.tokens == runs["direct"][0].tokens).all())
          and var["flash_attention"] == {"f32": 0, "bf16": L, "lse_f32": 0,
                                         "lse_bf16": 0},
          f"api.serve bf16: tokens differ from Session.serve's or launches "
          f"{var['flash_attention']}")
    out["api_serve"] = {"tokens_equal_session": True,
                        "launches": var["flash_attention"]}
    log("[bf16] api.serve(full=True, compute_dtype=bf16) direct == "
        "Session.serve direct token for token")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dispatch.reset_launches()
        row, soak_s = timed(lambda: run_soak(
            sess, 8, max_batch=4, page_size=16, prefill_chunk=16, window=4,
            out=Path(tmp) / "soak.json"))
        var = dispatch.variant_counts()
        check(row["requests"] == 8 and row["rolling_p99_worst"] is not None
              and json.loads((Path(tmp) / "soak.json").read_text())[
                  "serve/soak"] == row
              and var["paged_attention"]["f32"] == 0
              and var["paged_attention"]["bf16"] > 0,
              f"bf16 soak row {row}, launches {var}")
        out["soak"] = {**row, "s": soak_s}
        log(f"[bf16] run_soak, 8 Zipf requests, 4 slots, window 4: "
            f"{json.dumps(row)} in {soak_s:.1f} s")
        cli = [sys.executable, "-m", "repro_torch.launch.serve", "--full",
               "--soak", "4", "--max-batch", "4", "--window", "2", "--out",
               str(Path(tmp) / "cli.json")]
        t0 = time.perf_counter()
        r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                           timeout=600, env={**os.environ,
                                             "PYTHONPATH": str(ROOT / "src")})
        check(r.returncode == 0 and "rolling p99" in r.stdout
              and "device=cuda" in r.stdout
              and "serve/soak" in (Path(tmp) / "cli.json").read_text(),
              f"soak CLI failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
        last = next(x for x in r.stdout.splitlines() if "rolling p99" in x)
        out["cli_soak"] = {"cmd": " ".join(cli[1:-1]) + " <tmp>",
                           "s": time.perf_counter() - t0, "last": last}
        log(f"[cli] {out['cli_soak']['cmd']} (fp32: the CLI has no dtype "
            f"flag, as JAX's): exit 0 in {out['cli_soak']['s']:.1f} s | "
            f"{last}")
    del params, sess, runs
    torch.cuda.empty_cache()
    # bf16 weights, as JAX's build_model(param_dtype=jnp.bfloat16)
    model = build_model(cfg, dev, param_dtype=bf, compute_dtype=bf)
    s16 = api.Session(cfg=cfg, run_cfg=RunConfig(model=cfg), model=model,
                      device=dev, seed=0)
    p16, init_s = timed(s16.init_params)
    check(all(p.dtype == bf for p in p16.parameters()), "bf16 weights")
    n_params = sum(p.numel() for p in p16.parameters())
    rec = {"n_params": n_params, "weights_gb": n_params * 2 / 1e9,
           "init_s": init_s}
    for kind in ("direct", "continuous"):
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        if kind == "direct":
            res = s16.serve(batch_size=4, prompt_len=32, max_new_tokens=16,
                            params=p16)
            check(bool(torch.isfinite(res.logits).all()),
                  "bf16 weights: direct logits")
            r = {"prefill_ms": res.prefill_s * 1e3,
                 "decode_ms_per_token": res.decode_s_per_token * 1e3}
        else:
            res = s16.serve(scheduler="continuous",
                            requests=copy.deepcopy(reqs), params=p16, **kw)
            check(res.stats.drained, "bf16 weights: continuous did not drain")
            r = {"tok_per_s": 1 / res.decode_s_per_token,
                 "decode_steps": res.stats.decode_steps}
        var = dispatch.variant_counts()
        check(all(v.get("f32", 0) == 0 for v in var.values()),
              f"bf16 weights {kind}: an fp32 instantiation ran: {var}")
        rec[kind] = {**r, "peak_mem_gb": torch.cuda.max_memory_allocated()
                     / 1e9, "launches": {k: v for k, v in
                                         dispatch.launch_counts().items()
                                         if v}}
    out["bf16_weights"] = rec
    log(f"[bf16] qwen2.5-3b bf16 weights ({rec['weights_gb']:.2f} GB) "
        f"through build_model(param_dtype=bf16): {json.dumps(rec)}")
    del p16, s16, model
    torch.cuda.empty_cache()
    return out


def serve_family_bf16(arch: str, modes: tuple) -> dict:
    """Phase 23(c): one family in bf16 at published width and depth, fp32
    weights, through ``Session.serve`` in ``modes`` (8 Zipf requests through
    4 slots for the scheduler modes), the launches of each; for the ssm
    family a whole-prompt prefill too, the WKV scan (rows 11-12 take fp32:
    both packages widen the scan inputs)."""
    from repro_torch.api import Session
    from repro_torch.kernels import dispatch
    from repro_torch.runtime.serving import zipf_requests

    bf = torch.bfloat16
    sess = Session.from_config(arch, full=True, compute_dtype=bf, seed=0)
    cfg, L, V = sess.cfg, sess.cfg.n_layers, sess.cfg.vocab_size
    params, init_s = timed(sess.init_params)
    sess.serve(batch_size=4, prompt_len=8, max_new_tokens=2, params=params)
    reqs = zipf_requests(8, V, min_len=8, max_len=48, max_new_low=8,
                         max_new_high=24, seed=0)
    out = {"config": f"{arch} published width and depth ({L} layers), bf16 "
                     f"compute, fp32 weights", "init_s": init_s}
    for kind in modes:
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        if kind == "direct":
            res = sess.serve(batch_size=4, prompt_len=32, max_new_tokens=16,
                             params=params)
            check(bool(torch.isfinite(res.logits).all())
                  and res.tokens.shape == (4, 16), f"{arch} bf16 direct")
            rec = {"prefill_ms": res.prefill_s * 1e3,
                   "decode_ms_per_token": res.decode_s_per_token * 1e3,
                   "decode_tok_per_s": 4 / res.decode_s_per_token}
        else:
            res = sess.serve(scheduler=kind, requests=copy.deepcopy(reqs),
                             params=params, max_batch=4, max_len=512,
                             page_size=16, prefill_chunk=16)
            st = res.stats
            check(st.drained, f"{arch} bf16 {kind} did not drain")
            rec = {"tok_per_s": 1 / res.decode_s_per_token,
                   "decode_ms_per_step": res.decode_s_per_token * 1e3
                   * st.useful_tokens / max(st.decode_steps, 1),
                   "decode_steps": st.decode_steps,
                   "utilization": st.utilization}
        var = dispatch.variant_counts()
        n = {k: v for k, v in dispatch.launch_counts().items() if v}
        check(all(v.get("f32", 0) == 0 for v in var.values()),
              f"{arch} bf16 {kind}: an fp32 instantiation ran: {var}")
        if cfg.family == "hybrid":
            per = {"ssd": L, "flash_attention": L // cfg.attn_every}
            waves = res.stats.waves if kind == "wave" else 1
            check(n == {k: v * waves for k, v in per.items()},
                  f"{arch} bf16 {kind} launches {n}")
        elif cfg.family == "dense":
            check(set(n) == {"paged_attention", "paged_reset"}
                  and n["paged_attention"] % L == 0
                  and var["paged_reset"]["bf16"] == len(reqs)
                  + res.stats.preemptions,
                  f"{arch} bf16 {kind} launches {n}")
        else:
            check(not n, f"{arch} bf16 direct launched {n}")
        out[kind] = {**rec, "launches": n,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"[bf16] {arch} {kind}: {json.dumps(out[kind])}")
    if cfg.family == "ssm":
        prompt = torch.randint(0, V, (4, 32), generator=torch.Generator(
            ).manual_seed(5)).to(sess.device)
        cache = sess.model.init_cache(4, 48)
        dispatch.reset_launches()
        with torch.inference_mode():
            logits, scan_s = timed(lambda: sess.model.prefill(params, prompt,
                                                              cache))
        n = {k: v for k, v in dispatch.launch_counts().items() if v}
        check(n == {"wkv": L} and logits.dtype == bf
              and bool(torch.isfinite(logits).all()),
              f"{arch} bf16 whole-prompt prefill launches {n}")
        out["scan_prefill"] = {"ms": scan_s * 1e3, "launches": n}
        log(f"[bf16] {arch} whole-prompt prefill, batch 4 x 32: "
            f"{scan_s * 1e3:.2f} ms | launches {n} (the scan in fp32)")
    del params, sess
    torch.cuda.empty_cache()
    return out


def bf16_cross_device(seed: int = 23) -> dict:
    """Phase 23(d): a narrow qwen2.5-3b (2 layers, d_model 512, d_head 128,
    Hkv 2) in bf16 on the card and on the host CPU from the same weights:
    the logits of a dense prefill, 3 decode steps, a paged prefill chunk
    and 3 paged decode steps (``slice_logits``: flash, paged attention and
    the reset) within BF16_ATOL."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.kernels import dispatch
    from repro_torch.runtime.serving import PagePool

    bf = torch.bfloat16
    ncfg = reduce_for_smoke(get_config("qwen2.5-3b"), n_layers=2,
                            d_model=512, n_heads=4, n_kv_heads=2, d_head=128,
                            d_ff=1024, vocab_size=4096)
    on = {d: Session.from_config(ncfg, device=d, compute_dtype=bf, seed=seed)
          for d in ("cuda", "cpu")}
    p_cpu = on["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to(on["cuda"].device)
    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, ncfg.vocab_size, (2, 24), generator=g)
    steps = [torch.randint(0, ncfg.vocab_size, (2,), generator=g)
             for _ in range(3)]
    dispatch.reset_launches()
    got = slice_logits(on["cuda"].model, p_gpu, PagePool, prompt, steps)
    var = dispatch.variant_counts()
    want = slice_logits(on["cpu"].model, p_cpu, PagePool, prompt, steps)
    check(dispatch.variant_counts() == var, "the CPU run launched a kernel")
    check(all(var[k]["bf16"] > 0 and var[k]["f32"] == 0
              for k in ("flash_attention", "paged_attention", "paged_reset")),
          f"the card's bf16 slice: {var}")
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    top = max(b.abs().max().item() for b in want)
    check(err <= BF16_ATOL, f"bf16 card vs CPU logits differ by {err} "
                            f"(|logit| up to {top})")
    log(f"[bf16-slice] narrow qwen2.5-3b (2 layers, d_model 512, d_head 128)"
        f" in bf16, card vs CPU: max |logit diff| {err:.4g} (|logit| up to "
        f"{top:.3g}; bound {BF16_ATOL}) | card launches "
        f"{ {k: v['bf16'] for k, v in var.items() if k in SERVING_KERNELS} }")
    return {"max_abs_err": err, "max_abs_logit": top, "atol": BF16_ATOL}


def bf16_phase(dev) -> tuple:
    """Phase 23: bf16 serving on the card. (a) the kernels' bf16
    instantiations against their plain versions, timed; (b) qwen2.5-3b at
    36 layers in every mode, through ``Session`` and ``api.serve``, the
    soak, bf16 weights; (c) zamba2-7b, stablelm-3b, phi3-mini-3.8b and
    rwkv6-7b at published size; (d) card vs CPU at narrow width. No plain
    version of an attention or page-pool kernel runs on the card
    (``plain_attention_spy``). Returns ``(record, {kernel: {sub-row:
    row}})``; the main path's bf16 launches are in the record's ``qwen``
    runs."""
    t0 = time.perf_counter()
    rows = bf16_kernel_rows(dev)
    rec: dict = {}
    spy: dict = {}
    with plain_attention_spy(spy):
        rec["qwen"] = serve_qwen_bf16(dev)
        rec["families"] = {arch: serve_family_bf16(arch, modes)
                           for arch, modes in BF16_FAMILIES.items()}
        rec["cross_device"] = bf16_cross_device()
    check(spy["plain_calls_on_card"] == 0,
          f"{spy['plain_calls_on_card']} plain attention calls on the card")
    rec["plain_calls_on_card"] = 0
    q = rec["qwen"]
    rows["flash_attention"]["bf16"]["launches"] = \
        q["direct"]["variants"]["flash_attention"]["bf16"]
    rows["paged_attention"]["bf16"]["launches"] = \
        q["continuous"]["variants"]["paged_attention"]["bf16"]
    rows["paged_reset"]["bf16"]["launches"] = \
        q["speculative"]["variants"]["paged_reset"]["bf16"]
    rows["paged_rollback"]["bf16"]["launches"] = \
        q["speculative"]["variants"]["paged_rollback"]["bf16"]
    fam = rec["families"]
    rows["flash_attention"]["bf16_d112"]["launches"] = \
        fam["zamba2-7b"]["direct"]["launches"]["flash_attention"]
    for arch in DENSE_ARCHS:
        d = f"bf16_d{'80' if arch == 'stablelm-3b' else '96'}"
        rows["paged_attention"][d]["launches"] = \
            fam[arch]["continuous"]["launches"]["paged_attention"]
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[bf16] phase 23 in {rec['phase_s']:.1f} s; no plain attention "
        f"or page-pool call on the card")
    return rec, rows


# --------------------------------------------------------------- phase 24
# the MoE, VLM and encoder families at published width, their depth cut to
# fit one 80 GB card in fp32 (4 bytes a weight): phi3.5-moe 8 of 32 layers
# (10.7 B weights, 42.7 GB), qwen3-moe 4 of 94 (11.2 B, 44.8 GB), qwen2-vl
# 8 of 80 (9.5 B, 38.0 GB); hubert-xlarge whole (1.26 B); the MoE training
# cell phi3.5-moe at 1 layer (P about 1.56 B, 7 copies on the fused tier)
PHI, QWEN3, VL, HUBERT = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
                          "qwen2-vl-72b", "hubert-xlarge")
FAMILY_LAYERS = {PHI: 8, QWEN3: 4, VL: 8}
FAMILY_MODES = {PHI: ("direct", "wave", "continuous"),
                QWEN3: ("direct", "continuous"), VL: ("direct",)}
MOE_TRAIN_LAYERS = 1


def family_kernel_rows(dev, seed: int) -> dict:
    """Phase 24(a): flash attention at B 4, S 32 and paged attention at
    C 1, 4 and 16 (4 slots of 32 pages of 16) at phi3.5-moe's and
    qwen3-moe's heads, flash at qwen2-vl's, and flash without the causal
    mask at hubert-xlarge's shape (B 4, S 64, 16 heads, MHA, d_head 80;
    on no main path yet), each against its plain version and timed as
    phase 3 times its rows. Returns ``{kernel: {sub-row: row}}``."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows: dict = {"flash_attention": {}, "paged_attention": {}}
    for arch, g in ((PHI, "g4"), (QWEN3, "g16")):
        cfg = get_config(arch)
        r = check_flash(cfg, dev, gen, 4, 32, flash_ops, flash_ref, F)
        rows["flash_attention"][g] = r
        log_attention(f"flash_attention {g} ({arch})", r)
        for C, sub in ((1, g), (4, f"{g}_verify4"), (16, f"{g}_chunk16")):
            r = check_paged_attention(cfg, dev, gen, 4, 32, 16, C, paged_ops,
                                      paged_ref, F)
            rows["paged_attention"][sub] = r
            log_attention(f"paged_attention {sub} ({arch})", r)
    r = check_flash(get_config(VL), dev, gen, 4, 32, flash_ops, flash_ref, F)
    rows["flash_attention"]["vl64x8"] = r
    log_attention(f"flash_attention vl64x8 ({VL})", r)
    r = check_flash(get_config(HUBERT), dev, gen, 4, 64, flash_ops, flash_ref,
                    F, causal=False)
    r["launches"] = 0  # hubert-xlarge trains; no main path prefills it yet
    rows["flash_attention"]["noncausal_d80"] = r
    log_attention(f"flash_attention noncausal_d80 ({HUBERT})", r)
    return rows


def mrope_ids(B: int, S: int, dev, gen) -> torch.Tensor:
    """Distinct (3, B, S) M-RoPE ids: t the token index, h and w a patch
    grid's rows and columns."""
    t = torch.arange(S, device=dev).expand(B, S)
    h = torch.randint(0, 5, (B, S), device=dev, generator=gen) \
        + torch.arange(S, device=dev) // 4
    w = torch.randint(0, 7, (B, S), device=dev, generator=gen) \
        + 2 * (torch.arange(S, device=dev) % 4)
    return torch.stack([t, h, w])


def vlm_embeds_prefill(sess, params, log_name: str) -> dict:
    """Phase 24(d): qwen2-vl's prefill on frontend ``embeds`` (B 4, S 32,
    d 8192) with distinct (3, B, S) M-RoPE ids through flash (once a
    layer): its last logits equal those of ``forward`` without a cache
    (the training path's plain attention) within CROSS_ATOL / CROSS_RTOL,
    and differ from plain positions' (the ids reach the rotation)."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer

    cfg, dev = sess.cfg, sess.device
    gen = torch.Generator(device=dev).manual_seed(24)
    B, S = 4, 32
    embeds = torch.randn(B, S, cfg.d_model, device=dev, generator=gen)
    pos = mrope_ids(B, S, dev, gen)
    cache = sess.model.init_cache(B, S)
    dispatch.reset_launches()
    with torch.inference_mode():
        last, s = timed(lambda: sess.model.prefill(
            params, None, cache, embeds=embeds, positions=pos))
        n = {k: v for k, v in dispatch.launch_counts().items() if v}
        full = transformer.forward(params, cfg, None, logits_mode="last",
                                   embeds=embeds, positions=pos)[:, 0]
        plain = transformer.forward(params, cfg, None, logits_mode="last",
                                    embeds=embeds)[:, 0]
    check(n == {"flash_attention": cfg.n_layers},
          f"{cfg.name} embeds prefill launches {n}")
    err = (last - full).abs().max().item()
    moved = (plain - full).abs().max().item()
    top = full.abs().max().item()
    check(bool(torch.isfinite(last).all())
          and torch.allclose(last, full, atol=CROSS_ATOL, rtol=CROSS_RTOL),
          f"{cfg.name} embeds prefill vs forward: {err} (|logit| {top})")
    check(moved > 10 * CROSS_ATOL, f"{cfg.name}: M-RoPE ids moved the "
          f"logits by only {moved}")
    log(f"[{log_name}] {cfg.name} prefill on embeds (4 x 32 x "
        f"{cfg.d_model}) with distinct (3, B, S) M-RoPE ids: {s * 1e3:.2f} "
        f"ms, launches {n} | last logits vs forward without a cache: max "
        f"|diff| {err:.3g} (|logit| up to {top:.3g}) | plain positions "
        f"move them by {moved:.3g}")
    return {"ms": s * 1e3, "launches": n, "max_abs_err": err,
            "max_abs_logit": top, "plain_positions_diff": moved}


def frame_batches(cfg, dev, B: int = 16, S: int = 64, seed: int = 24):
    """hubert-xlarge's frontend stub: frame ``embeds`` (B, S, d_model) and
    labels over its 504-entry codebook, drawn on the card from a seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def next_batch():
        return {"embeds": torch.randn(B, S, cfg.d_model, device=dev,
                                      generator=gen),
                "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                        device=dev, generator=gen)}

    return next_batch


def moe_grad_repeat(Session, cfg, priv, opt, log_name: str) -> dict:
    """Phase 24(f): every silo's packed gradient of one batch (16 x 64
    over 4 silos) of the MoE training cell, computed twice, bit-equal: the
    dispatch's scatter (``index_add``) and the gather's backward add one
    real row and exact zeros into each destination; and the loss holds
    the aux load-balance term (``AUX_LOSS_WEIGHT`` times it above the LM
    loss)."""
    from repro_torch.core import flatbuf
    from repro_torch.models import transformer
    from repro_torch.models.layers import chunked_lm_loss
    from repro_torch.models.packing import param_tree

    sess = Session.from_config(cfg, privacy=priv, optimizer=opt, seed=1)
    state = sess.init_state()
    batch = sess.synthetic_batches(16, 64)()
    equal, t0 = [], time.perf_counter()
    for i in range(4):
        a, na = silo_grads_packed(sess.model, state.params, batch,
                                  state.layout, i, 4, flatbuf, param_tree)
        b, nb = silo_grads_packed(sess.model, state.params, batch,
                                  state.layout, i, 4, flatbuf, param_tree)
        torch.cuda.synchronize()
        equal.append(bool(torch.equal(bits(a), bits(b)))
                     and bits(na).item() == bits(nb).item())
        del a, b
    s = time.perf_counter() - t0
    check(all(equal), f"{cfg.name}: repeated silo gradients differ "
          f"({equal})")
    with torch.no_grad():
        b0 = {k: v[:4] for k, v in batch.items()}
        loss = sess.model.loss(state.params, b0).item()
        hidden = transformer.forward(state.params, cfg, b0["tokens"],
                                     logits_mode="hidden")
        lm = chunked_lm_loss(hidden, state.params.head(),
                             b0["labels"]).item()
    aux = (loss - lm) / transformer.AUX_LOSS_WEIGHT
    check(math.isfinite(loss) and aux > 0.5,
          f"{cfg.name}: loss {loss}, LM loss {lm}: no aux term")
    P = state.layout.total
    log(f"[{log_name}] {cfg.name} ({cfg.n_layers} layer, P {P}): 4 silos' "
        f"packed gradients computed twice, bit-equal ({s:.1f} s) | silo 0 "
        f"loss {loss:.6f} = LM {lm:.6f} + {transformer.AUX_LOSS_WEIGHT} x "
        f"aux {aux:.4f}")
    del state, sess, batch
    torch.cuda.empty_cache()
    return {"P": P, "silos_bit_equal": equal, "s": s, "loss": loss,
            "lm_loss": lm, "aux": aux}


def families_phase(dev) -> tuple:
    """Phase 24: the MoE, VLM and encoder families. (a) the attention
    kernels at their heads; (b) phi3.5-moe served in every mode, and card
    vs CPU at 1 layer; (c) qwen3-moe direct and continuous (paged
    attention at G 16); (d) qwen2-vl direct, and a prefill on embeds with
    M-RoPE ids; (e) hubert-xlarge trained on frame embeds, 3 fused steps
    and 1 barrier step; (f) phi3.5-moe at 1 layer, 2 fused steps and its
    gradients bit-equal when repeated. No plain attention call on the card
    through (b)-(f). Returns ``(record, {kernel: {sub-row: row}})``."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          PrivacyConfig)
    from repro_torch.runtime.serving import zipf_requests

    t0 = time.perf_counter()
    rows = family_kernel_rows(dev, 24)
    rec: dict = {"serve": {}}
    spy: dict = {}
    with plain_attention_spy(spy):
        for arch in (PHI, QWEN3, VL):
            cut = dataclasses.replace(get_config(arch),
                                      n_layers=FAMILY_LAYERS[arch])
            # at the published capacity factor an MoE layer drops tokens,
            # as many as the batch's shape makes it drop, so the modes are
            # not held to each other's tokens; the 1-layer slice below holds
            # each mode on the card to the same mode on the CPU
            rec["serve"][arch], sess, params, _ = serve_modes(
                Session, cut, FAMILY_MODES[arch], "families-serve")
            if arch == VL:
                rec["serve"][arch]["embeds_prefill"] = vlm_embeds_prefill(
                    sess, params, "families-serve")
            del sess, params
            torch.cuda.empty_cache()
        cut1 = dataclasses.replace(get_config(PHI),
                                   n_layers=MOE_TRAIN_LAYERS)
        x_reqs = zipf_requests(4, cut1.vocab_size, min_len=8, max_len=24,
                               max_new_low=4, max_new_high=8, seed=3)
        t_x = time.perf_counter()
        rec["cross_device"] = dense_cross_device(Session, cut1, x_reqs,
                                                 "families-slice")
        rec["cross_device"]["s"] = time.perf_counter() - t_x
        torch.cuda.empty_cache()
        priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                             dynamic_clip=True, noise_lambda=0.7, n_silos=4)
        priv_b = dataclasses.replace(priv, sync_path="barrier")
        opt = OptimizerConfig(name="adamw", lr=1e-3)
        hub = get_config(HUBERT)
        rec["train"] = {HUBERT: {
            "fused": train_cell(Session, hub, priv, opt, None, 3,
                                {"clip_accumulate": 1, "noise_batch": 1},
                                "families-train", frame_batches(hub, dev)),
            "barrier": train_cell(Session, hub, priv_b, opt,
                                  MeshConfig((4,), ("data",)), 1,
                                  {"clip_mask": 4}, "families-barrier",
                                  frame_batches(hub, dev))}}
        rec["train"][PHI] = {
            "fused": train_cell(Session, cut1, priv, opt, None, 2,
                                {"clip_accumulate": 1, "noise_batch": 1},
                                "families-train"),
            "repeat": moe_grad_repeat(Session, cut1, priv, opt,
                                      "families-train")}
    check(spy["plain_calls_on_card"] == 0,
          f"{spy['plain_calls_on_card']} plain attention calls on the card")
    rec["plain_calls_on_card"] = 0
    srv = rec["serve"]
    for g, arch in (("g4", PHI), ("g16", QWEN3)):
        rows["flash_attention"][g]["launches"] = \
            srv[arch]["direct"]["launches"]["flash_attention"]
        rows["paged_attention"][g]["launches"] = \
            srv[arch]["continuous"]["launches"]["paged_attention"]
    rows["flash_attention"]["vl64x8"]["launches"] = \
        srv[VL]["direct"]["launches"]["flash_attention"] \
        + srv[VL]["embeds_prefill"]["launches"]["flash_attention"]
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[families] phase 24 in {rec['phase_s']:.1f} s; no plain "
        f"attention or page-pool call on the card")
    return rec, rows


# --------------------------------------------------------------- phase 29
# speculative serving of the MoE family (--moespec only): phase 24's depths
# at published width and capacity factor, spec_k 4, a 1-layer early-exit
# draft and the self-draft, in fp32 and in bf16 compute
MOESPEC_LAYERS = {PHI: 8, QWEN3: 4}
MOESPEC_DRAFTS = (1, None)
MOESPEC_DTYPES = (torch.float32, torch.bfloat16)
# card vs CPU at 1 layer: logits within phase 24's gate (fp32) or phase
# 23's (bf16) up to a request's first split, which only a near-tie of the
# CPU's top-2 margin may cause
MOESPEC_GATES = {torch.float32: (CROSS_ATOL, 2 * CROSS_ATOL),
                 torch.bfloat16: (BF16_ATOL, BF16_TIE)}


@contextlib.contextmanager
def paged_forward_calls():
    """Counts, in the dict it yields, the paged forward's calls and the
    layers they ran (``transformer.forward_paged``, the target's and the
    draft's): each layer of each call is one ``paged_attention`` launch."""
    from repro_torch.models import transformer

    real = transformer.forward_paged
    calls = {"calls": 0, "layers": 0}

    def spy(params, cfg, *a, **k):
        calls["calls"] += 1
        calls["layers"] += cfg.n_layers
        return real(params, cfg, *a, **k)

    transformer.forward_paged = spy
    try:
        yield calls
    finally:
        transformer.forward_paged = real


def moespec_serve(Session, cfg, params, dtype, draft, reqs, card: str,
                  tag: str) -> dict:
    """Phase 29(b): one speculative continuous serve of ``reqs`` (4 slots,
    page 16, chunk 16, spec_k 4, ``draft`` layers or the self-draft) in
    ``dtype`` compute over the fp32 ``params``. It drains; paged attention
    launches once a layer of each paged forward (draft steps, verifies,
    prefill chunks), ``paged_reset`` once an admission, ``paged_rollback``
    once a tick with a tail, all on ``dtype``'s instantiation, and nothing
    else."""
    from repro_torch.kernels import dispatch
    from repro_torch.runtime.serving import PagePool

    sess = Session.from_config(cfg, seed=0, compute_dtype=dtype)
    var = dispatch.DTYPE_VARIANTS[dtype]
    with rollback_ticks(PagePool) as ticks, paged_forward_calls() as calls:
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        res, wall = timed(lambda: sess.serve(
            scheduler="continuous", requests=copy.deepcopy(reqs),
            params=params, max_batch=4, max_len=512, page_size=16,
            prefill_chunk=16, speculative=True, spec_k=4,
            draft_layers=draft))
        n = {k: v for k, v in dispatch.launch_counts().items() if v}
        variants = dispatch.variant_counts()
    st = res.stats
    V = cfg.vocab_size
    check(st.drained and len(st.latencies) == len(reqs),
          f"{tag}: did not drain")
    check(bool((res.tokens < V).all()) and bool((res.tokens >= 0).any()),
          f"{tag}: tokens")
    check(st.spec_proposed > 0, f"{tag}: no proposals")
    admissions = len(reqs) + st.preemptions
    want = {"paged_attention": calls["layers"], "paged_reset": admissions,
            "paged_rollback": ticks[0]}
    check(n == {k: v for k, v in want.items() if v},
          f"{tag}: launches {n}, expected {want}")
    for name, count in n.items():
        check(variants[name][var] == count,
              f"{tag}: {name} launched {variants[name]}, all {var} expected")
    steps = max(st.decode_steps, 1)
    out = {"draft_layers": draft, "dtype": DTYPE_NAMES[dtype],
           "wall_s": wall, "useful_tokens": st.useful_tokens,
           "tok_per_s": 1 / res.decode_s_per_token,
           "decode_ms_per_tick": res.decode_s_per_token * 1e3
           * st.useful_tokens / steps,
           "decode_steps": st.decode_steps,
           "spec_proposed": st.spec_proposed,
           "spec_accepted": st.spec_accepted,
           "acceptance": st.acceptance_rate,
           "ticks_rolled_back": ticks[0], "paged_forwards": calls["calls"],
           "launches": n, "peak_mem_gb":
               torch.cuda.max_memory_allocated() / 1e9, "card": card}
    log(f"[moespec] {tag}: {len(reqs)} requests, 4 slots: "
        f"{st.useful_tokens} tokens in {wall:.2f} s, {out['tok_per_s']:.1f} "
        f"tok/s | decode {out['decode_ms_per_tick']:.2f} ms a tick | "
        f"acceptance {st.acceptance_rate:.3f} ({st.spec_accepted}/"
        f"{st.spec_proposed}) | {ticks[0]} ticks rolled back | launches {n} "
        f"({calls['calls']} paged forwards) | peak {out['peak_mem_gb']:.2f} "
        f"GB | {card}")
    return out


def moespec_cross_device(Session, cfg1, dtype, reqs, card: str) -> dict:
    """Phase 29(c): ``cfg1`` (1 layer, published width and capacity) on the
    card and on the host CPU from the same weights, the self-draft (at
    capacity 1.25 the verify chunk drops other picks than the draft's
    single rows, so it rejects too): the same tokens, proposals and
    acceptances, the logit traces within ``MOESPEC_GATES``; a request may
    part only where the CPU's top-2 margin is within the tie bound (then
    its proposals and acceptances are not compared)."""
    from repro_torch.kernels import dispatch
    from repro_torch.runtime.serving import ContinuousServer

    atol, tie = MOESPEC_GATES[dtype]
    on = {d: Session.from_config(cfg1, device=d, seed=7, compute_dtype=dtype)
          for d in ("cuda", "cpu")}
    p_cpu = on["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to(on["cuda"].device)
    kw = dict(max_batch=2, max_len=64, page_size=16, prefill_chunk=16,
              speculative=True, spec_k=4, trace_logits=True)
    srv, rs, launches = {}, {}, {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        dispatch.reset_launches()
        rs[d] = copy.deepcopy(reqs)
        srv[d] = ContinuousServer(on[d].model, p, **kw)
        for r in rs[d]:
            srv[d].submit(r)
        srv[d].run_until_drained()
        launches[d] = {k: v for k, v in dispatch.launch_counts().items()
                       if v}
    check(not launches["cpu"] and launches["cuda"].get("paged_attention"),
          f"{cfg1.name} 1-layer launches: card {launches['cuda']}, CPU "
          f"{launches['cpu']}")
    worst, splits = 0.0, []
    for a, b in zip(rs["cuda"], rs["cpu"]):
        ta, tb = srv["cuda"].logit_trace[a.rid], srv["cpu"].logit_trace[b.rid]
        for j, (x, y) in enumerate(zip(ta[:len(b.generated)], tb)):
            worst = max(worst, float(np.abs(x - y).max()))
            if a.generated[j] != b.generated[j]:
                top = np.sort(y)[-2:]
                margin = float(top[1] - top[0])
                check(margin <= tie, f"{cfg1.name} {DTYPE_NAMES[dtype]}: "
                      f"rid {a.rid} parts at token {j} where the CPU's "
                      f"margin is {margin} > {tie}")
                splits.append({"rid": a.rid, "token": j, "margin": margin})
                break
        else:
            check(a.generated == b.generated, f"{cfg1.name}: rid {a.rid} "
                                              f"lengths differ")
    check(worst <= atol, f"{cfg1.name} {DTYPE_NAMES[dtype]}: card vs CPU "
                         f"logits {worst} apart before a split")
    stats = [(s.stats.spec_proposed, s.stats.spec_accepted)
             for s in (srv["cuda"], srv["cpu"])]
    if not splits:
        check(stats[0] == stats[1], f"{cfg1.name}: proposed / accepted card "
                                    f"vs CPU {stats}")
    out = {"dtype": DTYPE_NAMES[dtype], "tokens": sum(
        len(r.generated) for r in rs["cuda"]), "proposed_accepted": stats,
        "max_abs_logit_diff": worst, "atol": atol, "tie": tie,
        "splits": splits, "card_launches": launches["cuda"], "card": card}
    log(f"[moespec] {cfg1.name} 1 layer, self-draft, {DTYPE_NAMES[dtype]}, "
        f"card vs CPU: {out['tokens']} tokens, "
        + ("equal" if not splits else f"parted at near-ties {splits}")
        + f" | proposed / accepted {stats[0]} card, {stats[1]} CPU | max "
        f"|logit diff| {worst:.3g} (gate {atol}) | card launches "
        f"{launches['cuda']} | {card}")
    return out


def moespec_phase(dev, card: str) -> tuple:
    """Phase 29 (``--moespec`` only): speculative serving of the MoE family.
    (a) The page pools' zeroing kernel at phi3.5-moe's Hkv 8 and qwen3-moe's
    Hkv 4 (d_head 128), fp32 and bf16: bit-equal to its plain version over
    both whole pools, then an admission's reset and a speculative tick's
    rollback as ``PagePool`` runs them, timed as phase 3 times row 4. (b)
    phi3.5-moe at 8 layers and qwen3-moe at 4, published width and
    capacity factor, 8 Zipf requests through :func:`moespec_serve` with a
    1-layer draft and the self-draft, in fp32 and bf16. (c) phi3.5-moe at
    1 layer, card vs CPU (:func:`moespec_cross_device`). No plain attention
    or page-pool call on the card. Returns ``(record, {kernel: {sub-row:
    row}})``."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref
    from repro_torch.runtime.serving import zipf_requests

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(29)
    rows: dict = {"paged_rollback": {}, "paged_attention": {}}
    rec: dict = {"pool": {}, "serve": {}, "cross_device": {}, "card": card}
    for arch in (PHI, QWEN3):
        cut = dataclasses.replace(get_config(arch),
                                  n_layers=MOESPEC_LAYERS[arch])
        for dtype in MOESPEC_DTYPES:
            sub = f"moe_hkv{cut.n_kv_heads}_{DTYPE_NAMES[dtype]}"
            check_pool_zero(cut, dev, gen, paged_ops, paged_ref, dtype)
            ev = pool_events(cut, dev, 29, dtype, ranges=False)
            rec["pool"][sub] = ev
            tick = {k: x for k, x in ev["tick"].items() if k != "host"}
            rows["paged_rollback"][sub] = {
                **tick, "max_abs_err": 0.0, "bound_by": "bytes",
                "launch_floor_ms": ev["floor"]["device_ms"],
                "library_call": "index_fill_, one call a tensor",
                "bit_equal_to_plain": True}
            r = rows["paged_rollback"][sub]
            log(f"[moespec] paged_rollback {sub} ({arch}): bit-equal to its "
                f"plain version over both pools | call {r['ms']:.4f} ms | "
                f"card {r['device_ms']:.4f} ms | launch floor "
                f"{r['launch_floor_ms']:.4f} ms | index_fill_ "
                f"{r['library_ms']:.4f} ms (card "
                f"{r['library_device_ms']:.4f}) | plain {r['plain_ms']:.4f} "
                f"ms | bound {r['bound_ms']:.6f} ms (bytes) | {r['at']} | "
                f"{card}")
    spy: dict = {}
    with plain_attention_spy(spy):
        for arch in (PHI, QWEN3):
            cut = dataclasses.replace(get_config(arch),
                                      n_layers=MOESPEC_LAYERS[arch])
            sess = Session.from_config(cut, seed=0)
            params, init_s = timed(sess.init_params)
            n_params = sum(p.numel() for p in params.parameters())
            log(f"[moespec] {arch} full width, {cut.n_layers} layers "
                f"({cut.n_heads}/{cut.n_kv_heads} heads, {cut.n_experts} "
                f"experts top-{cut.top_k}, capacity factor "
                f"{cut.moe_capacity_factor}): {n_params / 1e9:.3f} B fp32 "
                f"params on the card in {init_s:.1f} s | {card}")
            reqs = zipf_requests(8, cut.vocab_size, min_len=8, max_len=48,
                                 max_new_low=8, max_new_high=24, seed=0)
            runs = {}
            for dtype in MOESPEC_DTYPES:
                for draft in MOESPEC_DRAFTS:
                    name = f"{DTYPE_NAMES[dtype]}_draft{draft or 'self'}"
                    runs[name] = moespec_serve(
                        Session, cut, params, dtype, draft, reqs, card,
                        f"{arch} {cut.n_layers} layers {name}")
                check(runs[f"{DTYPE_NAMES[dtype]}_draft1"][
                    "ticks_rolled_back"] > 0,
                      f"{arch} {DTYPE_NAMES[dtype]}: the 1-layer draft never "
                      f"rolled back")
            rec["serve"][arch] = {"n_params": n_params, "init_s": init_s,
                                  "runs": runs}
            H = cut.n_kv_heads
            for dtype in MOESPEC_DTYPES:
                dn = DTYPE_NAMES[dtype]
                rows["paged_rollback"][f"moe_hkv{H}_{dn}"]["launches"] = \
                    runs[f"{dn}_draft1"]["launches"].get("paged_rollback", 0)
                rows["paged_attention"][f"moe_hkv{H}_spec_{dn}"] = {
                    "launches": runs[f"{dn}_draft1"]["launches"][
                        "paged_attention"],
                    "at": f"{arch}, {cut.n_layers} layers, spec_k 4, a "
                          f"1-layer draft, {dn}"}
            del sess, params
            torch.cuda.empty_cache()
        cut1 = dataclasses.replace(get_config(PHI), n_layers=1)
        x_reqs = zipf_requests(3, cut1.vocab_size, min_len=8, max_len=24,
                               max_new_low=6, max_new_high=10, seed=2)
        for dtype in MOESPEC_DTYPES:
            rec["cross_device"][DTYPE_NAMES[dtype]] = moespec_cross_device(
                Session, cut1, dtype, x_reqs, card)
            torch.cuda.empty_cache()
    check(spy["plain_calls_on_card"] == 0,
          f"{spy['plain_calls_on_card']} plain attention or page-pool calls "
          f"on the card")
    rec["plain_calls_on_card"] = 0
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[moespec] phase 29 in {rec['phase_s']:.1f} s; no plain attention "
        f"or page-pool call on the card | {card}")
    return rec, rows


# --------------------------------------------------------------- phase 25
# training in bf16 (--bf16train only): the card against its CPU held as
# tests/test_torch_bf16_training.py holds the port to JAX (bf16 products
# summed in another order flip a rounding now and then): the loss at the
# first step, the norms and the bound, the noisy gradient, the master after
# AdamW (2 lr where a gradient's sign flipped, on at most 1% of weights
# past lr / 10)
BF16_LOSS_RTOL, BF16_NORM_RTOL, BF16_NOISY_ATOL = 2e-5, 1e-3, 2e-2
BF16_PARAM_ATOL, BF16_FLIP_SHARE = 2.5e-3, 0.01


def bf16_train_cross_device(Session, narrow, priv, opt) -> dict:
    """Phase 25(d): phase 8's narrow step under route (B) on the card and
    on the host CPU from the same bf16 weights: one fused pass and one
    train step each; loss, norms, bound, noisy gradient and master within
    the BF16_* tolerances, the carried key bit-equal, the bf16 weights the
    rounded master on both."""
    from repro_torch.core.barrier import step_keys
    from repro_torch.core import prng
    from repro_torch.distributed import steps as steps_mod
    from repro_torch.kernels import dispatch

    sess = {d: route_session(Session, narrow, "B", privacy=priv,
                             optimizer=opt, seed=3, device=d)
            for d in ("cuda", "cpu")}
    p_cpu = sess["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    batch = sess["cpu"].synthetic_batches(16, 32)()
    out = {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        dispatch.reset_launches()
        out[d] = narrow_step(sess[d], p, {k: v.to(d) for k, v in
                                          batch.items()},
                             steps_mod, step_keys, prng)
        out[d] += (dispatch.launch_counts(),)
    (n_g, m_g, x_g, s_g, c_g), (n_c, m_c, x_c, s_c, c_c) = \
        out["cuda"], out["cpu"]
    check(c_g["clip_accumulate"] == 2 and c_g["noise_batch"] == 2,
          f"bf16 narrow card launches {c_g}")
    check(all(v == 0 for v in c_c.values()), f"the CPU step launched {c_c}")
    check(x_g["prev_key"] == x_c["prev_key"]
          and s_g.noise_state.prev_key == s_c.noise_state.prev_key,
          "bf16: carried noise key differs between card and CPU")
    check(weights_are_rounded_master(s_g) and weights_are_rounded_master(s_c),
          "bf16 narrow: the weights are not the rounded master")
    check(math.isclose(x_g["loss"], x_c["loss"], rel_tol=BF16_LOSS_RTOL),
          f"bf16 narrow loss: card {x_g['loss']} vs CPU {x_c['loss']}")
    for k in ("clip_bound", "grad_norm_mean"):
        check(math.isclose(m_g[k], m_c[k], rel_tol=BF16_NORM_RTOL),
              f"bf16 narrow {k}: card {m_g[k]} vs CPU {m_c[k]}")
    norm_err = ((x_g["norms"] - x_c["norms"]).abs()
                / x_c["norms"].abs()).max().item()
    check(norm_err <= BF16_NORM_RTOL, f"bf16 narrow norms {norm_err}")
    noisy_err = (n_g - n_c).abs().max().item()
    check(noisy_err <= BF16_NOISY_ATOL, f"bf16 noisy gradient {noisy_err}")
    dp = (s_g.opt_state["master"].cpu() - s_c.opt_state["master"]).abs()
    share = (dp > opt.lr / 10).float().mean().item()
    check(dp.max().item() <= BF16_PARAM_ATOL and share <= BF16_FLIP_SHARE,
          f"bf16 master differs: max {dp.max().item()}, {share} past lr/10")
    rec = {"P": s_c.layout.total, "loss": [x_g["loss"], x_c["loss"]],
           "loss_rel_err": abs(x_g["loss"] - x_c["loss"]) / abs(x_c["loss"]),
           "clip_bound": [m_g["clip_bound"], m_c["clip_bound"]],
           "norms_max_rel_err": norm_err, "noisy_max_abs_err": noisy_err,
           "noisy_max_abs": n_c.abs().max().item(),
           "master_max_abs_err": dp.max().item(),
           "master_share_past_lr_10": share, "prev_key_equal": True}
    log(f"[bf16train-slice] narrow config (P {s_c.layout.total}), route B, "
        f"card vs CPU: loss {x_g['loss']:.6f} / {x_c['loss']:.6f} | norms "
        f"rel {norm_err:.3g} | bound {m_g['clip_bound']:.6f} / "
        f"{m_c['clip_bound']:.6f} | noisy max |diff| {noisy_err:.3g} | "
        f"master max |diff| {dp.max().item():.3g}, {share:.3g} past lr/10 | "
        f"prev_key equal; weights the rounded master on both")
    return rec


def bf16_grad_repeat(Session, cfg, priv, opt) -> dict:
    """Phase 25(e): silo 0's bf16 gradient of the 12-layer cell under
    route (B) (16 x 64 over 4 silos) computed twice on the card, packed:
    bit-equal, and its norm too."""
    from repro_torch.core import flatbuf
    from repro_torch.models.packing import param_tree

    sess = route_session(Session, cfg, "B", privacy=priv, optimizer=opt,
                         seed=1)
    state = sess.init_state()
    batch = sess.synthetic_batches(16, 64)()
    t0 = time.perf_counter()
    a, na = silo_grads_packed(sess.model, state.params, batch, state.layout,
                              0, 4, flatbuf, param_tree)
    b, nb = silo_grads_packed(sess.model, state.params, batch, state.layout,
                              0, 4, flatbuf, param_tree)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    equal = bool(torch.equal(bits(a), bits(b))) \
        and bits(na).item() == bits(nb).item()
    check(equal, f"{cfg.name} route B: silo 0's repeated gradients differ")
    log(f"[bf16train-repeat] {cfg.name} at {cfg.n_layers} layers, route B: "
        f"silo 0's packed gradient (norm {na.item():.6f}) computed twice, "
        f"bit-equal ({s:.1f} s)")
    P = state.layout.total
    del a, b, state, sess
    torch.cuda.empty_cache()
    return {"P": P, "bit_equal": equal, "norm": float(na), "s": s}


def bf16train_phase(dev) -> dict:
    """Phase 25 (``--bf16train`` only): training in bf16 on JAX's two
    routes, beside fp32 in the same call. qwen2.5-3b at full width and 12
    layers, phase 7's privacy, 16 x 64 over 4 silos: (a) 3 fused steps in
    fp32, route (A) and route (B), each DP kernel once a step; (b) 3
    barrier steps, silo 2 out at the second (4, 3 and 4 ``clip_mask``
    launches), the same three ways; (c) the scan tier under route (B) at
    the largest of SCAN_DEPTHS that fits, 2 steps (``normal_combine`` a
    leaf tensor); (d) the narrow step under route (B), card vs CPU; (e)
    one silo's bf16 gradient repeated, bit-equal. Step and stage ms, peak
    GB of each cell; under route (B) the bf16 weights the rounded master
    after every cell."""
    import gc

    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          PrivacyConfig, reduce_for_smoke)

    t0 = time.perf_counter()
    cfg = get_config("qwen2.5-3b")
    cut12 = dataclasses.replace(cfg, n_layers=12)
    priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=4)
    priv_b = dataclasses.replace(priv, sync_path="barrier")
    priv_s = dataclasses.replace(priv, silo_mode="scan")
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    mesh4 = MeshConfig((4,), ("data",))
    rec: dict = {"fused": {}, "barrier": {}}
    for route in ("fp32", "A", "B"):
        rec["fused"][route] = train_cell(
            Session, cut12, priv, opt, None, 3,
            {"clip_accumulate": 1, "noise_batch": 1}, "bf16train-fused",
            route=route)
    for route in ("fp32", "A", "B"):
        rec["barrier"][route] = train_cell(
            Session, cut12, priv_b, opt, mesh4, 3, {"clip_mask": [4, 3, 4]},
            "bf16train-barrier", route=route,
            silo_schedule=lambda t: [True, True, t != 1, True])
    scan: dict = {"tried": []}
    for depth in SCAN_DEPTHS:
        cut = dataclasses.replace(cfg, n_layers=depth)
        try:
            cell = train_cell(Session, cut, priv_s, opt, None, 2, {
                "normal_combine": lambda lay: len(leaf_slices(lay))},
                "bf16train-scan", route="B")
        except torch.cuda.OutOfMemoryError as e:
            scan["tried"].append({"n_layers": depth, "error": str(e)[:200]})
            log(f"[bf16train-scan] {depth} layers do not fit the card under "
                f"route B: {str(e)[:160]}")
            gc.collect()
            torch.cuda.empty_cache()
            continue
        scan.update(n_layers=depth, full_depth=depth == cfg.n_layers, **cell)
        break
    check("n_layers" in scan, f"the route B scan tier fits at none of "
                              f"{SCAN_DEPTHS} layers")
    rec["scan"] = scan
    narrow = reduce_for_smoke(cfg, n_layers=2, d_model=256, n_heads=4,
                              n_kv_heads=2, d_head=64, d_ff=512,
                              vocab_size=4096)
    rec["cross_device"] = bf16_train_cross_device(
        Session, narrow, dataclasses.replace(priv,
                                             clip_percentile_max=NARROW_CAP),
        opt)
    rec["repeat"] = bf16_grad_repeat(Session, cut12, priv, opt)
    for tier in ("fused", "barrier"):
        log(f"[bf16train] {tier} at 12 layers, ms a step after the first "
            f"(fp32 / A / B): " + " / ".join(
                f"{sum(rec[tier][r]['step_ms'][1:]) / 2:.1f}"
                for r in ("fp32", "A", "B")) + " | peak GB " + " / ".join(
                f"{rec[tier][r]['peak_mem_gb']:.2f}"
                for r in ("fp32", "A", "B")))
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[bf16train] phase 25 in {rec['phase_s']:.1f} s; scan tier under "
        f"route B at {scan['n_layers']} layers, peak "
        f"{scan['peak_mem_gb']:.2f} GB")
    return rec


# --------------------------------------- phases 3 (flash training) and 26

# the training pair against its plain versions: fp32 within KERNEL_ATOL
# plus FLASH_TRAIN_REL of each output's largest |value| (fp32 sums in other
# orders: the kernel's tiles against one einsum; the absolute floor for a
# gradient that is 0 up to rounding), lse within KERNEL_ATOL; bf16 within
# one bf16 ulp past that (both sides compute in fp32 and round once)
FLASH_TRAIN_REL = 1e-5
# the shapes phase 3 holds the training pair to: qwen2.5-3b's silo at JAX's
# train_4k length (B 1, S 4096, causal), hubert-xlarge's frames (B 4, S
# 512, 16 heads, MHA, d_head 80, non-causal) and a ragged length, each in
# fp32 and bf16 (the bf16 pair on the tensor cores)
FLASH_TRAIN_SHAPES = (
    ("", 1, 4096, 16, 2, 128, True, torch.float32),
    ("bf16", 1, 4096, 16, 2, 128, True, torch.bfloat16),
    ("hubert", 4, 512, 16, 16, 80, False, torch.float32),
    ("hubert_bf16", 4, 512, 16, 16, 80, False, torch.bfloat16),
    ("s1000", 1, 1000, 16, 2, 128, True, torch.float32),
    ("s1000_bf16", 1, 1000, 16, 2, 128, True, torch.bfloat16))
FLASH_TRAIN_SUBROWS = ("lse4096", "lse4096_bf16", "lse_hubert",
                       "lse_hubert_bf16", "lse_s1000", "lse_s1000_bf16",
                       "hubert", "hubert_bf16", "s1000", "s1000_bf16")
# flash's kernels in the SASS (mangled names), every one on the tensor
# cores (HMMA): the training pair's, bf16 and fp32, whose forwards the
# serving entries launch too (no lse); FLASH_FWD_SASS, those forwards, at
# each of the head dims the wrappers take
FLASH_TC_SASS = (r"flash_fwd_lse_tc_kernel", r"flash_bwd_dkdv_tc_kernel",
                 r"flash_bwd_dq_tc_kernel", r"flash_fwd_lse_x3_kernel",
                 r"flash_bwd_dkdv_x3_kernel", r"flash_bwd_dq_x3_kernel")
FLASH_FWD_SASS = (r"flash_fwd_lse_tc_kernel", r"flash_fwd_lse_x3_kernel")
# phase 26's card-vs-CPU gradient gate, tests/test_torch_flash_training.py's
FLASH_GRAD_REL = 5e-5


def busy_ms(fn, n: int = 3) -> float:
    """Device time of one ``fn()`` without the host's share, for what a
    CUDA graph cannot capture (an ``autograd.grad`` over a saved graph):
    the card's busy time under ``torch.profiler`` over ``n`` calls after a
    warm-up (``launch/profile_serve._window``)."""
    from repro_torch.launch.profile_serve import _window

    fn()
    return _window(lambda: [fn() for _ in range(n)], 0)["device_busy_ms"] / n


def flash_train_close(got, want, dtype, atol=KERNEL_ATOL) -> float:
    """Checks ``got`` against ``want`` at the training pair's gate; returns
    the max |difference|."""
    got, want = got.float(), want.float()
    gate = atol + FLASH_TRAIN_REL * want.abs().max()
    if dtype == torch.bfloat16:
        gate = gate + bf16_ulp(torch.maximum(got.abs(), want.abs()))
    diff = (got - want).abs()
    check(bool((diff <= gate).all()), f"flash training pair: "
          f"{float((diff - gate).max())} past the gate")
    return diff.max().item()


def check_flash_train(dev, gen, B, S, Hq, Hkv, D, causal, dtype, F) -> tuple:
    """The lse forward and the backward at one shape against their plain
    versions (the backward from the kernel's own out and lse, as training
    runs it), two launches of each bit-equal; each timed as a call and on
    the card (a CUDA graph of 5 calls: a call is milliseconds here) beside
    its plain version and SDPA's forward, or SDPA's backward (one autograd
    call over a saved graph, as a call and on the card:
    :func:`busy_ms`), and its bound: bytes (each input once, each
    output once) against 2 flops a product term, two S x S x D products
    forward and five backward over the visible pairs, at fp32's rate or
    bf16's tensor-core rate. Beside it the split's floor: the products the
    tensor-core design does, at bf16's rate. Returns (lse row, bwd
    row)."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_fwd_lse_cuda)

    q, k, v, do = (torch.randn(B, S, H, D, device=dev, generator=gen)
                   .to(dtype) for H in (Hq, Hkv, Hkv, Hq))
    fwd = lambda: flash_attention_fwd_lse_cuda(q, k, v, causal)  # noqa: E731
    out, lse = fwd()
    bwd = lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do,  # noqa
                                           causal)
    grads = bwd()
    out2, lse2 = fwd()
    again = bwd()
    want_out, want_lse = ref.flash_forward_ref(q, k, v, causal)
    want = ref.flash_backward_ref(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    check(torch.equal(bits(out), bits(out2)) and torch.equal(lse, lse2)
          and all(torch.equal(bits(a), bits(b))
                  for a, b in zip(grads, again)),
          "flash training pair: two launches differ")
    err_out = flash_train_close(out, want_out, dtype)
    err_lse = (lse - want_lse).abs().max().item()
    check(err_lse <= KERNEL_ATOL, f"flash lse off by {err_lse}")
    errs = [flash_train_close(g, w, dtype) for g, w in zip(grads, want)]
    del want, want_out, want_lse, out2, again
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    pairs = S * (S + 1) // 2 if causal else S * S
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    with torch.no_grad():
        lib_fwd_ms, lib_fwd_dev = cuda_ms(sdpa, reps=5, warmup=1), \
            graph_ms(sdpa, n=5, reps=3)
    o = sdpa()
    dot = do.transpose(1, 2).contiguous()
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        o, (qt, kt, vt), dot, retain_graph=True)
    at = (f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
          f"{'causal' if causal else 'non-causal'} {DTYPE_NAMES[dtype]}")
    b_f, by_f = bound(*work().flash_lse_work(q, k, v, causal), rate)
    # the split's floor, in units of an S x S x D product at bf16's rate:
    # bf16 enters the forward's P as three bf16 terms, so 4 units forward
    # (2 bound it), and the backward's P and dS as two, 10 backward (5);
    # fp32 enters every operand as three terms, a product as six mma, so 12
    # forward and 42 backward (7 products)
    unit = 2 * D * Hq * B * pairs / BF16_FLOP_PER_S * 1e3
    floor_f, floor_b = ((4, 10) if dtype == torch.bfloat16 else (12, 42))
    floor_f, floor_b = floor_f * unit, floor_b * unit
    lse_row = {
        "max_abs_err": err_out, "lse_max_abs_err": err_lse,
        "ms": cuda_ms(fwd, reps=5, warmup=1),
        "device_ms": graph_ms(fwd, n=5, reps=3),
        "plain_ms": cuda_ms(lambda: ref.flash_forward_ref(q, k, v, causal),
                            reps=3, warmup=1),
        "library_ms": lib_fwd_ms, "library_device_ms": lib_fwd_dev,
        "library_call": "scaled_dot_product_attention (forward)",
        "bound_ms": b_f, "bound_by": by_f, "split_floor_ms": floor_f,
        "at": at + " (training forward)"}
    b_b, by_b = bound(*work().flash_bwd_work(q, k, v, causal), rate)
    bwd_row = {
        "max_abs_err": max(errs), "max_abs_err_dq_dk_dv": errs,
        "two_launches_bit_equal": True,
        "ms": cuda_ms(bwd, reps=5, warmup=1),
        "device_ms": graph_ms(bwd, n=5, reps=3),
        "plain_ms": cuda_ms(lambda: ref.flash_backward_ref(
            q, k, v, out, lse, do, causal), reps=3, warmup=1),
        "library_ms": cuda_ms(lib_bwd, reps=5, warmup=1),
        "library_device_ms": busy_ms(lib_bwd),
        "library_call": "the backward of scaled_dot_product_attention "
                        "(one autograd.grad over its saved graph; on the "
                        "card: its kernels under torch.profiler)",
        "bound_ms": b_b, "bound_by": by_b, "split_floor_ms": floor_b,
        "at": at}
    del q, k, v, do, out, lse, grads, o, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return lse_row, bwd_row


def flash_hmma(sass: str) -> dict:
    """HMMA instructions in each of flash's kernels (every instantiation,
    by mangled name): at least one in each, bf16 and fp32, serving and
    training; the forwards at every head dim of FLASH_HEAD_DIMS; no
    CUDA-core ``flash_attention_fwd_kernel`` left. Returns ``{pattern:
    [count an instantiation]}``."""
    from repro_torch.kernels.dispatch import FLASH_HEAD_DIMS
    counts: dict = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            check("flash_attention_fwd_kernel" not in fn,
                  f"the CUDA-core flash forward is in the library: {fn}")
            name = next((p for p in FLASH_TC_SASS if re.search(p, fn)), None)
            if name:
                counts.setdefault(name, []).append(0)
        elif name and re.search(r"\bHMMA\b", line):
            counts[name][-1] += 1
    for p in FLASH_TC_SASS:
        check(bool(counts.get(p)) and min(counts[p]) > 0,
              f"{p}: an instantiation without HMMA ({counts.get(p)})")
    for p in FLASH_FWD_SASS:
        check(len(counts[p]) == len(FLASH_HEAD_DIMS),
              f"{p}: {len(counts[p])} instantiations, expected one at each "
              f"of {FLASH_HEAD_DIMS}")
    return counts


def flash_train_rows(dev, F) -> dict:
    """Phase 3's training rows: the lse forward (sub-rows of row 1) and
    the backward (row 19) at FLASH_TRAIN_SHAPES, after the SASS check that
    every flash kernel, the serving forwards' included, runs on the tensor
    cores (:func:`flash_hmma`). Returns ``{kernel: {sub-row: row}}``, the
    backward's main row under ``""``."""
    hmma = flash_hmma(library_sass())
    log(f"[kernel] flash training pair, HMMA an instantiation: "
        f"{json.dumps(hmma)}")
    gen = torch.Generator(device=dev).manual_seed(26)
    rows: dict = {"flash_attention": {}, "flash_attention_bwd": {}}
    for name, B, S, Hq, Hkv, D, causal, dtype in FLASH_TRAIN_SHAPES:
        lse_row, bwd_row = check_flash_train(dev, gen, B, S, Hq, Hkv, D,
                                             causal, dtype, F)
        lse_name = {"": "lse4096", "bf16": "lse4096_bf16"}.get(
            name, f"lse_{name}")
        rows["flash_attention"][lse_name] = lse_row
        rows["flash_attention_bwd"][name] = bwd_row
        for kernel, sub, r in (("flash_attention", lse_name, lse_row),
                               ("flash_attention_bwd", name or "main",
                                bwd_row)):
            log(f"[kernel] {kernel} {sub}: max_abs_err "
                f"{r['max_abs_err']:.3g} | kernel {r['ms']:.4f} ms (on the "
                f"card {r['device_ms']:.4f}) | library {r['library_ms']:.4f}"
                f" ms (on the card {r['library_device_ms']:.4f}; "
                f"{r['library_call']}) | plain {r['plain_ms']:.4f} ms | "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), the "
                f"split's floor {r['split_floor_ms']:.4f} ms | {r['at']}")
    rows["hmma"] = hmma
    return rows


def flash_session(Session, cfg, route: str, use_flash: bool, **kw):
    """:func:`route_session` over ``build_model(..., remat=True,
    use_flash=use_flash)``: JAX's training model switches, reached as JAX
    reaches them (no entry keyword takes them)."""
    from repro_torch.models.registry import build_model

    sess = route_session(Session, cfg, route, **kw)
    dt = torch.bfloat16 if route == "B" else torch.float32
    return dataclasses.replace(sess, model=build_model(
        sess.cfg, sess.device, param_dtype=dt, compute_dtype=dt,
        remat=True, use_flash=use_flash))


def flash_counts(cfg, silos: int) -> dict:
    """The flash launches of one step: each silo's pass runs every layer's
    lse forward twice (the forward, then remat's recompute) and its
    backward once."""
    return {"flash_attention": 2 * cfg.n_layers * silos,
            "flash_attention_bwd": cfg.n_layers * silos}


def attention_ms(cfg, B, S, dtype, use_flash: bool) -> dict:
    """One layer's attention at a silo's shape, timed alone on the card
    (CUDA events): its forward (with grad mode on, as remat's first pass
    runs it: flash's lse forward) and its forward and backward; a remat
    step runs both once a layer (the forward pass, then the recompute and
    the backward). The time in attention a silo's pass is ``layers x
    (forward + forward_backward)``, reckoned from these."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.attention import _sdpa

    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(B, S, H, cfg.d_head, device="cuda",
                               generator=gen).to(dtype)
                   for H in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads,
                             cfg.n_heads))
    fn = (lambda a, b, c: flash_ops.flash_attention(a, b, c, cfg.causal)) \
        if use_flash else (lambda a, b, c: _sdpa(a, b, c, cfg.causal))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    f_ms = cuda_ms(lambda: fn(*leaves), reps=3, warmup=1)
    fb_ms = cuda_ms(lambda: torch.autograd.grad(fn(*leaves), leaves, do),
                    reps=3, warmup=1)
    del q, k, v, do, leaves
    torch.cuda.empty_cache()
    return {"forward_ms": f_ms, "forward_backward_ms": fb_ms,
            "per_silo_pass_ms": cfg.n_layers * (f_ms + fb_ms)}


def flash_cell(Session, cfg, priv, opt, mesh, steps: int, want: dict,
               log_name: str, route: str, use_flash: bool, batch: int,
               seq_len: int, silos: int, next_batch=None,
               silo_schedule=None) -> dict:
    """A phase-26 cell: :func:`train_cell` over :func:`flash_session` at
    ``batch x seq_len``, flash launches added to ``want`` (none without
    flash; no plain attention call on the card either way), and the time
    in attention a step reckoned from :func:`attention_ms` at a silo's
    shape (its share of the step after the first)."""
    spy: dict = {}
    with plain_attention_spy(spy):
        want = dict(want, **(flash_counts(cfg, silos) if use_flash else {}))
        cell = train_cell(Session, cfg, priv, opt, mesh, steps, want,
                          log_name, next_batch=next_batch, route=route,
                          silo_schedule=silo_schedule, batch=batch,
                          seq_len=seq_len, use_flash=use_flash)
    check(spy["plain_calls_on_card"] == 0, f"{log_name}: "
          f"{spy['plain_calls_on_card']} plain attention calls on the card")
    dt = torch.bfloat16 if route == "B" else torch.float32
    att = attention_ms(cfg, batch // silos, seq_len, dt, use_flash)
    att["ms_a_step"] = silos * att["per_silo_pass_ms"]
    later = cell["step_ms"][1:] or cell["step_ms"]
    att["share_of_step"] = att["ms_a_step"] / (sum(later) / len(later))
    cell.update(use_flash=use_flash, remat=True, attention=att)
    log(f"[{log_name}] attention ({'flash' if use_flash else 'plain'}, "
        f"remat): {att['forward_ms']:.2f} ms forward + "
        f"{att['forward_backward_ms']:.2f} ms forward+backward a layer at "
        f"B {batch // silos} S {seq_len} -> {att['ms_a_step']:.0f} ms a step"
        f" (reckoned), {100 * att['share_of_step']:.1f}% of the step")
    return cell


def flash_cross_device(Session, narrow, priv, opt) -> dict:
    """Phase 26(e): one silo's loss and gradient of phase 8's narrow config
    (4 x 256, several 64-row tiles) through flash and remat, on the card
    (the kernels) and on the host CPU (their plain versions) from the same
    weights: the loss within TRAIN_RTOL, the packed gradient within
    FLASH_GRAD_REL of its largest |value|."""
    from repro_torch.core import flatbuf
    from repro_torch.kernels import dispatch
    from repro_torch.models.packing import param_tree

    sess = {d: flash_session(Session, narrow, "fp32", True, privacy=priv,
                             optimizer=opt, seed=3, device=d)
            for d in ("cuda", "cpu")}
    p_cpu = sess["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    batch = sess["cpu"].synthetic_batches(16, 256)()
    out = {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        st = sess[d].init_state(params=p)
        dispatch.reset_launches()
        g, _ = silo_grads_packed(sess[d].model, st.params,
                                 {k: v.to(d) for k, v in batch.items()},
                                 st.layout, 0, 4, flatbuf, param_tree)
        n = {k: v for k, v in dispatch.launch_counts().items() if v}
        with torch.no_grad():
            loss = sess[d].model.loss(st.params, {k: v[:4].to(d) for k, v
                                                  in batch.items()})
        out[d] = (g.cpu(), float(loss), n)
    (g_g, l_g, n_g), (g_c, l_c, n_c) = out["cuda"], out["cpu"]
    check(not n_c, f"the CPU pass launched {n_c}")
    check(n_g == flash_counts(narrow, 1), f"narrow card launches {n_g}")
    err = (g_g - g_c).abs().max().item()
    top = g_c.abs().max().item()
    check(math.isclose(l_g, l_c, rel_tol=TRAIN_RTOL),
          f"flash narrow loss: card {l_g} vs CPU {l_c}")
    check(err <= FLASH_GRAD_REL * top, f"flash narrow gradient {err} "
          f"(largest {top})")
    log(f"[flashtrain-slice] narrow config (P {g_c.numel()}), one silo "
        f"through flash + remat, card vs CPU: loss {l_g:.6f} / {l_c:.6f} | "
        f"gradient max |diff| {err:.3g} of {top:.3g} | card launches {n_g}")
    return {"P": g_c.numel(), "loss": [l_g, l_c], "grad_max_abs_err": err,
            "grad_max_abs": top, "card_launches": n_g}


def flash_grad_repeat(Session, cfg, priv, opt) -> dict:
    """Phase 26(f): silo 0's gradient of the 12-layer cell (one sequence
    of 4096) through flash and remat, twice on the card: bit-equal."""
    from repro_torch.core import flatbuf
    from repro_torch.models.packing import param_tree

    sess = flash_session(Session, cfg, "fp32", True, privacy=priv,
                         optimizer=opt, seed=1)
    state = sess.init_state()
    batch = sess.synthetic_batches(4, 4096)()
    t0 = time.perf_counter()
    a, na = silo_grads_packed(sess.model, state.params, batch, state.layout,
                              0, 4, flatbuf, param_tree)
    b, nb = silo_grads_packed(sess.model, state.params, batch, state.layout,
                              0, 4, flatbuf, param_tree)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    equal = bool(torch.equal(bits(a), bits(b))) \
        and bits(na).item() == bits(nb).item()
    check(equal, f"{cfg.name} flash: silo 0's repeated gradients differ")
    log(f"[flashtrain-repeat] {cfg.name} at {cfg.n_layers} layers, S 4096: "
        f"silo 0's packed gradient (norm {na.item():.6f}) through flash "
        f"and remat computed twice, bit-equal ({s:.1f} s)")
    P = state.layout.total
    del a, b, state, sess
    torch.cuda.empty_cache()
    return {"P": P, "bit_equal": equal, "norm": float(na), "s": s}


def scan_batch_search(Session, cfg, priv, opt, silos: int, want: dict,
                      first: dict) -> dict:
    """Phase 26(c)'s per-silo batch: the largest of 8, 4 and 2 sequences a
    silo that fits, tried in that order, the first that fits run once (1
    step). The peak at one sequence a silo is AdamW's over the fp32 master
    and its moments, not the silo gradient's, so it does not extrapolate
    (on an H100 80GB HBM3 at 700 W: 69.30 GB at 1 and 70.14 at 2, where
    8 ran out of memory); the share a sequence, reckoned from the peaks,
    is logged beside the trials."""
    import gc

    total = torch.cuda.mem_get_info()[1]
    out: dict = {"card_bytes": total, "peaks_gb": {1: first["peak_mem_gb"]},
                 "out_of_memory": []}
    for b in (8, 4, 2):
        err = None
        try:
            run = flash_cell(Session, cfg, priv, opt, None, 1, want,
                             "flashtrain-scan", "B", True, b * silos, 4096,
                             silos)
        except torch.cuda.OutOfMemoryError as e:
            err = str(e)[:200]
        if err is None:
            out.update(per_silo_batch=b, run=run)
            out["peaks_gb"][b] = run["peak_mem_gb"]
            break
        # the failed cell's tensors go with its traceback
        gc.collect()
        torch.cuda.empty_cache()
        out["out_of_memory"].append({"per_silo_batch": b, "error": err})
        log(f"[flashtrain-scan] {b} a silo does not fit: {err[:160]}")
    else:
        out["per_silo_batch"] = 1
    b = out["per_silo_batch"]
    if b > 1:
        out["per_sequence_gb"] = (out["peaks_gb"][b] - out["peaks_gb"][1]) \
            / (b - 1)
    log(f"[flashtrain-scan] per-silo batch {b} (peaks {out['peaks_gb']} GB "
        f"of {total / 1e9:.1f})")
    return out


def flashtrain_phase(dev) -> dict:
    """Phase 26 (``--flashtrain`` only): training through flash attention
    and remat, ``build_model(..., remat=True, use_flash=True)``, at JAX's
    train_4k length (S 4096). (a) qwen2.5-3b at full width and 12 layers,
    fp32, fused tier, phase 7's privacy over 4 silos, batch 4 x 4096: 2
    steps with flash, then 2 with the plain attention (remat both); (b)
    the barrier tier once at that cell, silo 2 out; (c) JAX's production
    cell: the scan tier under route (B), 36 layers, 8 silos, JAX's dry-run
    privacy (sigma 1, per-silo clipping), 2 steps at one sequence a silo,
    then the per-silo batch search; (d) hubert-xlarge at published width
    and 8 of 48 layers, frames of S 512, 16 x 512 over 4 silos, fused, 2
    steps; (e) phase 8's narrow config card vs CPU; (f) one silo's
    gradient repeated, bit-equal. Every cell: finite losses, rising
    epsilon, each DP kernel's launches, 2 x layers lse forwards and 1 x
    layers backwards a silo a step, no plain attention call on the card;
    step and stage ms, the time in attention, peak GB."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          PrivacyConfig, reduce_for_smoke)

    t0 = time.perf_counter()
    cfg = get_config("qwen2.5-3b")
    cut12 = dataclasses.replace(cfg, n_layers=12)
    priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=4)
    priv_b = dataclasses.replace(priv, sync_path="barrier")
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    fused = {"clip_accumulate": 1, "noise_batch": 1}
    rec: dict = {}
    for flash in (True, False):
        rec["fused_flash" if flash else "fused_plain"] = flash_cell(
            Session, cut12, priv, opt, None, 2, fused, "flashtrain-fused",
            "fp32", flash, 4, 4096, 4)
    rec["barrier"] = flash_cell(
        Session, cut12, priv_b, opt, MeshConfig((4,), ("data",)), 1,
        {"clip_mask": 3}, "flashtrain-barrier", "fp32", True, 4, 4096, 4,
        silo_schedule=lambda t: [True, True, False, True])
    # JAX's production cell (repro/launch/dryrun.py:91-102)
    priv_dry = PrivacyConfig(enabled=True, sigma=1.0, clip_mode="per_silo",
                             silo_mode="scan", n_silos=8)
    scan_want = {"normal_combine": lambda lay: len(leaf_slices(lay))}
    scan = flash_cell(Session, cfg, priv_dry, opt, None, 2, scan_want,
                      "flashtrain-scan", "B", True, 8, 4096, 8)
    scan["search"] = scan_batch_search(Session, cfg, priv_dry, opt, 8,
                                       scan_want, scan)
    rec["scan"] = scan
    hub = get_config("hubert-xlarge")
    hub8 = dataclasses.replace(hub, n_layers=8)
    rec["hubert"] = flash_cell(
        Session, hub8, priv, opt, None, 2, fused, "flashtrain-hubert",
        "fp32", True, 16, 512, 4,
        next_batch=frame_batches(hub8, dev, B=16, S=512))
    narrow = reduce_for_smoke(cfg, n_layers=2, d_model=256, n_heads=4,
                              n_kv_heads=2, d_head=64, d_ff=512,
                              vocab_size=4096)
    rec["cross_device"] = flash_cross_device(Session, narrow, priv, opt)
    rec["repeat"] = flash_grad_repeat(Session, cut12, priv, opt)
    f, p = rec["fused_flash"], rec["fused_plain"]
    log(f"[flashtrain] qwen2.5-3b at 12 layers, 4 x 4096 over 4 silos, "
        f"fp32, remat: flash {f['step_ms'][-1]:.1f} ms a step (attention "
        f"{f['attention']['ms_a_step']:.0f}, peak {f['peak_mem_gb']:.2f} GB)"
        f" against plain {p['step_ms'][-1]:.1f} (attention "
        f"{p['attention']['ms_a_step']:.0f}, peak {p['peak_mem_gb']:.2f} GB)")
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[flashtrain] phase 26 in {rec['phase_s']:.1f} s; the scan tier "
        f"under route B at 36 layers, S 4096: peak "
        f"{scan['peak_mem_gb']:.2f} GB at one sequence a silo, per-silo "
        f"batch {scan['search']['per_silo_batch']}")
    return rec


# --------------------------------------------------------------- phase 27
# bf16 training for every family and clip mode (--bf16families only): the
# MoE, VLM, encoder, ssm and hybrid families on JAX's two routes at
# published width, mixed fp32/bf16 trees under route (B), the perleaf
# barrier tier on the bf16 instantiation of zsmask_buffer, per-example and
# per-microbatch clipping over bf16 weights, and each family's narrow
# config card vs CPU at phase 25's gates but the loss's, which is
# tests/test_torch_bf16_families.py's 1e-4 (the card's cuBLAS products sum
# in another order, as JAX's XLA does, and the families' routing and
# scans' projections round more often than the dense family)
RWKV, ZAMBA = "rwkv6-7b", "zamba2-7b"
# the depths of phases 17 and 24 (PERF.md section 4), and the published one
# for hubert-xlarge; qwen2-vl-72b's scan tier from 2 layers down
FAM27_LAYERS = {RWKV: 4, ZAMBA: 12, PHI: 1, HUBERT: 48}
VL_SCAN_DEPTHS = (2, 1)
FAM_LOSS_RTOL = 1e-4


@contextlib.contextmanager
def plain_scan_spy(counts: dict):
    """Counts, under ``counts["plain_calls_on_card"]``, the calls of the
    scans' plain versions (forward and backward) and of the tree mask's
    plain versions that got a CUDA tensor: on the card each goes to its
    kernel or raises."""
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.kernels.zsmask import ref as zs_ref

    counts["plain_calls_on_card"] = 0
    real = {}
    for mod, names in ((wkv_ref, ("wkv_chunked_ref", "wkv_backward_ref")),
                       (ssd_ref, ("ssd_chunked_ref", "ssd_backward_ref")),
                       (zs_ref, ("zsmask_buffer_ref",
                                 "zsmask_buffer_bf16_ref"))):
        for name in names:
            fn = getattr(mod, name)
            real[mod, name] = fn

            def spy(*a, _fn=fn, **k):
                counts["plain_calls_on_card"] += any(
                    isinstance(x, torch.Tensor) and x.is_cuda for x in a)
                return _fn(*a, **k)

            setattr(mod, name, spy)
    try:
        yield counts
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def family_session(Session, cfg, route: str, use_flash=False, remat=False,
                   **kw):
    """A session of ``cfg`` training in bf16 under ``route`` (A: bf16
    compute over fp32 weights; B: bf16 weights over an fp32 master), over
    ``build_model(..., remat=, use_flash=)`` as JAX's dry run builds it."""
    from repro_torch.models.registry import build_model

    sess = Session.from_config(cfg, compute_dtype=torch.bfloat16, **kw)
    pd = torch.bfloat16 if route == "B" else torch.float32
    return dataclasses.replace(sess, model=build_model(
        sess.cfg, sess.device, param_dtype=pd, compute_dtype=torch.bfloat16,
        remat=remat, use_flash=use_flash))


def model_launches(cfg, use_flash: bool, remat: bool, silos: int = 4) -> dict:
    """The model's kernel launches of one step (every silo's pass): the
    scans' forward and backward a layer (rwkv6, zamba2's Mamba-2 layers),
    flash's lse forward (twice under remat) and backward an attention
    (a transformer layer, or each call of zamba2's shared block)."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {"wkv": silos * L, "wkv_bwd": silos * L}
    out = {}
    if cfg.family == "hybrid":
        out = {"ssd": silos * L, "ssd_bwd": silos * L}
        check(not remat, "zamba2's cells run without remat")
        L = L // cfg.attn_every
    if use_flash:
        out.update(flash_attention=(2 if remat else 1) * L * silos,
                   flash_attention_bwd=L * silos)
    return out


def vl_batches(cfg, dev, B: int = 16, S: int = 64, seed: int = 27):
    """qwen2-vl's frontend stub: ``embeds`` (B, S, d_model), distinct
    (3, B, S) M-RoPE ids and labels, drawn on the card from a seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def next_batch():
        return {"embeds": torch.randn(B, S, cfg.d_model, device=dev,
                                      generator=gen),
                "positions": mrope_ids(B, S, dev, gen),
                "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                        device=dev, generator=gen)}

    return next_batch


def family_cells(Session, cfg, dev, privs, opt, mesh4, use_flash: bool,
                 remat: bool, log_name: str) -> dict:
    """Phase 27(a)/(b) for one family at ``cfg``'s cut depth: 3 fused steps
    under route (A) and under route (B), a barrier step under (B) with silo
    2 out, 2 scan-tier steps under (B); each cell's launches (the model's,
    the DP kernels', nothing else), step and stage ms and peak GB, the
    bf16 weights the rounded master after every (B) cell."""
    priv, priv_b, priv_s = privs
    kind = {"vlm": "vl", "encoder": "frames"}.get(cfg.family)
    model = model_launches(cfg, use_flash, remat)

    def batches():
        if kind == "frames":
            return frame_batches(cfg, dev)
        return vl_batches(cfg, dev) if kind == "vl" else None

    def cell(tier, route, p, mesh, steps, dp, sched=None):
        return train_cell(
            Session, cfg, p, opt, mesh, steps, {**model, **dp},
            f"{log_name}-{tier}", next_batch=batches(), route=route,
            silo_schedule=sched,
            make_session=lambda **kw: family_session(
                Session, cfg, route, use_flash, remat, **kw))

    rec = {}
    for route in ("A", "B"):
        rec[f"fused_{route}"] = cell("fused", route, priv, None, 3, {
            "clip_accumulate": 1, "noise_batch": 1})
    rec["barrier_B"] = cell("barrier", "B", priv_b, mesh4, 1,
                            {"clip_mask": 3},
                            lambda t: [True, True, False, True])
    rec["scan_B"] = cell("scan", "B", priv_s, None, 2, {
        "normal_combine": lambda lay: len(leaf_slices(lay))})
    rec.update(use_flash=use_flash, remat=remat, model_launches=model)
    return rec


def vl_scan_search(Session, cfg, dev, priv_s, opt) -> dict:
    """Phase 27(c): qwen2-vl-72b's scan tier under route (B) at the
    deepest of VL_SCAN_DEPTHS that fits the card, 2 steps; the fused tier
    reckoned, not run (its fp32 copies alone exceed the card)."""
    import gc

    from repro_torch.core import flatbuf
    from repro_torch.models.packing import param_tree
    from repro_torch.models.transformer import Transformer

    rec: dict = {"tried": []}
    for depth in VL_SCAN_DEPTHS:
        cut = dataclasses.replace(cfg, n_layers=depth)
        P = flatbuf.layout_of(param_tree(Transformer(cut, "meta"))).total
        # master, two moments and the stacked (4, P) rows in fp32, the
        # bf16 weights: what the fused tier holds before any activation
        fused_gb = (7 * 4 + 2) * P / 1e9
        rec["tried"].append({"n_layers": depth, "P": P,
                             "fused_tier_reckoned_gb": fused_gb})
        try:
            cell = train_cell(
                Session, cut, priv_s, opt, None, 2,
                {"normal_combine": lambda lay: len(leaf_slices(lay))},
                "bf16fam-vl-scan", next_batch=vl_batches(cut, dev),
                route="B", make_session=lambda **kw: family_session(
                    Session, cut, "B", **kw))
        except torch.cuda.OutOfMemoryError as e:
            rec["tried"][-1]["error"] = str(e)[:200]
            log(f"[bf16fam-vl-scan] {depth} layers do not fit the card "
                f"under route B: {str(e)[:160]}")
            gc.collect()
            torch.cuda.empty_cache()
            continue
        rec.update(n_layers=depth, **cell)
        break
    check("n_layers" in rec, f"qwen2-vl's route B scan tier fits at none of "
                             f"{VL_SCAN_DEPTHS} layers")
    log(f"[bf16fam-vl-scan] qwen2-vl-72b: the scan tier under route B at "
        f"{rec['n_layers']} layers (peak {rec['peak_mem_gb']:.2f} GB); the "
        f"fused tier reckoned at " + ", ".join(
            f"{t['n_layers']} layers {t['fused_tier_reckoned_gb']:.1f} GB"
            for t in rec["tried"]) + " before activations: not run")
    return rec


def dp_card_ms(dev, P: int) -> dict:
    """PERF.md rows 5, 7 and 9 on the card at the 12-layer training shape
    (qwen2.5-3b, P packed): ``clip_accumulate`` over the (4, P) silo rows,
    ``clip_sum`` over 4 examples' (4, P) rows, ``noise_batch`` over the
    (P,) aggregate; each as a call (CUDA events around back-to-back calls)
    and on the card (calls captured into one CUDA graph)."""
    from repro_torch.core import prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.kernels.dp_fused import ops as noise_ops

    gen = torch.Generator(device=dev).manual_seed(27)
    g = torch.randn(4, P, device=dev, generator=gen)
    scale = torch.tensor([0.731, 1.0, 0.0, 0.418], device=dev)
    c = torch.ones((), device=dev)
    keys = step_keys(prng.PRNGKey(1), 0)
    prev = step_keys(prng.PRNGKey(1), 1).key_xi
    scales = torch.tensor([0.075, 0.075, 0.0, 0.075], device=dev)
    lams = torch.tensor([0.7, 0.0, 0.0, 0.7], device=dev)
    g_sum = clip_ops.clip_accumulate(g, scale)
    calls = {
        "clip_accumulate": lambda: clip_ops.clip_accumulate(g, scale),
        "clip_sum": lambda: noise_ops.clip_sum_packed(g, c),
        "noise_batch": lambda: noise_ops.noise_batch(
            g_sum, keys.key_xi, prev, scales, lams, 0.075)}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        out[name] = {"ms": cuda_ms(fn, reps=5, warmup=1),
                     "device_ms": graph_ms(fn, n=2, reps=5),
                     "at": f"qwen2.5-3b at 12 layers: "
                           + ("(P,) aggregate" if name == "noise_batch"
                              else "(4, P) rows") + f", P {P}"}
        log(f"[bf16fam-dp] {name}: call {out[name]['ms']:.3f} ms, card "
            f"{out[name]['device_ms']:.3f} ms | {out[name]['at']}")
    del g, g_sum
    torch.cuda.empty_cache()
    return out


def qwen_bf16_clip_modes(Session, cfg, dev, priv_b, opt, mesh4) -> dict:
    """Phase 27(d): qwen2.5-3b at full width and 12 layers under route
    (B): 3 perleaf barrier steps (one bf16 ``zsmask_buffer`` launch a silo
    a step, the corrected instantiation: the tree is all bf16, so no fp32
    launch), then per-example clipping at 4 x 64 (one ``clip_sum``) and
    per-microbatch clipping of the same batch in 4 groups (one
    ``clip_accumulate``), each timed with its peak memory; rows 5, 7 and 9
    on the card at this shape (:func:`dp_card_ms`)."""
    from repro_torch.core import clipping
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.dispatch import force_impl

    rec: dict = {}
    with force_impl("perleaf", kernel="dp_noise_tree"):
        rec["perleaf_barrier"] = train_cell(
            Session, cfg, priv_b, opt, mesh4, 3, {"zsmask_buffer": 4},
            "bf16fam-perleaf", route="B")
    var = dispatch.variant_counts()["zsmask_buffer"]
    check(var == {"plain": 0, "prev": 0, "bf16": 0, "bf16_prev": 12},
          f"perleaf barrier under route B: zsmask_buffer instantiations "
          f"{var}, expected 12 bf16_prev")
    rec["perleaf_barrier"]["launches_by_instantiation"] = var
    sess = family_session(Session, cfg, "B", seed=0)
    params = sess.init_params()
    batch = sess.synthetic_batches(4, 64)()
    for mode, fn, want in (
            ("per_example", lambda: clipping.per_example_clipped_grad(
                sess.model.loss, params, batch, 1.0, impl="packed"),
             {"clip_sum": 1}),
            ("per_microbatch", lambda: clipping.per_microbatch_clipped_grad(
                sess.model.loss, params, batch, 1.0, n_micro=4),
             {"clip_accumulate": 1})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        summed, norms, loss = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        n = {k: v for k, v in dispatch.launch_counts().items() if v}
        check(n == want, f"{mode} over bf16 weights: launches {n}, "
                         f"expected {want}")
        top = max(t.abs().max().item() for t in summed.values()
                  if isinstance(t, torch.Tensor)) if isinstance(
            summed, dict) else summed.abs().max().item()
        check(norms.shape == (4,) and bool(torch.isfinite(norms).all())
              and math.isfinite(float(loss)) and math.isfinite(top),
              f"{mode} over bf16 weights: norms {norms}, loss {loss}")
        rec[mode] = {"s": s, "peak_mem_gb":
                     torch.cuda.max_memory_allocated() / 1e9,
                     "launches": n, "norms": norms.tolist(),
                     "loss": float(loss)}
        log(f"[bf16fam-clip] qwen2.5-3b at 12 layers, route B, {mode} "
            f"at 4 x 64: {s:.2f} s, peak {rec[mode]['peak_mem_gb']:.2f} GB,"
            f" launches {n}, norms {[round(x, 4) for x in norms.tolist()]}")
        del summed, norms
    P = sess.init_state(params=params).layout.total
    del params, sess, batch
    torch.cuda.empty_cache()
    rec["dp_rows"] = dp_card_ms(dev, P)
    return rec


def bf16_family_cross_device(Session, arch: str, priv, opt) -> dict:
    """Phase 27(e): ``arch``'s narrow (smoke) config under route (B) on the
    card and on the host CPU from the same weights and batch: one fused
    pass and one train step each; the loss within FAM_LOSS_RTOL, norms,
    bound, noisy gradient and master within phase 25's BF16_* gates, the
    carried key bit-equal, the bf16 weights the rounded master on
    both, no kernel launched by the CPU run."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.distributed import steps as steps_mod
    from repro_torch.kernels import dispatch

    cfg = get_smoke_config(arch)
    sess = {d: family_session(Session, cfg, "B", privacy=priv,
                              optimizer=opt, seed=3, device=d)
            for d in ("cuda", "cpu")}
    p_cpu = sess["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    cpu = torch.device("cpu")
    if cfg.family in ("vlm", "encoder"):
        nb = vl_batches(cfg, cpu, 16, 32) if cfg.mrope \
            else frame_batches(cfg, cpu, 16, 32)
        batch = nb()
    else:
        batch = sess["cpu"].synthetic_batches(16, 32)()
    out = {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        dispatch.reset_launches()
        out[d] = narrow_step(sess[d], p, {k: v.to(d) for k, v in
                                          batch.items()},
                             steps_mod, step_keys, prng)
        out[d] += (dispatch.launch_counts(),)
    (n_g, m_g, x_g, s_g, c_g), (n_c, m_c, x_c, s_c, c_c) = \
        out["cuda"], out["cpu"]
    check(c_g["clip_accumulate"] == 2 and c_g["noise_batch"] == 2,
          f"{arch} narrow card launches {c_g}")
    check(all(v == 0 for v in c_c.values()), f"the CPU step launched {c_c}")
    check(x_g["prev_key"] == x_c["prev_key"]
          and s_g.noise_state.prev_key == s_c.noise_state.prev_key,
          f"{arch}: carried noise key differs between card and CPU")
    check(weights_are_rounded_master(s_g) and weights_are_rounded_master(s_c),
          f"{arch} narrow: the weights are not the rounded master")
    loss_err = abs(x_g["loss"] - x_c["loss"]) / abs(x_c["loss"])
    check(loss_err <= FAM_LOSS_RTOL, f"{arch} narrow loss: card "
                                     f"{x_g['loss']} vs CPU {x_c['loss']}")
    for k in ("clip_bound", "grad_norm_mean"):
        check(math.isclose(m_g[k], m_c[k], rel_tol=BF16_NORM_RTOL),
              f"{arch} narrow {k}: card {m_g[k]} vs CPU {m_c[k]}")
    norm_err = ((x_g["norms"] - x_c["norms"]).abs()
                / x_c["norms"].abs()).max().item()
    check(norm_err <= BF16_NORM_RTOL, f"{arch} narrow norms {norm_err}")
    noisy_err = (n_g - n_c).abs().max().item()
    check(noisy_err <= BF16_NOISY_ATOL, f"{arch} noisy gradient "
                                        f"{noisy_err}")
    dp = (s_g.opt_state["master"].cpu() - s_c.opt_state["master"]).abs()
    share = (dp > opt.lr / 10).float().mean().item()
    check(dp.max().item() <= BF16_PARAM_ATOL and share <= BF16_FLIP_SHARE,
          f"{arch} master differs: max {dp.max().item()}, {share} past "
          f"lr/10")
    rec = {"P": s_c.layout.total, "dtypes": sorted(set(s_c.layout.dtypes)),
           "loss": [x_g["loss"], x_c["loss"]], "loss_rel_err": loss_err,
           "norms_max_rel_err": norm_err, "noisy_max_abs_err": noisy_err,
           "master_max_abs_err": dp.max().item(),
           "master_share_past_lr_10": share, "card_launches": {
               k: v for k, v in c_g.items() if v}}
    log(f"[bf16fam-slice] {arch} narrow (P {rec['P']}, "
        f"{'/'.join(rec['dtypes'])}), route B, card vs CPU: loss rel "
        f"{loss_err:.3g} | norms rel {norm_err:.3g} | noisy max |diff| "
        f"{noisy_err:.3g} | master max |diff| {dp.max().item():.3g}, "
        f"{share:.3g} past lr/10 | card launches {rec['card_launches']}")
    return rec


def bf16families_phase(dev) -> dict:
    """Phase 27 (``--bf16families`` only): training in bf16 for every
    family of JAX's ``build_model`` at published width, phase 7's privacy
    (4 silos, sigma 0.3, dynamic clipping, lambda 0.7), AdamW lr 1e-3,
    16 x 64 a step. (a) rwkv6-7b at 4 of 32 layers and zamba2-7b at 12 of
    81 (its shared block through the flash pair): :func:`family_cells`;
    (b) phi3.5-moe at 1 layer and hubert-xlarge at 48 under ``remat``
    and ``use_flash``: the same; (c) qwen2-vl-72b's scan tier
    (:func:`vl_scan_search`); (d) qwen2.5-3b at 12 layers under route
    (B): the perleaf barrier tier, per-example and per-microbatch
    clipping, and PERF.md rows 5, 7 and 9 on the card
    (:func:`qwen_bf16_clip_modes`); (e) each family's narrow config card
    vs CPU (:func:`bf16_family_cross_device`). No plain attention, scan or
    tree-mask call on the card throughout."""
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          PrivacyConfig)

    t0 = time.perf_counter()
    priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=4)
    privs = (priv, dataclasses.replace(priv, sync_path="barrier"),
             dataclasses.replace(priv, silo_mode="scan"))
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    mesh4 = MeshConfig((4,), ("data",))
    rec: dict = {"cells": {}, "phase_s": {}}
    attn: dict = {}
    scans: dict = {}
    with plain_attention_spy(attn), plain_scan_spy(scans):
        for arch, flash, remat in ((RWKV, False, False), (ZAMBA, True, False),
                                   (PHI, True, True), (HUBERT, True, True)):
            t1 = time.perf_counter()
            cut = dataclasses.replace(get_config(arch),
                                      n_layers=FAM27_LAYERS[arch])
            rec["cells"][arch] = family_cells(Session, cut, dev, privs, opt,
                                              mesh4, flash, remat, "bf16fam")
            rec["phase_s"][arch] = time.perf_counter() - t1
        t1 = time.perf_counter()
        rec["vl_scan"] = vl_scan_search(Session, get_config(VL), dev,
                                        privs[2], opt)
        rec["phase_s"]["vl_scan"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        cut12 = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=12)
        rec["qwen12"] = qwen_bf16_clip_modes(Session, cut12, dev, privs[1],
                                             opt, mesh4)
        rec["phase_s"]["qwen12"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        narrow_priv = dataclasses.replace(priv, clip_percentile_max=NARROW_CAP)
        rec["cross_device"] = {
            arch: bf16_family_cross_device(Session, arch, narrow_priv, opt)
            for arch in (PHI, VL, HUBERT, RWKV, ZAMBA)}
        rec["phase_s"]["cross_device"] = time.perf_counter() - t1
    check(attn["plain_calls_on_card"] == 0 and scans["plain_calls_on_card"]
          == 0, f"plain calls on the card: attention "
                f"{attn['plain_calls_on_card']}, scans and tree masks "
                f"{scans['plain_calls_on_card']}")
    rec["plain_calls_on_card"] = 0
    for arch, cells in rec["cells"].items():
        log(f"[bf16fam] {arch} at {FAM27_LAYERS[arch]} layers: ms a step "
            f"after the first, fused A / fused B: " + " / ".join(
                f"{sum(cells[c]['step_ms'][1:]) / 2:.1f}"
                for c in ("fused_A", "fused_B")) + " | peak GB fused A / B "
            "/ barrier B / scan B: " + " / ".join(
                f"{cells[c]['peak_mem_gb']:.2f}" for c in (
                    "fused_A", "fused_B", "barrier_B", "scan_B")))
    rec["total_s"] = time.perf_counter() - t0
    log(f"[bf16fam] phase 27 in {rec['total_s']:.1f} s; no plain attention, "
        f"scan or tree-mask call on the card")
    return rec


# --------------------------------------------------------------- phase 28
# JAX's long-context cells on one card (--longctx only): the dry run's plan
# and --run at full width in bf16, and gates (a)-(e) at the cells' depths
LONGCTX_CELLS = (("qwen2.5-3b", "prefill_32k"), ("qwen2.5-3b", "decode_32k"),
                 ("zamba2-7b", "prefill_32k"), ("zamba2-7b", "decode_32k"),
                 ("rwkv6-7b", "long_500k"), ("zamba2-7b", "long_500k"))
# gate (e): the measured peak at or under the plan, the plan within 10% of it
PLAN_SLACK = 1.10
# gate (a): query rows of the flash serving forward held to the plain
# version (a row's plain output needs every key up to it: sampled rows keep
# the plain version's scores at (B, Hq, rows, S) instead of S x S)
FLASH_ROWS = 256
# the blocked plain version's query rows a block (scores (B, Hq, 2048, S))
PLAIN_BLOCK = 2048
# gate (c): the chunked prefill's calls at S 32768
CHUNKS_32K = 4


def attention_rows_plain(q, k, v, rows, causal: bool = True):
    """``ref.attention_ref``'s function at query rows ``rows`` only: fp32
    scores of each row against every key (masked past the row when causal),
    the softmax, the fp32 product with V, rounded once to q's dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    end = int(rows.max()) + 1 if causal else S
    qg = q[:, rows].reshape(B, rows.numel(), Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, :end].float()) \
        / (D ** 0.5)
    if causal:
        mask = rows[:, None] >= torch.arange(end, device=q.device)[None]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v[:, :end].float())
    return out.reshape(B, rows.numel(), Hq, D).to(q.dtype)


def attention_blocked_plain(q, k, v, causal: bool = True):
    """The plain version of the serving forward over a whole sequence, a
    batch row and PLAIN_BLOCK query rows at a time
    (:func:`attention_rows_plain`)."""
    B, S = q.shape[:2]
    out = torch.empty_like(q)
    for b in range(B):  # a row's scores at a time: (1, Hq, block, S)
        for i in range(0, S, PLAIN_BLOCK):
            rows = torch.arange(i, min(i + PLAIN_BLOCK, S), device=q.device)
            out[b:b + 1, i:i + rows.numel()] = attention_rows_plain(
                q[b:b + 1], k[b:b + 1], v[b:b + 1], rows, causal)
    return out


@contextlib.contextmanager
def plain_on_card():
    """The serving forward's kernels replaced by their plain versions on
    CUDA tensors, for gates (b) and (d): flash attention by
    :func:`attention_blocked_plain`, the scans by ``ref.wkv_chunked_ref``
    and ``ref.ssd_chunked_ref`` (the chunked forms the kernels are held to
    in phase 11)."""
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import mamba2 as m2_mod
    from repro_torch.models import rwkv6 as rwkv_mod

    saved = (attn_mod.flash_ops, rwkv_mod.rwkv_ops, m2_mod.ssd_ops)
    attn_mod.flash_ops = types.SimpleNamespace(
        flash_attention=attention_blocked_plain)
    rwkv_mod.rwkv_ops = types.SimpleNamespace(
        wkv_chunked=lambda *a, chunk=32: wkv_ref.wkv_chunked_ref(
            *a, chunk=chunk))
    m2_mod.ssd_ops = types.SimpleNamespace(
        ssd_chunked=lambda *a, chunk=64: ssd_ref.ssd_chunked_ref(
            *a, chunk=chunk))
    try:
        yield
    finally:
        attn_mod.flash_ops, rwkv_mod.rwkv_ops, m2_mod.ssd_ops = saved


def logits_gate(got, want, what: str) -> dict:
    """Phase 23's serving gate in bf16: last logits within BF16_ATOL, and
    a greedy token split only where the reference's margin between the two
    tokens is within BF16_TIE."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    check(err <= BF16_ATOL, f"{what}: logits differ by {err} (gate "
                            f"{BF16_ATOL})")
    a, b = got.argmax(-1), want.argmax(-1)
    rows = torch.nonzero(a != b).flatten().tolist()
    margins = [(want[r, b[r]] - want[r, a[r]]).item() for r in rows]
    check(all(m <= BF16_TIE for m in margins), f"{what}: a token split at a "
          f"margin past {BF16_TIE}: {margins}")
    return {"max_abs_err": err, "token_splits": len(rows),
            "split_margins": margins}


def longctx_cell(arch: str, shape: str, out_dir: Path, src: Path) -> dict:
    """One cell through the dry run's CLI with ``--run``, in a process of
    its own (the card emptied between cells), then gate (e) on its
    record; a cell the plan refuses is its plan alone."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    plan = dryrun.plan_record(arch, shape)
    if plan["status"] != "ok":
        log(f"[longctx] {arch} {shape}: {plan['status']}: "
            f"{plan.get('reason')} (arguments "
            f"{json.dumps(plan['memory']['argument_parts'])})")
        return plan
    env = dict(os.environ, PYTHONPATH=str(src))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--run", "--out", str(out_dir)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        log(f"[longctx]   {line}")
    check(res.returncode == 0, f"dryrun --run {arch} {shape}: rc "
          f"{res.returncode}: {res.stderr[-1500:]}")
    rec = json.loads((out_dir / f"{arch}__{shape}.json").read_text())
    run = rec["run"]
    plan_b = rec["memory"]["total_bytes_per_dev"]
    peak = run["peak_bytes"]
    check(run["logits_finite"] and run["logits_shape"] == [
        rec["batch"], get_config(arch).vocab_size], f"{arch} {shape}: logits "
          f"{run['logits_shape']}, finite {run['logits_finite']}")
    check(peak <= plan_b, f"(e) {arch} {shape}: measured peak {peak} over "
                          f"the plan {plan_b}")
    check(plan_b <= PLAN_SLACK * peak, f"(e) {arch} {shape}: the plan "
          f"{plan_b} is {plan_b / peak:.3f} of the measured peak {peak}")
    rec["wall_s"] = wall
    hc = rec.get("hlo_cost")
    if isinstance(hc, dict):  # the counted step (trees with op_cost.py)
        flops = hc["flops_per_chip"]
        share = flops / (run["step_ms"] / 1e3) / BF16_FLOP_PER_S
        rec["counted"] = {"flops": flops, "hbm_bytes":
                          hc["hbm_bytes_per_chip"],
                          "t_compute_s": rec["roofline"]["t_compute_s"],
                          "t_memory_s": rec["roofline"]["t_memory_s"],
                          "step_share_of_bf16_peak": share}
        log(f"[longctx] {arch} {shape}: counted {flops:.4e} FLOPs and "
            f"{hc['hbm_bytes_per_chip']:.4e} bytes a step (op_cost; "
            f"t_compute {rec['roofline']['t_compute_s']:.3f} s, t_memory "
            f"{rec['roofline']['t_memory_s']:.3f} s): the measured step "
            f"{run['step_ms']:.1f} ms reached {100 * share:.2f}% of "
            f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s | {card_line()}")
    pre = run.get("prefill", {})
    launches = pre.get("launches") or run["launches"]
    log(f"[longctx] {arch} {shape}: batch {rec['batch']} of "
        f"{rec['global_batch']} at S {rec['seq_len']}: step "
        f"{run['step_ms']:.1f} ms | peak planned "
        f"{plan_b / 1e9:.2f} GB, measured {peak / 1e9:.2f} GB (plan / "
        f"peak {plan_b / peak:.4f}) | launches {json.dumps(launches)}"
        + (f" | the state by {pre['calls']} prefill calls of {pre['chunk']}"
           f" tokens: {pre['ms']:.0f} ms, peak {pre['peak_bytes'] / 1e9:.2f}"
           f" GB" if pre else ""))
    return rec


def flash_rows_gate(cfg, dev, gen, S: int, B: int = 1) -> dict:
    """Gate (a): the bf16 flash serving forward at ``cfg``'s heads and the
    cell's depth against its plain version at FLASH_ROWS query rows (the
    first, the last and the rest drawn), at the bf16 instantiation's gate:
    within one bf16 ulp past the fp32 gate (KERNEL_ATOL / RTOL)."""
    from repro_torch.kernels.flash_attention import ops

    bf = torch.bfloat16
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.randn(B, S, Hq, D, device=dev, generator=gen).to(bf)
    k = torch.randn(B, S, Hkv, D, device=dev, generator=gen).to(bf)
    v = torch.randn(B, S, Hkv, D, device=dev, generator=gen).to(bf)
    got = ops.flash_attention(q, k, v, causal=True)
    rows = torch.cat([torch.tensor([0, S - 1], device=dev),
                      torch.randint(1, S - 1, (FLASH_ROWS - 2,), device=dev,
                                    generator=gen)]).unique()
    want = attention_rows_plain(q, k, v, rows)
    g = got[:, rows].float()
    diff = (g - want.float()).abs()
    ulp = bf16_ulp(torch.maximum(g.abs(), want.float().abs()))
    gate = KERNEL_ATOL + KERNEL_RTOL * want.float().abs() + ulp
    err = diff.max().item()
    check(bool((diff <= gate).all()), f"(a) flash bf16 at S {S}, heads "
          f"{Hq}/{Hkv} d_head {D}: past one ulp of its plain version ({err})")
    return {"S": S, "B": B, "rows": rows.numel(), "max_abs_err": err,
            "max_ulps": (diff / ulp).max().item(),
            "at": f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal bf16"}


def prefill_slice(cfg, dev, S: int, seed: int, plain: bool):
    """A cut of the cell's model (``cfg``) prefilled over S seeded tokens
    at batch 1 through the kernels, or through their plain versions on
    the card: its last logits and the kernels it launched."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun

    model = dryrun.cell_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        params = model.init(gen)
        toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                             device=dev, dtype=torch.int32)
        cache = model.init_cache(1, S)
        dispatch.reset_launches()
        with plain_on_card() if plain else contextlib.nullcontext():
            logits = model.prefill(params, toks, cache)
        torch.cuda.synchronize()
    launches = {k: v for k, v in dispatch.launch_counts().items() if v}
    del params, cache
    torch.cuda.empty_cache()
    return logits, launches


def slice_gate(cfg, dev, S: int, seed: int, what: str, want: dict) -> dict:
    """Gate (b): the slice through the kernels against the same slice
    through the plain versions on the card (:func:`logits_gate`); the
    kernels' launches ``want``, none under the plain versions."""
    t0 = time.perf_counter()
    got, n = prefill_slice(cfg, dev, S, seed, False)
    ref_, n_plain = prefill_slice(cfg, dev, S, seed, True)
    check(n == want, f"(b) {what}: launches {n}, want {want}")
    check(not n_plain, f"(b) {what}: the plain run launched {n_plain}")
    out = logits_gate(got, ref_, f"(b) {what}")
    out.update(launches=n, S=S, layers=cfg.n_layers,
               s=time.perf_counter() - t0)
    log(f"[longctx] (b) {what}: kernels vs plain versions on the card, last "
        f"logits {out['max_abs_err']:.4g} apart (gate {BF16_ATOL}), "
        f"{out['token_splits']} token splits; launches {json.dumps(n)}")
    return out


def rwkv_chunk_gate(dev, gen, ops, ref) -> dict:
    """Gate (c): ``wkv`` over S 32768 at rwkv6-7b's heads in one call
    against CHUNKS_32K calls with the state carried, and against the plain
    chunked version, within the scans' gate (WKV_ATOL). Then a report, not
    a gate: rwkv6-7b (32 layers, bf16) prefilled at S 32768 in one call and
    in CHUNKS_32K, its last logits and WKV states apart (the bf16 products
    at 8192 rows a call round otherwise than at 32768, and 32 layers of
    random weights carry the difference on)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    cfg = get_config("rwkv6-7b")
    H, N, S = cfg.n_heads, cfg.rwkv_head_size, 32_768
    r, k, v, w, u, s0 = wkv_inputs(dev, gen, 1, S, H, N)
    o1, st1 = ops.wkv_chunked(r, k, v, w, u, s0)
    c = S // CHUNKS_32K
    st, parts = s0, []
    for i in range(CHUNKS_32K):
        sl = slice(i * c, (i + 1) * c)
        o_, st = ops.wkv_chunked(r[:, sl].contiguous(), k[:, sl].contiguous(),
                                 v[:, sl].contiguous(), w[:, sl].contiguous(),
                                 u, st)
        parts.append(o_)
    po, pst = ref.wkv_chunked_ref(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    oc = torch.cat(parts, 1)
    scan = {"chunked_vs_one": max((oc - o1).abs().max().item(),
                                  (st - st1).abs().max().item()),
            "one_vs_plain": max((o1 - po).abs().max().item(),
                                (st1 - pst).abs().max().item())}
    check(max(scan.values()) <= WKV_ATOL, f"(c) wkv at S {S}: {scan} "
          f"(tolerance {WKV_ATOL})")
    del r, k, v, w, o1, oc, po, parts
    model = dryrun.cell_model(cfg, dev)
    g2 = torch.Generator(device=dev).manual_seed(28)
    with torch.inference_mode():
        params = model.init(g2)
        toks = torch.randint(0, cfg.vocab_size, (1, S), generator=g2,
                             device=dev, dtype=torch.int32)
        one = model.init_cache(1, S)
        l1 = model.prefill(params, toks, one)
        chunked = model.init_cache(1, S)
        for i in range(CHUNKS_32K):
            lc = model.prefill(params, toks[:, i * c:(i + 1) * c], chunked)
        torch.cuda.synchronize()
        state_err = (one["S"] - chunked["S"]).abs().max().item()
        logit_err = (lc.float() - l1.float()).abs().max().item()
        layer0_err = (one["S"][0] - chunked["S"][0]).abs().max().item()
    out = {"scan": scan, "S": S, "chunks": CHUNKS_32K,
           "model_report": {"logits_max_abs_err": logit_err,
                            "same_token": bool(torch.equal(
                                lc.argmax(-1), l1.argmax(-1))),
                            "state_max_abs_err": state_err,
                            "layer0_state_max_abs_err": layer0_err}}
    log(f"[longctx] (c) rwkv6-7b at S {S}: wkv in {CHUNKS_32K} calls vs one "
        f"{scan['chunked_vs_one']:.3g}, one vs plain "
        f"{scan['one_vs_plain']:.3g} (gate {WKV_ATOL}); report: the model "
        f"in {CHUNKS_32K} calls vs one, last logits {logit_err:.4g} apart "
        f"(same token: {out['model_report']['same_token']}), WKV states "
        f"{state_err:.3g} (layer 0: {layer0_err:.3g})")
    del params, one, chunked
    torch.cuda.empty_cache()
    return out


def rwkv_deep_gate(dev, seed: int = 29) -> dict:
    """Gate (d): rwkv6-7b cut to 2 layers, its state brought to long_500k's
    depth (524,288 seeded tokens, LONG_CHUNK a call) through the kernels
    and through the plain versions on the card, then one decode step:
    last logits at the serving gate."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=2)
    shape = SHAPES["long_500k"]
    outs, t0 = {}, time.perf_counter()
    for plain in (False, True):
        cell = dryrun.build_cell("rwkv6-7b", "long_500k", 1, dev, cfg=cfg)
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.inference_mode():
            params = cell.model.init(gen)
            cache = cell.model.init_cache(1, shape.seq_len)
            dispatch.reset_launches()
            with plain_on_card() if plain else contextlib.nullcontext():
                pre = dryrun.long_prefill(cell, params, cache, gen)
                del pre["logits"]
                tok = torch.randint(0, cfg.vocab_size, (1, 1), generator=gen,
                                    device=dev, dtype=torch.int32)
                outs[plain] = (cell.model.decode_step(params, tok, cache),
                               pre["launches"])
        del params, cache
    check(outs[False][1] == {"wkv": 2 * pre["calls"]} and not outs[True][1],
          f"(d) launches: kernels {outs[False][1]}, plain {outs[True][1]}")
    out = logits_gate(outs[False][0], outs[True][0], "(d) rwkv6-7b")
    out.update(layers=2, tokens=shape.seq_len, launches=outs[False][1],
               s=time.perf_counter() - t0)
    log(f"[longctx] (d) rwkv6-7b, 2 layers at depth {shape.seq_len}: kernels"
        f" vs plain versions on the card, last logits "
        f"{out['max_abs_err']:.4g} apart (gate {BF16_ATOL}); launches "
        f"{json.dumps(out['launches'])}")
    torch.cuda.empty_cache()
    return out


def long_flash_row(cfg, dev, gen, B: int, S: int, F) -> dict:
    """Row 1's bf16 serving forward at S ``S``, ``cfg``'s heads and the
    prefill's batch: held to its plain version at sampled rows
    (:func:`flash_rows_gate`'s gate), timed as calls (3 after one) beside
    the blocked plain version (once) and SDPA in bf16; the bound from bf16
    bytes and the causal products at the tensor cores' bf16 rate."""
    from repro_torch.kernels.flash_attention import ops

    bf = torch.bfloat16
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.randn(B, S, Hq, D, device=dev, generator=gen).to(bf)
    k = torch.randn(B, S, Hkv, D, device=dev, generator=gen).to(bf)
    v = torch.randn(B, S, Hkv, D, device=dev, generator=gen).to(bf)
    call = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    got = call()
    rows = torch.cat([torch.tensor([S - 1], device=dev),
                      torch.randint(0, S - 1, (63,), device=dev,
                                    generator=gen)])
    want = attention_rows_plain(q, k, v, rows)
    g = got[:, rows].float()
    diff = (g - want.float()).abs()
    ulp = bf16_ulp(torch.maximum(g.abs(), want.float().abs()))
    err = diff.max().item()
    check(bool((diff <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
                + ulp).all()), f"row 1 bf16 at S {S}, B {B}: past one ulp "
          f"of its plain version ({err})")
    del got
    # SDPA's flash backend, forced, on K and V repeated to the query heads
    # (GQA by hand): at S 32768 the math backend's S x S scores would not
    # fit the card
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
              .contiguous() for t in (k, v))

    def sdpa():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    bms, by = bound(*work().flash_work(q, k, v, True), BF16_FLOP_PER_S)
    return {"max_abs_err": err, "max_ulps": (diff / ulp).max().item(),
            "ms": cuda_ms(call, reps=3, warmup=0),
            "plain_ms": cuda_ms(lambda: attention_blocked_plain(q, k, v),
                                reps=1, warmup=0),
            "library_ms": cuda_ms(sdpa, reps=3, warmup=1),
            "bound_ms": bms, "bound_by": by,
            "library_call": "SDPA's flash backend on K, V repeated to Hq",
            "at": f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal bf16 "
                  f"(plain version: {PLAIN_BLOCK}-row blocks)"}


def long_scan_rows(dev, gen, ops_w, ref_w, ops_s, ref_s, zb: int) -> dict:
    """Rows 11 and 12 at the long cells' call shapes: ``wkv`` at rwkv6-7b's
    long_500k prefill call (1, LONG_CHUNK, 64, 64), held to its plain
    chunked version at phase 11's gate (WKV_ATOL), and ``ssd`` at
    zamba2-7b's prefill_32k call (its planned batch ``zb``, 32768, 112,
    64, N 64), held with its plain version to the plain version in fp64:
    the kernel within SSD_ATOL of the fp32 plain version's own distance;
    each timed beside its plain version (call times; the card's alone for
    the kernel)."""
    from repro_torch.configs import get_config

    rc, zc = get_config("rwkv6-7b"), get_config("zamba2-7b")
    H, N = rc.n_heads, rc.rwkv_head_size
    S = 32_768
    xs = wkv_inputs(dev, gen, 1, S, H, N)
    o, st = ops_w.wkv_chunked(*xs)
    po, pst = ref_w.wkv_chunked_ref(*xs)
    werr = max((o - po).abs().max().item(), (st - pst).abs().max().item())
    check(werr <= WKV_ATOL, f"wkv at (1, {S}, {H}, {N}): {werr}")
    r, u, s0 = xs[0], xs[4], xs[5]
    wkv = scan_timing(lambda: ops_w.wkv_chunked(*xs),
                      lambda: ref_w.wkv_chunked_ref(*xs),
                      *work().wkv_work(r, u, s0), f"B=1 S={S} H={H} N={N} fp32 "
                      f"(rwkv6-7b's long_500k prefill call)", graph_n=3,
                      plain_reps=1)
    wkv["max_abs_err"] = werr
    del xs, o, po
    d_in = zc.mamba_expand * zc.d_model
    nh, P, Ns = d_in // zc.mamba_headdim, zc.mamba_headdim, zc.ssm_state
    xs = ssd_inputs(dev, gen, zb, S, nh, P, Ns)
    y, h = ops_s.ssd_chunked(*xs)
    py, ph = ref_s.ssd_chunked_ref(*xs)
    serr = max((y - py).abs().max().item(), (h - ph).abs().max().item())
    # at this depth the two fp32 orders part by more than phase 11's
    # SSD_ATOL: each is held to the plain version in fp64 instead, and the
    # kernel may be no further from it than the fp32 plain version is
    dy, dh = ref_s.ssd_chunked_ref(*(t.double() for t in xs))
    k64 = max((y - dy).abs().max().item(), (h - dh).abs().max().item())
    p64 = max((py - dy).abs().max().item(), (ph - dh).abs().max().item())
    ymax = dy.abs().max().item()
    del dy, dh, py, ph
    check(k64 <= p64 + SSD_ATOL, f"ssd at ({zb}, {S}, {nh}, {P}): "
          f"{k64} from the fp64 plain version, the fp32 one {p64}")
    x, dt, _, Bc, _, h0 = xs
    ssd = scan_timing(lambda: ops_s.ssd_chunked(*xs),
                      lambda: ref_s.ssd_chunked_ref(*xs),
                      *work().ssd_work(x, dt, Bc, h0),
                      f"B={zb} S={S} nh={nh} P={P} N={Ns} fp32 (zamba2-7b's "
                      f"prefill_32k)", graph_n=3, plain_reps=1)
    ssd.update(max_abs_err=serr, fp64_max_abs_err=k64,
               plain_fp64_max_abs_err=p64, y_max_abs=ymax)
    torch.cuda.empty_cache()
    return {"wkv_long": wkv, "ssd_32k": ssd}


def long_paged_row(cfg, dev, gen, B: int, F) -> dict:
    """Row 2's bf16 tensor-core kernel over a 32,768-deep table (2048 pages
    of 16 a slot), C 1 at the last position of every slot, at ``cfg``'s
    heads and the decode cell's batch: the pool filled with seeded K/V,
    held to its plain version at the row's gate (KERNEL_ATOL / RTOL), timed
    as calls and on the card beside SDPA in bf16 over the gathered K/V."""
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.kernels.paged_attention.paged_attention import plan_tc

    nP, P, C = 2048, 16, 1
    S = nP * P
    q, kp, vp, tables, qs = paged_case(cfg, dev, gen, B, C, nP, P,
                                       [S - 1] * B)
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    got = ops.paged_attention(q, kp, vp, tables, qs)
    want = ref.paged_attention_ref(q, kp, vp, tables, qs)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
          f"paged bf16 over {nP} pages a slot, B {B}: {err}")
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kg = kp[tables.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    vg = vp[tables.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    nbytes, flops = paged_work(q, tables.cpu(), qs.cpu(), P, Hkv)
    bms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    call = lambda: ops.paged_attention(q, kp, vp, tables, qs)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kg, vg, enable_gqa=True)
    rows, chunks = plan_tc(Hq // Hkv * C, nP, P)
    return {"max_abs_err": err, "ms": cuda_ms(call),
            "device_ms": graph_ms(call, n=10, reps=5),
            "plain_ms": cuda_ms(lambda: ref.paged_attention_ref(
                q, kp, vp, tables, qs), reps=2, warmup=1),
            "library_ms": cuda_ms(sdpa), "library_device_ms": graph_ms(
                sdpa, n=10, reps=5),
            "bound_ms": bms, "bound_by": by,
            "plan": {"chunks": chunks, "row_tile": rows},
            "at": f"B={B} C={C} Hq={Hq} Hkv={Hkv} D={D} P={P} nP={nP} "
                  f"q_start={S - 1} bf16 (pools bf16, output fp32)"}


def step_profile(cfg, dev, B: int, S: int, kind: str, what: str) -> dict:
    """Where a step's card time goes, from ``torch.profiler`` over one
    prefill (on an empty cache) or one decode step (against a cache filled
    at depth S - 1) of ``cfg`` (a cut of the cell's model) at the cell's
    batch and depth: the card's busy ms, the flash kernel's and the SSD
    scan's ms and shares, and the kernels that take the most time."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.profile_serve import _window

    model = dryrun.cell_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(30)
    with torch.inference_mode():
        params = model.init(gen)
        cache = model.init_cache(B, S)
        if kind == "decode":
            dryrun.fill_cache(cache, S - 1, gen)
        toks = torch.randint(0, cfg.vocab_size, (B, S if kind == "prefill"
                                                 else 1), generator=gen,
                             device=dev, dtype=torch.int32)
        w = _window(lambda: model.prefill(params, toks, cache), 10_000)
    kernels = [r for r in w["top"] if r["cpu_ms"] == 0.0]
    flash = sum(r["device_ms"] for r in kernels if "flash" in r["name"])
    ssd = sum(r["device_ms"] for r in kernels if "ssd" in r["name"])
    out = {"kind": kind, "layers": cfg.n_layers, "B": B, "S": S,
           "wall_ms": w["wall_ms"], "device_busy_ms": w["device_busy_ms"],
           "flash_ms": flash, "ssd_ms": ssd,
           "attention_share": flash / w["device_busy_ms"],
           "ssd_share": ssd / w["device_busy_ms"],
           "top": [{"name": r["name"][:120], "count": r["count"],
                    "device_ms": r["device_ms"]} for r in kernels[:6]]}
    log(f"[longctx] {what} {kind} at {cfg.n_layers} layers, B {B} S {S} "
        f"under torch.profiler: card busy {out['device_busy_ms']:.1f} of "
        f"{out['wall_ms']:.1f} ms; flash {flash:.1f} ms "
        f"({out['attention_share']:.1%}), ssd {ssd:.1f} ms "
        f"({out['ssd_share']:.1%}); top: " + "; ".join(
            f"{r['device_ms']:.1f} ms x{r['count']} {r['name'][:60]}"
            for r in out["top"][:4]))
    del params, cache
    torch.cuda.empty_cache()
    return out


def longctx_phase(dev, src: Path) -> dict:
    """Phase 28 (``--longctx`` only): JAX's long-context cells on one card.
    Each cell of LONGCTX_CELLS through ``python -m
    repro_torch.launch.dryrun --run`` (full width, bf16, JAX's seq_len, the
    plan's batch), in a process of its own, with gate (e); zamba2-7b's
    long_500k is the plan's "does not fit". Then (a) the flash serving
    forward against its plain version at sampled rows at S 32768, at
    qwen2.5-3b's and zamba2-7b's heads; (b) a 2-layer slice of
    qwen2.5-3b's prefill and one group of zamba2-7b's (6 Mamba-2 layers and
    the shared block) through the kernels against the plain versions on
    the card; (c) rwkv6-7b's chunked prefill against one call at S 32768;
    (d) rwkv6-7b at 2 layers at depth 524,288, kernels against plain
    versions; rows 1, 2, 11 and 12 at the cells' shapes; and where the
    card's time goes in a cut of each prefill and of qwen2.5-3b's decode
    (``torch.profiler``)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "dryrun"   # the dry run's own default
    out_dir.mkdir(parents=True, exist_ok=True)
    rec: dict = {"cells": {}, "phase_s": {}}
    for arch, shape in LONGCTX_CELLS:
        rec["cells"][f"{arch} {shape}"] = longctx_cell(arch, shape, out_dir,
                                                       src)
    rec["phase_s"]["cells"] = time.perf_counter() - t0
    z_long = rec["cells"]["zamba2-7b long_500k"]
    check(z_long["status"] == "does_not_fit", "zamba2-7b long_500k: the plan "
          "should not fit one card")
    qwen, zamba = get_config("qwen2.5-3b"), get_config("zamba2-7b")
    gen = torch.Generator(device=dev).manual_seed(28)
    t1 = time.perf_counter()
    rec["a"] = {name: flash_rows_gate(cfg, dev, gen, 32_768)
                for name, cfg in (("qwen2.5-3b", qwen), ("zamba2-7b", zamba))}
    for name, r in rec["a"].items():
        log(f"[longctx] (a) flash bf16 at {name}'s heads, S 32768: "
            f"{r['rows']} rows, max_abs_err {r['max_abs_err']:.3g} "
            f"({r['max_ulps']:.2f} ulps)")
    rec["b"] = {
        "qwen2.5-3b": slice_gate(dataclasses.replace(qwen, n_layers=2), dev,
                                 32_768, 31, "qwen2.5-3b, 2 layers",
                                 {"flash_attention": 2}),
        "zamba2-7b": slice_gate(
            dataclasses.replace(zamba, n_layers=zamba.attn_every), dev,
            32_768, 32, "zamba2-7b, a group",
            {"flash_attention": 1, "ssd": zamba.attn_every})}
    rec["c"] = rwkv_chunk_gate(dev, gen, wkv_ops, wkv_ref)
    rec["d"] = rwkv_deep_gate(dev)
    rec["phase_s"]["gates"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    qb = rec["cells"]["qwen2.5-3b prefill_32k"]["batch"]
    zb = rec["cells"]["zamba2-7b prefill_32k"]["batch"]
    db = rec["cells"]["qwen2.5-3b decode_32k"]["batch"]
    rows = {"flash_32k": long_flash_row(qwen, dev, gen, qb, 32_768, F),
            "flash_32k_d112": long_flash_row(zamba, dev, gen, zb, 32_768, F)}
    rows.update(long_scan_rows(dev, gen, wkv_ops, wkv_ref, ssd_ops, ssd_ref,
                               zb))
    rows["paged_32k"] = long_paged_row(qwen, dev, gen, db, F)
    rec["rows"] = rows
    for name, r in rows.items():
        log(f"[longctx] row {name}: max_abs_err {r['max_abs_err']:.3g} | "
            f"kernel {r['ms']:.4f} ms"
            + (f" (on the card {r['device_ms']:.4f})" if "device_ms" in r
               else "") + f" | plain {r['plain_ms']:.4f} ms | library "
            + (f"{r['library_ms']:.4f} ms" if r.get("library_ms") else
               "none") + f" | bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            f" | {r['at']}")
    rec["phase_s"]["rows"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    q2 = dataclasses.replace(qwen, n_layers=2)
    z1 = dataclasses.replace(zamba, n_layers=zamba.attn_every)
    rec["profile"] = {
        "qwen2.5-3b prefill": step_profile(q2, dev, qb, 32_768, "prefill",
                                           "qwen2.5-3b"),
        "zamba2-7b prefill": step_profile(z1, dev, zb, 32_768, "prefill",
                                          "zamba2-7b"),
        "qwen2.5-3b decode": step_profile(q2, dev, db, 32_768, "decode",
                                          "qwen2.5-3b")}
    rec["phase_s"]["profile"] = time.perf_counter() - t1
    rec["total_s"] = time.perf_counter() - t0
    log(f"[longctx] phase 28 in {rec['total_s']:.1f} s "
        f"({json.dumps({k: round(v, 1) for k, v in rec['phase_s'].items()})})")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import (MeshConfig, OptimizerConfig,
                                          PrivacyConfig, reduce_for_smoke)
    from repro_torch.core import clipping, flatbuf, masking, prng
    from repro_torch.core.barrier import step_keys
    from repro_torch.core.dp_pipeline import DPPipeline
    from repro_torch.core.noise_correction import NoiseState
    from repro_torch.core.noise_correction import init_state as init_noise
    from repro_torch.distributed import steps as steps_mod
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.kernels.dp_clip import ref as clip_ref
    from repro_torch.kernels.dp_fused import ops as noise_ops
    from repro_torch.kernels.dp_fused import ref as noise_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref
    from repro_torch.kernels.zsmask import ops as zs_ops
    from repro_torch.kernels.zsmask import ref as zs_ref
    from repro_torch.models.packing import pack_params, param_tree
    from repro_torch.models.transformer import Transformer
    from repro_torch.runtime.serving import PagePool, zipf_requests

    t_start = time.perf_counter()
    report: dict = {}

    # 1. the card
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    report["card"] = card
    dev = torch.device("cuda")
    # fp32 at full precision: no TF32 in matrix products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    report["build_s"] = _build.build()
    log(f"[build] {len(_build.sources())} sources -> {_build.library_path().name} "
        f"in {report['build_s']:.1f} s")

    # 3. kernels against their plain versions, at the main path's shapes
    cfg = get_config("qwen2.5-3b")
    B_SLOTS, PAGE, CHUNK, MAX_LEN = 4, 16, 16, 512  # Session.serve defaults
    nP = MAX_LEN // PAGE
    gen = torch.Generator(device=dev).manual_seed(0)
    kern = {
        "paged_attention": check_paged_attention(
            cfg, dev, gen, B_SLOTS, nP, PAGE, 1, paged_ops, paged_ref, F),
        "flash_attention": check_flash(cfg, dev, gen, 4, 32, flash_ops,
                                       flash_ref, F),
    }
    # a speculative verify (spec_k 4) and a prefill chunk; decode is C 1
    kern["paged_attention"]["verify4"] = check_paged_attention(
        cfg, dev, gen, B_SLOTS, nP, PAGE, 4, paged_ops, paged_ref, F)
    kern["paged_attention"]["chunk16"] = check_paged_attention(
        cfg, dev, gen, B_SLOTS, nP, PAGE, CHUNK, paged_ops, paged_ref, F)
    # the page pools' zeroing: bit-equal to its plain version, then each
    # event as PagePool runs it (rows 3 and 4 of the kernel table)
    check_pool_zero(cfg, dev, gen, paged_ops, paged_ref)
    events = pool_events(cfg, dev, 0)

    def pool_row(r) -> dict:
        r = {k: x for k, x in r.items() if k != "host"}
        return {**r, "max_abs_err": 0.0, "bound_by": "bytes",
                "launch_floor_ms": events["floor"]["device_ms"],
                "library_call": "index_fill_, one call a tensor"}

    kern["paged_reset"] = {**pool_row(events["reset"]),
                           "cases": [pool_row(events["reset_draft"])]}
    kern["paged_rollback"] = {
        **pool_row(events["tick"]),
        "cases": [pool_row(events[f"range_{a}_{b}"])
                  for a, b in SINGLE_RANGES]}
    report["pool_events"] = events
    for name in ("paged_attention", "flash_attention"):
        log_attention(name, kern[name])
    log_pool_events(events)
    for sub in ("verify4", "chunk16"):
        log_attention(f"paged_attention {sub}", kern["paged_attention"][sub])
    # the training pair (the lse forward, row 1's training sub-rows, and
    # the backward, row 19) at the training shapes; then the main path that
    # launches them: one fused step of qwen2.5-3b at full width and 2
    # layers through build_model(remat=True, use_flash=True) at JAX's
    # train_4k length, 4 x 4096 over 4 silos (phase 26, --flashtrain, runs
    # the full cells)
    rows3 = flash_train_rows(dev, F)
    report["flash_hmma"] = rows3["hmma"]
    kern["flash_attention"].update(rows3["flash_attention"])
    kern["flash_attention_bwd"] = {**rows3["flash_attention_bwd"].pop(""),
                                   **rows3["flash_attention_bwd"]}
    report["flash_main"] = flash_cell(
        Session, dataclasses.replace(cfg, n_layers=2),
        PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                      dynamic_clip=True, noise_lambda=0.7, n_silos=4),
        OptimizerConfig(name="adamw", lr=1e-3), None, 1,
        {"clip_accumulate": 1, "noise_batch": 1}, "flash-main", "fp32",
        True, 4, 4096, 4)

    # 4. full-width qwen2.5-3b through the user's entry points; from here
    # to the end of phase 5 no plain attention or page-pool call may get a
    # CUDA tensor (phase 3 called them on purpose, to compare)
    spy45: dict = {}
    spying = contextlib.ExitStack()
    spying.enter_context(plain_attention_spy(spy45))
    L, V = cfg.n_layers, cfg.vocab_size
    sess = Session.from_config("qwen2.5-3b", full=True, seed=0)
    t0 = time.perf_counter()
    params = sess.init_params()
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[serve] qwen2.5-3b full width: {n_params / 1e9:.3f} B fp32 params "
        f"on the card in {report['init_s']:.1f} s")

    sess.serve(batch_size=4, prompt_len=32, max_new_tokens=2, params=params)

    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    direct = sess.serve(batch_size=4, prompt_len=32, max_new_tokens=16,
                        params=params)
    n_direct = dispatch.launch_counts()
    direct_peak = torch.cuda.max_memory_allocated()
    check(direct.tokens.shape == (4, 16), "direct tokens shape")
    check(bool(((direct.tokens >= 0) & (direct.tokens < V)).all()),
          "direct tokens out of vocab")
    check(tuple(direct.logits.shape) == (4, V)
          and bool(torch.isfinite(direct.logits).all()), "direct logits")
    check(n_direct["flash_attention"] == L,
          f"direct prefill ran flash {n_direct['flash_attention']}x, not {L}x")
    check(n_direct["paged_attention"] == 0 and n_direct["paged_reset"] == 0,
          "direct mode touched the paged kernels")
    report["direct"] = {
        "prefill_ms": direct.prefill_s * 1e3,
        "decode_ms_per_token": direct.decode_s_per_token * 1e3,
        "decode_tok_per_s": 4 / direct.decode_s_per_token,
        "launches": n_direct, "peak_mem_gb": direct_peak / 1e9}
    log(f"[serve] direct batch 4, prompt 32, 16 new: prefill "
        f"{direct.prefill_s * 1e3:.2f} ms | decode "
        f"{direct.decode_s_per_token * 1e3:.2f} ms/token step | "
        f"{4 / direct.decode_s_per_token:.1f} tok/s | launches {n_direct}")

    reqs = zipf_requests(8, V, min_len=8, max_len=48, max_new_low=8,
                         max_new_high=24, seed=0)
    runs, peaks = {}, {}
    for kind in ("wave", "continuous"):
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        res = sess.serve(scheduler=kind, requests=copy.deepcopy(reqs),
                         params=params, max_batch=B_SLOTS, max_len=MAX_LEN,
                         page_size=PAGE, prefill_chunk=CHUNK)
        runs[kind] = (res, dispatch.launch_counts())
        peaks[kind] = torch.cuda.max_memory_allocated()
    (wave, n_wave), (cont, n_cont) = runs["wave"], runs["continuous"]
    check(wave.stats.drained and cont.stats.drained, "a server did not drain")
    check(bool((cont.tokens == wave.tokens).all()),
          "continuous tokens differ from wave tokens")
    check(n_wave["flash_attention"] == L * wave.stats.waves
          and n_wave["paged_attention"] == 0,
          f"wave launches {n_wave} for {wave.stats.waves} waves")
    admissions = len(reqs) + cont.stats.preemptions
    check(n_cont["paged_reset"] == admissions,
          f"continuous ran reset {n_cont['paged_reset']}x for {admissions} "
          f"admissions")
    check(n_cont["paged_attention"] > 0
          and n_cont["paged_attention"] % L == 0,
          f"continuous ran paged attention {n_cont['paged_attention']}x, not "
          f"a positive multiple of {L}")
    check(n_cont["flash_attention"] == 0, "continuous mode ran flash")
    check(n_cont["paged_rollback"] == 0, "plain continuous mode rolled back")
    # speculative: the self-draft, and a 4-layer early-exit draft over
    # prefix sharing; one launch resets both pools at an admission, one
    # erases every rejected tail of a tick in both
    rolled = {}
    for kind, draft, share in (("speculative self-draft", None, False),
                               ("speculative 4-layer draft", 4, True)):
        with rollback_ticks(PagePool) as ticks:
            torch.cuda.reset_peak_memory_stats()
            dispatch.reset_launches()
            res = sess.serve(scheduler="continuous",
                             requests=copy.deepcopy(reqs), params=params,
                             max_batch=B_SLOTS, max_len=MAX_LEN,
                             page_size=PAGE, prefill_chunk=CHUNK,
                             speculative=True, spec_k=4, draft_layers=draft,
                             prefix_sharing=share)
            n = dispatch.launch_counts()
        runs[kind] = (res, n)
        peaks[kind] = torch.cuda.max_memory_allocated()
        rolled[kind] = ticks[0]
        check(res.stats.drained, f"{kind}: the server did not drain")
        check(bool((res.tokens == cont.tokens).all()),
              f"{kind} tokens differ from continuous tokens")
        check(res.stats.spec_proposed > 0, f"{kind}: no proposals")
        spec_admissions = len(reqs) + res.stats.preemptions
        check(n["paged_reset"] == spec_admissions,
              f"{kind} ran reset {n['paged_reset']}x for {spec_admissions} "
              f"admissions (one launch covers both pools)")
        check(n["paged_rollback"] == rolled[kind],
              f"{kind} ran rollback {n['paged_rollback']}x for "
              f"{rolled[kind]} ticks that rolled back")
        check(n["paged_attention"] > 0 and n["flash_attention"] == 0,
              f"{kind} launches {n}")
    n_spec = runs["speculative 4-layer draft"][1]
    check(n_spec["paged_rollback"] > 0, "the early-exit run never rolled back")
    for kind, (res, n) in runs.items():
        tok_s = 1 / res.decode_s_per_token
        st = res.stats
        report[kind] = {"useful_tokens": st.useful_tokens,
                        "ticks_rolled_back": rolled.get(kind, 0),
                        "tok_per_s": tok_s,
                        "p50_latency_steps": st.p50_latency_steps,
                        "p99_latency_steps": st.p99_latency_steps,
                        "utilization": st.utilization,
                        "decode_steps": st.decode_steps,
                        "launches": n, "peak_mem_gb": peaks[kind] / 1e9}
        spec = ""
        if kind.startswith("speculative"):
            report[kind].update(spec_proposed=st.spec_proposed,
                                spec_accepted=st.spec_accepted,
                                acceptance=st.acceptance_rate)
            spec = (f" | acceptance {st.acceptance_rate:.3f} "
                    f"({st.spec_accepted}/{st.spec_proposed})")
        log(f"[serve] {kind}: 8 requests, 4 slots: {st.useful_tokens} "
            f"tokens at {tok_s:.1f} tok/s | utilization "
            f"{st.utilization:.3f} | p50 {st.p50_latency_steps} p99 "
            f"{st.p99_latency_steps} steps | {st.decode_steps} decode steps"
            f"{spec} | launches {n}")
    log("[serve] continuous == wave and speculative == continuous token for "
        "token")

    # 5. the slice at 2 layers: card (kernels) vs host CPU (plain versions)
    cut = dataclasses.replace(cfg, n_layers=2)
    on = {"cuda": Session.from_config(cut, device="cuda"),
          "cpu": Session.from_config(cut, device="cpu")}
    p_gpu = cut_layers(params, cut, dev, Transformer)
    del params
    torch.cuda.empty_cache()
    p_cpu = cut_layers(p_gpu, cut, "cpu", Transformer)
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, V, (2, 24), generator=g)
    steps = [torch.randint(0, V, (2,), generator=g) for _ in range(3)]
    dispatch.reset_launches()
    got = slice_logits(on["cuda"].model, p_gpu, PagePool, prompt, steps)
    n_slice = dispatch.launch_counts()
    want = slice_logits(on["cpu"].model, p_cpu, PagePool, prompt, steps)
    check(dispatch.launch_counts() == n_slice, "the CPU run launched a kernel")
    check(all(n_slice[k] > 0 for k in ("flash_attention", "paged_attention",
                                       "paged_reset")),
          f"the card's slice run skipped a serving kernel: {n_slice}")
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    scale = max(b.abs().max().item() for b in want)
    check(all(torch.allclose(a, b, atol=CROSS_ATOL, rtol=CROSS_RTOL)
              for a, b in zip(got, want)),
          f"card vs CPU logits differ by {err} (|logit| up to {scale})")
    report["cross_device"] = {"max_abs_err": err, "max_abs_logit": scale,
                              "atol": CROSS_ATOL, "rtol": CROSS_RTOL}
    log(f"[slice] 2-layer full width, card vs CPU: max |logit diff| {err:.3g} "
        f"(|logit| up to {scale:.3g}; atol {CROSS_ATOL}, rtol {CROSS_RTOL})")
    sreqs = zipf_requests(3, V, min_len=8, max_len=24, max_new_low=6,
                          max_new_high=10, seed=2)
    skw = dict(scheduler="continuous", max_batch=2, max_len=64,
               page_size=PAGE, prefill_chunk=CHUNK, speculative=True,
               spec_k=4, draft_layers=1)
    dispatch.reset_launches()
    sg = on["cuda"].serve(requests=copy.deepcopy(sreqs), params=p_gpu, **skw)
    n_sg = dispatch.launch_counts()
    sc = on["cpu"].serve(requests=copy.deepcopy(sreqs), params=p_cpu, **skw)
    check(dispatch.launch_counts() == n_sg, "the CPU speculative run launched "
                                            "a kernel")
    check(n_sg["paged_attention"] > 0
          and n_sg["paged_reset"] == len(sreqs) + sg.stats.preemptions,
          f"the card's speculative slice launches {n_sg}")
    check(bool((sg.tokens == sc.tokens).all()),
          "speculative slice tokens differ between card and CPU")
    spec_stats = [(r.stats.spec_proposed, r.stats.spec_accepted)
                  for r in (sg, sc)]
    check(spec_stats[0] == spec_stats[1],
          f"speculative slice proposed/accepted card vs CPU: {spec_stats}")
    report["spec_cross_device"] = {
        "tokens": int((sg.tokens >= 0).sum()), "proposed": spec_stats[0][0],
        "accepted": spec_stats[0][1], "launches": n_sg}
    log(f"[slice] speculative, 1-layer draft, 3 requests, card vs CPU: "
        f"{report['spec_cross_device']['tokens']} tokens equal | proposed / "
        f"accepted {spec_stats[0]} on both | launches {n_sg}")
    cli = [sys.executable, "-m", "repro_torch.launch.serve", "--scheduler",
           "continuous", "--speculative", "--draft-layers", "1"]
    t0 = time.perf_counter()
    r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env={**os.environ,
                                         "PYTHONPATH": str(ROOT / "src")})
    check(r.returncode == 0 and "device=cuda" in r.stdout
          and "acceptance" in r.stdout,
          f"serving CLI failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    acc = next(x for x in r.stdout.splitlines() if "acceptance" in x)
    report["cli_serve"] = {"cmd": " ".join(cli[1:]),
                           "s": time.perf_counter() - t0, "last": acc}
    log(f"[cli] {' '.join(cli[1:])}: exit 0 in {report['cli_serve']['s']:.1f}"
        f" s | {acc}")

    del p_gpu, p_cpu, on, sess
    torch.cuda.empty_cache()
    spying.close()
    check(spy45["plain_calls_on_card"] == 0,
          f"{spy45['plain_calls_on_card']} plain attention calls on the card "
          f"in phases 4-5")

    # 6. the DP kernels at the training path's shapes
    cut12 = dataclasses.replace(cfg, n_layers=12)
    layout = flatbuf.layout_of(param_tree(Transformer(cut12, "meta")))
    N_SILOS, P = 4, layout.total
    log(f"[dp] qwen2.5-3b at 12 layers: packed P = {P} "
        f"({layout.n_params} parameters, {layout.n_leaves} leaves)")
    gen = torch.Generator(device=dev).manual_seed(6)
    kern["clip_accumulate"], g_sum, stacked = check_clip_accumulate(
        dev, gen, N_SILOS, P, clip_ops, clip_ref)
    # the per-example kernels on the same (4, P) buffer: B = 4 examples, one
    # silo's share of the training cells' batch
    kern["per_example_sumsq"] = check_sumsq(stacked, layout, clip_ops,
                                            clip_ref)
    kern["clip_sum"] = check_clip_sum(dev, stacked, noise_ops, noise_ref,
                                      clip_ref, P)
    del stacked
    torch.cuda.empty_cache()
    sass = library_sass()
    per_stream = live_stream_ops(sass, "noise_batch_kernel")
    log(f"[kernel] noise_batch SASS, instructions per stream element by "
        f"pipe: {json.dumps(per_stream)}")
    kern["noise_batch"] = check_noise_batch(dev, N_SILOS, P, g_sum, noise_ops,
                                            noise_ref, step_keys, prng.PRNGKey,
                                            per_stream)
    live_cm = stream_ops(sass, ROW8_SASS)
    log(f"[kernel] clip_mask SASS, instructions per stream element by pipe "
        f"(a report; the bound uses the pinned counts "
        f"{json.dumps(CLIP_MASK_OPS)}): {json.dumps(live_cm)}")
    kern["clip_mask"] = check_clip_mask(
        dev, P, g_sum, noise_ops, noise_ref, step_keys(prng.PRNGKey(1), 0),
        step_keys(prng.PRNGKey(1), 1).key_xi, CLIP_MASK_OPS)
    kern["clip_mask"]["bound_detail"]["live_sass"] = live_cm
    configs = stream_configs()
    log(f"[kernel] stream kernels' launch configuration: "
        f"{json.dumps(configs)}")
    kern["clip_mask"]["config"] = configs["clip_mask"]
    per_stream_zs = live_stream_ops(sass, "zsmask_kernel")
    log(f"[kernel] zsmask SASS, instructions per stream element by pipe: "
        f"{json.dumps(per_stream_zs)}")
    kern["zsmask"] = check_zsmask(
        dev, layout, g_sum, zs_ops, zs_ref, masking.fold_leaf,
        (masking.R_FOLD, masking.XI_FOLD), step_keys(prng.PRNGKey(1), 0),
        per_stream_zs)
    del g_sum
    torch.cuda.empty_cache()
    for name in ("clip_accumulate", "noise_batch", "clip_mask", "zsmask",
                 "per_example_sumsq", "clip_sum"):
        r = kern[name]
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"[kernel] {name}: max_abs_err {r['max_abs_err']} over all P "
            f"columns | kernel "
            f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms "
            f"({r['plain_at']}) | library {lib} | bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) | {r['at']}")
    for name in ("per_example_sumsq", "clip_sum"):
        r = kern[name]
        log(f"[kernel] {name}: " + json.dumps({k: r[k] for k in r if k in (
            "max_rel_err", "norms_max_rel_err",
            "sum_max_abs_err_at_kernel_norms", "largest_value",
            "two_pass_floor_ms")}))
    for name in ("noise_batch", "clip_mask", "zsmask"):
        log(f"[kernel] {name} bound parts (ms): "
            f"{json.dumps(kern[name]['bound_detail'])}")

    # 7. training at full width, 12 layers, through Session.train
    priv = PrivacyConfig(enabled=True, sigma=0.3, clip_bound=1.0,
                         dynamic_clip=True, noise_lambda=0.7, n_silos=N_SILOS)
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    tsess = Session.from_config(cut12, privacy=priv, optimizer=opt, seed=0)
    t0 = time.perf_counter()
    state = tsess.init_state()
    torch.cuda.synchronize()
    check(state.layout.total == P, f"train layout {state.layout.total} != {P}")
    log(f"[train] qwen2.5-3b full width, 12 layers: {P} packed fp32 "
        f"parameters on the card in {time.perf_counter() - t0:.1f} s")
    STEPS, BATCH, SEQ = 3, 16, 64
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = tsess.train(steps=STEPS, batch_size=BATCH, seq_len=SEQ,
                      state=state, log_every=1)
    n_train = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in res.metrics]
    eps = [m["epsilon"] for m in res.metrics]
    check(res.step == STEPS and len(res.metrics) == STEPS,
          f"trained {res.step} steps, not {STEPS}")
    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    check(all(b > a for a, b in zip([0.0] + eps, eps)),
          f"epsilon does not rise: {eps}")
    check(n_train["clip_accumulate"] == STEPS and n_train["noise_batch"] == STEPS,
          f"training launches {n_train}: each DP kernel once per step")
    check(all(n_train[k] == 0 for k in SERVING_KERNELS),
          f"training ran a serving kernel: {n_train}")
    step_ms = [m["step_time_s"] * 1e3 for m in res.metrics]
    stage_keys = ("silo_grads", "pack", "norms", "aggregate", "noise",
                  "optimizer")
    stages = {k: [st.get(k, 0.0) for st in res.trainer.stage_log]
              for k in stage_keys}
    report["train"] = {
        "config": "qwen2.5-3b, n_layers 12 (d_model 2048, 16/2 heads, "
                  "d_ff 11008, vocab 151936), fp32",
        "P": P, "n_silos": N_SILOS, "batch": BATCH, "seq_len": SEQ,
        "loss": losses, "clip_bound": [m["clip_bound"] for m in res.metrics],
        "epsilon": eps, "step_ms": step_ms,
        "step_ms_after_first": sum(step_ms[1:]) / (STEPS - 1),
        "stage_ms": stages, "peak_mem_gb": peak / 1e9, "launches": n_train}
    log(f"[train] {STEPS} steps, batch {BATCH} x {SEQ}, 4 silos: loss "
        f"{[round(x, 4) for x in losses]} | epsilon {[round(e, 3) for e in eps]}"
        f" | step ms {[round(t, 1) for t in step_ms]} (after the first: "
        f"{report['train']['step_ms_after_first']:.1f}) | peak "
        f"{peak / 1e9:.2f} GB | launches {n_train}")
    log("[train] stage ms per step: " + " | ".join(
        f"{k} {[round(t, 2) for t in v]}" for k, v in stages.items()))
    del res, state, tsess
    torch.cuda.empty_cache()

    # 7b. per-example clipping at full width, 12 layers, both routes
    pe = Session.from_config(cut12, seed=0)
    params = pe.init_params()
    layout7 = flatbuf.layout_of(param_tree(params))
    pe_batch = pe.synthetic_batches(4, SEQ)()
    routes = {}
    for impl in ("packed", "perleaf", "packed", "perleaf"):  # cold, warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        summed, norms, loss = clipping.per_example_clipped_grad(
            pe.model.loss, params, pe_batch, 1.0, impl=impl)
        torch.cuda.synchronize()
        cold = routes.get(impl, {}).get("s")
        routes[impl] = {
            "s": time.perf_counter() - t0, "cold_s": cold,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_above_start_gb":
                (torch.cuda.max_memory_allocated() - start) / 1e9,
            "launches": {k: v for k, v in dispatch.launch_counts().items()
                         if v},
            "loss": float(loss), "norms": norms, "sum": summed}
    n_pe = {"clip_sum": routes["packed"]["launches"].get("clip_sum", 0),
            **{k: routes["perleaf"]["launches"].get(k, 0) for k in (
                "per_example_sumsq_tree", "per_example_sumsq")}}
    check(routes["packed"]["launches"] == {"clip_sum": 1},
          f"packed route launches {routes['packed']['launches']}")
    check(routes["perleaf"]["launches"] == {"per_example_sumsq_tree": 1,
                                            "clip_accumulate": 1},
          f"perleaf route launches {routes['perleaf']['launches']}")
    na, nb = routes["packed"]["norms"], routes["perleaf"]["norms"]
    pe_rel = max_rel(na, nb)
    pe_err = max((a - b).abs().max().item() for a, b in zip(
        flatbuf.flat_tensors(layout7, routes["packed"]["sum"]),
        flatbuf.flat_tensors(layout7, routes["perleaf"]["sum"])))
    pe_top = max(t.abs().max().item() for t in flatbuf.flat_tensors(
        layout7, routes["packed"]["sum"]))
    check(pe_rel <= ROUTES_RTOL and pe_err <= ROUTES_RTOL * pe_top
          and math.isclose(routes["packed"]["loss"], routes["perleaf"]["loss"],
                           rel_tol=ROUTES_RTOL),
          f"per-example routes disagree: norms {pe_rel} relative, sums "
          f"{pe_err} (largest {pe_top})")
    report["per_example"] = {
        "config": report["train"]["config"], "P": layout7.total,
        "examples": 4, "seq_len": SEQ, "clip_bound": 1.0,
        "norms": na.tolist(), "norms_max_rel_err": pe_rel,
        "sum_max_abs_err": pe_err, "sum_largest": pe_top,
        **{impl: {k: r[k] for k in ("s", "cold_s", "peak_mem_gb",
                                    "peak_above_start_gb", "launches",
                                    "loss")}
           for impl, r in routes.items()}}
    log(f"[per-example] qwen2.5-3b full width, 12 layers, 4 examples x {SEQ}"
        f" (second call of each; the first: packed "
        f"{routes['packed']['cold_s'] * 1e3:.1f} ms, perleaf "
        f"{routes['perleaf']['cold_s'] * 1e3:.1f} ms): "
        f"packed {routes['packed']['s'] * 1e3:.1f} ms, peak "
        f"{routes['packed']['peak_mem_gb']:.2f} GB, launches "
        f"{routes['packed']['launches']} | perleaf "
        f"{routes['perleaf']['s'] * 1e3:.1f} ms, peak "
        f"{routes['perleaf']['peak_mem_gb']:.2f} GB, launches "
        f"{routes['perleaf']['launches']} | norms {[round(x, 3) for x in na.tolist()]}"
        f" agree to {pe_rel:.3g} | sums to {pe_err:.3g} (largest {pe_top:.3g})")
    del routes, params, pe, summed, norms, na, nb
    torch.cuda.empty_cache()

    # 8. one training step of a narrow config, card (kernels) vs CPU (plain)
    narrow = reduce_for_smoke(cfg, n_layers=2, d_model=256, n_heads=4,
                              n_kv_heads=2, d_head=64, d_ff=512,
                              vocab_size=4096)
    # the cap raised, so the bound is the percentile protocol's noisy
    # median (sort, linear quantile, threefry normal), not a clamped constant
    priv_c = dataclasses.replace(priv, clip_percentile_max=NARROW_CAP)
    sess_c = {d: Session.from_config(narrow, privacy=priv_c, optimizer=opt,
                                     seed=3, device=d) for d in ("cuda", "cpu")}
    p_cpu = sess_c["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    batch = batch8 = sess_c["cpu"].synthetic_batches(16, 32)()
    out = {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        dispatch.reset_launches()
        out[d] = narrow_step(sess_c[d], p, {k: v.to(d) for k, v in batch.items()},
                             steps_mod, step_keys, prng)
        out[d] += (dispatch.launch_counts(),)
    (n_g, m_g, x_g, s_g, c_g), (n_c, m_c, x_c, s_c, c_c) = out["cuda"], out["cpu"]
    check(c_g["clip_accumulate"] == 2 and c_g["noise_batch"] == 2,
          f"narrow card step launches {c_g}")
    check(all(v == 0 for v in c_c.values()), f"the CPU step launched {c_c}")
    check(x_g["prev_key"] == x_c["prev_key"]
          and s_g.noise_state.prev_key == s_c.noise_state.prev_key,
          "carried noise key differs between card and CPU")
    check(max(m_g["clip_bound"], m_c["clip_bound"]) < NARROW_CAP,
          f"narrow step bound at the cap: card {m_g['clip_bound']}, CPU "
          f"{m_c['clip_bound']}")
    for k in ("loss", "clip_bound", "grad_norm_mean"):
        check(math.isclose(m_g[k], m_c[k], rel_tol=TRAIN_RTOL),
              f"narrow step {k}: card {m_g[k]} vs CPU {m_c[k]}")
    check(torch.allclose(x_g["norms"], x_c["norms"], rtol=TRAIN_RTOL, atol=0),
          f"norms {x_g['norms']} vs {x_c['norms']}")
    noisy_err = (n_g - n_c).abs().max().item()
    check(noisy_err <= NOISY_ATOL, f"noisy gradient differs by {noisy_err}")
    dp = (s_g.opt_state["master"].cpu() - s_c.opt_state["master"]).abs()
    flips = int((dp > PARAM_ATOL).sum())
    check(dp.max().item() <= 2 * opt.lr * 1.001 and flips <= PARAM_FLIPS,
          f"params differ: max {dp.max().item()}, {flips} beyond {PARAM_ATOL}")
    report["train_cross_device"] = {
        "P": s_c.layout.total, "loss": [m_g["loss"], m_c["loss"]],
        "clip_bound": [m_g["clip_bound"], m_c["clip_bound"]],
        "noisy_max_abs_err": noisy_err,
        "noisy_max_abs": n_c.abs().max().item(),
        "param_max_abs_err": dp.max().item(), "param_beyond_atol": flips}
    log(f"[train-slice] narrow config (P {s_c.layout.total}), card vs CPU: "
        f"loss {m_g['loss']:.6f} / {m_c['loss']:.6f} | bound "
        f"{m_g['clip_bound']:.6f} / {m_c['clip_bound']:.6f} | noisy grad max "
        f"|diff| {noisy_err:.3g} (|g| up to {n_c.abs().max().item():.3g}) | "
        f"params max |diff| {dp.max().item():.3g}, {flips} beyond "
        f"{PARAM_ATOL} | prev_key equal")

    # 9. the barrier tier at full width, 12 layers
    mesh4 = MeshConfig((N_SILOS,), ("data",))
    priv_b = dataclasses.replace(priv, sync_path="barrier")
    bsess = Session.from_config(cut12, privacy=priv_b, optimizer=opt,
                                mesh=mesh4, seed=0)
    params = bsess.init_params()
    layout9, _ = pack_params(params)
    batch9 = bsess.synthetic_batches(BATCH, SEQ)()
    keys9 = step_keys(prng.PRNGKey(1), 0)
    ns9 = init_noise(prng.fold_in(prng.PRNGKey(0), 0xD0), N_SILOS)
    c0 = torch.tensor(priv.clip_bound, dtype=torch.float32, device=dev)
    grads_args = (batch9, keys9, ns9, c0, keys9.key_clip, layout9,
                  steps_mod.StageTimer(dev))
    f_agg, f_loss, _, _, f_bound = steps_mod._fused_grads(
        bsess.model, priv, params, grads_args[0], N_SILOS, *grads_args[1:])
    flatbuf.zero_padding(layout9, f_agg)
    torch.cuda.reset_peak_memory_stats()
    b_agg, b_loss, _, _, b_bound = steps_mod._barrier_grads(
        bsess.model, priv_b, mesh4, params, *grads_args)
    peak_grads = torch.cuda.max_memory_allocated()
    flatbuf.zero_padding(layout9, b_agg)
    B9 = priv.mask_scale * priv.sigma * float(b_bound)
    agg_err = chunked_max_diff(b_agg, f_agg)
    agg_tol = MASK_ATOL_PER_B * B9
    check(agg_err <= agg_tol, f"barrier vs fused aggregate differ by "
                              f"{agg_err} (tolerance {agg_tol}, B {B9})")
    check(math.isclose(float(b_loss), float(f_loss), rel_tol=TRAIN_RTOL)
          and math.isclose(float(b_bound), float(f_bound), rel_tol=TRAIN_RTOL),
          f"barrier vs fused loss {float(b_loss)} / {float(f_loss)}, bound "
          f"{float(b_bound)} / {float(f_bound)}")
    agg_max = f_agg.abs().max().item()
    del b_agg, f_agg
    torch.cuda.empty_cache()
    # silo 0's contribution minus its clipped gradient: the mask (and its
    # noise share), std sqrt(2 B^2 + s^2) = B sqrt(2) (1 + 1/1024)
    g0, norm0 = silo_grads_packed(bsess.model, params, batch9, layout9, 0,
                                  N_SILOS, flatbuf, param_tree)
    with torch.no_grad():
        pipe9 = DPPipeline(priv_b, layout9, N_SILOS)
        scale0 = pipe9.clip_scale(norm0, b_bound)
        contrib0 = pipe9.silo_contribution(g0, 0, scale0, None, keys9, ns9,
                                           b_bound)
        std0 = mask_std(contrib0, g0, scale0)
    check(abs(std0 / (B9 * math.sqrt(2)) - 1) < 0.01,
          f"contribution minus clipped gradient has std {std0}, not about "
          f"B*sqrt(2) = {B9 * math.sqrt(2)}")
    report["barrier_vs_fused"] = {
        "aggregate_max_abs_err": agg_err, "tolerance": agg_tol, "B": B9,
        "aggregate_max_abs": agg_max, "loss": [float(b_loss), float(f_loss)],
        "bound": [float(b_bound), float(f_bound)], "mask_std": std0,
        "B_sqrt2": B9 * math.sqrt(2),
        "peak_mem_gb_barrier_grads": peak_grads / 1e9}
    log(f"[barrier] full width, 12 layers, first step: barrier vs fused "
        f"aggregate max |diff| {agg_err:.3g} (|g| up to {agg_max:.3g}; "
        f"tolerance {agg_tol:.3g} from B {B9:.4f}) | loss {float(b_loss):.6f}"
        f" / {float(f_loss):.6f} | bound {float(b_bound):.6f} / "
        f"{float(f_bound):.6f} | silo 0's contribution minus its clipped "
        f"gradient: std {std0:.4f} (B*sqrt(2) = {B9 * math.sqrt(2):.4f}) | "
        f"peak {peak_grads / 1e9:.2f} GB in _barrier_grads")
    del g0, contrib0, params, bsess, pipe9
    torch.cuda.empty_cache()

    tsess = Session.from_config(cut12, privacy=priv_b, optimizer=opt,
                                mesh=mesh4, seed=0)
    state = tsess.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    res = tsess.train(steps=STEPS, batch_size=BATCH, seq_len=SEQ,
                      state=state, log_every=1)
    n_barrier = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in res.metrics]
    eps = [m["epsilon"] for m in res.metrics]
    check(res.step == STEPS and len(res.metrics) == STEPS,
          f"barrier trained {res.step} steps, not {STEPS}")
    check(all(math.isfinite(x) for x in losses), f"loss not finite: {losses}")
    check(all(b > a for a, b in zip([0.0] + eps, eps)),
          f"epsilon does not rise: {eps}")
    check(n_barrier["clip_mask"] == N_SILOS * STEPS
          and n_barrier["clip_accumulate"] == 0
          and n_barrier["noise_batch"] == 0
          and all(n_barrier[k] == 0 for k in SERVING_KERNELS),
          f"barrier launches {n_barrier}: clip_mask {N_SILOS} a step, no "
          f"other kernel")
    step_ms = [m["step_time_s"] * 1e3 for m in res.metrics]
    stage_keys = ("silo_grads", "norms", "pack", "contributions", "reduce",
                  "optimizer")
    stages = {k: [st.get(k, 0.0) for st in res.trainer.stage_log]
              for k in stage_keys}
    report["barrier"] = {
        "config": report["train"]["config"], "mesh": [N_SILOS],
        "P": P, "batch": BATCH, "seq_len": SEQ, "loss": losses,
        "clip_bound": [m["clip_bound"] for m in res.metrics],
        "epsilon": eps, "step_ms": step_ms,
        "step_ms_after_first": sum(step_ms[1:]) / (STEPS - 1),
        "stage_ms": stages, "peak_mem_gb": peak / 1e9,
        "launches": n_barrier}
    log(f"[barrier] {STEPS} steps, batch {BATCH} x {SEQ}, mesh (4,): loss "
        f"{[round(x, 4) for x in losses]} | epsilon "
        f"{[round(e, 3) for e in eps]} | step ms "
        f"{[round(t, 1) for t in step_ms]} (after the first: "
        f"{report['barrier']['step_ms_after_first']:.1f}) | peak "
        f"{peak / 1e9:.2f} GB | launches {n_barrier}")
    log("[barrier] stage ms per step: " + " | ".join(
        f"{k} {[round(t, 2) for t in v]}" for k, v in stages.items()))
    del res, state, tsess
    torch.cuda.empty_cache()

    # 9b. the barrier tier under the per-leaf policy, same width and depth
    n_slices = len(leaf_slices(layout))
    perleaf = dispatch.force_impl("perleaf", kernel="dp_noise_tree")
    with perleaf:
        bsess = Session.from_config(cut12, privacy=priv_b, optimizer=opt,
                                    mesh=mesh4, seed=0)
        params = bsess.init_params()
        layout9, _ = pack_params(params)
        batch9 = bsess.synthetic_batches(BATCH, SEQ)()
        primed = NoiseState(step_keys(prng.PRNGKey(4), 0).key_xi, True,
                            np.ones(N_SILOS, bool))
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        agg, _, _, _, bound9 = steps_mod._barrier_grads(
            bsess.model, priv_b, mesh4, params, batch9, keys9, primed, c0,
            keys9.key_clip, layout9, steps_mod.StageTimer(dev))
        n_one = dispatch.launch_counts()
        v_one = dispatch.variant_counts()["zsmask_buffer"]
        peak_one = torch.cuda.max_memory_allocated()
        agg = flatbuf.zero_padding(layout9, agg.clone())  # frees the rows
        check(n_one["zsmask_buffer"] == N_SILOS
              and sum(n_one.values()) == n_one["zsmask_buffer"]
              and v_one == {"plain": 0, "prev": N_SILOS, "bf16": 0,
                            "bf16_prev": 0},
              f"perleaf barrier step launches {n_one} ({v_one}): "
              f"zsmask_buffer {N_SILOS} (one a silo, lambda-corrected), no "
              f"other kernel")
        clipped = torch.zeros_like(agg)
        for i in range(N_SILOS):
            g, norm = silo_grads_packed(bsess.model, params, batch9, layout9,
                                        i, N_SILOS, flatbuf, param_tree)
            with torch.no_grad():
                clipped.add_(g * clipping.clip_scale(norm, bound9))
            del g
        # the aggregate minus sum_i clip(g_i): sigma_c (xi_t - lam xi_{t-1})
        # if the +-b r terms cancel (else std about 8 sigma_c)
        std9 = mask_std(agg, clipped, 1.0)
        want9 = priv.sigma * float(bound9) * math.sqrt(
            1 + priv.noise_lambda ** 2)
        check(abs(std9 / want9 - 1) < 0.01,
              f"perleaf aggregate minus the clipped sum has std {std9}, not "
              f"sigma_c sqrt(1 + lam^2) = {want9}")
        del agg, clipped, params, bsess
        torch.cuda.empty_cache()
        tsess = Session.from_config(cut12, privacy=priv_b, optimizer=opt,
                                    mesh=mesh4, seed=0)
        state = tsess.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        res = tsess.train(steps=STEPS, batch_size=BATCH, seq_len=SEQ,
                          state=state, log_every=1)
        n_perleaf = dispatch.launch_counts()
        v_perleaf = dispatch.variant_counts()["zsmask_buffer"]
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in res.metrics]
    eps = [m["epsilon"] for m in res.metrics]
    check(res.step == STEPS and all(math.isfinite(x) for x in losses),
          f"perleaf barrier: {res.step} steps, loss {losses}")
    check(all(b > a for a, b in zip([0.0] + eps, eps)),
          f"epsilon does not rise: {eps}")
    check(n_perleaf["zsmask_buffer"] == STEPS * N_SILOS
          and sum(n_perleaf.values()) == n_perleaf["zsmask_buffer"]
          and v_perleaf == {"plain": 0, "prev": STEPS * N_SILOS,
                            "bf16": 0, "bf16_prev": 0},
          f"perleaf barrier launches {n_perleaf} ({v_perleaf}): "
          f"zsmask_buffer {STEPS} x {N_SILOS}, lambda-corrected, no other "
          f"kernel")
    step_ms = [m["step_time_s"] * 1e3 for m in res.metrics]
    stages = {k: [st.get(k, 0.0) for st in res.trainer.stage_log]
              for k in stage_keys}
    report["barrier_perleaf"] = {
        "config": report["train"]["config"], "mesh": [N_SILOS],
        "policy": "perleaf (force_impl dp_noise_tree)", "P": P,
        "leaf_tensors": n_slices, "batch": BATCH, "seq_len": SEQ,
        "loss": losses, "clip_bound": [m["clip_bound"] for m in res.metrics],
        "epsilon": eps, "step_ms": step_ms,
        "step_ms_after_first": sum(step_ms[1:]) / (STEPS - 1),
        "stage_ms": stages, "peak_mem_gb": peak / 1e9,
        "launches": n_perleaf, "one_step_launches": n_one,
        "launches_by_instantiation": v_perleaf,
        "one_step_peak_mem_gb": peak_one / 1e9,
        "noise_std": std9, "noise_std_expected": want9}
    log(f"[barrier-perleaf] one primed step: aggregate minus sum clip(g_i) "
        f"std {std9:.5f} (sigma_c sqrt(1 + lam^2) = {want9:.5f}) | "
        f"{STEPS} steps: loss {[round(x, 4) for x in losses]} | epsilon "
        f"{[round(e, 3) for e in eps]} | step ms "
        f"{[round(t, 1) for t in step_ms]} (after the first: "
        f"{report['barrier_perleaf']['step_ms_after_first']:.1f}) | peak "
        f"{peak / 1e9:.2f} GB | launches {n_perleaf}")
    log("[barrier-perleaf] stage ms per step: " + " | ".join(
        f"{k} {[round(t, 2) for t in v]}" for k, v in stages.items()))
    del res, state, tsess
    torch.cuda.empty_cache()

    # 10. one barrier step of the narrow config, card (kernels) vs CPU
    priv_cb = dataclasses.replace(priv_c, sync_path="barrier")
    sess_b = {d: Session.from_config(narrow, privacy=priv_cb, optimizer=opt,
                                     mesh=mesh4, seed=3, device=d)
              for d in ("cuda", "cpu")}
    p_cpu = sess_b["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    batch = batch10 = sess_b["cpu"].synthetic_batches(16, 32)()
    act10 = np.array([True, False, True, True])  # silo 0's next is 2
    primed = NoiseState(step_keys(prng.PRNGKey(4), 0).key_xi, True,
                        np.array([True, True, False, True]))
    out = {}
    for d, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        dispatch.reset_launches()
        out[d] = barrier_step_parts(
            sess_b[d], p, {k: v.to(d) for k, v in batch.items()}, primed,
            act10, steps_mod, step_keys, prng, flatbuf, param_tree,
            pack_params, DPPipeline)
        out[d]["launches"] = dispatch.launch_counts()
    xg, xc = out["cuda"], out["cpu"]
    # the step launches for its 3 active silos (the dropped one's row is
    # zeroed), the rebuild for all 4
    n10 = int(act10.sum()) + N_SILOS
    check(xg["launches"]["clip_mask"] == n10
          and sum(xg["launches"].values()) == n10,
          f"narrow barrier card launches {xg['launches']}")
    check(all(v == 0 for v in xc["launches"].values()),
          f"the CPU barrier step launched {xc['launches']}")
    check(xg["prev_key"] == xc["prev_key"]
          and np.array_equal(xg["prev_active"], xc["prev_active"]),
          "carried noise state differs between card and CPU")
    check(max(xg["bound"], xc["bound"]) < NARROW_CAP,
          f"narrow barrier bound at the cap: {xg['bound']} / {xc['bound']}")
    for k in ("loss", "bound"):
        check(math.isclose(xg[k], xc[k], rel_tol=TRAIN_RTOL),
              f"narrow barrier {k}: card {xg[k]} vs CPU {xc[k]}")
    check(torch.allclose(xg["norms"], xc["norms"], rtol=TRAIN_RTOL, atol=0),
          f"norms {xg['norms']} vs {xc['norms']}")
    B10 = priv.mask_scale * priv.sigma * xc["bound"]
    tol10 = BARRIER_ATOL_PER_B * B10
    c_err = [(a - b).abs().max().item()
             for a, b in zip(xg["contribs"], xc["contribs"])]
    a_err = (xg["agg"] - xc["agg"]).abs().max().item()
    check(max(c_err) <= tol10 and a_err <= tol10,
          f"narrow barrier contributions differ by {c_err}, aggregate by "
          f"{a_err} (tolerance {tol10})")
    check(not xg["contribs"][1].any() and not xc["contribs"][1].any(),
          "the dropped silo contributed")
    report["barrier_cross_device"] = {
        "P": xc["agg"].shape[0], "active": act10.tolist(),
        "loss": [xg["loss"], xc["loss"]], "bound": [xg["bound"], xc["bound"]],
        "contribution_max_abs_err": c_err, "aggregate_max_abs_err": a_err,
        "tolerance": tol10,
        "contribution_max_abs": max(c.abs().max().item()
                                    for c in xc["contribs"])}
    log(f"[barrier-slice] narrow config (P {xc['agg'].shape[0]}), active "
        f"{act10.astype(int).tolist()}, primed state: loss {xg['loss']:.6f} /"
        f" {xc['loss']:.6f} | bound {xg['bound']:.6f} / {xc['bound']:.6f} | "
        f"contributions max |diff| {[f'{e:.3g}' for e in c_err]} (|c| up to "
        f"{report['barrier_cross_device']['contribution_max_abs']:.3g}) | "
        f"aggregate {a_err:.3g} (tolerance {tol10:.3g}) | prev_key equal")
    del p_gpu, out, xg
    torch.cuda.empty_cache()

    # 10b. the narrow config's per-example clipping (both routes) and one
    # fused and one barrier step under the per-leaf policy, card vs CPU
    sess_p = {d: Session.from_config(narrow, seed=3, device=d)
              for d in ("cuda", "cpu")}
    p_cpu = sess_p["cpu"].init_params()
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    batch = sess_p["cpu"].synthetic_batches(4, 32)()
    narrow_layout = flatbuf.layout_of(param_tree(p_cpu))
    cross = {}
    for impl in ("packed", "perleaf"):
        dispatch.reset_launches()
        a = clipping.per_example_clipped_grad(
            sess_p["cuda"].model.loss, p_gpu,
            {k: v.to(dev) for k, v in batch.items()}, 1.0, impl=impl)
        card_launches = {k: v for k, v in dispatch.launch_counts().items()
                         if v}
        b = clipping.per_example_clipped_grad(
            sess_p["cpu"].model.loss, p_cpu, batch, 1.0, impl=impl)
        sa = flatbuf.pack(narrow_layout, a[0]).cpu()
        sb = flatbuf.pack(narrow_layout, b[0])
        err, top = (sa - sb).abs().max().item(), sb.abs().max().item()
        rel = max_rel(a[1].cpu(), b[1])
        check(rel <= TRAIN_RTOL and err <= TRAIN_RTOL * top
              and math.isclose(float(a[2]), float(b[2]), rel_tol=TRAIN_RTOL),
              f"narrow per-example {impl}: norms {rel}, sums {err} (largest "
              f"{top}), loss {float(a[2])} / {float(b[2])}")
        cross[impl] = {"norms_max_rel_err": rel, "sum_max_abs_err": err,
                       "sum_largest": top, "card_launches": card_launches}
    check(cross["packed"]["card_launches"] == {"clip_sum": 1}
          and cross["perleaf"]["card_launches"] == {
              "per_example_sumsq_tree": 1, "clip_accumulate": 1},
          f"narrow per-example launches {cross}")
    with dispatch.force_impl("perleaf", kernel="dp_noise_tree"):
        out = {}
        for d in ("cuda", "cpu"):
            p = sess_c["cpu"].init_params()
            dispatch.reset_launches()
            out[d] = narrow_step(sess_c[d], p.to(d), {
                k: v.to(d) for k, v in batch8.items()}, steps_mod, step_keys,
                prng) + (dispatch.launch_counts(),)
        (n_g, m_g, x_g, s_g, c_g), (n_c, m_c, x_c, s_c, c_c) = \
            out["cuda"], out["cpu"]
        n_t = 2 * len(leaf_slices(narrow_layout))  # noise: one a tensor
        check({k: v for k, v in c_g.items() if v} == {
            "clip_accumulate": 2, "normal_combine": n_t}
              and not any(c_c.values()),
              f"narrow perleaf fused launches: card {c_g}, CPU {c_c}")
        check(x_g["prev_key"] == x_c["prev_key"]
              and s_g.noise_state.prev_key == s_c.noise_state.prev_key,
              "perleaf fused: carried noise key differs between card and CPU")
        for k in ("loss", "clip_bound", "grad_norm_mean"):
            check(math.isclose(m_g[k], m_c[k], rel_tol=TRAIN_RTOL),
                  f"narrow perleaf fused {k}: card {m_g[k]} vs CPU {m_c[k]}")
        f_err = (n_g - n_c).abs().max().item()
        check(f_err <= NOISY_ATOL,
              f"narrow perleaf fused noisy gradient differs by {f_err}")
        primed_full = NoiseState(step_keys(prng.PRNGKey(4), 0).key_xi, True,
                                 np.ones(N_SILOS, bool))
        out = {}
        for d in ("cuda", "cpu"):
            p = sess_b["cpu"].init_params()
            dispatch.reset_launches()
            out[d] = barrier_step_parts(
                sess_b[d], p.to(d), {k: v.to(d) for k, v in batch10.items()},
                primed_full, None, steps_mod, step_keys, prng, flatbuf,
                param_tree, pack_params, DPPipeline)
            out[d]["launches"] = dispatch.launch_counts()
            out[d]["variants"] = dispatch.variant_counts()["zsmask_buffer"]
    xg, xc = out["cuda"], out["cpu"]
    # the step's contributions and their rebuild: one zsmask_buffer a silo
    # each, lambda-corrected
    check(xg["launches"]["zsmask_buffer"] == 2 * N_SILOS
          and sum(xg["launches"].values()) == xg["launches"]["zsmask_buffer"]
          and xg["variants"] == {"plain": 0, "prev": 2 * N_SILOS,
                                 "bf16": 0, "bf16_prev": 0}
          and not any(xc["launches"].values()),
          f"narrow perleaf barrier launches: card {xg['launches']}, CPU "
          f"{xc['launches']}")
    check(xg["prev_key"] == xc["prev_key"],
          "perleaf barrier: carried noise key differs between card and CPU")
    for k in ("loss", "bound"):
        check(math.isclose(xg[k], xc[k], rel_tol=TRAIN_RTOL),
              f"narrow perleaf barrier {k}: card {xg[k]} vs CPU {xc[k]}")
    tol = BARRIER_ATOL_PER_B * priv.mask_scale * priv.sigma * xc["bound"]
    pc_err = [(a - b).abs().max().item()
              for a, b in zip(xg["contribs"], xc["contribs"])]
    pa_err = (xg["agg"] - xc["agg"]).abs().max().item()
    check(max(pc_err) <= tol and pa_err <= tol,
          f"narrow perleaf barrier contributions differ by {pc_err}, "
          f"aggregate by {pa_err} (tolerance {tol})")
    report["perleaf_cross_device"] = {
        "per_example": cross, "fused_noisy_max_abs_err": f_err,
        "fused_loss": [m_g["loss"], m_c["loss"]],
        "barrier_contribution_max_abs_err": pc_err,
        "barrier_aggregate_max_abs_err": pa_err, "barrier_tolerance": tol,
        "barrier_launches": xg["launches"]["zsmask_buffer"]}
    log(f"[perleaf-slice] narrow config, card vs CPU: per-example norms "
        f"{cross['packed']['norms_max_rel_err']:.3g} / "
        f"{cross['perleaf']['norms_max_rel_err']:.3g} relative (packed / "
        f"perleaf), sums {cross['packed']['sum_max_abs_err']:.3g} / "
        f"{cross['perleaf']['sum_max_abs_err']:.3g} | perleaf fused step: "
        f"noisy grad {f_err:.3g}, loss {m_g['loss']:.6f} / {m_c['loss']:.6f}"
        f" | perleaf barrier step: contributions {max(pc_err):.3g}, "
        f"aggregate {pa_err:.3g} (tolerance {tol:.3g}), "
        f"{xg['launches']['zsmask_buffer']} zsmask_buffer launches | keys "
        f"equal")
    del p_gpu, out, xg, xc, sess_p
    torch.cuda.empty_cache()

    cli = [sys.executable, "-m", "repro_torch.launch.train", "--sync-path",
           "barrier", "--silos", "4", "--steps", "2", "--drop-silos", "1:2"]
    t0 = time.perf_counter()
    r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env={**os.environ,
                                         "PYTHONPATH": str(ROOT / "src")})
    check(r.returncode == 0
          and "done at step 2 on cuda (barrier tier)" in r.stdout,
          f"training CLI failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    done = next(x for x in r.stdout.splitlines() if x.startswith("done"))
    report["cli"] = {"cmd": " ".join(cli[1:]), "s": time.perf_counter() - t0,
                     "last": done}
    log(f"[cli] {' '.join(cli[1:])}: exit 0 in {report['cli']['s']:.1f} s | "
        f"{report['cli']['last']}")
    cli = [sys.executable, "-m", "repro_torch.launch.train", "--sync-path",
           "barrier", "--silos", "4", "--steps", "2"]
    t0 = time.perf_counter()
    r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env={
                           **os.environ, "PYTHONPATH": str(ROOT / "src"),
                           "REPRO_KERNEL_IMPL": "dp_noise_tree=perleaf"})
    check(r.returncode == 0
          and "done at step 2 on cuda (barrier tier)" in r.stdout,
          f"perleaf training CLI failed ({r.returncode}):\n{r.stdout}\n"
          f"{r.stderr}")
    done = next(x for x in r.stdout.splitlines() if x.startswith("done"))
    report["cli_perleaf"] = {
        "cmd": "REPRO_KERNEL_IMPL=dp_noise_tree=perleaf " + " ".join(cli[1:]),
        "s": time.perf_counter() - t0, "last": done}
    log(f"[cli] {report['cli_perleaf']['cmd']}: exit 0 in "
        f"{report['cli_perleaf']['s']:.1f} s | {done}")
    del sess_b, sess_c, p_cpu, batch, batch8, batch10
    torch.cuda.empty_cache()

    # 11. the scans and flash at d_head 112, at the SSM/hybrid paths' shapes
    rcfg, zcfg = get_config("rwkv6-7b"), get_config("zamba2-7b")
    gen = torch.Generator(device=dev).manual_seed(11)
    kern.update(check_scans(dev, 11))
    log_scan_launches(rcfg, zcfg)
    d112 = check_flash(zcfg, dev, gen, 4, 32, flash_ops, flash_ref, F)
    kern["flash_attention"]["d112"] = d112
    log_attention("flash_attention d_head 112", d112)

    # 12-13. rwkv6-7b and zamba2-7b at full width and depth
    ssm_reqs = zipf_requests(8, 32000, min_len=8, max_len=48, max_new_low=8,
                             max_new_high=24, seed=0)
    g_z = zcfg.n_layers // zcfg.attn_every
    report["rwkv6"] = serve_family(
        Session, "rwkv6-7b", {}, {"wkv": rcfg.n_layers}, ssm_reqs, "rwkv6")
    torch.cuda.empty_cache()
    report["zamba2"] = serve_family(
        Session, "zamba2-7b",
        {"ssd": zcfg.n_layers, "flash_attention": g_z},
        {"ssd": zcfg.n_layers, "flash_attention": g_z}, ssm_reqs, "zamba2")
    torch.cuda.empty_cache()

    # 14. narrow configs at the kernels' widths, card vs CPU
    narrow_r = reduce_for_smoke(rcfg, n_layers=2, d_model=256, n_heads=4,
                                n_kv_heads=4, d_head=64, rwkv_head_size=64,
                                d_ff=512, vocab_size=4096)
    narrow_z = reduce_for_smoke(zcfg, n_layers=4, d_model=256, n_heads=2,
                                n_kv_heads=2, d_head=112, d_ff=512,
                                vocab_size=4096, ssm_state=64,
                                mamba_headdim=64, attn_every=2)
    x_reqs = zipf_requests(4, 4096, min_len=8, max_len=24, max_new_low=4,
                           max_new_high=8, seed=3)
    report["ssm_cross_device"] = {
        "rwkv6": family_cross_device(Session, narrow_r, x_reqs, "ssm-slice"),
        "zamba2": family_cross_device(Session, narrow_z, x_reqs,
                                      "ssm-slice")}

    # 15. the serving CLI on the card, wave mode, both families
    for arch in ("rwkv6-7b", "zamba2-7b"):
        cli = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               arch, "--scheduler", "wave"]
        t0 = time.perf_counter()
        r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                           timeout=600, env={**os.environ,
                                             "PYTHONPATH": str(ROOT / "src")})
        check(r.returncode == 0 and "device=cuda" in r.stdout
              and "utilization" in r.stdout,
              f"serving CLI {arch} failed ({r.returncode}):\n{r.stdout}\n"
              f"{r.stderr}")
        util = next(x for x in r.stdout.splitlines() if "utilization" in x)
        report[f"cli_serve_{arch}"] = {"cmd": " ".join(cli[1:]),
                                       "s": time.perf_counter() - t0,
                                       "last": util}
        log(f"[cli] {' '.join(cli[1:])}: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s | {util}")

    # 16. the wire tier on the card
    report["wire"], kern["clip_mask"]["wire"], stream_rows = wire_phase(
        dev, CLIP_MASK_OPS)
    for name in stream_rows:
        stream_rows[name]["config"] = configs[name]
    kern.update(stream_rows)

    # 17. training the ssm and hybrid families
    t17 = time.perf_counter()
    kern.update(check_scan_backward(dev, 17))
    report["ssm_train"] = {}
    for arch, scan in (("rwkv6-7b", "wkv"), ("zamba2-7b", "ssd")):
        cut = dataclasses.replace(get_config(arch),
                                  n_layers=SSM_TRAIN_LAYERS[arch])
        n_scans = N_SILOS * cut.n_layers
        scans = {scan: n_scans, scan + "_bwd": n_scans}
        cell = train_cell(Session, cut, priv, opt, None, STEPS, {
            **scans, "clip_accumulate": 1, "noise_batch": 1}, "ssm-train")
        # the same privacy settings, steps and silos as phase 7: the same
        # ledger, whatever the model
        check(cell["epsilon"] == report["train"]["epsilon"],
              f"{arch} epsilon {cell['epsilon']} is not the ledger's "
              f"{report['train']['epsilon']}")
        barrier = train_cell(Session, cut, priv_b, opt, mesh4, 1, {
            **scans, "clip_mask": N_SILOS}, "ssm-barrier")
        report["ssm_train"][arch] = {"fused": cell, "barrier": barrier}
    narrow_cfgs = {"rwkv6-7b": (narrow_r, "wkv"), "zamba2-7b": (narrow_z,
                                                               "ssd")}
    for arch, (ncfg, scan) in narrow_cfgs.items():
        report["ssm_train"][arch]["cross_device"] = ssm_train_cross_device(
            Session, ncfg, priv_c, priv_cb, opt, mesh4, scan,
            "ssm-train-slice")
    for arch in ("rwkv6-7b", "zamba2-7b"):
        cli = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               arch, "--steps", "1"]
        t0 = time.perf_counter()
        r = subprocess.run(cli, cwd=ROOT, capture_output=True, text=True,
                           timeout=600, env={**os.environ,
                                             "PYTHONPATH": str(ROOT / "src")})
        check(r.returncode == 0
              and "done at step 1 on cuda (fused tier)" in r.stdout,
              f"training CLI {arch} failed ({r.returncode}):\n{r.stdout}\n"
              f"{r.stderr}")
        done = next(x for x in r.stdout.splitlines() if x.startswith("done"))
        report[f"cli_train_{arch}"] = {"cmd": " ".join(cli[1:]),
                                       "s": time.perf_counter() - t0,
                                       "last": done}
        log(f"[cli] {' '.join(cli[1:])}: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s | {done}")
    report["phase17_s"] = time.perf_counter() - t17
    log(f"[ssm-train] phase 17 in {report['phase17_s']:.1f} s")

    # 18. the other dense archs, the admin masks, the scan tier
    spy18: dict = {}
    with plain_draw_spy(spy18):
        report["slice15"], rows18 = slice15_phase(dev)
    for name, subs in rows18.items():
        kern[name].update(subs)

    # 19. ledger wiring and persistence in the Trainer
    report["persist"] = persist_phase(dev)

    # 20. the paper's CIFAR models through the train step, the Trainer and
    # the wire tier
    spy20: dict = {}
    with plain_draw_spy(spy20):
        report["cifar"], rows20 = cifar_phase(dev, sass)
    for name, subs in rows20.items():
        kern[name].update(subs)

    # 21. the per-leaf normal draw: both entries against their plain
    # versions and timed, and their launches on phases 18 and 20's paths,
    # where no plain draw ran on the card
    report["normal"], rows21 = normal_phase(dev, sass)
    kern.update(rows21)
    admin, scan = report["slice15"]["admin"], report["slice15"]["scan"]
    cifar_scan = {m: report["cifar"]["tiers"][m]["scan"]["launches"]
                  for m in ("cifar10-cnn6", "cifar10-wrn28")}
    paths = {"admin_fused_12": admin["fused"]["launches"],
             "admin_barrier_12": admin["barrier"]["launches"],
             "admin_wire": admin["wire"]["launches"],
             f"scan_{scan['n_layers']}": scan["launches"],
             **{f"scan_{m}": n for m, n in cifar_scan.items()},
             "wrn28_noise_stage": report["cifar"]["prng_scan_noise_wrn28"][
                 "launches"],
             "plain_draws_on_card": {"phase 18": spy18["plain_draws_on_card"],
                                     "phase 20": spy20["plain_draws_on_card"]}}
    check(not any(paths["plain_draws_on_card"].values()),
          f"plain draws on the card: {paths['plain_draws_on_card']}")
    report["normal"]["paths"] = paths
    log(f"[normal] launches on the main paths (a step, or a run): "
        f"{json.dumps(paths)}")
    log(f"[normal] phase 21 in {report['normal']['phase_s']:.1f} s")

    # 22. the per-leaf wrappers at one launch a tree: both tree kernels
    # against the per-leaf launches and their plain versions, timed; the
    # per-leaf kernels' launches on the APIs that keep them
    report["tree"], rows22, per_leaf22 = tree_phase(dev, sass)
    kern.update(rows22)
    tiers20 = report["cifar"]["tiers"]
    # each instantiation's launches on the perleaf paths: the main row and
    # "prev0" phase 9b's, the CIFAR sub-rows phase 20's (lambda 0.7 on
    # both, so the uncorrected instantiation runs on neither)
    v9 = report["barrier_perleaf"]["launches_by_instantiation"]
    kern["zsmask_buffer"]["launches_by_instantiation"] = v9
    kern["zsmask_buffer"]["prev0"]["launches"] = v9["plain"]
    for model, short in (("cifar10-cnn6", "cnn6"), ("cifar10-wrn28",
                                                    "wrn28")):
        v20 = tiers20[model]["perleaf"]["launches_by_instantiation"][
            "zsmask_buffer"]
        kern["zsmask_buffer"][short]["launches"] = v20["prev"]
        kern["zsmask_buffer"][f"{short}_prev0"]["launches"] = v20["plain"]
    kern["per_example_sumsq_tree"]["pe16"]["launches"] = \
        report["cifar"]["per_example"]["perleaf"]["launches"][
            "per_example_sumsq_tree"]

    # 23. bf16 serving: the kernels' bf16 instantiations, qwen2.5-3b in
    # every mode, the other families, card vs CPU
    report["bf16"], rows23 = bf16_phase(dev)
    for name, subs in rows23.items():
        kern[name].update(subs)
    q23 = report["bf16"]["qwen"]
    by_variant = {
        "flash_attention": (n_direct, q23["direct"]),
        "paged_attention": (n_cont, q23["continuous"]),
        "paged_reset": (n_cont, q23["continuous"]),
        "paged_rollback": (n_spec, q23["speculative"])}
    for name, (n32, run16) in by_variant.items():
        kern[name]["launches_by_variant"] = {
            "f32": n32[name], "bf16": run16["variants"][name]["bf16"]}
        kern[name]["plain_calls_on_card"] = {
            "phases 4-5": spy45["plain_calls_on_card"],
            "phase 23": report["bf16"]["plain_calls_on_card"]}

    # the record
    launches = {"flash_attention": n_direct["flash_attention"],
                "paged_attention": n_cont["paged_attention"],
                "paged_reset": n_cont["paged_reset"],
                "paged_rollback": n_spec["paged_rollback"],
                "clip_accumulate": n_train["clip_accumulate"],
                "noise_batch": n_train["noise_batch"],
                "clip_mask": n_barrier["clip_mask"],
                "zsmask": n_perleaf["zsmask"],
                "per_example_sumsq": n_pe["per_example_sumsq"],
                "zsmask_buffer": n_perleaf["zsmask_buffer"],
                "per_example_sumsq_tree": n_pe["per_example_sumsq_tree"],
                "clip_sum": n_pe["clip_sum"],
                "wkv": report["rwkv6"]["wave"]["launches"]["wkv"],
                "ssd": report["zamba2"]["direct"]["launches"]["ssd"],
                "wkv_bwd": report["ssm_train"]["rwkv6-7b"]["fused"][
                    "launches"]["wkv_bwd"],
                "ssd_bwd": report["ssm_train"]["zamba2-7b"]["fused"][
                    "launches"]["ssd_bwd"],
                **{k: r["launches"] for k, r in stream_rows.items()},
                "normal": admin["barrier"]["launches"]["normal"],
                "normal_combine": scan["launches"]["normal_combine"],
                "flash_attention_bwd": report["flash_main"]["launches"][
                    "flash_attention_bwd"]}
    check(set(kern) == set(dispatch.KERNELS) == set(launches),
          f"the kernels line covers {sorted(kern)}, the registry "
          f"{sorted(dispatch.KERNELS)}")
    # the per-leaf kernels are on no main path: "launches" is what the
    # perleaf paths they served launched (phase 9b's steps, phase 7b's
    # per-example route: none); the APIs that keep them launch them in
    # phase 22 only, counted apart
    api_launches_on = {
        "zsmask": "pairwise_mask_tree(impl='perleaf') over qwen2.5-3b's "
                  "147 tensors (phase 22, not a main path)",
        "per_example_sumsq": "ops.sumsq a leaf of qwen2.5-3b's (4, P) "
                             "buffer (phase 22, not a main path)"}
    line = []
    for name, r in kern.items():
        k = dispatch.KERNELS[name]
        entry = {"name": name, "route": "cuda", "source": k.source,
                 "replaces": k.replaces, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"], "at": r["at"]}
        if name in api_launches_on:
            entry["api_launches"] = per_leaf22[name]
            entry["api_launches_on"] = api_launches_on[name]
        for extra in ("checked_at", "plain_at", "library_call",
                      "bound_detail", "cases", "device_ms", "max_rel_err",
                      "launch_floor_ms", "checked",
                      "norms_max_rel_err", "tolerance", "tolerance_rel",
                      "two_pass_floor_ms", "library_device_ms", "config",
                      "per_leaf_ms", "per_leaf_device_ms",
                      "library_per_leaf_ms", "route_ms", "route_device_ms",
                      "route_parts_ms", "launches_tree_vs_per_leaf",
                      "launches_by_instantiation", "launches_by_variant",
                      "plain_calls_on_card", "max_abs_err_dq_dk_dv",
                      "two_launches_bit_equal", "split_floor_ms"):
            if extra in r:
                entry[extra] = r[extra]
        for sub in ("verify4", "chunk16", "d112", "s512", "wire", "d80",
                    "d80_verify4", "d80_chunk16", "d96", "d96_verify4",
                    "d96_chunk16", "cnn6", "wrn28", "pe16", "w22",
                    "leaf311m", "prev0", "cnn6_prev0", "wrn28_prev0",
                    "bf16_prev0", *BF16_SUBROWS, *FLASH_TRAIN_SUBROWS):
            if sub in r:
                entry[sub] = {x: r[sub][x] for x in (
                    "max_abs_err", "ms", "device_ms", "plain_ms",
                    "library_ms", "library_device_ms", "bound_ms",
                    "bound_by", "launch_floor_ms", "launches", "at",
                    "per_leaf_ms", "per_leaf_device_ms",
                    "library_per_leaf_ms", "route_ms", "route_device_ms",
                    "route_parts_ms", "launches_tree_vs_per_leaf",
                    "not_bit_equal_share", "max_ulps", "past_one_ulp",
                    "lse_max_abs_err",
                    "model_max_abs_err", "bit_equal_launches",
                    "library_call", "split_floor_ms", "config")
                    if x in r[sub]}
        if "wire" in r:
            entry["wire"]["launches"] = r["wire"]["launches"]
        line.append(entry)
    report["total_s"] = time.perf_counter() - t_start
    log(f"[report] {json.dumps(report)}")
    log(f"[done] {report['total_s']:.1f} s")
    log(card)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    src = Path(args[args.index("--src") + 1]).resolve() \
        if "--src" in args else ROOT / "src"
    for phase in ("scans", "pool", "wire", "bwd", "streams", "slice15",
                  "persist", "cifar", "prng", "normal", "tree", "bf16",
                  "families", "bf16train", "flashtrain", "bf16families",
                  "longctx", "moespec"):
        if f"--{phase}" in args:
            sys.exit(one_phase(phase, src))
    sys.exit(main())
