#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: the card's name and power limit; build every kernel of the
   port from ``src/repro_torch/kernels/csrc`` (one nvcc each, in
   parallel) and report the build time and the compiler's register
   report; check with ``cuobjdump -sass`` that every instantiation of
   the bf16 flash kernel multiplies on the tensor cores (HMMA) and that
   every instance of the phantom products' bf16 kernels
   (``wgmma_fwd_kernel`` and ``wgmma_dgrad_kernel`` at each tile shape
   of ``phantom_fused.py: WG_SHAPES``, ``wgmma_wgrad_kernel``) does
   (HGMMA, the wgmma); TF32 off for matmuls and convolutions.
2. kernels against their plain versions at chatglm3-6b's prefill
   geometry (H=32, KV=2, hd=128; B in {1, 4}; S in {16, 32, 48, 128,
   512}; causal and full; bf16 and fp32) plus one smoke-geometry case
   (hd=16), with peaked scores (std 2: an output is not a near-uniform
   mean of V).  Tolerances: fp32 rtol 2e-3 / atol 2e-4 (the reference's
   kernel tests); bf16 against the float32 plain version on the same
   inputs, each output within 1e-2 of sum_j p_j |v_j|, the size of its
   weighted sum (bf16 P and the rounded output each err by at most 2^-8
   of it).  Per case: max error, the kernel's device
   time (``time_ms``), its bound (the larger of bytes over 3.35 TB/s
   and FLOPs over the peak of the input type: 989 TFLOP/s bf16 tensor,
   67 TFLOP/s fp32 non-tensor), the plain version's time and the time of
   ``torch.nn.functional.scaled_dot_product_attention`` on the same
   inputs as a yardstick (the port never calls it).  Then, at the
   serving geometry in bf16 (B=4, S in {48, 512}, causal), the kernel's
   time with a cold L2 (``_flash_cold``).
3. phantom kernels against their plain versions (``_phantom_case``):
   ``phantom_fused_matmul``, ``matmul_nt`` (dgrad, ``[L;D]`` read through
   two pointers) and ``matmul_tn`` (wgrad, ``[x|g]`` through two) on the
   reference's sweeps (``tests/test_kernels.py``), the paper-ffn-16k
   per-rank shapes (M=64, K=N=2048, PK=128), a pipeline stage's 8-row
   microbatch of it at pipe 2 x dp 2 x tp 2 (M=8, K=N=8192, PK=32) and
   the Table I mini-run's (M=64, K=N=128, PK in {32, 64, 128}); float32
   at 2e-4, bf16 at 2e-2.
   Per case and kernel: max error, device time, bound (bytes over
   3.35 TB/s or operations over 67 TFLOP/s fp32 / 989 TFLOP/s bf16),
   the plain version's time and ``torch.mm`` on operands concatenated
   and transposed outside the timing (the port never calls it).  For
   each kernel also the launch plan and its route (the kernel's CUDA
   name): aligned bf16 takes the tensor cores (``wgmma_*_kernel``: tile
   shape, splits, grid, and beside the forward's and the dgrad's time
   the one-shape plan's on the same operands: every call at 128 x 256
   tiles, its split priced as a whole tile), float32 and unaligned bf16
   the CUDA-core kernels
   (``splitk_kernel``: splits; ``tn_kernel``: persistent grid and rounds
   of tiles; 16-byte or masked copies); the sweep must run every product
   through both CUDA-core variants in float32 and through the wgmma
   kernel and the masked variant in bf16.  A second launch is held
   bitwise equal to the first.  At the main shape all three are also
   timed with a cold L2 (``_phantom_cold``).  Then the gradients of
   ``phantom_fused_linear`` against autograd through the plain version,
   at 2e-3 (fp32) and 6e-2 (bf16).
4. serve: chatglm3-6b at full width, ``SERVE_DEPTH`` of 28 layers, random
   weights from a seeded generator, ``kernel_backend="pallas"``,
   through ``ServeEngine`` (4 slots, max_len 128, page 16): 8
   closed-batch 16-token prompts, then 8 mixed-length prompts (5 to 48
   tokens: buckets 16, 32, 48), ``NEW_TOKENS`` greedy tokens each.
   Checks that every request finishes with them and that the flash kernel was
   launched once per layer of every prefill group.  Then a profiled
   window of decode steps (``_profile_decode``), and, on the same
   weights and the first group, the kernel path against the plain
   blockwise core (rtol/atol 5e-2): layer by layer in bf16 from the same
   inputs, and end to end in float32 activations (``_compare_cores``
   says why the bf16 end-to-end difference is printed, not held).  The
   main path runs under the port's tracer and a fresh metrics registry
   (``obs/``): held, a ``serve/prefill`` span a prefill group and a
   ``serve/decode`` span a decode step, ``serve_prefill_tokens_total``
   the prompts' tokens, ``serve_decode_tokens_total`` the served tokens
   less the exact-length prompts' first tokens, a ``serve_ttft_ms``
   observation a request the SLO reports count and a ``serve_tpot_ms``
   one a request of more than one token (``_serve_obs_held``).
5. train: 8 ranks spawned once on the one card (gloo, card tensors
   through the host: collective times are not NCCL's), each running
   ``_train_rank``: paper-ffn-16k phantom on dp=1, tp=8, batch 64, AdamW
   3e-3 -- step 1 through the kernels, through plain torch and through
   plain torch in float64, from the same shards and batch (loss,
   gradients and updated parameters held to rtol 1e-4 / atol 1e-5,
   gradients also to 1e-4 of their largest against both other runs, the
   parameters of gradients within 10 eps of zero to the tolerance plus
   what their gradients imply: ``_step1_diff``); 20 kernel-path steps
   (losses finite and
   falling, each kernel launched 2 x 20 times on every rank); the same
   20 steps with ``tensor_col``; then the Table I mini-run (n=1024, L=2,
   target 0.175, at most 500 steps) for TP and phantom k = 4
   (``TABLE1_RUNS``),
   whose iteration counts are printed beside the reference's, not held.
   At the phase's end, in the same ranks on new groups, PowerSGD
   (``_compress_rank``): paper-ffn-16k phantom through the kernels at
   dp 2 x tp 4, ``COMPRESS_STEPS`` SGD steps whose gradients cross dp
   through ``optim/compress.py: compressed_dp_psum`` at rank 2 with
   error feedback (each stacked leaf cut into its matrices); losses
   finite and falling, each step's dp all-reduces exactly rank n and
   rank m floats per matrix and a vector's own size; the compressed
   step's time beside the exact dp mean's.
6. energy: in the same 8 ranks, the measured-vs-predicted ledger of the
   paper-ffn-16k step (``telemetry/probe.py: measure_ffn_step``, input
   grads kept): ``tensor_col`` and phantom through the kernels, each
   counted once (flops by ``FlopCounterMode``, the phantom kernels by
   their operators' formulas; wire bytes from the collective log) and
   run ``ENERGY_STEPS`` metered steps, and the phantom step through plain
   torch, counted once.  Held on every rank: wire-byte and message-float
   ratios within 2% of 1.00, flops within the reference's pins (5%
   tensor_col, 25% phantom, measured >= 0.99 predicted), the kernel
   path's flops equal to the plain path's, each kernel launched twice
   per probe step.  Then the Table I iteration counts of phase 5 priced
   by ``repro_torch.benchmarks.table1_energy`` (E_tp, E_pp, saving per
   p).  The energies are the paper's model (Frontier A/B, alpha at the
   H100's float32 peak), not power read from the card.
7. pipeline: in the same 8 ranks, on new groups, paper-ffn-16k cut into
   2 stages of one layer on pipe 2 x dp 2 x tp 2, 1F1B over M = 4
   microbatches of 8 rows (``_pipeline_rank``).  Step 1 of phantom
   through the kernels held to the plain path as in phase 5, and the
   pipelined probe held to the same config's stages run in sequence on
   pipe 1 x dp 4 x tp 2 from the same global weights and batch (loss
   rtol 2e-4; parameter and input gradients rtol 5e-4 / atol 1e-6: the
   reference's oracle, ``tests/helpers.py``); 20 pipelined AdamW steps of
   phantom (each kernel launched M x L_loc = 4 times per step on every
   rank) and ``PIPE_TENSOR_STEPS`` of ``tensor_col`` (losses finite and
   falling; each rank's
   step median printed beside phase 5's, with the host draw's time and
   the ranks' peak host memory); the pipelined probe's ledger
   (``measure_ffn_pipeline_step``) against ``executed=False``: flops
   within the pins of phase 6, layer wire bytes within 2%, each rank's
   boundary bytes equal to its stage's sends, bubble fraction 0.2.  The
   ledger of phases 6 and 7 goes to ``build/chip_smoke_ledger.json``.

8. LM training: phi3-mini (``configs/phi3_mini.py``, full width) through
   the port's trainer (``phase_lm_train``).  (a) The flash kernel at the
   training shape, B=4, S=512, H=KV=32, causal, at hd=96 (phi3-mini) and
   hd=80 (stablelm-3b), bf16 and fp32, against its plain version with
   phase 2's tolerances, timed as there (and hd=96 bf16 with a cold L2).
   (b) Step 1 at full width and 2 layers from one draw cloned: the kernel
   path (``kernel_backend="auto"``) against the plain one (``"xla"``) in
   float32 -- loss, clipped gradients and parameters after one AdamW step
   held as in phase 5 (rtol 1e-4 / atol 1e-5, near-zero gradients with
   what they imply, gradients to 1e-4 of their leaf's largest) -- and the
   bf16 loss of both within ``LM_BF16_LOSS_RTOL``.  (c) The slice:
   ``launch/train.py``'s trainer (``make_trainer``) on phi3-mini at all
   32 layers, batch 4 x seq 512, ``remat="full"``, bf16 compute, fp32
   parameters and AdamW state updated in place, ``LM_STEPS`` steps:
   every loss finite, the flash kernel launched twice per layer per step
   (forward and recompute), the median step time, tokens/s and the peak
   card memory printed; then one more step under ``torch.profiler``
   (device busy share, the flash kernel's share, the top kernels).

9. LM training at tp = 4 (``phase_lm_train_tp``): first, in the parent,
   the flash kernel at phi3-mini's per-rank shape (B=4, S=512, H=KV=8,
   hd=96, bf16, causal) and the three phantom kernels at its gate/up and
   down shapes (M=2048; K=768, N=2048 and K=2048, N=768; PK=48; bf16),
   held and timed as in phases 2 and 3.  Then 4 ranks spawned on the
   card (gloo, card tensors through the host), each running
   ``_lm_tp_rank``: (a) step 1 of phi3-mini with phantom MLP sites at
   full width and ``LM_PARITY_LAYERS`` layers, fp32, through the kernels
   (``"auto"``) against plain torch (``"xla"``) from one draw cloned:
   loss, clipped gradients and parameters held on every rank's shards
   as in phase 5, every kernel launched as the layers imply; (b) the
   same with dense sites (the ``sp`` layout) at tp = 4 against tp = 1
   from the same seed (each rank holds its shards against the same cut
   of the tp = 1 run); (c) the main path: ``launch/train.py``'s trainer
   on phi3-mini at ``LM_TP_LAYERS`` (4) of its 32 layers, phantom, bf16,
   batch 4 x seq 512,
   ``LM_STEPS`` steps with the collectives logged -- every loss finite,
   each rank's launches per step exactly the flash kernel 2 and the
   phantom forward, dgrad and wgrad 6, 3 and 3 a layer; each
   rank's step time, wire bytes per step, peak memory and the card's
   used memory printed; the trainer checkpoints step 1 into
   ``LM_CKPT_DIR`` (each rank its blocks of the global arrays), and after
   the run a fresh trainer restores it (``restore_or_init``) and reruns
   step 2 (``_lm_ckpt_resume``): the bytes over the ranks equal to the
   decls' global parameters and AdamW moments, the resumed loss and
   parameter shards equal to the uninterrupted step 2's (bit for bit,
   else within ``LM_CKPT_REL_TOL``), its launches a main-path step's, the
   write and read seconds printed, the checkpoint removed after; then
   one more step with its collectives timed
   (``record_collectives(timed=True)``), rank 0's under
   ``torch.profiler``.  (c) is a pool job of its own under the port's
   tracer (``_lm_tp_main``): each rank traces on the parent's origin and
   the spans merge under pid = rank (``LM_TRACE``); ``--profile-dir``'s
   energy-drift watchdog predicts ``LM_WATCHDOG_S`` a step, so rank 0's
   first step trips it by construction and every rank captures step 2
   with ``torch.profiler``.  Held (``_lm_tp_obs_held``): each pid's
   ``train/run``, ``train/step``, ``ckpt/save`` and ``ckpt/restore``
   spans, the one trip on rank 0, rank 0's capture listing
   ``flash_mma_kernel`` 8, ``wgmma_fwd_kernel`` 24,
   ``wgmma_dgrad_kernel`` 12 and ``wgmma_wgrad_kernel`` 12 and no
   ``splitk_kernel`` or ``tn_kernel`` (a step's launches: every bf16
   phantom product on the tensor cores), ``train_steps_total`` rank 0's and
   ``ckpt_bytes_total`` over the ranks the checkpoint's bytes; (d)
   phantom (``fp``) and dense (``sp``) at ``LM_TP_COMPARE`` (4 layers,
   2 steps each): step times and wire bytes per rank side by side.

10. qwen2.5-14b at tp = 4 (``phase_qwen_train_tp``): ring attention
   (``attn_shard="ring"``) and phantom MLP sites (k = 16).  First, in the
   parent, the three phantom kernels at its gate/up and down shapes a
   rank (M=2048; K=1280, N=3456 and K=3456, N=1280; PK=64; bf16), held
   and timed as in phase 3, and with a cold L2.  Then 4 ranks on the
   card, each running ``_qwen_rank`` at full width: (a) step 1 at
   ``LM_PARITY_LAYERS`` layers, fp32, phantom, through the kernels
   against plain torch; (c) the phantom ``ring`` variant (ppermute hops)
   against (a)'s plain ``fused`` run; (b) dense sites (``sp``) at tp = 4
   against tp = 1 from the same seed, loss and clipped gradients, one
   rank at a time holding the 2.1 B-parameter tp = 1 model; all held as
   in phase 9, with every kernel's launches (ring attention never runs
   the flash kernel).  (d) The main path: ``launch/train.py``'s trainer at
   ``QWEN_LAYERS`` layers, bf16, batch 4 x seq 512, ``QWEN_STEPS`` steps:
   losses finite, launches per step and rank exactly 6, 3 and 3 per layer
   for the phantom forward, dgrad and wgrad and none of flash, wire bytes
   per step equal to ``ring_wire_bytes``; step times, tokens/s and peak
   memory printed; then one more step with its collectives timed, rank
   0's under ``torch.profiler``.

11. phi3-mini on a pipe axis (``phase_lm_train_pp``): pp 2 x tp 2,
   phantom MLP sites, the 1F1B pipeline over the batch's microbatches.
   First, in the parent, the flash kernel (B=1, S=512, H=KV=16, hd=96)
   and the three phantom kernels at a one-row microbatch's shapes a rank
   (M=512; K=1536, N=4096 and K=4096, N=1536; PK=24), bf16, held and
   timed as in phases 2 and 3, and with a cold L2.  Then 4 ranks on the
   card, each running ``_lm_pp_rank``: (a) step 1 at
   ``LM_PARITY_LAYERS`` layers (one a stage) over ``LM_PP_PARITY_M``
   microbatches, fp32, through the kernels against plain torch, AdamW;
   (a') the same with Adafactor; (b) (a)'s kernel run against pp 1 x tp
   2 from the same seed (each stage's two ranks run the whole model on
   their own group, and each rank holds its stage's cut); all held as
   in phase 9, with every kernel's launches.  (c) The main path:
   ``launch/train.py``'s trainer at ``LM_PP_LAYERS`` (4) of the 32 layers,
   bf16, batch 4 x seq
   512 in ``LM_PP_M`` microbatches, ``LM_PP_STEPS`` steps: losses
   finite, launches per step and rank exactly 2, 6, 3 and 3 per layer
   and microbatch of the stage for flash and the phantom forward, dgrad
   and wgrad, boundary bytes per step equal to the schedule's
   ``executed=False`` account (``lm_pp_boundary_bytes``); step times,
   tokens/s, wire bytes and peak memory printed; then one more step with
   its collectives timed, rank 0's under ``torch.profiler``.

12. the MoE family (``phase_moe``).  First, in the parent, the flash
   kernel at olmoe-1b-7b's serving shape (B=4, S=48, H=KV=16, hd=128)
   and a rank's at tp = 4 training (B=4, S=512, H=KV=4), and the three
   phantom kernels at its q/k/v/o sites a rank at tp = 4 (M=2048,
   K=N=512, PK=32), bf16, held and timed as in phases 2 and 3, and with
   a cold L2.  (a) ``_moe_serve``: olmoe-1b-7b at full width (``SERVE_DEPTH``
   of 16 layers, 64 experts top-8, 6.92 B parameters, random weights from the
   seed) through ``ServeEngine`` with phase 4's traffic; every request's
   ``NEW_TOKENS`` tokens, the flash kernel launched once per layer of every
   prefill group, the routers kept in fp32; a profiled decode window; the first
   group through the kernel path against the plain core, as in phase 4
   (``_compare_cores``: per layer in bf16, each layer's router logits
   held and the tokens whose kept experts differ between the cores
   counted and left out of that layer's hold; end to end in float32);
   the first 8 requests' greedy streams on the plain backend from the
   same weights: in float32 activations all equal to the kernel path's,
   in bf16 as served their first tokens (the rest printed: a rounding
   that swaps an expert at a near tie moves the rest of the stream).
   Then 4 ranks on the card, each running ``_moe_rank``: step 1
   at ``LM_PARITY_LAYERS`` layers, fp32, of olmoe through the kernels
   against plain torch (phantom q/k/v/o sites, the experts behind the
   ``fp`` all-to-alls, the aux loss printed) and at tp = 4 against
   tp = 1 (dense sites, the ``fp`` layout), and of granite-moe-3b-a800m
   (ring attention, tensor-partitioned experts) at tp = 4 against
   tp = 1, held as in phase 9; then the main path: ``launch/train.py``'s
   trainer on olmoe at full width and ``MOE_LAYERS`` layers, bf16,
   batch 4 x seq 512, ``MOE_STEPS`` steps: losses finite, launches per
   step and rank exactly 2, 8, 4 and 4 per layer (flash, the phantom
   forward at 4 sites, forward and recompute; dgrad; wgrad), wire bytes
   per step equal to ``moe_wire_bytes``; step times, tokens/s and peak
   memory printed; then one more step with its collectives timed, rank
   0's under ``torch.profiler``.

13. the SSM family and FSDP (``phase_ssm_fsdp``).  First, in the
   parent, the three phantom kernels at mamba2-370m's in and out sites a
   rank at tp = 4 (M=2048; K=256, N=512 and K=512, N=256; PK=32) and at
   phi3-mini's gate/up and down a rank at dp 2 x tp 2 (M=1024; K=1536,
   N=4096 and the transpose; PK=24), and flash at the latter's shape
   (B=2, S=512, H=KV=16, hd=96), bf16, held and timed as in phases 2 and
   3, and with a cold L2.  (a) ``_mamba_serve``: mamba2-370m at full width
   (``SERVE_DEPTH`` of 48 layers, d 1024) through ``ServeEngine`` with phase
   4's traffic, every prompt its own exact-length group (page size 1); every
   request's ``NEW_TOKENS`` tokens; TTFT, TPOT, a profiled decode window and
   the state cache's bytes; then, in float32 on the closed batch's first
   group, layer by layer from the same input, the prefill's final
   ``{"conv", "ssm"}`` state, its outputs and the last logits held to
   token-by-token decode from a zero state within ``RECURRENCE_TOL`` of
   the largest (``_recurrence_check``; the end-to-end gap is printed).
   No kernel runs there.  Then 4
   ranks on the card, each running ``_ssm_fsdp_rank``: (b) mamba2-370m,
   step 1 at ``LM_PARITY_LAYERS`` layers, fp32, phantom in/out sites
   through the kernels against plain torch, and dense sites at tp = 4
   against tp = 1; the main path at ``MAMBA_LAYERS`` layers, bf16,
   ``MAMBA_STEPS`` steps: every loss finite, launches per step and rank
   exactly 6, 3 and 3 a layer for the phantom forward, dgrad and wgrad
   and no flash, wire bytes per step equal to ``ssm_wire_bytes``; a
   profiled step.  (c) On new groups over the same ranks, dp 2 x tp 2
   (``_fsdp_rank``): phi3-mini's step 1 at ``LM_PARITY_LAYERS`` layers,
   fp32, through the kernels, ``fsdp=True`` against ``fsdp=False`` on
   the same weights (AdamW: loss, gradients, parameters; Adafactor: loss
   and gradients, its moments being per shard); the main path at
   ``FSDP_LAYERS`` layers, bf16, ``FSDP_STEPS`` steps with FSDP and
   without: launches 2, 6, 3 and 3 a layer, wire bytes per step equal to
   ``fsdp_wire_bytes``, each rank's parameter and optimizer bytes and
   peak; mamba2's step 1 with and without FSDP.  Every step-1 check: 0
   elements outside rtol 1e-4 / atol 1e-5.

14. the hybrid family (``phase_hybrid``).  First, in the parent, the
   flash kernel at jamba-1.5-large's serving shape (B=4, S=48, H=64,
   KV=8, hd=128) and a rank's at tp = 4 (B=4, S=512, H=16, KV=2), and the
   three phantom kernels at its gate/up and down sites a rank at tp = 4
   (M=2048; K=2048, N=6144 and K=6144, N=2048; PK=128), bf16, held and
   timed as in phases 2 and 3, and with a cold L2.  (a) ``_jamba_serve``:
   jamba at full width and ``JAMBA_SERVE_LAYERS`` layers (its three
   block kinds), bf16 parameters, through ``ServeEngine`` with phase 4's
   traffic, every prompt its own exact-length group; every request's
   ``NEW_TOKENS`` tokens, flash once per prefill group; then the recurrence
   check of phase 13 over the attention and SSD layers.  Then 4 ranks on the
   card, each running ``_hybrid_rank``: (b) step 1 at ``JAMBA_LAYERS`` layers
   in float32 with ``JAMBA_PARITY_EXPERTS`` experts, Adafactor, kernels
   against plain torch, held as in phase 9; (c) the main path:
   ``launch/train.py``'s trainer at full width, ``JAMBA_LAYERS`` layers,
   bf16 parameters, Adafactor, ``fsdp=True`` at dp 1, ``JAMBA_STEPS``
   steps: losses finite, launches per step and rank 2, 6, 3 and 3 (flash;
   the phantom forward, dgrad and wgrad at the MLP layer's three sites),
   wire bytes per step equal to ``hybrid_wire_bytes``; step times,
   tokens/s, peak memory against the reckoning
   (``jamba_reckoned_bytes``); one more step with its collectives timed,
   rank 0's under ``torch.profiler``.

15. the vision-language family (``phase_vlm``).  First, in the parent,
   the flash kernel at qwen2-vl-72b's serving shape (B=4, S=48, H=64,
   KV=8, hd=128) and a rank's at tp = 4 (B=4, S=512, H=16, KV=2), and the
   three phantom kernels at its gate/up and down sites a rank at tp = 4
   (M=2048; K=2048, N=7392 and K=7392, N=2048; PK=128: the first N and
   contraction that the 64-wide tiles do not divide), bf16, held and
   timed as in phases 2 and 3, and with a cold L2.  (a) ``_vlm_serve``:
   qwen2-vl at full width and ``QWEN2VL_SERVE_LAYERS`` layers, bf16
   parameters, through ``ServeEngine`` with phase 4's traffic in
   mixed-length buckets (the vision stub's zero embeddings spliced over
   each group's first positions, M-RoPE positions on three equal rows):
   every request's ``NEW_TOKENS`` tokens, flash once per layer of every prefill
   group, TTFT, TPOT, a profiled decode window, the weights' and the
   cache's bytes; then the recurrence check of phase 13 at
   ``QWEN2VL_PARITY_LAYERS`` of the layers cast to float32.  Then 4 ranks
   on the card, each running ``_family_rank`` on ``StubbedLM`` batches
   (random vision embeddings, M-RoPE positions): (b) step 1 at
   ``QWEN2VL_PARITY_LAYERS`` layers in float32, Adafactor, kernels against
   plain torch, held as in phase 9; (c) the main path:
   ``launch/train.py``'s trainer (``make_trainer`` with the stubbed
   dataset: the launcher itself raises for this family) at full width,
   ``QWEN2VL_LAYERS`` layers, bf16 parameters, Adafactor, ``fsdp=True`` at
   dp 1, ``LM_STEPS`` steps: losses finite, launches per step and rank 2,
   6, 3 and 3 a layer, wire bytes per step equal to ``fsdp_wire_bytes``;
   step times, tokens/s, peak memory; one more step with its collectives
   timed, rank 0's under ``torch.profiler``.

16. the encoder-decoder family (``phase_encdec``).  First, in the parent,
   the flash kernel at seamless-m4t-large-v2's serving shape (B=4, S=48,
   H=KV=16, hd=64) and a rank's at tp = 4 (B=4, S=512, H=KV=4), each in
   full mode (its encoder, against SDPA with ``is_causal=False``) and
   causal (its decoder), and the three phantom kernels at its up and
   down sites a rank at tp = 4 (M=2048; K=256, N=2048 and the transpose;
   PK=32), bf16, held and timed as in phases 2 and 3, and with a cold L2.
   (a) ``_encdec_serve``: seamless at full width (``SERVE_DEPTH`` of 24 + 24
   layers), bf16, through ``ServeEngine`` with phase 4's traffic, every prompt
   its own exact-length group: every request's ``NEW_TOKENS`` tokens, flash
   once per encoder and decoder layer of every prefill group; TTFT, TPOT, a
   profiled decode window, the self and cross caches' bytes; then, with random
   frames in float32 activations, one group's prefill logits and cross
   K/V through the kernels against the plain path, and the recurrence
   check at ``SEAMLESS_PARITY_LAYERS`` + as many layers.  Then 4 ranks
   on the card (``_family_rank``, random frames): (b) step 1 at
   ``SEAMLESS_PARITY_LAYERS`` + as many layers, float32, AdamW, kernels
   against plain; (c) the main path at ``SEAMLESS_LAYERS`` + as many
   layers, fp32 parameters, AdamW, ``LM_STEPS`` steps: launches per step
   and rank 2 flash a self-attention layer (encoder and decoder: the
   cross-attention runs the plain core), 4, 2 and 2 phantom a layer,
   wire bytes per step equal to ``encdec_wire_bytes``; as in 15.

17. serving on a mesh (``phase_serve_mesh``).  First, in the parent,
   the flash kernel at a rank's prefill at tp 4 (B = 2 and 4, S = 48, 8
   query heads on one KV head, hd 128) and the phantom forward at
   chatglm3-6b's gate/up and down a rank at tp 4 (M = 4 decode rows and
   M = 192 prefill rows; K = 1024, N = 3424 and the transpose; PK = 64),
   bf16, held and timed as in phases 2 and 3, and with a cold L2; then
   ``serve/router.py: route`` over ``SERVE_MESH_BUDGET`` devices at
   ``SERVE_MESH_SLO_MS``, its priced table printed.  Then, for (a)
   tensor sites on dp 2 x tp 4 (8 ranks) and (b) phantom gate/up/down
   (k = 16) on dp 1 x tp 4, ranks sharing the card each running
   ``_serve_mesh_rank``: the parity (the trace's first
   ``SERVE_MESH_PARITY_REQUESTS`` requests, ``PARITY_TOKENS`` tokens at
   most, at ``SERVE_MESH_PARITY_LAYERS`` layers: float32 greedy streams
   equal to the tp = 1 engine's on the same global weights, a phantom
   model's as its dense twin); the main path,
   ``run_config`` on chatglm3-6b at full width and ``SERVE_MESH_LAYERS``
   layers, bf16, replaying ``SERVE_MESH_TRACE``: every request's tokens,
   launches exactly the layers per prefill (flash) and 3 x the layers
   per prefill and decode step (the phantom forward), each rank's wire
   bytes of the probe prefill and decode step equal to
   ``serve_wire_bytes``; TTFT/TPOT p50/p95, tokens/s, memory per rank,
   J/token and measured/predicted energy and wire per phase, the ranks'
   agreement; the per-layer bf16 check of the kernel path against the
   plain path (``_mesh_layer_check``); one decode step with its
   collectives timed, rank 0's under ``torch.profiler``.
18. every other family served on a mesh (``phase_family_mesh``).
   First, in the parent, flash at a rank's prefill heads of each family
   at tp 4 and the phantom forward at each family's phantom sites a rank
   (a decode step's 4 rows and a 48-token group's 192), bf16, held and
   timed as in phases 2 and 3, and with a cold L2.  Then one spawn of 4
   ranks sharing the card (dp 1 x tp 4) serves, in turn, olmoe-1b-7b,
   mamba2-370m, jamba-1.5-large-398b (3 layers: its three block kinds),
   qwen2.5-14b (ring attention), qwen2-vl-72b and seamless-m4t-large-v2
   (2 + 2 layers), each at full width and 2 layers with its own
   projection map (``_family_mesh_rank``): the parity (float32 greedy
   streams of the trace's first ``FAMILY_MESH_PARITY_REQUESTS`` requests,
   ``PARITY_TOKENS`` tokens at most,
   arriving together, equal to the tp = 1 engine's on the same global
   weights, a phantom model's as its dense twin; jamba, whose float32
   experts would not fit beside a twin, per layer in bf16 against the
   plain path, within ``LOGIT_TOL`` of the layer's largest); the main
   path, ``run_config`` in bf16 on ``FAMILY_MESH_TRACE`` (4 requests,
   page 4, the recurrent families' prompts rounded up to a multiple of
   it) with frontend stubs drawn from each prompt: every request's
   tokens, launches exactly as the layers imply (``_family_mesh_launches``),
   each rank's wire bytes of the probe prefill and decode step equal to
   ``serve_wire_bytes``; TTFT/TPOT p50/p95, tokens/s, memory per rank;
   one decode step with its collectives timed, rank 0's under
   ``torch.profiler``.
19. the disaggregated fleet (``phase_fleet``, ``serve/fleet``), executed:
   prefill and decode pools of one replica each, every request's KV
   pages migrated from the prefill pool's group into a decode engine
   (``ServeEngine.adopt``), the modeled clock driving the schedule.
   (a) one process on the card: chatglm3-6b at full width,
   ``SERVE_DEPTH`` layers, bf16, tensor sites at tp 1 on
   ``FLEET_TRACE`` (8 poisson requests, prompts 4-48, 4-8 new tokens):
   every request's tokens, flash exactly once a layer of every prefill
   group and never in a decode step, the migrated bytes equal to the
   count from the decls (``cache_decls`` at each request's padded
   length) to the byte and measured/predicted wire in
   ``FLEET_WIRE_BAND``; the engines' measured prefill and decode step
   times (``StepMeter``) printed beside the modeled alpha + beta.  (b)
   ``FLEET_TP`` ranks sharing the card, full width, ``FLEET_MESH_LAYERS``
   layers, both pools the router's phantom candidate (gate/up/down,
   k = 16) at dp 1 x tp 4 on the same trace: as (a) on every rank, and
   the phantom forward once a phantom site of every prefill group and
   decode step.  Before each, the parity in float32 at
   ``FLEET_PARITY_LAYERS`` layers on the trace's first
   ``FLEET_PARITY_REQUESTS`` requests: the fleet's greedy streams equal a
   plain engine replay's on the same weights, and for (b) the tp = 1
   engine's on the dense twin.
20. elastic (``phase_elastic``): ``train/elastic.py: run_elastic`` at
   paper-ffn-4k's width (``ELASTIC``: n 4096, L 2, batch 64, 8 devices
   on 4 hosts, tensor_col first, ks (4, 8, 16), checkpoints every 10
   steps, 24 steps, AdamW 5e-4, the audit gate off), host3 lost at step
   12: each phase a world of gloo ranks sharing the card, the plain
   torch core (the plans' ``kernel_backend="xla"``).  Held: the plans
   and the recovery's detect, restored and replayed steps,
   ``distilled`` and ``from_scratch`` against the CPU planner's
   prediction (``ELASTIC_PLANS``, ``ELASTIC_RECOVERY``), each phase's
   checkpoint bytes against its saves times the plan's global
   parameters and AdamW moments, the account's identity (total = useful
   + replay + IO + restart, to ``ACCOUNT_TOL``), each phase's losses
   finite and falling; ``compile_s``, ``restore_s`` and ``replan_s``
   printed.  Traced, with the energy-drift watchdog (spike at 8x) and
   one slow step before the loss (``ELASTIC_SLOW_STEP``, 24x the
   self-baseline): held, exactly one trip, a spike at that step, its
   anomaly row and rank 0's capture of the next step, and ``python -m
   repro_torch.launch.obs verify-recovery`` on the run's trace and
   report (``_elastic_obs_held``).
21. plan (``phase_plan``): ``launch/plan.py: plan`` on the card at the
   CLI's defaults (devices 8, width 1024, depth 2, batch 64, ks 4,8,16,
   tensor_col and phantom, pilot tp 4, the paper's calibration) but
   ``PLAN_PILOT_STEPS`` pilot steps and ``PLAN_TARGET``, the report under
   ``build/``; the pilots (the plain torch core) run on the pool's 4
   ranks.  Held: the schema, every pilot its budget with finite, falling
   losses, a phantom curve, matched plans, a frontier and a winner;
   printed: each pilot's nu, final loss and median step ms, the curve,
   the comparison, the winner.  Then the winner's measured peak
   (``hbm_readings``, of which ``measured_hbm_bytes`` is the largest
   rank's peak: one train step on its ranks), held above 0 and below
   80 GB, printed beside its estimate with each rank's breakdown.  Then
   the winner applied to phi3-mini through ``launch/train.py:
   train_config`` (``--plan``, then ``--kernel-backend auto``) at phase
   9's cut on the winner's mesh: held, the applied mesh and projection
   map, the four kernels at that path's per-rank shapes in bf16 against
   their plain versions (timed, cold L2 too), step 1 kernels against
   plain at ``LM_PARITY_LAYERS`` layers in float32 (phase 9's
   tolerances), each kernel's launches as the layers imply (flash twice
   a layer, each phantom site's forward twice, its dgrad and wgrad once:
   the phantom default covers q/k/v/o and the MLP), the losses finite.
   The plan runs under ``launch/obs.py: obs_session`` with
   ``--trace-out`` / ``--metrics-out``: held, pid 0's ``plan/calibrate``,
   ``plan/enumerate`` and ``plan/pilots`` spans and a ``plan/pilot`` span
   a pilot on every rank's pid, ``plan_pilot_steps_total`` the pilots'
   steps (``_plan_obs_held``).

Phases 9-16 and 18-21, and 17's mesh of 4, run in one pool of 4 ranks
(``launch/mesh.py: RankPool``), started once, each phase's card memory
freed before the next (phase 20's worlds and phase 21's winner's mesh
are ranks of their own beside it).  Each phase's wall seconds are printed on a line
of their own.

The line before the last is the kernel table as JSON (the phantom
kernels' 8-row shape and its launches under ``pipe_rows8``; the flash
kernel's training launches and its hd=96 training shape under
``train_launches`` and ``hd96``; every kernel's tp = 4 shapes and its
launches per step and rank under ``lm_tp4``, qwen2.5-14b's under
``qwen_tp4``, the pp 2 x tp 2 microbatch's under ``lm_pp``, and
olmoe-1b-7b's tp = 4 training under ``moe_tp4``, with flash's serving
shape and launches under ``moe_serve``, mamba2-370m's tp = 4 training
under ``ssm_tp4``, phi3-mini's under FSDP under ``fsdp_dp2_tp2``, and
jamba-1.5-large's serving shape and launches under ``jamba_serve`` and
its tp = 4 training under ``jamba_tp4``, qwen2-vl-72b's under
``qwen2vl_serve`` and ``qwen2vl_tp4``, and seamless-m4t-large-v2's, full
and causal, under ``seamless_serve`` and ``seamless_tp4``; flash's and
the phantom forward's shapes and launches on the serving mesh under
``serve_mesh``, and on the other families' under ``family_mesh``; the
fleet's launches under ``fleet``, its shapes being rows 1, 1k and 2k's;
the resumed step 2's launches of phase 9 under ``lm_tp4``; the applied
plan's launches under ``plan``); the last
line is
``{"ok": true, "device": {...}}``.  Everything measured is also written
to ``build/chip_smoke.json``.
"""
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12
# NEW_TOKENS: the greedy tokens a request of the tp = 1 serve paths (16
# until phase 18 needed the script's time)
SLOTS, MAX_LEN, PAGE, NEW_TOKENS = 4, 128, 16, 8
# the tp = 1 serve paths' depth, each at full width (until phase 18
# needed the script's time: chatglm3-6b 28, olmoe 16, mamba2 48 and
# seamless 24 + 24 layers, their full depth; qwen2-vl's is
# QWEN2VL_SERVE_LAYERS, 8 until then)
SERVE_DEPTH = {"chatglm3-6b": 8, "olmoe-1b-7b": 4, "mamba2-370m": 8,
               "seamless-m4t-large-v2": 4}
MIXED_LENS = (5, 12, 16, 17, 29, 32, 40, 48)
SWEEP_B, SWEEP_S = (1, 4), (16, 32, 48, 128, 512)
MAIN_SHAPE = dict(B=SLOTS, S=48, H=32, KV=2, hd=128, causal=True,
                  dtype="bfloat16")
LOGIT_TOL = 5e-2
# (M, K, N, PK): the reference's sweeps (tests/test_kernels.py:13-19,
# 108-114; its backward check at :165-173 as a dgrad and a wgrad case),
# the paper-ffn-16k per-rank shapes at p=8 and batch 64, and the Table I
# mini-run's (n=1024, p=8)
PHANTOM_SHAPES = (
    [(128, 128, 128, 64), (256, 128, 128, 128), (128, 256, 384, 32),
     (512, 128, 256, 256), (128, 512, 128, 16),
     (192, 128, 128, 64), (192, 192, 192, 48), (100, 72, 56, 24),
     (130, 257, 129, 65), (128, 128, 300, 64),
     (96, 40, 160, 32), (96, 128, 112, 32)]
    + [(64, 128, 128, pk) for pk in (32, 64, 128)])
PHANTOM_MAIN = (64, 2048, 2048, 128)
# a pipeline stage's microbatch of paper-ffn-16k at pipe 2 x dp 2 x tp 2
# and M = 4: 64 / (2 x 4) rows, n / tp = 8192, k x tp = 32
PHANTOM_PIPE = (8, 8192, 8192, 32)
PHANTOM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 2e-3, "bfloat16": 6e-2}
GRAD_SHAPES = [(128, 128, 128, 16, 4), (192, 96, 80, 8, 2),
               (64, 64, 64, 4, 8)]
TRAIN_ARCH, TRAIN_DP, TRAIN_TP, TRAIN_STEPS = "paper-ffn-16k", 1, 8, 20
STEP1_TOL = dict(rtol=1e-4, atol=1e-5)
ADAM_NEAR_ZERO = 1e-7     # 10 x AdamW eps: see _step1_diff
STEP1_CHUNK = 1 << 23     # elements of a leaf compared at once
TABLE1 = dict(n=1024, L=2, target=0.175, max_steps=500)
# the mini-run's configs: TP and phantom k = 4, which Table I's pricing
# needs (k = 8 and 16 too until phase 18 needed the script's time)
TABLE1_RUNS = (("tensor", 4), ("phantom", 4))
TABLE1_REFERENCE = {"tensor": 168, 4: 154, 8: 154, 16: 180}
# metered probe steps of phases 6 and 7 (5 until phase 18 needed the
# script's time, 3 until phase 19 did)
ENERGY_STEPS = 2
# phase 5's PowerSGD run (``_compress_rank``): the paper FFN on dp x tp of
# the same 8 ranks, its gradients over dp at this rank, SGD.  The
# reference's test trains n = 64 at lr 0.3; at n = 16384 that step
# diverges within 10 steps (the update of a unit's output grows with the
# width), and 0.03 falls steadily
COMPRESS_DP, COMPRESS_TP, COMPRESS_RANK = 2, 4, 2
# (10 and 3 steps: 20 and 5 until phase 18 needed the script's time)
COMPRESS_STEPS, COMPRESS_PLAIN_STEPS, COMPRESS_LR = 10, 3, 0.03
PIPE_PP, PIPE_DP, PIPE_TP, PIPE_M = 2, 2, 2, 4
# the pipelined tensor_col baseline's steps (TRAIN_STEPS until phase 19
# needed the script's time; its loss falls below step 1's by step 4, where
# the pipelined phantom path's 20 steps cannot be cut: at 8 its
# loss-falls check broke)
PIPE_TENSOR_STEPS = 8
# the reference's pipeline oracle (tests/helpers.py:77-104)
EQUIV_LOSS_RTOL, EQUIV_TOL = 2e-4, dict(rtol=5e-4, atol=1e-6)
# measured/predicted flops pins of the reference (tests/test_telemetry.py)
FLOPS_PIN = {"tensor_col": 0.05, "phantom": 0.25}
PEAK = {"float32": 67e12, "bfloat16": 989e12}
# 2 steps (6, then 4, then 2 as phases were added; step 1 of every path
# is held to the plain path apart): the script's later phases need its
# time (the limit is 1200 s)
LM_ARCH, LM_BATCH, LM_SEQ, LM_STEPS = "phi3-mini-3.8b", 4, 512, 2
LM_PARITY_LAYERS = 2
# the bf16 step-1 loss of the kernel path against the plain path: both
# run bf16 projections; the kernel rounds P and its output to bf16 where
# the plain core keeps float32 (phase 2's 1e-2 of sum p|v| per output)
LM_BF16_LOSS_RTOL = 5e-3
# (B, S, H, KV, hd) of the training shape: phi3-mini (hd 96) and
# stablelm-3b (hd 80), causal
LM_FLASH_SHAPES = ((4, 512, 32, 32, 96), (4, 512, 32, 32, 80))
# phase 9: phi3-mini on LM_TP ranks; (d) runs LM_TP_COMPARE = (layers,
# steps) of phantom and of dense (3 steps until phase 19 needed the
# script's time)
LM_TP, LM_TP_COMPARE = 4, (4, 2)
# (c)'s depth: 4 of phi3-mini's 32 layers, and (d)'s, so that phase 17
# fits the script's time
LM_TP_LAYERS = 4
# the per-rank shapes of phi3-mini at tp = 4, batch 4 x seq 512: the
# phantom kernels' (M, K, N, PK) at gate/up and at down (k = 12, PK = 48),
# and flash's (B, S, H, KV, hd) at H / tp local heads
LM_CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"   # phase 9's checkpoint
LM_CKPT_REL_TOL = 1e-6       # the resumed step 2, where not bit for bit
# phase 9's watchdog: a prediction of 1 ms a step, far below any step of
# the main path (seconds), trips it at step 1 by construction; every rank
# captures step 2 under LM_PROFILE_DIR, and the trace goes to LM_TRACE
LM_WATCHDOG_S = 1e-3
LM_PROFILE_DIR = ROOT / "build" / "chip_smoke_profile"
LM_TRACE = ROOT / "build" / "chip_smoke_lm_tp_trace.json"
LM_TP_PHANTOM_SHAPES = ((2048, 768, 2048, 48), (2048, 2048, 768, 48))
LM_TP_FLASH_SHAPE = (4, 512, 8, 8, 96)
# phase 10: qwen2.5-14b on LM_TP ranks at full width and QWEN_LAYERS of its
# 48 layers (4 ranks' fp32 AdamW state at 48 layers, 116 GB, exceed the
# card; 2 rather than 4 or 8 leaves the later phases the script's
# time), QWEN_STEPS steps (2; 3 until phase 18 needed the time); the
# phantom kernels' (M, K, N, PK) a rank at gate/up and at down (k = 16,
# PK = 64)
QWEN_ARCH, QWEN_LAYERS, QWEN_STEPS = "qwen2.5-14b", 2, 2
QWEN_PHANTOM_SHAPES = ((2048, 1280, 3456, 64), (2048, 3456, 1280, 64))
# phase 11: phi3-mini on LM_PP stages x LM_PP_TP model ranks, the batch in
# LM_PP_M microbatches of one row, LM_PP_STEPS steps; (a) and (b) at
# LM_PARITY_LAYERS layers (one a stage) in LM_PP_PARITY_M microbatches.
# The per-rank shapes of a microbatch (1 x 512 tokens): the phantom
# kernels' (M, K, N, PK) at gate/up and at down (k = 12, PK = 24), and
# flash's (B, S, H, KV, hd) at H / tp local heads
LM_PP, LM_PP_TP, LM_PP_M, LM_PP_STEPS, LM_PP_PARITY_M = 2, 2, 4, 2, 2
LM_PP_LAYERS = 4     # (c)'s depth, 2 a stage, for phase 17's time
# (LM_PP_STEPS 2: 3 until phase 18 needed the time)
LM_PP_PHANTOM_SHAPES = ((512, 1536, 4096, 24), (512, 4096, 1536, 24))
LM_PP_FLASH_SHAPE = (1, 512, 16, 16, 96)
# phase 12: the MoE family.  olmoe-1b-7b served at full width (tp 1), and
# trained at full width and MOE_LAYERS of its 16 layers on LM_TP ranks
# (16 layers' fp32 AdamW state, 111 GB, exceed the card), MOE_STEPS
# steps; granite-moe-3b-a800m's tensor partition at LM_PARITY_LAYERS
# layers.  The kernels' shapes: flash's (B, S, H, KV, hd) at serving
# (SLOTS x the longest mixed prompt, 16 heads of 128) and a rank's at tp 4
# (16 / 4 heads); the phantom kernels' (M, K, N, PK) at the q/k/v/o sites
# a rank at tp 4 (d / tp = 512, k = 8, PK = 32)
# (2 layers, cut for phase 17's time; 2 steps, 3 until phase 18's)
MOE_ARCH, MOE_LAYERS, MOE_STEPS = "olmoe-1b-7b", 2, 2
GRANITE_ARCH = "granite-moe-3b-a800m"
MOE_SERVE_FLASH_SHAPE = (SLOTS, 48, 16, 16, 128)
MOE_TP_FLASH_SHAPE = (LM_BATCH, LM_SEQ, 4, 4, 128)
MOE_PHANTOM_SHAPE = (LM_BATCH * LM_SEQ, 512, 512, 32)
# phase 13: mamba2-370m served at full width (tp 1, every prompt its own
# exact-length group: page size 1) and trained at full width and
# MAMBA_LAYERS of its 48 layers on LM_TP ranks, MAMBA_STEPS steps; then
# FSDP on a dp FSDP_DP x tp FSDP_TP mesh of the same ranks: phi3-mini at
# FSDP_LAYERS layers, FSDP_STEPS steps.  The kernels' shapes a rank:
# mamba2's phantom in (wz, wx) and out sites at tp 4 (d / tp = 256,
# d_inner / tp = 512, k = 8, PK = 32); phi3-mini's gate/up and down at
# dp 2 x tp 2 (B / dp x S = 1024 rows, k = 12, PK = 24) and its flash
# (B / dp = 2, 32 / tp = 16 heads of 96)
# (4 of the 48 layers and 2 steps: 8 and 3 until phase 18 needed the
# script's time)
MAMBA_ARCH, MAMBA_LAYERS, MAMBA_STEPS, MAMBA_PAGE = "mamba2-370m", 4, 2, 1
MAMBA_PHANTOM_SHAPES = ((LM_BATCH * LM_SEQ, 256, 512, 32),
                        (LM_BATCH * LM_SEQ, 512, 256, 32))
# (FSDP_LAYERS 2, cut for phase 17's time; FSDP_STEPS 2, 3 until phase
# 18's)
FSDP_DP, FSDP_TP, FSDP_LAYERS, FSDP_STEPS = 2, 2, 2, 2
FSDP_PHANTOM_SHAPES = ((1024, 1536, 4096, 24), (1024, 4096, 1536, 24))
FSDP_FLASH_SHAPE = (LM_BATCH // FSDP_DP, LM_SEQ, 16, 16, 96)
# phase 14: jamba-1.5-large at full width: served at JAMBA_SERVE_LAYERS of
# its 72 layers (its three block kinds; one MoE layer's 16 experts are
# 19.3 GB in bf16), trained on LM_TP ranks at JAMBA_LAYERS (attention +
# MLP, SSD + MoE: 45.8 GB of bf16 weights and gradients over the ranks),
# JAMBA_STEPS steps; step 1 in float32 with JAMBA_PARITY_EXPERTS experts.
# The kernels' shapes: flash's (B, S, H, KV, hd) at serving (SLOTS x the
# longest mixed prompt, 64 heads, KV 8, hd 128) and a rank's at tp 4
# (16 heads, KV 2); the phantom kernels' (M, K, N, PK) at gate/up and at
# down a rank at tp 4 (d / tp = 2048, d_ff / tp = 6144, k = 32, PK = 128)
JAMBA_ARCH, JAMBA_SERVE_LAYERS, JAMBA_LAYERS = "jamba-1.5-large-398b", 3, 2
JAMBA_STEPS, JAMBA_PARITY_EXPERTS = LM_STEPS, 4
JAMBA_SERVE_FLASH_SHAPE = (SLOTS, 48, 64, 8, 128)
JAMBA_TP_FLASH_SHAPE = (LM_BATCH, LM_SEQ, 16, 2, 128)
JAMBA_PHANTOM_SHAPES = ((LM_BATCH * LM_SEQ, 2048, 6144, 128),
                        (LM_BATCH * LM_SEQ, 6144, 2048, 128))
# phase 15: qwen2-vl-72b at full width: served at QWEN2VL_SERVE_LAYERS of
# its 80 layers (19.1 GB of bf16 weights), the recurrence check at
# QWEN2VL_PARITY_LAYERS of them in float32; trained on LM_TP ranks at
# QWEN2VL_LAYERS (2, cut for phase 17's time), step 1 at
# QWEN2VL_PARITY_LAYERS.  The kernels' shapes:
# flash's (B, S, H, KV, hd) at serving (64 heads, KV 8, hd 128) and a
# rank's at tp 4 (16 heads, KV 2); the phantom kernels' (M, K, N, PK) at
# gate/up and at down a rank at tp 4 (d / tp = 2048, d_ff / tp = 7392:
# 115.5 of the 64-wide tiles, k = 32, PK = 128)
QWEN2VL_ARCH, QWEN2VL_SERVE_LAYERS, QWEN2VL_LAYERS = "qwen2-vl-72b", 2, 2
QWEN2VL_PARITY_LAYERS = 2
QWEN2VL_SERVE_FLASH_SHAPE = (SLOTS, 48, 64, 8, 128)
QWEN2VL_TP_FLASH_SHAPE = (LM_BATCH, LM_SEQ, 16, 2, 128)
QWEN2VL_PHANTOM_SHAPES = ((LM_BATCH * LM_SEQ, 2048, 7392, 128),
                          (LM_BATCH * LM_SEQ, 7392, 2048, 128))
# phase 16: seamless-m4t-large-v2: served at full width (SERVE_DEPTH),
# trained on LM_TP ranks at SEAMLESS_LAYERS encoder + SEAMLESS_LAYERS
# decoder layers (4 + 4, cut for phase 17's time), step 1
# at SEAMLESS_PARITY_LAYERS + as many.  Flash at
# hd 64, full (the encoder) and causal (the decoder), at serving (16
# heads) and a rank's at tp 4 (4 heads); the phantom kernels at up and
# down a rank at tp 4 (d / tp = 256, d_ff / tp = 2048, k = 8, PK = 32)
SEAMLESS_ARCH, SEAMLESS_LAYERS = "seamless-m4t-large-v2", 4
SEAMLESS_PARITY_LAYERS = 2
SEAMLESS_FLASH_SHAPES = tuple(
    shape + (causal,) for shape in ((SLOTS, 48, 16, 16, 64),
                                    (LM_BATCH, LM_SEQ, 4, 4, 64))
    for causal in (False, True))
SEAMLESS_PHANTOM_SHAPES = ((LM_BATCH * LM_SEQ, 256, 2048, 32),
                           (LM_BATCH * LM_SEQ, 2048, 256, 32))
# the recurrence check of phase 13 (a): prefill against token-by-token
# decode in float32, each within this share of its largest magnitude
RECURRENCE_TOL = 1e-4
# phase 17: chatglm3-6b served over a mesh of ranks sharing the card
# through ``serve/router.py: run_config``: tensor sites on dp 2 x tp 4 and
# the router's phantom candidate (gate/up/down, k = 16) on dp 1 x tp 4,
# at full width and SERVE_MESH_LAYERS of its 28 layers (2; 4 until phase
# 18 needed the script's time; a decode step
# at 28 layers takes ≈ 2.1 s a rank on the H100: 170 collectives
# through the host at ≈ 11 ms each; PERF.md §4), on a poisson
# trace (the reference launcher's defaults, 4-48 prompt and 4-16 new
# tokens at 4 requests/s, but 4 requests of its 16: 8 until phase 19
# needed the script's time, 16 until phase 18 did); the streams' parity at SERVE_MESH_PARITY_LAYERS over the
# trace's first SERVE_MESH_PARITY_REQUESTS (2; 8 until phase 18); the
# router over SERVE_MESH_BUDGET devices at
# SERVE_MESH_SLO_MS.  The kernels' shapes a rank: flash's (B, S, H, KV, hd)
# at a 48-token prefill of the rank's slots (32 / tp = 8 query heads
# sharing the replicated K/V's one GQA head), the phantom forward's (M,
# K, N, PK) at gate/up and down at a decode step's 4 rows and a 48-token
# prefill group's 192 (d / tp = 1024, d_ff / tp = 3424: 53.5 of the
# 64-wide tiles, k = 16, PK = 64)
SERVE_MESH_ARCH, SERVE_MESH_LAYERS, SERVE_MESH_PARITY_LAYERS = \
    "chatglm3-6b", 2, 2
# the parity's streams: the trace's first requests (a prefix of its draw)
SERVE_MESH_PARITY_REQUESTS = 2
# the parity streams of phases 17 and 18: each request's new tokens at
# most (the trace's up to 16 until phase 18 needed the script's time)
PARITY_TOKENS = 4
SERVE_MESH = {"tensor": (2, 4), "phantom": (1, 4)}     # impl: (dp, tp)
SERVE_MESH_TRACE = dict(kind="poisson", n=4, rate_rps=4.0,
                        prompt_len_range=(4, 48), new_tokens_range=(4, 16),
                        seed=SEED)
SERVE_MESH_SLO_MS, SERVE_MESH_BUDGET = 200.0, 8
SERVE_MESH_FLASH_SHAPES = ((SLOTS // 2, 48, 8, 1, 128),
                           (SLOTS, 48, 8, 1, 128))
SERVE_MESH_PHANTOM_SHAPES = ((SLOTS, 1024, 3424, 64), (SLOTS, 3424, 1024, 64),
                             (SLOTS * 48, 1024, 3424, 64),
                             (SLOTS * 48, 3424, 1024, 64))


# phase 18: the families other than the dense one served over dp 1 x tp
# 4 (ranks sharing the card), each at full width with its own projection
# map, bf16, FAMILY_MESH_LAYERS layers (jamba 3: its three block kinds;
# seamless as many encoder layers), page FAMILY_MESH_PAGE, on a short
# poisson trace (4 requests of 4-48 prompt and 4-8 new tokens, 8 until
# phase 19 needed the script's time, the recurrent families' prompts
# rounded up to a multiple of the page);
# the float32 streams of its first FAMILY_MESH_PARITY_REQUESTS requests
# against tp = 1, but jamba's (one layer's experts are 38.6 GB in
# float32), held per layer in bf16 against the plain path instead.  The
# kernels' shapes a rank: flash's (B, S, H, KV, hd[, causal]) at a
# 48-token prefill (olmoe 4 of 16 heads; jamba's and qwen2-vl's 16 on 2
# KV heads; seamless's 4 at hd 64, its encoder full, its decoder
# causal); the phantom forward's (M, K, N, PK) at a decode step's 4 rows
# and a 48-token group's 192, at olmoe's q/k/v/o (d / tp = 512, k = 8),
# mamba2's in and out (256 -> 512, 512 -> 256, k = 8), the MLP sites of
# jamba (2048, 6144, k = 32), qwen2.5 (1280, 3456, k = 16), qwen2-vl
# (2048, 7392, k = 32) and seamless (256, 2048, k = 8)
FAMILY_MESH = ("olmoe-1b-7b", "mamba2-370m", "jamba-1.5-large-398b",
               "qwen2.5-14b", "qwen2-vl-72b", "seamless-m4t-large-v2")
FAMILY_MESH_TP, FAMILY_MESH_LAYERS, FAMILY_MESH_PAGE = 4, 2, 4
FAMILY_MESH_DEPTH = {"jamba-1.5-large-398b": 3}
FAMILY_MESH_LAYER_CHECK = ("jamba-1.5-large-398b",)
FAMILY_MESH_TRACE = dict(kind="poisson", n=4, rate_rps=4.0,
                         prompt_len_range=(4, 48), new_tokens_range=(4, 8),
                         seed=SEED)
FAMILY_MESH_PARITY_REQUESTS = 2
FAMILY_MESH_FLASH_SHAPES = ((SLOTS, 48, 4, 4, 128), (SLOTS, 48, 16, 2, 128),
                            (SLOTS, 48, 4, 4, 64, False),
                            (SLOTS, 48, 4, 4, 64, True))
FAMILY_MESH_PHANTOM_SHAPES = tuple(
    (M, K, N, PK) for K, N, PK in ((512, 512, 32), (256, 512, 32),
                                   (512, 256, 32), (2048, 6144, 128),
                                   (6144, 2048, 128), (1280, 3456, 64),
                                   (3456, 1280, 64), (2048, 7392, 128),
                                   (7392, 2048, 128), (256, 2048, 32),
                                   (2048, 256, 32))
    for M in (SLOTS, SLOTS * 48))

# phase 19: the disaggregated fleet (``serve/fleet``), executed.  (a) one
# process on the card: chatglm3-6b at full width and SERVE_DEPTH layers,
# both pools tensor sites at dp 1 x tp 1; (b) FLEET_TP ranks sharing the
# card: full width, FLEET_MESH_LAYERS layers, both pools the router's
# phantom candidate (gate/up/down, k = 16) at dp 1 x tp FLEET_TP.  bf16,
# SLOTS slots, MAX_LEN, page PAGE, one replica a pool, on FLEET_TRACE (8
# poisson requests, prompts 4-48, 4-8 new tokens); the float32 parity at
# FLEET_PARITY_LAYERS layers on the trace's first FLEET_PARITY_REQUESTS
# requests, PARITY_TOKENS tokens at most.  The migrated bytes are held
# to the count from the decls in bf16, the cache's declared dtype (the
# float32 runs promote the cache and migrate twice the bytes).
FLEET_ARCH, FLEET_TP, FLEET_MESH_LAYERS = "chatglm3-6b", 4, 2
FLEET_PARITY_LAYERS, FLEET_PARITY_REQUESTS = 2, 2
FLEET_TRACE = dict(kind="poisson", n=8, rate_rps=4.0,
                   prompt_len_range=(4, 48), new_tokens_range=(4, 8),
                   seed=SEED)
FLEET_WIRE_BAND = (0.9, 1.1)


# a kernel's measured keys in the kernels line
TIMED = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
         "library_ms")
# ... and a phantom case's, with the CUDA name of the kernel that ran it,
# its tile shape, and (the forward's and the dgrad's wgmma route) the time
# of the one-shape plan on the same operands: every call at 128 x 256
# tiles, split as a whole tile (``benchmarks/wgmma_plan.py:
# one_shape_plan``)
PHANTOM_TIMED = TIMED + ("route", "tile", "one_shape_ms")
# the phantom products' bf16 kernels (the tensor-core route), by product
WGMMA_KERNELS = ("wgmma_fwd_kernel", "wgmma_dgrad_kernel",
                 "wgmma_wgrad_kernel")
WGMMA_OF = dict(zip(("phantom_fused_matmul", "matmul_nt", "matmul_tn"),
                    WGMMA_KERNELS))


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def observed(meta=None):
    """The port's tracer and a fresh metrics registry for the block
    (``obs/``; what ``launch/obs.py: obs_session`` installs, kept in
    memory): the ranks that a pool job starts inside it trace on its
    origin, and their spans merge into it (``obs/ranks.py``)."""
    from repro_torch.obs import (MetricsRegistry, Tracer, set_metrics,
                                 use_tracer)
    tracer, reg = Tracer(meta=meta), MetricsRegistry()
    prev = set_metrics(reg)
    try:
        with use_tracer(tracer):
            yield tracer, reg
    finally:
        set_metrics(prev)


def span_counts(doc, pid=None, ph="X"):
    """How many spans (``ph="i"``: instants) of each name a trace
    document holds, on ``pid`` or on every pid."""
    from collections import Counter
    return Counter(e["name"] for e in doc["traceEvents"] if e["ph"] == ph
                   and (pid is None or e["pid"] == pid))


def span_cost_us(n=20000):
    """Host microseconds of one ``Tracer.span`` enter and exit (an
    enabled tracer; the disabled one hands out a shared no-op span)."""
    from repro_torch.obs import Tracer
    tracer = Tracer()
    t0 = time.perf_counter()
    for i in range(n):
        with tracer.span("x", cat="y", step=i):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def time_ms(fn, reps=20, trials=5):
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed ``trials`` times between CUDA events (the median), so that
    the host's launch rate does not bound kernels of a few microseconds.
    Inputs stay resident in L2 across calls, as they are in serving,
    where the projection that made them ran just before.  ``fn`` may be a
    list of calls on different operands, taken in turn, each at least
    once (``cold_ms``)."""
    import torch
    fns = fn if isinstance(fn, list) else [fn]
    reps = max(reps, len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def cold_ms(make, nbytes):
    """Device time per call with a cold L2: ``make()`` returns a call on
    fresh operands of ``nbytes`` input bytes; enough of them, taken in
    turn, that each call's inputs were evicted (twice the 50 MB L2)."""
    sets = max(4, -(-100_000_000 // nbytes))
    return time_ms([make() for _ in range(sets)])


def attention_bound_ms(B, S, H, KV, hd, causal, dtype):
    """Least time for the function: each input read once and the output
    written once, against QK^T and PV on the pairs causality keeps."""
    import torch
    esize = 2 if dtype == torch.bfloat16 else 4
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * esize
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * hd * pairs
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = build.build(build.KERNELS)
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s ({', '.join(build.KERNELS)})")
    for name in build.KERNELS:
        for line in logs.get(name, "").splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    hmma = {f"hd={name.split('ILi')[1].split('E')[0]}": n for name, n in
            _sass_count("flash_attention", "flash_mma_kernel",
                        "HMMA").items()}
    print(f"flash_mma_kernel HMMA instructions (cuobjdump -sass), by head "
          f"dim: {hmma}", flush=True)
    check(len(hmma) == len(HEAD_DIMS) and all(hmma.values()),
          f"the bf16 flash kernel is not on the tensor cores at every head "
          f"dim of {HEAD_DIMS}: {hmma}")
    sass = _sass_count("phantom_fused", "wgmma_", "HGMMA")
    instances = {_wgmma_instance(name): n for name, n in sass.items()}
    hgmma = {k: sum(n for name, n in instances.items() if k in name)
             for k in WGMMA_KERNELS}
    print(f"phantom wgmma kernels' HGMMA instructions (cuobjdump -sass), "
          f"by instance: {instances}", flush=True)
    # every instance: the forward and the dgrad at each tile shape, the
    # wgrad at one
    from repro_torch.kernels.phantom_fused import WG_SHAPES
    want = sorted([f"{k}<{bm}, {bn}>" for k in WGMMA_KERNELS[:2]
                   for bm, bn in WG_SHAPES] + [WGMMA_KERNELS[2]])
    check(sorted(instances) == want and all(instances.values()),
          f"a bf16 phantom kernel instance is missing or not on the tensor "
          f"cores (no HGMMA): {instances}, want every one of {want}")
    return {"nvidia_smi": smi, "build_s": build_s, "flash_hmma": hmma,
            "phantom_hgmma": hgmma, "phantom_hgmma_instances": instances}


def _wgmma_instance(mangled):
    """``wgmma_fwd_kernel<64, 64>`` (or ``wgmma_wgrad_kernel``) from a
    wgmma kernel's mangled name."""
    import re
    base = next(k for k in WGMMA_KERNELS if k in mangled)
    shape = re.search(r"ILi(\d+)ELi(\d+)E", mangled)
    return base if shape is None else f"{base}<{shape[1]}, {shape[2]}>"


def _sass_count(kernel, function, opcode):
    """Instructions whose text holds ``opcode`` in each function of the
    built ``kernel`` library whose name holds ``function``, from
    ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels import build
    sass = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass",
         str(build.library_path(kernel))], capture_output=True, text=True,
        check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if function in name:
                counts[name] = 0
        elif name in counts and opcode in line:
            counts[name] += 1
    return counts


def _flash_inputs(S, gen, B=4, H=32, KV=2, hd=128, dtype="bfloat16"):
    """q, k, v on the card with scores q.k / sqrt(hd) of std 2."""
    import torch
    return [(torch.randn(B, S, n, hd, device="cuda", generator=gen) * scale
             ).to(getattr(torch, dtype))
            for n, scale in ((H, 2.0), (KV, 1.0), (KV, 0.5))]


def _flash_held(got, q, k, v, causal):
    """The kernel's output against the plain version: fp32 within rtol
    2e-3 / atol 2e-4; bf16 against the float32 plain version on the same
    inputs, within 1e-2 of sum_j p_j |v_j|.  Returns the largest absolute
    error, the largest relative to that sum (bf16; None for fp32) and
    the verdict."""
    import torch
    from repro_torch.kernels.ref import flash_attention_ref
    if q.dtype == torch.float32:
        want = flash_attention_ref(q, k, v, causal=causal)
        diff = (got - want).abs()
        return (diff.max().item(), None,
                bool((diff <= 2e-4 + 2e-3 * want.abs()).all()))
    q, k, v = (t.float() for t in (q, k, v))
    want = flash_attention_ref(q, k, v, causal=causal)
    size = flash_attention_ref(q, k, v.abs(), causal=causal)
    diff = (got.float() - want).abs()
    rel = (diff / size).max().item()
    return diff.max().item(), rel, rel <= 1e-2


def _case(B, S, H, KV, hd, causal, dtype, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = _flash_inputs(S, gen, B, H, KV, hd, dtype)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err, rel, ok = _flash_held(got, q, k, v, causal)
    # SDPA takes [B, H, S, hd]; K/V expanded to H heads outside the timing
    qs = q.transpose(1, 2)
    ks = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vs = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    bound, bound_by = attention_bound_ms(B, S, H, KV, hd, causal, q.dtype)
    return {
        "B": B, "S": S, "H": H, "KV": KV, "hd": hd, "causal": causal,
        "dtype": dtype, "max_abs_err": err, "max_rel_err": rel, "ok": ok,
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal)),
        "plain_ms": time_ms(
            lambda: flash_attention_ref(q, k, v, causal=causal)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal)),
        "bound_ms": bound, "bound_by": bound_by}


def phase_kernels():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [dict(B=B, S=S, H=32, KV=2, hd=128, causal=c, dtype=dt)
             for B in SWEEP_B for S in SWEEP_S for c in (True, False)
             for dt in ("bfloat16", "float32")]
    cases.append(dict(B=2, S=16, H=4, KV=2, hd=16, causal=True,
                      dtype="float32"))
    results = []
    for c in cases:
        r = _case(**c, gen=gen)
        results.append(r)
        print(f"flash_attention B={r['B']} S={r['S']} H={r['H']} "
              f"KV={r['KV']} hd={r['hd']} {r['dtype']} "
              f"{'causal' if r['causal'] else 'full'}: "
              f"max_abs_err={r['max_abs_err']:.3e}"
              + ("" if r["max_rel_err"] is None else
                 f" (of sum p|v|: {r['max_rel_err']:.3e})")
              + f" ok={r['ok']} "
              f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f}", flush=True)
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"flash_attention disagrees with its plain version in "
                   f"{len(bad)} case(s): {bad}")
    return {"sweep": results, "cold": _flash_cold(gen)}


def _flash_cold(gen):
    """The bf16 kernel and SDPA at the serving geometry with a cold L2."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    out = {}
    for S in (48, 512):
        nbytes = sum(t.numel() * 2 for t in _flash_inputs(S, gen))

        def kern():
            q, k, v = _flash_inputs(S, gen)
            return lambda: flash_attention(q, k, v, causal=True)

        def lib():
            q, k, v = _flash_inputs(S, gen)
            qs = q.transpose(1, 2)
            ks, vs = (t.repeat_interleave(16, dim=2).transpose(1, 2)
                      for t in (k, v))
            return lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                          is_causal=True)
        out[S] = {"cold_ms": cold_ms(kern, nbytes),
                  "library_cold_ms": cold_ms(lib, nbytes)}
        print(f"flash_attention bf16 B=4 S={S} causal, cold L2: ms="
              f"{out[S]['cold_ms']:.4f} library_ms="
              f"{out[S]['library_cold_ms']:.4f}", flush=True)
    return out


def closed_batch(vocab_size, n, prompt_len, new_tokens, seed):
    """``n`` requests of ``prompt_len`` random tokens, all arriving at 0:
    the serving launcher's closed batch (``launch/serve.py:
    make_workload``), prompts drawn by ``serve/traffic.py:
    trace_requests``."""
    from repro_torch.serve.traffic import TraceItem, trace_requests
    return trace_requests([TraceItem(0.0, prompt_len, new_tokens)] * n,
                          vocab_size, seed=seed)


def slo_report(requests):
    """``serve/traffic.py: SLOTracker``'s report of the requests, its
    tokens/s over the span from their first arrival (the mixed batch
    arrives after the closed one has run)."""
    from repro_torch.serve.traffic import SLOTracker
    tracker = SLOTracker()
    tracker.observe_all(requests)
    rep = tracker.report()
    span = rep.get("duration_s", 0.0) - min(r.arrival_s for r in requests)
    rep["tokens_per_s"] = rep["generated_tokens"] / span if span > 0 else 0.0
    return rep


def phase_serve():
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, with_kernel_backend
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import model_decls
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import bucket_of

    cfg = with_kernel_backend(get_config("chatglm3-6b"), "pallas").replace(
        num_layers=SERVE_DEPTH["chatglm3-6b"])
    axes = MeshAxes()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, materialize(model_decls(cfg, axes), gen, "cuda"),
                      slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
                      axes=axes, device="cuda")
    torch.cuda.synchronize()
    weights_gb = sum(t.numel() * t.element_size() for t in
                     _leaves(eng.params)) / 1e9
    print(f"serve: {cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"weights on card {weights_gb:.2f} GB, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    closed = closed_batch(cfg.vocab_size, 8, 16, NEW_TOKENS, SEED)
    rng = np.random.RandomState(SEED + 1)
    mixed = [Request(prompt=rng.randint(0, cfg.vocab_size, n)
                     .astype(np.int32), max_new_tokens=NEW_TOKENS,
                     req_id=100 + i) for i, n in enumerate(MIXED_LENS)]
    eng.warmup(sorted({bucket_of(n, PAGE) for n in MIXED_LENS + (16,)}))

    # --- the main path: counts from zero, read right after ---------------
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    groups0 = eng.prefill_meter.calls
    decodes0 = eng.decode_meter.calls
    with observed({"run": "chip_smoke.serve"}) as (tracer, reg):
        flash_attention.launches = 0
        eng.run(closed)
        rep_closed = slo_report(closed)
        for r in mixed:
            r.arrival_s = eng.now_s
        eng.run(mixed)
        launches = flash_attention.launches
        rep_mixed = slo_report(mixed)
    groups = eng.prefill_meter.calls - groups0
    decodes = eng.decode_meter.calls - decodes0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    obs = _serve_obs_held(tracer, reg, closed + mixed, groups, decodes,
                          rep_closed["requests"] + rep_mixed["requests"])

    for r in closed + mixed:
        check(r.done and len(r.out_tokens) == NEW_TOKENS,
              f"request {r.req_id} ended with {len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"request {r.req_id} sampled out-of-vocab tokens")
    check(launches == groups * cfg.num_layers,
          f"flash kernel launched {launches} times for {groups} prefill "
          f"groups x {cfg.num_layers} layers")
    for name, rep in (("closed", rep_closed), ("mixed", rep_mixed)):
        print(f"serve {name}: requests={rep['requests']} "
              f"tokens={rep['generated_tokens']} "
              f"TTFT p50={rep['ttft_ms']['p50']:.3f} ms "
              f"TPOT p50={rep['tpot_ms']['p50']:.3f} ms "
              f"tokens/s={rep['tokens_per_s']:.1f}", flush=True)
    print(f"serve: prefill groups={groups} flash launches={launches} "
          f"memory allocated {start_gb:.2f} GB at the start, peak "
          f"{peak_gb:.2f} GB", flush=True)

    for name, meter in (("prefill", eng.prefill_meter),
                        ("decode", eng.decode_meter)):
        print(f"serve: {name} step median "
              f"{meter.median_us() / 1e3:.3f} ms over {meter.calls} calls")

    profile = _profile_decode(eng, cfg)
    toks = torch.from_numpy(np.stack([r.prompt for r in closed[:SLOTS]])
                            ).long().cuda()
    logit_errs = _compare_cores(cfg, axes, eng.params, toks)
    return {"launches": launches, "prefill_groups": groups,
            "weights_gb": weights_gb, "start_memory_gb": start_gb,
            "peak_memory_gb": peak_gb, "obs": obs,
            "closed": rep_closed, "mixed": rep_mixed,
            "logits_max_abs_err": logit_errs, "decode_profile": profile,
            "prefill_meter": eng.prefill_meter.summary(),
            "decode_meter": eng.decode_meter.summary()}


def _serve_obs_held(tracer, reg, requests, groups, decodes, reported):
    """Hold the serving main path's trace and metrics (``obs/``): a
    ``serve/prefill`` span a prefill group and a ``serve/decode`` span a
    decode step; the prefilled tokens the prompts', the decode tokens
    those served less the first tokens of exact-length prompts (their
    prefill samples them); a TTFT observation a request the SLO reports
    counted, a TPOT one a request of more than one token.  Prints and
    returns the counts, the spans a decode step and a span's host
    cost."""
    from repro_torch.serve.scheduler import bucket_of
    doc = tracer.to_chrome()
    spans = span_counts(doc)
    exact = sum(len(r.prompt) == bucket_of(len(r.prompt), PAGE)
                for r in requests)
    want = {"serve/prefill": groups, "serve/decode": decodes,
            "serve_prefill_tokens_total": sum(len(r.prompt)
                                              for r in requests),
            "serve_decode_tokens_total": sum(len(r.out_tokens)
                                             for r in requests) - exact,
            "serve_ttft_ms": reported,
            "serve_tpot_ms": sum(len(r.out_tokens) > 1 for r in requests)}
    got = {"serve/prefill": spans["serve/prefill"],
           "serve/decode": spans["serve/decode"],
           **{k: int(reg.counter(k).value()) for k in (
               "serve_prefill_tokens_total", "serve_decode_tokens_total")},
           **{k: reg.histogram(k).count() for k in ("serve_ttft_ms",
                                                    "serve_tpot_ms")}}
    check(got == want, f"serve: spans and metrics {got}, want {want}")
    out = {"counts": got, "spans": sum(spans.values()),
           "span_cost_us": span_cost_us()}
    print(f"serve: obs spans and metrics {got} (held); "
          f"{out['spans']} spans over the main path, a span's host cost "
          f"{out['span_cost_us']:.2f} us", flush=True)
    return out


def _profile_decode(eng, cfg, steps=4):
    """Where a decode step's time goes: ``torch.profiler`` over a few
    steps of a full batch (after the main path, outside its counts).
    Reports the wall time per step, the device time its kernels and
    copies took, and how many of them ran per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    eng.submit(closed_batch(cfg.vocab_size, SLOTS, 16, steps + 2, SEED + 2))
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side entries only (kernels, copies): the CPU ops' device
    # columns count the same kernels again
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    ops = sum(e.count for e in events) / steps
    while eng.has_active():
        eng.step()
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    out = {"wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms or None,
           "device_busy_share": (device_ms / wall_ms) if device_ms else None,
           "device_ops_per_step": ops,
           "top_device_ms_per_step": {
               e.key[:60]: e.self_device_time_total / 1e3 / steps
               for e in top}}
    busy = out["device_busy_share"]
    top_ms = {k: round(v, 4) for k, v in out["top_device_ms_per_step"]
              .items()}
    print(f"serve: decode profile: wall {wall_ms:.3f} ms/step, device "
          f"{device_ms:.3f} ms/step, busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'}, "
          f"{ops:.0f} device ops/step; top: {top_ms}",
          flush=True)
    return out


def _close(a, b):
    import torch
    return bool(torch.allclose(a.float(), b.float(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL))


def _compare_cores(cfg, axes, params, toks, tag="serve"):
    """Prefill of the first group through the kernel path and through the
    plain blockwise core, on the same weights:

    * per layer, bf16 as served: both cores get the kernel path's input,
      so each layer's output and the final logits are held to 5e-2 without
      the drift of many chaotic random layers compounding one-ulp bf16
      differences.  The layer's FFN is the config's (``layer_plan``).  In
      an MoE layer both cores' router logits are held as well, and a token
      whose kept experts differ between the cores (``_routing_flips``) is
      left out of that layer's check and counted, at most half the layer's
      tokens: a discrete choice that a rounding moved, not a wrong sum;
    * end to end in float32 activations (fp32 kernel): held to 5e-2;
    * end to end in bf16: printed, not held (the drift above)."""
    import torch
    from repro_torch.configs.base import with_kernel_backend
    from repro_torch.models.blocks import block_apply, layer_plan
    from repro_torch.models.layers import (embed_apply, head_logits,
                                           norm_apply, residual_layout)
    from repro_torch.models.model import forward_prefill
    from repro_torch.parallel.params import tree_map
    plain = with_kernel_backend(cfg, "xla")
    _, ffn = layer_plan(cfg)[0]     # one block kind: chatglm3, olmoe
    V = cfg.vocab_size
    lay = residual_layout(cfg, "prefill")
    errs, flips = {}, []
    with torch.no_grad():
        B, S = toks.shape
        pos = torch.arange(S, device=toks.device).expand(B, S)
        h = embed_apply(cfg, lay, params["embed"], toks, axes)
        worst = 0.0
        for i in range(cfg.num_layers):
            lp = tree_map(lambda t: t[i], params["layers"])
            outs = []
            for c in (cfg, plain):
                routes = []
                with _recording_routes(routes):
                    h_c, _, _ = block_apply(c, lay, lp, h, pos, axes,
                                            kind="prefill", ffn=ffn)
                outs.append((h_c, routes))
            (h_k, r_k), (h_x, r_x) = outs
            same = torch.ones(B, S, dtype=torch.bool, device=h.device)
            if ffn == "moe":
                same, layer_flips = _routing_flips(cfg, r_k[0], r_x[0])
                same = same.reshape(B, S)
                flips += [{"layer": i, **f} for f in layer_flips]
                check(len(layer_flips) <= B * S // 2,
                      f"{tag}: layer {i}: {len(layer_flips)} of {B * S} "
                      f"tokens kept other experts on the two cores")
            worst = max(worst, (h_k[same].float() - h_x[same].float())
                        .abs().max().item())
            check(_close(h_k[same], h_x[same]),
                  f"{tag}: layer {i}: kernel and plain core outputs "
                  f"disagree")
            h = h_k

        def logits(x):
            return head_logits(cfg, lay, params["head"], norm_apply(
                cfg, lay, params["final_norm"], x, axes)[:, -1:],
                axes)[..., :V]
        # the last layer's tokens that kept the same experts on both cores
        rows = same[:, -1]
        lg_k, lg_x = logits(h_k)[rows], logits(h_x)[rows]
        check(bool(torch.isfinite(lg_k).all()), f"{tag}: non-finite logits")
        check(_close(lg_k, lg_x), f"{tag}: per-layer logits disagree")
        errs["per_layer_bf16_hidden"] = worst
        errs["per_layer_bf16_logits"] = (lg_k - lg_x).abs().max().item()

        for name, dt in (("end_to_end_fp32", "float32"),
                         ("end_to_end_bf16", "bfloat16")):
            c = cfg.replace(dtype=dt)
            lg_k, _ = forward_prefill(c, axes, params, {"tokens": toks})
            lg_x, _ = forward_prefill(with_kernel_backend(c, "xla"), axes,
                                      params, {"tokens": toks})
            errs[name] = (lg_k[..., :V] - lg_x[..., :V]).abs().max().item()
            if dt == "float32":
                check(_close(lg_k[..., :V], lg_x[..., :V]),
                      f"{tag}: fp32 end-to-end logits disagree")
    for name, e in errs.items():
        print(f"{tag}: kernel vs plain core, {name}: max_abs_err={e:.3e}"
              f"{'' if name == 'end_to_end_bf16' else ' (held to 5e-2)'}")
    if ffn == "moe":
        shown = [{k: round(v, 5) if isinstance(v, float) else v
                  for k, v in f.items()} for f in flips]
        print(f"{tag}: tokens that kept other experts on the two cores, "
              f"left out of their layer's check: {len(flips)} of "
              f"{B * S * cfg.num_layers} token-layers; each with its "
              f"router's top-k margin (plain core) and the cores' largest "
              f"router-logit difference: {shown}", flush=True)
        errs["routing_flips"] = flips
    return errs


@contextlib.contextmanager
def _recording_routes(log):
    """Within it, every ``models/moe.py: route`` call appends its
    (logits, capacity, combine_slot) to ``log``."""
    from repro_torch.models import moe
    route = moe.route

    def recording(logits, top_k, capacity):
        out = route(logits, top_k, capacity)
        log.append((logits, capacity, out[3]))
        return out
    moe.route = recording
    try:
        yield
    finally:
        moe.route = route


def _routing_flips(cfg, kern, plain):
    """Two cores' routing of one MoE layer, each (logits [T, E], capacity,
    combine_slot [T, K]): their router logits held to 5e-2; returns (a
    [T] mask of the tokens that kept the same experts on both, and for
    each other token its top-k margin on the plain core's logits, the
    cores' largest logit difference on it, and whether its top-k set
    moved or only a capacity drop did)."""
    import torch
    (lg_k, C, slot_k), (lg_x, _, slot_x) = kern, plain
    check(_close(lg_k, lg_x), "router logits of the two cores disagree")
    K = cfg.moe.top_k

    def kept(slot):
        return torch.where(slot >= 0, slot // C, -1).sort(-1).values

    def chosen(lg):
        return torch.topk(lg, K, dim=-1).indices.sort(-1).values
    same = (kept(slot_k) == kept(slot_x)).all(-1)
    moved = (chosen(lg_k) != chosen(lg_x)).any(-1)
    top = torch.topk(lg_x, K + 1, dim=-1).values
    margin = top[:, K - 1] - top[:, K]
    delta = (lg_k - lg_x).abs().max(-1).values
    flips = [{"token": t, "top_k_moved": bool(moved[t]),
              "margin": margin[t].item(), "logit_diff": delta[t].item()}
             for t in (~same).nonzero().flatten().tolist()]
    return same, flips


def _gemm_bound_ms(nbytes, flops, dtype):
    """Least time: the larger of the bytes over 3.35 TB/s and the
    operations over the card's peak for the input type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _held(got, want, tol):
    diff = (got.float() - want.float()).abs()
    return (diff.max().item(),
            bool((diff <= tol + tol * want.float().abs()).all()))


def _phantom_case(M, K, N, PK, dtype, gen, names=None):
    """The three phantom kernels (``names``: those of them) on one (M, K,
    N, PK): the forward z = x.L + g.D, the dgrad dz.[L;D]^T and the wgrad
    [x|g]^T.dz, each
    with its launch plan (the route: the kernel's CUDA name; the tile
    shape; splits per output tile and the clusters the card holds at
    once; the wgrad's grid and rounds of tiles; the variant: ``wgmma``,
    or 16-byte or masked copies), whether a second launch on the same
    inputs gives the same bits, and on the forward's and the dgrad's
    wgmma route the one-shape plan's time on the same operands."""
    import torch
    from repro_torch.benchmarks.wgmma_plan import one_shape_plan
    from repro_torch.kernels import phantom_fused as pf
    from repro_torch.kernels.phantom_fused import (WG_PRODUCTS, dgrad_plan,
                                                   forward_plan, matmul_nt,
                                                   matmul_tn,
                                                   phantom_fused_matmul,
                                                   resident_table, tn_plan,
                                                   wg_resident_table)
    from repro_torch.kernels.ref import (matmul_nt_ref, matmul_tn_ref,
                                         phantom_fused_ref)
    dt = getattr(torch, dtype)

    def r(*shape):
        return (torch.randn(*shape, device="cuda", generator=gen) * 0.3
                ).to(dt)
    x, L, g, D, dz = r(M, K), r(K, N), r(M, PK), r(PK, N), r(M, N)
    # the library's operands, concatenated (and viewed transposed) here,
    # outside the timing
    xg, LD = torch.cat([x, g], 1), torch.cat([L, D])
    LDt, xgt = LD.t(), xg.t()
    es, J = x.element_size(), K + PK
    flops = 2 * M * N * J
    calls = {
        "phantom_fused_matmul": (
            lambda: phantom_fused_matmul(x, L, g, D),
            lambda: phantom_fused_ref(x, L, g, D),
            lambda: torch.mm(xg, LD), (M * J + J * N + M * N) * es),
        "matmul_nt": (
            lambda: matmul_nt(dz, L, D),
            lambda: matmul_nt_ref(dz, torch.cat([L, D])),
            lambda: torch.mm(dz, LDt), (M * N + J * N + M * J) * es),
        "matmul_tn": (
            lambda: matmul_tn(x, dz, g),
            lambda: matmul_tn_ref(torch.cat([x, g], 1), dz),
            lambda: torch.mm(xgt, dz), (M * J + M * N + J * N) * es),
    }
    plans = {"phantom_fused_matmul": forward_plan(x, L, g, D),
             "matmul_nt": dgrad_plan(dz, L, D),
             "matmul_tn": tn_plan(x, dz, g)}
    # the forward's and the dgrad's parts of C and contraction segments,
    # and their launch on any plan through the wrappers' private launch
    # helpers: the one-shape plan's time beside the plan's
    by_plan = {
        "phantom_fused_matmul": (
            ((M,), (N,), (K, PK)),
            lambda p: lambda: pf._launch_forward(x, L, g, D, p)),
        "matmul_nt": (((M,), (K, PK), (N,)),
                      lambda p: lambda: pf._launch_nt(dz, L, D, p))}
    out = []
    for name, (kern, plain, lib, nbytes) in calls.items():
        if names and name not in names:
            continue
        got = kern()
        torch.cuda.synchronize()
        err, ok = _held(got, plain(), PHANTOM_TOL[dtype])
        bound, bound_by = _gemm_bound_ms(nbytes, flops, dtype)
        r = {"kernel": name, "M": M, "K": K, "N": N, "PK": PK,
             "dtype": dtype, "max_abs_err": err, "ok": ok,
             "ms": time_ms(kern), "plain_ms": time_ms(plain),
             "library_ms": time_ms(lib), "bound_ms": bound,
             "bound_by": bound_by}
        plan = plans[name]
        r["one_shape_ms"] = None
        if name == "matmul_tn":
            r.update(tiles=plan.tiles, grid=plan.grid, rounds=plan.rounds,
                     resident_blocks=plan.resident, splits=plan.splits,
                     tile=list(pf.WG_WGRAD_SHAPE if plan.variant == "wgmma"
                               else (pf.WGRAD_BM, pf.WGRAD_BN)))
        else:
            product = "dgrad" if plan.dgrad else "forward"
            table = (wg_resident_table(0, WG_PRODUCTS[product],
                                       (plan.bm, plan.bn))
                     if plan.variant == "wgmma" else
                     resident_table(0, plan.dgrad, plan.esize))
            r.update(splits=plan.splits, tiles=plan.tiles,
                     tile=[plan.bm, plan.bn],
                     clusters=plan.grid[0] * plan.grid[1] // plan.splits,
                     resident_clusters=table[plan.splits])
            if plan.variant == "wgmma":
                parts, on = by_plan[name]
                one = one_shape_plan(*parts, plan.dgrad,
                                     pf._wg_resident(product, x))
                r.update(est_us=plan.est_us, one_shape_splits=one.splits,
                         one_shape_ms=time_ms(on(one)))
        r.update(variant=plan.variant, route=plan.kernel,
                 bitwise=bool(torch.equal(got, kern())))
        r["ok"] = ok and r["bitwise"]
        out.append(r)
    return out


def _tile_text(r):
    """A phantom case's tile shape and, on the forward's and the dgrad's
    wgmma route, the one-shape plan's time beside the plan's."""
    text = f" tile={r['tile'][0]}x{r['tile'][1]}"
    if r["one_shape_ms"] is not None:
        text += (f" one_shape_ms={r['one_shape_ms']:.4f} (splits "
                 f"{r['one_shape_splits']})")
    return text


def _phantom_cold(M, K, N, PK, gen, dtype="float32", names=None):
    """The three kernels (``names``: those of them) and their library
    calls at one shape with a cold L2 (``cold_ms``: enough operand sets in
    turn that each call finds its inputs evicted)."""
    import torch
    from repro_torch.kernels.phantom_fused import (matmul_nt, matmul_tn,
                                                   phantom_fused_matmul)
    dt = getattr(torch, dtype)
    es = dt.itemsize

    def r(*shape):
        return (torch.randn(*shape, device="cuda", generator=gen) * 0.3
                ).to(dt)

    def ops():
        return r(M, K), r(K, N), r(M, PK), r(PK, N), r(M, N)
    calls = {   # kernel, library, input bytes
        "phantom_fused_matmul": (
            lambda x, L, g, D, dz: lambda: phantom_fused_matmul(x, L, g, D),
            lambda x, L, g, D, dz: (lambda a, b: lambda: torch.mm(a, b))(
                torch.cat([x, g], 1), torch.cat([L, D])),
            es * (M * (K + PK) + (K + PK) * N)),
        "matmul_nt": (
            lambda x, L, g, D, dz: lambda: matmul_nt(dz, L, D),
            lambda x, L, g, D, dz: (lambda b: lambda: torch.mm(dz, b.t()))(
                torch.cat([L, D])),
            es * (M * N + (K + PK) * N)),
        "matmul_tn": (
            lambda x, L, g, D, dz: lambda: matmul_tn(x, dz, g),
            lambda x, L, g, D, dz: (lambda a: lambda: torch.mm(a.t(), dz))(
                torch.cat([x, g], 1)),
            es * (M * (K + PK) + M * N)),
    }
    out = {}
    for name, (kern, lib, nbytes) in calls.items():
        if names and name not in names:
            continue
        out[name] = {
            "cold_ms": cold_ms(lambda: kern(*ops()), nbytes),
            "library_cold_ms": cold_ms(lambda: lib(*ops()), nbytes)}
        print(f"{name} M={M} K={K} N={N} PK={PK} {dtype}, cold L2: "
              f"ms={out[name]['cold_ms']:.4f} "
              f"library_ms={out[name]['library_cold_ms']:.4f}", flush=True)
    return out


def _phantom_grads(gen):
    """``phantom_fused_linear`` gradients (the kernels' backward) against
    autograd through the plain version, on the card."""
    import torch
    from repro_torch.kernels.ops import phantom_fused_linear
    from repro_torch.kernels.ref import phantom_fused_ref
    out = []
    for dtype in ("float32", "bfloat16"):
        dt, tol = getattr(torch, dtype), GRAD_TOL[dtype]
        for M, K, N, k, p in GRAD_SHAPES:
            shapes = ((M, K), (K, N), (M, p * k), (p * k, N))
            base = [(torch.randn(*s, device="cuda", generator=gen) * 0.3
                     ).to(dt) for s in shapes]
            res = {}
            for name, fn in (("kernel", phantom_fused_linear),
                             ("plain", phantom_fused_ref)):
                ins = [t.clone().requires_grad_(True) for t in base]
                loss = fn(*ins).square().sum()
                res[name] = (loss, torch.autograd.grad(loss, ins))
            torch.cuda.synchronize()
            errs, ok = [], True
            for a, b in zip((res["kernel"][0],) + res["kernel"][1],
                            (res["plain"][0],) + res["plain"][1]):
                err, good = _held(a, b, tol)
                errs.append(err)
                ok = ok and good and a.dtype == dt
            out.append({"M": M, "K": K, "N": N, "k": k, "p": p,
                        "dtype": dtype, "max_abs_err": max(errs), "ok": ok})
            print(f"phantom_fused_linear grads M={M} K={K} N={N} PK={p * k}"
                  f" {dtype}: max_abs_err={max(errs):.3e} ok={ok}",
                  flush=True)
    return out


def phase_phantom_kernels():
    import torch
    from repro_torch.kernels.phantom_fused import (WG_SHAPES, WG_WGRAD_SHAPE,
                                                   resident_table,
                                                   wg_resident_table,
                                                   wgrad_resident)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for dtype in ("float32", "bfloat16"):
        for shape in PHANTOM_SHAPES + [PHANTOM_MAIN, PHANTOM_PIPE]:
            for r in _phantom_case(*shape, dtype, gen):
                results.append(r)
                plan = (f" splits={r['splits']} clusters={r['clusters']} "
                        f"(resident at once: {r['resident_clusters']})"
                        if r["kernel"] != "matmul_tn" else
                        f" splits={r['splits']} tiles={r['tiles']} grid="
                        f"{r['grid']} rounds={r['rounds']} (resident at "
                        f"once: {r['resident_blocks']})")
                plan += (f" route={r['route']} {r['variant']}"
                         f"{_tile_text(r)} bitwise={r['bitwise']}")
                print(f"{r['kernel']} M={r['M']} K={r['K']} N={r['N']} "
                      f"PK={r['PK']} {dtype}: max_abs_err="
                      f"{r['max_abs_err']:.3e} ok={r['ok']}{plan} "
                      f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                      f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
                      f"library_ms={r['library_ms']:.4f}", flush=True)
    grads = _phantom_grads(gen)
    bad = [r for r in results + grads if not r["ok"]]
    check(not bad, f"phantom kernels disagree with their plain versions or "
                   f"with themselves in {len(bad)} case(s): {bad}")
    # float32 runs both CUDA-core variants; bf16 the tensor cores where
    # aligned and the masked variant where not: every product both ways
    for name in ("phantom_fused_matmul", "matmul_nt", "matmul_tn"):
        for dtype, want in (("float32", {"vec16", "masked"}),
                            ("bfloat16", {"wgmma", "masked"})):
            seen = {r["variant"] for r in results
                    if r["kernel"] == name and r["dtype"] == dtype}
            check(seen == want, f"{name} {dtype}: the sweep ran variants "
                                f"{seen}, not {want}")
        routes = {r["route"] for r in results if r["kernel"] == name
                  and r["dtype"] == "bfloat16" and r["variant"] == "wgmma"}
        check(routes == {WGMMA_OF[name]},
              f"{name}: aligned bf16 ran {routes}, not {WGMMA_OF[name]}")
    cold = _phantom_cold(*PHANTOM_MAIN, gen)
    resident = {f"{k}_{es}": resident_table(0, k == "dgrad", es)
                for k in ("forward", "dgrad") for es in (4, 2)}
    print(f"split-contraction kernel, clusters of S blocks resident at "
          f"once, by S (forward/dgrad, float32 = 4, bfloat16 masked = 2): "
          f"{resident}", flush=True)
    wgrad = {f"{es}_{v}": wgrad_resident(0, es, v)
             for es, v in ((4, "vec16"), (4, "masked"), (2, "masked"))}
    print(f"wgrad kernel, blocks resident at once (element size_variant): "
          f"{wgrad}", flush=True)
    wg_resident = {f"{k}<{bm}, {bn}>": wg_resident_table(0, p, (bm, bn))
                   for p, k in enumerate(WGMMA_KERNELS)
                   for bm, bn in (WG_SHAPES if p < 2 else (WG_WGRAD_SHAPE,))}
    print(f"wgmma kernels, clusters of S blocks resident at once, by S: "
          f"{wg_resident}", flush=True)
    return {"sweep": results, "grads": grads, "cold": cold,
            "resident_clusters": resident, "wgrad_resident_blocks": wgrad,
            "wgmma_resident_clusters": wg_resident}


def _adamw_step1(params, grads, lr, eps):
    """AdamW's first step at weight decay 0, in the tensors' own dtype:
    the bias-corrected moments are g and g^2, so p - lr * g / (|g| + eps)."""
    from repro_torch.parallel.params import tree_leaves, tree_unflatten
    g = dict(tree_leaves(grads))
    return tree_unflatten(params, {
        path: p - lr * g[path] / (g[path].abs() + eps)
        for path, p in tree_leaves(params)})


def _step1_diff(res, part, lr, eps):
    """Kernel path against plain path for one part of step 1 (``loss``,
    ``grads`` or ``params``): the worst absolute difference, the worst
    difference over its leaf's largest magnitude, the elements outside
    rtol 1e-4 / atol 1e-5, and each path's worst difference from the
    plain path run in float64 (``*_vs_f64``; ``kernel_vs_f64_scaled``
    over the leaf's largest float64 magnitude), where ``res`` has that
    run.

    AdamW's first step moves a parameter by ``lr * f(g)`` with
    ``f(g) = g / (|g| + eps)``, whose slope ``eps / (|g| + eps)^2``
    reaches ``1 / eps`` at g = 0: there a float32 gradient difference of
    1e-10 moves the parameter by ~3e-5.  A parameter whose gradient lies
    within ``ADAM_NEAR_ZERO`` (10 eps) of zero on either path
    (``near_zero_grad``) is held to the tolerance plus what its two
    gradients imply, ``lr * |f(g_kernel) - f(g_plain)|`` in float64
    (``max_implied_near_zero_grad``); every other parameter is held to
    the tolerance alone, and ``max_abs_err`` covers those only.  The
    ``*_vs_f64_near_zero_grad`` entries show how far each float32 path
    is from float64 there.  ``zero_in_one_path`` counts gradients that
    are exactly zero on one path only (a ReLU that switched)."""
    from repro_torch.parallel.params import tree_leaves

    def flat(tree):
        return dict(tree_leaves(tree)) if isinstance(tree, dict) \
            else {"": tree}

    def worst(t, mask=None):
        t = t if mask is None else t[mask]
        return t.max().item() if t.numel() else 0.0
    kern, plain = (flat(res[run][part]) for run in ("kernel", "plain"))
    # without a float64 run the *_vs_f64 entries are left out
    f64 = flat(res["float64"][part]) if "float64" in res else plain
    gk, gp = flat(res["kernel"]["grads"]), flat(res["plain"]["grads"])
    out = {"max_abs_err": 0.0, "max_scaled_err": 0.0, "outside": 0,
           "elements": 0, "kernel_vs_f64": 0.0,
           "kernel_vs_f64_scaled": 0.0, "plain_vs_f64": 0.0}
    if part == "grads":
        out["zero_in_one_path"] = 0
    if part == "params":
        out.update(near_zero_grad=0, max_abs_err_near_zero_grad=0.0,
                   max_implied_near_zero_grad=0.0,
                   kernel_vs_f64_near_zero_grad=0.0,
                   plain_vs_f64_near_zero_grad=0.0)
    for path, leaf in kern.items():
        # a leaf in chunks of STEP1_CHUNK elements, so that the float64
        # temporaries stay small beside a stage's 8192 x 8192 weight
        top = {"d": 0.0, "u": 0.0, "ek": 0.0, "w": 0.0}
        dev = plain[path].device     # a run's result may sit on the host
        for lo in range(0, max(leaf.numel(), 1), STEP1_CHUNK):
            def cut(x):
                return x.reshape(-1)[lo:lo + STEP1_CHUNK].to(dev)
            t, u, w = cut(leaf), cut(plain[path]).double(), cut(f64[path])
            d = (t.double() - u).abs()
            tol = STEP1_TOL["atol"] + STEP1_TOL["rtol"] * u.abs()
            ek, ep = (t.double() - w).abs(), (u - w).abs()
            if part == "grads":
                out["zero_in_one_path"] += int(
                    ((t == 0) != (cut(plain[path]) == 0)).sum())
            if part == "params":
                a, b = cut(gk[path]).double(), cut(gp[path]).double()
                near = ((a.abs() < ADAM_NEAR_ZERO)
                        | (b.abs() < ADAM_NEAR_ZERO))
                implied = lr * (a / (a.abs() + eps)
                                - b / (b.abs() + eps)).abs()
                tol = tol + implied * near
                out["near_zero_grad"] += int(near.sum())
                for key, v in (("max_abs_err", d), ("max_implied", implied),
                               ("kernel_vs_f64", ek), ("plain_vs_f64", ep)):
                    key += "_near_zero_grad"
                    out[key] = max(out[key], worst(v, near))
                d = d * ~near
            out["outside"] += int((d > tol).sum())
            out["elements"] += d.numel()
            for key, v in (("d", d), ("u", u.abs()), ("ek", ek),
                           ("w", w.abs())):
                top[key] = max(top[key], worst(v))
            out["plain_vs_f64"] = max(out["plain_vs_f64"], worst(ep))
        out["max_abs_err"] = max(out["max_abs_err"], top["d"])
        out["max_scaled_err"] = max(out["max_scaled_err"],
                                    top["d"] / max(top["u"], 1e-30))
        out["kernel_vs_f64"] = max(out["kernel_vs_f64"], top["ek"])
        out["kernel_vs_f64_scaled"] = max(out["kernel_vs_f64_scaled"],
                                          top["ek"] / max(top["w"], 1e-30))
    if "float64" not in res:
        out = {k: v for k, v in out.items() if "f64" not in k}
    return out


def _peak_rss_gib():
    """The process's peak resident host memory so far (``ru_maxrss``)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _step1(axes, device, kcfg, xcfg):
    """Step 1 through the kernels (``kcfg``), through plain torch
    (``xcfg``) and through plain torch in float64, from the same shards
    and batch: the kernel path against the other two, part by part
    (``_step1_diff``)."""
    import gc
    import torch
    from repro_torch.core.ffn import ffn_loss_and_grads, init_ffn, local_batch
    from repro_torch.data.synthetic import TeacherDataset
    from repro_torch.launch.train_ffn import BATCH, LR, SEED
    from repro_torch.optim import AdamW
    from repro_torch.parallel.params import tree_map

    opt = AdamW(LR, weight_decay=0.0)
    params, state = init_ffn(kcfg, axes, opt, SEED, device)
    x, y = TeacherDataset(kcfg.ffn_width, BATCH, SEED, device)(0)
    x, y = local_batch(x, axes), local_batch(y, axes)
    res = {}
    for name, cfg in (("kernel", kcfg), ("plain", xcfg)):
        # each run from its own copy: the optimizer updates in place
        p, s = tree_map(torch.clone, params), tree_map(torch.clone, state)
        loss, grads, _ = ffn_loss_and_grads(cfg, axes, p, x, y, BATCH)
        new_params, _ = opt.update(grads, s, p, 0)
        res[name] = {"loss": loss, "grads": grads, "params": new_params}
        del p, s
    p64 = tree_map(lambda t: t.double(), params)
    del params, state
    loss, grads, _ = ffn_loss_and_grads(xcfg, axes, p64, x.double(),
                                        y.double(), BATCH)
    res["float64"] = {"loss": loss, "grads": grads,
                      "params": _adamw_step1(p64, grads, LR, opt.eps)}
    del p64, grads
    gc.collect()
    out = {part: _step1_diff(res, part, LR, opt.eps)
           for part in ("loss", "grads", "params")}
    del res, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_rank(axes, device, smoke=False, table1_steps=TABLE1["max_steps"]):
    """The train phase inside one rank (``launch/mesh.py: spawn``).
    ``smoke`` takes the configs' CPU geometry, for a rehearsal with
    ``device="cpu"``."""
    import torch
    from repro_torch.benchmarks.table1_energy import table1_config
    from repro_torch.kernels import phantom_fused as pf
    from repro_torch.launch.train_ffn import train_config, train_rank

    comm = axes.world_comm
    out = {"rank": axes.rank, "backend": comm.backend,
           "via_host": comm.via_host}
    kcfg, xcfg = (train_config(TRAIN_ARCH, smoke=smoke, impl="phantom",
                               kernel_backend=b) for b in ("pallas", "xla"))
    out["step1"] = _step1(axes, device, kcfg, xcfg)
    # the peak host memory after each part, for the host draws' share
    out["peak_rss_gib"] = {"step1": _peak_rss_gib()}

    # --- the main path: counts from zero, read right after -------------
    kernels = (pf.phantom_fused_matmul, pf.matmul_nt, pf.matmul_tn)
    for k in kernels:
        k.launches = 0
    out["phantom"] = train_rank(axes, device, kcfg, TRAIN_STEPS)
    out["launches"] = {k.__name__: k.launches for k in kernels}
    torch.cuda.empty_cache()
    out["peak_rss_gib"]["phantom"] = _peak_rss_gib()
    out["tensor"] = train_rank(
        axes, device, train_config(TRAIN_ARCH, smoke=smoke, impl="tensor"),
        TRAIN_STEPS)
    torch.cuda.empty_cache()
    out["peak_rss_gib"]["tensor"] = _peak_rss_gib()

    out["table1"] = {}
    for impl, k in TABLE1_RUNS:
        run = train_rank(axes, device, table1_config(impl, k),
                         table1_steps, TABLE1["target"])
        out["table1"]["tensor" if impl == "tensor" else k] = run["losses"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["energy"] = _energy_rank(axes, device, smoke)
    out["energy_s"] = time.perf_counter() - t0
    out["peak_rss_gib"]["table1_and_energy"] = _peak_rss_gib()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["pipeline"] = _pipeline_rank(device, smoke)
    out["pipeline_s"] = time.perf_counter() - t0
    out["peak_rss_gib"].update(out["pipeline"].pop("peak_rss_gib"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["compress"] = _compress_rank(device, smoke)
    out["compress_s"] = time.perf_counter() - t0
    return out


def _pipe_equivalence(pipe, flat, device, cfg):
    """The pipelined probe on ``pipe`` against the same config's stages
    run in sequence on ``flat`` (pipe 1) by the same 8 ranks, from the
    same global weights and batch (``probe_inputs``: drawn on the host):
    the loss, this rank's stage of the parameter gradients (the flat
    run's stack holds every stage; both are cut by the same model
    coordinate) and the global input gradient, each against the
    reference's pipeline oracle."""
    import gc
    import torch
    from repro_torch.launch.train_ffn import BATCH, SEED
    from repro_torch.parallel.params import tree_leaves
    from repro_torch.telemetry.probe import (make_ffn_pipeline_probe_step,
                                             probe_inputs)
    res = {}
    for name, axes in (("pipe", pipe), ("flat", flat)):
        fn, decls = make_ffn_pipeline_probe_step(cfg, axes, BATCH)
        params, x, y = probe_inputs(cfg, axes, decls, BATCH, SEED, device)
        loss, (grads, x_grad) = fn(params, x, y)
        b, f = x.shape
        full = torch.zeros((BATCH, cfg.ffn_width), device=x.device)
        full[axes.dp_rank * b:(axes.dp_rank + 1) * b,
             axes.tp_rank * f:(axes.tp_rank + 1) * f] = x_grad
        res[name] = (float(loss), dict(tree_leaves(grads)),
                     axes.world_comm.all_reduce(full))
        del params, x, y, grads, x_grad
        gc.collect()
        torch.cuda.empty_cache()
    (lp, gp, xp), (lf, gf, xf) = res["pipe"], res["flat"]

    def held(a, b):
        diff = (a - b).abs()
        tol = EQUIV_TOL["atol"] + EQUIV_TOL["rtol"] * b.abs()
        return diff.max().item(), int((diff > tol).sum()), diff.numel()
    s = pipe.pp_rank
    grads = [held(g[0], gf[path][s]) for path, g in gp.items()]
    x_err = held(xp, xf)
    return {"loss_pipe": lp, "loss_flat": lf,
            "loss_rel": abs(lp - lf) / abs(lf),
            "grads_max_abs": max(g[0] for g in grads),
            "grads_outside": sum(g[1] for g in grads),
            "grads_elements": sum(g[2] for g in grads),
            "x_grad_max_abs": x_err[0], "x_grad_outside": x_err[1],
            "x_grad_elements": x_err[2]}


def _pipeline_rank(device, smoke=False):
    """The pipeline phase inside one rank: paper-ffn-16k cut into
    ``PIPE_PP`` stages on a pipe x dp x tp mesh of the same 8 ranks (new
    groups), and the same config on pipe 1 x dp 4 x tp 2 as the
    sequential reference.  Step 1 (``_step1``) and the equivalence
    (``_pipe_equivalence``) first, then the main path: 20 pipelined
    AdamW steps of phantom through the kernels (counts from zero, read
    right after) and ``PIPE_TENSOR_STEPS`` of ``tensor_col``; then the
    pipelined probe's
    ledger of both, its launches counted from zero."""
    import gc
    import torch
    from repro_torch.kernels import phantom_fused as pf
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train_ffn import (BATCH, SEED, train_config,
                                              train_rank)
    from repro_torch.telemetry import measure_ffn_pipeline_step

    pipe = make_local_mesh(PIPE_DP, PIPE_TP, PIPE_PP)
    flat = make_local_mesh(PIPE_PP * PIPE_DP, PIPE_TP)
    kcfg, xcfg, tcfg = (
        train_config(TRAIN_ARCH, smoke=smoke, impl=impl, kernel_backend=b,
                     pp=PIPE_PP, microbatches=PIPE_M)
        for impl, b in (("phantom", "pallas"), ("phantom", "xla"),
                        ("tensor", "pallas")))
    out = {"rank": pipe.rank, "stage": pipe.pp_rank,
           "step1": _step1(pipe, device, kcfg, xcfg),
           "equivalence": _pipe_equivalence(pipe, flat, device, kcfg)}
    rss = out["peak_rss_gib"] = {"pipe_step1_equivalence": _peak_rss_gib()}

    # --- the main path: counts from zero, read right after -------------
    kernels = (pf.phantom_fused_matmul, pf.matmul_nt, pf.matmul_tn)
    for k in kernels:
        k.launches = 0
    out["phantom"] = train_rank(pipe, device, kcfg, TRAIN_STEPS)
    out["launches"] = {k.__name__: k.launches for k in kernels}
    gc.collect()
    torch.cuda.empty_cache()
    rss["pipe_phantom"] = _peak_rss_gib()
    out["tensor"] = train_rank(pipe, device, tcfg, PIPE_TENSOR_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    rss["pipe_tensor"] = _peak_rss_gib()
    out["ledger"] = {}
    for name, cfg in (("tensor_col", tcfg), ("phantom", kcfg)):
        for k in kernels:
            k.launches = 0
        measured, predicted = measure_ffn_pipeline_step(
            cfg, pipe, BATCH, steps=ENERGY_STEPS, seed=SEED, device=device)
        out["ledger"][name] = {
            "measured": measured, "predicted": predicted,
            "launches": {k.__name__: k.launches for k in kernels}}
        gc.collect()
        torch.cuda.empty_cache()
    rss["pipe_ledger"] = _peak_rss_gib()
    return out


def _energy_rank(axes, device, smoke=False):
    """The energy phase inside one rank: the ledger probe of the train
    config for ``tensor_col`` and phantom through the kernels
    (``ENERGY_STEPS`` metered steps each) and for phantom through plain
    torch (counted only).  Each run's kernel counts start at 0 and are
    read right after it."""
    import gc
    import torch
    from repro_torch.kernels import phantom_fused as pf
    from repro_torch.launch.train_ffn import BATCH, SEED, train_config
    from repro_torch.telemetry import measure_ffn_step

    kernels = (pf.phantom_fused_matmul, pf.matmul_nt, pf.matmul_tn)
    out = {}
    for name, impl, backend, steps in (
            ("tensor_col", "tensor", "pallas", ENERGY_STEPS),
            ("phantom", "phantom", "pallas", ENERGY_STEPS),
            ("phantom_plain", "phantom", "xla", 0)):
        cfg = train_config(TRAIN_ARCH, smoke=smoke, impl=impl,
                           kernel_backend=backend)
        for k in kernels:
            k.launches = 0
        measured, predicted = measure_ffn_step(cfg, axes, BATCH, steps=steps,
                                               seed=SEED, device=device)
        out[name] = {"measured": measured, "predicted": predicted,
                     "steps": steps,
                     "launches": {k.__name__: k.launches for k in kernels}}
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _matrices(tree):
    """Each leaf of a parameter or gradient tree as the matrices of its
    last two dims (views, named ``path/i``), a vector as itself: the
    paper FFN stacks its layers (and phantom's L its blocks), so no leaf
    of it is a matrix that PowerSGD would compress as it stands."""
    from repro_torch.parallel.params import tree_leaves
    out = {}
    for path, t in tree_leaves(tree):
        if t.dim() <= 2:
            out[path] = t
            continue
        for i, m in enumerate(t.reshape(-1, *t.shape[-2:]).unbind(0)):
            out[f"{path}/{i}"] = m
    return out


def _compress_wire(grads, rank):
    """What one ``compressed_dp_psum`` issues a rank: per matrix of both
    dims at least 2 rank, all-reduces of rank n and rank m floats; per
    other leaf, one of its own size; all over the dp group."""
    out = []
    for _, g in sorted(grads.items()):
        if g.dim() == 2 and min(g.shape) >= 2 * rank:
            out += [rank * g.shape[0], rank * g.shape[1]]
        else:
            out.append(g.numel())
    return [float(n) for n in out]


def _compress_rank(device, smoke=False):
    """PowerSGD in phase 5's ranks, on new groups: paper-ffn-16k phantom
    through the kernels at dp ``COMPRESS_DP`` x tp ``COMPRESS_TP``,
    ``COMPRESS_STEPS`` SGD steps (lr ``COMPRESS_LR``) whose gradients
    reach the other data rank through ``optim/compress.py:
    compressed_dp_psum`` at rank ``COMPRESS_RANK`` with error feedback,
    as ``tests/test_ffn_pipeline.py: test_compressed_dp_training_converges``
    trains the paper FFN, each leaf cut into its matrices
    (``_matrices``); then ``COMPRESS_PLAIN_STEPS`` steps from the same
    start whose gradients are averaged over dp exactly.  Each rank's
    losses, step times and, for the compressed steps, every collective
    ``compressed_dp_psum`` issued."""
    import torch
    from repro_torch.core.ffn import ffn_apply, init_ffn, local_batch
    from repro_torch.data.synthetic import TeacherDataset
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train_ffn import BATCH, train_config
    from repro_torch.optim import SGD
    from repro_torch.optim.compress import (compressed_dp_psum,
                                            init_compress_state)
    from repro_torch.parallel.axes import record_collectives
    from repro_torch.parallel.params import tree_leaves, tree_unflatten

    axes = make_local_mesh(COMPRESS_DP, COMPRESS_TP)
    cfg = train_config(TRAIN_ARCH, smoke=smoke, impl="phantom",
                       kernel_backend="pallas")
    start, _ = init_ffn(cfg, axes, SGD(COMPRESS_LR), SEED, device)
    ds = TeacherDataset(cfg.ffn_width, BATCH, SEED, device)

    def run(steps, compressed):
        params = {k: t.clone() for k, t in tree_leaves(start)}
        q, err = init_compress_state(
            _matrices(tree_unflatten(start, params)), COMPRESS_RANK,
            torch.Generator().manual_seed(SEED))
        losses, step_ms, events = [], [], []
        for s in range(steps):
            x, y = (local_batch(a, axes) for a in ds(s))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            leaves = {k: t.detach().requires_grad_(True)
                      for k, t in params.items()}
            out = ffn_apply(cfg, axes, tree_unflatten(start, leaves), x)
            loss = torch.sum(torch.square(out - y)) / (BATCH * cfg.ffn_width)
            loss.backward()
            grads = tree_unflatten(start, {k: t.grad for k, t in
                                           leaves.items()})
            if compressed:
                mats = _matrices(grads)
                with record_collectives() as log:
                    red, q, err = compressed_dp_psum(mats, q, err, axes,
                                                     rank=COMPRESS_RANK)
                events.append([ev.m_floats for ev in log.events])
                with torch.no_grad():
                    for k, m in mats.items():
                        m.copy_(red[k])
            else:
                grads = {k: axes.dp_comm.all_reduce(g) / axes.dp
                         for k, g in tree_leaves(grads)}
                grads = tree_unflatten(start, grads)
            with torch.no_grad():
                for k, g in tree_leaves(grads):
                    params[k] = params[k] - COMPRESS_LR * g
            losses.append(float(axes.world_comm.all_reduce(loss.detach())))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return {"losses": losses, "step_ms": step_ms, "events": events}

    out = {"rank": axes.rank, "compressed": run(COMPRESS_STEPS, True),
           "plain": run(COMPRESS_PLAIN_STEPS, False)}
    out["compressed"]["want_events"] = _compress_wire(_matrices(start),
                                                      COMPRESS_RANK)
    return out


def _compress_held(ranks):
    """Hold every rank's PowerSGD run: losses finite and falling, each
    step's collectives those of ``_compress_wire``; returns the wire a
    step and the step times."""
    import math
    for r in ranks:
        rk, c = r["compress"]["rank"], r["compress"]["compressed"]
        for name in ("compressed", "plain"):
            losses = r["compress"][name]["losses"]
            check(all(math.isfinite(v) for v in losses),
                  f"compress rank {rk}: non-finite {name} loss {losses}")
        check(c["losses"][-1] < c["losses"][0],
              f"compress rank {rk}: the compressed run's loss did not "
              f"fall: {c['losses']}")
        for s, ev in enumerate(c["events"]):
            check(ev == c["want_events"],
                  f"compress rank {rk}: step {s} issued {ev}, want "
                  f"{c['want_events']} floats")
    c0 = ranks[0]["compress"]
    want = c0["compressed"]["want_events"]
    med = {name: statistics.median(c0[name]["step_ms"][1:])
           for name in ("compressed", "plain")}
    print(f"compress: {TRAIN_ARCH} phantom through the kernels at dp "
          f"{COMPRESS_DP} x tp {COMPRESS_TP}, SGD lr {COMPRESS_LR}, PowerSGD "
          f"rank {COMPRESS_RANK} with error feedback: losses "
          f"{c0['compressed']['losses'][0]:.6f} -> "
          f"{c0['compressed']['losses'][-1]:.6f} in {COMPRESS_STEPS} steps "
          f"(exact dp mean: {c0['plain']['losses'][0]:.6f} -> "
          f"{c0['plain']['losses'][-1]:.6f} in {COMPRESS_PLAIN_STEPS}); "
          f"dp all-reduces a step a rank {len(want)}, "
          f"{sum(want):.0f} floats, as counted on every rank; rank 0's "
          f"step median {med['compressed']:.1f} ms compressed, "
          f"{med['plain']:.1f} ms exact", flush=True)
    return {"floats_per_step": sum(want), "all_reduces_per_step": len(want),
            "median_step_ms": med, "losses": {
                name: c0[name]["losses"] for name in ("compressed", "plain")}}


def phase_train(device="cuda", smoke=False,
                table1_steps=TABLE1["max_steps"]):
    import gc
    import math
    import torch
    from repro_torch.launch.mesh import backend_for, spawn
    world = TRAIN_DP * TRAIN_TP
    gc.collect()
    torch.cuda.empty_cache()
    backend = backend_for("cuda", world)
    print(f"train: {world} ranks (dp={TRAIN_DP}, tp={TRAIN_TP}) on "
          f"{torch.cuda.device_count()} card(s); backend {backend}"
          f"{', card tensors through the host' if backend == 'gloo' else ''}",
          flush=True)
    t0 = time.perf_counter()
    ranks = spawn(_train_rank, TRAIN_DP, TRAIN_TP, device,
                  args=(smoke, table1_steps), timeout_s=900)
    wall = time.perf_counter() - t0
    for r in ranks:
        rk = r["rank"]
        print(f"train: rank {rk} step 1 kernel vs plain: {r['step1']}",
              flush=True)
        for part, diff in r["step1"].items():
            check(diff["outside"] == 0,
                  f"rank {rk}: step-1 {part} of the kernel path differ "
                  f"from the plain path in {diff['outside']} of "
                  f"{diff['elements']} elements: {diff}")
        # the gradients are ~1e-4 and below, so atol 1e-5 alone says
        # little: each leaf is also held to rtol 1e-4 of its largest one
        for key in ("max_scaled_err", "kernel_vs_f64_scaled"):
            check(r["step1"]["grads"][key] <= STEP1_TOL["rtol"],
                  f"rank {rk}: step-1 gradients of the kernel path differ "
                  f"by more than 1e-4 of the largest one ({key}): "
                  f"{r['step1']['grads']}")
        for name in ("phantom", "tensor"):
            losses = r[name]["losses"]
            check(all(math.isfinite(v) for v in losses),
                  f"rank {rk}: non-finite {name} loss")
            check(losses[-1] < losses[0],
                  f"rank {rk}: {name} loss did not fall: {losses}")
        for name, n in r["launches"].items():
            check(n == 2 * TRAIN_STEPS,
                  f"rank {rk}: {name} launched {n} times in {TRAIN_STEPS} "
                  f"steps of {TRAIN_ARCH} (want 2 per step)")
        for key, losses in r["table1"].items():
            check(all(math.isfinite(v) for v in losses),
                  f"rank {rk}: non-finite Table I loss ({key})")
    r0 = ranks[0]
    def worst(part, key):
        return max(r["step1"][part][key] for r in ranks)
    print(f"train: {TRAIN_ARCH} phantom step 1, kernel vs plain, worst over "
          f"ranks (held to rtol 1e-4 / atol 1e-5): loss "
          f"{worst('loss', 'max_abs_err'):.3e}, grads "
          f"{worst('grads', 'max_abs_err'):.3e} "
          f"({worst('grads', 'max_scaled_err'):.3e} of the largest), params "
          f"{worst('params', 'max_abs_err'):.3e}; gradients within 10 eps "
          f"of zero: {worst('params', 'near_zero_grad')} params per rank "
          f"at most, differing by up to "
          f"{worst('params', 'max_abs_err_near_zero_grad'):.3e} (their "
          f"gradients imply up to "
          f"{worst('params', 'max_implied_near_zero_grad'):.3e}; from "
          f"float64 the kernel path differs there by up to "
          f"{worst('params', 'kernel_vs_f64_near_zero_grad'):.3e}, the "
          f"plain path by up to "
          f"{worst('params', 'plain_vs_f64_near_zero_grad'):.3e}); kernel "
          f"path vs float64: grads "
          f"{worst('grads', 'kernel_vs_f64_scaled'):.3e} of the largest, "
          f"params {worst('params', 'kernel_vs_f64'):.3e}", flush=True)
    for name in ("phantom", "tensor"):
        med = [statistics.median(r[name]["step_s"]) * 1e3 for r in ranks]
        losses = r0[name]["losses"]
        print(f"train: {TRAIN_ARCH} {name} {TRAIN_STEPS} steps, loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f}; per-rank step-time "
              f"median (8 ranks time-sharing one card) "
              f"{', '.join(f'{m:.2f}' for m in med)} ms", flush=True)
    print(f"train: launches per rank over {TRAIN_STEPS} steps: "
          f"{r0['launches']} (all ranks equal: "
          f"{all(r['launches'] == r0['launches'] for r in ranks)})")
    table1 = {}
    for key, losses in r0["table1"].items():
        hit = losses[-1] <= TABLE1["target"]
        table1[str(key)] = len(losses) if hit else None
        label = "TP" if key == "tensor" else f"PP k={key}"
        print(f"train: Table I mini-run {label}: "
              f"{len(losses) if hit else 'not reached in ' + str(len(losses))}"
              f" iterations to loss <= {TABLE1['target']} (reference: "
              f"{TABLE1_REFERENCE[key]}; other data and initial weights)")
    compress = _compress_held(ranks)
    print(f"train: phase wall {wall:.1f} s")
    return {"ranks": ranks, "table1_iterations": table1, "wall_s": wall,
            "backend": backend, "compress": compress}


RATIO_KEYS = ("flops_per_device", "collective_wire_bytes_per_device",
              "collective_m_floats", "energy_j_per_iter")


def phase_energy(train, smi):
    """Hold and print the ranks' ledger probes (``_energy_rank``), price
    the Table I run's iteration counts, write the ledger."""
    from repro_torch.benchmarks import table1_energy
    from repro_torch.telemetry import Ledger, LedgerEntry
    ranks = train["ranks"]
    probe_steps = 1 + 1 + ENERGY_STEPS     # counted, warm-up, metered
    for r in ranks:
        rk, e = r["rank"], r["energy"]
        for name, pin in FLOPS_PIN.items():
            m, pr = e[name]["measured"], e[name]["predicted"]
            for key in ("collective_wire_bytes_per_device",
                        "collective_m_floats"):
                check(abs(m[key] / pr[key] - 1) <= 0.02,
                      f"rank {rk}: {name} {key} measured {m[key]} vs "
                      f"predicted {pr[key]}: ratio outside 1.00 +- 2%")
            ratio = m["flops_per_device"] / pr["flops_per_device"]
            check(abs(ratio - 1) <= pin and ratio >= 0.99,
                  f"rank {rk}: {name} flops ratio {ratio:.4f} outside "
                  f"[0.99, {1 + pin}]")
        kernel, plain = (e[n]["measured"] for n in ("phantom",
                                                    "phantom_plain"))
        check(kernel["flops_per_device"] == plain["flops_per_device"],
              f"rank {rk}: the kernel path counts "
              f"{kernel['flops_per_device']} flops, the plain path "
              f"{plain['flops_per_device']}")
        for name, launches in e["phantom"]["launches"].items():
            check(launches == 2 * probe_steps,
                  f"rank {rk}: {name} launched {launches} times in "
                  f"{probe_steps} probe steps (want 2 per step)")
        for name in ("tensor_col", "phantom_plain"):
            check(not any(e[name]["launches"].values()),
                  f"rank {rk}: {name} launched a phantom kernel: "
                  f"{e[name]['launches']}")

    ledger = Ledger(run="chip_smoke", meta={"card": smi,
                                           "arch": TRAIN_ARCH})
    e0 = ranks[0]["energy"]
    for name in ("tensor_col", "phantom", "phantom_plain"):
        m, pr = e0[name]["measured"], e0[name]["predicted"]
        entry = ledger.record(LedgerEntry(
            name=f"chip_smoke_energy_{name}", suite="chip_smoke",
            kind="train", arch=TRAIN_ARCH, impl=pr["strategy"], p=TRAIN_TP,
            measured=m, predicted=pr,
            extra={"dp": TRAIN_DP, "tp": TRAIN_TP,
                   "kernel_backend": "xla" if name == "phantom_plain"
                   else "pallas", "metered_steps": e0[name]["steps"],
                   "launches": e0[name]["launches"],
                   "wall_us_median_by_rank": [
                       r["energy"][name]["measured"].get("wall_us_median")
                       for r in ranks]}))
        ratios = entry.ratios()
        print(f"energy: {TRAIN_ARCH} {name} (rank 0), measured / predicted "
              f"/ ratio: " + "; ".join(
                  f"{k} {m[k]:.6g} / {pr[k]:.6g} / {ratios[k]:.6f}"
                  for k in RATIO_KEYS), flush=True)
        print(f"energy: {name} alpha_s {m['alpha_s']:.6g} (predicted "
              f"{pr['alpha_s']:.6g}), beta_s {m['beta_s']:.6g} (predicted "
              f"{pr['beta_s']:.6g}); collectives " + "; ".join(
                  f"{op} x{rec['count']} issued as {rec['issued_as']}"
                  for op, rec in m["collectives"].items()))
        if e0[name]["steps"]:
            print(f"energy: {name} probe step wall median per rank "
                  f"(8 ranks time-sharing one card, gloo through the host) "
                  + ", ".join(f"{w / 1e3:.2f}" for w in
                              entry.extra["wall_us_median_by_rank"])
                  + " ms", flush=True)
    print(f"energy: phantom launches per rank in {probe_steps} probe steps: "
          f"{e0['phantom']['launches']}; kernel path flops == plain path "
          f"flops on all ranks")
    pe, pt = (e0[n]["predicted"]["energy_j_per_iter"]
              for n in ("phantom", "tensor_col"))
    me, mt = (e0[n]["measured"]["energy_j_per_iter"]
              for n in ("phantom", "tensor_col"))
    print(f"energy: phantom / tensor_col energy per iteration, predicted "
          f"{pe / pt:.4f}, measured {me / mt:.4f} (paper's model, Frontier "
          f"A/B, alpha at the H100 fp32 peak; not power read from the card)")

    iters = {("tensor" if key == "tensor" else int(key)): len(losses)
             for key, losses in ranks[0]["table1"].items()}
    rows = table1_energy.run(ledger, iters)
    for row in rows:
        print(f"energy: Table I priced, p={row['p']} k={row['k']}: E_tp "
              f"{row['energy_j_tp']:.1f} J, E_pp {row['energy_j_pp']:.1f} J, "
              f"saving {row['saving_fraction'] * 100:.1f}% (iterations "
              f"{iters})", flush=True)
    print(f"energy: the probes took "
          f"{max(r['energy_s'] for r in ranks):.1f} s in the ranks")
    return ledger


def phase_pipeline(train, ledger, smoke=False):
    """Hold and print the ranks' pipeline phase (``_pipeline_rank``):
    step 1 against the plain path and the sequential reference, the 20
    pipelined steps and their launches, the pipelined probe's ledger
    (recorded into ``ledger``).  ``smoke``: the ranks ran the configs'
    CPU geometry."""
    import math
    from repro_torch.benchmarks.pipeline_smoke import boundary_bytes
    from repro_torch.launch.train_ffn import BATCH, train_config
    from repro_torch.telemetry import LedgerEntry
    ranks = [r["pipeline"] for r in train["ranks"]]
    cfg = train_config(TRAIN_ARCH, smoke=smoke, pp=PIPE_PP,
                       microbatches=PIPE_M)
    L_loc = cfg.num_layers // PIPE_PP
    probe_steps = 1 + 1 + ENERGY_STEPS     # counted, warm-up, metered
    for r in ranks:
        rk, s = r["rank"], r["stage"]
        for part, diff in r["step1"].items():
            check(diff["outside"] == 0,
                  f"pipeline rank {rk}: step-1 {part} of the kernel path "
                  f"differ from the plain path in {diff['outside']} of "
                  f"{diff['elements']} elements: {diff}")
        for key in ("max_scaled_err", "kernel_vs_f64_scaled"):
            check(r["step1"]["grads"][key] <= STEP1_TOL["rtol"],
                  f"pipeline rank {rk}: step-1 gradients of the kernel "
                  f"path differ by more than 1e-4 of the largest one "
                  f"({key}): {r['step1']['grads']}")
        eq = r["equivalence"]
        check(eq["loss_rel"] <= EQUIV_LOSS_RTOL and eq["grads_outside"] == 0
              and eq["x_grad_outside"] == 0,
              f"pipeline rank {rk}: the pipelined probe differs from the "
              f"stages run in sequence (loss rtol 2e-4, gradients rtol "
              f"5e-4 / atol 1e-6): {eq}")
        for name in ("phantom", "tensor"):
            losses = r[name]["losses"]
            check(all(math.isfinite(v) for v in losses),
                  f"pipeline rank {rk}: non-finite {name} loss")
            check(losses[-1] < losses[0],
                  f"pipeline rank {rk}: {name} loss did not fall: {losses}")
        for name, n in r["launches"].items():
            check(n == PIPE_M * L_loc * TRAIN_STEPS,
                  f"pipeline rank {rk}: {name} launched {n} times in "
                  f"{TRAIN_STEPS} steps (want M x L_loc = "
                  f"{PIPE_M * L_loc} per step)")
        for name, pin in FLOPS_PIN.items():
            e = r["ledger"][name]
            m, pr = e["measured"], e["predicted"]
            want = boundary_bytes(cfg, PIPE_PP, PIPE_DP, PIPE_TP, s, BATCH)
            check(m["stage"] == s and
                  m["boundary_wire_bytes_per_device"] == want,
                  f"pipeline rank {rk} (stage {s}): {name} boundary bytes "
                  f"{m['boundary_wire_bytes_per_device']}, its stage sends "
                  f"{want}")
            ratio = m["flops_per_device"] / pr["flops_per_device"]
            check(abs(ratio - 1) <= pin and ratio >= 0.99,
                  f"pipeline rank {rk}: {name} flops ratio {ratio:.4f} "
                  f"outside [0.99, {1 + pin}] of executed=False")
            layer = (m["collective_wire_bytes_per_device"]
                     - m["boundary_wire_bytes_per_device"])
            layer_pr = (pr["collective_wire_bytes_per_device"]
                        - pr["boundary_wire_bytes_per_device"])
            check(abs(layer / layer_pr - 1) <= 0.02,
                  f"pipeline rank {rk}: {name} layer wire bytes {layer} vs "
                  f"executed=False {layer_pr}: outside 1.00 +- 2%")
            check(pr["executed"] is False and
                  abs(pr["bubble_fraction"] - (PIPE_PP - 1)
                      / (PIPE_M + PIPE_PP - 1)) < 1e-12,
                  f"pipeline: prediction {pr['executed']} "
                  f"{pr['bubble_fraction']}")
        for name, launches in r["ledger"]["phantom"]["launches"].items():
            check(launches == PIPE_M * L_loc * probe_steps,
                  f"pipeline rank {rk}: {name} launched {launches} times in "
                  f"{probe_steps} probe steps (want {PIPE_M * L_loc} each)")
        check(not any(r["ledger"]["tensor_col"]["launches"].values()),
              f"pipeline rank {rk}: tensor_col launched a phantom kernel")

    def worst(part, key):
        return max(r["step1"][part][key] for r in ranks)
    print(f"pipeline: {TRAIN_ARCH} pipe {PIPE_PP} x dp {PIPE_DP} x tp "
          f"{PIPE_TP}, M = {PIPE_M}, phantom step 1 kernel vs plain, worst "
          f"over ranks (rtol 1e-4 / atol 1e-5): loss "
          f"{worst('loss', 'max_abs_err'):.3e}, grads "
          f"{worst('grads', 'max_abs_err'):.3e} "
          f"({worst('grads', 'max_scaled_err'):.3e} of the largest), params "
          f"{worst('params', 'max_abs_err'):.3e} (gradients within 10 eps "
          f"of zero: {worst('params', 'near_zero_grad')} params per rank at "
          f"most); kernel path vs float64: grads "
          f"{worst('grads', 'kernel_vs_f64_scaled'):.3e} of the largest",
          flush=True)
    eqs = [r["equivalence"] for r in ranks]
    print(f"pipeline: pipelined probe vs the stages in sequence on pipe 1 x "
          f"dp 4 x tp 2, same global weights: loss {eqs[0]['loss_pipe']:.8f}"
          f" vs {eqs[0]['loss_flat']:.8f} (rel {eqs[0]['loss_rel']:.3e}); "
          f"worst over ranks grads {max(e['grads_max_abs'] for e in eqs):.3e}"
          f", input grads {max(e['x_grad_max_abs'] for e in eqs):.3e}; "
          f"outside rtol 5e-4 / atol 1e-6: "
          f"{sum(e['grads_outside'] + e['x_grad_outside'] for e in eqs)}",
          flush=True)
    pp1 = train["ranks"]
    for name in ("phantom", "tensor"):
        med = [statistics.median(r[name]["step_s"]) * 1e3 for r in ranks]
        flat = [statistics.median(r[name]["step_s"]) * 1e3 for r in pp1]
        losses = ranks[0][name]["losses"]
        print(f"pipeline: {name} {len(losses)} pipelined steps, loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f}; per-rank step median "
              f"{', '.join(f'{m:.2f}' for m in med)} ms (pp = 1, dp 1 x tp "
              f"8: {', '.join(f'{m:.2f}' for m in flat)} ms); initial draw "
              f"on the host {max(r[name]['init_s'] for r in ranks):.2f} s "
              f"(pp = 1: {max(r[name]['init_s'] for r in pp1):.2f} s) at "
              f"most", flush=True)
    print(f"pipeline: launches per rank over {TRAIN_STEPS} steps: "
          f"{ranks[0]['launches']} (all ranks equal: "
          f"{all(r['launches'] == ranks[0]['launches'] for r in ranks)})")
    rss = {part: max(r["peak_rss_gib"][part] for r in train["ranks"])
           for part in train["ranks"][0]["peak_rss_gib"]}
    print("train and pipeline: peak host memory of a rank (ru_maxrss, the "
          "largest over ranks) after each part, GiB: " + ", ".join(
              f"{part} {v:.2f}" for part, v in rss.items()), flush=True)
    for name in ("tensor_col", "phantom"):
        by_stage = {}
        for r in ranks:
            by_stage.setdefault(r["stage"], r)
        for s, r in sorted(by_stage.items()):
            m, pr = (r["ledger"][name][k] for k in ("measured", "predicted"))
            entry = ledger.record(LedgerEntry(
                name=f"chip_smoke_pipeline_{name}_stage{s}",
                suite="chip_smoke", kind="train", arch=TRAIN_ARCH,
                impl=pr["strategy"], p=PIPE_TP, measured=m, predicted=pr,
                extra={"pp": PIPE_PP, "dp": PIPE_DP, "tp": PIPE_TP,
                       "microbatches": PIPE_M, "stage": s,
                       "metered_steps": ENERGY_STEPS,
                       "launches": r["ledger"][name]["launches"]}))
            ratios = entry.ratios()
            print(f"pipeline ledger: {name} stage {s} (rank {r['rank']}), "
                  f"measured / executed=False / ratio: " + "; ".join(
                      f"{k} {m[k]:.6g} / {pr[k]:.6g} / {ratios[k]:.6f}"
                      for k in ("flops_per_device",
                                "collective_wire_bytes_per_device",
                                "boundary_wire_bytes_per_device",
                                "collective_m_floats"))
                  + f"; probe step wall median "
                  f"{m['wall_us_median'] / 1e3:.2f} ms; bubble fraction "
                  f"{pr['bubble_fraction']:.3f}", flush=True)
    took = max(r["pipeline_s"] for r in train["ranks"])
    print(f"pipeline: the phase took {took:.1f} s in the ranks")
    return {"ranks": ranks, "peak_rss_gib": rss,
            "launches": ranks[0]["launches"]}


def _lm_flash(gen):
    """(a): the flash kernel at the training shapes against its plain
    version, timed as in phase 2; hd=96 bf16 also with a cold L2."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    results = []
    for B, S, H, KV, hd in LM_FLASH_SHAPES:
        for dtype in ("bfloat16", "float32"):
            r = _case(B, S, H, KV, hd, True, dtype, gen)
            results.append(r)
            print(f"lm_train: flash_attention B={B} S={S} H={H} KV={KV} "
                  f"hd={hd} {dtype} causal: max_abs_err="
                  f"{r['max_abs_err']:.3e}"
                  + ("" if r["max_rel_err"] is None else
                     f" (of sum p|v|: {r['max_rel_err']:.3e})")
                  + f" ok={r['ok']} ms={r['ms']:.4f} bound_ms="
                  f"{r['bound_ms']:.5f} ({r['bound_by']}) plain_ms="
                  f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f}",
                  flush=True)
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"flash_attention disagrees with its plain version at "
                   f"the training shapes: {bad}")
    B, S, H, KV, hd = LM_FLASH_SHAPES[0]
    nbytes = sum(t.numel() * 2 for t in _flash_inputs(S, gen, B, H, KV, hd))

    def kern():
        q, k, v = _flash_inputs(S, gen, B, H, KV, hd)
        return lambda: flash_attention(q, k, v, causal=True)

    def lib():
        q, k, v = (t.transpose(1, 2) for t in _flash_inputs(S, gen, B, H,
                                                            KV, hd))
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)
    cold = {"cold_ms": cold_ms(kern, nbytes),
            "library_cold_ms": cold_ms(lib, nbytes)}
    print(f"lm_train: flash_attention bf16 hd={hd} training shape, cold "
          f"L2: ms={cold['cold_ms']:.4f} library_ms="
          f"{cold['library_cold_ms']:.4f}", flush=True)
    return {"sweep": results, "cold": cold}


def _lm_step1(base):
    """(b): step 1 of ``base`` cut to ``LM_PARITY_LAYERS`` layers, kernel
    path against plain path from one draw cloned, in float32 (loss,
    clipped gradients, parameters: ``_step1_diff``), and the bf16 loss of
    both paths."""
    import gc
    import torch
    from repro_torch.configs.base import with_kernel_backend
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import forward_train, model_decls
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize, tree_map
    from repro_torch.train.trainer import make_train_step

    cut = base.replace(num_layers=LM_PARITY_LAYERS)
    axes = MeshAxes()
    params = materialize(model_decls(cut, axes), torch.Generator(
        device="cuda").manual_seed(SEED), "cuda")
    batch = LMDataset(cut.vocab_size, LM_BATCH, LM_SEQ + 1,
                      device="cuda")(0)
    sched = warmup_cosine(3e-4, 20, LM_STEPS)
    res, launches = {}, {}
    for name, backend in (("kernel", "auto"), ("plain", "xla")):
        cfg = with_kernel_backend(cut.replace(dtype="float32"), backend)
        opt = make_optimizer(cfg.optimizer, sched, weight_decay=0.1)
        seen = []
        update = opt.update

        def recording(g, s, p, step, update=update, seen=seen):
            seen.append(g)
            return update(g, s, p, step)
        opt.update = recording
        step_fn, _, _ = make_train_step(cfg, axes, opt, device="cuda")
        p = tree_map(torch.clone, params)
        flash_attention.launches = 0
        p, _, m = step_fn(p, opt.init(p), 0, batch)
        torch.cuda.synchronize()
        launches[name] = flash_attention.launches
        res[name] = {"loss": m["loss"], "grads": seen[0], "params": p,
                     "grad_norm": float(m["grad_norm"])}
    out = {part: _step1_diff(res, part, sched(0), opt.eps)
           for part in ("loss", "grads", "params")}
    out.update(launches=launches,
               loss={**out["loss"], "kernel": float(res["kernel"]["loss"]),
                     "plain": float(res["plain"]["loss"])},
               grad_norm={n: res[n]["grad_norm"] for n in res})
    del res
    gc.collect()
    bf16 = {}
    with torch.no_grad():
        for name, backend in (("kernel", "auto"), ("plain", "xla")):
            flash_attention.launches = 0
            sl, nv, _ = forward_train(with_kernel_backend(cut, backend),
                                      axes, params, batch)
            bf16[name] = float(sl / nv)
            launches[f"{name}_bf16_forward"] = flash_attention.launches
    bf16["rel"] = abs(bf16["kernel"] - bf16["plain"]) / abs(bf16["plain"])
    out["bf16_loss"] = bf16
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _profile_train_step(trainer, state):
    """One more step of the trainer under ``torch.profiler``: the wall
    time, the device time of its kernels and copies (busy share), the
    flash kernel's part and the top kernels.  The profiler files the
    time a gloo ``isend`` waits for its receiver (``gloo:send``, a
    pipeline's boundary sends) under the card; it is host time, and is
    reported apart (``gloo_send_ms``), outside the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = trainer.run(state, state.step + 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    gloo_send_ms = sum(e.self_device_time_total for e in events
                       if e.key.startswith("gloo:")) / 1e3
    events = [e for e in events if not e.key.startswith("gloo:")]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3

    def kind(key):
        k = key.lower()
        if "flash_mma_kernel" in k:
            return "flash"
        if any(n in k for n in ("splitk_kernel", "tn_kernel", "wgmma_")):
            return "phantom"
        if "memcpy" in k:
            return "copies"
        if any(w in k for w in ("gemm", "nvjet", "cutlass", "xmma")):
            return "gemm"
        return "other"
    by_kind = {"flash": 0.0, "phantom": 0.0, "gemm": 0.0, "copies": 0.0,
               "other": 0.0}
    for e in events:
        by_kind[kind(e.key)] += e.self_device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return state, {
        "wall_ms": wall_ms, "device_ms": device_ms or None,
        "device_busy_share": device_ms / wall_ms if device_ms else None,
        "device_ms_by_kind": by_kind if device_ms else None,
        "flash_share_of_device": (by_kind["flash"] / device_ms
                                  if device_ms else None),
        "device_ops": sum(e.count for e in events),
        "gloo_send_ms": gloo_send_ms,
        "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                          for e in top}}


def _time_optimizer(trainer, state):
    """Device ms of one ``optimizer.update`` of the whole model (the
    in-place AdamW) on zero gradients, after the main path."""
    import torch
    from repro_torch.parallel.params import tree_map
    grads = tree_map(torch.zeros_like, state.params)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    trainer.optimizer.update(grads, state.opt_state, state.params,
                             state.step)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_lm_train():
    import gc
    import math
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import (build_parser, make_trainer,
                                          train_config)
    from repro_torch.parallel.axes import MeshAxes
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flash = _lm_flash(gen)
    args = build_parser().parse_args([
        "--arch", LM_ARCH, "--full", "--kernel-backend", "auto", "--steps",
        str(LM_STEPS), "--batch", str(LM_BATCH), "--seq", str(LM_SEQ),
        "--seed", str(SEED)])
    cfg = train_config(args)
    check(cfg.remat == "full" and cfg.dtype == "bfloat16",
          f"{cfg.name}: remat {cfg.remat}, dtype {cfg.dtype}")

    step1 = _lm_step1(cfg)
    print(f"lm_train: {cfg.name} at {LM_PARITY_LAYERS} layers, step 1 "
          f"kernel vs plain in float32 (rtol 1e-4 / atol 1e-5): {step1}",
          flush=True)
    for part in ("loss", "grads", "params"):
        check(step1[part]["outside"] == 0,
              f"lm_train: step-1 {part} of the kernel path differ from the "
              f"plain path: {step1[part]}")
    check(step1["grads"]["max_scaled_err"] <= STEP1_TOL["rtol"],
          f"lm_train: step-1 gradients differ by more than 1e-4 of the "
          f"largest: {step1['grads']}")
    check(step1["launches"] == {
        "kernel": 2 * LM_PARITY_LAYERS, "plain": 0,
        "kernel_bf16_forward": LM_PARITY_LAYERS, "plain_bf16_forward": 0},
        f"lm_train: step-1 flash launches {step1['launches']}")
    check(step1["bf16_loss"]["rel"] <= LM_BF16_LOSS_RTOL,
          f"lm_train: bf16 step-1 loss, kernel vs plain: "
          f"{step1['bf16_loss']} (rtol {LM_BF16_LOSS_RTOL})")

    # --- the main path: counts from zero, read right after -------------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = make_trainer(MeshAxes(), torch.device("cuda"), cfg, args)
    t0 = time.perf_counter()
    state = trainer.init_state(args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9
    flash_attention.launches = 0
    state = trainer.run(state, LM_STEPS)
    launches = flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9

    losses = [h["loss"] for h in trainer.history]
    gnorms = [h["grad_norm"] for h in trainer.history]
    step_ms = [t / 1e3 for t in trainer.meter.times_us]
    med_ms = statistics.median(step_ms[1:])
    tokens = LM_BATCH * LM_SEQ
    n_params = sum(t.numel() for t in _leaves(state.params))
    check(all(math.isfinite(v) for v in losses + gnorms),
          f"lm_train: non-finite loss or gradient norm: {losses} {gnorms}")
    check(launches == 2 * cfg.num_layers * LM_STEPS,
          f"lm_train: flash kernel launched {launches} times in {LM_STEPS} "
          f"steps of {cfg.num_layers} layers (want forward + recompute)")
    print(f"lm_train: {cfg.name} d={cfg.d_model} layers={cfg.num_layers} "
          f"params={n_params:,} batch {LM_BATCH} x seq {LM_SEQ} "
          f"remat={cfg.remat}: losses {[round(v, 4) for v in losses]}, "
          f"grad norms {[round(v, 3) for v in gnorms]}", flush=True)
    print(f"lm_train: step ms {[round(v, 2) for v in step_ms]}; median "
          f"after the first {med_ms:.2f} ms, {tokens / med_ms * 1e3:.0f} "
          f"tokens/s; flash launches {launches} ({launches // LM_STEPS} per "
          f"step); initial draw on the card {init_s:.2f} s; card memory: "
          f"parameters and AdamW state {state_gb:.2f} GB, peak "
          f"{peak_gb:.2f} GB of {total_gb:.2f} GB", flush=True)
    state, prof = _profile_train_step(trainer, state)
    print(f"lm_train: profiled step: wall {prof['wall_ms']:.2f} ms, device "
          f"{prof['device_ms']} ms, busy share {prof['device_busy_share']}, "
          f"device ms by kind {prof['device_ms_by_kind']} (flash "
          f"{prof['flash_share_of_device']} of the device time), "
          f"{prof['device_ops']} device ops; top: "
          f"{ {k: round(v, 3) for k, v in prof['top_device_ms'].items()} }",
          flush=True)
    prof["optimizer_ms"] = _time_optimizer(trainer, state)
    print(f"lm_train: one in-place AdamW update of the {n_params:,} "
          f"parameters: {prof['optimizer_ms']:.2f} ms", flush=True)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash": flash, "step1": step1, "arch": cfg.name,
            "layers": cfg.num_layers, "params": n_params,
            "batch": LM_BATCH, "seq": LM_SEQ, "losses": losses,
            "grad_norms": gnorms, "step_ms": step_ms,
            "median_step_ms": med_ms,
            "tokens_per_s": tokens / med_ms * 1e3, "launches": launches,
            "init_s": init_s, "state_memory_gb": state_gb,
            "peak_memory_gb": peak_gb, "card_memory_gb": total_gb,
            "profile": prof}


def _lm_args(extra, arch=LM_ARCH):
    """``launch/train.py``'s flags for ``arch`` (phi3-mini) at ``LM_TP``
    ranks, batch ``LM_BATCH`` x seq ``LM_SEQ``."""
    from repro_torch.launch.train import build_parser
    return build_parser().parse_args(
        ["--arch", arch, "--full", "--kernel-backend", "auto",
         "--batch", str(LM_BATCH), "--seq", str(LM_SEQ), "--seed",
         str(SEED), "--tp", str(LM_TP)] + extra)


def _kernel_counts(reset=False):
    """The launch counts of the flash kernel and the three phantom
    kernels (``reset``: set them to 0 first)."""
    from repro_torch.kernels import phantom_fused as pf
    from repro_torch.kernels.flash_attention import flash_attention
    kernels = (flash_attention, pf.phantom_fused_matmul, pf.matmul_nt,
               pf.matmul_tn)
    if reset:
        for k in kernels:
            k.launches = 0
    return {k.__name__: k.launches for k in kernels}


def _tp_step1(cfg, axes, device, params, batch, sched, microbatches=1):
    """One step of ``cfg`` on ``axes`` from a clone of ``params`` with
    ``cfg.optimizer`` (AdamW or Adafactor, in place): the loss, the
    clipped gradients the optimizer got, the updated parameters, the
    launches and the optimizer's eps."""
    import torch
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel.params import tree_map
    from repro_torch.train.trainer import make_train_step
    opt = make_optimizer(cfg.optimizer, sched, weight_decay=0.1)
    seen = []
    update = opt.update

    def recording(g, s, p, step):
        seen.append(g)
        return update(g, s, p, step)
    opt.update = recording
    step_fn, _, _ = make_train_step(cfg, axes, opt, device=device,
                                    microbatches=microbatches)
    p = tree_map(torch.clone, params)
    _kernel_counts(reset=True)
    p, _, m = step_fn(p, opt.init(p), 0, batch)
    torch.cuda.synchronize()
    return ({"loss": m["loss"], "grads": seen[0], "params": p},
            _kernel_counts(), opt.eps)


def _run_ranks(pool, fn, dp, tp, device="cuda", pp=1, args=(),
               timeout_s=900):
    """``fn(axes, device, *args)`` on ``pool``'s ranks when it has
    ``pp * dp * tp`` of them (``launch/mesh.py: RankPool``), else on new
    ranks (``spawn``: a phase run alone, or a mesh of another size)."""
    from repro_torch.launch.mesh import spawn
    if pool is not None and pool.world == pp * dp * tp:
        return pool.run(fn, dp, tp, args, pp=pp, timeout_s=timeout_s)
    return spawn(fn, dp, tp, device, args=args, timeout_s=timeout_s, pp=pp)


def _free():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _lm_tp_profile(trainer, state, axes):
    """One more step on every rank with its collectives timed
    (``record_collectives(timed=True)``: the host ms in each and in the
    wait for the card before it); rank 0 also under ``torch.profiler``
    (``_profile_train_step``: device time by kind)."""
    import torch
    from repro_torch.parallel.axes import record_collectives
    with record_collectives(timed=True) as clock:
        if axes.rank == 0:
            state, prof = _profile_train_step(trainer, state)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = trainer.run(state, state.step + 1)
            torch.cuda.synchronize()
            prof = {"wall_ms": (time.perf_counter() - t0) * 1e3}
    prof.update(calls=clock.calls, device_wait_ms=clock.device_wait_ms,
                collective_ms=clock.collective_ms)
    return state, prof


def _lm_tp_train(axes, device, cfg, args, steps, profile=False,
                 dataset=None, watchdog_s=None):
    """``launch/train.py``'s trainer on this rank for ``steps`` steps (on
    ``dataset``'s batches where given, else the launcher's), kernel
    counts from 0 just before the run and read just after, the
    collectives logged: step times, losses, launches, wire bytes per
    step by collective, the rank's peak memory and the card's used
    memory; ``profile`` adds one step of ``_lm_tp_profile`` after the
    run.  With ``--ckpt-dir`` in ``args`` the trainer also saves step 1
    (``_lm_ckpt_save``) and, after the run, a fresh trainer restores it
    and reruns step 2 (``_lm_ckpt_resume``).  With ``--profile-dir`` the
    trainer's watchdog (``launch/train.py: make_trainer``) predicts
    ``watchdog_s`` a step; its summary and its capture's kernels
    (``_capture_kernels``) come back."""
    import torch
    from repro_torch.launch.train import make_trainer
    from repro_torch.parallel.axes import record_collectives
    from repro_torch.telemetry.counted import collective_costs
    trainer = make_trainer(axes, device, cfg, args, dataset=dataset)
    wd = trainer.watchdog
    if wd is not None:
        wd.predicted_s = watchdog_s
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(args.seed)
    ckpt = None
    _kernel_counts(reset=True)
    with record_collectives() as log:
        if trainer.checkpoints is not None:
            state = trainer.run(state, 1)
            ckpt = _lm_ckpt_save(trainer, state)
        state = trainer.run(state, steps)
    launches = _kernel_counts()
    per_op = collective_costs(log.events)
    out = {"step_ms": [t / 1e3 for t in trainer.meter.times_us],
           "losses": [h["loss"] for h in trainer.history],
           "grad_norms": [h["grad_norm"] for h in trainer.history],
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "wire_bytes_per_step": sum(r["wire_bytes"]
                                      for r in per_op.values()) / steps,
           "collectives_per_step": {
               k: {"count": r["count"] / steps,
                   "wire_bytes": r["wire_bytes"] / steps}
               for k, r in per_op.items()},
           "params_local": sum(t.numel() for t in _leaves(state.params)),
           "state_bytes": sum(t.numel() * t.element_size() for t in
                              list(_leaves(state.params))
                              + list(_leaves(state.opt_state)))}
    free, total = torch.cuda.mem_get_info()
    out.update(peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               card_used_gb=(total - free) / 1e9)
    if wd is not None:
        out["watchdog"] = wd.summary()
        if wd.captures:
            out["capture"] = _capture_kernels(
                Path(wd.captures[-1]) / f"rank{axes.rank}.json")
    if ckpt is not None:
        out["checkpoint"] = _lm_ckpt_resume(axes, device, cfg, args,
                                            trainer, state, ckpt)
    if profile:
        state, out["profile"] = _lm_tp_profile(trainer, state, axes)
    del trainer, state
    _free()
    return out


CAPTURED_KERNELS = {"flash_attention": "flash_mma_kernel",
                    "splitk": "splitk_kernel", "matmul_tn": "tn_kernel",
                    **dict(zip(("wgmma_fwd", "wgmma_dgrad", "wgmma_wgrad"),
                               WGMMA_KERNELS))}


def _capture_kernels(path):
    """A watchdog capture's CUDA kernels (``torch.profiler``'s Chrome
    trace, ``cat`` "kernel"), counted by their CUDA names; the file's
    bytes and events."""
    doc = json.loads(Path(path).read_text())
    names = [e.get("name", "") for e in doc.get("traceEvents", [])
             if e.get("cat") == "kernel"]
    return {"kernels": {k: sum(cuda in n for n in names)
                        for k, cuda in CAPTURED_KERNELS.items()},
            "kernel_events": len(names),
            "events": len(doc.get("traceEvents", [])),
            "bytes": Path(path).stat().st_size}


def _lm_ckpt_save(trainer, state):
    """The trainer's checkpoint of ``state`` (step 1): each rank's blocks
    of the global parameters and AdamW moments, queued (copied to the
    host) and flushed to its commit; this rank's seconds and bytes."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save_async(state)
    trainer.checkpoints.flush()
    return {"write_s": time.perf_counter() - t0,
            "io": trainer.checkpoints.io_stats()}


def _decl_bytes(tree):
    import torch
    from repro_torch.parallel.params import tree_leaves
    return sum(math.prod(d.shape) * torch.empty((), dtype=d.dtype)
               .element_size() for _, d in tree_leaves(tree))


def _lm_ckpt_resume(axes, device, cfg, args, trainer, state, ckpt):
    """(a) of the elastic phase: a fresh trainer restores the step-1
    checkpoint (``restore_or_init``) and reruns step 2; its loss and
    parameter shards against the uninterrupted step 2's (``trainer``'s,
    ``state``), its launches, the checkpoint's bytes against the decls'
    global bytes (parameters and both AdamW moments), the write and read
    seconds; the checkpoint is removed after."""
    import shutil
    import torch
    from repro_torch.launch.train import make_trainer
    from repro_torch.parallel.params import tree_leaves
    fresh = make_trainer(axes, device, cfg, args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = fresh.restore_or_init(args.seed)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    _kernel_counts(reset=True)
    resumed = fresh.run(restored, 2)
    launches = _kernel_counts()
    bitwise, rel = True, 0.0
    for (_, a), (_, b) in zip(tree_leaves(resumed.params),
                              tree_leaves(state.params)):
        bitwise = bitwise and torch.equal(a, b)
        scale = b.abs().max().clamp_min(1e-30)
        rel = max(rel, float((a.float() - b.float()).abs().max() / scale))
    want, got = trainer.history[1]["loss"], fresh.history[0]["loss"]
    out = {"restored_step": restored.step, "read_s": read_s,
           "write_s": ckpt["write_s"], "io": ckpt["io"],
           "decl_bytes": (_decl_bytes(trainer.decls)
                          + _decl_bytes(trainer.opt_decls)),
           "loss": got, "loss_uninterrupted": want,
           "loss_rel_err": abs(got - want) / abs(want),
           "params_bitwise": bitwise, "params_max_rel_err": rel,
           "launches": launches}
    del fresh, restored, resumed
    _free()
    axes.world_comm.unrecorded().all_reduce(torch.zeros(1, device=device))
    if axes.rank == 0:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    return out


def _lm_tp_rank(axes, device):
    """``phase_lm_train_tp`` inside one of the ``LM_TP`` ranks sharing
    the card: (a) step 1 kernels against plain at tp = 4, phantom, fp32,
    ``LM_PARITY_LAYERS`` layers; (b) dense (``sp``) at tp = 4 against
    tp = 1 from the same seed, each rank holding its shard of the tp = 1
    run.  (c), the main path, is the job ``_lm_tp_main``, traced; (d) the
    job ``_lm_tp_compare``."""
    from repro_torch.configs.base import (dense_projection_map,
                                          with_kernel_backend)
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.launch.train import train_config
    from repro_torch.models.model import model_decls
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize_shards, shard_params

    out = {"rank": axes.rank, "backend": axes.world_comm.backend}
    args = _lm_args(["--steps", str(LM_STEPS)])
    base = train_config(args).replace(num_layers=LM_TP_LAYERS)
    cut = base.replace(num_layers=LM_PARITY_LAYERS, dtype="float32")
    batch = LMDataset(cut.vocab_size, args.batch, args.seq + 1,
                      device=device)(0)
    sched = warmup_cosine(3e-4, 20, LM_STEPS)

    # (a) kernels against plain, phantom sites at tp = 4, float32
    params = materialize_shards(model_decls(cut, axes), axes, SEED, device,
                                draw_on=device)
    res, launches = {}, {}
    for name, backend in (("kernel", "auto"), ("plain", "xla")):
        res[name], launches[name], eps = _tp_step1(
            with_kernel_backend(cut, backend), axes, device, params, batch,
            sched)
    out["kernel_vs_plain"] = {
        part: _step1_diff(res, part, sched(0), eps)
        for part in ("loss", "grads", "params")}
    out["kernel_vs_plain"]["launches"] = launches
    out["kernel_vs_plain"]["loss_values"] = {
        n: float(r["loss"]) for n, r in res.items()}
    del params, res
    _free()

    # (b) the sp layout at tp = 4 against tp = 1, dense sites, float32
    dense = with_kernel_backend(cut.replace(
        projections=dense_projection_map()), "auto")
    decls = model_decls(dense, axes)
    params = materialize_shards(decls, axes, SEED, device, draw_on=device)
    res = {"kernel": _tp_step1(dense, axes, device, params, batch, sched)[0]}
    del params
    _free()
    one = MeshAxes()
    params = materialize_shards(model_decls(dense, one), one, SEED, device,
                                draw_on=device)
    full = _tp_step1(dense, one, device, params, batch, sched)[0]
    del params
    res["plain"] = {"loss": full["loss"],
                    "grads": shard_params(full["grads"], decls, axes),
                    "params": shard_params(full["params"], decls, axes)}
    del full
    out["tp4_vs_tp1"] = {part: _step1_diff(res, part, sched(0), eps)
                         for part in ("loss", "grads", "params")}
    out["tp4_vs_tp1"]["loss_values"] = {
        n: float(r["loss"]) for n, r in res.items()}
    del res
    _free()
    return out


def _lm_tp_main(axes, device):
    """(c) of ``phase_lm_train_tp``, the slice: phantom phi3-mini at
    ``LM_TP_LAYERS`` layers, bf16, ``LM_STEPS`` steps, checkpointed after
    step 1 and resumed by a fresh trainer, with ``--profile-dir``'s
    watchdog predicting ``LM_WATCHDOG_S`` a step: far below any step, so
    rank 0's first step trips it by construction and every rank captures
    step 2 with ``torch.profiler``."""
    from repro_torch.launch.train import train_config
    args = _lm_args(["--steps", str(LM_STEPS), "--ckpt-dir",
                     str(LM_CKPT_DIR), "--profile-dir",
                     str(LM_PROFILE_DIR)])
    base = train_config(args).replace(num_layers=LM_TP_LAYERS)
    return {"rank": axes.rank,
            "main": _lm_tp_train(axes, device, base, args, LM_STEPS,
                                 profile=True, watchdog_s=LM_WATCHDOG_S)}


def _lm_tp_compare(axes, device):
    """(d) of ``phase_lm_train_tp``: phantom against tensor in the
    transformer, ``LM_TP_COMPARE``'s layers and steps each."""
    from repro_torch.launch.train import train_config
    layers, steps = LM_TP_COMPARE
    out = {}
    for impl in ("phantom", "dense"):
        a = _lm_args(["--steps", str(steps), "--impl", impl])
        out[impl] = _lm_tp_train(
            axes, device, train_config(a).replace(num_layers=layers), a,
            steps)
    return {"rank": axes.rank, "compare": out}


def _lm_tp_kernels(gen):
    """The flash kernel and the three phantom kernels at the per-rank
    shapes of phi3-mini at tp = 4 (bf16), against their plain versions
    and timed as in phases 2 and 3."""
    flash = _case(*LM_TP_FLASH_SHAPE, True, "bfloat16", gen)
    print(f"lm_train_tp: flash_attention B={flash['B']} S={flash['S']} "
          f"H={flash['H']} KV={flash['KV']} hd={flash['hd']} bfloat16 "
          f"causal: max_abs_err={flash['max_abs_err']:.3e} (of sum p|v|: "
          f"{flash['max_rel_err']:.3e}) ok={flash['ok']} ms="
          f"{flash['ms']:.4f} bound_ms={flash['bound_ms']:.5f} "
          f"({flash['bound_by']}) plain_ms={flash['plain_ms']:.4f} "
          f"library_ms={flash['library_ms']:.4f}", flush=True)
    phantom = []
    for shape in LM_TP_PHANTOM_SHAPES:
        for r in _phantom_case(*shape, "bfloat16", gen):
            phantom.append(r)
            print(f"lm_train_tp: {r['kernel']} M={r['M']} K={r['K']} "
                  f"N={r['N']} PK={r['PK']} bfloat16: max_abs_err="
                  f"{r['max_abs_err']:.3e} ok={r['ok']} route={r['route']} "
                  f"{r['variant']} splits={r['splits']}{_tile_text(r)} "
                  f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                  f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f}", flush=True)
    bad = [r for r in [flash] + phantom if not r["ok"]]
    check(not bad, f"lm_train_tp: kernels disagree with their plain "
                   f"versions at the tp = 4 shapes: {bad}")
    return {"flash": flash, "phantom": phantom}


def _lm_tp_held(ranks, layers):
    """Hold every rank's (a) and (b), its step-1 launches and its
    losses; returns the worst of (a) and (b) over the ranks."""
    import math
    want_a = {"kernel": {"flash_attention": 2 * layers,
                         "phantom_fused_matmul": 6 * layers,
                         "matmul_nt": 3 * layers, "matmul_tn": 3 * layers},
              "plain": {"flash_attention": 0, "phantom_fused_matmul": 0,
                        "matmul_nt": 0, "matmul_tn": 0}}
    worst = {}
    for r in ranks:
        rk = r["rank"]
        for key in ("kernel_vs_plain", "tp4_vs_tp1"):
            for part in ("loss", "grads", "params"):
                diff = r[key][part]
                check(diff["outside"] == 0,
                      f"lm_train_tp rank {rk}: {key} {part} differ in "
                      f"{diff['outside']} of {diff['elements']} elements: "
                      f"{diff}")
                w = worst.setdefault(key, {}).setdefault(part, {})
                for k, v in diff.items():
                    w[k] = max(w.get(k, 0), v)
            check(r[key]["grads"]["max_scaled_err"] <= STEP1_TOL["rtol"],
                  f"lm_train_tp rank {rk}: {key} gradients differ by more "
                  f"than 1e-4 of the largest: {r[key]['grads']}")
        check(r["kernel_vs_plain"]["launches"] == want_a,
              f"lm_train_tp rank {rk}: step-1 launches "
              f"{r['kernel_vs_plain']['launches']}, want {want_a}")
        for name, run in [("main", r["main"])] + list(
                r["compare"].items()):
            check(all(math.isfinite(v) for v in run["losses"]
                      + run["grad_norms"]),
                  f"lm_train_tp rank {rk}: non-finite {name} loss or "
                  f"gradient norm: {run['losses']} {run['grad_norms']}")
    return worst


def phase_lm_train_tp(pool=None):
    """phi3-mini with phantom MLP sites on ``LM_TP`` ranks sharing the
    card (gloo, card tensors through the host)."""
    import statistics as st
    import torch
    import shutil
    from repro_torch.launch.mesh import RankPool, backend_for
    from repro_torch.launch.train import train_config
    _free()
    shutil.rmtree(LM_CKPT_DIR, ignore_errors=True)
    kernels = _lm_tp_kernels(torch.Generator(device="cuda").manual_seed(
        SEED))
    print(f"lm_train_tp: {LM_TP} ranks on {torch.cuda.device_count()} "
          f"card(s); backend {backend_for('cuda', LM_TP)}", flush=True)
    shutil.rmtree(LM_PROFILE_DIR, ignore_errors=True)
    own = None if pool is not None else RankPool(
        1, LM_TP, "cuda", timeout_s=POOL_TIMEOUT_S)
    pool = pool or own
    t0 = time.perf_counter()
    try:
        ranks = pool.run(_lm_tp_rank, 1, LM_TP, timeout_s=900)
        with observed({"run": "chip_smoke.lm_train_tp"}) as (tracer, reg):
            t1 = time.perf_counter()
            for r, m in zip(ranks, pool.run(_lm_tp_main, 1, LM_TP,
                                            timeout_s=900)):
                r.update(main=m["main"])
            main_s = time.perf_counter() - t1
        rank_metrics = pool.rank_metrics
        for r, c in zip(ranks, pool.run(_lm_tp_compare, 1, LM_TP,
                                        timeout_s=900)):
            r.update(compare=c["compare"])
    finally:
        if own is not None:
            own.close()
    wall = time.perf_counter() - t0
    cfg = train_config(_lm_args([])).replace(num_layers=LM_TP_LAYERS)
    worst = _lm_tp_held(ranks, LM_PARITY_LAYERS)
    for key, what in (("kernel_vs_plain", "kernels vs plain, phantom"),
                      ("tp4_vs_tp1", "dense sp at tp=4 vs tp=1")):
        w = worst[key]
        print(f"lm_train_tp: ({'a' if key == 'kernel_vs_plain' else 'b'}) "
              f"{cfg.name} at {LM_PARITY_LAYERS} layers, step 1 {what}, "
              f"float32, worst over ranks (held to rtol 1e-4 / atol 1e-5): "
              f"loss {w['loss']['max_abs_err']:.3e} (values "
              f"{ranks[0][key]['loss_values']}), grads "
              f"{w['grads']['max_abs_err']:.3e} "
              f"({w['grads']['max_scaled_err']:.3e} of the largest), "
              f"params {w['params']['max_abs_err']:.3e}; near-zero "
              f"gradients {w['params']['near_zero_grad']} per rank at "
              f"most, differing by up to "
              f"{w['params']['max_abs_err_near_zero_grad']:.3e} (implied "
              f"{w['params']['max_implied_near_zero_grad']:.3e}); elements "
              f"outside 0 of {w['params']['elements']} per rank at most",
              flush=True)
    tokens = LM_BATCH * LM_SEQ
    main = [r["main"] for r in ranks]
    med = [st.median(m["step_ms"][1:]) for m in main]
    launches = main[0]["launches_per_step"]
    L = cfg.num_layers
    want = {"flash_attention": 2 * L, "phantom_fused_matmul": 6 * L,
            "matmul_nt": 3 * L, "matmul_tn": 3 * L}
    for r in ranks:
        check(r["main"]["launches_per_step"] == want,
              f"lm_train_tp rank {r['rank']}: launches per step "
              f"{r['main']['launches_per_step']}, want {want} (forward and "
              f"recompute of {L} layers; the phantom forward at 3 sites)")
    ckpt = _lm_ckpt_held(ranks, launches)
    obs = _lm_tp_obs_held(tracer, reg, rank_metrics, ranks, want, ckpt,
                          main_s)
    print(f"lm_train_tp: (c) {cfg.name} phantom, tp={LM_TP}, layers={L}, "
          f"batch {LM_BATCH} x seq {LM_SEQ}, bf16, "
          f"remat={cfg.remat}: losses {[round(v, 4) for v in main[0]['losses']]}"
          f"; per-rank step ms, median of steps 2-{LM_STEPS}: "
          f"{[round(m, 2) for m in med]}; {tokens / max(med) * 1e3:.1f} "
          f"tokens/s (slowest rank); launches per step per rank "
          f"{launches}; local parameters per rank "
          f"{main[0]['params_local']:,}", flush=True)
    print(f"lm_train_tp: (c) wire bytes per step per rank "
          f"{[round(m['wire_bytes_per_step']) for m in main]}; by "
          f"collective (rank 0): {main[0]['collectives_per_step']}",
          flush=True)
    print(f"lm_train_tp: (c) peak memory per rank (GB) "
          f"{[round(m['peak_memory_gb'], 2) for m in main]}; card used "
          f"(GB, as each rank read it after its run) "
          f"{[round(m['card_used_gb'], 2) for m in main]}", flush=True)
    prof = [m["profile"] for m in main]
    print(f"lm_train_tp: (c) one more step, collectives timed on every "
          f"rank (rank 0 also profiled): wall ms "
          f"{[round(p['wall_ms'], 1) for p in prof]}, in collectives "
          f"(copies and gloo) "
          f"{[round(p['collective_ms'], 1) for p in prof]} over "
          f"{prof[0]['calls']} calls, waiting for the card before them "
          f"{[round(p['device_wait_ms'], 1) for p in prof]}; rank 0's "
          f"device {prof[0]['device_ms']} ms, by kind "
          f"{prof[0]['device_ms_by_kind']}, {prof[0]['device_ops']} "
          f"device ops; top: "
          f"{ {k: round(v, 3) for k, v in prof[0]['top_device_ms'].items()} }",
          flush=True)
    compare = {}
    for impl in ("phantom", "dense"):
        runs = [r["compare"][impl] for r in ranks]
        compare[impl] = {
            "median_step_ms": [st.median(x["step_ms"][1:]) for x in runs],
            "wire_bytes_per_step": [x["wire_bytes_per_step"] for x in runs],
            "losses": runs[0]["losses"]}
        print(f"lm_train_tp: (d) {impl} at {LM_TP_COMPARE[0]} layers, "
              f"{LM_TP_COMPARE[1]} steps: per-rank step ms (median after "
              f"the first) {[round(v, 2) for v in compare[impl]['median_step_ms']]}"
              f", wire bytes per step per rank "
              f"{[round(v) for v in compare[impl]['wire_bytes_per_step']]}, "
              f"losses {[round(v, 4) for v in runs[0]['losses']]}",
              flush=True)
    print(f"lm_train_tp: the phase took {wall:.1f} s in the ranks",
          flush=True)
    return {"kernels": kernels, "ranks": ranks, "worst": worst,
            "median_step_ms": med, "tokens_per_s": tokens / max(med) * 1e3,
            "launches_per_step": launches, "compare": compare,
            "checkpoint": ckpt, "obs": obs, "wall_s": wall}


def _lm_tp_obs_held(tracer, reg, rank_metrics, ranks, launches, ckpt,
                    main_s):
    """Hold (c)'s merged trace and metrics (``obs/``): the ranks' spans
    under pids 0 to ``LM_TP`` - 1, each with the main path's
    ``train/run`` spans (the first step, the rest, the resumed step, the
    profiled step) and a ``train/step`` span a step, one ``ckpt/save``
    and one ``ckpt/restore``; rank 0's one watchdog trip at step 1 (a
    ``watchdog/spike`` instant on pid 0 alone) and every rank's capture
    of step 2, whose kernels, counted by their CUDA names in rank 0's
    ``torch.profiler`` trace, are a main-path step's launches (flash 2,
    ``splitk_kernel`` 9 and ``tn_kernel`` 3 a layer); the exported
    metrics rank 0's (``train_steps_total`` a step, not ``LM_TP``), and
    ``ckpt_bytes_total`` summed over the ranks the checkpoint's bytes.
    Writes the trace to ``LM_TRACE``; returns the counts, the spans a
    step, a span's host cost and the capture's size and cost."""
    from repro_torch.obs import MetricsRegistry
    tracer.write(str(LM_TRACE))
    doc = tracer.to_chrome()
    runs, steps = 4, LM_STEPS + 2
    want = {"train/run": runs, "train/step": steps, "ckpt/save": 1,
            "ckpt/restore": 1}
    for pid in range(LM_TP):
        got = {k: span_counts(doc, pid)[k] for k in want}
        check(got == want, f"lm_train_tp: rank {pid}'s spans {got}, "
                           f"want {want}")
    spikes = [e["pid"] for e in doc["traceEvents"]
              if e["name"] == "watchdog/spike"]
    check(spikes == [0], f"lm_train_tp: watchdog spikes on pids {spikes}, "
                         f"want one on rank 0")
    wd = [r["main"]["watchdog"] for r in ranks]
    check([[t["step"] for t in w["trips"]] for w in wd]
          == [[0]] + [[]] * (LM_TP - 1),
          f"lm_train_tp: watchdog trips {[w['trips'] for w in wd]}, want "
          f"rank 0's at step 1 (index 0) alone")
    caps = [r["main"].get("capture") for r in ranks]
    check(caps[0] is not None, "lm_train_tp: rank 0 captured no step")
    # the main path is bf16 with aligned operands: every phantom product
    # on the tensor cores, none on the CUDA-core kernels
    want_k = {"flash_attention": launches["flash_attention"],
              "splitk": 0, "matmul_tn": 0,
              "wgmma_fwd": launches["phantom_fused_matmul"],
              "wgmma_dgrad": launches["matmul_nt"],
              "wgmma_wgrad": launches["matmul_tn"]}
    check(caps[0]["kernels"] == want_k,
          f"lm_train_tp: rank 0's capture holds kernels "
          f"{caps[0]['kernels']}, a step launches {want_k}")
    n_steps = reg.counter("train_steps_total").value(suite="trainer")
    check(n_steps == steps, f"lm_train_tp: train_steps_total {n_steps}, "
                            f"want rank 0's {steps} steps")
    summed = sum(MetricsRegistry().absorb(d).counter(
        "ckpt_bytes_total").value() for d in rank_metrics)
    check(summed == ckpt["bytes_written"],
          f"lm_train_tp: ckpt_bytes_total over the ranks {summed}, the "
          f"checkpoint {ckpt['bytes_written']}")
    step_us = [e["dur"] for e in doc["traceEvents"]
               if e["ph"] == "X" and e["name"] == "train/step"
               and e["pid"] == 0]
    out = {"spans_per_pid": {pid: sum(span_counts(doc, pid).values())
                             for pid in range(LM_TP)},
           "spans_per_step_per_rank": sum(
               span_counts(doc, 0).values()) / steps,
           "span_cost_us": span_cost_us(),
           "trace_bytes": LM_TRACE.stat().st_size,
           "train_step_us_rank0": step_us, "captures": caps, "main_s": main_s,
           "ckpt_bytes_total": summed}
    print(f"lm_train_tp: (c) traced: spans per rank "
          f"{out['spans_per_pid']} over {steps} steps (held: train/run "
          f"{runs}, train/step {steps}, ckpt/save 1, ckpt/restore 1 a "
          f"rank), a span's host cost {out['span_cost_us']:.2f} us; rank "
          f"0's watchdog trip at step 1 (held); rank 0's capture of step "
          f"2: kernels {caps[0]['kernels']} (held to a step's launches), "
          f"{caps[0]['kernel_events']} kernel events, "
          f"{caps[0]['bytes']:,} B; captures on the ranks "
          f"{[c is not None for c in caps]}; rank 0's train/step us "
          f"{[round(v) for v in step_us]} (step 2 captured); "
          f"ckpt_bytes_total over the ranks {int(summed):,} (held); trace "
          f"{out['trace_bytes']:,} B -> {LM_TRACE}", flush=True)
    return out


def _lm_ckpt_held(ranks, launches):
    """Hold (a) of the elastic phase on every rank: the checkpoint's
    bytes over the ranks equal to the decls' global bytes, step 1
    restored, the resumed step 2's loss and parameter shards equal to
    the uninterrupted step 2's (bit for bit, else within
    ``LM_CKPT_REL_TOL``), its launches equal to a step of the main
    path's."""
    ck = [r["main"]["checkpoint"] for r in ranks]
    written = sum(c["io"]["io_bytes"] for c in ck)
    check(written == ck[0]["decl_bytes"],
          f"elastic (a): the ranks wrote {written} B, the decls' global "
          f"parameters and AdamW moments are {ck[0]['decl_bytes']} B")
    for r, c in zip(ranks, ck):
        tag = f"elastic (a) rank {r['rank']}"
        check(c["restored_step"] == 1, f"{tag}: restored step "
                                       f"{c['restored_step']}, want 1")
        check(c["launches"] == launches,
              f"{tag}: the resumed step launched {c['launches']}, a step "
              f"of the main path {launches}")
        check(c["loss"] == c["loss_uninterrupted"]
              or c["loss_rel_err"] <= LM_CKPT_REL_TOL,
              f"{tag}: resumed step 2's loss {c['loss']!r}, uninterrupted "
              f"{c['loss_uninterrupted']!r}")
        check(c["params_bitwise"]
              or c["params_max_rel_err"] <= LM_CKPT_REL_TOL,
              f"{tag}: resumed step 2's parameters differ by "
              f"{c['params_max_rel_err']:.3e} of their leaf's largest")
    out = {"bytes_written": written, "decl_bytes": ck[0]["decl_bytes"],
           "write_s": [c["write_s"] for c in ck],
           "read_s": [c["read_s"] for c in ck],
           "loss_bitwise": all(c["loss"] == c["loss_uninterrupted"]
                               for c in ck),
           "params_bitwise": all(c["params_bitwise"] for c in ck),
           "max_loss_rel_err": max(c["loss_rel_err"] for c in ck),
           "max_params_rel_err": max(c["params_max_rel_err"] for c in ck),
           "resumed_launches": ck[0]["launches"]}
    print(f"elastic (a): phi3-mini at {LM_TP_LAYERS} layers, tp {LM_TP}: "
          f"checkpoint of step 1 {written:,} B written over the ranks "
          f"(the decls' parameters and AdamW moments: "
          f"{out['decl_bytes']:,} B, held), write s per rank "
          f"{[round(v, 2) for v in out['write_s']]}, read s per rank "
          f"{[round(v, 2) for v in out['read_s']]}; step 2 resumed by a "
          f"fresh trainer: loss {ck[0]['loss']!r} against "
          f"{ck[0]['loss_uninterrupted']!r} (bitwise on every rank: "
          f"{out['loss_bitwise']}, worst rel {out['max_loss_rel_err']:.3e}),"
          f" parameter shards bitwise on every rank: "
          f"{out['params_bitwise']} (worst rel "
          f"{out['max_params_rel_err']:.3e}; held to "
          f"{LM_CKPT_REL_TOL:g}); launches {out['resumed_launches']} "
          f"(held to a main-path step's)", flush=True)
    return out


def _gathered(p, m):
    """Wire bytes of a rank's m-byte message all-gathered or
    reduce-scattered over p ranks, as ``record_collectives`` prices it."""
    return m * (p - 1)


def _all_reduced(p, m):
    """Wire bytes of a rank's m-byte message all-reduced over p ranks."""
    return 2 * m * (p - 1) / p


def _local_bytes(d, p, dp):
    """Bytes of one rank's shard of a decl at tp = ``p``, dp = ``dp``."""
    import math
    ways = {"tp": p, "dp": dp}
    n = math.prod(size // ways.get(e, 1) for size, e in
                  zip(d.shape, tuple(d.spec) + (None,) * len(d.shape)))
    return n * d.dtype.itemsize


def _param_wire_bytes(cfg, p, dp):
    """The wire bytes one rank's parameters cost in a step at tp = ``p``,
    dp = ``dp``: the dp all-reduce of every gradient the decls do not
    shard over dp (``parallel/grads.py: reduce_grads``), the tp
    all-reduce of every one they replicate over tp, and for a leaf that
    FSDP shards over dp its gathers (once for the embedding and the
    head, twice in a block under ``remat="full"``: the forward and the
    recompute) and the one reduce-scatter of its gradient."""
    from repro_torch.models.model import model_decls
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import tree_leaves
    total = 0.0
    for path, d in tree_leaves(model_decls(cfg, MeshAxes(tp=p, dp=dp))):
        m = _local_bytes(d, p, dp)
        if "dp" in d.spec:
            gathers = 2 if path.startswith("layers/") else 1
            total += (gathers + 1) * _gathered(dp, m)
        else:
            total += _all_reduced(dp, m)
        if "tp" not in d.spec:
            total += _all_reduced(p, m)
    return total


def _norm_bytes(cfg, p, T):
    """One ``fp`` norm's psums over ``T`` tokens in one pass: RMSNorm's
    sum of squares, LayerNorm's sum and then its centred sum of
    squares, each [T, 1] in fp32."""
    return (2 if cfg.norm == "layernorm" else 1) * _all_reduced(p, T * 4)


def _outer_wire_bytes(cfg, batch, seq, p, dp=1):
    """The logical wire bytes one rank issues in one training step outside
    the blocks of an LM whose stream is feature-sharded (``fp``) at tp =
    ``p``, dp = ``dp``, priced as ``record_collectives`` prices them
    (``telemetry/predict.py: event_wire_bytes``: a rank's message of m
    bytes costs m (p - 1) gathered or reduce-scattered, 2 m (p - 1) / p
    all-reduced, m (p - 1) / p all-to-all'd, m a ppermute hop): the
    embedding's reduce-scatter, the final norm, the loss's feature gather
    and its vocab psums (a chunk's true-logit psum is not recomputed:
    ``torch.utils.checkpoint`` stops at the last tensor the backward
    needs), each forward and backward; the loss's two dp sums (the token
    count and the summed loss), the global norm, and the parameters'
    (``_param_wire_bytes``)."""
    act = 2 if cfg.dtype == "bfloat16" else 4
    d, b = cfg.d_model, batch // dp
    T = b * seq
    chunk = min(cfg.loss_chunk, seq)
    n_chunks = seq // chunk
    per_chunk = (_all_reduced(p, b * chunk * 4)
                 * (5 + 2 * (n_chunks > 1)))
    return (2 * _gathered(p, T * d // p * act)    # embedding, fwd + bwd
            + 2 * _norm_bytes(cfg, p, T)          # final norm
            + 2 * _gathered(p, T * d // p * act)  # the loss's gather
            + n_chunks * per_chunk
            + 2 * _all_reduced(dp, 4) + _all_reduced(p * dp, 4)
            + _param_wire_bytes(cfg, p, dp))


def serve_wire_bytes(cfg, rows, seq, p, phase):
    """The logical wire bytes one rank issues in one serving step at tp =
    ``p`` over ``rows`` rows (its dp shard of the slots): a prefill of
    ``seq`` tokens or one decode step (``phase``), of any LM family,
    priced as ``record_collectives`` prices them (``_outer_wire_bytes``).
    The stream is ``sp`` at prefill and ``rep`` at decode with tensor
    sites, ``fp`` with a phantom one.  Around the blocks: the
    embedding's reduce-scatter (an all-reduce in ``rep``), the final
    norm's psums (``fp``), the last position's psum (``sp``), the head's
    feature gather (``fp``) and the fp32 logits' gather.  Each block,
    summed over the layer plan (``_serve_block_bytes``); an
    encoder-decoder's prefill also runs the encoder over ``seq`` frames
    and gathers its output to full features (the memory).  FSDP's dp
    gathers (jamba's and qwen2-vl's configs set it) are not counted: at
    dp 1, where phase 18 serves them, they issue nothing."""
    from repro_torch.models.blocks import layer_plan
    from repro_torch.models.layers import padded_vocab, residual_layout
    act = 2 if cfg.dtype == "bfloat16" else 4
    d = cfg.d_model
    lay = residual_layout(cfg, phase)
    T = rows * (seq if phase == "prefill" else 1)
    w = _serve_wires(cfg, lay, p, T, act)
    out = w["reduce"]                                   # the embedding
    for mixer, ffn in layer_plan(cfg):
        out += _serve_block_bytes(cfg, lay, p, rows, seq, phase, mixer, ffn,
                                  cross=cfg.family == "encdec")
    if cfg.family == "encdec" and phase == "prefill":
        out += cfg.encoder_layers * _serve_block_bytes(
            cfg, lay, p, rows, seq, "encode", "attn", "mlp")
        out += w["norm"] + w["gather"]            # final norm, the memory
    if lay == "fp":
        out += w["norm"] + _gathered(p, rows * d // p * act)
    elif lay == "sp":
        out += _all_reduced(p, rows * d * act)        # the last position
    return out + _gathered(p, rows * padded_vocab(cfg) // p * 4)


def _serve_wires(cfg, lay, p, T, act):
    """The bytes of the stream's collectives over ``T`` tokens in layout
    ``lay``: ``gather`` (to full features), ``reduce`` (partial sums into
    the layout) and one norm's psums (``fp`` only)."""
    stream, full = T * cfg.d_model // p * act, T * cfg.d_model * act
    return {"gather": 0.0 if lay == "rep" else _gathered(p, stream),
            "reduce": (_all_reduced(p, full) if lay == "rep"
                       else _gathered(p, stream)),
            "norm": _norm_bytes(cfg, p, T) if lay == "fp" else 0.0}


def _ghost(cfg, site, p, T, act):
    """A phantom site's ghost gather of [T, k]."""
    return _gathered(p, T * cfg.projection_spec(site).k * act)


def _serve_block_bytes(cfg, lay, p, rows, seq, phase, mixer, ffn,
                       cross=False):
    """One block of ``serve_wire_bytes``; ``phase`` "encode" is an
    encoder block in prefill (non-causal, no cache).

    Head-mode attention: the features gathered where a q/k/v site is
    tensor or tp does not divide the KV heads (always at decode), a
    ghost gather per phantom site, ``wo``'s reduce (tensor); at prefill
    the K/V all-to-all onto sequence shards where tp divides the KV
    heads; at decode the q (and K/V) head gathers and the log-sum-exp
    merge's three all-reduces in fp32 (the max, the numerators, the
    denominators).  Ring attention: the chunk's features gathered
    (``fp``), the four weights gathered on use in the compute dtype, p -
    1 hops of K and of V and, in ``fp``, the all-to-all back; at decode
    the gathers of the four weights and the merge.  Cross-attention (a
    decoder block): its q site's gather and ``wo``'s reduce, at prefill
    the memory's K/V all-to-all, at decode the q head gather and the
    merge.  SSD: the gathered features, the in site's two ghosts
    (phantom), the gated RMSNorm's psum [T, 1] in fp32, ``out``'s
    ghost or reduce.  MLP: gather and reduce (tensor) or a ghost per
    projection (phantom: three for SwiGLU, two for gelu).  Expert-
    partitioned MoE: in ``fp`` the router's partial logits [T, E] in
    fp32 and two all-to-alls of the capacity slots [E, C, d / p]; in
    ``sp`` two all-to-alls of [E, C, d] over the rank's tokens; in
    ``rep`` the psum of the experts' outputs [E, C, d].  Every norm in
    ``fp`` adds its psums."""
    from repro_torch.models.attention import (attn_site_strategies,
                                              resolve_attn_mode)
    from repro_torch.models.layers import mlp_strategies
    from repro_torch.models.moe import moe_capacity
    from repro_torch.models.ssm import ssm_dims, ssm_site_strategies
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.configs.base import PHANTOM_KINDS
    act = 2 if cfg.dtype == "bfloat16" else 4
    d, H, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim() if H else 0
    decode = phase == "decode"
    T = rows * (1 if decode else seq)
    w = _serve_wires(cfg, lay, p, T, act)
    axes = MeshAxes(tp=p)
    out = w["norm"]                                           # norm1
    merge = (2 * _all_reduced(p, T * H * 4)
             + _all_reduced(p, T * H * hd * 4))

    def attn(is_cross):
        sts = attn_site_strategies(cfg, axes, cross=is_cross)
        ph = {n: sts[n].kind in PHANTOM_KINDS for n in sts}
        o = sum(_ghost(cfg, _SITE[n], p, T, act)
                for n in ("wq", "wk", "wv", "wo") if ph[n])
        o += 0.0 if ph["wo"] else w["reduce"]
        if resolve_attn_mode(cfg, axes) == "ring" and not is_cross:
            wts = sum(_gathered(p, n_in * n_out // p * act)
                      for n_in, n_out in ((d, H * hd), (d, kv * hd),
                                          (d, kv * hd), (H * hd, d)))
            if decode:
                return w["gather"] + wts + merge
            C = seq // p
            return ((w["gather"] if lay == "fp" else 0.0) + wts
                    + 2 * (p - 1) * rows * C * kv * hd * act
                    + (rows * C * d * act * (p - 1) / p
                       if lay == "fp" else 0.0))
        users = ("wq",) if is_cross else ("wq", "wk", "wv")
        if decode or kv % p or not all(ph[n] for n in users):
            o += w["gather"]
        if decode:
            o += _gathered(p, T * H // p * hd * act) + merge
            if kv % p == 0 and not is_cross:
                o += 2 * _gathered(p, T * kv // p * hd * act)
        elif phase == "prefill" and kv % p == 0:
            o += 2 * (rows * seq * kv // p * hd * act) * (p - 1) / p
        return o

    if mixer == "attn":
        out += attn(False)
    else:
        sts = ssm_site_strategies(cfg, axes)
        out += w["gather"] + _all_reduced(p, T * 4)
        out += (2 * _ghost(cfg, "ssm_in", p, T, act)
                if sts["in"].kind in PHANTOM_KINDS else 0.0)
        out += (_ghost(cfg, "ssm_out", p, T, act)
                if sts["out"].kind in PHANTOM_KINDS else w["reduce"])
    if cross:
        out += w["norm"] + attn(True)
    if ffn is None:
        return out
    out += w["norm"]                                          # norm2
    if ffn == "mlp":
        sts = mlp_strategies(cfg, axes, d, cfg.d_ff)
        if all(st.kind in PHANTOM_KINDS for st in sts.values()):
            out += sum(_ghost(cfg, f"ffn_{n}", p, T, act) for n in sts)
        else:
            out += w["gather"] + w["reduce"]
        return out
    m = cfg.moe
    E = m.num_experts
    tok = T // p if lay == "sp" else T
    C = moe_capacity(tok, E, m.top_k, m.capacity_factor)
    if lay == "fp":
        return (out + _all_reduced(p, T * E * 4)
                + 2 * E * C * d // p * act * (p - 1) / p)
    if lay == "sp":
        return out + 2 * E * C * d * act * (p - 1) / p
    return out + _all_reduced(p, E * C * d * act)


_SITE = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_o"}


def ring_wire_bytes(cfg, batch, seq, p):
    """The logical wire bytes one rank issues in one training step of a
    ring-attention model with phantom MLP sites in the ``fp`` layout at
    tp = ``p``, dp = 1 (``_outer_wire_bytes``' pricing).  Per block and
    pass: two norm psums, the feature gather of the rank's chunk, the
    four weights gathered on use in fp32, p - 1 hops of K and of V, the
    all-to-all back to ``fp`` and three ghost gathers; a backward pass
    issues the same bytes, and ``remat="full"`` repeats the forward:
    three passes.  Around the blocks: ``_outer_wire_bytes``."""
    act = 2 if cfg.dtype == "bfloat16" else 4
    d, H, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, k = cfg.resolved_head_dim(), cfg.projection_spec("ffn_gate").k
    T, C = batch * seq, seq // p
    block = (2 * _all_reduced(p, T * 4)
             + _gathered(p, T * d // p * act)
             + sum(_gathered(p, n_in * n_out // p * 4) for n_in, n_out in (
                 (d, H * hd), (d, kv * hd), (d, kv * hd), (H * hd, d)))
             + 2 * (p - 1) * batch * C * kv * hd * act
             + batch * C * d * act * (p - 1) / p
             + 3 * _gathered(p, T * k * act))
    return 3 * cfg.num_layers * block + _outer_wire_bytes(cfg, batch, seq, p)


def moe_wire_bytes(cfg, batch, seq, p):
    """The logical wire bytes one rank issues in one training step of an
    expert-partitioned MoE model with phantom q/k/v/o sites in the ``fp``
    layout at tp = ``p``, dp = 1 (``_outer_wire_bytes``' pricing).  Per
    block and pass: two norm psums, four ghost gathers (the attention
    reads the feature shard; its output stays one), the psum of the
    router's partial logits [T, E] in fp32, and the two all-to-alls of
    the capacity slots [E, C, d / p] in the compute dtype (C =
    ``moe_capacity(T, E, top_k, cf)``); a backward pass issues the same
    bytes, and ``remat="full"`` repeats the forward: three passes.
    Around the blocks: ``_outer_wire_bytes``."""
    from repro_torch.models.moe import moe_capacity
    act = 2 if cfg.dtype == "bfloat16" else 4
    m = cfg.moe
    d, k, T = cfg.d_model, cfg.projection_spec("attn_q").k, batch * seq
    C = moe_capacity(T, m.num_experts, m.top_k, m.capacity_factor)
    block = (2 * _all_reduced(p, T * 4)
             + 4 * _gathered(p, T * k * act)
             + _all_reduced(p, T * m.num_experts * 4)
             + 2 * m.num_experts * C * d // p * act * (p - 1) / p)
    return 3 * cfg.num_layers * block + _outer_wire_bytes(cfg, batch, seq, p)


def ssm_wire_bytes(cfg, batch, seq, p):
    """The logical wire bytes one rank issues in one training step of an
    SSM model (mamba2) with phantom in and out projections in the ``fp``
    layout at tp = ``p``, dp = 1 (``_outer_wire_bytes``' pricing).  Per
    block and pass: the norm's psum, the feature gather for the B/C and
    dt projections, the ghost gathers of ``wz``, ``wx`` and ``out``, and
    the gated RMSNorm's psum; a backward pass issues the same bytes, and
    ``remat="full"`` repeats the forward: three passes.  Around the
    blocks: ``_outer_wire_bytes`` (the replicated B/C projection's
    gradient all-reduced over tp among the parameters')."""
    act = 2 if cfg.dtype == "bfloat16" else 4
    d, k, T = cfg.d_model, cfg.projection_spec("ssm_in").k, batch * seq
    block = (2 * _all_reduced(p, T * 4)
             + _gathered(p, T * d // p * act)
             + 3 * _gathered(p, T * k * act))
    return 3 * cfg.num_layers * block + _outer_wire_bytes(cfg, batch, seq, p)


def fsdp_wire_bytes(cfg, batch, seq, p, dp):
    """The logical wire bytes one rank issues in one training step of a
    dense LM with phantom MLP sites and dense head-mode attention in the
    ``fp`` layout (phi3-mini) at tp = ``p``, dp = ``dp``, with or without
    FSDP (``_outer_wire_bytes``' pricing).  Per block and pass: two norm
    psums, the attention's feature gather and the reduce-scatter of
    ``wo``'s partial sums, and the ghost gathers of gate, up and down;
    three passes.  Under FSDP ``_param_wire_bytes`` replaces each
    dp-sharded leaf's gradient all-reduce by its gathers (the forward's
    and the recompute's in a block) and one reduce-scatter."""
    act = 2 if cfg.dtype == "bfloat16" else 4
    d, k = cfg.d_model, cfg.projection_spec("ffn_gate").k
    T = batch // dp * seq
    block = (2 * _all_reduced(p, T * 4)
             + 2 * _gathered(p, T * d // p * act)
             + 3 * _gathered(p, T * k * act))
    return (3 * cfg.num_layers * block
            + _outer_wire_bytes(cfg, batch, seq, p, dp))


class _KeepGrads:
    """An optimizer that keeps the clipped gradients it is handed and
    leaves the parameters as they are: step 1's loss and gradients with
    no optimizer state beside a model that fills much of the card."""
    eps = 0.0

    def state_decls(self, decls):
        return {}

    def init(self, params):
        return {}

    def update(self, grads, state, params, step):
        self.grads = grads
        return params, state


def _grads_step1(cfg, axes, device, params, batch):
    """The loss and clipped gradients of one step of ``cfg`` on ``axes``
    (``make_train_step`` with ``_KeepGrads``)."""
    import torch
    from repro_torch.train.trainer import make_train_step
    opt = _KeepGrads()
    step_fn, _, _ = make_train_step(cfg, axes, opt, device=device)
    _, _, m = step_fn(params, {}, 0, batch)
    torch.cuda.synchronize()
    return {"loss": m["loss"], "grads": opt.grads}


def _qwen_rank(axes, device):
    """``phase_qwen_train_tp`` inside one of the ``LM_TP`` ranks sharing
    the card, qwen2.5-14b at full width: (a) step 1 through the kernels
    against plain torch, phantom MLP sites, fp32, ``LM_PARITY_LAYERS``
    layers; (c) the phantom ``ring`` variant against (a)'s plain
    ``fused`` run; (b) dense (``sp``) at tp = 4 against tp = 1 from the
    same seed, loss and gradients: one rank at a time holds the tp = 1
    model and holds its shard of the result; (d) the main path, phantom,
    bf16, ``QWEN_LAYERS`` layers, ``QWEN_STEPS`` steps and one more
    profiled (``_lm_tp_train``)."""
    import torch
    from repro_torch.configs.base import (dense_projection_map,
                                          phantom_projection_map,
                                          with_kernel_backend)
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.launch.train import train_config
    from repro_torch.models.model import model_decls
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize_shards, shard_params

    out = {"rank": axes.rank}
    args = _lm_args(["--steps", str(QWEN_STEPS)], arch=QWEN_ARCH)
    base = train_config(args).replace(num_layers=QWEN_LAYERS)
    cut = base.replace(num_layers=LM_PARITY_LAYERS, dtype="float32")
    batch = LMDataset(cut.vocab_size, args.batch, args.seq + 1,
                      device=device)(0)
    sched = warmup_cosine(3e-4, 20, QWEN_STEPS)

    # (a) kernels against plain, phantom sites, float32
    params = materialize_shards(model_decls(cut, axes), axes, SEED, device,
                                draw_on=device)
    res, launches = {}, {}
    for name, backend in (("kernel", "auto"), ("plain", "xla")):
        res[name], launches[name], eps = _tp_step1(
            with_kernel_backend(cut, backend), axes, device, params, batch,
            sched)
    out["kernel_vs_plain"] = {
        part: _step1_diff(res, part, sched(0), eps)
        for part in ("loss", "grads", "params")}
    out["kernel_vs_plain"].update(
        launches=launches,
        loss_values={n: float(r["loss"]) for n, r in res.items()})
    del res["kernel"]
    _free()

    # (c) the phantom ring variant against (a)'s plain fused run
    ring = cut.replace(projections=phantom_projection_map(
        cut.projection_spec("ffn_gate").k, ffn=True, variant="ring"))
    res["kernel"], ring_launches, _ = _tp_step1(
        with_kernel_backend(ring, "auto"), axes, device, params, batch,
        sched)
    out["ring_vs_fused"] = {part: _step1_diff(res, part, sched(0), eps)
                            for part in ("loss", "grads", "params")}
    out["ring_vs_fused"].update(
        launches=ring_launches,
        loss_values={"ring": float(res["kernel"]["loss"]),
                     "fused": float(res["plain"]["loss"])})
    del params, res
    _free()

    # (b) ring attention, dense sites (sp): tp = 4 against tp = 1
    dense = with_kernel_backend(cut.replace(
        projections=dense_projection_map()), "auto")
    decls = model_decls(dense, axes)
    params = materialize_shards(decls, axes, SEED, device, draw_on=device)
    mine = _grads_step1(dense, axes, device, params, batch)
    del params
    _free()
    one = MeshAxes()
    for turn in range(axes.tp):
        if turn == axes.tp_rank:
            params = materialize_shards(model_decls(dense, one), one, SEED,
                                        device, draw_on=device)
            full = _grads_step1(dense, one, device, params, batch)
            del params
            res = {"kernel": mine, "plain": {
                "loss": full["loss"],
                "grads": shard_params(full["grads"], decls, axes)}}
            del full
            out["tp4_vs_tp1"] = {part: _step1_diff(res, part, 0.0, eps)
                                 for part in ("loss", "grads")}
            out["tp4_vs_tp1"]["loss_values"] = {
                "tp4": float(res["kernel"]["loss"]),
                "tp1": float(res["plain"]["loss"])}
            out["tp4_vs_tp1"]["peak_memory_gb"] = \
                torch.cuda.max_memory_allocated() / 1e9
            del res
            _free()
        # one rank at a time holds the tp = 1 model
        axes.tp_comm.all_reduce(torch.zeros(1, device=device))
    del mine
    _free()

    # (d) the main path --------------------------------------------------
    out["main"] = _lm_tp_train(axes, device, base, args, QWEN_STEPS,
                               profile=True)
    return out


def _timed_kernels(tag, gen, flash_shapes=(), phantom_shapes=(),
                   phantom_names=None):
    """The flash kernel at each (B, S, H, KV, hd), causal (or at (B, S,
    H, KV, hd, causal)), and the three phantom kernels (``phantom_names``:
    those of them) at each (M, K, N, PK), all bf16: held to their plain
    versions and timed as in phases 2 and 3, and with a cold L2.  Returns
    {"flash": [cases], "cases": [phantom cases], "cold": {str([M, K, N,
    PK]): the phantom kernels' cold-L2 times}}."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    out = {"flash": [], "cases": [], "cold": {}}
    for B, S, H, KV, hd, *mode in flash_shapes:
        causal = mode[0] if mode else True
        flash = _case(B, S, H, KV, hd, causal, "bfloat16", gen)

        def kern():
            q, k, v = _flash_inputs(S, gen, B, H, KV, hd)
            return lambda: flash_attention(q, k, v, causal=causal)

        def lib():
            # the library's kv heads repeated outside the timing, as in
            # ``_case``
            q, k, v = _flash_inputs(S, gen, B, H, KV, hd)
            q, k, v = (t.repeat_interleave(H // t.shape[2], dim=2)
                       .transpose(1, 2) for t in (q, k, v))
            return lambda: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=causal)
        nbytes = sum(t.numel() * 2
                     for t in _flash_inputs(S, gen, B, H, KV, hd))
        flash.update(cold_ms=cold_ms(kern, nbytes),
                     library_cold_ms=cold_ms(lib, nbytes))
        out["flash"].append(flash)
        print(f"{tag}: flash_attention B={B} S={S} H={H} KV={KV} hd={hd} "
              f"bfloat16 {'causal' if causal else 'full'}: "
              f"max_abs_err={flash['max_abs_err']:.3e} "
              f"(of sum p|v|: {flash['max_rel_err']:.3e}) ok={flash['ok']} "
              f"ms={flash['ms']:.4f} cold_ms={flash['cold_ms']:.4f} "
              f"bound_ms={flash['bound_ms']:.5f} ({flash['bound_by']}) "
              f"plain_ms={flash['plain_ms']:.4f} library_ms="
              f"{flash['library_ms']:.4f} (cold "
              f"{flash['library_cold_ms']:.4f})", flush=True)
    for shape in phantom_shapes:
        for r in _phantom_case(*shape, "bfloat16", gen, phantom_names):
            out["cases"].append(r)
            print(f"{tag}: {r['kernel']} M={r['M']} K={r['K']} "
                  f"N={r['N']} PK={r['PK']} bfloat16: max_abs_err="
                  f"{r['max_abs_err']:.3e} ok={r['ok']} route={r['route']} "
                  f"{r['variant']} splits={r['splits']}{_tile_text(r)} "
                  f"ms={r['ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                  f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f}", flush=True)
        out["cold"][str(list(shape))] = _phantom_cold(
            *shape, gen, dtype="bfloat16", names=phantom_names)
    bad = [r for r in out["flash"] + out["cases"] if not r["ok"]]
    check(not bad, f"{tag}: kernels disagree with their plain versions: "
                   f"{bad}")
    return out


def _qwen_held(ranks, cfg):
    """Hold every rank's (a), (b), (c), the launches of (a), (c) and of
    the main path, its losses and its wire bytes against
    ``ring_wire_bytes``; returns the worst of (a), (b), (c) over the
    ranks."""
    import math
    L = LM_PARITY_LAYERS
    none = {"flash_attention": 0, "phantom_fused_matmul": 0, "matmul_nt": 0,
            "matmul_tn": 0}
    want = {"kernel_vs_plain": {
                "kernel": {**none, "phantom_fused_matmul": 6 * L,
                           "matmul_nt": 3 * L, "matmul_tn": 3 * L},
                "plain": none},
            "ring_vs_fused": none}
    n = cfg.num_layers
    main_want = {**none, "phantom_fused_matmul": 6 * n, "matmul_nt": 3 * n,
                 "matmul_tn": 3 * n}
    wire = ring_wire_bytes(cfg, LM_BATCH, LM_SEQ, LM_TP)
    worst = {}
    for r in ranks:
        rk = r["rank"]
        for key in ("kernel_vs_plain", "ring_vs_fused", "tp4_vs_tp1"):
            parts = ("loss", "grads") + (("params",) if key != "tp4_vs_tp1"
                                         else ())
            for part in parts:
                diff = r[key][part]
                check(diff["outside"] == 0,
                      f"qwen_train_tp rank {rk}: {key} {part} differ in "
                      f"{diff['outside']} of {diff['elements']} elements: "
                      f"{diff}")
                w = worst.setdefault(key, {}).setdefault(part, {})
                for k, v in diff.items():
                    w[k] = max(w.get(k, 0), v)
            check(r[key]["grads"]["max_scaled_err"] <= STEP1_TOL["rtol"],
                  f"qwen_train_tp rank {rk}: {key} gradients differ by more "
                  f"than 1e-4 of the largest: {r[key]['grads']}")
            if key in want:
                check(r[key]["launches"] == want[key],
                      f"qwen_train_tp rank {rk}: {key} launches "
                      f"{r[key]['launches']}, want {want[key]}")
        m = r["main"]
        check(all(math.isfinite(v) for v in m["losses"] + m["grad_norms"]),
              f"qwen_train_tp rank {rk}: non-finite loss or gradient norm: "
              f"{m['losses']} {m['grad_norms']}")
        check(m["launches_per_step"] == main_want,
              f"qwen_train_tp rank {rk}: launches per step "
              f"{m['launches_per_step']}, want {main_want} (the phantom "
              f"forward at 3 sites, forward and recompute; ring attention "
              f"never runs the flash kernel)")
        check(m["wire_bytes_per_step"] == wire,
              f"qwen_train_tp rank {rk}: {m['wire_bytes_per_step']:.0f} "
              f"wire bytes a step, predicted {wire:.0f}")
    return worst


def phase_qwen_train_tp(pool=None):
    """qwen2.5-14b, ring attention and phantom MLP sites, on ``LM_TP``
    ranks sharing the card (gloo, card tensors through the host)."""
    import statistics as st
    import torch
    from repro_torch.launch.train import train_config
    _free()
    kernels = _timed_kernels(
        "qwen_train_tp", torch.Generator(device="cuda").manual_seed(SEED),
        phantom_shapes=QWEN_PHANTOM_SHAPES)
    t0 = time.perf_counter()
    ranks = _run_ranks(pool, _qwen_rank, 1, LM_TP)
    wall = time.perf_counter() - t0
    cfg = train_config(_lm_args([], arch=QWEN_ARCH)).replace(
        num_layers=QWEN_LAYERS)
    worst = _qwen_held(ranks, cfg)
    for key, what in (("kernel_vs_plain", "(a) kernels vs plain, phantom"),
                      ("ring_vs_fused", "(c) phantom ring vs fused"),
                      ("tp4_vs_tp1", "(b) ring, dense sp at tp=4 vs tp=1")):
        w = worst[key]
        print(f"qwen_train_tp: {what}, {cfg.name} at {LM_PARITY_LAYERS} "
              f"layers, step 1, float32, worst over ranks (rtol 1e-4 / "
              f"atol 1e-5): loss {w['loss']['max_abs_err']:.3e} (values "
              f"{ranks[0][key]['loss_values']}), grads "
              f"{w['grads']['max_abs_err']:.3e} "
              f"({w['grads']['max_scaled_err']:.3e} of the largest)"
              + (f", params {w['params']['max_abs_err']:.3e}; near-zero "
                 f"gradients {w['params']['near_zero_grad']} per rank at "
                 f"most, differing by up to "
                 f"{w['params']['max_abs_err_near_zero_grad']:.3e} (implied "
                 f"{w['params']['max_implied_near_zero_grad']:.3e})"
                 if "params" in w else "")
              + f"; elements outside 0 of {w['grads']['elements']} per rank "
              f"at most", flush=True)
    print(f"qwen_train_tp: (b) the tp = 1 side's peak memory (GB) "
          f"{[round(r['tp4_vs_tp1']['peak_memory_gb'], 2) for r in ranks]}",
          flush=True)
    main = [r["main"] for r in ranks]
    med = [st.median(m["step_ms"][1:]) for m in main]
    tokens = LM_BATCH * LM_SEQ
    wire = ring_wire_bytes(cfg, LM_BATCH, LM_SEQ, LM_TP)
    print(f"qwen_train_tp: (d) {cfg.name} phantom, ring attention, tp="
          f"{LM_TP}, layers={cfg.num_layers}, batch {LM_BATCH} x seq "
          f"{LM_SEQ}, bf16, remat={cfg.remat}: losses "
          f"{[round(v, 4) for v in main[0]['losses']]}; per-rank step ms "
          f"{[[round(v, 1) for v in m['step_ms']] for m in main]}, median "
          f"of steps 2-{QWEN_STEPS} {[round(v, 1) for v in med]}; "
          f"{tokens / max(med) * 1e3:.1f} tokens/s (slowest rank); launches "
          f"per step per rank {main[0]['launches_per_step']}; local "
          f"parameters per rank {main[0]['params_local']:,}", flush=True)
    print(f"qwen_train_tp: (d) wire bytes per step per rank "
          f"{[round(m['wire_bytes_per_step']) for m in main]}, predicted "
          f"{wire:.0f} (ring_wire_bytes); by collective (rank 0): "
          f"{main[0]['collectives_per_step']}", flush=True)
    print(f"qwen_train_tp: (d) peak memory per rank (GB) "
          f"{[round(m['peak_memory_gb'], 2) for m in main]}; card used "
          f"(GB, as each rank read it after its run) "
          f"{[round(m['card_used_gb'], 2) for m in main]}", flush=True)
    prof = [m["profile"] for m in main]
    print(f"qwen_train_tp: (d) one more step, collectives timed on every "
          f"rank (rank 0 also profiled): wall ms "
          f"{[round(p['wall_ms'], 1) for p in prof]}, in collectives "
          f"(copies and gloo) "
          f"{[round(p['collective_ms'], 1) for p in prof]} over "
          f"{prof[0]['calls']} calls, waiting for the card before them "
          f"{[round(p['device_wait_ms'], 1) for p in prof]}; rank 0's "
          f"device {prof[0]['device_ms']} ms, by kind "
          f"{prof[0]['device_ms_by_kind']}, {prof[0]['device_ops']} "
          f"device ops; top: "
          f"{ {k: round(v, 3) for k, v in prof[0]['top_device_ms'].items()} }",
          flush=True)
    print(f"qwen_train_tp: the phase took {wall:.1f} s in the ranks",
          flush=True)
    return {"kernels": kernels, "ranks": ranks, "worst": worst,
            "median_step_ms": med, "tokens_per_s": tokens / max(med) * 1e3,
            "launches_per_step": main[0]["launches_per_step"],
            "wire_bytes_predicted": wire, "wall_s": wall}


def _lm_pp_args():
    """``launch/train.py``'s flags for phi3-mini at pp ``LM_PP`` x tp
    ``LM_PP_TP``, ``LM_PP_M`` microbatches, ``LM_PP_STEPS`` steps."""
    return _lm_args(["--steps", str(LM_PP_STEPS), "--tp", str(LM_PP_TP),
                     "--pp", str(LM_PP), "--microbatches", str(LM_PP_M)])


def _stage_cut(tree, axes, pp):
    """A pp = 1 rank's tree cut to what stage ``axes.pp_rank`` of ``pp``
    holds: each layer stack ``[G, ...]`` as ``[pp, G/pp, ...]``, the
    stage's ``[1, G/pp, ...]`` slice kept."""
    from repro_torch.parallel.params import tree_map
    s = axes.pp_rank
    return {**tree, "layers": tree_map(
        lambda t: t.reshape((pp, t.shape[0] // pp) + t.shape[1:])[s:s + 1],
        tree["layers"])}


def _lm_pp_rank(axes, device):
    """``phase_lm_train_pp`` inside one of the ``LM_PP`` x ``LM_PP_TP``
    ranks sharing the card, phi3-mini with phantom MLP sites: (a) step 1
    through the kernels against plain torch, fp32, ``LM_PARITY_LAYERS``
    layers (one a stage), ``LM_PP_PARITY_M`` microbatches, AdamW; (a')
    the same with Adafactor; (b) (a)'s kernel run against pp 1 x tp
    ``LM_PP_TP`` from the same seed: each stage's model ranks run the
    whole 2-layer model over their own group, and each rank holds its
    stage's cut of it; (c) the main path, bf16, ``LM_PP_LAYERS`` layers,
    ``LM_PP_STEPS`` steps and one more profiled (``_lm_tp_train``)."""
    from repro_torch.configs.base import with_kernel_backend
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.launch.train import train_config
    from repro_torch.models.model import model_decls
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize_shards

    out = {"rank": axes.rank, "stage": axes.pp_rank}
    args = _lm_pp_args()
    base = train_config(args).replace(num_layers=LM_PP_LAYERS)
    cut = base.replace(num_layers=LM_PARITY_LAYERS, dtype="float32")
    batch = LMDataset(cut.vocab_size, args.batch, args.seq + 1,
                      device=device)(0)
    sched = warmup_cosine(3e-4, 20, LM_PP_STEPS)
    M = LM_PP_PARITY_M

    # (a) and (a'): kernels against plain, AdamW and Adafactor, float32
    params = materialize_shards(model_decls(cut, axes), axes, SEED, device,
                                draw_on=device)
    for key, opt in (("kernel_vs_plain", "adamw"),
                     ("adafactor", "adafactor")):
        res, launches = {}, {}
        for name, backend in (("kernel", "auto"), ("plain", "xla")):
            res[name], launches[name], eps = _tp_step1(
                with_kernel_backend(cut.replace(optimizer=opt), backend),
                axes, device, params, batch, sched, microbatches=M)
        out[key] = {part: _step1_diff(res, part, sched(0), eps)
                    for part in ("loss", "grads", "params")}
        out[key].update(launches=launches, loss_values={
            n: float(r["loss"]) for n, r in res.items()})
        if opt == "adamw":
            mine, adam_eps = res["kernel"], eps
        del res
        _free()
    del params
    _free()

    # (b) pp = 2 against pp = 1 at the same tp, the kernel path, AdamW
    one = MeshAxes(tp=axes.tp, tp_rank=axes.tp_rank,
                   tp_group=axes.tp_group, world_group=axes.tp_group)
    kcfg = with_kernel_backend(cut, "auto")
    params = materialize_shards(model_decls(kcfg, one), one, SEED, device,
                                draw_on=device)
    full = _tp_step1(kcfg, one, device, params, batch, sched,
                     microbatches=M)[0]
    del params
    res = {"kernel": mine, "plain": {
        "loss": full["loss"], "grads": _stage_cut(full["grads"], axes, LM_PP),
        "params": _stage_cut(full["params"], axes, LM_PP)}}
    del full, mine
    out["pp2_vs_pp1"] = {part: _step1_diff(res, part, sched(0), adam_eps)
                         for part in ("loss", "grads", "params")}
    out["pp2_vs_pp1"]["loss_values"] = {
        "pp2": float(res["kernel"]["loss"]),
        "pp1": float(res["plain"]["loss"])}
    del res
    _free()

    # (c) the main path ---------------------------------------------------
    out["main"] = _lm_tp_train(axes, device, base, args, LM_PP_STEPS,
                               profile=True)
    return out


def lm_pp_boundary_bytes(cfg, stage):
    """The bytes stage ``stage`` sends to its neighbours in one step: the
    schedule's ``executed=False`` account (``PipelineSchedule.p2p_events``:
    each microbatch's activation once forward and its gradient once
    backward, a message the stream's local shard of one microbatch in
    bf16), less the direction an end stage has no neighbour in."""
    from repro_torch.train.pipeline import PipelineSchedule
    m_bytes = (LM_BATCH // LM_PP_M) * LM_SEQ * cfg.d_model // LM_PP_TP * 2
    return sum(
        ev.m_floats * 4
        for ev in PipelineSchedule(LM_PP, LM_PP_M).p2p_events(m_bytes / 4)
        if (ev.phase == "fwd" and stage < LM_PP - 1)
        or (ev.phase == "bwd" and stage > 0))


def _lm_pp_held(ranks, cfg):
    """Hold every rank's (a), (a'), (b), their launches, the main path's
    losses, launches per step and boundary bytes; returns the worst of
    (a), (a') and (b) over the ranks."""
    import math
    per = LM_PARITY_LAYERS // LM_PP * LM_PP_PARITY_M
    none = {"flash_attention": 0, "phantom_fused_matmul": 0, "matmul_nt": 0,
            "matmul_tn": 0}
    want_a = {"kernel": {"flash_attention": 2 * per,
                         "phantom_fused_matmul": 6 * per,
                         "matmul_nt": 3 * per, "matmul_tn": 3 * per},
              "plain": none}
    n = cfg.num_layers // LM_PP * LM_PP_M
    want_main = {"flash_attention": 2 * n, "phantom_fused_matmul": 6 * n,
                 "matmul_nt": 3 * n, "matmul_tn": 3 * n}
    worst = {}
    for r in ranks:
        rk = r["rank"]
        for key in ("kernel_vs_plain", "adafactor", "pp2_vs_pp1"):
            for part in ("loss", "grads", "params"):
                diff = r[key][part]
                check(diff["outside"] == 0,
                      f"lm_train_pp rank {rk}: {key} {part} differ in "
                      f"{diff['outside']} of {diff['elements']} elements: "
                      f"{diff}")
                w = worst.setdefault(key, {}).setdefault(part, {})
                for k, v in diff.items():
                    w[k] = max(w.get(k, 0), v)
            check(r[key]["grads"]["max_scaled_err"] <= STEP1_TOL["rtol"],
                  f"lm_train_pp rank {rk}: {key} gradients differ by more "
                  f"than 1e-4 of the largest: {r[key]['grads']}")
        for key in ("kernel_vs_plain", "adafactor"):
            check(r[key]["launches"] == want_a,
                  f"lm_train_pp rank {rk}: {key} launches "
                  f"{r[key]['launches']}, want {want_a}")
        m = r["main"]
        check(all(math.isfinite(v) for v in m["losses"] + m["grad_norms"]),
              f"lm_train_pp rank {rk}: non-finite loss or gradient norm: "
              f"{m['losses']} {m['grad_norms']}")
        check(m["launches_per_step"] == want_main,
              f"lm_train_pp rank {rk}: launches per step "
              f"{m['launches_per_step']}, want {want_main} ({n} layers and "
              f"microbatches a stage, forward and recompute; the phantom "
              f"forward at 3 sites)")
        sent = m["collectives_per_step"].get("collective_permute", {}).get(
            "wire_bytes", 0)
        want = lm_pp_boundary_bytes(cfg, r["stage"])
        check(sent == want,
              f"lm_train_pp rank {rk}: {sent:.0f} boundary bytes a step, "
              f"the schedule's account {want:.0f}")
    return worst


def phase_lm_train_pp(pool=None):
    """phi3-mini with phantom MLP sites on pp ``LM_PP`` x tp ``LM_PP_TP``
    ranks sharing the card (gloo, card tensors through the host), the
    1F1B pipeline over ``LM_PP_M`` microbatches."""
    import statistics as st
    import torch
    from repro_torch.launch.train import train_config
    _free()
    kernels = _timed_kernels(
        "lm_train_pp", torch.Generator(device="cuda").manual_seed(SEED),
        (LM_PP_FLASH_SHAPE,), LM_PP_PHANTOM_SHAPES)
    t0 = time.perf_counter()
    ranks = _run_ranks(pool, _lm_pp_rank, 1, LM_PP_TP, pp=LM_PP)
    wall = time.perf_counter() - t0
    cfg = train_config(_lm_pp_args()).replace(num_layers=LM_PP_LAYERS)
    worst = _lm_pp_held(ranks, cfg)
    for key, what in (("kernel_vs_plain", "(a) kernels vs plain, AdamW"),
                      ("adafactor", "(a') kernels vs plain, Adafactor"),
                      ("pp2_vs_pp1", "(b) pp=2 vs pp=1, kernels, AdamW")):
        w = worst[key]
        print(f"lm_train_pp: {what}, {cfg.name} at {LM_PARITY_LAYERS} "
              f"layers, M={LM_PP_PARITY_M}, step 1, float32, worst over "
              f"ranks (held to rtol 1e-4 / atol 1e-5): loss "
              f"{w['loss']['max_abs_err']:.3e} (values "
              f"{ranks[-1][key]['loss_values']}), grads "
              f"{w['grads']['max_abs_err']:.3e} "
              f"({w['grads']['max_scaled_err']:.3e} of the largest), "
              f"params {w['params']['max_abs_err']:.3e}; near-zero "
              f"gradients {w['params']['near_zero_grad']} per rank at "
              f"most, differing by up to "
              f"{w['params']['max_abs_err_near_zero_grad']:.3e} (implied "
              f"{w['params']['max_implied_near_zero_grad']:.3e}); elements "
              f"outside 0 of {w['params']['elements']} per rank at most",
              flush=True)
    main = [r["main"] for r in ranks]
    med = [st.median(m["step_ms"][1:]) for m in main]
    tokens = LM_BATCH * LM_SEQ
    print(f"lm_train_pp: (c) {cfg.name} phantom, pp={LM_PP} x tp="
          f"{LM_PP_TP}, layers={cfg.num_layers}, batch {LM_BATCH} x seq "
          f"{LM_SEQ} in {LM_PP_M} microbatches, bf16, remat={cfg.remat}: "
          f"losses {[round(v, 4) for v in main[0]['losses']]}; per-rank "
          f"step ms {[[round(v, 1) for v in m['step_ms']] for m in main]}, "
          f"median of steps 2-{LM_PP_STEPS} {[round(v, 1) for v in med]}; "
          f"{tokens / max(med) * 1e3:.1f} tokens/s (slowest rank); "
          f"launches per step per rank {main[0]['launches_per_step']}; "
          f"local parameters per rank "
          f"{[m['params_local'] for m in main]}", flush=True)
    sent = [m["collectives_per_step"].get("collective_permute", {}).get(
        "wire_bytes", 0) for m in main]
    print(f"lm_train_pp: (c) boundary bytes per step per rank {sent} "
          f"(the schedule's account "
          f"{[lm_pp_boundary_bytes(cfg, r['stage']) for r in ranks]}); "
          f"wire bytes per step per rank "
          f"{[round(m['wire_bytes_per_step']) for m in main]}; by "
          f"collective (rank 0): {main[0]['collectives_per_step']}",
          flush=True)
    print(f"lm_train_pp: (c) peak memory per rank (GB) "
          f"{[round(m['peak_memory_gb'], 2) for m in main]}; card used "
          f"(GB, as each rank read it after its run) "
          f"{[round(m['card_used_gb'], 2) for m in main]}", flush=True)
    prof = [m["profile"] for m in main]
    print(f"lm_train_pp: (c) one more step, collectives timed on every "
          f"rank (rank 0 also profiled): wall ms "
          f"{[round(p['wall_ms'], 1) for p in prof]}, in collectives "
          f"(copies and gloo) "
          f"{[round(p['collective_ms'], 1) for p in prof]} over "
          f"{[p['calls'] for p in prof]} calls, waiting for the card before "
          f"them {[round(p['device_wait_ms'], 1) for p in prof]}; rank 0's "
          f"device {prof[0]['device_ms']} ms (busy "
          f"{prof[0]['device_busy_share']}), by kind "
          f"{prof[0]['device_ms_by_kind']}, {prof[0]['device_ops']} "
          f"device ops, its boundary isends pending "
          f"{prof[0]['gloo_send_ms']:.1f} ms (host); top: "
          f"{ {k: round(v, 3) for k, v in prof[0]['top_device_ms'].items()} }",
          flush=True)
    print(f"lm_train_pp: the phase took {wall:.1f} s in the ranks",
          flush=True)
    return {"kernels": kernels, "ranks": ranks, "worst": worst,
            "median_step_ms": med, "tokens_per_s": tokens / max(med) * 1e3,
            "launches_per_step": main[0]["launches_per_step"],
            "wall_s": wall}


def _moe_streams(cfg, weights, requests):
    """Greedy token streams of ``requests`` (fresh copies) through a new
    ``ServeEngine`` of ``cfg`` on ``weights``: the traffic of phase 4's
    closed batch on an engine that served nothing before."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, weights, slots=SLOTS, max_len=MAX_LEN,
                      page_size=PAGE, device="cuda")
    reqs = [Request(prompt=r.prompt.copy(), max_new_tokens=NEW_TOKENS,
                    req_id=r.req_id) for r in requests]
    eng.run(reqs)
    return [list(r.out_tokens) for r in reqs]


def _agreement(a, b):
    """Streams equal, and each pair's tokens before the first that
    differs."""
    def same(x, y):
        n = 0
        while n < min(len(x), len(y)) and x[n] == y[n]:
            n += 1
        return n
    return {"equal_streams": sum(x == y for x, y in zip(a, b)),
            "of": len(a), "tokens_before_first_difference":
            [same(x, y) for x, y in zip(a, b)]}


def _moe_serve():
    """(a): olmoe-1b-7b at full width (``SERVE_DEPTH``) and tp = 1 through
    ``ServeEngine``,
    phase 4's traffic, ``kernel_backend="pallas"``; the flash launches
    held to the prefill groups x layers; a profiled decode window; the
    first group's prefill on both cores (``_compare_cores``); the first 8
    requests' greedy streams on the plain path (``"xla"``) from the same
    weights, in bf16 as served and in float32 activations."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, with_kernel_backend
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import count_params, model_decls
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import bucket_of

    cfg = with_kernel_backend(get_config(MOE_ARCH), "pallas").replace(
        num_layers=SERVE_DEPTH[MOE_ARCH])
    t0 = time.perf_counter()
    # float32 draw, kept for the float32 streams; the engine casts a copy
    params = materialize(model_decls(cfg, MeshAxes()), torch.Generator(
        device="cuda").manual_seed(SEED), "cuda")
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                      page_size=PAGE, device="cuda")
    torch.cuda.synchronize()
    weights_gb = sum(t.numel() * t.element_size() for t in
                     _leaves(eng.params)) / 1e9
    router = eng.params["layers"]["ffn"]["router"]["w"]
    check(router.dtype == torch.float32,
          f"moe serve: the router is served in {router.dtype}")
    n_params = count_params(cfg)
    print(f"moe serve: {cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"experts={cfg.moe.num_experts} top-{cfg.moe.top_k} params="
          f"{n_params:,} (active {count_params(cfg, active_only=True):,}); "
          f"weights on card {weights_gb:.2f} GB (routers and head fp32), "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)

    closed = closed_batch(cfg.vocab_size, 8, 16, NEW_TOKENS, SEED)
    rng = np.random.RandomState(SEED + 1)
    mixed = [Request(prompt=rng.randint(0, cfg.vocab_size, n)
                     .astype(np.int32), max_new_tokens=NEW_TOKENS,
                     req_id=100 + i) for i, n in enumerate(MIXED_LENS)]
    eng.warmup(sorted({bucket_of(n, PAGE) for n in MIXED_LENS + (16,)}))

    # --- the main path: counts from zero, read right after ---------------
    torch.cuda.reset_peak_memory_stats()
    groups0 = eng.prefill_meter.calls
    flash_attention.launches = 0
    eng.run(closed)
    rep_closed = slo_report(closed)
    for r in mixed:
        r.arrival_s = eng.now_s
    eng.run(mixed)
    launches = flash_attention.launches
    groups = eng.prefill_meter.calls - groups0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rep_mixed = slo_report(mixed)
    for r in closed + mixed:
        check(r.done and len(r.out_tokens) == NEW_TOKENS,
              f"moe serve: request {r.req_id} ended with "
              f"{len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"moe serve: request {r.req_id} sampled out-of-vocab tokens")
    check(launches == groups * cfg.num_layers,
          f"moe serve: flash kernel launched {launches} times for {groups} "
          f"prefill groups x {cfg.num_layers} layers")
    for name, rep in (("closed", rep_closed), ("mixed", rep_mixed)):
        print(f"moe serve {name}: requests={rep['requests']} "
              f"tokens={rep['generated_tokens']} "
              f"TTFT p50={rep['ttft_ms']['p50']:.3f} ms "
              f"TPOT p50={rep['tpot_ms']['p50']:.3f} ms "
              f"tokens/s={rep['tokens_per_s']:.1f}", flush=True)
    print(f"moe serve: prefill groups={groups} flash launches={launches}; "
          f"peak memory {peak_gb:.2f} GB (the float32 draw held beside the "
          f"engine); prefill step median "
          f"{eng.prefill_meter.median_us() / 1e3:.3f} ms, decode "
          f"{eng.decode_meter.median_us() / 1e3:.3f} ms", flush=True)
    profile = _profile_decode(eng, cfg)

    # --- the backends on the same weights, outside the main path --------
    toks = torch.from_numpy(np.stack([r.prompt for r in closed[:SLOTS]])
                            ).long().cuda()
    cores = _compare_cores(cfg, MeshAxes(), eng.params, toks, "moe serve")
    plain = with_kernel_backend(cfg, "xla")
    main = [list(r.out_tokens) for r in closed]
    bf16 = _agreement(main, _moe_streams(plain, eng.params, closed))
    del eng
    _free()
    fp32 = _agreement(
        _moe_streams(cfg.replace(dtype="float32"), params, closed),
        _moe_streams(plain.replace(dtype="float32"), params, closed))
    print(f"moe serve: greedy streams of the first 8 requests, kernel vs "
          f"plain backend on the same weights: bf16 as served {bf16}; "
          f"float32 activations {fp32}", flush=True)
    # float32: the same function, the same tokens.  bf16: the kernel
    # rounds P and its output where the plain core keeps float32, and
    # where that swaps an expert at a near tie (``_compare_cores`` counts
    # them) the stream parts; the prefill's first token is held, the
    # rest printed
    check(fp32["equal_streams"] == fp32["of"],
          f"moe serve: float32 greedy streams differ between the kernel "
          f"and the plain backend: {fp32}")
    check(min(bf16["tokens_before_first_difference"]) >= 1,
          f"moe serve: bf16 first tokens differ between the kernel and the "
          f"plain backend: {bf16}")
    del params
    _free()
    return {"launches": launches, "prefill_groups": groups,
            "params": n_params, "weights_gb": weights_gb,
            "peak_memory_gb": peak_gb, "closed": rep_closed,
            "mixed": rep_mixed, "decode_profile": profile,
            "cores": cores, "streams_bf16": bf16, "streams_float32": fp32}


def _moe_rank(axes, device):
    """``phase_moe`` inside one of the ``LM_TP`` ranks sharing the card:
    (a) olmoe-1b-7b's step 1 at full width and ``LM_PARITY_LAYERS``
    layers, fp32, through the kernels against plain torch (phantom
    q/k/v/o sites, ``fp``), and each path's aux loss; (b) tp = 4 against
    tp = 1, loss and gradients, with its attention sites dense and the
    stream still feature-sharded (``phantom_projection_map(k,
    ffn=True)``: olmoe has no MLP site, so every projection is dense and
    every rank routes every token, the function of tp = 1; phantom
    factors differ with tp), one rank at a time holding the tp = 1
    model; (c) granite-moe-3b-a800m (ring attention, tensor-partitioned
    experts, ``sp``) at ``LM_PARITY_LAYERS`` layers, fp32, one AdamW
    step at tp = 4 against tp = 1; (d) the main path, olmoe-1b-7b at
    ``MOE_LAYERS`` layers, bf16, ``MOE_STEPS`` steps and one more
    profiled (``_lm_tp_train``)."""
    import torch
    from repro_torch.configs.base import (phantom_projection_map,
                                          with_kernel_backend)
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.launch.train import train_config
    from repro_torch.models.model import forward_train, model_decls
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize_shards, shard_params

    out = {"rank": axes.rank}
    one = MeshAxes()
    args = _lm_args(["--steps", str(MOE_STEPS)], arch=MOE_ARCH)
    base = train_config(args).replace(num_layers=MOE_LAYERS)
    cut = base.replace(num_layers=LM_PARITY_LAYERS, dtype="float32")
    batch = LMDataset(cut.vocab_size, args.batch, args.seq + 1,
                      device=device)(0)
    sched = warmup_cosine(3e-4, 20, MOE_STEPS)

    # (a) kernels against plain, phantom q/k/v/o sites, float32
    params = materialize_shards(model_decls(cut, axes), axes, SEED, device,
                                draw_on=device)
    res, launches, aux = {}, {}, {}
    for name, backend in (("kernel", "auto"), ("plain", "xla")):
        c = with_kernel_backend(cut, backend)
        res[name], launches[name], eps = _tp_step1(c, axes, device, params,
                                                   batch, sched)
        with torch.no_grad():
            aux[name] = float(forward_train(c, axes, params, batch)[2])
    out["kernel_vs_plain"] = {
        part: _step1_diff(res, part, sched(0), eps)
        for part in ("loss", "grads", "params")}
    out["kernel_vs_plain"].update(
        launches=launches, aux_values=aux,
        loss_values={n: float(r["loss"]) for n, r in res.items()})
    del params, res
    _free()

    # (b) tp = 4 against tp = 1, the fp layout with dense sites
    fp_dense = with_kernel_backend(cut.replace(
        projections=phantom_projection_map(cut.projection_spec(
            "attn_q").k, ffn=True)), "auto")
    decls = model_decls(fp_dense, axes)
    params = materialize_shards(decls, axes, SEED, device, draw_on=device)
    mine = _grads_step1(fp_dense, axes, device, params, batch)
    del params
    _free()
    for turn in range(axes.tp):
        if turn == axes.tp_rank:
            params = materialize_shards(model_decls(fp_dense, one), one,
                                        SEED, device, draw_on=device)
            full = _grads_step1(fp_dense, one, device, params, batch)
            del params
            res = {"kernel": mine, "plain": {
                "loss": full["loss"],
                "grads": shard_params(full["grads"], decls, axes)}}
            del full
            out["tp4_vs_tp1"] = {part: _step1_diff(res, part, 0.0, eps)
                                 for part in ("loss", "grads")}
            out["tp4_vs_tp1"]["loss_values"] = {
                "tp4": float(res["kernel"]["loss"]),
                "tp1": float(res["plain"]["loss"])}
            del res
            _free()
        # one rank at a time holds the tp = 1 model
        axes.tp_comm.all_reduce(torch.zeros(1, device=device))
    del mine
    _free()

    # (c) granite-moe-3b: the tensor partition, tp = 4 against tp = 1
    gargs = _lm_args([], arch=GRANITE_ARCH)
    granite = train_config(gargs).replace(num_layers=LM_PARITY_LAYERS,
                                          dtype="float32")
    gbatch = LMDataset(granite.vocab_size, gargs.batch, gargs.seq + 1,
                       device=device)(0)
    gdecls = model_decls(granite, axes)
    params = materialize_shards(gdecls, axes, SEED, device, draw_on=device)
    res = {}
    res["kernel"], glaunch, _ = _tp_step1(granite, axes, device, params,
                                          gbatch, sched)
    del params
    params = materialize_shards(model_decls(granite, one), one, SEED,
                                device, draw_on=device)
    full, _, _ = _tp_step1(granite, one, device, params, gbatch, sched)
    del params
    res["plain"] = {key: full[key] if key == "loss" else
                    shard_params(full[key], gdecls, axes)
                    for key in ("loss", "grads", "params")}
    del full
    out["granite_tp4_vs_tp1"] = {
        part: _step1_diff(res, part, sched(0), eps)
        for part in ("loss", "grads", "params")}
    out["granite_tp4_vs_tp1"].update(
        launches=glaunch,
        loss_values={"tp4": float(res["kernel"]["loss"]),
                     "tp1": float(res["plain"]["loss"])})
    del res
    _free()

    # (d) the main path --------------------------------------------------
    out["main"] = _lm_tp_train(axes, device, base, args, MOE_STEPS,
                               profile=True)
    return out


def _moe_held(ranks, cfg):
    """Hold every rank's (a), (b), (c), the launches of (a), (c) and of the
    main path, its losses and its wire bytes against ``moe_wire_bytes``;
    returns the worst of (a), (b), (c) over the ranks."""
    import math
    L, n = LM_PARITY_LAYERS, cfg.num_layers
    none = {"flash_attention": 0, "phantom_fused_matmul": 0, "matmul_nt": 0,
            "matmul_tn": 0}

    def path(layers):   # four phantom sites and flash, fwd and recompute
        return _path_launches(layers, 4)
    want = {"kernel_vs_plain": {"kernel": path(L), "plain": none},
            "granite_tp4_vs_tp1": none}
    wire = moe_wire_bytes(cfg, LM_BATCH, LM_SEQ, LM_TP)
    worst = {}
    for r in ranks:
        rk = r["rank"]
        for key in ("kernel_vs_plain", "tp4_vs_tp1", "granite_tp4_vs_tp1"):
            parts = ("loss", "grads") + (("params",) if key != "tp4_vs_tp1"
                                         else ())
            for part in parts:
                diff = r[key][part]
                check(diff["outside"] == 0,
                      f"moe rank {rk}: {key} {part} differ in "
                      f"{diff['outside']} of {diff['elements']} elements: "
                      f"{diff}")
                w = worst.setdefault(key, {}).setdefault(part, {})
                for k, v in diff.items():
                    w[k] = max(w.get(k, 0), v)
            check(r[key]["grads"]["max_scaled_err"] <= STEP1_TOL["rtol"],
                  f"moe rank {rk}: {key} gradients differ by more than 1e-4 "
                  f"of the largest: {r[key]['grads']}")
            if key in want:
                check(r[key]["launches"] == want[key],
                      f"moe rank {rk}: {key} launches "
                      f"{r[key]['launches']}, want {want[key]}")
        m = r["main"]
        check(all(math.isfinite(v) for v in m["losses"] + m["grad_norms"]),
              f"moe rank {rk}: non-finite loss or gradient norm: "
              f"{m['losses']} {m['grad_norms']}")
        check(m["launches_per_step"] == path(n),
              f"moe rank {rk}: launches per step {m['launches_per_step']}, "
              f"want {path(n)} (flash and the phantom forward at 4 sites, "
              f"forward and recompute)")
        check(m["wire_bytes_per_step"] == wire,
              f"moe rank {rk}: {m['wire_bytes_per_step']:.0f} wire bytes a "
              f"step, predicted {wire:.0f}")
    return worst


def phase_moe(pool=None):
    """The MoE family: the kernels at olmoe-1b-7b's shapes, its serving at
    full width (``_moe_serve``), then ``LM_TP`` ranks sharing the card
    (gloo, card tensors through the host) running ``_moe_rank``."""
    import statistics as st
    import torch
    from repro_torch.launch.train import train_config
    _free()
    kernels = _timed_kernels(
        "moe", torch.Generator(device="cuda").manual_seed(SEED),
        (MOE_SERVE_FLASH_SHAPE, MOE_TP_FLASH_SHAPE), (MOE_PHANTOM_SHAPE,))
    serve = _moe_serve()
    t0 = time.perf_counter()
    ranks = _run_ranks(pool, _moe_rank, 1, LM_TP)
    wall = time.perf_counter() - t0
    cfg = train_config(_lm_args([], arch=MOE_ARCH)).replace(
        num_layers=MOE_LAYERS)
    worst = _moe_held(ranks, cfg)
    for key, what in (
            ("kernel_vs_plain", f"(a) {cfg.name}, kernels vs plain"),
            ("tp4_vs_tp1", f"(b) {cfg.name}, fp dense sites, tp=4 vs tp=1"),
            ("granite_tp4_vs_tp1",
             f"(c) {GRANITE_ARCH}, tensor partition, tp=4 vs tp=1")):
        w = worst[key]
        print(f"moe: {what} at {LM_PARITY_LAYERS} layers, step 1, float32, "
              f"worst over ranks (rtol 1e-4 / atol 1e-5): loss "
              f"{w['loss']['max_abs_err']:.3e} (values "
              f"{ranks[0][key]['loss_values']}), grads "
              f"{w['grads']['max_abs_err']:.3e} "
              f"({w['grads']['max_scaled_err']:.3e} of the largest)"
              + (f", params {w['params']['max_abs_err']:.3e}; near-zero "
                 f"gradients {w['params']['near_zero_grad']} per rank at "
                 f"most, differing by up to "
                 f"{w['params']['max_abs_err_near_zero_grad']:.3e} (implied "
                 f"{w['params']['max_implied_near_zero_grad']:.3e})"
                 if "params" in w else "")
              + f"; elements outside 0 of {w['grads']['elements']} per rank "
              f"at most", flush=True)
    print(f"moe: (a) aux loss (summed over the layers; the objective adds "
          f"0.01 x aux / dp) {ranks[0]['kernel_vs_plain']['aux_values']}",
          flush=True)
    main = [r["main"] for r in ranks]
    med = [st.median(m["step_ms"][1:]) for m in main]
    tokens = LM_BATCH * LM_SEQ
    wire = moe_wire_bytes(cfg, LM_BATCH, LM_SEQ, LM_TP)
    print(f"moe: (d) {cfg.name} phantom q/k/v/o, experts over all-to-all, "
          f"tp={LM_TP}, layers={cfg.num_layers}, batch {LM_BATCH} x seq "
          f"{LM_SEQ}, bf16, remat={cfg.remat}: losses "
          f"{[round(v, 4) for v in main[0]['losses']]}; per-rank step ms "
          f"{[[round(v, 1) for v in m['step_ms']] for m in main]}, median "
          f"of steps 2-{MOE_STEPS} {[round(v, 1) for v in med]}; "
          f"{tokens / max(med) * 1e3:.1f} tokens/s (slowest rank); launches "
          f"per step per rank {main[0]['launches_per_step']}; local "
          f"parameters per rank {main[0]['params_local']:,}", flush=True)
    print(f"moe: (d) wire bytes per step per rank "
          f"{[round(m['wire_bytes_per_step']) for m in main]}, predicted "
          f"{wire:.0f} (moe_wire_bytes); by collective (rank 0): "
          f"{main[0]['collectives_per_step']}", flush=True)
    print(f"moe: (d) peak memory per rank (GB) "
          f"{[round(m['peak_memory_gb'], 2) for m in main]}; card used "
          f"(GB, as each rank read it after its run) "
          f"{[round(m['card_used_gb'], 2) for m in main]}", flush=True)
    prof = [m["profile"] for m in main]
    print(f"moe: (d) one more step, collectives timed on every rank (rank 0 "
          f"also profiled): wall ms {[round(p['wall_ms'], 1) for p in prof]}"
          f", in collectives (copies and gloo) "
          f"{[round(p['collective_ms'], 1) for p in prof]} over "
          f"{prof[0]['calls']} calls, waiting for the card before them "
          f"{[round(p['device_wait_ms'], 1) for p in prof]}; rank 0's "
          f"device {prof[0]['device_ms']} ms (busy "
          f"{prof[0]['device_busy_share']}), by kind "
          f"{prof[0]['device_ms_by_kind']}, {prof[0]['device_ops']} device "
          f"ops; top: "
          f"{ {k: round(v, 3) for k, v in prof[0]['top_device_ms'].items()} }",
          flush=True)
    print(f"moe: the ranks took {wall:.1f} s", flush=True)
    return {"kernels": kernels, "serve": serve, "ranks": ranks,
            "worst": worst, "median_step_ms": med,
            "tokens_per_s": tokens / max(med) * 1e3,
            "launches_per_step": main[0]["launches_per_step"],
            "wire_bytes_predicted": wire, "wall_s": wall}


def _mamba_serve():
    """(a): mamba2-370m at full width (``SERVE_DEPTH``) and tp = 1 through
    ``ServeEngine``,
    phase 4's traffic, every prompt its own exact-length group (the
    recurrent families cannot be right-padded; page size 1 admits every
    length).  Every request's ``NEW_TOKENS`` tokens, TTFT and TPOT, a profiled
    decode window, the state cache's bytes; then the recurrence check on the
    closed batch's first group (``_recurrence_check``).  No kernel runs
    here: the SSD scan is plain torch, as the reference's is XLA, and
    phantom needs tp > 1."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, with_kernel_backend
    from repro_torch.models.model import count_params, model_decls
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = with_kernel_backend(get_config(MAMBA_ARCH), "pallas").replace(
        num_layers=SERVE_DEPTH[MAMBA_ARCH])
    t0 = time.perf_counter()
    # float32 draw, kept for the recurrence check; the engine casts a copy
    params = materialize(model_decls(cfg, MeshAxes()), torch.Generator(
        device="cuda").manual_seed(SEED), "cuda")
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                      page_size=MAMBA_PAGE, device="cuda")
    torch.cuda.synchronize()
    n_params = count_params(cfg)
    state_bytes = sum(c.numel() * c.element_size()
                      for c in eng.cache.values())
    shapes = {k: (list(c.shape), str(c.dtype)) for k, c in eng.cache.items()}
    print(f"mamba serve: {cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"d_state={cfg.ssm.d_state} params={n_params:,}; state cache "
          f"{state_bytes / 1e6:.2f} MB for {SLOTS} slots ({shapes}), set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    closed = closed_batch(cfg.vocab_size, 8, 16, NEW_TOKENS, SEED)
    rng = np.random.RandomState(SEED + 1)
    mixed = [Request(prompt=rng.randint(0, cfg.vocab_size, n)
                     .astype(np.int32), max_new_tokens=NEW_TOKENS,
                     req_id=100 + i) for i, n in enumerate(MIXED_LENS)]
    eng.warmup(sorted(set(MIXED_LENS + (16,))))
    torch.cuda.reset_peak_memory_stats()
    groups0 = eng.prefill_meter.calls
    eng.run(closed)
    rep_closed = slo_report(closed)
    for r in mixed:
        r.arrival_s = eng.now_s
    eng.run(mixed)
    rep_mixed = slo_report(mixed)
    groups = eng.prefill_meter.calls - groups0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in closed + mixed:
        check(r.done and r.error is None and len(r.out_tokens) == NEW_TOKENS,
              f"mamba serve: request {r.req_id} ended with "
              f"{len(r.out_tokens)} tokens ({r.error})")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"mamba serve: request {r.req_id} sampled out-of-vocab tokens")
    # 8 closed prompts of 16 in groups of SLOTS; each mixed length alone
    check(groups == 8 // SLOTS + len(MIXED_LENS),
          f"mamba serve: {groups} prefill groups")
    for name, rep in (("closed", rep_closed), ("mixed", rep_mixed)):
        print(f"mamba serve {name}: requests={rep['requests']} "
              f"tokens={rep['generated_tokens']} "
              f"TTFT p50={rep['ttft_ms']['p50']:.3f} ms "
              f"TPOT p50={rep['tpot_ms']['p50']:.3f} ms "
              f"tokens/s={rep['tokens_per_s']:.1f}", flush=True)
    print(f"mamba serve: prefill groups={groups} (exact-length); peak "
          f"memory {peak_gb:.2f} GB (the float32 draw held beside the "
          f"engine); prefill step median "
          f"{eng.prefill_meter.median_us() / 1e3:.3f} ms, decode "
          f"{eng.decode_meter.median_us() / 1e3:.3f} ms", flush=True)
    profile = _profile_decode(eng, cfg)
    del eng
    _free()

    # --- the recurrence check, float32, outside the main path -----------
    recurrence, end_to_end = _recurrence_check(cfg.replace(dtype="float32"),
                                               params, closed[:SLOTS])
    del params
    _free()
    return {"params": n_params, "state_bytes": state_bytes,
            "prefill_groups": groups, "peak_memory_gb": peak_gb,
            "closed": rep_closed, "mixed": rep_mixed,
            "decode_profile": profile, "recurrence": recurrence,
            "recurrence_end_to_end": end_to_end}


def _recurrence_check(cfg, params, requests, tag="mamba serve",
                      stubs=None):
    """Prefill against token-by-token decode, in float32 on the requests'
    prompts (one group): layer by layer from the same input, every
    position's output and the prefill's cache (an SSD block's final
    ``{"conv", "ssm"}`` state: the chunked scan against the recurrence;
    an attention block's K/V rows; a decoder block's self K/V, its
    cross K/V given to the decode as the prefill made them) against
    decoding the prompt token by token from a zero cache, and the last
    logits of both from the last layer's outputs, each within
    ``RECURRENCE_TOL`` of its largest magnitude.  The prefill's batch
    carries the serving engine's stubs (``serve/engine.py:
    _add_modality_stubs``), or ``stubs`` in their place (seamless's
    random frames: on zero frames its memory is zero).  Held per layer
    because 48 random layers amplify one-ulp differences; the end-to-end
    gap (``forward_prefill`` against ``forward_decode``) is printed (for
    qwen2-vl it includes the vision rows, which prefill splices in and
    decode, fed the tokens, does not)."""
    import numpy as np
    import torch
    from repro_torch.models.blocks import block_apply, layer_plan, plan_period
    from repro_torch.models.layers import head_logits, norm_apply
    from repro_torch.models.layers import residual_layout
    from repro_torch.models.model import (_embed, _enc_stack, _positions,
                                          cache_decls, forward_decode,
                                          forward_prefill)
    from repro_torch.models.ssm import ssm_cache_shape
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import tree_leaves, tree_map
    from repro_torch.serve.engine import _add_modality_stubs
    one = MeshAxes()
    toks = torch.from_numpy(np.stack([r.prompt for r in requests])
                            ).long().cuda()
    B, S = toks.shape
    batch = _add_modality_stubs(cfg, {"tokens": toks}, B, S)
    batch.update(stubs or {})
    encdec = cfg.family == "encdec"
    lay = residual_layout(cfg, "prefill")
    plan = layer_plan(cfg)[:plan_period(cfg)]
    worst = {}

    def held(name, got, want, layer):
        scale = want.abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        w = worst.setdefault(name, {"max_abs_err": 0.0, "max_scaled_err": 0.0})
        w["max_abs_err"] = max(w["max_abs_err"], err)
        w["max_scaled_err"] = max(w["max_scaled_err"], err / scale)
        check(bool(torch.isfinite(got).all()) and err <= RECURRENCE_TOL
              * scale, f"{tag}: recurrence check, layer {layer} "
                       f"{name}: prefill and token-by-token decode differ "
                       f"by {err:.3e} (largest {scale:.3e})")

    def zero_cache(mixer, state):
        if mixer == "mamba":
            return {k: torch.zeros(shape, device="cuda") for k, (shape, _)
                    in ssm_cache_shape(cfg, one, B).items()}
        shape = (B, S, cfg.num_kv_heads, cfg.resolved_head_dim())
        kv = {k: torch.zeros(shape, device="cuda") for k in ("k", "v")}
        return {"self": kv, "cross": state["cross"]} if encdec else kv

    V = cfg.vocab_size      # the padded columns are masked to -1e30

    def logits(h):
        return head_logits(cfg, lay, params["head"], norm_apply(
            cfg, lay, params["final_norm"], h, one)[:, -1:], one)[..., :V]
    positions = _positions(cfg, batch, B, S, toks.device)
    key = "dec_layers" if encdec else "layers"
    with torch.no_grad():
        memory = (_enc_stack(cfg, lay, params, one, batch["frames"],
                             kind="prefill") if encdec else None)
        h = _embed(cfg, lay, params, batch, one)
        for i in range(cfg.num_layers):
            mixer, ffn = plan[i % len(plan)]
            lp = tree_map(lambda t: t[i // len(plan)], params[key])
            if len(plan) > 1:
                lp = lp[f"sub{i % len(plan)}"]
            h_pre, state, _ = block_apply(cfg, lay, lp, h, positions, one,
                                          kind="prefill", ffn=ffn,
                                          mixer=mixer, return_kv=True,
                                          memory=memory)
            cache = zero_cache(mixer, state)
            outs = []
            for t in range(S):
                o, cache, _ = block_apply(cfg, lay, lp, h[:, t:t + 1], None,
                                          one, kind="decode", ffn=ffn,
                                          mixer=mixer, cache=cache,
                                          pos=torch.full((B,), t,
                                                         device="cuda"))
                outs.append(o)
            held("outputs", torch.cat(outs, 1), h_pre, i)
            want = dict(tree_leaves(state))
            for name, c in tree_leaves(cache):
                held(name, c, want[name], i)
            h = h_pre
        held("logits", logits(outs[-1]), logits(h_pre), cfg.num_layers)
        lg_pre, pre = forward_prefill(cfg, one, params, batch)
        cache = tree_map(lambda sp: torch.zeros(sp.shape, device="cuda"),
                         cache_decls(cfg, one, B, S))
        if encdec:
            for name in ("k", "v"):
                cache["cross"][name].copy_(pre["cross"][name])
        for t in range(S):
            lg_dec, cache = forward_decode(cfg, one, params, cache,
                                           toks[:, t:t + 1],
                                           torch.full((B,), t, device="cuda"))
    lg_dec, lg_pre = lg_dec[..., :V], lg_pre[..., :V]
    end_to_end = ((lg_dec - lg_pre).abs().max()
                  / lg_pre.abs().max()).item()
    shown = ", ".join(f"{k} {v['max_scaled_err']:.3e}"
                      for k, v in worst.items())
    print(f"{tag}: recurrence check (float32, {B} x {S} tokens, "
          f"{cfg.num_layers} layers, each from the prefill's input to it): "
          f"prefill against token-by-token decode from a zero cache, worst "
          f"over the layers as a share of the largest: {shown} (held to "
          f"{RECURRENCE_TOL}); end to end (printed, not held: random layers "
          f"amplify rounding) the last logits differ by {end_to_end:.3e} of "
          f"the largest", flush=True)
    return worst, end_to_end


def _dp_cut(tree, decls, axes):
    """This rank's block of every dp-sharded dim of a tree that is
    replicated over dp (the same run without FSDP), so that it compares
    leaf by leaf with the FSDP run's shards."""
    from repro_torch.parallel.params import tree_leaves, tree_unflatten
    dflat = dict(tree_leaves(decls))
    flat = {}
    for path, t in tree_leaves(tree):
        for dim, e in enumerate(dflat[path].spec):
            if e == "dp":
                n = t.shape[dim] // axes.dp
                t = t.narrow(dim, axes.dp_rank * n, n)
        flat[path] = t
    return tree_unflatten(tree, flat)


def _fsdp_step1(base, axes, device, batch, sched, parts):
    """Step 1 of ``base`` with ``fsdp=True`` ("kernel" in
    ``_step1_diff``'s terms) against ``fsdp=False`` ("plain") on the same
    mesh, the same global weights and the same kernels: the parts
    compared, the launches of each run."""
    from repro_torch.models.model import model_decls
    from repro_torch.parallel.params import materialize_shards
    res, launches = {}, {}
    fdecls = model_decls(base.replace(fsdp=True), axes)
    for name, on in (("kernel", True), ("plain", False)):
        c = base.replace(fsdp=on)
        params = materialize_shards(model_decls(c, axes), axes, SEED,
                                    device, draw_on=device)
        r, launches[name], eps = _tp_step1(c, axes, device, params, batch,
                                           sched)
        del params
        if not on:
            r = {"loss": r["loss"], "grads": _dp_cut(r["grads"], fdecls,
                                                     axes),
                 "params": _dp_cut(r["params"], fdecls, axes)}
        res[name] = r
    out = {part: _step1_diff(res, part, sched(0), eps) for part in parts}
    out.update(launches=launches, loss_values={
        n: float(r["loss"]) for n, r in res.items()})
    del res
    _free()
    return out


def _fsdp_rank(axes, device):
    """Phase 13 (c) inside one rank of a dp ``FSDP_DP`` x tp ``FSDP_TP``
    mesh: phi3-mini at full width, phantom MLP sites.  Step 1 at
    ``LM_PARITY_LAYERS`` layers, fp32, through the kernels, with
    ``fsdp=True`` against ``fsdp=False`` (AdamW: loss, gradients and
    parameters; Adafactor: loss and gradients, its factored moments being
    per shard); then the main path at ``FSDP_LAYERS`` layers, bf16,
    ``FSDP_STEPS`` steps with FSDP and one more profiled, and the same
    steps without it; then mamba2's step 1 with and without FSDP."""
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.launch.train import train_config
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train.trainer import local_rows
    out = {"rank": axes.rank}
    args = _lm_args(["--steps", str(FSDP_STEPS), "--dp", str(FSDP_DP),
                     "--tp", str(FSDP_TP)])
    base = train_config(args).replace(num_layers=FSDP_LAYERS)
    cut = base.replace(num_layers=LM_PARITY_LAYERS, dtype="float32")
    batch = local_rows(LMDataset(cut.vocab_size, args.batch, args.seq + 1,
                                 device=device)(0), axes)
    sched = warmup_cosine(3e-4, 20, FSDP_STEPS)
    out["phi3_adamw"] = _fsdp_step1(cut, axes, device, batch, sched,
                                    ("loss", "grads", "params"))
    out["phi3_adafactor"] = _fsdp_step1(cut.replace(optimizer="adafactor"),
                                        axes, device, batch, sched,
                                        ("loss", "grads"))
    out["main"] = _lm_tp_train(axes, device, base.replace(fsdp=True), args,
                               FSDP_STEPS, profile=True)
    out["main_unsharded"] = _lm_tp_train(axes, device, base, args,
                                         FSDP_STEPS)
    margs = _lm_args([], arch=MAMBA_ARCH)
    mcut = train_config(margs).replace(num_layers=LM_PARITY_LAYERS,
                                       dtype="float32")
    mbatch = local_rows(LMDataset(mcut.vocab_size, margs.batch,
                                  margs.seq + 1, device=device)(0), axes)
    out["mamba_adamw"] = _fsdp_step1(mcut, axes, device, mbatch, sched,
                                     ("loss", "grads", "params"))
    return out


def _ssm_fsdp_rank(axes, device):
    """``phase_ssm_fsdp`` inside one of the ``LM_TP`` ranks sharing the
    card: (b) mamba2-370m at full width: step 1 at ``LM_PARITY_LAYERS``
    layers, fp32, phantom in/out sites through the kernels against plain
    torch, and dense sites (``sp``) at tp = 4 against tp = 1; then the
    main path at ``MAMBA_LAYERS`` layers, bf16, ``MAMBA_STEPS`` steps and
    one more profiled (``_lm_tp_train``).  (c) FSDP on a dp x tp mesh of
    the same ranks (``_fsdp_rank``)."""
    from repro_torch.configs.base import (dense_projection_map,
                                          with_kernel_backend)
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train_config
    from repro_torch.models.model import model_decls
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize_shards, shard_params

    out = {"rank": axes.rank}
    one = MeshAxes()
    args = _lm_args(["--steps", str(MAMBA_STEPS)], arch=MAMBA_ARCH)
    base = train_config(args).replace(num_layers=MAMBA_LAYERS)
    cut = base.replace(num_layers=LM_PARITY_LAYERS, dtype="float32")
    batch = LMDataset(cut.vocab_size, args.batch, args.seq + 1,
                      device=device)(0)
    sched = warmup_cosine(3e-4, 20, MAMBA_STEPS)

    # (b) kernels against plain, phantom in/out sites, float32
    params = materialize_shards(model_decls(cut, axes), axes, SEED, device,
                                draw_on=device)
    res, launches = {}, {}
    for name, backend in (("kernel", "auto"), ("plain", "xla")):
        res[name], launches[name], eps = _tp_step1(
            with_kernel_backend(cut, backend), axes, device, params, batch,
            sched)
    out["kernel_vs_plain"] = {
        part: _step1_diff(res, part, sched(0), eps)
        for part in ("loss", "grads", "params")}
    out["kernel_vs_plain"].update(
        launches=launches,
        loss_values={n: float(r["loss"]) for n, r in res.items()})
    del params, res
    _free()

    # (b) dense sites (sp), tp = 4 against tp = 1 from the same seed
    dense = with_kernel_backend(cut.replace(
        projections=dense_projection_map()), "auto")
    decls = model_decls(dense, axes)
    params = materialize_shards(decls, axes, SEED, device, draw_on=device)
    mine = _grads_step1(dense, axes, device, params, batch)
    del params
    params = materialize_shards(model_decls(dense, one), one, SEED, device,
                                draw_on=device)
    full = _grads_step1(dense, one, device, params, batch)
    del params
    res = {"kernel": mine, "plain": {
        "loss": full["loss"],
        "grads": shard_params(full["grads"], decls, axes)}}
    out["tp4_vs_tp1"] = {part: _step1_diff(res, part, 0.0, eps)
                         for part in ("loss", "grads")}
    out["tp4_vs_tp1"]["loss_values"] = {"tp4": float(mine["loss"]),
                                        "tp1": float(full["loss"])}
    del res, mine, full
    _free()

    # (b) the main path --------------------------------------------------
    out["main"] = _lm_tp_train(axes, device, base, args, MAMBA_STEPS,
                               profile=True)
    # (c) FSDP, new groups over the same ranks ----------------------------
    out["fsdp"] = _fsdp_rank(make_local_mesh(FSDP_DP, FSDP_TP), device)
    return out


def _path_launches(layers, sites, flash=True):
    """Launches a step a rank of ``layers`` blocks with ``sites`` phantom
    sites each under ``remat="full"``: flash and the phantom forward in
    the forward pass and the recompute, the dgrad and wgrad once."""
    return {"flash_attention": 2 * layers * flash,
            "phantom_fused_matmul": 2 * sites * layers,
            "matmul_nt": sites * layers, "matmul_tn": sites * layers}


def _ssm_fsdp_held(ranks, mcfg, fcfg):
    """Hold every rank's (b) and (c): step 1's parts with 0 elements
    outside and the launches they imply; the main paths' losses finite
    at every step, their launches per step and their wire bytes against
    ``ssm_wire_bytes`` and ``fsdp_wire_bytes``.  Returns the worst
    step-1 differences over the ranks."""
    import math
    L = LM_PARITY_LAYERS
    none = _path_launches(0, 0)
    worst = {}

    def hold(rk, key, res, launches=None):
        for part in ("loss", "grads", "params"):
            if part not in res:
                continue
            diff = res[part]
            check(diff["outside"] == 0,
                  f"ssm_fsdp rank {rk}: {key} {part} differ in "
                  f"{diff['outside']} of {diff['elements']} elements: "
                  f"{diff}")
            w = worst.setdefault(key, {}).setdefault(part, {})
            for k, v in diff.items():
                w[k] = max(w.get(k, 0), v)
        check(res["grads"]["max_scaled_err"] <= STEP1_TOL["rtol"],
              f"ssm_fsdp rank {rk}: {key} gradients differ by more than "
              f"1e-4 of the largest: {res['grads']}")
        if launches is not None:
            check(res["launches"] == launches,
                  f"ssm_fsdp rank {rk}: {key} launches {res['launches']}, "
                  f"want {launches}")

    def hold_main(rk, key, m, launches, wire):
        check(all(math.isfinite(v) for v in m["losses"] + m["grad_norms"]),
              f"ssm_fsdp rank {rk}: {key}: non-finite loss or gradient "
              f"norm: {m['losses']} {m['grad_norms']}")
        check(m["launches_per_step"] == launches,
              f"ssm_fsdp rank {rk}: {key}: launches per step "
              f"{m['launches_per_step']}, want {launches}")
        check(m["wire_bytes_per_step"] == wire,
              f"ssm_fsdp rank {rk}: {key}: {m['wire_bytes_per_step']:.0f} "
              f"wire bytes a step, counted {wire:.0f}")

    mwire = ssm_wire_bytes(mcfg, LM_BATCH, LM_SEQ, LM_TP)
    fwire = {on: fsdp_wire_bytes(fcfg.replace(fsdp=on), LM_BATCH, LM_SEQ,
                                 FSDP_TP, FSDP_DP) for on in (True, False)}
    phi3 = _path_launches(L, 3)
    for r in ranks:
        rk, f = r["rank"], r["fsdp"]
        hold(rk, "mamba_kernel_vs_plain", r["kernel_vs_plain"],
             {"kernel": _path_launches(L, 3, flash=False), "plain": none})
        hold(rk, "mamba_tp4_vs_tp1", r["tp4_vs_tp1"])
        hold_main(rk, "mamba main", r["main"],
                  _path_launches(mcfg.num_layers, 3, flash=False), mwire)
        hold(rk, "phi3_fsdp_vs_not_adamw", f["phi3_adamw"],
             {"kernel": phi3, "plain": phi3})
        hold(rk, "phi3_fsdp_vs_not_adafactor", f["phi3_adafactor"],
             {"kernel": phi3, "plain": phi3})
        mamba = _path_launches(L, 3, flash=False)
        hold(rk, "mamba_fsdp_vs_not_adamw", f["mamba_adamw"],
             {"kernel": mamba, "plain": mamba})
        launches = _path_launches(fcfg.num_layers, 3)
        hold_main(rk, "phi3 fsdp main", f["main"], launches, fwire[True])
        hold_main(rk, "phi3 unsharded", f["main_unsharded"], launches,
                  fwire[False])
    return worst, mwire, fwire


def phase_ssm_fsdp(pool=None):
    """The SSM family and FSDP: the kernels at mamba2-370m's tp = 4
    shapes and phi3-mini's dp 2 x tp 2 ones, mamba2's serving at full
    size (``_mamba_serve``), then ``LM_TP`` ranks sharing the card (gloo,
    card tensors through the host) running ``_ssm_fsdp_rank``."""
    import statistics as st
    import torch
    from repro_torch.launch.train import train_config
    _free()
    t0 = time.perf_counter()
    kernels = _timed_kernels(
        "ssm_fsdp", torch.Generator(device="cuda").manual_seed(SEED),
        (FSDP_FLASH_SHAPE,), MAMBA_PHANTOM_SHAPES + FSDP_PHANTOM_SHAPES)
    serve = _mamba_serve()
    t1 = time.perf_counter()
    ranks = _run_ranks(pool, _ssm_fsdp_rank, 1, LM_TP)
    wall = time.perf_counter() - t1
    mcfg = train_config(_lm_args([], arch=MAMBA_ARCH)).replace(
        num_layers=MAMBA_LAYERS)
    fcfg = train_config(_lm_args(["--dp", str(FSDP_DP), "--tp",
                                  str(FSDP_TP)])).replace(
        num_layers=FSDP_LAYERS)
    worst, mwire, fwire = _ssm_fsdp_held(ranks, mcfg, fcfg)
    for key, w in worst.items():
        print(f"ssm_fsdp: {key} at {LM_PARITY_LAYERS} layers, step 1, "
              f"float32, worst over ranks (rtol 1e-4 / atol 1e-5): "
              + "; ".join(f"{part} {v['max_abs_err']:.3e} ("
                          f"{v.get('max_scaled_err', 0):.3e} of the "
                          f"largest), {v['outside']} of {v['elements']} "
                          f"outside" for part, v in w.items()), flush=True)
    tokens = LM_BATCH * LM_SEQ
    main = [r["main"] for r in ranks]
    med = [st.median(m["step_ms"][1:]) for m in main]
    print(f"ssm_fsdp: (b) {mcfg.name} phantom in/out sites, tp={LM_TP}, "
          f"layers={mcfg.num_layers}, batch {LM_BATCH} x seq {LM_SEQ}, bf16, "
          f"remat={mcfg.remat}: losses "
          f"{[round(v, 4) for v in main[0]['losses']]}; per-rank step ms "
          f"{[[round(v, 1) for v in m['step_ms']] for m in main]}, median "
          f"of steps 2-{MAMBA_STEPS} {[round(v, 1) for v in med]}; "
          f"{tokens / max(med) * 1e3:.1f} tokens/s (slowest rank); launches "
          f"per step per rank {main[0]['launches_per_step']}; wire bytes "
          f"per step per rank {[round(m['wire_bytes_per_step']) for m in main]}"
          f", counted {mwire:.0f} (ssm_wire_bytes); peak memory per rank "
          f"(GB) {[round(m['peak_memory_gb'], 2) for m in main]}",
          flush=True)
    prof = [m["profile"] for m in main]
    print(f"ssm_fsdp: (b) one more step, collectives timed on every rank "
          f"(rank 0 also profiled): wall ms "
          f"{[round(p['wall_ms'], 1) for p in prof]}, in collectives "
          f"{[round(p['collective_ms'], 1) for p in prof]} over "
          f"{prof[0]['calls']} calls; rank 0's device "
          f"{prof[0]['device_ms']} ms (busy {prof[0]['device_busy_share']}),"
          f" by kind {prof[0]['device_ms_by_kind']}, "
          f"{prof[0]['device_ops']} device ops; top: "
          f"{ {k: round(v, 3) for k, v in prof[0]['top_device_ms'].items()} }",
          flush=True)
    fs = [r["fsdp"] for r in ranks]
    for key, what in (("main", "fsdp=True"),
                      ("main_unsharded", "fsdp=False")):
        ms = [f[key] for f in fs]
        fmed = [st.median(m["step_ms"][1:]) for m in ms]
        print(f"ssm_fsdp: (c) {fcfg.name} {what}, dp={FSDP_DP} x "
              f"tp={FSDP_TP}, layers={fcfg.num_layers}, bf16: losses "
              f"{[round(v, 4) for v in ms[0]['losses']]}; median step ms "
              f"{[round(v, 1) for v in fmed]}; "
              f"{tokens / max(fmed) * 1e3:.1f} tokens/s; launches per step "
              f"per rank {ms[0]['launches_per_step']}; wire bytes per step "
              f"per rank {[round(m['wire_bytes_per_step']) for m in ms]}, "
              f"counted {fwire[key == 'main']:.0f} (fsdp_wire_bytes); by "
              f"collective (rank 0) {ms[0]['collectives_per_step']}; "
              f"parameters + optimizer state per rank (GB) "
              f"{[round(m['state_bytes'] / 1e9, 3) for m in ms]}; peak "
              f"memory per rank (GB) "
              f"{[round(m['peak_memory_gb'], 2) for m in ms]}", flush=True)
    fprof = [f["main"]["profile"] for f in fs]
    print(f"ssm_fsdp: (c) one more fsdp step, collectives timed: wall ms "
          f"{[round(p['wall_ms'], 1) for p in fprof]}, in collectives "
          f"{[round(p['collective_ms'], 1) for p in fprof]}; rank 0's "
          f"device {fprof[0]['device_ms']} ms (busy "
          f"{fprof[0]['device_busy_share']}), by kind "
          f"{fprof[0]['device_ms_by_kind']}", flush=True)
    print(f"ssm_fsdp: the ranks took {wall:.1f} s; the phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"kernels": kernels, "serve": serve, "ranks": ranks,
            "worst": worst, "median_step_ms": med,
            "tokens_per_s": tokens / max(med) * 1e3,
            "launches_per_step": main[0]["launches_per_step"],
            "fsdp_launches_per_step": fs[0]["main"]["launches_per_step"],
            "wire_bytes_counted": {"mamba": mwire, "fsdp": fwire[True],
                                   "unsharded": fwire[False]},
            "wall_s": wall}


def hybrid_wire_bytes(cfg, batch, seq, p):
    """The logical wire bytes one rank issues in one training step of a
    hybrid model (jamba) with phantom MLP sites, tensor-parallel
    attention and SSD in/out projections and expert-partitioned MoE in
    the ``fp`` layout at tp = ``p``, dp = 1 (``_outer_wire_bytes``'
    pricing; at dp 1 FSDP's gathers and reduce-scatters are the
    identity and issue nothing).  Per block and pass, summed over the
    layer plan: an attention mixer's norm psum, its feature gather and
    the reduce-scatter of ``wo``'s partial sums; an SSD mixer's norm
    psum, its feature gather, the gated RMSNorm's psum and the
    reduce-scatter of ``out``'s partial sums; an MLP's norm psum and its
    three ghost gathers; an MoE's norm psum, the router's partial logits
    [T, E] in fp32 and the two all-to-alls of the capacity slots [E, C,
    d / p] (``moe_wire_bytes``); three passes under ``remat="full"``."""
    from repro_torch.models.blocks import layer_plan
    from repro_torch.models.moe import moe_capacity
    act = 2 if cfg.dtype == "bfloat16" else 4
    d, T = cfg.d_model, batch * seq
    norm, stream = _all_reduced(p, T * 4), _gathered(p, T * d // p * act)
    mixer = {"attn": norm + 2 * stream, "mamba": 2 * norm + 2 * stream}
    ffn = {None: 0.0}
    if cfg.d_ff:
        k = cfg.projection_spec("ffn_gate").k
        ffn["mlp"] = norm + 3 * _gathered(p, T * k * act)
    if cfg.moe is not None:
        m = cfg.moe
        C = moe_capacity(T, m.num_experts, m.top_k, m.capacity_factor)
        ffn["moe"] = (norm + _all_reduced(p, T * m.num_experts * 4)
                      + 2 * m.num_experts * C * d // p * act * (p - 1) / p)
    blocks = sum(mixer[mx] + ffn[ff] for mx, ff in layer_plan(cfg))
    return 3 * blocks + _outer_wire_bytes(cfg, batch, seq, p)


def encdec_wire_bytes(cfg, batch, seq, p):
    """The logical wire bytes one rank issues in one training step of an
    encoder-decoder model (seamless) with phantom MLP sites (up, down)
    and tensor-parallel head-mode attention in the ``fp`` layout at tp =
    ``p``, dp = 1, the frames as long as the tokens
    (``_outer_wire_bytes``' pricing).  Per pass: an encoder block's two
    norms (``_norm_bytes``), its attention's feature gather and the
    reduce-scatter of ``wo``'s partial sums, and the MLP's two ghost
    gathers; a decoder block's three norms, its self-attention's gather
    and reduce-scatter, its cross-attention's (the q site's feature
    gather and ``wo``'s reduce-scatter: K and V project the memory,
    which every rank holds whole) and the two ghost gathers; three
    passes under ``remat="full"`` (forward, recompute, backward), but for
    the first encoder block's first norm, whose psums have no backward:
    its moments are of the frames, which carry no gradient.  Once each
    forward and backward: the encoder's final norm, and the gather of its
    output to full features (the memory; the recompute of a decoder block
    reads it as it is).  Around the blocks: ``_outer_wire_bytes``."""
    act = 2 if cfg.dtype == "bfloat16" else 4
    d, T = cfg.d_model, batch * seq
    k = cfg.projection_spec("ffn_up").k
    norm, stream = _norm_bytes(cfg, p, T), _gathered(p, T * d // p * act)
    ghosts = 2 * _gathered(p, T * k * act)
    enc = 2 * norm + 2 * stream + ghosts
    dec = 3 * norm + 4 * stream + ghosts
    return (3 * (cfg.encoder_layers * enc + cfg.num_layers * dec) - norm
            + 2 * norm + 2 * stream
            + _outer_wire_bytes(cfg, batch, seq, p))


class StubbedLM:
    """``LMDataset``'s batches of ``batch`` x ``seq`` tokens (and labels)
    on ``device``, with the stubs of the family's frontends as the
    reference's ``tests/helpers.py: make_batch`` adds them: ``frames``
    [B, S, d] and ``vision_embeds`` [B, n_vision_tokens, d] drawn from a
    numpy ``RandomState(seed + step)`` (float32), ``positions``
    [3, B, S] ``arange(S)`` on each row."""

    def __init__(self, cfg, batch, seq, device, seed=0):
        from repro_torch.data.synthetic import LMDataset
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.device, self.seed = device, seed
        self.lm = LMDataset(cfg.vocab_size, batch, seq + 1, seed=seed,
                            device=device)

    def __call__(self, step):
        import numpy as np
        import torch
        from repro_torch.models.model import n_vision_tokens
        cfg, B, S = self.cfg, self.batch, self.seq
        out = dict(self.lm(step))
        rng = np.random.RandomState(self.seed + step)

        def draw(*shape):
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                    ).to(self.device)
        if cfg.family == "encdec":
            out["frames"] = draw(B, S, cfg.d_model)
        if cfg.frontend == "vision":
            out["vision_embeds"] = draw(B, n_vision_tokens(cfg, S),
                                        cfg.d_model)
        if cfg.rope == "mrope":
            out["positions"] = torch.arange(S, device=self.device).expand(
                3, B, S)
        return out


def _jamba_serve():
    """(a): jamba-1.5-large at full width and ``JAMBA_SERVE_LAYERS``
    layers (attention + MLP, SSD + MoE, SSD + MLP: its three block kinds),
    bf16 parameters, through ``_family_serve`` with every prompt its own
    exact-length group (page size 1, as mamba2's; flash once per prefill
    group: one attention layer); then, on the closed batch's first group,
    the recurrence check in float32 activations (``_recurrence_check``:
    attention K/V and SSD state, layer by layer), the MoE's capacity
    factor raised to 16 there so that no token is dropped in either."""
    import dataclasses
    from repro_torch.configs.base import get_config, with_kernel_backend
    from repro_torch.models.blocks import layer_plan
    from repro_torch.models.model import count_params
    cfg = with_kernel_backend(get_config(JAMBA_ARCH), "pallas").replace(
        num_layers=JAMBA_SERVE_LAYERS)
    print(f"jamba serve: plan {layer_plan(cfg)}, {cfg.moe.num_experts} "
          f"experts top-{cfg.moe.top_k}, active parameters "
          f"{count_params(cfg, active_only=True):,}", flush=True)
    out, eng, closed = _family_serve(cfg, MAMBA_PAGE, "jamba serve")
    check(out["prefill_groups"] == 8 // SLOTS + len(MIXED_LENS),
          f"jamba serve: {out['prefill_groups']} prefill groups")
    params = eng.params
    del eng
    _free()
    ample = cfg.replace(dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0))
    out["recurrence"], out["recurrence_end_to_end"] = _recurrence_check(
        ample, params, closed[:SLOTS], tag="jamba serve")
    del params
    _free()
    return out


def _host_copy(res):
    """A step-1 result moved to the host: ranks that share the card then
    hold one run's gradients and parameters on it at a time."""
    from repro_torch.parallel.params import tree_map
    return {k: tree_map(lambda t: t.cpu(), v) if isinstance(v, dict)
            else v for k, v in res.items()}


def jamba_reckoned_bytes(cfg, p):
    """What one rank of the tp = ``p`` main path holds at least: its
    parameters and their gradients (``param_dtype``) and Adafactor's
    factored moments (fp32), from the decls; the card holds ``p`` such
    ranks."""
    from repro_torch.models.model import model_decls
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import tree_leaves
    decls = model_decls(cfg, MeshAxes(tp=p))
    opt = make_optimizer("adafactor", 0.0).state_decls(decls)
    weights = sum(_local_bytes(d, p, 1) for _, d in tree_leaves(decls))
    state = sum(_local_bytes(d, p, 1) for _, d in tree_leaves(opt))
    return {"weights": weights, "grads": weights, "adafactor": state}


def _hybrid_rank(axes, device):
    """``phase_hybrid`` inside one of the ``LM_TP`` ranks sharing the
    card: (b) jamba's step 1 at full width and ``JAMBA_LAYERS`` layers,
    float32 parameters and activations and ``JAMBA_PARITY_EXPERTS``
    experts (one a rank, top-2 kept: 16 experts' weights do not fit
    twice in float32), Adafactor, through the kernels against plain
    torch from one draw cloned, the kernel run's result held on the host
    while the plain one runs; (c) the main path: ``launch/train.py``'s
    trainer at full width, ``JAMBA_LAYERS`` layers, bf16 parameters,
    Adafactor, ``fsdp=True`` at dp 1, ``JAMBA_STEPS`` steps and one more
    profiled (``_lm_tp_train``)."""
    import dataclasses
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.launch.train import train_config
    from repro_torch.optim.schedules import warmup_cosine

    out = {"rank": axes.rank}
    args = _lm_args(["--steps", str(JAMBA_STEPS)], arch=JAMBA_ARCH)
    base = train_config(args).replace(num_layers=JAMBA_LAYERS)
    cut = base.replace(dtype="float32", param_dtype="float32",
                       moe=dataclasses.replace(
                           base.moe, num_experts=JAMBA_PARITY_EXPERTS))
    batch = LMDataset(cut.vocab_size, args.batch, args.seq + 1,
                      device=device)(0)
    out["kernel_vs_plain"] = _step1_kernel_vs_plain(
        axes, device, cut, batch, warmup_cosine(3e-4, 20, JAMBA_STEPS))
    out["main"] = _lm_tp_train(axes, device, base, args, JAMBA_STEPS,
                               profile=True)
    return out


def _step1_kernel_vs_plain(axes, device, cut, batch, sched):
    """Step 1 of ``cut`` on this rank, through the kernels (``"auto"``)
    against plain torch (``"xla"``) from one draw cloned, the draw one
    rank at a time (a global leaf at a time beside the shards), the
    kernel run's result held on the host while the plain one runs: the
    parts' differences (``_step1_diff``), the launches and the losses."""
    import torch
    from repro_torch.configs.base import with_kernel_backend
    from repro_torch.models.model import model_decls
    from repro_torch.parallel.params import materialize_shards
    params = None
    for turn in range(axes.tp):           # one rank's global draw at a time
        if turn == axes.rank:
            params = materialize_shards(model_decls(cut, axes), axes, SEED,
                                        device, draw_on=device)
            _free()
        axes.world_comm.all_reduce(torch.zeros(1))
    res, launches = {}, {}
    for name, backend in (("kernel", "auto"), ("plain", "xla")):
        r, launches[name], eps = _tp_step1(
            with_kernel_backend(cut, backend), axes, device, params, batch,
            sched)
        res[name] = _host_copy(r) if name == "kernel" else r
        del r
        _free()
    del params
    out = {part: _step1_diff(res, part, sched(0), eps)
           for part in ("loss", "grads", "params")}
    out.update(launches=launches,
               loss_values={n: float(r["loss"]) for n, r in res.items()})
    del res
    _free()
    return out


def _hybrid_held(ranks, cfg):
    """Hold every rank's (b) and the main path (``_ranks_held``) against
    the launches jamba's layers imply and ``hybrid_wire_bytes``.  Returns
    the worst of (b) over the ranks, the counted wire and the launches."""
    from repro_torch.models.blocks import layer_plan
    mlp_layers = sum(ff == "mlp" for _, ff in layer_plan(cfg))
    attn_layers = sum(mx == "attn" for mx, _ in layer_plan(cfg))
    want = _path_launches(mlp_layers, 3)
    want["flash_attention"] = 2 * attn_layers
    wire = hybrid_wire_bytes(cfg, LM_BATCH, LM_SEQ, LM_TP)
    return _ranks_held(ranks, "hybrid", want, want, wire), wire, want


def _ranks_held(ranks, tag, want_b, want, wire):
    """Hold every rank's step 1 ((b): its parts with 0 elements outside,
    its gradients within 1e-4 of the largest, the kernel run's launches
    ``want_b`` and none on the plain run) and its main path (losses
    finite, launches a step ``want``, wire bytes a step ``wire``).
    Returns the worst of (b) over the ranks."""
    import math
    none = _path_launches(0, 0)
    worst = {}
    for r in ranks:
        rk, res = r["rank"], r["kernel_vs_plain"]
        for part in ("loss", "grads", "params"):
            diff = res[part]
            check(diff["outside"] == 0,
                  f"{tag} rank {rk}: step 1 {part} differ in "
                  f"{diff['outside']} of {diff['elements']} elements: {diff}")
            w = worst.setdefault(part, {})
            for k, v in diff.items():
                w[k] = max(w.get(k, 0), v)
        check(res["grads"]["max_scaled_err"] <= STEP1_TOL["rtol"],
              f"{tag} rank {rk}: step-1 gradients differ by more than 1e-4 "
              f"of the largest: {res['grads']}")
        check(res["launches"] == {"kernel": want_b, "plain": none},
              f"{tag} rank {rk}: step-1 launches {res['launches']}, want "
              f"{want_b} through the kernels and none plain")
        m = r["main"]
        check(all(math.isfinite(v) for v in m["losses"] + m["grad_norms"]),
              f"{tag} rank {rk}: non-finite loss or gradient norm: "
              f"{m['losses']} {m['grad_norms']}")
        check(m["launches_per_step"] == want,
              f"{tag} rank {rk}: launches per step "
              f"{m['launches_per_step']}, want {want}")
        check(m["wire_bytes_per_step"] == wire,
              f"{tag} rank {rk}: {m['wire_bytes_per_step']:.0f} wire bytes "
              f"a step, counted {wire:.0f}")
    return worst


def phase_hybrid(pool=None):
    """The hybrid family: the kernels at jamba's shapes, its serving at
    full width (``_jamba_serve``), then ``LM_TP`` ranks sharing the card
    (gloo, card tensors through the host) running ``_hybrid_rank``."""
    import torch
    from repro_torch.launch.train import train_config
    _free()
    t0 = time.perf_counter()
    kernels = _timed_kernels(
        "hybrid", torch.Generator(device="cuda").manual_seed(SEED),
        (JAMBA_SERVE_FLASH_SHAPE, JAMBA_TP_FLASH_SHAPE), JAMBA_PHANTOM_SHAPES)
    serve = _jamba_serve()
    cfg = train_config(_lm_args([], arch=JAMBA_ARCH)).replace(
        num_layers=JAMBA_LAYERS)
    reckoned = jamba_reckoned_bytes(cfg, LM_TP)
    print(f"hybrid: (c) reckoned a rank at tp={LM_TP}, {cfg.num_layers} "
          f"layers: weights {reckoned['weights'] / 1e9:.2f} GB + gradients "
          f"{reckoned['grads'] / 1e9:.2f} GB ({cfg.param_dtype}) + "
          f"Adafactor {reckoned['adafactor'] / 1e9:.3f} GB; {LM_TP} ranks "
          f"{LM_TP * sum(reckoned.values()) / 1e9:.2f} GB on the card "
          f"before activations and temporaries", flush=True)
    t1 = time.perf_counter()
    ranks = _run_ranks(pool, _hybrid_rank, 1, LM_TP)
    wall = time.perf_counter() - t1
    worst, wire, want = _hybrid_held(ranks, cfg)
    print(f"hybrid: (b) {cfg.name} at {JAMBA_LAYERS} layers, step 1, "
          f"float32 parameters, {JAMBA_PARITY_EXPERTS} experts (one a rank; "
          f"16 do not fit twice in float32), Adafactor, kernels vs plain, "
          f"worst over ranks (rtol 1e-4 / atol 1e-5): loss "
          f"{worst['loss']['max_abs_err']:.3e} (values "
          f"{ranks[0]['kernel_vs_plain']['loss_values']}), grads "
          f"{worst['grads']['max_abs_err']:.3e} "
          f"({worst['grads']['max_scaled_err']:.3e} of the largest), params "
          f"{worst['params']['max_abs_err']:.3e}; elements outside 0 of "
          f"{worst['params']['elements']} per rank at most; launches "
          f"{ranks[0]['kernel_vs_plain']['launches']}", flush=True)
    med = _main_report("hybrid", ranks, cfg, want, wire,
                       "hybrid_wire_bytes")
    tokens = LM_BATCH * LM_SEQ
    main = [r["main"] for r in ranks]
    print(f"hybrid: the ranks took {wall:.1f} s; the phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"kernels": kernels, "serve": serve, "ranks": ranks,
            "worst": worst, "median_step_ms": med,
            "tokens_per_s": tokens / max(med) * 1e3,
            "launches_per_step": main[0]["launches_per_step"],
            "wire_bytes_counted": wire, "reckoned_bytes_per_rank": reckoned,
            "wall_s": wall}


def _family_serve(cfg, page, tag):
    """``cfg`` (random weights from the seed, ``kernel_backend="pallas"``)
    through ``ServeEngine`` with phase 4's traffic at page size ``page``
    (16: mixed-length buckets; 1: every prompt its own exact-length
    group, as a recurrent family needs): every request's ``NEW_TOKENS``
    tokens, the flash kernel once per self-attention layer (an encoder's too;
    none at an SSD layer) of every prefill group; TTFT, TPOT, a profiled decode
    window, the weights' and the cache's bytes.  Returns (results, the
    engine, the closed batch)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.blocks import layer_plan
    from repro_torch.models.model import count_params, model_decls
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize, tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import bucket_of
    t0 = time.perf_counter()
    params = materialize(model_decls(cfg, MeshAxes()), torch.Generator(
        device="cuda").manual_seed(SEED), "cuda")
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                      page_size=page, device="cuda")
    del params
    _free()
    weights_gb = sum(t.numel() * t.element_size()
                     for t in _leaves(eng.params)) / 1e9
    cache = {path: c.numel() * c.element_size()
             for path, c in tree_leaves(eng.cache)}
    n_params = count_params(cfg)
    cache_mb = {k: round(v / 1e6, 3) for k, v in cache.items()}
    print(f"{tag}: {cfg.name} at full width, {cfg.num_layers} decoder "
          f"layers, {cfg.encoder_layers} encoder layers, d={cfg.d_model}, "
          f"params={n_params:,}; weights on card {weights_gb:.2f} GB "
          f"({cfg.param_dtype} parameters, served in {cfg.dtype}); cache "
          f"{sum(cache.values()) / 1e6:.2f} MB for {SLOTS} slots x "
          f"{MAX_LEN} ({cache_mb} MB); set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    closed = closed_batch(cfg.vocab_size, 8, 16, NEW_TOKENS, SEED)
    rng = np.random.RandomState(SEED + 1)
    mixed = [Request(prompt=rng.randint(0, cfg.vocab_size, n)
                     .astype(np.int32), max_new_tokens=NEW_TOKENS,
                     req_id=100 + i) for i, n in enumerate(MIXED_LENS)]
    eng.warmup(sorted({bucket_of(n, page) for n in MIXED_LENS + (16,)}))

    # --- the main path: counts from zero, read right after ---------------
    torch.cuda.reset_peak_memory_stats()
    groups0 = eng.prefill_meter.calls
    flash_attention.launches = 0
    eng.run(closed)
    rep_closed = slo_report(closed)
    for r in mixed:
        r.arrival_s = eng.now_s
    eng.run(mixed)
    launches = flash_attention.launches
    groups = eng.prefill_meter.calls - groups0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rep_mixed = slo_report(mixed)
    for r in closed + mixed:
        check(r.done and r.error is None and len(r.out_tokens) == NEW_TOKENS,
              f"{tag}: request {r.req_id} ended with "
              f"{len(r.out_tokens)} tokens ({r.error})")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"{tag}: request {r.req_id} sampled out-of-vocab tokens")
    per_group = (sum(mx == "attn" for mx, _ in layer_plan(cfg))
                 + cfg.encoder_layers)
    check(launches == groups * per_group,
          f"{tag}: flash kernel launched {launches} times for {groups} "
          f"prefill groups x {per_group} self-attention layers")
    for name, rep in (("closed", rep_closed), ("mixed", rep_mixed)):
        print(f"{tag} {name}: requests={rep['requests']} "
              f"tokens={rep['generated_tokens']} "
              f"TTFT p50={rep['ttft_ms']['p50']:.3f} ms "
              f"TPOT p50={rep['tpot_ms']['p50']:.3f} ms "
              f"tokens/s={rep['tokens_per_s']:.1f}", flush=True)
    print(f"{tag}: prefill groups={groups} flash launches={launches} "
          f"({per_group} a group); peak memory {peak_gb:.2f} GB; prefill "
          f"step median {eng.prefill_meter.median_us() / 1e3:.3f} ms, "
          f"decode {eng.decode_meter.median_us() / 1e3:.3f} ms", flush=True)
    profile = _profile_decode(eng, cfg)
    return ({"params": n_params, "weights_gb": weights_gb,
             "cache_bytes": cache, "launches": launches,
             "prefill_groups": groups, "peak_memory_gb": peak_gb,
             "closed": rep_closed, "mixed": rep_mixed,
             "decode_profile": profile,
             "prefill_meter": eng.prefill_meter.summary(),
             "decode_meter": eng.decode_meter.summary()}, eng, closed)


def _cut_layers(params, n, keys=("layers",)):
    """The first ``n`` entries of each stack ``keys`` of ``params``, the
    other leaves as they are, every leaf in float32 on the card."""
    from repro_torch.parallel.params import tree_map
    out = {}
    for k, v in params.items():
        cut = (lambda t: t[:n].float()) if k in keys else (
            lambda t: t.float())
        out[k] = tree_map(cut, v)
    return out


def _vlm_serve():
    """(a): qwen2-vl-72b at full width and ``QWEN2VL_SERVE_LAYERS``
    layers, bf16 parameters, through ``_family_serve`` (mixed-length
    buckets: the vision stub's zero embeddings over each group's first
    ``n_vision_tokens`` positions, M-RoPE positions ``arange`` on each
    row); then, at ``QWEN2VL_PARITY_LAYERS`` of those layers cast to
    float32 (a float32 model does not fit at full width), the recurrence
    check (``_recurrence_check``) on the closed batch's first group."""
    from repro_torch.configs.base import get_config, with_kernel_backend
    cfg = with_kernel_backend(get_config(QWEN2VL_ARCH), "pallas").replace(
        num_layers=QWEN2VL_SERVE_LAYERS)
    out, eng, closed = _family_serve(cfg, PAGE, "vlm serve")
    params = _cut_layers(eng.params, QWEN2VL_PARITY_LAYERS)
    del eng
    _free()
    out["recurrence"], out["recurrence_end_to_end"] = _recurrence_check(
        cfg.replace(dtype="float32", num_layers=QWEN2VL_PARITY_LAYERS),
        params, closed[:SLOTS], tag="vlm serve")
    del params
    _free()
    return out


def _encdec_serve():
    """(a): seamless-m4t-large-v2 at full width (``SERVE_DEPTH``), bf16,
    through ``_family_serve``, every prompt its own exact-length group
    (page size 1: the family is recurrent, its encoder reads the whole
    prompt's frames).  Served frames are zero, so there the encoder's
    memory is zero; then, with random frames in float32 activations on
    the served weights, the closed batch's first group's prefill logits
    and cross K/V through the kernels against the plain path
    (``LOGIT_TOL`` of the largest: the cross-attention runs the plain
    core in both, the encoder's flash is full and the decoder's causal);
    and the recurrence check at ``SEAMLESS_PARITY_LAYERS`` + the same
    encoder layers, float32, with the random frames."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, with_kernel_backend
    from repro_torch.models.model import forward_prefill
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import tree_leaves
    n = SERVE_DEPTH[SEAMLESS_ARCH]
    cfg = with_kernel_backend(get_config(SEAMLESS_ARCH), "pallas").replace(
        num_layers=n, encoder_layers=n)
    out, eng, closed = _family_serve(cfg, MAMBA_PAGE, "encdec serve")
    params = _cut_layers(eng.params, cfg.num_layers,
                         ("enc_layers", "dec_layers"))
    del eng
    _free()
    toks = torch.from_numpy(np.stack([r.prompt for r in closed[:SLOTS]])
                            ).long().cuda()
    B, S = toks.shape
    frames = torch.randn((B, S, cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(
                             SEED + 3))
    res = {}
    with torch.no_grad():
        for backend in ("pallas", "xla"):
            c = with_kernel_backend(cfg, backend).replace(dtype="float32")
            lg, cache = forward_prefill(c, MeshAxes(), params,
                                        {"tokens": toks, "frames": frames})
            res[backend] = {"logits": lg[..., :cfg.vocab_size],
                            **{f"cross/{k}": cache["cross"][k]
                               for k in ("k", "v")}}
    errs = {}
    for name, want in res["xla"].items():
        got = res["pallas"][name]
        scale = want.abs().max().item()
        errs[name] = (got - want).abs().max().item() / scale
        check(errs[name] <= LOGIT_TOL and scale > 0,
              f"encdec serve: prefill {name} through the kernels differs "
              f"from the plain path by {errs[name]:.3e} of the largest "
              f"({scale:.3e})")
    shown = {k: f"{v:.3e}" for k, v in errs.items()}
    print(f"encdec serve: one group's prefill with random frames, float32, "
          f"kernels against plain, as a share of the largest: {shown} (held "
          f"to {LOGIT_TOL}); cross K/V of the encoder's {S} rows "
          f"{list(res['xla']['cross/k'].shape)}", flush=True)
    out["prefill_kernel_vs_plain"] = errs
    del res
    n = SEAMLESS_PARITY_LAYERS
    small = _cut_layers(params, n, ("enc_layers", "dec_layers"))
    del params
    _free()
    out["recurrence"], out["recurrence_end_to_end"] = _recurrence_check(
        cfg.replace(dtype="float32", num_layers=n, encoder_layers=n), small,
        closed[:SLOTS], tag="encdec serve", stubs={"frames": frames})
    del small
    _free()
    return out


def _family_cfgs(arch, layers, parity):
    """``launch/train.py``'s config of ``arch`` at ``LM_TP`` (the main
    path's, cut to ``layers``, and step 1's, cut to ``parity`` in float32;
    an encoder-decoder's encoder cut alike) and its flags."""
    from repro_torch.launch.train import train_config
    args = _lm_args(["--steps", str(LM_STEPS)], arch=arch)
    base = train_config(args)

    def cut(n):
        return base.replace(num_layers=n, **(
            {"encoder_layers": n} if base.family == "encdec" else {}))
    return (cut(layers), cut(parity).replace(dtype="float32",
                                             param_dtype="float32"), args)


def _family_rank(axes, device, arch, layers, parity):
    """``phase_vlm`` and ``phase_encdec`` inside one of the ``LM_TP`` ranks
    sharing the card, on ``StubbedLM`` batches (random vision embeddings
    or frames; M-RoPE positions): (b) step 1 at full width and ``parity``
    layers, float32, the config's optimizer, through the kernels against
    plain torch from one draw cloned, the kernel run's result held on the
    host while the plain one runs; (c) the main path:
    ``launch/train.py``'s trainer (``make_trainer``: its optimizer and
    schedule) at full width and ``layers`` layers, ``LM_STEPS`` steps
    and one more profiled (``_lm_tp_train``)."""
    from repro_torch.optim.schedules import warmup_cosine
    main_cfg, cut, args = _family_cfgs(arch, layers, parity)
    out = {"rank": axes.rank}
    out["kernel_vs_plain"] = _step1_kernel_vs_plain(
        axes, device, cut, StubbedLM(cut, LM_BATCH, LM_SEQ, device,
                                     seed=SEED)(0),
        warmup_cosine(3e-4, 20, LM_STEPS))
    out["main"] = _lm_tp_train(
        axes, device, main_cfg, args, LM_STEPS, profile=True,
        dataset=StubbedLM(main_cfg, LM_BATCH, LM_SEQ, device, seed=SEED))
    return out


def _family_launches(cfg):
    """Launches a step a rank of ``cfg``'s training under ``remat="full"``:
    flash at every self-attention layer (the encoder's too), the phantom
    kernels at every MLP site (gate, up, down; a gelu MLP's up, down)."""
    sites = 3 if cfg.mlp == "swiglu" else 2
    return _path_launches(cfg.num_layers + cfg.encoder_layers, sites)


def _main_report(tag, ranks, cfg, want, wire, wire_name):
    """Print the main path of every rank (``_lm_tp_train``'s results):
    losses, step times, launches, wire bytes, memory, the profiled step;
    returns the median step ms of each rank."""
    import statistics as st
    tokens = LM_BATCH * LM_SEQ
    main = [r["main"] for r in ranks]
    med = [st.median(m["step_ms"][1:]) for m in main]
    print(f"{tag}: (c) {cfg.name} full width, {cfg.num_layers} decoder and "
          f"{cfg.encoder_layers} encoder layers, tp={LM_TP}, batch "
          f"{LM_BATCH} x seq {LM_SEQ}, {cfg.param_dtype} parameters, "
          f"{cfg.optimizer}, fsdp={cfg.fsdp} at dp 1, microbatches 1, "
          f"remat={cfg.remat}: losses "
          f"{[round(v, 4) for v in main[0]['losses']]}; per-rank step ms "
          f"{[[round(v, 1) for v in m['step_ms']] for m in main]}, median "
          f"of steps 2-{LM_STEPS} {[round(v, 1) for v in med]}; "
          f"{tokens / max(med) * 1e3:.1f} tokens/s (slowest rank); launches "
          f"per step per rank {main[0]['launches_per_step']} (want {want}); "
          f"local parameters per rank {main[0]['params_local']:,}",
          flush=True)
    print(f"{tag}: (c) wire bytes per step per rank "
          f"{[round(m['wire_bytes_per_step']) for m in main]}, counted "
          f"{wire:.0f} ({wire_name}); by collective (rank 0): "
          f"{main[0]['collectives_per_step']}", flush=True)
    print(f"{tag}: (c) parameters + optimizer state per rank (GB) "
          f"{[round(m['state_bytes'] / 1e9, 3) for m in main]}; peak memory "
          f"per rank (GB) {[round(m['peak_memory_gb'], 2) for m in main]}; "
          f"card used (GB, as each rank read it after its run) "
          f"{[round(m['card_used_gb'], 2) for m in main]}", flush=True)
    prof = [m["profile"] for m in main]
    print(f"{tag}: (c) one more step, collectives timed on every rank "
          f"(rank 0 also profiled): wall ms "
          f"{[round(p['wall_ms'], 1) for p in prof]}, in collectives "
          f"{[round(p['collective_ms'], 1) for p in prof]} over "
          f"{prof[0]['calls']} calls (share "
          f"{[round(p['collective_ms'] / p['wall_ms'], 3) for p in prof]}); "
          f"rank 0's device {prof[0]['device_ms']} ms (busy "
          f"{prof[0]['device_busy_share']}), by kind "
          f"{prof[0]['device_ms_by_kind']}, {prof[0]['device_ops']} device "
          f"ops; top: "
          f"{ {k: round(v, 3) for k, v in prof[0]['top_device_ms'].items()} }",
          flush=True)
    return med


def _phase_family(tag, arch, layers, parity, flash_shapes, phantom_shapes,
                  serve, wire_fn, wire_name, pool=None):
    """One family's phase: its kernels timed, ``serve()``, then ``LM_TP``
    ranks sharing the card (gloo, card tensors through the host) running
    ``_family_rank``, held by ``_ranks_held``."""
    import torch
    _free()
    t0 = time.perf_counter()
    kernels = _timed_kernels(
        tag, torch.Generator(device="cuda").manual_seed(SEED), flash_shapes,
        phantom_shapes)
    served = serve()
    cfg, cut, _ = _family_cfgs(arch, layers, parity)
    wire = wire_fn(cfg)
    t1 = time.perf_counter()
    ranks = _run_ranks(pool, _family_rank, 1, LM_TP,
                       args=(arch, layers, parity))
    wall = time.perf_counter() - t1
    want = _family_launches(cfg)
    worst = _ranks_held(ranks, tag, _family_launches(cut), want, wire)
    print(f"{tag}: (b) step 1 at full width, float32, {cut.num_layers} "
          f"decoder and {cut.encoder_layers} encoder layers, "
          f"{cut.optimizer}, kernels vs plain, worst over ranks (rtol 1e-4 / "
          f"atol 1e-5): loss {worst['loss']['max_abs_err']:.3e} (values "
          f"{ranks[0]['kernel_vs_plain']['loss_values']}), grads "
          f"{worst['grads']['max_abs_err']:.3e} "
          f"({worst['grads']['max_scaled_err']:.3e} of the largest), params "
          f"{worst['params']['max_abs_err']:.3e}; elements outside 0 of "
          f"{worst['params']['elements']} per rank at most; launches "
          f"{ranks[0]['kernel_vs_plain']['launches']}", flush=True)
    med = _main_report(tag, ranks, cfg, want, wire, wire_name)
    print(f"{tag}: the ranks took {wall:.1f} s; the phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    main = ranks[0]["main"]
    return {"kernels": kernels, "serve": served, "ranks": ranks,
            "worst": worst, "median_step_ms": med,
            "tokens_per_s": LM_BATCH * LM_SEQ / max(med) * 1e3,
            "launches_per_step": main["launches_per_step"],
            "wire_bytes_counted": wire, "wall_s": wall}


def phase_vlm(pool=None):
    """The vision-language family (qwen2-vl-72b): the kernels at its
    shapes, ``_vlm_serve``, then step 1 at ``QWEN2VL_PARITY_LAYERS``
    layers (Adafactor) and the main path at ``QWEN2VL_LAYERS`` layers,
    bf16 parameters, ``fsdp=True`` at dp 1, its wire bytes held to the
    dense head-mode count (``fsdp_wire_bytes``: the splice is local in
    ``fp``)."""
    return _phase_family(
        "vlm", QWEN2VL_ARCH, QWEN2VL_LAYERS, QWEN2VL_PARITY_LAYERS,
        (QWEN2VL_SERVE_FLASH_SHAPE, QWEN2VL_TP_FLASH_SHAPE),
        QWEN2VL_PHANTOM_SHAPES, _vlm_serve,
        lambda cfg: fsdp_wire_bytes(cfg, LM_BATCH, LM_SEQ, LM_TP, 1),
        "fsdp_wire_bytes at dp 1", pool)


def phase_encdec(pool=None):
    """The encoder-decoder family (seamless-m4t-large-v2): the kernels at
    its shapes (flash full, as its encoder runs it, and causal),
    ``_encdec_serve``, then step 1 at ``SEAMLESS_PARITY_LAYERS`` +
    ``SEAMLESS_PARITY_LAYERS`` layers (AdamW) and the main path at
    ``SEAMLESS_LAYERS`` + ``SEAMLESS_LAYERS`` layers, fp32 parameters,
    its wire bytes held to ``encdec_wire_bytes``."""
    return _phase_family(
        "encdec", SEAMLESS_ARCH, SEAMLESS_LAYERS, SEAMLESS_PARITY_LAYERS,
        SEAMLESS_FLASH_SHAPES, SEAMLESS_PHANTOM_SHAPES, _encdec_serve,
        lambda cfg: encdec_wire_bytes(cfg, LM_BATCH, LM_SEQ, LM_TP),
        "encdec_wire_bytes", pool)


def _dense_twin(tree):
    """A phantom model's tree as the tensor config's: each phantom site's
    factors ``{L, C, D}`` replaced by the dense matrix it computes, layer
    by layer, its bias kept (``core/phantom.py:
    phantom_dense_equivalent``)."""
    import torch
    from repro_torch.core.phantom import phantom_dense_equivalent
    if not isinstance(tree, dict):
        return tree
    if "L" not in tree:
        return {k: _dense_twin(v) for k, v in tree.items()}
    rest = {k: v for k, v in tree.items() if k not in ("L", "C", "D")}
    return {**rest, "w": torch.stack([phantom_dense_equivalent(
        {f: tree[f][i] for f in ("L", "C", "D")})
        for i in range(tree["L"].shape[0])])}


def _replayed(cfg, params, axes, device, trace, page=PAGE, stubs=None):
    """Greedy streams of ``trace`` through a ``replay`` of this rank's
    engine (``SLOTS`` slots, ``MAX_LEN``, page ``page``, the frontends'
    ``stubs``)."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.traffic import replay, trace_requests
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                      page_size=page, axes=axes, device=device, stubs=stubs)
    reqs = trace_requests(trace, cfg.vocab_size, seed=SEED)
    replay(eng, reqs)
    check(all(r.done and r.error is None for r in reqs),
          f"{cfg.name}: a request did not end")
    return [list(r.out_tokens) for r in reqs]


def _serve_parity(cfg, twin, axes, device, trace, page=PAGE, stubs=None):
    """The mesh engine's greedy streams of ``trace`` on ``cfg`` (at page
    ``page``, the frontends' ``stubs``), and on the world's rank 0 alone
    those of the tp = 1 engine on the same global weights, as the config
    ``twin`` (the tensor sites') holds them (a phantom model's as its
    dense twin): {"mesh": streams, "tp1": streams or None}."""
    import torch
    from repro_torch.models.model import model_decls
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.parallel.params import materialize
    from repro_torch.serve.router import serve_params
    out = {"mesh": _replayed(cfg, serve_params(cfg, axes, SEED, device),
                             axes, device, trace, page, stubs),
           "tp1": None}
    _free()
    if axes.rank == 0:
        glob = materialize(model_decls(cfg, axes), torch.Generator(
            device=device).manual_seed(SEED), device)
        out["tp1"] = _replayed(twin, _dense_twin(glob), MeshAxes(), device,
                               trace, page, stubs)
        del glob
        _free()
    axes.world_comm.all_reduce(torch.zeros(1))     # rank 0 is done
    return out


def _err_of_largest(got, want):
    """The largest elementwise difference and its share of ``want``'s
    largest magnitude."""
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def _profile_mesh_decode(cfg, params, axes, device, page=PAGE, stubs=None):
    """One decode step of a full batch of 16-token prompts on a fresh
    engine (page ``page``, the frontends' ``stubs``), every rank's
    collectives timed (``record_collectives(timed=True)``), rank 0's
    under ``torch.profiler``: wall ms, host ms in the collectives and
    their count, and rank 0's device ms and device ops."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.parallel.axes import record_collectives
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                      page_size=page, axes=axes, device=device, stubs=stubs)
    rng = np.random.RandomState(SEED + 2)
    eng.submit([Request(prompt=rng.randint(0, cfg.vocab_size, 16)
                        .astype(np.int32), max_new_tokens=3)
                for _ in range(SLOTS)])
    eng.step()
    torch.cuda.synchronize()
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if axes.rank == 0 else contextlib.nullcontext())
    with record_collectives(timed=True) as clock, ctx as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out = {"wall_ms": wall, "collective_ms": clock.collective_ms,
           "device_wait_ms": clock.device_wait_ms, "calls": clock.calls}
    if axes.rank == 0:
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        out.update(device_ms=device_ms or None,
                   device_ops=sum(e.count for e in events),
                   top_device_ms={e.key[:60]: e.self_device_time_total / 1e3
                                  for e in sorted(
                                      events,
                                      key=lambda e: -e.self_device_time_total
                                  )[:5]})
    while eng.has_active():
        eng.step()
    return out


def _serve_mesh_rank(axes, device, impl, layers):
    """``phase_serve_mesh`` inside one rank of the ``impl`` config's mesh:
    (1) the float32 parity streams at ``SERVE_MESH_PARITY_LAYERS`` layers
    (``_serve_parity``); (2) the main path, ``run_config`` at
    ``layers`` layers in bf16, kernel counts from 0 just before and read
    just after; (3) the per-layer kernel-vs-plain check on its weights;
    (4) one profiled decode step."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.planner import paper_default_calibration
    from repro_torch.serve.router import ServeConfig, run_config, serve_params
    from repro_torch.serve.traffic import make_trace
    sc = ServeConfig(SERVE_MESH_ARCH, impl, axes.dp, axes.tp, SLOTS,
                     max_len=MAX_LEN, page_size=PAGE, smoke=False)
    trace = make_trace(**SERVE_MESH_TRACE)
    prefix = [dataclasses.replace(t, max_new_tokens=min(
        t.max_new_tokens, PARITY_TOKENS)) for t in make_trace(
            **SERVE_MESH_TRACE, max_requests=SERVE_MESH_PARITY_REQUESTS)]
    twin = ServeConfig(sc.arch, "tensor", 1, 1, sc.slots, sc.max_len,
                       sc.page_size, smoke=False).model_config()
    out = {"parity": _serve_parity(*(
        c.replace(num_layers=SERVE_MESH_PARITY_LAYERS, dtype="float32")
        for c in (sc.model_config(), twin)), axes, device, prefix)}

    cfg = sc.model_config().replace(num_layers=layers)
    t0 = time.perf_counter()
    params = serve_params(cfg, axes, SEED, device)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _kernel_counts(reset=True)
    t0 = time.perf_counter()
    res = run_config(sc, trace, axes, device=device, cfg=cfg, params=params,
                     calib=paper_default_calibration(), seed=SEED,
                     slo_ms=SERVE_MESH_SLO_MS)
    torch.cuda.synchronize()
    res.update(launches=_kernel_counts(), wall_s=time.perf_counter() - t0,
               draw_s=draw_s,
               weights_gb=sum(t.numel() * t.element_size()
                              for t in _leaves(params)) / 1e9,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    free, total = torch.cuda.mem_get_info()
    res["card_used_gb"] = (total - free) / 1e9
    out["main"] = res
    rows = SLOTS // axes.dp
    toks = torch.from_numpy(np.random.RandomState(SEED + 3).randint(
        0, cfg.vocab_size, (SLOTS, 48))[axes.dp_rank * rows:
                                        (axes.dp_rank + 1) * rows]
    ).long().to(device)
    out["layers"] = _mesh_layer_check(cfg, axes, params, toks)
    out["profile"] = _profile_mesh_decode(cfg, params, axes, device)
    del params
    _free()
    return out


def _first_parting(a, b):
    """Per request, the index of the first token where two streams part
    (None where they agree)."""
    return [next((i for i, (x, y) in enumerate(zip(s, t)) if x != y),
                 None if len(s) == len(t) else min(len(s), len(t)))
            for s, t in zip(a, b)]


def _serve_mesh_held(impl, ranks, cfg, layers):
    """Hold one config's ranks: parity, launches, wire bytes, every
    request's tokens; print what the phase measured.  Returns the
    summary kept in the JSON."""
    from repro_torch.serve.router import ServeConfig
    from repro_torch.serve.traffic import make_trace
    dp, tp = SERVE_MESH[impl]
    trace = make_trace(**SERVE_MESH_TRACE)
    tag = f"serve mesh {impl} dp {dp} x tp {tp}"
    par = ranks[0]["parity"]
    check(all(r["parity"]["mesh"] == par["mesh"] for r in ranks),
          f"{tag}: ranks disagree on the float32 streams")
    check(par["mesh"] == par["tp1"],
          f"{tag}: float32 streams at {SERVE_MESH_PARITY_LAYERS} layers "
          f"part from tp = 1's at {_first_parting(par['mesh'], par['tp1'])}")
    print(f"{tag}: parity at {SERVE_MESH_PARITY_LAYERS} layers: float32 "
          f"streams of the trace's first {SERVE_MESH_PARITY_REQUESTS} "
          f"requests ({PARITY_TOKENS} tokens at most) equal tp = 1's "
          f"(held)", flush=True)
    main = [r["main"] for r in ranks]
    m0 = main[0]
    for r in ranks:
        check(r["main"]["streams"] == m0["streams"],
              f"{tag}: ranks disagree on the served streams")
    for s, t in zip(m0["streams"], trace):
        check(len(s) == t.max_new_tokens and all(
            0 <= x < cfg.vocab_size for x in s),
            f"{tag}: a request ended with {len(s)} of {t.max_new_tokens} "
            f"tokens")
    # launches: the replay's steps plus the warm-up's (one prefill a
    # bucket, one decode) and the measured account's probes (one each)
    pre = m0["prefill_steps"] + m0["warmup_prefills"] + 1
    dec = m0["decode_steps"] + 2
    want = {"flash_attention": layers * pre,
            "phantom_fused_matmul": (3 * layers * (pre + dec)
                                     if impl == "phantom" else 0),
            "matmul_nt": 0, "matmul_tn": 0}
    for r in main:
        check(r["launches"] == want, f"{tag}: launches {r['launches']}, "
                                     f"want {want}")
    S_probe = m0["probe_bucket"]
    wire = {ph: serve_wire_bytes(cfg, SLOTS // dp, S_probe, tp, ph)
            for ph in ("prefill", "decode")}
    for r in main:
        for ph in wire:
            got = sum(c["wire_bytes"] for c in r["collectives"][ph].values())
            check(got == wire[ph], f"{tag}: {ph} wire bytes {got}, counted "
                                   f"{wire[ph]}")
    ratio = {ph: m0["measured"][ph]["collective_wire_bytes_per_device"]
             / m0["predicted"][ph]["collective_wire_bytes_per_device"]
             for ph in wire}
    slo = m0["slo"]
    print(f"{tag}: {cfg.name} full width, {layers} layers, bf16, {SLOTS} "
          f"slots, max_len {MAX_LEN}: weights per rank "
          f"{[round(m['weights_gb'], 3) for m in main]} GB, peak "
          f"{[round(m['peak_memory_gb'], 2) for m in main]} GB, card used "
          f"{max(m['card_used_gb'] for m in main):.1f} GB; draw "
          f"{max(m['draw_s'] for m in main):.1f} s, run_config "
          f"{max(m['wall_s'] for m in main):.1f} s", flush=True)
    print(f"{tag}: requests={slo['requests']} tokens="
          f"{slo['generated_tokens']} TTFT p50={slo['ttft_ms']['p50']:.3f} "
          f"p95={slo['ttft_ms']['p95']:.3f} ms TPOT p50="
          f"{slo['tpot_ms']['p50']:.3f} p95={slo['tpot_ms']['p95']:.3f} ms "
          f"tokens/s={slo['tokens_per_s']:.2f} slo_met="
          f"{slo['slo_met_fraction']:.2f}; prefill groups "
          f"{m0['prefill_steps']}, decode steps {m0['decode_steps']}",
          flush=True)
    print(f"{tag}: launches per rank {m0['launches']} (held: flash "
          f"{layers} a prefill, phantom forward 3 x {layers} a prefill and "
          f"a decode step); wire bytes a rank, probe bucket {S_probe}: "
          f"prefill {wire['prefill']:.0f}, decode {wire['decode']:.0f} "
          f"(serve_wire_bytes, held on every rank); measured/predicted "
          f"wire {ratio}", flush=True)
    print(f"{tag}: J/token measured {m0['j_per_token_measured']:.4e}; "
          f"energy measured/predicted {m0['energy_ratio']} (the paper's "
          f"model at the H100's fp32 peak, not power read from the card)",
          flush=True)
    agree = m0["telemetry"]["agreement"]
    prof = [r["profile"] for r in ranks]
    print(f"{tag}: one decode step: wall ms "
          f"{[round(p['wall_ms'], 2) for p in prof]}, host ms in "
          f"{prof[0]['calls']} collectives "
          f"{[round(p['collective_ms'], 2) for p in prof]}; rank 0's device "
          f"{prof[0]['device_ms']} ms, {prof[0]['device_ops']} device ops; "
          f"top {prof[0]['top_device_ms']}", flush=True)
    print(f"{tag}: the ranks' agreement (rank 0, host, unrecorded groups): "
          f"{agree}; per-layer kernel vs plain (bf16, each within "
          f"{LOGIT_TOL} of the largest): {[r['layers'] for r in ranks]}",
          flush=True)
    return {"parity": par, "want_launches": want,
            "wire_counted": wire, "wire_ratio_to_prediction": ratio,
            "main": [{k: v for k, v in m.items() if k != "streams"}
                     for m in main],
            "streams": m0["streams"], "profile": prof,
            "layer_check": [r["layers"] for r in ranks]}


def phase_serve_mesh(pool=None):
    """Phase 17: chatglm3-6b served over meshes of ranks sharing the card
    (gloo, card tensors through the host), through the router's
    ``run_config``: (a) tensor sites at dp 2 x tp 4, (b) the phantom
    candidate at dp 1 x tp 4; (c) the router's priced table over
    ``SERVE_MESH_BUDGET`` devices at ``SERVE_MESH_SLO_MS``."""
    import torch
    from repro_torch.planner import paper_default_calibration
    from repro_torch.serve.router import (ServeConfig, candidate_configs,
                                          route)
    from repro_torch.serve.traffic import make_trace
    _free()
    kernels = _timed_kernels(
        "serve mesh", torch.Generator(device="cuda").manual_seed(SEED),
        SERVE_MESH_FLASH_SHAPES, SERVE_MESH_PHANTOM_SHAPES,
        phantom_names=("phantom_fused_matmul",))
    trace = make_trace(**SERVE_MESH_TRACE)
    calib = paper_default_calibration()
    winner, priced = route(candidate_configs(
        SERVE_MESH_ARCH, SERVE_MESH_BUDGET, slots_options=(SLOTS,),
        max_len=MAX_LEN, page_size=PAGE, smoke=False), calib, trace,
        slo_ms=SERVE_MESH_SLO_MS)
    print(f"serve mesh (c): route auto, slo {SERVE_MESH_SLO_MS:.0f} ms, "
          f"{SERVE_MESH_BUDGET} devices, {calib.source}:", flush=True)
    for pc in priced:
        print(f"serve mesh (c): {'*' if pc is winner else ' '} "
              f"{pc.config.name:<44s} J/tok={pc.j_per_token:.4e} "
              f"ttft={pc.ttft_s * 1e3:.3f}ms tpot={pc.tpot_s * 1e3:.3f}ms "
              f"slo_ok={pc.meets_slo}", flush=True)
    out = {"kernels": kernels, "route": {
        "winner": winner.config.name, "priced": [pc.as_dict()
                                                 for pc in priced]}}
    for impl, (dp, tp) in SERVE_MESH.items():
        cfg = ServeConfig(SERVE_MESH_ARCH, impl, dp, tp, SLOTS,
                          max_len=MAX_LEN, page_size=PAGE, smoke=False
                          ).model_config().replace(
                              num_layers=SERVE_MESH_LAYERS)
        t0 = time.perf_counter()
        ranks = _run_ranks(pool, _serve_mesh_rank, dp, tp, timeout_s=600,
                           args=(impl, SERVE_MESH_LAYERS))
        out[impl] = _serve_mesh_held(impl, ranks, cfg, SERVE_MESH_LAYERS)
        out[impl]["ranks_wall_s"] = time.perf_counter() - t0
        print(f"serve mesh {impl}: ranks' wall {out[impl]['ranks_wall_s']:.1f}"
              f" s", flush=True)
        _free()
    out["launches"] = {
        k: sum(out[impl]["main"][0]["launches"][k] for impl in SERVE_MESH)
        for k in ("flash_attention", "phantom_fused_matmul")}
    return out


def _family_mesh_cfg(arch, layers=None, dtype="bfloat16", impl=None):
    """``arch`` at full width with its own projection map (``impl``
    "tensor": the router's tensor candidate, every site tensor), every
    site on the kernel backend, cut to ``layers`` (default its
    ``FAMILY_MESH_DEPTH``; an encoder-decoder's encoder as deep as its
    decoder), in ``dtype`` activations."""
    from repro_torch.configs.base import get_config, with_kernel_backend
    from repro_torch.serve.router import ServeConfig
    n = layers or FAMILY_MESH_DEPTH.get(arch, FAMILY_MESH_LAYERS)
    cfg = (ServeConfig(arch, "tensor", 1, FAMILY_MESH_TP, SLOTS, MAX_LEN,
                       FAMILY_MESH_PAGE, smoke=False).model_config()
           if impl == "tensor" else get_config(arch))
    cfg = cfg.replace(num_layers=n, dtype=dtype)
    if cfg.family == "encdec":
        cfg = cfg.replace(encoder_layers=n)
    return with_kernel_backend(cfg, "auto")


def _family_mesh_trace(arch, n=None):
    """``FAMILY_MESH_TRACE`` (its first ``n`` requests); for a recurrent
    family each prompt's length rounded up to a multiple of the page,
    which its exact-length refill groups need (``serve/scheduler.py``
    rejects the others, as the reference's does)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.serve.engine import RECURRENT_FAMILIES
    from repro_torch.serve.traffic import make_trace
    trace = make_trace(**FAMILY_MESH_TRACE, max_requests=n or 0)
    if get_config(arch).family not in RECURRENT_FAMILIES:
        return trace
    page = FAMILY_MESH_PAGE
    return [dataclasses.replace(t, prompt_len=-(-t.prompt_len // page) * page)
            for t in trace]


def _family_mesh_launches(cfg, prefills, decodes):
    """Each kernel's launches on a rank for ``prefills`` prefill steps and
    ``decodes`` decode steps of ``cfg`` at tp 4: flash once a head-mode
    self-attention layer of a prefill (the encoder's too; ring attention
    and cross-attention run the plain core), the phantom forward once a
    phantom site of a layer of every step (the encoder's only at
    prefill)."""
    from repro_torch.configs.base import PHANTOM_KINDS
    from repro_torch.models.attention import (attn_site_strategies,
                                              resolve_attn_mode)
    from repro_torch.models.blocks import layer_plan
    from repro_torch.models.layers import mlp_strategies
    from repro_torch.models.ssm import ssm_site_strategies
    from repro_torch.parallel.axes import MeshAxes
    axes = MeshAxes(tp=FAMILY_MESH_TP)

    def phantom(sts):
        return sum(st.kind in PHANTOM_KINDS for st in sts.values())
    flash = sites = 0
    for mixer, ffn in layer_plan(cfg):
        if mixer == "attn":
            flash += resolve_attn_mode(cfg, axes) == "head"
            sites += phantom(attn_site_strategies(cfg, axes))
        else:
            sts = ssm_site_strategies(cfg, axes)
            sites += 2 * (sts["in"].kind in PHANTOM_KINDS) + (
                sts["out"].kind in PHANTOM_KINDS)
        if ffn == "mlp":
            sites += phantom(mlp_strategies(cfg, axes, cfg.d_model, cfg.d_ff))
    enc_flash = enc_sites = 0
    if cfg.family == "encdec":
        enc_flash = cfg.encoder_layers
        enc_sites = cfg.encoder_layers * phantom(
            mlp_strategies(cfg, axes, cfg.d_model, cfg.d_ff))
    return {"flash_attention": (flash + enc_flash) * prefills,
            "phantom_fused_matmul": ((sites + enc_sites) * prefills
                                     + sites * decodes),
            "matmul_nt": 0, "matmul_tn": 0}


def _mesh_layer_check(cfg, axes, params, toks):
    """One 48-token prefill of this rank's rows of any stack but an
    encoder-decoder's, block by block (a hybrid's every sub) in bf16 as
    served: the kernel path's block and the plain path's
    (``kernel_backend="xla"``) from the same input, each output and the
    last position's logits within ``LOGIT_TOL`` of the block's (the
    logits') largest magnitude.  Phase 4 holds each element to rtol/atol
    ``LOGIT_TOL`` at tp = 1, where only flash differs between the paths;
    at tp > 1 the plain path rounds a phantom site's local and ghost
    products to bf16 apart before it adds them, which moves elements
    near zero by a bf16 step of the products' size, beyond that
    elementwise tolerance at full width.  Returns the worst differences
    and their share of the largest."""
    import torch
    from repro_torch.configs.base import with_kernel_backend
    from repro_torch.models.blocks import block_apply
    from repro_torch.models.layers import (embed_apply, head_logits,
                                           norm_apply, residual_layout)
    from repro_torch.models.model import (_last_position, _layer, _plan,
                                          _subs, n_groups)
    plain = with_kernel_backend(cfg, "xla")
    lay = residual_layout(cfg, "prefill")
    plan = _plan(cfg)
    B, S = toks.shape
    pos = torch.arange(S, device=toks.device).expand(B, S)
    worst = worst_share = 0.0
    with torch.no_grad():
        h = embed_apply(cfg, lay, params["embed"], toks, axes)
        for i in range(n_groups(cfg)):
            for lp, mixer, ffn in _subs(plan, _layer(params, i)):
                h_k, _, _ = block_apply(cfg, lay, lp, h, pos, axes,
                                        kind="prefill", ffn=ffn, mixer=mixer)
                h_x, _, _ = block_apply(plain, lay, lp, h, pos, axes,
                                        kind="prefill", ffn=ffn, mixer=mixer)
                err, share = _err_of_largest(h_k, h_x)
                worst, worst_share = max(worst, err), max(worst_share, share)
                check(share <= LOGIT_TOL,
                      f"{cfg.name} mesh: rank {axes.rank} group {i} "
                      f"{mixer}/{ffn}: kernel and plain paths differ by "
                      f"{share:.3e} of the largest")
                h = h_k

        def logits(x):
            x = norm_apply(cfg, lay, params["final_norm"], x, axes)
            return head_logits(cfg, lay, params["head"],
                               _last_position(x, lay, axes),
                               axes)[..., :cfg.vocab_size]
        lg_k, lg_x = logits(h_k), logits(h_x)
    check(bool(torch.isfinite(lg_k).all()),
          f"{cfg.name} mesh: non-finite logits")
    lg_err, lg_share = _err_of_largest(lg_k, lg_x)
    check(lg_share <= LOGIT_TOL,
          f"{cfg.name} mesh: rank {axes.rank}: logits of the two paths "
          f"differ by {lg_share:.3e} of the largest")
    return {"per_layer_hidden": worst, "per_layer_share": worst_share,
            "logits": lg_err, "logits_share": lg_share}


def _family_parity(arch, axes, device):
    """``_serve_parity`` of phase 18: the trace's first
    ``FAMILY_MESH_PARITY_REQUESTS`` requests (``PARITY_TOKENS`` tokens at
    most) at ``FAMILY_MESH_LAYERS`` layers in float32, the twin the
    tensor candidate, frontends' stubs drawn from each prompt
    (``serve/engine.py: drawn_stubs``).  The requests arrive together: on
    the engines' wall clocks a poisson trace groups them differently at
    tp 4 and at tp 1, and an MoE's capacity drops a token or keeps it by
    which requests share its step."""
    import dataclasses
    from repro_torch.serve.engine import drawn_stubs
    trace = [dataclasses.replace(t, arrival_s=0.0, max_new_tokens=min(
        t.max_new_tokens, PARITY_TOKENS)) for t in
             _family_mesh_trace(arch, FAMILY_MESH_PARITY_REQUESTS)]
    return _serve_parity(
        _family_mesh_cfg(arch, FAMILY_MESH_LAYERS, "float32"),
        _family_mesh_cfg(arch, FAMILY_MESH_LAYERS, "float32", impl="tensor"),
        axes, device, trace, FAMILY_MESH_PAGE, drawn_stubs)


def _family_mesh_rank(axes, device):
    """``phase_family_mesh`` inside one of the ``FAMILY_MESH_TP`` ranks
    sharing the card, for each arch of ``FAMILY_MESH`` in turn: (1) the
    parity, float32 streams against tp = 1 (``_family_parity``) or, for
    the archs of ``FAMILY_MESH_LAYER_CHECK``, the per-layer bf16 check
    of the main path's weights (``_mesh_layer_check``); (2) the main
    path, ``run_config`` at the arch's depth in bf16 with drawn stubs,
    kernel counts from 0 just before and read just after; (3) one
    profiled decode step."""
    import numpy as np
    import torch
    from repro_torch.planner import paper_default_calibration
    from repro_torch.serve.engine import drawn_stubs
    from repro_torch.serve.router import ServeConfig, run_config, serve_params
    out = {}
    for arch in FAMILY_MESH:
        t_arch = time.perf_counter()
        res = {}
        if arch not in FAMILY_MESH_LAYER_CHECK:
            res["parity"] = _family_parity(arch, axes, device)
        cfg = _family_mesh_cfg(arch)
        sc = ServeConfig(arch, "tensor", axes.dp, axes.tp, SLOTS,
                         max_len=MAX_LEN, page_size=FAMILY_MESH_PAGE,
                         smoke=False)
        t0 = time.perf_counter()
        params = serve_params(cfg, axes, SEED, device)
        torch.cuda.synchronize()
        res["draw_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _kernel_counts(reset=True)
        t0 = time.perf_counter()
        main = run_config(sc, _family_mesh_trace(arch), axes, device=device,
                          cfg=cfg, params=params,
                          calib=paper_default_calibration(), seed=SEED,
                          stubs=drawn_stubs)
        torch.cuda.synchronize()
        main.update(launches=_kernel_counts(),
                    wall_s=time.perf_counter() - t0,
                    weights_gb=sum(t.numel() * t.element_size()
                                   for t in _leaves(params)) / 1e9,
                    peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        free, total = torch.cuda.mem_get_info()
        main["card_used_gb"] = (total - free) / 1e9
        res["main"] = main
        if arch in FAMILY_MESH_LAYER_CHECK:
            toks = torch.from_numpy(np.random.RandomState(SEED + 3).randint(
                0, cfg.vocab_size, (SLOTS, 48))).long().to(device)
            res["layers"] = _mesh_layer_check(cfg, axes, params, toks)
        res["profile"] = _profile_mesh_decode(
            cfg, params, axes, device, FAMILY_MESH_PAGE, drawn_stubs)
        del params
        _free()
        res["wall_s"] = time.perf_counter() - t_arch
        out[arch] = res
    return out


def _family_mesh_held(arch, ranks):
    """Hold one arch's ranks: parity, every request's tokens, launches,
    wire bytes to the byte; print what the phase measured.  Returns the
    summary kept in the JSON."""
    cfg = _family_mesh_cfg(arch)
    tp = FAMILY_MESH_TP
    tag = f"family mesh {arch} tp {tp}"
    res = [r[arch] for r in ranks]
    r0 = res[0]
    summary = {}
    if "parity" in r0:
        par = r0["parity"]
        check(all(r["parity"]["mesh"] == par["mesh"] for r in res),
              f"{tag}: ranks disagree on the float32 streams")
        check(par["mesh"] == par["tp1"],
              f"{tag}: float32 streams at {FAMILY_MESH_LAYERS} layers part "
              f"from tp = 1's at {_first_parting(par['mesh'], par['tp1'])}")
        summary["parity"] = par
        print(f"{tag}: parity at {FAMILY_MESH_LAYERS} layers: float32 "
              f"streams of the trace's first {FAMILY_MESH_PARITY_REQUESTS} "
              f"requests equal tp = 1's (held): {par['mesh']}", flush=True)
    else:
        summary["layer_check"] = [r["layers"] for r in res]
        print(f"{tag}: per-layer kernel vs plain, bf16, each within "
              f"{LOGIT_TOL} of the layer's largest (held; float32 weights "
              f"of the tp 4 ranks and the tp 1 twin would not fit the "
              f"card): {summary['layer_check']}", flush=True)
    main = [r["main"] for r in res]
    m0 = main[0]
    trace = _family_mesh_trace(arch)
    for m in main:
        check(m["streams"] == m0["streams"],
              f"{tag}: ranks disagree on the served streams")
    for s, t in zip(m0["streams"], trace):
        check(len(s) == t.max_new_tokens and all(
            0 <= x < cfg.vocab_size for x in s),
            f"{tag}: a request ended with {len(s)} of {t.max_new_tokens} "
            f"tokens")
    # the replay's steps, the warm-up's (one prefill a bucket, one
    # decode) and the measured account's probes (one each)
    want = _family_mesh_launches(
        cfg, m0["prefill_steps"] + m0["warmup_prefills"] + 1,
        m0["decode_steps"] + 2)
    for m in main:
        check(m["launches"] == want,
              f"{tag}: launches {m['launches']}, want {want}")
    S_probe = m0["probe_bucket"]
    wire = {ph: serve_wire_bytes(cfg, SLOTS, S_probe, tp, ph)
            for ph in ("prefill", "decode")}
    for m in main:
        for ph in wire:
            got = sum(c["wire_bytes"] for c in m["collectives"][ph].values())
            check(got == wire[ph], f"{tag}: {ph} wire bytes {got}, counted "
                                   f"{wire[ph]}")
    slo = m0["slo"]
    prof = [r["profile"] for r in res]
    print(f"{tag}: {cfg.num_layers} layers"
          f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}"
          f", bf16, page {FAMILY_MESH_PAGE}: weights a rank "
          f"{[round(m['weights_gb'], 3) for m in main]} GB, peak "
          f"{[round(m['peak_memory_gb'], 2) for m in main]} GB, card used "
          f"{max(m['card_used_gb'] for m in main):.1f} GB; draw "
          f"{max(r['draw_s'] for r in res):.1f} s, run_config "
          f"{max(m['wall_s'] for m in main):.1f} s, arch "
          f"{max(r['wall_s'] for r in res):.1f} s", flush=True)
    print(f"{tag}: requests={slo['requests']} tokens="
          f"{slo['generated_tokens']} TTFT p50={slo['ttft_ms']['p50']:.3f} "
          f"p95={slo['ttft_ms']['p95']:.3f} ms TPOT p50="
          f"{slo['tpot_ms']['p50']:.3f} p95={slo['tpot_ms']['p95']:.3f} ms "
          f"tokens/s={slo['tokens_per_s']:.2f}; prefill groups "
          f"{m0['prefill_steps']}, decode steps {m0['decode_steps']}",
          flush=True)
    print(f"{tag}: launches a rank {m0['launches']} (held); wire bytes a "
          f"rank, probe bucket {S_probe}: prefill {wire['prefill']:.0f}, "
          f"decode {wire['decode']:.0f} (serve_wire_bytes, held on every "
          f"rank)", flush=True)
    print(f"{tag}: one decode step: wall ms "
          f"{[round(p['wall_ms'], 2) for p in prof]}, host ms in "
          f"{prof[0]['calls']} collectives "
          f"{[round(p['collective_ms'], 2) for p in prof]}; rank 0's device "
          f"{prof[0]['device_ms']} ms, {prof[0]['device_ops']} device ops; "
          f"top {prof[0]['top_device_ms']}", flush=True)
    summary.update(
        want_launches=want, wire_counted=wire, probe_bucket=S_probe,
        slo={k: slo[k] for k in ("ttft_ms", "tpot_ms", "tokens_per_s",
                                 "requests", "generated_tokens")},
        main=[{k: v for k, v in m.items()
               if k not in ("streams", "telemetry", "collectives")}
              for m in main],
        agreement=m0["telemetry"]["agreement"], profile=prof,
        streams=m0["streams"], wall_s=[r["wall_s"] for r in res])
    return summary


def phase_family_mesh(pool=None):
    """Phase 18: the families other than the dense one served over dp 1 x
    tp 4, ranks sharing the card (gloo, card tensors through the host).
    First, in the parent, flash at a rank's prefill heads and the phantom
    forward at a rank's sites of each family (a decode step's 4 rows and
    a 48-token group's 192), bf16, held and timed as in phases 2 and 3,
    and with a cold L2.  Then one spawn of ``FAMILY_MESH_TP`` ranks serves
    each arch of ``FAMILY_MESH`` in turn (``_family_mesh_rank``), held by
    ``_family_mesh_held``."""
    import torch
    _free()
    kernels = _timed_kernels(
        "family mesh", torch.Generator(device="cuda").manual_seed(SEED),
        FAMILY_MESH_FLASH_SHAPES, FAMILY_MESH_PHANTOM_SHAPES,
        phantom_names=("phantom_fused_matmul",))
    t0 = time.perf_counter()
    ranks = _run_ranks(pool, _family_mesh_rank, 1, FAMILY_MESH_TP)
    out = {"kernels": kernels, "ranks_wall_s": time.perf_counter() - t0}
    for arch in FAMILY_MESH:
        out[arch] = _family_mesh_held(arch, ranks)
    out["launches"] = {
        k: sum(out[arch]["main"][0]["launches"][k] for arch in FAMILY_MESH)
        for k in ("flash_attention", "phantom_fused_matmul")}
    print(f"family mesh: ranks' wall {out['ranks_wall_s']:.1f} s; "
          f"launches a rank over the six main paths {out['launches']}",
          flush=True)
    return out


def _fleet_sc(impl, tp):
    """A pool of phase 19: chatglm3-6b at full width, ``impl`` sites
    (phantom: the router's candidate, gate/up/down at k = 16) on dp 1 x
    ``tp``, every site on the kernel backend."""
    from repro_torch.serve.router import ServeConfig
    return ServeConfig(FLEET_ARCH, impl, 1, tp, SLOTS, max_len=MAX_LEN,
                       page_size=PAGE, smoke=False, kernel_backend="pallas")


def _fleet_prefix():
    """The parity's trace: the first requests of ``FLEET_TRACE``,
    ``PARITY_TOKENS`` new tokens at most."""
    import dataclasses
    from repro_torch.serve.traffic import make_trace
    return [dataclasses.replace(t, max_new_tokens=min(t.max_new_tokens,
                                                      PARITY_TOKENS))
            for t in make_trace(**FLEET_TRACE,
                                max_requests=FLEET_PARITY_REQUESTS)]


def _fleet_run(sc, cfg, params, axes, device, trace):
    """One executed fleet replay of ``trace`` on this rank, both pools
    ``sc`` serving ``cfg`` on ``params``, one replica each, kernel counts
    from 0 just before and read just after: the report, the greedy
    streams (in trace order), the launches, the bytes the migrations
    carry counted from the decls (``cache_decls`` of one request at its
    padded prompt length, at the declared dtypes), the engines' step
    meters and the modeled step ms that drove the clock."""
    import torch
    from repro_torch.models.model import cache_decls
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.planner import paper_default_calibration
    from repro_torch.serve.fleet import (AutoscalePolicy, FleetConfig,
                                         FleetRouter)
    from repro_torch.serve.scheduler import bucket_of
    pol = AutoscalePolicy(min_replicas=1, max_replicas=1)
    fc = FleetConfig(prefill=sc, decode=sc, slo_ms=SERVE_MESH_SLO_MS,
                     executed=True, prefill_policy=pol, decode_policy=pol)
    router = FleetRouter(fc, calib=paper_default_calibration(), seed=SEED,
                         axes=axes, device=device, cfg=cfg, params=params)
    torch.cuda.synchronize()
    _kernel_counts(reset=True)
    t0 = time.perf_counter()
    rep = router.run(trace)
    torch.cuda.synchronize()
    launches = _kernel_counts()
    wall_s = time.perf_counter() - t0
    # every request migrates (4 new tokens at least)
    counted = sum(
        math.prod(t.shape) * t.dtype.itemsize
        for it in trace for t in _leaves(cache_decls(
            cfg, MeshAxes(), 1, bucket_of(it.prompt_len, sc.page_size))))
    pre = router.pre.account
    streams = {r.req_id: list(r.out_tokens) for r in router.finished}
    return {"report": rep, "launches": launches, "wall_s": wall_s,
            "streams": [streams.get(i) for i in range(len(trace))],
            "counted_bytes": counted,
            "meters": {"prefill": router.pre.engine.prefill_meter.summary(),
                       "decode": router.dec.replicas[0].engine
                       .decode_meter.summary()},
            "modeled_ms": {
                "prefill": {S: pre.prefill_step(S)[0] * 1e3 for S in
                            rep["pools"]["prefill"]["steps_by_bucket"]},
                "decode": router.dec.account.decode_step()[0] * 1e3}}


def _fleet_rank(axes, device):
    """Phase 19 (b) inside one of the ``FLEET_TP`` ranks: the float32
    parity at ``FLEET_PARITY_LAYERS`` layers (the fleet's streams, a
    plain replay on the mesh and the tp = 1 engine's on the dense twin:
    ``_serve_parity``), then the main path, the fleet in bf16 at
    ``FLEET_MESH_LAYERS`` layers."""
    from repro_torch.serve.router import serve_params
    from repro_torch.serve.traffic import make_trace
    sc = _fleet_sc("phantom", axes.tp)
    cfg32, twin = (c.replace(num_layers=FLEET_PARITY_LAYERS, dtype="float32")
                   for c in (sc.model_config(),
                             _fleet_sc("tensor", 1).model_config()))
    prefix = _fleet_prefix()
    par = _serve_parity(cfg32, twin, axes, device, prefix)
    par["fleet"] = _fleet_run(sc, cfg32, serve_params(cfg32, axes, SEED,
                                                       device),
                              axes, device, prefix)["streams"]
    _free()
    cfg = sc.model_config().replace(num_layers=FLEET_MESH_LAYERS)
    main = _fleet_run(sc, cfg, serve_params(cfg, axes, SEED, device), axes,
                      device, make_trace(**FLEET_TRACE))
    _free()
    return {"parity": par, "main": main}


def _fleet_held(tag, runs, cfg, phantom):
    """Hold one fleet's main path on every rank's run: every request's
    tokens, the same streams, the launches the layers imply (flash once
    a layer of every prefill group and never in a decode step; the
    phantom forward once a phantom site of every prefill group and
    decode step), the migrated bytes equal to the count from the decls
    and measured/predicted wire in ``FLEET_WIRE_BAND``; print the
    engines' measured step ms beside the modeled ones."""
    from repro_torch.serve.traffic import make_trace
    trace = make_trace(**FLEET_TRACE)
    r0 = runs[0]
    rep = r0["report"]
    for r in runs:
        check(r["streams"] == r0["streams"],
              f"{tag}: ranks disagree on the streams")
    check(rep["requests"]["finished"] == len(trace),
          f"{tag}: {rep['requests']} of {len(trace)} requests finished")
    for s, t in zip(r0["streams"], trace):
        check(s is not None and len(s) == t.max_new_tokens
              and all(0 <= x < cfg.vocab_size for x in s),
              f"{tag}: a request ended with {s} of {t.max_new_tokens} "
              f"tokens")
    L = cfg.num_layers
    pre, dec = rep["pools"]["prefill"]["steps"], rep["pools"]["decode"]["steps"]
    want = {"flash_attention": L * pre,
            "phantom_fused_matmul": 3 * L * (pre + dec) if phantom else 0,
            "matmul_nt": 0, "matmul_tn": 0}
    for r in runs:
        check(r["launches"] == want,
              f"{tag}: launches {r['launches']}, want {want}")
        got = r["report"]["transfer"]["measured"]["transfer_wire_bytes"]
        check(got == r["counted_bytes"],
              f"{tag}: migrated {got} B, counted {r['counted_bytes']} B")
        ratio = r["report"]["transfer"]["ratio_wire_bytes"]
        check(FLEET_WIRE_BAND[0] <= ratio <= FLEET_WIRE_BAND[1],
              f"{tag}: measured/predicted wire {ratio}")
    x = rep["transfer"]["measured"]
    slo = rep["slo"]
    print(f"{tag}: {cfg.name} {L} layers bf16: requests "
          f"{rep['requests']['finished']}/{len(trace)}, prefill groups "
          f"{pre} {rep['pools']['prefill']['steps_by_bucket']}, decode "
          f"steps {dec}; launches a rank {r0['launches']} (held); "
          f"migrations {x['migrations']}, {x['transfer_wire_bytes']:.0f} B "
          f"({x['bytes_per_migration']:.1f} B each) = the decls' count on "
          f"every rank, measured/predicted wire "
          f"{rep['transfer']['ratio_wire_bytes']:.6f}; fleet clock TTFT "
          f"p50 {slo['ttft_ms']['p50']:.3f} ms, TPOT p50 "
          f"{slo['tpot_ms']['p50']:.3f} ms (modeled); J/token "
          f"{rep['j_per_token']}; replay wall "
          f"{max(r['wall_s'] for r in runs):.1f} s", flush=True)
    for ph in ("prefill", "decode"):
        m = r0["meters"][ph]
        print(f"{tag}: {ph} step measured (StepMeter, rank 0): median "
              f"{m.get('wall_us_median', 0.0) / 1e3:.3f} ms, range "
              f"{m.get('wall_us_min', 0.0) / 1e3:.3f}-"
              f"{m.get('wall_us_max', 0.0) / 1e3:.3f} ms over {m['calls']} "
              f"calls ({m['warmup']} warm-up); modeled alpha+beta "
              f"{r0['modeled_ms'][ph]} ms", flush=True)
    return {"want_launches": want, "report": rep,
            "runs": [{k: v for k, v in r.items() if k != "report"}
                     for r in runs]}


def phase_fleet(device="cuda", rank=None, pool=None):
    """Phase 19: the disaggregated fleet executed on the card through
    the flash and phantom kernels: (a) one process, tensor pools at
    tp 1; (b) ``FLEET_TP`` ranks sharing the card, each running ``rank``
    (default ``_fleet_rank``), phantom pools at tp ``FLEET_TP``; each
    preceded by its float32 parity against a plain engine's replay."""
    import torch
    from repro_torch.parallel.axes import MeshAxes
    from repro_torch.serve.router import serve_params
    from repro_torch.serve.traffic import make_trace
    _free()
    device, axes = torch.device(device), MeshAxes()
    sc = _fleet_sc("tensor", 1)
    prefix = _fleet_prefix()
    cfg32 = sc.model_config().replace(num_layers=FLEET_PARITY_LAYERS,
                                      dtype="float32")
    params = serve_params(cfg32, axes, SEED, device)
    par = {"fleet": _fleet_run(sc, cfg32, params, axes, device,
                               prefix)["streams"],
           "plain": _replayed(cfg32, params, axes, device, prefix)}
    check(par["fleet"] == par["plain"],
          f"fleet (a): float32 streams part from the plain replay's at "
          f"{_first_parting(par['fleet'], par['plain'])}")
    print(f"fleet (a): parity at {FLEET_PARITY_LAYERS} layers: float32 "
          f"streams of the trace's first {FLEET_PARITY_REQUESTS} requests "
          f"equal a plain engine replay's (held)", flush=True)
    del params
    _free()
    cfg = sc.model_config().replace(num_layers=SERVE_DEPTH[FLEET_ARCH])
    params = serve_params(cfg, axes, SEED, device)
    out = {"one_card": _fleet_held(
        "fleet (a) tensor tp 1", [_fleet_run(sc, cfg, params, axes, device,
                                             make_trace(**FLEET_TRACE))],
        cfg, False)}
    out["one_card"]["parity"] = par
    del params
    _free()
    t0 = time.perf_counter()
    ranks = _run_ranks(pool, rank or _fleet_rank, 1, FLEET_TP, device=device,
                       timeout_s=600)
    par = ranks[0]["parity"]
    tag = f"fleet (b) phantom tp {FLEET_TP}"
    for r in ranks:
        check(r["parity"]["fleet"] == par["fleet"] == r["parity"]["mesh"],
              f"{tag}: float32 fleet streams part from the mesh replay's "
              f"at {_first_parting(r['parity']['fleet'], r['parity']['mesh'])}")
    check(par["fleet"] == par["tp1"],
          f"{tag}: float32 fleet streams part from tp = 1's at "
          f"{_first_parting(par['fleet'], par['tp1'])}")
    print(f"{tag}: parity at {FLEET_PARITY_LAYERS} layers: float32 streams "
          f"equal the mesh engine's replay and tp = 1's (held)", flush=True)
    cfg = _fleet_sc("phantom", FLEET_TP).model_config().replace(
        num_layers=FLEET_MESH_LAYERS)
    out["mesh"] = _fleet_held(tag, [r["main"] for r in ranks], cfg, True)
    out["mesh"]["parity"] = par
    out["mesh"]["ranks_wall_s"] = time.perf_counter() - t0
    print(f"{tag}: ranks' wall {out['mesh']['ranks_wall_s']:.1f} s",
          flush=True)
    return out


# phase 20: paper-ffn-4k's width on 8 gloo ranks sharing the card, host3
# lost at step 12; the straggler detector off (a threshold of 1e6): the
# shared host's step times would trip it at random, and its out-of-cadence
# save would move the restored step away from the prediction.  AdamW at
# 5e-4: at the default 3e-3 its per-element steps stall the loss from
# width 2048 on (PERF.md §6)
ELASTIC = dict(devices=8, hosts=4, width=4096, depth=2, batch=64,
               initial_strategy="tensor_col", ks=(4, 8, 16),
               checkpoint_every=10, max_steps=24, target_loss=1e-9,
               audit_replan=False, straggler_threshold=1e6, lr=5e-4)
ELASTIC_KILLS = ((12, "host3"),)
# the CPU planner's and cluster's prediction (PERF.md §6)
ELASTIC_PLANS = ["tensor_col_n4096_mesh1x8", "phantom_n4096_mesh1x2_k4"]
ELASTIC_RECOVERY = {"detect_step": 14, "restored_step": 10,
                    "replayed_steps": 4, "distilled": True,
                    "from_scratch": False}
# the watchdog's slow step: step 11 (index; before the loss, replayed
# after it) sleeps ELASTIC_SLOW_FACTOR - 1 times the self-baseline (the
# median of steps 1-5) inside its metered window; a spike at 8x (not the
# default 3x: the shared host's step times vary by more than 3x, as the
# straggler detector's 4x showed) trips on it alone, and the 20
# observations' cooldown after it cover the rest of the run, the
# replayed slow step and the re-planned plan's other step time included
ELASTIC_SLOW_STEP, ELASTIC_SLOW_FACTOR, ELASTIC_SPIKE = 11, 24.0, 8.0
ELASTIC_TRACE = ROOT / "build" / "chip_smoke_elastic_trace.json"
ELASTIC_REPORT = ROOT / "build" / "chip_smoke_elastic_report.json"
ACCOUNT_TOL = 1e-9
POOL_TIMEOUT_S = 1800.0      # the 4-rank pool's collective timeout


def phase_elastic():
    """Phase 20: ``train/elastic.py: run_elastic`` on the card
    (``ELASTIC``): tensor_col on 8 ranks, host3 lost at step 12,
    re-planned over the 6 survivors onto the phantom plan the CPU
    planner predicts, the step-10 checkpoint distilled into it, 24
    steps; traced, with the energy-drift watchdog and one slow step
    before the loss (``ELASTIC_SLOW_STEP``).  Held: the plans and the
    recovery's fields against the prediction, the checkpoint bytes
    against the saves times each plan's global parameters and AdamW
    moments, the account's identity, each phase's losses finite and
    falling; the watchdog's one spike at the slow step, its anomaly row
    and rank 0's capture of the next step; ``python -m
    repro_torch.launch.obs verify-recovery`` on the run's trace and
    report (the reference's tolerance, rel 0.35)."""
    import shutil
    from repro_torch.core.ffn import ffn_model_params
    from repro_torch.obs import EnergyDriftWatchdog
    from repro_torch.planner import PlanCandidate
    from repro_torch.telemetry import Ledger
    from repro_torch.train.elastic import ElasticConfig, run_elastic
    from repro_torch.train.fault import FaultScript
    workdir = ROOT / "build" / "chip_smoke_elastic"
    shutil.rmtree(workdir, ignore_errors=True)
    cfg = ElasticConfig(workdir=str(workdir),
                        slow_steps=(ELASTIC_SLOW_STEP,),
                        slow_factor=ELASTIC_SLOW_FACTOR, **ELASTIC)
    ledger = Ledger(run="chip_smoke.elastic")
    wd = EnergyDriftWatchdog(ledger=ledger, spike_factor=ELASTIC_SPIKE,
                             profile_dir=str(workdir / "profile"),
                             name=f"elastic_ffn{cfg.width}",
                             arch=f"ffn{cfg.width}")
    t0 = time.perf_counter()
    with observed({"run": "chip_smoke.elastic"}) as (tracer, reg):
        res = run_elastic(cfg, fault_script=FaultScript(kills=ELASTIC_KILLS),
                          device="cuda", ledger=ledger, watchdog=wd,
                          log_fn=lambda m: print(f"elastic (b): {m}",
                                                 flush=True))
    wall = time.perf_counter() - t0
    obs = _elastic_obs_held(tracer, reg, ledger, wd, res)
    shutil.rmtree(workdir, ignore_errors=True)
    check(not res.aborted and res.final_step == cfg.max_steps,
          f"elastic (b): aborted {res.aborted}, final step {res.final_step}")
    check(res.plan_names == ELASTIC_PLANS,
          f"elastic (b): plans {res.plan_names}, predicted {ELASTIC_PLANS}")
    check(len(res.recoveries) == 1, f"elastic (b): {len(res.recoveries)} "
                                    f"recoveries, want 1")
    rec = {k: res.recoveries[0][k] for k in ELASTIC_RECOVERY}
    check(rec == ELASTIC_RECOVERY,
          f"elastic (b): recovery {rec}, predicted {ELASTIC_RECOVERY}")
    want_bytes, at, phase_losses = 0, 0, []
    for ph in res.phases:
        (dp, tp, pp), k = ph["mesh"], ph["k"]
        plan = PlanCandidate(dp=dp, tp=tp, pp=pp, k=k,
                             strategy=ph["strategy"], width=cfg.width,
                             depth=cfg.depth, batch=cfg.batch)
        saves = sum(1 for s in range(ph["start_step"] + 1,
                                     ph["start_step"] + ph["steps"] + 1)
                    if s % cfg.checkpoint_every == 0)
        per = 3 * 4 * ffn_model_params(plan.model_config(), plan.tp)
        check(ph["ckpt_io_bytes"] == saves * per,
              f"elastic (b): {ph['plan']} wrote {ph['ckpt_io_bytes']} B, "
              f"{saves} saves of {per} B")
        want_bytes += saves * per
        losses = res.losses[at:at + ph["steps"]]
        phase_losses.append(losses)
        at += ph["steps"]
        check(all(math.isfinite(v) for v in losses)
              and losses[-1] < losses[0],
              f"elastic (b): {ph['plan']}'s losses not finite and falling: "
              f"{losses}")
    a = res.account
    parts = (a["energy_j_useful"] + a["energy_j_replay"]
             + a["energy_j_ckpt_io"] + a["energy_j_restart"])
    check(abs(a["energy_j_total"] - parts) <= ACCOUNT_TOL * a["energy_j_total"],
          f"elastic (b): account total {a['energy_j_total']!r} against the "
          f"sum of its parts {parts!r}")
    check(a["ckpt_io_bytes"] == want_bytes,
          f"elastic (b): account bytes {a['ckpt_io_bytes']}, want "
          f"{want_bytes}")
    r = res.recoveries[0]
    print(f"elastic (b): plans {res.plan_names} (as predicted); recovery "
          f"{rec} (as predicted); checkpoint bytes {int(a['ckpt_io_bytes']):,}"
          f" (held); account total {a['energy_j_total']!r} J = useful "
          f"{a['energy_j_useful']!r} + replay {a['energy_j_replay']!r} + IO "
          f"{a['energy_j_ckpt_io']!r} + restart {a['energy_j_restart']!r} "
          f"(held to {ACCOUNT_TOL:g}), replay overhead "
          f"{a['replay_overhead_ratio']:.4f}", flush=True)
    for ph, losses in zip(res.phases, phase_losses):
        print(f"elastic (b): {ph['plan']}: steps {ph['start_step']}.."
              f"{ph['start_step'] + ph['steps'] - 1}, compile_s "
              f"{ph['compile_s']:.2f} (spawn, build, warm-up), wall_s "
              f"{ph['wall_s']:.2f}, checkpoint write s {ph['ckpt_io_s']:.3f}"
              f"; losses (finite, falling: held) "
              f"{[round(v, 5) for v in losses]}", flush=True)
    print(f"elastic (b): restore_s {r['restore_s']:.2f} (load, distil), "
          f"replan_s {r['replan_s']:.4f}; the run took {wall:.1f} s",
          flush=True)
    return {"result": res.as_dict(), "losses": phase_losses, "obs": obs,
            "wall_s": wall}


def _elastic_obs_held(tracer, reg, ledger, wd, res):
    """Hold phase 20's observability: exactly one watchdog trip, a spike
    at ``ELASTIC_SLOW_STEP``, with its anomaly ledger row, its
    ``watchdog/spike`` instant and rank 0's capture of the next step
    (``rank0.json``); the recovery spans against the account through
    ``python -m repro_torch.launch.obs verify-recovery`` on the written
    trace and report.  Returns the trip, the capture and the spans."""
    import os
    tracer.write(str(ELASTIC_TRACE))
    ledger.write_report(str(ELASTIC_REPORT))
    trips = [(t.kind, t.step) for t in wd.trips]
    check(trips == [("spike", ELASTIC_SLOW_STEP)],
          f"elastic (c): watchdog trips {trips}, want one spike at step "
          f"{ELASTIC_SLOW_STEP}")
    rows = [e for e in ledger.entries if e.kind == "anomaly"]
    check([e.measured["step"] for e in rows] == [ELASTIC_SLOW_STEP],
          f"elastic (c): anomaly rows {[e.as_dict() for e in rows]}")
    capture = os.path.join(wd.profile_dir, "rank0.json")
    check(wd.captures and os.path.exists(capture),
          f"elastic (c): captures {wd.captures}, no {capture}")
    doc = tracer.to_chrome()
    instants = span_counts(doc, ph="i")
    check(instants["watchdog/spike"] == 1 and instants["elastic/detect"]
          == 1, f"elastic (c): instants {dict(instants)}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    verify = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.obs", "verify-recovery",
         "--trace", str(ELASTIC_TRACE), "--report", str(ELASTIC_REPORT)],
        capture_output=True, text=True, env=env, timeout=300)
    check(verify.returncode == 0,
          f"elastic (c): verify-recovery exit {verify.returncode}: "
          f"{verify.stdout} {verify.stderr}")
    t = wd.trips[0]
    out = {"trip": t.as_dict(), "capture_bytes": os.path.getsize(capture),
           "capture_kernels": _capture_kernels(capture),
           "spans": dict(span_counts(doc, 0)),
           "pids": sorted({e["pid"] for e in doc["traceEvents"]}),
           "verify_recovery": verify.stdout.strip().splitlines(),
           "span_cost_us": span_cost_us()}
    print(f"elastic (c): watchdog spike at step {t.step} (held), ratio "
          f"{t.ratio:.2f} ({t.measured_s * 1e3:.1f} ms against "
          f"{t.predicted_s * 1e3:.2f} ms), anomaly row and rank 0's "
          f"capture ({out['capture_bytes']:,} B) held; pid 0's spans "
          f"{out['spans']}; pids {out['pids']}; verify-recovery: "
          f"{' | '.join(out['verify_recovery'])}", flush=True)
    return out


# phase 21: the planner on the card.  The pilots at the plan CLI's
# defaults (devices 8, width 1024, depth 2, batch 64, ks 4,8,16, pilot tp
# 4, the paper's calibration) but PLAN_PILOT_STEPS steps, not 300, for the
# script's time; PLAN_TARGET from a CPU run of the same pilots, which
# crossed it at steps 22 (tensor_col) and 95 (phantom k 4, 8, 16).  The
# winner is applied to phi3-mini at phase 9's cut (LM_TP_LAYERS layers,
# batch LM_BATCH x seq LM_SEQ, bf16), LM_STEPS steps; step 1 at
# LM_PARITY_LAYERS layers in float32, kernels against plain
PLAN_PILOT_STEPS, PLAN_TARGET = 150, 0.21
PLAN_REPORT = ROOT / "build" / "chip_smoke_plan.json"
PLAN_TRACE = ROOT / "build" / "chip_smoke_plan_trace.json"
PLAN_METRICS = ROOT / "build" / "chip_smoke_plan_metrics.prom"
HBM_LIMIT = 80e9
# the sites of a phi3-mini layer whose projections the applied map sets
PLAN_SITES = ("attn_q", "attn_k", "attn_v", "attn_o", "ffn_gate", "ffn_up",
              "ffn_down")


def _plan_launches(cfg, layers):
    """Each kernel's launches in one train step of ``layers`` layers of
    ``cfg`` under full remat: flash and each phantom site's forward twice
    (the forward and its recompute), each phantom site's dgrad and wgrad
    once (rows 1b-4b's rule, at every site the map makes phantom)."""
    from repro_torch.configs.base import PHANTOM_KINDS
    n = sum(cfg.projection_spec(s).kind in PHANTOM_KINDS for s in PLAN_SITES)
    return {"flash_attention": 2 * layers,
            "phantom_fused_matmul": 2 * n * layers,
            "matmul_nt": n * layers, "matmul_tn": n * layers}


def _plan_shapes(cfg, plan):
    """The kernels' per-rank shapes on phase 21's main path: flash's (B,
    S, H, KV, hd) at the winner's dp and tp, and the phantom kernels'
    distinct (M, K, N, PK) over the sites the applied map makes phantom
    (PK = k * tp, the ghosts of the tp ranks side by side)."""
    from repro_torch.configs.base import PHANTOM_KINDS
    tp, B = plan.tp, LM_BATCH // plan.dp
    hd = cfg.head_dim or cfg.d_model // cfg.num_heads
    flash = (B, LM_SEQ, cfg.num_heads // tp, cfg.num_kv_heads // tp, hd)
    d, q, kv, f = (n // tp for n in (cfg.d_model, cfg.num_heads * hd,
                                     cfg.num_kv_heads * hd, cfg.d_ff))
    sites = {"attn_q": (d, q), "attn_k": (d, kv), "attn_v": (d, kv),
             "attn_o": (q, d), "ffn_gate": (d, f), "ffn_up": (d, f),
             "ffn_down": (f, d)}
    phantom = []
    for site, (K, N) in sites.items():
        spec = cfg.projection_spec(site)
        shape = (B * LM_SEQ, K, N, spec.k * tp)
        if spec.kind in PHANTOM_KINDS and shape not in phantom:
            phantom.append(shape)
    return flash, phantom


def _plan_rank(axes, device, cfg, args):
    """``phase_plan`` (c) inside one of the winner's ranks: step 1
    kernels against plain at ``LM_PARITY_LAYERS`` layers in float32, then
    the main path, ``launch/train.py``'s trainer at ``LM_TP_LAYERS``
    layers in bf16 for ``LM_STEPS`` steps."""
    from repro_torch.configs.base import with_kernel_backend
    from repro_torch.data.synthetic import LMDataset
    from repro_torch.models.model import model_decls
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.parallel.params import materialize_shards
    from repro_torch.train.trainer import local_rows
    out = {"rank": axes.rank}
    cut = cfg.replace(num_layers=LM_PARITY_LAYERS, dtype="float32")
    batch = local_rows(LMDataset(cut.vocab_size, args.batch, args.seq + 1,
                                 device=device)(0), axes)
    sched = warmup_cosine(3e-4, 20, LM_STEPS)
    params = materialize_shards(model_decls(cut, axes), axes, SEED, device,
                                draw_on=device)
    res, launches = {}, {}
    for name, backend in (("kernel", "auto"), ("plain", "xla")):
        res[name], launches[name], eps = _tp_step1(
            with_kernel_backend(cut, backend), axes, device, params, batch,
            sched)
    out["kernel_vs_plain"] = {part: _step1_diff(res, part, sched(0), eps)
                              for part in ("loss", "grads", "params")}
    out["kernel_vs_plain"]["launches"] = launches
    out["kernel_vs_plain"]["loss_values"] = {
        n: float(r["loss"]) for n, r in res.items()}
    del params, res
    _free()
    out["main"] = _lm_tp_train(axes, device,
                               cfg.replace(num_layers=LM_TP_LAYERS), args,
                               LM_STEPS)
    return out


def _plan_pilots(pool, device):
    """``launch/plan.py: plan`` at the CLI's defaults but
    ``PLAN_PILOT_STEPS`` and ``PLAN_TARGET``, its pilots on ``device``
    (``pool``'s ranks), under the launcher's ``obs_session`` with
    ``--trace-out PLAN_TRACE --metrics-out PLAN_METRICS``; returns the
    report and the pilots' ``IsoLossResult``."""
    from repro_torch.launch import plan as plan_cli
    from repro_torch.launch.obs import obs_session
    args = plan_cli.build_parser().parse_args(
        ["--pilot-steps", str(PLAN_PILOT_STEPS), "--target-loss",
         str(PLAN_TARGET), "--device", device, "--out", str(PLAN_REPORT),
         "--trace-out", str(PLAN_TRACE), "--metrics-out",
         str(PLAN_METRICS)])
    with obs_session(args.trace_out, args.metrics_out,
                     meta={"run": "chip_smoke.plan"}):
        iso = plan_cli.pilots(args, pool=pool)
        report = plan_cli.plan(args, iso=iso)
    return report, iso


def _plan_obs_held(iso, world):
    """Hold phase 21's ``--trace-out`` and ``--metrics-out``: pid 0 has
    the pass's ``plan/calibrate``, ``plan/enumerate`` and
    ``plan/pilots`` spans once (``plan/score`` is the ``--no-pilots``
    pass's, in the reference too) and a ``plan/pilot`` span a pilot, as
    has each of the ``world`` ranks' pids; ``plan_pilot_steps_total``
    sums the pilots' ``steps_run``."""
    from repro_torch.obs import load_trace
    doc = load_trace(str(PLAN_TRACE))
    want = {"plan/calibrate": 1, "plan/enumerate": 1, "plan/pilots": 1,
            "plan/pilot": len(iso.pilots)}
    got = dict(span_counts(doc, 0))
    check(got == want, f"plan (a): pid 0's spans {got}, want {want}")
    for pid in range(1, world):
        n = span_counts(doc, pid)["plan/pilot"]
        check(n == len(iso.pilots), f"plan (a): rank {pid}'s plan/pilot "
                                    f"spans {n}, want {len(iso.pilots)}")
    steps = 0.0
    for line in PLAN_METRICS.read_text().splitlines():
        if line.startswith("plan_pilot_steps_total{"):
            steps += float(line.rsplit(" ", 1)[1])
    want_steps = sum(p.steps_run for p in iso.pilots)
    check(steps == want_steps, f"plan (a): plan_pilot_steps_total "
                               f"{steps}, the pilots ran {want_steps}")
    out = {"spans": got, "pilot_steps_total": steps,
           "pilot_span_s": [e["dur"] * 1e-6 for e in doc["traceEvents"]
                            if e["ph"] == "X" and e["pid"] == 0
                            and e["name"] == "plan/pilot"],
           "trace_bytes": PLAN_TRACE.stat().st_size}
    print(f"plan (a): trace {PLAN_TRACE} ({out['trace_bytes']:,} B): pid "
          f"0's spans {got}, plan/pilot on each of {world} pids (held); "
          f"plan_pilot_steps_total {steps:.0f} (held); each pilot's span "
          f"s {[round(v, 2) for v in out['pilot_span_s']]}", flush=True)
    return out


def phase_plan(pool=None, device="cuda"):
    """Phase 21: the planner (``launch/plan.py``) on the card, then its
    winner applied through ``launch/train.py: _apply_plan`` to
    phi3-mini.  (a) The plan: the pilots on ``pool`` (4 ranks sharing
    the card); held: the report's schema, every pilot its budget with
    finite, falling losses, a phantom curve, matched plans, a frontier
    and a winner.  (b) The winner's measured peak, the largest rank's
    (``measured_hbm_bytes``, here from ``hbm_readings`` for each rank's
    breakdown), held above 0 and below 80 GB, printed beside its
    estimate.  (c) The winner applied with ``--kernel-backend auto`` on
    its own mesh: held, the applied mesh and projection map are the
    winner's, the four kernels at that path's per-rank shapes in bf16
    match their plain versions (timed), step 1 through the kernels
    matches plain torch (phase 9's tolerances), every kernel launched as
    the layers imply, the losses finite."""
    import statistics as st
    import torch
    from repro_torch.configs.base import (PHANTOM_KINDS, ProjectionMap,
                                          ProjectionSpec)
    from repro_torch.launch.mesh import RankPool
    from repro_torch.launch.train import build_parser, train_config
    from repro_torch.planner import (PLAN_SCHEMA, PlanCandidate,
                                     hbm_readings, load_plan_report)
    _free()
    PLAN_REPORT.unlink(missing_ok=True)
    t0 = time.perf_counter()
    report, iso = _plan_pilots(pool, device)
    plan_s = time.perf_counter() - t0
    obs = _plan_obs_held(iso, report["iso_loss"]["pilot_tp"])
    check(load_plan_report(str(PLAN_REPORT))["schema"] == PLAN_SCHEMA
          == report["schema"], f"plan (a): schema {report['schema']}")
    for p in iso.pilots:
        check(p.steps_run == PLAN_PILOT_STEPS
              and all(math.isfinite(v) for v in p.losses)
              and p.losses[-1] < p.losses[0],
              f"plan (a): pilot {p.name} ran {p.steps_run} of "
              f"{PLAN_PILOT_STEPS} steps, losses not finite and falling: "
              f"{p.losses[0]} -> {p.losses[-1]}")
        print(f"plan (a): pilot {p.name}: nu {p.iters_to_target}, final "
              f"loss {p.final_loss!r}, first {p.losses[0]!r}, median step "
              f"{p.wall_us_median / 1e3:.3f} ms (rank 0, CUDA events)",
              flush=True)
    curve = report["iso_loss"]["curves"].get("phantom")
    check(curve is not None, "plan (a): no phantom curve was fitted")
    comp = report["comparison"]
    check(comp["matched_plans"] > 0, f"plan (a): no matched plan: {comp}")
    check(report["frontier"] and report["winner"],
          f"plan (a): frontier {len(report['frontier'])}, winner "
          f"{report['winner']}")
    w = report["winner"]
    wp = w["plan"]
    print(f"plan (a): curve loss(k) = exp({curve['a']!r}) * "
          f"k^{curve['b']!r} over k {curve['ks']}; comparison {comp}",
          flush=True)
    print(f"plan (a): frontier {[s['plan']['name'] for s in report['frontier']]}"
          f"; winner {wp['name']} ({wp['devices']} devices, "
          f"{w['energy_j_total']!r} J to target, step "
          f"{w['step_time_s']!r} s); the plan took {plan_s:.1f} s",
          flush=True)

    spec = wp["projection_spec"]
    plan = PlanCandidate(dp=wp["dp"], tp=wp["tp"], pp=wp["pp"],
                         strategy=wp["strategy"], width=wp["width"],
                         depth=wp["depth"], batch=wp["batch"], k=wp["k"],
                         site=wp["site"], microbatches=wp["microbatches"],
                         variant=spec["variant"])
    world = plan.devices
    own = (None if pool is not None and pool.world == world
           else RankPool(plan.dp, plan.tp, device, pp=plan.pp,
                         timeout_s=POOL_TIMEOUT_S))
    ranks_pool = own or pool
    try:
        t1 = time.perf_counter()
        readings = hbm_readings(plan, device, pool=ranks_pool)
        hbm_s = time.perf_counter() - t1
        hbm = None if readings is None else max(r["peak"] for r in readings)
        check(hbm is not None and 0 < hbm < HBM_LIMIT,
              f"plan (b): measured HBM {hbm} B of {wp['name']}")
        print(f"plan (b): {wp['name']}: measured peak {hbm:,} B (the "
              f"largest rank's max_memory_allocated over one train step, "
              f"from what the rank held on entry), estimate "
              f"{w['hbm_bytes_per_device']!r} B, ratio "
              f"{hbm / w['hbm_bytes_per_device']:.3f}; each rank's bytes "
              f"after one small matmul (library), after the draw of "
              f"parameters and AdamW state (state), the step's peak and "
              f"after it (retained): {readings}; {hbm_s:.1f} s", flush=True)

        args = build_parser().parse_args(
            ["--arch", LM_ARCH, "--full", "--kernel-backend", "auto",
             "--batch", str(LM_BATCH), "--seq", str(LM_SEQ), "--seed",
             str(SEED), "--steps", str(LM_STEPS), "--dp", "2", "--tp", "4",
             "--plan", str(PLAN_REPORT)])
        cfg = train_config(args)
        mesh = (args.dp, args.tp, args.pp)
        check(mesh == (plan.dp, plan.tp, plan.pp),
              f"plan (c): applied mesh {mesh}, winner's "
              f"{(plan.dp, plan.tp, plan.pp)}")
        want_spec = (ProjectionSpec(kind=spec["kind"], k=spec["k"],
                                    variant=spec["variant"],
                                    kernel_backend="auto")
                     if spec["kind"] in PHANTOM_KINDS
                     else ProjectionSpec(kind="tensor",
                                         kernel_backend="auto"))
        check(cfg.projections == ProjectionMap(default=want_spec),
              f"plan (c): applied map {cfg.projections}, want "
              f"{want_spec} as its default and nothing else")
        flash_shape, phantom_shapes = _plan_shapes(cfg, plan)
        kernels = _timed_kernels(
            "plan (c)", torch.Generator(device="cuda").manual_seed(SEED),
            (flash_shape,), phantom_shapes)
        t1 = time.perf_counter()
        ranks = ranks_pool.run(_plan_rank, plan.dp, plan.tp, (cfg, args),
                               pp=plan.pp, timeout_s=900)
        ranks_s = time.perf_counter() - t1
    finally:
        if own is not None:
            own.close()
    want_a = {"kernel": _plan_launches(cfg, LM_PARITY_LAYERS),
              "plain": {k: 0 for k in _plan_launches(cfg, 0)}}
    want = _plan_launches(cfg, LM_TP_LAYERS)
    worst = {}
    for r in ranks:
        rk = r["rank"]
        for part in ("loss", "grads", "params"):
            diff = r["kernel_vs_plain"][part]
            check(diff["outside"] == 0,
                  f"plan (c) rank {rk}: step 1 {part} differ in "
                  f"{diff['outside']} of {diff['elements']} elements: {diff}")
            for k, v in diff.items():
                worst.setdefault(part, {})[k] = max(
                    worst.get(part, {}).get(k, 0), v)
        check(r["kernel_vs_plain"]["grads"]["max_scaled_err"]
              <= STEP1_TOL["rtol"],
              f"plan (c) rank {rk}: gradients differ by more than 1e-4 of "
              f"the largest: {r['kernel_vs_plain']['grads']}")
        check(r["kernel_vs_plain"]["launches"] == want_a,
              f"plan (c) rank {rk}: step-1 launches "
              f"{r['kernel_vs_plain']['launches']}, want {want_a}")
        check(r["main"]["launches_per_step"] == want,
              f"plan (c) rank {rk}: launches per step "
              f"{r['main']['launches_per_step']}, want {want}")
        check(all(math.isfinite(v) for v in r["main"]["losses"]
                  + r["main"]["grad_norms"]),
              f"plan (c) rank {rk}: non-finite loss or gradient norm: "
              f"{r['main']['losses']} {r['main']['grad_norms']}")
    main = [r["main"] for r in ranks]
    med = [st.median(m["step_ms"][1:]) for m in main]
    print(f"plan (c): {cfg.name} under {wp['name']}'s map "
          f"({want_spec.kind}, k {want_spec.k}) at dp {plan.dp} x tp "
          f"{plan.tp} x pp {plan.pp}: step 1 at {LM_PARITY_LAYERS} layers, "
          f"float32, kernels vs plain, worst over ranks (held to rtol 1e-4 "
          f"/ atol 1e-5): loss {worst['loss']['max_abs_err']:.3e} (values "
          f"{ranks[0]['kernel_vs_plain']['loss_values']}), grads "
          f"{worst['grads']['max_abs_err']:.3e} "
          f"({worst['grads']['max_scaled_err']:.3e} of the largest), "
          f"params {worst['params']['max_abs_err']:.3e}", flush=True)
    print(f"plan (c): main path, {LM_TP_LAYERS} layers, batch {LM_BATCH} x "
          f"seq {LM_SEQ}, bf16, {LM_STEPS} steps: losses "
          f"{[round(v, 4) for v in main[0]['losses']]}; per-rank step ms "
          f"{[round(m, 2) for m in med]} (median of steps 2-{LM_STEPS}); "
          f"launches per step per rank {main[0]['launches_per_step']} (held "
          f"to {want}); wire bytes per step per rank "
          f"{[round(m['wire_bytes_per_step']) for m in main]}; peak memory "
          f"per rank (GB) {[round(m['peak_memory_gb'], 2) for m in main]}; "
          f"the ranks took {ranks_s:.1f} s", flush=True)
    return {"report": {k: report[k] for k in ("iso_loss", "comparison",
                                               "winner", "counts")},
            "frontier": [s["plan"]["name"] for s in report["frontier"]],
            "pilots": [dict(p.as_dict(), losses=p.losses)
                       for p in iso.pilots],
            "plan_s": plan_s, "obs": obs,
            "hbm": {"measured": hbm, "ranks": readings,
                                      "estimate": w["hbm_bytes_per_device"]},
            "mesh": list(mesh), "launches_per_step": main[0][
                "launches_per_step"],
            "step1_launches": {k: max(r["kernel_vs_plain"]["launches"][
                "kernel"][k] for r in ranks) for k in want},
            "flash_shape": flash_shape, "kernels": kernels,
            "worst": worst, "median_step_ms": med,
            "losses": main[0]["losses"], "ranks_s": ranks_s}


def _plan_entry(plan, name):
    """A kernel on phase 21's main path (the applied winner): its
    launches per step and per rank, the most on a rank in its step-1
    check, and its timed cases at that path's shapes."""
    k = plan["kernels"]
    if name == "flash_attention":
        shapes = [{"shape": list(plan["flash_shape"]),
                   **{key: r[key] for key in TIMED + ("cold_ms",)}}
                  for r in k["flash"]]
    else:
        shapes = [{"shape": [r["M"], r["K"], r["N"], r["PK"]],
                   **{key: r[key] for key in PHANTOM_TIMED},
                   "cold_ms": k["cold"][str([r["M"], r["K"], r["N"],
                                             r["PK"]])][name]["cold_ms"]}
                  for r in k["cases"] if r["kernel"] == name]
    return {"mesh": plan["mesh"],
            "launches_per_step_per_rank": plan["launches_per_step"][name],
            "step1_launches_per_rank": plan["step1_launches"][name],
            "shapes": shapes}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        print(f"phase {name}: {walls[name]:.1f} s wall", flush=True)
        return out
    t_start = time.perf_counter()
    device = timed("device", phase_device)
    flash = timed("kernels", phase_kernels)
    phantom = timed("phantom_kernels", phase_phantom_kernels)
    serve = timed("serve", phase_serve)
    train = timed("train", phase_train)
    ledger = timed("energy", phase_energy, train, device["nvidia_smi"])
    pipeline = timed("pipeline", phase_pipeline, train, ledger)
    lm = timed("lm_train", phase_lm_train)
    # one world of 4 ranks runs every 4-rank phase in turn, each freeing
    # its card memory before the next: a rank starts in about 10 s
    from repro_torch.launch.mesh import RankPool
    with RankPool(1, LM_TP, "cuda", timeout_s=POOL_TIMEOUT_S) as pool:
        lm_tp = timed("lm_train_tp", phase_lm_train_tp, pool)
        qwen = timed("qwen_train_tp", phase_qwen_train_tp, pool)
        lm_pp = timed("lm_train_pp", phase_lm_train_pp, pool)
        moe = timed("moe", phase_moe, pool)
        ssm = timed("ssm_fsdp", phase_ssm_fsdp, pool)
        hybrid = timed("hybrid", phase_hybrid, pool)
        vlm = timed("vlm", phase_vlm, pool)
        encdec = timed("encdec", phase_encdec, pool)
        serve_mesh = timed("serve_mesh", phase_serve_mesh, pool)
        family_mesh = timed("family_mesh", phase_family_mesh, pool)
        fleet = timed("fleet", phase_fleet, "cuda", None, pool)
        elastic = timed("elastic", phase_elastic)
        plan = timed("plan", phase_plan, pool)
    print(f"phases: {time.perf_counter() - t_start:.1f} s wall in all",
          flush=True)
    path = ledger.write_report(ROOT / "build" / "chip_smoke_ledger.json")
    print(f"ledger written to {path}")
    ledger = ledger.report()

    sweep = flash["sweep"]
    at = {S: next(r for r in sweep if all(
        r[k] == v for k, v in {**MAIN_SHAPE, "S": S}.items()))
        for S in (48, 512)}
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96",
        "launches": serve["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in sweep),
        **{key: at[48][key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
        "cold_ms": flash["cold"][48]["cold_ms"],
        "s512": {**{key: at[512][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "cold_ms": flash["cold"][512]["cold_ms"]},
        "train_launches": lm["launches"],
        "hd96": {**{key: lm["flash"]["sweep"][0][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")}, "cold_ms": lm["flash"]["cold"]["cold_ms"]},
        "lm_tp4": {"shape": list(LM_TP_FLASH_SHAPE),
                   "launches_per_step_per_rank":
                       lm_tp["launches_per_step"]["flash_attention"],
                   "resumed_step_launches_per_rank": lm_tp["checkpoint"][
                       "resumed_launches"]["flash_attention"],
                   "captured_step_launches_rank0": lm_tp["obs"][
                       "captures"][0]["kernels"]["flash_attention"],
                   **{key: lm_tp["kernels"]["flash"][key] for key in TIMED}},
        "qwen_tp4": {"launches_per_step_per_rank":
                     qwen["launches_per_step"]["flash_attention"]},
        "lm_pp": {"shape": list(LM_PP_FLASH_SHAPE),
                  "launches_per_step_per_rank":
                      lm_pp["launches_per_step"]["flash_attention"],
                  **{key: lm_pp["kernels"]["flash"][0][key]
                     for key in TIMED + ("cold_ms",)}},
        "moe_serve": {"shape": list(MOE_SERVE_FLASH_SHAPE),
                      "launches": moe["serve"]["launches"],
                      **{key: moe["kernels"]["flash"][0][key]
                         for key in TIMED + ("cold_ms",)}},
        "moe_tp4": {"shape": list(MOE_TP_FLASH_SHAPE),
                    "launches_per_step_per_rank":
                        moe["launches_per_step"]["flash_attention"],
                    **{key: moe["kernels"]["flash"][1][key]
                       for key in TIMED + ("cold_ms",)}},
        "ssm_tp4": {"launches_per_step_per_rank":
                    ssm["launches_per_step"]["flash_attention"]},
        "fsdp_dp2_tp2": {"shape": list(FSDP_FLASH_SHAPE),
                         "launches_per_step_per_rank":
                             ssm["fsdp_launches_per_step"]["flash_attention"],
                         **{key: ssm["kernels"]["flash"][0][key]
                            for key in TIMED + ("cold_ms",)}},
        "jamba_serve": {"shape": list(JAMBA_SERVE_FLASH_SHAPE),
                        "launches": hybrid["serve"]["launches"],
                        **{key: hybrid["kernels"]["flash"][0][key]
                           for key in TIMED + ("cold_ms",)}},
        "jamba_tp4": {"shape": list(JAMBA_TP_FLASH_SHAPE),
                      "launches_per_step_per_rank":
                          hybrid["launches_per_step"]["flash_attention"],
                      **{key: hybrid["kernels"]["flash"][1][key]
                         for key in TIMED + ("cold_ms",)}},
        "qwen2vl_serve": {"shape": list(QWEN2VL_SERVE_FLASH_SHAPE),
                          "launches": vlm["serve"]["launches"],
                          **{key: vlm["kernels"]["flash"][0][key]
                             for key in TIMED + ("cold_ms",)}},
        "qwen2vl_tp4": {"shape": list(QWEN2VL_TP_FLASH_SHAPE),
                        "launches_per_step_per_rank":
                            vlm["launches_per_step"]["flash_attention"],
                        **{key: vlm["kernels"]["flash"][1][key]
                           for key in TIMED + ("cold_ms",)}},
        "seamless_serve": {"launches": encdec["serve"]["launches"],
                           "shapes": [
                               {"shape": list(shape), **{
                                   key: r[key] for key in TIMED
                                   + ("cold_ms",)}}
                               for shape, r in zip(
                                   SEAMLESS_FLASH_SHAPES[:2],
                                   encdec["kernels"]["flash"][:2])]},
        "seamless_tp4": {"launches_per_step_per_rank":
                         encdec["launches_per_step"]["flash_attention"],
                         "shapes": [
                             {"shape": list(shape), **{
                                 key: r[key] for key in TIMED
                                 + ("cold_ms",)}}
                             for shape, r in zip(
                                 SEAMLESS_FLASH_SHAPES[2:],
                                 encdec["kernels"]["flash"][2:])]},
        "serve_mesh": {"launches": serve_mesh["launches"]["flash_attention"],
                       "shapes": [
                           {"shape": list(shape), **{
                               key: r[key] for key in TIMED + ("cold_ms",)}}
                           for shape, r in zip(
                               SERVE_MESH_FLASH_SHAPES,
                               serve_mesh["kernels"]["flash"])]},
        "family_mesh": {
            "launches": family_mesh["launches"]["flash_attention"],
            "shapes": [{"shape": list(shape), **{
                key: r[key] for key in TIMED + ("cold_ms",)}}
                for shape, r in zip(FAMILY_MESH_FLASH_SHAPES,
                                    family_mesh["kernels"]["flash"])]},
        "fleet": {"one_card_launches": fleet["one_card"]["runs"][0][
                      "launches"]["flash_attention"],
                  "tp4_launches_per_rank": fleet["mesh"]["runs"][0][
                      "launches"]["flash_attention"]},
        "plan": _plan_entry(plan, "flash_attention")}]
    lines = {"phantom_fused_matmul": 118, "matmul_nt": 206, "matmul_tn": 239}
    for name, line in lines.items():
        cases = [r for r in phantom["sweep"] if r["kernel"] == name]
        main_r, pipe_r = (next(
            r for r in cases if r["dtype"] == "float32" and
            (r["M"], r["K"], r["N"], r["PK"]) == shape)
            for shape in (PHANTOM_MAIN, PHANTOM_PIPE))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/phantom_fused.cu",
            "replaces": f"src/repro/kernels/phantom_fused.py:{line}",
            "launches": train["ranks"][0]["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": main_r["ms"], "plain_ms": main_r["plain_ms"],
            "bound_ms": main_r["bound_ms"], "bound_by": main_r["bound_by"],
            "library_ms": main_r["library_ms"],
            "cold_ms": phantom["cold"][name]["cold_ms"],
            "pipe_rows8": {
                "shape": list(PHANTOM_PIPE),
                "launches": pipeline["launches"][name],
                **{key: pipe_r[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}},
            "plan": _plan_entry(plan, name),
            # the bf16 route: the tensor-core kernel and its HGMMA count
            "bf16_kernel": {"cuda_name": WGMMA_OF[name],
                            "hgmma_sass": device["phantom_hgmma"][
                                WGMMA_OF[name]]},
            "lm_tp4": {
                "launches_per_step_per_rank":
                    lm_tp["launches_per_step"][name],
                "resumed_step_launches_per_rank":
                    lm_tp["checkpoint"]["resumed_launches"][name],
                # the watchdog's torch.profiler capture of a step, by the
                # bf16 route's CUDA name
                "captured_step_launches_rank0": lm_tp["obs"]["captures"][0][
                    "kernels"][{"phantom_fused_matmul": "wgmma_fwd",
                                "matmul_nt": "wgmma_dgrad",
                                "matmul_tn": "wgmma_wgrad"}[name]],
                "shapes": [{"shape": [r["M"], r["K"], r["N"], r["PK"]],
                            **{key: r[key] for key in PHANTOM_TIMED}}
                           for r in lm_tp["kernels"]["phantom"]
                           if r["kernel"] == name]},
            "qwen_tp4": {
                "launches_per_step_per_rank":
                    qwen["launches_per_step"][name],
                "shapes": [{"shape": [r["M"], r["K"], r["N"], r["PK"]],
                            **{key: r[key] for key in PHANTOM_TIMED},
                            "cold_ms": qwen["kernels"]["cold"][str(
                                [r["M"], r["K"], r["N"], r["PK"]])][name][
                                "cold_ms"]}
                           for r in qwen["kernels"]["cases"]
                           if r["kernel"] == name]},
            "lm_pp": {
                "launches_per_step_per_rank":
                    lm_pp["launches_per_step"][name],
                "shapes": [{"shape": [r["M"], r["K"], r["N"], r["PK"]],
                            **{key: r[key] for key in PHANTOM_TIMED},
                            "cold_ms": lm_pp["kernels"]["cold"][str(
                                [r["M"], r["K"], r["N"], r["PK"]])][name][
                                "cold_ms"]}
                           for r in lm_pp["kernels"]["cases"]
                           if r["kernel"] == name]},
            "moe_tp4": {
                "launches_per_step_per_rank":
                    moe["launches_per_step"][name],
                "shapes": [{"shape": [r["M"], r["K"], r["N"], r["PK"]],
                            **{key: r[key] for key in PHANTOM_TIMED},
                            "cold_ms": moe["kernels"]["cold"][str(
                                [r["M"], r["K"], r["N"], r["PK"]])][name][
                                "cold_ms"]}
                           for r in moe["kernels"]["cases"]
                           if r["kernel"] == name]},
            **{tag: {
                "launches_per_step_per_rank": ssm[lkey][name],
                "shapes": [{"shape": [r["M"], r["K"], r["N"], r["PK"]],
                            **{key: r[key] for key in PHANTOM_TIMED},
                            "cold_ms": ssm["kernels"]["cold"][str(
                                [r["M"], r["K"], r["N"], r["PK"]])][name][
                                "cold_ms"]}
                           for r in ssm["kernels"]["cases"]
                           if r["kernel"] == name
                           and (r["M"], r["K"], r["N"], r["PK"]) in shapes]}
               for tag, lkey, shapes in (
                   ("ssm_tp4", "launches_per_step", MAMBA_PHANTOM_SHAPES),
                   ("fsdp_dp2_tp2", "fsdp_launches_per_step",
                    FSDP_PHANTOM_SHAPES))},
            **{tag: {
                "launches_per_step_per_rank":
                    res["launches_per_step"][name],
                "shapes": [{"shape": [r["M"], r["K"], r["N"], r["PK"]],
                            **{key: r[key] for key in PHANTOM_TIMED},
                            "cold_ms": res["kernels"]["cold"][str(
                                [r["M"], r["K"], r["N"], r["PK"]])][name][
                                "cold_ms"]}
                           for r in res["kernels"]["cases"]
                           if r["kernel"] == name]}
               for tag, res in (("jamba_tp4", hybrid), ("qwen2vl_tp4", vlm),
                                ("seamless_tp4", encdec))},
            **({"serve_mesh": {
                "launches": serve_mesh["launches"][name],
                "shapes": [{"shape": [r["M"], r["K"], r["N"], r["PK"]],
                            **{key: r[key] for key in PHANTOM_TIMED},
                            "cold_ms": serve_mesh["kernels"]["cold"][str(
                                [r["M"], r["K"], r["N"], r["PK"]])][name][
                                "cold_ms"]}
                           for r in serve_mesh["kernels"]["cases"]
                           if r["kernel"] == name]},
                "family_mesh": {
                "launches": family_mesh["launches"][name],
                "shapes": [{"shape": [r["M"], r["K"], r["N"], r["PK"]],
                            **{key: r[key] for key in PHANTOM_TIMED},
                            "cold_ms": family_mesh["kernels"]["cold"][str(
                                [r["M"], r["K"], r["N"], r["PK"]])][name][
                                "cold_ms"]}
                           for r in family_mesh["kernels"]["cases"]
                           if r["kernel"] == name]},
                "fleet": {"tp4_launches_per_rank": fleet["mesh"]["runs"][0][
                    "launches"][name]}}
               if name == "phantom_fused_matmul" else {})})
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"device": device, "flash": flash, "phantom": phantom,
         "serve": serve, "train": train, "pipeline": pipeline,
         "lm_train": lm, "lm_train_tp": lm_tp, "qwen_train_tp": qwen,
         "lm_train_pp": lm_pp, "moe": moe, "ssm_fsdp": ssm,
         "hybrid": hybrid, "vlm": vlm, "encdec": encdec,
         "serve_mesh": serve_mesh, "family_mesh": family_mesh,
         "fleet": fleet, "elastic": elastic, "plan": plan,
         "phase_wall_s": walls,
         "ledger": ledger,
         "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
