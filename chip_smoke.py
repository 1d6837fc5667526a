#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's thirteen paths: synchronous PPO,
asynchronous A3C over the MCC experience ring, the paged serving engine at
internlm2-1.8b's, xlstm-1.3b's and stablelm-12b's full width, multi-GMI
synchronous PPO (several GMIs on one card, one CUDA stream each), async
A3C under the fleet supervisor (faults, checkpoints) and the online GMI
controller, disaggregated prefill/decode serving over GMIs with cache
migration, under the same supervisor and controller, PPO over the
multi-agent env family, serving the mixture-of-experts family at
granite-moe-1b-a400m's and Mamba2/zamba2 at zamba2-7b's full width, LM
training (``launch/train.py --workload lm``) at internlm2-1.8b's and
hubert-xlarge's full width and depth with gradients through the attention
and mLSTM kernels' autograd Functions, and serving pixtral-12b's patch
embeddings ahead of its text at full width.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (PATH or /usr/local/cuda/bin).  Phases,
each asserting, in order:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (all sources in
   parallel) and print the build time, nvcc's register/spill report and
   the card's name and power limit; for the tensor-core kernels (the env
   step, whose observation runs in 3xTF32, the bf16 flash kernel, the
   policy trunk and the mLSTM kernel's three 3xTF32 launches) count the
   tensor-core instructions
   (``HGMMA``/``HMMA``) in ``cuobjdump -sass`` of the built library, and
   assert that each has some and that nvcc reports no spills;
2. hold each of the eight kernels against its plain PyTorch version on the
   card at its path's shapes (ShadowHand, N = 16384, a share of envs
   forced to reset; the env megakernel without and with ring writes; GAE
   and the n-step scan at T = 16, N = 16384; the trunk at 16384 x 211 ->
   256; the env megakernel in both ring modes, the trunk, GAE and the
   n-step scan also at a GMI's share of phase 12's envs, N = 4096 and
   8192 (the n-step scan also at any other trainer batch shape of phase
   12b (b) and (c), there); the ring pack of one A3C push, T = 16,
   N = 8192, slot 1 of 2, the
   other slot a sentinel, bit-exact; paged decode attention in bf16 at
   internlm2-1.8b's decode shape, B = 8, 16 q heads on 8 kv heads, hd
   128, 8-token pages, 1024 positions, and at phase 11's, B = 4, 32 q
   heads on 8 kv heads, hd 160, positions 543 and 159 (8 splits, as in
   the run); flash attention in bf16 at the prefill shapes of phase 8, at
   the launcher's eight 512-token prompts, at phase 14's prefill GMI's
   whole-prompt B = 1 x 896 and at phase 11's two
   dispatches, 2 x 512 and 2 x 128 at stablelm-12b's heads; both
   attention kernels at phase 16's shapes (granite-moe-1b-a400m, 16 q on
   8 kv heads, hd 64: paged decode B = 8, flash 4 x 512 and 4 x 128) and
   at phase 17's (zamba2-7b, 32 q on 32 kv heads, hd 112: paged decode
   B = 4, flash 2 x 512 and 2 x 256); the trunk also at phase 15's Ant
   widths, N = 16384; paged decode
   calls queued back to back at B = 8, 1 and 4 (4, 32 and 8 splits) and
   two at once on two streams; chunkwise mLSTM at phase 10's shapes,
   B = 4, 4 heads, S = 512, dh 512, chunk 256 from a zero state, and
   B = 1, S = 256 from a non-zero state, h and the final (C, n, m) each within
   1e-4 of the plain output's largest magnitude) and at ragged shapes
   (every Table-6 env and trunk width, GAE and the n-step scan at T = 5,
   GAE also at T = 40, where the advantages are re-read, and over 300,000
   columns, grid-strided, each GAE call bit-identical to a second one,
   the pack at N = 999 with a version tensor; both attention kernels in
   f32 at hd 64 with 16-token pages, unmapped pages, idle rows, a window
   and a softcap, flash also in bf16 at those ragged shapes and, in f32
   and bf16, causal at S = 200 with window 37, where later blocks skip
   whole key tiles below the window; both attention kernels at the head
   dims 80 (G 1), 112 (G 2) and 160 (G 4), in f32 and bf16 under the
   same gates: flash causal, bidirectional with a window and softcap, and
   causal at S = 200 with window 37, paged decode with unmapped pages,
   empty slots and idle rows; mLSTM at dh 64, chunk 16, S = 48 and S = 1
   from a non-zero state with strongly negative log_f and large log_i;
   flash at hubert-xlarge's B = 4 x 512, 16 on 16 heads, hd 80,
   bidirectional, in bf16 and f32); and the autograd Functions that
   carry both training kernels' gradients (C12), in f32: the forward the
   kernel, every input's gradient against autograd of the plain version
   within 1e-4 of the leaf's largest magnitude (flash causal at 16 q on 8
   kv heads, hd 128, and bidirectional at hd 80 with and without a
   window and softcap; mLSTM from a non-zero state through h and the
   final state);
3. check one small fused PPO iteration on the card against the plain
   PyTorch path on the CPU from the same params, state, noise and
   permutations;
4. check two small A3C rounds on the card against the CPU path, on both
   branches of ``AsyncRunner.round`` (direct produce into the ring, and
   collect + ring pack), from the same params, state and noise;
5. drive the PPO path: ``make_env("ShadowHand", megakernel=True)`` and
   ``PPOConfig(num_steps=16, use_fused_kernels=True)`` at N = 16384 for
   3 iterations, with the launch counters set to 0 just before and read
   just after;
6. drive the A3C path: ShadowHand, 2 serving GMIs of N = 8192 envs and 1
   trainer GMI on one 2-slot ring, T = 16, ``use_fused_kernels=True``, 3
   rounds on each branch (``megakernel=True`` produces into the ring,
   ``megakernel=False`` pushes through the ring pack), each with the
   launch counters set to 0 just before and read just after;
7. check a small f32 serving engine (reduced internlm2-1.8b, both
   kernels, chunked prefill, shared heads with copy-on-write) on the card
   against the same engine on the CPU: identical greedy tokens;
8. drive the serving path: a paged ``ServeEngine`` over
   internlm2-1.8b at full width in bf16 (random weights from seed 0),
   8 slots, ``max_seq`` 1024, ``chunk_prefill`` 256, serving four
   512-token prompts sharing a 256-token head, three 128-token prompts
   and one 896-token prompt, 64 greedy tokens each, with the launch
   counters set to 0 just before and read just after; it asserts one
   paged-decode launch per layer per decode step and one flash launch per
   layer per whole-prompt prefill dispatch, prints prefill and decode
   tok/s, and how many tokens of two requests match ``oracle_generate``
   (bf16 GEMMs at B = 1 and B = 8 round differently, so this is printed,
   not asserted);
9. check a small f32 xlstm engine (reduced xlstm-1.3b: one mLSTM and one
   sLSTM block, d = 256, dh 64, chunked prefill, slots reused) on the
   card against the same engine on the CPU: identical greedy tokens;
10. drive the xlstm serving path: a paged ``ServeEngine`` over
   xlstm-1.3b at full width in bf16 (random weights from seed 0), 8
   slots, ``max_seq`` 1024, ``chunk_prefill`` 512, serving four 512-token
   prompts (one B = 4 prefill dispatch, two mLSTM chunks inside each
   launch), three 128-token prompts (one B = 3 dispatch) and one
   768-token prompt (a 512 chunk, then a 256 chunk from the carried
   state), 64 greedy tokens each, with the launch counters set to 0 just
   before and read just after; it asserts exactly 42 mLSTM launches (one
   a mLSTM block) per prefill dispatch and per chunk and none in decode
   steps, and prints prefill and decode tok/s, peak device memory and
   the ``oracle_generate`` match count of two requests;
11. drive stablelm-12b serving (hd 160 through both attention kernels): a
   paged ``ServeEngine`` at full width in bf16 (d 5120, 32 q heads on 8
   kv heads, random weights from seed 0), the depth cut to 8 of its 40
   layers to keep the phase short, 4 slots, ``max_seq`` 1024, whole-prompt
   prefill, serving two 512-token and two 128-token prompts, 32 greedy
   tokens each, with the launch counters set to 0 just before and read
   just after; it asserts one paged-decode launch per layer per decode
   step and one flash launch per layer per whole-prompt dispatch, and
   prints prefill and decode tok/s and the ``oracle_generate`` match
   count of two requests (printed, not asserted, as in phase 8);
12. drive multi-GMI synchronous PPO at full width (ShadowHand, N = 16384
   envs in total, T = 16, fused kernels): print the TCG_EX layouts at
   (num_gpus, gmi_per_gpu) = (1, 4) and (2, 2) with the launcher's
   logical ids and Algorithm 1's strategy for each; hold
   ``Communicator.allreduce`` of the ShadowHand policy's gradient tree
   stacked over instance grids (1, 4), (2, 2) and (2, 2, 2), for every
   candidate strategy, against the host-staged ``reduce_host`` within
   1e-6 of each leaf's largest magnitude, and print each one's time;
   run ``launch/train.py``'s ``run_drl`` at 1 x 4 GMIs for 3 iterations
   with every GMI on its own CUDA stream, with the launch counters set
   to 0 just before and read just after (env step 4 x 16 x 3, trunk
   4 x 17 x 3, GAE 4 x 3, nothing else), and again with every GMI on the
   default stream in turn: params within 1e-6, the same launches; print
   env steps/s for 1 x 16384, 2 x 8192 and 4 x 4096 GMIs on streams and
   4 x 4096 in turn (same total envs and iterations; printed, not
   asserted); run Algorithm 2 (``explore`` over
   the port's PPO profiler, GMIperGPU 4, 2, 1, num_env 4096 and 16384)
   and print its trace and best config; launch the cooperative GAE kernel
   while another stream runs a GEMM chain (it must succeed and agree with
   its plain version; when it finished is printed);
12b. drive async A3C under the fleet supervisor and the online
   controller, the fault plan ``FLEET_EVENTS`` (a serving GMI killed,
   a flush dropped, a save crashed before its manifest, a trainer GMI
   killed, a flush poisoned, a finished pair torn; probation 2, a
   checkpoint every 2 rounds, 6 rounds): (a) ``make_fleet_supervisor``
   over ``plan_async(3, 2, 2)`` on logical GPUs, Ant, 8 envs a GMI,
   T = 4, the push branch, on the card against the CPU with the same
   noise: failures, recoveries, quarantines, checkpoint steps and
   counters equal, params within 1e-5; (b) the same plan at full width,
   ShadowHand, ``megakernel=True``, 4 serving GMIs x 4096 envs, T = 16:
   trained + poisoned == predicted, the poisoned batch's update
   discarded (the params the same tensors, bit-identical), ``restore``
   skipping the torn step 6 for step 2 bit for bit, and the round
   seconds supervised and unsupervised, checkpoint save and restore ms
   and MB, and the device memory that live tensors hold after
   ``finish`` (``live_cuda_bytes``) within 10% of the same fleet's with
   no faults (ring storage a dropped or requeued payload kept must not
   leak); (c) ``make_async_runner(..., overlap=True,
   online_controller=True)`` at the same width, ladder (4096, 8192),
   epochs of 2 rounds, 6 rounds: at least one probe re-plan (its ms
   printed), lossless, the device memory that live tensors hold after
   it within 10% of a run at 8192 with no re-plan; (a), (b) and (c)
   each with the launch counters set to 0 just before and read just
   after, exact (the env step a collected step on the direct branch, the
   ring pack a push on the push branch, the n-step scan a trained or
   discarded batch);
13. time each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events (flash at
   phase 8's B = 3 x 128 dispatch, at the launcher's B = 8 x 512, at
   phase 11's stablelm-12b B = 2 x 512, hd 160, and at phase 17's
   zamba2-7b B = 2 x 512, hd 112, and hubert-xlarge's bidirectional
   B = 4 x 512, hd 80, against bidirectional SDPA, in the row's
   ``shapes`` list; paged
   decode at phase 8's step and at phase 17's, B = 4, hd 112, in its
   ``shapes`` list), and the device time of every kernel (and of the library call,
   where there is one) under ``torch.profiler``, since small calls are
   host-bound, by launched kernel where a call launches more than one (a
   profile that sees no kernel is taken again, with a warning line); the
   trunk's and the mLSTM kernel's bounds are their three TF32 passes at
   the TF32 tensor-core peak, the env step's its projection's three TF32
   passes plus the rest on the fp32 pipe (printed beside the fp32-pipe
   figure); each row also carries the host time of one call on its own
   (``host_ms``: CPU wall time, no synchronise); print one
   ``{"kernels": [...]}`` line;
14. (run before 13's timings, so that its launches join the kernels line)
   drive disaggregated serving over GMIs (``make_disagg_front``: decode
   GMIs behind a ``RequestRouter``, prefill GMIs, the ``CacheChannel``,
   every GMI on its own CUDA stream from a ``GMIManager``): (a) a small f32
   front (reduced internlm2-1.8b, 2 decode GMIs x 4 slots, 1 prefill GMI,
   the planner pinned so that 40-token prompts migrate and 12-token ones
   stay local) on the card against the CPU: routes, payload bytes, head
   pages, ``prefix_pages_saved`` and greedy tokens equal; then
   ``make_fleet_supervisor(..., router=front)`` over a small A3C fleet
   with an ``engine_fail``, a ``prefill_fail`` and a ``channel_drop``:
   failure and recovery logs and tokens equal, every request completed;
   (b) internlm2-1.8b at full width in bf16, 2 decode GMIs x 8 slots and 1
   prefill GMI sharing one copy of the parameters, ``max_seq`` 1024,
   8-token pages, four 896-token prompts (two share a 512-token head) and
   four 64-token ones, 64 greedy tokens each, the planner pinned so that
   the 896s migrate and the 64s stay local, with the launch counters set to
   0 just before and read just after: one flash launch per layer per
   whole-prompt dispatch on whichever GMI ran it, one paged-decode launch
   per layer per decode step per engine, each payload's bytes its shipped
   pages x the page bytes, the shared head's 64 pages skipped, no request
   lost; it prints the pack ms and GB/s, TTFT by route, decode tok/s,
   peak device memory and the ``oracle_generate`` match count of a
   migrated and a local request (printed, as in phase 8), then runs the
   trace again through a planner priced by this run's measurements and
   prints its decisions; (c) ``make_async_runner(..., router=front,
   online_controller=True)`` over an A3C fleet with the small front,
   traffic outrunning its slots: at least one serving decision applied,
   every request completed, trained == predicted;
15. (also before 13) multi-agent PPO: (a) one fused iteration over the
   4-agent Ant (8 worlds, T = 4, one world at its episode cap) on the card
   against the CPU with the same noise and permutations: bookkeeping and
   the done fraction exact, params within 1e-5; (b) 16,384 agents (4,096
   worlds of 32 joints), T = 16, ``use_fused_kernels=True``, 3 iterations
   with the launch counters set to 0 just before and read just after:
   the trunk 17 times and GAE once an iteration, no env-step kernel (the
   family runs the plain step); env steps/s printed beside 16,384
   single-agent Ant envs on the plain step and on the env megakernel;
16. (also before 13) ``moe_apply`` in f32 on the card against the CPU with
   assignments dropped by capacity (slots exact, out 1e-5); then
   granite-moe-1b-a400m at full width in bf16 (24 layers, d 1024, 16 q
   on 8 kv heads, hd 64, 32 experts top-8, random weights from seed 0),
   8 slots, ``max_seq`` 1024, whole-prompt prefill, four 512-token and
   four 128-token prompts, 64 greedy tokens each, the launch counters
   set to 0 just before and read just after: one flash launch per layer
   per whole-prompt dispatch, one paged-decode launch per layer per
   decode step; it prints prefill and decode tok/s, peak device memory,
   the share of expert assignments dropped by capacity in the two
   prefill dispatches and the ``oracle_generate`` match count of two
   requests (printed, not asserted);
17. (also before 13) a small f32 hybrid engine (reduced zamba2, chunked
   at 16 tokens with a 48-token prompt, and whole-prompt) on the card
   against the CPU: greedy tokens and page tables identical, Mamba2
   states within 1e-4; then zamba2-7b at full width in bf16 (d 3584, 32
   heads on 32, hd 112, N 64, random weights from seed 0, ``Z_SUPER`` of
   its 9 super-blocks), 4 slots, ``max_seq`` 1024, whole-prompt prefill,
   two 512-token and two 256-token prompts, 32 greedy tokens each, the
   launch counters set to 0 just before and read just after: one flash
   launch per shared-attention application per whole-prompt dispatch at
   hd 112, one paged-decode launch per application per decode step; it
   prints tok/s, peak device memory and the ``oracle_generate`` match
   count of two requests;
18. (also before 13) LM training: (a) reduced internlm2-1.8b, xlstm-1.3b,
   hubert-xlarge and pixtral-12b in f32, ``loss_fn`` and its gradient on
   the card against the CPU from the same params and batch (loss 1e-5,
   every gradient leaf within 1e-4 of the CPU leaf's largest, so a leaf
   the kernels left without a gradient fails), and one
   ``make_train_step`` with two microbatches and remat (loss, Adam's
   first moment); (b) ``launch/train.py --workload lm --full`` at
   internlm2-1.8b (24 layers, f32 masters and Adam, bf16 compute, no
   remat), 4 x 512 tokens, 5 steps, and (c) the same at hubert-xlarge
   (48 layers, masked prediction over 512 frames), each with the launch
   counters set to 0 just before and read just after: one flash launch
   per layer per step and nothing else; each prints training tokens/s,
   step ms, the model-FLOP share of the bf16 peak (6 x params x tokens)
   and peak device memory;
19. (also before 13) a small f32 pixtral engine (8 patches ahead of the
   text, and a text-only request) on the card against the CPU: greedy
   tokens and page tables identical; then pixtral-12b at full width in
   bf16 (d 5120, 32 q on 8 kv heads, hd 128, depth cut to ``PLAYERS`` of
   40 layers), 4 slots, 256 patches + 256 text tokens a request, 32
   greedy tokens each, the launch counters set to 0 just before and read
   just after: one flash launch per layer per (one-request) whole-prompt
   dispatch, one paged-decode launch per layer per decode step; it
   prints prefill and decode tok/s and peak device memory.

Float32 matmuls run without TF32 (``allow_tf32 = False``) so the plain
versions are full fp32, as the kernels are.  The last line is the
``{"ok": true, "device": ...}`` contract line.  Without a CUDA card, or
without the repository's ``src/`` beside it, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import torch

ENV = "ShadowHand"
N_MAIN = 16384
T_MAIN = 16
N_RAGGED = 1000
N_A3C = 8192             # envs per serving GMI
N_PACK_RAGGED = 999      # s*N*211 not a multiple of 4: unaligned runs
# GAE columns beyond one a thread of every block an H100 holds at once
# (132 SMs x 16 blocks x 128 threads = 270,336): grid-stride columns
N_GAE_STRIDE = 300000
# the serving path's kernel shapes: decode positions of the 8 slots near
# the end of the phase-8 run (four 512 + 64, three 128 + 64, 896 + 64
# tokens), the whole-prompt prefill dispatch (B, S) it makes, and the
# launcher's (``launch/serve.py --full --batch 8 --prompt-len 512``)
DECODE_POS = [574, 574, 574, 574, 190, 190, 190, 958]
FLASH_SHAPES = [(3, 128), (4, 512), (8, 512), (1, 896)]
# hubert-xlarge's bidirectional attention in phases 2, 13 and 18 (c): B,
# S, heads on heads, hd
HUBERT_FLASH = (4, 512, 16, 16, 80)
# timed flash shapes (B, S, H, KH, hd, causal): phase 8's dispatch and the
# launcher's at internlm2-1.8b's heads, phase 11's two 512-token prompts
# at stablelm-12b's (hd 160, run at the padded width 192), phase 17's at
# zamba2-7b's (hd 112) and hubert-xlarge's bidirectional 4 x 512 at hd 80
FLASH_TIMED = [(3, 128, 16, 8, 128, True), (8, 512, 16, 8, 128, True),
               (2, 512, 32, 8, 160, True), (2, 512, 32, 32, 112, True),
               (*HUBERT_FLASH, False)]
# kernels that must reach the tensor cores: (library stem, kernel name)
TENSOR_CORE = [("env_megakernel", "env_mega_step_kernel"),
               ("flash_attention", "flash_attention_mma_kernel"),
               ("fused_policy_mlp", "fused_policy_mlp_kernel"),
               ("mlstm_chunkwise", "mlstm_scores_kernel"),
               ("mlstm_chunkwise", "mlstm_cstate_kernel"),
               ("mlstm_chunkwise", "mlstm_out_kernel")]
A3C_ROUNDS = 3
# the multi-GMI phase: layouts printed, iterations of the streams-vs-
# sequential gate, and the steps/s sweep (GMIs per GPU, dispatch mode), all
# at N_MAIN envs in total
GMI_LAYOUTS = [(1, 4), (2, 2)]
GMI_ITERS = 3
GMI_SWEEP = [(1, "streams"), (2, "streams"), (4, "streams"),
             (4, "sequential")]
# envs a GMI holds at 4 and at 2 GMIs a card: phase 2 checks the env step,
# the trunk and GAE at these too
GMI_N = (N_MAIN // 4, N_MAIN // 2)
GMI_SWEEP_ITERS = 4
# phase 12b: the supervised fleet's fault schedule, (kind, round, mode),
# one event of each runner-side kind; the failures it logs, in order (a
# checkpoint's step is the count of rounds done, so the round-4 tear hits
# the save after round index 3, before round 4's kill); the serving GMIs
# that collect over its 6 rounds (4, none in the round the first one dies,
# 2 and 2 while its GPU is quarantined, 4 and 4 after re-admission); envs
# a serving GMI at full width; timed rounds a turn
FLEET_EVENTS = [("kill_serving", 1, None), ("channel_drop", 2, None),
                ("kill_trainer", 4, None), ("ckpt_tear", 4, "before_manifest"),
                ("channel_poison", 5, None), ("ckpt_tear", 6, "torn_npz")]
FLEET_KINDS = ["kill_serving", "channel_drop", "ckpt_tear", "kill_trainer",
               "channel_poison", "ckpt_tear"]
FLEET_ROUNDS = 6
FLEET_COLLECTS = 4 + 0 + 2 + 2 + 4 + 4
FLEET_N = N_MAIN // 4
FLEET_TIMED = 5
PEAK_BYTES = 3.35e12     # H100 SXM HBM3, bytes/s
PEAK_F32 = 67e12         # H100 SXM fp32 outside the tensor cores, flop/s
PEAK_BF16 = 989e12       # H100 SXM bf16 tensor cores, dense, flop/s
PEAK_TF32 = 495e12       # H100 SXM TF32 tensor cores, dense, flop/s
# f32 accuracy on the TF32 tensor cores takes three passes (3xTF32)
PEAK_3XTF32 = PEAK_TF32 / 3
ARCH = "internlm2-1.8b"
# bf16 attention kernels: each output element within one bf16 ulp of its
# own magnitude, plus 2^-14 (``repro_torch.utils.bf16_ulps``); f32 ones 1e-4
XARCH = "xlstm-1.3b"
# the head dims the reference serves beyond 64 and 128, as (hd, H, KH):
# hubert-xlarge's 80 (G 1), zamba2-7b's 112 (here at G 2) and
# stablelm-12b's 160 (G 4)
HEAD_DIMS = [(80, 16, 16), (112, 16, 8), (160, 32, 8)]
SARCH = "stablelm-12b"
SLAYERS = 8              # of stablelm-12b's 40, to keep the phase short
# phase 11's kernel shapes: decode positions of its 4 slots near the end
# of the run (two 512 + 32, two 128 + 32 tokens) and its two whole-prompt
# dispatches (B, S)
SDECODE_POS = [543, 543, 159, 159]
SFLASH_SHAPES = [(2, 512), (2, 128)]
# phase 14: GMIs a manager holds room for (decode, prefill and any a
# controller decision adds); (b)'s decode GMIs, prefill GMIs and slots a
# decode GMI; its traffic (long prompts, the head two of them share, short
# prompts, greedy tokens each) and the pinned planner's threshold in
# prompt tokens (the long prompts migrate, the short stay local); (a)'s
# threshold, and its supervised fleet's faults (kind, round, target) and
# rounds; (c)'s rounds
D_GMIS = 16
D_DECODE, D_PREFILL, D_SLOTS = 2, 1, 8
D_LONG, D_HEAD, D_SHORT, D_GEN = 896, 512, 64, 64
D_THRESHOLD = 300
D_SMALL_THRESHOLD = 24
D_FLEET_EVENTS = [("engine_fail", 1, 0), ("prefill_fail", 2, 0),
                  ("channel_drop", 2, None)]
D_FLEET_ROUNDS = 4
D_ARBITER_ROUNDS = 4
# phase 15: agents a world, the small check's worlds and steps, and the
# iterations of the full-width run (N_MAIN agents, T_MAIN steps)
MA_AGENTS, MA_SMALL_WORLDS, MA_SMALL_T, MA_ITERS = 4, 8, 4, 3
# phase 16: granite-moe-1b-a400m's traffic (prompt lengths, greedy tokens
# each), its decode positions of the 8 slots near the end of the run and
# its two whole-prompt dispatches (B, S)
MARCH = "granite-moe-1b-a400m"
M_PROMPTS, M_GEN = (512,) * 4 + (128,) * 4, 64
M_DECODE_POS = [574] * 4 + [190] * 4
M_FLASH_SHAPES = [(4, 512), (4, 128)]
# phase 17: zamba2-7b's super-blocks run (of 9), traffic, decode positions
# of its 4 slots near the end of the run and its two dispatches (B, S)
ZARCH = "zamba2-7b"
Z_SUPER = 9
Z_PROMPTS, Z_GEN = (512, 512, 256, 256), 32
# phase 18: LM training, (a) the small card-vs-CPU archs, (b)/(c) the
# full-width runs (arch, batch, seq, steps); bf16 peak for the model-FLOP
# share
LM_SMALL = ("internlm2-1.8b", "xlstm-1.3b", "hubert-xlarge", "pixtral-12b")
LM_RUNS = (("internlm2-1.8b", 4, 512, 5), ("hubert-xlarge", 4, 512, 5))
# phase 19: pixtral-12b serving, depth cut as phase 11 cuts stablelm-12b
PARCH = "pixtral-12b"
PLAYERS = 8
P_TEXT, P_GEN, P_SLOTS = 256, 32, 4
Z_DECODE_POS = [543, 543, 287, 287]
Z_FLASH_SHAPES = [(2, 512), (2, 256)]
# mLSTM: (B, H, S, dh, chunk, zero state) of phase 10's B = 4 x 512
# dispatch and of the 768-token prompt's second chunk
MLSTM_MAIN = [(4, 4, 512, 512, 256, True), (1, 4, 256, 512, 256, False)]
# f32 tolerances: max |kernel - plain|; for the mLSTM outputs, relative
# to max(1, the plain output's largest magnitude)
TOL = {"env_mega_step": 1e-4, "gae_norm": 1e-4, "policy_mlp": 1e-4,
       "nstep_returns": 1e-5, "pack_channels": 0.0,
       "paged_attention": 1e-4, "flash_attention": 1e-4,
       "mlstm_chunkwise": 1e-4}
KERNELS = {
    "env_mega_step": ("src/repro_torch/csrc/env_megakernel.cu",
                      "src/repro/kernels/env_megakernel.py:179"),
    "gae_norm": ("src/repro_torch/csrc/gae_scan.cu",
                 "src/repro/kernels/gae_scan.py:57"),
    "policy_mlp": ("src/repro_torch/csrc/fused_policy_mlp.cu",
                   "src/repro/kernels/fused_policy_mlp.py:37"),
    "nstep_returns": ("src/repro_torch/csrc/gae_scan.cu",
                      "src/repro/kernels/gae_scan.py:98"),
    "pack_channels": ("src/repro_torch/csrc/channel_pack.cu",
                      "src/repro/kernels/channel_pack.py:103"),
    "paged_attention": ("src/repro_torch/csrc/paged_decode.cu",
                        "src/repro/kernels/paged_decode.py:77"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
    "mlstm_chunkwise": ("src/repro_torch/csrc/mlstm_chunkwise.cu",
                        "src/repro/kernels/mlstm_scan.py:74"),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def live_cuda_bytes() -> int:
    """Bytes of the distinct CUDA storages that Python objects hold, after
    a collection.  What a run still holds is read as the change in this,
    not in ``torch.cuda.memory_allocated``: that also counts the slack of
    cached blocks the allocator chose not to split, which depends on what
    earlier phases left in its cache."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    seen = {}
    for o in gc.get_objects():
        if issubclass(type(o), torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def sass_report(build_dir, logs):
    """For each of ``TENSOR_CORE``: the tensor-core instructions of its
    kernel in ``cuobjdump -sass`` of the built library, and nvcc's spill
    lines for it (every instantiation).  Asserts that it has some and that
    nvcc reports no spills."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = {}
    for stem, kernel in TENSOR_CORE:
        lib = str(build_dir / f"lib{stem}.so")
        sass = subprocess.run([tool, "-sass", lib], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif fn and kernel in fn:
                for op in ("HGMMA", "HMMA"):
                    if re.search(rf"\b{op}\.", line):
                        counts[op] = counts.get(op, 0) + 1
        spills, cur = [], ""
        for ln in logs.get(stem, "").splitlines():
            if "Function properties for" in ln:
                cur = ln
            elif "spill" in ln and kernel in cur:
                spills.append(ln.strip())
        assert spills, (stem, kernel, "no nvcc report")
        assert sum(counts.values()) > 0, (stem, kernel, "no tensor-core "
                                          "instruction in its SASS")
        assert all(re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                             ln) for ln in spills), (stem, spills)
        res[kernel] = counts
    return res


def device_times(fn, reps=20, warmup=3):
    """Mean device time of one call of ``fn`` by launched kernel: each
    kernel's durations under ``torch.profiler``, summed over ``reps``
    calls and divided by ``reps``.  A profile that saw no kernel is taken
    again, at most twice, with a warning line each time (the cause of such
    empty profiles is not known); {} if all three were empty."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    us = {}
    for attempt in range(3):
        if attempt:
            print(f"[warn] torch.profiler saw no kernel in profile "
                  f"{attempt} of 3; taking it again")
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n = e.name.replace("(anonymous namespace)", "")
                m = re.search(r"(\w+)(<[^(]*>)?\(", n)
                name = m.group(1) if m else n[:60]
                us[name] = us.get(name, 0.0) + (e.time_range.end
                                                - e.time_range.start)
        if us:
            break
    return {k: v / reps / 1e3 for k, v in us.items()}


def device_ms(fn):
    """The sum of :func:`device_times`; None if the profiler saw no
    kernel."""
    return sum(device_times(fn).values()) or None


def host_ms(fn, reps=50, warmup=3) -> float:
    """The median host (CPU wall) time of one call of ``fn`` on its own,
    with no synchronise around it: what the caller's thread spends
    enqueueing the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(ts)[reps // 2] * 1e3


def time_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------- inputs ----
def env_inputs(name, n, gen, dev):
    from repro_torch.envs import make_env
    from repro_torch.kernels import ref
    env = make_env(name, megakernel=True, device=dev)
    state, obs = env.reset(gen, n)
    mc = env.mega
    kw = dict(chain=mc.chain, task=mc.task, substeps=env.spec.substeps,
              dt=env.spec.dt, max_episode_len=env.spec.max_episode_len)
    J = env.spec.act_dim
    # a few plain steps so joint velocities and the root are not at rest
    for _ in range(3):
        a = torch.rand((n, J), generator=gen, device=dev) * 2 - 1
        out = ref.mega_step(*state, a, obs, None, 0, 0, mc.sensor, mc.tgt,
                            mc.masses, mc.lengths, **kw)
        state, obs = out[:7], out[7]
    state = list(state)
    t = state[4].clone()
    t[::8] = env.spec.max_episode_len - 1      # force 1/8 of envs to reset
    state[4] = t
    action = torch.rand((n, J), generator=gen, device=dev) * 3 - 1.5
    consts = (mc.sensor, mc.tgt, mc.masses, mc.lengths)
    return env, state, action, obs, consts, kw


def ring(T, S, n, sp, dev, fill=-7.0):
    return {"obs": torch.full((T, S * n, sp.obs_dim), fill, device=dev),
            "actions": torch.full((T, S * n, sp.act_dim), fill, device=dev),
            "rewards": torch.full((T, S * n), fill, device=dev),
            "dones": torch.full((T, S * n), fill, device=dev)}


def trunk_inputs(dims, n, gen, dev):
    """x (n, dims[0]) and one layer for each pair of widths: ``dims`` is
    the trunk's, ``spec.policy_dims[:-1]`` (the heads excluded)."""
    x = torch.rand((n, dims[0]), generator=gen, device=dev) * 2 - 1
    ws = [torch.randn((dims[i], dims[i + 1]), generator=gen, device=dev)
          * (2.0 / dims[i]) ** 0.5 for i in range(len(dims) - 1)]
    bs = [torch.randn((dims[i + 1],), generator=gen, device=dev) * 0.1
          for i in range(len(dims) - 1)]
    return x, ws, bs


def gae_inputs(T, n, gen, dev):
    r = torch.randn((T, n), generator=gen, device=dev)
    v = torch.randn((T, n), generator=gen, device=dev)
    d = (torch.rand((T, n), generator=gen, device=dev) < 0.05).float()
    last = torch.randn((n,), generator=gen, device=dev)
    return r, v, d, last


def pack_inputs(T, S, n, spec, gen, dev, version, fill=-7.0):
    """One push's payloads and ring buffers of S slots pre-filled with a
    sentinel."""
    pay = {"obs": torch.randn((T, n, spec.obs_dim), generator=gen, device=dev),
           "actions": torch.randn((T, n, spec.act_dim), generator=gen,
                                  device=dev),
           "rewards": torch.randn((T, n), generator=gen, device=dev),
           "dones": (torch.rand((T, n), generator=gen, device=dev)
                     < 0.05).float(),
           "bootstrap": torch.randn((n,), generator=gen, device=dev),
           "actor_version": version}
    bufs = ring(T, S, n, spec, dev, fill)
    bufs["bootstrap"] = torch.full((S, n), fill, device=dev)
    bufs["actor_version"] = torch.full((S, 1), -7, dtype=torch.int32,
                                       device=dev)
    return pay, bufs


# ------------------------------------------------------------- checks ----
def check_env(name, n, gen, dev, with_ring: bool) -> float:
    from repro_torch.kernels import ops, ref
    env, state, action, obs, consts, kw = env_inputs(name, n, gen, dev)
    T, S, slot, step_t = 4, 2, 1, 2
    bk = ring(T, S, n, env.spec, dev) if with_ring else None
    br = ring(T, S, n, env.spec, dev) if with_ring else None
    got = ops.env_mega_step(*state, action, obs, bk, step_t, slot, *consts,
                            **kw)
    want = ref.mega_step(*state, action, obs, br, step_t, slot, *consts,
                         **kw)
    want2 = ref.env_mega_step_ref(*state, action, obs, None, step_t, slot,
                                  *consts, **kw)
    torch.cuda.synchronize()
    err = 0.0
    names = ("q", "qd", "root", "prev_action", "t", "seed", "resets", "obs",
             "reward", "done")
    for nm, g, w, w2 in zip(names, got[:10], want[:10], want2[:10]):
        if g.dtype == torch.int32 or nm == "done":
            assert torch.equal(g, w) and torch.equal(g, w2), (name, nm)
        else:
            e = max(max_err(g, w), max_err(g, w2))
            assert e <= TOL["env_mega_step"], (name, nm, e)
            err = max(err, e)
    assert bool((got[9] > 0).any()), "no env was reset"
    if with_ring:
        for c in ("obs", "actions", "rewards", "dones"):
            e = max_err(bk[c], br[c])
            assert e <= TOL["env_mega_step"], (name, c, e)
            err = max(err, e)
            keep = torch.ones_like(bk[c], dtype=torch.bool)
            keep[step_t, slot * n:(slot + 1) * n] = False
            assert bool((bk[c][keep] == -7.0).all()), f"sentinel lost: {c}"
    return err


def check_gae(T, n, gen, dev) -> float:
    """Within the tolerance of the plain version, and bit-identical from
    call to call."""
    from repro_torch.kernels import ops, ref
    args = gae_inputs(T, n, gen, dev)
    ga, gr = ops.gae_norm(*args)
    ga2, gr2 = ops.gae_norm(*args)
    wa, wr = ref.gae_norm_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(ga, ga2) and torch.equal(gr, gr2), ("gae_norm", T, n)
    err = max(max_err(ga, wa), max_err(gr, wr))
    assert err <= TOL["gae_norm"], ("gae_norm", T, n, err)
    return err


def check_trunk(dims, n, gen, dev) -> float:
    from repro_torch.kernels import ops, ref
    x, ws, bs = trunk_inputs(dims, n, gen, dev)
    err = max_err(ops.policy_mlp(x, ws, bs), ref.policy_mlp_ref(x, ws, bs))
    assert err <= TOL["policy_mlp"], ("policy_mlp", dims, n, err)
    return err


def check_nstep(T, n, gen, dev) -> float:
    from repro_torch.kernels import ops, ref
    r, _, d, boot = gae_inputs(T, n, gen, dev)
    err = max_err(ops.nstep_returns(r, d, boot),
                  ref.nstep_returns_ref(r, d, boot))
    assert err <= TOL["nstep_returns"], ("nstep_returns", T, n, err)
    return err


def check_pack(T, n, spec, gen, dev, version) -> float:
    """Slot 1 of a 2-slot ring: the kernel's rings equal the plain
    version's bit for bit, slot 1 holds the payload and slot 0 keeps its
    sentinel."""
    from repro_torch.kernels import ops, ref
    S, slot = 2, 1
    pay, bk = pack_inputs(T, S, n, spec, gen, dev, version)
    br = {c: b.clone() for c, b in bk.items()}
    assert ops.pack_channels(bk, pay, slot) is bk
    ref.pack_channels_ref(br, pay, slot)
    torch.cuda.synchronize()
    for c in bk:
        assert torch.equal(bk[c], br[c]), ("pack_channels", n, c)
        rows = c in ("bootstrap", "actor_version")
        mine = bk[c][slot] if rows else bk[c][:, slot * n:(slot + 1) * n]
        other = bk[c][0] if rows else bk[c][:, :n]
        assert bool((other == -7).all()), f"sentinel lost: {c}"
        want = torch.as_tensor(pay[c], device=dev).reshape(mine.shape)
        assert torch.equal(mine, want.to(mine.dtype)), ("slot", c)
    return max(max_err(bk[c], br[c]) for c in bk)


def check_small_iteration(dev):
    """One fused PPO iteration on the card (kernels) against the plain
    PyTorch path on the CPU, from the same params, env state, noise and
    permutations.  Losses and rewards agree to 1e-4.  The iteration's 4
    Adam steps at lr = 3e-4 move a param by at most about 1.2e-3, so the
    check first asserts that the CPU run moved some param by more than
    1e-4 (an update really happened), then holds the card's params to the
    CPU's within 1e-5, a few percent of one step."""
    from repro_torch.envs import make_env
    from repro_torch.rl.ppo import PPOConfig, init_train, train_iteration
    from repro_torch.utils import tree_leaves, tree_map
    cfg = PPOConfig(num_steps=8, num_epochs=2, num_minibatches=2,
                    use_fused_kernels=True)
    n = 64
    out = {}
    for d in ("cpu", dev):
        env = make_env("Ant", megakernel=True, device=d)
        p, o, es, ob, _ = init_train(0, make_env("Ant", device="cpu"),
                                     env.spec.policy_dims, n, device="cpu")
        g = torch.Generator("cpu").manual_seed(1)
        noise = torch.randn((cfg.num_steps, n, env.spec.act_dim),
                            generator=g)
        perms = torch.stack([torch.randperm(cfg.num_steps * n, generator=g)
                             for _ in range(cfg.num_epochs)])
        p0 = [t.clone() for t in tree_leaves(p)]
        mv = lambda x: tree_map(lambda t: t.to(d), x)
        res = train_iteration(mv(p), mv(o), env, mv(es), ob.to(d), None,
                              cfg, noise=noise.to(d), perms=perms.to(d))
        out[str(d)] = tree_map(lambda t: t.cpu(), (res[0], res[5], res[1]))
    (pc, mc, oc), (pg, mg, og) = out["cpu"], out[str(dev)]
    for k in ("loss", "reward_mean", "reward_sum", "episode_done_frac"):
        assert abs(float(mc[k]) - float(mg[k])) <= 1e-4, (k, mc[k], mg[k])
    moved = max(max_err(a, b) for a, b in zip(tree_leaves(pc), p0))
    assert moved > 1e-4, ("no update on the CPU", moved)
    errs = [max_err(a, b) for a, b in zip(tree_leaves(pc), tree_leaves(pg))]
    perr = max(errs)
    if perr > 1e-5:
        # name the worst element and its Adam moments on both sides, so a
        # failure shows whether a near-zero second moment amplified it
        i = errs.index(perr)
        j = int((tree_leaves(pc)[i] - tree_leaves(pg)[i]).abs().argmax())
        at = lambda t: float(t.reshape(-1)[j])
        worst = {"leaf": i, "element": j, "start": at(p0[i]),
                 "cpu": at(tree_leaves(pc)[i]), "card": at(tree_leaves(pg)[i])}
        for side, o in (("cpu", oc), ("card", og)):
            worst[f"{side}_mu"] = at(tree_leaves(o.mu)[i])
            worst[f"{side}_nu"] = at(tree_leaves(o.nu)[i])
        raise AssertionError(("params card vs CPU", perr, worst))
    return perr, moved


def check_small_a3c(dev):
    """Two small A3C rounds on the card (the n-step kernel, and the env
    megakernel into the ring or the ring-pack kernel) against the plain
    PyTorch path on the CPU, on both branches of ``round``, from the same
    params, Adam state, env states and noise.  Losses agree to 1e-4; the
    CPU run must move some param by more than 1e-4 (each round's single
    Adam step at lr = 3e-4 moves a param by up to ~3e-4) before the
    card's params are held to the CPU's within 1e-5."""
    from repro_torch.envs import make_env
    from repro_torch.rl.a3c import AsyncRunner
    from repro_torch.utils import tree_leaves, tree_map
    n, T = 64, 8
    res = {}
    for mk in (True, False):
        runs = {d: AsyncRunner(make_env("Ant", megakernel=mk, device=d),
                               [0, 1], [2], num_envs=n, num_steps=T, seed=0,
                               use_fused_kernels=True, device=d)
                for d in ("cpu", dev)}
        cpu, card = runs["cpu"], runs[dev]
        mv = lambda x: tree_map(lambda t: t.to(dev), x)
        card.params = card.actor_params = mv(cpu.params)
        card.opt_state = mv(cpu.opt_state)
        for a, (es, obs, _) in cpu.actors.items():
            card.actors[a] = [mv(es), obs.to(dev), card.actors[a][2]]
        p0 = [t.clone() for t in tree_leaves(cpu.params)]
        g = torch.Generator("cpu").manual_seed(1)
        act = cpu.env.spec.act_dim
        for _ in range(2):
            noise = {a: torch.randn((T, n, act), generator=g)
                     for a in cpu.serving_gmis}
            lc, sc = cpu.round(noise)
            lg, sg = card.round({a: x.to(dev) for a, x in noise.items()})
            assert sc == sg == [0], (sc, sg)
            assert max(abs(a - b) for a, b in zip(lc, lg)) <= 1e-4, (lc, lg)
        assert card.trained_samples == cpu.trained_samples == 2 * 2 * T * n
        moved = max(max_err(a, b) for a, b in zip(tree_leaves(cpu.params),
                                                  p0))
        assert moved > 1e-4, ("no update on the CPU", moved)
        perr = max(max_err(a, b.cpu()) for a, b in zip(
            tree_leaves(cpu.params), tree_leaves(card.params)))
        assert perr <= 1e-5, (mk, perr)
        res["direct" if mk else "push"] = (perr, moved)
    return res


def run_a3c(dev, megakernel: bool):
    """The A3C path at full width: ShadowHand, serving GMIs 0 and 1 of
    N_A3C envs each and trainer GMI 2 on one 2-slot ring, T = 16, fused
    n-step returns, A3C_ROUNDS rounds with the launch counters set to 0
    just before and read just after."""
    from repro_torch.envs import SPECS, make_env
    from repro_torch.kernels import ops
    from repro_torch.rl.a3c import AsyncRunner
    from repro_torch.utils import tree_leaves
    env = make_env(ENV, megakernel=megakernel, device=dev)
    runner = AsyncRunner(env, [0, 1], [2], num_envs=N_A3C, num_steps=T_MAIN,
                         seed=0, use_fused_kernels=True, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    round_s, losses = [], []
    for _ in range(A3C_ROUNDS):
        ti = time.perf_counter()
        ls, stale = runner.round()       # reads the losses: a sync
        round_s.append(time.perf_counter() - ti)
        assert stale == [0] and len(ls) == 1, (stale, ls)
        assert all(v == v and abs(v) < float("inf") for v in ls), ls
        losses += ls
    elapsed = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    direct = 2 * T_MAIN * A3C_ROUNDS if megakernel else 0
    want = {k: 0 for k in TOL}
    want.update({"env_mega_step": direct, "nstep_returns": A3C_ROUNDS,
                 "pack_channels": 0 if megakernel else 2 * A3C_ROUNDS})
    assert launches == want, (launches, want)
    samples = A3C_ROUNDS * 2 * T_MAIN * N_A3C
    assert runner.trained_samples == runner.predictions == samples, (
        runner.trained_samples, runner.predictions)
    assert all(bool(p.isfinite().all()) for p in tree_leaves(runner.params))
    for es, obs, _ in runner.actors.values():
        assert obs.shape == (N_A3C, SPECS[ENV].obs_dim)
        assert bool(obs.isfinite().all())
    return launches, round_s, elapsed, losses, samples


# ---------------------------------------------------------- multi-GMI ----
def gmi_args(dev, gmi_per_gpu, iters=GMI_ITERS, dispatch="streams"):
    """``launch/train.py --workload drl`` arguments at the full width, one
    GPU of ``gmi_per_gpu`` GMIs."""
    import argparse
    return argparse.Namespace(
        env=ENV, num_gpus=1, gmi_per_gpu=gmi_per_gpu, num_env=N_MAIN,
        rollout=T_MAIN, iters=iters, seed=0, device=str(dev),
        dispatch=dispatch)


def check_layouts(dev):
    """Phase 12.1: the TCG_EX layouts the launcher plans, with the
    launcher's logical ids, and Algorithm 1's strategy for each."""
    from repro_torch.core.placement import plan_tcg_ex_training
    lines = []
    for g, t in GMI_LAYOUTS:
        lay = plan_tcg_ex_training(
            g, t, devices=list(range(max(torch.cuda.device_count(), g * t))),
            devices_per_gpu=t, device=dev)
        comm = lay.communicator()
        lines.append(f"[gmi] TCG_EX {g} x {t}:\n{lay.manager.summary()}\n"
                     f"[gmi] Algorithm 1 strategy {comm.strategy}, grid "
                     f"{comm.grid}, candidates {comm.candidates()}")
    return lines


def lgr_grids(dev):
    """Instance grids (1, 4), (2, 2) and (2, 2, 2) on the card, one CUDA
    stream per GMI."""
    from repro_torch.core.gmi import GMIManager
    from repro_torch.core.placement import plan_tcg_ex_training
    grids = []
    for g, t in ((1, 4), (2, 2)):
        lay = plan_tcg_ex_training(g, t, devices=list(range(g * t)),
                                   devices_per_gpu=t, device=dev)
        grids.append(lay.manager.instance_mesh("holistic"))
    mgr = GMIManager(list(range(8)), 4, device=dev)
    for gid in range(4):
        mgr.add_gmi(gid, "trainer", 0.5)
        mgr.set_gpu(gid, gid // 2)
    grids.append(mgr.instance_mesh("trainer"))
    return grids


def check_lgr(dev, gen):
    """Phase 12.2: ``Communicator.allreduce`` of the ShadowHand policy's
    gradient tree stacked over each grid, for every candidate strategy,
    against the host-staged ``reduce_host`` (``mpr_host``): every cell of
    every leaf within 1e-6 of the leaf's largest magnitude.  Also the
    device time of each (one card: one sum in several shapes)."""
    import itertools
    from repro_torch.comm import Communicator, ReduceCostModel
    from repro_torch.envs import SPECS
    from repro_torch.models.policy import init_policy
    from repro_torch.utils import tree_leaves, tree_map
    params = init_policy(gen, SPECS[ENV].policy_dims)
    nparam = sum(p.numel() for p in tree_leaves(params))
    lines, worst = [], 0.0
    for grid in lgr_grids(dev):
        gshape = grid.shape
        d = gshape[2] if len(gshape) > 2 else 1
        grads = tree_map(lambda p: torch.randn(gshape + tuple(p.shape),
                                               generator=gen, device=dev),
                         params)
        cells = list(itertools.product(*map(range, gshape)))
        for strat in ReduceCostModel(dev_per_inst=d).candidates(gshape):
            comm = Communicator(strat, mesh=grid)
            out = comm.allreduce(grads)
            want = comm.reduce_host([tree_map(lambda x: x[c], grads)
                                     for c in cells])
            err = 0.0
            for o, w in zip(tree_leaves(out), tree_leaves(want)):
                w = w.to(dev)
                err = max(err, float((o - w).abs().max() / w.abs().max()))
            assert err <= 1e-6, (gshape, strat, err)
            worst = max(worst, err)
            ms = time_ms(lambda: comm.allreduce(grads))
            dv = device_ms(lambda: comm.allreduce(grads))
            lines.append(f"[lgr] grid {gshape} {grid.axis_names} {strat}: "
                         f"max err {err:.3g} of each leaf's largest "
                         f"magnitude (tol 1e-6), {ms:.4f} ms a call (CUDA "
                         f"events), device time {dv} ms")
    lines.append(f"[lgr] ShadowHand gradient tree {nparam:,} f32 "
                 f"({nparam * 4 / 1e6:.2f} MB) per instance; worst error "
                 f"{worst:.3g}")
    return lines


def run_gmis_parity(dev):
    """Phase 12.3: ``run_drl`` at 1 x 4 GMIs, GMI_ITERS iterations, each GMI
    on its own stream with the launch counters set to 0 just before and
    read just after, then again with every GMI on the default stream in
    turn: the params within 1e-6 and the same launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run_drl
    from repro_torch.utils import tree_leaves
    runs, by_mode = {}, {}
    for dispatch in ("streams", "sequential"):
        torch.cuda.synchronize()
        ops.reset_launches()
        out = run_drl(gmi_args(dev, 4, dispatch=dispatch))
        torch.cuda.synchronize()
        by_mode[dispatch] = dict(ops.LAUNCHES)
        runs[dispatch] = out
        for it in out["metrics"]:
            for m in it:
                assert all(v == v and abs(v) < float("inf")
                           for v in m.values()), m
    want = {k: 0 for k in TOL}
    want.update({"env_mega_step": 4 * T_MAIN * GMI_ITERS,
                 "policy_mlp": 4 * (T_MAIN + 1) * GMI_ITERS,
                 "gae_norm": 4 * GMI_ITERS})
    for dispatch, la in by_mode.items():
        assert la == want, (dispatch, la, want)
    diff = max(max_err(a, b) for a, b in zip(
        tree_leaves(runs["streams"]["params"]),
        tree_leaves(runs["sequential"]["params"])))
    assert diff <= 1e-6, diff
    bit = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(runs["streams"]["params"]),
        tree_leaves(runs["sequential"]["params"])))
    return by_mode["streams"], diff, bit, runs


def measure_gmis(dev):
    """Phase 12.4: env steps/s of run_drl at the same total envs and
    iterations for 1 x 16384, 2 x 8192 and 4 x 4096 GMIs on streams, and
    4 x 4096 sequential; the first iteration is the warm-up, the rate is
    over the rest."""
    from repro_torch.launch.train import run_drl
    lines = []
    for k, dispatch in GMI_SWEEP:
        out = run_drl(gmi_args(dev, k, GMI_SWEEP_ITERS, dispatch))
        s = out["iter_s"]
        rate = (len(s) - 1) * T_MAIN * N_MAIN / sum(s[1:])
        lines.append(f"[multiplex] {k} GMI x {N_MAIN // k} envs, "
                     f"dispatch={dispatch}: {rate:,.0f} env steps/s "
                     f"(iterations 2-{len(s)}), per-iteration s "
                     f"{[round(x, 4) for x in s]}")
    return lines


def run_algorithm2(dev):
    """Phase 12.5: Algorithm 2 over the port's PPO profiler on the card."""
    from repro_torch.core.selection import explore, make_ppo_profiler
    trace = explore(make_ppo_profiler(iters=1, device=dev), ENV, num_gpu=1,
                    gmi_per_gpu_range=(4, 2, 1),
                    num_env_sweep=(4096, 16384))
    lines = [f"[alg2] GMIperGPU={g} num_env={n}: runnable={p.runnable} "
             f"throughput {p.throughput:,.0f} env steps/s a GMI, memory "
             f"model {p.memory:,.0f} B, Sat {s}"
             for g, n, p, s in trace.points]
    lines.append(f"[alg2] best_config (num_env, GMIperGPU) "
                 f"{trace.best_config}, projected "
                 f"{trace.best_throughput:,.0f} env steps/s")
    return lines


def gae_under_load(dev, gen):
    """Phase 12.6: the cooperative GAE launch while another stream keeps
    the card busy (a chain of 8 4096^3 fp32 GEMMs), at a GMI's N = 4096
    columns (a small grid) and at N_GAE_STRIDE columns (a grid of every
    block the card holds at once): it must return cudaSuccess (the wrapper
    raises otherwise) and agree with its plain version within 1e-4;
    printed, by CUDA events: when the GAE finished and when the chain
    finished, from the chain's start (the GAE is enqueued just after the
    chain)."""
    from repro_torch.kernels import ops, ref
    a = torch.randn(4096, 4096, generator=gen, device=dev)
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        b = a @ a           # the side stream's cuBLAS handle and workspace
    lines = []
    for n in (N_MAIN // 4, N_GAE_STRIDE):
        r, v, d, last = gae_inputs(T_MAIN, n, gen, dev)
        want = ref.gae_norm_ref(r, v, d, last)
        side.wait_stream(main)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.cuda.stream(side):
            ev[0].record()
            for _ in range(8):
                b = a @ a
            ev[1].record()
        got = ops.gae_norm(r, v, d, last)
        ev[2].record()
        torch.cuda.synchronize()
        err = max(max_err(x, y) for x, y in zip(got, want))
        assert err <= TOL["gae_norm"], (n, err)
        lines.append(f"[gae_load] N={n}: cudaLaunchCooperativeKernel "
                     f"returned cudaSuccess, max_abs_err={err:.3g}; the GAE "
                     f"finished {ev[0].elapsed_time(ev[2]):.3f} ms after "
                     f"the GEMM chain began, the chain "
                     f"{ev[0].elapsed_time(ev[1]):.3f} ms after")
    del b
    return lines


# ------------------------------------------------- supervised async A3C ----
def fleet_plan():
    """Phase 12b's fault schedule: one event of each runner-side kind."""
    from repro_torch.fault import FaultEvent, FaultPlan
    return FaultPlan([FaultEvent(k, r, mode=m) for k, r, m in FLEET_EVENTS])


def make_fleet(dev, env_name, n, T, megakernel, ckpt_dir=None, plan=True):
    """``make_fleet_supervisor`` over ``plan_async(3, 2, 2)`` on logical
    GPUs of one card (4 serving GMIs of ``n`` envs, 2 trainer GMIs), fused
    kernels, probation 2, a checkpoint every 2 rounds into ``ckpt_dir``."""
    from repro_torch.core.placement import plan_async
    from repro_torch.envs import make_env
    from repro_torch.launch.steps import make_fleet_supervisor
    layout = plan_async(3, 2, 2, devices=list(range(6)), devices_per_gpu=2,
                        device=dev)
    return make_fleet_supervisor(
        make_env(env_name, device=dev), layout,
        plan=fleet_plan() if plan else None, num_envs=n, num_steps=T,
        megakernel=megakernel, use_fused_kernels=True, probation=2,
        ckpt_dir=ckpt_dir, ckpt_every=2 if ckpt_dir else 0, device=dev)


def fleet_want(sup, direct):
    """The exact launches of a supervised run, from its own accounting:
    one env step a collected step on the direct branch, one ring pack a
    push on the other, one n-step scan a trained or discarded batch."""
    r = sup.runner
    want = {k: 0 for k in TOL}
    collects = r.predictions // (r.num_steps * r.num_envs)
    want["env_mega_step" if direct else "pack_channels"] = \
        collects * (r.num_steps if direct else 1)
    want["nstep_returns"] = r.version + r.poisoned_batches
    return want


def check_fleet_parity(dev):
    """Phase 12b (a): the supervised fleet on the card against the same
    fleet on the CPU (Ant, 8 envs a GMI, T = 4, the push branch: ring pack
    and n-step kernels), the same fault plan and noise.  Params and Adam
    state are copied from the CPU side once, before round 0; env states
    and observations are copied again after each re-plan, since the two
    devices' generators draw different resets.  Logs and counters equal,
    params within 1e-5; the card run's launches are exact and are
    returned for ``by_path``."""
    import shutil
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.utils import tree_leaves, tree_map
    n, T = 8, 4
    dirs = {d: tempfile.mkdtemp(prefix="fleet_") for d in ("cpu", "card")}
    cpu = make_fleet("cpu", "Ant", n, T, False, dirs["cpu"])
    card = make_fleet(dev, "Ant", n, T, False, dirs["card"])
    cr, gr = cpu.runner, card.runner
    mv = lambda x: tree_map(lambda t: t.to(dev), x)
    gr.params = gr.actor_params = mv(cr.params)
    gr.opt_state = mv(cr.opt_state)

    def carry():
        for a, (es, obs, _) in cr.actors.items():
            gr.actors[a] = [mv(es), obs.to(dev), gr.actors[a][2]]

    carry()
    p0 = [t.clone() for t in tree_leaves(cr.params)]
    g = torch.Generator("cpu").manual_seed(2)
    act = cr.env.spec.act_dim
    torch.cuda.synchronize()
    ops.reset_launches()
    for _ in range(FLEET_ROUNDS):
        noise = {a: torch.randn((T, n, act), generator=g)
                 for a in cr.serving_gmis}
        replans = cr.replans
        lc, sc = cpu.round(noise)
        lg, sg = card.round({a: x.to(dev) for a, x in noise.items()})
        assert sc == sg, (sc, sg)
        assert len(lc) == len(lg) and all(
            abs(a - b) <= 1e-4 for a, b in zip(lc, lg)), (lc, lg)
        assert gr.replans == cr.replans
        if cr.replans != replans:
            carry()
    lc, sc = cr.finish()
    lg, sg = gr.finish()
    assert sc == sg and all(abs(a - b) <= 1e-4 for a, b in zip(lc, lg))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    for k in ("failures", "recoveries", "quarantined", "ckpt_steps",
              "num_gpu", "serving_gpus"):
        assert getattr(card, k) == getattr(cpu, k), (k, getattr(card, k),
                                                     getattr(cpu, k))
    counters = ("predictions", "trained_samples", "poisoned_batches",
                "poisoned_samples", "replans", "version")
    for k in counters:
        assert getattr(gr, k) == getattr(cr, k), (k, getattr(gr, k),
                                                  getattr(cr, k))
    for k in ("dropped_flushes", "poisoned_flushes", "delivered_samples"):
        assert getattr(gr.pipe, k) == getattr(cr.pipe, k), k
    assert [f["kind"] for f in card.failures] == FLEET_KINDS, card.failures
    assert any(r["kind"] == "readmit" for r in card.recoveries)
    assert gr.trained_samples + gr.poisoned_samples == gr.predictions
    moved = max(max_err(a, b) for a, b in zip(tree_leaves(cr.params), p0))
    assert moved > 1e-4, ("no update on the CPU", moved)
    perr = max(max_err(a, b.cpu()) for a, b in zip(
        tree_leaves(cr.params), tree_leaves(gr.params)))
    assert perr <= 1e-5, perr
    want = fleet_want(card, direct=False)
    assert launches == want, (launches, want)
    for d in dirs.values():
        shutil.rmtree(d)
    return launches, perr, moved, {k: getattr(gr, k) for k in counters}, card


def run_fleet(dev):
    """Phase 12b (b): the supervised fleet at full width: ShadowHand,
    ``megakernel=True`` (direct produce into the ring), 4 serving GMIs x
    FLEET_N envs, T = 16, a checkpoint every 2 rounds into a temp dir,
    the fault plan of (a), with the launch counters set to 0 just before
    and read just after.  Asserts lossless accounting, that the poisoned
    batch left the params the very tensors (and values) they were, and
    that ``restore`` skips the torn step 6 for step 2 and reads its params
    bit for bit.  Also returns the device memory its live tensors hold after
    ``finish`` (the runner alive, relative to before it) and the (T, N) of
    every batch the n-step scan saw."""
    import shutil
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.rl import a3c
    from repro_torch.utils import tree_leaves
    d = tempfile.mkdtemp(prefix="fleet_")
    base = live_cuda_bytes()
    sup = make_fleet(dev, ENV, FLEET_N, T_MAIN, True, d)
    r = sup.runner
    calls, saved, save_ms, shapes = [], {}, [], set()
    update = a3c.trainer_update

    def spy(params, opt_state, exp, **kw):
        out = update(params, opt_state, exp, **kw)
        shapes.add(tuple(exp.rewards.shape))
        calls.append((params, [t.cpu() for t in tree_leaves(params)],
                      bool(torch.isfinite(out[2]))))
        return out

    checkpoint = r.checkpoint

    def timed_checkpoint(directory, step=None, fault_hook=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint(directory, step=step, fault_hook=fault_hook)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        saved[step] = ([t.cpu() for t in tree_leaves(r.params)],
                       r.rounds, r.version, r.trained_samples)
        return path

    r.checkpoint = timed_checkpoint
    a3c.trainer_update = spy
    torch.cuda.synchronize()
    ops.reset_launches()
    round_s = []
    try:
        for _ in range(FLEET_ROUNDS):
            t0 = time.perf_counter()
            sup.round()
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
        r.finish()
        torch.cuda.synchronize()
    finally:
        a3c.trainer_update = update
    launches = dict(ops.LAUNCHES)
    want = fleet_want(sup, direct=True)
    assert launches == want, (launches, want)
    assert r.predictions == FLEET_COLLECTS * T_MAIN * FLEET_N, r.predictions
    assert r.trained_samples + r.poisoned_samples == r.predictions, (
        r.trained_samples, r.poisoned_samples, r.predictions)
    assert [f["kind"] for f in sup.failures] == FLEET_KINDS, sup.failures
    assert any(x["kind"] == "readmit" for x in sup.recoveries)
    assert r.poisoned_batches == 1 and len(calls) == want["nstep_returns"]
    bad = [i for i, c in enumerate(calls) if not c[2]]
    assert len(bad) == 1, bad
    i = bad[0]
    after = calls[i + 1][0] if i + 1 < len(calls) else r.params
    assert after is calls[i][0], "the poisoned update was not discarded"
    assert all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(after),
                                                       calls[i][1]))
    assert all(bool(p.isfinite().all()) for p in tree_leaves(r.params))
    # the spy's references keep old params generations alive: drop them
    # before reading what the run itself holds
    del after, calls
    held = live_cuda_bytes() - base
    assert sup.ckpt_steps == [2, 6], sup.ckpt_steps
    from repro_torch.checkpoint import ckpt
    assert ckpt.steps(d) == [2, 6]
    from repro_torch.launch.steps import make_async_runner
    fresh = make_async_runner(r.env, sup.layout, num_envs=FLEET_N,
                              num_steps=T_MAIN, use_fused_kernels=True,
                              device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = fresh.restore(d)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    assert step == 2, step
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(tree_leaves(fresh.params), saved[2][0]))
    assert (fresh.rounds, fresh.version, fresh.trained_samples) \
        == saved[2][1:], (fresh.rounds, fresh.version, saved[2][1:])
    mb = os.path.getsize(os.path.join(d, "ckpt_2.npz")) / 1e6
    shutil.rmtree(d)
    return launches, round_s, save_ms, restore_ms, mb, held, shapes, sup


def fleet_held_without_faults(dev):
    """Phase 12b (b)'s yardstick: the device memory that live tensors of
    the same blocking fleet, with no fault plan and no checkpoints, still
    hold after FLEET_ROUNDS rounds and ``finish`` (the runner alive,
    relative to before it).  The faulted run must hold no more than 10% over it:
    ring storage that a dropped or requeued payload kept must not leak."""
    base = live_cuda_bytes()
    sup = make_fleet(dev, ENV, FLEET_N, T_MAIN, True, plan=False)
    for _ in range(FLEET_ROUNDS):
        sup.round()
    sup.runner.finish()
    assert sup.runner.trained_samples == sup.runner.predictions
    held = live_cuda_bytes() - base
    del sup
    return held


def time_fleet_rounds(dev):
    """Phase 12b: round seconds of the full-width fleet with no fault plan,
    supervised (hooks armed, the non-finite guard's one read a batch)
    against the same runner unsupervised (``make_async_runner``), in turns
    unsupervised, supervised, supervised, unsupervised, FLEET_TIMED rounds
    a turn after a warm-up round each."""
    from repro_torch.launch.steps import make_async_runner
    sup = make_fleet(dev, ENV, FLEET_N, T_MAIN, True, plan=False)
    runs = {"supervised": sup,
            "unsupervised": make_async_runner(
                sup.runner.env, sup.layout, num_envs=FLEET_N,
                num_steps=T_MAIN, use_fused_kernels=True, device=dev)}
    out = {k: [] for k in runs}
    for k in runs:
        runs[k].round()
    for k in ("unsupervised", "supervised", "supervised", "unsupervised"):
        for _ in range(FLEET_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[k].round()
            torch.cuda.synchronize()
            out[k].append(time.perf_counter() - t0)
    return out


def run_controller(dev):
    """Phase 12b (c): ``make_async_runner(..., overlap=True,
    online_controller=True)`` at full width (ShadowHand, megakernel env,
    4 serving GMIs from FLEET_N envs, T = 16, ladder (4096, 8192), epochs
    of 2 rounds) for 6 rounds and ``finish``, the launch counters set to 0
    just before and read just after; then a run with no controller at
    the larger N.  The device memory that live tensors hold after each
    (runner alive, relative to before it) must agree within 10%: dropped
    rings must not leak.
    Also returns the (T, N) of every batch the n-step scan saw."""
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.placement import plan_async
    from repro_torch.envs import make_env
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_async_runner
    from repro_torch.rl import a3c
    held, out, shapes = {}, {}, set()
    update = a3c.trainer_update

    def spy(params, opt_state, exp, **kw):
        shapes.add(tuple(exp.rewards.shape))
        return update(params, opt_state, exp, **kw)
    for name, n, online in (("controller", FLEET_N, True),
                            ("fixed", 2 * FLEET_N, False)):
        base = live_cuda_bytes()
        layout = plan_async(3, 2, 2, devices=list(range(6)),
                            devices_per_gpu=2, device=dev)
        runner = make_async_runner(
            make_env(ENV, megakernel=True, device=dev), layout, overlap=True,
            online_controller=online,
            controller_cfg=ControllerConfig(
                epoch_rounds=2, occ_low=0.0,
                num_env_sweep=(FLEET_N, 2 * FLEET_N)),
            num_envs=n, num_steps=T_MAIN, use_fused_kernels=True,
            device=dev)
        replan_ms = []
        if online:
            replan = runner.replan

            def timed_replan(decision, layout=None, replan=replan):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lay = replan(decision, layout)
                torch.cuda.synchronize()
                replan_ms.append((time.perf_counter() - t0) * 1e3)
                return lay

            runner.replan = timed_replan
        a3c.trainer_update = spy
        torch.cuda.synchronize()
        ops.reset_launches()
        collects = 0
        try:
            for _ in range(6):
                collects += len(runner.serving_gmis)
                runner.round()
            runner.finish()
            torch.cuda.synchronize()
        finally:
            a3c.trainer_update = update
        launches = dict(ops.LAUNCHES)
        held[name] = live_cuda_bytes() - base
        assert runner.trained_samples == runner.predictions
        want = {k: 0 for k in TOL}
        want.update({"env_mega_step": collects * T_MAIN,
                     "nstep_returns": runner.version})
        assert launches == want, (name, launches, want)
        out[name] = (launches, replan_ms, runner)
        del runner
    launches, replan_ms, runner = out["controller"]
    decisions = runner.controller.decisions
    assert runner.replans >= 1 and any("probe" in x.reason
                                       for x in decisions), decisions
    assert held["controller"] <= 1.1 * held["fixed"], held
    return launches, replan_ms, held, shapes, runner


# ---------------------------------------------------------- attention ----
def paged_inputs(B, H, KH, hd, P, M, qpos, gen, dev, dtype, holes=0.0,
                 unmapped=0.0):
    """A page pool of B * M + 1 pages (page 0 trash) with random contents
    everywhere, each row's virtual pages mapped to distinct physical pages
    up to its position ``qpos[b]`` (none for an idle row at -1), a share
    ``unmapped`` of them left unmapped and a share ``holes`` of mapped
    slots empty.  Mapped virtual page v holds positions [v*P, (v+1)*P) or
    -1, as the engine writes them."""
    N = B * M + 1
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((N, P, KH, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((N, P, KH, hd), generator=gen, device=dev).to(dtype)
    sp = torch.randint(-1, M * P, (N, P), generator=gen, device=dev,
                       dtype=torch.int32)
    sp[0] = -1
    table = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    perm = torch.randperm(N - 1, generator=gen, device=dev).to(torch.int32) + 1
    pos = torch.tensor(qpos, dtype=torch.int32, device=dev)
    for b, qp in enumerate(qpos):
        if qp < 0:
            continue
        n = qp // P + 1
        row = perm[b * M:b * M + n].clone()
        drop = torch.rand((n,), generator=gen, device=dev) < unmapped
        row[drop] = -1
        table[b, :n] = row
        for v in range(n):
            if row[v] >= 0:
                p = torch.arange(v * P, (v + 1) * P, dtype=torch.int32,
                                 device=dev)
                p[(p > qp) | (torch.rand((P,), generator=gen, device=dev)
                              < holes)] = -1
                sp[row[v]] = p
    return q, kp, vp, sp, table, pos


def check_paged(args, tol, **kw):
    from repro_torch.kernels import ops, ref
    got = ops.paged_attention(*args, **kw)
    want = ref.paged_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == args[0].dtype and bool(got.isfinite().all())
    idle = args[5] < 0
    assert bool((got[idle] == 0).all()), "idle row not exactly 0"
    return held(got, want, tol, "paged_attention")


def check_paged_in_turns(gen, dev):
    """Paged decode calls queued back to back with no sync between them, at
    B and split counts that differ (8 rows then 1 row then 4, bf16), and
    two calls of one shape on two streams at once: each output against its
    plain version.  The wrapper's tickets cross calls; this holds them."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_decode import num_splits
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [paged_inputs(B, 16, 8, 128, 8, 128, pos, gen, dev,
                          torch.bfloat16)
             for B, pos in ((8, DECODE_POS), (1, [958]),
                            (4, [574, -1, 7, 300]), (4, [300, 12, -1, 900]))]
    splits = [num_splits(a[0].shape[0], 8, 8, 128, sms) for a in cases]
    assert len(set(splits)) > 1, splits
    torch.cuda.synchronize()
    outs = [ops.paged_attention(*a) for a in cases[:3]]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        outs.append(ops.paged_attention(*cases[3]))
    outs.append(ops.paged_attention(*cases[2]))
    torch.cuda.synchronize()
    worst = 0.0
    for got, a in zip(outs, cases[:3] + [cases[3], cases[2]]):
        want = ref.paged_attention_ref(*a)
        assert bool((got[a[5] < 0] == 0).all()), "idle row not exactly 0"
        worst = max(worst, held(got, want, 0.0, "paged_attention")[1])
    return (f"[check] paged_attention in turns: B = 8, 1, 4 back to back "
            f"(splits {splits[:3]}), then B = 4 on a second stream beside B "
            f"= 4 on the first: {worst:.3g} of one bf16 ulp of each element "
            "(tol 1)")


def held(got, want, tol, name):
    """f32: max |got - want| <= tol; bf16: every element within one bf16
    ulp of its own magnitude.  Returns (max_abs_err, ulps or None)."""
    from repro_torch.utils import bf16_ulps
    err = max_err(got, want)
    if got.dtype == torch.float32:
        assert err <= tol, (name, got.dtype, err, tol)
        return err, None
    ulps = bf16_ulps(got, want)
    assert ulps <= 1.0, (name, got.dtype, err, f"{ulps:.3g} bf16 ulps")
    return err, ulps


def flash_inputs(B, S, H, KH, hd, gen, dev, dtype):
    return tuple(torch.randn((B, S, h, hd), generator=gen, device=dev)
                 .to(dtype) for h in (H, KH, KH))


def check_flash(args, tol, **kw):
    from repro_torch.kernels import ops, ref
    got = ops.flash_attention(*args, **kw)
    want = ref.attention_ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == args[0].dtype and bool(got.isfinite().all())
    return held(got, want, tol, "flash_attention")


def check_head_dims(gen, dev):
    """Both attention kernels at each of ``HEAD_DIMS``, in f32 (1e-4) and
    bf16 (one bf16 ulp of each element): flash causal at S = 77 (B = 2),
    bidirectional at S = 45 with a window and a softcap, and causal at
    S = 200 with window 37 (blocks skip whole key tiles); paged decode
    over 16-token pages with unmapped pages, empty slots and idle rows,
    without and with a window and softcap.  Returns one line a head dim."""
    lines = []
    for hd, H, KH in HEAD_DIMS:
        res = {}
        for dt, tol in ((torch.float32, TOL["flash_attention"]),
                        (torch.bfloat16, 0.0)):
            worst = 0.0
            for B, S, causal, kw in ((2, 77, True, {}),
                                     (1, 45, False, dict(window=19,
                                                         softcap=5.0)),
                                     (1, 200, True, dict(window=37))):
                e, u = check_flash(flash_inputs(B, S, H, KH, hd, gen, dev, dt),
                                   tol, causal=causal, **kw)
                worst = max(worst, e if u is None else u)
            res[f"flash {str(dt)[6:]}"] = worst
            worst = 0.0
            for kw in (dict(), dict(window=37, softcap=5.0)):
                a = paged_inputs(5, H, KH, hd, 16, 9, [130, -1, 17, 0, 143],
                                 gen, dev, dt, holes=0.2, unmapped=0.25)
                e, u = check_paged(a, TOL["paged_attention"], **kw)
                worst = max(worst, e if u is None else u)
            res[f"paged {str(dt)[6:]}"] = worst
        lines.append(
            f"[check] hd {hd} G {H // KH}: " + ", ".join(
                f"{k} {v:.3g}" for k, v in res.items())
            + " (f32 max_abs_err, tol 1e-4; bf16 in bf16 ulps of each "
            "element, tol 1; flash causal S=77, bidirectional S=45 window "
            "19 softcap 5, causal S=200 window 37; paged page 16, unmapped "
            "pages, empty slots, idle rows, without and with window 37 "
            "softcap 5)")
    return lines


# -------------------------------------------------------------- mLSTM ----
def mlstm_inputs(B, H, S, dh, zero, gen, dev, li_scale=1.0, lf_shift=2.0):
    """q, k, v ~ N(0, 1), log_i ~ N(0, li_scale^2), log_f =
    logsigmoid(N(lf_shift, 1)), and a zero or N(0, 1) (C0, n0, m0)."""
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    q, k, v = r(B, H, S, dh), r(B, H, S, dh), r(B, H, S, dh)
    li = r(B, H, S) * li_scale
    lf = torch.nn.functional.logsigmoid(r(B, H, S) + lf_shift)
    st = (r(B, H, dh, dh), r(B, H, dh), r(B, H))
    if zero:
        st = tuple(torch.zeros_like(t) for t in st)
    return (q, k, v, li, lf, *st)


def check_mlstm(args, chunk):
    """h and the final (C, n, m): finite, and each within TOL of the plain
    output's largest magnitude (at least 1).  Returns max |error|."""
    from repro_torch.kernels import ops, ref
    got = ops.mlstm_chunkwise(*args, chunk=chunk)
    want = ref.mlstm_chunkwise_ref(*args, chunk)
    torch.cuda.synchronize()
    err = 0.0
    for nm, g, w in zip(("h", "C", "n", "m"), got, want):
        assert g.shape == w.shape and bool(g.isfinite().all()), nm
        e = max_err(g, w)
        scale = max(1.0, float(w.abs().max()))
        assert e <= TOL["mlstm_chunkwise"] * scale, (nm, e, scale)
        err = max(err, e)
    return err


def mlstm_bound(B, H, S, dh, L):
    # q, k, v, h (B,H,S,dh), the gates (B,H,S), the state in and out;
    # per (b, h, chunk) what the function needs: the causal halves of
    # q k^T and scores v (L^2 dh each; the denominator's in-chunk part is
    # the score rows' sums), 2 L dh^2 each for q C^T and the C update,
    # and 2 L dh each for q . n and the n update
    bytes_ = 4 * (4 * B * H * S * dh + 2 * B * H * S
                  + 2 * (B * H * dh * dh + B * H * dh + B * H))
    ops_ = B * H * (S // L) * (2 * L * L * dh + 4 * L * dh * dh
                               + 4 * L * dh)
    return bytes_, ops_


# ------------------------------------------------------------ serving ----
def serve_stream(vocab, seed, head_len, n_long, long_len, n_short,
                 short_len, huge_len, gen_tokens):
    """The serving traffic: ``n_long`` prompts of ``long_len`` tokens that
    share a ``head_len``-token head, ``n_short`` prompts of ``short_len``
    and one of ``huge_len`` tokens, ``gen_tokens`` greedy tokens each."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, head_len)
    longs = [Request(tokens=np.concatenate(
        [head, rng.integers(0, vocab, long_len - head_len)]),
        max_new_tokens=gen_tokens) for _ in range(n_long)]
    shorts = [Request(tokens=rng.integers(0, vocab, short_len),
                      max_new_tokens=gen_tokens) for _ in range(n_short)]
    huge = Request(tokens=rng.integers(0, vocab, huge_len),
                   max_new_tokens=gen_tokens)
    return longs, shorts, huge


def drive_engine(eng, longs, shorts, huge):
    """Wave 1: the first long prompt, the short ones and the huge one;
    once the first long prompt has finished its (chunked) prefill and
    published its pages, wave 2: the other long prompts, which map the
    shared head and prefill only their tails.  Then drain."""
    done = []
    for r in [longs[0], *shorts, huge]:
        eng.submit(r)
    while True:
        done += eng.step()
        st = [s for s in eng._slots if s is not None and s.req is longs[0]]
        if not st or not st[0].prefilling:
            break
    for r in longs[1:]:
        eng.submit(r)
    return done + eng.run_until_idle()


def check_small_engine(dev):
    """A small f32 engine (reduced internlm2-1.8b: 2 layers, d = 256,
    hd 64, G = 2) with both kernels, chunked prefill and a shared head that
    ends inside a page (copy-on-write), on the card and on the CPU from the
    same params: greedy tokens identical, page tables equal."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine
    cfg = get_reduced(ARCH)
    params = T.init_model(0, cfg, "cpu")
    toks, tables = {}, {}
    for d in ("cpu", dev):
        eng = ServeEngine(cfg, params, max_slots=4, max_seq=96, device=d,
                          chunk_prefill=16)
        longs, shorts, huge = serve_stream(cfg.vocab_size, 1, 20, 3, 40, 2,
                                           12, 70, 12)
        ops.reset_launches()
        done = drive_engine(eng, longs, shorts, huge)
        assert len(done) == 6 and all(len(c.tokens) == 12 for c in done)
        toks[str(d)] = sorted((len(c.request.tokens), c.tokens)
                              for c in done)
        tables[str(d)] = eng._table.copy()
        launches = dict(ops.LAUNCHES)
    assert toks["cpu"] == toks[str(dev)], "card and CPU tokens differ"
    assert (tables["cpu"] == tables[str(dev)]).all()
    assert launches["paged_attention"] > 0 and \
        launches["flash_attention"] > 0, launches
    return launches


def check_small_xlstm_engine(dev):
    """A small f32 engine (reduced xlstm-1.3b: one mLSTM and one sLSTM
    block, d = 256, dh 64) with chunked prefill and more requests than
    slots, on the card and on the CPU from the same params: greedy tokens
    identical, page tables equal."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine
    cfg = get_reduced(XARCH)
    params = T.init_model(0, cfg, "cpu")
    toks, tables = {}, {}
    for d in ("cpu", dev):
        eng = ServeEngine(cfg, params, max_slots=4, max_seq=96, device=d,
                          chunk_prefill=16)
        longs, shorts, huge = serve_stream(cfg.vocab_size, 1, 20, 3, 40, 2,
                                           12, 64, 12)
        ops.reset_launches()
        done = drive_engine(eng, longs, shorts, huge)
        assert len(done) == 6 and all(len(c.tokens) == 12 for c in done)
        toks[str(d)] = sorted((len(c.request.tokens), c.tokens)
                              for c in done)
        tables[str(d)] = eng._table.copy()
        launches = dict(ops.LAUNCHES)
    assert toks["cpu"] == toks[str(dev)], "card and CPU tokens differ"
    assert (tables["cpu"] == tables[str(dev)]).all()
    assert launches["mlstm_chunkwise"] > 0, launches
    return launches


def serve_stats(eng, done, reqs, wall, setup_s, gen_tokens):
    tel = eng.telemetry
    assert len(done) == len(reqs) and all(
        c.status == "ok" and len(c.tokens) == gen_tokens for c in done)
    assert all(0 <= t < eng.cfg.vocab_size for c in done for t in c.tokens)
    gen = tel.total_tokens - len(reqs)
    return {
        "setup_s": setup_s, "wall_s": wall,
        "prompt_tokens": tel.total_prompt_tokens,
        "generated_tokens": tel.total_tokens,
        "prefill_tok_s": tel.total_prompt_tokens / tel.total_prefill_s,
        "decode_tok_s": gen / tel.total_decode_s,
        "decode_steps": tel.total_decode_steps,
        "decode_ms_per_step": 1e3 * tel.total_decode_s
        / tel.total_decode_steps,
        "prefill_dispatches": eng.prefill_dispatches,
        "end_to_end_tok_s": tel.total_tokens / wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated(eng.device) / 1e9}


def oracle_agreement(eng, done, reqs):
    """How many greedy tokens of each request match ``oracle_generate``
    (printed, not asserted: bf16 GEMMs at B = 1 and at the batch round
    differently), with the B = 1 path's top-2 logit margin at the first
    divergence: prefill the prompt, then decode the oracle's own tokens up
    to it through a dense cache."""
    from repro_torch.models import transformer as T
    by_rid = {c.rid: c.tokens for c in done}
    agree = []
    for r in reqs:
        orc = eng.oracle_generate(r)
        got = by_rid[r.rid]
        n = next((i for i, (a, b) in enumerate(zip(orc, got)) if a != b),
                 len(orc))
        margin = None
        if n < len(orc):
            lg, cache = T.prefill(eng.params, eng.cfg, {"tokens": torch.as_tensor(
                r.tokens[None], device=eng.device)}, eng.max_seq)
            for i in range(n):
                lg, cache = T.decode_step(
                    eng.params, eng.cfg, torch.tensor([orc[i]],
                                                      device=eng.device),
                    torch.tensor([len(r.tokens) + i], device=eng.device),
                    cache)
            top = torch.topk(lg[0].float(), 2).values
            margin = float(top[0] - top[1])
        agree.append({"prompt": len(r.tokens), "matching": n,
                      "of": len(orc), "top2_margin_at_divergence": margin})
    return agree


def run_xlstm(dev):
    """xlstm-1.3b at full width in bf16, random weights from seed 0: the
    phase-10 traffic through a paged ``ServeEngine``, with the launch
    counters set to 0 just before and read just after."""
    import numpy as np
    from repro_torch.configs import get_config, xlstm_1_3b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.telemetry import ServingTelemetry
    cfg = get_config(XARCH)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, T.init_model(0, cfg, dev), max_slots=8,
                      max_seq=1024, device=dev, chunk_prefill=512)
    # warm-up: cuBLAS handles and bf16 GEMM heuristics, one small request
    eng.serve([Request(tokens=list(range(1, 33)), max_new_tokens=3)])
    eng.telemetry = ServingTelemetry(eng.max_slots)
    eng.prefill_dispatches = 0
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=64) for n in (512,) * 4 + (128,) * 3
            + (768,)]
    # the prompts of at most chunk_prefill tokens prefill whole, batched by
    # length (two dispatches); the 768-token one in two chunks
    chunks = sum(-(-len(r.tokens) // eng.chunk_prefill) for r in reqs
                 if len(r.tokens) > eng.chunk_prefill)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    tel = eng.telemetry
    assert eng.prefill_dispatches == 2 and chunks == 2, (
        eng.prefill_dispatches, chunks)
    # one launch an mLSTM block per dispatch and per chunk, none in decode
    per_prefill = cfg.layer_kinds.count("mlstm")
    if cfg == xlstm_1_3b.FULL:
        assert per_prefill == 42, per_prefill     # 6 x 7 mLSTM blocks
    want = {k: 0 for k in TOL}
    want["mlstm_chunkwise"] = per_prefill * (eng.prefill_dispatches + chunks)
    assert launches == want, (launches, want)
    assert tel.total_decode_steps >= 63
    stats = serve_stats(eng, done, reqs, wall, setup_s, 64)
    stats["prefill_chunks"] = chunks
    stats["cache_gb"] = eng.cache_bytes / 1e9
    # a 128-token and the 768-token prompt
    stats["oracle"] = oracle_agreement(eng, done, [reqs[4], reqs[7]])
    return launches, stats


def run_serve(dev):
    """internlm2-1.8b at full width in bf16, random weights from seed 0:
    the phase-8 traffic through a paged ``ServeEngine``, with
    the launch counters set to 0 just before and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.telemetry import ServingTelemetry
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, T.init_model(0, cfg, dev), max_slots=8,
                      max_seq=1024, device=dev, chunk_prefill=256)
    # warm-up: cuBLAS handles and bf16 GEMM heuristics, one small request
    eng.serve([Request(tokens=list(range(1, 40)), max_new_tokens=3)])
    eng.telemetry = ServingTelemetry(eng.max_slots)
    eng.prefill_dispatches = 0
    setup_s = time.perf_counter() - t0
    longs, shorts, huge = serve_stream(cfg.vocab_size, 0, 256, 4, 512, 3,
                                       128, 896, 64)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = drive_engine(eng, longs, shorts, huge)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    tel = eng.telemetry
    L = cfg.num_layers
    want = {k: 0 for k in TOL}
    want["paged_attention"] = L * tel.total_decode_steps
    want["flash_attention"] = L * eng.prefill_dispatches
    assert launches == want, (launches, want)
    assert eng.prefill_dispatches >= 1 and tel.total_decode_steps >= 63
    reqs = longs + shorts + [huge]
    # the shared head's full pages are published in the prefix index
    assert eng.shared_head_pages(longs[1].tokens[:256]) == \
        256 // eng.page_size
    stats = serve_stats(eng, done, reqs, wall, setup_s, 64)
    # a short and the long chunked request
    stats["oracle"] = oracle_agreement(eng, done, [shorts[0], huge])
    return launches, stats, eng


def run_stablelm(dev):
    """stablelm-12b at full width in bf16 (d 5120, 32 q heads on 8 kv
    heads, hd 160), its depth cut to SLAYERS of 40 layers, random weights
    from seed 0: two 512-token and two 128-token prompts, 32 greedy tokens
    each, through a paged ``ServeEngine`` with whole-prompt prefill, the
    launch counters set to 0 just before and read just after."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.telemetry import ServingTelemetry
    full = get_config(SARCH)
    cfg = full.replace(num_layers=SLAYERS)
    assert cfg.resolved_head_dim == 160 and full.num_layers == 40
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, T.init_model(0, cfg, dev), max_slots=4,
                      max_seq=1024, device=dev, chunk_prefill=512)
    # warm-up: cuBLAS handles and bf16 GEMM heuristics, one small request
    eng.serve([Request(tokens=list(range(1, 40)), max_new_tokens=3)])
    eng.telemetry = ServingTelemetry(eng.max_slots)
    eng.prefill_dispatches = 0
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=32) for n in (512, 512, 128, 128)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    tel = eng.telemetry
    want = {k: 0 for k in TOL}
    want["paged_attention"] = SLAYERS * tel.total_decode_steps
    want["flash_attention"] = SLAYERS * eng.prefill_dispatches
    assert launches == want, (launches, want)
    assert eng.prefill_dispatches >= 1 and tel.total_decode_steps >= 31
    stats = {"layers": f"{SLAYERS} of {full.num_layers}",
             **serve_stats(eng, done, reqs, wall, setup_s, 32)}
    stats["oracle"] = oracle_agreement(eng, done, [reqs[0], reqs[2]])
    return launches, stats


# --------------------------------------------- disaggregated serving ----
def gmi_manager(dev, n=D_GMIS):
    """A MIG-like GMIManager on ``dev``: each GMI ``make_disagg_front``
    registers gets its own CUDA stream (none on the CPU)."""
    from repro_torch.core.gmi import GMIManager
    return GMIManager(devices=list(range(n)), devices_per_gpu=n,
                      backend="submesh", device=dev)


def pinned_planner(threshold):
    """A ``MigrationPlanner`` pinned so that a prompt of ``threshold``
    tokens or more migrates and a shorter one stays local: a bandwidth so
    high that bytes cost nothing, a fixed local prefill rate and a fixed
    per-transfer latency; measurements do not move it."""
    from repro_torch.serve import MigrationPlanner

    class Pinned(MigrationPlanner):
        @property
        def bandwidth(self):
            return self.static_bandwidth

        def observe_prefill(self, tokens, seconds):
            pass

    rate = 1e4
    return Pinned(bandwidth=1e15, latency_s=threshold / (1.05 * rate),
                  prefill_tok_s=rate)


def disagg_stream(vocab, seed, n_long, long_len, head_len, n_short,
                  short_len, gen_tokens):
    """The disaggregated traffic as two waves: wave 1 the first long prompt
    (which carries the shared head) and half the short ones; wave 2 the
    other long prompts (the second shares the head) and the other short
    ones.  A wave drains before the next starts, so the second sharing
    prompt is staged while the decode engine that spliced the first is
    the least loaded (the least-loaded engine takes each payload) and its
    prefix index still holds the head."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, head_len)
    longs = [Request(tokens=np.concatenate(
        [head, rng.integers(0, vocab, long_len - head_len)])
        if i < 2 else rng.integers(0, vocab, long_len),
        max_new_tokens=gen_tokens) for i in range(n_long)]
    shorts = [Request(tokens=rng.integers(0, vocab, short_len),
                      max_new_tokens=gen_tokens) for _ in range(n_short)]
    h = n_short // 2
    return [[longs[0], *shorts[:h]], [*longs[1:], *shorts[h:]]]


def record_sends(front, dev):
    """Wrap the front's channel ``send`` to log each payload's request,
    wire bytes and head pages, the host time of the call, and (on the
    card) CUDA events around the pack on the sending stream."""
    log = []
    send = front.channel.send

    def timed(item, tree, *, source=None):
        evs = None
        if dev.type == "cuda":
            s = torch.cuda.current_stream(dev)
            evs = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            evs[0].record(s)
        t0 = time.perf_counter()
        n = send(item, tree, source=source)
        host_ms = (time.perf_counter() - t0) * 1e3
        if evs:
            evs[1].record(s)
        log.append({"rid": item.req.rid, "prompt": item.prompt_tokens,
                    "head_pages": item.head_pages, "bytes": n, "evs": evs,
                    "host_ms": host_ms})
        return n

    front.channel.send = timed
    return log


def drive_front(front, waves):
    """Submit each wave (the planner routes each request as it arrives),
    step the front until idle, then the next wave.  Returns completions,
    each request's route, and its time to first token on the host clock
    (submit to the end of the front step in which it first holds a
    token)."""
    done, routes, t_sub, ttft = [], {}, {}, {}
    for wave in waves:
        for r in wave:
            before = front.planner.migrated
            t_sub[r.rid] = time.perf_counter()
            front.submit(r)
            routes[r.rid] = "migrated" if front.planner.migrated > before \
                else "local"
        while front.busy:
            done += front.step()
            now = time.perf_counter()
            for e in front.engines:
                for st in e._slots:
                    if st is not None and st.generated:
                        ttft.setdefault(st.req.rid, now - t_sub[st.req.rid])
            for c in done:
                ttft.setdefault(c.rid, now - t_sub[c.rid])
    return done, routes, ttft


def small_disagg(dev, params, cfg):
    """Phase 14 (a)'s front on ``dev``: reduced internlm2-1.8b in f32, 2
    decode GMIs x 4 slots and 1 prefill GMI, each on its own stream on the
    card, the planner pinned at D_SMALL_THRESHOLD tokens."""
    from repro_torch.launch.steps import make_disagg_front
    front = make_disagg_front(cfg, params, decode_engines=2, prefill_gmis=1,
                              max_slots=4, max_seq=96,
                              manager=gmi_manager(dev))
    front.planner = pinned_planner(D_SMALL_THRESHOLD)
    return front


def check_disagg_small(dev):
    """(a) The same disaggregated trace on the card and on the CPU from the
    same params: routes, payload bytes and head pages, prefix_pages_saved
    and greedy tokens equal.  Then ``make_fleet_supervisor(...,
    router=front)`` over a small A3C fleet (Ant, ``plan_async(3, 1, 2)``,
    8 envs a GMI, T = 4) with D_FLEET_EVENTS: failure and recovery logs
    equal on both sides, every request completed (tokens equal too)."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.placement import plan_async
    from repro_torch.envs import make_env
    from repro_torch.fault import FaultEvent, FaultPlan
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_fleet_supervisor
    from repro_torch.models import transformer as T
    cfg = get_reduced(ARCH)
    params = T.init_model(0, cfg, "cpu")
    out = {}
    for d in ("cpu", dev):
        d = torch.device(d)
        front = small_disagg(d, params, cfg)
        log = record_sends(front, d)
        waves = disagg_stream(cfg.vocab_size, 2, 4, 40, 16, 4, 12, 10)
        reqs = [r for w in waves for r in w]
        ops.reset_launches()
        done, routes, _ = drive_front(front, waves)
        idx = {r.rid: i for i, r in enumerate(reqs)}
        by_i = {idx[c.rid]: c for c in done}
        assert len(by_i) == len(reqs) and all(
            c.status == "ok" and len(c.tokens) == 10 for c in by_i.values())
        res = {
            "routes": [routes[r.rid] for r in reqs],
            "payloads": [(idx[p["rid"]], p["bytes"], p["head_pages"])
                         for p in log],
            "prefix_pages_saved": front.prefix_pages_saved,
            "tokens": [by_i[i].tokens for i in range(len(reqs))],
            "launches": dict(ops.LAUNCHES)}
        # the supervised fleet with the front as its router
        front = small_disagg(d, params, cfg)
        env = make_env("Ant", device=d)
        layout = plan_async(3, 1, 2, devices=list(range(6)),
                            devices_per_gpu=2, device=d)
        plan = FaultPlan([FaultEvent(k, round=r, target=t)
                          for k, r, t in D_FLEET_EVENTS])
        sup = make_fleet_supervisor(env, layout, plan=plan, router=front,
                                    num_envs=8, num_steps=4, device=d)
        waves = disagg_stream(cfg.vocab_size, 3, 4, 40, 16, 4, 12, 10)
        reqs = [r for w in waves for r in w]
        for r in reqs:
            front.submit(r)
        for _ in range(D_FLEET_ROUNDS):
            sup.round()
        done = list(front.completions) + sup.drain_serving()
        sup.runner.finish()
        idx = {r.rid: i for i, r in enumerate(reqs)}
        by_i = {idx[c.rid]: c for c in done}
        assert len(by_i) == len(reqs) and all(
            c.status == "ok" and len(c.tokens) == 10 for c in by_i.values())
        r = sup.runner
        assert r.trained_samples + r.poisoned_samples == r.predictions
        res["fleet"] = {"failures": sup.failures,
                        "recoveries": sup.recoveries,
                        "tokens": [by_i[i].tokens for i in range(len(reqs))],
                        "engines": front.num_engines,
                        "prefill_engines": len(front.prefill_engines)}
        out[str(d)] = res
    cpu, card = out["cpu"], out[str(dev)]
    for k in ("routes", "payloads", "prefix_pages_saved", "tokens",
              "fleet"):
        assert card[k] == cpu[k], (k, card[k], cpu[k])
    assert "migrated" in cpu["routes"] and "local" in cpu["routes"]
    assert cpu["prefix_pages_saved"] > 0
    kinds = [f["kind"] for f in cpu["fleet"]["failures"]]
    assert sorted(kinds) == sorted(k for k, _, _ in D_FLEET_EVENTS), kinds
    la = card["launches"]
    assert la["flash_attention"] > 0 and la["paged_attention"] > 0, la
    return card, la


def run_disagg(dev):
    """(b) internlm2-1.8b at full width in bf16, random weights from seed
    0: 2 decode GMIs x 8 slots and 1 prefill GMI, each on its own CUDA
    stream, one copy of the parameters, ``max_seq`` 1024, 8-token pages;
    the D_LONG/D_SHORT traffic with the planner pinned at D_THRESHOLD
    tokens, the launch counters set to 0 just before and read just after.
    Then the same trace through a planner that prices with this run's
    measured pack bandwidth and prefill rate (its decisions printed)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_disagg_front
    from repro_torch.models import transformer as T
    from repro_torch.serve import MigrationPlanner, Request
    from repro_torch.serve.telemetry import ServingTelemetry
    from repro_torch.utils import tree_leaves
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    manager = gmi_manager(dev)
    params = T.init_model(0, cfg, dev)
    front = make_disagg_front(cfg, params, decode_engines=D_DECODE,
                              prefill_gmis=D_PREFILL, max_slots=D_SLOTS,
                              max_seq=1024, manager=manager)
    del params
    front.planner = pinned_planner(D_THRESHOLD)
    engines = list(front.engines)
    pf = front.prefill_engines[0]
    # one copy of the parameters: every engine holds the same tensors
    ptrs = {id(e): [t.data_ptr() for t in tree_leaves(e.params)]
            for e in engines + [pf]}
    assert len({tuple(v) for v in ptrs.values()}) == 1
    if dev.type == "cuda":
        streams = {e.stream for e in engines + [pf]}
        assert None not in streams and len(streams) == D_DECODE + D_PREFILL
    # warm-up: cuBLAS handles and bf16 GEMM heuristics on every stream,
    # both routes
    rng = torch.Generator().manual_seed(1)
    warm = [Request(tokens=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=rng).numpy(),
                    max_new_tokens=3) for n in (40, 40, D_THRESHOLD + 8)]
    drive_front(front, [warm])
    for e in engines:
        e.telemetry = ServingTelemetry(e.max_slots)
        e.prefill_dispatches = 0
    pf.prefill_dispatches = 0
    pf.take_epoch()
    front.take_epoch()
    saved0 = front.prefix_pages_saved
    setup_s = time.perf_counter() - t0
    waves = disagg_stream(cfg.vocab_size, 0, 4, D_LONG, D_HEAD, 4, D_SHORT,
                          D_GEN)
    reqs = [r for w in waves for r in w]
    log = record_sends(front, dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done, routes, ttft = drive_front(front, waves)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    L = cfg.num_layers
    steps = sum(e.telemetry.total_decode_steps for e in engines)
    dispatches = sum(e.prefill_dispatches for e in engines)
    want = {k: 0 for k in TOL}
    want["paged_attention"] = L * steps
    want["flash_attention"] = L * (dispatches + pf.prefill_dispatches)
    assert launches == want, (launches, want)
    assert engines == list(front.engines), "a decode engine was lost"
    want_routes = ["migrated" if len(r.tokens) >= D_THRESHOLD else "local"
                   for r in reqs]
    assert [routes[r.rid] for r in reqs] == want_routes
    assert pf.prefill_dispatches == want_routes.count("migrated")
    assert len(done) == len(reqs) and all(
        c.status == "ok" and len(c.tokens) == D_GEN for c in done)
    assert all(0 <= t < cfg.vocab_size for c in done for t in c.tokens)
    # each payload ships its prompt's whole pages less the skipped head:
    # k and v (bf16) and the slot positions (int32) of every layer
    P = engines[0].page_size
    page_bytes = L * P * (2 * cfg.num_kv_heads * cfg.resolved_head_dim
                          * T.torch_dtype(cfg).itemsize + 4)
    for p in log:
        shipped = -(-p["prompt"] // P) - p["head_pages"]
        assert p["bytes"] == shipped * page_bytes, (p, page_bytes)
    heads = [p["head_pages"] for p in log]
    assert heads == [0, D_HEAD // P, 0, 0], heads
    assert front.prefix_pages_saved - saved0 == D_HEAD // P
    pack_ms = [p["evs"][0].elapsed_time(p["evs"][1]) if p["evs"]
               else p["host_ms"] for p in log]
    pack_gbs = [p["bytes"] / (ms * 1e6) for p, ms in zip(log, pack_ms)]
    tel = [e.telemetry for e in engines]
    # each request's first token is counted at its admission
    gen = sum(t.total_tokens for t in tel) - len(reqs)
    decode_s = sum(t.total_decode_s for t in tel)
    pf_s, pf_n, pf_toks = pf.take_epoch()
    by_route = {k: sorted(ttft[r.rid] * 1e3 for r in reqs
                          if routes[r.rid] == k)
                for k in ("migrated", "local")}
    stats = {
        "setup_s": setup_s, "wall_s": wall,
        "payload_mb": [p["bytes"] / 1e6 for p in log],
        "head_pages": heads, "page_bytes": page_bytes,
        "prefix_pages_saved": front.prefix_pages_saved - saved0,
        "pack_ms": pack_ms, "pack_gb_s": pack_gbs,
        "ttft_ms": by_route,
        "prefill_gmi_tok_s": pf_toks / pf_s,
        "decode_steps": steps, "decode_tok_s": gen / decode_s,
        "end_to_end_tok_s": sum(len(c.tokens) for c in done) / wall,
        "decode_prefill_dispatches": dispatches,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    # oracle agreement (printed, as in phase 8): a migrated and a local
    # request against the decode engine's B = 1 path
    by_rid = {c.rid: c.tokens for c in done}
    agree = []
    for r in (reqs[0], reqs[1]):
        orc = engines[0].oracle_generate(r)
        got = by_rid[r.rid]
        n = next((i for i, (a, b) in enumerate(zip(orc, got)) if a != b),
                 len(orc))
        agree.append({"prompt": len(r.tokens), "route": routes[r.rid],
                      "matching": n, "of": len(orc)})
    stats["oracle"] = agree
    # the measured planner: this run's pack bandwidth and prefill rate
    mp = MigrationPlanner()
    for p, ms in zip(log, pack_ms):
        mp.observe_transfer(ms / 1e3, p["bytes"])
    mp.observe_prefill(pf_toks, pf_s)
    front.planner = mp
    again = [[Request(tokens=r.tokens, max_new_tokens=D_GEN)
              for r in reqs]]
    done2, routes2, _ = drive_front(front, again)
    assert len(done2) == len(reqs) and all(
        c.status == "ok" and len(c.tokens) == D_GEN for c in done2)
    measured = {"bandwidth_gb_s": mp.bandwidth / 1e9,
                "prefill_tok_s": mp.prefill_tok_s,
                "latency_s": mp.latency_s,
                "routes": [(len(r.tokens), routes2[r.rid])
                           for r in again[0]],
                "migrated": mp.migrated, "kept_local": mp.kept_local}
    return launches, stats, measured


def run_disagg_arbiter(dev):
    """(c) The single arbiter: ``make_async_runner(..., router=front,
    online_controller=True)`` over an A3C fleet (Ant, ``plan_async(3, 1,
    1)``, 64 envs a GMI, T = 8, fused kernels) with phase (a)'s small
    front (1 decode GMI x 2 slots, 1 prefill GMI), D_ARBITER_ROUNDS rounds
    with traffic outrunning the decode slots between them, the launch
    counters set to 0 just before and read just after.  At least one
    serving decision is applied (the front grows), and every request
    completes."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.placement import plan_async
    from repro_torch.envs import make_env
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_async_runner, make_disagg_front
    from repro_torch.models import transformer as T
    import numpy as np
    from repro_torch.serve import Request
    cfg = get_reduced(ARCH)
    front = make_disagg_front(cfg, T.init_model(0, cfg, dev),
                              decode_engines=1, prefill_gmis=1, max_slots=2,
                              max_seq=96, manager=gmi_manager(dev))
    front.planner = pinned_planner(D_SMALL_THRESHOLD)
    layout = plan_async(3, 1, 1, devices=list(range(3)), devices_per_gpu=1,
                        device=dev)
    runner = make_async_runner(
        make_env("Ant", device=dev), layout, online_controller=True,
        router=front, num_envs=64, num_steps=8, use_fused_kernels=True,
        device=dev, controller_cfg=ControllerConfig(epoch_rounds=1,
                                                    probe=False))
    rng = np.random.default_rng(4)
    reqs, sizes = [], []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launches()
    for _ in range(D_ARBITER_ROUNDS):
        for n in (40, 12, 12, 12, 40, 12):
            reqs.append(Request(tokens=rng.integers(0, cfg.vocab_size, n),
                                max_new_tokens=8))
            front.submit(reqs[-1])
        front.step()
        front.step()
        runner.round()
        sizes.append((front.num_engines, len(front.prefill_engines)))
    done = list(front.completions) + front.drain()
    runner.finish()
    launches = dict(ops.LAUNCHES)
    ctl = runner.controller
    serving = [d for d in ctl.decisions if "serving" in d.reason
               or "prefill" in d.reason]
    assert serving, ctl.summary()
    assert max(n for n, _ in sizes) > 1 or max(p for _, p in sizes) > 1, \
        sizes
    assert {c.rid for c in done} == {r.rid for r in reqs}
    assert all(c.status == "ok" and len(c.tokens) == 8 for c in done)
    assert runner.trained_samples == runner.predictions
    for k in ("flash_attention", "paged_attention", "nstep_returns",
              "pack_channels"):
        assert launches[k] > 0, launches
    return launches, sizes, serving, runner


# ------------------------------------------------- multi-agent PPO ----
def check_multi_agent_small(dev):
    """Phase 15 (a): one fused PPO iteration over the 4-agent Ant (8
    worlds, 32 agents, T = 4, world 2 at its episode cap so its agents
    reset on the first step) on the card against the plain path on the
    CPU, from the same params, env state, noise and permutations: env
    bookkeeping (t, seed, resets) and the episode-done fraction exact,
    every world's agents done together, params within 1e-5 after an
    update that moved some param by more than 1e-4."""
    from repro_torch.envs import make_multi_agent_env
    from repro_torch.kernels import ops
    from repro_torch.models.policy import init_policy
    from repro_torch.rl.ppo import PPOConfig, train_iteration
    from repro_torch.optim import adam_init
    from repro_torch.utils import tree_leaves, tree_map
    cfg = PPOConfig(num_steps=MA_SMALL_T, num_epochs=2, num_minibatches=2,
                    use_fused_kernels=True)
    K, W = MA_AGENTS, MA_SMALL_WORLDS
    n = K * W
    cpu_env = make_multi_agent_env("Ant", K, device="cpu")
    dims = cpu_env.spec.policy_dims
    g = torch.Generator("cpu").manual_seed(3)
    p = init_policy(g, dims)
    o = adam_init(p)
    es, ob = cpu_env.reset(g, n)
    es = es._replace(t=es.t.index_fill(
        0, torch.tensor([2]), cpu_env.spec.max_episode_len - 1))
    ob = cpu_env._obs(es)
    noise = torch.randn((cfg.num_steps, n, dims[-1]), generator=g)
    perms = torch.stack([torch.randperm(cfg.num_steps * n, generator=g)
                         for _ in range(cfg.num_epochs)])
    p0 = [t.clone() for t in tree_leaves(p)]
    out, launches = {}, None
    for d in ("cpu", dev):
        env = make_multi_agent_env("Ant", K, device=d)
        mv = lambda x: tree_map(lambda t: t.to(d), x)
        ops.reset_launches()
        res = train_iteration(mv(p), mv(o), env, mv(es), ob.to(d), None, cfg,
                              noise=noise.to(d), perms=perms.to(d))
        launches = dict(ops.LAUNCHES)
        out[str(d)] = tree_map(lambda t: t.cpu(), (res[0], res[2], res[5]))
    (pc, sc, mc), (pg, sg, mg) = out["cpu"], out[str(dev)]
    for f in ("t", "seed", "resets"):
        assert torch.equal(getattr(sc, f), getattr(sg, f)), f
    assert int(sc.resets[2]) == 1
    assert float(mc["episode_done_frac"]) == float(mg["episode_done_frac"])
    assert float(mc["episode_done_frac"]) == 1 / (W * cfg.num_steps)
    moved = max(max_err(a, b) for a, b in zip(tree_leaves(pc), p0))
    assert moved > 1e-4, ("no update on the CPU", moved)
    perr = max(max_err(a, b) for a, b in zip(tree_leaves(pc),
                                             tree_leaves(pg)))
    assert perr <= 1e-5, ("params card vs CPU", perr)
    want = {k: 0 for k in TOL}
    want.update({"policy_mlp": cfg.num_steps + 1, "gae_norm": 1})
    assert launches == want, (launches, want)
    return perr, moved, launches


def ppo_rate(env, n, iters=MA_ITERS, count=False):
    """``iters`` fused PPO iterations of ``n`` envs (T = T_MAIN) on the
    card: (launches or None, per-iteration s, env steps/s over iterations
    2 onwards); with ``count`` the launch counters are set to 0 just
    before and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.rl.ppo import PPOConfig, init_train, make_train_step
    from repro_torch.utils import tree_leaves
    cfg = PPOConfig(num_steps=T_MAIN, use_fused_kernels=True)
    dev = env.device
    state = list(init_train(0, env, env.spec.policy_dims, n, device=dev))
    step = make_train_step(env, cfg)
    torch.cuda.synchronize()
    if count:
        ops.reset_launches()
    it_s = []
    for _ in range(iters):
        t0 = time.perf_counter()
        *state, metrics = step(*state)
        torch.cuda.synchronize()
        it_s.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES) if count else None
    assert all(bool(t.isfinite().all()) for t in tree_leaves(state[0]))
    assert all(v == v for v in map(float, metrics.values())), metrics
    return launches, it_s, (iters - 1) * T_MAIN * n / sum(it_s[1:])


def run_multi_agent(dev):
    """Phase 15 (b): fused PPO over the 4-agent Ant at full width, 16,384
    agents (4,096 worlds of 32 joints), T = 16, 3 iterations, with the
    launch counters set to 0 just before and read just after: the trunk
    T + 1 times an iteration, GAE once, no env-step kernel (the family
    runs the plain step).  Then 16,384 single-agent Ant envs the same way
    (plain step) and on the env megakernel, for their env steps/s."""
    from repro_torch.envs import make_env, make_multi_agent_env
    env = make_multi_agent_env("Ant", MA_AGENTS, device=dev)
    launches, it_s, rate = ppo_rate(env, N_MAIN, count=True)
    want = {k: 0 for k in TOL}
    want.update({"policy_mlp": (T_MAIN + 1) * MA_ITERS,
                 "gae_norm": MA_ITERS})
    assert launches == want, (launches, want)
    _, s1, r1 = ppo_rate(make_env("Ant", device=dev), N_MAIN)
    _, s2, r2 = ppo_rate(make_env("Ant", megakernel=True, device=dev),
                         N_MAIN)
    return launches, {"multi_agent": (it_s, rate), "single_plain": (s1, r1),
                      "single_megakernel": (s2, r2)}


# ------------------------------------------------------- MoE serving ----
def check_moe_small(dev):
    """Phase 16, first: ``moe_apply`` in f32 on the card against the CPU at
    a capacity factor that drops assignments (B = 3, S = 64, d 64, 8
    experts top-2, factor 0.5, and 16-token routing blocks): routing
    slots and validity exact, out within 1e-5."""
    from repro_torch.models import moe
    g = torch.Generator("cpu").manual_seed(5)
    p = moe.init_moe(g, 64, 96, 8)
    x = torch.randn((3, 64, 64), generator=g)
    err, dropped = 0.0, 0
    for rb in (0, 16):
        res = {}
        for d in ("cpu", dev):
            pd = {k: v.to(d) for k, v in p.items()}
            xd = x.to(d)
            logits = xd @ pd["router"]
            slot, _, valid = moe._route(logits, 2, 8, 8)
            out, aux = moe.moe_apply(pd, xd, num_experts=8, top_k=2,
                                     capacity_factor=0.5, route_block=rb)
            res[str(d)] = (slot.cpu(), valid.cpu(), out.cpu(), aux.cpu())
        (s0, v0, o0, a0), (s1, v1, o1, a1) = res["cpu"], res[str(dev)]
        assert torch.equal(s0, s1) and torch.equal(v0, v1)
        err = max(err, max_err(o0, o1), float((a0 - a1).abs()))
        dropped = int((~v0).sum())
    assert dropped > 0 and err <= 1e-5, (dropped, err)
    return err, dropped


def drop_share(eng, prompts):
    """The share of expert assignments dropped by capacity when each group
    of same-length prompts is prefilled as the engine dispatches it, in
    all and by layer (summed over the groups): ``moe._route`` wrapped to
    count, outside any counted run."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    seen = []
    route = moe._route

    def counting(*a, **kw):
        out = route(*a, **kw)
        seen.append((int(out[2].sum()), out[2].numel()))
        return out
    moe._route = counting
    try:
        for toks in prompts:
            T.prefill(eng.params, eng.cfg, {"tokens": torch.as_tensor(
                toks, device=eng.device)}, eng.max_seq)
    finally:
        moe._route = route
    kept, total = map(sum, zip(*seen))
    L = eng.cfg.num_layers
    by_layer = [1.0 - sum(k for k, _ in seen[i::L]) / sum(
        t for _, t in seen[i::L]) for i in range(L)]
    return 1.0 - kept / total, by_layer


def run_moe(dev):
    """granite-moe-1b-a400m at full width in bf16 (24 layers, d 1024, 16 q
    on 8 kv heads, hd 64, 32 experts top-8, vocab 49,155), random weights
    from seed 0: four 512-token and four 128-token prompts, 64 greedy
    tokens each, through a paged ``ServeEngine`` of 8 slots with
    whole-prompt prefill (``moe_route_block`` is 0, so no chunking), the
    launch counters set to 0 just before and read just after."""
    import numpy as np
    from repro_torch.configs import get_config, granite_moe_1b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.telemetry import ServingTelemetry
    cfg = get_config(MARCH)
    assert cfg.moe_route_block == 0 and cfg.dtype == "bfloat16"
    if cfg == granite_moe_1b.FULL:
        assert (cfg.num_layers, cfg.d_model, cfg.num_experts,
                cfg.experts_per_token, cfg.resolved_head_dim) == \
            (24, 1024, 32, 8, 64)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, T.init_model(0, cfg, dev), max_slots=8,
                      max_seq=1024, device=dev)
    eng.serve([Request(tokens=list(range(1, 40)), max_new_tokens=3)])
    eng.telemetry = ServingTelemetry(eng.max_slots)
    eng.prefill_dispatches = 0
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=M_GEN) for n in M_PROMPTS]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    tel = eng.telemetry
    L = cfg.num_layers
    want = {k: 0 for k in TOL}
    want["paged_attention"] = L * tel.total_decode_steps
    want["flash_attention"] = L * eng.prefill_dispatches
    assert launches == want, (launches, want)
    assert eng.prefill_dispatches == 2 and tel.total_decode_steps >= 63
    stats = serve_stats(eng, done, reqs, wall, setup_s, M_GEN)
    groups = sorted({len(r.tokens) for r in reqs})
    stats["prefill_drop_share"], stats["prefill_drop_share_by_layer"] = \
        drop_share(
        eng, [np.stack([r.tokens for r in reqs if len(r.tokens) == n])
              for n in groups])
    stats["oracle"] = oracle_agreement(eng, done, [reqs[0], reqs[4]])
    return launches, stats


# -------------------------------------------------- zamba2 serving ----
def check_zamba2_small(dev):
    """Phase 17, first: a small f32 hybrid engine (reduced zamba2: one
    Mamba2 block and the shared attention block, d = 256, hd 64) on the
    card and on the CPU from the same params, chunked (16-token chunks,
    a 48-token prompt among shorter ones) and whole-prompt: greedy tokens
    identical, page tables equal, every slot's Mamba2 state within 1e-4
    at the end."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine
    cfg = get_reduced(ZARCH)
    params = T.init_model(0, cfg, "cpu")
    worst, launches = 0.0, {}
    for chunk in (16, 0):
        toks, states = {}, {}
        for d in ("cpu", dev):
            eng = ServeEngine(cfg, params, max_slots=3, max_seq=96, device=d,
                              chunk_prefill=chunk)
            rng = np.random.default_rng(2)
            reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, n),
                            max_new_tokens=10) for n in (48, 12, 20, 48, 7)]
            ops.reset_launches()
            done = eng.serve(reqs)
            if d != "cpu":
                launches[chunk] = dict(ops.LAUNCHES)
            assert len(done) == 5 and all(len(c.tokens) == 10 for c in done)
            toks[str(d)] = sorted((len(c.request.tokens), c.tokens)
                                  for c in done)
            states[str(d)] = ([t.cpu() for t in eng._caches["mamba2_0"]],
                              eng._table.copy())
        assert toks["cpu"] == toks[str(dev)], ("tokens differ", chunk)
        (sc, tc), (sg, tg) = states["cpu"], states[str(dev)]
        assert (tc == tg).all()
        worst = max(worst, max(max_err(a, b) for a, b in zip(sc, sg)))
    assert worst <= 1e-4, worst
    assert launches[0]["flash_attention"] > 0 and \
        launches[16]["paged_attention"] > 0, launches
    return worst, launches


def run_zamba2(dev):
    """zamba2-7b at full width in bf16 (d 3584, 32 heads on 32, hd 112,
    N 64, vocab 32,000; ``Z_SUPER`` of 9 super-blocks of 8 Mamba2 + the
    shared attention block), random weights from seed 0: two 512-token and
    two 256-token prompts, 32 greedy tokens each, through a paged
    ``ServeEngine`` of 4 slots with whole-prompt prefill, the launch
    counters set to 0 just before and read just after."""
    import numpy as np
    from repro_torch.configs import get_config, zamba2_7b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.telemetry import ServingTelemetry
    full = get_config(ZARCH)
    cfg = full.replace(num_super=Z_SUPER,
                       num_layers=Z_SUPER * len(full.block_pattern))
    assert full.dtype == "bfloat16"
    if full == zamba2_7b.FULL:
        assert (full.d_model, full.resolved_head_dim, full.num_heads,
                full.num_kv_heads, full.ssm_state_dim, full.num_super) == \
            (3584, 112, 32, 32, 64, 9)
    t0 = time.perf_counter()
    params = T.init_model(0, cfg, dev)
    eng = ServeEngine(cfg, params, max_slots=4, max_seq=1024, device=dev)
    del params
    eng.serve([Request(tokens=list(range(1, 33)), max_new_tokens=3)])
    eng.telemetry = ServingTelemetry(eng.max_slots)
    eng.prefill_dispatches = 0
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=Z_GEN) for n in Z_PROMPTS]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    tel = eng.telemetry
    shared = cfg.layer_kinds.count("attn_shared")
    want = {k: 0 for k in TOL}
    want["paged_attention"] = shared * tel.total_decode_steps
    want["flash_attention"] = shared * eng.prefill_dispatches
    assert launches == want, (launches, want)
    assert eng.prefill_dispatches == 2 and tel.total_decode_steps >= 31
    stats = serve_stats(eng, done, reqs, wall, setup_s, Z_GEN)
    stats["super_blocks"] = f"{Z_SUPER} of {full.num_super}"
    stats["layer_applications"] = len(cfg.layer_kinds)
    stats["cache_gb"] = eng.cache_bytes / 1e9
    stats["oracle"] = oracle_agreement(eng, done, [reqs[0], reqs[2]])
    return launches, stats


# ------------------------------------------------- LM training (18, 19) ----
def check_kernel_grads(gen, dev):
    """Phase 2: the autograd Functions around the two training kernels, in
    f32 on the card.  Each forward is the kernel (held against its plain
    version to 1e-4, each output relative to its largest magnitude for the
    mLSTM); the gradients of every input (flash: q, k, v at internlm2's
    causal heads and hubert's bidirectional hd 80, the latter with a
    window and softcap too; mLSTM: q, k, v, both gates and the initial
    state) against autograd of the plain version on the same inputs,
    within 1e-4 of each leaf's largest magnitude.  Returns (worst flash,
    worst mLSTM) relative gradient error."""
    from repro_torch.kernels import ops, ref

    def compare(kernel, plain, args, weights):
        got = [a.clone().requires_grad_() for a in args]
        want = [a.clone().requires_grad_() for a in args]
        outs_k, outs_p = kernel(*got), plain(*want)
        if isinstance(outs_k, torch.Tensor):
            outs_k, outs_p = (outs_k,), (outs_p,)
        for o, w in zip(outs_k, outs_p):
            o, w = o.detach(), w.detach()
            scale = max(1.0, float(w.abs().max()))
            assert max_err(o, w) <= 1e-4 * scale, ("forward", max_err(o, w))
        sum(((o * w).sum() for o, w in zip(outs_k, weights)),
            torch.zeros((), device=dev)).backward()
        sum(((o * w).sum() for o, w in zip(outs_p, weights)),
            torch.zeros((), device=dev)).backward()
        worst = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.grad is not None and bool(a.grad.isfinite().all()), i
            scale = float(b.grad.abs().max())
            assert scale > 0, ("plain gradient is zero", i)
            rel = max_err(a.grad, b.grad) / scale
            assert rel <= 1e-4, ("gradient", i, rel)
            worst = max(worst, rel)
        return worst

    f32 = torch.float32
    wf = 0.0
    for (B, S, H, KH, hd), kw in (((2, 256, 16, 8, 128), dict(causal=True)),
                                  ((4, 128, 16, 16, 80), dict(causal=False)),
                                  ((2, 96, 16, 16, 80),
                                   dict(causal=False, window=37,
                                        softcap=5.0))):
        args = flash_inputs(B, S, H, KH, hd, gen, dev, f32)
        w = torch.randn(args[0].shape, generator=gen, device=dev)
        wf = max(wf, compare(lambda *a: ops.flash_attention(*a, **kw),
                             lambda *a: ref.attention_ref(*a, **kw), args,
                             (w,)))
    B, H, S, dh = 2, 4, 64, 128
    args = mlstm_inputs(B, H, S, dh, False, gen, dev)
    ws = [torch.randn(t.shape, generator=gen, device=dev)
          for t in (args[0], args[5], args[6], args[7])]
    wm = compare(lambda *a: ops.mlstm_chunkwise(*a, chunk=32),
                 lambda *a: ref.mlstm_chunkwise_ref(*a, 32), args, ws)
    return wf, wm


def lm_value_and_grad(cfg, params, batch, remat=False):
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree_flatten, tree_unflatten
    flat, spec = tree_flatten(params)
    xs = [x.detach().clone().requires_grad_() for x in flat]
    loss = T.loss_fn(tree_unflatten(xs, spec), cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), grads


def check_lm_small(dev):
    """Phase 18 (a), C12's gate: reduced internlm2-1.8b, xlstm-1.3b,
    hubert-xlarge and pixtral-12b in f32 from the same params and batch,
    ``loss_fn`` and its gradient on the card (the attention and mLSTM
    forwards through their kernels, the backward through the plain math)
    against the CPU: loss within 1e-5, every gradient leaf within 1e-4 of
    the CPU leaf's largest magnitude (a leaf left zero on the card fails);
    then one ``make_train_step`` with ``microbatches=2`` (internlm2): loss
    1e-5 and Adam's first moment (the clipped gradient) 1e-4 of each
    leaf's largest.  Launch counters set to 0 before the card's runs and
    read after.  Returns (rows, launches)."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import InputShape, TrainConfig
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam_init
    from repro_torch.utils import tree_leaves, tree_map
    rows, launches = [], {k: 0 for k in TOL}
    shape = InputShape("t", 64, 2, "train")

    def on(tree, d):
        return tree_map(lambda t: t.to(d), tree)

    for arch in LM_SMALL:
        cfg = get_reduced(arch)
        params = T.init_model(0, cfg, "cpu")
        batch = {k: torch.as_tensor(v)
                 for k, v in make_batch(cfg, shape, seed=1).items()}
        lc, gc = lm_value_and_grad(cfg, params, batch)
        torch.cuda.synchronize()
        ops.reset_launches()
        lg, gg = lm_value_and_grad(cfg, on(params, dev), on(batch, dev))
        torch.cuda.synchronize()
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        assert abs(lg - lc) <= 1e-5, (arch, lg, lc)
        worst = 0.0
        for i, (a, b) in enumerate(zip(gg, gc)):
            scale = float(b.abs().max())
            rel = max_err(a.cpu(), b) / scale if scale > 0 else \
                float(a.abs().max())
            assert rel <= 1e-4, (arch, "gradient leaf", i, rel, scale)
            worst = max(worst, rel)
        rows.append({"arch": arch, "loss_card": lg, "loss_cpu": lc,
                     "worst_grad_rel": worst, "leaves": len(gc)})
    cfg = get_reduced(LM_SMALL[0])
    tc = TrainConfig(microbatches=2, remat=True, learning_rate=1e-3)
    step, _ = make_train_step(cfg, train_cfg=tc)
    params = T.init_model(0, cfg, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in make_batch(
        cfg, InputShape("t", 64, 4, "train"), seed=2).items()}
    out = {}
    for d in ("cpu", dev):
        ops.reset_launches()
        p, o, m = step(on(params, d), adam_init(on(params, d)),
                       on(batch, d))
        if d != "cpu":
            torch.cuda.synchronize()
            for k, v in ops.LAUNCHES.items():
                launches[k] += v
        out[str(d)] = (float(m["loss"]), [t.cpu() for t in
                                          tree_leaves(o.mu)])
    (lc, mc), (lg, mg) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 1e-5, ("train step", lg, lc)
    worst = max(max_err(a, b) / float(b.abs().max()) for a, b in zip(mg, mc)
                if float(b.abs().max()) > 0)
    assert worst <= 1e-4, ("train step mu", worst)
    rows.append({"arch": f"{LM_SMALL[0]} make_train_step microbatches=2 "
                         "remat", "loss_card": lg, "loss_cpu": lc,
                 "worst_mu_rel": worst})
    # 2 attention layers an arch (3 archs) plus, with remat, the layer
    # recomputes of the 2 microbatches; xlstm's one mLSTM block
    assert launches["flash_attention"] == 3 * 2 + 2 * 2 * 2, launches
    assert launches["mlstm_chunkwise"] == 1, launches
    return rows, launches


def run_lm(dev, arch, batch, seq, steps):
    """Phases 18 (b) and (c): ``launch/train.py --workload lm --full`` at
    ``arch``'s published width and depth (random weights from seed 0, f32
    master params and Adam state, the config's bf16 compute, no remat) for
    ``steps`` steps of ``batch`` x ``seq`` tokens, the launch counters set
    to 0 just before and read just after: one flash launch per layer per
    step, nothing else.  Returns (launches, stats)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.utils import tree_leaves
    cfg = get_config(arch)
    assert cfg.dtype == "bfloat16"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    out = train.main(["--workload", "lm", "--arch", arch, "--full",
                      "--steps", str(steps), "--batch", str(batch),
                      "--seq", str(seq), "--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    want = {k: 0 for k in TOL}
    want["flash_attention"] = cfg.num_layers * steps
    assert launches == want, (launches, want)
    losses, step_s = out["losses"], out["step_s"]
    assert all(l == l and abs(l) < float("inf") for l in losses), losses
    params = tree_leaves(out["params"])
    n_params = sum(t.numel() for t in params)
    assert all(bool(t.isfinite().all()) for t in params)
    tokens = batch * seq
    best = min(step_s[1:])
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    stats = {"arch": arch, "layers": cfg.num_layers, "batch": batch,
             "seq": seq, "steps": steps, "params": n_params,
             "wall_s": wall, "step_ms": [1e3 * s for s in step_s],
             "tokens_per_s_median": tokens / med,
             "tokens_per_s_best": tokens / best,
             "model_flop_share_median": 6 * n_params * tokens / med
             / PEAK_BF16,
             "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
             "losses": losses}
    del out, params
    return launches, stats


def pixtral_requests(cfg, n_text, gen_tokens, seed, count):
    """``count`` requests of ``cfg.num_patches`` patch embeddings (in
    ``extras``) ahead of ``n_text`` random text tokens each."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, cfg.vocab_size, n_text),
                    max_new_tokens=gen_tokens,
                    extras={"patches": rng.standard_normal(
                        (cfg.num_patches, cfg.frontend_feat_dim)).astype(
                            np.float32)}) for _ in range(count)]


def check_pixtral_small(dev):
    """Phase 19, first: a small f32 pixtral engine (reduced: 8 patches
    ahead of the text, d = 256, hd 64) on the card and on the CPU from the
    same params, patch requests beside a text-only one: greedy tokens and
    page tables identical.  Returns the card's launches."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine
    cfg = get_reduced(PARCH)
    params = T.init_model(0, cfg, "cpu")
    toks, tables = {}, {}
    for d in ("cpu", dev):
        eng = ServeEngine(cfg, params, max_slots=3, max_seq=64, device=d)
        reqs = pixtral_requests(cfg, 20, 10, 3, 3) + [Request(
            tokens=np.arange(1, 13), max_new_tokens=10)]
        ops.reset_launches()
        done = eng.serve(reqs)
        launches = dict(ops.LAUNCHES)
        assert len(done) == 4 and all(len(c.tokens) == 10 for c in done)
        toks[str(d)] = [c.tokens for c in sorted(done, key=lambda c: c.rid)]
        tables[str(d)] = eng._table.copy()
    assert toks["cpu"] == toks[str(dev)], "card and CPU tokens differ"
    assert (tables["cpu"] == tables[str(dev)]).all()
    assert launches["flash_attention"] > 0 and \
        launches["paged_attention"] > 0, launches
    return launches


def run_pixtral(dev):
    """pixtral-12b at full width in bf16 (d 5120, 32 q heads on 8 kv heads,
    hd 128, 1024-wide patch embeddings, vocab 131,072), its depth cut to
    PLAYERS of 40 layers, random weights from seed 0: P_SLOTS requests of
    256 patches + P_TEXT text tokens, P_GEN greedy tokens each, through a
    paged ``ServeEngine`` (patch requests are admitted one at a time, as in
    the reference), the launch counters set to 0 just before and read just
    after."""
    from repro_torch.configs import get_config, pixtral_12b
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.telemetry import ServingTelemetry
    full = get_config(PARCH)
    cfg = full.replace(num_layers=PLAYERS)
    if full == pixtral_12b.FULL:
        assert (full.d_model, full.num_heads, full.num_kv_heads,
                full.resolved_head_dim, full.num_patches,
                full.frontend_feat_dim, full.num_layers) == \
            (5120, 32, 8, 128, 256, 1024, 40)
    t0 = time.perf_counter()
    params = T.init_model(0, cfg, dev)
    eng = ServeEngine(cfg, params, max_slots=P_SLOTS,
                      max_seq=cfg.num_patches + P_TEXT + P_GEN + 8,
                      device=dev)
    del params
    eng.serve(pixtral_requests(cfg, 16, 3, 9, 1))
    eng.telemetry = ServingTelemetry(eng.max_slots)
    eng.prefill_dispatches = 0
    setup_s = time.perf_counter() - t0
    reqs = pixtral_requests(cfg, P_TEXT, P_GEN, 0, P_SLOTS)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_idle()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    tel = eng.telemetry
    want = {k: 0 for k in TOL}
    want["paged_attention"] = PLAYERS * tel.total_decode_steps
    want["flash_attention"] = PLAYERS * eng.prefill_dispatches
    assert launches == want, (launches, want)
    assert eng.prefill_dispatches == P_SLOTS
    assert tel.total_decode_steps >= P_GEN - 1
    stats = {"layers": f"{PLAYERS} of {full.num_layers}",
             **serve_stats(eng, done, reqs, wall, setup_s, P_GEN)}
    return launches, stats


def paged_bound(args):
    """Bytes and operations of one paged decode call on these inputs:
    q and out, the table and positions, and each row's mapped pages that
    hold a visible key (k, v and slot positions of the page, read once);
    ~4 * H * hd flops per visible key."""
    q, kp, vp, sp, table, pos = args
    B, H, hd = q.shape
    N, P, KH, _ = kp.shape
    sp, table, pos = sp.cpu(), table.cpu(), pos.cpu()
    es = q.element_size()
    bytes_ = 2 * B * H * hd * es + table.numel() * 4 + B * 4
    keys = 0
    for b in range(B):
        qp = int(pos[b])
        if qp < 0:
            continue
        for v in range(qp // P + 1):
            pid = int(table[b, v])
            if pid >= 0:
                bytes_ += 2 * P * KH * hd * es + P * 4
                sl = sp[pid]
                keys += int(((sl >= 0) & (sl <= qp)).sum())
    return bytes_, keys * 4 * H * hd


def flash_bound(B, S, H, KH, hd, es, causal=True):
    # q, k, v read once, out written once; QK^T and PV over the causal
    # (or, bidirectional, all) pairs, 4 * hd flops each
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
    return es * (2 * B * S * H * hd + 2 * B * S * KH * hd), 4 * hd * pairs


# ------------------------------------------------------------- bounds ----
def env_bound(N, J, obs_dim, substeps):
    """Bytes, and the operations as (count, peak) pairs whose times add:
    the observation projection in three TF32 passes on the tensor cores,
    the rest on the fp32 pipe."""
    R = 6 + 4 * J + 3
    # reads q, qd, action (N,J) f32, root (N,6), t/seed/resets (N,) i32 and
    # the constants; writes q, qd, prev_action, root, t, resets, obs,
    # reward, done.  prev_action is an input the step never reads.
    bytes_ = 4 * (3 * N * J + 6 * N + 3 * N + R * obs_dim + 3 * J) \
        + 4 * (3 * N * J + 6 * N + 2 * N + N * obs_dim + 2 * N)
    # observation projection, then tanh and ~32 fp32 ops a joint a
    # substep (coupling, gravity, qdd, clip, Euler, tip cumsum, thrust
    # sums, counting each sin/cos as one) plus ~30 a substep for the root
    proj = 2 * N * R * obs_dim
    rest = N * obs_dim + N * substeps * (32 * J + 30)
    return bytes_, [(proj, PEAK_3XTF32), (rest, PEAK_F32)]


def gae_bound(T, N):
    # reads r, v, d (T,N) and last (N); writes adv, ret (T,N); ~13 ops an
    # element (scan 7, mean and centred variance 4, normalise 2)
    return 4 * (3 * T * N + N + 2 * T * N), 13 * T * N


def trunk_bound(dims, N):
    pairs = list(zip(dims[:-1], dims[1:]))
    bytes_ = 4 * (N * dims[0] + sum(a * b + b for a, b in pairs)
                  + N * dims[-1])
    ops_ = sum(2 * N * a * b + 2 * N * b for a, b in pairs)
    return bytes_, ops_


def nstep_bound(T, N):
    # reads r, d (T,N) and bootstrap (N); writes G (T,N); 4 ops an element
    return 4 * (3 * T * N + N), 4 * T * N


def pack_bound(T, N, obs_dim, act_dim):
    # every payload element read once and written once; no arithmetic
    return 2 * (4 * (T * N * (obs_dim + act_dim + 2) + N) + 4), 0


def bound_ms(bytes_, ops_, peak_ops=PEAK_F32):
    """The larger of the bytes' time and the operations' time; ``ops_``
    is a count at ``peak_ops``, or a list of (count, peak) pairs whose
    times add."""
    tb = bytes_ / PEAK_BYTES * 1e3
    if isinstance(ops_, list):
        to = sum(o / p for o, p in ops_) * 1e3
    else:
        to = ops_ / peak_ops * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def op_count(ops_):
    return sum(o for o, _ in ops_) if isinstance(ops_, list) else ops_


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    sys.path.insert(0, src)
    from repro_torch.envs import SPECS, make_env
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.rl.ppo import PPOConfig, init_train, make_train_step
    from repro_torch.utils import tree_leaves

    # full fp32 matmuls: the plain versions must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "| card:", card_line())

    # 1. build ------------------------------------------------------------
    secs = _build.build_all()
    print(f"[build] {secs:.1f} s (0 = already built) in {_build.build_dir()}")
    for stem, log in _build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                print(f"[build] {stem}: {line.strip()}")
    for kernel, counts in sass_report(_build.build_dir(),
                                      _build.build_logs()).items():
        print(f"[build] {kernel}: tensor-core instructions in cuobjdump -sass "
              f"{counts}, no spills")

    # 2. kernel against plain version -------------------------------------
    gen = torch.Generator(dev).manual_seed(0)
    spec = SPECS[ENV]
    trunk_dims = spec.policy_dims[:-1]
    errs = {
        "env_mega_step": max(check_env(ENV, n, gen, dev, with_ring)
                             for n in (N_MAIN,) + GMI_N
                             for with_ring in (False, True)),
        "gae_norm": max(check_gae(T_MAIN, n, gen, dev)
                        for n in (N_MAIN,) + GMI_N),
        "policy_mlp": max([check_trunk(trunk_dims, n, gen, dev)
                           for n in (N_MAIN,) + GMI_N]
                          # phase 15's Ant trunk at N_MAIN agents
                          + [check_trunk(SPECS["Ant"].policy_dims[:-1],
                                         N_MAIN, gen, dev)]),
        "nstep_returns": max(check_nstep(T_MAIN, n, gen, dev)
                             for n in (N_MAIN,) + GMI_N),
        "pack_channels": check_pack(T_MAIN, N_A3C, spec, gen, dev, 3),
    }
    bf = torch.bfloat16
    from repro_torch.configs import get_config
    fc = get_config(ARCH)
    FH, FKH, FHD = fc.num_heads, fc.num_kv_heads, fc.resolved_head_dim
    paged_main = paged_inputs(8, FH, FKH, FHD, 8, 128, DECODE_POS, gen, dev,
                              bf)
    ulps = {}
    errs["paged_attention"], ulps["paged_attention"] = check_paged(
        paged_main, 0.0)
    flash = [check_flash(flash_inputs(b, sq, FH, FKH, FHD, gen, dev, bf),
                         0.0) for b, sq in FLASH_SHAPES]
    # phase 11's shapes: stablelm-12b's 32 q heads on 8 kv heads at hd 160
    # (flash at the padded width 192; paged decode at 4 rows and the
    # engine's 8-token pages and 128-page table, so the same splits)
    sc = get_config(SARCH)
    SH, SKH, SHD = sc.num_heads, sc.num_kv_heads, sc.resolved_head_dim
    paged_s = check_paged(paged_inputs(4, SH, SKH, SHD, 8, 128, SDECODE_POS,
                                       gen, dev, bf), 0.0)
    flash_s = [check_flash(flash_inputs(b, sq, SH, SKH, SHD, gen, dev, bf),
                           0.0) for b, sq in SFLASH_SHAPES]
    print(f"[check] {SARCH} main-path shapes (32 q on 8 kv heads, hd 160, "
          f"bf16): paged_attention B=4 positions {SDECODE_POS} "
          f"max_abs_err={paged_s[0]:.3g} ({paged_s[1]:.3g} of one bf16 ulp "
          f"of each element, tol 1); flash_attention causal " + ", ".join(
              f"B={b} S={sq} max_abs_err={e:.3g} ({u:.3g} ulp)"
              for (b, sq), (e, u) in zip(SFLASH_SHAPES, flash_s)))
    errs["paged_attention"] = max(errs["paged_attention"], paged_s[0])
    ulps["paged_attention"] = max(ulps["paged_attention"], paged_s[1])
    flash += flash_s
    # phases 16 and 17: granite-moe-1b-a400m's 16 q on 8 kv heads at hd
    # 64, zamba2-7b's 32 on 32 at hd 112 (flash at the padded width 128)
    zpaged = {}
    for arch, B, pos, shapes in ((MARCH, 8, M_DECODE_POS, M_FLASH_SHAPES),
                                 (ZARCH, 4, Z_DECODE_POS, Z_FLASH_SHAPES)):
        ac = get_config(arch)
        AH, AKH, AHD = ac.num_heads, ac.num_kv_heads, ac.resolved_head_dim
        pa = paged_inputs(B, AH, AKH, AHD, 8, 128, pos, gen, dev, bf)
        zpaged[arch] = pa
        pe = check_paged(pa, 0.0)
        fe = [check_flash(flash_inputs(b, sq, AH, AKH, AHD, gen, dev, bf),
                          0.0) for b, sq in shapes]
        print(f"[check] {arch} main-path shapes ({AH} q on {AKH} kv heads, "
              f"hd {AHD}, bf16): paged_attention B={B} positions {pos} "
              f"max_abs_err={pe[0]:.3g} ({pe[1]:.3g} of one bf16 ulp of each "
              f"element, tol 1); flash_attention causal " + ", ".join(
                  f"B={b} S={sq} max_abs_err={e:.3g} ({u:.3g} ulp)"
                  for (b, sq), (e, u) in zip(shapes, fe)))
        errs["paged_attention"] = max(errs["paged_attention"], pe[0])
        ulps["paged_attention"] = max(ulps["paged_attention"], pe[1])
        flash += fe
    # hubert-xlarge's bidirectional attention at hd 80 (phase 18 (c))
    hub = [check_flash(flash_inputs(*HUBERT_FLASH, gen, dev, dt), tol,
                       causal=False)
           for dt, tol in ((bf, 0.0), (torch.float32,
                                       TOL["flash_attention"]))]
    print(f"[check] hubert-xlarge shape (B, S, heads, kv heads, hd) "
          f"{HUBERT_FLASH}, bidirectional: flash_attention bf16 "
          f"max_abs_err={hub[0][0]:.3g} ({hub[0][1]:.3g} of one bf16 ulp of "
          f"each element, tol 1), f32 max_abs_err={hub[1][0]:.3g} (tol "
          f"1e-4)")
    flash.append(hub[0])
    errs["flash_attention"] = max(e for e, _ in flash)
    ulps["flash_attention"] = max(u for _, u in flash)
    print(check_paged_in_turns(gen, dev))
    mlstm_main = [(mlstm_inputs(*shape[:4], zero, gen, dev), chunk)
                  for *shape, chunk, zero in MLSTM_MAIN]
    errs["mlstm_chunkwise"] = max(check_mlstm(a, c) for a, c in mlstm_main)
    for k, e in errs.items():
        tol = f"tol {TOL[k]:g}" if k not in ulps else \
            f"{ulps[k]:.3g} of one bf16 ulp of each element, tol 1"
        if k == "mlstm_chunkwise":
            tol = f"tol {TOL[k]:g} of each output's largest magnitude"
        print(f"[check] {k} main-path shapes: max_abs_err={e:.3g} ({tol})")
    print(f"[check] env_mega_step (both ring modes), policy_mlp, gae_norm "
          f"and nstep_returns main-path shapes include a GMI's N = "
          f"{GMI_N[0]} and {GMI_N[1]}; policy_mlp also Ant's "
          f"{SPECS['Ant'].policy_dims[:-1]} at N = {N_MAIN}")
    f32 = torch.float32
    for kw in (dict(), dict(window=37, softcap=5.0)):
        a = paged_inputs(5, 8, 4, 64, 16, 9, [130, -1, 17, 0, 143], gen, dev,
                         f32, holes=0.2, unmapped=0.25)
        e1, _ = check_paged(a, TOL["paged_attention"], **kw)
        e2, _ = check_flash(flash_inputs(2, 77, 8, 2, 64, gen, dev, f32),
                         TOL["flash_attention"], causal=True, **kw)
        e3, _ = check_flash(flash_inputs(1, 45, 4, 4, 128, gen, dev, f32),
                         TOL["flash_attention"], causal=False, **kw)
        _, u5 = check_flash(flash_inputs(2, 77, 8, 2, 64, gen, dev, bf),
                            0.0, causal=True, **kw)
        _, u6 = check_flash(flash_inputs(1, 45, 4, 4, 128, gen, dev, bf),
                            0.0, causal=False, **kw)
        a = paged_inputs(3, 8, 1, 128, 16, 9, [100, 5, -1], gen, dev, f32,
                         holes=0.2, unmapped=0.25)
        e4, _ = check_paged(a, TOL["paged_attention"], **kw)
        print(f"[check] ragged f32 {kw or 'no window/softcap'}: "
              f"paged_attention (page 16, unmapped pages, idle rows) hd 64 "
              f"G 2 max_abs_err={e1:.3g}, hd 128 G 8 max_abs_err={e4:.3g}; "
              f"flash_attention causal S=77 hd 64 G 4 max_abs_err={e2:.3g},"
              f" bidirectional S=45 hd 128 G 1 max_abs_err={e3:.3g} (tol "
              f"1e-4); bf16 flash at the same shapes {u5:.3g} and {u6:.3g} "
              "of one bf16 ulp of each element (tol 1)")
    # a window narrow enough that later blocks skip whole key tiles
    # (kv_lo > 0 needs the block's first query >= window + BK - 1)
    for kw in (dict(window=37), dict(window=37, softcap=5.0)):
        res = []
        for B, H, KH, hd in ((2, 8, 2, 64), (1, 4, 2, 128)):
            e, _ = check_flash(flash_inputs(B, 200, H, KH, hd, gen, dev, f32),
                               TOL["flash_attention"], causal=True, **kw)
            _, u = check_flash(flash_inputs(B, 200, H, KH, hd, gen, dev, bf),
                               0.0, causal=True, **kw)
            res.append(f"hd {hd} G {H // KH} f32 max_abs_err={e:.3g}, bf16 "
                       f"{u:.3g} of one bf16 ulp")
        print(f"[check] flash_attention causal S=200 {kw}: "
              f"{'; '.join(res)} (tol 1e-4; 1)")
    for line in check_head_dims(gen, dev):
        print(line)
    gf, gm = check_kernel_grads(gen, dev)
    print(f"[check] autograd Functions (C12), f32: flash_attention forward "
          f"the kernel, dq/dk/dv against autograd of the plain version at "
          f"2 x 256 causal 16 q on 8 kv hd 128, 4 x 128 bidirectional 16 on "
          f"16 hd 80, 2 x 96 bidirectional hd 80 window 37 softcap 5: worst "
          f"{gf:.3g} of each leaf's largest; mlstm_chunkwise B=2 H=4 S=64 "
          f"dh 128 chunk 32 from a non-zero state, gradients of q, k, v, "
          f"both gates and (C0, n0, m0) through h and the final state: "
          f"worst {gm:.3g} (tol 1e-4)")
    for name, sp in SPECS.items():
        e1 = check_env(name, N_RAGGED, gen, dev, True)
        e2 = check_trunk(sp.policy_dims[:-1], N_RAGGED, gen, dev)
        print(f"[check] {name} N={N_RAGGED}: env max_abs_err={e1:.3g}, "
              f"trunk {sp.policy_dims[:-1]} max_abs_err={e2:.3g}")
    for S in (48, 1):
        e = check_mlstm(mlstm_inputs(2, 3, S, 64, False, gen, dev, 5.0, -6.0),
                        16)
        print(f"[check] mlstm_chunkwise B=2 H=3 S={S} dh 64 chunk 16, "
              f"non-zero state, log_i x5, log_f ~ logsigmoid(N(-6, 1)): "
              f"max_abs_err={e:.3g} (tol {TOL['mlstm_chunkwise']:g} of each "
              "output's largest magnitude)")
    e40 = check_gae(40, N_RAGGED, gen, dev)
    print(f"[check] gae_norm T=5 N={N_RAGGED}: max_abs_err="
          f"{check_gae(5, N_RAGGED, gen, dev):.3g}; T=40 (advantages "
          f"re-read from L2) max_abs_err={e40:.3g}; T=4 N={N_GAE_STRIDE} "
          f"(grid-stride columns) max_abs_err="
          f"{check_gae(4, N_GAE_STRIDE, gen, dev):.3g} (tol 1e-4; each "
          "bit-identical over two calls)")
    print(f"[check] nstep_returns T=5 N={N_RAGGED}: max_abs_err="
          f"{check_nstep(5, N_RAGGED, gen, dev):.3g}")
    ver = torch.tensor([[11]], dtype=torch.int32, device=dev)
    print(f"[check] pack_channels T=5 N={N_PACK_RAGGED} (version tensor): "
          f"max_abs_err={check_pack(5, N_PACK_RAGGED, spec, gen, dev, ver)}"
          ", rings bit-exact, sentinel kept")

    # 3. small iteration against the CPU path -----------------------------
    perr, moved = check_small_iteration(dev)
    print(f"[parity] fused PPO iteration card vs CPU: params max_abs_err="
          f"{perr:.3g} (tol 1e-5; largest update {moved:.3g}), metrics "
          "within 1e-4")

    # 4. small A3C rounds against the CPU path ----------------------------
    for branch, (perr, moved) in check_small_a3c(dev).items():
        print(f"[parity] A3C {branch} branch, 2 rounds card vs CPU: params "
              f"max_abs_err={perr:.3g} (tol 1e-5; largest update "
              f"{moved:.3g}), losses within 1e-4, staleness [0]")

    # 5. the PPO path -------------------------------------------------------
    env = make_env(ENV, megakernel=True, device=dev)
    cfg = PPOConfig(num_steps=T_MAIN, use_fused_kernels=True)
    state = list(init_train(0, env, spec.policy_dims, N_MAIN, device=dev))
    step = make_train_step(env, cfg)
    iters = 3
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    it_s = []
    for _ in range(iters):
        ti = time.perf_counter()
        *state, metrics = step(*state)
        torch.cuda.synchronize()
        it_s.append(time.perf_counter() - ti)
        vals = {k: float(v) for k, v in metrics.items()}
        assert all(map(lambda v: v == v and abs(v) < float("inf"),
                       vals.values())), vals
    elapsed = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    want = {k: 0 for k in TOL}
    want.update({"env_mega_step": T_MAIN * iters,
                 "policy_mlp": (T_MAIN + 1) * iters, "gae_norm": iters})
    assert launches == want, (launches, want)
    by_path = {"ppo": launches}
    params, _, env_state, obs = state[:4]
    assert obs.shape == (N_MAIN, spec.obs_dim) and bool(obs.isfinite().all())
    assert all(bool(p.isfinite().all()) for p in tree_leaves(params))
    steps = iters * T_MAIN * N_MAIN
    print(f"[ppo] {ENV} N={N_MAIN} T={T_MAIN}: {iters} iterations, "
          f"per-iteration s={[round(s, 4) for s in it_s]}, "
          f"{steps / elapsed:,.0f} env steps/s, "
          f"{T_MAIN * N_MAIN / min(it_s):,.0f} env steps/s (best "
          f"iteration), last metrics {vals}, launches {launches}")

    # 6. the A3C path, both branches ----------------------------------------
    for branch, mk in (("a3c_direct", True), ("a3c_push", False)):
        la, round_s, el, losses, samples = run_a3c(dev, mk)
        by_path[branch] = la
        print(f"[a3c] {branch}: {ENV} 2 serving GMIs x N={N_A3C}, T={T_MAIN},"
              f" {A3C_ROUNDS} rounds, per-round s="
              f"{[round(x, 4) for x in round_s]}, {samples / el:,.0f} env "
              f"steps/s, {2 * T_MAIN * N_A3C / min(round_s):,.0f} env "
              f"steps/s (best round), trained == predicted == {samples:,}, "
              f"losses {[round(x, 4) for x in losses]}, staleness [0] a "
              f"round, launches {la}")

    # 7. small serving engine against the CPU -------------------------------
    la = check_small_engine(dev)
    print(f"[parity] small f32 serving engine ({ARCH} reduced, both "
          f"kernels, chunked prefill, shared head with copy-on-write) card "
          f"vs CPU: greedy tokens and page tables identical, launches {la}")

    # 8. the serving path ---------------------------------------------------
    la, stats, eng = run_serve(dev)
    by_path["serve"] = la
    print(f"[serve] {ARCH} full width bf16, 8 slots, max_seq 1024, chunk "
          f"256: launches {la}, stats {json.dumps(stats)}")
    print(f"[serve] prefill {stats['prefill_tok_s']:,.1f} tok/s, decode "
          f"{stats['decode_tok_s']:,.1f} tok/s "
          f"({stats['decode_ms_per_step']:.3f} ms a step at up to 8 rows)")
    del eng

    # 9. small xlstm engine against the CPU -------------------------------
    la = check_small_xlstm_engine(dev)
    print(f"[parity] small f32 serving engine ({XARCH} reduced, mLSTM "
          f"kernel, chunked prefill, reused slots) card vs CPU: greedy "
          f"tokens and page tables identical, launches {la}")

    # 10. the xlstm serving path --------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    la, stats = run_xlstm(dev)
    by_path["serve_xlstm"] = la
    print(f"[serve_xlstm] {XARCH} full width bf16, 8 slots, max_seq 1024, "
          f"chunk 512: launches {la}, stats {json.dumps(stats)}")
    print(f"[serve_xlstm] prefill {stats['prefill_tok_s']:,.1f} tok/s, "
          f"decode {stats['decode_tok_s']:,.1f} tok/s "
          f"({stats['decode_ms_per_step']:.3f} ms a step at up to 8 rows), "
          f"peak {stats['peak_mem_gb']:.2f} GB")

    # 11. stablelm-12b serving: hd 160 through both attention kernels -----
    torch.cuda.reset_peak_memory_stats(dev)
    la, stats = run_stablelm(dev)
    by_path["serve_stablelm"] = la
    print(f"[serve_stablelm] {SARCH} full width bf16 (d 5120, 32 q on 8 kv "
          f"heads, hd 160; depth cut to {SLAYERS} of 40 layers), 4 slots, "
          f"max_seq 1024, whole-prompt prefill: launches {la}, stats "
          f"{json.dumps(stats)}")
    print(f"[serve_stablelm] prefill {stats['prefill_tok_s']:,.1f} tok/s, "
          f"decode {stats['decode_tok_s']:,.1f} tok/s "
          f"({stats['decode_ms_per_step']:.3f} ms a step at up to 4 rows)")

    # 12. multi-GMI synchronous PPO on one card ---------------------------
    t12 = time.perf_counter()
    for line in check_layouts(dev):
        print(line)
    for line in check_lgr(dev, gen):
        print(line)
    la, diff, bit, runs = run_gmis_parity(dev)
    by_path["multi_gmi"] = la
    rates = {k: v["steps_per_s"] for k, v in runs.items()}
    print(f"[gmi] run_drl {ENV} 1 x 4 GMIs x {N_MAIN // 4} envs, T="
          f"{T_MAIN}, {GMI_ITERS} iterations, strategy "
          f"{runs['streams']['strategy']}: one stream a GMI against the "
          f"default stream in turn, params max_abs_err={diff:.3g} (tol 1e-6;"
          f" bit-identical: {bit}), launches {la} (both runs), env steps/s "
          f"{rates}")
    for line in measure_gmis(dev):
        print(line)
    for line in run_algorithm2(dev):
        print(line)
    for line in gae_under_load(dev, gen):
        print(line)
    print(f"[gmi] phase 12 took {time.perf_counter() - t12:.1f} s")

    # 12b. supervised async A3C: faults, checkpoints, online controller ---
    t12b = time.perf_counter()
    la, perr, moved, counters, small = check_fleet_parity(dev)
    by_path["a3c_fleet_small"] = la
    print(f"[fleet] (a) supervised fleet card vs CPU: Ant, plan_async(3, 2, "
          f"2) on logical GPUs, 8 envs a GMI, T=4, push branch, plan "
          f"{FLEET_EVENTS}, probation 2, a checkpoint every 2 rounds: "
          f"failures {[f['kind'] for f in small.failures]}, recoveries "
          f"{[r['kind'] for r in small.recoveries]}, ckpt_steps "
          f"{small.ckpt_steps}, counters {counters}, all equal to the "
          f"CPU's; params max_abs_err={perr:.3g} (tol 1e-5; largest update "
          f"{moved:.3g}); launches {la}")
    la, round_s, save_ms, restore_ms, mb, held_b, shapes, sup = \
        run_fleet(dev)
    by_path["a3c_fleet"] = la
    held_0 = fleet_held_without_faults(dev)
    assert held_b <= 1.1 * held_0, (held_b, held_0)
    r = sup.runner
    print(f"[fleet] (b) {ENV} megakernel, 4 serving GMIs x {FLEET_N} envs, "
          f"T={T_MAIN}, the same plan: per-round s "
          f"{[round(x, 4) for x in round_s]}; predictions {r.predictions:,} "
          f"== trained {r.trained_samples:,} + poisoned "
          f"{r.poisoned_samples:,}; the poisoned batch's update discarded "
          f"(params the same tensors, bit-identical); restore skipped torn "
          f"step 6 for step 2, params bit-identical; launches {la}; "
          f"device memory live tensors hold after finish {held_b / 2**20:.1f} MiB "
          f"against {held_0 / 2**20:.1f} MiB for the same fleet with no "
          f"faults (tol 10%)")
    print(f"[fleet] checkpoint of the {ENV} tree (params, Adam mu and nu, "
          f"version): {mb:.3f} MB, save ms {[round(x, 3) for x in save_ms]}"
          f" (steps 2 and 6; step 4 crashed before its manifest), restore "
          f"{restore_ms:.3f} ms (reading torn step 6, then step 2)")
    times = time_fleet_rounds(dev)
    print(f"[fleet] round s with no faults, {FLEET_TIMED} rounds a turn "
          f"(unsupervised, supervised, supervised, unsupervised): "
          + "; ".join(f"{k} {[round(x, 4) for x in v]} (median "
                      f"{sorted(v)[len(v) // 2]:.4f})"
                      for k, v in times.items()))
    del sup, r
    la, replan_ms, held, shapes_c, runner = run_controller(dev)
    by_path["a3c_controller"] = la
    # the n-step scan at every trainer batch shape of (b) and (c), those
    # phase 2 did not hold already included
    shapes |= shapes_c
    held_2 = {(T_MAIN, n) for n in (N_MAIN,) + GMI_N}
    e_fleet = max([check_nstep(T, n, gen, dev)
                   for T, n in sorted(shapes - held_2)], default=0.0)
    errs["nstep_returns"] = max(errs["nstep_returns"], e_fleet)
    print(f"[check] nstep_returns at the trainer batches' (T, N) of (b) and "
          f"(c) {sorted(shapes)}: held in phase 2 or here, max_abs_err="
          f"{errs['nstep_returns']:.3g} (tol {TOL['nstep_returns']:g})")
    print(f"[fleet] (c) online controller, overlap, {ENV} 4 serving GMIs, "
          f"ladder ({FLEET_N}, {2 * FLEET_N}), epochs of 2 rounds, 6 "
          f"rounds: {runner.replans} re-plan(s), re-plan ms "
          f"{[round(x, 3) for x in replan_ms]}, trained == predicted == "
          f"{runner.predictions:,}; device memory live tensors hold after "
          f"{held['controller'] / 2**20:.1f} MiB against "
          f"{held['fixed'] / 2**20:.1f} MiB for a run at N={2 * FLEET_N} "
          f"with no re-plan (tol 10%); launches {la}")
    for line in runner.controller.summary().splitlines():
        print(f"[fleet] {line}")
    for x in runner.controller.decisions:
        print(f"[fleet]   re-plan: {x.reason} -> serving_gpus="
              f"{x.serving_gpus}, gmi_per_gpu={x.gmi_per_gpu}, "
              f"num_env={x.num_env}")
    del runner
    print(f"[fleet] phase 12b took {time.perf_counter() - t12b:.1f} s")

    # 14. disaggregated serving over GMIs (before 13's timings, so its
    # launches join the kernels line) -------------------------------------
    t14 = time.perf_counter()
    small, la = check_disagg_small(dev)
    by_path["disagg_small"] = la
    print(f"[disagg] (a) small f32 front ({ARCH} reduced, 2 decode GMIs x 4 "
          f"slots + 1 prefill GMI, one stream each, planner pinned at "
          f"{D_SMALL_THRESHOLD} tokens) card vs CPU: routes "
          f"{small['routes']}, payload (request, bytes, head pages) "
          f"{small['payloads']}, prefix_pages_saved "
          f"{small['prefix_pages_saved']}, greedy tokens, all equal; "
          f"launches {la}")
    fl = small["fleet"]
    print(f"[disagg] (a) make_fleet_supervisor(router=front), Ant "
          f"plan_async(3, 1, 2), plan {D_FLEET_EVENTS}, {D_FLEET_ROUNDS} "
          f"rounds then drain_serving: failures "
          f"{[(f['kind'], f['round'], f.get('target')) for f in fl['failures']]}"
          f", recoveries {[(r['kind'], r['action']) for r in fl['recoveries'] if 'action' in r]}"
          f", every request completed, tokens and logs equal to the CPU's; "
          f"{fl['engines']} decode and {fl['prefill_engines']} prefill "
          f"GMI(s) after")
    torch.cuda.reset_peak_memory_stats(dev)
    la, stats, measured = run_disagg(dev)
    by_path["disagg"] = la
    print(f"[disagg] (b) {ARCH} full width bf16, {D_DECODE} decode GMIs x "
          f"{D_SLOTS} slots + {D_PREFILL} prefill GMI, one CUDA stream each, "
          f"shared params, max_seq 1024, 8-token pages; 4 x {D_LONG} tokens "
          f"(two share a {D_HEAD}-token head) and 4 x {D_SHORT}, {D_GEN} "
          f"greedy tokens each, planner pinned at {D_THRESHOLD} tokens: "
          f"launches {la}, stats {json.dumps(stats)}")
    print(f"[disagg] (b) migration: payload "
          f"{[round(x, 3) for x in stats['payload_mb']]} MB, pack ms "
          f"{[round(x, 4) for x in stats['pack_ms']]}, GB/s "
          f"{[round(x, 1) for x in stats['pack_gb_s']]}; TTFT ms migrated "
          f"{[round(x, 1) for x in stats['ttft_ms']['migrated']]}, local "
          f"{[round(x, 1) for x in stats['ttft_ms']['local']]}; decode "
          f"{stats['decode_tok_s']:,.1f} tok/s; peak "
          f"{stats['peak_mem_gb']:.2f} GB | {card_line()}")
    print(f"[disagg] (b) measured planner over the same trace: "
          f"{json.dumps(measured)}")
    la, sizes, decisions, runner = run_disagg_arbiter(dev)
    by_path["disagg_arbiter"] = la
    print(f"[disagg] (c) make_async_runner(router=front, "
          f"online_controller=True), Ant plan_async(3, 1, 1), "
          f"{D_ARBITER_ROUNDS} rounds: (decode, prefill) GMIs after each "
          f"round {sizes}, serving decisions "
          f"{[d.reason for d in decisions]}, every request completed, "
          f"trained == predicted == {runner.predictions:,}; launches {la}")
    del runner
    print(f"[disagg] phase 14 took {time.perf_counter() - t14:.1f} s")

    # 15. multi-agent PPO: the trunk and GAE kernels over the plain step --
    t15 = time.perf_counter()
    perr, moved, la = check_multi_agent_small(dev)
    print(f"[multi_agent] (a) 4-agent Ant, {MA_SMALL_WORLDS} worlds x "
          f"{MA_AGENTS} agents, T={MA_SMALL_T}, fused PPO iteration card vs "
          f"CPU: t/seed/resets and done fraction equal, world 2's agents "
          f"done together, params max_abs_err={perr:.3g} (tol 1e-5; largest "
          f"update {moved:.3g}); launches {la}")
    la, rates = run_multi_agent(dev)
    by_path["multi_agent"] = la
    print(f"[multi_agent] (b) 4-agent Ant, {N_MAIN} agents ({N_MAIN // 4} "
          f"worlds of {4 * SPECS['Ant'].act_dim} joints), T={T_MAIN}, "
          f"{MA_ITERS} fused PPO iterations: launches {la}; env steps/s "
          f"(iterations 2-{MA_ITERS}) " + "; ".join(
              f"{k} {r:,.0f} (per-iteration s {[round(x, 4) for x in s_]})"
              for k, (s_, r) in rates.items()) + f" | {card_line()}")
    print(f"[multi_agent] phase 15 took {time.perf_counter() - t15:.1f} s")

    # 16. granite-moe-1b-a400m serving at full width ------------------------
    t16 = time.perf_counter()
    err, dropped = check_moe_small(dev)
    print(f"[moe] moe_apply f32 card vs CPU (B=3, S=64, 8 experts top-2, "
          f"capacity factor 0.5, route_block 0 and 16; {dropped} "
          f"assignments dropped): slots and validity equal, out "
          f"max_abs_err={err:.3g} (tol 1e-5)")
    torch.cuda.reset_peak_memory_stats(dev)
    la, stats = run_moe(dev)
    by_path["serve_moe"] = la
    print(f"[moe] {MARCH} full width bf16 (24 layers, d 1024, 16 q on 8 kv "
          f"heads, hd 64, 32 experts top-8), 8 slots, max_seq 1024, "
          f"whole-prompt prefill, 4 x 512 + 4 x 128 tokens, {M_GEN} each: "
          f"launches {la}, stats {json.dumps(stats)}")
    print(f"[moe] prefill {stats['prefill_tok_s']:,.1f} tok/s, decode "
          f"{stats['decode_tok_s']:,.1f} tok/s "
          f"({stats['decode_ms_per_step']:.3f} ms a step at up to 8 rows), "
          f"prefill drop share {stats['prefill_drop_share']:.4f}, peak "
          f"{stats['peak_mem_gb']:.2f} GB | {card_line()}")
    print(f"[moe] phase 16 took {time.perf_counter() - t16:.1f} s")

    # 17. zamba2-7b serving: the shared attention at hd 112 -----------------
    t17 = time.perf_counter()
    worst, la = check_zamba2_small(dev)
    print(f"[zamba2] small f32 hybrid engine ({ZARCH} reduced) card vs CPU, "
          f"chunk 16 (a 48-token prompt) and whole-prompt: greedy tokens and "
          f"page tables identical, Mamba2 states max_abs_err={worst:.3g} "
          f"(tol 1e-4); launches {la}")
    torch.cuda.reset_peak_memory_stats(dev)
    la, stats = run_zamba2(dev)
    by_path["serve_zamba2"] = la
    print(f"[zamba2] {ZARCH} full width bf16 (d 3584, 32 heads on 32, hd 112, "
          f"N 64; {stats['super_blocks']} super-blocks, "
          f"{stats['layer_applications']} layer applications), 4 slots, "
          f"max_seq 1024, whole-prompt prefill, 2 x 512 + 2 x 256 tokens, "
          f"{Z_GEN} each: launches {la}, stats {json.dumps(stats)}")
    print(f"[zamba2] prefill {stats['prefill_tok_s']:,.1f} tok/s, decode "
          f"{stats['decode_tok_s']:,.1f} tok/s "
          f"({stats['decode_ms_per_step']:.3f} ms a step at up to 4 rows), "
          f"peak {stats['peak_mem_gb']:.2f} GB | {card_line()}")
    print(f"[zamba2] phase 17 took {time.perf_counter() - t17:.1f} s")

    # 18. LM training: gradients through the kernels (C12), full width ----
    t18 = time.perf_counter()
    rows, la = check_lm_small(dev)
    by_path["lm_small"] = la
    for r in rows:
        print(f"[lm] (a) f32 card vs CPU, reduced {json.dumps(r)}")
    print(f"[lm] (a) loss within 1e-5, every gradient leaf within 1e-4 of "
          f"the CPU leaf's largest; launches {la}")
    for tag, (arch, b, sq, n) in zip(("b", "c"), LM_RUNS):
        torch.cuda.empty_cache()
        la, st = run_lm(dev, arch, b, sq, n)
        by_path[f"lm_{arch.split('-')[0]}"] = la
        print(f"[lm] ({tag}) {arch} full width and depth ({st['layers']} "
              f"layers, {st['params']:,} params), f32 masters + Adam, bf16 "
              f"compute, no remat, {b} x {sq} tokens, {n} steps: launches "
              f"{la} ({st['layers']} flash a step), stats {json.dumps(st)}")
        print(f"[lm] ({tag}) {arch}: {st['tokens_per_s_median']:,.1f} "
              f"training tokens/s (median of steps 2-{n}; best "
              f"{st['tokens_per_s_best']:,.1f}), step ms "
              f"{[round(x, 2) for x in st['step_ms']]}, model-FLOP share "
              f"{st['model_flop_share_median']:.4f} of the {PEAK_BF16:.3g} "
              f"flop/s bf16 peak (6 x params x tokens), peak "
              f"{st['peak_mem_gb']:.2f} GB | {card_line()}")
    print(f"[lm] phase 18 took {time.perf_counter() - t18:.1f} s")

    # 19. pixtral-12b serving: patch embeddings ahead of the text ----------
    t19 = time.perf_counter()
    la = check_pixtral_small(dev)
    print(f"[pixtral] small f32 engine ({PARCH} reduced, 8 patches ahead of "
          f"the text, a text-only request beside) card vs CPU: greedy tokens "
          f"and page tables identical; launches {la}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    la, stats = run_pixtral(dev)
    by_path["serve_pixtral"] = la
    print(f"[pixtral] {PARCH} full width bf16 (d 5120, 32 q on 8 kv heads, "
          f"hd 128; depth cut to {PLAYERS} of 40 layers), {P_SLOTS} slots, "
          f"256 patches + {P_TEXT} text tokens each, {P_GEN} greedy tokens: "
          f"launches {la}, stats {json.dumps(stats)}")
    print(f"[pixtral] prefill {stats['prefill_tok_s']:,.1f} tok/s, decode "
          f"{stats['decode_tok_s']:,.1f} tok/s "
          f"({stats['decode_ms_per_step']:.3f} ms a step at up to "
          f"{P_SLOTS} rows), peak {stats['peak_mem_gb']:.2f} GB | "
          f"{card_line()}")
    print(f"[pixtral] phase 19 took {time.perf_counter() - t19:.1f} s")
    launches = {k: sum(p[k] for p in by_path.values()) for k in TOL}

    # 13. timings -----------------------------------------------------------
    _, st, action, obs0, consts, kw = env_inputs(ENV, N_MAIN, gen, dev)
    r, v, d, last = gae_inputs(T_MAIN, N_MAIN, gen, dev)
    x, ws, bs = trunk_inputs(trunk_dims, N_MAIN, gen, dev)
    pay, bufs = pack_inputs(T_MAIN, 2, N_A3C, spec, gen, dev, 3)

    def chain():
        h = x
        for w, b in zip(ws, bs):
            h = torch.tanh(torch.addmm(b, h, w))
        return h

    def copies():
        col = N_A3C
        for c in ("obs", "actions", "rewards", "dones"):
            bufs[c][:, col:col + N_A3C].copy_(pay[c])
        bufs["bootstrap"][1].copy_(pay["bootstrap"])
        bufs["actor_version"][1].fill_(pay["actor_version"])

    rows = []
    timings = {
        "env_mega_step": (
            lambda: ops.env_mega_step(*st, action, obs0, None, 0, 0,
                                      *consts, **kw),
            lambda: ref.mega_step(*st, action, obs0, None, 0, 0, *consts,
                                  **kw),
            None, env_bound(N_MAIN, spec.act_dim, spec.obs_dim,
                            spec.substeps)),
        "gae_norm": (lambda: ops.gae_norm(r, v, d, last),
                     lambda: ref.gae_norm_ref(r, v, d, last), None,
                     gae_bound(T_MAIN, N_MAIN)),
        "policy_mlp": (lambda: ops.policy_mlp(x, ws, bs),
                       lambda: ref.policy_mlp_ref(x, ws, bs), chain,
                       trunk_bound(trunk_dims, N_MAIN), PEAK_3XTF32),
        "nstep_returns": (lambda: ops.nstep_returns(r, d, last),
                          lambda: ref.nstep_returns_ref(r, d, last), None,
                          nstep_bound(T_MAIN, N_MAIN)),
        "pack_channels": (lambda: ops.pack_channels(bufs, pay, 1),
                          lambda: ref.pack_channels_ref(bufs, pay, 1),
                          copies, pack_bound(T_MAIN, N_A3C, spec.obs_dim,
                                             spec.act_dim)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash_t = {}
    for fb, fs, fh, fkh, fhd, fc in FLASH_TIMED:
        fq, fk, fv = flash_inputs(fb, fs, fh, fkh, fhd, gen, dev, bf)
        ft = [t.transpose(1, 2).contiguous() for t in (fq, fk, fv)]
        flash_t[(fb, fs, fhd)] = (
            lambda fq=fq, fk=fk, fv=fv, fc=fc: ops.flash_attention(
                fq, fk, fv, causal=fc),
            lambda fq=fq, fk=fk, fv=fv, fc=fc: ref.attention_ref(
                fq, fk, fv, causal=fc),
            lambda ft=ft, fc=fc: sdpa(*ft, is_causal=fc, enable_gqa=True),
            flash_bound(fb, fs, fh, fkh, fhd, 2, fc), PEAK_BF16)
    paged_t = {}
    for pb, pa in ((8, paged_main), (4, zpaged[ZARCH])):
        paged_t[(pb, pa[0].shape[1], pa[0].shape[2])] = (
            lambda pa=pa: ops.paged_attention(*pa),
            lambda pa=pa: ref.paged_attention_ref(*pa), None,
            paged_bound(pa), PEAK_BF16)
    timings["paged_attention"] = paged_t[(8, FH, FHD)]
    timings["flash_attention"] = flash_t[(3, 128, FHD)]
    (ma, mc), shape = mlstm_main[0], MLSTM_MAIN[0]
    timings["mlstm_chunkwise"] = (
        lambda: ops.mlstm_chunkwise(*ma, chunk=mc),
        lambda: ref.mlstm_chunkwise_ref(*ma, mc), None,
        mlstm_bound(*shape[:4], mc), PEAK_3XTF32)
    def timed(kern, plain, lib, nbytes, nops, *peak):
        b_ms, b_by = bound_ms(nbytes, nops, *peak)
        # plain, kernel, kernel, plain: report the mean of each pair
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(lib) if lib else None,
                "host_ms": host_ms(kern), "bytes": nbytes,
                "ops": op_count(nops)}

    for name, (kern, plain, lib, (nbytes, nops), *peak) in timings.items():
        row = {"name": name, "route": "cuda", "source": KERNELS[name][0],
               "replaces": KERNELS[name][1], "launches": launches[name],
               "max_abs_err": errs[name]}
        # a call can be host-bound: the device time of the kernel (and of
        # the library call's kernels, where there is one) under the
        # profiler is in the row (in flash's, in its ``shapes``)
        extra = {}
        if name == "flash_attention":
            # every timed shape, each in its own turns; the row's own
            # numbers are phase 8's dispatch, the first
            row["shapes"] = []
            for (fb, fs, fhd), (k_, p_, l_, (nb, no), *pk) in \
                    flash_t.items():
                row["shapes"].append({"B": fb, "S": fs, "hd": fhd,
                                      "causal": fhd != HUBERT_FLASH[-1],
                                      **timed(k_, p_, l_, nb, no, *pk),
                                      "device_ms": device_ms(k_),
                                      "library_device_ms": device_ms(l_)})
            row.update({k: v for k, v in row["shapes"][0].items()
                        if k not in ("B", "S", "hd", "causal")})
        elif name == "paged_attention":
            # phase 8's decode step (the row's own numbers) and phase 17's
            # at hd 112, each in its own turns
            row["shapes"] = []
            for (pb, ph, phd), (k_, p_, l_, (nb, no), *pk) in \
                    paged_t.items():
                row["shapes"].append({"B": pb, "H": ph, "hd": phd,
                                      **timed(k_, p_, l_, nb, no, *pk),
                                      "device_ms": device_ms(k_),
                                      "library_device_ms": None})
            row.update({k: v for k, v in row["shapes"][0].items()
                        if k not in ("B", "H", "hd")})
        else:
            row.update(timed(kern, plain, lib, nbytes, nops, *peak))
            by_kernel = device_times(kern)
            extra = {"device_ms": sum(by_kernel.values()) or None,
                     "library_device_ms": device_ms(lib) if lib else None}
            row.update(extra)
            if len(by_kernel) > 1:
                print(f"[time] {name}: device time by launched kernel "
                      f"{json.dumps(by_kernel)}")
        row["launches_by_path"] = {p: la[name] for p, la in by_path.items()}
        rows.append(row)
        for sh in row.get("shapes", [{**row, **extra}]):
            at = (f" B={sh['B']} {'S' if 'S' in sh else 'H'}="
                  f"{sh.get('S', sh.get('H'))} hd={sh['hd']}" if "B" in sh
                  else "")
            dv = (f", device time (profiler) kernel {sh['device_ms']} ms, "
                  f"library {sh['library_device_ms']} ms")
            print(f"[time] {name}{at}: kernel {sh['ms']:.4f} ms, plain "
                  f"{sh['plain_ms']:.4f} ms, bound {sh['bound_ms']:.4f} ms "
                  f"({sh['bound_by']}), library {sh['library_ms']} ms{dv}, "
                  f"host time of a call on its own {sh['host_ms']:.4f} ms")
        if name == "env_mega_step":
            nb_, no_ = timings[name][3]
            f32_ms, f32_by = bound_ms(nb_, op_count(no_))
            print(f"[time] env_mega_step bound both ways: "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}) with the "
                  f"projection in three TF32 passes on the tensor cores, "
                  f"{f32_ms:.4f} ms ({f32_by}) on the fp32 pipe alone")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
