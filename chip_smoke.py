#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's four paths: synchronous PPO,
asynchronous A3C over the MCC experience ring, and the paged serving
engine at internlm2-1.8b's, xlstm-1.3b's and stablelm-12b's full width.

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
   256; the ring pack of one A3C push, T = 16, N = 8192, slot 1 of 2, the
   other slot a sentinel, bit-exact; paged decode attention in bf16 at
   internlm2-1.8b's decode shape, B = 8, 16 q heads on 8 kv heads, hd
   128, 8-token pages, 1024 positions, and at phase 11's, B = 4, 32 q
   heads on 8 kv heads, hd 160, positions 543 and 159 (8 splits, as in
   the run); flash attention in bf16 at the prefill shapes of phase 8, at
   the launcher's eight 512-token prompts and at phase 11's two
   dispatches, 2 x 512 and 2 x 128 at stablelm-12b's heads; paged decode
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
   from a non-zero state with strongly negative log_f and large log_i);
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
12. time each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events (flash at
   phase 8's B = 3 x 128 dispatch, at the launcher's B = 8 x 512 and at
   phase 11's stablelm-12b B = 2 x 512, hd 160, in the row's ``shapes``
   list), and the device time of every kernel (and of the library call,
   where there is one) under ``torch.profiler``, since small calls are
   host-bound, by launched kernel where a call launches more than one (a
   profile that sees no kernel is taken again, with a warning line); the
   trunk's and the mLSTM kernel's bounds are their three TF32 passes at
   the TF32 tensor-core peak, the env step's its projection's three TF32
   passes plus the rest on the fp32 pipe (printed beside the fp32-pipe
   figure); each row also carries the host time of one call on its own
   (``host_ms``: CPU wall time, no synchronise); print one
   ``{"kernels": [...]}`` line.

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
FLASH_SHAPES = [(3, 128), (4, 512), (8, 512)]
# timed flash shapes (B, S, H, KH, hd): phase 8's dispatch and the
# launcher's at internlm2-1.8b's heads, and phase 11's two 512-token
# prompts at stablelm-12b's (hd 160, run at the padded width 192)
FLASH_TIMED = [(3, 128, 16, 8, 128), (8, 512, 16, 8, 128),
               (2, 512, 32, 8, 160)]
# kernels that must reach the tensor cores: (library stem, kernel name)
TENSOR_CORE = [("env_megakernel", "env_mega_step_kernel"),
               ("flash_attention", "flash_attention_mma_kernel"),
               ("fused_policy_mlp", "fused_policy_mlp_kernel"),
               ("mlstm_chunkwise", "mlstm_scores_kernel"),
               ("mlstm_chunkwise", "mlstm_cstate_kernel"),
               ("mlstm_chunkwise", "mlstm_out_kernel")]
A3C_ROUNDS = 3
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
    assert len(done) == len(reqs) and all(
        c.status == "ok" and len(c.tokens) == 64 for c in done)
    assert all(0 <= t < cfg.vocab_size for c in done for t in c.tokens)
    gen = tel.total_tokens - len(reqs)
    stats = {
        "setup_s": setup_s, "wall_s": wall,
        "prompt_tokens": tel.total_prompt_tokens,
        "generated_tokens": tel.total_tokens,
        "prefill_tok_s": tel.total_prompt_tokens / tel.total_prefill_s,
        "decode_tok_s": gen / tel.total_decode_s,
        "decode_steps": tel.total_decode_steps,
        "decode_ms_per_step": 1e3 * tel.total_decode_s
        / tel.total_decode_steps,
        "prefill_dispatches": eng.prefill_dispatches,
        "prefill_chunks": chunks,
        "end_to_end_tok_s": tel.total_tokens / wall,
        "cache_gb": eng.cache_bytes / 1e9,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    # oracle agreement (printed), with the B = 1 path's top-2 logit margin
    # at the first divergence: prefill the prompt, then decode the oracle's
    # own tokens up to it (xlstm's dense cache needs no page table)
    by_rid = {c.rid: c.tokens for c in done}
    agree = []
    for r in (reqs[4], reqs[7]):       # a 128-token and the 768-token prompt
        orc = eng.oracle_generate(r)
        got = by_rid[r.rid]
        n = next((i for i, (a, b) in enumerate(zip(orc, got)) if a != b),
                 len(orc))
        margin = None
        if n < len(orc):
            lg, cache = T.prefill(eng.params, cfg, {"tokens": torch.as_tensor(
                r.tokens[None], device=dev)}, eng.max_seq)
            for i in range(n):
                lg, cache = T.decode_step(
                    eng.params, cfg, torch.tensor([orc[i]], device=dev),
                    torch.tensor([len(r.tokens) + i], device=dev), cache)
            top = torch.topk(lg[0].float(), 2).values
            margin = float(top[0] - top[1])
        agree.append({"prompt": len(r.tokens), "matching": n,
                      "of": len(orc), "top2_margin_at_divergence": margin})
    stats["oracle"] = agree
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
    assert len(done) == len(reqs) and all(
        c.status == "ok" and len(c.tokens) == 64 for c in done)
    assert all(0 <= t < cfg.vocab_size for c in done for t in c.tokens)
    # the shared head's full pages are published in the prefix index
    assert eng.shared_head_pages(longs[1].tokens[:256]) == \
        256 // eng.page_size
    gen = tel.total_tokens - len(reqs)
    stats = {
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
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    # oracle agreement (printed): a short and the long chunked request
    by_rid = {c.rid: c.tokens for c in done}
    agree = []
    for r in (shorts[0], huge):
        orc = eng.oracle_generate(r)
        got = by_rid[r.rid]
        n = next((i for i, (a, b) in enumerate(zip(orc, got)) if a != b),
                 len(orc))
        margin = None
        if n < len(orc):
            toks = torch.as_tensor(list(r.tokens) + orc[:n], device=dev)
            lg = T.forward(eng.params, cfg, {"tokens": toks[None]})[0, -1]
            top = torch.topk(lg.float(), 2).values
            margin = float(top[0] - top[1])
        agree.append({"prompt": len(r.tokens), "matching": n,
                      "of": len(orc), "top2_margin_at_divergence": margin})
    stats["oracle"] = agree
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
    assert len(done) == len(reqs) and all(
        c.status == "ok" and len(c.tokens) == 32 for c in done)
    assert all(0 <= t < cfg.vocab_size for c in done for t in c.tokens)
    gen = tel.total_tokens - len(reqs)
    stats = {
        "layers": f"{SLAYERS} of {full.num_layers}",
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
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    # oracle agreement (printed, not asserted: bf16 GEMMs at B = 1 and
    # B = 4 round differently)
    by_rid = {c.rid: c.tokens for c in done}
    agree = []
    for r in (reqs[0], reqs[2]):
        orc = eng.oracle_generate(r)
        got = by_rid[r.rid]
        n = next((i for i, (a, b) in enumerate(zip(orc, got)) if a != b),
                 len(orc))
        agree.append({"prompt": len(r.tokens), "matching": n,
                      "of": len(orc)})
    stats["oracle"] = agree
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


def flash_bound(B, S, H, KH, hd, es):
    # q, k, v read once, out written once; QK^T and PV over the causal
    # pairs, 4 * hd flops each
    pairs = B * H * S * (S + 1) // 2
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
        "env_mega_step": max(check_env(ENV, N_MAIN, gen, dev, False),
                             check_env(ENV, N_MAIN, gen, dev, True)),
        "gae_norm": check_gae(T_MAIN, N_MAIN, gen, dev),
        "policy_mlp": check_trunk(trunk_dims, N_MAIN, gen, dev),
        "nstep_returns": check_nstep(T_MAIN, N_MAIN, gen, dev),
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
    launches = {k: sum(p[k] for p in by_path.values()) for k in TOL}

    # 12. timings -----------------------------------------------------------
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
    for fb, fs, fh, fkh, fhd in FLASH_TIMED:
        fq, fk, fv = flash_inputs(fb, fs, fh, fkh, fhd, gen, dev, bf)
        ft = [t.transpose(1, 2).contiguous() for t in (fq, fk, fv)]
        flash_t[(fb, fs, fhd)] = (
            lambda fq=fq, fk=fk, fv=fv: ops.flash_attention(fq, fk, fv),
            lambda fq=fq, fk=fk, fv=fv: ref.attention_ref(fq, fk, fv),
            lambda ft=ft: sdpa(*ft, is_causal=True, enable_gqa=True),
            flash_bound(fb, fs, fh, fkh, fhd, 2), PEAK_BF16)
    timings["paged_attention"] = (
        lambda: ops.paged_attention(*paged_main),
        lambda: ref.paged_attention_ref(*paged_main), None,
        paged_bound(paged_main), PEAK_BF16)
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
                                      **timed(k_, p_, l_, nb, no, *pk),
                                      "device_ms": device_ms(k_),
                                      "library_device_ms": device_ms(l_)})
            row.update({k: v for k, v in row["shapes"][0].items()
                        if k not in ("B", "S", "hd")})
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
            at = (f" B={sh['B']} S={sh['S']} hd={sh['hd']}" if "B" in sh
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
