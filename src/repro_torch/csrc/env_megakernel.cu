// Fused env step for sm_90a: physics substeps, reward, t/done bookkeeping,
// predicated counter-PRNG auto-reset, observation, and optional ring-row
// writes, in one launch.
//
// Replaces: src/repro/kernels/env_megakernel.py::env_mega_step (Pallas,
// body _mega_kernel, shared math _step_core).  Plain version:
// src/repro_torch/kernels/ref.py::mega_step (and env_mega_step_ref).
//
// What bounds it on an H100: bytes.  Per env it reads and writes a few
// hundred bytes of state (q, qd, action, root, counters, obs): at
// ShadowHand (J = 20, raw width R = 6+4J+3 = 89, obs_dim 211) and
// N = 16384, 23.0 MB, 6.9 us at 3.35 TB/s.  The observation projection
// obs = tanh(raw @ sensor) is 2 * 89 * 211 flops an env, 0.615 GFLOP;
// at f32 accuracy on the TF32 tensor cores (three passes, below) that is
// 1.85 GFLOP at 495 TFLOP/s, and the physics (~32 ops a joint a substep)
// adds ~0.04 GFLOP at 67 TFLOP/s: ~4.4 us of operations.  (On the fp32
// pipe alone the projection would take 9.9 us.)
//
// Design.  A block takes BE = 64 envs (one wgmma N tile) on 256 threads
// (two warpgroups) and runs two phases.
//
// Physics: each env's joints spread over a group of G = ENV_LANES lanes
// (4; 8 ties it and 32 is 1.5x slower, as kernel_times.py measures by
// building the source with -DENV_LANES), each lane holding a contiguous
// run of ceil(J / G) joints in registers with its per-joint constants.
// The
// neighbour coupling reads the boundary q of the next lanes by
// __shfl_up/down_sync over the group's width (joint 0 takes its own q as
// its left, joint J-1 its own as its right, as the reference's shifts
// do); the tip's cumsum is a serial prefix in each lane on top of an
// exclusive scan of the lane totals across the group; the thrust, reward
// and feature sums are __shfl_xor_sync butterflies, which leave the same
// bits in every lane of the group (each step adds a pair both ways
// round), so every lane keeps the same root and takes the same done
// branch.  sin(q) is computed once a substep and carried into the next
// substep's gravity term: the same float of the same q.  The predicated
// reset draws counter_normal(seed, resets, j) in the lane that holds
// joint j.  G = 4 puts all 256 threads to work on 64 envs at once; larger
// G loop over the block's envs in passes.  The PRNG uses native uint32
// arithmetic and wraps exactly like src/repro/envs/physics.py::hash_u32.
//
// Observation: the block's raw features (64 envs x R, zero-padded to
// K = 96) go to shared memory already split into TF32 hi and lo parts
// (x_hi = tf32(x) rounded to nearest, x_lo = x - x_hi), each in wgmma's
// 32-byte-swizzled K-major layout, 24 KB a part.  The product runs
// transposed, obs^T = sensor^T raw^T, so the block's raw tile is wgmma's
// B operand (N = the 64 envs) and the sensor is the register A operand:
// each warpgroup takes 64-column tiles of obs (c = wg, wg + 2, ...; four
// tiles at obs_dim 211, zero past obs_dim), loads its sensor fragments
// straight from global memory (75 KB, L2-resident), splits them in
// registers, and accumulates lo*hi + hi*lo + hi*hi in f32 on
// wgmma m64n64k8, six k-steps a batch.  The dropped lo*lo term and the
// split leave ~2^-21 of each product: f32-level accuracy.  The epilogue
// applies tanhf and stores only obs_dim columns and the block's envs.
// So the sensor needs no shared memory and no split launch, and raw
// never leaves the chip: one launch.
//
// Ring mode (ring pointers non-null): the acted-on obs and the raw action
// go to ring row step_t, columns [slot*N, (slot+1)*N), in 16-byte vectors
// where source and destination share their alignment (scalars at the
// ends, and everywhere when they do not); reward and done by scalar.
// Every scalar (step_t, slot, N, substeps, h, max_episode_len, the 13
// chain/task floats) is a runtime argument.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int MAXJ = 21;
constexpr int BE = 64;                   // envs a block: one wgmma N tile
constexpr int THREADS = 256;             // two warpgroups
constexpr int KP = 96;                   // raw width padded (R <= 93)
constexpr int KSTEPS = KP / 8;
constexpr int KBATCH = KSTEPS / 2;       // k-steps an MMA batch
constexpr int MAXOBS = 256;              // four 64-column obs tiles
constexpr int RAW_PART = KSTEPS * BE * 8;   // floats of one split part
constexpr int NCONST = 4;                // per-joint constants in smem
constexpr size_t SMEM_BYTES = (2 * RAW_PART + NCONST * 32) * 4;
constexpr unsigned FULL = 0xffffffffu;

#ifndef ENV_LANES
#define ENV_LANES 4
#endif
static_assert(ENV_LANES == 4 || ENV_LANES == 8 || ENV_LANES == 32,
              "a lane group is 4, 8 or 32 lanes of one warp");

struct Consts {
  float damping, coupling, stiffness, max_qd, gravity, torque_scale,
      ground_k, ground_c;
  float w_fwd, w_up, w_ctrl, w_tgt, fall_z;
  float h;                               // dt / substeps
};

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float counter_normal(uint32_t seed,
                                                uint32_t counter,
                                                uint32_t idx) {
  uint32_t base = hash_u32(seed ^ (counter * 0x9E3779B9u));
  uint32_t h1 = hash_u32(base + idx * 2u + 1u);
  uint32_t h2 = hash_u32(base + idx * 2u + 2u);
  float u1 = __fadd_rn(__fmul_rn((float)(h1 >> 8), 1.0f / 16777216.0f),
                       0.5f / 16777216.0f);
  float u2 = __fmul_rn((float)(h2 >> 8), 1.0f / 16777216.0f);
  float r = sqrtf(-2.0f * logf(u1));
  return r * cosf(6.28318530717958647692f * u2);
}

// x = hi + lo: hi rounded to TF32 (nearest, ties away, by integer add and
// mask), lo = x - hi exactly, passed as f32 bits, of which the MMA reads
// the TF32 part
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// float offset of (env n, k in 0..7) in one k-step's [BE][8] block of
// wgmma's 32-byte-swizzled K-major layout (the 16-byte half of each
// 32-byte row XORed with bit 2 of the row)
__device__ __forceinline__ int sw32(int n, int k) {
  return n * 8 + ((((k >> 2) ^ (n >> 2)) & 1) << 2) + (k & 3);
}

// raw feature k of the block's env n, split into the two B parts
__device__ __forceinline__ void put_raw(float* rawh, int n, int k, float x) {
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  const int o = (k >> 3) * BE * 8 + sw32(n, k & 7);
  rawh[o] = __uint_as_float(hi);
  rawh[RAW_PART + o] = __uint_as_float(lo);
}

// sum over the G lanes of a group; the same bits in every lane
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o, G);
  return v;
}

// the sum of v over the group's lanes before this one (0 in lane 0)
template <int G>
__device__ __forceinline__ float group_exclusive(float v, int r) {
  float x = v;
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const float y = __shfl_up_sync(FULL, x, o, G);
    if (r >= o) x += y;
  }
  const float ex = __shfl_up_sync(FULL, x, 1, G);
  return r == 0 ? 0.0f : ex;
}

// copy n floats, in 16-byte vectors where dst and src share their
// alignment, by the whole block
__device__ void copy_run(float* __restrict__ dst,
                         const float* __restrict__ src, long long n) {
  const int tid = threadIdx.x;
  const int md = (int)(((uintptr_t)dst >> 2) & 3);
  if (md == (int)(((uintptr_t)src >> 2) & 3)) {
    const long long head = min(n, (long long)((4 - md) & 3));
    const long long nv = (n - head) / 4;
    for (long long i = tid; i < head; i += THREADS) dst[i] = src[i];
    const float4* s4 = reinterpret_cast<const float4*>(src + head);
    float4* d4 = reinterpret_cast<float4*>(dst + head);
    for (long long i = tid; i < nv; i += THREADS) d4[i] = __ldg(s4 + i);
    for (long long i = head + 4 * nv + tid; i < n; i += THREADS)
      dst[i] = src[i];
  } else {
    for (long long i = tid; i < n; i += THREADS) dst[i] = src[i];
  }
}

template <int G>
__global__ void __launch_bounds__(THREADS, 2) env_mega_step_kernel(
    const float* __restrict__ q_in, const float* __restrict__ qd_in,
    const float* __restrict__ root_in, const int* __restrict__ t_in,
    const int* __restrict__ seed_in, const int* __restrict__ resets_in,
    const float* __restrict__ action, const float* __restrict__ obs_in,
    const float* __restrict__ sensor, const float* __restrict__ tgt,
    const float* __restrict__ masses, const float* __restrict__ lengths,
    float* __restrict__ q_o, float* __restrict__ qd_o,
    float* __restrict__ root_o, float* __restrict__ pa_o,
    int* __restrict__ t_o, int* __restrict__ resets_o,
    float* __restrict__ obs_o, float* __restrict__ rew_o,
    float* __restrict__ done_o, float* __restrict__ ring_obs,
    float* __restrict__ ring_act, float* __restrict__ ring_rew,
    float* __restrict__ ring_done, int N, int J, int obs_dim, int ring_cols,
    int step_t, int slot, int substeps, int max_len, Consts c) {
  constexpr int JL = (MAXJ + G - 1) / G;   // joints a lane at most
  constexpr int EP = THREADS / G;          // envs a pass
  // 1024-byte aligned (the kernel has no static shared memory)
  extern __shared__ __align__(1024) unsigned char smem[];
  float* rawh = reinterpret_cast<float*>(smem);   // hi, then lo
  float* gml_s = rawh + 2 * RAW_PART;   // gravity * mass * length
  float* inert_s = gml_s + 32;
  float* l_s = inert_s + 32;
  float* tgt_s = l_s + 32;

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * BE;
  const int nb = min(BE, N - e0);
  const int R = 6 + 4 * J + 3;
  if (tid < J) {
    const float m = masses[tid], l = lengths[tid];
    gml_s[tid] = c.gravity * m * l;
    inert_s[tid] = m * (l * l) + 1e-3f;
    l_s[tid] = l;
    tgt_s[tid] = tgt[tid];
  }
  __syncthreads();

  // ---- physics: G lanes an env, lane r holding joints [r*jl, r*jl + n)
  const int r = tid % G;
  const int jl = (J + G - 1) / G;
  const int j0 = r * jl;
  const int n = max(0, min(jl, J - j0));
  const float h = c.h;
  for (int el = tid / G; el < EP * ((BE + EP - 1) / EP); el += EP) {
    // a group past the block's envs computes env e0's step and stores
    // nothing to global memory: every lane of a warp must reach the
    // shuffles
    const bool live = el < nb;
    const int e = e0 + (live ? el : 0);
    float q[JL], qd[JL], a[JL], s[JL], gml[JL], inert[JL], len[JL];
#pragma unroll
    for (int i = 0; i < JL; ++i) {
      if (i < n) {
        const int j = j0 + i;
        q[i] = q_in[e * J + j];
        qd[i] = qd_in[e * J + j];
        a[i] = fminf(fmaxf(action[e * J + j], -1.0f), 1.0f);
        gml[i] = gml_s[j];
        inert[i] = inert_s[j];
        len[i] = l_s[j];
      } else {
        q[i] = qd[i] = a[i] = gml[i] = len[i] = 0.0f;
        inert[i] = 1.0f;
      }
      s[i] = sinf(q[i]);
    }
    float root[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) root[k] = root_in[e * 6 + k];
    const bool has_last = n > 0 && j0 + n == J;   // holds joint J - 1

    for (int st = 0; st < substeps; ++st) {
      // the boundary q of the neighbouring lanes (old q: qd is updated
      // first, from the old q only)
      float qlast = q[0];
#pragma unroll
      for (int i = 1; i < JL; ++i)
        if (i < n) qlast = q[i];
      const float qprev = __shfl_up_sync(FULL, qlast, 1, G);
      const float qnext = __shfl_down_sync(FULL, q[0], 1, G);
#pragma unroll
      for (int i = 0; i < JL; ++i) {
        if (i < n) {
          const float left =
              i > 0 ? q[i > 0 ? i - 1 : 0] : (r == 0 ? q[0] : qprev);
          float right;
          if (i + 1 < n)
            right = q[i + 1 < JL ? i + 1 : i];
          else
            right = has_last ? q[i] : qnext;
          const float lap = left - 2.0f * q[i] + right;
          const float grav = gml[i] * s[i];
          const float qdd = (c.torque_scale * a[i] - c.damping * qd[i]
                             - c.stiffness * q[i] - grav + c.coupling * lap)
                            / inert[i];
          qd[i] = fminf(fmaxf(qd[i] + h * qdd, -c.max_qd), c.max_qd);
        }
      }
      float tot = 0.0f;
#pragma unroll
      for (int i = 0; i < JL; ++i) {
        if (i < n) {
          q[i] = q[i] + h * qd[i];
          tot += q[i];
        }
      }
      float cum = group_exclusive<G>(tot, r);
      float tip = 0.0f, s_sin = 0.0f, s_cos2 = 0.0f;
#pragma unroll
      for (int i = 0; i < JL; ++i) {
        if (i < n) {
          cum += q[i];
          tip += len[i] * cosf(cum);
          s[i] = sinf(q[i]);
          s_sin += s[i] * a[i];
          s_cos2 += cosf(2.0f * q[i]) * a[i];
        }
      }
      tip = group_sum<G>(tip);
      s_sin = group_sum<G>(s_sin);
      s_cos2 = group_sum<G>(s_cos2);
      const float tip_h = root[2] + tip;
      const float pen = fmaxf(-tip_h, 0.0f);
      const float contact = c.ground_k * pen
          - c.ground_c * fminf(root[5], 0.0f) * (pen > 0.0f ? 1.0f : 0.0f);
      const float thrust[3] = {s_sin / (float)J * c.torque_scale,
                               0.1f * (s_cos2 / (float)J),
                               contact - c.gravity * 0.5f};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float vel = (root[3 + k] + h * thrust[k]) * 0.98f;
        root[3 + k] = vel;
        root[k] = root[k] + h * vel;
      }
      root[2] = fmaxf(root[2], 0.05f);
    }

    float s_q = 0.0f, s_a2 = 0.0f, s_tgt = 0.0f;
#pragma unroll
    for (int i = 0; i < JL; ++i) {
      if (i < n) {
        s_q += q[i];
        s_a2 += a[i] * a[i];
        const float dq = q[i] - tgt_s[j0 + i];
        s_tgt += dq * dq;
      }
    }
    s_q = group_sum<G>(s_q);
    s_a2 = group_sum<G>(s_a2);
    s_tgt = group_sum<G>(s_tgt);
    const float reward = c.w_fwd * root[3] + c.w_up * cosf(s_q / (float)J)
                         - c.w_ctrl * s_a2 - c.w_tgt * (s_tgt / (float)J)
                         + 0.5f;
    int t = t_in[e] + 1;
    int resets = resets_in[e];
    const bool done = (t >= max_len) || (root[2] < c.fall_z);
    if (done) {
      resets += 1;
      const uint32_t sd = (uint32_t)seed_in[e];
#pragma unroll
      for (int i = 0; i < JL; ++i) {
        if (i < n) {
          q[i] = 0.1f * counter_normal(sd, (uint32_t)resets,
                                       (uint32_t)(j0 + i));
          s[i] = sinf(q[i]);
          qd[i] = 0.0f;
          a[i] = 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) root[k] = (k == 2) ? 0.6f : 0.0f;
      t = 0;
    }
    const float done_f = done ? 1.0f : 0.0f;

    // raw features: root, sin q, cos q, qd, pa, tip, height, mean |qd|;
    // zero from R to KP
    float tot = 0.0f;
#pragma unroll
    for (int i = 0; i < JL; ++i)
      if (i < n) tot += q[i];
    float cum = group_exclusive<G>(tot, r);
    float tip = 0.0f, s_abs = 0.0f;
#pragma unroll
    for (int i = 0; i < JL; ++i) {
      if (i < n) {
        const int j = j0 + i;
        cum += q[i];
        tip += len[i] * cosf(cum);
        s_abs += fabsf(qd[i]);
        put_raw(rawh, el, 6 + j, s[i]);
        put_raw(rawh, el, 6 + J + j, cosf(q[i]));
        put_raw(rawh, el, 6 + 2 * J + j, qd[i]);
        put_raw(rawh, el, 6 + 3 * J + j, a[i]);   // prev_action
        if (live) {
          q_o[e * J + j] = q[i];
          qd_o[e * J + j] = qd[i];
          pa_o[e * J + j] = a[i];
        }
      }
    }
    tip = group_sum<G>(tip);
    s_abs = group_sum<G>(s_abs);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (k % G == r) {
        put_raw(rawh, el, k, root[k]);
        if (live) root_o[e * 6 + k] = root[k];
      }
    }
    for (int k = R + r; k < KP; k += G) put_raw(rawh, el, k, 0.0f);
    if (r == 0) {
      put_raw(rawh, el, 6 + 4 * J, root[2] + tip);
      put_raw(rawh, el, 6 + 4 * J + 1, root[2] - 0.6f);
      put_raw(rawh, el, 6 + 4 * J + 2, s_abs / (float)J);
      if (live) {
        t_o[e] = t;
        resets_o[e] = resets;
        rew_o[e] = reward;
        done_o[e] = done_f;
        if (ring_rew != nullptr) {
          const long long rc =
              (long long)step_t * ring_cols + (long long)slot * N + e;
          ring_rew[rc] = reward;
          ring_done[rc] = done_f;
        }
      }
    }
  }
  wg::fence_shared();   // the raw tile is read by wgmma (async proxy)
  __syncthreads();

  // ---- observation: obs^T (64-column tiles) = sensor^T raw^T, 3xTF32
  const int warp = tid / 32, lane = tid % 32;
  const int wgi = warp / 4, w4 = warp % 4;
  const int g = lane >> 2, tq = lane & 3;
  const int mtiles = (obs_dim + 63) / 64;
  for (int mt = wgi; mt < mtiles; mt += 2) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    // this thread's A rows (obs columns) and their guard
    const int ca = 64 * mt + 16 * w4 + g, cb = ca + 8;
#pragma unroll
    for (int kb = 0; kb < KSTEPS; kb += KBATCH) {
      uint32_t ah[KBATCH][4], al[KBATCH][4];
#pragma unroll
      for (int j = 0; j < KBATCH; ++j) {
        const int k = 8 * (kb + j) + tq;
        const float* s0 = sensor + (long long)k * obs_dim;
        const float* s4 = s0 + 4 * obs_dim;
        const bool k0ok = k < R, k4ok = k + 4 < R;
        split_tf32(k0ok && ca < obs_dim ? __ldg(s0 + ca) : 0.0f, ah[j][0],
                   al[j][0]);
        split_tf32(k0ok && cb < obs_dim ? __ldg(s0 + cb) : 0.0f, ah[j][1],
                   al[j][1]);
        split_tf32(k4ok && ca < obs_dim ? __ldg(s4 + ca) : 0.0f, ah[j][2],
                   al[j][2]);
        split_tf32(k4ok && cb < obs_dim ? __ldg(s4 + cb) : 0.0f, ah[j][3],
                   al[j][3]);
      }
      wg::fence();
#pragma unroll
      for (int j = 0; j < KBATCH; ++j) {
        const float* bh = rawh + (kb + j) * BE * 8;
        const uint64_t dhi = wg::desc(bh, 16, 256, wg::SW32);
        const uint64_t dlo = wg::desc(bh + RAW_PART, 16, 256, wg::SW32);
        wg::wgmma_m64n64k8_tf32_rs(acc, al[j], dhi);
        wg::wgmma_m64n64k8_tf32_rs(acc, ah[j], dlo);
        wg::wgmma_m64n64k8_tf32_rs(acc, ah[j], dhi);
      }
      wg::commit();
      wg::wait_all();
    }
    // accumulator element i: obs column 64 mt + 16 w4 + g + 8 ((i/2) % 2),
    // env 8 (i/4) + 2 tq + i % 2
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = (((i >> 1) & 1) ? cb : ca);
      const int en = 8 * (i >> 2) + 2 * tq + (i & 1);
      if (col < obs_dim && en < nb)
        obs_o[(long long)(e0 + en) * obs_dim + col] = tanhf(acc[i]);
    }
  }

  if (ring_obs != nullptr) {
    const long long row =
        (long long)step_t * ring_cols + (long long)slot * N + e0;
    copy_run(ring_obs + row * obs_dim, obs_in + (long long)e0 * obs_dim,
             (long long)nb * obs_dim);
    copy_run(ring_act + row * J, action + (long long)e0 * J,
             (long long)nb * J);
  }
}

}  // namespace

extern "C" int env_mega_step_launch(
    const float* q, const float* qd, const float* root, const int* t,
    const int* seed, const int* resets, const float* action,
    const float* obs_in, const float* sensor, const float* tgt,
    const float* masses, const float* lengths, float* q_o, float* qd_o,
    float* root_o, float* pa_o, int* t_o, int* resets_o, float* obs_o,
    float* rew_o, float* done_o, float* ring_obs, float* ring_act,
    float* ring_rew, float* ring_done, int N, int J, int obs_dim,
    int ring_cols, int step_t, int slot, int substeps, int max_len,
    const float* consts, void* stream) {
  if (J < 1 || J > MAXJ || N < 1 || obs_dim < 1 || obs_dim > MAXOBS)
    return (int)cudaErrorInvalidValue;
  Consts c;
  c.damping = consts[0];
  c.coupling = consts[1];
  c.stiffness = consts[2];
  c.max_qd = consts[3];
  c.gravity = consts[4];
  c.torque_scale = consts[5];
  c.ground_k = consts[6];
  c.ground_c = consts[7];
  c.w_fwd = consts[8];
  c.w_up = consts[9];
  c.w_ctrl = consts[10];
  c.w_tgt = consts[11];
  c.fall_z = consts[12];
  c.h = consts[13];
  static unsigned long long sized = 0;
  cudaError_t err = wg::allow_smem(env_mega_step_kernel<ENV_LANES>,
                                   (int)SMEM_BYTES, sized);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + BE - 1) / BE;
  env_mega_step_kernel<ENV_LANES>
      <<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
          q, qd, root, t, seed, resets, action, obs_in, sensor, tgt, masses,
          lengths, q_o, qd_o, root_o, pa_o, t_o, resets_o, obs_o, rew_o,
          done_o, ring_obs, ring_act, ring_rew, ring_done, N, J, obs_dim,
          ring_cols, step_t, slot, substeps, max_len, c);
  return (int)cudaGetLastError();
}
