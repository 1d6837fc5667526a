// Fused env step for sm_90a: physics substeps, reward, t/done bookkeeping,
// predicated counter-PRNG auto-reset, observation, and optional ring-row
// writes, in one launch.
//
// Replaces: src/repro/kernels/env_megakernel.py::env_mega_step (Pallas,
// body _mega_kernel, shared math _step_core).  Plain version:
// src/repro_torch/kernels/ref.py::mega_step (and env_mega_step_ref).
//
// What bounds it on an H100: per env it reads and writes a few hundred
// bytes of state (q, qd, action, root, counters) and does the observation
// projection obs = tanh(raw @ sensor), 2 * (6+4J+3) * obs_dim flops (for
// ShadowHand 2*89*211 = 37.6 kflop/env), plus substeps*J sin/cos.  At
// N = 16384 that is ~20 MB and ~0.7 GFLOP of fp32: neither the 3.35 TB/s
// nor the 67 TFLOP/s bound is above ~10 us, so launch latency and the
// serial substep chain inside one thread decide the time.
//
// Design: one thread per env for the physics (J <= 21: q, qd and the
// clipped action live in registers, loops unrolled to 21 with a J guard;
// chain constants in shared memory).  The per-env done predicate picks the
// reset branch, replacing the block-wide lax.cond(any(done)) of the
// reference with the same values.  Each env's raw feature row goes to
// shared memory; then all 256 threads of the block compute the block's
// (64 x obs_dim) observations with consecutive threads on consecutive
// sensor columns, so sensor reads coalesce and go through L1 (ShadowHand's
// sensor is 89x211 f32 = 75 KB, above the 48 KB of static shared memory).
// Every scalar (step_t, slot, N, substeps, h, max_episode_len, the 13
// chain/task floats) is a runtime argument; ring pointers may be null,
// which is the no-ring mode.  The PRNG uses native uint32 arithmetic and
// wraps exactly like src/repro/envs/physics.py::hash_u32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXJ = 21;
constexpr int MAXR = 6 + 4 * MAXJ + 3;   // raw feature width at J = 21
constexpr int BE = 64;                   // envs per block
constexpr int THREADS = 256;

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

__global__ void __launch_bounds__(THREADS) env_mega_step_kernel(
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
  __shared__ float raw_s[BE * MAXR];
  __shared__ float m_s[MAXJ], l_s[MAXJ], inert_s[MAXJ], tgt_s[MAXJ];

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * BE;
  const int nb = min(BE, N - e0);
  const int R = 6 + 4 * J + 3;
  if (tid < J) {
    float m = masses[tid], l = lengths[tid];
    m_s[tid] = m;
    l_s[tid] = l;
    inert_s[tid] = m * (l * l) + 1e-3f;
    tgt_s[tid] = tgt[tid];
  }
  __syncthreads();

  if (tid < nb) {
    const int e = e0 + tid;
    float q[MAXJ], qd[MAXJ], a[MAXJ];
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      if (j < J) {
        q[j] = q_in[e * J + j];
        qd[j] = qd_in[e * J + j];
        a[j] = fminf(fmaxf(action[e * J + j], -1.0f), 1.0f);
      } else {
        q[j] = qd[j] = a[j] = 0.0f;
      }
    }
    float root[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) root[k] = root_in[e * 6 + k];
    const float h = c.h;

    for (int s = 0; s < substeps; ++s) {
      // qd update reads the old q only, so qd is updated in place first
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j < J) {
          float left = q[j > 0 ? j - 1 : 0];
          float right = (j + 1 < J) ? q[j + 1 < MAXJ ? j + 1 : j] : q[j];
          float lap = left - 2.0f * q[j] + right;
          float grav = c.gravity * m_s[j] * l_s[j] * sinf(q[j]);
          float qdd = (c.torque_scale * a[j] - c.damping * qd[j]
                       - c.stiffness * q[j] - grav + c.coupling * lap)
                      / inert_s[j];
          qd[j] = fminf(fmaxf(qd[j] + h * qdd, -c.max_qd), c.max_qd);
        }
      }
      float cum = 0.0f, tip = 0.0f, s_sin = 0.0f, s_cos2 = 0.0f;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j < J) {
          q[j] = q[j] + h * qd[j];
          cum += q[j];
          tip += l_s[j] * cosf(cum);
          s_sin += sinf(q[j]) * a[j];
          s_cos2 += cosf(2.0f * q[j]) * a[j];
        }
      }
      float tip_h = root[2] + tip;
      float pen = fmaxf(-tip_h, 0.0f);
      float contact = c.ground_k * pen
                      - c.ground_c * fminf(root[5], 0.0f) * (pen > 0.0f ? 1.0f : 0.0f);
      float thrust[3] = {s_sin / (float)J * c.torque_scale, 0.1f * (s_cos2 / (float)J),
                         contact - c.gravity * 0.5f};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float vel = (root[3 + k] + h * thrust[k]) * 0.98f;
        root[3 + k] = vel;
        root[k] = root[k] + h * vel;
      }
      root[2] = fmaxf(root[2], 0.05f);
    }

    float s_q = 0.0f, s_a2 = 0.0f, s_tgt = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      if (j < J) {
        s_q += q[j];
        s_a2 += a[j] * a[j];
        float dq = q[j] - tgt_s[j];
        s_tgt += dq * dq;
      }
    }
    float reward = c.w_fwd * root[3] + c.w_up * cosf(s_q / (float)J)
                   - c.w_ctrl * s_a2 - c.w_tgt * (s_tgt / (float)J) + 0.5f;
    int t = t_in[e] + 1;
    int resets = resets_in[e];
    bool done = (t >= max_len) || (root[2] < c.fall_z);
    if (done) {
      resets += 1;
      const uint32_t sd = (uint32_t)seed_in[e];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j < J) {
          q[j] = 0.1f * counter_normal(sd, (uint32_t)resets, (uint32_t)j);
          qd[j] = 0.0f;
          a[j] = 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) root[k] = (k == 2) ? 0.6f : 0.0f;
      t = 0;
    }
    const float done_f = done ? 1.0f : 0.0f;
    // raw features for the observation: root, sin q, cos q, qd, pa, extras
    float* raw = raw_s + tid * MAXR;
    float cum = 0.0f, tip = 0.0f, s_abs = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      raw[k] = root[k];
      root_o[e * 6 + k] = root[k];
    }
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      if (j < J) {
        raw[6 + j] = sinf(q[j]);
        raw[6 + J + j] = cosf(q[j]);
        raw[6 + 2 * J + j] = qd[j];
        raw[6 + 3 * J + j] = a[j];   // prev_action = clipped action
        cum += q[j];
        tip += l_s[j] * cosf(cum);
        s_abs += fabsf(qd[j]);
        q_o[e * J + j] = q[j];
        qd_o[e * J + j] = qd[j];
        pa_o[e * J + j] = a[j];
      }
    }
    raw[6 + 4 * J] = root[2] + tip;
    raw[6 + 4 * J + 1] = root[2] - 0.6f;
    raw[6 + 4 * J + 2] = s_abs / (float)J;
    t_o[e] = t;
    resets_o[e] = resets;
    rew_o[e] = reward;
    done_o[e] = done_f;
    if (ring_rew != nullptr) {
      const long long rc = (long long)step_t * ring_cols + (long long)slot * N + e;
      ring_rew[rc] = reward;
      ring_done[rc] = done_f;
    }
  }
  __syncthreads();

  // observation: (nb x obs_dim) outputs over the block's 256 threads
  for (int i = tid; i < nb * obs_dim; i += THREADS) {
    const int el = i / obs_dim, k = i - el * obs_dim;
    const float* raw = raw_s + el * MAXR;
    float acc = 0.0f;
    for (int r = 0; r < R; ++r) acc += raw[r] * __ldg(sensor + r * obs_dim + k);
    obs_o[(long long)(e0 + el) * obs_dim + k] = tanhf(acc);
  }
  if (ring_obs != nullptr) {
    const long long row = (long long)step_t * ring_cols + (long long)slot * N + e0;
    for (int i = tid; i < nb * obs_dim; i += THREADS)
      ring_obs[row * obs_dim + i] = obs_in[(long long)e0 * obs_dim + i];
    for (int i = tid; i < nb * J; i += THREADS)
      ring_act[row * J + i] = action[(long long)e0 * J + i];
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
  if (J < 1 || J > MAXJ || N < 1 || obs_dim < 1) return (int)cudaErrorInvalidValue;
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
  const int blocks = (N + BE - 1) / BE;
  env_mega_step_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      q, qd, root, t, seed, resets, action, obs_in, sensor, tgt, masses,
      lengths, q_o, qd_o, root_o, pa_o, t_o, resets_o, obs_o, rew_o, done_o,
      ring_obs, ring_act, ring_rew, ring_done, N, J, obs_dim, ring_cols,
      step_t, slot, substeps, max_len, c);
  return (int)cudaGetLastError();
}
