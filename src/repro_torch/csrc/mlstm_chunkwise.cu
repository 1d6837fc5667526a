// Chunkwise mLSTM (xLSTM's matrix-memory recurrence) for sm_90a, with the
// carried state in and out.
//
// Replaces: src/repro/kernels/mlstm_scan.py::mlstm_chunkwise (Pallas, grid
// (B*H, chunks) with the chunk axis sequential and C (dh x dh), n (dh) and
// m resident in VMEM scratch).  This kernel also starts from a given
// (C0, n0, m0) and writes the final (C, n, m), which the model needs for
// chunked prefill and decode; from a zero state with the state outputs
// dropped it computes what the TPU kernel computes.  Plain version:
// src/repro_torch/kernels/ref.py::mlstm_chunkwise_ref (the chunk math of
// src/repro_torch/models/ssm.py::_mlstm_chunk).
//
// Per chunk of L steps, with b the in-chunk cumsum of log_f:
//   lw[t,s]  = b_t - b_s + log_i_s (s <= t; masked otherwise)
//   m_t      = max(m_prev + b_t, max_s lw[t,s])
//   P[t,s]   = (q_t . k_s) * dh^-1/2 * exp(lw[t,s] - m_t)
//   h_t      = (sum_s P[t,s] v_s + w_t dh^-1/2 q_t C^T)
//              / max(|sum_s P[t,s] + w_t dh^-1/2 q_t . n_prev|, exp(-m_t))
//              with w_t = exp(m_prev + b_t - m_t);
//   then the chunk-end update of C (stored v (x) k), n and m.
//
// What bounds it on an H100: operations.  Per (b, h, chunk) it needs
// 2 L^2 dh for q k^T, 2 L^2 dh for P v and 4 L dh^2 for q C^T and the C
// update (the causal mask halves the first two); at dh = 512, L = 256 that
// is ~100x more flops than bytes, far above the fp32 machine balance.  This
// first kernel runs on the fp32 FMA pipe (TF32/bf16 wgmma is later work).
//
// Design.  One block cannot hold a (b, h)'s state: C is dh x dh f32, 1 MB
// at dh = 512, and Hopper has 227 KB of shared memory a block.  The TPU's
// grid (B*H blocks) would also fill only 16 of 132 SMs at the prefill
// shapes.  So three launches:
//   1. state scan, one block per (b, h), walking the chunks in order:
//      b (sequential cumsum, as the plain version's), m_prev of each chunk,
//      the chunk-end m, weights w_c and decay, n carried across chunks, and
//      q_t . n_prev for each step.  O(S dh) work a (b, h): cheap.
//   2. intra-chunk scores, one block per (b, h, chunk, 64 queries): the
//      64 x 64 tiles of q k^T over dh (register-blocked 4 x 4 a thread,
//      q and k tiles staged in shared memory), tiles above the diagonal
//      skipped; m_t from the exact row max of lw; writes P (B*H, S, L) to a
//      scratch tensor, and w_t and the denominator of each step.  This
//      is the only part that needs all of dh for a (t, s) pair, so it is
//      computed once instead of once per row tile of C.
//   3. state walk, one block per (b, h, 32 rows of C): rows of C are v's
//      dims and h's columns, so a block owns its 32 x dh row tile of C in
//      shared memory for the whole sequence and walks the chunks in order:
//      h for its 32 columns (q C^T over dh, and P v over the causal
//      prefix), then the C update from k and w_c v.  No state leaves the
//      chip between chunks.
// Masked entries never reach exp(): P is 0 there, so no NaN; a chunk of
// L = 1 (a one-token prompt) works.  The chunk length is a runtime value.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TQ = 64;      // query rows a tile (launches 2 and 3)
constexpr int KE = 32;      // reduction depth staged a step
constexpr int DT = 32;      // rows of C a block owns (launch 3)

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------- 1 ------
// Dynamic shared memory: n[dh], bc[L], li[L], wc[L].
__global__ void __launch_bounds__(THREADS) mlstm_state_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ log_i, const float* __restrict__ log_f,
    const float* __restrict__ n0, const float* __restrict__ m0,
    float* __restrict__ n_out, float* __restrict__ m_out,
    float* __restrict__ bcum, float* __restrict__ qn,
    float* __restrict__ wc_g, float* __restrict__ mprev_g,
    float* __restrict__ decay_g, int S, int L, int dh) {
  extern __shared__ float sm[];
  float* n = sm;
  float* bc = n + dh;
  float* li = bc + L;
  float* wc = li + L;
  __shared__ float red[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.x;
  const int nc = S / L;
  const float* qb = q + bh * S * dh;
  const float* kb = k + bh * S * dh;
  for (int e = tid; e < dh; e += THREADS) n[e] = n0[bh * dh + e];
  float m = m0[bh];
  for (int c = 0; c < nc; ++c) {
    const long long base = bh * S + (long long)c * L;
    for (int t = tid; t < L; t += THREADS) li[t] = log_i[base + t];
    if (tid == 0) {
      float acc = 0.0f;
      for (int t = 0; t < L; ++t) {
        acc += log_f[base + t];
        bc[t] = acc;
      }
      mprev_g[bh * nc + c] = m;
    }
    __syncthreads();
    for (int t = tid; t < L; t += THREADS) bcum[base + t] = bc[t];
    // q_t . n_prev, one warp a step
    for (int t = warp; t < L; t += THREADS / 32) {
      const float* qr = qb + ((long long)c * L + t) * dh;
      float s = 0.0f;
      for (int e = lane; e < dh; e += 32) s = fmaf(qr[e], n[e], s);
      s = warp_sum(s);
      if (lane == 0) qn[base + t] = s;
    }
    // chunk-end stabiliser: max(m + b_L, max_s (log_i_s + (b_L - b_s)))
    const float bl = bc[L - 1];
    float mx = -INFINITY;
    for (int s = tid; s < L; s += THREADS) mx = fmaxf(mx, li[s] + (bl - bc[s]));
    mx = warp_max(mx);
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    mx = red[0];
    for (int w = 1; w < THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
    const float m_new = fmaxf(m + bl, mx);
    for (int s = tid; s < L; s += THREADS) {
      const float w = expf(((li[s] + bl) - bc[s]) - m_new);
      wc[s] = w;
      wc_g[base + s] = w;
    }
    const float decay = expf((m + bl) - m_new);
    if (tid == 0) decay_g[bh * nc + c] = decay;
    __syncthreads();   // wc complete; every read of n for q . n done
    const float* kc = kb + (long long)c * L * dh;
    for (int e = tid; e < dh; e += THREADS) {
      float acc = 0.0f;
      for (int s = 0; s < L; ++s) acc = fmaf(wc[s], kc[(long long)s * dh + e], acc);
      n[e] = decay * n[e] + acc;
    }
    m = m_new;
    __syncthreads();   // n, bc, li, wc reused by the next chunk
  }
  for (int e = tid; e < dh; e += THREADS) n_out[bh * dh + e] = n[e];
  if (tid == 0) m_out[bh] = m;
}

// ---------------------------------------------------------------- 2 ------
// grid (ceil(L / TQ), chunks, B*H).  Dynamic shared memory: bc[L], li[L].
__global__ void __launch_bounds__(THREADS) mlstm_intra_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ log_i, const float* __restrict__ bcum,
    const float* __restrict__ qn, const float* __restrict__ mprev_g,
    float* __restrict__ P, float* __restrict__ coef,
    float* __restrict__ denom, int S, int L, int dh, float scale) {
  extern __shared__ float sm[];
  float* bc = sm;
  float* li = bc + L;
  __shared__ float As[KE][TQ + 1];
  __shared__ float Bs[KE][TQ + 1];
  __shared__ float mrow[TQ];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = blockIdx.x * TQ, c = blockIdx.y;
  const long long bh = blockIdx.z;
  const int nc = S / L;
  const long long base = bh * S + (long long)c * L;   // row of step 0
  for (int t = tid; t < L; t += THREADS) {
    bc[t] = bcum[base + t];
    li[t] = log_i[base + t];
  }
  const float mp = mprev_g[bh * nc + c];
  __syncthreads();
  {   // m_t from the exact row max of lw, four threads a row
    const int r = tid >> 2, l4 = tid & 3, t = t0 + r;
    float mx = -INFINITY;
    if (t < L) {
      const float bt = bc[t];
      for (int s = l4; s <= t; s += 4) mx = fmaxf(mx, (bt - bc[s]) + li[s]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (l4 == 0) mrow[r] = t < L ? fmaxf(mp + bc[t], mx) : 0.0f;
  }
  __syncthreads();
  const int tend = min(t0 + TQ, L);
  float rs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int s0 = 0; s0 < tend; s0 += TQ) {
    float acc[4][4] = {};
    for (int e0 = 0; e0 < dh; e0 += KE) {
      for (int i = tid; i < TQ * KE; i += THREADS) {
        const int row = i / KE, e = i % KE;
        As[e][row] = t0 + row < L ? q[(base + t0 + row) * dh + e0 + e] : 0.0f;
        Bs[e][row] = s0 + row < L ? k[(base + s0 + row) * dh + e0 + e] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int e = 0; e < KE; ++e) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[e][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[e][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, t = t0 + r;
      if (t >= L) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx + 16 * j;
        if (s >= L) continue;
        float p = 0.0f;
        if (s <= t) {
          const float lw = (bc[t] - bc[s]) + li[s];
          p = (acc[i][j] * scale) * expf(lw - mrow[r]);
        }
        P[(base + t) * L + s] = p;
        rs[i] += p;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = rs[i];
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int r = ty + 16 * i, t = t0 + r;
    if (tx == 0 && t < L) {
      const float mt = mrow[r];
      const float w = expf((mp + bc[t]) - mt);
      coef[base + t] = w;
      denom[base + t] = fmaxf(fabsf(v + w * (scale * qn[base + t])), expf(-mt));
    }
  }
}

// ---------------------------------------------------------------- 3 ------
// grid (dh / DT, B*H).  Dynamic shared memory: Cs[DT][dh + 1], Qs[KE][TQ + 1],
// Ps[KE][TQ + 1], Vs[KE][DT + 1].
__global__ void __launch_bounds__(THREADS) mlstm_inter_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ C0,
    const float* __restrict__ P, const float* __restrict__ coef,
    const float* __restrict__ denom, const float* __restrict__ wc_g,
    const float* __restrict__ decay_g, float* __restrict__ h,
    float* __restrict__ C_out, int S, int L, int dh, float scale) {
  extern __shared__ float sm[];
  const int cs = dh + 1;
  float* Cs = sm;
  float* Qs = Cs + DT * cs;
  float* Ps = Qs + KE * (TQ + 1);
  float* Vs = Ps + KE * (TQ + 1);
  const int tid = threadIdx.x, td = tid & 15, tt = tid >> 4;
  const int d0 = blockIdx.x * DT;
  const long long bh = blockIdx.y;
  const int nc = S / L;
  const float* Cin = C0 + (bh * dh + d0) * dh;
  for (int i = tid; i < DT * dh; i += THREADS) Cs[(i / dh) * cs + i % dh] = Cin[i];
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    const long long base = bh * S + (long long)c * L;
    for (int t0 = 0; t0 < L; t0 += TQ) {
      const int tend = min(t0 + TQ, L);
      float ai[4][2] = {}, ap[4][2] = {};
      for (int e0 = 0; e0 < dh; e0 += KE) {          // q C^T over dh
        for (int i = tid; i < TQ * KE; i += THREADS) {
          const int row = i / KE, e = i % KE;
          Qs[e * (TQ + 1) + row] =
              t0 + row < L ? q[(base + t0 + row) * dh + e0 + e] : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int e = 0; e < KE; ++e) {
          const float c0 = Cs[td * cs + e0 + e], c1 = Cs[(td + 16) * cs + e0 + e];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = Qs[e * (TQ + 1) + tt + 16 * i];
            ai[i][0] = fmaf(a, c0, ai[i][0]);
            ai[i][1] = fmaf(a, c1, ai[i][1]);
          }
        }
        __syncthreads();
      }
      for (int s0 = 0; s0 < tend; s0 += KE) {         // P v, causal prefix
        for (int i = tid; i < TQ * KE; i += THREADS) {
          const int row = i / KE, s = i % KE;
          Ps[s * (TQ + 1) + row] = t0 + row < L && s0 + s < tend
              ? P[(base + t0 + row) * L + s0 + s] : 0.0f;
        }
        for (int i = tid; i < KE * DT; i += THREADS) {
          const int s = i / DT, d = i % DT;
          Vs[s * (DT + 1) + d] =
              s0 + s < tend ? v[(base + s0 + s) * dh + d0 + d] : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int s = 0; s < KE; ++s) {
          const float v0 = Vs[s * (DT + 1) + td], v1 = Vs[s * (DT + 1) + td + 16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = Ps[s * (TQ + 1) + tt + 16 * i];
            ap[i][0] = fmaf(p, v0, ap[i][0]);
            ap[i][1] = fmaf(p, v1, ap[i][1]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + tt + 16 * i;
        if (t >= L) continue;
        const float w = coef[base + t], den = denom[base + t];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          h[(base + t) * dh + d0 + td + 16 * j] =
              (ap[i][j] + w * (scale * ai[i][j])) / den;
      }
    }
    // chunk-end update: C = decay C + sum_s (w_c[s] v_s) (x) k_s, rows d0..
    // d0+DT of C; each thread owns columns e = tid and tid + THREADS.
    const float decay = decay_g[bh * nc + c];
    float acc[DT][2];
    const int e_0 = tid, e_1 = tid + THREADS;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] = e_0 < dh ? decay * Cs[d * cs + e_0] : 0.0f;
      acc[d][1] = e_1 < dh ? decay * Cs[d * cs + e_1] : 0.0f;
    }
    __syncthreads();   // every read of this chunk's C done; Vs reused below
    for (int s0 = 0; s0 < L; s0 += KE) {
      for (int i = tid; i < KE * DT; i += THREADS) {
        const int s = i / DT, d = i % DT;
        Vs[s * (DT + 1) + d] = s0 + s < L
            ? wc_g[base + s0 + s] * v[(base + s0 + s) * dh + d0 + d] : 0.0f;
      }
      __syncthreads();
      const int send = min(KE, L - s0);
      for (int s = 0; s < send; ++s) {
        const float* kr = k + (base + s0 + s) * dh;
        const float k0 = e_0 < dh ? kr[e_0] : 0.0f;
        const float k1 = e_1 < dh ? kr[e_1] : 0.0f;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const float wv = Vs[s * (DT + 1) + d];
          acc[d][0] = fmaf(wv, k0, acc[d][0]);
          acc[d][1] = fmaf(wv, k1, acc[d][1]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      if (e_0 < dh) Cs[d * cs + e_0] = acc[d][0];
      if (e_1 < dh) Cs[d * cs + e_1] = acc[d][1];
    }
    __syncthreads();
  }
  float* Co = C_out + (bh * dh + d0) * dh;
  for (int i = tid; i < DT * dh; i += THREADS) Co[i] = Cs[(i / dh) * cs + i % dh];
}

}  // namespace

// Shapes: q, k, v, h (BH, S, dh); log_i, log_f (BH, S); C0, C (BH, dh, dh);
// n0, n (BH, dh); m0, m (BH,).  Scratch: P (BH, S, L); bcum, qn, wc, coef,
// denom (BH, S); mprev, decay (BH, S / L).  All f32, contiguous.  Needs
// S % L == 0, dh % 32 == 0 and 32 <= dh <= 512.
extern "C" int mlstm_chunkwise_launch(
    const float* q, const float* k, const float* v, const float* log_i,
    const float* log_f, const float* C0, const float* n0, const float* m0,
    float* h, float* C, float* n, float* m, float* P, float* bcum, float* qn,
    float* wc, float* coef, float* denom, float* mprev, float* decay, int BH,
    int S, int L, int dh, void* stream) {
  if (BH < 1 || S < 1 || L < 1 || S % L || dh % DT || dh < DT ||
      dh > 2 * THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)dh);
  const int nc = S / L;
  const size_t sm1 = sizeof(float) * (dh + 3 * (size_t)L);
  const size_t sm2 = sizeof(float) * 2 * (size_t)L;
  const size_t sm3 = sizeof(float) *
      (DT * (size_t)(dh + 1) + 2 * KE * (TQ + 1) + KE * (DT + 1));
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(mlstm_state_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(mlstm_intra_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm2)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(mlstm_inter_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm3)) != cudaSuccess)
    return (int)err;
  mlstm_state_kernel<<<BH, THREADS, sm1, st>>>(q, k, log_i, log_f, n0, m0, n,
                                               m, bcum, qn, wc, mprev, decay,
                                               S, L, dh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_intra_kernel<<<dim3((L + TQ - 1) / TQ, nc, BH), THREADS, sm2, st>>>(
      q, k, log_i, bcum, qn, mprev, P, coef, denom, S, L, dh, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_inter_kernel<<<dim3(dh / DT, BH), THREADS, sm3, st>>>(
      q, k, v, C0, P, coef, denom, wc, decay, h, C, S, L, dh, scale);
  return (int)cudaGetLastError();
}
