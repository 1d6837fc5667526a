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
// Value width.  q and k have dk dims, v and h dv <= dk: a sharded step
// runs the block on a rank's share of every head's value rows (dk 512 and
// dv 32 for xlstm-1.3b over 16 ranks), and C (dv x dk) holds those rows.
// Each value row contracts with all of dk, so the kernel on dv rows
// computes exactly those rows of what it computes at dv = dk: n, m and
// the scale dk^-1/2 are the whole head's.  The TPU kernel has one dh.
//
// Per chunk of L steps, with b the in-chunk cumsum of log_f:
//   lw[t,s]  = b_t - b_s + log_i_s (s <= t; masked otherwise)
//   m_t      = max(m_prev + b_t, max_s lw[t,s])
//   P[t,s]   = (q_t . k_s) * dk^-1/2 * exp(lw[t,s] - m_t)
//   h_t      = (sum_s P[t,s] v_s + w_t dk^-1/2 q_t C^T)
//              / max(|sum_s P[t,s] + w_t dk^-1/2 q_t . n_prev|, exp(-m_t))
//              with w_t = exp(m_prev + b_t - m_t);
//   then the chunk-end update of C (stored v (x) k), n and m.
//
// What bounds it on an H100: operations.  Per (b, h, chunk) it needs
// 2 L^2 dk for q k^T, 2 L^2 dv for P v and 4 L dv dk for q C^T and the C
// update (the causal mask halves the first two); at dk = dv = 512, L = 256 that
// is ~100x more flops than bytes, far above the machine balance.  The gate
// is 1e-4 of each output's largest magnitude over reductions 256-512 deep,
// which one TF32 pass (~2^-11 a product) does not keep, so the four
// products run in 3xTF32 on wgmma (m64nNk8, f32 accumulate), as the policy
// trunk does: each operand x splits into x_hi = tf32(x) and
// x_lo = x - x_hi, and the accumulator takes lo*hi + hi*lo + hi*hi.  At
// the TF32 peak that is 3 x 10.75 GFLOP in 0.065 ms at B = 4 x 512 (the
// fp32 pipe would take 0.16 ms for one pass).
//
// TF32 wgmma reads both operands K-major (the transpose bits exist for
// 16-bit types only).  A comes from registers: each block stages a 64-row
// x 32-deep A slice in shared memory (columns XORed with 4 x (row % 8),
// so a warp's fragment loads hit 32 banks) and splits it in registers.  B
// comes from shared memory, split once while staging, in wgmma's
// 32-byte-swizzled K-major layout ([columns][8] f32 a k-step, hi then lo).
// q k^T and q C^T read k and C as stored (C is v (x) k, row d, column e);
// P v and the C update contract over the key axis, so v and k are
// transposed while staging.
//
// Design.  C is dv x dk f32, 1 MB at dk = dv = 512, so no block holds a
// (b, h)'s state; the TPU's grid (B*H blocks) would also fill only 16 of
// 132 SMs.  Four launches, the last three one warpgroup (128 threads) a
// block:
//   1. gates, one block per (b, h, 32 of n's dk columns): the in-chunk cumsum
//      b (a warp scan), m_prev of each chunk, the chunk-end m, weights w_c
//      and decay (every block computes them, the first stores them), and n
//      carried across chunks for the block's columns, with n before each
//      chunk stored for launch 2.  O(S dk) work a (b, h), fp32 pipe.
//   2. scores, one block per (b, h, chunk, 64 queries, 64 keys), tiles
//      above the diagonal absent: S = q k^T on the tensor cores over dk;
//      m_t from the exact row max of lw; writes the tile of P (B*H, S, L)
//      to a scratch tensor and adds its row sums to a per-step vector
//      (atomics, one a row a tile).  The first key tile's blocks store w_t
//      and m_t and q_t . n_prev (from the staged q rows).  This is the only
//      part that needs all of dk for a (t, s) pair, so it is computed
//      once, not once per tile of v's dims.
//   3. state, one block per (b, h, 64 rows d < dv of C, 128 columns
//      e < dk): the tile of C stays in the block's accumulators across the chunks:
//      C = decay C + (w_c v)^T k per chunk (M = d, N = e, K = the chunk's
//      keys); the state before each chunk after the first goes to a
//      scratch (B*H, chunks - 1, dv, dk), and the last to C.
//   4. output, one block per (b, h, chunk, 64 queries, 128 of v's dims):
//      P v over the causal prefix, then (w_t dk^-1/2 q) C^T over dk, into
//      one accumulator, divided by max(|row sum of P + w_t dk^-1/2
//      q_t . n_prev|, exp(-m_t)).  Chunks run in parallel: each reads the
//      state before it from launch 3.  A block reads only its 64 rows of P
//      and q, so each row of them is read by dv / 128 blocks (4 at
//      dv = 512; the fp32 kernel this replaces read all of P and q in each
//      of its dv / 32 = 16 row-tile blocks).
// Staging goes global -> registers -> shared memory, one 32-deep slice at
// a time (12 wgmma a slice in launches 3 and 4), the next slice's loads
// issued before this slice's MMAs; there is no TMA ring.  The transposed
// operands (v and k read along the dims) pass through a padded raw slice
// so that both the loads and the swizzled stores hit 32 banks.
// Masked entries never reach exp(): P is 0 there, so no NaN; rows past L
// and columns past dk or dv stage as 0 and are never stored, so a chunk
// of L = 1 (a one-token prompt) and dv = 32 work.  The chunk length is a
// runtime value.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int THREADS = 256;   // launch 1
constexpr int WG = 128;        // launches 2-4: one warpgroup
constexpr int TM = 64;         // rows of an MMA tile
constexpr int KC = 32;         // reduction depth staged a step
constexpr int KSTEPS = KC / 8;
constexpr int NE = 128;        // launch 3: columns e of C a block
constexpr int ND = 128;        // launch 4: v's dims a block

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------- 1 ------
// grid (ceil(dk / 32), B*H).  Dynamic shared memory: bc[L], li[L], wc[L].
// Every block runs the scalar gate scan of its (b, h) (O(S), cheap); the
// first block of each (b, h) stores it.  Each block carries n for 32
// columns e, a warp a column each, its 8 warps summing interleaved steps.
__global__ void __launch_bounds__(THREADS) mlstm_gates_kernel(
    const float* __restrict__ k, const float* __restrict__ log_i,
    const float* __restrict__ log_f, const float* __restrict__ n0,
    const float* __restrict__ m0, float* __restrict__ n_out,
    float* __restrict__ m_out, float* __restrict__ nst,
    float* __restrict__ bcum, float* __restrict__ wc_g,
    float* __restrict__ mprev_g, float* __restrict__ decay_g,
    float* __restrict__ rowsum, int S, int L, int dk) {
  extern __shared__ float sm[];
  float* bc = sm;
  float* li = bc + L;
  float* wc = li + L;
  __shared__ float red[THREADS / 32];
  __shared__ float npart[THREADS / 32][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.y;
  const bool lead = blockIdx.x == 0;
  const int col = lane, part = warp;
  const int e = blockIdx.x * 32 + col;
  const int nc = S / L;
  float n = e < dk ? n0[bh * dk + e] : 0.0f;
  float m = m0[bh];
  for (int c = 0; c < nc; ++c) {
    const long long base = bh * S + (long long)c * L;
    for (int t = tid; t < L; t += THREADS) {
      li[t] = log_i[base + t];
      bc[t] = log_f[base + t];
    }
    __syncthreads();
    if (warp == 0) {   // inclusive cumsum of log_f, eight steps a lane
      float carry = 0.0f;
      for (int t0 = 0; t0 < L; t0 += 256) {
        const int t1 = t0 + 8 * lane;
        float x[8], run = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          x[i] = t1 + i < L ? bc[t1 + i] : 0.0f;
          run += x[i];
          x[i] = run;
        }
        float inc = run;
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += y;
        }
        const float off = carry + inc - run;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (t1 + i < L) bc[t1 + i] = x[i] + off;
        carry += __shfl_sync(0xffffffffu, inc, 31);
      }
    }
    __syncthreads();
    if (lead) {
      for (int t = tid; t < L; t += THREADS) {
        bcum[base + t] = bc[t];
        rowsum[base + t] = 0.0f;   // launch 2 adds each tile's row sums
      }
      if (tid == 0) mprev_g[bh * nc + c] = m;
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
      if (lead) wc_g[base + s] = w;
    }
    const float decay = expf((m + bl) - m_new);
    if (lead && tid == 0) decay_g[bh * nc + c] = decay;
    if (part == 0 && e < dk) nst[(bh * nc + c) * dk + e] = n;   // before c
    __syncthreads();   // wc complete
    float acc = 0.0f;
    if (e < dk) {
      const float* kc = k + base * dk + e;
#pragma unroll 8
      for (int s = part; s < L; s += THREADS / 32)
        acc = fmaf(wc[s], kc[(long long)s * dk], acc);
    }
    npart[part][col] = acc;
    __syncthreads();
    float dn = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) dn += npart[w][col];
    n = decay * n + dn;
    m = m_new;
    __syncthreads();   // bc, li, wc, npart reused by the next chunk
  }
  if (part == 0 && e < dk) n_out[bh * dk + e] = n;
  if (lead && tid == 0) m_out[bh] = m;
}

// ------------------------------------------------------- 3xTF32 tiles ----
// x = hi + lo: hi rounded to TF32 (nearest, ties away, by integer add and
// mask), lo = x - hi exactly, passed as f32 bits, of which the MMA reads
// the TF32 part
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// word offset of (column n, k in 0..7) in a [columns][8] f32 block of
// wgmma's 32-byte-swizzled K-major layout: the 16-byte half of each
// 32-byte row XORed with bit 2 of the column
__device__ __forceinline__ int sw32(int n, int k) {
  return n * 8 + ((((k >> 2) ^ (n >> 2)) & 1) << 2) + (k & 3);
}

// A slices: row-major [TM][KC] with each row's columns XORed with
// 4 x (row % 8), or depth-major [KC][ATP] (ATP = 8 mod 32); a warp's
// fragment loads hit 32 banks in both
constexpr int ATP = TM + 8;
__device__ __forceinline__ int a_at(int r, int c) {
  return r * KC + (c ^ ((r & 7) << 2));
}
template <bool T>
__device__ __forceinline__ float a_get(const float* As, int r, int c) {
  return T ? As[c * ATP + r] : As[a_at(r, c)];
}

// four consecutive depths k..k+3 (k % 4 == 0) of B's column n, split: the
// k-step's block holds hi [N][8], then lo [N][8]; one 16-byte store each.
// Lanes on consecutive columns at one depth hit 32 banks.
template <int N>
__device__ __forceinline__ void put_b4(float* Bs, int n, int k, float4 x) {
  uint4 hi, lo;
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
  float* blk = Bs + (k >> 3) * 2 * N * 8;
  const int o = sw32(n, k & 7);
  *reinterpret_cast<uint4*>(blk + o) = hi;
  *reinterpret_cast<uint4*>(blk + N * 8 + o) = lo;
}

// B from a slice staged depth-major, raw [KC][N + 4] (rows of v or k as
// read), transposed into the split K-major layout
template <int N>
__device__ __forceinline__ void raw_to_b(float* Bs, const float* raw) {
  for (int i = threadIdx.x; i < N * (KC / 4); i += WG) {
    const int n = i % N, k4 = i / N * 4;
    const float* r = raw + k4 * (N + 4) + n;
    put_b4<N>(Bs, n, k4, make_float4(r[0], r[N + 4], r[2 * (N + 4)],
                                     r[3 * (N + 4)]));
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <int N>
__device__ __forceinline__ void mma_tf32(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_tf32<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wg::wgmma_m64n64k8_tf32_rs(d, a, db);
}
template <>
__device__ __forceinline__ void mma_tf32<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wg::wgmma_m64n128k8_tf32_rs(d, a, db);
}

// acc (64 x N) += A (the staged slice, 64 x KC) B^T (the staged B, N x KC)
// in three TF32 passes.  Every A fragment of the slice is split before the
// fence, so no register an MMA reads changes while it runs.  The caller
// has made the slice visible (fence_shared, then a barrier).
template <int N, bool AT>
__device__ __forceinline__ void mma_slice(float (&acc)[N / 2],
                                          const float* As, const float* Bs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = 16 * warp + (lane >> 2), t = lane & 3;
  uint32_t ah[KSTEPS][4], al[KSTEPS][4];
#pragma unroll
  for (int j = 0; j < KSTEPS; ++j) {
    split_tf32(a_get<AT>(As, r, 8 * j + t), ah[j][0], al[j][0]);
    split_tf32(a_get<AT>(As, r + 8, 8 * j + t), ah[j][1], al[j][1]);
    split_tf32(a_get<AT>(As, r, 8 * j + t + 4), ah[j][2], al[j][2]);
    split_tf32(a_get<AT>(As, r + 8, 8 * j + t + 4), ah[j][3], al[j][3]);
  }
  wg::fence();
#pragma unroll
  for (int j = 0; j < KSTEPS; ++j) {
    const float* bh = Bs + j * 2 * N * 8;
    const uint64_t bhi = wg::desc(bh, 16, 256, wg::SW32);
    const uint64_t blo = wg::desc(bh + N * 8, 16, 256, wg::SW32);
    mma_tf32<N>(acc, al[j], bhi);
    mma_tf32<N>(acc, ah[j], blo);
    mma_tf32<N>(acc, ah[j], bhi);
  }
  wg::commit();
  wg::wait_all();
}

// accumulator element i of this thread: row and column in the 64 x N tile
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// Each slice's global loads go to registers one slice ahead: issued just
// before the previous slice's MMAs, stored to shared memory after them.

// ---------------------------------------------------------------- 2 ------
// grid (T (T + 1) / 2 tiles (query tile qt, key tile kt <= qt) with
// T = ceil(L / 64), chunks, B*H).  Dynamic shared memory: B [KSTEPS][2]
// [64][8], A [TM][KC], bc[L], li[L].
__global__ void __launch_bounds__(WG) mlstm_scores_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ log_i, const float* __restrict__ bcum,
    const float* __restrict__ mprev_g, const float* __restrict__ nst,
    float* __restrict__ P, float* __restrict__ coef,
    float* __restrict__ mrow_g, float* __restrict__ rowsum,
    float* __restrict__ qn_g, int S, int L, int dk, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);
  float* As = Bs + KSTEPS * 2 * 64 * 8;
  float* bc = As + TM * KC;
  float* li = bc + L;
  __shared__ float mrow[TM];
  const int tid = threadIdx.x;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= (int)blockIdx.x) ++qt;
  const int kt = blockIdx.x - qt * (qt + 1) / 2;
  const int t0 = qt * TM, s0 = kt * 64, c = blockIdx.y;
  const long long bh = blockIdx.z;
  const int nc = S / L;
  const long long base = bh * S + (long long)c * L;   // row of step 0
  const int tend = min(t0 + TM, L);
  for (int t = tid; t < tend; t += WG) {
    bc[t] = bcum[base + t];
    li[t] = log_i[base + t];
  }
  const float mp = mprev_g[bh * nc + c];
  __syncthreads();
  {   // m_t from the exact row max of lw, two threads a row
    const int r = tid >> 1, h2 = tid & 1, t = t0 + r;
    float mx = -INFINITY;
    if (t < L) {
      const float bt = bc[t];
      for (int s = h2; s <= t; s += 2) mx = fmaxf(mx, (bt - bc[s]) + li[s]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mt = t < L ? fmaxf(mp + bc[t], mx) : 0.0f;
    if (h2 == 0) {
      mrow[r] = mt;
      if (kt == 0 && t < L) {
        coef[base + t] = expf((mp + bc[t]) - mt);
        mrow_g[base + t] = mt;
      }
    }
  }
  // S = q k^T over dk: q rows t0.., k rows s0.. (K-major as stored)
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  float4 rq[TM * KC / 4 / WG], rk[TM * KC / 4 / WG];
  auto load = [&](int e0) {
#pragma unroll
    for (int j = 0; j < TM * KC / 4 / WG; ++j) {
      const int i = tid + WG * j, r = i / (KC / 4), c4 = i % (KC / 4) * 4;
      rq[j] = t0 + r < L ? ld4(q + (base + t0 + r) * dk + e0 + c4) : zero4();
      rk[j] = s0 + r < L ? ld4(k + (base + s0 + r) * dk + e0 + c4) : zero4();
    }
  };
  // q_t . n_prev on the way, in the first key tile's blocks: a row's 8
  // lanes, rows (tid / 8) + 16 j
  const float* np = nst + (bh * nc + c) * dk;
  float qd[TM * KC / 4 / WG];
#pragma unroll
  for (int j = 0; j < TM * KC / 4 / WG; ++j) qd[j] = 0.0f;
  load(0);
  for (int e0 = 0; e0 < dk; e0 += KC) {
#pragma unroll
    for (int j = 0; j < TM * KC / 4 / WG; ++j) {
      const int i = tid + WG * j, r = i / (KC / 4), c4 = i % (KC / 4) * 4;
      st4(As + a_at(r, c4), rq[j]);
      put_b4<64>(Bs, r, c4, rk[j]);
      if (kt == 0) qd[j] += dot4(rq[j], ld4(np + e0 + c4));
    }
    wg::fence_shared();
    __syncthreads();
    if (e0 + KC < dk) load(e0 + KC);
    mma_slice<64, false>(acc, As, Bs);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = acc_row(i), t = t0 + r, s = s0 + acc_col(i);
    if (t < L && s < L) {
      float p = 0.0f;
      if (s <= t) {
        const float lw = (bc[t] - bc[s]) + li[s];
        p = (acc[i] * scale) * expf(lw - mrow[r]);
      }
      P[(base + t) * L + s] = p;
      acc[i] = p;
    } else {
      acc[i] = 0.0f;
    }
  }
  // the tile's part of each row's sum of P (over the row's four lanes)
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float x = 0.0f;
#pragma unroll
    for (int i = 2 * h2; i < 32; i += 4) x += acc[i] + acc[i + 1];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    const int t = t0 + acc_row(2 * h2);
    if ((tid & 3) == 0 && t < L) atomicAdd(rowsum + base + t, x);
  }
  if (kt == 0) {
#pragma unroll
    for (int j = 0; j < TM * KC / 4 / WG; ++j) {
      float x = qd[j];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      const int t = t0 + (tid + WG * j) / (KC / 4);
      if ((tid & 7) == 0 && t < L) qn_g[base + t] = x;
    }
  }
}

// ---------------------------------------------------------------- 3 ------
// grid (ceil(dv / TM), ceil(dk / NE), B*H).  Dynamic shared memory: B
// [KSTEPS][2][NE][8], A [KC][ATP] (depth-major), raw [KC][NE + 4].
__global__ void __launch_bounds__(WG) mlstm_cstate_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ C0, const float* __restrict__ wc_g,
    const float* __restrict__ decay_g, float* __restrict__ Cst,
    float* __restrict__ C_out, int S, int L, int dk, int dv) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);
  float* At = Bs + KSTEPS * 2 * NE * 8;
  float* raw = At + KC * ATP;
  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * TM, e0 = blockIdx.y * NE;
  const long long bh = blockIdx.z;
  const int nc = S / L;
  const long long cs = (long long)dv * dk;
  // acc: C[d0 + row][e0 + col], pairs of adjacent columns
  float acc[NE / 2];
#pragma unroll
  for (int i = 0; i < NE / 2; i += 2) {
    const int d = d0 + acc_row(i), e = e0 + acc_col(i);
    const float2 x = d < dv && e < dk
        ? *reinterpret_cast<const float2*>(C0 + bh * cs + (long long)d * dk + e)
        : make_float2(0.0f, 0.0f);
    acc[i] = x.x;
    acc[i + 1] = x.y;
  }
  constexpr int JV = KC * TM / 4 / WG, JK = KC * NE / 4 / WG;
  float4 rv[JV], rk[JK];
  float rw[JV];
  for (int c = 0; c < nc; ++c) {
    if (c > 0) {   // the state before chunk c
      float* Co = Cst + (bh * (nc - 1) + c - 1) * cs;
#pragma unroll
      for (int i = 0; i < NE / 2; i += 2) {
        const int d = d0 + acc_row(i), e = e0 + acc_col(i);
        if (d < dv && e < dk)
          *reinterpret_cast<float2*>(Co + (long long)d * dk + e) =
              make_float2(acc[i], acc[i + 1]);
      }
    }
    const float decay = decay_g[bh * nc + c];
#pragma unroll
    for (int i = 0; i < NE / 2; ++i) acc[i] *= decay;
    const long long base = bh * S + (long long)c * L;
    // A[d][s] = w_c[s] v[s][d0 + d] and B[e][s] = k[s][e0 + e], both
    // from rows of v and k read along the dims
    auto load = [&](int s0) {
#pragma unroll
      for (int j = 0; j < JV; ++j) {
        const int i = tid + WG * j, kk = i / (TM / 4), m4 = i % (TM / 4) * 4;
        const bool ok = s0 + kk < L && d0 + m4 < dv;
        rv[j] = ok ? ld4(v + (base + s0 + kk) * dv + d0 + m4) : zero4();
        rw[j] = ok ? wc_g[base + s0 + kk] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int i = tid + WG * j, kk = i / (NE / 4), n4 = i % (NE / 4) * 4;
        rk[j] = s0 + kk < L && e0 + n4 < dk
            ? ld4(k + (base + s0 + kk) * dk + e0 + n4) : zero4();
      }
    };
    load(0);
    for (int s0 = 0; s0 < L; s0 += KC) {
#pragma unroll
      for (int j = 0; j < JV; ++j) {
        const int i = tid + WG * j, kk = i / (TM / 4), m4 = i % (TM / 4) * 4;
        st4(At + kk * ATP + m4, scale4(rv[j], rw[j]));
      }
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int i = tid + WG * j, kk = i / (NE / 4), n4 = i % (NE / 4) * 4;
        st4(raw + kk * (NE + 4) + n4, rk[j]);
      }
      __syncthreads();
      raw_to_b<NE>(Bs, raw);
      wg::fence_shared();
      __syncthreads();
      if (s0 + KC < L) load(s0 + KC);
      mma_slice<NE, true>(acc, At, Bs);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < NE / 2; i += 2) {
    const int d = d0 + acc_row(i), e = e0 + acc_col(i);
    if (d < dv && e < dk)
      *reinterpret_cast<float2*>(C_out + bh * cs + (long long)d * dk + e) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------- 4 ------
// grid (ceil(dv / ND), ceil(L / TM), B*H*chunks).  Dynamic shared memory:
// B [KSTEPS][2][ND][8], A [TM][KC], raw [KC][ND + 4].
__global__ void __launch_bounds__(WG) mlstm_out_kernel(
    const float* __restrict__ q, const float* __restrict__ v,
    const float* __restrict__ C0, const float* __restrict__ Cst,
    const float* __restrict__ P, const float* __restrict__ coef,
    const float* __restrict__ mrow_g, const float* __restrict__ rowsum,
    const float* __restrict__ qn, float* __restrict__ h, int S, int L,
    int dk, int dv, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);
  float* As = Bs + KSTEPS * 2 * ND * 8;
  float* raw = As + TM * KC;
  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * ND, t0 = blockIdx.y * TM;
  const int nc = S / L;
  const long long bh = blockIdx.z / nc;
  const int c = blockIdx.z % nc;
  const long long base = bh * S + (long long)c * L;
  const long long cs = (long long)dv * dk;
  const float* Cc = c == 0 ? C0 + bh * cs : Cst + (bh * (nc - 1) + c - 1) * cs;
  float acc[ND / 2];
#pragma unroll
  for (int i = 0; i < ND / 2; ++i) acc[i] = 0.0f;

  // P v over the causal prefix of the block's rows
  constexpr int JP = TM * KC / WG, JV = KC * ND / 4 / WG;
  const int kend = min(t0 + TM, L);
  float rp[JP];
  float4 rv[JV];
  auto load_pv = [&](int s0) {
#pragma unroll
    for (int j = 0; j < JP; ++j) {   // row i / KC = warp + 4 j, depth lane
      const int i = tid + WG * j, r = i / KC, kk = i % KC;
      rp[j] = t0 + r < L && s0 + kk < kend
          ? P[(base + t0 + r) * L + s0 + kk] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < JV; ++j) {
      const int i = tid + WG * j, kk = i / (ND / 4), n4 = i % (ND / 4) * 4;
      rv[j] = s0 + kk < kend && d0 + n4 < dv
          ? ld4(v + (base + s0 + kk) * dv + d0 + n4) : zero4();
    }
  };
  load_pv(0);
  for (int s0 = 0; s0 < kend; s0 += KC) {
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const int i = tid + WG * j;
      As[a_at(i / KC, i % KC)] = rp[j];
    }
#pragma unroll
    for (int j = 0; j < JV; ++j) {
      const int i = tid + WG * j, kk = i / (ND / 4), n4 = i % (ND / 4) * 4;
      st4(raw + kk * (ND + 4) + n4, rv[j]);
    }
    __syncthreads();
    raw_to_b<ND>(Bs, raw);
    wg::fence_shared();
    __syncthreads();
    if (s0 + KC < kend) load_pv(s0 + KC);
    mma_slice<ND, false>(acc, As, Bs);
    __syncthreads();
  }

  // (w_t dk^-1/2 q_t) C^T over dk: C's rows as stored are B's K-major
  // rows, read two lanes to a 32-byte k-step
  constexpr int JQ = TM * KC / 4 / WG, JC = ND * KC / 4 / WG;
  float4 rq[JQ], rc[JC];
  float qs[JQ];
#pragma unroll
  for (int j = 0; j < JQ; ++j) {
    const int t = t0 + (tid + WG * j) / (KC / 4);
    qs[j] = t < L ? coef[base + t] * scale : 0.0f;
  }
  auto load_qc = [&](int e0) {
#pragma unroll
    for (int j = 0; j < JQ; ++j) {
      const int i = tid + WG * j, r = i / (KC / 4), c4 = i % (KC / 4) * 4;
      rq[j] = t0 + r < L ? ld4(q + (base + t0 + r) * dk + e0 + c4) : zero4();
    }
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int i = tid + WG * j, n = (i >> 1) % ND;
      const int c4 = (i / (2 * ND)) * 8 + (i & 1) * 4;
      rc[j] = d0 + n < dv ? ld4(Cc + (long long)(d0 + n) * dk + e0 + c4)
                          : zero4();
    }
  };
  load_qc(0);
  for (int e0 = 0; e0 < dk; e0 += KC) {
#pragma unroll
    for (int j = 0; j < JQ; ++j) {
      const int i = tid + WG * j, r = i / (KC / 4), c4 = i % (KC / 4) * 4;
      st4(As + a_at(r, c4), scale4(rq[j], qs[j]));
    }
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int i = tid + WG * j, n = (i >> 1) % ND;
      put_b4<ND>(Bs, n, (i / (2 * ND)) * 8 + (i & 1) * 4, rc[j]);
    }
    wg::fence_shared();
    __syncthreads();
    if (e0 + KC < dk) load_qc(e0 + KC);
    mma_slice<ND, false>(acc, As, Bs);
    __syncthreads();
  }
  // h = (P v + w q C^T) / max(|sum_s P + w dk^-1/2 q . n|, exp(-m))
#pragma unroll
  for (int i = 0; i < ND / 2; i += 2) {
    const int t = t0 + acc_row(i), d = d0 + acc_col(i);
    if (t < L && d < dv) {
      const long long st = base + t;
      const float den = fmaxf(fabsf(rowsum[st] + coef[st] * (scale * qn[st])),
                              expf(-mrow_g[st]));
      *reinterpret_cast<float2*>(h + st * dv + d) =
          make_float2(acc[i] / den, acc[i + 1] / den);
    }
  }
}

}  // namespace

// Shapes: q, k (BH, S, dk); v, h (BH, S, dv); log_i, log_f (BH, S); C0, C
// (BH, dv, dk); n0, n (BH, dk); m0, m (BH,).  Scratch: P (BH, S, L); Cst
// (BH, S / L - 1, dv, dk) (unused when S == L); nst (BH, S / L, dk); bcum,
// wc, coef, mrow, rowsum, qn (BH, S); mprev, decay (BH, S / L).  All f32, contiguous, 16-byte
// aligned.  Needs S % L == 0, dk and dv multiples of 32, and
// 32 <= dv <= dk <= 512.
extern "C" int mlstm_chunkwise_launch(
    const float* q, const float* k, const float* v, const float* log_i,
    const float* log_f, const float* C0, const float* n0, const float* m0,
    float* h, float* C, float* n, float* m, float* P, float* Cst, float* nst,
    float* bcum, float* wc, float* coef, float* mrow, float* rowsum,
    float* qn, float* mprev, float* decay, int BH, int S, int L, int dk,
    int dv, void* stream) {
  if (BH < 1 || S < 1 || L < 1 || S % L || dk % 32 || dv % 32 || dv < 32 ||
      dv > dk || dk > 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)dk);
  const int nc = S / L, nt = (L + TM - 1) / TM;
  const size_t sm1 = sizeof(float) * 3 * (size_t)L;
  const size_t sm2 = sizeof(float) * (KSTEPS * 2 * 64 * 8 + TM * KC + 2 * (size_t)L);
  const size_t sm3 = sizeof(float) * (KSTEPS * 2 * NE * 8 + KC * ATP + KC * (NE + 4));
  const size_t sm4 = sizeof(float) * (KSTEPS * 2 * ND * 8 + TM * KC + KC * (ND + 4));
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(mlstm_gates_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(mlstm_scores_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm2)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(mlstm_cstate_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm3)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(mlstm_out_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sm4)) != cudaSuccess)
    return (int)err;
  mlstm_gates_kernel<<<dim3((dk + 31) / 32, BH), THREADS, sm1, st>>>(
      k, log_i, log_f, n0, m0, n, m, nst, bcum, wc, mprev, decay, rowsum, S,
      L, dk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_scores_kernel<<<dim3(nt * (nt + 1) / 2, nc, BH), WG, sm2, st>>>(
      q, k, log_i, bcum, mprev, nst, P, coef, mrow, rowsum, qn, S, L, dk,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_cstate_kernel<<<dim3((dv + TM - 1) / TM, (dk + NE - 1) / NE, BH), WG,
                        sm3, st>>>(k, v, C0, wc, decay, Cst, C, S, L, dk, dv);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_out_kernel<<<dim3((dv + ND - 1) / ND, nt, BH * nc), WG, sm4, st>>>(
      q, v, C0, Cst, P, coef, mrow, rowsum, qn, h, S, L, dk, dv, scale);
  return (int)cudaGetLastError();
}
