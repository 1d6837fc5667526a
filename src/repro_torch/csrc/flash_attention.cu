// Blocked online-softmax attention (flash attention) for sm_90a, with GQA,
// an index-based causal / sliding-window mask and a logit softcap.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas,
// grid (B*H, q blocks, kv blocks) with the kv axis sequential and the
// running max, denominator and accumulator in VMEM scratch).  Plain
// version: src/repro_torch/kernels/ref.py::attention_ref.
//
// What bounds it on an H100: at prefill lengths, operations.  Every
// visible (query, key) pair costs 4 * hd flops (QK^T and PV) against
// 2 * hd elements of k/v per key read once; with S = 512 and causal
// masking that is ~S/2 flops per byte of k/v, above the fp32 SIMT
// machine balance (67 TFLOP/s over 3.35 TB/s = 20 flops a byte).  This
// first kernel runs on the fp32 FMA pipe, not the tensor cores (wgmma is
// later work), so its bound is counted at the fp32 peak.
//
// Design:
//  * one block of 128 threads per (batch, q head, block of BQ = 32
//    queries); four threads share a query row, each owning hd/4 of its
//    dims (interleaved in groups of four, so the four threads of a row
//    read one 64-byte span of a shared-memory row: no bank conflicts);
//  * the kv head is h / G (GQA); the block loops over kv tiles of BK = 32
//    keys staged in shared memory as f32 (16-byte loads from device
//    memory), and skips tiles wholly above the causal diagonal or below
//    the window, which hold no visible key;
//  * scores for eight keys at a time, reduced over the row's four
//    threads with shuffles; one online-softmax rescale per eight keys;
//  * masked keys get weight 0 and never raise the running max.  Every
//    query row with q <= Skv - 1 sees at least key q itself (the mask
//    keeps key j == i), so no stored row is left empty; padded key rows
//    beyond Skv are zero in shared memory and masked.
// Accumulation is f32; the output is stored in the input's type.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int TPR = 4;                 // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int KG = 8;                  // keys per online-softmax update

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Skv, int H, int KH, int causal,
    int window, float scale, float cap) {
  constexpr int V = attn::Vec<T>::N;
  constexpr int NC = HD / 16;          // float4 groups a thread owns
  __shared__ __align__(16) float Ks[BK][HD];
  __shared__ __align__(16) float Vs[BK][HD];

  const int qb = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kh = h / (H / KH);
  const int row = threadIdx.x / TPR, r = threadIdx.x % TPR;
  const int qi = qb * BQ + row;
  const bool q_ok = qi < Sq;

  float qf[NC][4], acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = c * 16 + r * 4 + e;
      qf[c][e] = q_ok ? attn::to_float(q[((long long)(b * Sq + qi) * H + h) * HD + d]) * scale
                      : 0.0f;
      acc[c][e] = 0.0f;
    }
  }
  float m = attn::NEG_INF, l = 0.0f;

  // visible key range of the whole q block
  int kv_hi = Skv;
  if (causal) kv_hi = min(Skv, (qb + 1) * BQ);
  long long lo = (long long)qb * BQ - window + 1;
  int kv_lo = lo > 0 ? (int)(lo / BK) * BK : 0;
  const long long lo_pos = (long long)qi - window;   // keys must be > this

  for (int j0 = kv_lo; j0 < kv_hi; j0 += BK) {
    __syncthreads();   // the previous tile is no longer read
    for (int i = threadIdx.x; i < BK * (HD / V); i += THREADS) {
      const int kr = i / (HD / V), cv = i % (HD / V);
      const int key = j0 + kr;
      float kf[V], vf[V];
      if (key < Skv) {
        const long long off = ((long long)(b * Skv + key) * KH + kh) * HD + cv * V;
        attn::unpack(attn::load16(k + off), kf);
        attn::unpack(attn::load16(v + off), vf);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) kf[e] = vf[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        Ks[kr][cv * V + e] = kf[e];
        Vs[kr][cv * V + e] = vf[e];
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int kk = 0; kk < BK; kk += KG) {
      float s[KG];
      bool ok[KG];
      float mg = attn::NEG_INF;
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        float d = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 kv4 = *reinterpret_cast<const float4*>(&Ks[kk + u][c * 16 + r * 4]);
          d += qf[c][0] * kv4.x + qf[c][1] * kv4.y + qf[c][2] * kv4.z +
               qf[c][3] * kv4.w;
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        const int key = j0 + kk + u;
        ok[u] = q_ok && key < Skv && (!causal || key <= qi) &&
                (long long)key > lo_pos;
        s[u] = attn::cap_score(d, cap);
        if (ok[u]) mg = fmaxf(mg, s[u]);
      }
      const float mn = fmaxf(m, mg);
      const float corr = expf(m - mn);
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        s[u] = ok[u] ? expf(s[u] - mn) : 0.0f;
        psum += s[u];
      }
      l = l * corr + psum;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] *= corr;
#pragma unroll
        for (int u = 0; u < KG; ++u) {
          const float4 v4 = *reinterpret_cast<const float4*>(&Vs[kk + u][c * 16 + r * 4]);
          acc[c][0] += s[u] * v4.x;
          acc[c][1] += s[u] * v4.y;
          acc[c][2] += s[u] * v4.z;
          acc[c][3] += s[u] * v4.w;
        }
      }
      m = mn;
    }
  }

  if (!q_ok) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* o = out + ((long long)(b * Sq + qi) * H + h) * HD;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) attn::store(o + c * 16 + r * 4 + e, acc[c][e] * inv);
  }
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Skv, int H, int KH, int hd, int causal, int window,
             float scale, float cap, cudaStream_t s) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  if (hd == 64) {
    flash_attention_kernel<T, 64><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KH, causal,
        window, scale, cap);
  } else if (hd == 128) {
    flash_attention_kernel<T, 128><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KH, causal,
        window, scale, cap);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd); k/v (B, Skv, KH, hd); out (B, Sq, H, hd); query i and
// key j at positions i and j.  hd 64 or 128.  dtype 0 = f32, 1 = bf16.
// window 1 << 30 means none; cap <= 0 means no softcap.  Returns a
// cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int KH, int hd,
                                      int causal, int window, float scale,
                                      float cap, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KH < 1 || H % KH != 0 || window < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_t<float>(q, k, v, out, B, Sq, Skv, H, KH, hd, causal, window,
                           scale, cap, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KH, hd, causal,
                                   window, scale, cap, s);
  return (int)cudaErrorInvalidValue;
}
