// Paged gather-decode attention for sm_90a: one decode token per batch
// row, its keys and values read through the row's page table.
//
// Replaces: src/repro/kernels/paged_decode.py::paged_decode_attention
// (Pallas, grid (B*KH, M) with the page axis sequential, table, positions
// and window riding scalar prefetch, online-softmax state in VMEM).
// Plain version: src/repro_torch/kernels/ref.py::paged_attention_ref.
//
// What bounds it on an H100: memory.  A (row, kv head) pair reads its
// G = H/KH query heads once and every mapped, visible key and value row
// once (2 * hd elements a key), and does ~4 * G * hd flops per key: at
// bf16 that is ~G flops a byte, far under the card's ~295 flops a byte.
//
// Design:
//  * one block per (row, kv head) with its G query heads, so each key and
//    value row is read once for the whole GQA group; the block's loop over
//    the row's virtual pages replaces the TPU's sequential grid axis;
//  * the block loads its own table row (into shared memory) and position:
//    there is no scalar prefetch here.  The window is a runtime argument
//    (1 << 30 means none), so a change of window does not rebuild;
//  * pages wholly past the query position or before the window, and
//    unmapped pages (table < 0), are skipped: virtual page v holds only
//    positions [v*page, (v+1)*page) or -1, so they hold no visible key;
//  * a key row of hd elements is read by hd/V lanes with 16-byte loads
//    (V = 8 bf16 or 4 f32; hd = 128 bf16 is 16 lanes), so a warp holds
//    32*V/hd keys at once; each of the block's subgroups runs its own
//    online softmax over every (NSG)-th key, KU keys' loads in flight at a
//    time, and the subgroups' states merge in shared memory at the end;
//  * masked keys never enter the softmax: a row whose keys are all masked
//    (an idle slot at position -1) ends with l = 0 and acc = 0 and stores
//    0 / max(l, 1e-30) = 0 exactly, as the reference's zeroed values and
//    clamped denominator give; no trash-page value is ever read.
// Accumulation is f32; the output is stored in the input's type.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KU = 4;   // keys a subgroup loads before it computes

template <typename T, int G>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kpages,
    const T* __restrict__ vpages, const int* __restrict__ slot_pos,
    const int* __restrict__ table, const int* __restrict__ positions,
    T* __restrict__ out, int H, int KH, int hd, int P, int M, int window,
    float scale, float cap) {
  constexpr int V = attn::Vec<T>::N;
  const int LPR = hd / V;        // lanes per key row, a divisor of 32
  const int RPW = 32 / LPR;      // key rows a warp holds at once
  const int NSG = WARPS * RPW;   // subgroups in the block
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPR, sl = lane % LPR;
  const int sg = warp * RPW + sub;
  const unsigned mask =
      LPR == 32 ? 0xffffffffu : (((1u << LPR) - 1u) << (sub * LPR));

  extern __shared__ float smem[];
  int* tbl = reinterpret_cast<int*>(smem);
  const int tbl_words = (M + 3) & ~3;
  float* ms = smem + tbl_words;          // [NSG][G]
  float* ls = ms + NSG * G;              // [NSG][G]
  float* accs = ls + NSG * G;            // [NSG][G][hd]

  for (int i = threadIdx.x; i < M; i += THREADS) tbl[i] = table[(long long)b * M + i];
  const int qpos = positions[b];
  __syncthreads();

  float qf[G][V], acc[G][V], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long off = ((long long)b * H + kh * G + g) * hd + sl * V;
    attn::unpack(attn::load16(q + off), qf[g]);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      qf[g][e] *= scale;
      acc[g][e] = 0.0f;
    }
    m[g] = attn::NEG_INF;
    l[g] = 0.0f;
  }

  int first = 0, npages = 0;
  if (qpos >= 0) {
    const long long lo = (long long)qpos - window + 1;
    first = lo > 0 ? (int)(lo / P) : 0;
    const int last = min(M - 1, qpos / P);
    npages = last >= first ? last - first + 1 : 0;
  }
  const int nkeys = npages * P;
  const long long lo_pos = (long long)qpos - window;   // keys must be > this

  for (int base = sg * KU; base < nkeys; base += NSG * KU) {
    uint4 kr[KU], vr[KU];
    bool ok[KU];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int t = base + u;
      ok[u] = false;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (t < nkeys) {
        const int phys = tbl[first + t / P];
        if (phys >= 0) {
          const long long slot = (long long)phys * P + t % P;
          const int kp = slot_pos[slot];
          ok[u] = kp >= 0 && kp <= qpos && (long long)kp > lo_pos;
          if (ok[u]) {
            const long long off = (slot * KH + kh) * hd + sl * V;
            kr[u] = attn::load16(kpages + off);
            vr[u] = attn::load16(vpages + off);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      if (!ok[u]) continue;     // uniform across the subgroup's lanes
      float kf[V], vf[V], s[G];
      attn::unpack(kr[u], kf);
      attn::unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < V; ++e) d += qf[g][e] * kf[e];
        s[g] = d;
      }
      for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(mask, s[g], off);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float sc = attn::cap_score(s[g], cap);
        const float mn = fmaxf(m[g], sc);
        const float corr = expf(m[g] - mn);
        const float p = expf(sc - mn);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] = acc[g][e] * corr + p * vf[e];
        m[g] = mn;
      }
    }
  }

  // merge the subgroups' online-softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (sl == 0) {
      ms[sg * G + g] = m[g];
      ls[sg * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) accs[(sg * G + g) * hd + sl * V + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * hd; i += THREADS) {
    const int g = i / hd, d = i % hd;
    float mx = attn::NEG_INF;
    for (int s2 = 0; s2 < NSG; ++s2) mx = fmaxf(mx, ms[s2 * G + g]);
    float lsum = 0.0f, a = 0.0f;
    for (int s2 = 0; s2 < NSG; ++s2) {
      const float w = expf(ms[s2 * G + g] - mx);
      lsum += ls[s2 * G + g] * w;
      a += accs[(s2 * G + g) * hd + d] * w;
    }
    attn::store(out + ((long long)b * H + kh * G + g) * hd + d,
                a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int G>
int launch_g(const void* q, const void* k, const void* v, const int* sp,
             const int* table, const int* pos, void* out, int B, int H, int KH,
             int hd, int P, int M, int window, float scale, float cap,
             cudaStream_t stream) {
  constexpr int V = attn::Vec<T>::N;
  const int nsg = WARPS * (32 / (hd / V));
  const size_t smem = sizeof(float) * (((M + 3) & ~3) + 2 * nsg * G +
                                       (size_t)nsg * G * hd);
  auto kern = paged_decode_kernel<T, G>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * KH, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), sp, table, pos, static_cast<T*>(out), H, KH,
      hd, P, M, window, scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const int* sp,
             const int* table, const int* pos, void* out, int B, int H, int KH,
             int hd, int P, int M, int window, float scale, float cap,
             cudaStream_t s) {
  switch (H / KH) {
    case 1: return launch_g<T, 1>(q, k, v, sp, table, pos, out, B, H, KH, hd, P, M, window, scale, cap, s);
    case 2: return launch_g<T, 2>(q, k, v, sp, table, pos, out, B, H, KH, hd, P, M, window, scale, cap, s);
    case 4: return launch_g<T, 4>(q, k, v, sp, table, pos, out, B, H, KH, hd, P, M, window, scale, cap, s);
    case 8: return launch_g<T, 8>(q, k, v, sp, table, pos, out, B, H, KH, hd, P, M, window, scale, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd); k/v pages (N, P, KH, hd); slot_pos (N, P) int32; table
// (B, M) int32; positions (B,) int32; out (B, H, hd).  dtype 0 = f32,
// 1 = bf16.  cap <= 0 means no softcap.  Returns a cudaError_t.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const int* slot_pos,
                                   const int* table, const int* positions,
                                   void* out, int B, int H, int KH, int hd,
                                   int P, int M, int window, float scale,
                                   float cap, int dtype, void* stream) {
  if (B < 1 || KH < 1 || H % KH != 0 || P < 1 || M < 1 || window < 1)
    return (int)cudaErrorInvalidValue;
  const int V = dtype == 1 ? 8 : 4;
  if (hd % V != 0 || hd / V > 32 || 32 % (hd / V) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_t<float>(q, k_pages, v_pages, slot_pos, table, positions, out,
                           B, H, KH, hd, P, M, window, scale, cap, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k_pages, v_pages, slot_pos, table,
                                   positions, out, B, H, KH, hd, P, M, window,
                                   scale, cap, s);
  return (int)cudaErrorInvalidValue;
}
