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
// Design: split-KV ("flash-decoding").  One (row, kv head) at decode
// batch 8 is too little work for one block: B * KH blocks (64 at
// internlm2-1.8b's 8 rows) leave most of the 132 SMs idle, each streaming
// its row's whole cache alone.  So:
//  * grid (B * KH, NSPLIT): block (row, kv head, split) takes its G query
//    heads and an equal share of the row's visible virtual pages, so each
//    key and value row is still read once for the whole GQA group.  The
//    launcher picks NSPLIT so that at most two blocks an SM run (one
//    wave);
//  * the block loads its share of the table row into shared memory and
//    its position: there is no scalar prefetch here.  The window is a
//    runtime argument (1 << 30 means none), so a change of window does not
//    rebuild;
//  * pages wholly past the query position or before the window, and
//    unmapped pages (table < 0), are skipped: virtual page v holds only
//    positions [v*page, (v+1)*page) or -1, so they hold no visible key;
//  * a key row of hd elements is NV = hd / V 16-byte vectors (V = 8 bf16 or
//    4 f32); a subgroup of LPR lanes (NV / NCH rounded up to a power of two,
//    at most 32) holds one key row, NCH vectors a lane, so any hd that is a
//    multiple of V up to 256 works; each of the block's subgroups runs its
//    own online softmax over every NSG-th key, KU keys' loads in flight at a
//    time and one update for the KU keys together (their score shuffles
//    interleave, one rescale of the accumulators a round: the chain of
//    dependent shuffles and exps a key is what the time goes on once the
//    loads are in flight), and the subgroups' states merge in shared
//    memory;
//  * with NSPLIT > 1 each block writes its merged (m, l, acc[G][hd]) in f32
//    to a scratch the wrapper allocates, then takes a ticket (an atomic add
//    after __threadfence); the block that takes the last ticket of its
//    (row, kv head) merges every split's partial, stores the output and
//    sets the ticket back to 0 for the next call.  A split that saw no key
//    has m = -1e30 and l = 0 and adds nothing: the weights exp(m_s - max)
//    stay finite because the masked value is finite, not -inf;
//  * a mapped slot's key and value rows load together with its position,
//    so a key costs one memory round trip, not two; a slot that turns out
//    masked (empty, past the query, before the window) is dropped before
//    the softmax.  So a row whose keys are all masked (an idle slot at
//    position -1) ends with l = 0 and acc = 0 and stores
//    0 / max(l, 1e-30) = 0 exactly, as the reference's zeroed values and
//    clamped denominator give.
// Accumulation is f32; the output is stored in the input's type.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_HD = 256;

// lanes a key row takes: ceil(nv / nch) rounded up to a power of two
__host__ __device__ inline int lanes_per_row(int nv, int nch) {
  const int need = (nv + nch - 1) / nch;
  int l = 1;
  while (l < need) l <<= 1;
  return l;
}

template <typename T, int G, int NCH>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kpages,
    const T* __restrict__ vpages, const int* __restrict__ slot_pos,
    const int* __restrict__ table, const int* __restrict__ positions,
    T* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int* __restrict__ tickets, int H, int KH,
    int hd, int P, int M, int window, float scale, float cap) {
  constexpr int V = attn::Vec<T>::N;
  constexpr int KU = 4 / NCH;      // keys a subgroup loads before it computes
  constexpr int E = NCH * V;       // elements of a key row a lane holds
  const int NV = hd / V;
  const int LPR = lanes_per_row(NV, NCH);
  const int RPW = 32 / LPR;        // key rows a warp holds at once
  const int NSG = WARPS * RPW;     // subgroups in the block
  const int bk = blockIdx.x, nsplit = gridDim.y, split = blockIdx.y;
  const int b = bk / KH, kh = bk % KH;
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
  __shared__ int last;

  // the G query rows, scaled (independent of the position: loaded first)
  float qf[G][E], acc[G][E], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long off = ((long long)b * H + kh * G + g) * hd;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = sl + i * LPR;
      float f[V];
      if (c < NV) {
        attn::unpack(attn::load16(q + off + c * V), f);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        qf[g][i * V + e] = f[e] * scale;
        acc[g][i * V + e] = 0.0f;
      }
    }
    m[g] = attn::NEG_INF;
    l[g] = 0.0f;
  }

  // this split's share of the row's visible virtual pages
  const int qpos = positions[b];
  int first = 0, npages = 0;
  if (qpos >= 0) {
    const long long lo = (long long)qpos - window + 1;
    first = lo > 0 ? (int)(lo / P) : 0;
    const int lastp = min(M - 1, qpos / P);
    npages = lastp >= first ? lastp - first + 1 : 0;
  }
  const int per = (npages + nsplit - 1) / nsplit;
  const int p0 = min(npages, split * per);
  const int mine = min(npages, p0 + per) - p0;
  for (int i = threadIdx.x; i < mine; i += THREADS)
    tbl[i] = table[(long long)b * M + first + p0 + i];
  __syncthreads();

  const int nkeys = mine * P;
  const long long lo_pos = (long long)qpos - window;   // keys must be > this

  for (int base = sg * KU; base < nkeys; base += NSG * KU) {
    // a mapped slot's key and value rows load beside its position, before
    // the position is known to be visible: one memory round trip, not two
    uint4 kr[KU][NCH], vr[KU][NCH];
    int kp[KU];
    bool ok[KU];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int t = base + u;
      kp[u] = -1;
#pragma unroll
      for (int i = 0; i < NCH; ++i) kr[u][i] = vr[u][i] = make_uint4(0u, 0u, 0u, 0u);
      if (t < nkeys) {
        const int phys = tbl[t / P];
        if (phys >= 0) {
          const long long slot = (long long)phys * P + t % P;
          kp[u] = slot_pos[slot];
          const long long off = (slot * KH + kh) * hd;
#pragma unroll
          for (int i = 0; i < NCH; ++i) {
            const int c = sl + i * LPR;
            if (c < NV) {
              kr[u][i] = attn::load16(kpages + off + c * V);
              vr[u][i] = attn::load16(vpages + off + c * V);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KU; ++u)
      ok[u] = kp[u] >= 0 && kp[u] <= qpos && (long long)kp[u] > lo_pos;
    // the KU keys' scores together (their shuffles interleave), then one
    // online-softmax update for all of them
    float s[KU][G];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      float kf[E];
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        float f[V];
        attn::unpack(kr[u][i], f);
#pragma unroll
        for (int e = 0; e < V; ++e) kf[i * V + e] = f[e];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) d += qf[g][e] * kf[e];
        s[u][g] = d;
      }
    }
    for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < KU; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) s[u][g] += __shfl_xor_sync(mask, s[u][g], off);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mn = m[g];
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        s[u][g] = attn::cap_score(s[u][g], cap);
        if (ok[u]) mn = fmaxf(mn, s[u][g]);
      }
      const float corr = expf(m[g] - mn);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
      m[g] = mn;
#pragma unroll
      for (int u = 0; u < KU; ++u) s[u][g] = ok[u] ? expf(s[u][g] - mn) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      if (!ok[u]) continue;   // uniform in the subgroup; masked v unread
      float vf[E];
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        float f[V];
        attn::unpack(vr[u][i], f);
#pragma unroll
        for (int e = 0; e < V; ++e) vf[i * V + e] = f[e];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        l[g] += s[u][g];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += s[u][g] * vf[e];
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
    for (int i = 0; i < NCH; ++i) {
      const int c = sl + i * LPR;
      if (c < NV) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          accs[(sg * G + g) * hd + c * V + e] = acc[g][i * V + e];
      }
    }
  }
  __syncthreads();
  const long long pbase = (long long)bk * nsplit;
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
    if (nsplit == 1) {
      attn::store(out + ((long long)b * H + kh * G + g) * hd + d,
                  a / fmaxf(lsum, 1e-30f));
    } else {
      part_acc[((pbase + split) * G + g) * hd + d] = a;
      if (d == 0) {
        part_ml[((pbase + split) * G + g) * 2] = mx;
        part_ml[((pbase + split) * G + g) * 2 + 1] = lsum;
      }
    }
  }
  if (nsplit == 1) return;

  // the last split of this (row, kv head) to finish merges every split:
  // every split's (m, l) into shared memory at once, the weights once a
  // (split, head), then the accumulators with their loads in flight
  // together
  __threadfence();      // this block's partial, visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[bk], 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // in the accumulators' space, no longer read: m, l and the weights
  // [nsplit][G] each, then 1 / (sum of l) [G]
  float* sm_m = accs;
  float* sm_l = sm_m + nsplit * G;
  float* wts = sm_l + nsplit * G;
  for (int i = threadIdx.x; i < nsplit * G; i += THREADS) {
    sm_m[i] = __ldcg(part_ml + (pbase * G + i) * 2);
    sm_l[i] = __ldcg(part_ml + (pbase * G + i) * 2 + 1);
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = attn::NEG_INF, lsum = 0.0f;
    for (int s2 = 0; s2 < nsplit; ++s2) mx = fmaxf(mx, sm_m[s2 * G + g]);
    for (int s2 = 0; s2 < nsplit; ++s2) {
      const float w = expf(sm_m[s2 * G + g] - mx);
      wts[s2 * G + g] = w;
      lsum += sm_l[s2 * G + g] * w;
    }
    wts[nsplit * G + g] = 1.0f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * hd; i += THREADS) {
    const int g = i / hd, d = i % hd;
    float a = 0.0f;
#pragma unroll 4
    for (int s2 = 0; s2 < nsplit; ++s2)
      a += __ldcg(part_acc + ((pbase + s2) * G + g) * hd + d) * wts[s2 * G + g];
    attn::store(out + ((long long)b * H + kh * G + g) * hd + d,
                a * wts[nsplit * G + g]);
  }
  if (threadIdx.x == 0) tickets[bk] = 0;   // ready for the next call
}

struct Args {
  const void *q, *k, *v;
  const int *sp, *table, *pos;
  void* out;
  float *part_acc, *part_ml;
  int* tickets;
  int B, H, KH, hd, P, M, window, nsplit;
  float scale, cap;
};

template <typename T, int G, int NCH>
int launch_g(const Args& a, cudaStream_t stream) {
  constexpr int V = attn::Vec<T>::N;
  const int nsg = WARPS * (32 / lanes_per_row(a.hd / V, NCH));
  const size_t smem = sizeof(float) * (((a.M + 3) & ~3) + 2 * nsg * G +
                                       (size_t)nsg * G * a.hd);
  auto kern = paged_decode_kernel<T, G, NCH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(a.B * a.KH, a.nsplit), THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.sp, a.table, a.pos, static_cast<T*>(a.out),
      a.part_acc, a.part_ml, a.tickets, a.H, a.KH, a.hd, a.P, a.M, a.window,
      a.scale, a.cap);
  return (int)cudaGetLastError();
}

template <typename T, int NCH>
int launch_t(const Args& a, cudaStream_t s) {
  switch (a.H / a.KH) {
    case 1: return launch_g<T, 1, NCH>(a, s);
    case 2: return launch_g<T, 2, NCH>(a, s);
    case 4: return launch_g<T, 4, NCH>(a, s);
    case 8: return launch_g<T, 8, NCH>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd); k/v pages (N, P, KH, hd); slot_pos (N, P) int32; table
// (B, M) int32; positions (B,) int32; out (B, H, hd).  dtype 0 = f32,
// 1 = bf16; hd a multiple of 4 (f32) or 8 (bf16), at most 256.  cap <= 0
// means no softcap.  nsplit >= 1 splits of each row's pages; with
// nsplit > 1, part_acc (B * KH * nsplit * H/KH * hd) and part_ml
// (B * KH * nsplit * H/KH * 2) are f32 scratch and tickets (B * KH) int32
// are 0 before the call and 0 after it.  Returns a cudaError_t.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const int* slot_pos,
                                   const int* table, const int* positions,
                                   void* out, float* part_acc, float* part_ml,
                                   int* tickets, int B, int H, int KH, int hd,
                                   int P, int M, int window, int nsplit,
                                   float scale, float cap, int dtype,
                                   void* stream) {
  if (B < 1 || KH < 1 || H % KH != 0 || P < 1 || M < 1 || window < 1 ||
      nsplit < 1 || hd < 1 || hd > MAX_HD)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, slot_pos, table, positions, out, part_acc,
               part_ml, tickets, B, H, KH, hd, P, M, window, nsplit, scale,
               cap};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && hd % 4 == 0)
    return hd <= 128 ? launch_t<float, 1>(a, s) : launch_t<float, 2>(a, s);
  if (dtype == 1 && hd % 8 == 0) return launch_t<__nv_bfloat16, 1>(a, s);
  return (int)cudaErrorInvalidValue;
}
