// Blocked online-softmax attention (flash attention) for sm_90a, with GQA,
// an index-based causal / sliding-window mask and a logit softcap.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas,
// grid (B*H, q blocks, kv blocks) with the kv axis sequential and the
// running max, denominator and accumulator in VMEM scratch).  Plain
// version: src/repro_torch/kernels/ref.py::attention_ref.
//
// What bounds it on an H100: at the prefill shapes the serving path sends
// (internlm2-1.8b, hd 128, 16 q heads on 8 kv heads, S = 128-512), each
// visible (query, key) pair costs 4 * hd flops against 2 * hd elements of
// k/v read once a kv head, so the work is matrix products; the bound is
// bf16 tensor-core operations (989 TFLOP/s) or, at short prompts, the
// bytes of q, k, v and out.  Two kernels, routed by dtype (not a
// fallback: each dtype has its one kernel):
//
// bf16: Hopper's tensor cores (flash_attention_mma_kernel), one
// warpgroup (4 warps, 64 rows) a block.
//  * The kernel runs at a padded width HDP, the next multiple of 64 at or
//    above the head dim (hd 64 -> 64; 80, 112, 128 -> 128; 160 -> 192):
//    the K/V tensor maps keep the true hd as their innermost dimension,
//    so TMA fills the box columns past hd with zeros, Q's padding chunks
//    load as zeros, and the epilogue stores only the first hd columns.
//    Zeros add nothing to Q K^T, and V's zero columns give output columns
//    that are never stored; the scale comes in from the true hd.  The
//    padding costs MMA work: 1.6x at hd 80, 1.14x at 112, 1.2x at 160.
//  * Rows of a block are (query, q head) pairs of one kv head: row R of
//    the (b, kv head) stream is query R / G, q head kh * G + R % G, so the
//    G heads that share a kv head read each K/V tile once, and the rows of
//    a block are one contiguous span of q and out.  Blocks that end later
//    on the causal diagonal, with the most tiles, start first.
//  * K and V tiles of BK = 64 keys stay bf16 in shared memory, in the
//    128-byte-swizzled layout wgmma reads, brought in by TMA (a tensor map
//    over the strided (B, S, KH, hd) layout, 64-dim boxes; keys past Skv
//    read as zero) into a ring of three stages with a "full" and an
//    "empty" mbarrier each: tiles land while earlier ones are computed,
//    and one thread refills a stage once every thread's MMAs have read it.
//    Q (64 rows) comes in once by cp.async.
//  * S = Q K^T by wgmma m64n64k16 (bf16 in, f32 accumulate), both operands
//    from shared memory.  The products are exact; `scale` multiplies the
//    f32 scores (q is not rounded after scaling), then the softcap.
//  * Online softmax in f32 registers, over a row's four threads, in base 2
//    (exp2 of scores times log2 e); masked keys get weight 0 and never
//    raise the running max; tiles that every row of a warp sees whole skip
//    the mask.
//  * O += P V by wgmma m64n(hd)k16 with P from registers (its layout is
//    S's accumulator layout) and V from shared memory, transposed.  P is
//    split in two bf16 parts, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
//    two products into the same f32 accumulator: P keeps ~2^-17 of its
//    relative precision, where one bf16 P would lose up to 2^-9 of
//    sum p |v| and miss the one-bf16-ulp check on outputs near 0.  The
//    plain version computes P and PV in f32.  The split makes PV twice
//    the products of one bf16 pass, so the kernel does 1.5x the MMA work
//    of an attention that rounds P to bf16.
//  * Tiles wholly above the causal diagonal or below the window are
//    skipped.
//
// f32: fp32 FMA pipe (flash_attention_f32_kernel), as the first port:
// one block of 128 threads per (batch, q head, 32 queries), four threads
// to a query row, kv tiles of 32 keys staged as f32, scores for eight keys
// at a time reduced over the row's threads with shuffles.
//
// In both, every query row with q <= Skv - 1 sees at least key q itself,
// so no stored row is left empty.  Accumulation is f32; the output is
// stored in the input's type.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "wgmma.cuh"

namespace {

// ------------------------------------------------------------- bf16 ----
constexpr int BK = 64;                 // keys a tile
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

// 16 bytes from global to shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   wg::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c (8 bf16) of row r in a [rows][HD] bf16
// tile kept as wgmma's 128-byte-swizzled layout: HD / 64 column blocks of
// [rows][64], each row's chunk index XORed with the row's low three bits.
template <int ROWS>
__device__ __forceinline__ int sw128(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// PV for one 16-key step: O (64 x HD) += P (registers) V (shared, keys x
// HD, MN-major for the MMA)
template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 2],
                                        const uint32_t (&p)[4], uint64_t dv);
template <>
__device__ __forceinline__ void pv_step<192>(float (&o)[96],
                                             const uint32_t (&p)[4],
                                             uint64_t dv) {
  wg::wgmma_m64n192k16_rs_mn(o, p, dv);
}
template <>
__device__ __forceinline__ void pv_step<128>(float (&o)[64],
                                             const uint32_t (&p)[4],
                                             uint64_t dv) {
  wg::wgmma_m64n128k16_rs_mn(o, p, dv);
}
template <>
__device__ __forceinline__ void pv_step<64>(float (&o)[32],
                                            const uint32_t (&p)[4],
                                            uint64_t dv) {
  wg::wgmma_m64n64k16_rs_mn(o, p, dv);
}

constexpr int BM = 64;                 // rows a block: one warpgroup
constexpr int THREADS = 128;

// Q, the K/V ring, the barriers
template <int HD>
constexpr int smem_bytes() {
  return (BM + 2 * STAGES * BK) * HD * 2 + 2 * STAGES * 8;
}

// HD is the padded width HDP; hd (a multiple of 8, HD - 64 < hd <= HD)
// the true one
template <int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_mma_kernel(
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __nv_bfloat16* __restrict__ q,
    __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H, int KH, int hd,
    int causal, int window, float scale, float cap) {
  constexpr int KS = HD / 16;          // k-steps of Q K^T
  constexpr int NT = BK / 8;           // 8-key tiles of S
  constexpr int CH = HD / 8;           // 16-byte chunks a row
  constexpr int TILE = BK * HD * 2;    // bytes of one K or V tile
  // 1024-byte aligned (the kernel has no static shared memory): every
  // 8-row x 128-byte swizzle atom sits on a 1024-byte boundary
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* Qs = smem;                         // [BM][HD]
  unsigned char* Ks = Qs + BM * HD * 2;             // [STAGES][BK][HD]
  unsigned char* Vs = Ks + STAGES * TILE;           // [STAGES][BK][HD]
  // full[s]: stage s holds its K and V tiles; empty[s]: every thread's
  // MMAs have read them
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * TILE);
  uint64_t* empty = full + STAGES;

  const int G = H / KH;
  const int rows = Sq * G;
  const int nrb = (rows + BM - 1) / BM;
  const int rb = nrb - 1 - blockIdx.x;             // latest rows first
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int R0 = rb * BM;
  const int Rw = R0 + warp * 16;                   // the warp's first row

  // row R of this (b, kh) is query R / G, q head kh * G + R % G: the G
  // rows of one query are contiguous in q and out
  auto row_off = [&](int R) -> long long {
    return ((long long)(b * Sq + R / G) * H + kh * G + R % G) * hd;
  };
  // query positions of the thread's rows g and g + 8, and the warp's
  const int qi[2] = {(Rw + g) / G, (Rw + g + 8) / G};
  const int wq_lo = Rw / G, wq_hi = (Rw + 15) / G;

  // visible key range of the whole block
  const int qmin = R0 / G;
  const int qmax = min(Sq - 1, (R0 + BM - 1) / G);
  int kv_hi = Skv;
  if (causal) kv_hi = min(Skv, qmax + 1);
  const long long lo = (long long)qmin - window + 1;
  const int kv_lo = lo > 0 ? (int)(lo / BK) * BK : 0;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  // tile i's K and V by TMA, in 64-dim boxes; keys past Skv and columns
  // past hd read as 0
  auto load_tile = [&](int i) {
    const int st = i % STAGES, j0 = kv_lo + i * BK;
    wg::mbar_expect(&full[st], 2 * TILE);
#pragma unroll
    for (int cb = 0; cb < HD / 64; ++cb) {
      wg::tma_load_4d(Ks + st * TILE + cb * BK * 128, &tk, cb * 64, kh, j0, b,
                      &full[st]);
      wg::tma_load_4d(Vs + st * TILE + cb * BK * 128, &tv, cb * 64, kh, j0, b,
                      &full[st]);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], THREADS);
    }
    wg::mbar_init_fence();
    for (int i = 0; i < STAGES && i < ntiles; ++i) load_tile(i);
  }
  // the Q tile, rows past the stream and columns past hd zero-filled
  for (int c = tid; c < BM * CH; c += THREADS) {
    const int r = c / CH, ch = c % CH, R = R0 + r;
    const bool ok = R < rows && ch * 8 < hd;
    cp_async16(Qs + sw128<BM>(r, ch), q + (ok ? row_off(R) + ch * 8 : 0), ok);
  }
  cp_commit();
  cp_wait_all();
  wg::fence_shared();   // this thread's Q copies, visible to the MMAs
  __syncthreads();      // and every thread's; the barriers are initialised

  // O: the accumulator of the PV products, element 4 j + e of 8-column
  // tile j (rows g, g + 8 as e / 2, columns 8 j + 2 t + e % 2)
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m[2] = {attn::NEG_INF, attn::NEG_INF}, l[2] = {0.0f, 0.0f};

  for (int i = 0; i < ntiles; ++i) {
    const int j0 = kv_lo + i * BK, st = i % STAGES;
    const uint32_t round = (i / STAGES) & 1;
    wg::mbar_wait(&full[st], round);

    // S = Q K^T: 64 rows x BK keys, 16 dims a step; the
    // descriptors step 32 bytes inside a 128-byte swizzle row and a column
    // block (rows x 128 bytes) every 64 dims
    const unsigned char* ks = Ks + st * TILE;
    float s[NT][4];
    float(&sf)[NT * 4] = reinterpret_cast<float(&)[NT * 4]>(s);
    wg::fence();
#pragma unroll
    for (int kq = 0; kq < KS; ++kq)
      wg::wgmma_m64n64k16_ss(
          sf, wg::desc(Qs + (kq / 4) * 128 * BM + (kq % 4) * 32, 16, 1024,
                       wg::SW128),
          wg::desc(ks + (kq / 4) * 128 * BK + (kq % 4) * 32, 16, 1024,
                   wg::SW128),
          kq > 0);
    wg::commit();
    wg::wait_all();

    // scale and softcap (one uniform branch, not one a score), then the
    // mask, in base 2 (scores times log2(e), then exp2)
    if (cap > 0.0f) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = tanhf(s[n][e] * scale / cap) * cap * LOG2E;
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale * LOG2E;
    }
    // a tile every key of which each of the warp's rows sees needs no mask
    const bool inside = j0 + BK <= Skv && (!causal || j0 + BK - 1 <= wq_lo) &&
                        j0 > wq_hi - window;
    if (!inside) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + n * 8 + 2 * t + (e & 1);
          const int qp = qi[e >> 1];
          const bool ok = key < Skv && (!causal || key <= qp) &&
                          key > qp - window;
          if (!ok) s[n][e] = -INFINITY;
        }
    }
    // online softmax over the row's four threads; masked scores are -inf,
    // so they never raise the running max and exp2f gives them exactly 0
    float c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mg = attn::NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mg = fmaxf(mg, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, 1));
      mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, 2));
      const float mn = fmaxf(m[h], mg);
      c[h] = exp2f(m[h] - mn);
      m[h] = mn;
      float ps = 0.0f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * h] = exp2f(s[n][2 * h] - mn);
        s[n][2 * h + 1] = exp2f(s[n][2 * h + 1] - mn);
        ps += s[n][2 * h] + s[n][2 * h + 1];
      }
      l[h] = l[h] * c[h] + ps;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= c[0];
      o[4 * j + 1] *= c[0];
      o[4 * j + 2] *= c[1];
      o[4 * j + 3] *= c[1];
    }

    // P = P_hi + P_lo in bf16, as the A operand of each 16-key step:
    // a0 (row g, keys 2t..), a1 (row g + 8), a2 / a3 the keys 8 on
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int h2 = 0; h2 < 4; ++h2) {
        const float p0 = s[2 * kk + (h2 >> 1)][(h2 & 1) * 2];
        const float p1 = s[2 * kk + (h2 >> 1)][(h2 & 1) * 2 + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        ph[kk][h2] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[kk][h2] = pack_bf16(p0 - hf.x, p1 - hf.y);
      }
    }
    // O += P_lo V + P_hi V: V's descriptor steps 16 key rows (2048 bytes)
    // a step; its 64-dim column blocks lie BK * 128 bytes apart
    const unsigned char* vs = Vs + st * TILE;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      pv_step<HD>(o, pl[kk],
                  wg::desc(vs + kk * 2048, 128 * BK, 1024, wg::SW128));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      pv_step<HD>(o, ph[kk],
                  wg::desc(vs + kk * 2048, 128 * BK, 1024, wg::SW128));
    wg::commit();
    wg::wait_all();
    // this thread's MMAs are done with the stage; once every thread's are,
    // thread 0 refills it with tile i + STAGES
    wg::mbar_arrive(&empty[st]);
    if (tid == 0 && i + STAGES < ntiles) {
      wg::mbar_wait(&empty[st], round);
      load_tile(i + STAGES);
    }
    __syncwarp();   // warp 0 whole again before its next MMAs
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.0f / fmaxf(lt, 1e-30f);
    const int R = Rw + g + h * 8;
    if (R >= rows) continue;
    __nv_bfloat16* orow = out + row_off(R);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      if (j * 8 < hd)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
            pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime's
// entry-point query (no link against libcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// k or v (B, Skv, KH, hd) bf16 as the 4-D tensor {hd, KH, Skv, B}, boxes
// of 64 dims x 1 head x BK keys, 128-byte swizzled as the MMAs read them
// (a box past hd reads zeros there)
bool kv_map(CUtensorMap* map, const void* base, int B, int Skv, int KH,
            int hd) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KH, (cuuint64_t)Skv,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)KH * hd * 2,
                                 (cuuint64_t)Skv * KH * hd * 2};
  const cuuint32_t box[4] = {64, 1, BK, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Skv, int H, int KH, int hd, int causal, int window,
                float scale, float cap, cudaStream_t s) {
  constexpr int smem = smem_bytes<HD>();
  auto kern = flash_attention_mma_kernel<HD>;
  static unsigned long long sized = 0;   // once an instantiation
  const cudaError_t err = wg::allow_smem(kern, smem, sized);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tk, tv;
  if (!kv_map(&tk, k, B, Skv, KH, hd) || !kv_map(&tv, v, B, Skv, KH, hd))
    return (int)cudaErrorInvalidValue;
  const int rows = Sq * (H / KH);
  const dim3 grid((rows + BM - 1) / BM, B * KH);
  kern<<<grid, THREADS, smem, s>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), Sq, Skv, H, KH, hd, causal, window,
      scale, cap);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- f32 ----
constexpr int BQ = 32;
constexpr int BKF = 32;
constexpr int TPR = 4;                 // threads per query row
constexpr int THREADS_F = BQ * TPR;
constexpr int KG = 8;                  // keys per online-softmax update

template <int HD>
__global__ void __launch_bounds__(THREADS_F) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Sq, int Skv,
    int H, int KH, int causal, int window, float scale, float cap) {
  constexpr int V = 4;
  constexpr int NC = HD / 16;          // float4 groups a thread owns
  __shared__ __align__(16) float Ks[BKF][HD];
  __shared__ __align__(16) float Vs[BKF][HD];

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
      qf[c][e] = q_ok ? q[((long long)(b * Sq + qi) * H + h) * HD + d] * scale
                      : 0.0f;
      acc[c][e] = 0.0f;
    }
  }
  float m = attn::NEG_INF, l = 0.0f;

  // visible key range of the whole q block
  int kv_hi = Skv;
  if (causal) kv_hi = min(Skv, (qb + 1) * BQ);
  long long lo = (long long)qb * BQ - window + 1;
  int kv_lo = lo > 0 ? (int)(lo / BKF) * BKF : 0;
  const long long lo_pos = (long long)qi - window;   // keys must be > this

  for (int j0 = kv_lo; j0 < kv_hi; j0 += BKF) {
    __syncthreads();   // the previous tile is no longer read
    for (int i = threadIdx.x; i < BKF * (HD / V); i += THREADS_F) {
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
    for (int kk = 0; kk < BKF; kk += KG) {
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
  float* o = out + ((long long)(b * Sq + qi) * H + h) * HD;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c * 16 + r * 4 + e] = acc[c][e] * inv;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Skv, int H, int KH, int causal, int window,
               float scale, float cap, cudaStream_t s) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_attention_f32_kernel<HD><<<grid, THREADS_F, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, KH,
      causal, window, scale, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd); k/v (B, Skv, KH, hd); out (B, Sq, H, hd); query i and
// key j at positions i and j.  hd 64, 80, 112, 128 or 160.  dtype 0 = f32
// (the fp32 kernel), 1 = bf16 (the tensor-core kernel, at the padded width
// 64, 128 or 192).  window 1 << 30 means none; cap <= 0 means no softcap.
// Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int KH, int hd,
                                      int causal, int window, float scale,
                                      float cap, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KH < 1 || H % KH != 0 || window < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_ARGS q, k, v, out, B, Sq, Skv, H, KH
#define FA_REST causal, window, scale, cap, s
  if (dtype == 0) {
    switch (hd) {
      case 64: return launch_f32<64>(FA_ARGS, FA_REST);
      case 80: return launch_f32<80>(FA_ARGS, FA_REST);
      case 112: return launch_f32<112>(FA_ARGS, FA_REST);
      case 128: return launch_f32<128>(FA_ARGS, FA_REST);
      case 160: return launch_f32<160>(FA_ARGS, FA_REST);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 64: return launch_bf16<64>(FA_ARGS, hd, FA_REST);
      case 80: case 112: case 128: return launch_bf16<128>(FA_ARGS, hd, FA_REST);
      case 160: return launch_bf16<192>(FA_ARGS, hd, FA_REST);
    }
  }
#undef FA_ARGS
#undef FA_REST
  return (int)cudaErrorInvalidValue;
}
