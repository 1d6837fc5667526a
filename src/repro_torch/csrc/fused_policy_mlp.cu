// Fused tanh-MLP policy trunk for sm_90a: every layer in one launch,
// h = tanh(h @ w + b) per layer, f32 in, f32 out, at f32 accuracy on the
// tensor cores (3xTF32).
//
// Replaces: src/repro/kernels/fused_policy_mlp.py::fused_policy_mlp
// (Pallas, every weight matrix resident in VMEM, grid over batch blocks).
// Plain version: src/repro_torch/kernels/ref.py::policy_mlp_ref.
//
// What bounds it on an H100: operations.  ShadowHand's trunk
// (211:512:512:512:256) is 2 * 763,392 flops a row, 25.0 GFLOP at
// N = 16384.  At f32 accuracy on the tensor cores that is the three TF32
// passes below, 75.0 GFLOP, 0.152 ms at the 495 TFLOP/s TF32 peak (the
// fp32 pipe would take 0.37 ms at 67 TFLOP/s), while its bytes (x, ~3 MB
// of weights, out) take ~8 us at 3.35 TB/s.
//
// Design: the TPU kept the weights on chip; Hopper's 227 KB of shared
// memory per block cannot hold ShadowHand's ~3 MB of weights, so the roles
// swap: each block takes ROWS = 64 rows (one wgmma M tile) and keeps their
// activations on chip, f32 in one shared buffer of 64 x 512 (each row's
// columns XORed with 4 x (row % 8), so a warp's fragment loads hit 32
// banks), overwritten in place by each layer's output once every warp has
// read its input (a barrier between).
//
// Products: 3xTF32 on wgmma (m64n64k8, f32 accumulate).  Each operand x
// splits into x_hi = tf32(x), rounded to nearest, and the rest
// x_lo = x - x_hi, of which the MMA reads the TF32 part; the accumulator
// takes lo*hi + hi*lo + hi*hi.  The dropped lo*lo term and the split leave
// ~2^-21 of each product, so the result keeps f32-level accuracy; one
// TF32 pass keeps ~2^-11.  The activations (A) are split in registers
// (an integer add, a mask and a subtraction: full-rate ops) and go to the
// MMA as register operands; the weights (B) must come from shared memory,
// K-major.
//
// Two launches.  The first splits every weight matrix once (not once a
// block) into hi and lo parts laid out as the MMAs read them: for each
// k-step of 8 rows, [columns][8] f32 in wgmma's 32-byte-swizzled K-major
// layout, hi then lo (6.1 MB of scratch for ShadowHand).  The second
// streams those k-steps (32 KB at width 512, one contiguous run) from
// global memory, where they stay in the 50 MB L2 across blocks, by one
// bulk (TMA) copy a step into a ring of three stages.  A producer
// warpgroup (one thread of it copies; setmaxnreg gives its registers to
// the consumers) keeps the ring full; each stage has a "full" mbarrier
// (the copy's bytes landed) and an "empty" one (every consumer thread's
// MMAs have read it), so the consumers wait only for data, and the step
// sequence runs on across layer boundaries.  Two consumer warpgroups each
// own four 64-column output chunks (c, c + 2, ...; 128 f32 accumulators a
// thread) and run, per k-step, the lo*hi, hi*lo and hi*hi products of
// every chunk; chunks past a layer's width run too and are never
// stored (a wgmma under a branch would be serialized).  The epilogue's
// tanh is 1 - 2 / (1 + e^(2x)) (within 2e-7 of tanh).  Ragged widths
// (211, Humanoid's 108:200:400:100) are zero-padded to the MMA tiles: the
// activation buffer starts zeroed, the split weights are zero past each
// matrix, and padding output columns are written as 0.  Widths above 512
// or more than 8 layers are refused.  Shared memory: 131,072 bytes of
// activations and 98,304 of weight ring, of the 232,448 a block may use.
// N = 16384 gives 256 blocks, 1.9 waves on 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int ROWS = 64;               // rows a block: one wgmma M tile
constexpr int WGS = 2;                 // consumer warpgroups
constexpr int CONSUMERS = WGS * 128;
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
constexpr int MAXW = 512;
constexpr int MAXL = 8;
constexpr int STAGES = 3;
constexpr int CHUNKS = MAXW / 64 / WGS;   // 64-column chunks a warpgroup
// one k-step of split weights: hi then lo, each [512 columns][8 k] f32
constexpr int STAGE = 2 * MAXW * 8 * 4;
constexpr int ACT = ROWS * MAXW * 4;

struct MlpArgs {
  const float* w[MAXL];
  const float* b[MAXL];
  int dims[MAXL + 1];
  int tile0[MAXL + 1];        // first k-step of each layer; [L] = total
  long long woff[MAXL + 1];   // layer l's weights in ws; [L] = size
  int L;
};

constexpr size_t SMEM_BYTES =
    ACT + STAGES * STAGE + 2 * STAGES * 8 + sizeof(MlpArgs);

__host__ __device__ constexpr int pad64(int n) { return (n + 63) / 64 * 64; }

// x = hi + lo: hi rounded to TF32 (nearest, ties away, by integer add and
// mask: full-rate ops, no conversion unit), lo = x - hi exactly, passed as
// f32 bits, of which the MMA reads the TF32 part (~2^-11 of lo, ~2^-22 of x)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// byte offset of (column n, k in 0..7) in a [columns][8] f32 block of
// wgmma's 32-byte-swizzled K-major layout: the 16-byte half of each
// 32-byte row XORed with bit 2 of the column
__host__ __device__ constexpr int sw32(int n, int k) {
  return n * 32 + ((((k >> 2) ^ (n >> 2)) & 1) << 4) + (k & 3) * 4;
}

// the activation buffer [ROWS][MAXW] f32, column XORed with 4 x (row % 8)
// so that a warp's A-fragment loads hit 32 banks
__device__ __forceinline__ int act_at(int r, int c) {
  return r * MAXW + (c ^ ((r & 7) << 2));
}

// Split every weight matrix into TF32 hi and lo parts in the layout the
// MMAs read (one k-step block after another: hi [pad64(dout)][8], then
// lo, swizzled), zero past the matrix.  One thread an element.
__global__ void __launch_bounds__(256) fused_policy_mlp_split_kernel(
    float* __restrict__ ws, MlpArgs p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (2 * i >= p.woff[p.L]) return;
  int l = 0;
  while (2 * i >= p.woff[l + 1]) ++l;
  const int din = p.dims[l], dout = p.dims[l + 1], np = pad64(dout);
  const long long j = i - p.woff[l] / 2;           // element of the layer
  const int n = (int)(j % np), k = (int)(j / np);
  const float w = k < din && n < dout ? p.w[l][(long long)k * dout + n] : 0.0f;
  uint32_t hi, lo;
  split_tf32(w, hi, lo);
  float* blk = ws + p.woff[l] + (long long)(k / 8) * np * 16;
  blk[sw32(n, k % 8) / 4] = __uint_as_float(hi);
  blk[np * 8 + sw32(n, k % 8) / 4] = __uint_as_float(lo);
}

// tanh as 1 - 2 / (1 + e^(2x)): +-1 at the ends (e^(2x) 0 or inf), |error|
// below 2e-7 over all x; ~6 instructions with no branch, where tanhf's two
// branches both run in a warp of mixed arguments
__device__ __forceinline__ float tanh_f(float x) {
  return 1.0f - 2.0f / (1.0f + __expf(2.0f * x));
}

// a barrier of the consumer warpgroups only (the producer has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__global__ void __launch_bounds__(THREADS, 1) fused_policy_mlp_kernel(
    const float* __restrict__ x, const float* __restrict__ ws,
    float* __restrict__ out, int N, MlpArgs p) {
  // 1024-byte aligned (the kernel has no static shared memory)
  extern __shared__ __align__(1024) unsigned char smem[];
  float* act = reinterpret_cast<float*>(smem);     // [ROWS][MAXW], swizzled
  unsigned char* ring = smem + ACT;                // [STAGES][STAGE]
  // full[s]: stage s holds its k-step; empty[s]: every consumer has read it
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  MlpArgs& sp = *reinterpret_cast<MlpArgs*>(empty + STAGES);  // by layer
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wgi = warp / 4, w4 = warp % 4;
  const int r0 = blockIdx.x * ROWS;
  if (tid == 0) {
    sp = p;
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], CONSUMERS);
    }
    wg::mbar_init_fence();
  }
  // x, and zeros everywhere else: padding columns of every layer's input
  // are 0 (or finite values that meet zero weight rows)
  const int d0 = p.dims[0];
  for (int i = tid; i < ROWS * MAXW; i += THREADS) {
    const int r = i / MAXW, c = i % MAXW;
    act[act_at(r, c)] =
        (c < d0 && r0 + r < N) ? x[(long long)(r0 + r) * d0 + c] : 0.0f;
  }
  __syncthreads();   // sp, the barriers and x visible

  const int total = sp.tile0[sp.L];
  if (wgi == WGS) {
    // the producer warpgroup, its registers given to the consumers: one
    // thread copies k-step i of the whole sequence, hi and lo, one
    // contiguous run, in one bulk copy into its stage once every consumer
    // has read the step that stage held
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS)
      for (int i = 0; i < total; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) wg::mbar_wait(&empty[st], (i / STAGES + 1) & 1);
        int l = 0;
        while (i >= sp.tile0[l + 1]) ++l;
        const int bytes = pad64(sp.dims[l + 1]) * 64;
        wg::mbar_expect(&full[st], bytes);
        const long long step = i - sp.tile0[l];
        wg::bulk_load(ring + st * STAGE, ws + sp.woff[l] + step * (bytes / 4),
                      bytes, &full[st]);
      }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // this warpgroup's 64-column chunks c = wgi + WGS * cc; accumulator
  // element i of chunk cc: row 16 w4 + g + 8 ((i / 2) % 2), column
  // 64 c + 8 (i / 4) + 2 t + i % 2
  float acc[CHUNKS][32];
#pragma unroll
  for (int cc = 0; cc < CHUNKS; ++cc)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[cc][e] = 0.0f;

  int l = 0, k0 = 0;
  int dout = sp.dims[1];
  for (int i = 0; i < total; ++i) {
    const int st = i % STAGES;
    const int np = pad64(dout);
    wg::mbar_wait(&full[st], (i / STAGES) & 1);

    // A: rows 16 w4 + g (+ 8), columns k0 + t (+ 4), split in registers
    uint32_t ah[4], al[4];
    {
      const int r = 16 * w4 + g;
      split_tf32(act[act_at(r, k0 + t)], ah[0], al[0]);
      split_tf32(act[act_at(r + 8, k0 + t)], ah[1], al[1]);
      split_tf32(act[act_at(r, k0 + t + 4)], ah[2], al[2]);
      split_tf32(act[act_at(r + 8, k0 + t + 4)], ah[3], al[3]);
    }
    // lo*hi, hi*lo, hi*hi for every chunk, pass by pass; a chunk's B is
    // 64 columns x 8 k at 2048 bytes a chunk, hi then lo np * 32 on.
    // Chunks past the layer's width run too, on whatever the stage
    // holds there, and are never stored: a wgmma under a branch would be
    // serialized
    const unsigned char* bw = ring + st * STAGE;
    wg::fence();
#pragma unroll
    for (int cc = 0; cc < CHUNKS; ++cc)
      wg::wgmma_m64n64k8_tf32_rs(
          acc[cc], al,
          wg::desc(bw + (wgi + WGS * cc) * 2048, 16, 256, wg::SW32));
#pragma unroll
    for (int cc = 0; cc < CHUNKS; ++cc)
      wg::wgmma_m64n64k8_tf32_rs(
          acc[cc], ah,
          wg::desc(bw + (wgi + WGS * cc) * 2048 + np * 32, 16, 256, wg::SW32));
#pragma unroll
    for (int cc = 0; cc < CHUNKS; ++cc)
      wg::wgmma_m64n64k8_tf32_rs(
          acc[cc], ah,
          wg::desc(bw + (wgi + WGS * cc) * 2048, 16, 256, wg::SW32));
    wg::commit();
    wg::wait_all();
    wg::mbar_arrive(&empty[st]);   // this thread's MMAs are done with it

    k0 += 8;
    if (i + 1 == sp.tile0[l + 1]) {
      // the layer's products are done: bias, tanh, and store
      consumer_sync();   // every consumer has read this layer's input
      const bool last = l + 1 == sp.L;
      const float* bias = sp.b[l];
#pragma unroll
      for (int cc = 0; cc < CHUNKS; ++cc) {
        const int c = wgi + WGS * cc;
        if (c * 64 < dout) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int r = 16 * w4 + g + ((e >> 1) & 1) * 8;
            const int col = c * 64 + 8 * (e >> 2) + 2 * t + (e & 1);
            const float y =
                col < dout ? tanh_f(acc[cc][e] + __ldg(bias + col)) : 0.0f;
            if (!last)
              act[act_at(r, col)] = y;
            else if (col < dout && r0 + r < N)
              out[(long long)(r0 + r) * dout + col] = y;
          }
        }
        // every chunk starts the next layer at 0, those past this layer's
        // width too: a wider next layer (Humanoid's 200 -> 400) uses them
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[cc][e] = 0.0f;
      }
      consumer_sync();   // the next layer's input is in place
      ++l;
      k0 = 0;
      if (!last) dout = sp.dims[l + 1];
    }
  }
}

}  // namespace

// weights/biases: host arrays of L device pointers; dims: host array of
// L + 1 widths, each <= 512, L <= 8; scratch: the sum over layers of
// ceil(din / 8) * pad64(dout) * 16 floats on the device, 16-byte aligned.
// Two launches: the weight split, then the trunk.
extern "C" int fused_policy_mlp_launch(const float* x, float* out, int N,
                                       const float* const* weights,
                                       const float* const* biases,
                                       const int* dims, int L, float* scratch,
                                       void* stream) {
  if (N < 1 || L < 1 || L > MAXL || (uintptr_t)scratch % 16)
    return (int)cudaErrorInvalidValue;
  MlpArgs p;
  p.L = L;
  for (int i = 0; i <= L; ++i) {
    if (dims[i] < 1 || dims[i] > MAXW) return (int)cudaErrorInvalidValue;
    p.dims[i] = dims[i];
  }
  p.tile0[0] = 0;
  p.woff[0] = 0;
  for (int i = 0; i < L; ++i) {
    p.w[i] = weights[i];
    p.b[i] = biases[i];
    p.tile0[i + 1] = p.tile0[i] + (dims[i] + 7) / 8;
    p.woff[i + 1] =
        p.woff[i] + (long long)((dims[i] + 7) / 8) * pad64(dims[i + 1]) * 16;
  }
  for (int i = L; i < MAXL; ++i) {
    p.w[i] = p.b[i] = nullptr;
    p.dims[i + 1] = 0;
    p.tile0[i + 1] = p.tile0[L];
    p.woff[i + 1] = p.woff[L];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long elems = p.woff[L] / 2;
  fused_policy_mlp_split_kernel<<<(unsigned)((elems + 255) / 256), 256, 0,
                                  s>>>(scratch, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static unsigned long long sized = 0;
  err = wg::allow_smem(fused_policy_mlp_kernel, (int)SMEM_BYTES, sized);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + ROWS - 1) / ROWS;
  fused_policy_mlp_kernel<<<blocks, THREADS, SMEM_BYTES, s>>>(x, scratch, out,
                                                              N, p);
  return (int)cudaGetLastError();
}
