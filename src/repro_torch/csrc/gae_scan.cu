// Fused GAE + global advantage normalisation for sm_90a.
//
// Replaces: src/repro/kernels/gae_scan.py::gae_scan (Pallas, grid (1,),
// the whole (T, N) block resident in VMEM).  Plain version:
// src/repro_torch/kernels/ref.py::gae_norm_ref.
//
// What bounds it on an H100: memory.  It reads rewards, values, dones
// (3 T*N f32) and last_value (N) and writes advantages and returns
// (2 T*N f32), ~10 flops an element; at T = 16, N = 16384 that is 5.3 MB,
// 1.6 us at 3.35 TB/s, far below launch latency.
//
// Design: Hopper has no single core to hold the block, and the
// normalisation is global over all T*N elements, so the work is three
// short launches with no atomics, each block reducing in a fixed order:
//   1. one thread per column runs the reverse scan over T (reads coalesce
//      along N), writes adv and ret, and the block writes its partial sum
//      of adv;
//   2. every block sums the partials in the same order (the mean), then
//      writes its partial sum of (adv - mean)^2 — the reference's two-pass
//      centred variance, not E[x^2] - E[x]^2;
//   3. every block derives mean and std the same way and normalises its
//      columns: adv = (adv - mean) / (std + eps).
// Results are deterministic from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// Sum over the block in a fixed order; the result is valid in every thread.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) total = v;
  }
  __syncthreads();
  float out = total;
  __syncthreads();   // total and warp_sums may be reused by the next call
  return out;
}

// Sum of partial[0..nparts) in a fixed order, identical in every block.
__device__ float sum_partials(const float* __restrict__ partial, int nparts) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += THREADS) v += partial[i];
  return block_sum(v);
}

__global__ void __launch_bounds__(THREADS) gae_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ v,
    const float* __restrict__ d, const float* __restrict__ last,
    float* __restrict__ adv, float* __restrict__ ret,
    float* __restrict__ partial, int T, int N, float gamma, float gl) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  float local = 0.0f;
  if (n < N) {
    float a = 0.0f, v_next = last[n];
    for (int t = T - 1; t >= 0; --t) {
      const long long i = (long long)t * N + n;
      const float vt = v[i], nonterm = 1.0f - d[i];
      const float delta = r[i] + gamma * v_next * nonterm - vt;
      a = delta + gl * nonterm * a;
      adv[i] = a;
      ret[i] = a + vt;
      v_next = vt;
      local += a;
    }
  }
  const float s = block_sum(local);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void __launch_bounds__(THREADS) gae_var_kernel(
    const float* __restrict__ adv, const float* __restrict__ partial,
    float* __restrict__ partial2, int T, int N) {
  const float mean = sum_partials(partial, gridDim.x) / ((float)T * (float)N);
  const int n = blockIdx.x * THREADS + threadIdx.x;
  float local = 0.0f;
  if (n < N) {
    for (int t = 0; t < T; ++t) {
      const float c = adv[(long long)t * N + n] - mean;
      local += c * c;
    }
  }
  const float s = block_sum(local);
  if (threadIdx.x == 0) partial2[blockIdx.x] = s;
}

__global__ void __launch_bounds__(THREADS) gae_norm_kernel(
    float* __restrict__ adv, const float* __restrict__ partial,
    const float* __restrict__ partial2, int T, int N, float eps) {
  const float count = (float)T * (float)N;
  const float mean = sum_partials(partial, gridDim.x) / count;
  const float var = sum_partials(partial2, gridDim.x) / count;
  const float denom = sqrtf(fmaxf(var, 0.0f)) + eps;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n < N) {
    for (int t = 0; t < T; ++t) {
      const long long i = (long long)t * N + n;
      adv[i] = (adv[i] - mean) / denom;
    }
  }
}

}  // namespace

// partial: scratch of 2 * ceil(N / 256) floats, allocated by the caller.
extern "C" int gae_scan_launch(const float* rewards, const float* values,
                               const float* dones, const float* last_value,
                               float* adv, float* ret, float* partial, int T,
                               int N, float gamma, float gamma_lam, float eps,
                               void* stream) {
  if (T < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (N + THREADS - 1) / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  float* partial2 = partial + blocks;
  gae_scan_kernel<<<blocks, THREADS, 0, s>>>(rewards, values, dones,
                                             last_value, adv, ret, partial, T,
                                             N, gamma, gamma_lam);
  gae_var_kernel<<<blocks, THREADS, 0, s>>>(adv, partial, partial2, T, N);
  gae_norm_kernel<<<blocks, THREADS, 0, s>>>(adv, partial, partial2, T, N, eps);
  return (int)cudaGetLastError();
}

// The number of scratch floats gae_scan_launch needs for N columns.
extern "C" int gae_scan_scratch(int N) { return 2 * ((N + THREADS - 1) / THREADS); }
