// Fused tanh-MLP policy trunk for sm_90a: every layer in one launch,
// h = tanh(h @ w + b) per layer, f32 in, f32 accumulate, no TF32.
//
// Replaces: src/repro/kernels/fused_policy_mlp.py::fused_policy_mlp
// (Pallas, every weight matrix resident in VMEM, grid over batch blocks).
// Plain version: src/repro_torch/kernels/ref.py::policy_mlp_ref.
//
// What bounds it on an H100: fp32 operations.  ShadowHand's trunk
// (211:512:512:512:256) is 2 * 763,392 flops a row, 25.0 GFLOP at
// N = 16384: 0.37 ms at the 67 TFLOP/s fp32 (non-tensor-core) peak, while
// its bytes (x, ~3 MB of weights, out) take ~8 us at 3.35 TB/s.
//
// Design: the TPU kept the weights on chip; Hopper's 227 KB of shared
// memory per block cannot hold ShadowHand's ~3 MB of weights, so the roles
// swap: each block takes ROWS = 32 rows and keeps their activations on chip,
// ping-ponging between two shared buffers of ROWS x max_width f32 (128 KB
// at width 512, dynamic shared memory), stored transposed (k-major) so one
// float4 load gives four rows of one input feature.  Weight rows stream
// from global memory, coalesced along the output columns, and stay in the
// 50 MB L2 across blocks.  Each of the 256 threads owns up to two output
// columns for all 32 rows (64 accumulators in registers).  Ragged widths
// (Humanoid 108:200:400:100) are masked; widths above 512 or more than 8
// layers are refused.  wgmma, TMA and tensor cores are later work.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;
constexpr int THREADS = 256;
constexpr int MAXW = 512;
constexpr int CPT = MAXW / THREADS;    // output columns per thread
constexpr int MAXL = 8;

struct MlpArgs {
  const float* w[MAXL];
  const float* b[MAXL];
  int dims[MAXL + 1];
  int L;
  int maxw;
};

__global__ void __launch_bounds__(THREADS) fused_policy_mlp_kernel(
    const float* __restrict__ x, float* __restrict__ out, int N, MlpArgs p) {
  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + p.maxw * ROWS;
  const int r0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;

  const int d0 = p.dims[0];
  for (int i = tid; i < ROWS * d0; i += THREADS) {
    const int r = i / d0, k = i - r * d0;
    buf0[k * ROWS + r] = (r0 + r < N) ? x[(long long)(r0 + r) * d0 + k] : 0.0f;
  }
  __syncthreads();

  float* hin = buf0;
  float* hout = buf1;
  for (int l = 0; l < p.L; ++l) {
    const int din = p.dims[l], dout = p.dims[l + 1];
    const float* __restrict__ w = p.w[l];
    float acc[CPT][ROWS];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[c][r] = 0.0f;
    bool live[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) live[c] = tid + c * THREADS < dout;

#pragma unroll 2
    for (int k = 0; k < din; ++k) {
      float wk[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        wk[c] = live[c] ? __ldg(w + (long long)k * dout + tid + c * THREADS) : 0.0f;
      const float4* h4 = reinterpret_cast<const float4*>(hin + k * ROWS);
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const float4 hv = h4[q];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[c][4 * q + 0] = fmaf(hv.x, wk[c], acc[c][4 * q + 0]);
          acc[c][4 * q + 1] = fmaf(hv.y, wk[c], acc[c][4 * q + 1]);
          acc[c][4 * q + 2] = fmaf(hv.z, wk[c], acc[c][4 * q + 2]);
          acc[c][4 * q + 3] = fmaf(hv.w, wk[c], acc[c][4 * q + 3]);
        }
      }
    }

    const bool last = l == p.L - 1;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tid + c * THREADS;
      if (!live[c]) continue;
      const float bias = p.b[l][col];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float y = tanhf(acc[c][r] + bias);
        if (last) {
          if (r0 + r < N) out[(long long)(r0 + r) * dout + col] = y;
        } else {
          hout[col * ROWS + r] = y;
        }
      }
    }
    __syncthreads();
    float* tmp = hin;
    hin = hout;
    hout = tmp;
  }
}

}  // namespace

// weights/biases: host arrays of L device pointers; dims: host array of
// L + 1 widths.  Widths must be <= 512 and L <= 8.
extern "C" int fused_policy_mlp_launch(const float* x, float* out, int N,
                                       const float* const* weights,
                                       const float* const* biases,
                                       const int* dims, int L, void* stream) {
  if (N < 1 || L < 1 || L > MAXL) return (int)cudaErrorInvalidValue;
  MlpArgs p;
  p.L = L;
  p.maxw = 0;
  for (int i = 0; i <= L; ++i) {
    if (dims[i] < 1 || dims[i] > MAXW) return (int)cudaErrorInvalidValue;
    p.dims[i] = dims[i];
    p.maxw = dims[i] > p.maxw ? dims[i] : p.maxw;
  }
  for (int i = 0; i < L; ++i) {
    p.w[i] = weights[i];
    p.b[i] = biases[i];
  }
  const size_t smem = 2 * (size_t)p.maxw * ROWS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_policy_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + ROWS - 1) / ROWS;
  fused_policy_mlp_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, out, N, p);
  return (int)cudaGetLastError();
}
