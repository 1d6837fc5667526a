// Fused GAE + global advantage normalisation, and the A3C n-step return
// scan, for sm_90a.
//
// Replaces: src/repro/kernels/gae_scan.py::gae_scan and ::nstep_scan
// (Pallas, grid (1,), the whole (T, N) block resident in VMEM).  Plain
// versions: src/repro_torch/kernels/ref.py::gae_norm_ref and
// ::nstep_returns_ref.
//
// What bounds GAE on an H100: memory.  It reads rewards, values, dones
// (3 T*N f32) and last_value (N) and writes advantages and returns
// (2 T*N f32), ~10 flops an element; at T = 16, N = 16384 that is 5.3 MB,
// 1.6 us at 3.35 TB/s, far below launch latency.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), whose
// blocks are all resident together, so two grid-wide barriers
// (cooperative_groups' grid.sync) replace the three launches a global
// normalisation would otherwise take.  The grid is capped at the blocks
// the current context's SMs hold at once (a GMI's green context holds
// only its share of the card, ctx_sms.cuh); each thread takes columns n,
// n + grid * 128, ..., so any N works.
//   1. each thread runs the reverse scan over T for its column (reads
//      coalesce along N), writes ret, keeps its column's T advantages in
//      registers (T <= 16 and one column a thread; otherwise it writes
//      them to adv and reads them back from L2 below), and its block
//      writes its partial sum of adv; barrier;
//   2. every block sums the partials in the same fixed order (the mean),
//      then writes its partial sum of (adv - mean)^2 -- the reference's
//      two-pass centred variance, not E[x^2] - E[x]^2; barrier;
//   3. every block derives mean and std the same way and writes
//      adv = (adv - mean) / (std + eps).
// No atomics: results are bit-identical from run to run.  The partials
// live in a scratch of 2 x (resident blocks) floats that the caller
// keeps.
//
// n-step scan: G_t = r_t + gamma * G_{t+1} * (1 - d_t) from G_T =
// bootstrap.  Bound by memory: 3 T*N + N floats; at T = 16, N = 16384,
// 3.2 MB, about 1 us at 3.35 TB/s, below launch latency.  One thread per
// column walks t backwards, so each row's reads and writes coalesce
// along N.  No contraction into FMA: the products and the sum round as
// the plain version's separate tensor ops do, so the two agree bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "ctx_sms.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;       // the n-step scan's block
constexpr int GAE_THREADS = 128;   // the GAE kernel's block
constexpr int TREG = 16;           // time steps kept in registers

// Sum over the block (BT threads) in a fixed order; the result is valid
// in every thread.
template <int BT>
__device__ float block_sum(float v) {
  __shared__ float warp_sums[BT / 32];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < BT / 32 ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) total = v;
  }
  __syncthreads();
  float out = total;
  __syncthreads();   // total and warp_sums may be reused by the next call
  return out;
}

// Sum of partial[0..nparts) in a fixed order, identical in every block.
template <int BT>
__device__ float sum_partials(const float* __restrict__ partial, int nparts) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += BT) v += partial[i];
  return block_sum<BT>(v);
}

// REGS: T <= TREG and at most one column a thread, so each thread keeps
// its column's advantages in registers between the passes
template <bool REGS>
__global__ void __launch_bounds__(GAE_THREADS) gae_norm_kernel(
    const float* __restrict__ r, const float* __restrict__ v,
    const float* __restrict__ d, const float* __restrict__ last,
    float* __restrict__ adv, float* __restrict__ ret,
    float* __restrict__ partial, int T, int N, float gamma, float gl,
    float eps) {
  cg::grid_group grid = cg::this_grid();
  const int nparts = gridDim.x;
  const int stride = nparts * GAE_THREADS;
  const int n0 = blockIdx.x * GAE_THREADS + threadIdx.x;
  float a_reg[TREG];
  float local = 0.0f;
  if (REGS) {
    if (n0 < N) {
      float a = 0.0f, v_next = last[n0];
#pragma unroll
      for (int t = TREG - 1; t >= 0; --t) {
        if (t < T) {
          const long long i = (long long)t * N + n0;
          const float vt = v[i], nonterm = 1.0f - d[i];
          const float delta = r[i] + gamma * v_next * nonterm - vt;
          a = delta + gl * nonterm * a;
          a_reg[t] = a;
          ret[i] = a + vt;
          v_next = vt;
          local += a;
        }
      }
    }
  } else {
    for (int n = n0; n < N; n += stride) {
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
  }
  float sum = block_sum<GAE_THREADS>(local);
  if (threadIdx.x == 0) partial[blockIdx.x] = sum;
  grid.sync();

  const float count = (float)T * (float)N;
  const float mean = sum_partials<GAE_THREADS>(partial, nparts) / count;
  local = 0.0f;
  if (REGS) {
    if (n0 < N) {
#pragma unroll
      for (int t = 0; t < TREG; ++t) {
        if (t < T) {
          const float c = a_reg[t] - mean;
          local += c * c;
        }
      }
    }
  } else {
    for (int n = n0; n < N; n += stride)
      for (int t = 0; t < T; ++t) {
        const float c = adv[(long long)t * N + n] - mean;
        local += c * c;
      }
  }
  sum = block_sum<GAE_THREADS>(local);
  if (threadIdx.x == 0) partial[nparts + blockIdx.x] = sum;
  grid.sync();

  const float var = sum_partials<GAE_THREADS>(partial + nparts, nparts) / count;
  const float denom = sqrtf(fmaxf(var, 0.0f)) + eps;
  if (REGS) {
    if (n0 < N) {
#pragma unroll
      for (int t = 0; t < TREG; ++t)
        if (t < T) adv[(long long)t * N + n0] = (a_reg[t] - mean) / denom;
    }
  } else {
    for (int n = n0; n < N; n += stride)
      for (int t = 0; t < T; ++t) {
        const long long i = (long long)t * N + n;
        adv[i] = (adv[i] - mean) / denom;
      }
  }
}

// The blocks of gae_norm_kernel<REGS> the current context holds at once:
// blocks an SM times the context's SMs (ctx_sms.cuh), not the device's, so
// that inside a green context of a GMI's share of the card the grid is
// what that share holds together.
template <bool REGS>
cudaError_t resident_blocks(int& out) {
  // the same on every context of an sm_90a card
  static int per_sm = 0;
  static std::once_flag once;
  std::call_once(once, [] {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, gae_norm_kernel<REGS>, GAE_THREADS, 0) != cudaSuccess)
      per_sm = 0;
  });
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  int sms = 0;
  cudaError_t err = current_ctx_sms(sms);
  if (err != cudaSuccess) return err;
  out = per_sm * sms;
  return cudaSuccess;
}

__global__ void __launch_bounds__(THREADS) nstep_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ d,
    const float* __restrict__ boot, float* __restrict__ ret, int T, int N,
    float gamma) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  float g = boot[n];
  for (int t = T - 1; t >= 0; --t) {
    const long long i = (long long)t * N + n;
    g = __fadd_rn(r[i], __fmul_rn(__fmul_rn(gamma, g), 1.0f - d[i]));
    ret[i] = g;
  }
}

}  // namespace

// The floats of scratch gae_scan_launch needs in the current context: two
// for each block the context's SMs hold at once.
extern "C" int gae_scan_scratch() {
  int a = 0, b = 0;
  if (resident_blocks<true>(a) != cudaSuccess ||
      resident_blocks<false>(b) != cudaSuccess)
    return -1;
  return 2 * (a > b ? a : b);
}

// partial: scratch of gae_scan_scratch() floats, kept by the caller; one
// cooperative launch
extern "C" int gae_scan_launch(const float* rewards, const float* values,
                               const float* dones, const float* last_value,
                               float* adv, float* ret, float* partial, int T,
                               int N, float gamma, float gamma_lam, float eps,
                               void* stream) {
  if (T < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int want = (N + GAE_THREADS - 1) / GAE_THREADS;
  int cap = 0;
  cudaError_t err = resident_blocks<true>(cap);
  if (err != cudaSuccess) return (int)err;
  const bool regs = T <= TREG && want <= cap;
  if (!regs && (err = resident_blocks<false>(cap)) != cudaSuccess)
    return (int)err;
  dim3 blocks(want < cap ? want : cap), threads(GAE_THREADS);
  void* args[] = {(void*)&rewards, (void*)&values, (void*)&dones,
                  (void*)&last_value, (void*)&adv, (void*)&ret,
                  (void*)&partial, (void*)&T, (void*)&N, (void*)&gamma,
                  (void*)&gamma_lam, (void*)&eps};
  void* kern = regs ? (void*)gae_norm_kernel<true>
                    : (void*)gae_norm_kernel<false>;
  return (int)cudaLaunchCooperativeKernel(kern, blocks, threads, args, 0,
                                          (cudaStream_t)stream);
}

extern "C" int nstep_scan_launch(const float* rewards, const float* dones,
                                 const float* bootstrap, float* ret, int T,
                                 int N, float gamma, void* stream) {
  if (T < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (N + THREADS - 1) / THREADS;
  nstep_scan_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      rewards, dones, bootstrap, ret, T, N, gamma);
  return (int)cudaGetLastError();
}
