// Ring pack of one experience push, all six channels in one launch, for
// sm_90a.
//
// Replaces: src/repro/kernels/channel_pack.py::pack_channels (Pallas,
// grid (1,), the slot index in SMEM, ring buffers aliased in to out).
// Plain version: src/repro_torch/kernels/ref.py::pack_channels_ref.
//
// Layout (S ring slots, one per push; the slot is a runtime argument):
//   obs (T, S*N, obs_dim), actions (T, S*N, act_dim), rewards and dones
//   (T, S*N): slot s owns columns [s*N, (s+1)*N);
//   bootstrap (S, N) and actor_version (S, 1) int32: slot s owns row s.
// The payloads are (T, N, ...) contiguous, bootstrap (N,), and the version
// comes either as a value or as a pointer to one int32 on the card.
//
// What bounds it on an H100: memory.  Every payload byte is read once and
// written once; at ShadowHand T = 16, N = 8192 a push is 122.2 MB, so
// 244.4 MB moved, 73 us at 3.35 TB/s.
//
// Design: for each t, a channel's destination block [t, s*N:(s+1)*N, :]
// is one contiguous run of N*width floats, and so is its source, so the
// kernel is a multi-segment copy.  blockIdx.z picks the channel, blockIdx.y
// the row t, and the blocks along x stride over the run.  Where source
// and destination share their offset modulo 16 bytes the run is copied as
// float4 after a scalar head, else float by float: whether they do
// depends on s*N*width, so it is decided per run inside the kernel.  Other
// slots are never touched.  A copy is exact: the result equals the plain
// version bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHANNELS = 5;   // obs, actions, rewards, dones, bootstrap

__device__ void copy_run(const float* __restrict__ src,
                         float* __restrict__ dst, long long len) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const uintptr_t sa = (uintptr_t)src, da = (uintptr_t)dst;
  if (((sa ^ da) & 15u) != 0) {
    for (long long i = tid; i < len; i += stride) dst[i] = src[i];
    return;
  }
  long long head = (long long)(((16u - (da & 15u)) & 15u) / 4u);
  if (head > len) head = len;
  if (tid < head) dst[tid] = src[tid];
  const long long nvec = (len - head) / 4;
  const float4* __restrict__ s4 = reinterpret_cast<const float4*>(src + head);
  float4* __restrict__ d4 = reinterpret_cast<float4*>(dst + head);
  for (long long i = tid; i < nvec; i += stride) d4[i] = s4[i];
  const long long tail = head + nvec * 4;
  if (tail + tid < len) dst[tail + tid] = src[tail + tid];
}

struct Args {
  const float* src[CHANNELS];
  float* dst[CHANNELS];
  int width[CHANNELS];
  const int* ver_src;
  int ver_val;
  int* ver_dst;
  int T, N, S, slot;
};

__global__ void __launch_bounds__(THREADS) pack_channels_kernel(Args a) {
  const int c = blockIdx.z, t = blockIdx.y;
  if (c == CHANNELS - 1) {            // bootstrap: one row, written at t = 0
    if (t == 0)
      copy_run(a.src[c], a.dst[c] + (long long)a.slot * a.N, a.N);
    if (t == 0 && blockIdx.x == 0 && threadIdx.x == 0)
      a.ver_dst[a.slot] = a.ver_src ? *a.ver_src : a.ver_val;
    return;
  }
  const long long run = (long long)a.N * a.width[c];
  copy_run(a.src[c] + (long long)t * run,
           a.dst[c] + ((long long)t * a.S + a.slot) * run, run);
}

}  // namespace

// Payload and ring pointers in channel order (obs, actions, rewards, dones,
// bootstrap).  ver_src may be null, and then ver_val is written.
extern "C" int pack_channels_launch(
    const float* obs_p, const float* act_p, const float* rew_p,
    const float* done_p, const float* boot_p, const int* ver_src,
    int ver_val, float* obs_b, float* act_b, float* rew_b, float* done_b,
    float* boot_b, int* ver_b, int T, int N, int S, int obs_dim, int act_dim,
    int slot, void* stream) {
  if (T < 1 || N < 1 || S < 1 || slot < 0 || slot >= S || T > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{{obs_p, act_p, rew_p, done_p, boot_p},
         {obs_b, act_b, rew_b, done_b, boot_b},
         {obs_dim, act_dim, 1, 1, 1},
         ver_src, ver_val, ver_b, T, N, S, slot};
  // about four float4 a thread along the widest run
  const long long widest = (long long)N * (obs_dim > act_dim ? obs_dim : act_dim);
  long long bx = (widest + 4LL * 4 * THREADS - 1) / (4LL * 4 * THREADS);
  if (bx < 1) bx = 1;
  if (bx > 65535) bx = 65535;
  const dim3 grid((unsigned)bx, (unsigned)T, CHANNELS);
  pack_channels_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
