// The SMs of the current CUDA context: the whole card's in the primary
// context, a GMI's share inside its green context (core/gmi.py).  A kernel
// that sizes its grid by what is resident at once (gae_scan.cu) or spreads
// its work over the SMs (paged_decode.cu) reads them here, not the
// device's count.  Read once a context with cuCtxGetDevResource and kept:
// a context's resources do not change, and GMIs' contexts are never
// destroyed.  Each library that includes this keeps its own copy.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <mutex>

inline cudaError_t current_ctx_sms(int& out) {
  constexpr int KEEP = 64;
  static CUcontext ctxs[KEEP] = {nullptr};
  static int counts[KEEP] = {0};
  static int kept = 0;
  static std::mutex mu;
  CUcontext cur = nullptr;
  if (cuCtxGetCurrent(&cur) != CUDA_SUCCESS) return cudaErrorInvalidDevice;
  if (cur == nullptr) {
    // no context yet on this thread: the runtime makes the primary one
    // current
    cudaError_t err = cudaFree(nullptr);
    if (err != cudaSuccess) return err;
    if (cuCtxGetCurrent(&cur) != CUDA_SUCCESS || cur == nullptr)
      return cudaErrorInvalidDevice;
  }
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < kept; ++i)
    if (ctxs[i] == cur) {
      out = counts[i];
      return cudaSuccess;
    }
  CUdevResource res;
  if (cuCtxGetDevResource(cur, &res, CU_DEV_RESOURCE_TYPE_SM) !=
      CUDA_SUCCESS)
    return cudaErrorInvalidDevice;
  out = (int)res.sm.smCount;
  if (out <= 0) return cudaErrorInvalidConfiguration;
  if (kept < KEEP) {
    ctxs[kept] = cur;
    counts[kept] = out;
    ++kept;
  }
  return cudaSuccess;
}
