// SM partitions for GMIs on one card.
//
// Replaces no TPU kernel and holds no kernel.  On the TPU a GMI owns whole
// chips (src/repro/core/gmi.py::GMIManager.set_gpu, ::submesh); on an H100
// it owns a share of one card's SMs.  This file binds the CUDA driver calls
// that carve that share (CUDA 12.4+ green contexts), always from splits that
// keep together the SMs a thread-block cluster may span (flags 0 of
// cuDevSmResourceSplitByCount; a split that treats each SM on its own
// makes finer groups, in which cuBLAS's bf16 GEMMs fail once the process
// has run them on the whole card: gmi_probe.py):
//   * sm_split: one split of the card's SMs into `groups` groups of
//     `width` SMs, made once per (device, groups, width) and kept, so that
//     every GMI of a pool draws its SMs from the same disjoint groups;
//   * green_create: a green context over the union of some of those
//     groups (cuDevResourceGenerateDesc, cuGreenCtxCreate) and one stream
//     of its own (cuGreenCtxStreamCreate);
//   * green_push / green_pop: make a green context current and back;
//   * ctx_sms: the SMs of the current context (ctx_sms.cuh);
//   * sm_granularity: the width of the smallest group a split makes;
//   * diag_per_sm_context: diagnostic only, for gmi_probe.py; no GMI uses
//     it.  A context over the first group of a split that treats each SM
//     on its own.
// Contexts are never destroyed: memory the caching allocator took under
// one may still be in use.  The caller keeps one a set of groups.
#include <cuda.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

#include "ctx_sms.cuh"

namespace {

constexpr int MAX_GROUPS = 64;
constexpr int MAX_SPLITS = 32;

struct Split {
  int device, groups, width, got;
  CUdevResource res[MAX_GROUPS];
};

Split splits[MAX_SPLITS];
int nsplits = 0;
std::mutex mu;

CUresult device_sm_resource(int device, CUdevice* dev, CUdevResource* out) {
  CUresult r = cuInit(0);
  if (r != CUDA_SUCCESS) return r;
  if ((r = cuDeviceGet(dev, device)) != CUDA_SUCCESS) return r;
  return cuDeviceGetDevResource(*dev, out, CU_DEV_RESOURCE_TYPE_SM);
}

// the kept split of (device, groups, width); mu held
CUresult find_split(int device, int groups, int width, Split** out) {
  for (int i = 0; i < nsplits; ++i)
    if (splits[i].device == device && splits[i].groups == groups &&
        splits[i].width == width) {
      *out = &splits[i];
      return CUDA_SUCCESS;
    }
  if (groups < 1 || groups > MAX_GROUPS || nsplits == MAX_SPLITS)
    return CUDA_ERROR_INVALID_VALUE;
  Split& s = splits[nsplits];
  CUdevice dev;
  CUdevResource whole, rest;
  CUresult r = device_sm_resource(device, &dev, &whole);
  if (r != CUDA_SUCCESS) return r;
  unsigned int n = (unsigned int)groups;
  r = cuDevSmResourceSplitByCount(s.res, &n, &whole, &rest, 0,
                                  (unsigned int)width);
  if (r != CUDA_SUCCESS) return r;
  s.device = device;
  s.groups = groups;
  s.width = width;
  s.got = (int)n;
  ++nsplits;
  *out = &s;
  return CUDA_SUCCESS;
}

// the SMs of the smallest group a split of card `device` with `flags`
// makes when it asks for groups of one SM
CUresult granularity(int device, unsigned int flags, int* out) {
  CUdevice dev;
  CUdevResource whole;
  CUresult r = device_sm_resource(device, &dev, &whole);
  if (r != CUDA_SUCCESS) return r;
  unsigned int n = 0;
  r = cuDevSmResourceSplitByCount(nullptr, &n, &whole, nullptr, flags, 1);
  if (r != CUDA_SUCCESS) return r;
  if (n == 0) return CUDA_ERROR_INVALID_VALUE;
  std::vector<CUdevResource> res(n);
  r = cuDevSmResourceSplitByCount(res.data(), &n, &whole, nullptr, flags, 1);
  if (r != CUDA_SUCCESS) return r;
  *out = (int)res[0].sm.smCount;
  return CUDA_SUCCESS;
}

// a green context over groups `sel[0..n)` of card `device`, with one
// non-blocking stream of its own; `sms` its SM count
CUresult make_green(int device, CUdevResource* sel, int n, void** ctx,
                    void** stream, int* sms) {
  CUdevResourceDesc desc;
  CUresult r = cuDevResourceGenerateDesc(&desc, sel, (unsigned int)n);
  if (r != CUDA_SUCCESS) return r;
  CUdevice dev;
  if ((r = cuDeviceGet(&dev, device)) != CUDA_SUCCESS) return r;
  CUgreenCtx g;
  if ((r = cuGreenCtxCreate(&g, desc, dev, CU_GREEN_CTX_DEFAULT_STREAM)) !=
      CUDA_SUCCESS)
    return r;
  CUcontext c;
  CUstream st;
  CUdevResource got;
  if ((r = cuCtxFromGreenCtx(&c, g)) != CUDA_SUCCESS ||
      (r = cuGreenCtxStreamCreate(&st, g, CU_STREAM_NON_BLOCKING, 0)) !=
          CUDA_SUCCESS ||
      (r = cuGreenCtxGetDevResource(g, &got, CU_DEV_RESOURCE_TYPE_SM)) !=
          CUDA_SUCCESS) {
    cuGreenCtxDestroy(g);
    return r;
  }
  *ctx = (void*)c;
  *stream = (void*)st;
  *sms = (int)got.sm.smCount;
  return CUDA_SUCCESS;
}

}  // namespace

// The split's groups made (`got`) and each one's SMs (`widths`, `groups`
// ints).  A split that makes fewer groups than asked is the caller's to
// refuse.
extern "C" int sm_split(int device, int groups, int width, int* got,
                        int* widths) {
  std::lock_guard<std::mutex> lock(mu);
  Split* s = nullptr;
  CUresult r = find_split(device, groups, width, &s);
  if (r != CUDA_SUCCESS) return (int)r;
  *got = s->got;
  for (int i = 0; i < s->got; ++i) widths[i] = (int)s->res[i].sm.smCount;
  return 0;
}

// The partition granularity: the SMs of the smallest group a split makes.
extern "C" int sm_granularity(int device, int* out) {
  return (int)granularity(device, 0, out);
}

// A green context over groups `slots[0..n)` of the split (device, groups,
// width), with one non-blocking stream of its own; `sms` its SM count.
extern "C" int green_create(int device, int groups, int width,
                            const int* slots, int n, void** ctx,
                            void** stream, int* sms) {
  std::lock_guard<std::mutex> lock(mu);
  Split* s = nullptr;
  CUresult r = find_split(device, groups, width, &s);
  if (r != CUDA_SUCCESS) return (int)r;
  if (n < 1 || n > s->got) return (int)CUDA_ERROR_INVALID_VALUE;
  CUdevResource sel[MAX_GROUPS];
  for (int i = 0; i < n; ++i) {
    if (slots[i] < 0 || slots[i] >= s->got)
      return (int)CUDA_ERROR_INVALID_VALUE;
    sel[i] = s->res[slots[i]];
  }
  return (int)make_green(device, sel, n, ctx, stream, sms);
}

extern "C" int green_push(void* ctx) {
  return (int)cuCtxPushCurrent((CUcontext)ctx);
}

// Pops the current context; refuses if it is not `ctx`.
extern "C" int green_pop(void* ctx) {
  CUcontext cur = nullptr;
  CUresult r = cuCtxGetCurrent(&cur);
  if (r != CUDA_SUCCESS) return (int)r;
  if (cur != (CUcontext)ctx) return (int)CUDA_ERROR_INVALID_CONTEXT;
  return (int)cuCtxPopCurrent(&cur);
}

extern "C" int ctx_sms(int* out) { return (int)current_ctx_sms(*out); }

// Diagnostic only (gmi_probe.py): no GMI uses it.  Splits card `device`
// into `groups` groups of `width` SMs treating each SM on its own
// (CU_DEV_SM_RESOURCE_SPLIT_IGNORE_SM_COSCHEDULING), and makes a green
// context over the first group: `gran` that split mode's granularity,
// `got` the groups made.  Not kept: one a call.
extern "C" int diag_per_sm_context(int device, int groups, int width,
                                   int* gran, int* got, void** ctx,
                                   void** stream, int* sms) {
  const unsigned int each = CU_DEV_SM_RESOURCE_SPLIT_IGNORE_SM_COSCHEDULING;
  CUresult r = granularity(device, each, gran);
  if (r != CUDA_SUCCESS) return (int)r;
  if (groups < 1 || groups > MAX_GROUPS) return (int)CUDA_ERROR_INVALID_VALUE;
  CUdevice dev;
  CUdevResource whole, rest, res[MAX_GROUPS];
  if ((r = device_sm_resource(device, &dev, &whole)) != CUDA_SUCCESS)
    return (int)r;
  unsigned int n = (unsigned int)groups;
  if ((r = cuDevSmResourceSplitByCount(res, &n, &whole, &rest, each,
                                       (unsigned int)width)) != CUDA_SUCCESS)
    return (int)r;
  *got = (int)n;
  if (n < 1) return (int)CUDA_ERROR_INVALID_VALUE;
  return (int)make_green(device, res, 1, ctx, stream, sms);
}
