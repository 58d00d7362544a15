// Batched transfer-surface selection: best candidate per (request, surface).
//
// Replaces the TPU kernel
// repro/kernels/transfer_select.py::batched_predict_argmax_pallas
// (the one-hot-matmul Pallas `_select_kernel`).
//
// Computes, for stacked flattened surface lattices values (S, G) f32 and
// candidate lattice indices idx (B, P) int32:
//   best[b, s] = max_p values[s, idx[b, p]]
//   argk[b, s] = the first p that attains it (int32)
// as the plain-torch twin does (repro_torch/kernels/ref.py::
// batched_predict_argmax_ref): an index in [-G, 0) counts from the end, an
// index outside [-G, G) reads NaN and is never loaded, and a NaN among the
// candidates wins (the first NaN is the result, with its index).
//
// What bounds it on an H100: neither bytes nor operations but the launch.
// The fleet admission path scores one batch row per cluster: B = 1,
// P = S <= 5, G = 16^3 = 4096, i.e. 25 gathered floats and 40 output bytes,
// far below a microsecond of bandwidth.  The whole value stack is at most
// S * G * 4 = 80 KB and stays in L2 between launches.
//
// What the design does about it: nothing is staged.  The TPU kernel's
// one-hot (BB * P, G) tile exists only because the TPU gathers badly; on
// Hopper each output pair is one thread that walks its P candidates and
// loads values[s, idx[b, p]] directly through the read-only path.  Threads
// of a warp share b (s is the fast index), so the candidate row is a
// broadcast load.  The running best is replaced only on strict `>`, which
// keeps the first index on ties; the loop stops at the first NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float lattice_value(const float* __restrict__ row,
                                               int i, int G) {
  if (i < 0) i += G;  // no overflow: i >= INT_MIN and 0 < G < 2^31
  if (i < 0 || i >= G) return __int_as_float(0x7fc00000);  // quiet NaN
  return __ldg(row + i);
}

__global__ void transfer_select_kernel(const float* __restrict__ values,
                                       const int32_t* __restrict__ idx, int S,
                                       int G, int B, int P,
                                       float* __restrict__ best,
                                       int32_t* __restrict__ argk) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(B) * S) return;
  const int64_t b = t / S;
  const int64_t s = t - b * S;
  const float* row = values + s * G;
  const int32_t* cand = idx + b * P;
  float top = lattice_value(row, __ldg(cand), G);
  int32_t arg = 0;
  for (int p = 1; p < P && !isnan(top); ++p) {
    const float v = lattice_value(row, __ldg(cand + p), G);
    if (isnan(v) || v > top) {  // strict: ties keep the first index
      top = v;
      arg = p;
    }
  }
  best[t] = top;
  argk[t] = arg;
}

}  // namespace

// C interface for ctypes.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).  The caller guarantees
// contiguous float32/int32 buffers, P >= 1 and S * G, B * S, B * P < 2^31;
// anything else is refused with cudaErrorInvalidValue.
extern "C" int transfer_select_launch(const float* values, const int32_t* idx,
                                      int S, int G, int B, int P, float* best,
                                      int32_t* argk, void* stream) {
  if (S < 0 || G < 0 || B < 0 || P < 1 ||
      static_cast<int64_t>(S) * G >= (int64_t{1} << 31) ||
      static_cast<int64_t>(B) * S >= (int64_t{1} << 31) ||
      static_cast<int64_t>(B) * P >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(B) * S;
  if (n == 0) return 0;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  transfer_select_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      values, idx, S, G, B, P, best, argk);
  return static_cast<int>(cudaGetLastError());
}
