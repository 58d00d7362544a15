// Nearest-centroid assignment: labels + minimum squared distance.
//
// Replaces the TPU kernel repro/kernels/cluster_assign.py::cluster_assign_pallas
// (the tiled Pallas `_assign_kernel`).
//
// Computes, for points X (N, d) f32 and centroids C (M, d) f32:
//   d2[i]     = min_j max(|x_i|^2 - 2 x_i.c_j + |c_j|^2, 0)
//   labels[i] = the first j that attains that minimum (int32)
// in the same order of operations as the plain-torch twin
// (repro_torch/kernels/ref.py::cluster_assign_ref).
//
// What bounds it on an H100: memory bandwidth.  Per point it reads d floats
// and writes 8 bytes, and does ~3 M d flops; at the clustering path's d = 4,
// M <= 12 that is ~6 flops per byte, far below the card's ~20 f32 flops per
// byte of bandwidth.  N = 1e6 moves 24 MB, about 7 us at 3.35 TB/s.
//
// What the design does about it: one thread per point, so each point's row
// is read from device memory exactly once and each output written once; the
// ragged tail of N is masked, not padded.  The (tiny) centroid matrix and its
// squared norms are staged once per block in shared memory, where every
// thread of the block reads them as broadcasts.  d is a template parameter,
// so the point's row lives in registers and every loop over d is unrolled to
// its exact length: a runtime d, unrolled to the bound 16 under a guard,
// makes the kernel instruction-bound (predicated loads and FMAs) at ~5x the
// byte bound.  When d is a multiple of 4 and X is 16-byte aligned, rows and
// centroids are read as float4.  The TPU kernel's MXU
// cross term is not carried over: with d = 4 there is no product worth a
// tensor core.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 64;
constexpr int kMaxD = 16;
constexpr int kThreads = 256;

template <int D, bool kVec>
__global__ void cluster_assign_kernel(const float* __restrict__ X,
                                      const float* __restrict__ C, int n,
                                      int m, int32_t* __restrict__ labels,
                                      float* __restrict__ dist) {
  __shared__ __align__(16) float sc[kMaxM * D];
  __shared__ float sc2[kMaxM];
  for (int t = threadIdx.x; t < m * D; t += blockDim.x) sc[t] = C[t];
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) s += sc[j * D + k] * sc[j * D + k];
    sc2[j] = s;
  }
  __syncthreads();

  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x[D];
  if constexpr (kVec) {
    const float4* xi = reinterpret_cast<const float4*>(X + i * D);
#pragma unroll
    for (int k = 0; k < D / 4; ++k) {
      const float4 v = xi[k];
      x[4 * k] = v.x;
      x[4 * k + 1] = v.y;
      x[4 * k + 2] = v.z;
      x[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) x[k] = X[i * D + k];
  }
  float x2 = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) x2 += x[k] * x[k];

  float best = __int_as_float(0x7f800000);  // +inf
  int32_t arg = 0;
  for (int j = 0; j < m; ++j) {
    float dot = 0.f;
    if constexpr (kVec) {
      const float4* cj = reinterpret_cast<const float4*>(sc + j * D);
#pragma unroll
      for (int k = 0; k < D / 4; ++k) {
        const float4 c = cj[k];
        dot += x[4 * k] * c.x;
        dot += x[4 * k + 1] * c.y;
        dot += x[4 * k + 2] * c.z;
        dot += x[4 * k + 3] * c.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) dot += x[k] * sc[j * D + k];
    }
    const float d2 = fmaxf(x2 - 2.f * dot + sc2[j], 0.f);
    if (d2 < best) {  // strict: ties keep the first index
      best = d2;
      arg = j;
    }
  }
  labels[i] = arg;
  dist[i] = best;
}

template <int D>
void launch(const float* X, const float* C, int n, int m, int32_t* labels,
            float* dist, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const bool aligned = (reinterpret_cast<uintptr_t>(X) % 16) == 0;
  if constexpr (D % 4 == 0) {
    if (aligned) {
      cluster_assign_kernel<D, true>
          <<<blocks, kThreads, 0, stream>>>(X, C, n, m, labels, dist);
      return;
    }
  }
  cluster_assign_kernel<D, false>
      <<<blocks, kThreads, 0, stream>>>(X, C, n, m, labels, dist);
}

}  // namespace

// C interface for ctypes.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).  The caller guarantees
// contiguous float32/int32 buffers; m and d outside 1..64 and 1..16 are
// refused with cudaErrorInvalidValue.
extern "C" int cluster_assign_launch(const float* X, const float* C, int n,
                                     int d, int m, int32_t* labels,
                                     float* dist, void* stream) {
  if (m < 1 || m > kMaxM || d < 1 || d > kMaxD || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(X, C, n, m, labels, dist, s); break;
    case 2: launch<2>(X, C, n, m, labels, dist, s); break;
    case 3: launch<3>(X, C, n, m, labels, dist, s); break;
    case 4: launch<4>(X, C, n, m, labels, dist, s); break;
    case 5: launch<5>(X, C, n, m, labels, dist, s); break;
    case 6: launch<6>(X, C, n, m, labels, dist, s); break;
    case 7: launch<7>(X, C, n, m, labels, dist, s); break;
    case 8: launch<8>(X, C, n, m, labels, dist, s); break;
    case 9: launch<9>(X, C, n, m, labels, dist, s); break;
    case 10: launch<10>(X, C, n, m, labels, dist, s); break;
    case 11: launch<11>(X, C, n, m, labels, dist, s); break;
    case 12: launch<12>(X, C, n, m, labels, dist, s); break;
    case 13: launch<13>(X, C, n, m, labels, dist, s); break;
    case 14: launch<14>(X, C, n, m, labels, dist, s); break;
    case 15: launch<15>(X, C, n, m, labels, dist, s); break;
    case 16: launch<16>(X, C, n, m, labels, dist, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
