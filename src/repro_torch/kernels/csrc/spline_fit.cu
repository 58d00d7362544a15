// Batched natural-cubic-spline fit over shared knots (Thomas solve).
//
// Replaces the TPU kernel repro/kernels/spline_fit.py::nat_spline_fit_pallas
// (the Pallas `_fit_kernel`).
//
// Computes, for knots x (N,) with 1 <= N <= 16 and rows Y (R, N) f32, the
// (R, N-1, 4) local coefficients a + b t + c t^2 + d t^3 of each row's natural
// cubic spline, as the plain-torch twin
// (repro_torch/kernels/ref.py::nat_spline_fit_ref) does.  N = 1 (a constant)
// and N = 2 (a line) have no tridiagonal system and are handled here too, so
// the card never hands a degenerate knot vector to another route.
//
// What bounds it on an H100: at the additive refit's sizes (N = 9 pp knots,
// R = a few hundred to a few thousand rows) the whole call moves well under
// a megabyte, so it is bound by the launch itself (a few microseconds), not
// by bytes (R * (5N - 4) * 4 bytes at 3.35 TB/s) or by flops (~20 N per row).
// At large R it is bandwidth-bound: the output is four times the input.
//
// What the design does about it: one launch for the whole batch, one thread
// per row.  The knot-only Thomas factors (h, cp and 1/denom) are computed once
// per block into shared memory; each thread then reads its row once, runs the
// forward and backward sweeps in registers (N is a template parameter, so
// every loop is unrolled and no array leaves registers), and writes its
// coefficients once as float4 stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 16;

template <int N>
__global__ void spline_fit_kernel(const float* __restrict__ x,
                                  const float* __restrict__ Y, int R,
                                  float4* __restrict__ out) {
  constexpr int NM = N > 2 ? N - 2 : 1;  // interior unknowns M_1..M_{N-2}
  __shared__ float sh[N > 1 ? N - 1 : 1];
  __shared__ float scp[NM];
  __shared__ float sinv[NM];
  if (N > 2 && threadIdx.x == 0) {
    for (int i = 0; i < N - 1; ++i) sh[i] = x[i + 1] - x[i];
    float cp = 0.f;
    for (int j = 0; j < N - 2; ++j) {
      const float diag = 2.f * (sh[j] + sh[j + 1]);
      const float denom = j == 0 ? diag : diag - sh[j] * cp;
      cp = sh[j + 1] / denom;
      scp[j] = cp;
      sinv[j] = 1.f / denom;
    }
  }
  __syncthreads();

  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = Y[r * N + i];

  if constexpr (N == 1) {
    out[r] = make_float4(y[0], 0.f, 0.f, 0.f);
  } else if constexpr (N == 2) {
    out[r] = make_float4(y[0], (y[1] - y[0]) / (x[1] - x[0]), 0.f, 0.f);
  } else {
    // forward sweep: dp_j = (rhs_j - h_j dp_{j-1}) / denom_j
    float dp[N - 2];
#pragma unroll
    for (int j = 0; j < N - 2; ++j) {
      const float rhs = 6.f * ((y[j + 2] - y[j + 1]) / sh[j + 1] -
                               (y[j + 1] - y[j]) / sh[j]);
      dp[j] = (j == 0 ? rhs : rhs - sh[j] * dp[j - 1]) * sinv[j];
    }
    // back substitution -> second derivatives, natural boundary M_0 = M_{N-1} = 0
    float M[N];
    M[0] = 0.f;
    M[N - 1] = 0.f;
    M[N - 2] = dp[N - 3];
#pragma unroll
    for (int j = N - 4; j >= 0; --j) M[j + 1] = dp[j] - scp[j] * M[j + 2];
#pragma unroll
    for (int i = 0; i < N - 1; ++i) {
      const float h = sh[i];
      const float b =
          (y[i + 1] - y[i]) / h - h * (2.f * M[i] + M[i + 1]) / 6.f;
      out[r * (N - 1) + i] = make_float4(y[i], b, M[i] / 2.f,
                                         (M[i + 1] - M[i]) / (6.f * h));
    }
  }
}

template <int N>
void launch(const float* x, const float* Y, int R, float* out,
            cudaStream_t stream) {
  const int blocks = (R + kThreads - 1) / kThreads;
  spline_fit_kernel<N><<<blocks, kThreads, 0, stream>>>(
      x, Y, R, reinterpret_cast<float4*>(out));
}

}  // namespace

// C interface for ctypes.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).  The caller guarantees
// 1 <= n <= 16, contiguous float32 buffers and a 16-byte aligned `out` of
// R * max(n - 1, 1) * 4 floats.
extern "C" int spline_fit_launch(const float* x, const float* Y, int R, int n,
                                 float* out, void* stream) {
  if (R < 0 || n < 1 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: launch<1>(x, Y, R, out, s); break;
    case 2: launch<2>(x, Y, R, out, s); break;
    case 3: launch<3>(x, Y, R, out, s); break;
    case 4: launch<4>(x, Y, R, out, s); break;
    case 5: launch<5>(x, Y, R, out, s); break;
    case 6: launch<6>(x, Y, R, out, s); break;
    case 7: launch<7>(x, Y, R, out, s); break;
    case 8: launch<8>(x, Y, R, out, s); break;
    case 9: launch<9>(x, Y, R, out, s); break;
    case 10: launch<10>(x, Y, R, out, s); break;
    case 11: launch<11>(x, Y, R, out, s); break;
    case 12: launch<12>(x, Y, R, out, s); break;
    case 13: launch<13>(x, Y, R, out, s); break;
    case 14: launch<14>(x, Y, R, out, s); break;
    case 15: launch<15>(x, Y, R, out, s); break;
    case 16: launch<16>(x, Y, R, out, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
