// Mamba2 SSD (state-space duality) chunked scan.
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::ssd_pallas
// (`_ssd_kernel`).
//
// Computes what the plain version ref.ssd_chunked_ref computes, for
// x (B, L, H, P) and B, C (B, L, N) in float32 or bfloat16, dt (B, L, H),
// A (H,) and the states in float32, chunk Q.  Within a chunk, with
// cum = the inclusive cumsum of dt * A (<= 0):
//   y[q]    = exp(cum[q]) C[q] . S_in                                (inter)
//           + sum_{k <= q} (C[q] . B[k]) exp(cum[q] - cum[k]) dt[k] x[k]   (intra)
//   S_out   = exp(cum[end]) S_in + sum_k exp(cum[end] - cum[k]) dt[k] x[k] B[k]^T
// S is the (P, N) state of one (batch, head), carried from chunk to chunk.
// Two things the Pallas kernel does not do: it takes an initial state
// (`init`, else zeros) and emits the final state itself (the Pallas kernel
// rejects initial_state and recomputes the final state through the XLA
// oracle), and it takes a ragged L as the oracle pads it, with dt = 0
// steps: the last chunk has Lc < Q live positions, its padded positions
// add exactly 0 to cum and to S, and their outputs are not written.  C.B^T
// is computed here, per tile, not by a library product.
//
// What bounds it on an H100: operations.  At the serve shape (zamba2-7b
// prefill: B = 8, L = 2048, H = 112, P = N = 64, Q = 256) one call needs
// ~6e10 flops (C.B^T once per chunk, the causal intra product, the inter
// product and the state update) and moves ~0.5 GB.  In bf16 at the tensor
// cores' peak the bytes bound it (~0.15 ms); this first version does its
// products in float32 on the CUDA cores, recomputing C.B^T for every head,
// so it is far from either bound: tensor cores and sharing C.B^T across
// heads are later work.
//
// What the design does about it: the TPU runs the (batch, chunk) grid in
// order with a multi-MB VMEM state.  Here one block of 256 threads owns a
// (batch, head) and loops over the chunks in order, its 64 x 64 float32
// state in shared memory (16 KB).  A (Q, Q) float32 weight tile would be
// 256 KB at Q = 256, above a block's 227 KB of shared memory, so the chunk
// is cut into 64-row query and key sub-blocks: for each query sub-block the
// kernel builds a 64 x 64 weight tile G = (C.B^T) exp(cum[q] - cum[k]) dt[k]
// per key sub-block at or below the diagonal and accumulates G x into a
// 4 x 4 register micro-tile per thread.  exp is taken only where k <= q
// (above the diagonal cum[q] - cum[k] > 0 could overflow, and masking an
// inf after the product would give inf * 0 = NaN).  The chunk's cumsum is a
// block-wide parallel scan.  P and N up to 64 and Q up to 1024 are taken;
// shared memory is ~85 KB at Q = 256, so two blocks share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16: ty = row group, tx = column group
constexpr int kT = 64;          // sub-block rows; the largest P and N
constexpr int kLD = kT + 1;     // odd row stride: column walks conflict-free
constexpr int kMaxQ = 1024;     // 4 cumsum entries a thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ inline size_t smem_floats(int Q) {
  return 4 * static_cast<size_t>(kT) * kLD + static_cast<size_t>(kT) * kT +
         2 * static_cast<size_t>(Q) + 32;
}

template <typename TX, typename TBC>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const TBC* __restrict__ Bm,
                const TBC* __restrict__ Cm, const float* __restrict__ init,
                TX* __restrict__ y, float* __restrict__ final_state, int L,
                int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  float* sS = smem;                 // kT x kLD: state [p][n]
  float* sC = sS + kT * kLD;        // kT x kLD: C rows of a query sub-block
  float* sB = sC + kT * kLD;        // kT x kLD: B rows of a key sub-block
  float* sG = sB + kT * kLD;        // kT x kLD: weights [q][k]
  float* sX = sG + kT * kLD;        // kT x kT:  x rows of a key sub-block
  float* cum = sX + kT * kT;        // Q: within-chunk cumsum of dt * A
  float* dtv = cum + Q;             // Q: dt
  float* wsum = dtv + Q;            // per-warp totals of the scan

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const float a = A[h];
  const size_t PN = static_cast<size_t>(P) * N;
  const size_t x_row = static_cast<size_t>(H) * P;   // stride of a position
  const TX* xb = x + static_cast<size_t>(b) * L * x_row + static_cast<size_t>(h) * P;
  TX* yb = y + static_cast<size_t>(b) * L * x_row + static_cast<size_t>(h) * P;
  const TBC* Bb = Bm + static_cast<size_t>(b) * L * N;
  const TBC* Cb = Cm + static_cast<size_t>(b) * L * N;
  const float* dtb = dt + static_cast<size_t>(b) * L * H + h;

  // entering state of chunk 0 (padding rows and columns stay 0 throughout)
  for (int i = tid; i < kT * kLD; i += kThreads) sS[i] = 0.f;
  __syncthreads();
  if (init != nullptr) {
    const float* ib = init + (static_cast<size_t>(b) * H + h) * PN;
    for (int i = tid; i < P * N; i += kThreads) sS[(i / N) * kLD + i % N] = ib[i];
  }

  // rows [r0, r0 + kT) of a (L, width) operand into a kT x ld tile, zero
  // past the chunk's live rows and past width
  auto load_rows = [&](float* dst, int ld, const auto* src, size_t row_stride,
                       int t0, int r0, int live, int width) {
    for (int i = tid; i < kT * kT; i += kThreads) {
      const int r = i >> 6, col = i & (kT - 1);
      float val = 0.f;
      if (r0 + r < live && col < width)
        val = to_f(src[static_cast<size_t>(t0 + r0 + r) * row_stride + col]);
      dst[r * ld + col] = val;
    }
  };

  const int per = (Q + kThreads - 1) / kThreads;   // <= 4
  const int n_chunks = (L + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int Lc = min(Q, L - t0);

    // dt and the inclusive cumsum of dt * A (dt = 0 past Lc)
    __syncthreads();
    float loc[4];
    float tot = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = tid * per + e;
      float d = 0.f;
      if (e < per && t < Lc) d = dtb[static_cast<size_t>(t0 + t) * H];
      if (e < per && t < Q) dtv[t] = d;
      loc[e] = d * a;
      tot += loc[e];
    }
    float incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      float w = lane < kThreads / 32 ? wsum[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < kThreads / 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += n;
      }
      if (lane < kThreads / 32) wsum[lane] = w;
    }
    __syncthreads();
    float run = incl - tot + (warp > 0 ? wsum[warp - 1] : 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = tid * per + e;
      run += loc[e];
      if (e < per && t < Q) cum[t] = run;
    }
    __syncthreads();
    const float cum_end = cum[Q - 1];   // padded steps add exactly 0

    // outputs, one query sub-block at a time
    for (int q0 = 0; q0 < Lc; q0 += kT) {
      __syncthreads();
      load_rows(sC, kLD, Cb, N, t0, q0, Lc, N);
      __syncthreads();

      // inter: exp(cum[q]) C[q] . S[p]
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * kLD + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = sS[(tx + 16 * j) * kLD + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dec = expf(cum[min(q0 + ty + 16 * i, Q - 1)]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= dec;
      }

      // intra: key sub-blocks at or below the diagonal
      for (int k0 = 0; k0 <= q0; k0 += kT) {
        __syncthreads();
        load_rows(sB, kLD, Bb, N, t0, k0, Lc, N);
        load_rows(sX, kT, xb, x_row, t0, k0, Lc, P);
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * kLD + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * kLD + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qq = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = k0 + tx + 16 * j;
            float w = 0.f;
            if (kk <= qq && qq < Lc)   // exp only on and below the diagonal
              w = g[i][j] * expf(cum[qq] - cum[kk]) * dtv[kk];
            sG[(ty + 16 * i) * kLD + tx + 16 * j] = w;
          }
        }
        __syncthreads();
        const int kmax = min(kT, Lc - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          float gv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = sG[(ty + 16 * i) * kLD + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = sX[kk * kT + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qq = q0 + ty + 16 * i;
        if (qq >= Lc) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) from_f(yb + static_cast<size_t>(t0 + qq) * x_row + p, acc[i][j]);
        }
      }
    }

    // state update: S = exp(cum_end) S + sum_k (exp(cum_end - cum[k]) dt[k] x[k]) B[k]^T
    float ns[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ns[i][j] = 0.f;
    for (int k0 = 0; k0 < Lc; k0 += kT) {
      __syncthreads();
      load_rows(sB, kLD, Bb, N, t0, k0, Lc, N);
      load_rows(sX, kT, xb, x_row, t0, k0, Lc, P);
      if (tid < kT) {
        const int kk = k0 + tid;
        sG[tid] = kk < Lc ? expf(cum_end - cum[kk]) * dtv[kk] : 0.f;
      }
      __syncthreads();
      const int kmax = min(kT, Lc - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const float w = sG[kk];
        float xv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = w * sX[kk * kT + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[kk * kLD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ns[i][j] = fmaf(xv[i], bv[j], ns[i][j]);
      }
    }
    __syncthreads();
    const float decay = expf(cum_end);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* s = sS + (ty + 16 * i) * kLD + tx + 16 * j;
        *s = *s * decay + ns[i][j];
      }
  }
  __syncthreads();

  if (final_state != nullptr) {
    float* fb = final_state + (static_cast<size_t>(b) * H + h) * PN;
    for (int i = tid; i < P * N; i += kThreads) fb[i] = sS[(i / N) * kLD + i % N];
  }
}

template <typename TX, typename TBC>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* init, void* y, float* final_state,
           int B, int L, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t bytes = smem_floats(Q) * sizeof(float);
  auto kernel = ssd_scan_kernel<TX, TBC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const TX*>(x), dt, A, static_cast<const TBC*>(Bm),
      static_cast<const TBC*>(Cm), init, static_cast<TX*>(y), final_state, L,
      H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes.  x_dtype / bc_dtype: 0 = float32, 1 = bfloat16
// (y has x's dtype); dt, A, init and final_state are float32; init and
// final_state may be null (zero initial state; no final state written).
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 on success).  The caller guarantees contiguous buffers of the stated
// shapes; anything the kernel does not take (P or N above 64, Q above 1024,
// an empty or too large grid) is refused with cudaErrorInvalidValue.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* Bm, const void* Cm,
                               const float* init, void* y, float* final_state,
                               int x_dtype, int bc_dtype, int B, int L, int H,
                               int P, int N, int Q, void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || P > kT || N < 1 || N > kT ||
      Q < 1 || Q > kMaxQ || B > 65535 || (x_dtype != 0 && x_dtype != 1) ||
      (bc_dtype != 0 && bc_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && bc_dtype == 0)
    return launch<float, float>(x, dt, A, Bm, Cm, init, y, final_state, B, L, H, P, N, Q, s);
  if (x_dtype == 0)
    return launch<float, __nv_bfloat16>(x, dt, A, Bm, Cm, init, y, final_state, B, L, H, P, N, Q, s);
  if (bc_dtype == 0)
    return launch<__nv_bfloat16, float>(x, dt, A, Bm, Cm, init, y, final_state, B, L, H, P, N, Q, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, Bm, Cm, init, y, final_state, B, L, H, P, N, Q, s);
}
