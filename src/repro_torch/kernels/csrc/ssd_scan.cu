// Mamba2 SSD (state-space duality) chunked scan: two kernels, one for
// bfloat16 x, B and C and one for every other dtype combination, behind one
// C entry point.
//
// Both replace the TPU kernel repro/kernels/ssm_scan.py::ssd_pallas
// (`_ssd_kernel`).
//
// They compute what the plain version ref.ssd_chunked_ref computes, for
// x (B, L, H, P) and B, C (B, L, N) in float32 or bfloat16, dt (B, L, H),
// A (H,) and the states in float32, chunk Q.  Within a chunk, with
// cum = the inclusive cumsum of dt * A (<= 0):
//   y[q]    = exp(cum[q]) C[q] . S_in                                (inter)
//           + sum_{k <= q} (C[q] . B[k]) exp(cum[q] - cum[k]) dt[k] x[k]   (intra)
//   S_out   = exp(cum[end]) S_in + sum_k exp(cum[end] - cum[k]) dt[k] x[k] B[k]^T
// S is the (P, N) state of one (batch, head), carried from chunk to chunk.
// Two things the Pallas kernel does not do: they take an initial state
// (`init`, else zeros) and emit the final state themselves (the Pallas
// kernel rejects initial_state and recomputes the final state through the
// XLA oracle), and they take a ragged L as the oracle pads it, with dt = 0
// steps: the last chunk has Lc < Q live positions, its padded positions
// add exactly 0 to cum and to S, and their outputs are not written.  C.B^T
// is computed here, per tile, not by a library product.  P and N up to 64
// and Q up to 1024 are taken.  One block owns a (batch, head) and walks
// its chunks in order; the chunk is cut into 64-row query and key
// sub-blocks, and for each query sub-block the weights
// G = (C.B^T) exp(cum[q] - cum[k]) dt[k] of each key sub-block at or below
// the diagonal are built and multiplied into x.  exp is taken only where
// k <= q (above the diagonal cum[q] - cum[k] > 0 could overflow, and
// masking an inf after the product would give inf * 0 = NaN), and never
// factored into exp(cum[q]) exp(-cum[k]) (|cum| reaches hundreds on the
// serve path).
//
// What bounds them on an H100.  At the serve shape (zamba2-7b prefill:
// B = 8, L = 2048, H = 112, P = N = 64, Q = 256, final state) one call
// needs ~6e10 flops (C.B^T once per chunk, the causal intra product, the
// inter product and the state update) and moves ~0.5 GB: in bf16 at the
// tensor cores' peak the bytes bound it (~0.15 ms); in float32 outside the
// tensor cores the operations (~0.9 ms).
//
// bfloat16 x, B and C, `tc::ssd_scan_bf16_kernel`: the products on the
// tensor cores, mma.sync m16n8k16 (bf16 in, float32 accumulate), with
// FlashAttention-2's shape and the softmax replaced by the decay mask.
// Four warps own a 64-row query sub-block, 16 rows each.  Per key
// sub-block: S = C[q] B[k]^T from ldmatrix reads of the bf16 tiles; in
// registers G = S exp(cum[q] - cum[k]) dt[k], the A operand of
// O += G X[k] (X read by ldmatrix.trans); on the diagonal tile a warp
// skips the 16-key groups past its last row.  Where a row's group of 16
// steps follows the key's, the decay is taken as exp(cum[q] - cum[g])
// times fk[k] = exp(cum[g] - cum[k]) dt[k], g the key group's last step:
// both exponents are <= 0, and fk is computed once a chunk, so a thread
// takes 2 exps per 16-key group instead of 8.  Inter:
// O = exp(cum[q]) C[q] S^T, S's B operand the entering state's bf16 copy
// written to shared memory once a chunk.  The (P, N) float32 state lives
// in registers, in the accumulator layout (the warp's 16 rows of P), and
// takes its update S = exp(cum[end]) S + (w x)^T B,
// w[k] = exp(cum[end] - cum[k]) dt[k], on the last query sub-block's steps,
// which visit every key tile.  Each float32 operand, G, S and w x, goes in
// as two bf16 halves, hi = bf16(v) and lo = bf16(v - hi), multiplied
// twice (~2^-17 of it lost): one bf16 rounding (~2^-9) of w x misses the
// final state's 1e-4 gate, and of G or S triples y's error against the
// float32 plain route (PERF.md, section 6).  x, B and C are exact in bf16 and
// are not split, so the tensor cores' products are exact and only their
// float32 sums round.  cp.async 16-byte copies stage the next step's B
// and X tiles, and the next query sub-block's C tile (the next chunk's
// first included), while this step multiplies, and 4-byte copies the next
// chunk's dt during a chunk's first step; the copies' zero-fill form fills
// rows past the chunk's live length and columns past P and N, so no
// product needs a guard.  A tile whose rows are not 16-byte aligned (P or
// N not a multiple of 8, or an unaligned base pointer) is loaded with
// plain loads instead, in the same kernel.  Tiles are unpadded, their
// 16-byte chunks permuted by row (`swz`) so that each ldmatrix phase reads
// eight distinct bank groups: ~68 KB of shared memory at Q = 256 and 149
// registers a thread, so three blocks share an SM.  No atomics: each
// output has one writer, and a call is deterministic.  Not yet: wgmma,
// TMA, more warps a block (each step is one warp's chain of dependent
// products; PERF.md, section 6).

// Every other dtype combination, `ssd_scan_kernel`: the products in
// float32 on the CUDA cores (a tensor core would give TF32).  One block of
// 256 threads, its 64 x 64 float32 state in shared memory (16 KB), a
// 64 x 64 float32 weight tile per key sub-block, G x accumulated into a
// 4 x 4 register micro-tile per thread; the chunk's cumsum is a block-wide
// parallel scan.  Shared memory is ~85 KB at Q = 256, so two blocks share
// an SM.

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


// ------------------------------------------------------------------ //
// bfloat16 on the tensor cores
// ------------------------------------------------------------------ //
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
static_assert(16 * kWarps == kT, "16 rows a warp");   // kT: file-level
constexpr int kTile = kT * kT;       // bf16 elements of one 64 x 64 tile

// Tiles are stored unpadded, each row's eight 16-byte chunks permuted:
// chunk c of row r sits at chunk c ^ (r % 8), so the eight rows an
// ldmatrix phase reads fall on eight distinct bank groups.  The element
// offset of (row r, column c):
__device__ __forceinline__ int swz(int r, int c) {
  return r * kT + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// Q rounded up to a multiple of kThreads: the chunk's per-step entries
__host__ __device__ inline int padded_chunk(int Q) {
  return (Q + kThreads - 1) / kThreads * kThreads;
}

// C, B and X double-buffered, and the entering state as hi and lo halves
// (bf16 [p][n]); then cum, dt, the decay factor fk and the next chunk's dt
// (float, padded_chunk(Q) each)
__host__ __device__ inline size_t smem_bytes(int Q) {
  const int qp = padded_chunk(Q);
  return sizeof(__nv_bfloat16) * 8 * static_cast<size_t>(kTile) +
         sizeof(float) * (4 * static_cast<size_t>(qp) + kWarps);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; 16 zero bytes (and nothing read) unless valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared; 4 zero bytes (and nothing read) unless valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16,
// column-major): a[0..3] hold (row g, cols 2t..2t+1), (g + 8, 2t..),
// (g, 2t + 8..), (g + 8, 2t + 8..); b0, b1 (rows 2t.., col g), (2t + 8.., g);
// c[0..3] (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), where
// g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// v = (lo, hi) as the sum of two bf16 pairs: big = bf16(v), small =
// bf16(v - big), each packed as pack_bf16 packs
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& big,
                                           uint32_t& small) {
  __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  const float2 f = __bfloat1622float2(b);
  big = *reinterpret_cast<uint32_t*>(&b);
  small = pack_bf16(lo - f.x, hi - f.y);
}

// Rows [0, kT) of an operand, row r at src + r * stride, into a swizzled
// tile: rows >= live and columns >= width become zero.  vec: 16-byte
// cp.async copies (zero-filled past the edge), for rows whose width is a
// multiple of 8 and that start 16-byte aligned; else plain loads.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int live, int width,
                                          bool vec) {
  if (vec) {
#pragma unroll
    for (int it = 0; it < kT * 8 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i >> 3, c = i & 7;
      const bool ok = r < live && 8 * c < width;
      cp_async16(dst + swz(r, 8 * c), ok ? src + r * stride + 8 * c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
      const int r = i >> 6, c = i & (kT - 1);
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (r < live && c < width) v = src[r * stride + c];
      dst[swz(r, c)] = v;
    }
  }
}

// One block takes one (head, batch row) and walks its chunks in order.
__global__ void __launch_bounds__(kThreads, 3)   // blocks an SM
ssd_scan_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ dt, const float* __restrict__ A,
                     const __nv_bfloat16* __restrict__ Bm,
                     const __nv_bfloat16* __restrict__ Cm,
                     const float* __restrict__ init,
                     __nv_bfloat16* __restrict__ y,
                     float* __restrict__ final_state, int L, int H, int P,
                     int N, int Q, int x_vec, int bc_vec) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // 2 tiles
  __nv_bfloat16* sB = sC + 2 * kTile;                              // 2 tiles
  __nv_bfloat16* sX = sB + 2 * kTile;    // 2 tiles
  __nv_bfloat16* sSh = sX + 2 * kTile;   // entering state, bf16(S)
  __nv_bfloat16* sSl = sSh + kTile;      // bf16(S - bf16(S))
  const int qp = padded_chunk(Q);
  float* cum = reinterpret_cast<float*>(sSl + kTile);   // qp
  float* dtv = cum + qp;       // qp: dt, 0 past the chunk's end
  float* fk = dtv + qp;        // qp: exp(cum[g] - cum[k]) dt[k]
  float* dnext = fk + qp;      // qp: the next chunk's dt
  float* wsum = dnext + qp;    // kWarps

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;   // fragment row group, column pair
  const int row0 = warp * 16 + g;           // tile row of c[0..1]; c[2..3] + 8
  const size_t PN = static_cast<size_t>(P) * N;
  const size_t x_row = static_cast<size_t>(H) * P;   // stride of a position
  const __nv_bfloat16* Bb = Bm + static_cast<size_t>(b) * L * N;
  const __nv_bfloat16* Cb = Cm + static_cast<size_t>(b) * L * N;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * L * x_row +
                           static_cast<size_t>(h) * P;

  // ldmatrix row addresses (FlashAttention-2's, flash_attention.cu), as a
  // row and a 16-byte chunk of it, the chunk swizzled by the row's % 8,
  // which is lane % 8 in each: a_frag reads a row-major A (the warp's 16
  // rows, 16 columns); b_frag a B stored [n][k] (two 8-wide n-tiles x 16
  // k), or, transposed, an A stored [k][m] (16 m x 16 k); bt_frag,
  // transposed, a B stored [k][n] (16 k x two 8-wide n-tiles).  The chunk
  // of the 16-column group kk is c + 2 kk.
  const int l7 = lane & 7;
  const int a_row = warp * 16 + (lane & 15), a_c = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_c = (lane >> 3) & 1;
  const int bt_row = (lane & 7) + (((lane >> 3) & 1) << 3), bt_c = lane >> 4;
  auto at = [&](int row, int chunk) { return row * kT + (((chunk ^ l7) & 7) << 3); };

  // The (P, N) state in float32, in the accumulator layout: this warp's
  // rows p = 16 warp + g (+ 8), columns n = 8 j + 2 tg (+ 1); zero past P
  // and N
  float st[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = row0 + 8 * (e >> 1), n = 8 * j + 2 * tg + (e & 1);
      st[j][e] = init != nullptr && p < P && n < N
                     ? init[(static_cast<size_t>(b) * H + h) * PN +
                            static_cast<size_t>(p) * N + n]
                     : 0.f;
    }

  // the entering state's two bf16 halves, the B operand of the inter term
  auto store_state = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t big, small;
        split_bf16(st[j][2 * hh], st[j][2 * hh + 1], big, small);
        const int o = swz(row0 + 8 * hh, 8 * j + 2 * tg);
        *reinterpret_cast<uint32_t*>(sSh + o) = big;
        *reinterpret_cast<uint32_t*>(sSl + o) = small;
      }
  };

  // dt over the chunk at t0 with Lc live steps into dnext (0 past Lc, up to
  // qp): by plain loads for the first chunk, by cp.async in the caller's
  // commit group for the next (a single path for both took ~40 more
  // registers a thread and a block slot an SM; PERF.md, section 6)
  const int per = qp / kThreads;   // 1 to 8
  auto fetch_dt = [&](int t0, int Lc, bool async) {
    const float* dtb = dt + (static_cast<size_t>(b) * L + t0) * H + h;
    for (int e = 0; e < per; ++e) {
      const int t = tid * per + e;
      const bool ok = t < Lc;
      if (async)
        cp_async4(dnext + t, ok ? dtb + static_cast<size_t>(t) * H : dtb, ok);
      else
        dnext[t] = ok ? dtb[static_cast<size_t>(t) * H] : 0.f;
    }
  };

  // from dnext: dt, the inclusive cumsum of dt * A, and the decay factors
  // fk[k] = exp(cum[g] - cum[k]) dt[k] <= dt[k], g the last step of k's
  // group of 16; then S *= exp(cum at the chunk's end), the decay the
  // chunk's update adds to.  cum[qp - 1] is that end (padded steps add
  // exactly 0).
  auto chunk_scan = [&]() {
    const float a = A[h];
    float loc[8];
    float tot = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int t = tid * per + e;
      float d = 0.f;
      if (e < per) {
        d = dnext[t];
        dtv[t] = d;
      }
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
    float run = incl - tot;
    for (int w = 0; w < warp; ++w) run += wsum[w];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      run += loc[e];
      if (e < per) cum[tid * per + e] = run;
    }
    __syncthreads();
    for (int t = tid; t < qp; t += kThreads)
      fk[t] = __expf(cum[t | 15] - cum[t]) * dtv[t];
    const float decay = expf(cum[qp - 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] *= decay;
  };

  auto load_step = [&](int buf, int cbuf, int t0, int Lc, int qi, int ki) {
    const int k0 = ki * kT;
    load_tile(sB + buf * kTile, Bb + static_cast<size_t>(t0 + k0) * N, N,
              Lc - k0, N, bc_vec);
    load_tile(sX + buf * kTile, xb + static_cast<size_t>(t0 + k0) * x_row,
              x_row, Lc - k0, P, x_vec);
    if (ki == 0) {
      const int q0 = qi * kT;
      load_tile(sC + cbuf * kTile, Cb + static_cast<size_t>(t0 + q0) * N, N,
                Lc - q0, N, bc_vec);
    }
  };

  // One step: a (chunk, query sub-block qi, key sub-block ki <= qi).  The
  // next step's tiles are in flight while this one computes; the first
  // step of a chunk also fetches the next chunk's dt.
  int t0 = 0, Lc = min(Q, L), qi = 0, ki = 0, buf = 0, cbuf = 0;
  store_state();
  fetch_dt(0, Lc, false);
  __syncthreads();
  chunk_scan();
  load_step(0, 0, 0, Lc, 0, 0);
  cp_async_commit();

  float acc[8][4] = {};   // this query sub-block's 16 rows of y
  for (;;) {
    const int nq = (Lc + kT - 1) / kT;
    int nt0 = t0, nLc = Lc, nqi = qi, nki = ki + 1;
    if (nki > qi) {
      nki = 0;
      if (++nqi == nq) {
        nqi = 0;
        nt0 = t0 + Q;
        nLc = min(Q, L - nt0);
      }
    }
    const bool has_next = nt0 < L;
    if (has_next) {
      load_step(buf ^ 1, nki == 0 ? cbuf ^ 1 : cbuf, nt0, nLc, nqi, nki);
      if (qi == 0 && ki == 0 && t0 + Q < L)
        fetch_dt(t0 + Q, min(Q, L - t0 - Q), true);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tC = sC + cbuf * kTile;
    const __nv_bfloat16* tB = sB + buf * kTile;
    const int q0 = qi * kT, k0 = ki * kT;

    if (ki == 0) {   // inter: exp(cum[q]) C[q] . S, S as its two halves
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        if (16 * kk >= N) break;
        uint32_t fa[4];
        ldsm_x4(fa, tC + at(a_row, a_c + 2 * kk));
#pragma unroll
        for (int jp = 0; jp < kT / 16; ++jp) {
          if (16 * jp >= P) break;
          const int o = at(jp * 16 + b_row, b_c + 2 * kk);
          uint32_t fb[4];
          ldsm_x4(fb, sSh + o);
          mma_bf16(acc[2 * jp], fa, fb[0], fb[1]);
          mma_bf16(acc[2 * jp + 1], fa, fb[2], fb[3]);
          ldsm_x4(fb, sSl + o);
          mma_bf16(acc[2 * jp], fa, fb[0], fb[1]);
          mma_bf16(acc[2 * jp + 1], fa, fb[2], fb[3]);
        }
      }
      const float e0 = expf(cum[q0 + row0]);
      const float e1 = expf(cum[q0 + row0 + 8]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }
    }

    // intra: S = C[q] . B[k] on the warp's 16 rows x 64 keys; on the
    // diagonal tile the keys past the warp's last row are all masked, and
    // their 16-key groups are skipped
    const bool diag = ki == qi;
    const int kg_max = diag ? warp : kT / 16 - 1;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      if (16 * kk >= N) break;
      uint32_t fa[4];
      ldsm_x4(fa, tC + at(a_row, a_c + 2 * kk));
#pragma unroll
      for (int jp = 0; jp < kT / 16; ++jp) {
        if (jp > kg_max) break;
        uint32_t fb[4];
        ldsm_x4(fb, tB + at(jp * 16 + b_row, b_c + 2 * kk));
        mma_bf16(s[2 * jp], fa, fb[0], fb[1]);
        mma_bf16(s[2 * jp + 1], fa, fb[2], fb[3]);
      }
    }
    // O += G X[k], G = S exp(cum[q] - cum[k]) dt[k] where
    // k <= q and 0 above the diagonal.  Where the row's group of 16 follows
    // the key's, G = S exp(cum[q] - cum[g]) fk[k], g the key group's last
    // step: both exponents are <= 0.  In the 16 x 16 blocks on the diagonal
    // it is taken directly, exp only where k <= q (above it the exponent is
    // positive and could overflow), and it is never factored into
    // exp(cum[q]) exp(-cum[k]).  Two 8-key n-tiles of G make a bf16 A
    // fragment, twice: G's hi and lo halves.
    const float cq[2] = {cum[q0 + row0], cum[q0 + row0 + 8]};
    const __nv_bfloat16* tX = sX + buf * kTile;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      if (kk > kg_max) break;
      float gv[2][4];
      if (diag && kk == warp) {   // the row's own group of 16 keys
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = 16 * kk + 8 * jj + 2 * tg + (e & 1);
            const int ql = row0 + 8 * (e >> 1);
            float v = 0.f;
            if (kl <= ql)
              v = s[2 * kk + jj][e] * __expf(cq[e >> 1] - cum[k0 + kl]) * dtv[k0 + kl];
            gv[jj][e] = v;
          }
      } else {
        const float cg = cum[k0 + 16 * kk + 15];
        const float r[2] = {__expf(cq[0] - cg), __expf(cq[1] - cg)};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = 16 * kk + 8 * jj + 2 * tg + (e & 1);
            gv[jj][e] = s[2 * kk + jj][e] * r[e >> 1] * fk[k0 + kl];
          }
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(gv[r >> 1][2 * (r & 1)], gv[r >> 1][2 * (r & 1) + 1],
                   hi[r], lo[r]);
#pragma unroll
      for (int dp = 0; dp < kT / 16; ++dp) {
        if (16 * dp >= P) break;
        uint32_t fb[4];
        ldsm_x4_trans(fb, tX + at(kk * 16 + bt_row, bt_c + 2 * dp));
        mma_bf16(acc[2 * dp], hi, fb[0], fb[1]);
        mma_bf16(acc[2 * dp + 1], hi, fb[2], fb[3]);
        mma_bf16(acc[2 * dp], lo, fb[0], fb[1]);
        mma_bf16(acc[2 * dp + 1], lo, fb[2], fb[3]);
      }
    }

    // state update, on the last query sub-block's steps (they visit every
    // key sub-block): S += sum_k (w[k] x[k]) B[k]^T on the warp's 16 rows
    // of P, w[k] = exp(cum_end - cum[k]) dt[k] = exp(cum_end - cum[g]) fk[k]
    // (g the last step of k's group of 16).  w x is split into two bf16
    // halves, so that only ~2^-17 of it is lost
    if (qi == nq - 1) {
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        if (k0 + 16 * kk >= Lc) break;
        const int kb = k0 + 16 * kk + 2 * tg;
        uint32_t fx[4];
        ldsm_x4_trans(fx, tX + at(kk * 16 + b_row, b_c + 2 * warp));
        const float wg = expf(cum[qp - 1] - cum[k0 + 16 * kk + 15]);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {   // fx[r]: keys kb (+ 8 for r >= 2)
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&fx[r]));
          const int k = kb + 8 * (r >> 1);
          split_bf16(f.x * (wg * fk[k]), f.y * (wg * fk[k + 1]), hi[r], lo[r]);
        }
#pragma unroll
        for (int jn = 0; jn < kT / 16; ++jn) {
          if (16 * jn >= N) break;
          uint32_t fb[4];
          ldsm_x4_trans(fb, tB + at(kk * 16 + bt_row, bt_c + 2 * jn));
          mma_bf16(st[2 * jn], hi, fb[0], fb[1]);
          mma_bf16(st[2 * jn + 1], hi, fb[2], fb[3]);
          mma_bf16(st[2 * jn], lo, fb[0], fb[1]);
          mma_bf16(st[2 * jn + 1], lo, fb[2], fb[3]);
        }
      }
    }

    if (diag) {   // the query sub-block is done: its rows of y
      __nv_bfloat16* yb = y + static_cast<size_t>(b) * L * x_row +
                          static_cast<size_t>(h) * P;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ql = q0 + row0 + 8 * hh;
        if (ql >= Lc) continue;
        __nv_bfloat16* yr = yb + static_cast<size_t>(t0 + ql) * x_row;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int p = 8 * n + 2 * tg;
          const float v0 = acc[n][2 * hh], v1 = acc[n][2 * hh + 1];
          if (P % 2 == 0) {   // p, p + 1 both in or both out, 4-byte aligned
            if (p < P)
              *reinterpret_cast<__nv_bfloat162*>(yr + p) =
                  __floats2bfloat162_rn(v0, v1);
          } else {
            if (p < P) yr[p] = __float2bfloat16(v0);
            if (p + 1 < P) yr[p + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
    __syncthreads();   // the next step refills this step's buffers

    if (!has_next) break;
    if (nt0 != t0) {   // a new chunk: its entering state, dt and cum
      if (nq == 1) {   // one step: its prefetch of dt is still in flight
        cp_async_wait<0>();
        __syncthreads();
      }
      store_state();
      chunk_scan();
    }
    if (nki == 0) cbuf ^= 1;
    buf ^= 1;
    t0 = nt0;
    Lc = nLc;
    qi = nqi;
    ki = nki;
  }

  if (final_state != nullptr) {
    float* fb = final_state + (static_cast<size_t>(b) * H + h) * PN;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = row0 + 8 * (e >> 1), n = 8 * j + 2 * tg + (e & 1);
        if (p < P && n < N) fb[static_cast<size_t>(p) * N + n] = st[j][e];
      }
  }
}

int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* init, void* y, float* final_state,
           int B, int L, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t bytes = smem_bytes(Q);
  auto kernel = ssd_scan_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int x_vec = P % 8 == 0 && aligned(x);
  const int bc_vec = N % 8 == 0 && aligned(Bm) && aligned(Cm);
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A,
      static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), init,
      static_cast<__nv_bfloat16*>(y), final_state, L, H, P, N, Q, x_vec,
      bc_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// C interface for ctypes.  x_dtype / bc_dtype: 0 = float32, 1 = bfloat16
// (y has x's dtype); both bfloat16 pick the tensor-core kernel, every
// other combination the float32 CUDA-core kernel; dt, A, init and final_state are float32; init and
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
  return tc::launch(x, dt, A, Bm, Cm, init, y, final_state, B, L, H, P, N, Q, s);
}
