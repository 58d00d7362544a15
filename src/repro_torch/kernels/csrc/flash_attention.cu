// GQA scaled-dot-product attention with an online softmax.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (`_attn_kernel`).
//
// Computes, for q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D), float32 or
// bfloat16, contiguous, the kv head of q head h being h / (Hq / Hkv):
//   s      = (q . k) * scale                      in float32, scale = 1/sqrt(D)
//   masked = -1e30 where (causal and kpos > qpos) or (window > 0 and
//            kpos <= qpos - window), qpos = q_offset + row
//   online softmax over kv tiles with float32 m, l and acc, as the Pallas
//   kernel: m_new = max(m, rowmax s), p = exp(s - m_new),
//   alpha = exp(m - m_new), l = alpha l + sum p, acc = alpha acc + p v
//   out    = acc / max(l, 1e-30)                   in q's dtype
// Unlike the Pallas kernel (which asserts that the block sizes divide Sq
// and Sk) it masks the ragged edge itself: a key at kpos >= Sk does not
// exist (its p is exactly 0), a query row at >= Sq is computed and not
// stored.  A query that sees no key at all gets the mean of v, as the
// Pallas kernel and the plain version (ref.attention_ref) give it: its
// masked scores all equal -1e30, so each p is exp(0) = 1.
//
// What bounds it on an H100: operations.  The serve path's shape (zamba2-7b
// prefill: B = 8, Sq = Sk = 2048, Hq = Hkv = 32, D = 112, causal) needs
// ~2.4e11 flops and moves ~0.5 GB; at the bf16 tensor-core peak that is
// ~0.24 ms against ~0.15 ms for the bytes.  This first version does its
// products in float32 on the CUDA cores (67 TFLOP/s peak), not on the
// tensor cores: right and simple first, wgmma and TMA are later work.
//
// What the design does about it: the TPU grid keeps the kv blocks
// sequential in VMEM scratch; here one block of 256 threads owns a
// (b, q head, 64-query tile) and loops over 64-key tiles inside it, with
// the 64 x D float32 accumulator in registers (a 4 x NC micro-tile per
// thread) and Q, K, V and the score tile in shared memory (odd row strides,
// so the column walks are free of bank conflicts).  Key tiles wholly
// outside the causal or window band of the whole query tile are skipped,
// which halves the causal work; a query tile holding a row that sees no key
// visits every tile so that such a row averages v as above.  D is any
// multiple of 8 up to 256 (zamba2's 112 included): NC = D / 16 rounded up
// to a power of two picks the kernel, and V's tile is zero-padded to
// 16 NC columns so the product loop needs no guard.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16: ty = row group, tx = column group
constexpr int kBQ = 64;         // queries per block
constexpr int kBK = 64;         // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Layout {
  int ldq;   // = D + 1 (odd)
  int ldv;   // = 16 * NC (zero-padded columns)
  int ldp;   // = kBK + 1
};

__host__ __device__ inline size_t smem_floats(int D, int nc) {
  return static_cast<size_t>(kBQ) * (D + 1) + static_cast<size_t>(kBK) * (D + 1) +
         static_cast<size_t>(kBK) * 16 * nc + static_cast<size_t>(kBQ) * (kBK + 1) +
         3 * kBQ;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int Hq, int Hkv, int D, int causal, int window,
                       long long q_offset, float scale) {
  extern __shared__ float smem[];
  const Layout lay{D + 1, 16 * NC, kBK + 1};
  float* sQ = smem;                          // kBQ x ldq
  float* sK = sQ + kBQ * lay.ldq;            // kBK x ldq
  float* sV = sK + kBK * lay.ldq;            // kBK x ldv
  float* sP = sV + kBK * lay.ldv;            // kBQ x ldp: scores, then p
  float* sM = sP + kBQ * lay.ldp;            // kBQ running max
  float* sL = sM + kBQ;                      // kBQ running sum
  float* sA = sL + kBQ;                      // kBQ this tile's alpha

  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;

  const size_t q_row = static_cast<size_t>(Hq) * D;    // stride of a position
  const size_t k_row = static_cast<size_t>(Hkv) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq) * q_row + static_cast<size_t>(hq) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk) * k_row + static_cast<size_t>(hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk) * k_row + static_cast<size_t>(hk) * D;

  // Q tile (rows past Sq are zero) and the softmax state
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    sQ[r * lay.ldq + d] =
        (q0 + r < Sq) ? to_f(qb[static_cast<size_t>(q0 + r) * q_row + d]) : 0.f;
  }
  for (int i = tid; i < kBK * lay.ldv; i += kThreads) sV[i] = 0.f;  // pads stay 0
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  // the kv tiles this query tile needs
  const long long qpos_lo = q_offset + q0;
  const long long qpos_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  const int n_tiles = (Sk + kBK - 1) / kBK;
  int t_begin = 0, t_end = n_tiles;
  const bool empty_row = (causal && qpos_lo < 0) ||
                         (window > 0 && qpos_hi - window + 1 > Sk - 1);
  if (!empty_row) {
    if (causal && qpos_hi / kBK + 1 < t_end)
      t_end = static_cast<int>(qpos_hi / kBK + 1);
    if (window > 0) {
      const long long first = qpos_lo - window + 1;
      if (first > 0) t_begin = static_cast<int>(first / kBK);
    }
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // previous tile's sK, sV, sP reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < Sk) {
        const size_t off = static_cast<size_t>(k0 + r) * k_row + d;
        kv = to_f(kb[off]);
        vv = to_f(vb[off]);
      }
      sK[r * lay.ldq + d] = kv;
      sV[r * lay.ldv + d] = vv;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * lay.ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * lay.ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const long long qpos = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const long long kpos = k0 + c;
        float val = s[i][j] * scale;
        if (kpos >= Sk) {
          val = -INFINITY;                     // no such key: p = 0 exactly
        } else if ((causal && kpos > qpos) ||
                   (window > 0 && kpos <= qpos - window)) {
          val = kNegInf;
        }
        sP[r * lay.ldp + c] = val;
      }
    }
    __syncthreads();

    // row statistics: warp w takes rows 8w .. 8w + 7, two keys a lane
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float a0 = sP[r * lay.ldp + lane];
      const float a1 = sP[r * lay.ldp + lane + 32];
      float mx = fmaxf(a0, a1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(a0 - m_new);
      const float p1 = expf(a1 - m_new);
      sP[r * lay.ldp + lane] = p0;
      sP[r * lay.ldp + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha acc + p v: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * lay.ldp + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = sV[kk * lay.ldv + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* ob = o + (static_cast<size_t>(b) * Sq) * q_row + static_cast<size_t>(hq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float inv_l = 1.f / fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      if (c < D)
        from_f(ob + static_cast<size_t>(q0 + r) * q_row + c, acc[i][j] * inv_l);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int Hq, int Hkv, int D, int causal, int window,
           long long q_offset, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(D, NC) * sizeof(float);
  auto kernel = flash_attention_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq, Hkv, D, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int Hq, int Hkv, int D, int causal, int window,
             long long q_offset, float scale, cudaStream_t stream) {
  const int groups = (D + 15) / 16;
  if (groups <= 1)
    return launch<T, 1>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
  if (groups <= 2)
    return launch<T, 2>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
  if (groups <= 4)
    return launch<T, 4>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
  if (groups <= 8)
    return launch<T, 8>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
  return launch<T, 16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
}

}  // namespace

// C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and o
// alike).  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).  The caller guarantees contiguous
// buffers of the stated shapes; anything the kernel does not take (D not a
// multiple of 8 or above 256, Hq not a multiple of Hkv, an empty or too
// large grid) is refused with cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype, int B,
                                      int Sq, int Sk, int Hq, int Hkv, int D,
                                      int causal, int window,
                                      long long q_offset, float scale,
                                      void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      D < 8 || D > 256 || D % 8 != 0 || window < 0 || B > 65535 ||
      Hq > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window,
                           q_offset, scale, s);
  return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal,
                                 window, q_offset, scale, s);
}
