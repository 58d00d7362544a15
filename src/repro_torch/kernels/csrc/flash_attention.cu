// GQA scaled-dot-product attention with an online softmax: two kernels, one
// for each dtype, behind one C entry point.
//
// Both replace the TPU kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (`_attn_kernel`).
//
// They compute, for q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D), float32 or
// bfloat16, contiguous, the kv head of q head h being h / (Hq / Hkv):
//   s      = (q . k) * scale                      in float32, scale = 1/sqrt(D)
//   masked = -1e30 where (causal and kpos > qpos) or (window > 0 and
//            kpos <= qpos - window), qpos = q_offset + row
//   online softmax over kv tiles with float32 m, l and acc, as the Pallas
//   kernel: m_new = max(m, rowmax s), p = exp(s - m_new),
//   alpha = exp(m - m_new), l = alpha l + sum p, acc = alpha acc + p v
//   out    = acc / max(l, 1e-30)                   in q's dtype
// Unlike the Pallas kernel (which asserts that the block sizes divide Sq
// and Sk) they mask the ragged edge themselves: a key at kpos >= Sk does
// not exist (its p is exactly 0), a query row at >= Sq is computed and not
// stored.  A query that sees no key at all gets the mean of v, as the
// Pallas kernel and the plain version (ref.attention_ref) give it: its
// masked scores all equal -1e30, so each p is exp(0) = 1.  D is any
// multiple of 8 up to 256.  Both kernels give a block one (b, q head,
// 64-query tile) and loop over 64-key tiles inside it; key tiles wholly
// outside the causal or window band of the whole query tile are skipped,
// which halves the causal work, and a query tile holding a row that sees no
// key visits every tile so that such a row averages v as above.
//
// What bounds them on an H100: operations.  The serve path's shape
// (zamba2-7b prefill: B = 8, Sq = Sk = 2048, Hq = Hkv = 32, D = 112,
// causal) needs ~2.4e11 flops and moves ~0.5 GB: at the bf16 tensor-core
// peak (989 TFLOP/s) that is ~0.24 ms against ~0.15 ms for the bytes, and
// in float32 outside the tensor cores (67 TFLOP/s) ~3.6 ms.
//
// bfloat16, `flash_attention_bf16_kernel`: the products on the tensor
// cores, FlashAttention-2's shape.  Four warps own the 64 query rows, 16
// each.  K and V tiles are double-buffered in shared memory and filled with
// cp.async, 16 bytes a thread, the next tile's copy in flight while this
// one computes; rows past Sk and columns past D are zero-filled by the
// copy itself.  S = Q K^T and O += P V are mma.sync m16n8k16 (bf16 in,
// float32 accumulate), their operands read with ldmatrix (V's transposed;
// Q's too, each tile: kept in registers they were no faster on an H100 and
// cost 30-60 more registers a thread).  S never leaves registers:
// a thread holds a quarter of two rows, the row max is reduced over the 4
// threads of a quad, and the exponentials are exp2f with scale * log2(e)
// folded into the scores (the masked value stays -1e30 in those units, so
// a row that sees no key still averages v).  l is summed from the float32
// p; P is rounded to bf16 only as the A operand of P V, in registers (the
// plain version's probs.to(v.dtype)); O stays float32.  The masks are
// applied only on tiles that cross the diagonal, the window's edge or Sk.
// D is padded with zero columns to 16 KD, KD in {1, 2, 4, 7, 8, 12, 16} (7
// for zamba2's 112, 12 for MLA's 192: padded to 256 a third of every
// product ran on zero columns); shared rows are 16 KD + 8 elements long, an
// odd number of 16-byte units, so each ldmatrix phase reads eight distinct
// bank groups.
// The grid walks q tiles from the last, so that the longest causal rows
// start first.  Not yet: wgmma, TMA and mbarriers, warp specialisation, a
// persistent grid, and sharing K and V among the q heads of a group.
//
// float32, `flash_attention_kernel`: the products in float32 on the CUDA
// cores (a tensor core would compute TF32, about three digits).  One block
// of 256 threads holds the 64 x D float32 accumulator in registers (a
// 4 x NC micro-tile per thread) and Q, K, V and the score tile in shared
// memory (odd row strides, so the column walks are free of bank
// conflicts).  NC = D / 16 rounded up to a power of two picks the kernel,
// and V's tile is zero-padded to 16 NC columns so the product loop needs
// no guard.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16: ty = row group, tx = column group
constexpr int kBQ = 64;         // queries per block
constexpr int kBK = 64;         // keys per tile
constexpr float kNegInf = -1e30f;

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

template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int Sq,
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
  const float* qb = q + (static_cast<size_t>(b) * Sq) * q_row + static_cast<size_t>(hq) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk) * k_row + static_cast<size_t>(hk) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk) * k_row + static_cast<size_t>(hk) * D;

  // Q tile (rows past Sq are zero) and the softmax state
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    sQ[r * lay.ldq + d] =
        (q0 + r < Sq) ? qb[static_cast<size_t>(q0 + r) * q_row + d] : 0.f;
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
        kv = kb[off];
        vv = vb[off];
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

  float* ob = o + (static_cast<size_t>(b) * Sq) * q_row + static_cast<size_t>(hq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float inv_l = 1.f / fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      if (c < D)
        ob[static_cast<size_t>(q0 + r) * q_row + c] = acc[i][j] * inv_l;
    }
  }
}

template <int NC>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int Hq, int Hkv, int D, int causal, int window,
           long long q_offset, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(D, NC) * sizeof(float);
  auto kernel = flash_attention_kernel<NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, Hq, Hkv, D, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ //
// bfloat16 on the tensor cores
// ------------------------------------------------------------------ //
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
static_assert(16 * kWarps == kBQ, "16 query rows a warp");   // kBQ, kBK: file-level
constexpr float kLog2e = 1.4426950408889634f;

template <int KD>   // KD groups of 16 columns: D padded to 16 KD
struct Tile {
  static constexpr int kLd = 16 * KD + 8;   // shared row stride, elements
  static constexpr size_t kSmemBytes =      // Q, then 2 x K and 2 x V
      sizeof(__nv_bfloat16) * static_cast<size_t>(kBQ + 4 * kBK) * kLd;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; 16 zero bytes (and nothing read) unless valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
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

// Copy a 64-row tile whose row r starts at src + r * stride into dst
// (row stride Tile<KD>::kLd): rows >= n_rows and columns >= D become zero.
template <int KD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int n_rows, int D) {
  constexpr int kChunks = 2 * KD;   // 16-byte chunks of a padded row
  static_assert(kBQ == kBK && kBK * kChunks % kThreads == 0, "tile split");
#pragma unroll
  for (int it = 0; it < kBK * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r < n_rows && 8 * c < D;
    cp_async16(dst + r * Tile<KD>::kLd + 8 * c,
               ok ? src + r * stride + 8 * c : src, ok);
  }
}

template <int KD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                            int Hq, int Hkv, int D, int causal, int window,
                            long long q_offset, float scale_log2) {
  constexpr int LD = Tile<KD>::kLd;
  constexpr int ND = 2 * KD;   // 8-column n-tiles of O
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // kBQ x LD
  __nv_bfloat16* sK = sQ + kBQ * LD;                               // 2 x kBK x LD
  __nv_bfloat16* sV = sK + 2 * kBK * LD;                           // 2 x kBK x LD

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest rows first
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;   // fragment row group, column pair
  const int row0 = warp * 16 + g;           // block row of c[0..1]; c[2..3] + 8

  const size_t q_row = static_cast<size_t>(Hq) * D;    // stride of a position
  const size_t k_row = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* qb =
      q + (static_cast<size_t>(b) * Sq + q0) * q_row + static_cast<size_t>(hq) * D;
  const __nv_bfloat16* kb =
      k + (static_cast<size_t>(b) * Sk) * k_row + static_cast<size_t>(hk) * D;
  const __nv_bfloat16* vb =
      v + (static_cast<size_t>(b) * Sk) * k_row + static_cast<size_t>(hk) * D;

  // the kv tiles this query tile needs: the float32 kernel's rule, written
  // out again.  Shared as one __device__ helper it left the D = 128
  // instance 40 registers short and slower on an H100 (PERF.md, section 6);
  // test_flash_attention_bf16_kernel_matches_f32_kernel_on_card holds the
  // two kernels to each other on the ragged, window and no-key cases.
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

  load_tile<KD>(sQ, qb, q_row, Sq - q0, D);
  {
    const size_t k0 = static_cast<size_t>(t_begin) * kBK;
    load_tile<KD>(sK, kb + k0 * k_row, k_row, Sk - t_begin * kBK, D);
    load_tile<KD>(sV, vb + k0 * k_row, k_row, Sk - t_begin * kBK, D);
  }
  cp_async_commit();

  // ldmatrix row addresses: Q as A (16 rows x 16 cols), K as B of S = Q K^T
  // (two 8-key n-tiles x 16 cols), V transposed as B of O += P V (16 keys x
  // two 8-column n-tiles)
  const __nv_bfloat16* q_frag = sQ + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int k_frag = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int v_frag = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;

  float acc[ND][4] = {};
  float m_run[2] = {kNegInf, kNegInf};   // rows row0 and row0 + 8
  float l_run[2] = {0.f, 0.f};           // this thread's share of l

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {   // the next tile's copy overlaps this one's work
      const size_t k1 = static_cast<size_t>(t + 1) * kBK;
      load_tile<KD>(sK + (buf ^ 1) * kBK * LD, kb + k1 * k_row, k_row,
                    Sk - (t + 1) * kBK, D);
      load_tile<KD>(sV + (buf ^ 1) * kBK * LD, vb + k1 * k_row, k_row,
                    Sk - (t + 1) * kBK, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + buf * kBK * LD;
    const __nv_bfloat16* tV = sV + buf * kBK * LD;

    // S = Q K^T: the warp's 16 rows x 64 keys, eight n-tiles of 8 keys
    float s[kBK / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_frag + kk * 16);
#pragma unroll
      for (int jp = 0; jp < kBK / 16; ++jp) {
        uint32_t bk[4];
        ldsm_x4(bk, tK + jp * 16 * LD + k_frag + kk * 16);
        mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // to log2 units, then the masks where the tile crosses an edge
    const int k0 = t * kBK;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    const bool edge = empty_row || k0 + kBK > Sk ||
                      (causal && k0 + kBK - 1 > qpos_lo) ||
                      (window > 0 && k0 <= qpos_hi - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long qpos = qpos_lo + row0 + (e >> 1) * 8;
          const int kpos = k0 + 8 * j + 2 * tg + (e & 1);
          if (kpos >= Sk) {
            s[j][e] = -INFINITY;                 // no such key: p = 0 exactly
          } else if ((causal && kpos > qpos) ||
                     (window > 0 && kpos <= qpos - window)) {
            s[j][e] = kNegInf;
          }
        }
    }

    // online softmax: row h of the thread's two is spread over its quad
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m_run[h];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[h] = exp2f(m_run[h] - mx);
      m_run[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[j][2 * h] = exp2f(s[j][2 * h] - mx);
        s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - mx);
        sum += s[j][2 * h] + s[j][2 * h + 1];
      }
      l_run[h] = alpha[h] * l_run[h] + sum;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: two 8-key n-tiles of p make one bf16 A fragment
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, tV + kk * 16 * LD + v_frag + dp * 16);
        mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();   // the next iteration refills the other buffer
  }

  __nv_bfloat16* ob =
      o + (static_cast<size_t>(b) * Sq + q0) * q_row + static_cast<size_t>(hq) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    const int r = row0 + 8 * h;
    if (q0 + r >= Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 8 * n + 2 * tg;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(r) * q_row + c) =
            __floats2bfloat162_rn(acc[n][2 * h] * inv_l, acc[n][2 * h + 1] * inv_l);
    }
  }
}

int last_kd = 0;   // the instance of the last bf16 launch that was taken

template <int KD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int Hq, int Hkv, int D, int causal, int window,
           long long q_offset, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Tile<KD>::kSmemBytes;
  auto kernel = flash_attention_bf16_kernel<KD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq,
      Sk, Hq, Hkv, D, causal, window, q_offset, scale * kLog2e);
  err = cudaGetLastError();
  if (err == cudaSuccess) last_kd = KD;
  return static_cast<int>(err);
}

}  // namespace tc

// float32: the CUDA-core kernel, NC = D / 16 rounded up to a power of two
int dispatch_f32(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                 int window, long long q_offset, float scale,
                 cudaStream_t stream) {
  const int groups = (D + 15) / 16;
  if (groups <= 1)
    return launch<1>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
  if (groups <= 2)
    return launch<2>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
  if (groups <= 4)
    return launch<4>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
  if (groups <= 8)
    return launch<8>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
  return launch<16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
}

// bfloat16: the tensor-core kernel, KD = D / 16 rounded up (to a power of
// two but for 7, zamba2's head_dim 112, and 12, MLA's q-k width 192 = 128 +
// 64 RoPE: both run unpadded)
int bf16_instance(int D) {
  const int groups = (D + 15) / 16;
  if (groups == 7 || groups == 12) return groups;
  int kd = 1;
  while (kd < groups) kd *= 2;
  return kd;
}

int launch_bf16(int kd, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                int window, long long q_offset, float scale,
                cudaStream_t stream) {
  switch (kd) {
    case 1: return tc::launch<1>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
    case 2: return tc::launch<2>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
    case 4: return tc::launch<4>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
    case 7: return tc::launch<7>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
    case 8: return tc::launch<8>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
    case 12: return tc::launch<12>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
    case 16: return tc::launch<16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// what every entry point refuses (see flash_attention_launch)
bool bad_args(const void* q, const void* k, const void* v, int dtype, int B,
              int Sq, int Sk, int Hq, int Hkv, int D, int window) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      D < 8 || D > 256 || D % 8 != 0 || window < 0 || B > 65535 ||
      Hq > 65535 || (dtype != 0 && dtype != 1))
    return true;
  return dtype == 1 && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v)) % 16 != 0;
}

}  // namespace

// C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and o
// alike).  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).  The caller guarantees contiguous
// buffers of the stated shapes; anything the kernels do not take (D not a
// multiple of 8 or above 256, Hq not a multiple of Hkv, an empty or too
// large grid, bfloat16 q, k or v not 16-byte aligned) is refused with
// cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype, int B,
                                      int Sq, int Sk, int Hq, int Hkv, int D,
                                      int causal, int window,
                                      long long q_offset, float scale,
                                      void* stream) {
  if (bad_args(q, k, v, dtype, B, Sq, Sk, Hq, Hkv, D, window))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window,
                        q_offset, scale, s);
  return launch_bf16(bf16_instance(D), q, k, v, o, B, Sq, Sk, Hq, Hkv, D,
                     causal, window, q_offset, scale, s);
}

// The bfloat16 kernel at instance `kd` (16 kd >= D) whatever D would pick:
// to hold an instance to a wider one on the same inputs.
extern "C" int flash_attention_launch_bf16_instance(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, int causal, int window,
    long long q_offset, float scale, int kd, void* stream) {
  if (bad_args(q, k, v, 1, B, Sq, Sk, Hq, Hkv, D, window) || 16 * kd < D)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16(kd, q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window,
                     q_offset, scale, static_cast<cudaStream_t>(stream));
}

// The instance of the last bfloat16 launch that was taken (0 before any).
extern "C" int flash_attention_last_instance(void) { return tc::last_kd; }
