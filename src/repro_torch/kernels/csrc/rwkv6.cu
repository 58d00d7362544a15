// RWKV6 ("Finch") WKV chunked scan with a data-dependent decay.
//
// Replaces the TPU kernel repro/kernels/rwkv6.py::rwkv6_pallas
// (`_rwkv_kernel`).
//
// Computes what the plain version ref.rwkv6_chunked_ref computes, for
// r, k (B, L, H, K) and v (B, L, H, V) in float32 or bfloat16, w (B, L, H, K)
// float32 (<= 0), u (H, K) and the states (B, H, K, V) in float32, chunk Q.
// Within a chunk, with wcum the inclusive cumsum of w down the chunk and
// wprev = wcum - w (= wcum one step earlier):
//   y[t]  = sum_{s<t} (sum_k r[t,k] k[s,k] exp(wprev[t,k] - wcum[s,k])) v[s]
//         + (sum_k r[t,k] u[k] k[t,k]) v[t]                        (bonus)
//         + sum_k r[t,k] exp(wprev[t,k]) S[k,:]                    (inter)
//   S_out = diag(exp(total)) S + sum_s (k[s] exp(total - wcum[s])) v[s]^T,
//           total = wcum at the chunk's end.
// S is the (K, V) state of one (batch, head), carried from chunk to chunk.
// Three things the Pallas kernel does not do: it takes an initial state
// (`init`, else zeros) and emits the final state itself (the Pallas kernel
// asserts initial_state is None and recomputes the final state through the
// XLA oracle), it takes a ragged L as the oracle pads it (w = 0, r = k = 0:
// the last chunk's Lc < Q live rows are the only ones read, written or
// summed, and total is wcum at row Lc - 1), and so it serves decode, whose
// every step is L = 1 at chunk 1 from the carried state.
//
// The split and the direct decay.  The oracle forms the weight of a pair
// (t, s < t) split across the operands, (r exp(wprev[t])) (k exp(-wcum[s])),
// one (Q, Q) product of two operands with 2 Q K exps.  exp(-wcum) grows as
// e^|total|, which float32 holds (e^88.7) only while |total| does.  So each
// chunk takes the split form when its largest |total| over K is at most 64
// (kSplitCut; a block-uniform test, made by the barrier that ends the
// cumsum): always at the model's |w| <= 4 and Q = 16.  Any other chunk
// takes the pair's decay directly, exp(wprev[t] - wcum[s]) with an exponent
// <= 0, which cannot overflow at any chunk and costs one exp for each
// (t, s, k).  The chunk stays the caller's: it sets the order of the sums.
//
// What bounds it on an H100: operations, narrowly, for the arithmetic.  At
// the serve shape (rwkv6-1.6b prefill: B = 8, L = 2048, H = 32, K = V = 64,
// Q = 16, bf16) one call needs ~1.1e10 float32 operations (the inter
// product and the state update, Q K V each a chunk, dominate) and moves
// ~0.40 GB (r, k, v, y in bf16, w in float32): ~0.16 ms at the CUDA cores'
// 67 TFLOP/s against ~0.12 ms at 3.35 TB/s.  A decode step (L = 1) reads
// and writes the 16 KB state of every (batch, head): bytes.  What holds it
// back in practice is latency: a block walks its (batch, head)'s chunks in
// order, each step waits on the one before, and B H = 256 blocks give the
// 132 SMs two chains each at most (PERF.md, section 6).
//
// What the design does about it: the TPU runs the (batch, head, chunk)
// grid in order with the state in VMEM scratch.  Here one block of 256
// threads owns a (batch, head) and loops over its chunks with three
// barriers a chunk, every phase spread over all eight warps:
//   (1) cp.async has landed the chunk in shared memory: r, k, v in their
//       own dtype and w in float32, rows padded by 16 bytes; two
//       stages, the copy two chunks ahead issued once a stage has been
//       read (one stage where two do not fit, at large chunks);
//   (P) the entering state goes from registers to shared memory; each
//       thread owns four columns of one row of each 16-row block: the
//       cumsum of w down the chunk by a 16-lane __shfl_up_sync scan, then
//       its float4 of r exp(wprev), k exp(-wcum), k exp(total - wcum) and
//       v as float32;
//   (2) __syncthreads_or of "some column's |total| > 64" picks the form;
//   (A) the (Q, Q) weight tile below the diagonal as 2 x 2 register tiles,
//       four lanes a tile each summing a quarter of K from float4s, and
//       the bonus on the diagonal, four lanes a row;
//   (3) the stage is free: the copy two chunks ahead is issued;
//   (Y) y = A v + (r exp(wprev)) S as one product over K + Q: each lane a
//       4 x 4 tile of y and a quarter of the sum (k and s of one residue
//       mod 4), the quarters reduced by two shuffles; then the state
//       update S = exp(total) S + k_tail^T v, each thread's 4 x 4 tile of
//       S held in registers for the whole scan.
// Every product reads float4 operands and accumulates in float32 on the
// CUDA cores (a tensor core would give TF32 or bf16 operands, and the
// state needs more: PERF.md, section 6).  K, V and Q up to 64 are taken; rows
// that are not 16-byte aligned (K or V not a multiple of 4, of 8 in bf16,
// or an unaligned pointer) load and store element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMax = 64;            // the largest K and V
constexpr int kMaxQ = 64;           // the largest chunk
constexpr int kLDR = kMax + 4;      // row stride of the [row][k] float arrays
constexpr float kSplitCut = 64.f;   // the largest |total| of the split form
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

template <typename T>
__host__ __device__ constexpr int row_pad() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// four consecutive values (16-byte aligned float, 8-byte aligned bf16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void st4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&x)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// acc + a . b, the four products in order
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc + sum_i r_i k_i exp((ct_i - w_i) - cs_i): four pairs' direct decays
__device__ __forceinline__ float direct4(float4 r, float4 w, float4 ct,
                                         float4 k, float4 cs, float acc) {
  acc = fmaf(r.x * k.x, expf((ct.x - w.x) - cs.x), acc);
  acc = fmaf(r.y * k.y, expf((ct.y - w.y) - cs.y), acc);
  acc = fmaf(r.z * k.z, expf((ct.z - w.z) - cs.z), acc);
  return fmaf(r.w * k.w, expf((ct.w - w.w) - cs.w), acc);
}

// acc[i][j] += a[i] b[j]
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// Shared memory: the float arrays, then the stages.
template <typename T>
struct Layout {
  int qp;              // Q rounded up to a multiple of 4
  size_t floats;       // float words before the stages
  size_t stage;        // bytes of one stage: r, k, v rows, then w rows
  __host__ __device__ explicit Layout(int Q) {
    qp = (Q + 3) & ~3;
    floats = static_cast<size_t>(kMax) * kMax         // S
             + static_cast<size_t>(kMax) * qp         // r exp(wprev), [k][t]
             + static_cast<size_t>(qp) * qp           // A, [s][t]
             + 4 * static_cast<size_t>(qp) * kLDR     // ri, kn, kt, wcum
             + static_cast<size_t>(qp) * kMax         // v
             + 2 * kMax;                              // u, exp(total)
    stage = static_cast<size_t>(Q) *
            (3 * (kMax + row_pad<T>()) * sizeof(T) + kLDR * sizeof(float));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ init,
             T* __restrict__ y, float* __restrict__ final_state, int L, int H,
             int K, int V, int Q, int n_stages, int vec) {
  constexpr int kLDT = kMax + row_pad<T>();   // stage rows of r, k and v
  const Layout<T> lay(Q);
  const int qp = lay.qp;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sS = reinterpret_cast<float*>(smem);  // kMax x kMax: entering state
  float* sRiT = sS + kMax * kMax;              // kMax x qp: r exp(wprev) [k][t]
  float* sAT = sRiT + kMax * qp;               // qp x qp: weights [s][t]
  float* sRi = sAT + qp * qp;                  // qp x kLDR: r exp(wprev)
  float* sKn = sRi + qp * kLDR;                // qp x kLDR: k exp(-wcum)
  float* sKt = sKn + qp * kLDR;                // qp x kLDR: k exp(total - wcum)
  float* sWc = sKt + qp * kLDR;                // qp x kLDR: wcum
  float* sVf = sWc + qp * kLDR;                // qp x kMax: v
  float* sU = sVf + qp * kMax;                 // kMax: u
  float* sE = sU + kMax;                       // kMax: exp(total)
  unsigned char* stages = reinterpret_cast<unsigned char*>(sE + kMax);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int K4 = (K + 3) & ~3;
  const size_t krow = static_cast<size_t>(H) * K;   // stride of a position
  const size_t vrow = static_cast<size_t>(H) * V;
  const size_t kbase = static_cast<size_t>(b) * L * krow + static_cast<size_t>(h) * K;
  const size_t vbase = static_cast<size_t>(b) * L * vrow + static_cast<size_t>(h) * V;
  const size_t sbase = (static_cast<size_t>(b) * H + h) * K * V;
  const int n_chunks = (L + Q - 1) / Q;

  // The thread's 4 x 4 tile of the state, held in registers for the whole
  // scan: rows 4 kb.., columns 4 vb..; a warp's 8-lane phases read 8
  // consecutive vb.
  const int st_vb = (warp & 1) * 8 + (lane & 7);
  const int st_kb = (warp >> 1) * 4 + (lane >> 3);
  const bool st_live = 4 * st_vb < V;
  float st[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) st[i][j] = 0.f;
  if (init != nullptr && st_live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = 4 * st_kb + i;
      if (kk >= K) continue;
      const float* row = init + sbase + static_cast<size_t>(kk) * V + 4 * st_vb;
      if (vec) {
        const float4 x = ld4(row);
        st[i][0] = x.x; st[i][1] = x.y; st[i][2] = x.z; st[i][3] = x.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * st_vb + j < V) st[i][j] = row[j];
      }
    }
  }
  for (int i = tid; i < kMax; i += kThreads)
    sU[i] = i < K ? u[static_cast<size_t>(h) * K + i] : 0.f;
  for (int i = tid; i < qp * qp; i += kThreads)   // A above the diagonal
    if (i / qp > i % qp) sAT[i] = 0.f;
  if (K & 3) {   // products read the stage's r, k, w up to K4: zero them
    float4* z = reinterpret_cast<float4*>(stages);
    for (size_t i = tid; i < n_stages * lay.stage / 16; i += kThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  auto stage_r = [&](int si) {
    return reinterpret_cast<T*>(stages + si * lay.stage);
  };
  // Copy chunk c's live rows into stage si: cp.async 16-byte copies where
  // every row is 16-byte aligned, else plain loads.
  auto issue = [&](int c, int si) {
    if (c >= n_chunks) return;
    const int t0 = c * Q, Lc = min(Q, L - t0);
    T* sr = stage_r(si);
    T* sk = sr + Q * kLDT;
    T* sv = sk + Q * kLDT;
    float* sw = reinterpret_cast<float*>(sv + Q * kLDT);
    if (vec) {
      constexpr int kPer = 16 / sizeof(T);   // elements of a 16-byte copy
      const int segK = K / kPer, segV = V / kPer, segW = K / 4;
      const int per_row = 2 * segK + segV + segW;
      for (int i = tid; i < Lc * per_row; i += kThreads) {
        const int t = i / per_row;
        int s = i - t * per_row;
        const size_t g = static_cast<size_t>(t0 + t);
        if (s < segK) {
          cp_async16(sr + t * kLDT + s * kPer, r + kbase + g * krow + s * kPer);
        } else if ((s -= segK) < segK) {
          cp_async16(sk + t * kLDT + s * kPer, k + kbase + g * krow + s * kPer);
        } else if ((s -= segK) < segV) {
          cp_async16(sv + t * kLDT + s * kPer, v + vbase + g * vrow + s * kPer);
        } else {
          s -= segV;
          cp_async16(sw + t * kLDR + s * 4, w + kbase + g * krow + s * 4);
        }
      }
    } else {
      for (int i = tid; i < Lc * K; i += kThreads) {
        const int t = i / K, j = i - t * K;
        const size_t off = kbase + static_cast<size_t>(t0 + t) * krow + j;
        sr[t * kLDT + j] = r[off];
        sk[t * kLDT + j] = k[off];
        sw[t * kLDR + j] = w[off];
      }
      for (int i = tid; i < Lc * V; i += kThreads) {
        const int t = i / V, j = i - t * V;
        sv[t * kLDT + j] = v[vbase + static_cast<size_t>(t0 + t) * vrow + j];
      }
    }
  };

  issue(0, 0);
  cp_async_commit();
  if (n_stages == 2) {
    issue(1, 1);
    cp_async_commit();
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int si = n_stages == 2 ? (c & 1) : 0;
    const int t0 = c * Q, Lc = min(Q, L - t0);
    const T* sr = stage_r(si);
    const T* sk = sr + Q * kLDT;
    const T* sv = sk + Q * kLDT;
    const float* sw = reinterpret_cast<const float*>(sv + Q * kLDT);
    if (n_stages == 2) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();                                                  // (1)

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x[4] = {st[i][0], st[i][1], st[i][2], st[i][3]};
      st4(sS + (4 * st_kb + i) * kMax + 4 * st_vb, x);
    }

    // (P) rows t = rb + lane % 16 of each 16-row block, columns 4 cg..,
    // cg = 2 warp + lane / 16: the cumsum of w down the rows by a 16-lane
    // scan, then the rows' operands
    bool unsafe = false;
    {
      const int j0 = 4 * (warp * 2 + (lane >> 4)), row = lane & 15;
      const bool live = j0 < K;
      float total[4] = {0.f, 0.f, 0.f, 0.f};
      for (int rb = 0; rb < qp; rb += 16) {
        const int t = rb + row;
        const float4 w4 = live && t < Lc ? ld4(sw + t * kLDR + j0)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
        float x[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int d = 1; d < 16; d <<= 1)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float o = __shfl_up_sync(kFull, x[i], d, 16);
            if (row >= d) x[i] += o;
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] += total[i];
          total[i] = __shfl_sync(kFull, x[i], 15, 16);
        }
        if (t < qp) st4(sWc + t * kLDR + j0, x);
      }
      bool safe[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        safe[i] = fabsf(total[i]) <= kSplitCut;
        unsafe |= !safe[i];
      }
      if (row == 0) {
        const float e[4] = {expf(total[0]), expf(total[1]), expf(total[2]),
                            expf(total[3])};
        st4(sE + j0, e);
      }
      for (int t = row; t < qp; t += 16) {
        float ri[4] = {0.f, 0.f, 0.f, 0.f}, kn[4] = {0.f, 0.f, 0.f, 0.f},
              kt[4] = {0.f, 0.f, 0.f, 0.f};
        if (live && t < Lc) {
          const float4 c4 = ld4(sWc + t * kLDR + j0), w4 = ld4(sw + t * kLDR + j0);
          const float4 r4 = ld4(sr + t * kLDT + j0), k4 = ld4(sk + t * kLDT + j0);
          const float wc[4] = {c4.x, c4.y, c4.z, c4.w};
          const float wt[4] = {w4.x, w4.y, w4.z, w4.w};
          const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
          const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ri[i] = rv[i] * expf(wc[i] - wt[i]);
            kt[i] = kv[i] * expf(total[i] - wc[i]);
            if (safe[i]) kn[i] = kv[i] * expf(-wc[i]);
          }
        }
        st4(sRi + t * kLDR + j0, ri);
        st4(sKn + t * kLDR + j0, kn);
        st4(sKt + t * kLDR + j0, kt);
#pragma unroll
        for (int i = 0; i < 4; ++i) sRiT[(j0 + i) * qp + t] = ri[i];
        float vf[4] = {0.f, 0.f, 0.f, 0.f};
        if (t < Lc) {
          const float4 v4 = ld4(sv + t * kLDT + j0);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (j0 + i < V) vf[i] = vv[i];
        }
        st4(sVf + t * kMax + j0, vf);
      }
    }
    const bool direct = __syncthreads_or(unsafe);                     // (2)

    // (A) 2 x 2 tiles of A below the diagonal, tile (tp, sp <= tp) of
    // rows t = 2 tp.. and columns s = 2 sp..; then the bonus A[t][t], a
    // row at a time.  Four lanes a task, lane q summing k = 4 (q + 4 i)..
    // (q + 4 i) + 3, the four sums reduced as (q0 + q1) + (q2 + q3).
    {
      const int np = qp / 2, n_tiles = np * (np + 1) / 2;
      const int n_tasks = 4 * (n_tiles + qp), q = lane & 3;
      for (int base = warp * 32; base < n_tasks; base += kThreads) {
        const int task = (base + lane) >> 2;
        float p[4] = {0.f, 0.f, 0.f, 0.f};   // (t, s) (t, s+1) (t+1, s) (t+1, s+1)
        int t = 0, s = 0;
        const bool tile = task < n_tiles;
        if (tile) {
          int tp = static_cast<int>((sqrtf(8.f * task + 1.f) - 1.f) * 0.5f);
          while (tp * (tp + 1) / 2 > task) --tp;
          while ((tp + 1) * (tp + 2) / 2 <= task) ++tp;
          t = 2 * tp;
          s = 2 * (task - tp * (tp + 1) / 2);
        } else {
          t = s = task - n_tiles;
        }
        if (t < Lc && base + lane < n_tasks) {
          // rows past Lc - 1 read row Lc - 1: their entries are stored as 0
          const int t1 = min(t + 1, Lc - 1), s1 = min(s + 1, Lc - 1);
          if (!tile) {           // the bonus: sum_k r u k
            for (int j = 4 * q; j < K4; j += 16) {
              const float4 rr = ld4(sr + t * kLDT + j), kk = ld4(sk + t * kLDT + j);
              const float4 uu = ld4(sU + j);
              p[0] = fmaf(rr.x * uu.x, kk.x, p[0]);
              p[0] = fmaf(rr.y * uu.y, kk.y, p[0]);
              p[0] = fmaf(rr.z * uu.z, kk.z, p[0]);
              p[0] = fmaf(rr.w * uu.w, kk.w, p[0]);
            }
          } else if (!direct) {  // the split form
            for (int j = 4 * q; j < K4; j += 16) {
              const float4 a0 = ld4(sRi + t * kLDR + j), a1 = ld4(sRi + (t + 1) * kLDR + j);
              const float4 b0 = ld4(sKn + s * kLDR + j), b1 = ld4(sKn + (s + 1) * kLDR + j);
              p[0] = dot4(a0, b0, p[0]);
              p[1] = dot4(a0, b1, p[1]);
              p[2] = dot4(a1, b0, p[2]);
              p[3] = dot4(a1, b1, p[3]);
            }
          } else {               // the direct form
            for (int j = 4 * q; j < K4; j += 16) {
              const float4 r0 = ld4(sr + t * kLDT + j), r1 = ld4(sr + t1 * kLDT + j);
              const float4 k0 = ld4(sk + s * kLDT + j), k1 = ld4(sk + s1 * kLDT + j);
              const float4 w0 = ld4(sw + t * kLDR + j), w1 = ld4(sw + t1 * kLDR + j);
              const float4 c0 = ld4(sWc + t * kLDR + j), c1 = ld4(sWc + t1 * kLDR + j);
              const float4 d0 = ld4(sWc + s * kLDR + j), d1 = ld4(sWc + s1 * kLDR + j);
              p[0] = direct4(r0, w0, c0, k0, d0, p[0]);
              p[1] = direct4(r0, w0, c0, k1, d1, p[1]);
              p[2] = direct4(r1, w1, c1, k0, d0, p[2]);
              p[3] = direct4(r1, w1, c1, k1, d1, p[3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] += __shfl_xor_sync(kFull, p[i], 1);
          p[i] += __shfl_xor_sync(kFull, p[i], 2);
        }
        if (base + lane < n_tasks) {
          if (tile) {
            const int te = t + (q >> 1), se = s + (q & 1);
            const float a = q == 0 ? p[0] : q == 1 ? p[1] : q == 2 ? p[2] : p[3];
            if (se < te) sAT[se * qp + te] = te < Lc ? a : 0.f;
          } else if (q == 0) {
            sAT[t * qp + t] = t < Lc ? p[0] : 0.f;
          }
        }
      }
    }
    __syncthreads();                                                  // (3)
    issue(c + n_stages, si);
    cp_async_commit();

    // (Y) y rows 4 tb.., V columns 4 vb..: the quarter of the sum over
    // k and s = split mod 4, then the quarters reduced across the lanes
    // 8 and 16 apart: y = (q0 + q2) + (q1 + q3), lane `split` keeping row
    // 4 tb + split
    {
      const int split = lane >> 3;
      for (int item = tid; item < (qp / 4) * kMax; item += kThreads) {
        const int wi = item >> 5;
        const int tb = wi >> 1, vb = (wi & 1) * 8 + (lane & 7);
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int kk = split; kk < K4; kk += 4)
          outer4(acc, ld4(sRiT + kk * qp + 4 * tb), ld4(sS + kk * kMax + 4 * vb));
        const int s_end = min(4 * tb + 4, Lc);
        for (int s = split; s < s_end; s += 4)
          outer4(acc, ld4(sAT + s * qp + 4 * tb), ld4(sVf + s * kMax + 4 * vb));
        const bool hi2 = split & 2, hi1 = split & 1;
        float half[2][4], out[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float keep = hi2 ? acc[i + 2][j] : acc[i][j];
            const float send = hi2 ? acc[i][j] : acc[i + 2][j];
            half[i][j] = keep + __shfl_xor_sync(kFull, send, 16);
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float keep = hi1 ? half[1][j] : half[0][j];
          const float send = hi1 ? half[0][j] : half[1][j];
          out[j] = keep + __shfl_xor_sync(kFull, send, 8);
        }
        const int t = 4 * tb + split;
        if (t < Lc && 4 * vb < V) {
          T* dst = y + vbase + static_cast<size_t>(t0 + t) * vrow + 4 * vb;
          if (vec) {
            st4(dst, out);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (4 * vb + j < V) from_f(dst + j, out[j]);
          }
        }
      }
    }

    // (S) S = exp(total) S + sum_{s < Lc} k_tail[s]^T v[s], in registers
    {
      const float4 e = ld4(sE + 4 * st_kb);
      const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] *= ev[i];
      for (int s = 0; s < Lc; ++s)
        outer4(st, ld4(sKt + s * kLDR + 4 * st_kb), ld4(sVf + s * kMax + 4 * st_vb));
    }
  }

  if (final_state != nullptr && st_live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = 4 * st_kb + i;
      if (kk >= K) continue;
      float* row = final_state + sbase + static_cast<size_t>(kk) * V + 4 * st_vb;
      if (vec) {
        const float x[4] = {st[i][0], st[i][1], st[i][2], st[i][3]};
        st4(row, x);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * st_vb + j < V) row[j] = st[i][j];
      }
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* init, void* y, float* final_state,
           int B, int L, int H, int K, int V, int Q, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout<T> lay(Q);
  const size_t fixed = lay.floats * sizeof(float);
  const int n_stages = fixed + 2 * lay.stage <= static_cast<size_t>(optin) ? 2 : 1;
  const size_t bytes = fixed + n_stages * lay.stage;
  if (bytes > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const size_t es = sizeof(T);
  const int vec = (K * es) % 16 == 0 && (V * es) % 16 == 0 && K % 4 == 0 &&
                  aligned(r) && aligned(k) && aligned(v) && aligned(w) &&
                  aligned(y) && aligned(init) && aligned(final_state);
  auto kernel = rwkv6_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, init, static_cast<T*>(y), final_state, L,
      H, K, V, Q, n_stages, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16, for r, k, v
// and y; w, u, init and final_state are float32; init and final_state may
// be null (zero initial state; no final state written).  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 on
// success).  The caller guarantees contiguous buffers of the stated shapes;
// anything the kernel does not take (K or V above 64, Q above 64, an empty
// or too large grid) is refused with cudaErrorInvalidValue.
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const float* w, const float* u, const float* init,
                            void* y, float* final_state, int dtype, int B,
                            int L, int H, int K, int V, int Q, void* stream) {
  if (B < 1 || L < 1 || H < 1 || K < 1 || K > kMax || V < 1 || V > kMax ||
      Q < 1 || Q > kMaxQ || B > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, init, y, final_state, B, L, H, K, V, Q, s);
  return launch<__nv_bfloat16>(r, k, v, w, u, init, y, final_state, B, L, H, K, V, Q, s);
}
