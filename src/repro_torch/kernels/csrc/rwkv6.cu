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
// The decay of a pair (t, s < t) is taken directly, exp(wprev[t] - wcum[s])
// with an exponent <= 0, not split as the oracle splits it across the two
// operands (r exp(wprev[t]) times k exp(-wcum[s])).  The split form's
// exp(-wcum) grows as e^(|w| Q), which stays inside float32 (e^88.7) only
// while |w| Q does: the model clamps |w| to 4 and takes Q = 16, so e^64.
// The direct form cannot overflow at any chunk; it costs one exp for each
// (t, s, k), Q^2 K / 2 a chunk.  The chunk stays the caller's: it sets the
// order of the sums, and the kernel never changes it.
//
// What bounds it on an H100: operations, narrowly.  At the serve shape
// (rwkv6-1.6b prefill: B = 8, L = 2048, H = 32, K = V = 64, Q = 16, bf16)
// one call needs ~1.1e10 float32 operations (the inter product and the
// state update, Q K V each a chunk, dominate) and moves ~0.40 GB (r, k, v,
// y in bf16, w in float32): ~0.16 ms at the CUDA cores' 67 TFLOP/s against
// ~0.12 ms at 3.35 TB/s.  A decode step (L = 1) reads and writes the
// 16 KB state of every (batch, head): bytes.
//
// What the design does about it: the TPU runs the (batch, head, chunk)
// grid in order with the state in VMEM scratch.  Here one block of 256
// threads owns a (batch, head) and loops over the chunks in order, its
// 64 x 64 float32 state in shared memory (16 KB); at the serve shape that is
// 256 blocks over 132 SMs, all resident at once (~39 KB of shared memory a
// block at Q = 16).  Per chunk the block stages r, k, v, w in shared memory
// as float32 (zero past Lc), takes the column cumsums of w (one thread a
// column), forms the (Q, Q) weight tile A (strictly lower triangle plus the
// bonus on the diagonal), then computes y = A v + (r exp(wprev)) S and the
// state update, each output element owned by one thread, accumulating in
// float32 on the CUDA cores.  Row strides of K + 1 floats keep column walks
// free of bank conflicts.  K and V up to 64 and Q up to 64 are taken.
// Tensor cores, TMA and prefetching the next chunk are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMax = 64;                  // the largest K and V
constexpr int kLD = kMax + 1;             // odd row stride
constexpr int kGroups = kThreads / kMax;  // thread groups over rows
constexpr int kMaxQ = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ inline size_t smem_floats(int Q) {
  return static_cast<size_t>(kMax) * kLD + 5 * static_cast<size_t>(Q) * kLD +
         static_cast<size_t>(Q) * (Q + 1) + 3 * static_cast<size_t>(kMax);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ init,
             T* __restrict__ y, float* __restrict__ final_state, int L, int H,
             int K, int V, int Q) {
  extern __shared__ float smem[];
  float* sS = smem;                 // kMax x kLD: state [k][v]
  float* sR = sS + kMax * kLD;      // Q x kLD: r, then r exp(wprev)
  float* sK = sR + Q * kLD;         // Q x kLD: k, then k exp(total - wcum)
  float* sV = sK + Q * kLD;         // Q x kLD: v
  float* sW = sV + Q * kLD;         // Q x kLD: w, then wcum
  float* sP = sW + Q * kLD;         // Q x kLD: wprev = wcum - w
  float* sA = sP + Q * kLD;         // Q x (Q + 1): weights [t][s], s <= t
  float* sU = sA + Q * (Q + 1);     // kMax: u
  float* sT = sU + kMax;            // kMax: total
  float* sE = sT + kMax;            // kMax: exp(total), the chunk's decay

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int col = tid % kMax, grp = tid / kMax;
  const size_t krow = static_cast<size_t>(H) * K;   // stride of a position
  const size_t vrow = static_cast<size_t>(H) * V;
  const size_t kbase = static_cast<size_t>(b) * L * krow + static_cast<size_t>(h) * K;
  const size_t vbase = static_cast<size_t>(b) * L * vrow + static_cast<size_t>(h) * V;
  const size_t KV = static_cast<size_t>(K) * V;

  // entering state of chunk 0 (rows and columns past K and V stay 0)
  for (int i = tid; i < kMax * kLD; i += kThreads) sS[i] = 0.f;
  if (tid < K) sU[tid] = u[static_cast<size_t>(h) * K + tid];
  __syncthreads();
  if (init != nullptr) {
    const float* ib = init + (static_cast<size_t>(b) * H + h) * KV;
    for (int i = tid; i < K * V; i += kThreads) sS[(i / V) * kLD + i % V] = ib[i];
  }

  const int n_chunks = (L + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int Lc = min(Q, L - t0);

    // stage the chunk as float32; rows past Lc are the oracle's padding
    __syncthreads();
    for (int i = tid; i < Q * kMax; i += kThreads) {
      const int t = i / kMax, j = i % kMax;
      float rv = 0.f, kv = 0.f, wv = 0.f, vv = 0.f;
      if (t < Lc) {
        if (j < K) {
          const size_t off = kbase + static_cast<size_t>(t0 + t) * krow + j;
          rv = to_f(r[off]);
          kv = to_f(k[off]);
          wv = w[off];
        }
        if (j < V) vv = to_f(v[vbase + static_cast<size_t>(t0 + t) * vrow + j]);
      }
      sR[t * kLD + j] = rv;
      sK[t * kLD + j] = kv;
      sW[t * kLD + j] = wv;
      sV[t * kLD + j] = vv;
    }
    __syncthreads();

    // inclusive cumsum of w down each column, wprev as the oracle forms it
    if (tid < K) {
      float run = 0.f;
      for (int t = 0; t < Q; ++t) {
        const float wt = sW[t * kLD + tid];
        run += wt;
        sW[t * kLD + tid] = run;
        sP[t * kLD + tid] = run - wt;
      }
      sT[tid] = run;                   // padded rows add exactly 0
      sE[tid] = expf(run);
    }
    __syncthreads();

    // A[t][s] = sum_k r[t,k] k[s,k] exp(wprev[t,k] - wcum[s,k]) for s < t;
    // A[t][t] = sum_k r[t,k] u[k] k[t,k]; 0 above the diagonal
    for (int i = tid; i < Q * Q; i += kThreads) {
      const int t = i / Q, s = i % Q;
      float acc = 0.f;
      if (t < Lc && s < t) {
        for (int j = 0; j < K; ++j)
          acc = fmaf(sR[t * kLD + j] * sK[s * kLD + j],
                     expf(sP[t * kLD + j] - sW[s * kLD + j]), acc);
      } else if (t < Lc && s == t) {
        for (int j = 0; j < K; ++j)
          acc = fmaf(sR[t * kLD + j] * sU[j], sK[t * kLD + j], acc);
      }
      sA[t * (Q + 1) + s] = acc;
    }
    __syncthreads();

    // the operands of the inter term and of the state update
    for (int i = tid; i < Q * kMax; i += kThreads) {
      const int t = i / kMax, j = i % kMax;
      if (j < K) {
        sR[t * kLD + j] *= expf(sP[t * kLD + j]);
        sK[t * kLD + j] *= expf(sT[j] - sW[t * kLD + j]);
      }
    }
    __syncthreads();

    // y[t][col] = sum_k ri[t][k] S[k][col] + sum_{s<=t} A[t][s] v[s][col]
    if (col < V) {
      for (int t = grp; t < Lc; t += kGroups) {
        float acc = 0.f;
        for (int j = 0; j < K; ++j) acc = fmaf(sR[t * kLD + j], sS[j * kLD + col], acc);
        for (int s = 0; s <= t; ++s) acc = fmaf(sA[t * (Q + 1) + s], sV[s * kLD + col], acc);
        from_f(y + vbase + static_cast<size_t>(t0 + t) * vrow + col, acc);
      }
    }
    __syncthreads();

    // S[k][col] = exp(total_k) S[k][col] + sum_{s<Lc} k_tail[s][k] v[s][col]
    if (col < V) {
      for (int j = grp; j < K; j += kGroups) {
        float acc = sS[j * kLD + col] * sE[j];
        for (int s = 0; s < Lc; ++s) acc = fmaf(sK[s * kLD + j], sV[s * kLD + col], acc);
        sS[j * kLD + col] = acc;
      }
    }
  }
  __syncthreads();

  if (final_state != nullptr) {
    float* fb = final_state + (static_cast<size_t>(b) * H + h) * KV;
    for (int i = tid; i < K * V; i += kThreads) fb[i] = sS[(i / V) * kLD + i % V];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* init, void* y, float* final_state,
           int B, int L, int H, int K, int V, int Q, cudaStream_t stream) {
  const size_t bytes = smem_floats(Q) * sizeof(float);
  auto kernel = rwkv6_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, init, static_cast<T*>(y), final_state, L,
      H, K, V, Q);
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
