// Single-token GQA attention against a KV cache, split over the keys
// (flash-decoding's shape): a kernel that reduces each chunk of the cache
// and a second, small one that merges the chunks, behind one C entry point.
//
// It replaces no TPU kernel: the reference leaves decode attention to XLA
// (repro/kernels/ops.py::decode_attention), which fuses the cast of the cache
// into its loads.  Eager PyTorch cannot: the plain version
// (kernels/ref.py::decode_attention_ref) writes float32 copies of the whole
// reserved cache every layer and step before it multiplies.
//
// For q (B, 1, Hq, D) and caches k, v (B, L, Hkv, D), float32 or bfloat16,
// the kv head of q head h being h / (Hq / Hkv), and n = *n_valid, read on the
// device (the valid slots are the prefix [0, n) of the cache):
//   s_j = (q . k_j) / sqrt(D)           float32 products and sums
//   o   = sum_j softmax(s)_j v_j         float32 p and sums, o in q's dtype
// which is the plain version's mathematics with its sums taken in another
// order: products of two bfloat16 values are exact in float32, and p is never
// rounded.  n < 1 leaves no slot valid: the plain version's masked scores are
// then all equal and every slot of the cache weighs the same, and so it is
// here; n > L counts as L.
//
// What bounds it on an H100: bytes.  Each valid key and value is read once, in
// its own dtype, and serves the g = Hq / Hkv q heads of its kv head with 2 g D
// operations: g operations a bfloat16 byte, far under what the CUDA cores
// sustain at the memory's 3.35 TB/s.  minitron-4b's decode step (B = 64, 8 kv
// heads of 128, ~2,150 valid of 3,076 slots) reads ~0.56 GB a layer: ~0.17 ms.
//
// `decode_attention_split_kernel`: one block of 128 threads owns one
// (request, kv head, group of G q heads, chunk of up to 256 keys); a chunk
// that starts at or past n returns at once.  The chunk's K tiles and then its
// V tiles (64 keys each) stream through a ring of two tiles of shared memory,
// filled with cp.async 16 bytes a thread: the next tile's copy is in flight
// while this one is computed, and the first V tile loads while the last K
// tile is reduced.  Two tiles, not three or four: at minitron-4b's shape the
// smaller ring lets more blocks share an SM, which hides more latency than a
// deeper ring does (0.263 ms against 0.282 with three and 0.337 with four, on
// an H100).  A key's D columns are spread over a group of lanes, 8 columns
// a lane (rows padded to an odd number of 16-byte units, so a group's loads
// meet no bank twice); the lane's 8 columns of each q head sit in registers.
// s is summed over the lane group with shuffles and kept in shared memory;
// once the chunk's scores are in, the block takes each head's max m, writes
// p = exp(s - m) over them and sums l = sum p; then each lane accumulates
// p v for its 8 columns and G heads over the keys of its lane group, in
// float32 registers, and the groups and warps are summed in a fixed order.
// The block writes its unnormalised o, m and l to the caller's scratch.
// `decode_attention_merge_kernel`: one block a (request, q head) weighs the
// valid chunks by exp(m_c - max m) and writes o = sum_c w_c o_c / sum_c w_c
// l_c in q's dtype.
// The chunk (64, 128 or 256 keys) is the caller's, from the shapes.  G is the
// largest divisor of g up to 8; larger groups take several blocks, each of
// which reads the keys again.  Neither kernel synchronises or allocates, and
// n stays on the device, so a CUDA graph can capture both launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 64;     // keys a tile of the ring
constexpr int kStages = 2;        // tiles in the ring
constexpr int kMaxChunk = 256;    // keys a block
constexpr int kMaxGroup = 8;      // q heads a block
constexpr int kMaxD = 256;

struct Shape {
  int L, Hq, Hkv, D;
  int chunk, n_chunks;   // keys a block, blocks over L
  int groups;            // blocks of G q heads a kv head
  long long q_sb, q_sh;                 // q's strides, elements
  long long kv_sb, kv_sl, kv_sh;        // k's and v's strides, elements
  float sqrt_d;
};

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 8 consecutive elements from 16-byte-aligned shared memory, as float32
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // the element at the lower address is low
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The valid keys: n = *n_valid clamped to L; none when n < 1 (then all L
// slots count, each with the same score).
__device__ __forceinline__ int valid_keys(const int* n_valid, int L, bool& none) {
  const int n = *n_valid;
  none = n < 1;
  return none ? L : min(n, L);
}

// Shared row stride in elements: D padded to an odd number of 16-byte units.
template <typename T>
__host__ __device__ inline int row_stride(int D) {
  const int per_unit = 16 / static_cast<int>(sizeof(T));
  return ((D / per_unit) | 1) * per_unit;
}

template <typename T, int G>
__host__ __device__ inline size_t smem_bytes(int D, int chunk) {
  return sizeof(T) * static_cast<size_t>(kStages) * kTileKeys * row_stride<T>(D) +
         sizeof(float) * (static_cast<size_t>(G) * chunk + kWarps * G);
}

// Each of x[0..G) reduced over the block (max or sum), in every thread.
// red holds kWarps x G floats.
template <int G, bool kMax>
__device__ __forceinline__ void block_reduce(float (&x)[G], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[h], off);
      x[h] = kMax ? fmaxf(x[h], y) : x[h] + y;
    }
  if (lane == 0)
#pragma unroll
    for (int h = 0; h < G; ++h) red[warp * G + h] = x[h];
  __syncthreads();
#pragma unroll
  for (int h = 0; h < G; ++h) {
    float r = red[h];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      r = kMax ? fmaxf(r, red[w * G + h]) : r + red[w * G + h];
    x[h] = r;
  }
  __syncthreads();   // red is written again by the next reduction
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ n_valid,
                              float* __restrict__ part_o,
                              float* __restrict__ part_ml, Shape sh) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  bool none;
  const int n_all = valid_keys(n_valid, sh.L, none);
  const int c = blockIdx.x;
  const int key0 = c * sh.chunk;
  if (key0 >= n_all) return;                  // the whole block leaves
  const int n = min(sh.chunk, n_all - key0);  // this chunk's keys
  const int b = blockIdx.z;
  const int hk = blockIdx.y / sh.groups;
  const int h0 = hk * (sh.Hq / sh.Hkv) + (blockIdx.y % sh.groups) * G;
  const int D = sh.D;
  constexpr int kPerUnit = 16 / static_cast<int>(sizeof(T));
  const int units = D / kPerUnit;             // 16-byte units of a row
  const int ld = row_stride<T>(D);
  const int stage = kTileKeys * ld;
  T* ring = reinterpret_cast<T*>(dec_smem);                    // kStages tiles
  float* s_p = reinterpret_cast<float*>(ring + kStages * stage);  // G x chunk
  float* s_red = s_p + G * sh.chunk;                              // kWarps x G

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lpk = 1;                                // lanes a key: 8 columns a lane
  while (8 * lpk < D) lpk <<= 1;
  const int kpw = 32 / lpk;                   // keys a warp takes at once
  const int lig = lane & (lpk - 1), kg = lane / lpk;
  const int col = 8 * lig;
  const bool active = col < D;

  const int n_tiles = (n + kTileKeys - 1) / kTileKeys;
  const long long kv_base = b * sh.kv_sb + hk * sh.kv_sh;
  // tile t of the chunk's 2 n_tiles: K tiles first, then V tiles
  auto load = [&](int t) {
    const T* src = (t < n_tiles ? k : v) + kv_base;
    const int first = key0 + (t % n_tiles) * kTileKeys;
    const int rows = min(kTileKeys, key0 + n - first);
    T* dst = ring + (t % kStages) * stage;
    for (int i = tid; i < rows * units; i += kThreads) {
      const int r = i / units, u = i - r * units;
      cp_async16(dst + r * ld + u * kPerUnit,
                 src + (first + r) * sh.kv_sl + u * kPerUnit);
    }
  };
  // wait for tile t, keeping kStages - 1 tiles in flight behind it
  const int n_t = 2 * n_tiles;
  auto advance = [&](int t) {
    if (t + kStages - 1 < n_t) load(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_t) load(t);
    cp_async_commit();
  }

  // S = q k / sqrt(D) over the chunk, into s_p
  {
    float qr[G][8];
    const T* qb = q + b * sh.q_sb + col;
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qr[h][e] = active ? to_float(qb[(h0 + h) * sh.q_sh + e]) : 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      advance(t);
      const T* tile = ring + (t % kStages) * stage;
      const int j0 = t * kTileKeys;
      const int rows = min(kTileKeys, n - j0);
      // warp-uniform bound: every lane reaches the shuffles
      for (int base = warp * kpw; base < rows; base += kWarps * kpw) {
        const int j = base + kg;
        float s[G];
#pragma unroll
        for (int h = 0; h < G; ++h) s[h] = 0.f;
        if (active && j < rows) {
          float x[8];
          load8(tile + j * ld + col, x);
#pragma unroll
          for (int h = 0; h < G; ++h)
#pragma unroll
            for (int e = 0; e < 8; ++e) s[h] = fmaf(qr[h][e], x[e], s[h]);
        }
        for (int off = lpk >> 1; off > 0; off >>= 1)
#pragma unroll
          for (int h = 0; h < G; ++h)
            s[h] += __shfl_xor_sync(0xffffffffu, s[h], off);
        if (lig == 0 && j < rows)
#pragma unroll
          for (int h = 0; h < G; ++h)
            s_p[h * sh.chunk + j0 + j] = none ? 0.f : s[h] / sh.sqrt_d;
      }
      __syncthreads();   // the next load refills this tile
    }
  }

  // the chunk's softmax state: m, then p = exp(s - m) in place, l = sum p
  float m[G], l[G];
#pragma unroll
  for (int h = 0; h < G; ++h) m[h] = -INFINITY;
  for (int j = tid; j < n; j += kThreads)
#pragma unroll
    for (int h = 0; h < G; ++h) m[h] = fmaxf(m[h], s_p[h * sh.chunk + j]);
  block_reduce<G, true>(m, s_red);
#pragma unroll
  for (int h = 0; h < G; ++h) l[h] = 0.f;
  for (int j = tid; j < n; j += kThreads)
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float p = expf(s_p[h * sh.chunk + j] - m[h]);
      s_p[h * sh.chunk + j] = p;
      l[h] += p;
    }
  block_reduce<G, false>(l, s_red);   // its barriers publish p

  // o = p v over the chunk: a lane's 8 columns of G heads
  float acc[G][8];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[h][e] = 0.f;
  for (int t = n_tiles; t < n_t; ++t) {
    advance(t);
    const T* tile = ring + (t % kStages) * stage;
    const int j0 = (t - n_tiles) * kTileKeys;
    const int rows = min(kTileKeys, n - j0);
    if (active)
      for (int j = warp * kpw + kg; j < rows; j += kWarps * kpw) {
        float x[8];
        load8(tile + j * ld + col, x);
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float p = s_p[h * sh.chunk + j0 + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[h][e] = fmaf(p, x[e], acc[h][e]);
        }
      }
    __syncthreads();
  }
  cp_async_wait<0>();   // only empty groups are left: the ring is free

  // sum over the warp's key groups, then over the warps, in a fixed order;
  // kWarps x G x D floats fit in the ring (at most 128 D bytes against its
  // 256 D or more)
  for (int off = lpk; off < 32; off <<= 1)
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], off);
  float* red = reinterpret_cast<float*>(dec_smem);
  if (kg == 0 && active)
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(warp * G + h) * D + col + e] = acc[h][e];
  __syncthreads();
  const size_t row = (static_cast<size_t>(b) * sh.Hq + h0) * sh.n_chunks + c;
  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D, d = i - h * D;
    float sum = red[h * D + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[(w * G + h) * D + d];
    part_o[(row + static_cast<size_t>(h) * sh.n_chunks) * D + d] = sum;
  }
  if (tid == 0)
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const size_t r = row + static_cast<size_t>(h) * sh.n_chunks;
      part_ml[2 * r] = m[h];
      part_ml[2 * r + 1] = l[h];
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_merge_kernel(const float* __restrict__ part_o,
                              const float* __restrict__ part_ml,
                              const int* __restrict__ n_valid,
                              T* __restrict__ o, Shape sh) {
  bool none;
  const int n_all = valid_keys(n_valid, sh.L, none);
  const int nc = (n_all + sh.chunk - 1) / sh.chunk;   // the chunks written
  const int hq = blockIdx.x, b = blockIdx.y;
  const size_t row = (static_cast<size_t>(b) * sh.Hq + hq) * sh.n_chunks;
  const float* ml = part_ml + 2 * row;
  float mx = -INFINITY;
  for (int c = 0; c < nc; ++c) mx = fmaxf(mx, ml[2 * c]);
  float l = 0.f;
  for (int c = 0; c < nc; ++c) l += expf(ml[2 * c] - mx) * ml[2 * c + 1];
  T* ob = o + (static_cast<size_t>(b) * sh.Hq + hq) * sh.D;
  for (int d = threadIdx.x; d < sh.D; d += kThreads) {
    float acc = 0.f;
    for (int c = 0; c < nc; ++c)
      acc += expf(ml[2 * c] - mx) * part_o[(row + c) * sh.D + d];
    store(ob + d, acc / l);
  }
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, const int* n_valid,
           void* o, float* part_o, float* part_ml, int B, const Shape& sh,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, G>(sh.D, sh.chunk);
  auto kernel = decode_attention_split_kernel<T, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sh.n_chunks, sh.Hkv * sh.groups, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      n_valid, part_o, part_ml, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_merge_kernel<T><<<dim3(sh.Hq, B), kThreads, 0, stream>>>(
      part_o, part_ml, n_valid, static_cast<T*>(o), sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_group(int G, const void* q, const void* k, const void* v,
                 const int* n_valid, void* o, float* part_o, float* part_ml,
                 int B, const Shape& sh, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, 1>(q, k, v, n_valid, o, part_o, part_ml, B, sh, stream);
    case 2: return launch<T, 2>(q, k, v, n_valid, o, part_o, part_ml, B, sh, stream);
    case 3: return launch<T, 3>(q, k, v, n_valid, o, part_o, part_ml, B, sh, stream);
    case 4: return launch<T, 4>(q, k, v, n_valid, o, part_o, part_ml, B, sh, stream);
    case 5: return launch<T, 5>(q, k, v, n_valid, o, part_o, part_ml, B, sh, stream);
    case 6: return launch<T, 6>(q, k, v, n_valid, o, part_o, part_ml, B, sh, stream);
    case 7: return launch<T, 7>(q, k, v, n_valid, o, part_o, part_ml, B, sh, stream);
    case 8: return launch<T, 8>(q, k, v, n_valid, o, part_o, part_ml, B, sh, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the q heads a block serves: the largest divisor of g up to kMaxGroup
int group_of(int g) {
  for (int G = kMaxGroup; G > 1; --G)
    if (g % G == 0) return G;
  return 1;
}

}  // namespace

// C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and o
// alike).  n_valid: one int32 on the device.  q (B, 1, Hq, D) with strides
// q_sb, q_sh (elements; 1 along D); k and v (B, L, Hkv, D) with the strides
// kv_sb, kv_sl, kv_sh (1 along D), both; o (B, 1, Hq, D) contiguous; part:
// float32 scratch of B Hq ceil(L / chunk) (D + 2) elements.  Launches both
// kernels on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 on success).  Anything the kernels do not take (D not a multiple of 8 or
// above 256, Hq not a multiple of Hkv, chunk not 64, 128 or 256, k or v not
// 16-byte aligned in their rows, an empty or too large grid) is refused with
// cudaErrorInvalidValue.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* n_valid,
                                       void* o, void* part, int dtype, int B,
                                       int L, int Hq, int Hkv, int D,
                                       long long q_sb, long long q_sh,
                                       long long kv_sb, long long kv_sl,
                                       long long kv_sh, int chunk,
                                       float sqrt_d, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      D < 8 || D > kMaxD || D % 8 != 0 || (dtype != 0 && dtype != 1) ||
      (chunk != 64 && chunk != 128 && chunk != kMaxChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_unit = dtype == 0 ? 4 : 8;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0 ||
      kv_sb % per_unit != 0 || kv_sl % per_unit != 0 || kv_sh % per_unit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = Hq / Hkv, G = group_of(g);
  Shape sh{L, Hq, Hkv, D, chunk, (L + chunk - 1) / chunk, g / G,
           q_sb, q_sh, kv_sb, kv_sl, kv_sh, sqrt_d};
  if (static_cast<long long>(Hkv) * sh.groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  float* part_o = static_cast<float*>(part);
  float* part_ml = part_o + static_cast<size_t>(B) * Hq * sh.n_chunks * D;
  const int* nv = static_cast<const int*>(n_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_group<float>(G, q, k, v, nv, o, part_o, part_ml, B, sh, s);
  return launch_group<__nv_bfloat16>(G, q, k, v, nv, o, part_o, part_ml, B, sh, s);
}
