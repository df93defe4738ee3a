// Fused dot-product score + top-k for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel predictionio_tpu/ops/pallas_topk.py
// (`_topk_kernel` + `_merge_block`, reached through `fused_top_k_dot`):
// for each query row, the `num` items with the largest q . item, without
// ever writing the [B, I] score matrix to device memory. One source, three
// item types: float32, bfloat16 (upcast on load) and int8 with a per-row
// float32 scale applied after the dot.
//
// Bound on the card: the item table is read once (I*k*itemsize bytes) and
// 2*B*I*k fp32 operations are done on CUDA cores (no TF32: the contract is
// fp32 FMA). At I = 1,048,576, k = 32 the table is 128 MiB (f32), 3.35 TB/s
// gives 40 us; B = 64 is 4.3 GFLOP, 64 us at 67 TFLOP/s fp32.
//
// Design. The TPU grid walks item blocks in order on one core and carries
// the best-list in VMEM; Hopper runs blocks in parallel and in no order, so
// the work splits in two passes:
//   pass 1, grid (query tile x item split): each block scores its item range
//     against a tile of QT queries (1, 2, 4 or 8, the smallest that covers
//     the batch up to 8; fp32 FMA, k-sequential sums) and keeps one
//     top-`num` list per query in shared memory. Each thread scores one
//     item row against the whole tile, so a row is read once per tile; the
//     tile's queries sit in shared memory as [k][QT], so one 16-byte load
//     gives the values of one element for four queries. Pass 1 writes
//     [B, splits, num] partial lists to scratch the caller allocates.
//   pass 2, one block per query: merges the splits' lists into [B, num].
// Both passes keep their lists the same way: a candidate whose key beats the
// list's current k-th best is appended to a buffer behind the list (room
// for at least one chunk of 256 candidates); a buffer that could not take
// another chunk is folded in by a bitonic sort of (list + buffer) in
// shared memory.
// Ranking is by one 64-bit key: the order-preserving bits of the float score
// above the complement of the item index, so equal scores rank the lower
// index first (lax.top_k's order) across splits too. NaN and masked scores
// are never inserted (they rank as -inf); a slot that never fills stays key
// 0 and decodes to score -inf, index 0, as the TPU kernel leaves it.
// A list lives in shared memory, so a call ranks at most 1024 per round:
// a larger `num` runs further rounds, each bounded above by the last key
// the round before produced (`upper`).
//
// Each launcher enqueues on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;   // threads per block; items per pass-1 chunk
constexpr int kMaxTile = 8;     // most queries scored together in one block

__device__ __forceinline__ u64 make_key(float s, int idx) {
  s = __fadd_rn(s, 0.0f);  // -0.0 ranks with +0.0, then by index
  uint32_t b = __float_as_uint(s);
  uint32_t u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<u64>(u) << 32) |
         static_cast<u64>(0xFFFFFFFFu - static_cast<uint32_t>(idx));
}

__device__ __forceinline__ void decode_key(u64 key, float* s, int* idx) {
  if (key == 0ull) {
    *s = -INFINITY;
    *idx = 0;
    return;
  }
  uint32_t u = static_cast<uint32_t>(key >> 32);
  uint32_t b = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  *s = __uint_as_float(b);
  *idx = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

// `lists` top-`num` lists in shared memory, list l at region[l*R, l*R+R):
// [0, num) the best keys sorted descending (0 = empty slot), then
// cnt[l] unmerged candidates, then zeros. R is a power of two.
struct TopLists {
  u64* region;
  int* cnt;
  u64* thr;  // key of each list's num-th entry: a candidate must beat it
  int lists;
  int R;
  int num;

  __device__ void init() {
    for (int t = threadIdx.x; t < lists * R; t += blockDim.x) region[t] = 0ull;
    if (threadIdx.x < lists) {
      cnt[threadIdx.x] = 0;
      thr[threadIdx.x] = 0ull;
    }
  }

  __device__ __forceinline__ void offer(int l, u64 key) {
    if (key > thr[l]) {
      int pos = atomicAdd(&cnt[l], 1);
      region[static_cast<size_t>(l) * R + num + pos] = key;
    }
  }

  // true when some buffer could not take one more chunk; read by every
  // thread, then a barrier so no thread offers before all have read
  __device__ bool must_fold(int chunk) {
    bool full = false;
    for (int l = 0; l < lists; ++l) full |= cnt[l] > R - num - chunk;
    __syncthreads();
    return full;
  }

  __device__ bool pending() {
    bool any = false;
    for (int l = 0; l < lists; ++l) any |= cnt[l] > 0;
    __syncthreads();
    return any;
  }

  // bitonic sort of every whole region, descending; keep the top num
  __device__ void fold() {
    const int half = R >> 1;
    for (int size = 2; size <= R; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = threadIdx.x; t < lists * half; t += blockDim.x) {
          int l = t / half;
          int p = t - l * half;
          int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
          int j = i + stride;
          u64* r = region + static_cast<size_t>(l) * R;
          u64 a = r[i], b = r[j];
          bool desc = (i & size) == 0;
          if (desc ? (a < b) : (a > b)) {
            r[i] = b;
            r[j] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int t = threadIdx.x; t < lists * R; t += blockDim.x) {
      if (t % R >= num) region[t] = 0ull;
    }
    if (threadIdx.x < lists) {
      cnt[threadIdx.x] = 0;
      thr[threadIdx.x] = region[static_cast<size_t>(threadIdx.x) * R + num - 1];
    }
    __syncthreads();
  }
};

// The QT query values of element c (qs is laid out [k][QT]), as vector
// shared-memory loads: one 16-byte load feeds four FMAs.
template <int QT>
__device__ __forceinline__ void load_q(const float* qs, int c, float* qv) {
  const float* p = qs + c * QT;
  if constexpr (QT % 4 == 0) {
#pragma unroll
    for (int l = 0; l < QT; l += 4) {
      float4 v = *reinterpret_cast<const float4*>(p + l);
      qv[l] = v.x;
      qv[l + 1] = v.y;
      qv[l + 2] = v.z;
      qv[l + 3] = v.w;
    }
  } else if constexpr (QT == 2) {
    float2 v = *reinterpret_cast<const float2*>(p);
    qv[0] = v.x;
    qv[1] = v.y;
  } else {
    qv[0] = p[0];
  }
}

template <typename T, int QT>
__device__ __forceinline__ void fma_element(const float* qs, int c, T v,
                                            float* acc) {
  float qv[QT];
  load_q<QT>(qs, c, qv);
  const float x = to_f32<T>(v);
#pragma unroll
  for (int l = 0; l < QT; ++l) acc[l] = fmaf(qv[l], x, acc[l]);
}

template <typename T, int QT>
__global__ void __launch_bounds__(kThreads)
    topk_pass1(const float* __restrict__ q, const T* __restrict__ items,
               const float* __restrict__ scale,
               const uint8_t* __restrict__ mask, int mask_kind,
               const u64* __restrict__ upper, u64* __restrict__ partial,
               int B, int I, int k, int num, int R, int split_len, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  // one list per query of the tile; a batch smaller than the tile (B < QT)
  // allocates only B lists
  const int lists = min(QT, B);
  u64* region = reinterpret_cast<u64*>(smem);
  float* qs = reinterpret_cast<float*>(region + static_cast<size_t>(lists) * R);
  __shared__ int cnt[kMaxTile];
  __shared__ u64 thr[kMaxTile];
  __shared__ u64 ub[kMaxTile];

  const int b0 = blockIdx.x * QT;
  const int nq = min(QT, B - b0);
  const int split = blockIdx.y;
  const int start = split * split_len;
  const int end = min(I, start + split_len);

  TopLists top{region, cnt, thr, nq, R, num};
  top.init();
  for (int t = threadIdx.x; t < QT * k; t += blockDim.x) {
    const int c = t / QT;
    const int l = t - c * QT;
    qs[t] = l < nq ? q[static_cast<size_t>(b0 + l) * k + c] : 0.0f;
  }
  if (threadIdx.x < QT) {
    int l = threadIdx.x;
    ub[l] = (upper != nullptr && l < nq) ? upper[b0 + l] : ~0ull;
  }
  __syncthreads();

  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  for (int base = start; base < end; base += kThreads) {
    const int i = base + threadIdx.x;
    if (i < end) {
      float acc[QT];
#pragma unroll
      for (int l = 0; l < QT; ++l) acc[l] = 0.0f;
      const T* row = items + static_cast<size_t>(i) * k;
      if (vec) {
        for (int c0 = 0; c0 < k; c0 += E) {
          uint4 raw = *reinterpret_cast<const uint4*>(row + c0);
          const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < E; ++e)
            fma_element<T, QT>(qs, c0 + e, v[e], acc);
        }
      } else {
        for (int c = 0; c < k; ++c) fma_element<T, QT>(qs, c, row[c], acc);
      }
      const bool item_masked = mask_kind == 1 && mask[i] != 0;
      const float sc = scale != nullptr ? scale[i] : 1.0f;
#pragma unroll
      for (int l = 0; l < QT; ++l) {
        if (l >= nq) break;
        float s = scale != nullptr ? acc[l] * sc : acc[l];
        // NaN (corrupt factors) and masked items rank as -inf: never kept
        if (isnan(s) || s == -INFINITY || item_masked) continue;
        if (mask_kind == 2 && mask[static_cast<size_t>(b0 + l) * I + i] != 0)
          continue;
        u64 key = make_key(s, i);
        if (key < ub[l]) top.offer(l, key);
      }
    }
    __syncthreads();
    if (top.must_fold(kThreads)) top.fold();
  }
  if (top.pending()) top.fold();

  const int splits = gridDim.y;
  for (int t = threadIdx.x; t < nq * num; t += blockDim.x) {
    int l = t / num;
    int j = t - l * num;
    partial[(static_cast<size_t>(b0 + l) * splits + split) * num + j] =
        region[static_cast<size_t>(l) * R + j];
  }
}

__global__ void __launch_bounds__(kThreads)
    topk_pass2(const u64* __restrict__ partial, int splits, int num, int R,
               float* __restrict__ out_s, int* __restrict__ out_i,
               int out_stride, int col_off, u64* __restrict__ bound) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* region = reinterpret_cast<u64*>(smem);
  __shared__ int cnt[1];
  __shared__ u64 thr[1];
  const int b = blockIdx.x;

  TopLists top{region, cnt, thr, 1, R, num};
  top.init();
  __syncthreads();
  const u64* src = partial + static_cast<size_t>(b) * splits * num;
  const int total = splits * num;
  for (int base = 0; base < total; base += kThreads) {
    const int t = base + threadIdx.x;
    if (t < total) {
      u64 key = src[t];
      if (key != 0ull) top.offer(0, key);
    }
    __syncthreads();
    if (top.must_fold(kThreads)) top.fold();
  }
  if (top.pending()) top.fold();

  for (int j = threadIdx.x; j < num; j += blockDim.x) {
    float s;
    int idx;
    decode_key(region[j], &s, &idx);
    out_s[static_cast<size_t>(b) * out_stride + col_off + j] = s;
    out_i[static_cast<size_t>(b) * out_stride + col_off + j] = idx;
  }
  if (threadIdx.x == 0 && bound != nullptr) bound[b] = region[num - 1];
}

template <typename T, int QT>
cudaError_t launch_pass1_tile(const float* q, const void* items,
                              const float* scale, const uint8_t* mask,
                              int mask_kind, const u64* upper, u64* partial,
                              int B, int I, int k, int num, int R,
                              int split_len, int splits, int vec,
                              cudaStream_t stream) {
  const int lists = B < QT ? B : QT;
  const size_t smem = static_cast<size_t>(lists) * R * sizeof(u64) +
                      static_cast<size_t>(QT) * k * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1<T, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((B + QT - 1) / QT, splits);
  topk_pass1<T, QT><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(items), scale, mask, mask_kind, upper, partial,
      B, I, k, num, R, split_len, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pass1(int qt, const float* q, const void* items,
                         const float* scale, const uint8_t* mask,
                         int mask_kind, const u64* upper, u64* partial, int B,
                         int I, int k, int num, int R, int split_len,
                         int splits, int vec, cudaStream_t stream) {
  switch (qt) {
    case 1:
      return launch_pass1_tile<T, 1>(q, items, scale, mask, mask_kind, upper,
                                     partial, B, I, k, num, R, split_len,
                                     splits, vec, stream);
    case 2:
      return launch_pass1_tile<T, 2>(q, items, scale, mask, mask_kind, upper,
                                     partial, B, I, k, num, R, split_len,
                                     splits, vec, stream);
    case 4:
      return launch_pass1_tile<T, 4>(q, items, scale, mask, mask_kind, upper,
                                     partial, B, I, k, num, R, split_len,
                                     splits, vec, stream);
    case 8:
      return launch_pass1_tile<T, 8>(q, items, scale, mask, mask_kind, upper,
                                     partial, B, I, k, num, R, split_len,
                                     splits, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// qt: queries per pass-1 block (1, 2, 4 or 8). dtype: 0 float32, 1
// bfloat16, 2 int8. mask_kind: 0 none, 1 [I], 2 [B, I] (uint8, nonzero =
// exclude). scale, mask and upper may be null. partial: [B, splits, num]
// keys. vec: 1 when every item row starts on a 16-byte boundary and
// k * itemsize is a multiple of 16.
int pio_topk_pass1(int qt, const float* q, const void* items, int dtype,
                   const float* scale, const uint8_t* mask, int mask_kind,
                   const u64* upper, u64* partial, int B, int I, int k,
                   int num, int R, int split_len, int splits, int vec,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_pass1<float>(qt, q, items, scale, mask, mask_kind, upper,
                                 partial, B, I, k, num, R, split_len, splits,
                                 vec, s);
    case 1:
      return launch_pass1<__nv_bfloat16>(qt, q, items, scale, mask,
                                         mask_kind, upper, partial, B, I, k,
                                         num, R, split_len, splits, vec, s);
    case 2:
      return launch_pass1<int8_t>(qt, q, items, scale, mask, mask_kind, upper,
                                  partial, B, I, k, num, R, split_len, splits,
                                  vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Merges partial [B, splits, num] into out_s / out_i columns
// [col_off, col_off + num) of rows of out_stride; bound (may be null)
// receives each row's last key, the exclusive upper bound of a next round.
int pio_topk_pass2(const u64* partial, int B, int splits, int num, int R,
                   float* out_s, int* out_i, int out_stride, int col_off,
                   u64* bound, void* stream) {
  const size_t smem = static_cast<size_t>(R) * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass2, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_pass2<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      partial, splits, num, R, out_s, out_i, out_stride, col_off, bound);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
