// ALS half-step statistics for NVIDIA Hopper (sm_90a): each stats row's
// factors gathered on chip and its normal-equation pieces summed there.
//
// Stands for the JAX package's per-slab statistics,
// predictionio_tpu/ops/als.py `_slab_stats` (an XLA formulation: the
// gather y[idx] and two einsums), whose math the port's plain version,
// ops/als.py `_slab_stats_plain`, runs as index_select + bmm. For each
// row r of one slab (idx, weights, valid [R, W]) and the factors y:
//   implicit:  aw = alpha*w*v,  bw = v + alpha*w*v
//   explicit:  aw = v,          bw = w*v
// (float32, rounded to bf16 and back when the gathers are bf16, as the
// plain version rounds them), then
//   A[r] = sum_j (aw_j*y_j) y_j^T,  b[r] = sum_j bw_j*y_j,  cnt[r] = sum_j v_j
// over the row's W slots, y_j = y[idx[r, j]] widened to float32.
//
// Bound on the card: operations. The math needs each slot's id, weight
// and flag (12 B) and each row's A, b and count written once, while the
// factor rows (3.4 MB of items and 17.7 MB of users at ml20m, rank 32)
// stay in the 50 MB L2; A's lower triangle and b take 2(k(k+1)/2 + k)
// FLOPs a rating: at an ml20m epoch 44.8 GFLOP, 0.67 ms at 67 TFLOP/s
// fp32, against 0.42 ms for the bytes. The formulation it replaces wrote
// the padded [R, W, k] slab to HBM and read it back three times (the
// gather, the weight product, the two bmm): 26 GB and 44 ms an epoch.
//
// Design. One warp for each 32 x 32 block of A's lower block triangle
// (K = 32, 64 or 128, the smallest that holds k: 1, 3 or 10 warps a
// row); the warps of a row walk its slots in chunks of 32, lane s of
// every warp holding slot s's aw, bw and id. Three stages overlap:
// chunk c + 2's ids, weights and flags are read (coalesced) while
// chunk c is summed, and weighed only after; chunk c + 1's factor rows
// go from L2 into registers while chunk c is summed, and then, widened
// to float32, into shared memory (two buffers, row j at j*K, zero past
// k); no warp waits on a load it has just issued. A chunk whose flags
// are all zero (the padding after a row's ratings) is neither read nor
// summed. Lane l of a block's warp owns a 4 x 8 tile of it (rows
// 4(l/4).., columns 8(l%4)..): per slot one float4 of its rows and two
// of its columns from shared memory (a few addresses a warp, so few
// wavefronts), four products t = aw*y_p and 32 FMAs into registers,
// and on a diagonal block four FMAs of b. The blocks then pass through
// shared memory, so every store of A is coalesced: each lower block to
// its place and, mirrored, to the upper triangle, so A is exactly
// symmetric. Sums are float32 FMAs in slot order, the count a fixed
// butterfly: no atomics, and a launch repeats bit for bit.
//
// Measured on an H100 (700 W) at an ml20m epoch's 32 slabs, rank 32:
// 4.31 ms, the bound 15.5 % of it, against 44.4 ms for the formulation
// it replaces. The time follows the instructions a slot issues, not the
// bytes: a lane owning one row of a block (33 shared-memory floats a
// slot, not 12) took 5.13 ms; summing each chunk apart before adding it
// (five times smaller errors, 154 registers) 6.00 ms; five blocks an SM
// (96 registers, spilling) 5.20 ms. A diagonal block still sums its
// upper half, every lane its rows' part of b, and a chunk is summed
// whole past a row's last rating: at rank 32 a little over half of the
// FMAs issued are not needed.
//
// The launcher enqueues on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 32;        // slots a chunk: one a lane
constexpr int kTileStride = 33;   // a block row in shared memory, floats

template <int K>
struct Shape {
  static constexpr int kT = K / 32;                 // blocks a side
  static constexpr int kWarps = kT * (kT + 1) / 2;  // a row's lower blocks
  static constexpr int kRows = K == 32 ? 4 : (K == 64 ? 2 : 1);  // a CTA
  static constexpr int kThreads = kRows * kWarps * 32;
  // slots of a chunk each warp of the row loads
  static constexpr int kLoads = (kChunk + kWarps - 1) / kWarps;
  static constexpr int kBufFloats = 2 * kChunk * K;
  static constexpr int kTileFloats = kWarps * 32 * kTileStride;
  static constexpr int kRowFloats =
      kBufFloats > kTileFloats ? kBufFloats : kTileFloats;
  static constexpr int kMinBlocks = K == 32 ? 4 : (K == 64 ? 3 : 2);
  static_assert(kRows * kRowFloats * 4 <= 48 * 1024, "static shared bytes");
};

template <int kWarps>
__device__ __forceinline__ void row_sync(int group) {
  if constexpr (kWarps == 1) {
    __syncwarp();
  } else {
    // a named barrier for each row's warps (0 is __syncthreads')
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(kWarps * 32)
                 : "memory");
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBf16>
__device__ __forceinline__ float load_y(const void* y, long long at) {
  if constexpr (kBf16) {
    const unsigned short h =
        __ldg(static_cast<const unsigned short*>(y) + at);
    return __uint_as_float(static_cast<unsigned>(h) << 16);  // exact
  } else {
    return __ldg(static_cast<const float*>(y) + at);
  }
}

struct Slots {
  const int* idx;
  const float* w;
  const float* v;
  int width;
  float alpha;
  int implicit;
  int round_w;
};

// lane s's slot of the chunk at `base`, as read: weight, flag and id
// (zeros past the row); the loads are issued here and first used a
// chunk later, so no warp waits on them
struct Raw {
  float w, v;
  int id;
};

__device__ __forceinline__ Raw read_slot(const Slots& in, int base,
                                         int lane) {
  const int j = base + lane;
  if (j >= in.width) return Raw{0.f, 0.f, -1};
  return Raw{__ldg(in.w + j), __ldg(in.v + j), __ldg(in.idx + j)};
}

// the slot's aw and bw, and the id to gather (-1 where the flag is
// zero); true when any slot of the chunk is flagged
__device__ __forceinline__ bool weigh(const Slots& in, const Raw& raw,
                                      int& id, float& aw, float& bw) {
  const float v = raw.v;
  if (in.implicit) {
    aw = __fmul_rn(__fmul_rn(in.alpha, raw.w), v);
    bw = __fadd_rn(v, aw);
  } else {
    aw = v;
    bw = __fmul_rn(raw.w, v);
  }
  if (in.round_w) {
    aw = round_bf16(aw);
    bw = round_bf16(bw);
  }
  id = v != 0.f ? raw.id : -1;
  return __ballot_sync(kFull, v != 0.f) != 0;
}

template <int K, bool kBf16>
__global__ void __launch_bounds__(Shape<K>::kThreads, Shape<K>::kMinBlocks)
als_gramian_kernel(const void* __restrict__ y, long long y_stride,
                   long long y_rows, const int* __restrict__ idx,
                   long long idx_stride, const float* __restrict__ weights,
                   long long w_stride, const float* __restrict__ valid,
                   long long v_stride, int rows, int width, int k,
                   float alpha, int implicit, int round_w,
                   float* __restrict__ a, float* __restrict__ b,
                   float* __restrict__ cnt) {
  using S = Shape<K>;
  constexpr int kT = S::kT;
  constexpr int kW = S::kWarps;
  __shared__ __align__(16) float smem[S::kRows * S::kRowFloats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp / kW;  // the CTA's row
  const int wi = warp % kW;     // the row's warp: its block of A
  const long long r = static_cast<long long>(blockIdx.x) * S::kRows + group;
  if (r >= rows) return;  // the row's warps leave together
  int bi = 0;
  while ((bi + 1) * (bi + 2) / 2 <= wi) ++bi;
  const int bj = wi - bi * (bi + 1) / 2;
  float* base = smem + group * S::kRowFloats;

  const Slots in{idx + r * idx_stride, weights + r * w_stride,
                 valid + r * v_stride, width, alpha, implicit, round_w};
  const int chunks = (width + kChunk - 1) / kChunk;

  // lane l's tile of its block: rows 4tr..4tr+3, columns 8tc..8tc+7
  const int tr = lane >> 2, tc = lane & 3;
  float acc[4][8];
  float bacc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bacc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  float count = 0.f;

  // this warp's share of a chunk's factor rows: slot wi + kW*i, column
  // 32m + lane
  float pre[S::kLoads][kT];
  auto fetch = [&](int id) {
#pragma unroll
    for (int i = 0; i < S::kLoads; ++i) {
      const int s = wi + kW * i;
      const int sid = __shfl_sync(kFull, id, s & 31);
      const bool take = s < kChunk && sid >= 0 && sid < y_rows;
#pragma unroll
      for (int m = 0; m < kT; ++m) {
        const int c = 32 * m + lane;
        pre[i][m] = take && c < k ? load_y<kBf16>(y, sid * y_stride + c)
                                  : 0.f;
      }
    }
  };

  // chunk c's weights (aw, bw, its flags' sum) and factor rows (pre),
  // and chunk c + 1's slots as read
  int id = -1;
  float aw = 0.f, bw = 0.f, v = 0.f;
  bool any = false;
  Raw next{0.f, 0.f, -1};
  if (chunks > 0) {
    const Raw first = read_slot(in, 0, lane);
    any = weigh(in, first, id, aw, bw);
    v = first.v;
    if (any) fetch(id);
    next = read_slot(in, kChunk, lane);
  }
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    const float caw = aw, cbw = bw;
    const bool cany = any;
    float* buf = base + (c & 1) * kChunk * K;
    if (cany) {
#pragma unroll
      for (int i = 0; i < S::kLoads; ++i) {
        const int s = wi + kW * i;
        if (s < kChunk) {
#pragma unroll
          for (int m = 0; m < kT; ++m) buf[s * K + 32 * m + lane] = pre[i][m];
        }
      }
    }
    count += v;
    // the chunk's rows are in place; every warp is past chunk c - 1, so
    // the other buffer is free for chunk c + 1
    row_sync<kW>(group);
    if (c + 1 < chunks) {
      // chunk c + 1's rows, read while chunk c is summed; chunk c + 2's
      // slots, weighed once chunk c is summed
      any = weigh(in, next, id, aw, bw);
      v = next.v;
      if (any) fetch(id);
      next = read_slot(in, (c + 2) * kChunk, lane);
    }
    if (!cany) continue;
#pragma unroll 4
    for (int s = 0; s < kChunk; ++s) {
      const float as = __shfl_sync(kFull, caw, s);
      const float bs = __shfl_sync(kFull, cbw, s);
      const float* row = buf + s * K;
      const float4 yr = *reinterpret_cast<const float4*>(row + 32 * bi +
                                                         4 * tr);
      const float4 c0 = *reinterpret_cast<const float4*>(row + 32 * bj +
                                                         8 * tc);
      const float4 c1 = *reinterpret_cast<const float4*>(row + 32 * bj +
                                                         8 * tc + 4);
      const float yp[4] = {yr.x, yr.y, yr.z, yr.w};
      const float yq[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float t = __fmul_rn(as, yp[i]);
        bacc[i] = fmaf(bs, yp[i], bacc[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(t, yq[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(kFull, count, o);

  // every warp is done with the chunk buffers: the blocks take their place
  row_sync<kW>(group);
  float* tile = base + wi * 32 * kTileStride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      tile[(4 * tr + i) * kTileStride + 8 * tc + j] = acc[i][j];
    }
  }
  __syncwarp();
  float* ar = a + r * k * k;
  const bool diag = bi == bj;
#pragma unroll 4
  for (int rr = 0; rr < 32; ++rr) {
    // lower: row 32bi + rr, column 32bj + lane; on the diagonal block
    // the upper half mirrors the lower
    const int row = 32 * bi + rr, col = 32 * bj + lane;
    const float low = tile[rr * kTileStride + lane];
    const float mirror = tile[lane * kTileStride + rr];
    if (row < k && col < k) {
      ar[row * k + col] = diag && rr < lane ? mirror : low;
    }
    if (!diag) {
      const int row2 = 32 * bj + rr, col2 = 32 * bi + lane;
      if (row2 < k && col2 < k) ar[row2 * k + col2] = mirror;
    }
  }
  if (diag && tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 32 * bi + 4 * tr + i;
      if (p < k) b[r * k + p] = bacc[i];
    }
  }
  if (wi == 0 && lane == 0) cnt[r] = count;
}

template <int K, bool kBf16>
cudaError_t launch(const void* y, long long y_stride, long long y_rows,
                   const int* idx, long long idx_stride, const float* w,
                   long long w_stride, const float* v, long long v_stride,
                   int rows, int width, int k, float alpha, int implicit,
                   int round_w, float* a, float* b, float* cnt,
                   cudaStream_t stream) {
  using S = Shape<K>;
  const unsigned blocks = static_cast<unsigned>((rows + S::kRows - 1) /
                                                S::kRows);
  als_gramian_kernel<K, kBf16><<<blocks, S::kThreads, 0, stream>>>(
      y, y_stride, y_rows, idx, idx_stride, w, w_stride, v, v_stride, rows,
      width, k, alpha, implicit, round_w, a, b, cnt);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t dispatch(const void* y, long long y_stride, long long y_rows,
                     const int* idx, long long idx_stride, const float* w,
                     long long w_stride, const float* v, long long v_stride,
                     int rows, int width, int k, float alpha, int implicit,
                     int round_w, float* a, float* b, float* cnt,
                     cudaStream_t s) {
  if (k <= 32) {
    return launch<32, kBf16>(y, y_stride, y_rows, idx, idx_stride, w,
                             w_stride, v, v_stride, rows, width, k, alpha,
                             implicit, round_w, a, b, cnt, s);
  }
  if (k <= 64) {
    return launch<64, kBf16>(y, y_stride, y_rows, idx, idx_stride, w,
                             w_stride, v, v_stride, rows, width, k, alpha,
                             implicit, round_w, a, b, cnt, s);
  }
  return launch<128, kBf16>(y, y_stride, y_rows, idx, idx_stride, w,
                            w_stride, v, v_stride, rows, width, k, alpha,
                            implicit, round_w, a, b, cnt, s);
}

}  // namespace

extern "C" {

// a[rows, k, k], b[rows, k] and cnt[rows] (float32, contiguous) from one
// slab's idx (int32), weights and valid (float32), each [rows, width]
// with its rows `*_stride` elements apart and contiguous within, and
// the factors y[y_rows, k] (float32, or bf16 when y_bf16 is 1), rows
// y_stride elements apart. An id outside [0, y_rows) reads a zero row:
// the kernel never reads outside y. round_bf16 rounds aw and bw to
// bf16 and back. 1 <= k <= 128, rows >= 1, width >= 0. `device` is the
// CUDA ordinal the tensors and `stream` belong to; the launch is made
// there, and the calling thread's current device is put back before
// returning.
int pio_als_gramian(const void* y, long long y_stride, long long y_rows,
                    int y_bf16, const void* idx, long long idx_stride,
                    const void* weights, long long w_stride,
                    const void* valid, long long v_stride, int rows,
                    int width, int k, float alpha, int implicit,
                    int round_bf16, void* a, void* b, void* cnt, int device,
                    void* stream) {
  if (rows < 1 || width < 0 || k < 1 || k > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto fi = static_cast<const int*>(idx);
  auto fw = static_cast<const float*>(weights);
  auto fv = static_cast<const float*>(valid);
  auto fa = static_cast<float*>(a);
  auto fb = static_cast<float*>(b);
  auto fc = static_cast<float*>(cnt);
  auto s = static_cast<cudaStream_t>(stream);
  if (y_bf16) {
    err = dispatch<true>(y, y_stride, y_rows, fi, idx_stride, fw, w_stride,
                         fv, v_stride, rows, width, k, alpha, implicit,
                         round_bf16, fa, fb, fc, s);
  } else {
    err = dispatch<false>(y, y_stride, y_rows, fi, idx_stride, fw, w_stride,
                          fv, v_stride, rows, width, k, alpha, implicit,
                          round_bf16, fa, fb, fc, s);
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // extern "C"
