// ALS heavy sums for NVIDIA Hopper (sm_90a): one heavy group's sub-row
// statistics added into their owners' slots, pairwise, in one launch.
//
// Stands for the JAX package's heavy-row scatter-add,
// predictionio_tpu/ops/als.py `_assemble_and_solve` (`ha.at[local].add(ga)`,
// `hb...`, `hcnt...`: an XLA scatter, summed in no fixed order), in the
// fixed order the port's plain version, ops/als.py `_heavy_add_plain`,
// adds in. A group's gather-Gramian gave each sub-row r its stats ga[r]
// (k x k), gb[r] (k) and gcnt[r]; its plan (ops/als.py `HeavyOrder`) gives
// each owner slot its padded width W (a power of two) and W members: the
// slot's sub-rows in ascending order, then the zero row (any member at or
// past the group's row count). For every column c of the packed stats row
// (A's k*k, then b's k, then the count):
//   total = the members' values added pairwise, level by level
//           (m0+m1, m2+m3, then those sums, ...)
//   acc[slot][c] = acc[slot][c] + total
// Float32 adds alone, in the plain version's order, with no FMA and no
// atomics (a group holds each slot once), so the sums are its bits, and
// a launch repeats bit for bit. A zero row's member adds +0.0, as the
// plain version's appended zero row does.
//
// Bound on the card: bytes. Each sub-row's stats row is read once
// (k*k + k + 1 floats, 4,228 B at rank 32) and each slot's acc row read
// and written once: 0.1 GB and ~0.04 ms an ml20m epoch at 3.35 TB/s. The
// torch formulation it replaces took a cat of the three outputs, a zero
// row, and per bucket of equal widths an index_select, log2(W) strided
// adds, an index_select, an add and an index_put: 269 launches an ml20m
// epoch (12 groups, 33 buckets, 101 levels), whose host enqueue paced
// the epoch.
//
// Design. One block per (slot, tile of columns): a member's row is read
// coalesced across the block's columns. A slot's W members split into P
// parts of W/P (P, a power of two, from the group's widest slot: one
// part per 128 members, up to 32; P = 1 for every group of an ml20m
// epoch), each an aligned subtree of the pairwise tree, summed by its own
// threads: 128 columns a block at P = 1, 64 at P = 2, 32 above (the
// block 32·P threads). Within a part, members are read eight at a time,
// all eight loads in flight at once (a part of 1, 2 or 4 is read whole
// and summed as its tree), and the eight summed as their three-level
// tree; above that the tree is a binary counter: batch b's total climbs
// one level for each trailing one bit of b, added to the partial sum
// waiting there, and waits at the first zero bit. With W a power of two
// this pairs exactly as the level-by-level loop does, the last batch's
// climb ending with the part's total; the parts' totals are then added
// level by level in shared memory, the top of the same tree. A slot
// narrower than P members takes one part a member. The chain a thread
// walks is so at most 16 batches for W up to 4,096: the card's latency
// per batch, not the width, sets a launch's length.
//
// The launcher enqueues on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 8;      // members read before any is added
constexpr int kLevels = 28;    // a width up to 2^30: batches climb 27 levels
constexpr int kMaxParts = 32;  // parts a slot splits into, at most

// columns a block: 128 threads at P <= 4, 32 columns at P >= 4
constexpr int tile_columns(int parts) {
  return parts >= 4 ? 32 : 128 / parts;
}

// the pairwise sum of `width` (a power of two) members from `mine`, one
// column: `src` at the column, `stride` between sub-rows; a member at
// or past `rows` (or below 0) is the zero row
__device__ __forceinline__ float subtree(const float* __restrict__ src,
                                         long long stride, int rows,
                                         const int* __restrict__ mine,
                                         int width) {
  auto value = [&](int m) {
    const int r = __ldg(mine + m);
    return r >= 0 && r < rows ? __ldg(src + r * stride) : 0.f;
  };
  if (width < kBatch) {
    // 1, 2 or 4 members: their tree at once
    float v[kBatch / 2];
#pragma unroll
    for (int j = 0; j < kBatch / 2; ++j) v[j] = j < width ? value(j) : 0.f;
    return width == 1   ? v[0]
           : width == 2 ? __fadd_rn(v[0], v[1])
                        : __fadd_rn(__fadd_rn(v[0], v[1]),
                                    __fadd_rn(v[2], v[3]));
  }
  // eight members at a time: their tree of three levels, whose total
  // climbs the counter from level 3
  float wait[kLevels];  // wait[l]: a partial sum of 8 * 2^l members
  float x = 0.f;
#pragma unroll 1
  for (int b = 0; b < width / kBatch; ++b) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = value(kBatch * b + j);
    x = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                  __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      if (!((b >> l) & 1)) {
        wait[l] = x;
        break;
      }
      x = __fadd_rn(wait[l], x);
    }
  }
  return x;
}

// threadIdx.x: the column in the block's tile; threadIdx.y: the part
__global__ void __launch_bounds__(kMaxParts * 32)
als_heavy_add_kernel(const float* __restrict__ ga, long long ga_stride,
                     const float* __restrict__ gb, long long gb_stride,
                     const float* __restrict__ gcnt, long long gcnt_stride,
                     int rows, int k, const int* __restrict__ plan,
                     const int* __restrict__ members,
                     float* __restrict__ acc, long long acc_stride) {
  __shared__ float partial[kMaxParts][32];
  const int kk = k * k;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const int* entry = plan + 3 * static_cast<long long>(blockIdx.x);
  const int slot = __ldg(entry);
  const int width = __ldg(entry + 1);
  const int parts = min(static_cast<int>(blockDim.y), width);
  const int part = threadIdx.y;
  const bool mine = c <= kk + k && part < parts;
  float x = 0.f;
  if (mine) {
    // column c of a sub-row's packed stats: A, then b, then the count
    const float* src;
    long long stride;
    if (c < kk) {
      src = ga + c;
      stride = ga_stride;
    } else if (c < kk + k) {
      src = gb + (c - kk);
      stride = gb_stride;
    } else {
      src = gcnt;
      stride = gcnt_stride;
    }
    const int size = width / parts;
    x = subtree(src, stride, rows, members + __ldg(entry + 2) + part * size,
                size);
  }
  if (blockDim.y > 1) {
    // the parts' totals, added level by level: the top of the tree
    // (blockDim.y > 1 only where the tile is 32 or 64 columns wide)
    float* col = &partial[0][0] + threadIdx.x;
    const int pitch = blockDim.x;
    if (mine) col[part * pitch] = x;
    __syncthreads();
    if (part != 0) return;
    for (int step = 1; step < parts; step <<= 1) {
      for (int i = 0; i < parts; i += 2 * step) {
        col[i * pitch] = __fadd_rn(col[i * pitch], col[(i + step) * pitch]);
      }
    }
    x = col[0];
  }
  if (mine) {
    float* out = acc + slot * acc_stride + c;
    *out = __fadd_rn(*out, x);
  }
}

}  // namespace

extern "C" {

// acc[slot, :] += the pairwise sum of each planned slot's members, for one
// heavy group: ga[rows, k, k], gb[rows, k] and gcnt[rows] (float32, each
// sub-row `*_stride` elements from the next and contiguous within);
// plan[n_slots, 3] int32 rows (slot, padded width, offset into members);
// members int32, a member at or past `rows` (or below 0) the zero row;
// acc[.., k*k + k + 1] float32, rows acc_stride elements apart. Each slot
// appears once in the plan; every width is a power of two. `parts`: the
// parts each slot's members split into (1, 2, 4, 8, 16 or 32). 1 <= k <=
// 128, n_slots >= 1. `device` is the CUDA ordinal the tensors and
// `stream` belong to; the launch is made there, and the calling thread's
// current device is put back before returning.
int pio_als_heavy_add(const void* ga, long long ga_stride, const void* gb,
                      long long gb_stride, const void* gcnt,
                      long long gcnt_stride, int rows, int k,
                      const void* plan, int n_slots, const void* members,
                      int parts, void* acc, long long acc_stride, int device,
                      void* stream) {
  if (n_slots < 1 || rows < 0 || k < 1 || k > 128 || parts < 1 ||
      parts > kMaxParts || (parts & (parts - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int cols = k * k + k + 1;
  const int tile = tile_columns(parts);
  const dim3 grid(static_cast<unsigned>(n_slots),
                  static_cast<unsigned>((cols + tile - 1) / tile));
  const dim3 block(static_cast<unsigned>(tile), static_cast<unsigned>(parts));
  als_heavy_add_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ga), ga_stride,
      static_cast<const float*>(gb), gb_stride,
      static_cast<const float*>(gcnt), gcnt_stride, rows, k,
      static_cast<const int*>(plan), static_cast<const int*>(members),
      static_cast<float*>(acc), acc_stride);
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // extern "C"
