// Batched SPD solve of ALS's normal equations for NVIDIA Hopper (sm_90a).
//
// Stands for the JAX package's TPU formulation of the solve,
// predictionio_tpu/ops/als.py `_chol_solve_batched` (an unrolled
// Cholesky-Crout over the batch), whose math the port's plain version,
// ops/als.py `_solve_plain`, runs as torch.linalg.cholesky_ex +
// torch.cholesky_solve. For each system r of the batch:
//   implicit:  A = (a[r] + yty) + lam*I
//   explicit:  A = a[r] + (lam*max(cnt[r], 1))*I
// (float32, in that order: the plain version's operations), then
// A = L*L^T from A's lower triangle (the triangle cholesky_ex reads),
// L*y = b[r] and L^T*x[r] = y. A system with a pivot that is not
// positive or not finite (what makes cholesky_ex's info nonzero) solves
// to zeros; otherwise each non-finite element of x[r] becomes 0.
//
// Bound on the card: bytes. A system at k = 32 needs 2.1 KB of a (the
// lower triangle, all that this kernel and cholesky_ex read, of its
// 4 KB) plus 256 B of b and x, against k^3/3 + 2k^2 = 13 kFLOP: the
// 165,237 systems of an ml20m epoch are 0.39 GB, 0.117 ms at 3.35 TB/s,
// and 2.1 GFLOP, 0.03 ms at 67 TFLOP/s fp32. The library path it replaces (MAGMA's batched
// potrf/potrs under cholesky_ex / cholesky_solve) allocated and
// synchronised the stream on every call, which left the card idle while
// the host waited.
//
// Design. One warp a system, kWarps systems a block; the regularised
// matrix and its factor live in shared memory and registers only, x is
// the one write, and the launch allocates nothing and never
// synchronises. The matrix is kept as its lower 32 x 32 tiles, each row
// padded to 33 floats so that a warp reading a tile's row or its column
// hits 32 distinct banks. Rows and columns past k hold the identity,
// so one code serves every k up to K (K = 32, 64 or 128, the smallest
// that holds k).
//   load: lane c reads column c of each row (one coalesced read a row,
//     the lower triangle only; a tile's 32 reads all in flight), then
//     adds yty and the diagonal term and stores the tile element;
//   factor, tile by tile (right-looking, blocked): lane i holds row i of
//     the diagonal tile in registers and factors it with shuffles (step
//     j: the pivot from lane j, l_ij = a_ij * (1/d_j), then every
//     a_ic -= l_ij * l_cj, l_cj shuffled from lane c); each tile below
//     solves x * L_pp^T = a with L_pp's entries shuffled from the
//     registers that hold them; then the trailing tiles take their
//     updates from shared memory. Each element's updates are subtracted
//     in ascending j, as in the unblocked algorithm. 1/d_j goes to
//     shared memory for the solves;
//   solve: y and then x live one element a lane (a register per tile);
//     at step j lane j scales its element, one shuffle hands it to every
//     lane, and each lane subtracts its L entry (a column read for
//     L*y = b, a row read for L^T*x = y).
// At K = 32 the block is 8 warps held to 64 registers a thread, so four
// blocks (32 systems) share an SM. Measured on an H100 at an ml20m
// epoch's 165,237 systems in one launch, the time follows the warps in
// flight and the reads each has outstanding, not the HBM bytes: at 80
// registers (three blocks) 1.33 ms, at 64 1.04 ms, and 0.76 ms once a
// warp's 32 row reads all go out before the first is used. In the
// epoch's 22 launches the same systems take 1.13 ms: the launches of a
// few thousand systems or fewer take about 20 us each, one system's
// latency. A variant with two systems a warp (width-16 shuffles, half
// as many a system) took 0.86 ms against 1.04 in one launch but read no
// faster in the epoch, so this kernel keeps one system a warp.
// Every sum is fp32 FMA in a fixed order with no atomics (sqrt and
// division IEEE-rounded), so a launch repeats bit for bit.
//
// The launcher enqueues on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;                     // a tile's rows: one a lane
constexpr int kStride = kTile + 1;            // a padded tile row, floats
constexpr int kTileFloats = kTile * kStride;
constexpr int kStaticSmem = 48 * 1024;        // static shared bytes a block
constexpr int kMaxWarps = 8;

template <int K>
struct Shape {
  static constexpr int kT = K / kTile;  // tiles a side
  // a warp's lower tiles and its inverse pivots
  static constexpr int kWarpFloats = kT * (kT + 1) / 2 * kTileFloats + K;
  static constexpr int kFit = kStaticSmem / (kWarpFloats * 4);
  static constexpr int kWarps = kFit < kMaxWarps ? kFit : kMaxWarps;
  // at K = 32, four blocks an SM: registers capped at 64 a thread
  static constexpr int kMinBlocks = kT == 1 ? 4 : 1;
  static_assert(K % kTile == 0 && kWarps >= 1, "a warp's tiles must fit");
};

__device__ __forceinline__ int tile_at(int i, int j) {  // lower: i >= j
  return (i * (i + 1) / 2 + j) * kTileFloats;
}

// Right-looking Cholesky of one diagonal tile held a row a lane in `l`
// (upper part zero): l becomes L's row, dinv[j] = 1 / L[j][j]; true
// when a pivot is not positive or not finite. Step j takes its pivot
// from lane j and hands each lane c's l_cj to every lane by shuffle.
__device__ __forceinline__ bool factor_tile(float (&l)[kTile], float* dinv,
                                            int lane) {
  bool bad = false;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const float piv = __shfl_sync(kFull, l[j], j);
    bad |= !(piv > 0.f && piv < INFINITY);
    const float d = sqrtf(piv);
    const float inv = 1.f / d;
    if (lane == j) dinv[j] = inv;
    const float lj = lane > j ? l[j] * inv : (lane == j ? d : 0.f);
    l[j] = lj;
#pragma unroll
    for (int c = j + 1; c < kTile; ++c) {
      l[c] = fmaf(-lj, __shfl_sync(kFull, lj, c), l[c]);
    }
  }
  return bad;
}

template <int K>
__global__ void __launch_bounds__(Shape<K>::kWarps * 32, Shape<K>::kMinBlocks)
als_solve_kernel(const float* __restrict__ a, long long a_stride,
                 const float* __restrict__ b, long long b_stride,
                 const float* __restrict__ cnt, long long cnt_stride,
                 const float* __restrict__ yty, float lam, int implicit,
                 float* __restrict__ x, int rows, int k) {
  constexpr int T = Shape<K>::kT;
  __shared__ float smem[Shape<K>::kWarps][Shape<K>::kWarpFloats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r =
      static_cast<long long>(blockIdx.x) * Shape<K>::kWarps + warp;
  if (r >= rows) return;  // the whole warp leaves together
  float* s = smem[warp];
  float* dinv = s + T * (T + 1) / 2 * kTileFloats;
  const float* ar = a + r * a_stride;

  float diag_add = lam;
  if (!implicit) {
    // lam * max(n, 1) rounded before the add, as the plain version
    // rounds it; a NaN count stays NaN, as clamp keeps it
    const float n = cnt[r * cnt_stride];
    diag_add = __fmul_rn(lam, n < 1.f ? 1.f : n);
  }

  // load: the lower triangle, regularised; the identity past k
#pragma unroll
  for (int ti = 0; ti < T; ++ti) {
#pragma unroll
    for (int tj = 0; tj <= ti; ++tj) {
      float* tile = s + tile_at(ti, tj);
      const int c = tj * kTile + lane;
      // every row's read in flight before the first is used: one at a
      // time, a warp would wait out the memory's latency 32 times
      float v[kTile];
#pragma unroll
      for (int rr = 0; rr < kTile; ++rr) {
        const int row = ti * kTile + rr;
        v[rr] = row < k && c <= row
                    ? ar[static_cast<long long>(row) * k + c] : 0.f;
      }
      asm volatile("" ::: "memory");
#pragma unroll
      for (int rr = 0; rr < kTile; ++rr) {
        const int row = ti * kTile + rr;
        float e = row == c ? 1.f : 0.f;
        if (row < k && c <= row) {
          e = v[rr];
          if (implicit) e = __fadd_rn(e, __ldg(yty + row * k + c));
          if (c == row) e = __fadd_rn(e, diag_add);
        }
        tile[rr * kStride + lane] = e;
      }
    }
  }
  __syncwarp();

  bool bad = false;
#pragma unroll 1
  for (int p = 0; p < T; ++p) {
    float* diag = s + tile_at(p, p);
    float l[kTile];
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      l[c] = c <= lane ? diag[lane * kStride + c] : 0.f;
    }
    bad |= factor_tile(l, dinv + p * kTile, lane);
#pragma unroll
    for (int c = 0; c < kTile; ++c) diag[lane * kStride + c] = l[c];
    __syncwarp();

    // the tiles below: v * L_pp^T = a, row by row (lane m holds L_pp[m])
#pragma unroll 1
    for (int i = p + 1; i < T; ++i) {
      float* pan = s + tile_at(i, p) + lane * kStride;
      float v[kTile];
#pragma unroll
      for (int c = 0; c < kTile; ++c) v[c] = pan[c];
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        v[c] *= dinv[p * kTile + c];
#pragma unroll
        for (int m = c + 1; m < kTile; ++m) {
          v[m] = fmaf(-v[c], __shfl_sync(kFull, l[c], m), v[m]);
        }
      }
#pragma unroll
      for (int c = 0; c < kTile; ++c) pan[c] = v[c];
    }
    __syncwarp();

    // the trailing tiles: A_ij -= L_ip * L_jp^T
#pragma unroll 1
    for (int i = p + 1; i < T; ++i) {
      const float* lip = s + tile_at(i, p) + lane * kStride;
#pragma unroll 1
      for (int j = p + 1; j <= i; ++j) {
        const float* ljp = s + tile_at(j, p);
        float* aij = s + tile_at(i, j) + lane * kStride;
        float acc[kTile];
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[c] = aij[c];
#pragma unroll 1
        for (int m = 0; m < kTile; ++m) {
          const float lim = lip[m];
#pragma unroll
          for (int c = 0; c < kTile; ++c) {
            acc[c] = fmaf(-lim, ljp[c * kStride + m], acc[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < kTile; ++c) aij[c] = acc[c];
      }
    }
    __syncwarp();
  }

  // L*y = b, then L^T*x = y; lane i holds element 32t + i in y[t] and
  // its inverse pivot in inv[t]: lane j scales its own element, one
  // shuffle hands it to every lane
  const float* br = b + r * b_stride;
  float y[T], inv[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int row = t * kTile + lane;
    y[t] = row < k ? br[row] : 0.f;
    inv[t] = dinv[row];
  }
#pragma unroll
  for (int jt = 0; jt < T; ++jt) {
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      const float yj = __shfl_sync(kFull, y[jt] * inv[jt], jj);
      if (lane == jj) y[jt] = yj;
#pragma unroll
      for (int t = jt; t < T; ++t) {
        if (t > jt || lane > jj) {
          y[t] = fmaf(-s[tile_at(t, jt) + lane * kStride + jj], yj, y[t]);
        }
      }
    }
  }
#pragma unroll
  for (int jt = T - 1; jt >= 0; --jt) {
#pragma unroll
    for (int jj = kTile - 1; jj >= 0; --jj) {
      const float xj = __shfl_sync(kFull, y[jt] * inv[jt], jj);
      if (lane == jj) y[jt] = xj;
#pragma unroll
      for (int t = 0; t <= jt; ++t) {
        if (t < jt || lane < jj) {
          y[t] = fmaf(-s[tile_at(jt, t) + jj * kStride + lane], xj, y[t]);
        }
      }
    }
  }

  float* xr = x + r * k;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int row = t * kTile + lane;
    if (row < k) xr[row] = (bad || !(fabsf(y[t]) < INFINITY)) ? 0.f : y[t];
  }
}

template <int K>
cudaError_t launch(const float* a, long long a_stride, const float* b,
                   long long b_stride, const float* cnt, long long cnt_stride,
                   const float* yty, float lam, int implicit, float* x,
                   int rows, int k, cudaStream_t stream) {
  constexpr int W = Shape<K>::kWarps;
  const unsigned blocks = static_cast<unsigned>((rows + W - 1) / W);
  als_solve_kernel<K><<<blocks, W * 32, 0, stream>>>(
      a, a_stride, b, b_stride, cnt, cnt_stride, yty, lam, implicit, x,
      rows, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x[rows, k] (contiguous) from a[rows, k, k], b[rows, k] and cnt[rows],
// each system `*_stride` floats after the one before and contiguous
// within; yty[k, k] contiguous, or null when `implicit` is 0 (cnt is read
// only then). 1 <= k <= 128, rows >= 1. `device` is the CUDA ordinal the
// tensors and `stream` belong to; the launch is made there, and the
// calling thread's current device is put back before returning.
int pio_als_solve(const void* a, long long a_stride, const void* b,
                  long long b_stride, const void* cnt, long long cnt_stride,
                  const void* yty, float lam, int implicit, void* x, int rows,
                  int k, int device, void* stream) {
  if (rows < 1 || k < 1 || k > 128 || (implicit && yty == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto fa = static_cast<const float*>(a);
  auto fb = static_cast<const float*>(b);
  auto fc = static_cast<const float*>(cnt);
  auto fy = static_cast<const float*>(yty);
  auto fx = static_cast<float*>(x);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 32) {
    err = launch<32>(fa, a_stride, fb, b_stride, fc, cnt_stride, fy, lam,
                     implicit, fx, rows, k, s);
  } else if (k <= 64) {
    err = launch<64>(fa, a_stride, fb, b_stride, fc, cnt_stride, fy, lam,
                     implicit, fx, rows, k, s);
  } else {
    err = launch<128>(fa, a_stride, fb, b_stride, fc, cnt_stride, fy, lam,
                      implicit, fx, rows, k, s);
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // extern "C"
