// Fused dot-product score + top-k for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel predictionio_tpu/ops/pallas_topk.py
// (`_topk_kernel` + `_merge_block`, reached through `fused_top_k_dot`):
// for each query row, the `num` items with the largest q . item, without
// ever writing the [B, I] score matrix to device memory. One source, three
// item types: float32, bfloat16 (upcast at use) and int8 with a per-row
// float32 scale applied after the dot.
//
// Bound on the card: the item table is read once (I*k*itemsize bytes) and
// 2*B*I*k fp32 operations are done on CUDA cores (no TF32: the contract is
// fp32 FMA). At I = 1,048,576, k = 32 the table is 128 MiB (f32), 3.35 TB/s
// gives 40 us; B = 64 is 4.3 GFLOP, 64 us at 67 TFLOP/s fp32 (H100 SXM data
// sheet peaks, 700 W).
//
// Design. The TPU grid walks item blocks in order on one core and carries
// the best-list in VMEM; Hopper runs blocks in parallel and in no order, so
// the work splits in two passes:
//   pass 1, grid (query tile x item split): each block scores its item range
//     against a tile of QT queries (1, 2, ..., 64; the planner in
//     ops/fused_topk.py picks the widest that fits its shared-memory
//     budget) and keeps one top-`num` list per query in shared memory.
//     The split is streamed through shared memory in tiles of IT rows
//     (cut along k into chunks of at most kChunkBytes), each copied by
//     16-byte cp.async with consecutive threads on consecutive pieces, in
//     a ring of stages that keeps up to kInflightBytes of copies in flight
//     while the block computes on the oldest. bf16 and int8 tiles cross HBM
//     at their own width and are converted at use. Each thread owns a
//     TQ x TI micro-tile of (query, item) scores and walks k in 16-byte
//     steps: per four elements TQ + TI shared 16-byte loads feed 4*TQ*TI
//     FMAs (64 at 4 x 4). A warp is WI item groups x WQ query groups, its
//     query groups on consecutive query rows; every shared row is an odd
//     number of 16-byte units long, so a warp's load of one k offset reads
//     distinct banks (one wavefront when WI <= 8). Sums are fp32 FMA in k
//     order.
//     Selection. Each list keeps a buffer behind it that holds one whole
//     tile of candidates. In the first tile every list is empty: each
//     rankable score becomes a key in a slot of its own, and where a lane
//     group scores more than num items of a query only its num best are
//     kept (a key ranked by shuffles; no other can be among the best).
//     After that a score becomes a 64-bit key only when it is >= its
//     list's num-th score (a float each thread keeps in registers), and a
//     thread appends its few candidates with one shared atomic each. One
//     barrier a step: a list whose buffer could not take another tile
//     raises a flag, and the block folds after the next step's barrier (a
//     flag for each parity of the step, so that no thread reads a flag
//     that another is still setting in the same step). A fold keeps each
//     list's num best of list and buffer: for num <= kRankList by ranking
//     every key against the others (few keys) or by warp insertion (many),
//     for longer lists by a bitonic sort.
//     Pass 1 writes [B, splits, num] partial lists to scratch the caller
//     allocates.
//   pass 2, one block per query: merges the splits' lists into [B, num]
//     (a buffer of kThreads candidates, bitonic folds).
// Ranking is by one 64-bit key: the order-preserving bits of the float score
// above the complement of the item index, so equal scores rank the lower
// index first (lax.top_k's order) across splits too. NaN and masked scores
// rank as -inf: such an item enters a list as the key of -inf above its
// complemented index (0x007FFFFF in the high word), above the empty key 0
// and below every finite score, so a list with fewer rankable items than
// `num` fills its last slots with score -inf and the lowest unrankable
// indices, ascending, as lax.top_k does. After the first tile a score is
// tested as !(v < t) against its list's num-th score t, which is -inf
// while the list has room: every item passes then, NaN and -inf included,
// and the key compare decides; once a list holds `num` finite scores,
// -inf fails the test and NaN alone passes it, to fail the key compare.
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

constexpr int kThreads = 256;    // threads per block; keys per pass-2 chunk
constexpr int kMaxTile = 64;     // most queries scored together in one block
constexpr int kRowPad = 16;      // bytes that pad a shared-memory row
constexpr int kChunkBytes = 128; // most bytes of an item row per tile chunk
// each thread's micro-tile, TQ queries x TI items, by log2(QT)
constexpr int kMicroQ[7] = {1, 2, 4, 4, 4, 4, 4};
constexpr int kMicroI[7] = {1, 1, 1, 2, 2, 2, 4};
constexpr int kSmemLimit = 232448;  // most shared memory of a block
// item-tile copies a block aims to keep in flight (bytes), in at most
// kMaxStages ring stages and within kSmemBudget: two blocks an SM then
// cover HBM latency (several microseconds under load)
constexpr int kInflightBytes = 40960;
constexpr int kMaxStages = 16;
// a pass-1 block's dynamic shared memory: two blocks fit on one SM
constexpr int kSmemBudget = 112640;
// a pass-1 list of at most kRankList folds by ranking every key when it
// and its buffer hold at most kRankSlots keys (its region keeps num slots
// at its end for the result), else by warp insertion; a longer list by a
// bitonic sort
constexpr int kRankList = 32;
constexpr int kRankSlots = 128;

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x >> 1);
}
__host__ __device__ constexpr int micro_q(int qt) { return kMicroQ[log2i(qt)]; }
__host__ __device__ constexpr int micro_i(int qt) { return kMicroI[log2i(qt)]; }

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// a shared-memory row of `bytes` (a multiple of 16) padded to an odd
// number of 16-byte units: eight rows read at one offset hit all 32 banks
__host__ __device__ constexpr int padded_row(int bytes) {
  return bytes + ((bytes / 16) % 2 == 0 ? kRowPad : 0);
}

// The pass-1 block's shape at query tile QT: NGQ x NGI thread groups, each
// thread scoring TQ queries x TI items, so a tile holds IT = NGI * TI items.
// A warp is WI item groups x WQ query groups.
template <int QT>
struct Micro {
  static constexpr int TQ = micro_q(QT);
  static constexpr int TI = micro_i(QT);
  static constexpr int NGQ = QT / TQ;
  static constexpr int NGI = kThreads / NGQ;
  static constexpr int IT = NGI * TI;
  static constexpr int WQ = NGQ < 4 ? NGQ : 4;
  static constexpr int WI = 32 / WQ;
  static_assert(QT <= kMaxTile && QT % TQ == 0 && NGQ % WQ == 0 &&
                    NGI % WI == 0,
                "micro-tile");
};

// elements of one item-tile chunk along k, and its row stride in shared
// memory (bytes)
__host__ __device__ inline void item_chunk(int k, int itemsize, int* chunk,
                                           int* stride) {
  const int kp = round_up(k, 16 / itemsize);
  *chunk = kp < kChunkBytes / itemsize ? kp : kChunkBytes / itemsize;
  *stride = padded_row(*chunk * itemsize);
}

// stages of the item-tile ring: enough that all but the one being read
// hold kInflightBytes of copies, as many as fit beside `fixed` bytes in
// kSmemBudget, at most kMaxStages, at least 2
__host__ __device__ inline int tile_stages(int stage_bytes, int fixed) {
  int s = 1 + (kInflightBytes + stage_bytes - 1) / stage_bytes;
  const int fit = (kSmemBudget - fixed) / stage_bytes;
  s = s < fit ? s : fit;
  s = s < kMaxStages ? s : kMaxStages;
  return s < 2 ? 2 : s;
}

// dynamic shared bytes of a pass-1 block: the lists, the tile's queries
// (rows of round_up(k, 16 / itemsize) floats, padded) and the ring of item
// tiles. ops/fused_topk.py's pass1_smem mirrors it.
size_t pass1_smem(int qt, int it, int B, int R, int k, int itemsize) {
  int chunk, stride;
  item_chunk(k, itemsize, &chunk, &stride);
  const int kp = round_up(k, 16 / itemsize);
  const int lists = B < qt ? B : qt;
  const int fixed = lists * R * static_cast<int>(sizeof(u64)) +
                    qt * padded_row(kp * static_cast<int>(sizeof(float)));
  return static_cast<size_t>(fixed) +
         static_cast<size_t>(tile_stages(it * stride, fixed)) * it * stride;
}

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

// `lists` top-`num` lists in shared memory, list l at region[l*R, l*R+R):
// [0, num) the best keys sorted descending (0 = empty slot), then
// cnt[l] unmerged candidates, then zeros. R is a power of two.
struct TopLists {
  u64* region;
  int* cnt;
  u64* thr;  // key of each list's num-th entry: a candidate must beat it
  float* thr_score;  // its score (-inf while the list has room); may be null
  int lists;
  int R;
  int num;

  __device__ void init() {
    for (int t = threadIdx.x; t < lists * R; t += blockDim.x) region[t] = 0ull;
    if (threadIdx.x < lists) {
      cnt[threadIdx.x] = 0;
      thr[threadIdx.x] = 0ull;
      if (thr_score != nullptr) thr_score[threadIdx.x] = -INFINITY;
    }
  }

  __device__ __forceinline__ void offer(int l, u64 key) {
    if (key > thr[l]) {
      int pos = atomicAdd(&cnt[l], 1);
      region[static_cast<size_t>(l) * R + num + pos] = key;
    }
  }

  // the most unmerged candidates of any list; read by every thread, then a
  // barrier so no thread offers before all have read
  __device__ int max_count() {
    int most = 0;
    for (int l = 0; l < lists; ++l) most = max(most, cnt[l]);
    __syncthreads();
    return most;
  }

  // true when some buffer could not take one more chunk of candidates
  __device__ bool must_fold(int most, int chunk) const {
    return most > R - num - chunk;
  }

  // for num <= kRankList and long buffers: a warp per list, one key a lane (lane r
  // the r-th best). Each buffered candidate that beats the list's num-th
  // key is inserted at its rank (a ballot); the keys below it move down a
  // lane.
  __device__ void fold_warp() {
    constexpr unsigned kAll = 0xFFFFFFFFu;
    const int lane = threadIdx.x & 31;
    for (int l = threadIdx.x >> 5; l < lists; l += blockDim.x >> 5) {
      u64* r = region + static_cast<size_t>(l) * R;
      const int c = cnt[l];
      u64 v = lane < num ? r[lane] : 0ull;
      u64 last = __shfl_sync(kAll, v, num - 1);
      for (int b = 0; b < c; b += 32) {
        const u64 cand = b + lane < c ? r[num + b + lane] : 0ull;
        unsigned todo = __ballot_sync(kAll, cand > last);
        while (todo != 0u) {
          const u64 x = __shfl_sync(kAll, cand, __ffs(todo) - 1);
          todo &= todo - 1u;
          if (x <= last) continue;  // x and last are the same in every lane
          const int rank = __popc(__ballot_sync(kAll, lane < num && v > x));
          const u64 up = __shfl_up_sync(kAll, v, 1);
          if (lane < num) v = lane > rank ? up : (lane == rank ? x : v);
          last = __shfl_sync(kAll, v, num - 1);
        }
      }
      if (lane < num) r[lane] = v;
      if (lane == 0) {
        cnt[l] = 0;
        thr[l] = last;
        if (thr_score != nullptr) {
          int idx;
          decode_key(last, &thr_score[l], &idx);
        }
      }
    }
    __syncthreads();
  }

  // for num <= kRankList and short buffers: each key's rank in its list (how many keys of
  // the list and its buffer beat it; keys are distinct, empty slots are 0
  // and never kept), a warp per 32 keys; the num best go to a strip at the
  // region's end (zeros between folds), then to the list's head, in order.
  // No sort, no serial chain: a key reads the list's keys once.
  __device__ void fold_rank(int most) {
    const int lane = threadIdx.x & 31;
    const int chunks = (num + most + 31) / 32;
    for (int task = threadIdx.x >> 5; task < lists * chunks;
         task += blockDim.x >> 5) {
      const int l = task / chunks;
      const u64* r = region + static_cast<size_t>(l) * R;
      const int n = num + cnt[l];
      const int p = (task - l * chunks) * 32 + lane;
      const u64 key = p < n ? r[p] : 0ull;
      if (key == 0ull) continue;
      int rank = 0;
#pragma unroll 4
      for (int o = 0; o < n; ++o) rank += r[o] > key ? 1 : 0;
      if (rank < num) region[static_cast<size_t>(l) * R + R - num + rank] = key;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < lists * num; t += blockDim.x) {
      const int l = t / num;
      const int j = t - l * num;
      u64* r = region + static_cast<size_t>(l) * R;
      r[j] = r[R - num + j];
      r[R - num + j] = 0ull;
    }
    __syncthreads();
    if (threadIdx.x < lists) {
      const u64 key = region[static_cast<size_t>(threadIdx.x) * R + num - 1];
      cnt[threadIdx.x] = 0;
      thr[threadIdx.x] = key;
      if (thr_score != nullptr) {
        int idx;
        decode_key(key, &thr_score[threadIdx.x], &idx);
      }
    }
    __syncthreads();
  }

  // pass 1's fold: by rank when num + most keys are few, else by warp
  // insertion (num <= kRankList); a bitonic sort for longer lists
  __device__ void fold_any(int most) {
    if (num > kRankList) {
      fold(most);
    } else if (num + most <= kRankSlots) {
      fold_rank(most);
    } else {
      fold_warp();
    }
  }

  // bitonic sort, descending, of the first P slots of every region, the
  // least power of two holding num + most (every slot past it is empty);
  // keep the top num
  __device__ void fold(int most) {
    int P = 2;
    while (P < num + most) P <<= 1;
    const int lg = __ffs(P) - 1;
    const int half = P >> 1;
    for (int size = 2; size <= P; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = threadIdx.x; t < lists * half; t += blockDim.x) {
          const int l = t >> (lg - 1);
          const int p = t & (half - 1);
          const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
          const int j = i + stride;
          u64* r = region + static_cast<size_t>(l) * R;
          const u64 a = r[i], b = r[j];
          const bool desc = (i & size) == 0;
          if (desc ? (a < b) : (a > b)) {
            r[i] = b;
            r[j] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int t = threadIdx.x; t < lists * P; t += blockDim.x) {
      const int o = t & (P - 1);
      if (o >= num) region[static_cast<size_t>(t >> lg) * R + o] = 0ull;
    }
    if (threadIdx.x < lists) {
      const u64 key = region[static_cast<size_t>(threadIdx.x) * R + num - 1];
      cnt[threadIdx.x] = 0;
      thr[threadIdx.x] = key;
      if (thr_score != nullptr) {
        int idx;
        decode_key(key, &thr_score[threadIdx.x], &idx);
      }
    }
    __syncthreads();
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// waits until at most n (0 .. kMaxStages - 2) copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: cp_async_wait_n<0>(); break;
    case 1: cp_async_wait_n<1>(); break;
    case 2: cp_async_wait_n<2>(); break;
    case 3: cp_async_wait_n<3>(); break;
    case 4: cp_async_wait_n<4>(); break;
    case 5: cp_async_wait_n<5>(); break;
    case 6: cp_async_wait_n<6>(); break;
    case 7: cp_async_wait_n<7>(); break;
    case 8: cp_async_wait_n<8>(); break;
    case 9: cp_async_wait_n<9>(); break;
    case 10: cp_async_wait_n<10>(); break;
    case 11: cp_async_wait_n<11>(); break;
    case 12: cp_async_wait_n<12>(); break;
    case 13: cp_async_wait_n<13>(); break;
    default: cp_async_wait_n<14>(); break;
  }
}

template <int N>
struct RawOf;
template <>
struct RawOf<1> {
  typedef uint8_t type;
};
template <>
struct RawOf<2> {
  typedef uint16_t type;
};
template <>
struct RawOf<4> {
  typedef uint32_t type;
};

// Elements 4g .. 4g+3 of a 16-byte piece of an item row as exact floats:
// bf16 is the high half of an f32; an int8 byte b becomes 2^23 + (b ^ 0x80)
// by a byte permute, less 2^23 + 128 (no integer-to-float conversion).
template <typename T>
__device__ __forceinline__ void piece_f32(const uint4& raw, int g, float* x);
template <>
__device__ __forceinline__ void piece_f32<float>(const uint4& raw, int g,
                                                 float* x) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void piece_f32<__nv_bfloat16>(const uint4& raw,
                                                         int g, float* x) {
  const uint32_t lo = g == 0 ? raw.x : raw.z;
  const uint32_t hi = g == 0 ? raw.y : raw.w;
  x[0] = __uint_as_float(lo << 16);
  x[1] = __uint_as_float(lo & 0xFFFF0000u);
  x[2] = __uint_as_float(hi << 16);
  x[3] = __uint_as_float(hi & 0xFFFF0000u);
}
template <>
__device__ __forceinline__ void piece_f32<int8_t>(const uint4& raw, int g,
                                                  float* x) {
  const uint32_t w =
      (g == 0 ? raw.x : g == 1 ? raw.y : g == 2 ? raw.z : raw.w) ^
      0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    x[e] = __int_as_float(static_cast<int>(
               __byte_perm(w, 0x4B000000u, 0x7540u | e))) -
           8388736.0f;
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Built with -DPIO_TOPK_PROFILE (ops/topk_profile.py does), pass 1 adds
// up each warp's clock cycles by phase of a step into g_phase_cycles:
// 0 copy wait, 1 barrier, 2 fold flag, 3 copy issue, 4 dot products,
// 5 threshold test, 6 appends (the first tile's keys included), 7 folds.
#ifdef PIO_TOPK_PROFILE
__device__ unsigned long long g_phase_cycles[8];
#define PHASE(n)                  \
  {                               \
    const long long c = clock64(); \
    phase[n] += c - clock_at;     \
    clock_at = c;                 \
  }
#else
#define PHASE(n)
#endif
template <typename T, int QT>
__global__ void __launch_bounds__(kThreads, 2)
    topk_pass1(const float* __restrict__ q, const T* __restrict__ items,
               const float* __restrict__ scale,
               const uint8_t* __restrict__ mask, int mask_kind,
               const u64* __restrict__ upper, u64* __restrict__ partial,
               int B, int I, int k, int num, int R, int split_len, int vec) {
  typedef Micro<QT> M;
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte piece
  constexpr unsigned kFull = 0xFFFFFFFFu;
  typedef typename RawOf<sizeof(T)>::type Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int cnt[QT];
  __shared__ u64 thr[QT];
  __shared__ float thr_s[QT];
  __shared__ u64 ub[QT];
  // set by step s's appends at fold_due[s & 1], read at step s + 1's barrier
  __shared__ int fold_due[2];

  int chunk, stride;
  item_chunk(k, sizeof(T), &chunk, &stride);
  const int kp = round_up(k, E);
  const int nkc = (kp + chunk - 1) / chunk;
  const int qstride = padded_row(kp * 4) / 4;  // floats per query row
  // one list per query of the tile; a batch smaller than the tile (B < QT)
  // allocates only B lists
  const int lists = min(QT, B);
  u64* region = reinterpret_cast<u64*>(smem);
  float* qs = reinterpret_cast<float*>(region + static_cast<size_t>(lists) * R);
  unsigned char* tiles = reinterpret_cast<unsigned char*>(qs + QT * qstride);
  const int stage_bytes = M::IT * stride;
  const int stages = tile_stages(stage_bytes, static_cast<int>(tiles - smem));
  // a buffer holding more candidates than this could not take another tile
  const int room = R - (num <= kRankList ? 2 * num : num) - M::IT;

  const int b0 = blockIdx.x * QT;
  const int nq = min(QT, B - b0);
  const int split = blockIdx.y;
  const int start = split * split_len;
  const int end = min(I, start + split_len);
  const int steps = end > start ? (end - start + M::IT - 1) / M::IT * nkc : 0;

  TopLists top{region, cnt, thr, thr_s, nq, R, num};
  top.init();
  for (int t = threadIdx.x; t < QT * qstride; t += kThreads) {
    const int l = t / qstride;
    const int c = t - l * qstride;
    qs[t] = (l < nq && c < k) ? q[static_cast<size_t>(b0 + l) * k + c] : 0.0f;
  }
  if (threadIdx.x < QT) {
    const int l = threadIdx.x;
    ub[l] = (upper != nullptr && l < nq) ? upper[b0 + l] : ~0ull;
  }
  if (threadIdx.x < 2) fold_due[threadIdx.x] = 0;

  // this thread's groups: item rows ig + i * NGI, queries qg + j * NGQ
  constexpr int kWarpsQ = M::NGQ / M::WQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qg = (warp % kWarpsQ) * M::WQ + lane / M::WI;
  const int ig = (warp / kWarpsQ) * M::WI + lane % M::WI;
  // the first lane of this lane's group (the WI lanes sharing qg), and the
  // warp's place along the items
  const int gbase = lane & ~(M::WI - 1);
  const int grow = warp / kWarpsQ;
  // its lists' num-th scores, -inf while a list has room (thr_s, copied
  // after every fold)
  float ts[M::TQ];
#pragma unroll
  for (int j = 0; j < M::TQ; ++j) ts[j] = -INFINITY;

  // step s copies chunk s % nkc of tile s / nkc into stage s % stages, as
  // one commit group
  const unsigned char* src = reinterpret_cast<const unsigned char*>(items);
  auto load = [&](int s) {
    const int t = s / nkc;
    const int c0 = (s - t * nkc) * chunk;
    const int clen = min(chunk, kp - c0);
    const int base = start + t * M::IT;
    const int rows = min(M::IT, end - base);
    unsigned char* dst = tiles + (s % stages) * stage_bytes;
    if (vec) {
      const int pieces = clen / E;
      for (int p = threadIdx.x; p < rows * pieces; p += kThreads) {
        const int r = p / pieces;
        const int c = p - r * pieces;
        cp_async16(dst + r * stride + c * 16,
                   src + (static_cast<size_t>(base + r) * k + c0) * sizeof(T) +
                       c * 16);
      }
    } else {
      // rows not 16-byte aligned: plain loads, zeros past k
      const Raw* rsrc = reinterpret_cast<const Raw*>(items);
      for (int p = threadIdx.x; p < rows * clen; p += kThreads) {
        const int r = p / clen;
        const int c = p - r * clen;
        reinterpret_cast<Raw*>(dst + r * stride)[c] =
            c0 + c < k ? rsrc[static_cast<size_t>(base + r) * k + c0 + c]
                       : Raw(0);
      }
    }
    cp_async_commit();
  };

  int roff[M::TI];  // this thread's rows within a stage (bytes)
#pragma unroll
  for (int i = 0; i < M::TI; ++i) roff[i] = (ig + i * M::NGI) * stride;
  const float* qrow = qs + qg * qstride;
  float acc[M::TQ][M::TI];

  // a ring of `stages` tiles: while the block computes on step s, the
  // copies of steps s + 1 .. s + stages - 1 are in flight. Every step
  // commits one group (empty past the last step).
  for (int s = 0; s < stages - 1; ++s) {
    if (s < steps) {
      load(s);
    } else {
      cp_async_commit();
    }
  }
#ifdef PIO_TOPK_PROFILE
  long long phase[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long clock_at = clock64();
#endif
  for (int s = 0; s < steps; ++s) {
    cp_async_wait(stages - 2);  // this thread's copies of step s landed
    PHASE(0)
    // every thread's copies of step s landed, and every thread is done
    // with step s - 1: its stage may take the next copy, its candidates
    // are all in the buffers
    __syncthreads();
    PHASE(1)
    if (fold_due[(s + 1) & 1]) {
      const int most = top.max_count();  // every thread has read the flag
      if (threadIdx.x == 0) fold_due[(s + 1) & 1] = 0;
      top.fold_any(most);
#pragma unroll
      for (int j = 0; j < M::TQ; ++j)
        if (qg + j * M::NGQ < nq) ts[j] = thr_s[qg + j * M::NGQ];
      PHASE(7)
    }
    PHASE(2)
    if (s + stages - 1 < steps) {
      load(s + stages - 1);
    } else {
      cp_async_commit();
    }
    PHASE(3)
    const int t = s / nkc;
    const int kc = s - t * nkc;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < M::TQ; ++j)
#pragma unroll
        for (int i = 0; i < M::TI; ++i) acc[j][i] = 0.0f;
    }
    const unsigned char* tile = tiles + (s % stages) * stage_bytes;
    const int c0 = kc * chunk;
    const int pieces = min(chunk, kp - c0) / E;
    const float* qp = qrow + c0;
#pragma unroll 2
    for (int p = 0; p < pieces; ++p) {
      uint4 raw[M::TI];
#pragma unroll
      for (int i = 0; i < M::TI; ++i)
        raw[i] = *reinterpret_cast<const uint4*>(tile + roff[i] + p * 16);
#pragma unroll
      for (int g = 0; g < E / 4; ++g) {
        float4 qv[M::TQ];
#pragma unroll
        for (int j = 0; j < M::TQ; ++j)
          qv[j] = *reinterpret_cast<const float4*>(
              qp + j * M::NGQ * qstride + p * E + 4 * g);
        float x[M::TI][4];
#pragma unroll
        for (int i = 0; i < M::TI; ++i) piece_f32<T>(raw[i], g, x[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < M::TQ; ++j)
#pragma unroll
            for (int i = 0; i < M::TI; ++i)
              acc[j][i] = fmaf(lane4(qv[j], e), x[i][e], acc[j][i]);
      }
    }
    PHASE(4)
    if (kc != nkc - 1) continue;

    const int base = start + t * M::IT;
    if (t == 0) {
      // the first tile: every list is empty, so every rankable score is a
      // candidate, written to a slot of its own (no atomics); the lists
      // fold at the next barrier. Where a lane group scores more than num
      // items of a query, only its num best can be among the split's
      // best: each key is ranked in its group (shuffles) and goes to slot
      // num * (1 + grow) + rank, or is dropped.
      const bool local = num <= M::WI * M::TI;
#pragma unroll
      for (int j = 0; j < M::TQ; ++j) {
        const int l = qg + j * M::NGQ;
        u64 key[M::TI];
#pragma unroll
        for (int i = 0; i < M::TI; ++i) {
          const int gi = base + ig + i * M::NGI;
          const float sc = (scale != nullptr && gi < end) ? scale[gi] : 1.0f;
          const float v = scale != nullptr ? acc[j][i] * sc : acc[j][i];
          key[i] = 0ull;
          if (gi < end && l < nq) {
            // NaN fails the compare: it ranks as -inf, as masked items do
            const bool dead =
                !(v > -INFINITY) || (mask_kind == 1 && mask[gi] != 0) ||
                (mask_kind == 2 &&
                 mask[static_cast<size_t>(b0 + l) * I + gi] != 0);
            key[i] = make_key(dead ? -INFINITY : v, gi);
            if (key[i] >= ub[l]) key[i] = 0ull;
          }
        }
        if (local) {
          int rank[M::TI];
#pragma unroll
          for (int i = 0; i < M::TI; ++i) rank[i] = 0;
          for (int from = gbase; from < gbase + M::WI; ++from) {
#pragma unroll
            for (int i2 = 0; i2 < M::TI; ++i2) {
              const u64 o = __shfl_sync(kFull, key[i2], from);
#pragma unroll
              for (int i = 0; i < M::TI; ++i) rank[i] += o > key[i] ? 1 : 0;
            }
          }
#pragma unroll
          for (int i = 0; i < M::TI; ++i)
            if (key[i] != 0ull && rank[i] < num)
              region[static_cast<size_t>(l) * R + num * (1 + grow) +
                     rank[i]] = key[i];
        } else if (l < nq) {
#pragma unroll
          for (int i = 0; i < M::TI; ++i)
            region[static_cast<size_t>(l) * R + num + ig + i * M::NGI] =
                key[i];
        }
      }
      if (threadIdx.x < nq)
        cnt[threadIdx.x] = local ? kThreads / 32 / kWarpsQ * num : M::IT;
      if (threadIdx.x == 0) fold_due[s & 1] = 1;
      PHASE(6)
      continue;
    }
    // a score below its list's num-th score is never kept: one float
    // compare each, no key built (with room in the list that score is
    // -inf and every item passes; NaN always passes, for the key compare
    // to refuse). Each score that passes sets a bit; a thread then appends
    // its few candidates one by one (a shared atomic each), and a buffer
    // that could not take another tile raises the flag.
    unsigned hits = 0u;
#pragma unroll
    for (int i = 0; i < M::TI; ++i) {
      const int gi = base + ig + i * M::NGI;
      const float sc = (scale != nullptr && gi < end) ? scale[gi] : 1.0f;
#pragma unroll
      for (int j = 0; j < M::TQ; ++j) {
        if (scale != nullptr) acc[j][i] *= sc;
        const float v = acc[j][i];
        if (gi < end && qg + j * M::NGQ < nq && !(v < ts[j]))
          hits |= 1u << (j * M::TI + i);
      }
    }
    PHASE(5)
    while (hits != 0u) {
      const int b = __ffs(hits) - 1;
      hits &= hits - 1u;
      float v = acc[0][0];  // acc[b / TI][b % TI], by selects
#pragma unroll
      for (int j = 0; j < M::TQ; ++j)
#pragma unroll
        for (int i = 0; i < M::TI; ++i)
          if (b == j * M::TI + i) v = acc[j][i];
      const int l = qg + b / M::TI * M::NGQ;
      const int gi = base + ig + b % M::TI * M::NGI;
      // masked items and NaN rank as -inf
      const bool dead =
          !(v > -INFINITY) || (mask_kind == 1 && mask[gi] != 0) ||
          (mask_kind == 2 && mask[static_cast<size_t>(b0 + l) * I + gi] != 0);
      const u64 key = make_key(dead ? -INFINITY : v, gi);
      if (key <= thr[l] || (upper != nullptr && key >= ub[l])) continue;
      const int pos = atomicAdd(&cnt[l], 1);
      region[static_cast<size_t>(l) * R + num + pos] = key;
      if (pos + 1 > room) fold_due[s & 1] = 1;
    }
    PHASE(6)
  }

  __syncthreads();
  const int most = top.max_count();
  if (most > 0) {
    top.fold_any(most);
  }
#ifdef PIO_TOPK_PROFILE
  if (lane == 0)
    for (int n = 0; n < 8; ++n)
      atomicAdd(&g_phase_cycles[n], static_cast<u64>(phase[n]));
#endif

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

  TopLists top{region, cnt, thr, nullptr, 1, R, num};
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
    const int most = top.max_count();
    if (top.must_fold(most, kThreads)) top.fold(most);
  }
  const int most = top.max_count();
  if (most > 0) top.fold(most);

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
  // a plan this kernel cannot run is refused, never adjusted
  const size_t smem = pass1_smem(QT, Micro<QT>::IT, B, R, k, sizeof(T));
  if (num < 1 || k < 1 || k > 256 || (R & (R - 1)) != 0 ||
      R < (num <= kRankList ? 2 * num : num) + Micro<QT>::IT ||
      split_len < 1 || splits < 1 ||
      splits > 65535 || static_cast<long long>(split_len) * splits < I ||
      smem > static_cast<size_t>(kSmemLimit))
    return cudaErrorInvalidValue;
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
    case 16:
      return launch_pass1_tile<T, 16>(q, items, scale, mask, mask_kind, upper,
                                      partial, B, I, k, num, R, split_len,
                                      splits, vec, stream);
    case 32:
      return launch_pass1_tile<T, 32>(q, items, scale, mask, mask_kind, upper,
                                      partial, B, I, k, num, R, split_len,
                                      splits, vec, stream);
    case 64:
      return launch_pass1_tile<T, 64>(q, items, scale, mask, mask_kind, upper,
                                      partial, B, I, k, num, R, split_len,
                                      splits, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// qt: queries per pass-1 block (1, 2, 4, ..., 64). dtype: 0 float32, 1
// bfloat16, 2 int8. mask_kind: 0 none, 1 [I], 2 [B, I] (uint8, nonzero =
// exclude). scale, mask and upper may be null. partial: [B, splits, num]
// keys. R: slots per list, a power of two >= num + the tile's items, and
// >= 2 * num + the tile's items for num <= kRankList.
// vec: 1 when every item row starts on a 16-byte boundary and
// k * itemsize is a multiple of 16. A plan that does not fit returns
// cudaErrorInvalidValue.
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

#ifdef PIO_TOPK_PROFILE
// Copies pass 1's phase cycles (8 counters) to `out` and zeroes them.
int pio_topk_phase_cycles(u64* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const u64 zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
}
#endif
}  // extern "C"
