// Exact inner-product top-k over an f32 gallery: a skinny f32 scan with the
// selection in its epilogue, CUDA C++ for sm_90a.
//
// Replaces no TPU kernel. The JAX package leaves this scan to XLA's dot and
// lax.top_k (image_search_engine_for_historical_research_tpu/ops/topk.py), and
// the port first left it to cuBLAS and torch.topk. On the H100 that pair wastes
// the card at the shapes the port runs: cuBLAS's f32 kernel for a (Q, D) x
// (N, D)^T product tiles the query side by 64 rows, so Q = 70 runs as 128 rows
// (10.48 ms against 1,007,323 x 2048 rows, where Q = 64 takes 5.51), and
// torch.topk then reads the whole (Q, N) score matrix back (1.08 ms at
// Q = 70, k = 100).
//
// What bounds it: one scan is 2QND FLOPs on the f32 CUDA cores (67 TFLOP/s;
// tensor cores and TF32 are not used, so the scores stay f32) and one read of
// the gallery (3.35 TB/s). At Q = 70, N = 1,007,323, D = 2048 that is 4.31 ms
// of arithmetic against 2.46 ms of bytes: bound by the FMAs. At Q <= 16 the
// bytes bound it. Beside the FMA pipe, shared memory is the scarce unit: a
// 16-byte shared load costs four of its cycles (one a quarter warp) whether
// the warp's lanes read 32 addresses or one, and an SM issues four warp FMAs a
// cycle. A thread tile of m queries x n rows loads m + n float4s per 4mn FMAs,
// so shared memory keeps up only where 4 (m + n) <= mn.
//
// Design:
//   - A persistent grid, one block of 8 warps an SM, walks tiles of BN = 512
//     gallery rows (tile = blockIdx.x + t * gridDim.x). A block computes all
//     of its tile's Q x BN scores: Q is padded to QP = 8 * TQ (72 for 70),
//     warp w owns queries [w * TQ, (w + 1) * TQ) against all BN rows, and lane
//     l the rows l + 32 j, j < NR = 16: at TQ = 9 a 9 x 16 tile, 25 float4
//     loads per 576 FMAs, and 144 accumulators, which fill the registers.
//   - Q <= 72 (TQ <= 9). Above it the accumulators no longer fit a 16-row
//     lane; a tile of 8 rows a lane ran Q = 128 in 14.0 ms, where cuBLAS's
//     64-row query tiles are full and it and torch.topk take 12.2, so those
//     shapes stay with the library.
//   - D is walked in 32-wide slices through a ring of 3-4 shared-memory
//     stages filled with cp.async (16 bytes, zero-filled past N, Q and D,
//     prefetching the next 256 bytes of each row into L2). The ring runs
//     across tile boundaries, so the next tile's first slices load during an
//     epilogue. A slice is one 128-byte line of each row (16-wide slices ran
//     2-9% slower: twice the barriers and half-line reads). Gallery rows are
//     128 bytes apart with their eight 16-byte chunks XOR-swizzled by the low
//     3 bits of the row, so both the copies into a stage and a quarter warp's
//     loads of 8 rows hit 8 distinct bank groups.
//   - Per 4-wide step of D a thread loads its TQ query float4s (the same for
//     every lane) and then, row by row, NR gallery float4s, each feeding 4 TQ
//     FMAs. Each score is one fmaf chain over d = 0, 1, ..., D - 1.
//   - The epilogue filters, it does not sort. A score enters as a 64-bit key,
//     (its order-preserving bits << 32) | ~row, so keys order by score and
//     then by the lower row, lax.top_k's rule, and are unique. Each (block,
//     query) appends the keys above its threshold to a buffer of CAP = BN +
//     128 keys in device memory (a ballot and a prefix count a row, no serial
//     step); when a tile's keys would not fit, the owning warp reads the
//     buffer into registers, compacts it to its k largest by a radix select
//     on the keys (a warp sum per bit below the keys' common prefix), writes
//     them back and raises the threshold to the k-th key. The epilogue is a
//     loop over the warp's queries: each round filters the scores in acc[0]
//     and shifts the rows of acc down by one, so its code is one copy that
//     stays in the instruction cache (unrolled over 9 queries it did not,
//     and cost a tenth of the scan). After the last tile the warp compacts to
//     k and orders the keys by rank into the block's list.
//   - A second kernel merges the blocks' sorted lists, one block a query: the
//     lists go to shared memory and warp 0 takes the largest head k times.
//     No atomic decides any order, and the (Q, N) score matrix is never
//     written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 32;        // D slice a stage holds: 8 chunks of 16 bytes a row
constexpr int kChunks = kBK / 4;
constexpr int kMaxTQ = 9;      // QP = 8 * TQ <= 72 queries
constexpr int kMaxK = 128;
constexpr int kNR = 16;        // gallery rows a lane takes
constexpr int kBN = 32 * kNR;  // gallery rows a tile holds
constexpr int kCap = kBN + kMaxK;  // keys a (block, query) buffer holds
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;
constexpr int kMaxLists = 224;  // merge: (224, 128) keys fit a block's shared memory
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

__device__ __forceinline__ u64 make_key(float s, int row) {
  unsigned u = __float_as_uint(s);
  if ((u << 1) == 0) u = 0;  // -0 ties with +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | (0xffffffffu - static_cast<unsigned>(row));
}

__device__ __forceinline__ float key_score(u64 key) {
  unsigned u = static_cast<unsigned>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ long long key_row(u64 key) {
  return static_cast<long long>(0xffffffffu - static_cast<unsigned>(key));
}

__device__ __forceinline__ u64 shfl64(u64 v, int src) {
  const unsigned lo = __shfl_sync(kFull, static_cast<unsigned>(v), src);
  const unsigned hi = __shfl_sync(kFull, static_cast<unsigned>(v >> 32), src);
  return (static_cast<u64>(hi) << 32) | lo;
}

// The warp's largest key (every lane gets it); keys are unique or 0.
__device__ __forceinline__ u64 warp_max(u64 v) {
  const unsigned hi = __reduce_max_sync(kFull, static_cast<unsigned>(v >> 32));
  const unsigned lo = __reduce_max_sync(
      kFull, static_cast<unsigned>(v >> 32) == hi ? static_cast<unsigned>(v) : 0u);
  return (static_cast<u64>(hi) << 32) | lo;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` (0, 1 or 2) groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The largest value v with at least `need` (>= 1) of the warp's keys (v[t] of
// each lane) satisfying sel(key) && field(key) >= v, found bit by bit from the
// highest bit in which the selected fields differ.
template <int T, typename Sel, typename Field>
__device__ __forceinline__ unsigned radix_select(const u64 (&v)[T], int need, Sel sel,
                                                 Field field) {
  unsigned mx = 0, mn = 0xffffffffu;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (sel(v[t])) {
      mx = max(mx, field(v[t]));
      mn = min(mn, field(v[t]));
    }
  }
  mx = __reduce_max_sync(kFull, mx);
  mn = __reduce_min_sync(kFull, mn);
  if (mx == mn) return mx;
  const int top = 31 - __clz(mx ^ mn);
  unsigned pre = mx & ~((2u << top) - 1u);  // the bits above `top`, shared by all
  for (int bit = top; bit >= 0; --bit) {
    const unsigned cand = pre | (1u << bit);
    unsigned c = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) c += (sel(v[t]) && field(v[t]) >= cand) ? 1u : 0u;
    if (static_cast<int>(__reduce_add_sync(kFull, c)) >= need) pre = cand;
  }
  return pre;
}

// Keep the k largest of the n > k keys in src[0, n) (device memory, unordered,
// n <= CAP) in dst[0, k), which may be src; returns the k-th largest key. One
// warp, with the keys in registers; keys are unique and nonzero.
template <int CAP>
__device__ __forceinline__ u64 compact(const u64* src, u64* dst, int n, int k, int lane) {
  constexpr int T = CAP / 32;
  u64 v[T];  // key lane + 32 t, 0 past n
#pragma unroll
  for (int t = 0; t < T; ++t) v[t] = lane + 32 * t < n ? src[lane + 32 * t] : 0ull;
  const auto all = [](u64 key) { return key != 0ull; };
  const auto hi = [](u64 key) { return static_cast<unsigned>(key >> 32); };
  const unsigned h = radix_select(v, k, all, hi);
  unsigned gt = 0, eq = 0, lo_min = 0xffffffffu;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const unsigned kh = static_cast<unsigned>(v[t] >> 32), kl = static_cast<unsigned>(v[t]);
    gt += kh > h ? 1u : 0u;
    if (kh == h) {  // h > 0, so never a missing key
      ++eq;
      lo_min = min(lo_min, kl);
    }
  }
  const int need = k - static_cast<int>(__reduce_add_sync(kFull, gt));  // 1 <= need <= eq
  unsigned l;
  if (need == static_cast<int>(__reduce_add_sync(kFull, eq))) {
    l = __reduce_min_sync(kFull, lo_min);  // every key of score h is kept
  } else {
    const auto same = [h](u64 key) { return static_cast<unsigned>(key >> 32) == h; };
    const auto lo = [](u64 key) { return static_cast<unsigned>(key); };
    l = radix_select(v, need, same, lo);
  }
  const u64 kth = (static_cast<u64>(h) << 32) | l;
  __syncwarp();  // every lane has read src before dst is written
  unsigned base = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const bool keep = v[t] >= kth;
    const unsigned b = __ballot_sync(kFull, keep);
    if (keep) dst[base + __popc(b & ((1u << lane) - 1u))] = v[t];
    base += __popc(b);
  }
  __syncwarp();
  return kth;
}

template <int TQ>
__global__ void __launch_bounds__(kThreads, 1)
    scan_kernel(const float* __restrict__ x, const float* __restrict__ q, int N, int D, int Q,
                int k, int stages, u64* __restrict__ cand, u64* __restrict__ lists) {
  constexpr int QP = 8 * TQ;
  constexpr int NR = kNR;
  constexpr int BN = kBN;
  constexpr int CAP = kCap;
  constexpr int stage_floats = (BN + QP) * kBK;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  u64* thr_s = reinterpret_cast<u64*>(ring + stages * stage_floats);  // (QP,)
  int* cnt_s = reinterpret_cast<int*>(thr_s + QP);                    // (QP,)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (N + BN - 1) / BN;
  const int nslices = (D + kBK - 1) / kBK;
  const int my_tiles = (tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);
  const int total = my_tiles * nslices;

  if (lane < TQ) {
    thr_s[warp * TQ + lane] = 0ull;
    cnt_s[warp * TQ + lane] = 0;
  }

  // slice g of this block: tile blockIdx.x + (g / nslices) * gridDim.x,
  // columns (g % nslices) * kBK ...; issued into stage g % stages. A thread
  // copies chunk `part` of the rows r0 + 32 t: of the tile's rows, where the
  // swizzle (the low 3 bits of r0) is the same for every t, and of the
  // queries.
  const int part = tid & (kChunks - 1), r0 = tid / kChunks;
  constexpr int kRowStep = kThreads / kChunks;  // 32
  const int b_dst = r0 * kBK + ((part ^ (r0 & 7)) << 2);
  const int a_dst = (BN + r0) * kBK + part * 4;
  int i_tile = blockIdx.x, i_ks = 0, i_stage = 0, issued = 0;
  auto issue = [&]() {
    if (issued < total) {
      float* st = ring + i_stage * stage_floats;
      const int row0 = i_tile * BN + r0, gk = i_ks * kBK + part * 4;
      const bool in_d = gk < D;
      const float* src = x + (static_cast<size_t>(row0) * D + gk);
#pragma unroll
      for (int t = 0; t < BN / kRowStep; ++t) {
        const bool ok = in_d && row0 + kRowStep * t < N;
        cp_async16(st + b_dst + t * kRowStep * kBK,
                   ok ? src + static_cast<size_t>(kRowStep * t) * D : x, ok);
      }
#pragma unroll
      for (int t = 0; t < (QP + kRowStep - 1) / kRowStep; ++t) {
        const int r = r0 + kRowStep * t;
        const bool ok = in_d && r < Q;
        if (r < QP)
          cp_async16(st + a_dst + t * kRowStep * kBK,
                     ok ? q + (static_cast<size_t>(r) * D + gk) : q, ok);
      }
      if (++i_ks == nslices) {
        i_ks = 0;
        i_tile += gridDim.x;
      }
      if (++i_stage == stages) i_stage = 0;
    }
    ++issued;
    cp_async_commit();
  };

  for (int s = 0; s < stages - 1; ++s) issue();

  float acc[TQ][NR];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[i][j] = 0.f;

  const int swz = lane & 7;  // the XOR swizzle of this lane's rows
  int c_tile = blockIdx.x, c_ks = 0, c_stage = 0;
  for (int s = 0; s < total; ++s) {
    cp_async_wait(stages - 2);
    __syncthreads();  // slice s is in; every warp is done with slice s - 1's stage
    issue();
    const float* bs = ring + c_stage * stage_floats + lane * kBK;
    const float* as = ring + c_stage * stage_floats + (BN + warp * TQ) * kBK;
#pragma unroll 1
    for (int p = 0; p < kChunks; ++p) {
      float4 a[TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i) a[i] = *reinterpret_cast<const float4*>(as + i * kBK + p * 4);
      const float* bp = bs + ((p ^ swz) << 2);
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(bp + j * 32 * kBK);
#pragma unroll
        for (int i = 0; i < TQ; ++i) acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
#pragma unroll
        for (int i = 0; i < TQ; ++i) acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
#pragma unroll
        for (int i = 0; i < TQ; ++i) acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
#pragma unroll
        for (int i = 0; i < TQ; ++i) acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
    if (++c_stage == stages) c_stage = 0;
    if (++c_ks < nslices) continue;

    // The tile's scores are complete: filter them into the buffers, one
    // query a round. The rounds are a loop, not unrolled, so the epilogue's
    // code is one copy that stays in the instruction cache: each round takes
    // the scores of acc[0] and then shifts the rows of acc down by one.
    const int row0 = c_tile * BN;
    c_ks = 0;
    c_tile += gridDim.x;
#pragma unroll 1
    for (int qg = warp * TQ; qg < warp * TQ + TQ; ++qg) {
      if (qg < Q) {
        u64* buf = cand + (static_cast<size_t>(blockIdx.x) * Q + qg) * CAP;
        u64 thr = thr_s[qg];
        int n = cnt_s[qg];
        int m = 0;
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const int row = row0 + lane + 32 * j;
          m += __popc(__ballot_sync(kFull, (row < N) & (make_key(acc[0][j], row) > thr)));
        }
        if (m != 0) {
          if (n + m > CAP) {  // n > k here: CAP - BN >= k
            thr = compact<CAP>(buf, buf, n, k, lane);
            n = k;
          }
#pragma unroll
          for (int j = 0; j < NR; ++j) {
            const int row = row0 + lane + 32 * j;
            const u64 key = row < N ? make_key(acc[0][j], row) : 0ull;
            const bool pass = key > thr;
            const unsigned b = __ballot_sync(kFull, pass);
            if (pass) buf[n + __popc(b & ((1u << lane) - 1u))] = key;
            n += __popc(b);
          }
          __syncwarp();
          if (lane == 0) {
            thr_s[qg] = thr;
            cnt_s[qg] = n;
          }
          __syncwarp();
        }
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[i][j] = i + 1 < TQ ? acc[i + 1][j] : 0.f;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");

  // this block's top-k of each query, descending, 0-padded: lists[(block, q, e)]
#pragma unroll 1
  for (int i = 0; i < TQ; ++i) {
    const int qg = warp * TQ + i;
    if (qg >= Q) break;
    u64* buf = cand + (static_cast<size_t>(blockIdx.x) * Q + qg) * CAP;
    int n = cnt_s[qg];
    if (n > k) {
      compact<CAP>(buf, buf, n, k, lane);
      n = k;
    }
    u64 v[kMaxK / 32];
#pragma unroll
    for (int r = 0; r < kMaxK / 32; ++r) {
      const int e = r * 32 + lane;
      v[r] = e < n ? buf[e] : 0ull;
    }
    int rank[kMaxK / 32] = {};
    for (int e = 0; e < n; ++e) {
      const int r = e >> 5;
      const u64 o = shfl64(r == 0 ? v[0] : r == 1 ? v[1] : r == 2 ? v[2] : v[3], e & 31);
#pragma unroll
      for (int t = 0; t < kMaxK / 32; ++t) rank[t] += o > v[t] ? 1 : 0;
    }
    u64* out = lists + (static_cast<size_t>(blockIdx.x) * Q + qg) * k;
#pragma unroll
    for (int r = 0; r < kMaxK / 32; ++r) {
      const int e = r * 32 + lane;
      if (e < n) out[rank[r]] = v[r];
      else if (e < k) out[e] = 0ull;
    }
  }
}

// One block a query: the G lists of k sorted keys into shared memory, then
// warp 0 takes the largest head k times (lane l holds lists l + 32 m).
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const u64* __restrict__ lists, int G, int Q, int k,
                 float* __restrict__ out_scores, long long* __restrict__ out_ids) {
  extern __shared__ u64 heads[];  // (G, k)
  const int qg = blockIdx.x;
  for (int e = threadIdx.x; e < G * k; e += blockDim.x) {
    const int g = e / k, j = e - g * k;
    heads[e] = lists[(static_cast<size_t>(g) * Q + qg) * k + j];
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  constexpr int kLanes = kMaxLists / 32;
  int ptr[kLanes];
  u64 best = 0;
  int best_m = 0;
#pragma unroll
  for (int m = 0; m < kLanes; ++m) {
    ptr[m] = 0;
    const int g = lane + 32 * m;
    const u64 h = g < G ? heads[g * k] : 0ull;
    if (h > best) {
      best = h;
      best_m = m;
    }
  }
  for (int t = 0; t < k; ++t) {
    const u64 w = warp_max(best);
    if (lane == 0) {
      out_scores[static_cast<size_t>(qg) * k + t] = key_score(w);
      out_ids[static_cast<size_t>(qg) * k + t] = key_row(w);
    }
    if (best == w) {  // one lane: advance the list it took, find its next best
#pragma unroll
      for (int m = 0; m < kLanes; ++m) ptr[m] += (m == best_m) ? 1 : 0;
      best = 0;
#pragma unroll
      for (int m = 0; m < kLanes; ++m) {
        const int g = lane + 32 * m;
        const u64 h = (g < G && ptr[m] < k) ? heads[g * k + ptr[m]] : 0ull;
        if (h > best) {
          best = h;
          best_m = m;
        }
      }
    }
  }
}

template <int TQ>
int launch_scan(const float* x, const float* q, int N, int D, int Q, int k, int blocks,
                u64* cand, u64* lists, cudaStream_t stream) {
  constexpr int QP = 8 * TQ;
  const int stage_bytes = (kBN + QP) * kBK * 4;
  const int fixed = QP * 12;  // thresholds and counts
  int stages = (kSmemLimit - fixed) / stage_bytes;
  stages = stages < kMaxStages ? stages : kMaxStages;
  const int smem = stages * stage_bytes + fixed;
  cudaError_t err =
      cudaFuncSetAttribute(scan_kernel<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<TQ><<<blocks, kThreads, smem, stream>>>(x, q, N, D, Q, k, stages, cand, lists);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int scan_topk_max_q() { return 8 * kMaxTQ; }
int scan_topk_max_k() { return kMaxK; }
int scan_topk_max_blocks() { return kMaxLists; }
// Gallery rows a block tile takes, and the keys a (block, query) buffer holds.
int scan_topk_tile_rows() { return kBN; }
int scan_topk_buffer_keys() { return kCap; }

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// x: (N, D) f32, q: (Q, D) f32, both contiguous and 16-byte aligned, D % 4 ==
// 0, 1 <= N < 2^31, 1 <= Q <= 72, 1 <= k <= min(128, N); blocks: the scan's
// grid, 1 <= blocks <= min(ceil(N / scan_topk_tile_rows()), 224); cand:
// (blocks, Q, scan_topk_buffer_keys()) uint64 scratch; lists: (blocks, Q, k)
// uint64 scratch; out_scores: (Q, k) f32 and out_ids: (Q, k) int64,
// descending by score, the lower id first among equal scores.
int scan_topk_launch(const void* x, const void* q, int N, int D, int Q, int k, int blocks,
                     void* cand, void* lists, void* out_scores, void* out_ids, void* stream) {
  if (Q < 1 || Q > 8 * kMaxTQ || k < 1 || k > kMaxK || k > N || D < 4 || D % 4 ||
      blocks < 1 || blocks > kMaxLists ||
      blocks > (N + kBN - 1) / kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* qf = static_cast<const float*>(q);
  u64* c = static_cast<u64*>(cand);
  u64* l = static_cast<u64*>(lists);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch ((Q + 7) / 8) {
#define SCAN_TOPK_CASE(TQ)                                     \
  case TQ:                                                     \
    rc = launch_scan<TQ>(xf, qf, N, D, Q, k, blocks, c, l, s); \
    break;
    SCAN_TOPK_CASE(1) SCAN_TOPK_CASE(2) SCAN_TOPK_CASE(3) SCAN_TOPK_CASE(4)
    SCAN_TOPK_CASE(5) SCAN_TOPK_CASE(6) SCAN_TOPK_CASE(7) SCAN_TOPK_CASE(8)
    SCAN_TOPK_CASE(9)
#undef SCAN_TOPK_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  const int smem = blocks * k * 8;
  cudaError_t err = cudaFuncSetAttribute(merge_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<Q, kThreads, smem, s>>>(l, blocks, Q, k, static_cast<float*>(out_scores),
                                         static_cast<long long*>(out_ids));
  return static_cast<int>(cudaGetLastError());
}

const char* scan_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
