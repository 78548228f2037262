// HNSW level-0 beam search: one thread block per query, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `_beam_kernel` of the JAX package
// (image_search_engine_for_historical_research_tpu/ops/pallas_graph.py:55-270,
// launched by `pallas_beam_search`, :273-367) with the same semantics, so the
// plain PyTorch version (ops/beam_search.py::beam_search_reference), this
// kernel and the TPU kernel give the same beams:
//
//   - the beam has ef_pad slots (ef rounded up to a multiple of 128);
//   - the start node is scored, marked visited and counts as already popped,
//     so its neighbour row is the first one expanded;
//   - each step tests and sets the visited bit of neighbours j = 0..m0-1 in
//     order (-1 entries are skipped and never mark node 0; an id repeated in
//     one row is fresh only the first time), scores the fresh ones with
//     ||v||^2 - 2 q.v + ||q||^2 in f32, then inserts them in j order, each
//     replacing the current worst slot (first index on ties) if strictly
//     closer;
//   - the pop takes the closest unexpanded slot (first index on ties); the
//     loop runs while step < max_steps and an unexpanded slot has d < INF.
//
// What bounds it on the H100: the chain of dependent hops. A hop cannot
// start before the previous pop, and within a hop the neighbour row, the
// fresh rows (8 KB each at D = 2048, f32) and the serial inserts follow one
// another. At the served size (about 6.4 fresh rows a hop, one block) a hop
// moves about 50 KB, far below what HBM streams in one round trip, so the hop
// time is latency: the rows' round trip, the arithmetic on them, the serial
// inserts and the pop, and the hand-offs between warps. At 1M with a random
// graph (about 27 fresh rows a hop, 70 blocks) the rows' bytes set the time
// of phase B, and the serial phases A and C, during which a block reads
// nothing, keep the kernel away from the byte bound.
//
// Design, each part against one link of that chain (the phase clocks below
// measured each on the card):
//   - One block of 16 warps per query; the visited set is a bitset of
//     ceil(N/32) words in dynamic shared memory (125 KB at N = 1M), beside the
//     query row, the beam's ids, the candidates and the neighbour-row cache.
//     The wrapper drops the cache where it does not fit (the kernel then reads
//     the popped node's row from device memory, as the TPU kernel does). Where
//     the bitset does not fit even so (N above about 1.79M at D = 2048), it
//     lives in device memory, one row of words a block (the wrapper's zeroed
//     buffer), and is tested and set by global atomicOr alone:
//     the first lane of each id repeated in a chunk of the row
//     (__match_any_sync) takes the atomic, so the first position stays the
//     fresh one, and no plain load can read a stale L1 line. Warp 0 steers
//     (the visited test, the inserts, the pop); warps 1..15 score rows. They
//     meet at two named barriers a hop, the side that hands work over
//     arriving (bar.arrive) and the side that waits syncing, never at a
//     block-wide __syncthreads.
//   - No device round trip for the neighbour row (A). A scoring warp copies
//     the neighbour row of each fresh node (128 bytes at m0 = 32) into shared
//     memory with cp.async, issued ahead of the node's row loads, and warp 0
//     copies it to nbr_cache[i] when the node enters beam slot i, so the pop
//     hands the next hop its row at once. (A copy started at the insert would
//     still be in flight when the pop takes a node inserted in the same hop;
//     the TPU kernel starts its row DMA after the pop,
//     pallas_graph.py:238-250.) The visited test-and-set takes one shared
//     atomicOr a neighbour; __match_any_sync, which keeps the first of a
//     repeated id, runs only when a repeat is seen.
//   - One round trip for a hop's rows (B). Each scoring warp issues all of a
//     row's 16-byte loads before its first FMA: 16 float4 a lane in f32 and 8
//     uint4 in bf16 cover 2048 values (other D loop over 2048-wide chunks; the
//     query row is zero-padded to whole chunks, so only the tail loads are
//     predicated and the arithmetic has no branch). Each query load from
//     shared memory waits on its row value (`after`), so the row's loads, not
//     the query's, hold the 128 registers a thread has at one block an SM;
//     four partial sums and interleaved warp sums shorten the arithmetic.
//     More fresh rows than scoring warps take a second burst per warp.
//   - Insert and pop with redux.sync (C). Warp 0 holds the beam's distances
//     as order-preserving uint32 keys in registers with an expanded bitmask
//     (ef_pad/32 slots a lane, slot = r*32 + lane, up to 64 a lane, so
//     ef_pad <= 2048); the ids stay in shared memory. The owner lane takes a
//     slot by selects and one predicated store,
//     without a divergent branch, and the distances reach the output from the
//     keys. The arg-max (worst) and the arg-min of the unexpanded slots are
//     __reduce_max/min_sync over each lane's best, then __reduce_min_sync
//     over the slot index of the lanes that hold it: the first index on ties.
//     A ballot skips candidates that are not below the worst key at the start
//     of the hop (the worst only falls); the worst is recomputed only after a
//     replacement, and not at all while the beam fills (the next empty slot
//     is the worst).
//
// Built with -DBEAM_SEARCH_PHASE_CLOCKS, the kernel also sums clock64()
// cycles per block over the phases (A: neighbour row and visited test; B:
// row distances, the longest scoring warp's span on its own clock; C: inserts
// and pop; barrier: warp 0's wait for B less B) and counts hops, pops of a
// slot filled in the same hop, and fresh rows (beam_search_launch_clocks).
// Every phase is a difference of one warp's own clock readings: the counters
// of different warps are not comparable.
//
// The output is the unsorted beam (ids, squared distances), (Q, ef_pad); the
// wrapper sorts it (stable), cuts it to ef and negates the distances.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.4e38f;  // the TPU kernel's sentinel, not +inf
constexpr int kWarps = 16;       // warp 0 steers, warps 1..15 score rows
constexpr int kScorers = kWarps - 1;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBarFresh = 1;     // warp 0 -> scorers: the fresh ids are ready
constexpr int kBarScored = 2;    // scorers -> warp 0: the distances are ready
constexpr int kRowF32 = 16;      // float4 loads a lane issues at once (f32)
constexpr int kRowBf16 = 8;      // uint4 loads a lane issues at once (bf16)
constexpr int kMaxSlots = 64;    // ef_pad <= 32 * kMaxSlots (MAX_EF_PAD in the wrapper)
#ifdef BEAM_SEARCH_PHASE_CLOCKS
constexpr bool kClocks = true;
// per-block clock slots: A, B, C, barrier cycles, hops, same-hop pops,
// fresh rows, total cycles
constexpr int kClockSlots = 8;
#else
constexpr bool kClocks = false;
#endif

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

// clock64() once the shared word *p has been read: a clock read right after
// a barrier can issue before the barrier resolves (the warp waits at its next
// shared-memory access), so branch on a load first
__device__ __forceinline__ unsigned long long clock_after(const int* p) {
  if (*reinterpret_cast<const volatile int*>(p) == 0x7fffffff) __trap();
  return clock64();
}

// f32 -> uint32 with the same order (-0 as +0): flip every bit of a negative
// value, the sign bit of a positive one
__device__ __forceinline__ unsigned order_key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// order_key's inverse
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The index i, made to wait for x (i becomes 0 only if x is NaN, when the
// distance is NaN anyway): a q load at that index then issues once the row
// data x has arrived, not beside the row's loads, where all of them together
// would need 128 registers a lane and spill.
__device__ __forceinline__ int after(int i, float x) {
  asm("{\n\t.reg .pred p;\n\tsetp.nan.f32 p, %1, %1;\n\t@p mov.b32 %0, 0;\n\t}"
      : "+r"(i)
      : "f"(x));
  return i;
}

// two warp sums with their shuffles interleaved
__device__ __forceinline__ void warp_sum2(float a, float b, float& sa, float& sb) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float x = __shfl_xor_sync(kFull, a, o);
    const float y = __shfl_xor_sync(kFull, b, o);
    a += x;
    b += y;
  }
  sa = a;
  sb = b;
}

__device__ __forceinline__ void acc(float& a, float& b, const float4 v,
                                    const float4 w) {
  a += v.x * w.x + v.y * w.y + v.z * w.z + v.w * w.w;
  b += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}

// q . v and ||v||^2 of one database row, summed over one warp; every load of
// a 2048-wide chunk is in flight before the first FMA
__device__ __forceinline__ void row_dot(const float* row, const float* q, int D,
                                        int lane, float& dot, float& sq) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const int nv = D / 4;
  float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
  for (int base = 0; base < nv; base += 32 * kRowF32) {
    float4 v[kRowF32];
#pragma unroll
    for (int u = 0; u < kRowF32; ++u) {
      const int i = base + u * 32 + lane;
      v[u] = i < nv ? __ldg(r4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kRowF32; ++u)  // past the row's end v and q are 0
      acc(a[u & 3], b[u & 3], v[u], q4[after(base + u * 32 + lane, v[u].x)]);
  }
  warp_sum2((a[0] + a[1]) + (a[2] + a[3]), (b[0] + b[1]) + (b[2] + b[3]), dot, sq);
}

__device__ __forceinline__ void row_dot(const __nv_bfloat16* row,
                                        const float* q, int D, int lane,
                                        float& dot, float& sq) {
  const uint4* r8 = reinterpret_cast<const uint4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const int nv = D / 8;
  float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
  for (int base = 0; base < nv; base += 32 * kRowBf16) {
    uint4 v[kRowBf16];
#pragma unroll
    for (int u = 0; u < kRowBf16; ++u) {
      const int i = base + u * 32 + lane;
      v[u] = i < nv ? __ldg(r8 + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kRowBf16; ++u) {  // past the row's end v and q are 0
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[u]);
      const float2 f0 = __bfloat1622float2(h[0]);
      const int i = after(base + u * 32 + lane, f0.x);
      const float2 f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]);
      const float2 f3 = __bfloat1622float2(h[3]);
      acc(a[u & 3], b[u & 3], make_float4(f0.x, f0.y, f1.x, f1.y), q4[2 * i]);
      acc(a[u & 3], b[u & 3], make_float4(f2.x, f2.y, f3.x, f3.y), q4[2 * i + 1]);
    }
  }
  warp_sum2((a[0] + a[1]) + (a[2] + a[3]), (b[0] + b[1]) + (b[2] + b[3]), dot, sq);
}

// One warp scores node `id` into *d_out and, with the cache, copies its
// neighbour row into nbr_out (shared memory) with cp.async, issued ahead of
// the row's loads; the caller waits for the copies (cp.async.wait_all) before
// it hands over.
template <bool kCache, typename T>
__device__ __forceinline__ void score_node(const T* __restrict__ db,
                                           const int* __restrict__ nbr0, int id,
                                           const float* q, float q2, int D,
                                           int m0, int lane, float* d_out,
                                           int* nbr_out) {
  const int* nrow = nbr0 + static_cast<size_t>(id) * m0;
  for (int j = lane; kCache && j < m0; j += 32) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(nbr_out + j));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(nrow + j)
                 : "memory");
  }
  float dot, sq;
  row_dot(db + static_cast<size_t>(id) * D, q, D, lane, dot, sq);
  if (lane == 0) *d_out = sq - 2.f * dot + q2;
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// A bit per slot a lane holds (bit r: slot r * 32 + lane).
template <int S>
struct SlotMask {
  using type = unsigned;
};
template <>
struct SlotMask<64> {
  using type = unsigned long long;
};

// First-index arg-max of the keys held S to a lane (slot = r * 32 + lane).
template <int S>
__device__ __forceinline__ void warp_argmax(const unsigned (&key)[S], int lane,
                                            unsigned& bk, int& bs) {
  unsigned k = key[0];
  int r = 0;
#pragma unroll
  for (int i = 1; i < S; ++i)
    if (key[i] > k) { k = key[i]; r = i; }
  bk = __reduce_max_sync(kFull, k);
  bs = static_cast<int>(__reduce_min_sync(
      kFull, k == bk ? static_cast<unsigned>(r * 32 + lane) : kFull));
}

// First-index arg-min over the unexpanded slots (expanded ones count as
// inf_key).
template <int S, typename M>
__device__ __forceinline__ void warp_argmin_open(const unsigned (&key)[S],
                                                 M expanded,
                                                 unsigned inf_key, int lane,
                                                 unsigned& bk, int& bs) {
  unsigned k = (expanded & M(1)) ? inf_key : key[0];
  int r = 0;
#pragma unroll
  for (int i = 1; i < S; ++i) {
    const unsigned x = ((expanded >> i) & M(1)) ? inf_key : key[i];
    if (x < k) { k = x; r = i; }
  }
  bk = __reduce_min_sync(kFull, k);
  bs = static_cast<int>(__reduce_min_sync(
      kFull, k == bk ? static_cast<unsigned>(r * 32 + lane) : kFull));
}

struct Layout {
  size_t q, beam_id, cand_id, cand_d, scal, cand_nbr, nbr_cache, visited, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// D rounded up to the width one burst covers (32 lanes x 16 float4 = 2048)
__host__ __device__ inline int padded_d(int D) { return (D + 2047) / 2048 * 2048; }

// cache = false leaves out the neighbour-row cache and its staging rows;
// smem_visited = false leaves out the visited bitset (it is in device memory)
__host__ __device__ inline Layout layout(int N, int D, int m0, int ef_pad, bool cache,
                                         bool smem_visited) {
  Layout l;
  l.q = 0;  // the query row, zero-padded to whole 2048-wide chunks
  l.beam_id = align16(l.q + sizeof(float) * padded_d(D));
  l.cand_id = l.beam_id + sizeof(int) * ef_pad;
  l.cand_d = l.cand_id + sizeof(int) * m0;
  l.scal = l.cand_d + sizeof(float) * m0;
  l.cand_nbr = align16(l.scal + sizeof(int) * 4);
  l.nbr_cache = l.cand_nbr + (cache ? sizeof(int) * m0 * m0 : 0);
  l.visited = align16(l.nbr_cache + (cache ? sizeof(int) * ef_pad * m0 : 0));
  l.total = l.visited + (smem_visited ? sizeof(uint32_t) * ((N + 31) / 32) : 0);
  return l;
}

// kCache: with the neighbour-row cache (a template argument: as a runtime
// flag its branches slowed every hop)
template <typename T, int S, bool kCache>
__global__ void __launch_bounds__(kThreads, 1)  // one block an SM: 128 registers a thread
beam_kernel(const T* __restrict__ db, const int* __restrict__ nbr0,
            const float* __restrict__ queries, const int* __restrict__ starts,
            int N, int D, int m0, int ef_pad, int max_steps,
            uint32_t* __restrict__ visited_g, int* __restrict__ out_ids,
            float* __restrict__ out_d, unsigned long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
#ifdef BEAM_SEARCH_PHASE_CLOCKS
  __shared__ unsigned long long clk_work[kWarps];  // a warp's B, own clock
  __shared__ unsigned long long clk_sum[kClockSlots];
  if (threadIdx.x < kClockSlots) clk_sum[threadIdx.x] = 0;
#endif
  const unsigned long long t_begin = kClocks ? clock64() : 0;
  // visited_g: a (gridDim.x, ceil(N/32)) bitset in device memory, or null
  // for the bitset in shared memory
  const bool gvis = visited_g != nullptr;
  const Layout L = layout(N, D, m0, ef_pad, kCache, !gvis);
  float* q = reinterpret_cast<float*>(smem + L.q);
  int* beam_id = reinterpret_cast<int*>(smem + L.beam_id);
  int* cand_id = reinterpret_cast<int*>(smem + L.cand_id);
  float* cand_d = reinterpret_cast<float*>(smem + L.cand_d);
  int* scal = reinterpret_cast<int*>(smem + L.scal);  // n_fresh, -1 = stop
  // (m0, m0) and (ef_pad, m0), or null without the cache
  int* cand_nbr = kCache ? reinterpret_cast<int*>(smem + L.cand_nbr) : nullptr;
  int* nbr_cache = kCache ? reinterpret_cast<int*>(smem + L.nbr_cache) : nullptr;
  uint32_t* visited = reinterpret_cast<uint32_t*>(smem + L.visited);

  const int qid = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int vw = (N + 31) / 32;
  const int start = starts[qid];
  uint32_t* vg = gvis ? visited_g + static_cast<size_t>(qid) * vw : nullptr;

  const float* qg = queries + static_cast<size_t>(qid) * D;
  for (int i = tid; i < padded_d(D); i += kThreads) q[i] = i < D ? qg[i] : 0.f;
  for (int i = tid; !gvis && i < vw; i += kThreads) visited[i] = 0u;
  for (int i = tid; i < ef_pad; i += kThreads) beam_id[i] = i == 0 ? start : -1;
  __syncthreads();

  // ||q||^2, held by every warp
  float q2 = 0.f;
  for (int i = lane; i < D; i += 32) q2 += q[i] * q[i];
  q2 = warp_sum(q2);

  // seed: score the start node (its distance into cand_d[0], its neighbour
  // row into slot 0's cache row if there is a cache) and mark it visited; it
  // enters slot 0 popped
  if (warp == 1) {
    score_node<kCache>(db, nbr0, start, q, q2, D, m0, lane, &cand_d[0], nbr_cache);
    wait_copies();
    if (lane == 0 && gvis) atomicOr(vg + (start >> 5), 1u << (start & 31));
    if (lane == 0 && !gvis) visited[start >> 5] |= 1u << (start & 31);
  }
  __syncthreads();

  if (warp == 0) {
    const unsigned inf_key = order_key(kInf);
    using M = typename SlotMask<S>::type;
    unsigned key[S];   // the beam's distances: slot r * 32 + lane
    M expanded = 0u;   // bit r: slot r * 32 + lane
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const int s = r * 32 + lane;
      key[r] = s < ef_pad ? inf_key : 0u;  // dead slots: never worst, never open
      if (s >= ef_pad) expanded |= M(1) << r;
    }
    if (lane == 0) {
      key[0] = order_key(cand_d[0]);
      expanded |= M(1);
    }
    unsigned wk;  // the worst slot's key and index
    int ws;
    warp_argmax(key, lane, wk, ws);
    int popped = 0;
    bool cont = true;
    for (int step = 0;; ++step) {
      unsigned long long t0 = 0, t1 = 0, t2 = 0;
      if (kClocks) t0 = clock64();
      if (step >= max_steps || !cont) {
        if (lane == 0) scal[0] = -1;
        __syncwarp();
        bar_arrive(kBarFresh);
        break;
      }
      // A. the popped node's neighbour row from the cache (without one, from
      //    device memory): visited test-and-set in j order, fresh ids
      //    compacted in j order
      const int* row = kCache ? nbr_cache + popped * m0
                              : nbr0 + static_cast<size_t>(beam_id[popped]) * m0;
      int n_fresh = 0;
      for (int base = 0; gvis && base < m0; base += 32) {  // bitset in device memory
        const int j = base + lane;
        const int nid = j < m0 ? row[j] : -1;
        const unsigned peers = __match_any_sync(kFull, nid >= 0 ? nid : -1 - lane);
        const bool won = nid >= 0 && __ffs(peers) - 1 == lane &&
                         (atomicOr(vg + (nid >> 5), 1u << (nid & 31)) & (1u << (nid & 31))) == 0u;
        const unsigned fm = __ballot_sync(kFull, won);
        if (won) cand_id[n_fresh + __popc(fm & ((1u << lane) - 1u))] = nid;
        n_fresh += __popc(fm);
        __syncwarp();
      }
      for (int base = 0; !gvis && base < m0; base += 32) {
        const int j = base + lane;
        const int nid = j < m0 ? row[j] : -1;
        const bool cand = nid >= 0 && (visited[nid >> 5] & (1u << (nid & 31))) == 0u;
        __syncwarp();
        const bool won = cand && (atomicOr(&visited[nid >> 5], 1u << (nid & 31)) &
                                  (1u << (nid & 31))) == 0u;
        const unsigned cm = __ballot_sync(kFull, cand);
        unsigned fm = __ballot_sync(kFull, won);
        if (fm != cm) {  // an unvisited id repeated in the chunk: the first is fresh
          const unsigned peers = __match_any_sync(kFull, cand ? nid : -1 - lane);
          fm = __ballot_sync(kFull, cand && __ffs(peers) - 1 == lane);
        }
        const bool fresh = (fm >> lane) & 1u;
        if (fresh) cand_id[n_fresh + __popc(fm & ((1u << lane) - 1u))] = nid;
        n_fresh += __popc(fm);
        __syncwarp();
      }
      if (lane == 0) scal[0] = n_fresh;
      __syncwarp();
      if (kClocks) t1 = clock64();
      bar_arrive(kBarFresh);

      bar_sync(kBarScored);
      if (kClocks) t2 = clock_after(scal);

      // C. inserts in j order, then the pop
      M touched = 0u;  // slots filled in this hop (clock build)
      for (int base = 0; base < n_fresh; base += 32) {
        const int k = base + lane;
        const unsigned ck = k < n_fresh ? order_key(cand_d[k]) : kFull;
        const int cid = k < n_fresh ? cand_id[k] : -1;
        unsigned pending = __ballot_sync(kFull, ck < wk);
        while (pending) {
          const int src = __ffs(pending) - 1;
          pending &= pending - 1u;
          const unsigned kk = __shfl_sync(kFull, ck, src);
          if (kk >= wk) continue;  // warp-uniform
          const int id = __shfl_sync(kFull, cid, src);
          if (kCache) {
            const int* from = cand_nbr + (base + src) * m0;
            int* to = nbr_cache + ws * m0;
            if (lane < m0) to[lane] = from[lane];
            for (int j = lane + 32; j < m0; j += 32) to[j] = from[j];
          }
          // the owner lane takes the slot, without a divergent branch
          const int wr = ws >> 5;
          const bool own = lane == (ws & 31);
          if (own) beam_id[ws] = id;
#pragma unroll
          for (int r = 0; r < S; ++r) key[r] = own && r == wr ? kk : key[r];
          const M bit = own ? M(1) << wr : M(0);
          expanded &= ~bit;
          touched |= bit;
          if (wk == inf_key && ws + 1 < ef_pad)
            ++ws;  // filling: slots < ws are taken, the rest empty
          else
            warp_argmax(key, lane, wk, ws);
        }
      }
      unsigned mk;
      int ms;
      warp_argmin_open(key, expanded, inf_key, lane, mk, ms);
      cont = mk < inf_key;
      if (cont) {
        if (lane == (ms & 31)) expanded |= M(1) << (ms >> 5);
        popped = ms;
      }
      __syncwarp();
#ifdef BEAM_SEARCH_PHASE_CLOCKS
      const unsigned long long t3 = clock64();
      unsigned long long b = clk_work[1];
      for (int w = 2; w < kWarps; ++w) b = max(b, clk_work[w]);
      const unsigned same = __shfl_sync(
          kFull, static_cast<unsigned>((touched >> (ms >> 5)) & M(1)), ms & 31);
      if (lane == 0) {
        clk_sum[0] += t1 - t0;
        clk_sum[1] += b;
        clk_sum[2] += t3 - t2;
        clk_sum[3] += (t2 - t1) - b;
        clk_sum[4] += 1;
        clk_sum[5] += cont ? same : 0u;
        clk_sum[6] += n_fresh;
      }
#else
      (void)touched;
      (void)t1;
      (void)t2;
#endif
    }
    // the beam, unsorted: ids from shared memory, distances from the keys
    __syncwarp();
    const size_t row = static_cast<size_t>(qid) * ef_pad;
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const int s = r * 32 + lane;
      if (s < ef_pad) {
        out_ids[row + s] = beam_id[s];
        out_d[row + s] = key_value(key[r]);
      }
    }
#ifdef BEAM_SEARCH_PHASE_CLOCKS
    if (lane == 0 && clocks != nullptr) {
      clk_sum[7] = clock64() - t_begin;
      for (int i = 0; i < kClockSlots; ++i) clocks[static_cast<size_t>(qid) * kClockSlots + i] = clk_sum[i];
    }
#endif
  } else {
    // B. distances and neighbour rows of the fresh nodes, one node per warp
    for (;;) {
      bar_sync(kBarFresh);
      const int n_fresh = scal[0];
      if (n_fresh < 0) break;
#ifdef BEAM_SEARCH_PHASE_CLOCKS
      // the start parks in shared memory: a register held across the rows'
      // burst would spill
      const unsigned long long b0 = clock_after(scal);
      if (lane == 0) clk_work[warp] = b0;
#endif
      for (int k = warp - 1; k < n_fresh; k += kScorers)
        score_node<kCache>(db, nbr0, cand_id[k], q, q2, D, m0, lane, &cand_d[k],
                           kCache ? cand_nbr + k * m0 : nullptr);
      wait_copies();
#ifdef BEAM_SEARCH_PHASE_CLOCKS
      if (lane == 0) clk_work[warp] = clock64() - clk_work[warp];
#endif
      __syncwarp();
      bar_arrive(kBarScored);
    }
  }
#ifndef BEAM_SEARCH_PHASE_CLOCKS
  (void)t_begin;
  (void)clocks;
#endif
}

template <typename T, int S, bool kCache>
int launch_kernel(const void* db, const void* nbr0, const void* queries,
                  const void* starts, int N, int D, int m0, int Q, int ef_pad,
                  int max_steps, void* visited, void* out_ids, void* out_d,
                  void* clocks, void* stream) {
  const size_t smem = layout(N, D, m0, ef_pad, kCache, visited == nullptr).total;
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel<T, S, kCache>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_kernel<T, S, kCache><<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(db), static_cast<const int*>(nbr0),
      static_cast<const float*>(queries), static_cast<const int*>(starts), N, D,
      m0, ef_pad, max_steps, static_cast<uint32_t*>(visited),
      static_cast<int*>(out_ids), static_cast<float*>(out_d),
      static_cast<unsigned long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int launch(const void* db, const void* nbr0, const void* queries,
           const void* starts, int N, int D, int m0, int Q, int ef_pad,
           int max_steps, int cache, void* visited, void* out_ids, void* out_d,
           void* clocks, void* stream) {
  return cache ? launch_kernel<T, S, true>(db, nbr0, queries, starts, N, D, m0, Q,
                                           ef_pad, max_steps, visited, out_ids,
                                           out_d, clocks, stream)
               : launch_kernel<T, S, false>(db, nbr0, queries, starts, N, D, m0, Q,
                                            ef_pad, max_steps, visited, out_ids,
                                            out_d, clocks, stream);
}

// the beam's registers per lane: ef_pad / 32 rounded up to 4, 8, 16, 32 or 64
template <typename T>
int launch_slots(const void* db, const void* nbr0, const void* queries,
                 const void* starts, int N, int D, int m0, int Q, int ef_pad,
                 int max_steps, int cache, void* visited, void* out_ids,
                 void* out_d, void* clocks, void* stream) {
  const int slots = (ef_pad + 31) / 32;
#define BEAM_SEARCH_LAUNCH(S)                                                    \
  launch<T, S>(db, nbr0, queries, starts, N, D, m0, Q, ef_pad, max_steps, cache, \
               visited, out_ids, out_d, clocks, stream)
  if (slots <= 4) return BEAM_SEARCH_LAUNCH(4);
  if (slots <= 8) return BEAM_SEARCH_LAUNCH(8);
  if (slots <= 16) return BEAM_SEARCH_LAUNCH(16);
  if (slots <= 32) return BEAM_SEARCH_LAUNCH(32);
  if (slots <= kMaxSlots) return BEAM_SEARCH_LAUNCH(kMaxSlots);
#undef BEAM_SEARCH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const void* db, int db_is_bf16, const void* nbr0,
             const void* queries, const void* starts, int N, int D, int m0,
             int Q, int ef_pad, int max_steps, int cache, void* visited,
             void* out_ids, void* out_d, void* clocks, void* stream) {
  if (db_is_bf16)
    return launch_slots<__nv_bfloat16>(db, nbr0, queries, starts, N, D, m0, Q,
                                       ef_pad, max_steps, cache, visited, out_ids,
                                       out_d, clocks, stream);
  return launch_slots<float>(db, nbr0, queries, starts, N, D, m0, Q, ef_pad,
                             max_steps, cache, visited, out_ids, out_d, clocks,
                             stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs: the query row, the beam's ids, the
// candidates, with cache = 1 the neighbour-row cache and, with smem_visited =
// 1, the visited bitset.
size_t beam_search_smem_bytes(int N, int D, int m0, int ef_pad, int cache,
                              int smem_visited) {
  return layout(N, D, m0, ef_pad, cache != 0, smem_visited != 0).total;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// db: (N, D) f32 (db_is_bf16 = 0) or bf16 (1), rows 16-byte aligned, D % 8 == 0;
// nbr0: (N, m0) int32, -1 padded; queries: (Q, D) f32; starts: (Q,) int32 in
// [0, N); out_ids: (Q, ef_pad) int32; out_d: (Q, ef_pad) f32; ef_pad % 32 == 0,
// ef_pad <= 2048; cache: 1 keeps the neighbour rows of the beam's nodes in
// shared memory, 0 reads the popped node's row from device memory; visited:
// null keeps the visited bitset in shared memory, else (Q, ceil(N/32)) uint32
// words in device memory, all zero.
int beam_search_launch(const void* db, int db_is_bf16, const void* nbr0,
                       const void* queries, const void* starts, int N, int D,
                       int m0, int Q, int ef_pad, int max_steps, int cache,
                       void* visited, void* out_ids, void* out_d, void* stream) {
  return dispatch(db, db_is_bf16, nbr0, queries, starts, N, D, m0, Q, ef_pad,
                  max_steps, cache, visited, out_ids, out_d, nullptr, stream);
}

#ifdef BEAM_SEARCH_PHASE_CLOCKS
// As beam_search_launch, and also writes clocks: (Q, 8) uint64 per block.
int beam_search_launch_clocks(const void* db, int db_is_bf16, const void* nbr0,
                              const void* queries, const void* starts, int N,
                              int D, int m0, int Q, int ef_pad, int max_steps,
                              int cache, void* visited, void* out_ids,
                              void* out_d, void* clocks, void* stream) {
  return dispatch(db, db_is_bf16, nbr0, queries, starts, N, D, m0, Q, ef_pad,
                  max_steps, cache, visited, out_ids, out_d, clocks, stream);
}
#endif

const char* beam_search_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
