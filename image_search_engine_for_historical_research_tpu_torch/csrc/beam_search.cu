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
// What bounds it on the H100: the chain of dependent hops. Each step needs
// the popped node's neighbour row before it knows which database rows to
// read, then reads about 8 KB (D = 2048, f32) for every fresh neighbour, then
// runs a serial insert and pop. At the served shapes a step moves tens of KB,
// far below what HBM could stream in the step's latency; the kernel is
// latency-bound, not bandwidth-bound.
//
// Design (simple first):
//   - one block of 16 warps per query, so Q queries run on Q SMs at once;
//   - the visited set is a bitset of ceil(N/32) words in dynamic shared
//     memory (125 KB at N = 1M), zeroed at block start; the query row (8 KB
//     at D = 2048, f32) and the beam also live in shared memory. The wrapper
//     refuses N whose bitset does not fit (about 1.7M at D = 2048);
//   - warp 0 reads the neighbour row and does the visited test-and-set for 32
//     neighbours at a time: __match_any_sync finds repeats within the row, so
//     only the first lane of an id may be fresh, which is the serial order's
//     result; the fresh ids are compacted in j order;
//   - the 16 warps score the fresh rows, one row per warp at a time, with
//     16-byte loads and shuffle reductions;
//   - warp 0 does the serial inserts (recomputing the worst slot only after a
//     replacement) and the pop, with warp-wide first-index arg-max/arg-min.
//
// The output is the unsorted beam (ids, squared distances), (Q, ef_pad); the
// wrapper sorts it (stable), cuts it to ef and negates the distances.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.4e38f;  // the TPU kernel's sentinel, not +inf
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// q . v and ||v||^2 of one database row, summed over one warp.
__device__ __forceinline__ void row_dot(const float* row, const float* q, int D,
                                        int lane, float& dot, float& sq) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float a = 0.f, b = 0.f;
  for (int i = lane; i < D / 4; i += 32) {
    const float4 v = __ldg(r4 + i);
    const float4 w = q4[i];
    a += v.x * w.x + v.y * w.y + v.z * w.z + v.w * w.w;
    b += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  dot = warp_sum(a);
  sq = warp_sum(b);
}

__device__ __forceinline__ void row_dot(const __nv_bfloat16* row,
                                        const float* q, int D, int lane,
                                        float& dot, float& sq) {
  const uint4* r8 = reinterpret_cast<const uint4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float a = 0.f, b = 0.f;
  for (int i = lane; i < D / 8; i += 32) {
    const uint4 raw = __ldg(r8 + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(h[0]);
    const float2 f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]);
    const float2 f3 = __bfloat1622float2(h[3]);
    const float4 w0 = q4[2 * i];
    const float4 w1 = q4[2 * i + 1];
    a += f0.x * w0.x + f0.y * w0.y + f1.x * w0.z + f1.y * w0.w +
         f2.x * w1.x + f2.y * w1.y + f3.x * w1.z + f3.y * w1.w;
    b += f0.x * f0.x + f0.y * f0.y + f1.x * f1.x + f1.y * f1.y +
         f2.x * f2.x + f2.y * f2.y + f3.x * f3.x + f3.y * f3.y;
  }
  dot = warp_sum(a);
  sq = warp_sum(b);
}

// Warp-wide arg-max of a[0..n): the largest value, the lowest index on ties.
__device__ __forceinline__ void warp_argmax(const float* a, int n, int lane,
                                            float& bv, int& bi) {
  float v = -INFINITY;
  int idx = 0x7fffffff;
  for (int i = lane; i < n; i += 32) {
    const float x = a[i];
    if (x > v) { v = x; idx = i; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (ov > v || (ov == v && oi < idx)) { v = ov; idx = oi; }
  }
  bv = v;
  bi = idx;
}

// Warp-wide arg-min over the unexpanded slots (expanded ones count as kInf),
// the lowest index on ties.
__device__ __forceinline__ void warp_argmin_open(const float* a,
                                                 const int* expanded, int n,
                                                 int lane, float& bv, int& bi) {
  float v = INFINITY;
  int idx = 0x7fffffff;
  for (int i = lane; i < n; i += 32) {
    const float x = expanded[i] ? kInf : a[i];
    if (x < v) { v = x; idx = i; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (ov < v || (ov == v && oi < idx)) { v = ov; idx = oi; }
  }
  bv = v;
  bi = idx;
}

struct Layout {
  size_t q, beam_d, beam_id, expanded, cand_id, cand_d, scal, visited, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int N, int D, int m0, int ef_pad) {
  Layout l;
  l.q = 0;
  l.beam_d = align16(l.q + sizeof(float) * D);
  l.beam_id = l.beam_d + sizeof(float) * ef_pad;
  l.expanded = l.beam_id + sizeof(int) * ef_pad;
  l.cand_id = l.expanded + sizeof(int) * ef_pad;
  l.cand_d = l.cand_id + sizeof(int) * m0;
  l.scal = l.cand_d + sizeof(float) * m0;
  l.visited = align16(l.scal + sizeof(int) * 4);
  l.total = l.visited + sizeof(uint32_t) * ((N + 31) / 32);
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
beam_kernel(const T* __restrict__ db, const int* __restrict__ nbr0,
            const float* __restrict__ queries, const int* __restrict__ starts,
            int N, int D, int m0, int ef_pad, int max_steps,
            int* __restrict__ out_ids, float* __restrict__ out_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(N, D, m0, ef_pad);
  float* q = reinterpret_cast<float*>(smem + L.q);
  float* beam_d = reinterpret_cast<float*>(smem + L.beam_d);
  int* beam_id = reinterpret_cast<int*>(smem + L.beam_id);
  int* expanded = reinterpret_cast<int*>(smem + L.expanded);
  int* cand_id = reinterpret_cast<int*>(smem + L.cand_id);
  float* cand_d = reinterpret_cast<float*>(smem + L.cand_d);
  int* scal = reinterpret_cast<int*>(smem + L.scal);  // node, cont, n_fresh
  uint32_t* visited = reinterpret_cast<uint32_t*>(smem + L.visited);

  const int qid = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int vw = (N + 31) / 32;

  const float* qg = queries + static_cast<size_t>(qid) * D;
  for (int i = tid; i < D; i += kThreads) q[i] = qg[i];
  for (int i = tid; i < vw; i += kThreads) visited[i] = 0u;
  for (int i = tid; i < ef_pad; i += kThreads) {
    beam_d[i] = kInf;
    beam_id[i] = -1;
    expanded[i] = 0;
  }
  __syncthreads();

  // ||q||^2, held by every warp
  float q2 = 0.f;
  for (int i = lane; i < D; i += 32) q2 += q[i] * q[i];
  q2 = warp_sum(q2);

  // seed: score the start node, mark it visited and popped
  const int start = starts[qid];
  if (warp == 0) {
    float dot, sq;
    row_dot(db + static_cast<size_t>(start) * D, q, D, lane, dot, sq);
    if (lane == 0) {
      beam_d[0] = sq - 2.f * dot + q2;
      beam_id[0] = start;
      expanded[0] = 1;
      visited[start >> 5] |= 1u << (start & 31);
      scal[0] = start;
      scal[1] = 1;
    }
  }
  __syncthreads();

  for (int step = 0; step < max_steps; ++step) {
    // A. neighbour row of the popped node: visited test-and-set in j order,
    //    fresh ids compacted in j order
    if (warp == 0) {
      const int* row = nbr0 + static_cast<size_t>(scal[0]) * m0;
      int n_fresh = 0;
      for (int base = 0; base < m0; base += 32) {
        const int j = base + lane;
        const int nid = j < m0 ? __ldg(row + j) : -1;
        const unsigned peers = __match_any_sync(kFull, nid);
        bool fresh = false;
        if (nid >= 0 && __ffs(peers) - 1 == lane)
          fresh = (visited[nid >> 5] & (1u << (nid & 31))) == 0u;
        __syncwarp();
        if (fresh) atomicOr(&visited[nid >> 5], 1u << (nid & 31));
        const unsigned fm = __ballot_sync(kFull, fresh);
        if (fresh) cand_id[n_fresh + __popc(fm & ((1u << lane) - 1u))] = nid;
        n_fresh += __popc(fm);
        __syncwarp();
      }
      if (lane == 0) scal[2] = n_fresh;
    }
    __syncthreads();

    // B. distances of the fresh rows, one row per warp at a time
    const int n_fresh = scal[2];
    for (int k = warp; k < n_fresh; k += kWarps) {
      float dot, sq;
      row_dot(db + static_cast<size_t>(cand_id[k]) * D, q, D, lane, dot, sq);
      if (lane == 0) cand_d[k] = sq - 2.f * dot + q2;
    }
    __syncthreads();

    // C. serial inserts, then the pop
    if (warp == 0) {
      float wd;
      int wi;
      warp_argmax(beam_d, ef_pad, lane, wd, wi);
      for (int k = 0; k < n_fresh; ++k) {
        const float d = cand_d[k];
        if (d < wd) {
          if (lane == 0) {
            beam_d[wi] = d;
            beam_id[wi] = cand_id[k];
            expanded[wi] = 0;
          }
          __syncwarp();
          warp_argmax(beam_d, ef_pad, lane, wd, wi);
        }
      }
      float md;
      int mi;
      warp_argmin_open(beam_d, expanded, ef_pad, lane, md, mi);
      const int cont = md < kInf;
      if (lane == 0) {
        if (cont) {
          scal[0] = beam_id[mi];
          expanded[mi] = 1;
        }
        scal[1] = cont;
      }
    }
    __syncthreads();
    if (!scal[1]) break;
  }

  for (int i = tid; i < ef_pad; i += kThreads) {
    out_ids[static_cast<size_t>(qid) * ef_pad + i] = beam_id[i];
    out_d[static_cast<size_t>(qid) * ef_pad + i] = beam_d[i];
  }
}

template <typename T>
int launch(const void* db, const void* nbr0, const void* queries,
           const void* starts, int N, int D, int m0, int Q, int ef_pad,
           int max_steps, void* out_ids, void* out_d, void* stream) {
  const size_t smem = layout(N, D, m0, ef_pad).total;
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_kernel<T><<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(db), static_cast<const int*>(nbr0),
      static_cast<const float*>(queries), static_cast<const int*>(starts), N, D,
      m0, ef_pad, max_steps, static_cast<int*>(out_ids),
      static_cast<float*>(out_d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs: the visited bitset, the query row,
// the beam and the candidate list.
size_t beam_search_smem_bytes(int N, int D, int m0, int ef_pad) {
  return layout(N, D, m0, ef_pad).total;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// db: (N, D) f32 (db_is_bf16 = 0) or bf16 (1), rows 16-byte aligned, D % 8 == 0;
// nbr0: (N, m0) int32, -1 padded; queries: (Q, D) f32; starts: (Q,) int32 in
// [0, N); out_ids: (Q, ef_pad) int32; out_d: (Q, ef_pad) f32; ef_pad % 32 == 0.
int beam_search_launch(const void* db, int db_is_bf16, const void* nbr0,
                       const void* queries, const void* starts, int N, int D,
                       int m0, int Q, int ef_pad, int max_steps, void* out_ids,
                       void* out_d, void* stream) {
  if (db_is_bf16)
    return launch<__nv_bfloat16>(db, nbr0, queries, starts, N, D, m0, Q, ef_pad,
                                 max_steps, out_ids, out_d, stream);
  return launch<float>(db, nbr0, queries, starts, N, D, m0, Q, ef_pad,
                       max_steps, out_ids, out_d, stream);
}

const char* beam_search_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
