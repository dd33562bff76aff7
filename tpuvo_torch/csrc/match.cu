// Brute-force top-2 descriptor matcher with Lowe's ratio test.
//
// Replaces the TPU kernel tpuvo/ops/pallas/match_kernel.py:_tile_kernel
// (launched by match_topk_pallas).  For each query row it finds the best
// (first index on ties) and second-best squared-L2 distance over the valid
// map columns, with distance |a|^2 + |b|^2 - 2 a.b clamped at 0, and writes
// the acceptance decision (best < dist_thr, best/second < ratio_thr, query
// valid) — the whole MatchResult in one launch.  Each sum is one fmaf chain
// over the descriptor in index order, so a map entry equal to the query is
// at distance exactly 0 and exact duplicates in the map tie exactly: the
// ratio test then rejects them in the kernel and its plain version alike,
// instead of deciding on rounding noise.
//
// What bounds it on an H100: fp32 operations.  The products take 2·N·M·D
// FLOP: at the tracker's shape (N = 128 queries, M = 8192 map slots,
// D = 10) 21 MFLOP, 0.31 us at 67 TFLOP/s, against 0.10 us for its 343 KB;
// at the refiner's topology shape (N = 25,600) 4.2 GFLOP, 62.6 us, against
// 0.54 us for 1.8 MB.  D = 10 gives the tensor cores nothing to do, and the
// exact-tie rule forbids a reordered sum.  At N = 128 the work is too small
// to fill the card, so the time is latency: the launch, the loads, the
// tile steps and the merge.  The design:
//   * the queries live in registers (D is a template parameter: 10, the
//     engine's descriptor, and 64, which takes any D <= 64 zero-padded: a
//     trailing fmaf(0, 0, s) leaves every chain's bits unchanged); a block
//     of 128 threads takes qb query rows as (qb / QPT) query slots x
//     (128 / slots) row lanes, each thread holding QPT queries — 4 in the
//     throughput regime, so one shared-memory row load feeds 4 queries;
//   * the map streams through shared memory in tiles of kRows rows, with
//     16-byte cp.async into a ring of kStages stages (3 tiles in flight);
//     one pass then writes each row beside its |b|^2 — computed ONCE per
//     row, in the descriptor-order fmaf chain — with invalid and
//     past-the-end rows zeroed and |b|^2 = inf, so the inner loop has no
//     validity test.  Each step computes QPT x U distances branch-free
//     (independent fma chains); a query's top-2 is updated, with selects,
//     only when the minimum of its U beats its runner-up;
//   * the map is split across the blocks of a thread-block cluster
//     (grid.x = cluster size <= 8, portable); partial top-2s merge across
//     the row lanes of a block, then across the cluster through
//     distributed shared memory, comparing (dist, idx) lexicographically —
//     the first-index rule holds in any merge order, so a duplicate pair
//     split across two blocks still gives the lower index.
//     At N = 128: tiles of 16 queries x 8 splits = 64 blocks.  At the
//     topology shape: tiles of 256 queries (4 a thread) x 8 splits = 800
//     blocks, each reading its eighth of the map from L2 once;
//   * lanes (the batched tracker: B sequences, each matched against its own
//     map) go on blockIdx.z, each lane's arrays at its own lane stride (0
//     shares one lane's array among all); the cluster stays (splits, 1, 1),
//     inside one lane.  At B = 256, N = 128: one 128-query tile (4 a
//     thread) per lane.
// Tile and cluster sizes are chosen by the wrapper
// (ops/cuda/match_kernel.launch_plan).  Alignment is the kernel's own
// affair: a lane's map that starts off 16 bytes (a lane stride of M·D
// floats with M·D not a multiple of 4, or a view) is copied in 4-byte
// pieces, and valid flags off 4 bytes by plain loads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSplits = 8;
constexpr int kMaxQueries = 512;  // qb <= 128 slots x 4 queries

template <int DP, int QPT>
struct Shape {
  static constexpr int kRows = DP <= 16 ? 128 : 32;     // map rows per staged tile
  static constexpr int kStages = DP <= 16 ? 4 : 2;      // cp.async ring
  static constexpr int kStride = (DP + 1 + 3) / 4 * 4;  // row floats: DP, |b|^2, pad
  static constexpr int kUnroll = DP > 16 ? 1 : (QPT == 1 ? 8 : 4);  // rows in flight
  static_assert(kRows <= kThreads, "one converting thread per row");
  static_assert((kRows * DP * 4) % 16 == 0, "16-byte copies fill a stage exactly");
};

struct Top2 {
  float best;
  int idx;
  float second;
};

// merge two partial top-2s: the winner is the lexicographically smaller
// (best, idx); the runner-up is the better of the winner's second and the
// loser's best (the loser's second is never smaller than its best)
// (by value and with selects: references into a or b would put both on
// the stack)
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool a_wins = (a.best < b.best) || (a.best == b.best && a.idx < b.idx);
  return Top2{a_wins ? a.best : b.best, a_wins ? a.idx : b.idx,
              fminf(a_wins ? a.second : b.second, a_wins ? b.best : a.best)};
}

// a barrier over the cluster's threads that orders shared-memory writes
// before it and reads after it across the cluster: release/acquire at
// cluster scope (cg::cluster_group::sync adds a GPU-wide fence)
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// cp.async of `bytes` (1..16 / 1..4) source bytes, the rest of the 16 / 4
// destination bytes zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// thread's copies of `bytes` bytes from src into dst (dst 16-byte aligned;
// src 16-byte aligned for copy16, 4 for copy4)
__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes, int tid) {
  for (int e = tid * 16; e < bytes; e += kThreads * 16)
    cp_async16((char*)dst + e, (const char*)src + e, min(16, bytes - e));
}
__device__ __forceinline__ void copy4(void* dst, const void* src, int bytes, int tid) {
  for (int e = tid * 4; e < bytes; e += kThreads * 4)
    cp_async4((char*)dst + e, (const char*)src + e, min(4, bytes - e));
}
// the map rows: 16-byte copies where the lane's rows allow them
__device__ __forceinline__ void copy_rows(void* dst, const float* src, int bytes, bool vec,
                                          int tid) {
  if (vec) copy16(dst, src, bytes, tid);
  else copy4(dst, src, bytes, tid);
}
// valid flags: 4-byte copies, or plain byte loads from an unaligned lane
// (visible to the block at its next barrier, like the copies)
__device__ __forceinline__ void copy_flags(uint8_t* dst, const uint8_t* src, int n, bool word,
                                           int tid) {
  if (word) copy4(dst, src, n, tid);
  else
    for (int e = tid; e < n; e += kThreads) dst[e] = src[e];
}

template <int DP, int QPT>
__global__ void __launch_bounds__(kThreads) match_top2_kernel(
    const float* __restrict__ d1,        // (B, N, D), lane stride s_d1
    const uint8_t* __restrict__ v1,      // (B, N), lane stride s_v1
    const float* __restrict__ d2,        // (B, M, D), lane stride s_d2
    const uint8_t* __restrict__ v2,      // (B, M), lane stride s_v2
    float* __restrict__ best_out,        // (B, N)
    int64_t* __restrict__ idx_out,       // (B, N)
    float* __restrict__ second_out,      // (B, N)
    uint8_t* __restrict__ accept_out,    // (B, N)
    int N, int M, int D, int64_t s_d1, int64_t s_v1, int64_t s_d2, int64_t s_v2, int qb,
    int tiles_per_split, float dist_thr, float ratio_thr) {
  using S = Shape<DP, QPT>;
  constexpr int R = S::kRows, NS = S::kStages, ST = S::kStride, U = S::kUnroll;
  __shared__ __align__(16) float raw[NS][R * DP];    // cp.async ring: rows as they lie in d2
  __shared__ __align__(16) uint8_t raw_v[NS][R];     // ... and their valid flags
  __shared__ __align__(16) float tile[R * ST];       // rows beside |b|^2
  __shared__ __align__(16) uint8_t q_valid[kMaxQueries];
  __shared__ Top2 part[kThreads * QPT];              // per (row lane, query), then per query

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int nsplit = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int slots = qb / QPT;                   // query slots; the block's rows split
  const int slot = tid % slots, lane_r = tid / slots, lanes = kThreads / slots;
  const int q0 = blockIdx.y * qb;               // first query row of the block
  const int64_t lane = blockIdx.z;
  d1 += lane * s_d1;
  v1 += lane * s_v1;
  d2 += lane * s_d2;
  v2 += lane * s_v2;
  best_out += lane * N;
  idx_out += lane * N;
  second_out += lane * N;
  accept_out += lane * N;
  // block-uniform: every staged tile starts a multiple of 16 bytes (and of
  // 4 flags) after the lane's start, so the lane's start decides
  const bool d2_vec = ((uintptr_t)d2 & 15) == 0;
  const bool v2_word = ((uintptr_t)v2 & 3) == 0;
  const bool v1_word = ((uintptr_t)v1 & 3) == 0;

  const int tiles = (M + R - 1) / R;
  const int t_lo = split * tiles_per_split;
  const int t_hi = min(t_lo + tiles_per_split, tiles);
  auto issue = [&](int t) {  // every thread commits one group per call
    if (t < t_hi) {
      const int j0 = t * R, rows = min(R, M - j0), st = (t - t_lo) % NS;
      copy_rows(raw[st], d2 + (int64_t)j0 * D, rows * D * 4, d2_vec, tid);
      copy_flags(raw_v[st], v2 + j0, rows, v2_word, tid);
    }
    cp_async_commit();
  };
  copy_flags(q_valid, v1 + q0, min(qb, N - q0), v1_word, tid);  // joins the first tile's group
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(t_lo + s);

  // the queries in registers, zero-padded to DP, and |a|^2 in index order
  float a[QPT][DP], n1[QPT];
  Top2 t[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int row = q0 + slot + k * slots;
#pragma unroll
    for (int c = 0; c < DP; ++c) a[k][c] = (row < N && c < D) ? d1[(int64_t)row * D + c] : 0.f;
    n1[k] = 0.f;
#pragma unroll
    for (int c = 0; c < DP; ++c) n1[k] = fmaf(a[k][c], a[k][c], n1[k]);
    t[k] = Top2{CUDART_INF_F, 0x7fffffff, CUDART_INF_F};
  }

  const int rows_per_lane = R / lanes;
  for (int tt = t_lo; tt < t_hi; ++tt) {
    const int st = (tt - t_lo) % NS;
    cp_async_wait<NS - 2>();  // this thread's copies of tile tt have landed
    __syncthreads();          // everyone's have; the last tile's compute is done
    issue(tt + NS - 1);       // into the stage tile tt - 1 used
    if (tid < R) {
      const bool ok = raw_v[st][tid] != 0 && tt * R + tid < M;
      float* dst = &tile[tid * ST];
      float n2 = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        const float bk = (ok && c < D) ? raw[st][tid * D + c] : 0.f;
        n2 = fmaf(bk, bk, n2);
        dst[c] = bk;
      }
      dst[DP] = ok ? n2 : CUDART_INF_F;  // never the best, never the runner-up
    }
    __syncthreads();  // the converted tile is complete

    const int r0 = lane_r * rows_per_lane;
    for (int r = r0; r < r0 + rows_per_lane; r += U) {
      float b[U][ST];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4* b4 = reinterpret_cast<const float4*>(&tile[(r + u) * ST]);
#pragma unroll
        for (int c4 = 0; c4 < ST / 4; ++c4) {
          const float4 x = b4[c4];
          b[u][4 * c4] = x.x; b[u][4 * c4 + 1] = x.y; b[u][4 * c4 + 2] = x.z; b[u][4 * c4 + 3] = x.w;
        }
      }
      // every distance of the step first, branch-free (QPT x U independent
      // chains), then per query one test: does any beat its runner-up?
      float d[QPT][U], m[QPT];
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float cross = 0.f;
#pragma unroll
          for (int c = 0; c < DP; ++c) cross = fmaf(a[k][c], b[u][c], cross);
          d[k][u] = fmaf(-2.0f, cross, n1[k] + b[u][DP]);  // clamped at 0 below
        }
        m[k] = d[k][0];
#pragma unroll
        for (int u = 1; u < U; ++u) m[k] = fminf(m[k], d[k][u]);
      }
      const int j = tt * R + r;
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        if (fmaxf(m[k], 0.0f) < t[k].second) {  // max(min, 0): the min of the clamped
#pragma unroll
          for (int u = 0; u < U; ++u) {  // ascending j with strict '<': first index wins
            const float du = fmaxf(d[k][u], 0.0f);
            const bool lt_best = du < t[k].best, lt_second = du < t[k].second;
            t[k].second = lt_best ? t[k].best : (lt_second ? du : t[k].second);
            t[k].idx = lt_best ? j + u : t[k].idx;
            t[k].best = lt_best ? du : t[k].best;
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (an empty split waits here for q_valid)

  // merge the row lanes of each query, then the blocks of the cluster
#pragma unroll
  for (int k = 0; k < QPT; ++k) part[lane_r * qb + slot + k * slots] = t[k];
  __syncthreads();
  if (lane_r == 0) {
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      Top2 m = t[k];
      for (int l = 1; l < lanes; ++l) m = merge(m, part[l * qb + slot + k * slots]);
      part[slot + k * slots] = m;
    }
  }
  cluster_barrier();  // every block's per-query partials are written
  // rank s finishes the queries qi with qi % nsplit == s, merging the ranks in order
  for (int qi = tid; qi < qb; qi += kThreads) {
    const int row = q0 + qi;
    if (qi % nsplit != split || row >= N) continue;
    Top2 m = cluster.map_shared_rank(part, 0)[qi];
    for (int s = 1; s < nsplit; ++s) m = merge(m, cluster.map_shared_rank(part, s)[qi]);
    // no valid column: idx 0 (what a first-index argmin over +inf gives)
    best_out[row] = m.best;
    idx_out[row] = m.idx < M ? m.idx : 0;
    second_out[row] = m.second;
    accept_out[row] =
        (uint8_t)((m.best < dist_thr) && (m.best / m.second < ratio_thr) && q_valid[qi]);
  }
  cluster_barrier();  // no block leaves while another may still read its partials
}

struct Args {
  const void *d1, *v1, *d2, *v2;
  void *best, *idx, *second, *accept;
  int B, N, M, D;
  int64_t s_d1, s_v1, s_d2, s_v2;
  int qb, splits;
  float dist_thr, ratio_thr;
};

template <int DP, int QPT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int tiles = (a.M + Shape<DP, QPT>::kRows - 1) / Shape<DP, QPT>::kRows;
  const int tiles_per_split = (tiles + a.splits - 1) / a.splits;
  const int splits = a.splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (a.N + a.qb - 1) / a.qb, a.B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, match_top2_kernel<DP, QPT>, (const float*)a.d1,
                            (const uint8_t*)a.v1, (const float*)a.d2, (const uint8_t*)a.v2,
                            (float*)a.best, (int64_t*)a.idx, (float*)a.second,
                            (uint8_t*)a.accept, a.N, a.M, a.D, a.s_d1, a.s_v1, a.s_d2, a.s_v2,
                            a.qb, tiles_per_split, a.dist_thr, a.ratio_thr);
}

}  // namespace

extern "C" int tpuvo_match_top2(
    const void* d1, const void* v1, const void* d2, const void* v2,
    void* best, void* idx, void* second, void* accept, int B, int N, int M, int D,
    int64_t s_d1, int64_t s_v1, int64_t s_d2, int64_t s_v2,
    int qb, int qpt, int splits, float dist_thr, float ratio_thr, void* stream) {
  if (N <= 0 || B <= 0) return 0;
  const int slots = qpt > 0 ? qb / qpt : 0;
  // 4 queries a thread only at D = 10: 4 x 64 padded queries would not fit in registers
  const bool tile_ok = (qpt == 1 || (qpt == 4 && D == 10)) && qb % qpt == 0 && qb <= kMaxQueries &&
                       (slots == 8 || slots == 16 || slots == 32 || slots == 64 || slots == 128);
  // floats are 4-byte aligned whatever the view; the kernel handles the rest
  if (D < 1 || D > 64 || !tile_ok || splits < 1 || splits > kMaxSplits ||
      (N + qb - 1) / qb > 65535 || B > 65535 || M < 0 || ((uintptr_t)d2 & 3) ||
      s_d1 < 0 || s_v1 < 0 || s_d2 < 0 || s_v2 < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{d1, v1, d2, v2, best, idx, second, accept, B, N, M, D,
               s_d1, s_v1, s_d2, s_v2, qb, splits, dist_thr, ratio_thr};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (D == 10)
    e = qpt == 1 ? launch<10, 1>(a, s) : launch<10, 4>(a, s);
  else
    e = launch<64, 1>(a, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
