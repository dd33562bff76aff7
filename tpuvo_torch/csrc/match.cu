// Brute-force top-2 descriptor matcher with Lowe's ratio test.
//
// Replaces the TPU kernel tpuvo/ops/pallas/match_kernel.py:_tile_kernel
// (launched by match_topk_pallas).  For each query row it finds the best
// (first index on ties) and second-best squared-L2 distance over the valid
// map columns, with distance |a|^2 + |b|^2 - 2 a.b clamped at 0, and writes
// the acceptance decision (best < dist_thr, best/second < ratio_thr, query
// valid) — the whole MatchResult in one launch.  Each sum runs over the
// descriptor in index order, so a map entry equal to the query is at
// distance exactly 0 and exact duplicates in the map tie exactly: the ratio
// test then rejects them in the kernel and its plain version alike, instead
// of deciding on rounding noise.
//
// What bounds it on an H100: at the main path's shape (N = 128 queries,
// M = 8192 map slots, D = 10) the work is ~1M distances (~30 MFLOP) over a
// 330 KB map that sits in L2 after its first read; it is bound by the
// per-block scan latency, not by bandwidth, and D = 10 gives tensor cores
// nothing to do (plain fp32 FMA).
// Design: the TPU kernel folded map tiles into an accumulator across
// SEQUENTIAL grid steps; CUDA blocks run in no order, so nothing carries
// between blocks.  One block per query row, threads stride over the whole
// map keeping a local (best, idx, second) in registers, then a warp-shuffle
// and shared-memory merge that compares (dist, idx) lexicographically — the
// first-index rule holds whatever order the merge runs in.  Validity is a
// plain test of valid2[j]; the TPU's penalty row is not needed.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 64;

struct Top2 {
  float best;
  int64_t idx;
  float second;
};

// merge two partial top-2s: the winner is the lexicographically smaller
// (best, idx); the runner-up is the better of the winner's second and the
// loser's best (the loser's second is never smaller than its best)
__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool a_wins = (a.best < b.best) || (a.best == b.best && a.idx < b.idx);
  const Top2& w = a_wins ? a : b;
  const Top2& l = a_wins ? b : a;
  return Top2{w.best, w.idx, fminf(w.second, l.best)};
}

__global__ void match_top2_kernel(
    const float* __restrict__ d1,        // (N, D)
    const uint8_t* __restrict__ v1,      // (N,)
    const float* __restrict__ d2,        // (M, D)
    const uint8_t* __restrict__ v2,      // (M,)
    float* __restrict__ best_out,        // (N,)
    int64_t* __restrict__ idx_out,       // (N,)
    float* __restrict__ second_out,      // (N,)
    uint8_t* __restrict__ accept_out,    // (N,)
    int N, int M, int D, float dist_thr, float ratio_thr) {
  const int row = blockIdx.x;
  __shared__ float q[kMaxD];
  __shared__ float qn;
  __shared__ Top2 part[kThreads / 32];

  if (threadIdx.x < D) q[threadIdx.x] = d1[(int64_t)row * D + threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    float n1 = 0.f;
    for (int k = 0; k < D; ++k) n1 = fmaf(q[k], q[k], n1);
    qn = n1;
  }
  __syncthreads();
  const float n1 = qn;

  // own scan in ascending j with strict '<': first index among this thread's
  Top2 t{CUDART_INF_F, (int64_t)M, CUDART_INF_F};
  for (int j = threadIdx.x; j < M; j += kThreads) {
    if (!v2[j]) continue;
    const float* bj = d2 + (int64_t)j * D;
    // the three sums run the same fma chain in the same order, so a map
    // descriptor equal to the query gives n1 == n2 == cross and a distance
    // of exactly 0 (duplicates then tie exactly, as in the plain version)
    float n2 = 0.f, cross = 0.f;
    for (int k = 0; k < D; ++k) {
      const float bk = bj[k];
      n2 = fmaf(bk, bk, n2);
      cross = fmaf(q[k], bk, cross);
    }
    const float d = fmaxf(fmaf(-2.0f, cross, n1 + n2), 0.0f);
    if (d < t.best) { t.second = t.best; t.best = d; t.idx = j; }
    else if (d < t.second) { t.second = d; }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.best = __shfl_down_sync(0xffffffffu, t.best, off);
    o.idx = (int64_t)__shfl_down_sync(0xffffffffu, (long long)t.idx, off);
    o.second = __shfl_down_sync(0xffffffffu, t.second, off);
    t = merge(t, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    Top2 r = part[0];
    for (int w = 1; w < kThreads / 32; ++w) r = merge(r, part[w]);
    // no valid column: idx 0 (what a first-index argmin over +inf gives)
    const int64_t idx = r.idx < M ? r.idx : 0;
    best_out[row] = r.best;
    idx_out[row] = idx;
    second_out[row] = r.second;
    accept_out[row] = (uint8_t)((r.best < dist_thr) && (r.best / r.second < ratio_thr) && v1[row]);
  }
}

}  // namespace

extern "C" int tpuvo_match_top2(
    const void* d1, const void* v1, const void* d2, const void* v2,
    void* best, void* idx, void* second, void* accept, int N, int M, int D,
    float dist_thr, float ratio_thr, void* stream) {
  if (N <= 0) return 0;
  if (D > kMaxD) return (int)cudaErrorInvalidValue;
  match_top2_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d1, (const uint8_t*)v1, (const float*)d2, (const uint8_t*)v2,
      (float*)best, (int64_t*)idx, (float*)second, (uint8_t*)accept, N, M, D,
      dist_thr, ratio_thr);
  return (int)cudaGetLastError();
}
