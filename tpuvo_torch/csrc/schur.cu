// The bundle adjustment's reduced camera system from its nonzero coupling
// blocks: kernel F.
//
// Replaces no Pallas kernel.  The JAX package (tpuvo/ba/window.py
// schur_parts, backsubstitute) forms S = Hpp - sum_l W_l Hll^-1_l W_l^T as
// one dense product over an (L, W, 6, 3) coupling tensor, which XLA tiles
// for the TPU's matrix unit.  A block W_lf is nonzero only where frame f
// observes landmark l, so at most W*N of the L*W blocks are: at the global
// sweep's shape (W = 200 frames, N = 400 keypoints, L = 8,192 slots) 4.9%,
// and the dense product (70.8 GFLOP) multiplies zeros for the rest.  Here
// the blocks are one per (landmark, frame) pair that an observation joins
// (ba/window.pair_plan: slots in ascending (landmark, frame) order, a
// landmark's pairs contiguous, and a by-frame order of the pairs that is
// ascending in landmark within each frame).
//
//   tpuvo_schur_reduce(Wp (P, 6, 3), Hinv (La, 3, 3), bl (La, 3), Hpp (W, 6, 6),
//                      bp (W, 6), pair_lm (P,), pair_f (P,), lm_bounds (La + 1,),
//                      frame_order (P,), frame_bounds (W + 1,), S (6W, 6W), b (6W,),
//                      W, n_max (a frame's pairs at most: P / W), stream)
//     S[f, g] = Hpp_f [f == g] - sum over the landmarks l that f and g both see,
//               in ascending l, of (W_lf Hinv_l) W_lg^T;
//     b[f]    = bp_f - sum over f's landmarks, ascending, of (W_lf Hinv_l) bl_l;
//   tpuvo_schur_backsub(Wp, Hinv, bl, dx (W, 6), pair_f, lm_bounds, out (La, 3), La, stream)
//     out[l]  = -Hinv_l (bl_l + sum over l's pairs, ascending f, of W_lf^T dx_f).
// Float32, every product and sum in a fixed order (the inner 3- or 6-term
// sums lowest index first as fused multiply-adds, the landmark sums one
// rounded addition at a time), no atomics: two runs, in a CUDA graph or
// not, give the same bits.  Every element of S, b and out is written.
//
// What bounds it on an H100: the nonzero blocks' bytes and their products
// are small (at the sweep's shape 80,000 blocks, 5.8 MB read, S's 5.8 MB
// written: ~3.5 us at 3.35 TB/s; sum_l k_l^2 block products of 108
// multiply-adds, ~0.2 GFLOP: ~3 us at 67 TFLOP/s), so the kernel's time is
// the latency of its dependent loads and the serial landmark sums.
//
// The design:
//   * a block owns frame f's rows of S over up to kSpan partner frames (the
//     grid's y covers wider systems), a thread 2 rows of it: row i of the
//     blocks (f, g) and (f, g + half), its 12 sums in registers, so every
//     entry has one owner and no thread waits on another;
//   * first the block reads all of f's pairs in one parallel pass: each
//     pair's landmark and that landmark's pair range (cut to the block's
//     partner frames by binary search where the span does not cover every
//     frame), into shared memory;
//   * then it walks f's pairs in ascending landmark a chunk at a time
//     (kChunk, or fewer where their partners would pass kItems): every
//     warp computes the chunk's W_lf Hinv_l (6 x 3), copies the partners'
//     blocks into shared memory (a landmark's pairs are contiguous:
//     coalesced) and marks, for each partner frame g, the chunk's
//     landmarks that g sees in a 32-bit mask and where g's block lies;
//   * each thread walks its frames' masks from the lowest bit, so it
//     touches only the landmarks its frames share with f, in ascending
//     order, and adds the 6 terms of its row; threads 0-5 of the first
//     span carry b's sum;
//   * at the end each thread puts its sums, negated, with Hpp added on the
//     diagonal block (the order of the dense path, -sum + Hpp), into shared
//     memory, from where the block writes its rows coalesced.
// On an H100 at the sweep's shape this design takes ~121 us, most of it the
// diagonal block's threads adding f's ~280 landmarks in turn.  Tried there
// and slower: the row panel in shared memory with warp w adding the
// partners g with g % 8 == w, a warp-serial step a landmark (207 us); every
// thread testing every landmark of the chunk for its frames (217 us).
// Back-substitution is a thread a landmark over its contiguous pairs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // back-substitution; the least a reduction block has
constexpr int kSpan = 256;     // partner frames a block owns
constexpr int kMaxThreads = 3 * kSpan;  // a thread owns 2 of the block's 6 kSpan rows
constexpr int kChunk = 32;     // f's pairs staged at a time: a bit of a mask each
constexpr int kItems = 512;    // partner blocks staged at a time (>= kSpan)
constexpr unsigned kFull = 0xffffffffu;

static_assert(kItems >= kSpan, "a landmark's partners in a span must fit one chunk");
static_assert(36 * kSpan <= 18 * kItems, "the rows must fit the staging room");

struct Stage {
  float y[kChunk][18];          // W_lf Hinv_l of each staged pair of f, (6, 3)
  float bl[kChunk][3];          // its landmark's bl
  int cum[kChunk + 1];          // staged landmark c's partners: items cum[c] .. cum[c + 1]
  int take;                     // landmarks staged
  unsigned seen[kSpan];         // bit c: partner frame g0 + g sees the chunk's landmark c
  short slot[kChunk][kSpan];    // and its block is item slot[c][g] (where the bit is set)
};

// The first index in [lo, hi) whose a[] is >= x (a ascending there).
__device__ __forceinline__ int64_t first_at_least(const int64_t* __restrict__ a, int64_t lo,
                                                  int64_t hi, int64_t x) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Row i of block (f, g0 + g): the chunk's landmarks that g sees, lowest
// first, each adding (W_lf Hinv_l)_i . W_lg_j to acc[j].
__device__ __forceinline__ void add_row(float (&acc)[6], const Stage& st,
                                        const float* items_w, int g, int i) {
  for (unsigned m = st.seen[g]; m; m &= m - 1) {
    const int c = __ffs(m) - 1;
    const float* wq = items_w + st.slot[c][g] * 18;
    const float y0 = st.y[c][i * 3], y1 = st.y[c][i * 3 + 1], y2 = st.y[c][i * 3 + 2];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float t = y0 * wq[j * 3];
      t = fmaf(y1, wq[j * 3 + 1], t);
      t = fmaf(y2, wq[j * 3 + 2], t);
      acc[j] = __fadd_rn(acc[j], t);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
schur_reduce_kernel(const float* __restrict__ wp, const float* __restrict__ hinv,
                    const float* __restrict__ bl, const float* __restrict__ hpp,
                    const float* __restrict__ bp, const int64_t* __restrict__ pair_lm,
                    const int64_t* __restrict__ pair_f, const int64_t* __restrict__ lm_bounds,
                    const int64_t* __restrict__ frame_order,
                    const int64_t* __restrict__ frame_bounds, float* __restrict__ S,
                    float* __restrict__ b, int W, int n_max) {
  extern __shared__ float dyn[];
  float* const items_w = dyn;                      // (kItems, 6, 3) partner blocks
  int* const f_pair = (int*)(items_w + kItems * 18);  // f's pairs (n_max at most),
  int* const f_lm = f_pair + n_max;                //   their landmarks,
  int* const f_src = f_lm + n_max;                 //   the first partner in the span,
  int* const f_n = f_src + n_max;                  //   and the partners in the span
  __shared__ Stage st;
  const int f = blockIdx.x;
  const int g0 = blockIdx.y * kSpan;
  const int span = W - g0 < kSpan ? W - g0 : kSpan;
  const int half = (span + 1) / 2;                 // a thread's rows: frames gi and gi + half
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int gi = threadIdx.x / 6, i = threadIdx.x - gi * 6;
  const bool own0 = gi < half, own1 = gi < half && gi + half < span;
  const bool whole = span == W;                    // every frame is a partner of this block

  float acc0[6], acc1[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) acc0[j] = acc1[j] = 0.0f;
  float bacc = 0.0f;                               // threads 0-5 of the first span: b's row i
  const int64_t p0 = __ldg(frame_bounds + f);
  const int nf = (int)(__ldg(frame_bounds + f + 1) - p0);

  for (int t = threadIdx.x; t < nf; t += blockDim.x) {
    const int64_t p = __ldg(frame_order + p0 + t);
    const int64_t l = __ldg(pair_lm + p);
    int64_t s = __ldg(lm_bounds + l), e = __ldg(lm_bounds + l + 1);
    if (!whole) {
      s = first_at_least(pair_f, s, e, g0);
      e = first_at_least(pair_f, s, e, g0 + span);
    }
    f_pair[t] = (int)p;
    f_lm[t] = (int)l;
    f_src[t] = (int)s;
    f_n[t] = (int)(e - s);                         // <= span: distinct frames
  }
  __syncthreads();

  for (int c0 = 0; c0 < nf;) {
    if (warp == 0) {
      const int c = c0 + lane;
      int inc = c < nf ? f_n[c] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc += v;
      }
      // the lanes that fit are a prefix (inc grows with the lane), lane 0 always
      const int take = __popc(__ballot_sync(kFull, c < nf && inc <= kItems));
      if (lane < take) st.cum[lane + 1] = inc;
      if (lane == 0) {
        st.cum[0] = 0;
        st.take = take;
      }
    }
    for (int g = threadIdx.x; g < span; g += blockDim.x) st.seen[g] = 0u;
    __syncthreads();
    const int take = st.take;

    // stage: the chunk's W_lf Hinv_l and bl_l, the partners' blocks and frames
    for (int t = threadIdx.x; t < take * 18; t += blockDim.x) {
      const int c = t / 18, r = t - c * 18, ii = r / 3, k = r - ii * 3;
      const float* w = wp + (int64_t)f_pair[c0 + c] * 18 + ii * 3;
      const float* h = hinv + (int64_t)f_lm[c0 + c] * 9 + k;
      float y = __ldg(w) * __ldg(h);
      y = fmaf(__ldg(w + 1), __ldg(h + 3), y);
      y = fmaf(__ldg(w + 2), __ldg(h + 6), y);
      st.y[c][r] = y;
    }
    for (int t = threadIdx.x; t < take * 3; t += blockDim.x)
      st.bl[t / 3][t % 3] = __ldg(bl + (int64_t)f_lm[c0 + t / 3] * 3 + t % 3);
    for (int c = warp; c < take; c += warps) {
      const int at = st.cum[c], n = st.cum[c + 1] - at;
      const int64_t src = f_src[c0 + c];
      const float* from = wp + src * 18;
      float* to = items_w + at * 18;
      for (int t = lane; t < n * 18; t += 32) to[t] = __ldg(from + t);
      for (int t = lane; t < n; t += 32) {
        const int g = (int)(__ldg(pair_f + src + t) - g0);
        st.slot[c][g] = (short)(at + t);
        atomicOr(&st.seen[g], 1u << c);
      }
    }
    __syncthreads();

    if (blockIdx.y == 0 && threadIdx.x < 6) {
      for (int c = 0; c < take; ++c) {
        float t = st.y[c][i * 3] * st.bl[c][0];
        t = fmaf(st.y[c][i * 3 + 1], st.bl[c][1], t);
        t = fmaf(st.y[c][i * 3 + 2], st.bl[c][2], t);
        bacc = __fadd_rn(bacc, t);
      }
    }
    if (own0) add_row(acc0, st, items_w, gi, i);
    if (own1) add_row(acc1, st, items_w, gi + half, i);
    c0 += take;
    __syncthreads();
  }

  // the rows through shared memory (the staged blocks' room), written coalesced
  float* const panel = items_w;                    // (6, 6 span)
  const int cols = 6 * span;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    if (own0) {
      const float d = g0 + gi == f ? __ldg(hpp + (f * 6 + i) * 6 + j) : 0.0f;
      panel[i * cols + gi * 6 + j] = __fadd_rn(-acc0[j], d);
    }
    if (own1) {
      const float d = g0 + gi + half == f ? __ldg(hpp + (f * 6 + i) * 6 + j) : 0.0f;
      panel[i * cols + (gi + half) * 6 + j] = __fadd_rn(-acc1[j], d);
    }
  }
  __syncthreads();
  const int64_t ld = 6 * (int64_t)W;
  for (int t = threadIdx.x; t < 6 * cols; t += blockDim.x) {
    const int ii = t / cols, c = t - ii * cols;
    S[(f * 6 + ii) * ld + g0 * 6 + c] = panel[t];
  }
  if (blockIdx.y == 0 && threadIdx.x < 6)
    b[f * 6 + i] = __fsub_rn(__ldg(bp + f * 6 + i), bacc);
}

__global__ void __launch_bounds__(kThreads)
schur_backsub_kernel(const float* __restrict__ wp, const float* __restrict__ hinv,
                     const float* __restrict__ bl, const float* __restrict__ dx,
                     const int64_t* __restrict__ pair_f, const int64_t* __restrict__ lm_bounds,
                     float* __restrict__ out, int64_t La) {
  const int64_t l = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (l >= La) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  const int64_t s = __ldg(lm_bounds + l), e = __ldg(lm_bounds + l + 1);
  for (int64_t p = s; p < e; ++p) {
    const float* w = wp + p * 18;                  // (6, 3)
    const float* d = dx + __ldg(pair_f + p) * 6;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float t = __ldg(w + k) * __ldg(d);
#pragma unroll
      for (int i = 1; i < 6; ++i) t = fmaf(__ldg(w + i * 3 + k), __ldg(d + i), t);
      acc[k] = __fadd_rn(acc[k], t);
    }
  }
  float r[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = __fadd_rn(__ldg(bl + l * 3 + k), acc[k]);
  const float* h = hinv + l * 9;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = __ldg(h + i * 3) * r[0];
    t = fmaf(__ldg(h + i * 3 + 1), r[1], t);
    t = fmaf(__ldg(h + i * 3 + 2), r[2], t);
    out[l * 3 + i] = -t;
  }
}

}  // namespace

extern "C" int tpuvo_schur_reduce(const void* wp, const void* hinv, const void* bl,
                                  const void* hpp, const void* bp, const void* pair_lm,
                                  const void* pair_f, const void* lm_bounds,
                                  const void* frame_order, const void* frame_bounds, void* S,
                                  void* b, int W, int n_max, void* stream) {
  if (W <= 0) return 0;
  if (n_max < 0) return (int)cudaErrorInvalidValue;
  const int span = W < kSpan ? W : kSpan;
  const int rows = (6 * ((span + 1) / 2) + 31) / 32 * 32;  // 6 rows a frame, 2 a thread
  const int threads = rows > kThreads ? rows : kThreads;
  const size_t smem = sizeof(float) * kItems * 18 + sizeof(int) * 4 * (size_t)n_max;
  if (smem + sizeof(Stage) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        schur_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)W, (unsigned)((W + kSpan - 1) / kSpan));
  schur_reduce_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)wp, (const float*)hinv, (const float*)bl, (const float*)hpp,
      (const float*)bp, (const int64_t*)pair_lm, (const int64_t*)pair_f,
      (const int64_t*)lm_bounds, (const int64_t*)frame_order, (const int64_t*)frame_bounds,
      (float*)S, (float*)b, W, n_max);
  return (int)cudaGetLastError();
}

extern "C" int tpuvo_schur_backsub(const void* wp, const void* hinv, const void* bl,
                                   const void* dx, const void* pair_f, const void* lm_bounds,
                                   void* out, int64_t La, void* stream) {
  if (La <= 0) return 0;
  const int64_t blocks = (La + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  schur_backsub_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)wp, (const float*)hinv, (const float*)bl, (const float*)dx,
      (const int64_t*)pair_f, (const int64_t*)lm_bounds, (float*)out, La);
  return (int)cudaGetLastError();
}
