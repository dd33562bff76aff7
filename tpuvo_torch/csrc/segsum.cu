// Fixed-order segment sums for the BA's and the pose graph's assembly:
// kernel D.
//
// Replaces no Pallas kernel.  The JAX package sums per-entry blocks into
// their targets with segment_sum / .at[].add, which XLA lowers to a
// scatter-add; the port sums them in an order planned once per solve
// (ba/assembly.py: a stable argsort of the targets, so each target's
// entries keep their order).  out[t] = ((0 + v_0) + v_1) + ... over the
// entries of target t in plan order, in float32 with each addition
// rounded (__fadd_rn: no contraction), no atomics: the sequential order of
// torch.segment_reduce's loop, which the plain version runs, and so the
// same bits.  One launch takes the place of the gather values[order] and
// of torch.segment_reduce.
//
//   tpuvo_segsum(values (n, cols) f32, order (n,) int64, bounds
//                (n_targets + 1,) int64, out (n_targets, cols) f32,
//                n, n_targets, cols, stream)
//
// Target t's entries are order[bounds[t] .. bounds[t+1]); every output
// element is written, an empty target's as +0.0.
//
// What bounds it on an H100: the serial chain of the longest segment.  A
// call reads at most n (8 + 4 cols) bytes and writes n_targets * cols * 4,
// well under a microsecond at 3.35 TB/s for the local BA's sums, but the
// additions of one target must follow one another.  One thread walking a
// segment, as segment_reduce does, makes every gathered load of it a link
// of that chain.  The local BA's problem puts 60-65% of its entries in one
// segment, the inert landmark slot that collects every invalid
// observation, and each of those entries is an exact zero (weight 0).
//
// The design skips that chain's zeros.  The running sum starts at +0.0 and
// so is never -0.0 (x + -x rounds to +0.0), and adding +-0.0 to anything
// but -0.0 gives it back bit for bit (a NaN too: the card's arithmetic
// gives the canonical NaN, which the sum already is once it is NaN).  So an
// entry whose values are all +-0.0 may be left out, and only the ordered
// additions of the others are serial:
//   * a block of kThreads threads takes a group of consecutive targets, as
//     many as fill its threads with their columns (kThreads / cols), so a
//     plan of many short targets does not launch a block a target; where
//     the plan has many more targets than entries (the global sweep's 1.6M
//     (landmark, frame) blocks over 25,600 observations) the group grows
//     up to kMaxRepeat times, each thread writing that many outputs.  A
//     target's entries are contiguous in plan order, and so are the
//     group's;
//   * the block walks the group's entries a tile (kTile = kThreads * kPer)
//     at a time.  The tile's row indices come through `order` (coalesced;
//     the next tile's are loaded while this one is summed); each thread
//     tests its kPer rows for a nonzero value, every load issued before any
//     test (vector loads where the column count and the base allow), and
//     ballots write the tile's flags as a bit mask to shared memory with
//     the row indices; each warp then ballots which mask words hold a flag;
//   * thread k adds, for column k % cols of target k / cols, the flagged
//     entries of the tile in its target's range, in order (the summary's
//     words, then the mask's bits, lowest first; kBatch entries gathered
//     before their additions), into its running sum, which carries from
//     tile to tile through the output element the same thread owns;
//   * so the inert segment costs a few tiles of parallel loads and no
//     additions, and a landmark's segment its ~5-16 additions.
// The launch follows the plan's shape (the group from the column count and
// the ratio of targets to entries, the grid from the number of targets,
// the tiles from each group's entries); the column counts of the BA and
// the pose graph (3, 6, 9, 18, 36) are compiled with the count as a
// constant.  (Tried on the card and slower for the local BA's three sums:
// a thread-block cluster per group testing a round across its blocks,
// 1024-thread blocks, and a warp's lanes on consecutive values of its rows.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 4;                     // entries a thread gathers per tile
constexpr int kTile = kThreads * kPer;      // entries per tile
constexpr int kWords = kTile / 32;          // mask words per tile
constexpr int kSummary = kWords / 32;       // summary words (bit w: mask word w is nonzero)
constexpr int kMaxGroup = 1024;             // targets a block takes at most
constexpr int kMaxRepeat = 8;               // the most a group grows for near-empty targets
constexpr int kBatch = 4;                   // flagged entries gathered before their additions

// The OR of a row's value bits, read VEC floats at a time (the row's
// alignment allows it: VEC divides the column count and the base's).
template <int COLS, int VEC>
__device__ __forceinline__ unsigned row_bits(const float* __restrict__ v, int cols) {
  unsigned a = 0;
  if constexpr (VEC == 4) {
    const uint4* w = reinterpret_cast<const uint4*>(v);
#pragma unroll
    for (int c = 0; c < COLS / 4; ++c) {
      const uint4 x = __ldg(w + c);
      a |= x.x | x.y | x.z | x.w;
    }
  } else if constexpr (VEC == 2) {
    const uint2* w = reinterpret_cast<const uint2*>(v);
#pragma unroll
    for (int c = 0; c < COLS / 2; ++c) {
      const uint2 x = __ldg(w + c);
      a |= x.x | x.y;
    }
  } else if constexpr (COLS > 0) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) a |= __float_as_uint(__ldg(v + c));
  } else {
    for (int c = 0; c < cols; ++c) a |= __float_as_uint(__ldg(v + c));
  }
  return a;
}

template <int COLS, int VEC>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ values, const int64_t* __restrict__ order,
              const int64_t* __restrict__ bounds, float* __restrict__ out, int64_t n_targets,
              int cols_arg, int group) {
  const int cols = COLS > 0 ? COLS : cols_arg;
  __shared__ int64_t rows[kTile];           // the tile's gathered row indices
  __shared__ unsigned mask[kWords];         // bit p: entry p of the tile is nonzero
  __shared__ int64_t seg[kMaxGroup + 1];    // the group's bounds

  const int64_t t0 = (int64_t)blockIdx.x * group;
  const int g = (int)(n_targets - t0 < group ? n_targets - t0 : group);
  for (int i = threadIdx.x; i <= g; i += kThreads) seg[i] = bounds[t0 + i];
  __syncthreads();
  const int64_t e0 = seg[0], e1 = seg[g];
  const int owned = g * cols;
  float* const o = out + t0 * cols;
  for (int k = threadIdx.x; k < owned; k += kThreads) {
    const int t = k / cols;
    if (seg[t] == seg[t + 1]) o[k] = 0.0f;
  }

  // the tile's row indices through `order` (coalesced); the next tile's are
  // loaded while this one is summed
  int64_t r[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int64_t j = e0 + u * kThreads + threadIdx.x;
    r[u] = j < e1 ? __ldg(order + j) : -1;
  }
  for (int64_t base = e0; base < e1; base += kTile) {
    // test: a warp whose entries all lie past the group's skips them (the
    // test is the same for the whole warp); in the others every load of
    // the thread's entries is issued before any is tested (an entry past
    // the group's reads row 0, which exists, and is not flagged).  An entry
    // is nonzero iff one of its values has a bit set besides the sign (a
    // NaN is nonzero, +-0.0 is not).
    const int64_t lane0 = base + (threadIdx.x & ~31);
    unsigned bits[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      bits[u] = 0;
      if (lane0 + u * kThreads < e1)
        bits[u] = row_bits<COLS, VEC>(values + (r[u] >= 0 ? r[u] : 0) * cols, cols);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int p = u * kThreads + threadIdx.x;
      rows[p] = r[u];
      const unsigned w = __ballot_sync(0xffffffffu, r[u] >= 0 && (bits[u] << 1) != 0);
      if ((threadIdx.x & 31) == 0) mask[p >> 5] = w;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int64_t j = base + kTile + u * kThreads + threadIdx.x;
      r[u] = j < e1 ? __ldg(order + j) : -1;
    }
    __syncthreads();
    // every warp reads which mask words hold a flag, so that a target's
    // walk skips the words of zeros
    unsigned summary[kSummary];
#pragma unroll
    for (int q = 0; q < kSummary; ++q)
      summary[q] = __ballot_sync(0xffffffffu, mask[q * 32 + (threadIdx.x & 31)] != 0);

    // add: thread k sums column k % cols of target k / cols over the
    // tile's flagged entries in the target's range, in order, gathering
    // kBatch of them before their additions
    for (int k = threadIdx.x; k < owned; k += kThreads) {
      const int t = k / cols, c = k - t * cols;
      const int64_t s = seg[t], e = seg[t + 1];
      const int64_t lo = s > base ? s : base;
      const int64_t hi = e < base + kTile ? e : base + kTile;
      if (lo >= hi) continue;
      float acc = s >= base ? 0.0f : o[k];  // the target's first tile starts from +0.0
      const int a = (int)(lo - base), b = (int)(hi - base);
      for (int q = a >> 10; q <= (b - 1) >> 10; ++q) {
        unsigned words = summary[0];
#pragma unroll
        for (int i = 1; i < kSummary; ++i)
          if (q == i) words = summary[i];
        const int w_lo = (a >> 5) - 32 * q, w_hi = ((b - 1) >> 5) - 32 * q;  // in this word
        if (w_lo > 0) words &= ~0u << w_lo;
        if (w_hi < 31) words &= ~0u >> (31 - w_hi);
        while (words) {
          const int w = 32 * q + __ffs(words) - 1;
          words &= words - 1;
          unsigned m = mask[w];
          const int w0 = w << 5;
          if (a > w0) m &= ~0u << (a - w0);
          if (b < w0 + 32) m &= (1u << (b - w0)) - 1u;
          while (m) {
            float v[kBatch];
            int got = 0;
#pragma unroll
            for (int i = 0; i < kBatch; ++i) {
              if (m) {
                v[i] = __ldg(values + rows[w0 + __ffs(m) - 1] * cols + c);
                m &= m - 1;
                got = i + 1;
              }
            }
#pragma unroll
            for (int i = 0; i < kBatch; ++i)
              if (i < got) acc = __fadd_rn(acc, v[i]);
          }
        }
      }
      o[k] = acc;
    }
    __syncthreads();
  }
}

template <int COLS>
cudaError_t launch(const void* values, const void* order, const void* bounds, void* out,
                   int64_t n, int64_t n_targets, int cols, cudaStream_t stream) {
  // a group fills the block's threads with its columns; where the plan has
  // many more targets than entries (most of them empty), it takes up to
  // kMaxRepeat times as many, each thread writing that many outputs
  int group = cols <= kThreads ? kThreads / cols : 1;
  const int64_t per_entry = n_targets / (n > 0 ? n : 1);
  const int repeat = per_entry < kMaxRepeat ? (per_entry > 1 ? (int)per_entry : 1) : kMaxRepeat;
  group = group * repeat < kMaxGroup ? group * repeat : kMaxGroup;
  const int64_t blocks = (n_targets + group - 1) / group;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const uintptr_t at = (uintptr_t)values;
  const dim3 grid((unsigned)blocks);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, stream>>>((const float*)values, (const int64_t*)order,
                                          (const int64_t*)bounds, (float*)out, n_targets, cols,
                                          group);
  };
  if constexpr (COLS > 0 && COLS % 4 == 0) {
    if (at % 16 == 0) {
      args(segsum_kernel<COLS, 4>);
      return cudaGetLastError();
    }
  }
  if constexpr (COLS > 0 && COLS % 2 == 0) {
    if (at % 8 == 0) {
      args(segsum_kernel<COLS, 2>);
      return cudaGetLastError();
    }
  }
  args(segsum_kernel<COLS, 1>);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tpuvo_segsum(const void* values, const void* order, const void* bounds,
                            void* out, int64_t n, int64_t n_targets, int cols, void* stream) {
  if (n_targets <= 0 || cols <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (cols) {
    case 3: return (int)launch<3>(values, order, bounds, out, n, n_targets, cols, s);
    case 6: return (int)launch<6>(values, order, bounds, out, n, n_targets, cols, s);
    case 9: return (int)launch<9>(values, order, bounds, out, n, n_targets, cols, s);
    case 18: return (int)launch<18>(values, order, bounds, out, n, n_targets, cols, s);
    case 36: return (int)launch<36>(values, order, bounds, out, n, n_targets, cols, s);
    default: return (int)launch<0>(values, order, bounds, out, n, n_targets, cols, s);
  }
}
