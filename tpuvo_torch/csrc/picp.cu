// Fused projective-ICP Gauss-Newton solver: the whole GN loop for one pose
// in one thread block, its points staged on chip once.
//
// Replaces the TPU kernel tpuvo/ops/pallas/picp_kernel.py:_make_kernel
// (launched by _solve_pallas_impl).  Semantics are those of
// tpuvo_torch/ops/picp.py:solve (the twin of the XLA solver the Pallas
// kernel is held to): per round, project through the 12-scalar pose, cull on
// cheirality and image bounds, apply the saturating weight, build the
// closed-form 2x6 Jacobian WITH the principal-point terms, reduce 21 H terms,
// 6 g terms and 3 statistics, damp, solve the unrolled 6x6 Cholesky, apply
// T <- v2tEuler(dx) * T, and stop on the relative-chi rule (1e30 sentinel)
// or the min-inlier bail.
//
// What bounds it on an H100: not bytes or FLOPs.  The tracker's problem
// (B = 1, N = 128, ~5 rounds) is ~0.12 MFLOP and ~3.8 KB: ~2 ns of roofline,
// far under the ~1 us a launch costs.  The time is a chain of dependent
// latencies: the gather (valid -> idx -> world[idx]) and, per round, the
// reduction, the barrier and the serial 6x6 solve.  The design:
//   * one 128-thread block per problem, grid over the batch (B = 256 is
//     one launch); a thread takes one point at N <= 128 and strides over
//     the points where N is larger;
//   * the points are staged ONCE: valid, idx and uv are loaded together,
//     world[idx] right after, and only the valid rows are kept, compacted
//     in index order into shared memory (SoA), so no round touches global
//     memory and no round spends a lane on an invalid row;
//   * each round reduces its 30 sums with a warp reduce-scatter (31
//     shuffles, lane l ends with sum l), then one barrier and a fixed-order
//     sum over the 4 warps' partials, which are double-buffered by round
//     parity (no second barrier); every thread then solves the 6x6 system
//     and updates the pose redundantly, so the loop state is block-uniform;
//   * the solve takes one reciprocal per pivot and reuses it; the rotation
//     takes sincosf;
//   * the typed results (T, num_inliers int32, chi_inliers, chi_outliers,
//     iterations int32, converged bool) are written by the kernel itself,
//     so a call launches nothing else;
//   * each input has its own lane stride (the batched tracker's frames and
//     maps are lanes of larger tensors; 0 shares one array among all
//     problems), and an optional (B,) array gives each problem its own
//     robust threshold (the threshold sweep), else the scalar one;
//   * K is four scalars, or read from a (3, 3) array on the card (a caller
//     whose K is a CUDA tensor then needs no host read);
//   * the annealed schedule (PICPConfig.annealed_kernel): before each
//     round's linearization the threshold is max(thr, anneal_mult * med),
//     med the lower median of the chi of the staged points that project
//     in bounds at the current pose (0 when none does).  Each thread
//     writes its points' chi to a sixth staged row, then ranks each of
//     its points against all of them (ties broken by index): the point of
//     rank (n_in_bounds - 1) / 2 is the median.  O(N^2 / 128) compares a
//     round and two more barriers; exact, no speed work yet.
// Two runs give the same bits: every sum runs in a fixed order.  Compiled
// WITHOUT --use_fast_math: the rel-chi stop is knife-edge and approximate
// sin/cos/sqrt/div would move iteration counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 30;  // 21 H (upper triangle) + 6 g + chi_in, chi_out, n_in
constexpr int kStaged = 5;  // floats per staged point: X0, X1, X2, u, v (+ chi when annealed)

// One reduce-scatter level: 2*O values per lane in, O out.  A lane keeps
// the half selected by its bit O and adds its partner's copy of that half.
template <int O>
__device__ __forceinline__ void reduce_scatter_level(float* v, int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// The warp's total of v[lane] (v has 32 entries; lane l ends with sum l).
__device__ __forceinline__ float warp_reduce_scatter(float* v, int lane) {
  reduce_scatter_level<16>(v, lane);
  reduce_scatter_level<8>(v, lane);
  reduce_scatter_level<4>(v, lane);
  reduce_scatter_level<2>(v, lane);
  reduce_scatter_level<1>(v, lane);
  return v[0];
}

__global__ void __launch_bounds__(kThreads) picp_solve_kernel(
    const float* __restrict__ world,     // (B, M, 3), lane stride lane_w
    const int64_t* __restrict__ idx,     // (B, N), lane stride lane_i; or nullptr (world is per-observation)
    const float* __restrict__ uv,        // (B, N, 2), lane stride lane_z
    const uint8_t* __restrict__ valid,   // (B, N), lane stride lane_v
    const float* __restrict__ T0,        // (B, 4, 4)
    const float* __restrict__ thr_b,     // (B,) robust thresholds, or nullptr (thr for all)
    const float* __restrict__ Kd,        // (3, 3) row-major intrinsics, or nullptr (fx, fy, cx, cy)
    float* __restrict__ T_out,           // (B, 4, 4)
    int32_t* __restrict__ n_in_out,      // (B,)
    float* __restrict__ chi_in_out,      // (B,)
    float* __restrict__ chi_out_out,     // (B,)
    int32_t* __restrict__ iters_out,     // (B,)
    uint8_t* __restrict__ conv_out,      // (B,)
    int N, int M, int64_t lane_w, int64_t lane_i, int64_t lane_z, int64_t lane_v,
    float fx, float fy, float cx, float cy, float width, float height,
    float thr_all, float damping, float conv, int max_it, int min_inl,
    int keep_outliers, int anneal, float anneal_mult) {
  extern __shared__ float staged[];            // (kStaged + anneal, N): the valid rows, compacted
  __shared__ __align__(16) float part[2][kWarps][32];  // per-warp sums, by round parity
  __shared__ int warp_valid[kWarps];
  __shared__ float med_buf[2];                 // the annealed median, by round parity

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const float* Wb = world + b * lane_w;
  const int64_t* Ib = idx ? idx + b * lane_i : nullptr;
  const float* Zb = uv + b * lane_z;
  const uint8_t* Vb = valid + b * lane_v;
  const float thr_base = thr_b ? thr_b[b] : thr_all;
  if (Kd) { fx = Kd[0]; cx = Kd[2]; fy = Kd[4]; cy = Kd[5]; }
  float* sX0 = staged;
  float* sX1 = staged + N;
  float* sX2 = staged + 2 * N;
  float* sU = staged + 3 * N;
  float* sV = staged + 4 * N;
  float* sChi = staged + 5 * N;  // annealed only

  // ---- stage the valid rows once, in index order ----
  int nv = 0;
  for (int n0 = 0; n0 < N; n0 += kThreads) {
    const int n = n0 + tid;
    bool ok = false;
    float X0 = 0.f, X1 = 0.f, X2 = 0.f, zu = 0.f, zv = 0.f;
    if (n < N) {
      // valid, idx and uv are independent loads; world[idx] waits for idx only
      ok = Vb[n] != 0;
      const int64_t j = Ib ? Ib[n] : n;
      zu = Zb[n * 2 + 0];
      zv = Zb[n * 2 + 1];
      if (ok) { X0 = Wb[j * 3 + 0]; X1 = Wb[j * 3 + 1]; X2 = Wb[j * 3 + 2]; }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) warp_valid[warp] = __popc(ballot);
    __syncthreads();
    int pos = nv + __popc(ballot & ((1u << lane) - 1u));
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      pos += w < warp ? warp_valid[w] : 0;
      total += warp_valid[w];
    }
    if (ok) { sX0[pos] = X0; sX1[pos] = X1; sX2[pos] = X2; sU[pos] = zu; sV[pos] = zv; }
    nv += total;
    __syncthreads();  // warp_valid is rewritten by the next chunk; staged is complete
  }

  const float* T = T0 + (int64_t)b * 16;
  float R00 = T[0], R01 = T[1], R02 = T[2], t0 = T[3];
  float R10 = T[4], R11 = T[5], R12 = T[6], t1 = T[7];
  float R20 = T[8], R21 = T[9], R22 = T[10], t2 = T[11];

  float prev = 1e30f;  // PREV_CHI_INIT (see tpuvo_torch/ops/picp.py)
  int it = 0;
  bool done = false;
  float n_in = 0.f, chi_in = 0.f, chi_out = 0.f;
  bool convd = false;

  // point n at the current pose: camera frame, pixel, and whether it is in
  // front of the camera and in the image
#define PICP_PROJECT(n)                                                             \
  const float X0 = sX0[n], X1 = sX1[n], X2 = sX2[n];                                \
  const float px = R00 * X0 + R01 * X1 + R02 * X2 + t0;                             \
  const float py = R10 * X0 + R11 * X1 + R12 * X2 + t1;                             \
  const float pz = R20 * X0 + R21 * X1 + R22 * X2 + t2;                             \
  const float iz = 1.0f / (fabsf(pz) > 1e-12f ? pz : 1.0f);                         \
  const float u = (fx * px + cx * pz) * iz, v = (fy * py + cy * pz) * iz;           \
  const bool seen = pz > 0.f && u >= 0.f && u <= width - 1.0f && v >= 0.f &&        \
                    v <= height - 1.0f;                                             \
  const float eu = u - sU[n], ev = v - sV[n];

  while (!done && it < max_it) {
    float thr = thr_base;
    if (anneal) {
      // this round's threshold from the lower median of the in-bounds chi;
      // med_buf alternates by round parity, so no thread still reads the
      // slot that thread 0 clears here
      const int par = it & 1;
      const float inf = __int_as_float(0x7f800000);
      for (int n = tid; n < nv; n += kThreads) {
        PICP_PROJECT(n)
        sChi[n] = seen ? eu * eu + ev * ev : inf;
      }
      if (tid == 0) med_buf[par] = 0.f;
      __syncthreads();
      for (int n = tid; n < nv; n += kThreads) {
        const float c = sChi[n];
        if (!(c < inf)) continue;
        int used = 0, rank = 0;
        for (int j = 0; j < nv; ++j) {
          const float cj = sChi[j];
          used += cj < inf;
          rank += cj < c || (cj == c && j < n);
        }
        if (rank == (used - 1) / 2) med_buf[par] = c;
      }
      __syncthreads();  // sChi is rewritten only after the next round's barriers
      thr = fmaxf(thr_base, anneal_mult * med_buf[par]);
    }

    float s[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) s[k] = 0.f;

    for (int n = tid; n < nv; n += kThreads) {
      PICP_PROJECT(n)
      // culled rows contribute exactly nothing (the masked-row zeroing)
      if (!seen) continue;
      const float chi = eu * eu + ev * ev;
      const bool inl = chi <= thr;
      if (inl) { s[27] += chi; s[29] += 1.f; } else { s[28] += chi; }
      float w;
      if (inl) w = 1.f;
      else if (keep_outliers) w = sqrtf(thr / fmaxf(chi, 1e-20f));
      else continue;
      // J = Jp.K.Jr with Jr = [I | skew(-p_cam)]; C rows (fx/z, 0, (cx-u)/z)
      // and (0, fy/z, (cy-v)/z) — the (cx, cy) terms are not optional.
      const float a = fx * iz, bb = fy * iz;
      const float c = (cx - u) * iz, d = (cy - v) * iz;
      const float J0[6] = {a, 0.f, c, c * py, a * pz - c * px, -a * py};
      const float J1[6] = {0.f, bb, d, -bb * pz + d * py, -d * px, bb * px};
      int k = 0;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
#pragma unroll
        for (int q = r; q < 6; ++q) { s[k] += (J0[r] * J0[q] + J1[r] * J1[q]) * w; ++k; }
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) s[21 + r] += (J0[r] * eu + J1[r] * ev) * w;
    }

    // warp sums (lane l holds sum l), then one barrier and a fixed-order
    // sum over the warps; the parity buffer lets the next round write
    // while a slow thread still reads this one
    const int par = it & 1;
    part[par][warp][lane] = warp_reduce_scatter(s, lane);
    __syncthreads();
    float tot[32];
#pragma unroll
    for (int k4 = 0; k4 < 8; ++k4) {
      float4 acc = reinterpret_cast<const float4*>(part[par][0])[k4];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 p = reinterpret_cast<const float4*>(part[par][w])[k4];
        acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
      }
      tot[4 * k4 + 0] = acc.x; tot[4 * k4 + 1] = acc.y;
      tot[4 * k4 + 2] = acc.z; tot[4 * k4 + 3] = acc.w;
    }

    // every thread: damped 6x6 Cholesky solve H dx = -g (unrolled)
    float H[6][6];
    {
      int k = 0;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
#pragma unroll
        for (int q = r; q < 6; ++q) { H[r][q] = tot[k]; H[q][r] = tot[k]; ++k; }
      }
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) H[r][r] += damping;
    float L[6][6], inv[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float acc = H[j][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc -= L[j][k] * L[j][k];
      const float Ljj = sqrtf(fmaxf(acc, 1e-30f));
      L[j][j] = Ljj;
      inv[j] = 1.0f / Ljj;  // the one division of this pivot
#pragma unroll
      for (int i = j + 1; i < 6; ++i) {
        float a2 = H[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) a2 -= L[i][k] * L[j][k];
        L[i][j] = a2 * inv[j];
      }
    }
    float y[6], dx[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float a2 = -tot[21 + i];
#pragma unroll
      for (int k = 0; k < i; ++k) a2 -= L[i][k] * y[k];
      y[i] = a2 * inv[i];
    }
#pragma unroll
    for (int i = 5; i >= 0; --i) {
      float a2 = y[i];
#pragma unroll
      for (int k = i + 1; k < 6; ++k) a2 -= L[k][i] * dx[k];
      dx[i] = a2 * inv[i];
    }

    const float num_inl = tot[29];
    const bool ok = num_inl >= (float)min_inl;
    if (ok) {
      // T <- v2tEuler(dx) . T with R = Rx(dx3) Ry(dx4) Rz(dx5)
      float sa, ca, sb, cb, sc, cc;
      sincosf(dx[3], &sa, &ca);
      sincosf(dx[4], &sb, &cb);
      sincosf(dx[5], &sc, &cc);
      const float sasb = sa * sb, casb = ca * sb;
      const float D00 = cb * cc, D01 = -(cb * sc), D02 = sb;
      const float D10 = sasb * cc + ca * sc, D11 = ca * cc - sasb * sc, D12 = -(sa * cb);
      const float D20 = -(casb * cc) + sa * sc, D21 = sa * cc + casb * sc, D22 = ca * cb;
      const float n00 = D00 * R00 + D01 * R10 + D02 * R20;
      const float n01 = D00 * R01 + D01 * R11 + D02 * R21;
      const float n02 = D00 * R02 + D01 * R12 + D02 * R22;
      const float nt0 = D00 * t0 + D01 * t1 + D02 * t2 + dx[0];
      const float n10 = D10 * R00 + D11 * R10 + D12 * R20;
      const float n11 = D10 * R01 + D11 * R11 + D12 * R21;
      const float n12 = D10 * R02 + D11 * R12 + D12 * R22;
      const float nt1 = D10 * t0 + D11 * t1 + D12 * t2 + dx[1];
      const float n20 = D20 * R00 + D21 * R10 + D22 * R20;
      const float n21 = D20 * R01 + D21 * R11 + D22 * R21;
      const float n22 = D20 * R02 + D21 * R12 + D22 * R22;
      const float nt2 = D20 * t0 + D21 * t1 + D22 * t2 + dx[2];
      R00 = n00; R01 = n01; R02 = n02; t0 = nt0;
      R10 = n10; R11 = n11; R12 = n12; t1 = nt1;
      R20 = n20; R21 = n21; R22 = n22; t2 = nt2;
    }
    const float curr = tot[27];
    const float rel = prev > 1e-10f ? fabsf(prev - curr) / prev : 0.f;
    convd = ok && (rel < conv);
    done = (!ok) || convd;
    prev = curr;
    n_in = num_inl;
    chi_in = tot[27];
    chi_out = tot[28];
    ++it;
  }
#undef PICP_PROJECT

  if (tid == 0) {
    float* To = T_out + (int64_t)b * 16;
    To[0] = R00; To[1] = R01; To[2] = R02; To[3] = t0;
    To[4] = R10; To[5] = R11; To[6] = R12; To[7] = t1;
    To[8] = R20; To[9] = R21; To[10] = R22; To[11] = t2;
    To[12] = 0.f; To[13] = 0.f; To[14] = 0.f; To[15] = 1.f;
    n_in_out[b] = (int32_t)n_in;
    chi_in_out[b] = chi_in;
    chi_out_out[b] = chi_out;
    iters_out[b] = it;
    conv_out[b] = convd ? 1 : 0;
  }
}

}  // namespace

extern "C" int tpuvo_picp_solve(
    const void* world, const void* idx, const void* uv, const void* valid,
    const void* T0, const void* thr_b, const void* K, void* T_out, void* n_in, void* chi_in,
    void* chi_out, void* iters, void* converged, int B, int N, int M,
    int64_t lane_w, int64_t lane_i, int64_t lane_z, int64_t lane_v,
    float fx, float fy, float cx, float cy, float width, float height,
    float thr, float damping, float conv, int max_it, int min_inl,
    int keep_outliers, int anneal, float anneal_mult, void* stream) {
  if (B <= 0) return 0;
  if (lane_w < 0 || lane_i < 0 || lane_z < 0 || lane_v < 0) return (int)cudaErrorInvalidValue;
  anneal = anneal ? 1 : 0;
  const size_t smem = sizeof(float) * (kStaged + anneal) * (size_t)N;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        picp_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  picp_solve_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)world, (const int64_t*)idx, (const float*)uv,
      (const uint8_t*)valid, (const float*)T0, (const float*)thr_b, (const float*)K,
      (float*)T_out, (int32_t*)n_in, (float*)chi_in, (float*)chi_out, (int32_t*)iters,
      (uint8_t*)converged, N, M, lane_w, lane_i, lane_z, lane_v, fx, fy, cx, cy, width, height,
      thr, damping, conv, max_it, min_inl, keep_outliers, anneal, anneal_mult);
  return (int)cudaGetLastError();
}
