// Fused projective-ICP Gauss-Newton solver: the whole GN loop for one pose
// runs inside one warp.
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
// What bounds it on an H100: nothing in bandwidth or FLOPs (N <= a few
// hundred points, ~100 flops each per round).  It is a chain of dependent
// rounds, so it is bound by latency: shuffle reductions and the serial
// Cholesky.  The design keeps every round inside registers of one warp:
//   * one warp per problem (grid over the batch), lanes stride over the
//     points, so a batch of 256 solves fills the card with one launch;
//   * the 30 sums are XOR-butterfly reduced, so EVERY lane holds the totals;
//   * every lane solves the 6x6 system and updates the pose redundantly, so
//     the loop state (pose, prev chi, done) is warp-uniform and the loop
//     never diverges; no shared memory and no block barrier.
// Compiled WITHOUT --use_fast_math: the rel-chi stop is knife-edge and
// approximate sin/cos/sqrt/div would move iteration counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kSums = 30;  // 21 H (upper triangle) + 6 g + chi_in, chi_out, n_in

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void picp_solve_kernel(
    const float* __restrict__ world,     // (B, M, 3)
    const int64_t* __restrict__ idx,     // (B, N) or nullptr (world is per-observation)
    const float* __restrict__ uv,        // (B, N, 2)
    const uint8_t* __restrict__ valid,   // (B, N)
    const float* __restrict__ T0,        // (B, 4, 4)
    float* __restrict__ T_out,           // (B, 4, 4)
    float* __restrict__ stats,           // (B, 8): n_in, chi_in, chi_out, iters, converged
    int B, int N, int M,
    float fx, float fy, float cx, float cy, float width, float height,
    float thr, float damping, float conv, int max_it, int min_inl,
    int keep_outliers) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warp leaves together

  const float* Wb = world + (int64_t)b * M * 3;
  const int64_t* Ib = idx ? idx + (int64_t)b * N : nullptr;
  const float* Zb = uv + (int64_t)b * N * 2;
  const uint8_t* Vb = valid + (int64_t)b * N;
  const float* T = T0 + (int64_t)b * 16;

  float R00 = T[0], R01 = T[1], R02 = T[2], t0 = T[3];
  float R10 = T[4], R11 = T[5], R12 = T[6], t1 = T[7];
  float R20 = T[8], R21 = T[9], R22 = T[10], t2 = T[11];

  float prev = 1e30f;  // PREV_CHI_INIT (see tpuvo_torch/ops/picp.py)
  int it = 0;
  bool done = false;
  float n_in = 0.f, chi_in = 0.f, chi_out = 0.f;
  bool convd = false;

  while (!done && it < max_it) {
    float s[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = 0.f;

    for (int n = lane; n < N; n += 32) {
      if (!Vb[n]) continue;
      int64_t j = Ib ? Ib[n] : n;
      const float X0 = Wb[j * 3 + 0], X1 = Wb[j * 3 + 1], X2 = Wb[j * 3 + 2];
      const float px = R00 * X0 + R01 * X1 + R02 * X2 + t0;
      const float py = R10 * X0 + R11 * X1 + R12 * X2 + t1;
      const float pz = R20 * X0 + R21 * X1 + R22 * X2 + t2;
      const float hx = fx * px + cx * pz;
      const float hy = fy * py + cy * pz;
      const float iz = 1.0f / (fabsf(pz) > 1e-12f ? pz : 1.0f);
      const float u = hx * iz, v = hy * iz;
      // culled rows contribute exactly nothing (the masked-row zeroing)
      if (!(pz > 0.f && u >= 0.f && u <= width - 1.0f && v >= 0.f && v <= height - 1.0f))
        continue;
      const float eu = u - Zb[n * 2 + 0];
      const float ev = v - Zb[n * 2 + 1];
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
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = warp_allsum(s[k]);

    // every lane: damped 6x6 Cholesky solve H dx = -g (unrolled)
    float H[6][6];
    {
      int k = 0;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
#pragma unroll
        for (int q = r; q < 6; ++q) { H[r][q] = s[k]; H[q][r] = s[k]; ++k; }
      }
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) H[r][r] += damping;
    float L[6][6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float acc = H[j][j];
#pragma unroll
      for (int k = 0; k < j; ++k) acc -= L[j][k] * L[j][k];
      const float Ljj = sqrtf(fmaxf(acc, 1e-30f));
      L[j][j] = Ljj;
      const float inv = 1.0f / Ljj;
#pragma unroll
      for (int i = j + 1; i < 6; ++i) {
        float a2 = H[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) a2 -= L[i][k] * L[j][k];
        L[i][j] = a2 * inv;
      }
    }
    float y[6], dx[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float a2 = -s[21 + i];
#pragma unroll
      for (int k = 0; k < i; ++k) a2 -= L[i][k] * y[k];
      y[i] = a2 / L[i][i];
    }
#pragma unroll
    for (int i = 5; i >= 0; --i) {
      float a2 = y[i];
#pragma unroll
      for (int k = i + 1; k < 6; ++k) a2 -= L[k][i] * dx[k];
      dx[i] = a2 / L[i][i];
    }

    const float num_inl = s[29];
    const bool ok = num_inl >= (float)min_inl;
    if (ok) {
      // T <- v2tEuler(dx) . T with R = Rx(dx3) Ry(dx4) Rz(dx5)
      const float ca = cosf(dx[3]), sa = sinf(dx[3]);
      const float cb = cosf(dx[4]), sb = sinf(dx[4]);
      const float cc = cosf(dx[5]), sc = sinf(dx[5]);
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
    const float curr = s[27];
    const float rel = prev > 1e-10f ? fabsf(prev - curr) / prev : 0.f;
    convd = ok && (rel < conv);
    done = (!ok) || convd;
    prev = curr;
    n_in = num_inl;
    chi_in = s[27];
    chi_out = s[28];
    ++it;
  }

  if (lane == 0) {
    float* To = T_out + (int64_t)b * 16;
    To[0] = R00; To[1] = R01; To[2] = R02; To[3] = t0;
    To[4] = R10; To[5] = R11; To[6] = R12; To[7] = t1;
    To[8] = R20; To[9] = R21; To[10] = R22; To[11] = t2;
    To[12] = 0.f; To[13] = 0.f; To[14] = 0.f; To[15] = 1.f;
    float* S = stats + (int64_t)b * 8;
    S[0] = n_in; S[1] = chi_in; S[2] = chi_out; S[3] = (float)it;
    S[4] = convd ? 1.f : 0.f; S[5] = 0.f; S[6] = 0.f; S[7] = 0.f;
  }
}

}  // namespace

extern "C" int tpuvo_picp_solve(
    const void* world, const void* idx, const void* uv, const void* valid,
    const void* T0, void* T_out, void* stats, int B, int N, int M,
    float fx, float fy, float cx, float cy, float width, float height,
    float thr, float damping, float conv, int max_it, int min_inl,
    int keep_outliers, void* stream) {
  if (B <= 0) return 0;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  picp_solve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)world, (const int64_t*)idx, (const float*)uv,
      (const uint8_t*)valid, (const float*)T0, (float*)T_out, (float*)stats,
      B, N, M, fx, fy, cx, cy, width, height, thr, damping, conv, max_it,
      min_inl, keep_outliers);
  return (int)cudaGetLastError();
}
