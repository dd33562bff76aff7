// Kernel C's fast-path division, reciprocal and square root
// (tpuvo_torch/csrc/smalleig.cu: div_fast, rcp_fast, sqrt_fast) against the
// IEEE operators, and the latency of each in a dependent chain.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o build/kernel_c_fast_paths tools/kernel_c_fast_paths.cu && build/kernel_c_fast_paths
//
// Exactness: the inputs a fast path claims (ok left set) must give the
// operator's bits; prints the mismatches and the claimed count of each.
// The reciprocal and the square root try every one of the 2^32 bit
// patterns once, so their claimed counts are distinct inputs; the division
// tries 2^32 seeded pairs (operands between 2^-77 and 2^78, a +-0
// numerator in 1 of 256).
// Latency: one thread, 4096 dependent steps of each op, clock64 cycles a
// step, and the SM clock (clock64 over %globaltimer).
#include "../tpuvo_torch/csrc/smalleig.cu"
#include <cstdio>

__device__ uint32_t mix(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu; x ^= x >> 16;
  return x;
}

// exponent field uniform in [lo, lo + span), random mantissa and sign
__device__ float draw(uint32_t h, int lo, int span) {
  const uint32_t e = lo + (mix(h ^ 0x5bd1e995u) % span);
  return __uint_as_float((h & 0x807fffffu) | (e << 23));
}

__global__ void exactness(unsigned long long* out, uint32_t salt, int n) {
  unsigned long long c[6] = {0, 0, 0, 0, 0, 0};  // bad, claimed: div, rcp, sqrt
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const uint32_t bits = (salt << 30) | (uint32_t)i;  // every pattern once over 4 salts
    const uint32_t a = mix(bits), b = mix(a + 0x9e3779b9u);
    const float y = draw(b, 50, 155);
    const float x = (i & 255) == 0 ? __uint_as_float(a & 0x80000000u) : draw(a, 50, 155);
    bool ok = true;
    const float q = div_fast(x, y, ok);
    if (ok) { ++c[1]; c[0] += __float_as_uint(q) != __float_as_uint(x / y); }
    const float u = __uint_as_float(bits);
    ok = true;
    const float r = rcp_fast(u, ok);
    if (ok) { ++c[3]; c[2] += __float_as_uint(r) != __float_as_uint(1.0f / u); }
    const float w = __uint_as_float(bits);
    ok = true;
    const float s = sqrt_fast(w, ok);
    if (ok) { ++c[5]; c[4] += __float_as_uint(s) != __float_as_uint(sqrtf(w)); }
  }
  for (int j = 0; j < 6; ++j) atomicAdd(out + j, c[j]);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void latency(const float* in, float* out, long long* cyc, int iters) {
  float x = in[0];
  const float y = in[1];
  bool ok = true;
  long long t[7];
  const unsigned long long g0 = global_ns();
  t[0] = clock64();
  for (int i = 0; i < iters; ++i) x = fmaf(x, y, 1e-7f);
  t[1] = clock64();
  for (int i = 0; i < iters; ++i) x = y / x;
  t[2] = clock64();
  for (int i = 0; i < iters; ++i) x = div_fast(y, x, ok);
  t[3] = clock64();
  for (int i = 0; i < iters; ++i) x = sqrtf(x + 2.0f);
  t[4] = clock64();
  for (int i = 0; i < iters; ++i) x = sqrt_fast(x + 2.0f, ok);
  t[5] = clock64();
  for (int i = 0; i < iters; ++i) x = 1.0f / x;
  t[6] = clock64();
  const unsigned long long g1 = global_ns();
  for (int j = 0; j < 6; ++j) cyc[j] = t[j + 1] - t[j];
  cyc[6] = t[6] - t[0];
  cyc[7] = (long long)(g1 - g0);
  out[0] = x + (ok ? 0.0f : 1.0f);
}

int main() {
  unsigned long long* d;
  cudaMalloc(&d, 6 * sizeof(unsigned long long));
  cudaMemset(d, 0, 6 * sizeof(unsigned long long));
  for (uint32_t salt = 0; salt < 4; ++salt) exactness<<<1024, 256>>>(d, salt, 1 << 30);
  unsigned long long h[6];
  cudaMemcpy(h, d, sizeof h, cudaMemcpyDeviceToHost);
  printf("exactness (%s): div_fast %llu differ of %llu claimed; rcp_fast %llu of %llu; "
         "sqrt_fast %llu of %llu\n", cudaGetErrorString(cudaGetLastError()), h[0], h[1], h[2],
         h[3], h[4], h[5]);
  const float h_in[2] = {1.5f, 3.0f};
  float *in, *out;
  long long* cyc;
  cudaMalloc(&in, sizeof h_in); cudaMalloc(&out, sizeof(float)); cudaMalloc(&cyc, 8 * 8);
  cudaMemcpy(in, h_in, sizeof h_in, cudaMemcpyHostToDevice);
  const int iters = 4096;
  latency<<<1, 1>>>(in, out, cyc, iters);  // warm
  latency<<<1, 1>>>(in, out, cyc, iters);
  long long c[8];
  cudaMemcpy(c, cyc, sizeof c, cudaMemcpyDeviceToHost);
  const char* names[6] = {"FFMA", "x / y (IEEE operator)", "div_fast", "sqrtf(x + 2)",
                          "sqrt_fast(x + 2)", "1 / x (IEEE operator)"};
  for (int j = 0; j < 6; ++j) printf("latency %-24s %.1f cycles a step\n", names[j], (double)c[j] / iters);
  printf("SM clock %.3f GHz (clock64 over globaltimer)\n", (double)c[6] / c[7]);
  return 0;
}
