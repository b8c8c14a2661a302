// RG-LRU recurrence (recurrentgemma's real-gated linear recurrent unit) on
// float32 (B, S, W) inputs, for Hopper.
//
// Replaces: src/repro/kernels/rglru_scan/rglru_scan.py, _rglru_kernel
// (launched by rglru_scan through pl.pallas_call).
//
//   a_t = exp(-8 r_t softplus(-lam))
//   h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) (i_t x_t),   y_t = h_t
//
// x, r, i and y are (B, S, W); lam is (W,); the state h is float32.
//
// What bounds it: on paper, memory (11 flops against 16 bytes per element:
// three loads and one store).  In fact the sequence: each channel's S steps
// depend on each other, and at recurrentgemma-2b width there are only
// B*W = 2560 channels, one thread each, too few to hide a step's latency.
//
// Design.  The TPU kernel carried h in VMEM scratch across an ordered grid
// axis of time chunks.  Blocks on the card run in no order, so a CTA never
// splits S with another: one thread per (b, w) channel keeps h in a
// register over the whole sequence, and a CTA holds block_w channels
// (blockDim.x = block_w, at most 1024).  Per loop trip the CTA stages
// `chunk` time steps of x, r and i into shared memory with cp.async (each
// thread copies its own channel's column, neighbouring threads neighbouring
// addresses, all copies in flight at once), waits, and steps the recurrence
// out of shared memory, storing y_t as it goes.  softplus(-lam) is computed
// once per channel, outside the loop, as logaddexp(-lam, 0) with no
// threshold (jax.nn.softplus).  expf and sqrtf are the exact library
// versions, and the arithmetic is written with explicit round-to-nearest
// ops in the plain version's order.
#include <cuda_runtime.h>

namespace {

constexpr float kCFactor = 8.0f;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// log(1 + exp(v)) as logaddexp(v, 0): max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float softplus(float v) {
  return __fadd_rn(fmaxf(v, 0.0f), log1pf(expf(-fabsf(v))));
}

__global__ void __launch_bounds__(kMaxThreads) rglru_kernel(
    const float* __restrict__ x, const float* __restrict__ r,
    const float* __restrict__ ig, const float* __restrict__ lam,
    float* __restrict__ y, int S, int W, int chunk) {
  extern __shared__ float smem[];
  const int bw = blockDim.x;
  float* sx = smem;
  float* sr = sx + chunk * bw;
  float* si = sr + chunk * bw;
  const int tiles = W / bw;
  const int b = blockIdx.x / tiles;
  const int w = (blockIdx.x % tiles) * bw + threadIdx.x;
  const float splam = softplus(-lam[w]);
  const size_t base = static_cast<size_t>(b) * S * W + w;
  float h = 0.0f;
  for (int t0 = 0; t0 < S; t0 += chunk) {
    for (int t = 0; t < chunk; ++t) {
      const size_t g = base + static_cast<size_t>(t0 + t) * W;
      const int s = t * bw + threadIdx.x;
      cp_async4(sx + s, x + g);
      cp_async4(sr + s, r + g);
      cp_async4(si + s, ig + g);
    }
    cp_async_wait_all();  // a thread reads back only the column it copied
#pragma unroll 4
    for (int t = 0; t < chunk; ++t) {
      const int s = t * bw + threadIdx.x;
      const float a = expf(__fmul_rn(__fmul_rn(-kCFactor, sr[s]), splam));
      const float gain = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)), 1e-12f));
      h = __fadd_rn(__fmul_rn(a, h), __fmul_rn(gain, __fmul_rn(si[s], sx[s])));
      y[base + static_cast<size_t>(t0 + t) * W] = h;
    }
  }
}

long long smem_bytes(int block_w, int chunk) {
  return 3LL * chunk * block_w * static_cast<long long>(sizeof(float));
}

}  // namespace

// The dynamic shared memory one CTA of (block_w, chunk) takes.
extern "C" long long rglru_scan_smem_bytes(int block_w, int chunk) {
  return smem_bytes(block_w, chunk);
}

// x, r, i, y: (B, S, W) float32; lam: (W,) float32.  Returns the launch's
// cudaGetLastError() code (cudaErrorInvalidValue for tiles the kernel does
// not take).
extern "C" int rglru_scan_launch(
    const void* x, const void* r, const void* i, const void* lam, void* y,
    int B, int S, int W, int block_w, int chunk, void* stream) {
  if (block_w < 1 || block_w > kMaxThreads || chunk < 1 || W % block_w || S % chunk ||
      B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = smem_bytes(block_w, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      rglru_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(B * (W / block_w));
  rglru_kernel<<<grid, block_w, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<const float*>(i), static_cast<const float*>(lam),
      static_cast<float*>(y), S, W, chunk);
  return static_cast<int>(cudaGetLastError());
}
