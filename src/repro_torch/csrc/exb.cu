// GKV exb_realspcal E x B update on split re/im float32 planes, for Hopper.
//
// Replaces: src/repro/kernels/exb/exb.py, _exb_kernel (launched by
// exb_pallas through pl.pallas_call).
//
//   out_re = (df1_re * (ey_re - CS1*vl*by_re) - df2_re * (ex_re - CS1*vl*bx_re)) * CEF
//   out_im = the same on the im planes
//
// df1/df2 and the outputs are (iv, iz, mx, my); the eight 3-D fields are
// (iz, mx, my), broadcast over iv; vl is (iv,).
//
// What bounds it: memory.  24 flops against ~26 bytes per output pair
// (4 four-dimensional loads + 2 stores, the 3-D fields amortised over iv),
// so the card's 3.35 TB/s is the ceiling and the flops are free.
//
// Design.  The tunables keep the paper's meaning: (block_iv, block_iz) is
// the grain of parallelism, a grid of (iv/block_iv) x (iz/block_iz) CTAs,
// from 1 CTA at (16,16) to 256 CTAs at (1,1) on the paper's domain.  Each
// CTA walks its tile.  (mx, my) is treated as one contiguous plane of
// mx*my floats, so neighbouring threads load neighbouring addresses although
// my = 65.  For each plane element a thread reads the eight 3-D fields once,
// into registers, and applies them to the block_iv values of iv: the reuse
// the TPU kernel got from an index map that drops the iv grid index.  The
// arithmetic is written with explicit round-to-nearest ops (no FMA
// contraction) so the kernel rounds exactly as the plain PyTorch version.
#include <cuda_runtime.h>

namespace {

constexpr float kCS1 = 0.8775825618903728f;
constexpr float kCEF = 1.0f / (2 * 128 * 2 * 64);
constexpr int kThreads = 256;

struct ExbArgs {
  const float* vl;
  const float* df1_re; const float* df1_im;
  const float* df2_re; const float* df2_im;
  const float* ex_re; const float* ex_im;
  const float* ey_re; const float* ey_im;
  const float* bx_re; const float* bx_im;
  const float* by_re; const float* by_im;
  float* out_re; float* out_im;
  int iz, plane, block_iv, block_iz;
};

__device__ __forceinline__ float shifted(float e, float cs1vl, float b) {
  return __fsub_rn(e, __fmul_rn(cs1vl, b));
}

__global__ void __launch_bounds__(kThreads) exb_kernel(ExbArgs a) {
  const int iv0 = blockIdx.x * a.block_iv;
  const int iz0 = blockIdx.y * a.block_iz;
  for (int z = iz0; z < iz0 + a.block_iz; ++z) {
    const size_t off3 = static_cast<size_t>(z) * a.plane;
    for (int e = threadIdx.x; e < a.plane; e += kThreads) {
      const size_t i3 = off3 + e;
      const float ex_re = __ldg(a.ex_re + i3), ex_im = __ldg(a.ex_im + i3);
      const float ey_re = __ldg(a.ey_re + i3), ey_im = __ldg(a.ey_im + i3);
      const float bx_re = __ldg(a.bx_re + i3), bx_im = __ldg(a.bx_im + i3);
      const float by_re = __ldg(a.by_re + i3), by_im = __ldg(a.by_im + i3);
      for (int v = iv0; v < iv0 + a.block_iv; ++v) {
        const float cs1vl = __fmul_rn(kCS1, __ldg(a.vl + v));
        const size_t i4 = (static_cast<size_t>(v) * a.iz + z) * a.plane + e;
        const float re = __fsub_rn(
            __fmul_rn(__ldg(a.df1_re + i4), shifted(ey_re, cs1vl, by_re)),
            __fmul_rn(__ldg(a.df2_re + i4), shifted(ex_re, cs1vl, bx_re)));
        const float im = __fsub_rn(
            __fmul_rn(__ldg(a.df1_im + i4), shifted(ey_im, cs1vl, by_im)),
            __fmul_rn(__ldg(a.df2_im + i4), shifted(ex_im, cs1vl, bx_im)));
        a.out_re[i4] = __fmul_rn(re, kCEF);
        a.out_im[i4] = __fmul_rn(im, kCEF);
      }
    }
  }
}

}  // namespace

// Inputs in the order of the JAX kernel's operands; returns the launch's
// cudaGetLastError() code (cudaErrorInvalidValue for tiles that do not
// divide the extents).
extern "C" int exb_launch(
    const void* vl,
    const void* df1_re, const void* df1_im, const void* df2_re, const void* df2_im,
    const void* ex_re, const void* ex_im, const void* ey_re, const void* ey_im,
    const void* bx_re, const void* bx_im, const void* by_re, const void* by_im,
    void* out_re, void* out_im,
    int iv, int iz, int plane, int block_iv, int block_iz, void* stream) {
  if (block_iv < 1 || block_iz < 1 || iv % block_iv || iz % block_iz || plane < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ExbArgs a;
  a.vl = static_cast<const float*>(vl);
  a.df1_re = static_cast<const float*>(df1_re);
  a.df1_im = static_cast<const float*>(df1_im);
  a.df2_re = static_cast<const float*>(df2_re);
  a.df2_im = static_cast<const float*>(df2_im);
  a.ex_re = static_cast<const float*>(ex_re);
  a.ex_im = static_cast<const float*>(ex_im);
  a.ey_re = static_cast<const float*>(ey_re);
  a.ey_im = static_cast<const float*>(ey_im);
  a.bx_re = static_cast<const float*>(bx_re);
  a.bx_im = static_cast<const float*>(bx_im);
  a.by_re = static_cast<const float*>(by_re);
  a.by_im = static_cast<const float*>(by_im);
  a.out_re = static_cast<float*>(out_re);
  a.out_im = static_cast<float*>(out_im);
  a.iz = iz;
  a.plane = plane;
  a.block_iv = block_iv;
  a.block_iz = block_iz;
  const dim3 grid(iv / block_iv, iz / block_iz);
  exb_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
