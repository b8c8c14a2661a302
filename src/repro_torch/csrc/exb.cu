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
// Design.  The tunables keep the paper's meaning and add depth:
// (block_iv, block_iz) is the grain of parallelism, and `split` cuts each
// (mx, my) plane, taken as one contiguous run of mx*my floats, into that
// many contiguous pieces, one CTA each: a grid of split x (iv/block_iv) x
// (iz/block_iz) CTAs, from 1 CTA at (16,16,1) to over a thousand.  A CTA
// has as many threads (up to 256) as its piece needs for two elements a
// thread.  Where the plane is a multiple of 4 floats every row starts on 16
// bytes, and an element is a float4 (16-byte loads and stores); any other
// plane, where rows start off 16 bytes, runs the same kernel on single
// floats.  Each thread takes two elements at once, so the loads of both are
// in flight together: it reads their eight 3-D fields once, into registers,
// and applies them to the block_iv values of iv (the reuse the TPU kernel
// got from an index map that drops the iv grid index), the 4-D loads of the
// two elements issued before either is computed.  The 4-D fields and the
// outputs are streamed (evict-first), so the 3-D fields stay in the L2 for
// the other iv blocks.  The arithmetic is written with explicit
// round-to-nearest ops (no FMA contraction) so the kernel rounds exactly as
// the plain PyTorch version.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float kCS1 = 0.8775825618903728f;
constexpr float kCEF = 1.0f / (2 * 128 * 2 * 64);
constexpr int kMaxThreads = 256;
constexpr int kUnroll = 2;  // elements a thread has in flight

struct ExbArgs {
  const float* vl;
  const float* df1_re; const float* df1_im;
  const float* df2_re; const float* df2_im;
  const float* ex_re; const float* ex_im;
  const float* ey_re; const float* ey_im;
  const float* bx_re; const float* bx_im;
  const float* by_re; const float* by_im;
  float* out_re; float* out_im;
  int iz, n, piece, block_iv, block_iz;  // n: elements a plane; piece: a CTA's
};

// One element: a float4 or a float, with the kernel's rounding per lane.
template <typename V> struct Lanes;
template <> struct Lanes<float> {
  static constexpr int kN = 1;
  static __device__ __forceinline__ float& at(float& x, int) { return x; }
};
template <> struct Lanes<float4> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ float& at(float4& x, int i) {
    return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
  }
};

__device__ __forceinline__ float shifted(float e, float cs1vl, float b) {
  return __fsub_rn(e, __fmul_rn(cs1vl, b));
}

template <typename V>
__global__ void __launch_bounds__(kMaxThreads) exb_kernel(ExbArgs a) {
  using L = Lanes<V>;
  const int e0 = blockIdx.x * a.piece;
  const int e1 = min(a.n, e0 + a.piece);
  const int iv0 = blockIdx.y * a.block_iv;
  const int iz0 = blockIdx.z * a.block_iz;
  const V* ex_re = reinterpret_cast<const V*>(a.ex_re);
  const V* ex_im = reinterpret_cast<const V*>(a.ex_im);
  const V* ey_re = reinterpret_cast<const V*>(a.ey_re);
  const V* ey_im = reinterpret_cast<const V*>(a.ey_im);
  const V* bx_re = reinterpret_cast<const V*>(a.bx_re);
  const V* bx_im = reinterpret_cast<const V*>(a.bx_im);
  const V* by_re = reinterpret_cast<const V*>(a.by_re);
  const V* by_im = reinterpret_cast<const V*>(a.by_im);
  const V* df1_re = reinterpret_cast<const V*>(a.df1_re);
  const V* df1_im = reinterpret_cast<const V*>(a.df1_im);
  const V* df2_re = reinterpret_cast<const V*>(a.df2_re);
  const V* df2_im = reinterpret_cast<const V*>(a.df2_im);
  V* out_re = reinterpret_cast<V*>(a.out_re);
  V* out_im = reinterpret_cast<V*>(a.out_im);

  for (int z = iz0; z < iz0 + a.block_iz; ++z) {
    for (int base = e0 + threadIdx.x; base < e1; base += kUnroll * blockDim.x) {
      int e[kUnroll];
      bool ok[kUnroll];
      V f[kUnroll][8];  // ex, ey, bx, by; re then im
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        e[u] = base + u * blockDim.x;
        ok[u] = e[u] < e1;
        if (ok[u]) {
          const size_t i3 = static_cast<size_t>(z) * a.n + e[u];
          f[u][0] = __ldg(ex_re + i3); f[u][1] = __ldg(ey_re + i3);
          f[u][2] = __ldg(bx_re + i3); f[u][3] = __ldg(by_re + i3);
          f[u][4] = __ldg(ex_im + i3); f[u][5] = __ldg(ey_im + i3);
          f[u][6] = __ldg(bx_im + i3); f[u][7] = __ldg(by_im + i3);
        }
      }
      for (int vv = iv0; vv < iv0 + a.block_iv; ++vv) {
        const float cs1vl = __fmul_rn(kCS1, __ldg(a.vl + vv));
        const size_t row = (static_cast<size_t>(vv) * a.iz + z) * a.n;
        V d[kUnroll][4];  // df1_re, df2_re, df1_im, df2_im
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (ok[u]) {
            const size_t i4 = row + e[u];
            d[u][0] = __ldcs(df1_re + i4); d[u][1] = __ldcs(df2_re + i4);
            d[u][2] = __ldcs(df1_im + i4); d[u][3] = __ldcs(df2_im + i4);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!ok[u]) continue;
          V re, im;
#pragma unroll
          for (int c = 0; c < L::kN; ++c) {
            L::at(re, c) = __fmul_rn(__fsub_rn(
                __fmul_rn(L::at(d[u][0], c), shifted(L::at(f[u][1], c), cs1vl, L::at(f[u][3], c))),
                __fmul_rn(L::at(d[u][1], c), shifted(L::at(f[u][0], c), cs1vl, L::at(f[u][2], c)))),
                kCEF);
            L::at(im, c) = __fmul_rn(__fsub_rn(
                __fmul_rn(L::at(d[u][2], c), shifted(L::at(f[u][5], c), cs1vl, L::at(f[u][7], c))),
                __fmul_rn(L::at(d[u][3], c), shifted(L::at(f[u][4], c), cs1vl, L::at(f[u][6], c)))),
                kCEF);
          }
          __stcs(out_re + row + e[u], re);
          __stcs(out_im + row + e[u], im);
        }
      }
    }
  }
}

}  // namespace

// Inputs in the order of the JAX kernel's operands; returns the launch's
// cudaGetLastError() code (cudaErrorInvalidValue for tiles that do not
// divide the extents, or a split below 1).
extern "C" int exb_launch(
    const void* vl,
    const void* df1_re, const void* df1_im, const void* df2_re, const void* df2_im,
    const void* ex_re, const void* ex_im, const void* ey_re, const void* ey_im,
    const void* bx_re, const void* bx_im, const void* by_re, const void* by_im,
    void* out_re, void* out_im,
    int iv, int iz, int plane, int block_iv, int block_iz, int split, void* stream) {
  if (block_iv < 1 || block_iz < 1 || iv % block_iv || iz % block_iz || plane < 1 ||
      split < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ptrs[] = {df1_re, df1_im, df2_re, df2_im, ex_re, ex_im, ey_re, ey_im,
                        bx_re, bx_im, by_re, by_im, out_re, out_im};
  bool vec = plane % 4 == 0;
  for (const void* p : ptrs) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  a.n = vec ? plane / 4 : plane;
  a.piece = (a.n + split - 1) / split;
  a.block_iv = block_iv;
  a.block_iz = block_iz;
  // threads for two elements each, whole warps, at most kMaxThreads
  const int want = (a.piece + kUnroll - 1) / kUnroll;
  const int threads = want >= kMaxThreads ? kMaxThreads : (want + 31) / 32 * 32;
  const dim3 grid(split, iv / block_iv, iz / block_iz);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    exb_kernel<float4><<<grid, threads, 0, s>>>(a);
  } else {
    exb_kernel<float><<<grid, threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

