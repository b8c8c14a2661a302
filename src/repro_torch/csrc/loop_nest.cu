// The paper's loop-exchange variants as launch shapes on the card: one
// walker, two bodies (GKV exb_realspcal, Seism3D update_stress).
//
// Replaces: src/repro/core/exchange.py, LoopNest.variant_fn (each
// (variant, degree) of an elementwise loop nest, run there as lax.map
// steps), with the bodies in src/repro/apps/: gkv.py exb_body and
// seism3d.py update_stress_body.  The JAX package has no Pallas kernel for
// them; the TPU kernels of the same bodies (exb, stress) have their own
// ports with their own grids.  Here the variant's loop structure is the
// thing under test.
//
// A launch shape (repro_torch.core.exchange.launch_shape) of a nest whose
// elements are contiguous in C order:
//   launches  iterations of the loops above the directive, one launch each,
//             in order (OpenMP's fork and join of every outer iteration);
//   ctas      min(degree, P) for a directive loop of length P, one CTA a
//             thread;
//   per_cta   ceil(P / degree) directive iterations a CTA (OpenMP's static
//             schedule) times the inner extent, the loops below the
//             directive collapsed;
//   per_launch  P times the inner extent.
// Launch o covers elements [o per_launch, (o + 1) per_launch); CTA c walks
// its iterations in order, [c per_cta, min((c + 1) per_cta, per_launch))
// of it (a CTA past P has none), its kThreads threads striding over
// (iteration x inner).  The C entry points make the outer launches in
// their own loop, so one call from Python runs one variant: up to 65,536
// launches (Seism3D 256^3 at variant (3,3)), whose cost is part of what
// the variant is.
//
// What bounds it: bytes.  GKV reads six complex64 fields and vl and
// writes wkdf1, 60 bytes a point (127.8 MB at the paper's (16,16,128,65):
// 0.038 ms at 3.35 TB/s); Seism3D reads 17 float32 fields and writes 6, 92
// bytes a point (1.544 GB at 256^3).  Both do 24 and 28 flops a point.
// What the variants change is how much of the card the shape fills: a
// directive on a 16-long loop runs 16 CTAs, an inner one runs one launch
// per outer iteration, each a few microseconds of launch overhead.
//
// Design.  A templated walker, walk<Body>, takes the body as a functor by
// value (its field pointers in the kernel's parameters) and the shape as
// run-time values; each thread computes its elements with 64-bit indices
// and the body reads and writes them at that index, so a warp's accesses
// are contiguous.  A CTA has 1024 threads, the most it may: at a low
// degree a few CTAs stream the whole domain, and a CTA's rate is its bytes
// in flight (each thread loads all of a point's fields before its first
// store), so the widest CTA is the fastest "thread".  GKV's complex64
// fields are read as float2 (interleaved re, im), vl as float32, all
// pre-broadcast to (iv, iz, mx, my) as the JAX make_inputs gives them.
// The body's arithmetic is the JAX body's in its order; the compiler may
// contract a multiply and an add into an FMA, which the float32 tolerance
// covers.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // threads a CTA, whatever the shape
constexpr float kCs1 = 0.8775825618903728f;             // gkv.py CS1
constexpr float kCef = 1.0f / (2 * 128 * 2 * 64);       // gkv.py CEF
constexpr float kDt = 5.0e-3f;                           // seism3d.py DT

struct GkvExb {
  const float2 *df1, *df2, *exw, *eyw, *bxw, *byw;
  const float* vl;
  float2* out;

  __device__ __forceinline__ void operator()(long long e) const {
    const float t = kCs1 * vl[e];
    const float2 by = byw[e], bx = bxw[e], ey0 = eyw[e], ex0 = exw[e];
    const float2 a = df1[e], b = df2[e];
    const float eyr = ey0.x - t * by.x, eyi = ey0.y - t * by.y;
    const float exr = ex0.x - t * bx.x, exi = ex0.y - t * bx.y;
    const float re = a.x * eyr - b.x * exr;
    const float im = a.y * eyi - b.y * exi;
    out[e] = make_float2(re * kCef, im * kCef);
  }
};

// in: Sxx Syy Szz Sxy Sxz Syz, dxVx dyVy dzVz dxVy dyVx dxVz dzVx dyVz dzVy,
// lam rig; out: the six stress components
struct Seism3dStress {
  const float* in[17];
  float* out[6];

  __device__ __forceinline__ void operator()(long long e) const {
    float v[17];  // every load before the first store, which may alias them
#pragma unroll
    for (int i = 0; i < 17; ++i) v[i] = in[i][e];
    const float dxVx = v[6], dyVy = v[7], dzVz = v[8];
    const float rl = v[15], rm = v[16];
    const float rm2 = 2.0f * rm;
    const float rlrm2 = rl + rm2;
    const float d3 = dxVx + dyVy + dzVz;
    out[0][e] = v[0] + kDt * (rlrm2 * d3 - rm2 * (dyVy + dzVz));
    out[1][e] = v[1] + kDt * (rlrm2 * d3 - rm2 * (dxVx + dzVz));
    out[2][e] = v[2] + kDt * (rlrm2 * d3 - rm2 * (dxVx + dyVy));
    out[3][e] = v[3] + kDt * rm * (v[9] + v[10]);
    out[4][e] = v[4] + kDt * rm * (v[11] + v[12]);
    out[5][e] = v[5] + kDt * rm * (v[13] + v[14]);
  }
};

template <class Body>
__global__ void __launch_bounds__(kThreads) walk(const Body body, long long base,
                                                 long long per_cta, long long per_launch) {
  const long long start = static_cast<long long>(blockIdx.x) * per_cta;
  const long long end = min(start + per_cta, per_launch);
  for (long long e = start + threadIdx.x; e < end; e += kThreads) body(base + e);
}

// The variant's launches, in order; the first refused launch's error code.
template <class Body>
int run_launches(const Body& body, long long launches, int ctas, long long per_cta,
          long long per_launch, cudaStream_t stream) {
  if (launches < 1 || ctas < 1 || per_cta < 1 || per_launch < 1 ||
      static_cast<long long>(ctas) * per_cta < per_launch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (long long o = 0; o < launches; ++o) {
    walk<Body><<<ctas, kThreads, 0, stream>>>(body, o * per_launch, per_cta, per_launch);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// in: wkdf1 wkdf2 wkexw wkeyw wkbxw wkbyw (complex64) and vl (float32), all
// of launches * per_launch elements; out: wkdf1 (complex64).
extern "C" int loop_nest_gkv(const void* const* in, void* out, long long launches, int ctas,
                             long long per_cta, long long per_launch, void* stream) {
  GkvExb body;
  body.df1 = static_cast<const float2*>(in[0]);
  body.df2 = static_cast<const float2*>(in[1]);
  body.exw = static_cast<const float2*>(in[2]);
  body.eyw = static_cast<const float2*>(in[3]);
  body.bxw = static_cast<const float2*>(in[4]);
  body.byw = static_cast<const float2*>(in[5]);
  body.vl = static_cast<const float*>(in[6]);
  body.out = static_cast<float2*>(out);
  return run_launches(body, launches, ctas, per_cta, per_launch, static_cast<cudaStream_t>(stream));
}

// in: the 17 float32 fields in Seism3dStress's order; out: the 6 updated
// stress components.
extern "C" int loop_nest_seism3d(const void* const* in, void* const* out, long long launches,
                                 int ctas, long long per_cta, long long per_launch,
                                 void* stream) {
  Seism3dStress body;
  for (int i = 0; i < 17; ++i) body.in[i] = static_cast<const float*>(in[i]);
  for (int i = 0; i < 6; ++i) body.out[i] = static_cast<float*>(out[i]);
  return run_launches(body, launches, ctas, per_cta, per_launch, static_cast<cudaStream_t>(stream));
}
