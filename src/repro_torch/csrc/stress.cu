// Seism3D update_stress on float32 (nk, nj, ni) fields, for Hopper.
//
// Replaces: src/repro/kernels/stress/stress.py, _stress_kernel (launched by
// stress_pallas through pl.pallas_call).
//
//   rm2 = 2 rig,  rlrm2 = lam + rm2,  d3 = dxVx + dyVy + dzVz
//   Sxx += DT (rlrm2 d3 - rm2 (dyVy + dzVz))    (Syy, Szz alike)
//   Sxy += DT rig (dxVy + dyVx)                  (Sxz, Syz alike)
//
// 17 input fields and 6 outputs, all (nk, nj, ni) float32, DT = 5e-3.
//
// What bounds it: memory.  About 30 flops against 92 bytes per cell (17
// loads and 6 stores of 4 bytes), so the card's 3.35 TB/s is the ceiling
// and the flops are free.
//
// Design.  As for exb, the tunables keep the paper's meaning: (block_k,
// block_j) is the grain of parallelism, a grid of (nk/block_k) x
// (nj/block_j) CTAs, each walking the block_k x block_j rows of its tile.
// The contiguous i dimension is never split (the paper's Fig-14 lesson):
// the CTA's threads stride over it, so neighbouring threads load
// neighbouring addresses of every field.  No shared memory is used: every
// value is read once, into registers.  The arithmetic is written with
// explicit round-to-nearest ops (no FMA contraction) in the plain version's
// order, so the kernel rounds exactly as the plain PyTorch version.
#include <cuda_runtime.h>

namespace {

constexpr float kDT = 5.0e-3f;
constexpr int kThreads = 256;
constexpr int kIn = 17;
constexpr int kOut = 6;

// Input order of the JAX kernel's operands (ref.INPUT_NAMES).
enum Field {
  kSxx, kSyy, kSzz, kSxy, kSxz, kSyz,
  kDxVx, kDyVy, kDzVz, kDxVy, kDyVx, kDxVz, kDzVx, kDyVz, kDzVy,
  kLam, kRig,
};

struct StressArgs {
  const float* in[kIn];
  float* out[kOut];  // Sxx, Syy, Szz, Sxy, Sxz, Syz
  int nj, ni, block_k, block_j;
};

__device__ __forceinline__ float ld(const StressArgs& a, int field, size_t c) {
  return __ldg(a.in[field] + c);
}

// s + DT * (rlrm2d3 - rm2 * (u + v)), the diagonal components
__device__ __forceinline__ float diag(float s, float rlrm2d3, float rm2, float u, float v) {
  return __fadd_rn(s, __fmul_rn(kDT, __fsub_rn(rlrm2d3, __fmul_rn(rm2, __fadd_rn(u, v)))));
}

// s + (DT * rig) * (u + v), the off-diagonal components
__device__ __forceinline__ float offdiag(float s, float dtrm, float u, float v) {
  return __fadd_rn(s, __fmul_rn(dtrm, __fadd_rn(u, v)));
}

__global__ void __launch_bounds__(kThreads) stress_kernel(const StressArgs a) {
  const int tiles_j = a.nj / a.block_j;
  const int k0 = (blockIdx.x / tiles_j) * a.block_k;
  const int j0 = (blockIdx.x % tiles_j) * a.block_j;
  for (int k = k0; k < k0 + a.block_k; ++k) {
    for (int j = j0; j < j0 + a.block_j; ++j) {
      const size_t row = (static_cast<size_t>(k) * a.nj + j) * a.ni;
      for (int i = threadIdx.x; i < a.ni; i += kThreads) {
        const size_t c = row + i;
        const float rm = ld(a, kRig, c);
        const float rm2 = __fmul_rn(2.0f, rm);
        const float rlrm2 = __fadd_rn(ld(a, kLam, c), rm2);
        const float vxx = ld(a, kDxVx, c);
        const float vyy = ld(a, kDyVy, c);
        const float vzz = ld(a, kDzVz, c);
        const float rlrm2d3 = __fmul_rn(rlrm2, __fadd_rn(__fadd_rn(vxx, vyy), vzz));
        const float dtrm = __fmul_rn(kDT, rm);
        a.out[0][c] = diag(ld(a, kSxx, c), rlrm2d3, rm2, vyy, vzz);
        a.out[1][c] = diag(ld(a, kSyy, c), rlrm2d3, rm2, vxx, vzz);
        a.out[2][c] = diag(ld(a, kSzz, c), rlrm2d3, rm2, vxx, vyy);
        a.out[3][c] = offdiag(ld(a, kSxy, c), dtrm, ld(a, kDxVy, c), ld(a, kDyVx, c));
        a.out[4][c] = offdiag(ld(a, kSxz, c), dtrm, ld(a, kDxVz, c), ld(a, kDzVx, c));
        a.out[5][c] = offdiag(ld(a, kSyz, c), dtrm, ld(a, kDyVz, c), ld(a, kDzVy, c));
      }
    }
  }
}

}  // namespace

// inputs: 17 device pointers in ref.INPUT_NAMES order; outputs: 6 in
// ref.OUTPUT_NAMES order.  Returns the launch's cudaGetLastError() code
// (cudaErrorInvalidValue for tiles that do not divide the extents).
extern "C" int stress_launch(
    const void* const* inputs, void* const* outputs,
    int nk, int nj, int ni, int block_k, int block_j, void* stream) {
  if (block_k < 1 || block_j < 1 || nk % block_k || nj % block_j || ni < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StressArgs a;
  for (int f = 0; f < kIn; ++f) a.in[f] = static_cast<const float*>(inputs[f]);
  for (int f = 0; f < kOut; ++f) a.out[f] = static_cast<float*>(outputs[f]);
  a.nj = nj;
  a.ni = ni;
  a.block_k = block_k;
  a.block_j = block_j;
  const unsigned grid = static_cast<unsigned>((nk / block_k) * (nj / block_j));
  stress_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
