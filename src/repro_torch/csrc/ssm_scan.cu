// Mamba-1 selective scan on float32 inputs, for Hopper.
//
// Replaces: src/repro/kernels/ssm_scan/ssm_scan.py, _ssm_kernel (launched
// by ssm_scan through pl.pallas_call).
//
//   h_t = exp(dt_t (x) A) . h_{t-1} + (dt_t x_t) (x) B_t      h: (D, N) per batch
//   y_t = h_t C_t + D . x_t
//
// x, dt and y are (B, S, D); A is (D, N); Bc and Cc are (B, S, N); the skip
// vector D is (D,).  The state is float32 and the (S, D, N) decay is never
// stored.
//
// What bounds it: on paper, memory (x, dt, y at 12 bytes per (t, d) against
// about 7 N operations, one an exp, so the bytes bind at N = 16).  Each
// channel's S steps depend on each other, so how much of the card the
// B*D*N independent states keep busy decides how close it comes.
//
// Design.  The TPU kernel carried h in VMEM scratch across an ordered grid
// axis of time chunks.  Blocks on the card run in no order, so a CTA never
// splits S with another: it loops over the whole sequence.  One thread per
// (d, n) pair keeps h[d, n] in a register (B*D*N = 131,072 threads at
// falcon-mamba-7b width, where one thread per channel would give only 8192
// threads, each with a 16-wide exp chain a step).  A CTA holds block_d
// channels, block_d*N threads; the N threads of a channel are an aligned
// segment of one warp, and y_t[d] is summed over n with __shfl_xor_sync
// inside the segment.  Per loop trip the CTA stages `chunk` steps of B_t
// and C_t (shared by all its channels) and of its own x and dt into shared
// memory with cp.async, all copies in flight at once, steps the recurrence
// out of shared memory, collects y in shared memory and stores it with
// neighbouring threads on neighbouring addresses.  expf is the exact
// library version; products and sums are explicit round-to-nearest ops in
// the plain version's order (the n-sum is a butterfly, the plain version's
// a sequential reduction).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

struct SsmArgs {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bc;
  const float* Cc;
  const float* skip;
  float* y;
  int S, D, block_d, chunk;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int N>
__global__ void __launch_bounds__(kMaxThreads) ssm_kernel(const SsmArgs a) {
  extern __shared__ float smem[];
  const int bd = a.block_d;
  const int ck = a.chunk;
  float* sx = smem;           // [chunk][block_d]
  float* sdt = sx + ck * bd;  // [chunk][block_d]
  float* sy = sdt + ck * bd;  // [chunk][block_d]
  float* sb = sy + ck * bd;   // [chunk][N]
  float* sc = sb + ck * N;    // [chunk][N]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // block_d * N
  const int dl = tid / N;
  const int n = tid % N;
  const int tiles = a.D / bd;
  const int b = blockIdx.x / tiles;
  const int d0 = (blockIdx.x % tiles) * bd;
  const float A = a.A[static_cast<size_t>(d0 + dl) * N + n];
  const float skip = a.skip[d0 + dl];
  const size_t row0 = static_cast<size_t>(b) * a.S;  // (b, t = 0)
  float h = 0.0f;
  for (int t0 = 0; t0 < a.S; t0 += ck) {
    for (int e = tid; e < ck * bd; e += nthreads) {
      const int t = e / bd;
      const size_t g = (row0 + t0 + t) * a.D + d0 + (e - t * bd);
      cp_async4(sx + e, a.x + g);
      cp_async4(sdt + e, a.dt + g);
    }
    const size_t gbn = (row0 + t0) * N;  // chunk * N contiguous values
    for (int e = tid; e < ck * N; e += nthreads) {
      cp_async4(sb + e, a.Bc + gbn + e);
      cp_async4(sc + e, a.Cc + gbn + e);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < ck; ++t) {
      const float xv = sx[t * bd + dl];
      const float dtv = sdt[t * bd + dl];
      const float decay = expf(__fmul_rn(dtv, A));
      h = __fadd_rn(__fmul_rn(decay, h), __fmul_rn(__fmul_rn(dtv, xv), sb[t * N + n]));
      float p = __fmul_rn(h, sc[t * N + n]);
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) {
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
      }
      if (n == 0) sy[t * bd + dl] = __fadd_rn(p, __fmul_rn(xv, skip));
    }
    __syncthreads();  // sy complete; sx, sdt, sb, sc free for the next trip
    for (int e = tid; e < ck * bd; e += nthreads) {
      const int t = e / bd;
      a.y[(row0 + t0 + t) * a.D + d0 + (e - t * bd)] = sy[e];
    }
  }
}

long long smem_bytes(int block_d, int chunk, int n_state) {
  return static_cast<long long>(sizeof(float)) * chunk * (3LL * block_d + 2LL * n_state);
}

template <int N>
int launch(const SsmArgs& a, int B, cudaStream_t stream) {
  const long long smem = smem_bytes(a.block_d, a.chunk, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(B * (a.D / a.block_d));
  ssm_kernel<N><<<grid, a.block_d * N, static_cast<size_t>(smem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The dynamic shared memory one CTA of (block_d, chunk) takes at n_state.
extern "C" long long ssm_scan_smem_bytes(int block_d, int chunk, int n_state) {
  return smem_bytes(block_d, chunk, n_state);
}

// x, dt, y: (B, S, D); A: (D, N); Bc, Cc: (B, S, N); skip: (D,); all
// float32.  N must be a power of two up to 32 and block_d * N a multiple of
// 32 up to 1024.  Returns the launch's cudaGetLastError() code
// (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int ssm_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bc, const void* Cc,
    const void* skip, void* y, int B, int S, int D, int N, int block_d, int chunk,
    void* stream) {
  const long long threads = static_cast<long long>(block_d) * N;
  if (B < 1 || block_d < 1 || chunk < 1 || D % block_d || S % chunk ||
      threads > kMaxThreads || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SsmArgs a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bc = static_cast<const float*>(Bc);
  a.Cc = static_cast<const float*>(Cc);
  a.skip = static_cast<const float*>(skip);
  a.y = static_cast<float*>(y);
  a.S = S;
  a.D = D;
  a.block_d = block_d;
  a.chunk = chunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1>(a, B, s);
    case 2: return launch<2>(a, B, s);
    case 4: return launch<4>(a, B, s);
    case 8: return launch<8>(a, B, s);
    case 16: return launch<16>(a, B, s);
    case 32: return launch<32>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
