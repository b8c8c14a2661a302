// Mamba-1 selective scan on float32 or bf16 inputs, for Hopper.
//
// Replaces: src/repro/kernels/ssm_scan/ssm_scan.py, _ssm_kernel (launched
// by ssm_scan through pl.pallas_call).
//
//   h_t = exp(dt_t (x) A) . h_{t-1} + (dt_t x_t) (x) B_t      h: (D, N) per batch
//   y_t = h_t C_t + D . x_t
//
// x, dt, Bc, Cc and y share one element type, float32 or bf16 (y takes
// x's, as in the JAX kernel); A (D, N) and the skip vector D (D,) are
// float32; x, dt, y are (B, S, D) and Bc, Cc (B, S, N).  The state and all
// arithmetic are float32 and the (S, D, N) decay is never stored.  Where
// the caller passes h_out (B, D, N) float32 (a model's prefill, whose
// decode starts from it), the threads that carry the state write it there
// after the last step; a null h_out writes nothing.
//
// What bounds it: on paper, one exp per (t, d, n) on the SFU (16 a clock
// per SM, 0.064 ms at falcon-mamba-7b width on an H100 SXM), about as long
// as the bytes (x, dt, y at 12 bytes per (t, d) in float32: 0.060 ms; half
// that in bf16).  On the card, the chain of one warp's step: its time
// follows the warp-steps (N / K threads a channel), hardly the exps or the
// B/C loads, as long as an SM holds about 8 warps to overlap the chains
// (at B = 1, K = 4 is the most states that still gives them).
//
// Design.  The TPU kernel carried h in VMEM scratch across an ordered grid
// axis of time chunks.  Blocks on the card run in no order, so a CTA loops
// over the whole sequence for its channels.  One thread keeps K = `states`
// consecutive states of one channel in registers (K in 1..16, dividing N),
// so a channel takes N / K consecutive lanes.  Per (step, state) the update
// is one FMUL and one MUFU.EX2 for the decay (A * log2 e is formed once per
// state, outside the loop), one FMUL for (dt x) B_t[n] (dt x formed once
// per step) and two FMAs: h = fma(decay, h, u B), y = fma(h, C, y).  B_t
// and C_t are read as 16-byte vectors; x and dt once per step.
//
// A warp runs its instructions in order, so a step done alone waits on its
// loads, its exps and its shuffles in turn, and the first version of this
// kernel ran at one step per ~330 cycles whatever K was.  Steps are taken in
// groups of U = 32 / K: first every decay and input of the group (nothing
// there waits on h), then the recurrence, then the y sums over the
// channel's N / K lanes as a reduce-scatter: each of log2(N / K) levels
// sends half the group's partial sums to the partner lane and adds the
// half it keeps, so U (1 - K / N) shuffles finish all U sums (a butterfly
// per step takes U log2(N / K)) and lane g ends with U K / N whole sums,
// whose y it stores.
//
// Per loop trip the CTA stages `chunk` steps of x and dt for its block_d
// channels and of B_t and C_t into one of two shared-memory stages with
// cp.async (16-byte pieces where the tile allows), so the loads of trip
// k + 1 fly while trip k is scanned; one barrier a trip.  y goes straight
// to global memory: a warp's stores cover 32 K / N neighbouring channels of
// N / K steps.  A trip that ends short of a whole group (the last trip of
// a sequence that is no multiple of chunk, or a chunk that is no multiple
// of U) has the rows up to its last group's end set to 0 in shared memory:
// dt = 0 is decay 1 and input 0, so h passes through them unchanged, and
// they store nothing.  So any S runs, and the loop over groups is the same
// for every trip.
//
// State sizes.  N is any value from 1 to 256; the kernel runs on NP, the
// power of two at or above it, as its lanes and its shared-memory rows of
// B_t and C_t.  The states past N read A = 0 and B = C = 0 (the columns
// past N of every staged row are set to 0 once, and cp.async never writes
// them), so their decay is 1, their input 0, h stays 0 and they add nothing
// to y; no padded copy is made in memory.  A channel takes NP / K lanes,
// at most a warp's 32.  Past N = 32 that is more lanes than the U steps of
// a group: the reduce-scatter then leaves each lane one step's sum over
// U of the lanes, and a butterfly over the remaining NP / (K U) lanes
// completes it; the first of those lanes stores it.  Both cases (N no
// power of two, N past 32) run an instantiation of their own (General):
// one that took them whatever N was ran the power-of-two sizes up to 32 in
// bf16 10-15% slower, so those keep the code they ran before.
#include "scan_staging.cuh"

namespace {

struct SsmArgs {
  const void* x;
  const void* dt;
  const float* A;
  const void* Bc;
  const void* Cc;
  const float* skip;
  void* y;
  float* h_out;  // the final state (B, D, N), or null
  int S, D, N, block_d, chunk;
  int g_xd, g_bc;  // staging piece sizes in bytes (scan::copy_bytes)
  int np;          // N rounded up to a power of two
};

// The most threads a CTA of K states a thread takes: ssm_kernel's launch
// bound (one CTA an SM at the least), which leaves 128 registers a thread
// for a group's 2 U K decays and inputs, and 255 at K >= 8, whose 2 K
// states and coefficients come on top.
constexpr int max_threads(int K) { return K >= 8 ? 256 : 512; }

// Rows of one stage: the chunk rounded up to a whole group at any states
// (U = 32 / K divides 32), so a short trip's last group stays inside it.
__host__ __device__ constexpr int stage_rows(int chunk) { return (chunk + 31) / 32 * 32; }

// The states the kernel runs on: N rounded up to a power of two.
constexpr int pad_states(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// Bytes of one stage: x, dt as [rows][block_d], Bc, Cc as [rows][NP],
// each region 16-byte aligned.
long long stage_bytes(int block_d, int chunk, int n_state, int elt) {
  const long long rows = stage_rows(chunk);
  return 2 * scan::align16(rows * block_d * elt) +
         2 * scan::align16(rows * pad_states(n_state) * elt);
}

long long smem_bytes(int block_d, int chunk, int n_state, int elt) {
  return 2 * stage_bytes(block_d, chunk, n_state, elt);
}

template <typename T, int K, bool General>
__global__ void __launch_bounds__(K >= 8 ? 256 : 512, 1) ssm_kernel(const SsmArgs a) {
  constexpr int U = 32 / K;  // steps of a group: at least the threads of a channel
  constexpr int kLevels = K == 1 ? 5 : K == 2 ? 4 : K == 4 ? 3 : K == 8 ? 2 : 1;  // log2(U)
  extern __shared__ __align__(16) unsigned char smem[];
  const int bd = a.block_d, ck = a.chunk, N = a.N, D = a.D;
  const int NP = General ? a.np : N;  // N itself unless General
  const int tpc = NP / K;  // threads of one channel
  const int xd_bytes = static_cast<int>(scan::align16(1LL * stage_rows(ck) * bd * sizeof(T)));
  const int bc_bytes = static_cast<int>(scan::align16(1LL * stage_rows(ck) * NP * sizeof(T)));
  const int stage = 2 * xd_bytes + 2 * bc_bytes;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int dl = tid / tpc;
  const int g = tid - dl * tpc;
  // lanes that end a group with the same step's sum (more than 1 only past
  // N = 32), the steps of a group whose y a storing lane stores, and the
  // lane's first
  const int spread = General && tpc > U ? tpc / U : 1;
  const int m = General && tpc > U ? 1 : U / tpc;
  const int lane_first = General ? g / spread * m : g * m;
  const bool stores = !General || g % spread == 0;
  const int tiles = D / bd;
  const int b = blockIdx.x / tiles;
  const int d0 = (blockIdx.x % tiles) * bd;
  const int d = d0 + dl;

  float a2[K], h[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int n = g * K + j;
    if constexpr (General) {
      a2[j] = n < N ? a.A[static_cast<size_t>(d) * N + n] * scan::kLog2e : 0.0f;
    } else {
      a2[j] = a.A[static_cast<size_t>(d) * N + n] * scan::kLog2e;
    }
    h[j] = 0.0f;
  }
  const float skip = a.skip[d];
  const size_t row0 = static_cast<size_t>(b) * a.S;  // (b, t = 0)
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);
  const T* Bc = static_cast<const T*>(a.Bc);
  const T* Cc = static_cast<const T*>(a.Cc);
  T* y = static_cast<T*>(a.y) + row0 * D + d;

  // the steps of trip k inside the sequence
  auto rows_of = [&](int k) { return min(ck, a.S - k * ck); };

  // cp.async trip `trip` into stage `s`: x, dt rows of block_d elements
  // (row stride D), then the trip's N values a step of Bc and Cc into rows
  // of NP; a short trip's rows up to its last group's end are set to 0.
  auto load_trip = [&](int trip, int s) {
    unsigned char* base = smem + s * stage;
    const size_t r = row0 + static_cast<size_t>(trip) * ck;
    const int n = rows_of(trip);
    const int gx = a.g_xd, row_pieces = bd * static_cast<int>(sizeof(T)) / gx;
    const char* xs = reinterpret_cast<const char*>(x + r * D + d0);
    const char* dts = reinterpret_cast<const char*>(dt + r * D + d0);
    const size_t stride = static_cast<size_t>(D) * sizeof(T);
    for (int e = tid; e < n * row_pieces; e += nthreads) {
      const int t = e / row_pieces;
      const int off = t * bd * static_cast<int>(sizeof(T)) + (e - t * row_pieces) * gx;
      const size_t src = t * stride + (e - t * row_pieces) * gx;
      scan::copy_piece(base + off, xs + src, gx);
      scan::copy_piece(base + xd_bytes + off, dts + src, gx);
    }
    const int gb = a.g_bc;
    const char* bs = reinterpret_cast<const char*>(Bc + r * N);
    const char* cs = reinterpret_cast<const char*>(Cc + r * N);
    if constexpr (!General) {  // the trip's rows are contiguous in both
      const int bc_pieces = n * N * static_cast<int>(sizeof(T)) / gb;
      for (int e = tid; e < bc_pieces; e += nthreads) {
        scan::copy_piece(base + 2 * xd_bytes + e * gb, bs + e * gb, gb);
        scan::copy_piece(base + 2 * xd_bytes + bc_bytes + e * gb, cs + e * gb, gb);
      }
    } else {
      const int bc_row = N * static_cast<int>(sizeof(T)) / gb;
      for (int e = tid; e < n * bc_row; e += nthreads) {
        const int t = e / bc_row;
        const int piece = (e - t * bc_row) * gb;
        const int off = t * NP * static_cast<int>(sizeof(T)) + piece;
        const int src = t * N * static_cast<int>(sizeof(T)) + piece;
        scan::copy_piece(base + 2 * xd_bytes + off, bs + src, gb);
        scan::copy_piece(base + 2 * xd_bytes + bc_bytes + off, cs + src, gb);
      }
    }
    const int dead = (n + U - 1) / U * U - n;
    T* zx = reinterpret_cast<T*>(base) + n * bd;
    T* zdt = reinterpret_cast<T*>(base + xd_bytes) + n * bd;
    T* zb = reinterpret_cast<T*>(base + 2 * xd_bytes) + n * NP;
    for (int e = tid; e < dead * bd; e += nthreads) {
      zx[e] = scan::from_f32<T>(0.0f);
      zdt[e] = scan::from_f32<T>(0.0f);
    }
    for (int e = tid; e < dead * NP; e += nthreads) zb[e] = scan::from_f32<T>(0.0f);
    scan::cp_async_commit();
  };

  // the columns past N of both stages' B and C rows: 0 for the whole run
  if (General && N < NP) {
    const int pad = NP - N, per = stage_rows(ck) * pad;
    for (int e = tid; e < 4 * per; e += nthreads) {
      const int region = e / per, rest = e - region * per, row = rest / pad;
      T* rows = reinterpret_cast<T*>(smem + (region >> 1) * stage + 2 * xd_bytes +
                                     (region & 1) * bc_bytes);
      rows[row * NP + N + (rest - row * pad)] = scan::from_f32<T>(0.0f);
    }
  }

  const int trips = (a.S + ck - 1) / ck;
  load_trip(0, 0);
  for (int k = 0; k < trips; ++k) {
    scan::cp_async_wait_all();
    __syncthreads();  // trip k landed for all; trip k - 1's stage is free
    if (k + 1 < trips) load_trip(k + 1, (k + 1) & 1);
    const unsigned char* base = smem + (k & 1) * stage;
    const T* sx = reinterpret_cast<const T*>(base);
    const T* sdt = reinterpret_cast<const T*>(base + xd_bytes);
    const T* sb = reinterpret_cast<const T*>(base + 2 * xd_bytes) + g * K;
    const T* sc = reinterpret_cast<const T*>(base + 2 * xd_bytes + bc_bytes) + g * K;
    T* yk = y + static_cast<size_t>(k) * ck * D;
    const int n = rows_of(k);
    for (int t0 = 0; t0 < n; t0 += U) {
      // the group's decays and inputs first: nothing here waits on h
      float dec[U][K], ub[U][K];
      const T* px = sx + t0 * bd + dl;
      const T* pdt = sdt + t0 * bd + dl;
      const T* pb = sb + t0 * NP;
#pragma unroll
      for (int s = 0; s < U; ++s) {
        const float dtv = scan::to_f32(*pdt);
        const float u = dtv * scan::to_f32(*px);
        float bv[K];
        scan::load_vec<T, K>(pb, bv);
        px += bd;
        pdt += bd;
        pb += NP;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          dec[s][j] = scan::ex2(dtv * a2[j]);
          ub[s][j] = u * bv[j];
        }
      }
      // the recurrence, and each step's partial y over this thread's states
      float p[U];
      const T* pc = sc + t0 * NP;
#pragma unroll
      for (int s = 0; s < U; ++s) {
        float cv[K];
        scan::load_vec<T, K>(pc, cv);
        pc += NP;
        float ps = 0.0f;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          h[j] = fmaf(dec[s][j], h[j], ub[s][j]);
          ps = fmaf(h[j], cv[j], ps);
        }
        p[s] = ps;
      }
      // reduce-scatter over the channel's lanes: each level halves the
      // steps a lane holds, sending the half its partner keeps, so lane g
      // ends with the sums of steps [g m, g m + m) in p[0..m); past
      // N = 32 (spread > 1) with step g / spread's sum over U lanes in p[0]
#pragma unroll
      for (int l = 0; l < kLevels; ++l) {
        if ((tpc >> l) > 1) {
          const int o = tpc >> (l + 1);
          const bool upper = (g & o) != 0;
#pragma unroll
          for (int i = 0; i < (U >> (l + 1)); ++i) {
            const float lo = p[i], hi = p[i + (U >> (l + 1))];
            p[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, o);
          }
        }
      }
      // ... which a butterfly over the spread lanes completes
      if constexpr (General) {
        for (int o = spread / 2; o >= 1; o /= 2) p[0] += __shfl_xor_sync(0xffffffffu, p[0], o);
      }
      const int first = t0 + lane_first;  // this lane's first step
      T* py = yk + static_cast<size_t>(first) * D;
      const T* pxs = sx + first * bd + dl;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        if (stores && i < m && first + i < n) {
          *py = scan::from_f32<T>(fmaf(scan::to_f32(*pxs), skip, p[i]));
          py += D;
          pxs += bd;
        }
      }
    }
  }
  // the state after the last step (steps past S were the identity)
  if (a.h_out != nullptr) {
    float* ho = a.h_out + (static_cast<size_t>(b) * D + d) * N;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int n = g * K + j;
      if (!General || n < N) ho[n] = h[j];
    }
  }
}

template <typename T, int K, bool General>
int launch(SsmArgs a, int B, cudaStream_t stream) {
  const int elt = static_cast<int>(sizeof(T));
  const long long smem = smem_bytes(a.block_d, a.chunk, a.N, elt);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_kernel<T, K, General>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto addr = [](const void* p) { return reinterpret_cast<unsigned long long>(p); };
  a.g_xd = scan::copy_bytes(elt, {1ULL * a.block_d * elt, 1ULL * a.D * elt, addr(a.x),
                                  addr(a.dt)});
  a.g_bc = scan::copy_bytes(elt, {1ULL * a.N * elt, addr(a.Bc), addr(a.Cc)});
  const unsigned grid = static_cast<unsigned>(B * (a.D / a.block_d));
  ssm_kernel<T, K, General><<<grid, a.block_d * a.np / K, static_cast<size_t>(smem),
                             stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_states(const SsmArgs& a, int B, int states, cudaStream_t s) {
  const bool general = a.N != a.np || a.np > 32;
  switch (states) {
    case 1: return general ? launch<T, 1, true>(a, B, s) : launch<T, 1, false>(a, B, s);
    case 2: return general ? launch<T, 2, true>(a, B, s) : launch<T, 2, false>(a, B, s);
    case 4: return general ? launch<T, 4, true>(a, B, s) : launch<T, 4, false>(a, B, s);
    case 8: return general ? launch<T, 8, true>(a, B, s) : launch<T, 8, false>(a, B, s);
    case 16: return general ? launch<T, 16, true>(a, B, s) : launch<T, 16, false>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The dynamic shared memory one CTA of (block_d, chunk) takes at n_state
// and an element size of elt bytes.
extern "C" long long ssm_scan_smem_bytes(int block_d, int chunk, int n_state, int elt) {
  return smem_bytes(block_d, chunk, n_state, elt);
}

// The most threads a CTA may have at `states` states a thread.
extern "C" int ssm_scan_max_threads(int states) { return max_threads(states); }

// x, dt, Bc, Cc, y: elements of elt bytes (4: float32, 2: bf16); A, skip
// float32; h_out (B, D, N) float32 takes the final state, or is null.  Any S >= 1 and chunk >= 1; N from 1 to 256 (NP: N rounded up
// to a power of two), states a power of two up to 16 and NP at most with
// NP / states <= 32 lanes a channel, and block_d * NP / states a multiple
// of 32 up to max_threads(states).  Returns the launch's
// cudaGetLastError() code (cudaErrorInvalidValue for what the kernel does
// not take).
extern "C" int ssm_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bc, const void* Cc,
    const void* skip, void* y, void* h_out, int B, int S, int D, int N, int block_d, int chunk,
    int states, int elt, void* stream) {
  const int np = pad_states(N);
  const bool ok = N >= 1 && N <= 256 && states > 0 && states <= 16 &&
                  (states & (states - 1)) == 0 && states <= np && np / states <= 32;
  if (!ok || B < 1 || S < 1 || block_d < 1 || chunk < 1 || D % block_d ||
      (elt != 4 && elt != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = 1LL * block_d * np / states;
  if (threads > max_threads(states) || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SsmArgs a;
  a.x = x;
  a.dt = dt;
  a.A = static_cast<const float*>(A);
  a.Bc = Bc;
  a.Cc = Cc;
  a.skip = static_cast<const float*>(skip);
  a.y = y;
  a.h_out = static_cast<float*>(h_out);
  a.S = S;
  a.D = D;
  a.N = N;
  a.np = np;
  a.block_d = block_d;
  a.chunk = chunk;
  a.g_xd = a.g_bc = elt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elt == 4 ? launch_states<float>(a, B, states, s)
                  : launch_states<__nv_bfloat16>(a, B, states, s);
}
