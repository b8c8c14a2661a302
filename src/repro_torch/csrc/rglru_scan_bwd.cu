// Backward of the RG-LRU recurrence (csrc/rglru_scan.cu), for Hopper.
//
// Replaces: src/repro/models/rglru.py:82, XLA's derivative of rglru_block's
// lax.scan (its oracle: src/repro/kernels/rglru_scan/ref.py:11 under
// jax.vjp); the JAX package has no kernel for it.
//
// Forward: a_t = exp(-8 r_t softplus(-lam)), s_t = sqrt(max(1 - a_t^2,
// 1e-12)), h_t = a_t h_{t-1} + s_t i_t x_t, y_t = h_t.  Backward, from the
// last step to the first, with g_t = dL/dh_t:
//   g_t  = dy_t + a_{t+1} g_{t+1}                       (a_S g_S = 0)
//   da_t = g_t h_{t-1} - g_t i_t x_t a_t / s_t          (the second term 0
//                                                         where the clamp holds)
//   dx_t = g_t s_t i_t,  di_t = g_t s_t x_t,  dr_t = -8 softplus(-lam) a_t da_t
//   dlam = 8 sigmoid(-lam) sum_{b,t} da_t a_t r_t
// x, r, i, dy and dx, dr, di share one element type, float32 or bf16 (dy
// takes y's, which is x's); lam and dlam are float32, and so are the
// state, the adjoint and all arithmetic.  h is recomputed in float32, never
// read from the forward's output, which a bf16 call rounds.
//
// What bounds it: memory.  x, r, i, dy read and dx, dr, di written are 28
// bytes an element in float32 (14 in bf16); this design reads x, r, i, dy
// twice, 44 bytes (22), 0.069 ms at (1, 2048, 2560) float32 at 3.35 TB/s.
// Timed as the tuner times it, after an L2 flush that leaves ~50 MB of dirty
// lines, the call also pays their write-back: about 0.1 ms at 3 TB/s.
//
// It replaces an earlier design (PR 21), 0.1192 ms there on an H100 SXM: a
// CTA of block_w channels walked the whole sequence twice in order (the
// trips' start states forward, then the trips in reverse), one trip's
// loads in flight behind its compute, so the call took one chain's latency
// (31 trips of ~3.8 us) and moved 40 bytes an element.
//
// Design.  Both recurrences are linear in their carry, so a run of steps
// composes into one map each way:
//   forward  h -> A h + H,   adjoint  G -> A G + Hr   (time reversed)
// with A the product of the run's a_t, shared by both, and G_t = a_t g_t,
// what step t hands to step t - 1 (each step is G_t = a_t G_{t+1} + a_t
// dy_t).  A trip is `chunk` steps of block_w channels with `split` threads a
// channel; thread p of a channel takes the segment of L steps [p L, p L +
// L) (the forward's tiles and shared-memory layout, padding included), and
// Kogge-Stone shuffle scans over the split lanes join the segments.  Every
// (batch row, trip, channel block) is an item, and each item runs in a CTA
// of its own, in four launches:
//   1. maps: the item's x, r, i and dy staged once with cp.async; each
//      segment composes its forward map (keeping a_t) and its adjoint map,
//      an up-scan and a down-scan over the lanes join them, and the trip's
//      A, H (the last lane's) and Hr (the first lane's) go to float32
//      scratch (B, trips, W);
//   2. chain, a thread a (batch row, channel): the trips' maps in order,
//      h_{k+1} = A_k h_k + H_k forward and G_k = A_{k+1} G_{k+1} + Hr_{k+1}
//      back, written in place: the state at each trip's start over H, the
//      carry entering each trip's last step over Hr;
//   3. gradients: the item staged again; from its start state it reruns the
//      forward (keeping a_t and h_{t-1} of its segment in registers), joins
//      the adjoint from its carry with the down-scan, walks its segment
//      backward for dx, dr and di, written over x, r and i in shared memory
//      and stored whole, and writes its channels' dlam partial of the trip
//      to scratch (B, trips, W), summed over its steps and then the
//      channel's lanes;
//   4. reduce: dlam = 8 sigmoid(-lam) times the partials added over the
//      batch rows and trips in order.
// Passes 1 and 3 launch B trips (W / block_w) CTAs (2560 at (32, 64, 8),
// the fastest at (1, 2048, 2560) f32), a single stage each, so an SM holds
// several items' loads in flight; the longest chain is one trip's.
// Launches 2-4 are programmatic dependents of the one before
// (griddepcontrol): their CTAs are scheduled while it drains and wait for
// its writes, and the gradient pass stages its inputs before that wait.
// Passes 2 and 4 move a few KB.  No float atomics and no order that
// depends on timing: two calls give the same bits.
// The same passes as persistent CTAs with two stages (each item's loads in
// flight behind the one before) ran 3-7% slower on an H100 SXM
// (scripts/kernel_ab.py, A B B A): fewer CTAs an SM hold fewer bytes in
// flight.
//
// The gradient pass takes 1 - a_t^2 as (1 - a_t)(1 + a_t) with 1 - a_t =
// -expm1(-8 r_t softplus(-lam)): near a_t = 1 the square root's derivative
// -a / s divides by a small s, and 1 - a_t^2 taken from a_t loses most of
// its digits there.  Steps past the sequence's end read x = r = i = dy = 0:
// a = 1 and b = 0 in the forward, and G passes them unchanged; nothing of
// them is stored.  So any S runs.
#include "scan_staging.cuh"

namespace {

constexpr float kCFactor = 8.0f;
constexpr int kPhaseMaps = 1, kPhaseChain = 2, kPhaseGrads = 4, kPhaseReduce = 8;
// The launch bound: 128 registers a thread, 255 at segments of 32 steps,
// whose a_t and h_{t-1} take 64.
constexpr int max_threads(int L) { return L >= 32 ? 256 : 512; }

struct BwdArgs {
  const void* x;
  const void* r;
  const void* i;
  const float* lam;
  const void* dy;
  void* dx;
  void* dr;
  void* di;
  float* dlam;
  float* ma;    // (B, trips, W): the product of each trip's a_t
  float* mh;    // (B, trips, W): each trip's forward map from h = 0, then its start state
  float* mg;    // (B, trips, W): each trip's adjoint map from G = 0, then the carry
                // entering its last step
  float* part;  // (B, trips, W): dlam's sum over each trip
  int B, S, W, block_w, chunk, split, pad, g;  // g: staging piece size in bytes
};

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// The forward's layout (rglru_scan.cu): elements skipped after each
// segment of L rows, so the lanes of a warp fall on distinct banks.
int seg_pad(int block_w, int L, int split, int elt) {
  if (split == 1) return 0;
  const int words_per_seg = (32 / split) * elt / 4 > 0 ? (32 / split) * elt / 4 : 1;
  const int seg_words = L * block_w * elt / 4;
  const int pad_words = ((words_per_seg - seg_words) % 32 + 32) % 32;
  return pad_words * 4 / elt;
}

long long tile_bytes(int block_w, int L, int split, int elt) {
  const long long seg = 1LL * L * block_w + seg_pad(block_w, L, split, elt);
  return scan::align16(split * seg * elt);
}

// One stage of x, r, i and dy tiles.
long long smem_bytes(int block_w, int L, int split, int elt) {
  return 4 * tile_bytes(block_w, L, split, elt);
}

int seg_len(int chunk, int split) {
  const int need = (chunk + split - 1) / split;
  for (int L = 4; L <= 32; L *= 2) {
    if (need <= L) return L;
  }
  return 0;
}

// Floats of one (B, trips, W) scratch array, a whole number of 16 bytes.
long long trip_floats(int B, int S, int W, int chunk) {
  const long long trips = (S + chunk - 1) / chunk;
  return (1LL * B * trips * W + 3) / 4 * 4;
}

// Programmatic dependent launch: wait for the grids this one depends on
// (their writes visible), and let the next grid's CTAs be scheduled.  Both
// are no-ops in a grid launched without the attribute.
__device__ __forceinline__ void wait_prior_grids() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The maps pass (kGrads false) and the gradient pass (true): a CTA an
// item, (batch row, trip, channel block) = blockIdx.x, the items of one
// trip neighbours, so together they read whole rows.
template <typename T, int L, bool kGrads>
__global__ void __launch_bounds__(max_threads(L)) rglru_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int elt = static_cast<int>(sizeof(T));
  const int bw = a.block_w, split = a.split, ck = a.chunk, W = a.W;
  const int seg = L * bw + a.pad;  // elements of one segment, padding included
  const int tile = static_cast<int>(scan::align16(1LL * split * seg * elt));
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int c = tid / split;
  const int p = tid - c * split;
  const int tiles = W / bw;
  const int trips = (a.S + ck - 1) / ck;
  const int bk = blockIdx.x / tiles;  // the batch row and trip
  const int w0 = (blockIdx.x - bk * tiles) * bw;
  const int b = bk / trips, k = bk - b * trips;
  const size_t stride = static_cast<size_t>(W) * elt;  // bytes between rows
  const size_t g0 = ((static_cast<size_t>(b) * a.S + static_cast<size_t>(k) * ck) * W + w0) * elt;
  const size_t mine = static_cast<size_t>(bk) * W + w0 + c;  // (b, k, w0 + c) of the scratch
  const int n = min(ck, a.S - k * ck);                        // the trip's rows
  const int G = a.g, row_pieces = bw * elt / G;
  const int t_first = tid / row_pieces, u_first = tid - t_first * row_pieces;
  const int t_step = nthreads / row_pieces, u_step = nthreads - t_step * row_pieces;
  auto row_off = [&](int t) { return ((t / L) * seg + (t % L) * bw) * elt; };

  // the trip's x, r, i and dy, staged with cp.async (the inputs are the
  // previous launches', complete before the chain ahead of this pass)
  {
    const char* src[4] = {static_cast<const char*>(a.x), static_cast<const char*>(a.r),
                          static_cast<const char*>(a.i), static_cast<const char*>(a.dy)};
    for (int t = t_first, v = u_first; t < n;) {
      const int u = v * G;
      const int off = row_off(t) + u;
      const size_t gofs = g0 + t * stride + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) scan::copy_piece(smem + q * tile + off, src[q] + gofs, G);
      t += t_step;
      v += u_step;
      if (v >= row_pieces) {
        v -= row_pieces;
        ++t;
      }
    }
    scan::cp_async_commit();
  }
  wait_prior_grids();  // the scratch the gradient pass reads
  launch_next_grid();
  // the gradient pass's start state and carry, loaded while the trip lands
  float start = 0.0f, carry = 0.0f;
  if constexpr (kGrads) {
    if (k > 0) start = a.mh[mine];
    if (k < trips - 1) carry = a.mg[mine];
  }
  const float sp = softplus(-a.lam[w0 + c]);
  const float k2 = -kCFactor * sp * scan::kLog2e;

  const int warp_lanes = min(32, nthreads - (tid & ~31));
  const unsigned full = warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1u;

  scan::cp_async_wait_all();
  __syncthreads();  // the trip landed
  // this thread's segment (x, r, i, dy); its steps past the trip's end set to 0
  T* ptr[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) ptr[q] = reinterpret_cast<T*>(smem + q * tile) + p * seg + c;
  if (n < L * split) {
    for (int j = max(n - p * L, 0); j < L; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) ptr[q][j * bw] = scan::from_f32<T>(0.0f);
    }
  }

  // the segment's a_t (kept) and its forward map (A, H) from h = 0
  float av[L], A = 1.0f, H = 0.0f;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float at = scan::ex2(scan::to_f32(ptr[1][j * bw]) * k2);
    float gain;
    asm("sqrt.approx.f32 %0, %1;" : "=f"(gain) : "f"(fmaxf(fmaf(-at, at, 1.0f), 1e-12f)));
    av[j] = at;
    H = fmaf(at, H, gain * (scan::to_f32(ptr[2][j * bw]) * scan::to_f32(ptr[0][j * bw])));
    A *= at;
  }
  // the segment's adjoint map, from its last step to its first: G -> A G + Hr
  float Hr = 0.0f;
#pragma unroll
  for (int j = L - 1; j >= 0; --j) Hr = av[j] * (Hr + scan::to_f32(ptr[3][j * bw]));

  // inclusive scans over the channel's lanes: up, lane p's forward map then
  // covers segments 0..p; down, its adjoint map segments p..split-1
  float Af = A, Hf = H, Ab = A, Hb = Hr;
  for (int off = 1; off < split; off <<= 1) {
    const float Ap = __shfl_up_sync(full, Af, off, split);
    const float Hp = __shfl_up_sync(full, Hf, off, split);
    const float Ad = __shfl_down_sync(full, Ab, off, split);
    const float Hd = __shfl_down_sync(full, Hb, off, split);
    if (p >= off) {
      Hf = fmaf(Af, Hp, Hf);
      Af *= Ap;
    }
    if (p + off < split) {
      Hb = fmaf(Ab, Hd, Hb);
      Ab *= Ad;
    }
  }

  if constexpr (!kGrads) {
    // the trip's maps: the forward from the last lane, the adjoint from the first
    if (p == split - 1) {
      a.ma[mine] = Af;
      a.mh[mine] = Hf;
    }
    if (p == 0) a.mg[mine] = Hb;
  } else {
    // exclusive: the segments before this one, and after it
    float Ae = __shfl_up_sync(full, Af, 1, split);
    float He = __shfl_up_sync(full, Hf, 1, split);
    float Ad = __shfl_down_sync(full, Ab, 1, split);
    float Hd = __shfl_down_sync(full, Hb, 1, split);
    if (p == 0) {
      Ae = 1.0f;
      He = 0.0f;
    }
    if (p == split - 1) {
      Ad = 1.0f;
      Hd = 0.0f;
    }
    const float kr = -kCFactor * sp;
    // the forward again from the segment's start state: h_{t-1}
    float hp[L];
    float h = fmaf(Ae, start, He);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float at = av[j];
      float gain;
      asm("sqrt.approx.f32 %0, %1;" : "=f"(gain) : "f"(fmaxf(fmaf(-at, at, 1.0f), 1e-12f)));
      hp[j] = h;
      h = fmaf(at, h, gain * (scan::to_f32(ptr[2][j * bw]) * scan::to_f32(ptr[0][j * bw])));
    }
    // the segment backward from the G entering its last step: the gradients
    // over x, r and i
    float Gc = fmaf(Ad, carry, Hd);
    float lam_sum = 0.0f;
#pragma unroll
    for (int j = L - 1; j >= 0; --j) {
      const float at = av[j];
      const float gt = scan::to_f32(ptr[3][j * bw]) + Gc;
      const float xv = scan::to_f32(ptr[0][j * bw]);
      const float rv = scan::to_f32(ptr[1][j * bw]);
      const float iv = scan::to_f32(ptr[2][j * bw]);
      // 1 - a_t^2 as (1 - a_t)(1 + a_t), 1 - a_t = -expm1(log a_t): where
      // a_t is near 1, 1 - a_t^2 from a_t cancels, and d sqrt / da = -a / s
      // multiplies its error
      const float om = -expm1f(rv * kr);
      const float m = om * (2.0f - om);
      const float clamped = fmaxf(m, 1e-12f);
      float gain, inv;
      asm("sqrt.approx.f32 %0, %1;" : "=f"(gain) : "f"(clamped));
      asm("rsqrt.approx.f32 %0, %1;" : "=f"(inv) : "f"(clamped));
      const float gs = gt * gain;
      float da = gt * hp[j];
      if (m > 1e-12f) da = fmaf(-gt * (iv * xv), at * inv, da);
      lam_sum = fmaf(da * at, rv, lam_sum);
      ptr[0][j * bw] = scan::from_f32<T>(gs * iv);
      ptr[1][j * bw] = scan::from_f32<T>(da * at * kr);
      ptr[2][j * bw] = scan::from_f32<T>(gs * xv);
      Gc = at * gt;
    }
    // dlam of the trip: over the channel's lanes, in a fixed order
    for (int off = split / 2; off >= 1; off >>= 1) {
      lam_sum += __shfl_xor_sync(full, lam_sum, off, split);
    }
    if (p == 0) a.part[mine] = lam_sum;
    __syncthreads();  // the gradient tiles are complete
    char* dst[3] = {static_cast<char*>(a.dx), static_cast<char*>(a.dr),
                    static_cast<char*>(a.di)};
    for (int t = t_first, v = u_first; t < n;) {
      const int u = v * G;
      const int off = row_off(t) + u;
      const size_t gofs = g0 + t * stride + u;
#pragma unroll
      for (int q = 0; q < 3; ++q) scan::store_piece(dst[q] + gofs, smem + q * tile + off, G);
      t += t_step;
      v += u_step;
      if (v >= row_pieces) {
        v -= row_pieces;
        ++t;
      }
    }
  }
}

// The trips' maps chained in order, a thread a (b, w), written in place:
// the state at each trip's start over its H, the carry entering each trip's
// last step over its Hr.  kGroup trips' maps are loaded before any is used.
constexpr int kGroup = 32;

__global__ void rglru_bwd_chain(const BwdArgs a) {
  wait_prior_grids();
  launch_next_grid();
  const int trips = (a.S + a.chunk - 1) / a.chunk;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.B * a.W) return;
  const int b = e / a.W;
  const size_t base = static_cast<size_t>(b) * trips * a.W + (e - b * a.W);
  float h = 0.0f;
  for (int k0 = 0; k0 < trips; k0 += kGroup) {
    float A[kGroup], H[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int k = k0 + j;
      A[j] = k < trips ? a.ma[base + static_cast<size_t>(k) * a.W] : 0.0f;
      H[j] = k < trips ? a.mh[base + static_cast<size_t>(k) * a.W] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int k = k0 + j;
      if (k < trips) {
        a.mh[base + static_cast<size_t>(k) * a.W] = h;
        h = fmaf(A[j], h, H[j]);
      }
    }
  }
  float g = 0.0f;
  for (int k0 = trips - 1; k0 >= 0; k0 -= kGroup) {
    float A[kGroup], Hr[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int k = k0 - j;
      A[j] = k >= 0 ? a.ma[base + static_cast<size_t>(k) * a.W] : 0.0f;
      Hr[j] = k >= 0 ? a.mg[base + static_cast<size_t>(k) * a.W] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int k = k0 - j;
      if (k >= 0) {
        a.mg[base + static_cast<size_t>(k) * a.W] = g;
        g = fmaf(A[j], g, Hr[j]);
      }
    }
  }
}

// dlam: the trips' partials added over the batch rows and trips in order,
// kGroup rows loaded at once.
__global__ void rglru_bwd_reduce(const BwdArgs a) {
  wait_prior_grids();
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= a.W) return;
  const int rows = a.B * ((a.S + a.chunk - 1) / a.chunk);
  float v = 0.0f;
  for (int q0 = 0; q0 < rows; q0 += kGroup) {
    float part[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      part[j] = q0 + j < rows ? a.part[static_cast<size_t>(q0 + j) * a.W + w] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (q0 + j < rows) v += part[j];
    }
  }
  a.dlam[w] = kCFactor * v / (1.0f + expf(a.lam[w]));
}

// Launch kernel on `grid` CTAs of `threads`; with `after` set, as a
// programmatic dependent of the stream's previous launch.
template <typename... Args>
int launch_on(void (*kernel)(Args...), unsigned grid, int threads, long long smem, bool after,
              cudaStream_t stream, const BwdArgs& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// A trip pass: a CTA an item.
template <typename T, int L, bool kGrads>
int launch_pass(const BwdArgs& a, long long items, long long smem, bool after,
                cudaStream_t stream) {
  auto kernel = rglru_bwd_kernel<T, L, kGrads>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_on(kernel, static_cast<unsigned>(items), a.block_w * a.split, smem, after,
                   stream, a);
}

template <typename T, int L>
int launch(BwdArgs a, int phases, cudaStream_t stream) {
  const int elt = static_cast<int>(sizeof(T));
  const long long smem = smem_bytes(a.block_w, L, a.split, elt);
  const auto addr = [](const void* p) { return reinterpret_cast<unsigned long long>(p); };
  a.pad = seg_pad(a.block_w, L, a.split, elt);
  a.g = scan::copy_bytes(elt, {1ULL * a.block_w * elt, 1ULL * a.pad * elt, 1ULL * a.W * elt,
                               addr(a.x), addr(a.r), addr(a.i), addr(a.dy), addr(a.dx),
                               addr(a.dr), addr(a.di)});
  const int trips = (a.S + a.chunk - 1) / a.chunk;
  const long long items = 1LL * a.B * trips * (a.W / a.block_w);
  // each launch after the first of the call follows the one before it
  // programmatically: its CTAs start while that one drains
  bool after = false;
  // one trip has no maps to chain: its start state and carry are 0
  if (trips > 1 && (phases & kPhaseMaps)) {
    const int code = launch_pass<T, L, false>(a, items, smem, after, stream);
    if (code != 0) return code;
    after = true;
  }
  if (trips > 1 && (phases & kPhaseChain)) {
    const int code = launch_on(rglru_bwd_chain, static_cast<unsigned>((a.B * a.W + 255) / 256),
                               256, 0, after, stream, a);
    if (code != 0) return code;
    after = true;
  }
  if (phases & kPhaseGrads) {
    const int code = launch_pass<T, L, true>(a, items, smem, after, stream);
    if (code != 0) return code;
    after = true;
  }
  if (phases & kPhaseReduce) {
    return launch_on(rglru_bwd_reduce, static_cast<unsigned>((a.W + 255) / 256), 256, 0, after,
                     stream, a);
  }
  return 0;
}

template <typename T>
int launch_len(const BwdArgs& a, int L, int phases, cudaStream_t s) {
  switch (L) {
    case 4: return launch<T, 4>(a, phases, s);
    case 8: return launch<T, 8>(a, phases, s);
    case 16: return launch<T, 16>(a, phases, s);
    case 32: return launch<T, 32>(a, phases, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The dynamic shared memory one CTA of (block_w, chunk, split) takes at an
// element size of elt bytes (-1 for a chunk / split the kernel does not take).
extern "C" long long rglru_scan_bwd_smem_bytes(int block_w, int chunk, int split, int elt) {
  const int L = split < 1 || chunk < 1 ? 0 : seg_len(chunk, split);
  return L ? smem_bytes(block_w, L, split, elt) : -1;
}

// Bytes of the float32 scratch one call takes: the trips' A, H (then start
// states), Hr (then carries) and dlam partials, four (B, trips, W) arrays.
extern "C" long long rglru_scan_bwd_scratch_bytes(int B, int S, int W, int chunk) {
  return 4 * 4 * trip_floats(B, S, W, chunk);
}

// The most threads a CTA of (chunk, split) may have (0 for a chunk / split
// the kernel does not take).
extern "C" int rglru_scan_bwd_max_threads(int chunk, int split) {
  const int L = split < 1 || chunk < 1 ? 0 : seg_len(chunk, split);
  return L ? max_threads(L) : 0;
}

// x, r, i, dy, dx, dr, di: (B, S, W) elements of elt bytes (4: float32, 2:
// bf16); lam, dlam: (W,) float32; scratch of rglru_scan_bwd_scratch_bytes.
// The forward's tiles: any S >= 1 and chunk >= 1, split a power of two up to
// 32 with ceil(chunk / split) <= 32, block_w dividing W, block_w * split at
// most rglru_scan_bwd_max_threads.  phases: 15 for the call (maps 1, chain
// 2, gradients 4, reduce 8, launched alone for timing on the same scratch).
// Returns the launches' cudaGetLastError() code (cudaErrorInvalidValue for
// tiles the kernel does not take).
extern "C" int rglru_scan_bwd_launch_phases(
    const void* x, const void* r, const void* i, const void* lam, const void* dy, void* dx,
    void* dr, void* di, void* dlam, void* scratch, int B, int S, int W, int block_w, int chunk,
    int split, int elt, int phases, void* stream) {
  const long long threads = 1LL * block_w * split;
  if (B < 1 || S < 1 || block_w < 1 || split < 1 || split > 32 || (split & (split - 1)) ||
      chunk < 1 || seg_len(chunk, split) == 0 || W % block_w ||
      threads > max_threads(seg_len(chunk, split)) ||
      (elt != 4 && elt != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = trip_floats(B, S, W, chunk);
  BwdArgs a;
  a.x = x;
  a.r = r;
  a.i = i;
  a.lam = static_cast<const float*>(lam);
  a.dy = dy;
  a.dx = dx;
  a.dr = dr;
  a.di = di;
  a.dlam = static_cast<float*>(dlam);
  a.ma = static_cast<float*>(scratch);
  a.mh = a.ma + n;
  a.mg = a.mh + n;
  a.part = a.mg + n;
  a.B = B;
  a.S = S;
  a.W = W;
  a.block_w = block_w;
  a.chunk = chunk;
  a.split = split;
  a.pad = 0;
  a.g = elt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = seg_len(chunk, split);
  return elt == 4 ? launch_len<float>(a, L, phases, s)
                  : launch_len<__nv_bfloat16>(a, L, phases, s);
}

// The whole call: rglru_scan_bwd_launch_phases with every phase.
extern "C" int rglru_scan_bwd_launch(
    const void* x, const void* r, const void* i, const void* lam, const void* dy, void* dx,
    void* dr, void* di, void* dlam, void* scratch, int B, int S, int W, int block_w, int chunk,
    int split, int elt, void* stream) {
  return rglru_scan_bwd_launch_phases(x, r, i, lam, dy, dx, dr, di, dlam, scratch, B, S, W,
                                      block_w, chunk, split, elt,
                                      kPhaseMaps | kPhaseChain | kPhaseGrads | kPhaseReduce,
                                      stream);
}
