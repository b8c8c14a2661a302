// Backward of the Mamba-1 selective scan (csrc/ssm_scan.cu), for Hopper.
//
// Replaces: src/repro/models/ssm.py:95, XLA's derivative of ssm_block's
// lax.scan (its oracle: src/repro/kernels/ssm_scan/ref.py:18 under
// jax.vjp); the JAX package has no kernel for it.
//
// Forward, per batch row, channel d and state n:
//   h_t = e_t h_{t-1} + u_t B_t,   e_t = exp(dt_t A),  u_t = dt_t x_t
//   y_t = sum_n h_t C_t + skip x_t
// Backward, with R_t = e_t g_t the adjoint step t hands to step t - 1
// (R_S = dh, the final state's gradient, or 0):
//   g_t   = dy_t C_t + R_{t+1}
//   dA   += g_t e_t h_{t-1} dt_t                      summed over b, t
//   ddt_t = sum_n g_t (A e_t h_{t-1}) + x_t sum_n g_t B_t
//   dx_t  = dt_t sum_n g_t B_t + skip dy_t
//   dB_t  = sum_d g_t u_t,   dC_t = sum_d h_t dy_t     summed over the channels
//   dskip = sum_{b,t} dy x
// x, dt, dy, Bc, Cc and their gradients share one element type, float32 or
// bf16 (dy takes y's, which is x's); A, skip, dh, dA and dskip are float32,
// and so is all arithmetic.
//
// What bounds it, at falcon-mamba-7b's train cell (B, S, D, N) = (2, 2048,
// 8192, 16) float32 on an H100 SXM: bytes, 0.2013 ms (x, dt, dy read and
// dx, ddt written: 20 bytes per (t, d)); a pass of exps, one per
// (t, d, n), takes the SFU 0.1282 ms; the float32 work, about 15 FMA-pipe
// operations per (t, d, n) where the forward takes 4, about 0.25 ms.
//
// It replaces an earlier design, which ran 2.3996 ms there (12x its bound):
//   1. each thread carried K = 4 states of one channel through the whole
//      sequence four times (a chunk-start sweep, a sweep to the group
//      starts, each group forward again, then backward): chains of 4 S
//      dependent steps, 2 warps an SM sub-partition to hide them (122,880
//      bytes of shared memory a CTA, 8 warps an SM);
//   2. every exp was taken three times (1.61 G ex2 at B = 2, 0.385 ms of
//      SFU);
//   3. a warp-step cost 11 dependent shuffles for 4 states: a butterfly of
//      dx's and ddt's sums over the channel's 4 lanes, a reduce-scatter of
//      dB_t/dC_t over the warp's 8 channels (2.75 shuffles per (t, d, n),
//      and a shared-memory store per 4);
//   4. its scratch moved about 270 MB: the chunk-start states of every 32
//      steps and the dB/dC partials of every 64 channels.
//
// Design.  Both recurrences are linear in their carry, so L steps of one
// channel and state compose into one map each way:
//   forward  h -> P h + hl,  backward  R -> P R + rl,  P = 2^(a2 sum dt)
// (hl, rl: the steps run from a zero carry; a2 = A log2 e).  A thread owns
// a segment of `seg` (L) steps of `channels` (C) channels and loops over
// all N states; a warp's lanes are LT = chunk / L time lanes (a trip of
// `chunk` steps, one segment each) by 32 / LT channel lanes, and the
// segments' maps are joined by Kogge-Stone scans over the time lanes
// (shuffles, log2 LT levels each way), with no barrier: each warp runs on
// its own.  Three kernels and the reduce:
//   sweep 1 composes every trip but the last apart: CTAs of 128 threads
//     (16-step segments where D allows), each composing a few trips of its
//     channels with the next trip's loads in flight, write each trip's
//     forward map from a zero state (its Q, one exp per step) and sum of dt
//     to scratch; a chaining kernel then turns the maps into the state at
//     each trip's start, h_{k+1} = 2^(a2 sum dt_k) h_k + Q_k, in place
//     (hc: B, trips - 1, N, D);
//   sweep 2 gives a CTA block_d channels of one batch row and walks their
//     trips in reverse.  The next trip's x, dt, dy rows (swizzled so a
//     warp's time lanes read distinct banks), B_t, C_t rows and start state
//     come in with cp.async while the current trip runs.  For each state a
//     thread takes its steps' decays once and keeps them in registers (L C
//     each), composes both maps, joins them (the forward one from the
//     trip's start state, the backward one from the next trip's carry,
//     which the first time lane hands on through shared memory), and walks
//     its segment forward (e h_{t-1} kept; h_t dy_t) and backward (g_t; dA;
//     ghe a2 and g B_t summed over the states in registers for ddt and dx;
//     g_t u_t).
// So every decay is taken twice (sweep 1 and sweep 2) and each segment's
// product once more a sweep (1 / L per step), against three times before.
// Each warp holds (t, d) pairs of its own, so none waits on another: the
// old design's chains of 4 S steps become chains of L steps, and the grid
// is B D / block_d CTAs of 32 / LT channel lanes a warp.
//
// The sums.  Over the states (dx, ddt): in registers, no shuffle.  Over the
// channels (dB_t, dC_t): a thread's C channels in registers; then, a state
// at a time, each lane's 2 L terms go to its warp's transpose buffer and
// each lane adds the channel lanes of 2 L / (32 / LT) (term, time lane)
// pairs, float4 rows in a tree, into the warp's sums of the trip; at the
// trip's end the CTA adds its warps in order and writes its partial sums
// (B, D / block_d, S, N).  Per (t, d, n): the scans and dA's butterfly
// over the time lanes, (5 log2 LT + 4) / L shuffles (1.75 at the train
// cell's tuned (8 steps, 2 channels, 4 time lanes)), none in a step's
// chain; the transpose, 2 / C shared-memory stores and 0.5 / C 16-byte
// loads.  The earlier design took 2.75 shuffles in each step's chain.
// dA: each segment's partial per (channel, state), over the time lanes by
// a butterfly, onto the CTA's sum in shared memory; dskip's terms a
// thread's own in shared memory, over the time lanes in order at the end.
// No float atomics: a reduce kernel, the same launch's last, adds the
// partials over the CTAs in order, dA's (B, D, N) and dskip's (B, D) over
// the batch rows, so two calls give the same bits.
//
// Scratch at the train cell (2, 2048, 8192, 16) at the tuned (block_d 64,
// chunk 32): hc 66.1 MB, the dB/dC partials 67.1 MB (the trips' sums of
// dt, 4.1 MB, in the dB partials' room: sweep 1 reads them before sweep 2
// writes those), dA and dskip 1.1 MB: 134.3 MB (100.7 MB at block_d 128),
// against the earlier design's 135.3 MB.
//
// Steps past the sequence's end (a short last trip, a chunk past S) read
// dt = x = dy = 0 and B = C = 0: decay 1, input 0 and no adjoint input, so
// both maps pass them unchanged, and nothing of them is stored.  So any S
// and any chunk (a multiple of seg) run.
#include "scan_staging.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarp = 32;

struct BwdArgs {
  const void* x;
  const void* dt;
  const float* A;
  const void* Bc;
  const void* Cc;
  const float* skip;
  const void* dy;
  const float* dh;  // (B, D, N), or null
  void* dx;
  void* ddt;
  float* dA;
  void* dB;
  void* dC;
  float* dskip;
  float* hc;      // (B, trips - 1, N, D): trip k's map from a zero state,
                  // then the state at the start of trip k + 1
  float* tdt;     // (B, trips - 1, D): the sum of dt over trip k (part_b's room)
  float* part_b;  // (B, D / block_d, S, N): a CTA's dB_t over its channels
  float* part_c;  // likewise dC_t
  float* part_a;  // (B, D, N): dA of one batch row
  float* part_s;  // (B, D): dskip of one batch row
  int B, S, D, N, block_d, chunk;
  int phases;  // kPhaseSweep1 | kPhaseSweep2 | kPhaseReduce: which run (all but for timing)
  int g_xd, g_bc;  // cp.async piece sizes in bytes of x, dt, dy rows and of B_t, C_t rows
  int maps_trips;  // sweep 1: trips a CTA composes
};

constexpr int kPhaseSweep1 = 1, kPhaseSweep2 = 2, kPhaseReduce = 4;

// The launch bound: 128 registers a thread where it holds 4 (step,
// channel) pairs, 168 at 8 and 255 at 16 (7 floats a pair: dt, u, dy, the
// decay, e h_{t-1} and the two sums over the states).
__host__ __device__ constexpr int max_threads(int L, int C) {
  return L * C >= 16 ? 256 : L * C >= 8 ? 384 : 512;
}

// n floats rounded up to whole 16 bytes
__host__ __device__ constexpr long long floats16(long long n) { return (n + 3) / 4 * 4; }

// Shared memory in floats, each region a whole number of 16 bytes:
//   B_t and C_t of a trip, float32, transposed (N rows of chunk + 4 steps);
//   A log2 e, the trip's start state, the adjoint handed on between trips
//   and the CTA's dA sums, (N, block_d) each;
//   the warps' dB_t/dC_t sums of a trip (warps, 2, N, chunk + 1);
//   each warp's transpose of a state's dB_t/dC_t terms (warps, 2 L, 32);
//   the next trip, fetched with cp.async while this one runs: x, dt and dy
//   rows of block_d elements (chunk rows each), B_t and C_t rows of N (up
//   to kBcAhead states), the start state (N, block_d) float32;
//   each thread's x of the trip (L C, a thread), for ddt at the trip's end,
//   and its dskip terms (C, a thread).
struct Smem {
  long long bc, state, red, tbuf, xd, bcrows, h, xs;
};

// B_t and C_t rows are fetched ahead only up to kBcAhead states (past it
// they would not fit beside the rest): staged when the trip starts.
constexpr int kBcAhead = 64;

__host__ __device__ Smem smem_floats(int block_d, int chunk, int n_state, int L, int C, int elt) {
  const long long lanes_c = kWarp / (chunk / L);
  const long long warps = block_d / (lanes_c * C);
  const long long bc_rows = n_state <= kBcAhead ? (1LL * chunk * n_state * elt + 3) / 4 : 0;
  return {floats16(1LL * n_state * (chunk + 4)), floats16(1LL * n_state * block_d),
          floats16(warps * 2 * n_state * (chunk + 1)), warps * 2 * L * kWarp,
          floats16(1LL * chunk * block_d * elt / 4), floats16(bc_rows),
          1LL * n_state * block_d, warps * kWarp * (L + 1) * C};
}

long long smem_bytes(int block_d, int chunk, int n_state, int L, int C, int elt) {
  const Smem s = smem_floats(block_d, chunk, n_state, L, C, elt);
  return 4 * (2 * s.bc + 4 * s.state + s.red + s.tbuf + 3 * s.xd + 2 * s.bcrows + s.h + s.xs);
}

// Floats of each scratch region, in order, each a multiple of 4 (16 bytes).
// Each trip's sum of dt lives where the dB partials will: sweep 1 reads it
// before sweep 2 writes them.
struct Scratch {
  long long hc, tdt, part, part_a, part_s;
  long long first() const { return tdt > part ? tdt : part; }  // tdt, then the dB partials
};

Scratch scratch_floats(int B, int S, int D, int N, int block_d, int chunk) {
  const long long trips = (S + chunk - 1) / chunk;
  return {floats16(1LL * B * (trips - 1) * N * D), floats16(1LL * B * (trips - 1) * D),
          floats16(1LL * B * (D / block_d) * S * N), floats16(1LL * B * D * N),
          floats16(1LL * B * D)};
}

long long scratch_bytes(int B, int S, int D, int N, int block_d, int chunk) {
  const Scratch s = scratch_floats(B, S, D, N, block_d, chunk);
  return 4 * (s.hc + s.first() + s.part + s.part_a + s.part_s);
}

// The elements e = tid, tid + threads, ... of a grid `cols` wide as (row,
// col), stepped without a division each.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// (`threads` passes an empty asm, so the compiler does not hoist the
// divisions out of the trip loop and keep them in registers across it)
__device__ __forceinline__ Walk walk(int tid, int threads, int cols) {
  asm volatile("" : "+r"(threads));
  return {tid / cols, tid % cols, threads / cols, threads % cols, cols};
}

// Wait for all but the most recent cp.async group.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// LT time lanes (a trip of LT L steps), 32 / LT channel lanes.  kMaps:
// sweep 1's maps (a CTA a few trips of a tile); else sweep 2 (a CTA a
// tile, its trips in reverse).
template <typename T, int L, int C, int LT, bool kMaps>
__global__ void __launch_bounds__(kMaps ? 512 : max_threads(L, C), 1)
    ssm_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int lanes_t = LT, lanes_c = kWarp / LT, ck = LT * L;
  static_assert(lanes_c % 4 == 0 && 2 * L % lanes_c == 0, "float4 rows of channel lanes");
  const int N = a.N, D = a.D, S = a.S, bd = a.block_d;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int lane = tid & (kWarp - 1), warp = tid >> 5, warps = threads >> 5;
  const int tl = lane / lanes_c, cl = lane - tl * lanes_c;
  const int c0 = (warp * lanes_c + cl) * C;  // this thread's first channel in the CTA
  const int tiles = D / bd;
  const int trips = (S + ck - 1) / ck;
  const int per = kMaps ? (trips - 1 + a.maps_trips - 1) / a.maps_trips : 1;  // CTAs of a tile
  const int cta = blockIdx.x / per;
  const int b = cta / tiles, tile = cta - b * tiles;
  const int d0 = tile * bd + c0;
  const int brow = ck + 4, rrow = ck + 1;

  constexpr int elt = static_cast<int>(sizeof(T));
  const Smem sz = smem_floats(bd, ck, N, L, C, elt);
  float* Bs = reinterpret_cast<float*>(smem);
  float* Cs = Bs + sz.bc;
  float* As = kMaps ? Bs + sz.bc : Cs + sz.bc;  // (N, block_d): A log2 e
  float* Hs = As + sz.state;  // (N, block_d): the trip's start state
  float* Rs = Hs + sz.state;  // (N, block_d): the adjoint handed on between trips
  float* dAs = Rs + sz.state;  // (N, block_d): the CTA's dA sums
  float* red = dAs + sz.state;  // (warps, 2, N, chunk + 1): the warps' dB_t/dC_t sums
  float* tbuf = red + sz.red;   // (warps, 2 L, 32): each warp's dB/dC transpose

  const T* X = static_cast<const T*>(a.x) + static_cast<size_t>(b) * S * D;
  const T* DT = static_cast<const T*>(a.dt) + static_cast<size_t>(b) * S * D;
  const T* DY = static_cast<const T*>(a.dy) + static_cast<size_t>(b) * S * D;
  const T* BG = static_cast<const T*>(a.Bc) + static_cast<size_t>(b) * S * N;
  const T* CG = static_cast<const T*>(a.Cc) + static_cast<size_t>(b) * S * N;
  float* hc = a.hc + static_cast<size_t>(b) * (trips - 1) * N * D + tile * bd;

  // sweep 1: this thread's steps of trip k, dt and x as loaded (steps past
  // S read 0), converted only where used, so the loads of the next trip
  // stay in flight while this one runs
  auto load_steps = [&](int k, T (&dt)[L][C], T (&x)[L][C]) {
#pragma unroll
    for (int t = 0; t < L; ++t) {
      const int r = k * ck + tl * L + t;
      const bool in = r < S;
      const size_t off = static_cast<size_t>(in ? r : 0) * D + d0;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        dt[t][j] = in ? DT[off + j] : scan::from_f32<T>(0.0f);
        x[t][j] = in ? X[off + j] : scan::from_f32<T>(0.0f);
      }
    }
  };

  // sweep 2's prefetch of a trip: x, dt, dy rows (their G-byte pieces
  // swizzled by the time lane where a row is whole eights of 16 bytes, so
  // a warp's time lanes read distinct banks), B_t and C_t rows, and the
  // start state, with cp.async; only the rows before S
  unsigned char* pf = reinterpret_cast<unsigned char*>(tbuf + sz.tbuf);
  const int xd_bytes = 4 * static_cast<int>(sz.xd), row_bytes = bd * elt;
  unsigned char* pfB = pf + 3 * xd_bytes;
  unsigned char* pfC = pfB + 4 * sz.bcrows;
  float* pfH = reinterpret_cast<float*>(pfC + 4 * sz.bcrows);
  float* xs = pfH + sz.h;  // (L, C, threads)
  const int G = a.g_xd, pieces = row_bytes / G;
  const int swz = G == 16 && pieces % 8 == 0 ? 7 : 0;
  auto prefetch = [&](int k) {
    const int rows = min(ck, S - k * ck);
    const size_t src0 = (static_cast<size_t>(k) * ck * D + tile * bd) * elt;
    const char* src[3] = {reinterpret_cast<const char*>(X) + src0,
                          reinterpret_cast<const char*>(DT) + src0,
                          reinterpret_cast<const char*>(DY) + src0};
    for (Walk w = walk(tid, threads, pieces); w.r < rows; w.next()) {
      const int dst = w.r * row_bytes + (w.c ^ ((w.r / L) & swz)) * G;
      const size_t off = static_cast<size_t>(w.r) * D * elt + w.c * G;
#pragma unroll
      for (int q = 0; q < 3; ++q) scan::copy_piece(pf + q * xd_bytes + dst, src[q] + off, G);
    }
    const int G2 = a.g_bc;
    const size_t bc0 = static_cast<size_t>(k) * ck * N * elt;
    for (int e = tid; e < (N <= kBcAhead ? rows * N * elt / G2 : 0); e += threads) {
      scan::copy_piece(pfB + e * G2, reinterpret_cast<const char*>(BG) + bc0 + e * G2, G2);
      scan::copy_piece(pfC + e * G2, reinterpret_cast<const char*>(CG) + bc0 + e * G2, G2);
    }
    if (k > 0) {  // the start state's rows, in 16-byte pieces
      for (Walk w = walk(tid, threads, bd / 4); w.r < N; w.next()) {
        const float* row = hc + (static_cast<size_t>(k - 1) * N + w.r) * D;
        scan::copy_piece(pfH + w.r * bd + 4 * w.c, row + 4 * w.c, 16);
      }
    }
    scan::cp_async_commit();
  };

  // a state's row of the segment's L steps from a staged array
  auto segment = [&](const float* rows, int n, float (&out)[L]) {
    const float4* p = reinterpret_cast<const float4*>(rows + n * brow + tl * L);
#pragma unroll
    for (int i = 0; i < L / 4; ++i) {
      const float4 f = p[i];
      out[4 * i] = f.x;
      out[4 * i + 1] = f.y;
      out[4 * i + 2] = f.z;
      out[4 * i + 3] = f.w;
    }
  };

  // the segments' maps x -> P x + Q joined over the time lanes of a
  // channel (Kogge-Stone): each lane's composition of the lanes up to it
  // (scan_up) or, time reversed, from it on (scan_down); `before` and
  // `after` shift a scan by one lane, the identity at the end
  auto scan_up = [&](float P, float Q) {
#pragma unroll
    for (int o = 1; o < lanes_t; o <<= 1) {
      const float Pp = __shfl_up_sync(0xffffffffu, P, o * lanes_c);
      const float Qp = __shfl_up_sync(0xffffffffu, Q, o * lanes_c);
      if (tl >= o) {
        Q = fmaf(P, Qp, Q);
        P *= Pp;
      }
    }
    return make_float2(P, Q);
  };
  auto scan_down = [&](float P, float Q) {
#pragma unroll
    for (int o = 1; o < lanes_t; o <<= 1) {
      const float Pn = __shfl_down_sync(0xffffffffu, P, o * lanes_c);
      const float Qn = __shfl_down_sync(0xffffffffu, Q, o * lanes_c);
      if (tl + o < lanes_t) {
        Q = fmaf(P, Qn, Q);
        P *= Pn;
      }
    }
    return make_float2(P, Q);
  };
  auto before = [&](float2 m) {
    const float P = __shfl_up_sync(0xffffffffu, m.x, lanes_c);
    const float Q = __shfl_up_sync(0xffffffffu, m.y, lanes_c);
    return tl == 0 ? make_float2(1.0f, 0.0f) : make_float2(P, Q);
  };
  auto after = [&](float2 m) {
    const float P = __shfl_down_sync(0xffffffffu, m.x, lanes_c);
    const float Q = __shfl_down_sync(0xffffffffu, m.y, lanes_c);
    return tl == lanes_t - 1 ? make_float2(1.0f, 0.0f) : make_float2(P, Q);
  };

  for (int e = tid; e < N * bd; e += threads) {
    const int n = e / bd, c = e - n * bd;
    As[e] = a.A[static_cast<size_t>(tile * bd + c) * N + n] * scan::kLog2e;
  }

  // -- sweep 1: trip k's map from a zero state, joined over its segments --
  if constexpr (kMaps) {
    // a CTA composes trips k0 .. k1 - 1 of its tile, each trip's loads
    // issued while the one before runs: dt and x into registers, B_t rows
    // (up to kBcAhead states) into one of two buffers with cp.async
    const int k0 = (blockIdx.x - cta * per) * a.maps_trips;
    const int k1 = min(k0 + a.maps_trips, trips - 1);
    const bool ahead = N <= kBcAhead;
    unsigned char* Bb = reinterpret_cast<unsigned char*>(As + sz.state);
    auto fetch_b = [&](int k, int buf) {
      const int rows = min(ck, S - k * ck), G2 = a.g_bc;
      const char* src = reinterpret_cast<const char*>(BG) + static_cast<size_t>(k) * ck * N * elt;
      unsigned char* dst = Bb + buf * 4 * sz.bcrows;
      for (int e = tid; e < rows * N * elt / G2; e += threads) {
        scan::copy_piece(dst + e * G2, src + e * G2, G2);
      }
      scan::cp_async_commit();
    };
    T dtr[L][C], xr[L][C];
    load_steps(k0, dtr, xr);
    if (ahead) fetch_b(k0, 0);
    for (int k = k0; k < k1; ++k) {
      float dt[L][C], u[L][C], sdt[C];
#pragma unroll
      for (int t = 0; t < L; ++t) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          dt[t][j] = scan::to_f32(dtr[t][j]);
          u[t][j] = dt[t][j] * scan::to_f32(xr[t][j]);
        }
      }
      const bool more = k + 1 < k1;
      if (more) {
        load_steps(k + 1, dtr, xr);
        if (ahead) fetch_b(k + 1, (k - k0 + 1) & 1);
      }
      if (ahead) more ? cp_async_wait_one() : scan::cp_async_wait_all();
      __syncthreads();  // trip k's B_t rows landed (and A staged); trip k - 1's read
      {
        const int rows = min(ck, S - k * ck);
        const T* src = ahead ? reinterpret_cast<const T*>(Bb + ((k - k0) & 1) * 4 * sz.bcrows)
                             : BG + static_cast<size_t>(k) * ck * N;
        for (Walk w = walk(tid, threads, N); w.r < ck; w.next()) {
          Bs[w.c * brow + w.r] = w.r < rows ? scan::to_f32(src[w.r * N + w.c]) : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        sdt[j] = 0.0f;
#pragma unroll
        for (int t = 0; t < L; ++t) sdt[j] += dt[t][j];
        float all = sdt[j];  // the trip's sum of dt, over the time lanes
#pragma unroll
        for (int o = 1; o < lanes_t; o <<= 1) all += __shfl_xor_sync(0xffffffffu, all, o * lanes_c);
        if (tl == 0) a.tdt[(static_cast<size_t>(b) * (trips - 1) + k) * D + d0 + j] = all;
      }
      __syncthreads();  // B_t transposed
      float* hk = hc + static_cast<size_t>(k) * N * D + c0;
      for (int n = 0; n < N; ++n) {
        float bv[L];
        segment(Bs, n, bv);
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float a2 = As[n * bd + c0 + j];
          float hl = 0.0f;
#pragma unroll
          for (int t = 0; t < L; ++t) hl = fmaf(scan::ex2(dt[t][j] * a2), hl, u[t][j] * bv[t]);
          const float2 all = scan_up(scan::ex2(a2 * sdt[j]), hl);
          if (tl == lanes_t - 1) hk[static_cast<size_t>(n) * D + j] = all.y;
        }
      }
    }
  } else {
    // -- sweep 2: the trips in reverse ------------------------------------
    for (int e = tid; e < N * bd; e += threads) {
      const int n = e / bd, c = e - n * bd;
      const size_t at = (static_cast<size_t>(b) * D + tile * bd + c) * N + n;
      Rs[e] = a.dh != nullptr ? a.dh[at] : 0.0f;
      dAs[e] = 0.0f;
    }
    float* dss = xs + L * C * threads;  // (C, threads): each thread's dskip terms
#pragma unroll
    for (int j = 0; j < C; ++j) dss[j * threads + tid] = 0.0f;
    float* red_w = red + warp * 2 * N * rrow;  // this warp's sums
    float* tw = tbuf + warp * 2 * L * kWarp;    // this warp's transpose buffer
    T* DX = static_cast<T*>(a.dx) + static_cast<size_t>(b) * S * D;
    T* DDT = static_cast<T*>(a.ddt) + static_cast<size_t>(b) * S * D;

    prefetch(trips - 1);
    for (int k = trips - 1; k >= 0; --k) {
      scan::cp_async_wait_all();
      __syncthreads();  // trip k's rows landed; the previous trip's sums read
      // this thread's steps (past S: 0), the trip's B_t, C_t transposed, its
      // start state
      // (this thread's element (t, j) of a prefetched array: row tl L + t,
      // channel c0 + j, its piece swizzled by the time lane)
      float dt[L][C], u[L][C], dy[L][C];
      int col[C], first = c0;
      asm volatile("" : "+r"(first));  // computed here, not kept across the trips
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int byte = (first + j) * elt, piece = byte / G;
        col[j] = (piece ^ (tl & swz)) * G + byte - piece * G;
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float dsk = dss[j * threads + tid];
#pragma unroll
        for (int t = 0; t < L; ++t) {
          const int r = tl * L + t;
          const bool in = k * ck + r < S;
          const int at = r * row_bytes + col[j];
          const float xv = in ? scan::to_f32(*reinterpret_cast<const T*>(pf + at)) : 0.0f;
          dt[t][j] = in ? scan::to_f32(*reinterpret_cast<const T*>(pf + xd_bytes + at)) : 0.0f;
          dy[t][j] = in ? scan::to_f32(*reinterpret_cast<const T*>(pf + 2 * xd_bytes + at)) : 0.0f;
          u[t][j] = dt[t][j] * xv;
          dsk = fmaf(dy[t][j], xv, dsk);
          xs[(t * C + j) * threads + tid] = xv;
        }
        dss[j * threads + tid] = dsk;
      }
      {
        const int rows = min(ck, S - k * ck);
        const bool ahead = N <= kBcAhead;
        const size_t at = static_cast<size_t>(k) * ck * N;
        const T* pb = ahead ? reinterpret_cast<const T*>(pfB) : BG + at;
        const T* pc = ahead ? reinterpret_cast<const T*>(pfC) : CG + at;
        for (Walk w = walk(tid, threads, N); w.r < ck; w.next()) {
          const int e = w.r * N + w.c;
          const bool in = w.r < rows;
          Bs[w.c * brow + w.r] = in ? scan::to_f32(pb[e]) : 0.0f;
          Cs[w.c * brow + w.r] = in ? scan::to_f32(pc[e]) : 0.0f;
        }
        for (int e = tid; e < N * bd; e += threads) Hs[e] = k == 0 ? 0.0f : pfH[e];
      }
      __syncthreads();  // the prefetch consumed: fetch the next trip
      if (k > 0) prefetch(k - 1);
      float sa[L][C], sb[L][C], sdt[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        sdt[j] = 0.0f;
#pragma unroll
        for (int t = 0; t < L; ++t) {
          sdt[j] += dt[t][j];
          sa[t][j] = 0.0f;
          sb[t][j] = 0.0f;
        }
      }
      for (int n = 0; n < N; ++n) {
        float bv[L], cv[L], a2[C];
        segment(Bs, n, bv);
        segment(Cs, n, cv);
        const int at = n * bd + c0;
        // the decays, taken once, the segment's two maps and their joins
        float e[L][C], h[C], R[C], Rout[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          a2[j] = As[at + j];
          float hl = 0.0f, rl = 0.0f;
#pragma unroll
          for (int t = 0; t < L; ++t) {
            e[t][j] = scan::ex2(dt[t][j] * a2[j]);
            hl = fmaf(e[t][j], hl, u[t][j] * bv[t]);
          }
#pragma unroll
          for (int t = L - 1; t >= 0; --t) rl = e[t][j] * fmaf(dy[t][j], cv[t], rl);
          const float P = scan::ex2(a2[j] * sdt[j]);
          const float2 up = before(scan_up(P, hl));
          h[j] = fmaf(up.x, Hs[at + j], up.y);
          const float2 all = scan_down(P, rl), down = after(all);
          const float carry = Rs[at + j];
          R[j] = fmaf(down.x, carry, down.y);
          Rout[j] = fmaf(all.x, carry, all.y);
        }
        __syncwarp();  // the warp's lanes have read the carry
        if (tl == 0) {
#pragma unroll
          for (int j = 0; j < C; ++j) Rs[at + j] = Rout[j];
        }
        // the segment forward: e h_{t-1}, and dC_t's terms over the channels
        // (the dB/dC terms go straight to the warp's transpose buffer)
        float eh[L][C];
        __syncwarp();  // the buffer's previous state read
#pragma unroll
        for (int t = 0; t < L; ++t) {
          float hy = 0.0f;
#pragma unroll
          for (int j = 0; j < C; ++j) {
            eh[t][j] = e[t][j] * h[j];
            h[j] = fmaf(u[t][j], bv[t], eh[t][j]);
            hy = j == 0 ? h[j] * dy[t][j] : fmaf(h[j], dy[t][j], hy);
          }
          tw[(L + t) * kWarp + lane] = hy;
        }
        // ... and backward with the adjoint
        float dA[C];
#pragma unroll
        for (int j = 0; j < C; ++j) dA[j] = 0.0f;
#pragma unroll
        for (int t = L - 1; t >= 0; --t) {
          float gu = 0.0f;
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const float g = fmaf(dy[t][j], cv[t], R[j]);
            const float ghe = g * eh[t][j];
            sa[t][j] = fmaf(ghe, a2[j], sa[t][j]);
            dA[j] = fmaf(ghe, dt[t][j], dA[j]);
            sb[t][j] = fmaf(g, bv[t], sb[t][j]);
            gu = j == 0 ? g * u[t][j] : fmaf(g, u[t][j], gu);
            R[j] = e[t][j] * g;
          }
          tw[t * kWarp + lane] = gu;
        }
        // dA over the time lanes (a butterfly), onto the CTA's sum
#pragma unroll
        for (int j = 0; j < C; ++j) {
#pragma unroll
          for (int o = 1; o < lanes_t; o <<= 1) {
            dA[j] += __shfl_xor_sync(0xffffffffu, dA[j], o * lanes_c);
          }
          if (tl == 0) dAs[at + j] += dA[j];
        }
        // dB_t and dC_t over the channel lanes, through the warp's transpose
        // buffer (each lane's 2 L terms, written in the walks): each lane
        // adds the channel lanes of 2 L / lanes_c (term, time lane) pairs (a
        // tree, lane bit 0 first) into the warp's sums
        __syncwarp();  // every lane's terms in the buffer
#pragma unroll
        for (int m = 0; m < 2 * L / lanes_c; ++m) {
          const int o = lane + m * kWarp, i = o / lanes_t, t = o - i * lanes_t;
          const float4* q = reinterpret_cast<const float4*>(tw + i * kWarp + t * lanes_c);
          float sum = 0.0f;
#pragma unroll
          for (int g = 0; g < lanes_c / 4; ++g) {
            const float4 f = q[g];
            sum += (f.x + f.y) + (f.z + f.w);
          }
          const int which = i >= L ? 1 : 0;
          red_w[(which * N + n) * rrow + t * L + i - which * L] = sum;
        }
      }
      // dx and ddt of this thread's steps
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const int r = k * ck + tl * L + t;
        if (r < S) {
          const size_t off = static_cast<size_t>(r) * D + d0;
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const float xv = xs[(t * C + j) * threads + tid];
            DX[off + j] = scan::from_f32<T>(fmaf(dt[t][j], sb[t][j], a.skip[d0 + j] * dy[t][j]));
            DDT[off + j] = scan::from_f32<T>(fmaf(xv, sb[t][j], sa[t][j] * kLn2));
          }
        }
      }
      __syncthreads();  // every warp's dB/dC sums of the trip in place
      // the CTA's dB_t, dC_t of the trip: the warps in order
      const int rows = min(ck, S - k * ck);
      const size_t part0 = ((static_cast<size_t>(b) * tiles + tile) * S + k * ck) * N;
      for (Walk w = walk(tid, threads, N); w.r < rows; w.next()) {
        const int t = w.r, n = w.c;
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          const float* from = red + (which * N + n) * rrow + t;
          float sum = from[0];
#pragma unroll 4
          for (int g = 1; g < warps; ++g) sum += from[g * 2 * N * rrow];
          (which ? a.part_c : a.part_b)[part0 + t * N + n] = sum;
        }
      }
    }

    // this batch row's dA and dskip (a channel's time lanes in order)
    __syncthreads();  // the CTA's dA sums and every thread's dskip terms complete
    for (int e = tid; e < N * bd; e += threads) {
      const int c = e / N, n = e - c * N;
      a.part_a[(static_cast<size_t>(b) * D + tile * bd) * N + e] = dAs[n * bd + c];
    }
    for (int c = tid; c < bd; c += threads) {
      const int w = c / (lanes_c * C), rest = c - w * lanes_c * C;
      const int lc = rest / C, j = rest - lc * C;
      float s = 0.0f;
      for (int t = 0; t < lanes_t; ++t) s += dss[j * threads + w * kWarp + t * lanes_c + lc];
      a.part_s[static_cast<size_t>(b) * D + tile * bd + c] = s;
    }
  }
}

// The trips' maps chained in order, a thread a (b, n, d): the state at the
// start of trip k + 1 is 2^(a2 tdt_k) h_k + Q_k, written over Q_k.
__global__ void ssm_bwd_starts(const BwdArgs a, int trips) {
  const size_t ND = static_cast<size_t>(a.N) * a.D, total = a.B * ND;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t b = e / ND, rest = e - b * ND;
    const int n = static_cast<int>(rest / a.D), d = static_cast<int>(rest - n * a.D);
    const float a2 = a.A[static_cast<size_t>(d) * a.N + n] * scan::kLog2e;
    float* q = a.hc + b * (trips - 1) * ND + rest;
    const float* tdt = a.tdt + b * (trips - 1) * a.D + d;
    // in groups of 4 trips, the group's maps loaded before any is written
    float h = 0.0f;
    for (int k0 = 0; k0 + 1 < trips; k0 += 4) {
      float qk[4], pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + i;
        qk[i] = k + 1 < trips ? q[k * ND] : 0.0f;
        pk[i] = k + 1 < trips ? tdt[static_cast<size_t>(k) * a.D] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k0 + i + 1 < trips) {
          h = fmaf(scan::ex2(a2 * pk[i]), h, qk[i]);
          q[(k0 + i) * ND] = h;
        }
      }
    }
  }
}

// dB and dC over the CTAs' partials, dA and dskip over the batch rows, each
// added in order.
template <typename T>
__global__ void ssm_bwd_reduce(const BwdArgs a, int P) {
  const size_t per = static_cast<size_t>(a.S) * a.N;
  const size_t nbc = static_cast<size_t>(a.B) * per;
  const size_t na = static_cast<size_t>(a.D) * a.N;
  const size_t total = 2 * nbc + na + a.D;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    if (e < 2 * nbc) {
      const int which = e >= nbc;
      const size_t r = e - which * nbc;
      const size_t b = r / per;
      const float* src = (which ? a.part_c : a.part_b) + b * P * per + (r - b * per);
      float v = 0.0f;
      for (int p = 0; p < P; ++p) v += src[p * per];
      (which ? static_cast<T*>(a.dC) : static_cast<T*>(a.dB))[r] = scan::from_f32<T>(v);
    } else if (e < 2 * nbc + na) {
      const size_t r = e - 2 * nbc;
      float v = 0.0f;
      for (int b = 0; b < a.B; ++b) v += a.part_a[b * na + r];
      a.dA[r] = v;
    } else {
      const size_t r = e - 2 * nbc - na;
      float v = 0.0f;
      for (int b = 0; b < a.B; ++b) v += a.part_s[static_cast<size_t>(b) * a.D + r];
      a.dskip[r] = v;
    }
  }
}

// Sweep 1: the trips' maps, a trip of LT L steps (16-step segments where D
// is a multiple of 32) in CTAs of 128 threads (one channel a thread;
// narrower where D asks) that each compose kMapsTrips trips, then their
// chaining.
constexpr int kMapsTrips = 4;

template <typename T, int L, int LT>
int launch_maps(BwdArgs a, cudaStream_t stream) {
  constexpr int elt = static_cast<int>(sizeof(T));
  const int trips = (a.S + a.chunk - 1) / a.chunk;
  const int lanes_c = kWarp / LT;
  int bd = 128 / LT;
  while (a.D % bd) bd /= 2;  // D is a multiple of 4 (of the channel lanes of every tile)
  if (bd < lanes_c) return static_cast<int>(cudaErrorInvalidValue);
  a.block_d = bd;
  a.maps_trips = kMapsTrips;
  const Smem sz = smem_floats(bd, a.chunk, a.N, L, 1, elt);
  const long long smem = 4 * (sz.bc + sz.state + 2 * sz.bcrows);  // B_t, A, two trips' rows
  cudaError_t err = cudaFuncSetAttribute(ssm_bwd_kernel<T, L, 1, LT, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = (trips - 1 + kMapsTrips - 1) / kMapsTrips;
  ssm_bwd_kernel<T, L, 1, LT, true><<<static_cast<unsigned>(a.B * (a.D / bd) * per), bd * LT,
                                      static_cast<size_t>(smem), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = 1LL * a.B * a.N * a.D;
  ssm_bwd_starts<<<static_cast<unsigned>(n > 4096LL * 256 ? 4096 : (n + 255) / 256), 256, 0,
                   stream>>>(a, trips);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int L, int C, int LT>
int launch(BwdArgs a, cudaStream_t stream) {
  constexpr int elt = static_cast<int>(sizeof(T));
  const auto addr = [](const void* p) { return reinterpret_cast<unsigned long long>(p); };
  a.g_xd = scan::copy_bytes(elt, {1ULL * a.block_d * elt, 1ULL * a.D * elt, addr(a.x),
                                  addr(a.dt), addr(a.dy)});
  a.g_bc = scan::copy_bytes(elt, {1ULL * a.N * elt, 1ULL * a.S * a.N * elt, addr(a.Bc),
                                  addr(a.Cc)});
  const int P = a.D / a.block_d;
  const int threads = a.block_d / C * LT;
  const int trips = (a.S + a.chunk - 1) / a.chunk;
  cudaError_t err;
  if ((a.phases & kPhaseSweep1) && trips > 1) {
    const int code = a.D % 32 == 0 ? (a.chunk == 64 ? launch_maps<T, 16, 4>(a, stream)
                                                    : launch_maps<T, 16, 2>(a, stream))
                                   : (a.chunk == 64 ? launch_maps<T, 8, 8>(a, stream)
                                                    : launch_maps<T, 4, 8>(a, stream));
    if (code != 0) return code;
  }
  if (a.phases & kPhaseSweep2) {
    const long long smem = smem_bytes(a.block_d, a.chunk, a.N, L, C, elt);
    err = cudaFuncSetAttribute(ssm_bwd_kernel<T, L, C, LT, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssm_bwd_kernel<T, L, C, LT, false><<<static_cast<unsigned>(a.B * P), threads,
                                         static_cast<size_t>(smem), stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!(a.phases & kPhaseReduce)) return 0;
  const long long total = 2LL * a.B * a.S * a.N + 1LL * a.D * a.N + a.D;
  const unsigned blocks = static_cast<unsigned>(total > 8192LL * 256 ? 8192 : (total + 255) / 256);
  ssm_bwd_reduce<T><<<blocks, 256, 0, stream>>>(a, P);
  return static_cast<int>(cudaGetLastError());
}

// The compiled (seg, channels, time lanes): a trip of 32 or 64 steps, 8
// or 4 channel lanes.
#define SSM_BWD_TILES(X) \
  X(4, 1, 8) X(8, 1, 4) X(8, 1, 8) X(16, 1, 4) X(4, 2, 8) X(8, 2, 4)

template <typename T>
int launch_tile(const BwdArgs& a, int seg, int channels, int lanes_t, cudaStream_t s) {
#define SSM_BWD_LAUNCH(L, C, LT) \
  if (seg == L && channels == C && lanes_t == LT) return launch<T, L, C, LT>(a, s);
  SSM_BWD_TILES(SSM_BWD_LAUNCH)
#undef SSM_BWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

bool compiled(int seg, int channels, int lanes_t) {
#define SSM_BWD_TAKES(L, C, LT) \
  if (seg == L && channels == C && lanes_t == LT) return true;
  SSM_BWD_TILES(SSM_BWD_TAKES)
#undef SSM_BWD_TAKES
  return false;
}

}  // namespace

// The dynamic shared memory one sweep-2 CTA of (block_d, chunk, seg,
// channels) takes at n_state states and an element size of elt bytes.
extern "C" long long ssm_scan_bwd_smem_bytes(int block_d, int chunk, int n_state, int seg,
                                             int channels, int elt) {
  return smem_bytes(block_d, chunk, n_state, seg, channels, elt);
}

// Bytes of the float32 scratch one call takes: the trip-start states, the
// CTAs' dB and dC partials, and dA's and dskip's per batch row.
extern "C" long long ssm_scan_bwd_scratch_bytes(int B, int S, int D, int N, int block_d,
                                                int chunk) {
  return scratch_bytes(B, S, D, N, block_d, chunk);
}

// The most threads a CTA of (seg, channels) may have.
extern "C" int ssm_scan_bwd_max_threads(int seg, int channels) {
  return max_threads(seg, channels);
}

// x, dt, Bc, Cc, dy and dx, ddt, dB, dC: elements of elt bytes (4: float32,
// 2: bf16); A, skip, dh (B, D, N, or null), dA, dskip float32; scratch of
// ssm_scan_bwd_scratch_bytes; phases 7 (sweep 1, sweep 2 and the reduce:
// 1, 2 and 4, launched alone for timing on the same scratch).  N from 1 to
// 256; (seg, channels, chunk / seg time lanes) one of SSM_BWD_TILES, the
// warp's other 32 / (chunk / seg) lanes channel lanes;
// block_d dividing D, a multiple of channels times the channel lanes;
// (block_d / channels) (chunk / seg) threads up to max_threads; any S >= 1.
// Returns the launches' cudaGetLastError() code (cudaErrorInvalidValue for
// what the kernel does not take).
extern "C" int ssm_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bc, const void* Cc,
    const void* skip, const void* dy, const void* dh, void* dx, void* ddt, void* dA, void* dB,
    void* dC, void* dskip, void* scratch, int B, int S, int D, int N, int block_d, int chunk,
    int seg, int channels, int elt, int phases, void* stream) {
  if (N < 1 || N > 256 || B < 1 || S < 1 || block_d < 1 || D % block_d || seg < 1 ||
      chunk % seg || !compiled(seg, channels, chunk / seg) || (elt != 4 && elt != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lanes_t = chunk / seg;
  if (block_d % (kWarp / lanes_t * channels) ||
      1LL * block_d / channels * lanes_t > max_threads(seg, channels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scratch s = scratch_floats(B, S, D, N, block_d, chunk);
  float* base = static_cast<float*>(scratch);
  BwdArgs a;
  a.x = x;
  a.dt = dt;
  a.A = static_cast<const float*>(A);
  a.Bc = Bc;
  a.Cc = Cc;
  a.skip = static_cast<const float*>(skip);
  a.dy = dy;
  a.dh = static_cast<const float*>(dh);
  a.dx = dx;
  a.ddt = ddt;
  a.dA = static_cast<float*>(dA);
  a.dB = dB;
  a.dC = dC;
  a.dskip = static_cast<float*>(dskip);
  a.hc = base;
  a.tdt = base + s.hc;
  a.part_b = a.tdt;
  a.part_c = a.part_b + s.first();
  a.part_a = a.part_c + s.part;
  a.part_s = a.part_a + s.part_a;
  a.B = B;
  a.S = S;
  a.D = D;
  a.N = N;
  a.block_d = block_d;
  a.chunk = chunk;
  a.phases = phases;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elt == 4 ? launch_tile<float>(a, seg, channels, lanes_t, st)
                  : launch_tile<__nv_bfloat16>(a, seg, channels, lanes_t, st);
}
