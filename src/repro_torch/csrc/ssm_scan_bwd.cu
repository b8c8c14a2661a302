// Backward of the Mamba-1 selective scan (csrc/ssm_scan.cu), for Hopper.
//
// Replaces: src/repro/models/ssm.py:95, XLA's derivative of ssm_block's
// lax.scan (its oracle: src/repro/kernels/ssm_scan/ref.py:18 under
// jax.vjp); the JAX package has no kernel for it.
//
// Forward, per batch row, channel d and state n:
//   h_t = e_t h_{t-1} + u_t B_t,   e_t = exp(dt_t A),  u_t = dt_t x_t
//   y_t = sum_n h_t C_t + skip x_t
// Backward, from the last step to the first, with the state's adjoint
// g_t = dL/dh_t and carry = e_{t+1} g_{t+1} (dh, the final state's
// gradient, before the last step):
//   g_t   = dy_t C_t + carry
//   dA   += g_t h_{t-1} e_t dt_t                       summed over b, t
//   ddt_t = sum_n g_t (A e_t h_{t-1}) + x_t sum_n g_t B_t
//   dx_t  = dt_t sum_n g_t B_t + skip dy_t
//   dB_t  = sum_d g_t u_t,   dC_t = sum_d h_t dy_t      summed over the channels
//   dskip = sum_{b,t} dy x
// x, dt, dy, Bc, Cc and their gradients share one element type, float32 or
// bf16 (dy takes y's, which is x's); A, skip, dh, dA and dskip are float32,
// and so is all arithmetic.
//
// What bounds it: on paper, the SFU (one exp per (t, d, n), 0.064 ms at
// falcon-mamba-7b width, B = 1, on an H100 SXM) against bytes (x, dt, dy
// read and dx, ddt written, 20 bytes per (t, d) in float32: 0.100 ms).  On
// the card, as in the forward, the chains of dependent steps and the
// shuffles of the sums across lanes.
//
// Design.  A CTA owns block_d channels of one batch row for the whole
// sequence; a thread keeps K = `states` consecutive states of one channel
// (the forward's layout: NP / K lanes a channel, NP = N rounded up to a
// power of two, the states past N reading A = 0 and B = C = 0, so they stay
// 0).  The forward keeps h in registers and stores none of it; the
// backward needs h_{t-1} in reverse order.  It is recomputed, never run
// backwards: h_{t-1} = (h_t - u_t B_t) / e_t divides by an exp that
// underflows for large |A| dt.  Three levels:
//   1. sweep 1 runs the recurrence forward over every chunk of `chunk`
//      steps but the last and writes the state at each chunk's start to
//      global scratch (B, trips, D, NP) float32 (8 MB at falcon width,
//      B = 1, chunk 128); only the thread that wrote a value reads it back;
//   2. sweep 2 walks the chunks in reverse.  A chunk's x, dt, dy, B_t and
//      C_t are staged with cp.async into one of two shared-memory stages
//      (the previous chunk's loads fly while this one runs).  From the
//      chunk's start state a pass writes the state at the start of each
//      group of U = 16 / K steps to shared memory;
//   3. the groups in reverse: a group's U steps are run forward again from
//      its start state, keeping each step's decay and h_{t-1} in registers
//      (U K of each), and then walked backward with the adjoint.
// So every exp is taken three times; dA and dskip sum in registers.
//
// The sums.  Over a channel's states (ddt, dx): a butterfly over its NP / K
// lanes; the channel's first lane writes dx and ddt over x and dt in shared
// memory, and the chunk's rows are stored whole at its end.  Over the
// channels (dB_t, dC_t): a reduce-scatter of a step's 2 K sums over the
// warp's channels (2 K - 1 shuffles at N = 16, where a butterfly of each
// took 2 K log2(2 K)), each warp's sums of a chunk's steps go to shared
// memory, and at the chunk's end the CTA adds them in warp order and writes
// its partial sums to scratch (B, D / block_d, S, N) float32: one barrier
// a chunk.  No float atomics: a reduce kernel, the
// same launch's second, adds the partials over the CTAs in order, dA's
// per-batch-row partials (B, D, N) over the rows and dskip's likewise, so
// two calls give the same bits.
//
// Rows past the sequence's end (a short last chunk, or a chunk that is no
// multiple of U) are set to 0 in shared memory: dt = 0 is decay 1 and
// input 0, dy = 0 adds nothing to g, so h and the carry pass them
// unchanged, and nothing of them is stored.  So any S and any chunk run.
#include "scan_staging.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

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
  float* hc;      // (B, trips, D, NP): the state at each chunk's start
  float* part_b;  // (B, D / block_d, S, N): a CTA's dB_t over its channels
  float* part_c;  // likewise dC_t
  float* part_a;  // (B, D, N): dA of one batch row
  float* part_s;  // (B, D): dskip of one batch row
  int B, S, D, N, np, block_d, chunk;
  int g_xd, g_bc;  // staging piece sizes in bytes (scan::copy_bytes)
};

// Steps of a group: their decays and states before them stay in registers
// (U K of each).
__host__ __device__ constexpr int group_steps(int K) { return K >= 16 ? 1 : 16 / K; }

// The launch bound: 255 registers a thread for a group's 2 U K decays and
// states, the K states, carries and sums of dA, and a step's loads.
constexpr int kMaxThreads = 256;

constexpr int pad_states(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// Rows of one stage: the chunk rounded up to a whole group.
__host__ __device__ constexpr int stage_rows(int chunk, int K) {
  return (chunk + group_steps(K) - 1) / group_steps(K) * group_steps(K);
}

long long stage_bytes(int block_d, int chunk, int np, int K, int elt) {
  const long long rows = stage_rows(chunk, K);
  return 3 * scan::align16(rows * block_d * elt) + 2 * scan::align16(rows * np * elt);
}

// Two stages; the group starts (rows / U of K floats a thread); the warps'
// sums of a chunk's steps (2 rows warps NP floats).
long long smem_bytes(int block_d, int chunk, int n_state, int K, int elt) {
  const int np = pad_states(n_state);
  const long long threads = 1LL * block_d * np / K;
  const long long rows = stage_rows(chunk, K);
  return 2 * stage_bytes(block_d, chunk, np, K, elt) + 4 * rows / group_steps(K) * K * threads +
         4LL * 2 * rows * (threads / 32) * np;
}

// Floats of each scratch region, in order, each a multiple of 4 (16 bytes).
struct Scratch {
  long long hc, part, part_a, part_s;
};

Scratch scratch_floats(int B, int S, int D, int N, int block_d, int chunk) {
  const auto round4 = [](long long v) { return (v + 3) / 4 * 4; };
  const long long trips = (S + chunk - 1) / chunk;
  return {round4(1LL * B * trips * D * pad_states(N)),
          round4(1LL * B * (D / block_d) * S * N), round4(1LL * B * D * N),
          round4(1LL * B * D)};
}

long long scratch_bytes(int B, int S, int D, int N, int block_d, int chunk) {
  const Scratch s = scratch_floats(B, S, D, N, block_d, chunk);
  return 4 * (s.hc + 2 * s.part + s.part_a + s.part_s);
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxThreads, 1) ssm_bwd_kernel(const BwdArgs a) {
  constexpr int U = group_steps(K);
  extern __shared__ __align__(16) unsigned char smem[];
  const int bd = a.block_d, ck = a.chunk, N = a.N, NP = a.np, D = a.D, S = a.S;
  const int rows = stage_rows(ck, K);
  const int xd_bytes = static_cast<int>(scan::align16(1LL * rows * bd * sizeof(T)));
  const int bc_bytes = static_cast<int>(scan::align16(1LL * rows * NP * sizeof(T)));
  const int stage = 3 * xd_bytes + 2 * bc_bytes;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  float* edges = reinterpret_cast<float*>(smem + 2 * stage);
  float* red = edges + (rows / U) * K * nthreads;
  const int tpc = NP / K;  // lanes of one channel
  const int dl = tid / tpc;
  const int g = tid - dl * tpc;
  const int tiles = D / bd;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int d0 = tile * bd;
  const int d = d0 + dl;
  const int trips = (S + ck - 1) / ck;

  float a2[K];  // A log2(e): e_t = 2^(dt a2)
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int n = g * K + j;
    a2[j] = n < N ? a.A[static_cast<size_t>(d) * N + n] * scan::kLog2e : 0.0f;
  }
  const float skip = a.skip[d];
  const size_t row0 = static_cast<size_t>(b) * S;  // (b, t = 0)
  float* hc = a.hc + static_cast<size_t>(b) * trips * D * NP + static_cast<size_t>(d) * NP +
              g * K;

  auto rows_of = [&](int k) { return min(ck, S - k * ck); };

  // cp.async chunk `trip` into stage `s`: x, dt (and with `full` dy) rows of
  // block_d elements, B (and with `full` C) rows of NP; the rows up to the
  // last group's end are set to 0.
  auto load_chunk = [&](int trip, int s, bool full) {
    unsigned char* base = smem + s * stage;
    const size_t r = row0 + static_cast<size_t>(trip) * ck;
    const int n = rows_of(trip);
    const int gx = a.g_xd, row_pieces = bd * static_cast<int>(sizeof(T)) / gx;
    const size_t src0 = (r * D + d0) * sizeof(T);
    const char* src[3] = {static_cast<const char*>(a.x) + src0,
                          static_cast<const char*>(a.dt) + src0,
                          static_cast<const char*>(a.dy) + src0};
    const int arrays = full ? 3 : 2;
    const size_t stride = static_cast<size_t>(D) * sizeof(T);
    for (int e = tid; e < n * row_pieces; e += nthreads) {
      const int t = e / row_pieces;
      const int piece = (e - t * row_pieces) * gx;
      const int off = t * bd * static_cast<int>(sizeof(T)) + piece;
      for (int q = 0; q < arrays; ++q) {
        scan::copy_piece(base + q * xd_bytes + off, src[q] + t * stride + piece, gx);
      }
    }
    const int gb = a.g_bc, bc_row = N * static_cast<int>(sizeof(T)) / gb;
    const char* bs = static_cast<const char*>(a.Bc) + r * N * sizeof(T);
    const char* cs = static_cast<const char*>(a.Cc) + r * N * sizeof(T);
    for (int e = tid; e < n * bc_row; e += nthreads) {
      const int t = e / bc_row;
      const int piece = (e - t * bc_row) * gb;
      const int off = t * NP * static_cast<int>(sizeof(T)) + piece;
      const int from = t * N * static_cast<int>(sizeof(T)) + piece;
      scan::copy_piece(base + 3 * xd_bytes + off, bs + from, gb);
      if (full) scan::copy_piece(base + 3 * xd_bytes + bc_bytes + off, cs + from, gb);
    }
    const int dead = (n + U - 1) / U * U - n;
    for (int q = 0; q < 3; ++q) {
      T* z = reinterpret_cast<T*>(base + q * xd_bytes) + n * bd;
      for (int e = tid; e < dead * bd; e += nthreads) z[e] = scan::from_f32<T>(0.0f);
    }
    for (int q = 0; q < 2; ++q) {
      T* z = reinterpret_cast<T*>(base + 3 * xd_bytes + q * bc_bytes) + n * NP;
      for (int e = tid; e < dead * NP; e += nthreads) z[e] = scan::from_f32<T>(0.0f);
    }
    scan::cp_async_commit();
  };

  // the columns past N of both stages' B and C rows: 0 for the whole run
  if (N < NP) {
    const int pad = NP - N, per = rows * pad;
    for (int e = tid; e < 4 * per; e += nthreads) {
      const int region = e / per, rest = e - region * per, row = rest / pad;
      T* rw = reinterpret_cast<T*>(smem + (region >> 1) * stage + 3 * xd_bytes +
                                   (region & 1) * bc_bytes);
      rw[row * NP + N + (rest - row * pad)] = scan::from_f32<T>(0.0f);
    }
  }

  // one step of the recurrence on staged row t
  auto step = [&](const T* sx, const T* sdt, const T* sb, int t, float (&h)[K]) {
    const float dtv = scan::to_f32(sdt[t * bd + dl]);
    const float u = dtv * scan::to_f32(sx[t * bd + dl]);
    float bv[K];
    scan::load_vec<T, K>(sb + t * NP, bv);
#pragma unroll
    for (int j = 0; j < K; ++j) h[j] = fmaf(scan::ex2(dtv * a2[j]), h[j], u * bv[j]);
  };

  // -- sweep 1: the state at the start of every chunk but the first -------
  float h[K];
#pragma unroll
  for (int j = 0; j < K; ++j) h[j] = 0.0f;
  if (trips > 1) {
    load_chunk(0, 0, false);
    for (int k = 0; k + 1 < trips; ++k) {
      scan::cp_async_wait_all();
      __syncthreads();  // chunk k landed; chunk k - 1's stage is free
      if (k + 2 < trips) load_chunk(k + 1, (k + 1) & 1, false);
      const unsigned char* base = smem + (k & 1) * stage;
      const T* sx = reinterpret_cast<const T*>(base);
      const T* sdt = reinterpret_cast<const T*>(base + xd_bytes);
      const T* sb = reinterpret_cast<const T*>(base + 3 * xd_bytes) + g * K;
#pragma unroll 4
      for (int t = 0; t < ck; ++t) step(sx, sdt, sb, t, h);
      float* out = hc + static_cast<size_t>(k + 1) * D * NP;
#pragma unroll
      for (int j = 0; j < K; ++j) out[j] = h[j];
    }
    scan::cp_async_wait_all();
    __syncthreads();  // both stages free for sweep 2
  }

  // -- sweep 2: the chunks in reverse --------------------------------------
  float carry[K], dA[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int n = g * K + j;
    carry[j] = a.dh != nullptr && n < N ? a.dh[(static_cast<size_t>(b) * D + d) * N + n] : 0.0f;
    dA[j] = 0.0f;
  }
  float dskip = 0.0f;
  T* dx = static_cast<T*>(a.dx);
  T* ddt = static_cast<T*>(a.ddt);
  const int P = tiles;
  load_chunk(trips - 1, 0, true);
  for (int kk = 0; kk < trips; ++kk) {
    const int k = trips - 1 - kk;
    scan::cp_async_wait_all();
    __syncthreads();  // chunk k landed; the other stage is stored and free
    if (k > 0) load_chunk(k - 1, (kk + 1) & 1, true);
    unsigned char* base = smem + (kk & 1) * stage;
    T* sx = reinterpret_cast<T*>(base);
    T* sdt = reinterpret_cast<T*>(base + xd_bytes);
    const T* sdy = reinterpret_cast<const T*>(base + 2 * xd_bytes);
    const T* sb = reinterpret_cast<const T*>(base + 3 * xd_bytes) + g * K;
    const T* sc = reinterpret_cast<const T*>(base + 3 * xd_bytes + bc_bytes) + g * K;
    const int n = rows_of(k);
    const int groups = (n + U - 1) / U;

    // the state at each group's start, from the chunk's
#pragma unroll
    for (int j = 0; j < K; ++j) h[j] = k == 0 ? 0.0f : hc[static_cast<size_t>(k) * D * NP + j];
    for (int q = 0; q < groups; ++q) {
#pragma unroll
      for (int j = 0; j < K; ++j) edges[(q * K + j) * nthreads + tid] = h[j];
#pragma unroll
      for (int s = 0; s < U; ++s) step(sx, sdt, sb, q * U + s, h);
    }

    for (int q = groups - 1; q >= 0; --q) {
      // the group forward again: each step's decay and the state before it
      float dec[U][K], hp[U][K];
#pragma unroll
      for (int j = 0; j < K; ++j) h[j] = edges[(q * K + j) * nthreads + tid];
#pragma unroll
      for (int s = 0; s < U; ++s) {
        const int t = q * U + s;
        const float dtv = scan::to_f32(sdt[t * bd + dl]);
        const float u = dtv * scan::to_f32(sx[t * bd + dl]);
        float bv[K];
        scan::load_vec<T, K>(sb + t * NP, bv);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          dec[s][j] = scan::ex2(dtv * a2[j]);
          hp[s][j] = h[j];
          h[j] = fmaf(dec[s][j], h[j], u * bv[j]);
        }
      }
      // ... and backward with the adjoint
#pragma unroll
      for (int s = U - 1; s >= 0; --s) {
        const int t = q * U + s;
        const float xv = scan::to_f32(sx[t * bd + dl]);
        const float dtv = scan::to_f32(sdt[t * bd + dl]);
        const float dyv = scan::to_f32(sdy[t * bd + dl]);
        const float u = dtv * xv;
        float bv[K], cv[K], gu[K], hd[K];
        scan::load_vec<T, K>(sb + t * NP, bv);
        scan::load_vec<T, K>(sc + t * NP, cv);
        float sum_b = 0.0f, sum_a = 0.0f;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float gj = fmaf(dyv, cv[j], carry[j]);
          const float ghe = gj * hp[s][j] * dec[s][j];
          sum_a = fmaf(ghe, a2[j], sum_a);
          dA[j] = fmaf(ghe, dtv, dA[j]);
          sum_b = fmaf(gj, bv[j], sum_b);
          gu[j] = gj * u;
          hd[j] = fmaf(dec[s][j], hp[s][j], u * bv[j]) * dyv;
          carry[j] = dec[s][j] * gj;
        }
        // over the channel's lanes ...
        for (int o = 1; o < tpc; o <<= 1) {
          sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
          sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
        }
        // ... and over the warp's channels (the lane bits from 16 down to
        // tpc): a reduce-scatter of the 2 K sums, dB's then dC's, each level
        // sending the half the partner keeps, then a butterfly once a lane
        // holds one; the lanes that end with a whole sum write it
        float v[2 * K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          v[j] = gu[j];
          v[K + j] = hd[j];
        }
        int held = 2 * K, first = 0;
        bool writes = true;
#pragma unroll
        for (int l = 0; l < 5; ++l) {
          const int o = 16 >> l;
          if (o < tpc) break;  // the rest are a channel's own lanes
          constexpr int kHalfMax = K;  // (2 K >> l) / 2 at l = 0
          const int half = (2 * K >> l) / 2;
          if (half >= 1) {
            const bool upper = (lane & o) != 0;
#pragma unroll
            for (int i = 0; i < kHalfMax; ++i) {
              if (i < half) {
                const float lo = v[i], hi = v[i + half];
                v[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, o);
              }
            }
            held = half;
            if (upper) first += half;
          } else {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
            writes = writes && (lane & o) == 0;
          }
        }
        if (writes) {
#pragma unroll
          for (int i = 0; i < 2 * K; ++i) {
            if (i < held) {
              const int q = first + i, which = q >= K ? 1 : 0;
              red[((which * rows + t) * nwarps + warp) * NP + g * K + q - which * K] = v[i];
            }
          }
        }
        dskip = fmaf(dyv, xv, dskip);
        // the channel's lanes have read x and dt of step t
        if (tpc > 1) __syncwarp();
        if (g == 0) {
          sx[t * bd + dl] = scan::from_f32<T>(fmaf(dtv, sum_b, skip * dyv));
          sdt[t * bd + dl] = scan::from_f32<T>(fmaf(xv, sum_b, sum_a * kLn2));
        }
      }
    }
    __syncthreads();  // the chunk's dx, ddt and every warp's sums are in place
    // the CTA's sums over its channels, the warps added in order
    for (int e = tid; e < 2 * n * N; e += nthreads) {
      const int which = e / (n * N), rest = e - which * n * N;
      const int t = rest / N, nn = rest - t * N;
      const float* src = red + (which * rows + t) * nwarps * NP + nn;
      float v = 0.0f;
      for (int w = 0; w < nwarps; ++w) v += src[w * NP];
      float* part = which ? a.part_c : a.part_b;
      part[((static_cast<size_t>(b) * P + tile) * S + static_cast<size_t>(k) * ck + t) * N + nn] =
          v;
    }
    // the chunk's dx and ddt rows, neighbouring threads on neighbouring addresses
    const int gx = a.g_xd, row_pieces = bd * static_cast<int>(sizeof(T)) / gx;
    const size_t dst0 = ((row0 + static_cast<size_t>(k) * ck) * D + d0) * sizeof(T);
    const size_t stride = static_cast<size_t>(D) * sizeof(T);
    for (int e = tid; e < n * row_pieces; e += nthreads) {
      const int t = e / row_pieces;
      const int piece = (e - t * row_pieces) * gx;
      const int off = t * bd * static_cast<int>(sizeof(T)) + piece;
      scan::store_piece(reinterpret_cast<char*>(dx) + dst0 + t * stride + piece, base + off, gx);
      scan::store_piece(reinterpret_cast<char*>(ddt) + dst0 + t * stride + piece,
                        base + xd_bytes + off, gx);
    }
  }
  // this batch row's dA and dskip
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int n = g * K + j;
    if (n < N) a.part_a[(static_cast<size_t>(b) * D + d) * N + n] = dA[j];
  }
  if (g == 0) a.part_s[static_cast<size_t>(b) * D + d] = dskip;
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

template <typename T, int K>
int launch(BwdArgs a, cudaStream_t stream) {
  const int elt = static_cast<int>(sizeof(T));
  const long long smem = smem_bytes(a.block_d, a.chunk, a.N, K, elt);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_bwd_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto addr = [](const void* p) { return reinterpret_cast<unsigned long long>(p); };
  a.g_xd = scan::copy_bytes(elt, {1ULL * a.block_d * elt, 1ULL * a.D * elt, addr(a.x),
                                  addr(a.dt), addr(a.dy), addr(a.dx), addr(a.ddt)});
  a.g_bc = scan::copy_bytes(elt, {1ULL * a.N * elt, addr(a.Bc), addr(a.Cc)});
  const int P = a.D / a.block_d;
  ssm_bwd_kernel<T, K><<<static_cast<unsigned>(a.B * P), a.block_d * a.np / K,
                         static_cast<size_t>(smem), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = 2LL * a.B * a.S * a.N + 1LL * a.D * a.N + a.D;
  const unsigned blocks = static_cast<unsigned>(total > 8192LL * 256 ? 8192 : (total + 255) / 256);
  ssm_bwd_reduce<T><<<blocks, 256, 0, stream>>>(a, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_states(const BwdArgs& a, int states, cudaStream_t s) {
  switch (states) {
    case 1: return launch<T, 1>(a, s);
    case 2: return launch<T, 2>(a, s);
    case 4: return launch<T, 4>(a, s);
    case 8: return launch<T, 8>(a, s);
    case 16: return launch<T, 16>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The dynamic shared memory one CTA of (block_d, chunk, states) takes at
// n_state and an element size of elt bytes.
extern "C" long long ssm_scan_bwd_smem_bytes(int block_d, int chunk, int n_state, int states,
                                             int elt) {
  return smem_bytes(block_d, chunk, n_state, states, elt);
}

// Bytes of the float32 scratch one call takes: the chunk-start states, the
// CTAs' dB and dC partials, and dA's and dskip's per batch row.
extern "C" long long ssm_scan_bwd_scratch_bytes(int B, int S, int D, int N, int block_d,
                                                int chunk) {
  return scratch_bytes(B, S, D, N, block_d, chunk);
}

// x, dt, Bc, Cc, dy and dx, ddt, dB, dC: elements of elt bytes (4: float32,
// 2: bf16); A, skip, dh (B, D, N, or null), dA, dskip float32; scratch of
// ssm_scan_bwd_scratch_bytes.  The forward's tiles: N from 1 to 256,
// states a power of two up to 16 with NP / states <= 32 lanes a channel,
// block_d * NP / states a multiple of 32 up to 256, block_d dividing D; any S >= 1 and chunk >= 1.  Returns the
// launches' cudaGetLastError() code (cudaErrorInvalidValue for what the
// kernel does not take).
extern "C" int ssm_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bc, const void* Cc,
    const void* skip, const void* dy, const void* dh, void* dx, void* ddt, void* dA, void* dB,
    void* dC, void* dskip, void* scratch, int B, int S, int D, int N, int block_d, int chunk,
    int states, int elt, void* stream) {
  const int np = pad_states(N);
  const bool ok = N >= 1 && N <= 256 && states > 0 && states <= 16 &&
                  (states & (states - 1)) == 0 && states <= np && np / states <= 32;
  if (!ok || B < 1 || S < 1 || block_d < 1 || chunk < 1 || D % block_d ||
      (elt != 4 && elt != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = 1LL * block_d * np / states;
  if (threads > kMaxThreads || threads % 32) {
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
  a.part_b = base + s.hc;
  a.part_c = a.part_b + s.part;
  a.part_a = a.part_c + s.part;
  a.part_s = a.part_a + s.part_a;
  a.B = B;
  a.S = S;
  a.D = D;
  a.N = N;
  a.np = np;
  a.block_d = block_d;
  a.chunk = chunk;
  a.g_xd = a.g_bc = elt;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elt == 4 ? launch_states<float>(a, states, st)
                  : launch_states<__nv_bfloat16>(a, states, st);
}
