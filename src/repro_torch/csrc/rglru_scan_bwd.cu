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
// What bounds it: on paper, memory (x, r, i, dy read and dx, dr, di
// written: 28 bytes per element in float32, 14 in bf16); as in the forward,
// a thread that carried one channel through the whole sequence would make
// it latency instead (B W = 2560 chains at recurrentgemma-2b width).
//
// Design.  The forward's: a CTA owns block_w channels with `split` threads
// a channel, walks the sequence in tiles of `chunk` steps staged with
// cp.async into one of two shared-memory stages, and each thread takes a
// segment of L steps of a tile (the forward's layout, padding included).
// Both recurrences are linear, so a segment's steps compose into one map
// and a Kogge-Stone scan over the split lanes joins the segments:
//   sweep 1 runs the forward's phases A and B over every tile but the last
//     and writes the state at each tile's start to scratch (B, trips, W)
//     float32;
//   sweep 2 walks the tiles in reverse.  From the tile's start state it
//     reruns the forward (phases A, B, C), keeping a_t and h_{t-1} of its
//     segment in registers.  Then the adjoint, with time reversed: with
//     G_t = a_t g_t (what step t hands to step t - 1) each step is the map
//     G_t = a_t G_{t+1} + a_t dy_t, so a segment composes its map from its
//     last step to its first, an inclusive scan down the lanes
//     (__shfl_down_sync) gives each segment the G entering it from the
//     later ones and the carry from the next tile, and the segment is
//     walked backward once more for the gradients, written over x, r and i
//     in shared memory and stored whole.
// The gradient pass takes 1 - a_t^2 as (1 - a_t)(1 + a_t) with 1 - a_t =
// -expm1(-8 r_t softplus(-lam)): near a_t = 1 the square root's derivative
// -a / s divides by a small s, and 1 - a_t^2 taken from a_t loses most of
// its digits there.
// dlam sums in registers over a thread's steps, then over the channel's
// lanes; each batch row's sum goes to scratch (B, W) and a second kernel
// of the same launch adds the rows in order: no float atomics, so two
// calls give the same bits.  Steps past the sequence's end read x = r =
// i = dy = 0: a = 1 and b = 0 in the forward, and G passes them unchanged;
// nothing of them is stored.  So any S runs.
#include "scan_staging.cuh"

namespace {

constexpr float kCFactor = 8.0f;
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
  float* hc;    // (B, trips, W): the state at each tile's start
  float* part;  // (B, W): dlam of one batch row
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

// Two stages of x, r, i and dy tiles.
long long smem_bytes(int block_w, int L, int split, int elt) {
  return 2 * 4 * tile_bytes(block_w, L, split, elt);
}

int seg_len(int chunk, int split) {
  const int need = (chunk + split - 1) / split;
  for (int L = 4; L <= 32; L *= 2) {
    if (need <= L) return L;
  }
  return 0;
}

long long scratch_floats(int B, int S, int W, int chunk) {
  const long long trips = (S + chunk - 1) / chunk;
  return (1LL * B * trips * W + 3) / 4 * 4 + 1LL * B * W;
}

template <typename T, int L>
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
  const int b = blockIdx.x / tiles;
  const int w0 = (blockIdx.x % tiles) * bw;
  const float lam = a.lam[w0 + c];
  const float sp = softplus(-lam);
  const float k2 = -kCFactor * sp * scan::kLog2e;
  const float kr = -kCFactor * sp;
  const size_t row0 = static_cast<size_t>(b) * a.S;
  const size_t stride = static_cast<size_t>(W) * elt;  // bytes between rows
  const int G = a.g, row_pieces = bw * elt / G;
  const char* src[4] = {static_cast<const char*>(a.x), static_cast<const char*>(a.r),
                        static_cast<const char*>(a.i), static_cast<const char*>(a.dy)};
  char* dst[3] = {static_cast<char*>(a.dx), static_cast<char*>(a.dr),
                  static_cast<char*>(a.di)};
  const int trips = (a.S + ck - 1) / ck;
  float* hc = a.hc + static_cast<size_t>(b) * trips * W + w0 + c;

  const int t_first = tid / row_pieces, u_first = tid - t_first * row_pieces;
  const int t_step = nthreads / row_pieces, u_step = nthreads - t_step * row_pieces;

  auto row_off = [&](int t) { return ((t / L) * seg + (t % L) * bw) * elt; };
  auto rows_of = [&](int k) { return min(ck, a.S - k * ck); };

  // cp.async tile k's first `arrays` of x, r, i, dy into stage s
  auto load_tile = [&](int k, int s, int arrays) {
    unsigned char* base = smem + s * 4 * tile;
    const size_t g0 = ((row0 + static_cast<size_t>(k) * ck) * W + w0) * elt;
    const int n = rows_of(k);
    for (int t = t_first, v = u_first; t < n;) {
      const int u = v * G;
      const int off = row_off(t) + u;
      const size_t gofs = g0 + t * stride + u;
      for (int q = 0; q < arrays; ++q) scan::copy_piece(base + q * tile + off, src[q] + gofs, G);
      t += t_step;
      v += u_step;
      if (v >= row_pieces) {
        v -= row_pieces;
        ++t;
      }
    }
    scan::cp_async_commit();
  };

  const int warp_lanes = min(32, nthreads - (tid & ~31));
  const unsigned full = warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1u;

  // this thread's segment of tile k in stage s (x, r, i, dy), its steps
  // past the tile's end set to 0
  auto segment = [&](int k, int s, T* (&ptr)[4], int arrays) {
    unsigned char* base = smem + s * 4 * tile;
#pragma unroll
    for (int q = 0; q < 4; ++q) ptr[q] = reinterpret_cast<T*>(base + q * tile) + p * seg + c;
    const int n = rows_of(k);
    if (n < L * split) {
      for (int j = max(n - p * L, 0); j < L; ++j) {
        for (int q = 0; q < arrays; ++q) ptr[q][j * bw] = scan::from_f32<T>(0.0f);
      }
    }
  };

  // phase A of the forward on a segment: its a_t (kept) and its map (A, H)
  auto compose = [&](T* const (&ptr)[4], float (&av)[L], float& A, float& H) {
    A = 1.0f;
    H = 0.0f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float at = scan::ex2(scan::to_f32(ptr[1][j * bw]) * k2);
      float gain;
      asm("sqrt.approx.f32 %0, %1;" : "=f"(gain) : "f"(fmaxf(fmaf(-at, at, 1.0f), 1e-12f)));
      av[j] = at;
      H = fmaf(at, H, gain * (scan::to_f32(ptr[2][j * bw]) * scan::to_f32(ptr[0][j * bw])));
      A *= at;
    }
  };

  // phase B: the maps scanned up the lanes; each lane's start state from the
  // tile's, and the tile's end state
  auto join_up = [&](float A, float H, float start, float& mine) {
    for (int off = 1; off < split; off <<= 1) {
      const float Ap = __shfl_up_sync(full, A, off, split);
      const float Hp = __shfl_up_sync(full, H, off, split);
      if (p >= off) {
        H = fmaf(A, Hp, H);
        A *= Ap;
      }
    }
    float Ae = __shfl_up_sync(full, A, 1, split);
    float He = __shfl_up_sync(full, H, 1, split);
    if (p == 0) {
      Ae = 1.0f;
      He = 0.0f;
    }
    const float Al = __shfl_sync(full, A, split - 1, split);
    const float Hl = __shfl_sync(full, H, split - 1, split);
    mine = fmaf(Ae, start, He);
    return fmaf(Al, start, Hl);
  };

  // -- sweep 1: the state at the start of every tile but the first --------
  float carry = 0.0f;
  if (trips > 1) {
    load_tile(0, 0, 3);
    for (int k = 0; k + 1 < trips; ++k) {
      scan::cp_async_wait_all();
      __syncthreads();  // tile k landed; tile k - 1's stage is free
      if (k + 2 < trips) load_tile(k + 1, (k + 1) & 1, 3);
      T* ptr[4];
      segment(k, k & 1, ptr, 3);
      float av[L], A, H, mine;
      compose(ptr, av, A, H);
      carry = join_up(A, H, carry, mine);
      if (p == 0) hc[static_cast<size_t>(k + 1) * W] = carry;
    }
    scan::cp_async_wait_all();
    __syncthreads();  // both stages free for sweep 2
  }

  // -- sweep 2: the tiles in reverse ---------------------------------------
  float Gin = 0.0f;  // G handed to this tile's last step by the next tile
  float lam_sum = 0.0f;
  load_tile(trips - 1, 0, 4);
  for (int kk = 0; kk < trips; ++kk) {
    const int k = trips - 1 - kk;
    scan::cp_async_wait_all();
    __syncthreads();  // tile k landed; the other stage is stored and free
    if (k > 0) load_tile(k - 1, (kk + 1) & 1, 4);
    T* ptr[4];
    segment(k, kk & 1, ptr, 4);
    // the forward again from the tile's start state: a_t and h_{t-1}
    float av[L], hp[L], A, H, h;
    compose(ptr, av, A, H);
    join_up(A, H, k == 0 ? 0.0f : hc[static_cast<size_t>(k) * W], h);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float at = av[j];
      float gain;
      asm("sqrt.approx.f32 %0, %1;" : "=f"(gain) : "f"(fmaxf(fmaf(-at, at, 1.0f), 1e-12f)));
      hp[j] = h;
      h = fmaf(at, h, gain * (scan::to_f32(ptr[2][j * bw]) * scan::to_f32(ptr[0][j * bw])));
    }
    // the segment's map of G, from its last step to its first
    float Ar = 1.0f, Hr = 0.0f;
#pragma unroll
    for (int j = L - 1; j >= 0; --j) {
      Hr = av[j] * (Hr + scan::to_f32(ptr[3][j * bw]));
      Ar *= av[j];
    }
    // inclusive scan down the lanes: lane p's map then covers segments p..
    for (int off = 1; off < split; off <<= 1) {
      const float Ad = __shfl_down_sync(full, Ar, off, split);
      const float Hd = __shfl_down_sync(full, Hr, off, split);
      if (p + off < split) {
        Hr = fmaf(Ar, Hd, Hr);
        Ar *= Ad;
      }
    }
    float Ae = __shfl_down_sync(full, Ar, 1, split);
    float He = __shfl_down_sync(full, Hr, 1, split);
    if (p == split - 1) {
      Ae = 1.0f;
      He = 0.0f;
    }
    const float A0 = __shfl_sync(full, Ar, 0, split);
    const float H0 = __shfl_sync(full, Hr, 0, split);
    float Gc = fmaf(Ae, Gin, He);  // entering this segment's last step
    Gin = fmaf(A0, Gin, H0);       // for the previous tile
    // the segment backward: the gradients over x, r and i
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
    __syncthreads();  // the gradient tiles are complete
    unsigned char* base = smem + (kk & 1) * 4 * tile;
    const size_t g0 = ((row0 + static_cast<size_t>(k) * ck) * W + w0) * elt;
    const int n = rows_of(k);
    for (int t = t_first, v = u_first; t < n;) {
      const int u = v * G;
      const int off = row_off(t) + u;
      const size_t gofs = g0 + t * stride + u;
#pragma unroll
      for (int q = 0; q < 3; ++q) scan::store_piece(dst[q] + gofs, base + q * tile + off, G);
      t += t_step;
      v += u_step;
      if (v >= row_pieces) {
        v -= row_pieces;
        ++t;
      }
    }
  }
  // dlam of this batch row: over the channel's lanes, in a fixed order
  for (int off = split / 2; off >= 1; off >>= 1) {
    lam_sum += __shfl_xor_sync(full, lam_sum, off, split);
  }
  if (p == 0) {
    a.part[static_cast<size_t>(b) * W + w0 + c] = kCFactor * lam_sum / (1.0f + expf(lam));
  }
}

// dlam over the batch rows, added in order.
__global__ void rglru_bwd_reduce(const BwdArgs a) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= a.W) return;
  float v = 0.0f;
  for (int b = 0; b < a.B; ++b) v += a.part[static_cast<size_t>(b) * a.W + w];
  a.dlam[w] = v;
}

template <typename T, int L>
int launch(BwdArgs a, cudaStream_t stream) {
  const int elt = static_cast<int>(sizeof(T));
  const long long smem = smem_bytes(a.block_w, L, a.split, elt);
  cudaError_t err = cudaFuncSetAttribute(
      rglru_bwd_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto addr = [](const void* p) { return reinterpret_cast<unsigned long long>(p); };
  a.pad = seg_pad(a.block_w, L, a.split, elt);
  a.g = scan::copy_bytes(elt, {1ULL * a.block_w * elt, 1ULL * a.pad * elt, 1ULL * a.W * elt,
                               addr(a.x), addr(a.r), addr(a.i), addr(a.dy), addr(a.dx),
                               addr(a.dr), addr(a.di)});
  const unsigned grid = static_cast<unsigned>(a.B * (a.W / a.block_w));
  rglru_bwd_kernel<T, L><<<grid, a.block_w * a.split, static_cast<size_t>(smem), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rglru_bwd_reduce<<<(a.W + 255) / 256, 256, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_len(const BwdArgs& a, int L, cudaStream_t s) {
  switch (L) {
    case 4: return launch<T, 4>(a, s);
    case 8: return launch<T, 8>(a, s);
    case 16: return launch<T, 16>(a, s);
    case 32: return launch<T, 32>(a, s);
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

// Bytes of the float32 scratch one call takes: the tile-start states and
// dlam's per batch row.
extern "C" long long rglru_scan_bwd_scratch_bytes(int B, int S, int W, int chunk) {
  return 4 * scratch_floats(B, S, W, chunk);
}

// x, r, i, dy, dx, dr, di: (B, S, W) elements of elt bytes (4: float32, 2:
// bf16); lam, dlam: (W,) float32; scratch of rglru_scan_bwd_scratch_bytes.
// The forward's tiles: any S >= 1 and chunk >= 1, split a power of two up to
// 32 with ceil(chunk / split) <= 32, block_w dividing W, block_w * split at
// most max_threads of its segment (512; 256 at 32 steps).  Returns the
// launches' cudaGetLastError() code (cudaErrorInvalidValue for tiles the
// kernel does not take).
extern "C" int rglru_scan_bwd_launch(
    const void* x, const void* r, const void* i, const void* lam, const void* dy, void* dx,
    void* dr, void* di, void* dlam, void* scratch, int B, int S, int W, int block_w, int chunk,
    int split, int elt, void* stream) {
  const long long threads = 1LL * block_w * split;
  if (B < 1 || S < 1 || block_w < 1 || split < 1 || split > 32 || (split & (split - 1)) ||
      chunk < 1 || seg_len(chunk, split) == 0 || W % block_w ||
      threads > max_threads(seg_len(chunk, split)) ||
      (elt != 4 && elt != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  a.hc = static_cast<float*>(scratch);
  a.part = a.hc + (1LL * B * ((S + chunk - 1) / chunk) * W + 3) / 4 * 4;
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
  return elt == 4 ? launch_len<float>(a, L, s) : launch_len<__nv_bfloat16>(a, L, s);
}
