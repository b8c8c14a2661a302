// RG-LRU recurrence (recurrentgemma's real-gated linear recurrent unit) on
// float32 or bf16 (B, S, W) inputs, for Hopper.
//
// Replaces: src/repro/kernels/rglru_scan/rglru_scan.py, _rglru_kernel
// (launched by rglru_scan through pl.pallas_call).
//
//   a_t = exp(-8 r_t softplus(-lam))
//   h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) (i_t x_t),   y_t = h_t
//
// x, r, i and y share one element type, float32 or bf16 (y takes x's, as
// in the JAX kernel); lam (W,) is float32, and so are the state and all
// arithmetic.
//
// What bounds it: on paper, memory (about 12 operations against 16 bytes
// per element in float32: three loads and one store; 8 in bf16).  A thread
// that carries one channel through the whole sequence makes it latency
// instead: at recurrentgemma-2b width there are only B*W = 2560 channels,
// too few chains of S dependent steps to hide a step's latency.  Split as
// below, the measured time on an H100 is under 2x the float32 byte bound;
// what is left is each tile's fixed cost (the wait, two barriers, the
// store) and the instruction throughput of the SMs that hold two CTAs.
//
// Design.  The recurrence is linear in h, so a run of steps composes into
// one map h -> A h + H, and maps compose as (A1, H1) then (A2, H2) =
// (A1 A2, A2 H1 + H2).  A CTA owns block_w channels and `split` threads a
// channel (consecutive lanes, split <= 32), and loops over the sequence in
// tiles of `chunk` steps, staged with cp.async into one of two
// shared-memory stages so the loads of tile k + 1 fly while tile k is
// scanned.  Per tile, thread p of a channel takes the L steps
// [p L, p L + L), L being the least compiled segment (4, 8, 16, 32) with
// L split >= chunk:
//   A. it computes a_t and b_t = sqrt(max(1 - a_t^2, 1e-12)) i_t x_t, keeps
//      them in registers (L is a compile-time 4..32), and composes its
//      segment's (A, H) from h = 0;
//   B. an exclusive Kogge-Stone scan of (A, H) over the split lanes
//      (__shfl_up_sync, log2(split) combines) gives each segment its map
//      from the tile's start, applied to the carry from the previous tile;
//   C. it reruns h = fma(a_t, h, b_t) from its start state and writes y_t
//      over x_t in shared memory; the last lane's end state is the next
//      tile's carry.
// The tile is then stored with neighbouring threads on neighbouring
// addresses.  A tile that ends short of L split steps (a chunk that is no
// multiple of L, or the last tile of a sequence that is no multiple of
// chunk) has its missing steps' x, r and i set to 0 in shared memory, each
// thread its own, which makes them the identity map (a = 1, b = 0), and
// stores none of them.  So
// any S runs, and so does any CTA of block_w split threads: a warp the CTA
// does not fill shuffles among its own lanes.  x, r and i are read once and y written once; the dependent
// chain of a CTA is about 2 S / split + (S / chunk) log2(split) steps
// instead of S.  Each staged row holds block_w elements at a row stride of
// W; every L rows (one thread's segment) the layout skips `pad` elements,
// chosen so the lanes of a warp, which read rows p L + j of neighbouring
// columns, fall on distinct banks.  softplus(-lam) is computed once per
// channel as logaddexp(-lam, 0) with no threshold (jax.nn.softplus); the
// step's exp and square root are the SFU's ex2.approx and sqrt.approx, and
// the tile walks without integer division (both cut the time by 10-17%).
#include "scan_staging.cuh"

namespace {

constexpr float kCFactor = 8.0f;
constexpr int kMaxThreads = 512;  // launch bound: 128 registers a thread

struct RgArgs {
  const void* x;
  const void* r;
  const void* i;
  const float* lam;
  void* y;
  int S, W, block_w, chunk, split, pad, g;  // g: staging piece size in bytes
};

// log(1 + exp(v)) as logaddexp(v, 0): max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

// Elements skipped after each segment of L rows, so that a segment's
// stride in 32-bit words is congruent, mod the 32 banks, to the words one
// segment's lanes read in a step (the warp's 32 / split neighbouring
// channels); lanes p and p' then never share a bank.
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

// Two stages of x, r and i tiles.
long long smem_bytes(int block_w, int L, int split, int elt) {
  return 2 * 3 * tile_bytes(block_w, L, split, elt);
}

// The least compiled segment of at least ceil(chunk / split) steps, or 0.
int seg_len(int chunk, int split) {
  const int need = (chunk + split - 1) / split;
  for (int L = 4; L <= 32; L *= 2) {
    if (need <= L) return L;
  }
  return 0;
}

template <typename T, int L>
__global__ void __launch_bounds__(kMaxThreads) rglru_kernel(const RgArgs a) {
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
  const float k2 = -kCFactor * softplus(-a.lam[w0 + c]) * scan::kLog2e;
  const size_t row0 = static_cast<size_t>(b) * a.S;
  const size_t stride = static_cast<size_t>(W) * elt;  // bytes between rows
  const int G = a.g, row_pieces = bw * elt / G;
  const char* src[3] = {static_cast<const char*>(a.x), static_cast<const char*>(a.r),
                        static_cast<const char*>(a.i)};
  char* y = static_cast<char*>(a.y);

  // this thread's first piece of a tile, and the step to its next one
  const int t_first = tid / row_pieces, u_first = tid - t_first * row_pieces;
  const int t_step = nthreads / row_pieces, u_step = nthreads - t_step * row_pieces;

  // byte offset in a tile of row t (of the tile's chunk rows)
  auto row_off = [&](int t) { return ((t / L) * seg + (t % L) * bw) * elt; };

  // the rows of tile k inside the sequence
  auto rows_of = [&](int k) { return min(ck, a.S - k * ck); };

  auto load_tile = [&](int k, int s) {
    unsigned char* base = smem + s * 3 * tile;
    const size_t g0 = ((row0 + static_cast<size_t>(k) * ck) * W + w0) * elt;
    const int n = rows_of(k);
    for (int t = t_first, v = u_first; t < n;) {
      const int u = v * G;
      const int off = row_off(t) + u;
      const size_t g = g0 + t * stride + u;
#pragma unroll
      for (int q = 0; q < 3; ++q) scan::copy_piece(base + q * tile + off, src[q] + g, G);
      t += t_step;
      v += u_step;
      if (v >= row_pieces) {
        v -= row_pieces;
        ++t;
      }
    }
    scan::cp_async_commit();
  };

  const int trips = (a.S + ck - 1) / ck;
  // the lanes of this thread's warp that the CTA holds (split divides 32,
  // so a channel's lanes are all in or all out)
  const int warp_lanes = min(32, nthreads - (tid & ~31));
  const unsigned full = warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1u;
  float carry = 0.0f;
  load_tile(0, 0);
  for (int k = 0; k < trips; ++k) {
    scan::cp_async_wait_all();
    __syncthreads();  // tile k landed for all; tile k - 1's stage is stored
    if (k + 1 < trips) load_tile(k + 1, (k + 1) & 1);
    unsigned char* base = smem + (k & 1) * 3 * tile;
    T* sx = reinterpret_cast<T*>(base) + p * seg + c;
    T* sr = reinterpret_cast<T*>(base + tile) + p * seg + c;
    T* si = reinterpret_cast<T*>(base + 2 * tile) + p * seg + c;
    const int n = rows_of(k);
    if (n < L * split) {  // a short tile: this thread's steps past its end read as 0
      for (int j = max(n - p * L, 0); j < L; ++j) {
        sx[j * bw] = sr[j * bw] = si[j * bw] = scan::from_f32<T>(0.0f);
      }
    }

    // A: this segment's a_t, b_t and its map (A, H) from h = 0
    float av[L], bv[L];
    float A = 1.0f, H = 0.0f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float at = scan::ex2(scan::to_f32(sr[j * bw]) * k2);
      float gain;
      asm("sqrt.approx.f32 %0, %1;" : "=f"(gain) : "f"(fmaxf(fmaf(-at, at, 1.0f), 1e-12f)));
      av[j] = at;
      bv[j] = gain * (scan::to_f32(si[j * bw]) * scan::to_f32(sx[j * bw]));
      H = fmaf(at, H, bv[j]);
      A *= at;
    }
    // B: inclusive scan of the maps over the channel's lanes, then each
    // lane's start state from the previous lane's prefix and the carry
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
    float h = fmaf(Ae, carry, He);
    carry = fmaf(Al, carry, Hl);
    // C: rerun the segment from its start state; y_t over x_t
#pragma unroll
    for (int j = 0; j < L; ++j) {
      h = fmaf(av[j], h, bv[j]);
      sx[j * bw] = scan::from_f32<T>(h);
    }
    __syncthreads();  // the y tile is complete
    const size_t g0 = ((row0 + static_cast<size_t>(k) * ck) * W + w0) * elt;
    for (int t = t_first, v = u_first; t < n;) {
      const int u = v * G;
      scan::store_piece(y + g0 + t * stride + u, base + row_off(t) + u, G);
      t += t_step;
      v += u_step;
      if (v >= row_pieces) {
        v -= row_pieces;
        ++t;
      }
    }
  }
}

template <typename T, int L>
int launch(RgArgs a, int B, cudaStream_t stream) {
  const int elt = static_cast<int>(sizeof(T));
  const long long smem = smem_bytes(a.block_w, L, a.split, elt);
  cudaError_t err = cudaFuncSetAttribute(
      rglru_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto addr = [](const void* p) { return reinterpret_cast<unsigned long long>(p); };
  a.pad = seg_pad(a.block_w, L, a.split, elt);
  a.g = scan::copy_bytes(elt, {1ULL * a.block_w * elt, 1ULL * a.pad * elt, 1ULL * a.W * elt,
                               addr(a.x), addr(a.r), addr(a.i), addr(a.y)});
  const unsigned grid = static_cast<unsigned>(B * (a.W / a.block_w));
  rglru_kernel<T, L><<<grid, a.block_w * a.split, static_cast<size_t>(smem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_len(const RgArgs& a, int B, int L, cudaStream_t s) {
  switch (L) {
    case 4: return launch<T, 4>(a, B, s);
    case 8: return launch<T, 8>(a, B, s);
    case 16: return launch<T, 16>(a, B, s);
    case 32: return launch<T, 32>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The dynamic shared memory one CTA of (block_w, chunk, split) takes at an
// element size of elt bytes (-1 for a chunk / split the kernel does not take).
extern "C" long long rglru_scan_smem_bytes(int block_w, int chunk, int split, int elt) {
  const int L = split < 1 || chunk < 1 ? 0 : seg_len(chunk, split);
  return L ? smem_bytes(block_w, L, split, elt) : -1;
}

// x, r, i, y: (B, S, W) elements of elt bytes (4: float32, 2: bf16); lam:
// (W,) float32.  Any S >= 1 and chunk >= 1; split is a power of two up to
// 32 with ceil(chunk / split) <= 32, block_w divides W, and block_w * split
// is at most 512.  Returns the launch's cudaGetLastError() code
// (cudaErrorInvalidValue for tiles the kernel does not take).
extern "C" int rglru_scan_launch(
    const void* x, const void* r, const void* i, const void* lam, void* y,
    int B, int S, int W, int block_w, int chunk, int split, int elt, void* stream) {
  const long long threads = 1LL * block_w * split;
  if (B < 1 || S < 1 || block_w < 1 || split < 1 || split > 32 || (split & (split - 1)) ||
      chunk < 1 || seg_len(chunk, split) == 0 || W % block_w || threads > kMaxThreads ||
      (elt != 4 && elt != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RgArgs a;
  a.x = x;
  a.r = r;
  a.i = i;
  a.lam = static_cast<const float*>(lam);
  a.y = y;
  a.S = S;
  a.W = W;
  a.block_w = block_w;
  a.chunk = chunk;
  a.split = split;
  a.pad = 0;
  a.g = elt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = seg_len(chunk, split);
  return elt == 4 ? launch_len<float>(a, B, L, s) : launch_len<__nv_bfloat16>(a, B, L, s);
}
