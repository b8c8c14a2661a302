// Causal GQA flash attention, backward, bf16, on Hopper's tensor cores:
// dq, dk, dv from q, k, v, o, lse and do, at tile head dims 16..256.
//
// Replaces: src/repro/models/attention.py, _flash_bwd (:260), the custom
// VJP of flash_attention_xla (:346) that XLA compiles; it has no Pallas
// site.  Every bf16 call runs here; float32 runs on flash_attention_bwd.cuh
// (mma.sync, 3xTF32).
//
// q, o, do, dq (B,S,H,hd), k, v, dk, dv (B,S,KV,hd) bf16, lse float32
// (B,H,S) (the forward's residual m + log l); KV head = h / G, G = H/KV.
// hd is a run-time multiple of 8 up to 256, run on the least tile head dim
// HD in {16, 32, 64, 128, 256} at or above it; TMA fills the tile's columns past
// hd with zeros (the forward's rule), which add nothing to any product, and
// they are never stored.
//
// What bounds it: operations.  The causal backward is five products of half
// the S x S square (S = Q.K^T and dP = dO.V^T recomputed, dV += P^T.dO,
// dQ += dS.K, dK += dS^T.Q): at tinyllama width (S=4096, H=32, hd=64) ~86
// GFLOP a batch row against ~100 MB, ~850 flops a byte, past the bf16
// tensor-core ridge.  So every product is a wgmma, and every tile streams in
// by TMA while the previous one computes.
//
// Design.  Three passes and a reduce, no atomics, so each sum runs in one
// fixed order and the result is the same bit for bit from run to run (the
// training restart drill rests on it).  FlashAttention-3's single pass adds
// dQ across CTAs with float32 atomics, whose order changes from run to run;
// the price here is S and dP computed twice, 7 products where 5 would do.
//  1. delta = rowsum(do * o), float32 (B, H, S): 16-byte loads, a row's
//     pieces summed over its lanes.
//  2. dq: one CTA per (q block, head, batch), q blocks in reverse (the
//     longest causal walks first), one consumer warpgroup per 64 rows
//     (block_q 64 or 128).  Q and dO are loaded once by TMA; K and V blocks
//     of block_kv rows go through a 2-stage ring, one mbarrier a stage,
//     thread 0 issuing block j+1's loads before the warpgroups compute on
//     block j (the forward's ring).  S = Q.K^T and dP = dO.V^T are
//     Wgmma<block_kv>::ss, both operands K-major, each in a commit group
//     of its own; P = exp2(S scale log2e - lse log2e) (ex2.approx.ftz) is
//     formed in the accumulator registers while the tensor cores compute
//     dP, then dS = P (dP scale - delta scale); dS is packed in place to
//     bf16 A fragments, and dQ += dS.K is Wgmma<64 or HD>::rs reading K
//     MN-major from the same shared tile that S read K-major (as the
//     forward reads V for P.V).
//  3. dk, dv: one CTA per (KV block, KV head x kv_split, batch), one
//     consumer warpgroup per 64 keys (block_kv 64 or 128) below HD 256.  K and V are
//     loaded once; the CTA walks G / kv_split consecutive query heads of
//     its group, in order, and for each the q blocks at or below the
//     diagonal; Q and dO of each (head, q block) go through the ring.
//     S^T = K.Q^T and dP^T = V.dO^T are ss; P^T and dS^T are packed to A
//     fragments; dV += P^T.dO and dK += dS^T.Q are rs with dO and Q
//     MN-major.  Four commit groups a trip: P^T is formed while dP^T
//     computes, dS^T while dV does.  lse and delta rows are not a TMA tensor (S * 4 bytes need
//     not be a multiple of 16): every thread loads its share of the next
//     block's with plain loads issued at the top of a trip, as inline asm
//     that stays ahead of the trip's wgmma, and stores them to the stage
//     after the trip's products.
//     At HD 256 a warpgroup's dK and dV of 64 keys would be 256 floats a
//     thread before S^T and dP^T, so two warpgroups (kColGroups) share the
//     CTA's 64 keys (block_q = block_kv = 64): warpgroup c computes S^T and
//     dP^T for q rows 32c .. 32c + 31 of the trip (N = 32, K = 256; each
//     product once, no column chunk recomputes one), forms its P^T and
//     dS^T and stores them as bf16 into two staged 64 x 64 tiles, swizzled
//     as TMA's 128-byte mode lays a box (stage_a); a proxy fence and the
//     CTA barrier later, each warpgroup runs dV += P^T.dO and dK += dS^T.Q
//     as ss products (A K-major from the staged tile, B MN-major) on its two
//     boxes of 64 columns, so it holds 64 + 64 floats of dK and dV and 16 +
//     16 of S^T and dP^T.  Shared memory: K and V once (64 KB), two Q/dO
//     stages (128 KB), the staged tiles (16 KB), 210 KB in all.  The dq
//     pass needs no change there: one warpgroup, S, dP (32 floats each at
//     block_kv 64) and dQ (128), Q and dO once and two K/V stages, 193 KB.
//  4. kv_split (a tunable, any divisor of G): at 1 the dk/dv pass
//     stores bf16 dk and dv.  Above 1, split s of a group walks query heads
//     s G/kv_split ... (s+1) G/kv_split - 1 and stores float32 partials
//     into scratch (kv_split, B, S, KV, hd), dk's then dv's; the reduce pass
//     sums them in split order and rounds once.  With one CTA walking all
//     of G, B=1 has too few CTAs and its first key block carries 4x the
//     average walk; the split spreads the group over G/kv_split times the
//     CTAs, at the price of the partials' bytes.  Any divisor: a group of
//     10 (recurrentgemma-2b) splits into 1, 2, 5 or 10.
//
// Rounding, as the JAX _flash_bwd: P is
// rounded to bf16 before P^T.dO, dS before dS.K and dS^T.Q; S and dP stay
// float32; each gradient is accumulated in float32 and rounded once when
// stored.
//
// Registers: a thread of the dk/dv pass holds S^T and dP^T (block_q / 2
// floats each) and dK and dV (HD / 2 each); at HD 128 and block_q 64 that
// is 192 floats of 255, and ptxas keeps them without spilling, so no
// column split or producer warp is needed there; block_q 128 at HD 128
// (256 floats) is not instantiated, and the dq pass's block_kv 128 at HD
// 128 (S, dP and dQ: 192) is.  At HD 256 see note 3.  The C entries refuse
// any tile that is not instantiated.
//
// The hardware rules (descriptors, fences, tensor maps, GQA strides,
// barrier phases) are the forward's, set out in flash_attention_sm90.cu's
// notes 1-5.  Here as there: a warpgroup skips blocks wholly outside its
// causal range, but one warpgroup of each CTA never skips (the dq pass's
// last, the dk/dv pass's first), so every phase is waited on before its
// stage is armed again.
#include <cfloat>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;
constexpr int kAlign = 1024;       // swizzled tiles start on 1024 B
constexpr int kBarrierBytes = 64;  // the once-loaded tiles' barrier and one a stage

// The passes a launch runs (a bit each): the wrapper runs all of them; a
// timing of one pass runs it alone on the buffers a full call left.
constexpr int kPassDelta = 1, kPassDq = 2, kPassDkv = 4, kPassReduce = 8;

template <int HD, int BQ, int BKV> struct Tile {
  static constexpr int kBoxCols = HD < 64 ? HD : 64;  // columns of one TMA box
  static constexpr int kBoxes = HD / kBoxCols;        // 2 at HD 128, 4 at 256
  static constexpr int kRowBytes = 2 * kBoxCols;      // the swizzle span
  static constexpr int kQBytes = 2 * BQ * HD;         // one Q or dO tile
  static constexpr int kKVBytes = 2 * BKV * HD;       // one K or V tile
  // dq pass: Q and dO once, K and V through the ring
  static constexpr int kDqThreads = 128 * (BQ / 64);
  static constexpr long long kDqSmem =
      kAlign + 2 * kQBytes + kStages * 2 * kKVBytes + kBarrierBytes;
  // dk/dv pass: K and V once, Q and dO through the ring, and each stage's
  // lse (log2 domain) and delta (times the scale) rows, float32.  At HD 256
  // two warpgroups share each 64 keys (kColGroups, note 3), and P^T and
  // dS^T of a trip are staged as bf16 (64 keys x BQ each)
  static constexpr int kColGroups = HD == 256 ? 2 : 1;
  static constexpr int kDkvThreads = 128 * (BKV / 64) * kColGroups;
  static constexpr int kStatBytes = 2 * BQ * 4;
  static constexpr int kStagedBytes = kColGroups > 1 ? 2 * 2 * BKV * BQ : 0;
  static constexpr long long kDkvSmem = kAlign + 2 * kKVBytes +
                                        kStages * (2 * kQBytes + kStatBytes) + kStagedBytes +
                                        kBarrierBytes;
  static constexpr long long kSmem = kDqSmem > kDkvSmem ? kDqSmem : kDkvSmem;
};

// 2^x on the SFU, a result below 2^-126 flushed to zero (such a P adds
// nothing a float32 sum keeps); exp2f's handling of those results costs
// instructions on every element.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A float load that stays where it is written: volatile asm keeps its order
// against the wgmma (also volatile), so it is in flight during them.
__device__ __forceinline__ float load_early(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// delta[b, h, s] = sum over hd of do * o, float32.  A (b, s, h) row of hd
// (a multiple of 8, at most 256) is P = the power of two at or above hd / 8
// lanes, each taking 8 elements of o and of do in one 16-byte load; the
// row's sum is reduced over its P lanes (a whole warp at hd 256).
__global__ void __launch_bounds__(256) flash_bwd_delta_sm90(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    float* __restrict__ delta, int rows, int S, int H, int hd, int lanes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = t / lanes, piece = t % lanes;
  float acc = 0.f;
  if (row < rows && 8 * piece < hd) {
    const size_t at = static_cast<size_t>(row) * hd + 8 * piece;
    const uint4 x = *reinterpret_cast<const uint4*>(o + at);
    const uint4 y = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(xa[i]);
      const float2 c = __bfloat1622float2(ya[i]);
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
    }
  }
  for (int off = lanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && piece == 0) {
    const int b = row / (S * H), s = (row / H) % S, h = row % H;
    delta[(static_cast<size_t>(b) * H + h) * S + s] = acc;
  }
}

// P in s from S in s, for the dq pass: a thread's rows row, row + 8 (lse2
// in the log2 domain), its columns key0 + 8c + {0, 1}; Mask: P = 0 above
// the diagonal and at keys past S.
template <int BKV, bool Mask>
__device__ __forceinline__ void dq_probs(float (&s)[BKV / 2], const float (&lse2)[2],
                                         float scale_log2, int key0, int row, int S) {
#pragma unroll
  for (int c = 0; c < BKV / 8; ++c) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * c + 2 * i + e;
        float p = exp2_ftz(fmaf(s[x], scale_log2, -lse2[i]));
        if (Mask) {
          const int key = key0 + 8 * c + e;
          if (key >= S || key > row + 8 * i) p = 0.f;
        }
        s[x] = p;
      }
    }
  }
}

// P^T in st from S^T in st, for the dk/dv pass: a thread's rows are keys
// key, key + 8, its columns the q rows q0 + 8c + col + {0, 1}, whose lse
// (log2 domain) is read from the stage; Mask: P = 0 where the q row is
// above the key or past S.
template <int BQ, bool Mask>
__device__ __forceinline__ void dkv_probs(float (&st)[BQ / 2], const float* lse2,
                                          float scale_log2, int q0, int col, int key, int S) {
#pragma unroll
  for (int c = 0; c < BQ / 8; ++c) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * c + col);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * c + 2 * i + e;
        float p = exp2_ftz(fmaf(st[x], scale_log2, -(e ? l.y : l.x)));
        if (Mask) {
          const int r = q0 + 8 * c + col + e;
          if (r >= S || r < key + 8 * i) p = 0.f;
        }
        st[x] = p;
      }
    }
  }
}

// dS = P (dP - delta) scale = P (dP scale - delta scale) in dp, the scaled
// delta of a thread's accumulator element x given by sdelta(x).
template <int N, typename Delta>
__device__ __forceinline__ void scores(float (&dp)[N / 2], const float (&p)[N / 2],
                                       float scale, Delta sdelta) {
#pragma unroll
  for (int x = 0; x < N / 2; ++x) dp[x] = p[x] * fmaf(dp[x], scale, -sdelta(x));
}

// 16 columns of an accumulator of N columns are one bf16 A fragment.
template <int N>
__device__ __forceinline__ void pack(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
  }
}

// A warpgroup's 64 x N accumulator (rows row, row + 8; columns 8c + col +
// {0, 1}) as bf16 into columns c0 .. c0 + N - 1 of a 64 x 64 tile of 128-byte
// rows at `tile` (1024-aligned), swizzled as TMA's 128-byte mode lays a box
// (the 16-byte piece of a row XOR the row mod 8), so that wgmma reads it as
// a K-major operand A.  A warp's 4-byte stores fall on 32 distinct banks.
template <int N>
__device__ __forceinline__ void stage_a(uint32_t tile, const float (&d)[N / 2], int c0, int row,
                                        int col) {
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      const int byte = 2 * (c0 + 8 * c + col);
      st_shared_u32(tile + r * 128 + (byte ^ ((r & 7) << 4)),
                    pack_bf16(d[4 * c + 2 * i], d[4 * c + 2 * i + 1]));
    }
  }
}

// D (64 x N) = A.B^T over HD, A (64 rows at `a`) and B (N rows at `b`)
// K-major tiles of HD columns stored as boxes of BoxCols side by side
// (a box of A spans a_rows rows, of B b_rows).
template <int HD, int N, int BoxCols>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a, int a_rows, uint32_t b,
                                           int b_rows) {
  constexpr int kRowBytes = 2 * BoxCols;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int x = kk * 16 / BoxCols;
    const int cb = 2 * (kk * 16 % BoxCols);
    Wgmma<N>::ss(d, smem_desc(a + x * a_rows * kRowBytes + cb, kRowBytes),
                 smem_desc(b + x * b_rows * kRowBytes + cb, kRowBytes), kk > 0);
  }
}

// acc (64 x HD, boxes of BoxCols) += A.B, A the K / 16 bf16 fragments in
// registers, B a tile of K rows and HD columns at `b`, MN-major.
template <int K, int Boxes, int BoxCols>
__device__ __forceinline__ void product_rs(float (&acc)[Boxes][BoxCols / 2],
                                           const uint32_t (&a)[K / 16][4], uint32_t b) {
  constexpr int kRowBytes = 2 * BoxCols;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < Boxes; ++x) {
      Wgmma<BoxCols>::rs(acc[x], a[kk], smem_desc(b + x * K * kRowBytes + 16 * kk * kRowBytes,
                                                  kRowBytes));
    }
  }
}

// acc (64 x Boxes boxes of 64 columns) += A.B, A a 64 x K bf16 tile staged
// at `a` (K = 64: one box of 128-byte rows, K-major), B the K rows of Boxes
// boxes at `b`, boxes b_box bytes apart, MN-major.
template <int K, int Boxes>
__device__ __forceinline__ void product_ss_mn(float (&acc)[Boxes][32], uint32_t a, uint32_t b,
                                              int b_box) {
  static_assert(K == 64, "the staged operand is one box of 64 columns");
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < Boxes; ++x) {
      Wgmma<64>::ss_mn(acc[x], smem_desc(a + 32 * kk, 128),
                       smem_desc(b + x * b_box + 16 * kk * 128, 128));
    }
  }
}

// Row i (0: the thread's first row, 1: the row 8 below) of an accumulator
// to `out` (the row's column 0 plus this thread's col): bf16 pairs, or
// float32 pairs where Out is float; columns at or past hd are not stored.
template <typename Out, int Boxes, int BoxCols>
__device__ __forceinline__ void store_row(Out* out, const float (&acc)[Boxes][BoxCols / 2], int i,
                                          int col, int hd) {
#pragma unroll
  for (int x = 0; x < Boxes; ++x) {
#pragma unroll
    for (int c = 0; c < BoxCols / 8; ++c) {
      const int at = x * BoxCols + 8 * c + col;
      if (at >= hd) continue;
      const float lo = acc[x][4 * c + 2 * i], hi = acc[x][4 * c + 2 * i + 1];
      if constexpr (sizeof(Out) == 4) {
        *reinterpret_cast<float2*>(out + at) = make_float2(lo, hi);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(lo, hi);
      }
    }
  }
}

template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(Tile<HD, BQ, BKV>::kDqThreads, 1) flash_bwd_dq_sm90(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int S, int H, int KV, int hd, float scale) {
  using T = Tile<HD, BQ, BKV>;
  constexpr int RB = T::kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t do_s = q_s + T::kQBytes;
  const uint32_t ring = do_s + T::kQBytes;                  // stage s: K, then V
  const uint32_t bar = ring + kStages * 2 * T::kKVBytes;    // Q and dO, then one a stage

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int nkv = (min(S, q0 + BQ) + BKV - 1) / BKV;
  const int tid = threadIdx.x;

  auto load_kv = [&](int j) {  // thread 0 only
    const uint32_t stage = ring + (j % kStages) * 2 * T::kKVBytes;
    const uint32_t full = bar + 8 * (1 + j % kStages);
    mbar_expect_tx(full, 2 * T::kKVBytes);
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) {
      const uint32_t off = x * BKV * RB;
      tma_load_4d(stage + off, &kmap, full, x * T::kBoxCols, kvh, j * BKV, b);
      tma_load_4d(stage + T::kKVBytes + off, &vmap, full, x * T::kBoxCols, kvh, j * BKV, b);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(bar + 8 * i, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, 2 * T::kQBytes);
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) {
      tma_load_4d(q_s + x * BQ * RB, &qmap, bar, x * T::kBoxCols, h, q0, b);
      tma_load_4d(do_s + x * BQ * RB, &dmap, bar, x * T::kBoxCols, h, q0, b);
    }
    load_kv(0);
  }
  __syncthreads();  // the barriers are initialised before anyone waits

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg;                // this warpgroup's first row
  const int row = row0 + 16 * warp + lane / 4;  // this thread's rows: row, row + 8
  const int col = 2 * (lane % 4);               // and columns 8c + col + {0, 1}
  const uint32_t q_wg = q_s + 64 * wg * RB;
  const uint32_t do_wg = do_s + 64 * wg * RB;
  const size_t lrow = (static_cast<size_t>(b) * H + h) * S;
  float lse2[2], dl[2];  // lse in the log2 domain, delta times scale
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    lse2[i] = r < S ? lse[lrow + r] * kLog2e : 0.f;
    dl[i] = r < S ? delta[lrow + r] * scale : 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  float acc[T::kBoxes][T::kBoxCols / 2];
#pragma unroll
  for (int x = 0; x < T::kBoxes; ++x) {
#pragma unroll
    for (int i = 0; i < T::kBoxCols / 2; ++i) acc[x][i] = 0.0f;
  }
  mbar_wait(bar, 0);

  for (int j = 0; j < nkv; ++j) {
    if (j > 0) __syncthreads();  // every warpgroup is done with block j - 1's stage
    if (tid == 0 && j + 1 < nkv) load_kv(j + 1);
    __syncwarp();
    const int k0 = j * BKV;
    if (k0 > row0 + 63) continue;  // wholly above this warpgroup's diagonal
    const uint32_t k_s = ring + (j % kStages) * 2 * T::kKVBytes;
    const uint32_t v_s = k_s + T::kKVBytes;
    mbar_wait(bar + 8 * (1 + j % kStages), (j / kStages) & 1);

    // S = Q.K^T and dP = dO.V^T, f32, 64 x BKV each a warpgroup, in two
    // groups: P is formed from S while the tensor cores compute dP
    float s[BKV / 2], dp[BKV / 2];
    wgmma_fence();
    product_ss<HD, BKV, T::kBoxCols>(s, q_wg, BQ, k_s, BKV);
    wgmma_commit();
    product_ss<HD, BKV, T::kBoxCols>(dp, do_wg, BQ, v_s, BKV);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    if ((k0 + BKV - 1 > row0) || k0 + BKV > S) {
      dq_probs<BKV, true>(s, lse2, scale_log2, k0 + col, row, S);
    } else {
      dq_probs<BKV, false>(s, lse2, scale_log2, k0 + col, row, S);
    }
    wgmma_wait<0>();
    fence_regs(dp);
    scores<BKV>(dp, s, scale, [&](int x) { return dl[(x / 2) % 2]; });
    uint32_t ds[BKV / 16][4];
    pack<BKV>(ds, dp);

    // dQ += dS.K, K read MN-major from the tile S read K-major
    wgmma_fence();
    product_rs<BKV, T::kBoxes, T::kBoxCols>(acc, ds, k_s);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) fence_regs(acc[x]);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(ds[kk]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= S) continue;
    store_row<__nv_bfloat16, T::kBoxes, T::kBoxCols>(
        dq + ((static_cast<size_t>(b) * S + r) * H + h) * hd, acc, i, col, hd);
  }
}

template <int HD, int BQ, int BKV, bool kSplit>
__global__ void __launch_bounds__(Tile<HD, BQ, BKV>::kDkvThreads, 1) flash_bwd_dkv_sm90(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
    int B, int S, int H, int KV, int hd, int kv_split, float scale) {
  using T = Tile<HD, BQ, BKV>;
  constexpr int RB = T::kRowBytes;
  constexpr int kThreads = T::kDkvThreads;
  constexpr int kPer = (2 * BQ + kThreads - 1) / kThreads;  // lse/delta loads a thread
  constexpr int CG = T::kColGroups;   // warpgroups sharing a 64-key slab
  constexpr int kOwn = T::kBoxes / CG;  // boxes of dK and dV columns a warpgroup owns
  constexpr int NQ = BQ / CG;           // q rows of S^T and dP^T a warpgroup scores
  static_assert(CG == 1 || (BQ == 64 && BKV == 64), "column groups take one 64 x 64 tile");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t v_s = k_s + T::kKVBytes;
  const uint32_t ring = v_s + T::kKVBytes;                    // stage s: Q, then dO
  const uint32_t staged = ring + kStages * 2 * T::kQBytes;    // CG > 1: P^T, then dS^T
  const uint32_t stats = staged + T::kStagedBytes;            // s: lse2[BQ], delta scale[BQ]
  const uint32_t bar = stats + kStages * T::kStatBytes;       // K and V, then one a stage
  float* stat_p = reinterpret_cast<float*>(smem_raw + (stats - smem_u32(smem_raw)));

  const int k0 = blockIdx.x * BKV;  // the keys with the most rows first
  const int kvh = blockIdx.y / kv_split;
  const int split = blockIdx.y % kv_split;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int heads = G / kv_split;                 // this CTA's query heads,
  const int h0 = kvh * G + split * heads;         // h0 .. h0 + heads - 1
  const int i0 = k0 / BQ;                         // the first q block with a row >= k0
  const int per = (S + BQ - 1) / BQ - i0;         // q blocks a head
  const int trips = heads * per;
  const int tid = threadIdx.x;

  auto load_q = [&](int n) {  // thread 0 only: Q and dO of trip n
    const int h = h0 + n / per, q0 = (i0 + n % per) * BQ;
    const uint32_t stage = ring + (n % kStages) * 2 * T::kQBytes;
    const uint32_t full = bar + 8 * (1 + n % kStages);
    mbar_expect_tx(full, 2 * T::kQBytes);
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) {
      const uint32_t off = x * BQ * RB;
      tma_load_4d(stage + off, &qmap, full, x * T::kBoxCols, h, q0, b);
      tma_load_4d(stage + T::kQBytes + off, &dmap, full, x * T::kBoxCols, h, q0, b);
    }
  };
  // this thread's share of trip n's lse and delta rows (elements tid,
  // tid + kThreads, ...: lse of row e below BQ, delta of row e - BQ above)
  auto load_stats = [&](int n, float (&v)[kPer]) {
    const int h = h0 + n / per, q0 = (i0 + n % per) * BQ;
    const size_t lrow = (static_cast<size_t>(b) * H + h) * S;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads;
      const int r = q0 + e % BQ;
      v[u] = 0.f;
      if (e < 2 * BQ && r < S) v[u] = load_early((e < BQ ? lse : delta) + lrow + r);
    }
  };
  auto store_stats = [&](int n, const float (&v)[kPer]) {
    float* dst = stat_p + (n % kStages) * 2 * BQ;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads;
      if (e < 2 * BQ) dst[e] = v[u] * (e < BQ ? kLog2e : scale);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(bar + 8 * i, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, 2 * T::kKVBytes);
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) {
      tma_load_4d(k_s + x * BKV * RB, &kmap, bar, x * T::kBoxCols, kvh, k0, b);
      tma_load_4d(v_s + x * BKV * RB, &vmap, bar, x * T::kBoxCols, kvh, k0, b);
    }
    load_q(0);
  }
  {
    float v[kPer];
    load_stats(0, v);
    store_stats(0, v);
  }
  __syncthreads();  // the barriers and trip 0's stats are in place

  const int wg = tid / 128;
  const int slab = wg / CG;                     // this warpgroup's 64 keys
  const int cg = wg % CG;                       // and its column group
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int w0 = k0 + 64 * slab;                // this warpgroup's first key
  const int key = w0 + 16 * warp + lane / 4;    // this thread's keys: key, key + 8
  const int col = 2 * (lane % 4);               // and q rows 8c + col + {0, 1}
  const uint32_t k_wg = k_s + 64 * slab * RB;
  const uint32_t v_wg = v_s + 64 * slab * RB;
  const float scale_log2 = scale * kLog2e;

  float dka[kOwn][T::kBoxCols / 2], dva[kOwn][T::kBoxCols / 2];
#pragma unroll
  for (int x = 0; x < kOwn; ++x) {
#pragma unroll
    for (int i = 0; i < T::kBoxCols / 2; ++i) dka[x][i] = dva[x][i] = 0.0f;
  }
  mbar_wait(bar, 0);

  for (int n = 0; n < trips; ++n) {
    if (n > 0) __syncthreads();  // every warpgroup is done with trip n - 1's stage
    float next[kPer];
    const bool more = n + 1 < trips;
    if (more) {
      if (tid == 0) load_q(n + 1);
      load_stats(n + 1, next);
    }
    __syncwarp();
    const int q0 = (i0 + n % per) * BQ;
    if (q0 + BQ - 1 >= w0) {  // else every row is above this warpgroup's keys
      const uint32_t q_st = ring + (n % kStages) * 2 * T::kQBytes;
      const uint32_t do_st = q_st + T::kQBytes;
      const float* lse2 = stat_p + (n % kStages) * 2 * BQ;
      mbar_wait(bar + 8 * (1 + n % kStages), (n / kStages) & 1);

      // S^T = K.Q^T and dP^T = V.dO^T, f32, 64 keys x NQ rows each a
      // warpgroup (its column group's q rows), each in a group of its own:
      // P^T is formed while the tensor cores compute dP^T
      const int qh = q0 + cg * NQ;  // the first of those rows
      float st[NQ / 2], dpt[NQ / 2];
      wgmma_fence();
      product_ss<HD, NQ, T::kBoxCols>(st, k_wg, BKV, q_st + cg * NQ * RB, BQ);
      wgmma_commit();
      product_ss<HD, NQ, T::kBoxCols>(dpt, v_wg, BKV, do_st + cg * NQ * RB, BQ);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);
      if (qh < w0 + 63 || qh + NQ > S) {
        dkv_probs<NQ, true>(st, lse2 + cg * NQ, scale_log2, qh, col, key, S);
      } else {
        dkv_probs<NQ, false>(st, lse2 + cg * NQ, scale_log2, qh, col, key, S);
      }
      const float* dl = lse2 + BQ + cg * NQ;
      if constexpr (CG == 1) {
        // dV += P^T.dO in a third group, dS^T formed while it computes; dO
        // and Q are read MN-major for dV and dK
        uint32_t pf[BQ / 16][4], sf[BQ / 16][4];
        pack<BQ>(pf, st);
        wgmma_fence();
        product_rs<BQ, T::kBoxes, T::kBoxCols>(dva, pf, do_st);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dpt);
        scores<BQ>(dpt, st, scale, [&](int x) { return dl[8 * (x / 4) + col + x % 2]; });
        pack<BQ>(sf, dpt);
        wgmma_fence();
        product_rs<BQ, T::kBoxes, T::kBoxCols>(dka, sf, q_st);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          fence_regs(pf[kk]);
          fence_regs(sf[kk]);
        }
      } else {
        // each warpgroup holds P^T and dS^T of its NQ rows: both go to the
        // staged tiles as bf16, and after the barrier each warpgroup takes
        // all BQ rows of them for its kOwn boxes of dV and dK columns
        wgmma_wait<0>();
        fence_regs(dpt);
        scores<NQ>(dpt, st, scale, [&](int x) { return dl[8 * (x / 4) + col + x % 2]; });
        const int row = 16 * warp + lane / 4;
        stage_a<NQ>(staged, st, cg * NQ, row, col);
        stage_a<NQ>(staged + T::kStagedBytes / 2, dpt, cg * NQ, row, col);
        fence_proxy_async();
        __syncthreads();  // both warpgroups' halves are staged
        const int box = cg * kOwn;
        wgmma_fence();
        product_ss_mn<BQ, kOwn>(dva, staged, do_st + box * BQ * RB, BQ * RB);
        wgmma_commit();
        product_ss_mn<BQ, kOwn>(dka, staged + T::kStagedBytes / 2, q_st + box * BQ * RB,
                                BQ * RB);
        wgmma_commit();
        wgmma_wait<0>();
      }
#pragma unroll
      for (int x = 0; x < kOwn; ++x) {
        fence_regs(dka[x]);
        fence_regs(dva[x]);
      }
    }
    if (more) store_stats(n + 1, next);
  }

  // this warpgroup's boxes of columns: box0 .. box0 + kOwn - 1
  const int c0 = cg * kOwn * T::kBoxCols;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = key + 8 * i;
    if (r >= S || c0 >= hd) continue;
    const size_t at = ((static_cast<size_t>(b) * S + r) * KV + kvh) * hd + c0;
    if constexpr (kSplit) {
      const size_t n = static_cast<size_t>(B) * S * KV * hd;  // one partial
      float* pk = part + split * n + at;
      store_row<float, kOwn, T::kBoxCols>(pk, dka, i, col, hd - c0);
      store_row<float, kOwn, T::kBoxCols>(pk + kv_split * n, dva, i, col, hd - c0);
    } else {
      store_row<__nv_bfloat16, kOwn, T::kBoxCols>(dk + at, dka, i, col, hd - c0);
      store_row<__nv_bfloat16, kOwn, T::kBoxCols>(dv + at, dva, i, col, hd - c0);
    }
  }
}

// dk (blockIdx.y 0) or dv (1) = the sum of the kv_split float32 partials
// of n elements each (n a multiple of 4), in split order, rounded once.
__global__ void __launch_bounds__(256) flash_bwd_reduce_sm90(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, long long n, int kv_split) {
  const float* src = part + blockIdx.y * kv_split * n;
  __nv_bfloat16* dst = blockIdx.y ? dv : dk;
  const long long stride = 4ll * gridDim.x * blockDim.x;
  for (long long i = 4ll * (blockIdx.x * blockDim.x + threadIdx.x); i < n; i += stride) {
    float4 a = *reinterpret_cast<const float4*>(src + i);
    for (int s = 1; s < kv_split; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(src + s * n + i);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + i) = __floats2bfloat162_rn(a.x, a.y);
    *reinterpret_cast<__nv_bfloat162*>(dst + i + 2) = __floats2bfloat162_rn(a.z, a.w);
  }
}

// CTAs of a pass (0: dq, 1: dk/dv) one SM holds at once (registers, shared
// memory and threads, as CUDA's occupancy calculator counts them), or -1.
template <int HD, int BQ, int BKV> int ctas_per_sm(int pass) {
  using T = Tile<HD, BQ, BKV>;
  const void* kernel = pass == 0 ? reinterpret_cast<const void*>(flash_bwd_dq_sm90<HD, BQ, BKV>)
                                 : reinterpret_cast<const void*>(
                                       flash_bwd_dkv_sm90<HD, BQ, BKV, false>);
  const int threads = pass == 0 ? T::kDqThreads : T::kDkvThreads;
  const long long smem = pass == 0 ? T::kDqSmem : T::kDkvSmem;
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess) {
    return -1;
  }
  return n;
}

long long scratch_bytes(int B, int S, int KV, int hd, int kv_split) {
  return kv_split > 1 ? 2ll * kv_split * B * S * KV * hd * 4 : 0;
}

template <int HD, int BQ, int BKV>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, void* scratch, int B,
           int S, int H, int KV, int hd, int kv_split, float scale, int passes,
           cudaStream_t stream) {
  using T = Tile<HD, BQ, BKV>;
  CUtensorMap qmap, kmap, vmap, dmap;
  cudaError_t err = encode(&qmap, q, B, S, H, hd, T::kBoxCols, BQ);
  if (err == cudaSuccess) err = encode(&dmap, dout, B, S, H, hd, T::kBoxCols, BQ);
  if (err == cudaSuccess) err = encode(&kmap, k, B, S, KV, hd, T::kBoxCols, BKV);
  if (err == cudaSuccess) err = encode(&vmap, v, B, S, KV, hd, T::kBoxCols, BKV);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kq = flash_bwd_dq_sm90<HD, BQ, BKV>;
  auto kkv = kv_split > 1 ? flash_bwd_dkv_sm90<HD, BQ, BKV, true>
                          : flash_bwd_dkv_sm90<HD, BQ, BKV, false>;
  err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(T::kDqSmem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(T::kDkvSmem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* lf = static_cast<const float*>(lse);
  auto* df = static_cast<float*>(delta);
  auto* part = static_cast<float*>(scratch);
  if (passes & kPassDelta) {
    const int rows = B * S * H;
    int lanes = 1;
    while (8 * lanes < hd) lanes *= 2;  // a row's lanes: 1 .. 32, a whole warp holds rows
    const long long threads = static_cast<long long>(rows) * lanes;
    flash_bwd_delta_sm90<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), df, rows,
        S, H, hd, lanes);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & kPassDq) {
    kq<<<dim3((S + BQ - 1) / BQ, H, B), T::kDqThreads, T::kDqSmem, stream>>>(
        qmap, kmap, vmap, dmap, lf, df, static_cast<__nv_bfloat16*>(dq), S, H, KV, hd, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & kPassDkv) {
    kkv<<<dim3((S + BKV - 1) / BKV, KV * kv_split, B), T::kDkvThreads, T::kDkvSmem, stream>>>(
        qmap, kmap, vmap, dmap, lf, df, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), part, B, S, H, KV, hd, kv_split, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (kv_split > 1 && (passes & kPassReduce)) {
    const long long n = static_cast<long long>(B) * S * KV * hd;
    const long long blocks = (n / 4 + 255) / 256;
    flash_bwd_reduce_sm90<<<dim3(static_cast<unsigned>(blocks < 1056 ? blocks : 1056), 2), 256,
                            0, stream>>>(part, static_cast<__nv_bfloat16*>(dk),
                                         static_cast<__nv_bfloat16*>(dv), n, kv_split);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// The instantiated tiles (tile hd, block_q, block_kv): block_q is the dq
// pass's rows (a warpgroup per 64) and the dk/dv pass's streamed q block,
// block_kv the other way round.  At hd 128 block_q stays 64: the dk/dv
// pass's S^T, dP^T, dK and dV of block_q 128 would be 256 floats a thread.
// At hd 256 one tile: the dk/dv pass's two Q/dO stages take 128 KB, so
// block_q stays 64, and its column groups take 64 keys.
#define FLASH_BWD_SM90_TILES(X)                                                              \
  X(16, 64, 64) X(16, 64, 128) X(16, 128, 64) X(16, 128, 128)                                \
  X(32, 64, 64) X(32, 64, 128) X(32, 128, 64) X(32, 128, 128)                                \
  X(64, 64, 64) X(64, 64, 128) X(64, 128, 64) X(64, 128, 128)                                \
  X(128, 64, 64) X(128, 64, 128)                                                             \
  X(256, 64, 64)

// The tile head dim a call at head dim hd runs on: the least of 16, 32, 64,
// 128, 256 at or above it; 0 where hd is not a multiple of 8 in 8..256.
int tile_hd(int hd) {
  if (hd < 8 || hd > 256 || hd % 8) return 0;
  int t = 16;
  while (t < hd) t *= 2;
  return t;
}

}  // namespace

// dq, dk, dv of causal GQA attention from q, k, v, o, do (bf16,
// (B,S,heads,hd)) and lse (float32, (B,H,S)); delta is float32 (B,H,S)
// scratch the call writes, scratch the kv_split > 1 partials
// (flash_attention_bwd_sm90_scratch_bytes, null at kv_split 1).  `passes`
// selects the passes to run (15: all).  Returns the launches'
// cudaGetLastError() code, or cudaErrorInvalidValue for a tile not
// instantiated, a kv_split that does not divide H/KV, or shapes the kernel
// does not take.
extern "C" int flash_attention_bwd_sm90_launch(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, const void* lse,
                                               void* delta, void* dq, void* dk, void* dv,
                                               void* scratch, int B, int S, int H, int KV, int hd,
                                               int bq, int bkv, int kv_split, float scale,
                                               int passes, void* stream) {
  const int ht = tile_hd(hd);
  if (ht == 0 || KV < 1 || H % KV || S < 1 || B < 1 || kv_split < 1 ||
      (H / KV) % kv_split || (kv_split > 1 && !scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_SM90_LAUNCH(HD, BQ, BKV)                                                   \
  if (ht == HD && bq == BQ && bkv == BKV) {                                                   \
    return launch<HD, BQ, BKV>(q, k, v, o, dout, lse, delta, dq, dk, dv, scratch, B, S, H, KV, \
                               hd, kv_split, scale, passes, s);                               \
  }
  FLASH_BWD_SM90_TILES(FLASH_BWD_SM90_LAUNCH)
#undef FLASH_BWD_SM90_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The larger of the two passes' dynamic shared memory at head dim hd (must
// equal the Python model), or -1 for a tile not instantiated.
extern "C" long long flash_attention_bwd_sm90_smem_bytes(int hd, int bq, int bkv) {
  const int ht = tile_hd(hd);
#define FLASH_BWD_SM90_SMEM(HD, BQ, BKV) \
  if (ht == HD && bq == BQ && bkv == BKV) return Tile<HD, BQ, BKV>::kSmem;
  FLASH_BWD_SM90_TILES(FLASH_BWD_SM90_SMEM)
#undef FLASH_BWD_SM90_SMEM
  return -1;
}

// CTAs of pass `pass` (0: dq, 1: dk/dv) of a tile (at head dim hd) one SM of
// the current device holds at once, or -1 for a tile not instantiated.
extern "C" int flash_attention_bwd_sm90_ctas_per_sm(int hd, int bq, int bkv, int pass) {
  const int ht = tile_hd(hd);
#define FLASH_BWD_SM90_CTAS(HD, BQ, BKV) \
  if (ht == HD && bq == BQ && bkv == BKV) return ctas_per_sm<HD, BQ, BKV>(pass);
  FLASH_BWD_SM90_TILES(FLASH_BWD_SM90_CTAS)
#undef FLASH_BWD_SM90_CTAS
  return -1;
}

// Bytes of the float32 partials a call at kv_split takes (0 at 1): dk's
// and dv's, each (kv_split, B, S, KV, hd).
extern "C" long long flash_attention_bwd_sm90_scratch_bytes(int B, int S, int KV, int hd,
                                                            int kv_split) {
  return scratch_bytes(B, S, KV, hd, kv_split);
}
