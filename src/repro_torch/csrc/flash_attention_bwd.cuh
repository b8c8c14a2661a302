// Causal GQA flash attention, backward: dq, dk, dv from q, k, v, o, lse, do,
// on mma.sync.  It serves float32 (3xTF32) at every tile head dim and bf16
// at tile hd 256 alone; bf16 below hd 256 runs on the wgmma kernel of
// flash_attention_bwd_sm90.cu, whose notes hold the design both share.
//
// Replaces: src/repro/models/attention.py, _flash_bwd (:260), the custom
// VJP of flash_attention_xla (:346); it has no Pallas site.
//
// q, o, do, dq (B,S,H,hd), k, v, dk, dv (B,S,KV,hd), all of one element
// type E; KV head = h / (H/KV).  hd is a run-time multiple of 8 (bf16) or 4
// (float32) up to 256, run on the least tile head dim HD at or above it;
// the tile's columns past hd load as zeros and are never stored.
//
// What bounds it: operations (five causal products, each on the tensor
// cores: bf16 m16n8k16, float32 as three TF32 m16n8k8 products, a TF32
// high part and the rest, so float32 accuracy holds).
//
// Design: the three passes of flash_attention_bwd_sm90.cu, no atomics:
//  1. delta = rowsum(do * o), one warp a row.
//  2. dq: one CTA per (q block, head, batch, column chunk), a warp per 16
//     rows; K and V blocks stream through shared memory; dS is taken
//     straight from the S accumulator as the A fragment of dS.K.
//  3. dk, dv: one CTA per (KV block, KV head, batch, column chunk), a warp
//     per 16 keys, walking all G query heads of its KV head.
// A column chunk is the output columns of one CTA (bf16: up to 128 for dq,
// 64 for dk and dv; float32 half as many); a chunk past the first
// recomputes S and dP.  Tiles are loaded with 16-byte pieces and plain
// stores, rows padded so fragment loads fall on distinct banks.
//
// Sums: the tensor cores' float32 accumulation rounds toward zero, so a sum
// carried in one accumulator over all of S drifts (3e-4 of a row at S =
// 4096 in float32, on the card).  So in float32 every k-step's three TF32
// products are summed from zero and added in float32 (round to nearest),
// and each block's sum to the gradient; bf16 keeps the running sums, whose
// drift lies far inside its tolerance.
//
// Rounding as the JAX _flash_bwd does in bf16: P is rounded before P^T.dO,
// dS before dS.K and dS^T.Q; S and dP stay float32; each gradient is
// accumulated in float32 and rounded once when stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash_bwd {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x rounded to TF32 (to nearest) and the rest, as the forward's float32 kernel.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The mma.sync fragments of one element type, read from row-major tiles in
// shared memory.  A thread is lane (g, t) = (lane / 4, lane % 4) of its warp.
//  load_a(ra, rb, k0): A rows g and g + 8 (ra, rb: the tile rows), k-step at k0
//    along the row.
//  from_acc(c, kk): the k-step kk of A taken from an accumulator c[n][4] of
//    16 x (8 n) whose columns are the k axis.
//  load_b_k(rn, k0): B's column g is the tile row rn, k along the row.
//  load_b_n(tile, ld, k0, n): B(k, n) = tile[k][n], k along the rows.
template <typename E> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  using E = __nv_bfloat16;
  static constexpr int kK = 16;   // m16n8k16
  static constexpr int kPad = 8;  // row padding (elements): 4-byte loads on distinct banks
  static constexpr bool kBlockSums = false;  // see the dq pass
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };

  static __device__ __forceinline__ uint32_t ld32(const E* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint32_t pair(const E* lo, const E* hi) {
    return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
           (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
  }
  static __device__ __forceinline__ A load_a(const E* ra, const E* rb, int k0, int t) {
    A a;
    a.x[0] = ld32(ra + k0 + 2 * t);
    a.x[1] = ld32(rb + k0 + 2 * t);
    a.x[2] = ld32(ra + k0 + 8 + 2 * t);
    a.x[3] = ld32(rb + k0 + 8 + 2 * t);
    return a;
  }
  template <int N>
  static __device__ __forceinline__ A from_acc(const float (&c)[N][4], int kk) {
    A a;
    a.x[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a.x[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a.x[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a.x[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
    return a;
  }
  static __device__ __forceinline__ B load_b_k(const E* rn, int k0, int t) {
    B b;
    b.x[0] = ld32(rn + k0 + 2 * t);
    b.x[1] = ld32(rn + k0 + 8 + 2 * t);
    return b;
  }
  static __device__ __forceinline__ B load_b_n(const E* tile, int ld, int k0, int n, int t) {
    const E* p = tile + (k0 + 2 * t) * ld + n;
    B b;
    b.x[0] = pair(p, p + ld);
    b.x[1] = pair(p + 8 * ld, p + 9 * ld);
    return b;
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma_bf16(d, a.x, b.x[0], b.x[1]);
  }
  static __device__ __forceinline__ void mma_rn(float (&d)[4], const A& a, const B& b) {
    mma(d, a, b);
  }
  static __device__ __forceinline__ void store2(E* p, float lo, float hi) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float load(const E* p) { return __bfloat162float(*p); }
};

template <> struct Mma<float> {
  using E = float;
  static constexpr int kK = 8;    // m16n8k8, k in the order (0,2,4,6,1,3,5,7)
  static constexpr int kPad = 4;  // row padding (floats)
  static constexpr bool kBlockSums = true;  // see the dq pass
  struct A { uint32_t h[4], l[4]; };
  struct B { uint32_t h[2], l[2]; };

  static __device__ __forceinline__ A load_a(const E* ra, const E* rb, int k0, int t) {
    const float2 x = *reinterpret_cast<const float2*>(ra + k0 + 2 * t);
    const float2 y = *reinterpret_cast<const float2*>(rb + k0 + 2 * t);
    A a;
    split(x.x, a.h[0], a.l[0]);
    split(y.x, a.h[1], a.l[1]);
    split(x.y, a.h[2], a.l[2]);
    split(y.y, a.h[3], a.l[3]);
    return a;
  }
  template <int N>
  static __device__ __forceinline__ A from_acc(const float (&c)[N][4], int kk) {
    A a;
    split(c[kk][0], a.h[0], a.l[0]);
    split(c[kk][2], a.h[1], a.l[1]);
    split(c[kk][1], a.h[2], a.l[2]);
    split(c[kk][3], a.h[3], a.l[3]);
    return a;
  }
  static __device__ __forceinline__ B load_b_k(const E* rn, int k0, int t) {
    const float2 x = *reinterpret_cast<const float2*>(rn + k0 + 2 * t);
    B b;
    split(x.x, b.h[0], b.l[0]);
    split(x.y, b.h[1], b.l[1]);
    return b;
  }
  static __device__ __forceinline__ B load_b_n(const E* tile, int ld, int k0, int n, int t) {
    const E* p = tile + (k0 + 2 * t) * ld + n;
    B b;
    split(p[0], b.h[0], b.l[0]);
    split(p[ld], b.h[1], b.l[1]);
    return b;
  }
  // d += a.b in 3xTF32, small terms first
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma_tf32(d, a.l, b.h[0], b.h[1]);
    mma_tf32(d, a.h, b.l[0], b.l[1]);
    mma_tf32(d, a.h, b.h[0], b.h[1]);
  }
  // the same, the k-step's products summed from zero and added to d in
  // float32 (round to nearest): no truncation from a long running sum
  static __device__ __forceinline__ void mma_rn(float (&d)[4], const A& a, const B& b) {
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    mma(p, a, b);
    asm volatile("" : "+f"(p[0]), "+f"(p[1]), "+f"(p[2]), "+f"(p[3]));  // one k-step at a time
    d[0] += p[0];
    d[1] += p[1];
    d[2] += p[2];
    d[3] += p[3];
  }
  static __device__ __forceinline__ void store2(E* p, float lo, float hi) {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  }
  static __device__ __forceinline__ float load(const E* p) { return *p; }
};

// Marks an accumulator as rewritten, so the compiler rebuilds the A
// fragments it takes from it where they are used instead of keeping every
// k-step's fragment alive across a loop (registers).
template <int N> __device__ __forceinline__ void fence_acc(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    asm volatile("" : "+f"(c[n][0]), "+f"(c[n][1]), "+f"(c[n][2]), "+f"(c[n][3]));
  }
}

// Rows [row0, row0 + R) of an (S, hd) matrix whose rows lie `stride`
// elements apart, into R shared rows of LD elements: HD columns in 16-byte
// pieces, zeros past S and past hd (a multiple of the piece).
template <typename E, int R, int HD, int LD, int NT>
__device__ __forceinline__ void load_tile(E* dst, const E* src, size_t stride, int row0, int S,
                                          int hd, int tid) {
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  constexpr int P = HD / V;
  for (int c = tid; c < R * P; c += NT) {
    const int r = c / P, col = (c % P) * V;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S && col < hd) {
      x = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * stride + col);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + col) = x;
  }
}

// Output columns one CTA of each pass owns: in bf16 all of hd up to 128
// (dq) or 64 (dk and dv, two accumulators); float32 takes half as many,
// its A fragments (a TF32 high part and the rest) and its k-step sums
// taking the registers the other half would.
template <typename E, int HD> struct Chunks {
  static constexpr int kMaxDq = sizeof(E) == 2 ? 128 : 64;
  static constexpr int kMaxDkv = sizeof(E) == 2 ? 64 : 32;
  static constexpr int kDq = HD < kMaxDq ? HD : kMaxDq;
  static constexpr int kDkv = HD < kMaxDkv ? HD : kMaxDkv;
};

template <typename E, int HD, int BQ, int BKV> struct DqTile {
  static constexpr int kThreads = 32 * (BQ / 16);
  static constexpr int kLd = HD + Mma<E>::kPad;
  static constexpr long long kSmem =
      static_cast<long long>(sizeof(E)) * kLd * (2 * BQ + 2 * BKV);
};

template <typename E, int HD, int BQ, int BKV> struct DkvTile {
  static constexpr int kThreads = 32 * (BKV / 16);
  static constexpr int kLd = HD + Mma<E>::kPad;
  static constexpr long long kSmem =
      static_cast<long long>(sizeof(E)) * kLd * (2 * BQ + 2 * BKV) + 2ll * BQ * sizeof(float);
};

// delta[b, h, s] = sum over hd of do * o, float32: one warp a (b, s, h) row.
template <typename E>
__global__ void __launch_bounds__(256) flash_bwd_delta(const E* __restrict__ o,
                                                       const E* __restrict__ dout,
                                                       float* __restrict__ delta, int rows,
                                                       int S, int H, int hd) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp: one row a warp
  const E* op = o + static_cast<size_t>(row) * hd;
  const E* dp = dout + static_cast<size_t>(row) * hd;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(Mma<E>::load(op + c), Mma<E>::load(dp + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int b = row / (S * H), s = (row / H) % S, h = row % H;
    delta[(static_cast<size_t>(b) * H + h) * S + s] = acc;
  }
}

template <typename E, int HD, int BQ, int BKV>
__global__ void __launch_bounds__(32 * (BQ / 16), 1) flash_bwd_dq(
    const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
    const E* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    E* __restrict__ dq, int S, int H, int KV, int hd, float scale) {
  using M = Mma<E>;
  using T = DqTile<E, HD, BQ, BKV>;
  constexpr int LD = T::kLd;
  constexpr int DC = Chunks<E, HD>::kDq;
  constexpr int NT = BKV / 8;     // n-tiles of S and dP
  constexpr int KS = HD / M::kK;  // k-steps over hd
  constexpr int KK = BKV / M::kK; // k-steps over keys (dS.K)
  constexpr int DT = DC / 8;      // n-tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* qs = reinterpret_cast<E*>(smem_raw);
  E* dos = qs + BQ * LD;
  E* ks = dos + BQ * LD;
  E* vs = ks + BKV * LD;

  const int chunks = (hd + DC - 1) / DC;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z / chunks;
  const int c0 = (blockIdx.z % chunks) * DC;
  const int kvh = h / (H / KV);
  const size_t q_step = static_cast<size_t>(H) * hd;
  const size_t kv_step = static_cast<size_t>(KV) * hd;
  const size_t qoff = (static_cast<size_t>(b) * S * H + h) * hd;
  const size_t kvoff = (static_cast<size_t>(b) * S * KV + kvh) * hd;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp;  // this warp's first row

  load_tile<E, BQ, HD, LD, T::kThreads>(qs, q + qoff, q_step, q0, S, hd, tid);
  load_tile<E, BQ, HD, LD, T::kThreads>(dos, dout + qoff, q_step, q0, S, hd, tid);
  const size_t lrow = (static_cast<size_t>(b) * H + h) * S;
  float lse2[2], dl[2];  // rows g and g + 8: lse in the log2 domain, delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    lse2[i] = row < S ? lse[lrow + row] * kLog2e : 0.f;
    dl[i] = row < S ? delta[lrow + row] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const E* qa = qs + (16 * warp + g) * LD;
  const E* qb = qa + 8 * LD;
  const E* da = dos + (16 * warp + g) * LD;
  const E* db = da + 8 * LD;

  const int nkv = (min(S, q0 + BQ) + BKV - 1) / BKV;
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BKV;
    __syncthreads();  // every warp is done with block j - 1's tiles
    load_tile<E, BKV, HD, LD, T::kThreads>(ks, k + kvoff, kv_step, k0, S, hd, tid);
    load_tile<E, BKV, HD, LD, T::kThreads>(vs, v + kvoff, kv_step, k0, S, hd, tid);
    __syncthreads();
    if (k0 > r0 + 15) continue;  // wholly above this warp's diagonal

    // S = Q.K^T and dP = dO.V^T, 16 x BKV each
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    auto scores = [&](int kk) {
      const typename M::A aq = M::load_a(qa, qb, kk * M::kK, t);
      const typename M::A ad = M::load_a(da, db, kk * M::kK, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        M::mma_rn(s[n], aq, M::load_b_k(ks + (8 * n + g) * LD, kk * M::kK, t));
        M::mma_rn(dp[n], ad, M::load_b_k(vs + (8 * n + g) * LD, kk * M::kK, t));
      }
    };
    if constexpr (M::kBlockSums) {  // one k-step at a time: registers
#pragma unroll 1
      for (int kk = 0; kk < KS; ++kk) scores(kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) scores(kk);
    }

    // dS = P * (dP - delta) * scale, P = 0 above the diagonal and past S
    const bool edge = k0 + BKV - 1 > r0 || k0 + BKV > S;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        const int row = r0 + g + 8 * i;
        float p = exp2f(fmaf(s[n][e], scale_log2, -lse2[i]));
        if (edge && (key > row || key >= S)) p = 0.f;
        s[n][e] = p * (dp[n][e] - dl[i]) * scale;
      }
    }

    // dq += dS.K over this chunk's columns.  In float32 each block's sum is
    // taken on its own and added to dq in float32 (round to nearest): the
    // tensor cores' accumulation rounds toward zero, and a sum carried in
    // it over all of S's blocks drifts (3e-4 of a row at S = 4096, far
    // inside bf16's tolerance, so bf16 keeps the cheaper running sum)
    if constexpr (M::kBlockSums) {
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        fence_acc(s);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          M::mma_rn(part, M::template from_acc<NT>(s, kk),
                    M::load_b_n(ks, LD, kk * M::kK, c0 + 8 * n + g, t));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const typename M::A a = M::template from_acc<NT>(s, kk);
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          M::mma(acc[n], a, M::load_b_n(ks, LD, kk * M::kK, c0 + 8 * n + g, t));
        }
      }
    }
  }

  E* out = dq + qoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int col = c0 + 8 * n + 2 * t;
      if (col < hd) M::store2(out + row * q_step + col, acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

template <typename E, int HD, int BQ, int BKV>
__global__ void __launch_bounds__(32 * (BKV / 16), 1) flash_bwd_dkv(
    const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
    const E* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    E* __restrict__ dk, E* __restrict__ dv, int S, int H, int KV, int hd, float scale) {
  using M = Mma<E>;
  using T = DkvTile<E, HD, BQ, BKV>;
  constexpr int LD = T::kLd;
  constexpr int DC = Chunks<E, HD>::kDkv;
  constexpr int NQ = BQ / 8;      // n-tiles of S^T and dP^T
  constexpr int KS = HD / M::kK;  // k-steps over hd
  constexpr int KQ = BQ / M::kK;  // k-steps over rows (P^T.dO, dS^T.Q)
  constexpr int DT = DC / 8;      // n-tiles of dk and dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ks = reinterpret_cast<E*>(smem_raw);
  E* vs = ks + BKV * LD;
  E* qs = vs + BKV * LD;
  E* dos = qs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dos + BQ * LD);  // log2 domain
  float* dl_s = lse_s + BQ;

  const int chunks = (hd + DC - 1) / DC;
  const int k0 = blockIdx.x * BKV;  // the keys with the most rows first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z / chunks;
  const int c0 = (blockIdx.z % chunks) * DC;
  const int G = H / KV;
  const size_t q_step = static_cast<size_t>(H) * hd;
  const size_t kv_step = static_cast<size_t>(KV) * hd;
  const size_t kvoff = (static_cast<size_t>(b) * S * KV + kvh) * hd;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = k0 + 16 * warp;  // this warp's first key

  load_tile<E, BKV, HD, LD, T::kThreads>(ks, k + kvoff, kv_step, k0, S, hd, tid);
  load_tile<E, BKV, HD, LD, T::kThreads>(vs, v + kvoff, kv_step, k0, S, hd, tid);
  const float scale_log2 = scale * kLog2e;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const E* ka = ks + (16 * warp + g) * LD;
  const E* kb = ka + 8 * LD;
  const E* va = vs + (16 * warp + g) * LD;
  const E* vb = va + 8 * LD;

  const int nq = (S + BQ - 1) / BQ;
  for (int gq = 0; gq < G; ++gq) {
    const int h = kvh * G + gq;
    const size_t qoff = (static_cast<size_t>(b) * S * H + h) * hd;
    const size_t lrow = (static_cast<size_t>(b) * H + h) * S;
    for (int i = k0 / BQ; i < nq; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // every warp is done with the previous q block's tiles
      load_tile<E, BQ, HD, LD, T::kThreads>(qs, q + qoff, q_step, q0, S, hd, tid);
      load_tile<E, BQ, HD, LD, T::kThreads>(dos, dout + qoff, q_step, q0, S, hd, tid);
      for (int r = tid; r < BQ; r += T::kThreads) {
        const int row = q0 + r;
        lse_s[r] = row < S ? lse[lrow + row] * kLog2e : 0.f;
        dl_s[r] = row < S ? delta[lrow + row] : 0.f;
      }
      __syncthreads();
      if (q0 + BQ - 1 < w0) continue;  // every row is above this warp's keys

      // S^T = K.Q^T and dP^T = V.dO^T, 16 keys x BQ rows each
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
      }
      auto scores = [&](int kk) {
        const typename M::A ak = M::load_a(ka, kb, kk * M::kK, t);
        const typename M::A av = M::load_a(va, vb, kk * M::kK, t);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          M::mma_rn(st[n], ak, M::load_b_k(qs + (8 * n + g) * LD, kk * M::kK, t));
          M::mma_rn(dpt[n], av, M::load_b_k(dos + (8 * n + g) * LD, kk * M::kK, t));
        }
      };
      if constexpr (M::kBlockSums) {  // one k-step at a time: registers
#pragma unroll 1
        for (int kk = 0; kk < KS; ++kk) scores(kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) scores(kk);
      }

      // P^T and dS^T = P^T * (dP^T - delta) * scale; P = 0 where the row is
      // above the key or past S
      const bool edge = q0 < w0 + 15 || q0 + BQ > S;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = 8 * n + 2 * t + (e & 1);
          const int row = q0 + rl;
          const int key = w0 + g + 8 * (e >> 1);
          float p = exp2f(fmaf(st[n][e], scale_log2, -lse_s[rl]));
          if (edge && (row < key || row >= S)) p = 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dl_s[rl]) * scale;
        }
      }

      // dv += P^T.dO and dk += dS^T.Q over this chunk's columns (in float32
      // each q block's sums on their own, as dq's)
      if constexpr (M::kBlockSums) {
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          fence_acc(st);
          fence_acc(dpt);
          float pv[4] = {0.f, 0.f, 0.f, 0.f}, pk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < KQ; ++kk) {
            M::mma_rn(pv, M::template from_acc<NQ>(st, kk),
                      M::load_b_n(dos, LD, kk * M::kK, c0 + 8 * n + g, t));
            M::mma_rn(pk, M::template from_acc<NQ>(dpt, kk),
                      M::load_b_n(qs, LD, kk * M::kK, c0 + 8 * n + g, t));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dva[n][e] += pv[e];
            dka[n][e] += pk[e];
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) {
          const typename M::A ap = M::template from_acc<NQ>(st, kk);
          const typename M::A as = M::template from_acc<NQ>(dpt, kk);
#pragma unroll
          for (int n = 0; n < DT; ++n) {
            M::mma(dva[n], ap, M::load_b_n(dos, LD, kk * M::kK, c0 + 8 * n + g, t));
            M::mma(dka[n], as, M::load_b_n(qs, LD, kk * M::kK, c0 + 8 * n + g, t));
          }
        }
      }
    }
  }

  E* dko = dk + kvoff;
  E* dvo = dv + kvoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = w0 + g + 8 * i;
    if (key >= S) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int col = c0 + 8 * n + 2 * t;
      if (col < hd) {
        M::store2(dko + key * kv_step + col, dka[n][2 * i], dka[n][2 * i + 1]);
        M::store2(dvo + key * kv_step + col, dva[n][2 * i], dva[n][2 * i + 1]);
      }
    }
  }
}

// The three passes of one tile on `stream`; the launches' cudaGetLastError()
// code (the first that is not success).
template <typename E, int HD, int BQ, int BKV>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int H,
           int KV, int hd, float scale, cudaStream_t stream) {
  using TQ = DqTile<E, HD, BQ, BKV>;
  using TK = DkvTile<E, HD, BQ, BKV>;
  auto kq = flash_bwd_dq<E, HD, BQ, BKV>;
  auto kkv = flash_bwd_dkv<E, HD, BQ, BKV>;
  cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(TQ::kSmem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(TK::kSmem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  const E* de = static_cast<const E*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  const int rows = B * S * H;
  flash_bwd_delta<E><<<(rows + 7) / 8, 256, 0, stream>>>(static_cast<const E*>(o), de, df, rows,
                                                        S, H, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cq = (hd + Chunks<E, HD>::kDq - 1) / Chunks<E, HD>::kDq;
  kq<<<dim3((S + BQ - 1) / BQ, H, B * cq), TQ::kThreads, TQ::kSmem, stream>>>(
      qe, ke, ve, de, lf, df, static_cast<E*>(dq), S, H, KV, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ck = (hd + Chunks<E, HD>::kDkv - 1) / Chunks<E, HD>::kDkv;
  kkv<<<dim3((S + BKV - 1) / BKV, KV, B * ck), TK::kThreads, TK::kSmem, stream>>>(
      qe, ke, ve, de, lf, df, static_cast<E*>(dk), static_cast<E*>(dv), S, H, KV, hd, scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiated tiles (tile hd, block_q, block_kv), by dtype: block_q is
// the dq pass's rows (16 a warp) and the dk/dv pass's k-steps over rows,
// block_kv the other way round, so each is at most 64 (the S and dP
// accumulators of a warp are 16 x the other tile); at hd 256 block_kv 32
// (float32: the four tiles of 64 rows would not fit the shared memory).
// bf16 takes only hd 256 here (flash_attention_bwd_sm90.cu has the rest).
#define FLASH_BWD_TILES_F32(X)                                                                \
  X(16, 32, 32) X(16, 64, 64)                                                                 \
  X(32, 32, 32) X(32, 64, 64)                                                                 \
  X(64, 32, 32) X(64, 32, 64) X(64, 64, 32) X(64, 64, 64)                                     \
  X(128, 32, 32) X(128, 32, 64) X(128, 64, 32) X(128, 64, 64)                                 \
  X(256, 32, 32) X(256, 64, 32)
#define FLASH_BWD_TILES_BF16(X) X(256, 32, 32) X(256, 64, 32)

// The tile head dim a call at head dim hd runs on (the least of 16, 32, 64,
// 128, 256 at or above it); 0 where hd is not a multiple of `multiple` up
// to 256.
inline int tile_hd(int hd, int multiple) {
  if (hd < multiple || hd > 256 || hd % multiple) return 0;
  int t = 16;
  while (t < hd) t *= 2;
  return t;
}

template <typename E>
int launch_any(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int H,
               int KV, int hd, int bq, int bkv, float scale, void* stream) {
  const int ht = tile_hd(hd, 16 / static_cast<int>(sizeof(E)));
  if (ht == 0 || KV < 1 || H % KV || S < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_LAUNCH(HD, BQ, BKV)                                                       \
  if (ht == HD && bq == BQ && bkv == BKV) {                                                  \
    return launch<E, HD, BQ, BKV>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, hd, \
                                  scale, s);                                                 \
  }
  if constexpr (sizeof(E) == 4) {
    FLASH_BWD_TILES_F32(FLASH_BWD_LAUNCH)
  } else {
    FLASH_BWD_TILES_BF16(FLASH_BWD_LAUNCH)
  }
#undef FLASH_BWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The larger of the two passes' dynamic shared memory at head dim hd (must
// equal the Python model), or -1 for a tile not instantiated.
template <typename E> long long smem_bytes(int hd, int bq, int bkv) {
  const int ht = tile_hd(hd, 16 / static_cast<int>(sizeof(E)));
#define FLASH_BWD_SMEM(HD, BQ, BKV)                                             \
  if (ht == HD && bq == BQ && bkv == BKV) {                                      \
    const long long a = DqTile<E, HD, BQ, BKV>::kSmem;                          \
    const long long b = DkvTile<E, HD, BQ, BKV>::kSmem;                         \
    return a > b ? a : b;                                                        \
  }
  if constexpr (sizeof(E) == 4) {
    FLASH_BWD_TILES_F32(FLASH_BWD_SMEM)
  } else {
    FLASH_BWD_TILES_BF16(FLASH_BWD_SMEM)
  }
#undef FLASH_BWD_SMEM
  return -1;
}

}  // namespace flash_bwd
