// Causal GQA flash attention, backward, float32: dq, dk, dv from q, k, v,
// o, lse, do on mma.sync in 3xTF32.  It serves float32 alone; every bf16
// call runs on the wgmma kernel of flash_attention_bwd_sm90.cu, whose notes
// hold the three-pass design both share.
//
// Replaces: src/repro/models/attention.py, _flash_bwd (:260), the custom
// VJP of flash_attention_xla (:346); it has no Pallas site.
//
// q, o, do, dq (B,S,H,hd), k, v, dk, dv (B,S,KV,hd) float32; KV head =
// h / (H/KV).  hd is a run-time multiple of 4 up to 256, run on the least
// tile head dim HD at or above it; the tile's columns past hd load as zeros
// and are never stored.
//
// What bounds it: operations (five causal products on the tensor cores,
// each float32 multiply-add three TF32 m16n8k8 products, a TF32 high part
// and the rest, so float32 accuracy holds).
//
// Design: the three passes of flash_attention_bwd_sm90.cu, no atomics.
//  1. delta = rowsum(do * o), one warp a row.
//  2. dq: one CTA per (q block, head, batch); Q and dO are loaded once, K
//     and V blocks stream through a ring of cp.async 16-byte pieces (zeros
//     past S and hd), block j+1's loads in flight under block j's products
//     (one stage where two do not fit the shared memory).
//  3. dk, dv: one CTA per (KV block, KV head x kv_split, batch), walking
//     G / kv_split query heads of its KV head; K and V are loaded once, Q,
//     dO and the q block's lse and delta rows stream through the ring.
//  4. kv_split above 1 (any divisor of G, as the wgmma kernel's): float32
//     partials of dk and dv in scratch, summed in split order by a reduce
//     pass.  recurrentgemma-2b's 10|1 heads at B=1 give the dk/dv pass 64
//     CTAs at block_kv 32, the first walking 10 heads x 64 q blocks; split
//     10 ways, 640 CTAs, the longest walk 64 trips.
// Each (block, block) trip computes its scores once.  The CTA's warps are
// kSlabs slabs of 16 rows (dq: q rows; dk/dv: keys) times kGroups groups:
// first a warp scores its slab against its group's share of the other
// block (S and dP, or S^T and dP^T, over all of hd), forms P and dS (P^T
// and dS^T) and stores them float32 to a staged tile; after the barrier it
// takes its slab of the staged tile as the A operand (split at the load)
// for its group's share of hd's columns of dQ (dK and dV).  So no product
// is recomputed for a column chunk, and a CTA has up to 8 warps at every
// tile (the dk/dv pass had 2 or 4 before, and at hd 256 computed S^T and
// dP^T 8 times, once a 32-column chunk).  Tiles are row-padded: the q, k,
// v and do rows by 4 floats (the B loads down a column fall on distinct
// banks), the staged rows by 8 (the A loads' 8-byte pieces).
//
// Sums: the tensor cores' float32 accumulation rounds toward zero, so a sum
// carried in one accumulator over all of S drifts (3e-4 of a row at S =
// 4096, on the card).  So every k-step's three TF32 products are summed
// from zero and added in float32 (round to nearest), and each block's sum
// to the gradient.
//
// Rounding as the JAX _flash_bwd: S and dP stay float32, P and dS too, and
// each gradient is accumulated in float32.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace flash_bwd {

constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kSmemMax = 232448;  // a block's opt-in shared memory on sm_90 (227 KB)

constexpr int min3(int a, int b, int c) { return a < b ? (a < c ? a : c) : (b < c ? b : c); }

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

// The m16n8k8 fragments, split, read from row-major tiles in shared memory;
// k runs in the order (0,2,4,6,1,3,5,7) in A and B alike, so a lane reads
// its two values of a row as one 8-byte load.  A thread is lane (g, t) =
// (lane / 4, lane % 4) of its warp.
struct FragA { uint32_t h[4], l[4]; };
struct FragB { uint32_t h[2], l[2]; };

// A rows g and g + 8 (ra, rb: the tile rows), the k-step at k0 along them.
__device__ __forceinline__ FragA load_a(const float* ra, const float* rb, int k0, int t) {
  const float2 x = *reinterpret_cast<const float2*>(ra + k0 + 2 * t);
  const float2 y = *reinterpret_cast<const float2*>(rb + k0 + 2 * t);
  FragA a;
  split(x.x, a.h[0], a.l[0]);
  split(y.x, a.h[1], a.l[1]);
  split(x.y, a.h[2], a.l[2]);
  split(y.y, a.h[3], a.l[3]);
  return a;
}

// B's column g is the tile row rn, k along the row.
__device__ __forceinline__ FragB load_b_k(const float* rn, int k0, int t) {
  const float2 x = *reinterpret_cast<const float2*>(rn + k0 + 2 * t);
  FragB b;
  split(x.x, b.h[0], b.l[0]);
  split(x.y, b.h[1], b.l[1]);
  return b;
}

// B(k, n) = tile[k][n], k down the rows.
__device__ __forceinline__ FragB load_b_n(const float* tile, int ld, int k0, int n, int t) {
  const float* p = tile + (k0 + 2 * t) * ld + n;
  FragB b;
  split(p[0], b.h[0], b.l[0]);
  split(p[ld], b.h[1], b.l[1]);
  return b;
}

// d += a.b, the k-step's three TF32 products (small terms first) summed
// from zero and added to d in float32 (round to nearest).
__device__ __forceinline__ void mma_rn(float (&d)[4], const FragA& a, const FragB& b) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, a.l, b.h[0], b.h[1]);
  mma_tf32(p, a.h, b.l[0], b.l[1]);
  mma_tf32(p, a.h, b.h[0], b.h[1]);
  asm volatile("" : "+f"(p[0]), "+f"(p[1]), "+f"(p[2]), "+f"(p[3]));  // one k-step at a time
  d[0] += p[0];
  d[1] += p[1];
  d[2] += p[2];
  d[3] += p[3];
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + R) of an (S, hd) matrix whose rows lie `stride`
// floats apart, into R shared rows of LD floats: HD columns in 16-byte
// cp.async pieces, zeros past S and past hd (a multiple of 4).
template <int R, int HD, int LD, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t stride, int row0,
                                          int S, int hd, int tid) {
  constexpr int P = HD / 4;
  for (int c = tid; c < R * P; c += NT) {
    const int r = c / P, col = (c % P) * 4;
    const bool ok = row0 + r < S && col < hd;
    cp_async16(dst + r * LD + col, src + (ok ? static_cast<size_t>(row0 + r) * stride + col : 0),
               ok);
  }
}

// The dq pass's CTA: kSlabs x kGroups warps (kGroups shares of the block's
// keys in the scores, of hd's columns in dQ); Q, dO and the staged dS once,
// K and V a stage.
template <int HD, int BQ, int BKV> struct DqTile {
  static constexpr int kSlabs = BQ / 16;
  static constexpr int kGroups = min3(8 / kSlabs, BKV / 8, HD / 8);
  static constexpr int kThreads = 32 * kSlabs * kGroups;
  static constexpr int kLd = HD + 4;    // q, do, k, v rows (floats)
  static constexpr int kLds = BKV + 8;  // staged dS rows
  static constexpr long long kFixed = 4ll * (2 * BQ * kLd + BQ * kLds);
  static constexpr long long kStage = 4ll * (2 * BKV * kLd);
  static constexpr int kStages = kFixed + 2 * kStage <= kSmemMax ? 2 : 1;
  static constexpr long long kSmem = kFixed + kStages * kStage;
};

// The dk/dv pass's CTA: kSlabs x kGroups warps (kGroups shares of the q
// block's rows in the scores, of hd's columns in dK and dV); K, V and the
// staged P^T and dS^T once, Q, dO, lse and delta a stage.
template <int HD, int BQ, int BKV> struct DkvTile {
  static constexpr int kSlabs = BKV / 16;
  static constexpr int kGroups = min3(8 / kSlabs, BQ / 8, HD / 8);
  static constexpr int kThreads = 32 * kSlabs * kGroups;
  static constexpr int kLd = HD + 4;
  static constexpr int kLds = BQ + 8;  // staged P^T and dS^T rows
  static constexpr long long kFixed = 4ll * (2 * BKV * kLd + 2 * BKV * kLds);
  static constexpr long long kStage = 4ll * (2 * BQ * kLd + 2 * BQ);
  static constexpr int kStages = kFixed + 2 * kStage <= kSmemMax ? 2 : 1;
  static constexpr long long kSmem = kFixed + kStages * kStage;
};

// delta[b, h, s] = sum over hd of do * o, float32: one warp a (b, s, h) row.
__global__ void __launch_bounds__(256) flash_bwd_delta(const float* __restrict__ o,
                                                       const float* __restrict__ dout,
                                                       float* __restrict__ delta, int rows,
                                                       int S, int H, int hd) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp: one row a warp
  const float* op = o + static_cast<size_t>(row) * hd;
  const float* dp = dout + static_cast<size_t>(row) * hd;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(op[c], dp[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int b = row / (S * H), s = (row / H) % S, h = row % H;
    delta[(static_cast<size_t>(b) * H + h) * S + s] = acc;
  }
}

// dk (blockIdx.y 0) or dv (1) = the sum of the kv_split float32 partials
// of n elements each (n a multiple of 4), in split order.
__global__ void __launch_bounds__(256) flash_bwd_reduce(const float* __restrict__ part,
                                                        float* __restrict__ dk,
                                                        float* __restrict__ dv, long long n,
                                                        int kv_split) {
  const float* src = part + blockIdx.y * kv_split * n;
  float* dst = blockIdx.y ? dv : dk;
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
    *reinterpret_cast<float4*>(dst + i) = a;
  }
}

template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(DqTile<HD, BQ, BKV>::kThreads, 1) flash_bwd_dq(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int S, int H, int KV, int hd,
    float scale) {
  using T = DqTile<HD, BQ, BKV>;
  constexpr int LD = T::kLd, LDS = T::kLds, NT = T::kThreads;
  constexpr int NS = BKV / T::kGroups;  // keys of S and dP a warp scores
  constexpr int DC = HD / T::kGroups;   // columns of dQ a warp owns
  constexpr int KS = HD / 8;            // k-steps over hd
  constexpr int KK = BKV / 8;           // k-steps over keys (dS.K)
  constexpr int NP = DC / 8 < 8 ? DC / 8 : 8;  // n-tiles of dQ summed at once
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + BQ * LD;
  float* dss = dos + BQ * LD;  // staged dS, BQ x BKV
  float* ring = dss + BQ * LDS;  // stage s: K, then V

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_step = static_cast<size_t>(H) * hd;
  const size_t kv_step = static_cast<size_t>(KV) * hd;
  const size_t qoff = (static_cast<size_t>(b) * S * H + h) * hd;
  const size_t kvoff = (static_cast<size_t>(b) * S * KV + kvh) * hd;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int slab = warp % T::kSlabs, grp = warp / T::kSlabs;
  const int r0 = q0 + 16 * slab;  // this warp's first row
  const int nkv = (min(S, q0 + BQ) + BKV - 1) / BKV;

  auto load_kv = [&](int j) {
    float* st = ring + (j % T::kStages) * 2 * BKV * LD;
    load_tile<BKV, HD, LD, NT>(st, k + kvoff, kv_step, j * BKV, S, hd, tid);
    load_tile<BKV, HD, LD, NT>(st + BKV * LD, v + kvoff, kv_step, j * BKV, S, hd, tid);
  };
  load_tile<BQ, HD, LD, NT>(qs, q + qoff, q_step, q0, S, hd, tid);
  load_tile<BQ, HD, LD, NT>(dos, dout + qoff, q_step, q0, S, hd, tid);
  load_kv(0);
  cp_commit();
  if (T::kStages == 2) {
    if (nkv > 1) load_kv(1);
    cp_commit();
  }

  const size_t lrow = (static_cast<size_t>(b) * H + h) * S;
  float lse2[2], dl[2];  // rows g and g + 8: lse in the log2 domain, delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    lse2[i] = row < S ? lse[lrow + row] * kLog2e : 0.f;
    dl[i] = row < S ? delta[lrow + row] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  float acc[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* qa = qs + (16 * slab + g) * LD;
  const float* qb = qa + 8 * LD;
  const float* da = dos + (16 * slab + g) * LD;
  const float* db = da + 8 * LD;
  const float* sa = dss + (16 * slab + g) * LDS;
  const float* sb = sa + 8 * LDS;
  const int c0 = grp * NS;  // this warp's first key of the block

  for (int j = 0; j < nkv; ++j) {
    if (T::kStages == 2) {
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // block j (and Q, dO) landed for every thread
    const float* ks = ring + (j % T::kStages) * 2 * BKV * LD;
    const float* vs = ks + BKV * LD;
    const int k0 = j * BKV;

    // S = Q.K^T and dP = dO.V^T, 16 rows x NS keys a warp
    float s[NS / 8][4], dp[NS / 8][4];
#pragma unroll
    for (int n = 0; n < NS / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    if (k0 + c0 <= r0 + 15) {  // else every key is above this warp's rows
#pragma unroll 1
      for (int kk = 0; kk < KS; ++kk) {
        const FragA aq = load_a(qa, qb, 8 * kk, t);
        const FragA ad = load_a(da, db, 8 * kk, t);
#pragma unroll
        for (int n = 0; n < NS / 8; ++n) {
          mma_rn(s[n], aq, load_b_k(ks + (c0 + 8 * n + g) * LD, 8 * kk, t));
          mma_rn(dp[n], ad, load_b_k(vs + (c0 + 8 * n + g) * LD, 8 * kk, t));
        }
      }
    }

    // dS = P * (dP - delta) * scale, P = 0 above the diagonal and past S,
    // to the staged tile
#pragma unroll
    for (int n = 0; n < NS / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + c0 + 8 * n + 2 * t + e;
          const int row = r0 + g + 8 * i;
          float p = exp2f(fmaf(s[n][2 * i + e], scale_log2, -lse2[i]));
          if (key > row || key >= S) p = 0.f;
          ds[e] = p * (dp[n][2 * i + e] - dl[i]) * scale;
        }
        *reinterpret_cast<float2*>(dss + (16 * slab + g + 8 * i) * LDS + c0 + 8 * n + 2 * t) =
            make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();  // the staged dS is whole

    // dq += dS.K over this warp's columns, each block's sum on its own, NP
    // n-tiles at a time (registers)
#pragma unroll
    for (int n0 = 0; n0 < DC / 8; n0 += NP) {
      float part[NP][4];
#pragma unroll
      for (int n = 0; n < NP; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < KK; ++kk) {
        const FragA as = load_a(sa, sb, 8 * kk, t);
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          mma_rn(part[n], as, load_b_n(ks, LD, 8 * kk, grp * DC + 8 * (n0 + n) + g, t));
        }
      }
#pragma unroll
      for (int n = 0; n < NP; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
      }
    }
    __syncthreads();  // every warp is done with block j's stage and the staged dS
    if (j + T::kStages < nkv) load_kv(j + T::kStages);
    cp_commit();
  }

  float* out = dq + qoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      const int col = grp * DC + 8 * n + 2 * t;
      if (col < hd) {
        *reinterpret_cast<float2*>(out + row * q_step + col) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      }
    }
  }
}

template <int HD, int BQ, int BKV, bool kSplit>
__global__ void __launch_bounds__(DkvTile<HD, BQ, BKV>::kThreads, 1) flash_bwd_dkv(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ part, int B, int S, int H, int KV, int hd, int kv_split, float scale) {
  using T = DkvTile<HD, BQ, BKV>;
  constexpr int LD = T::kLd, LDS = T::kLds, NT = T::kThreads;
  constexpr int NS = BQ / T::kGroups;  // q rows of S^T and dP^T a warp scores
  constexpr int DC = HD / T::kGroups;  // columns of dK and dV a warp owns
  constexpr int KS = HD / 8;           // k-steps over hd
  constexpr int KQ = BQ / 8;           // k-steps over rows (P^T.dO, dS^T.Q)
  constexpr int NP = DC / 8 < 4 ? DC / 8 : 4;  // n-tiles of dK and dV summed at once
  constexpr int kStageF = 2 * BQ * LD + 2 * BQ;  // floats of a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + BKV * LD;
  float* pts = vs + BKV * LD;    // staged P^T, BKV x BQ
  float* dss = pts + BKV * LDS;  // staged dS^T
  float* ring = dss + BKV * LDS;  // stage s: Q, dO, then the rows' lse and delta

  const int k0 = blockIdx.x * BKV;  // the keys with the most rows first
  const int kvh = blockIdx.y / kv_split;
  const int split = blockIdx.y % kv_split;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int heads = G / kv_split;          // this CTA's query heads,
  const int h0 = kvh * G + split * heads;  // h0 .. h0 + heads - 1
  const size_t q_step = static_cast<size_t>(H) * hd;
  const size_t kv_step = static_cast<size_t>(KV) * hd;
  const size_t kvoff = (static_cast<size_t>(b) * S * KV + kvh) * hd;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int slab = warp % T::kSlabs, grp = warp / T::kSlabs;
  const int w0 = k0 + 16 * slab;          // this warp's first key
  const int i0 = k0 / BQ;                 // the first q block with a row >= k0
  const int per = (S + BQ - 1) / BQ - i0;  // q blocks a head
  const int trips = heads * per;

  auto load_trip = [&](int n) {  // Q, dO, lse and delta of head h0 + n / per's block
    const int h = h0 + n / per, q0 = (i0 + n % per) * BQ;
    float* st = ring + (n % T::kStages) * kStageF;
    const size_t qoff = (static_cast<size_t>(b) * S * H + h) * hd;
    load_tile<BQ, HD, LD, NT>(st, q + qoff, q_step, q0, S, hd, tid);
    load_tile<BQ, HD, LD, NT>(st + BQ * LD, dout + qoff, q_step, q0, S, hd, tid);
    const size_t lrow = (static_cast<size_t>(b) * H + h) * S;
    for (int r = tid; r < 2 * BQ; r += NT) {
      const int row = q0 + r % BQ;
      const bool ok = row < S;
      cp_async4(st + 2 * BQ * LD + r, (r < BQ ? lse : delta) + (ok ? lrow + row : 0), ok);
    }
  };
  load_tile<BKV, HD, LD, NT>(ks, k + kvoff, kv_step, k0, S, hd, tid);
  load_tile<BKV, HD, LD, NT>(vs, v + kvoff, kv_step, k0, S, hd, tid);
  load_trip(0);
  cp_commit();
  if (T::kStages == 2) {
    if (trips > 1) load_trip(1);
    cp_commit();
  }
  const float scale_log2 = scale * kLog2e;

  float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const float* ka = ks + (16 * slab + g) * LD;
  const float* kb = ka + 8 * LD;
  const float* va = vs + (16 * slab + g) * LD;
  const float* vb = va + 8 * LD;
  const float* pa = pts + (16 * slab + g) * LDS;
  const float* pb = pa + 8 * LDS;
  const float* sa = dss + (16 * slab + g) * LDS;
  const float* sb = sa + 8 * LDS;
  const int c0 = grp * NS;  // this warp's first row of the q block

  for (int n = 0; n < trips; ++n) {
    if (T::kStages == 2) {
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // trip n (and K, V) landed for every thread
    const int q0 = (i0 + n % per) * BQ;
    const float* qs = ring + (n % T::kStages) * kStageF;
    const float* dos = qs + BQ * LD;
    const float* lse_s = dos + BQ * LD;
    const float* dl_s = lse_s + BQ;

    // S^T = K.Q^T and dP^T = V.dO^T, 16 keys x NS rows a warp
    float st[NS / 8][4], dpt[NS / 8][4];
#pragma unroll
    for (int m = 0; m < NS / 8; ++m) {
      st[m][0] = st[m][1] = st[m][2] = st[m][3] = 0.f;
      dpt[m][0] = dpt[m][1] = dpt[m][2] = dpt[m][3] = 0.f;
    }
    if (q0 + c0 + NS - 1 >= w0) {  // else every row is above this warp's keys
#pragma unroll 1
      for (int kk = 0; kk < KS; ++kk) {
        const FragA ak = load_a(ka, kb, 8 * kk, t);
        const FragA av = load_a(va, vb, 8 * kk, t);
#pragma unroll
        for (int m = 0; m < NS / 8; ++m) {
          mma_rn(st[m], ak, load_b_k(qs + (c0 + 8 * m + g) * LD, 8 * kk, t));
          mma_rn(dpt[m], av, load_b_k(dos + (c0 + 8 * m + g) * LD, 8 * kk, t));
        }
      }
    }

    // P^T and dS^T = P^T * (dP^T - delta) * scale; P = 0 where the row is
    // above the key or past S; both to the staged tiles
#pragma unroll
    for (int m = 0; m < NS / 8; ++m) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rl = c0 + 8 * m + 2 * t + e;
          const int row = q0 + rl;
          const int key = w0 + g + 8 * i;
          p[e] = exp2f(fmaf(st[m][2 * i + e], scale_log2, -(lse_s[rl] * kLog2e)));
          if (row < key || row >= S) p[e] = 0.f;
          ds[e] = p[e] * (dpt[m][2 * i + e] - dl_s[rl]) * scale;
        }
        const int at = (16 * slab + g + 8 * i) * LDS + c0 + 8 * m + 2 * t;
        *reinterpret_cast<float2*>(pts + at) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(dss + at) = make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();  // the staged P^T and dS^T are whole

    // dv += P^T.dO and dk += dS^T.Q over this warp's columns, each q
    // block's sums on their own
#pragma unroll
    for (int m0 = 0; m0 < DC / 8; m0 += NP) {  // NP n-tiles at a time (registers)
      float pv[NP][4], pk[NP][4];
#pragma unroll
      for (int m = 0; m < NP; ++m) {
        pv[m][0] = pv[m][1] = pv[m][2] = pv[m][3] = 0.f;
        pk[m][0] = pk[m][1] = pk[m][2] = pk[m][3] = 0.f;
      }
#pragma unroll 1
      for (int kk = 0; kk < KQ; ++kk) {
        const FragA ap = load_a(pa, pb, 8 * kk, t);
        const FragA as = load_a(sa, sb, 8 * kk, t);
#pragma unroll
        for (int m = 0; m < NP; ++m) {
          const int col = grp * DC + 8 * (m0 + m) + g;
          mma_rn(pv[m], ap, load_b_n(dos, LD, 8 * kk, col, t));
          mma_rn(pk[m], as, load_b_n(qs, LD, 8 * kk, col, t));
        }
      }
#pragma unroll
      for (int m = 0; m < NP; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[m0 + m][e] += pv[m][e];
          dka[m0 + m][e] += pk[m][e];
        }
      }
    }
    __syncthreads();  // every warp is done with trip n's stage and the staged tiles
    if (n + T::kStages < trips) load_trip(n + T::kStages);
    cp_commit();
  }

  // kv_split above 1: float32 partials (kv_split, B, S, KV, hd), dk's then
  // dv's, which the reduce pass sums in split order
  const size_t n_part = static_cast<size_t>(B) * S * KV * hd;
  float* dko = kSplit ? part + split * n_part + kvoff : dk + kvoff;
  float* dvo = kSplit ? part + (kv_split + split) * n_part + kvoff : dv + kvoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = w0 + g + 8 * i;
    if (key >= S) continue;
#pragma unroll
    for (int m = 0; m < DC / 8; ++m) {
      const int col = grp * DC + 8 * m + 2 * t;
      if (col < hd) {
        *reinterpret_cast<float2*>(dko + key * kv_step + col) =
            make_float2(dka[m][2 * i], dka[m][2 * i + 1]);
        *reinterpret_cast<float2*>(dvo + key * kv_step + col) =
            make_float2(dva[m][2 * i], dva[m][2 * i + 1]);
      }
    }
  }
}

// The three passes of one tile on `stream`; the launches' cudaGetLastError()
// code (the first that is not success).
template <int HD, int BQ, int BKV>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, void* scratch, int B,
           int S, int H, int KV, int hd, int kv_split, float scale, cudaStream_t stream) {
  using TQ = DqTile<HD, BQ, BKV>;
  using TK = DkvTile<HD, BQ, BKV>;
  auto kq = flash_bwd_dq<HD, BQ, BKV>;
  auto kkv = kv_split > 1 ? flash_bwd_dkv<HD, BQ, BKV, true> : flash_bwd_dkv<HD, BQ, BKV, false>;
  cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(TQ::kSmem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(TK::kSmem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* df = static_cast<const float*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  auto* delta_f = static_cast<float*>(delta);
  const int rows = B * S * H;
  flash_bwd_delta<<<(rows + 7) / 8, 256, 0, stream>>>(static_cast<const float*>(o), df, delta_f,
                                                       rows, S, H, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kq<<<dim3((S + BQ - 1) / BQ, H, B), TQ::kThreads, TQ::kSmem, stream>>>(
      qf, kf, vf, df, lf, delta_f, static_cast<float*>(dq), S, H, KV, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* part = static_cast<float*>(scratch);
  kkv<<<dim3((S + BKV - 1) / BKV, KV * kv_split, B), TK::kThreads, TK::kSmem, stream>>>(
      qf, kf, vf, df, lf, delta_f, static_cast<float*>(dk), static_cast<float*>(dv), part, B, S,
      H, KV, hd, kv_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || kv_split == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * S * KV * hd;
  const long long blocks = (n / 4 + 255) / 256;
  flash_bwd_reduce<<<dim3(static_cast<unsigned>(blocks < 1056 ? blocks : 1056), 2), 256, 0,
                     stream>>>(part, static_cast<float*>(dk), static_cast<float*>(dv), n,
                               kv_split);
  return static_cast<int>(cudaGetLastError());
}

// The instantiated tiles (tile hd, block_q, block_kv): block_q is the dq
// pass's rows and the dk/dv pass's streamed q block, block_kv the other way
// round, each 32 or 64 (16-row slabs); block_kv 32 at hd 256, where (at
// block_q 64) one stage of the ring fits beside the once-loaded tiles.
#define FLASH_BWD_TILES_F32(X)                                                                \
  X(16, 32, 32) X(16, 64, 64)                                                                 \
  X(32, 32, 32) X(32, 64, 64)                                                                 \
  X(64, 32, 32) X(64, 32, 64) X(64, 64, 32) X(64, 64, 64)                                     \
  X(128, 32, 32) X(128, 32, 64) X(128, 64, 32) X(128, 64, 64)                                 \
  X(256, 32, 32) X(256, 64, 32)

// The tile head dim a call at head dim hd runs on (the least of 16, 32, 64,
// 128, 256 at or above it); 0 where hd is not a multiple of 4 up to 256.
inline int tile_hd(int hd) {
  if (hd < 4 || hd > 256 || hd % 4) return 0;
  int t = 16;
  while (t < hd) t *= 2;
  return t;
}

inline int launch_any(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                      void* scratch, int B, int S, int H, int KV, int hd, int bq, int bkv,
                      int kv_split, float scale, void* stream) {
  const int ht = tile_hd(hd);
  if (ht == 0 || KV < 1 || H % KV || S < 1 || B < 1 || kv_split < 1 || (H / KV) % kv_split ||
      (kv_split > 1 && !scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_LAUNCH(HD, BQ, BKV)                                                           \
  if (ht == HD && bq == BQ && bkv == BKV) {                                                      \
    return launch<HD, BQ, BKV>(q, k, v, o, dout, lse, delta, dq, dk, dv, scratch, B, S, H, KV, \
                               hd, kv_split, scale, s);                                         \
  }
  FLASH_BWD_TILES_F32(FLASH_BWD_LAUNCH)
#undef FLASH_BWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The larger of the two passes' dynamic shared memory at head dim hd (must
// equal the Python model), or -1 for a tile not instantiated.
inline long long smem_bytes(int hd, int bq, int bkv) {
  const int ht = tile_hd(hd);
#define FLASH_BWD_SMEM(HD, BQ, BKV)                    \
  if (ht == HD && bq == BQ && bkv == BKV) {             \
    const long long a = DqTile<HD, BQ, BKV>::kSmem;    \
    const long long b = DkvTile<HD, BQ, BKV>::kSmem;   \
    return a > b ? a : b;                               \
  }
  FLASH_BWD_TILES_F32(FLASH_BWD_SMEM)
#undef FLASH_BWD_SMEM
  return -1;
}

}  // namespace flash_bwd
