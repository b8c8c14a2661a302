// Causal GQA flash attention, forward, float32, on the tensor cores (3xTF32).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// _flash_kernel (launched by flash_attention through pl.pallas_call), for
// float32 inputs; bf16 runs on flash_attention_sm90.cu.
//
// q (B,S,H,hd), k/v (B,S,KV,hd) float32; KV head = h / (H/KV).  Online
// softmax with float32 m, l and acc; keys >= S and keys above the diagonal
// score NEG_INF = -0.7*FLT_MAX; rows >= S are never stored.
//
// Head dims.  hd is a run-time value, any multiple of 4 up to 256 (a row
// of whole 16-byte pieces); the kernel runs on the least tile head dim
// HD in {16, 32, 64, 128, 256} at or above it.  Row strides and the output
// store use hd; the tile's columns at or past hd load as zeros (the
// cp.async zero-fill form), add nothing to Q.K^T, and are never stored.
// They are computed like any other column: skipping the k-steps and
// n-tiles past hd (a branch the same for every thread) made ptxas spill one
// tile (hd 32, (64, 64)).
//
// What bounds it: operations.  At tinyllama width (S=2048, H=32, hd=64)
// causal attention is ~17.2 GFLOP.  A TF32 product keeps 10 mantissa bits,
// too few for the float32 tolerance, so every product is split as CUTLASS's
// FastF32 splits it: x = hi + lo with hi = x rounded to TF32 (to nearest),
// lo = x - hi (which the tensor core truncates to TF32), and
// a.b = lo_a.hi_b + hi_a.lo_b + hi_a.hi_b accumulated in float32, small
// terms first; only lo_a.lo_b (~2^-21 relative) is dropped.  Three TF32
// products a multiply-add: the bound is 3 x flops / the TF32 peak.
//
// Design.  One CTA per (q block, head, batch); q blocks run from the last
// (the longest causal walk) to the first.  Each warp owns 16 query rows, the
// m of mma.sync.m16n8k8.tf32, so BQ = 16 x warps.  The q tile stays in
// shared memory for the whole walk and is split as it is read (registers
// hold only the S and O accumulators: a q fragment kept in registers, raw
// and split, spilled at hd 64 and above).  K and V tiles of BKV keys come
// through a 2-stage shared-memory ring filled with 16-byte cp.async pieces
// (zeros past S), so the loads of block j+1 run under the products of block
// j; TMA would save the address arithmetic but needs the mbarrier phase
// bookkeeping for the same overlap, and the copies are not what bounds the
// kernel.
// S = Q.K^T runs over hd in k-steps of 8, the softmax runs on the S
// accumulator in registers (row max and sum over the 4 lanes of a quad),
// and O += P.V takes P straight from that accumulator: the contraction
// order within each group of 8 keys is (0,2,4,6,1,3,5,7), so the lane that
// holds S columns 2t, 2t+1 holds exactly P's A fragment (columns t, t+4),
// and V's B fragment reads keys 2t, 2t+1 of its (key, hd) rows: no shuffle,
// no transpose.  Q and K take the same order over hd, so a lane reads its
// two Q or K values as one 8-byte load.  Rows are padded (Q and K by 8
// floats, V by 4) so the fragment loads of a warp fall on distinct banks.
// Blocks wholly above a warp's diagonal are skipped by that warp; only
// blocks that cross the diagonal or S are masked.
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, int BQ, int BKV> struct Tile {
  static constexpr int kWarps = BQ / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLdk = HD + 8;  // Q, K row stride (floats): 8-byte loads on distinct banks
  static constexpr int kLdv = HD + 4;  // V row stride: rows 2t, 2t+1, column g on distinct banks
  static constexpr int kQ = BQ * kLdk;
  static constexpr int kStage = BKV * (kLdk + kLdv);
  static constexpr size_t kSmem = (kQ + 2 * static_cast<size_t>(kStage)) * sizeof(float);
};

// x rounded to TF32 (to nearest, ties away) and the rest, as CUTLASS's
// round_half_ulp_truncate: the tensor core reads the top 19 bits of each.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in 3xTF32, small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(Tile<HD, BQ, BKV>::kThreads) flash_fwd_tf32x3(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int S, int H, int KV, int hd, float scale_log2, int causal) {
  using T = Tile<HD, BQ, BKV>;
  constexpr int KS = HD / 8;   // k-steps of S = Q.K^T, n-tiles of O
  constexpr int NT = BKV / 8;  // n-tiles of S, k-steps of O += P.V
  extern __shared__ __align__(16) float smem[];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_step = static_cast<size_t>(H) * hd;
  const size_t kv_step = static_cast<size_t>(KV) * hd;
  const float* kg = k + (static_cast<size_t>(b) * S * KV + kvh) * hd;
  const float* vg = v + (static_cast<size_t>(b) * S * KV + kvh) * hd;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 16 * warp;  // this warp's first row

  // the q tile (zeros past S and hd), in the first group with K and V of block 0
  {
    const float* qg = q + (static_cast<size_t>(b) * S * H + h) * hd;
    for (int c = tid; c < BQ * HD / 4; c += T::kThreads) {
      const int row = c / (HD / 4), col = 4 * (c % (HD / 4));
      const bool ok = q0 + row < S && col < hd;
      cp_async16(smem + row * T::kLdk + col, qg + (ok ? (q0 + row) * q_step + col : 0), ok);
    }
  }

  // K and V tiles of block j into stage j & 1, 16 bytes a piece (zeros
  // past S and hd)
  const int nkv = ((causal ? min(S, q0 + BQ) : S) + BKV - 1) / BKV;
  auto stage = [&](int j) {
    float* ks = smem + T::kQ + (j & 1) * T::kStage;
    float* vs = ks + BKV * T::kLdk;
    const int k0 = j * BKV;
    for (int c = tid; c < BKV * HD / 4; c += T::kThreads) {
      const int row = c / (HD / 4), col = 4 * (c % (HD / 4));
      const bool ok = k0 + row < S && col < hd;
      const size_t gofs = ok ? static_cast<size_t>(k0 + row) * kv_step + col : 0;
      cp_async16(ks + row * T::kLdk + col, kg + gofs, ok);
      cp_async16(vs + row * T::kLdv + col, vg + gofs, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0);
  // this warp's rows g and g + 8 of the q tile, hd in the order (2t, 2t+1)
  // of each k-step
  const float* qa = smem + (16 * warp + g) * T::kLdk + 2 * t;
  const float* qb = qa + 8 * T::kLdk;

  float acc[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8, raw score units
  float l[2] = {0.f, 0.f};          // this lane's part of the row sums

  for (int j = 0; j < nkv; ++j) {
    if (j + 1 < nkv) {
      stage(j + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int k0 = j * BKV;
    if (!causal || k0 <= r0 + 15) {
      const float* ks = smem + T::kQ + (j & 1) * T::kStage;
      const float* vs = ks + BKV * T::kLdk;

      // S = Q.K^T
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        uint32_t ah[4], al[4];
        const float2 za = *reinterpret_cast<const float2*>(qa + 8 * i);
        const float2 zb = *reinterpret_cast<const float2*>(qb + 8 * i);
        split(za.x, ah[0], al[0]);
        split(zb.x, ah[1], al[1]);
        split(za.y, ah[2], al[2]);
        split(zb.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 kk = *reinterpret_cast<const float2*>(ks + (8 * n + g) * T::kLdk + 8 * i + 2 * t);
          mma3(s[n], ah, al, kk.x, kk.y);
        }
      }

      // keys past S or above the diagonal score NEG_INF
      if (k0 + BKV > S || (causal && k0 + BKV - 1 > r0)) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const int row = r0 + g + 8 * (e >> 1);
            if (key >= S || (causal && key > row)) s[n][e] = kNegInf;
          }
        }
      }

      // online softmax on the accumulator: exp2 of (s - m) * scale * log2(e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        const float mc = m_new * scale_log2;
        const float alpha = exp2f(fmaf(m[r], scale_log2, -mc));
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = exp2f(fmaf(s[n][e], scale_log2, -mc));
            s[n][e] = p;
            sum += p;
          }
        }
        l[r] = fmaf(l[r], alpha, sum);
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          acc[i][2 * r] *= alpha;
          acc[i][2 * r + 1] *= alpha;
        }
      }

      // O += P.V: S's accumulator of n-tile n is P's A fragment of k-step n
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t ph[4], pl[4];
        split(s[n][0], ph[0], pl[0]);
        split(s[n][2], ph[1], pl[1]);
        split(s[n][1], ph[2], pl[2]);
        split(s[n][3], ph[3], pl[3]);
        const float* v0 = vs + (8 * n + 2 * t) * T::kLdv + g;
#pragma unroll
        for (int i = 0; i < KS; ++i) mma3(acc[i], ph, pl, v0[8 * i], v0[T::kLdv + 8 * i]);
      }
    }
    __syncthreads();  // every warp is done with stage j & 1 before it refills
  }

  // columns 2t, 2t + 1 of k-step i: both below hd or both past it (hd is
  // a multiple of 4)
  float* og = o + (static_cast<size_t>(b) * S * H + h) * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const float inv = 1.0f / quad_sum(l[r]);
    if (row < S) {
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        if (8 * i + 2 * t < hd) {
          *reinterpret_cast<float2*>(og + row * q_step + 8 * i + 2 * t) =
              make_float2(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
        }
      }
    }
  }
}

template <int HD, int BQ, int BKV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
           int hd, float scale, int causal, cudaStream_t stream) {
  using T = Tile<HD, BQ, BKV>;
  auto kernel = flash_fwd_tf32x3<HD, BQ, BKV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, KV, hd, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of this tile one SM holds at once (registers, shared memory and
// threads, as CUDA's occupancy calculator counts them), or -1 on error.
template <int HD, int BQ, int BKV> int ctas_per_sm() {
  using T = Tile<HD, BQ, BKV>;
  auto kernel = flash_fwd_tf32x3<HD, BQ, BKV>;
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(T::kSmem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, T::kThreads, T::kSmem) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}

// The instantiated tiles (tile hd, block_q, block_kv): block_kv <= 64 at
// hd 128, where two stages of 128-key tiles would not fit the shared
// memory, and one tile at hd 256, (64, 32), for the same reason (202 KB).
#define FLASH_F32_TILES(X)                                                                    \
  X(16, 64, 32) X(16, 64, 64) X(16, 64, 128) X(16, 128, 32) X(16, 128, 64) X(16, 128, 128)    \
  X(32, 64, 32) X(32, 64, 64) X(32, 64, 128) X(32, 128, 32) X(32, 128, 64) X(32, 128, 128)    \
  X(64, 64, 32) X(64, 64, 64) X(64, 64, 128) X(64, 128, 32) X(64, 128, 64) X(64, 128, 128)    \
  X(128, 64, 32) X(128, 64, 64) X(128, 128, 32) X(128, 128, 64)                              \
  X(256, 64, 32)

// The tile head dim a call at head dim hd runs on: the least of 16, 32,
// 64, 128, 256 at or above it; 0 where hd is not a multiple of 4 in 4..256.
int tile_hd(int hd) {
  if (hd < 4 || hd > 256 || hd % 4) return 0;
  int t = 16;
  while (t < hd) t *= 2;
  return t;
}

}  // namespace

// dtype: 0 = float32 (bf16 has its own entry, flash_attention_sm90_launch).
// Returns the launch's cudaGetLastError() code, cudaErrorInvalidValue for a
// dtype, head_dim or tile that is not instantiated, or shapes it does not take.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int H, int KV, int hd, int bq, int bkv, float scale, int causal,
    void* stream) {
  const int ht = tile_hd(hd);
  if (dtype != 0 || ht == 0 || KV < 1 || H % KV || S < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_F32_LAUNCH(HD, BQ, BKV)                                           \
  if (ht == HD && bq == BQ && bkv == BKV) {                                     \
    return launch<HD, BQ, BKV>(q, k, v, o, B, S, H, KV, hd, scale, causal, s);  \
  }
  FLASH_F32_TILES(FLASH_F32_LAUNCH)
#undef FLASH_F32_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory one CTA may opt into on `device`
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), or -1 on error.
extern "C" int flash_attention_smem_optin(int device) {
  int value = 0;
  if (cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)
      != cudaSuccess) {
    return -1;
  }
  return value;
}

// The dynamic shared memory one launch at head dim hd asks for (must equal
// the Python model), or -1 for a dtype or tile that is not instantiated.
extern "C" long long flash_attention_smem_bytes(int dtype, int hd, int bq, int bkv) {
  const int ht = tile_hd(hd);
  if (dtype != 0) return -1;
#define FLASH_F32_SMEM(HD, BQ, BKV) \
  if (ht == HD && bq == BQ && bkv == BKV) return Tile<HD, BQ, BKV>::kSmem;
  FLASH_F32_TILES(FLASH_F32_SMEM)
#undef FLASH_F32_SMEM
  return -1;
}

// CTAs of a tile (at head dim hd) one SM of the current device holds at
// once, or -1 for a tile not instantiated.
extern "C" int flash_attention_ctas_per_sm(int hd, int bq, int bkv) {
  const int ht = tile_hd(hd);
#define FLASH_F32_CTAS(HD, BQ, BKV) \
  if (ht == HD && bq == BQ && bkv == BKV) return ctas_per_sm<HD, BQ, BKV>();
  FLASH_F32_TILES(FLASH_F32_CTAS)
#undef FLASH_F32_CTAS
  return -1;
}
