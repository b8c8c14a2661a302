// Causal GQA flash attention, forward, bf16, on Hopper's tensor cores.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// _flash_kernel (launched by flash_attention through pl.pallas_call), for
// bf16 inputs; float32 stays on the CUDA-core kernel in flash_attention.cu
// (TF32 would not hold its tolerance).
//
// q (B,S,H,hd), k/v (B,S,KV,hd) bf16; KV head = h / (H/KV).  Online softmax
// with float32 m, l and acc; l sums the float32 p, and p is rounded to bf16
// before p.V (as the TPU kernel does); keys >= S score NEG_INF =
// -0.7*FLT_MAX; the output is bf16, rows >= S never stored.  KV blocks
// wholly above the diagonal are skipped: in the TPU kernel they leave m, l
// and acc unchanged (p = 0, alpha = 1).
//
// Head dims.  hd is a run-time value, any multiple of 8 up to 256 (a row
// stride of whole 16 bytes, as TMA needs); the kernel runs on the least
// tile head dim HD in {16, 32, 64, 128, 256} at or above it.  The tensor
// maps are encoded with hd as dimension 0, so the box columns at or past hd
// are out of bounds, and TMA fills them with zeros (in the swizzled layout
// the wgmma descriptors read, like any element) and still counts their
// bytes.  Zero columns add nothing to Q.K^T and are computed like any
// other (no branch between the wgmma of one group, which ptxas would
// answer by serialising them); the output store writes only columns below
// hd.
//
// What bounds it: operations.  At tinyllama width (S=2048, H=32, hd=64)
// causal attention is ~17.2 GFLOP against ~18.9 MB of traffic, ~900 flops a
// byte, three times the bf16 tensor-core ridge.  So both products run on
// the tensor cores (wgmma) and the tiles stream in by TMA while the
// previous block computes.
//
// Design.  One CTA per (q block, head, batch), q blocks launched in reverse
// so the rows with the most keys start first.  Each consumer warpgroup owns
// 64 query rows (block_q 64 or 128: one or two warpgroups).  Q is loaded
// once by TMA; K and V tiles of block_kv rows go through a 2-stage ring of
// shared memory, one mbarrier per stage: thread 0 issues the loads of block
// j+1 before the warpgroups compute on block j.  S = Q.K^T is
// wgmma m64n{block_kv}k16 from shared memory; the softmax runs in the
// accumulator registers (a row's max and sum are reduced over the 4 lanes of
// a quad); O += P.V is wgmma m64n{hd}k16 with P taken from registers, its
// f32 accumulator layout converted in place to bf16 A fragments, 16 columns
// at a time, and V read MN-major (the transpose flag).  The epilogue divides
// by l and stores bf16 straight from registers.  Tiles are template
// parameters (a wgmma's n is an immediate); the C entry dispatches the
// instantiated set and refuses any other tile.
//
// Where the hardware is particular, and what this source does:
//  1. Descriptors (hopper.cuh, smem_desc): the swizzle follows a tile
//     row's bytes, HD 16 -> 32 B, 32 -> 64 B, 64 -> 128 B.  An HD-128 or
//     HD-256 row (256 or 512 B) is wider than the 128 B span, so it is
//     loaded as two or four 64-column boxes side by side in shared memory,
//     with a descriptor each.  A k-step of
//     S = Q.K^T moves the start address 32 B along the row, inside the
//     swizzle atom, which holds because every tile is 1024 B aligned.
//  2. wgmma.fence before the products that read registers ordinary code
//     wrote (S after the last softmax, O after the rescale, P after it is
//     built); the group is waited on, and the registers pinned, before S or
//     O is touched.
//  3. The tensor maps are encoded on the host by cuTensorMapEncodeTiled,
//     found through cudaGetDriverEntryPoint (no -lcuda), and passed
//     as __grid_constant__ parameters.  Rows past S arrive as zeros and
//     still count in the barrier's bytes; zero keys score 0, not -inf, so
//     the tail block is masked in the kernel.
//  4. GQA layout: the maps are 4-D over (hd, heads, S, B), so a head's
//     consecutive positions are heads*hd elements apart as a TMA stride;
//     nothing is transposed or copied in HBM.
//  5. Barrier phases: block j waits on stage j%2 with parity (j/2)%2; a
//     CTA with a single KV block never issues the second stage's load.  A
//     __syncthreads() before each load keeps it from overwriting the stage
//     a warpgroup still reads (its wgmma group has been waited on).  The
//     last warpgroup never skips a block, so every phase has been waited on
//     before its stage is armed again.
#include <cfloat>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;
constexpr int kAlign = 1024;        // swizzled tiles start on 1024 B
constexpr int kBarrierBytes = 64;   // the Q barrier and one per stage

template <int HD, int BQ, int BKV> struct Tile {
  static constexpr int kWarpgroups = BQ / 64;
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kBoxCols = HD < 64 ? HD : 64;  // columns of one TMA box
  static constexpr int kBoxes = HD / kBoxCols;        // 2 at HD 128, 4 at 256
  static constexpr int kRowBytes = 2 * kBoxCols;      // the swizzle span
  static constexpr int kQBytes = 2 * BQ * HD;
  static constexpr int kKVBytes = 2 * BKV * HD;       // one K or one V tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  // the tiles, aligned from wherever the dynamic window starts, then barriers
  static constexpr long long kSmem =
      kAlign + kQBytes + kStages * kStageBytes + kBarrierBytes;
};

// Scales one S block into the log2 domain, masks it where `Mask` says, and
// returns the two rows' maxima over this thread's columns.
template <int BKV, bool Mask>
__device__ __forceinline__ void scale_mask(float (&s)[BKV / 2], float (&mx)[2], float scale,
                                           int key0, int row, int S, int causal) {
#pragma unroll
  for (int c = 0; c < BKV / 8; ++c) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * c + 2 * i + e] * scale;
        if (Mask) {
          const int key = key0 + 8 * c + e;
          if (key >= S || (causal && key > row + 8 * i)) x = kNegInf;
        }
        s[4 * c + 2 * i + e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
  }
}

// Row i (0: the thread's first row, 1: the row 8 below) of the thread's
// accumulator columns, divided by the row's sum l, as bf16 pairs from
// `out`; Check stops at column hd (hd a multiple of 8, so a pair is wholly
// below or past it).
template <int Boxes, int BoxCols, bool Check>
__device__ __forceinline__ void store_row(__nv_bfloat16* out,
                                          const float (&acc)[Boxes][BoxCols / 2], int i,
                                          float l, int hd) {
#pragma unroll
  for (int x = 0; x < Boxes; ++x) {
#pragma unroll
    for (int c = 0; c < BoxCols / 8; ++c) {
      if (Check && x * BoxCols + 8 * c >= hd) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + x * BoxCols + 8 * c) =
          __floats2bfloat162_rn(acc[x][4 * c + 2 * i] / l, acc[x][4 * c + 2 * i + 1] / l);
    }
  }
}

template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(Tile<HD, BQ, BKV>::kThreads, 1) flash_fwd_sm90(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, int S, int H,
    int KV, int hd, float scale_log2, int causal) {
  using T = Tile<HD, BQ, BKV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t ring = q_s + T::kQBytes;                       // stage s at s*kStageBytes
  const uint32_t bar = ring + kStages * T::kStageBytes;         // Q, then one per stage

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int nkv = (kv_end + BKV - 1) / BKV;
  const int tid = threadIdx.x;

  // K and V of block j into stage j % 2 (thread 0 only)
  auto load_kv = [&](int j) {
    const uint32_t stage = ring + (j % kStages) * T::kStageBytes;
    const uint32_t full = bar + 8 * (1 + j % kStages);
    mbar_expect_tx(full, T::kStageBytes);
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) {
      const uint32_t off = x * BKV * T::kRowBytes;
      tma_load_4d(stage + off, &kmap, full, x * T::kBoxCols, kvh, j * BKV, b);
      tma_load_4d(stage + T::kKVBytes + off, &vmap, full, x * T::kBoxCols, kvh, j * BKV, b);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(bar + 8 * i, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, T::kQBytes);
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) {
      tma_load_4d(q_s + x * BQ * T::kRowBytes, &qmap, bar, x * T::kBoxCols, h, q0, b);
    }
    load_kv(0);
  }
  __syncthreads();  // the barriers are initialised before anyone waits

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg;                     // this warpgroup's first row
  const int row = row0 + 16 * warp + lane / 4;       // this thread's rows: row, row + 8
  const int col = 2 * (lane % 4);                    // and columns 8c + col + {0, 1}
  const uint32_t q_wg = q_s + 64 * wg * T::kRowBytes;

  float acc[T::kBoxes][T::kBoxCols / 2];
#pragma unroll
  for (int x = 0; x < T::kBoxes; ++x) {
#pragma unroll
    for (int i = 0; i < T::kBoxCols / 2; ++i) acc[x][i] = 0.0f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's columns only; summed over the quad at the end
  mbar_wait(bar, 0);

  for (int j = 0; j < nkv; ++j) {
    if (j > 0) __syncthreads();  // every warpgroup is done with block j - 1's stage
    if (tid == 0 && j + 1 < nkv) load_kv(j + 1);
    __syncwarp();
    const int k0 = j * BKV;
    if (causal && k0 > row0 + 63) continue;  // wholly above this warpgroup's diagonal
    const uint32_t k_s = ring + (j % kStages) * T::kStageBytes;
    const uint32_t v_s = k_s + T::kKVBytes;
    mbar_wait(bar + 8 * (1 + j % kStages), (j / kStages) & 1);

    // S = Q.K^T, f32, 64 x BKV per warpgroup
    float s[BKV / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int x = kk * 16 / T::kBoxCols;
      const int cb = 2 * (kk * 16 % T::kBoxCols);
      Wgmma<BKV>::ss(s, smem_desc(q_wg + x * BQ * T::kRowBytes + cb, T::kRowBytes),
                     smem_desc(k_s + x * BKV * T::kRowBytes + cb, T::kRowBytes), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax in registers, log2 domain
    float mx[2] = {kNegInf, kNegInf};
    const bool mask = (causal && k0 + BKV - 1 > row0) || k0 + BKV > S;
    if (mask) {
      scale_mask<BKV, true>(s, mx, scale_log2, k0 + col, row, S, causal);
    } else {
      scale_mask<BKV, false>(s, mx, scale_log2, k0 + col, row, S, causal);
    }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int c = 0; c < BKV / 8; ++c) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * c + 2 * i + e] - m[i]);
          sum[i] += p;
          s[4 * c + 2 * i + e] = p;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) {
#pragma unroll
      for (int c = 0; c < T::kBoxCols / 8; ++c) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[x][4 * c + 2 * i] *= alpha[i];
          acc[x][4 * c + 2 * i + 1] *= alpha[i];
        }
      }
    }

    // P in bf16: 16 columns of the S accumulator are one A fragment
    uint32_t p[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }

    // O += P.V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < T::kBoxes; ++x) {
        Wgmma<T::kBoxCols>::rs(
            acc[x], p[kk],
            smem_desc(v_s + x * BKV * T::kRowBytes + 16 * kk * T::kRowBytes, T::kRowBytes));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x) fence_regs(acc[x]);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(p[kk]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = row + 8 * i;
    if (r >= S) continue;
    const size_t at = (static_cast<size_t>(b) * S + r) * H + h;
    // a full tile (hd == HD) stores every column unchecked, at a constant
    // row stride, as the kernel did before hd could be less than its tile
    if (hd == HD) {
      store_row<T::kBoxes, T::kBoxCols, false>(o + at * HD + col, acc, i, l[i], HD);
    } else {
      store_row<T::kBoxes, T::kBoxCols, true>(o + at * hd + col, acc, i, l[i], hd);
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime so the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// The (B, S, heads, hd) bf16 tensor at `ptr` as a 4-D map (hd, heads, S, B),
// boxes of (box_cols, 1, rows, 1), swizzled by the box's row bytes; box
// columns at or past hd arrive as zeros.
cudaError_t encode(CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd,
                   int box_cols, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * hd;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1u,
                             static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t step[4] = {1u, 1u, 1u, 1u};
  const int code = swizzle_code(2 * box_cols);
  const CUtensorMapSwizzle swizzle = code == 1   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : code == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD, int BQ, int BKV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
           int hd, float scale, int causal, cudaStream_t stream) {
  using T = Tile<HD, BQ, BKV>;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = encode(&qmap, q, B, S, H, hd, T::kBoxCols, BQ);
  if (err == cudaSuccess) err = encode(&kmap, k, B, S, KV, hd, T::kBoxCols, BKV);
  if (err == cudaSuccess) err = encode(&vmap, v, B, S, KV, hd, T::kBoxCols, BKV);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = flash_fwd_sm90<HD, BQ, BKV>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(qmap, kmap, vmap,
                                                  static_cast<__nv_bfloat16*>(o), S, H, KV, hd,
                                                  scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of this tile one SM holds at once (registers, shared memory and
// threads, as CUDA's occupancy calculator counts them), or -1 on error.
template <int HD, int BQ, int BKV> int ctas_per_sm() {
  using T = Tile<HD, BQ, BKV>;
  auto kernel = flash_fwd_sm90<HD, BQ, BKV>;
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(T::kSmem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, T::kThreads, T::kSmem) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}

// The instantiated tiles (tile hd, block_q, block_kv): block_kv <= 128 at
// hd 128 and <= 64 at hd 256, where S, O and P of 64 rows would not fit 255
// registers otherwise (O alone is 128 a thread at hd 256).
#define FLASH_SM90_TILES(X)                                                                   \
  X(16, 64, 32) X(16, 64, 64) X(16, 64, 128) X(16, 64, 256)                                   \
  X(16, 128, 32) X(16, 128, 64) X(16, 128, 128) X(16, 128, 256)                               \
  X(32, 64, 32) X(32, 64, 64) X(32, 64, 128) X(32, 64, 256)                                   \
  X(32, 128, 32) X(32, 128, 64) X(32, 128, 128) X(32, 128, 256)                               \
  X(64, 64, 32) X(64, 64, 64) X(64, 64, 128) X(64, 64, 256)                                   \
  X(64, 128, 32) X(64, 128, 64) X(64, 128, 128) X(64, 128, 256)                               \
  X(128, 64, 32) X(128, 64, 64) X(128, 64, 128)                                               \
  X(128, 128, 32) X(128, 128, 64) X(128, 128, 128)                                            \
  X(256, 64, 32) X(256, 64, 64) X(256, 128, 32) X(256, 128, 64)

// The tile head dim a call at head dim hd runs on: the least of 16, 32,
// 64, 128, 256 at or above it; 0 where hd is not a multiple of 8 in 8..256.
int tile_hd(int hd) {
  if (hd < 8 || hd > 256 || hd % 8) return 0;
  int t = 16;
  while (t < hd) t *= 2;
  return t;
}

}  // namespace

// Returns the launch's cudaGetLastError() code, cudaErrorInvalidValue for a
// tile not instantiated or shapes the kernel does not take.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* o,
                                           int B, int S, int H, int KV, int hd, int bq, int bkv,
                                           float scale, int causal, void* stream) {
  const int ht = tile_hd(hd);
  if (ht == 0 || KV < 1 || H % KV || S < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_SM90_LAUNCH(HD, BQ, BKV)                                                    \
  if (ht == HD && bq == BQ && bkv == BKV) {                                                \
    return launch<HD, BQ, BKV>(q, k, v, o, B, S, H, KV, hd, scale, causal, s);            \
  }
  FLASH_SM90_TILES(FLASH_SM90_LAUNCH)
#undef FLASH_SM90_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory one launch at head dim hd asks for (must equal
// the Python model), or -1 for a tile not instantiated.
extern "C" long long flash_attention_sm90_smem_bytes(int hd, int bq, int bkv) {
  const int ht = tile_hd(hd);
#define FLASH_SM90_SMEM(HD, BQ, BKV) \
  if (ht == HD && bq == BQ && bkv == BKV) return Tile<HD, BQ, BKV>::kSmem;
  FLASH_SM90_TILES(FLASH_SM90_SMEM)
#undef FLASH_SM90_SMEM
  return -1;
}

// CTAs of a tile (at head dim hd) one SM of the current device holds at
// once, or -1 for a tile not instantiated.
extern "C" int flash_attention_sm90_ctas_per_sm(int hd, int bq, int bkv) {
  const int ht = tile_hd(hd);
#define FLASH_SM90_CTAS(HD, BQ, BKV) \
  if (ht == HD && bq == BQ && bkv == BKV) return ctas_per_sm<HD, BQ, BKV>();
  FLASH_SM90_TILES(FLASH_SM90_CTAS)
#undef FLASH_SM90_CTAS
  return -1;
}
