// Causal GQA flash attention, forward, float32, on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// _flash_kernel (launched by flash_attention through pl.pallas_call), for
// float32 inputs; bf16 runs on the tensor cores (flash_attention_sm90.cu).
//
// q (B,S,H,hd), k/v (B,S,KV,hd) float32; KV head = h / (H/KV).  Online
// softmax with float32 m, l and acc; keys >= S score NEG_INF = -0.7*FLT_MAX;
// rows >= S are never stored.
//
// What bounds it: operations.  At tinyllama width (S=2048, H=32, hd=64)
// causal attention is ~17.2 GFLOP.  The products run on the CUDA cores in
// float32 (plain FMAs): TF32 tensor cores keep a 10-bit mantissa, which
// would not hold the float32 tolerance.
//
// Design.  One CTA per (q block, head, batch).  The TPU carried m/l/acc
// from one grid step to the next along the KV axis; Hopper runs CTAs in no
// order, so block_kv is a loop inside the CTA.  Shared memory holds the q
// tile, the K and V tiles, the score tile and the f32 accumulator, which is
// what smem_bytes (and the Python vmem model) counts; tile sizes are runtime
// ints, and the emitted space only holds tiles whose bytes fit the opt-in
// limit.  KV blocks entirely above the diagonal are skipped: in the TPU
// kernel they leave m, l and acc unchanged (p = 0, alpha = 1).  Tail keys
// are masked in the kernel and tail rows are never stored, so nothing is
// padded in HBM.  Tile rows are padded by one 32-bit word so the column
// walks of the score product fall in distinct banks.
#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -0.7f * FLT_MAX;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// Row stride of a q/k/v tile in elements: one extra 32-bit word per row.
template <typename T, int HD> __host__ __device__ constexpr int tile_ld() {
  return HD + static_cast<int>(4 / sizeof(T));
}

template <typename T, int HD>
size_t smem_bytes(int bq, int bkv) {
  const size_t floats = static_cast<size_t>(bq) * bkv + static_cast<size_t>(bq) * HD + 3 * bq;
  const size_t elems = static_cast<size_t>(bq + 2 * bkv) * tile_ld<T, HD>();
  return floats * sizeof(float) + elems * sizeof(T);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int H, int KV, int bq, int bkv, float scale,
    int causal) {
  constexpr int LD = tile_ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_t = reinterpret_cast<float*>(smem);   // bq x bkv scores / p
  float* acc = s_t + bq * bkv;                    // bq x HD
  float* m_t = acc + bq * HD;                     // bq
  float* l_t = m_t + bq;                          // bq
  float* a_t = l_t + bq;                          // bq: this block's alpha
  T* q_t = reinterpret_cast<T*>(a_t + bq);        // bq x LD
  T* k_t = q_t + bq * LD;                         // bkv x LD
  T* v_t = k_t + bkv * LD;                        // bkv x LD

  const int q0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int rows = min(bq, S - q0);
  const size_t q_step = static_cast<size_t>(H) * HD;   // between positions
  const size_t kv_step = static_cast<size_t>(KV) * HD;
  const T* qg = q + (static_cast<size_t>(b) * S * H + h) * HD;
  const T* kg = k + (static_cast<size_t>(b) * S * KV + kvh) * HD;
  const T* vg = v + (static_cast<size_t>(b) * S * KV + kvh) * HD;
  T* og = o + (static_cast<size_t>(b) * S * H + h) * HD;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const T zero = from_f<T>(0.0f);

  for (int i = tid; i < bq * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    q_t[r * LD + d] = r < rows ? qg[static_cast<size_t>(q0 + r) * q_step + d] : zero;
    acc[i] = 0.0f;
  }
  for (int r = tid; r < bq; r += kThreads) {
    m_t[r] = kNegInf;
    l_t[r] = 0.0f;
  }
  // causal: keys past this block's last row never score
  const int kv_end = causal ? min(S, q0 + bq) : S;
  const int nkv = (kv_end + bkv - 1) / bkv;

  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * bkv;
    __syncthreads();  // the previous block's readers of k_t/v_t/s_t are done
    for (int i = tid; i < bkv * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const bool ok = k0 + c < S;
      const size_t g = static_cast<size_t>(k0 + c) * kv_step + d;
      k_t[c * LD + d] = ok ? kg[g] : zero;
      v_t[c * LD + d] = ok ? vg[g] : zero;
    }
    __syncthreads();

    // s = q k^T * scale, masked (f32 accumulation)
    for (int i = tid; i < bq * bkv; i += kThreads) {
      const int r = i / bkv, c = i % bkv;
      const T* qr = q_t + r * LD;
      const T* kc = k_t + c * LD;
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot += to_f(qr[d]) * to_f(kc[d]);
      const int key = k0 + c;
      const bool masked = key >= S || (causal && key > q0 + r);
      s_t[i] = masked ? kNegInf : dot * scale;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < bq; r += kThreads / 32) {
      float* sr = s_t + r * bkv;
      float mx = kNegInf;
      for (int c = lane; c < bkv; c += 32) mx = fmaxf(mx, sr[c]);
      mx = warp_max(mx);
      const float m_prev = m_t[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = lane; c < bkv; c += 32) {
        const float p = expf(sr[c] - m_new);
        sum += p;
        sr[c] = to_f(from_f<T>(p));  // p in v's type for p.V; l keeps f32 p
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_t[r] = l_t[r] * alpha + sum;
        m_t[r] = m_new;
        a_t[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v
    for (int i = tid; i < bq * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const float* pr = s_t + r * bkv;
      float a = acc[i] * a_t[r];
      for (int c = 0; c < bkv; ++c) a += pr[c] * to_f(v_t[c * LD + d]);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    og[static_cast<size_t>(q0 + r) * q_step + d] = from_f<T>(acc[i] / l_t[r]);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int bq, int bkv, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(bq, bkv);
  auto kernel = flash_fwd<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + bq - 1) / bq, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KV, bq, bkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int S, int H, int KV, int bq, int bkv, float scale,
                int causal, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, bq, bkv, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, bq, bkv, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, bq, bkv, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, bq, bkv, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32 (bf16 has its own entry, flash_attention_sm90_launch).
// Returns the launch's cudaGetLastError()
// code, cudaErrorInvalidValue for a head_dim, dtype or tile it does not take.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int H, int KV, int hd, int bq, int bkv, float scale, int causal,
    void* stream) {
  if (bq < 1 || bkv < 1 || KV < 1 || H % KV || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(hd, q, k, v, o, B, S, H, KV, bq, bkv, scale, causal, s);
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

// The dynamic shared memory one launch asks for (must equal the Python
// vmem model), or -1 for an unsupported dtype/head_dim.
extern "C" long long flash_attention_smem_bytes(int dtype, int hd, int bq, int bkv) {
  if (dtype == 0) {
    switch (hd) {
      case 16: return smem_bytes<float, 16>(bq, bkv);
      case 32: return smem_bytes<float, 32>(bq, bkv);
      case 64: return smem_bytes<float, 64>(bq, bkv);
      case 128: return smem_bytes<float, 128>(bq, bkv);
    }
  }
  return -1;
}
