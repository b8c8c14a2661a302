// Shared pieces of the two scan kernels (ssm_scan.cu, rglru_scan.cu):
// element types, cp.async staging of G-byte pieces, the fast exp2.
//
// The scans take float32 or bf16 inputs and compute in float32.  Their
// tiles stage global rows into shared memory with cp.async, in pieces of
// G bytes: 16, 8 or 4 where the rows' sizes and addresses allow it, and 2
// (a bf16 row of odd length) as a plain load and store, since cp.async has
// no 2-byte form.  The host picks G once per launch with copy_bytes().
#pragma once

#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace scan {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The 4 / sizeof(T) values one 32-bit word holds, exactly, in order.
template <typename T>
__device__ __forceinline__ void unpack(uint32_t w, float* out);
template <>
__device__ __forceinline__ void unpack<float>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

// K consecutive elements of shared memory at p, as floats, in the widest
// loads their K * sizeof(T) bytes allow (p is aligned to that, up to 16).
template <typename T, int K>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[K]) {
  constexpr int kBytes = K * static_cast<int>(sizeof(T));
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(T));
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int v = 0; v < kBytes / 16; ++v) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[v];
      unpack<T>(w.x, out + (4 * v + 0) * kPerWord);
      unpack<T>(w.y, out + (4 * v + 1) * kPerWord);
      unpack<T>(w.z, out + (4 * v + 2) * kPerWord);
      unpack<T>(w.w, out + (4 * v + 3) * kPerWord);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    unpack<T>(w.x, out);
    unpack<T>(w.y, out + kPerWord);
  } else if constexpr (kBytes == 4) {
    unpack<T>(*reinterpret_cast<const uint32_t*>(p), out);
  } else {
    out[0] = to_f32(p[0]);
  }
}

// 2^v on the SFU: one MUFU.EX2 (inputs and outputs below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// One G-byte piece from global to shared memory: cp.async for 16, 8 and 4
// bytes (16 bypasses L1), a plain load and store for 2.
__device__ __forceinline__ void copy_piece(void* dst, const void* src, int G) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (G) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
      break;
    default:
      *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One G-byte piece from shared to global memory.
__device__ __forceinline__ void store_piece(void* dst, const void* src, int G) {
  switch (G) {
    case 16: *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src); break;
    case 8: *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src); break;
    case 4: *static_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src); break;
    default: *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

__host__ __device__ constexpr long long align16(long long bytes) { return (bytes + 15) / 16 * 16; }

// The largest piece, 16 bytes down to the element size, that divides every
// size and address in `parts` (row lengths, row strides, pointers in bytes).
inline int copy_bytes(int elt, std::initializer_list<unsigned long long> parts) {
  for (int g = 16; g > elt; g /= 2) {
    bool ok = true;
    for (unsigned long long v : parts) ok = ok && v % g == 0;
    if (ok) return g;
  }
  return elt;
}

}  // namespace scan
