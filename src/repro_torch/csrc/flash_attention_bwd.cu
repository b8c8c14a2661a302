// Causal GQA flash attention, backward, bf16 at tile head dim 256: the
// instantiations of flash_attention_bwd.cuh for __nv_bfloat16 (its hd-256
// tiles alone; every smaller head dim runs on flash_attention_bwd_sm90.cu)
// and their C entry points (the float32 ones are in
// flash_attention_bwd_f32.cu, built beside this file so the two compile at
// once).
//
// Replaces: src/repro/models/attention.py, _flash_bwd (:260), the custom VJP
// of flash_attention_xla (no Pallas site).
// What bounds it: operations (five causal products).  Design.  Three
// passes (delta, dq, dk/dv) on mma.sync with no atomics: the notes are in
// flash_attention_bwd.cuh.
#include "flash_attention_bwd.cuh"

// dq, dk, dv of causal GQA attention from q, k, v, o, do (bf16, (B,S,heads,hd))
// and lse (float32, (B,H,S)); delta is float32 (B,H,S) scratch the call
// writes.  Returns the launches' cudaGetLastError() code, or
// cudaErrorInvalidValue for a tile not instantiated or shapes it does not take.
extern "C" int flash_attention_bwd_bf16_launch(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, const void* lse,
                                               void* delta, void* dq, void* dk, void* dv, int B,
                                               int S, int H, int KV, int hd, int bq, int bkv,
                                               float scale, void* stream) {
  return flash_bwd::launch_any<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                                              KV, hd, bq, bkv, scale, stream);
}

// The dynamic shared memory one launch at head dim hd asks for (the larger
// pass's), or -1 for a tile not instantiated.
extern "C" long long flash_attention_bwd_bf16_smem_bytes(int hd, int bq, int bkv) {
  return flash_bwd::smem_bytes<__nv_bfloat16>(hd, bq, bkv);
}
