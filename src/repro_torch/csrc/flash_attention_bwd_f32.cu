// Causal GQA flash attention, backward, float32 (3xTF32 on the tensor
// cores): the instantiations of flash_attention_bwd.cuh and their C entry
// points.
//
// Replaces: src/repro/models/attention.py, _flash_bwd (:260), the custom VJP
// of flash_attention_xla (no Pallas site), for float32; bf16 runs on
// flash_attention_bwd_sm90.cu.
// What bounds it: operations (five causal products, three TF32 products a
// multiply-add).  Design.  Three passes (delta, dq, dk/dv) and a reduce of
// the kv_split partials, on mma.sync with no atomics, each product computed
// once: the notes are in flash_attention_bwd.cuh.
#include "flash_attention_bwd.cuh"

// dq, dk, dv of causal GQA attention from q, k, v, o, do (float32,
// (B,S,heads,hd)) and lse (float32, (B,H,S)); delta is float32 (B,H,S)
// scratch the call writes, scratch the kv_split > 1 partials (the bytes
// flash_attention_bwd_sm90_scratch_bytes gives, null at kv_split 1).
// Returns the launches' cudaGetLastError() code, or cudaErrorInvalidValue
// for a tile not instantiated, a kv_split that does not divide H/KV, or
// shapes it does not take.
extern "C" int flash_attention_bwd_f32_launch(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, const void* lse,
                                              void* delta, void* dq, void* dk, void* dv,
                                              void* scratch, int B, int S, int H, int KV, int hd,
                                              int bq, int bkv, int kv_split, float scale,
                                              void* stream) {
  return flash_bwd::launch_any(q, k, v, o, dout, lse, delta, dq, dk, dv, scratch, B, S, H, KV,
                               hd, bq, bkv, kv_split, scale, stream);
}

// The dynamic shared memory one launch at head dim hd asks for (the larger
// pass's), or -1 for a tile not instantiated.
extern "C" long long flash_attention_bwd_f32_smem_bytes(int hd, int bq, int bkv) {
  return flash_bwd::smem_bytes(hd, bq, bkv);
}
