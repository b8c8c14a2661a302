// Causal GQA flash attention, backward, float32 (3xTF32 on the tensor
// cores): the instantiations of flash_attention_bwd.cuh for float and their
// C entry points.
//
// Replaces: src/repro/models/attention.py, _flash_bwd (:260), the custom VJP
// of flash_attention_xla (no Pallas site).
// What bounds it: operations (five causal products, three TF32 products a
// multiply-add).  Design.  As flash_attention_bwd.cu's: the notes are in
// flash_attention_bwd.cuh.
#include "flash_attention_bwd.cuh"

// As flash_attention_bwd_bf16_launch, for float32 q, k, v, o, do, dq, dk, dv.
extern "C" int flash_attention_bwd_f32_launch(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, const void* lse,
                                              void* delta, void* dq, void* dk, void* dv, int B,
                                              int S, int H, int KV, int hd, int bq, int bkv,
                                              float scale, void* stream) {
  return flash_bwd::launch_any<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, hd,
                                      bq, bkv, scale, stream);
}

extern "C" long long flash_attention_bwd_f32_smem_bytes(int hd, int bq, int bkv) {
  return flash_bwd::smem_bytes<float>(hd, bq, bkv);
}
