// One-token GQA flash-decode over the contiguous slot cache, for Hopper
// (sm_90a), written by hand.
//
// Replaces the TPU kernel `flash_decode` (`_decode_kernel`) of
// src/repro/kernels/decode_attention.py. Same function: q (B, H, D) against
// cache_k / cache_v (B, Skv, Hkv, D) with per-slot valid lengths (B,);
// keys at or past lengths[b] are never read, a slot with length 0 (or with
// active[b] == 0) gets exact zeros. Any Skv is accepted (the reference's
// "Skv <= 512 or a multiple of 512" guard is gone).
//
// The kernel body is decode_kernel.cuh's, shared with paged_flash_decode.cu:
// the slot cache is its identity table (key t of slot b is row b * Skv + t).
// That header describes the design (split-KV at fixed 256-key boundaries
// with a combine pass) and what bounds it on the H100.

#include "decode_kernel.cuh"

// q (B, H, D); cache_k, cache_v (B, Skv, Hkv, D); lengths (B,) int32;
// active (B,) uint8 or null; part (B, H, nsplit, D) and part_ml (B, H,
// nsplit, 2) f32 scratch, nsplit = ceil(Skv / 256); out (B, H, D); lse
// (B, H) f32, or null for none: each (slot, head)'s log-sum-exp of the
// scaled scores over its live keys, -inf for a slot with none. K and V
// 16-byte aligned. Returns the CUDA error code of the launches (0 =
// success).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const int* lengths,
                                const unsigned char* active, void* part,
                                void* part_ml, void* out, void* lse, int B,
                                int H, int Hkv, int Skv, int D, int nsplit,
                                float scale, int dtype, void* stream) {
  return repro::decode::launch_any(q, k, v, repro::decode::ContiguousRows{Skv},
                                   lengths, active, part, part_ml, out, lse,
                                   B, H, Hkv, D, nsplit, scale, dtype, stream);
}
