// One-token GQA flash-decode over the paged KV pool, for Hopper (sm_90a),
// written by hand.
//
// Replaces the TPU kernel `paged_flash_decode` (`_paged_decode_kernel`) of
// src/repro/kernels/decode_attention.py. Same function: q (B, H, D) against
// k_pages / v_pages (NP+1, P, Hkv, D) read through a per-slot page table
// (B, npages) int32, with per-slot valid lengths (B,): key t of slot b is
// pages[pt[b, t / P], t % P]; keys at or past lengths[b] are never read, so
// table columns j >= ceil(lengths[b] / P) (unreserved columns, which name
// the TRASH page NP) are never touched, and a slot of length 0 gets exact
// zeros. Any page size P is accepted: the 64-key tiles walk logical
// positions and each row is addressed through the table on its own, so P
// need not divide or be divided by the tile. The table may be a column
// slice of a wider table: its rows are `pt_stride` ints apart.
//
// The TPU kernel's grid walked one page per step, each page's DMA aimed by
// a scalar-prefetched table. Here each lane group resolves its row through
// the table and loads it as in the slot-cache kernel; the kernel body is
// decode_kernel.cuh's, shared with flash_decode.cu, with the same fixed
// 256-key split boundaries, so a slot's keys are summed in the same order
// as in the slot cache and both give the same bits. That header describes
// the design and what bounds it on the H100 (the live K/V bytes over the
// memory rate).

#include "decode_kernel.cuh"

// q (B, H, D); k_pages, v_pages (NP+1, P, Hkv, D); page_table (B, npages)
// int32 with rows pt_stride apart; lengths (B,) int32; part (B, H,
// nsplit, D) and part_ml (B, H, nsplit, 2) f32 scratch, nsplit =
// ceil(npages * P / 256); out (B, H, D). The pools 16-byte aligned.
// Returns the CUDA error code of the launches (0 = success).
extern "C" int paged_flash_decode_fwd(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const int* page_table,
                                      long long pt_stride, int npages,
                                      int page_size, const int* lengths,
                                      void* part, void* part_ml, void* out,
                                      int B, int H, int Hkv, int D,
                                      int nsplit, float scale, int dtype,
                                      void* stream) {
  if (npages < 1 || page_size < 1 || pt_stride < npages)
    return cudaErrorInvalidValue;
  repro::decode::PagedRows rows{page_table, pt_stride, npages, page_size};
  return repro::decode::launch_any(q, k_pages, v_pages, rows, lengths,
                                   nullptr, part, part_ml, out, nullptr, B, H,
                                   Hkv, D, nsplit, scale, dtype, stream);
}
