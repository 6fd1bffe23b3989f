// Absorbed-matrix MLA decode over the paged latent pool, for Hopper
// (sm_90a), written by hand.
//
// Replaces the TPU kernel `paged_mla_decode` (`_paged_mla_kernel`) of
// src/repro/kernels/decode_attention.py. Same function: one query token per
// slot, already absorbed through w_uk, q_lat (B, H, R) and its rope part
// q_rope (B, H, Dr), against the compressed latents ckv_pages (NP+1, P, R)
// and the shared rope keys krope_pages (NP+1, P, Dr), read through a
// per-slot page table (B, npages) int32: key t of slot b is row
// pt[b, t / P] * P + t % P. Score (q_lat . c_kv + q_rope . k_rope) * scale,
// f32 online softmax (the reference's -1e30 sentinel, max(l, 1e-30)); the
// value is the latent itself, so the output (B, H, R) stays in latent space
// (the caller applies w_uv and wo), in q's dtype. Keys at or past
// lengths[b] are never read, so table columns j >= ceil(lengths[b] / P)
// (unreserved columns, which name the TRASH page NP) are never touched, and
// a slot of length 0 gets exact zeros. Any page size P; R <= 512 and Dr
// multiples of 8 and both pools 16-byte aligned (the wrapper refuses
// others), so every row is staged in whole 16-byte chunks; the table may be
// a column slice of a wider one (rows `pt_stride` ints apart). f32 or bf16;
// 64-bit offsets.
//
// Two kernels. The partial kernel's grid is (B, ceil(H / 2), S): a block
// takes one slot, two query heads and one of S contiguous ranges of the
// slot's keys (split-KV, "flash-decoding"); a block whose range starts at or
// past the slot's length does no work. It walks its keys in tiles of 32:
// the tile's rows are resolved through the table into shared memory, its
// latent and rope rows are staged there as f32 (32 x (R + Dr)) with 16-byte
// loads, four in flight a thread, each warp scores (head, key) pairs with
// its lanes splitting the R + Dr width, one warp per head runs the online
// softmax, and each thread accumulates P . c_kv into its four (head,
// column) f32 accumulators in registers. It writes its unnormalised (R)
// accumulators and its (m, l) per head. The combine kernel, one block per
// (slot, head), weighs the S partials by exp(m_s - max m) in split order
// (no atomics: the same inputs give the same bits) and divides by
// max(l, 1e-30).
//
// What bounds it on the H100: one token reads each live latent row (R + Dr
// values) once and does ~4 (R + Dr) FLOPs per head per key, so at 16 heads
// the least time is the live latent bytes over the memory rate (DeepSeek's
// 16 x ~512 keys of 1 152 bytes: ~9 MB, ~3 us). The TPU kernel kept a whole
// (H, R) f32 accumulator (16 x 512 x 4 B = 32 KB) in VMEM across its
// sequential page axis; here two heads' (2, R) accumulators sit in
// registers. Why two heads a block and a key split: a grid of B blocks
// fills 16 of the card's 132 SMs at 16 slots; eight head pairs make 128
// blocks, and the wrapper splits the keys until there are about four blocks
// an SM, so the longest slot no longer sets the time alone. The eight head
// pairs of a slot read the same rows, the later reads mostly from the 50 MB
// L2. Tensor cores (the score and P . V products are small GEMMs) and a
// cp.async / TMA double buffer are later work; PERF.md has its times.

#include "common.cuh"

namespace repro {
namespace mla {

constexpr int kBK = 32;                           // keys per tile
constexpr int kThreads = 256;                     // eight warps
constexpr int kHG = 2;                            // query heads per block
constexpr int kMaxR = 512;                        // widest latent taken
constexpr int kAcc = kHG * kMaxR / kThreads;      // accumulators per thread
constexpr int kInFlight = 4;                      // 16-byte loads a thread
constexpr int kMaxSplits = 64;                    // key ranges per slot
constexpr int kCombineThreads = 128;

inline int smem_bytes(int RD) {
  // q (kHG x RD), latent + rope tile (kBK x RD), scores (kHG x kBK),
  // per-head m, l, corr
  return static_cast<int>(sizeof(float)) *
         (kHG * RD + kBK * RD + kHG * kBK + 3 * kHG);
}

// 16 bytes of T (8 bf16 or 4 f32) to f32 in shared memory.
__device__ __forceinline__ void store_chunk(float* dst, uint4 v,
                                            const float*) {
  *reinterpret_cast<uint4*>(dst) = v;
}
__device__ __forceinline__ void store_chunk(float* dst, uint4 v,
                                            const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float4 lo, hi;
  float2 f;
  f = __bfloat1622float2(h[0]); lo.x = f.x; lo.y = f.y;
  f = __bfloat1622float2(h[1]); lo.z = f.x; lo.w = f.y;
  f = __bfloat1622float2(h[2]); hi.x = f.x; hi.y = f.y;
  f = __bfloat1622float2(h[3]); hi.z = f.x; hi.w = f.y;
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_mla_partial(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                  const T* __restrict__ ckv, const T* __restrict__ krope,
                  const int* __restrict__ pt, long long pt_stride,
                  int npages, int page, const int* __restrict__ lengths,
                  float* __restrict__ part, float* __restrict__ part_ml,
                  int H, int R, int Dr, float scale, int split_keys) {
  const int RD = R + Dr;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                 // kHG x RD: [q_lat | q_rope] per head
  float* sk = sq + kHG * RD;        // kBK x RD: [c_kv | k_rope] per key
  float* ss = sk + kBK * RD;        // kHG x kBK scores, then weights
  float* sm = ss + kHG * kBK;       // kHG running max
  float* sl = sm + kHG;             // kHG running sum
  float* sc = sl + kHG;             // kHG correction of the current tile
  __shared__ long long srow[kBK];   // pool row of each tile key, -1 = none

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kHG;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int n_all = max(0, min(lengths[b], npages * page));
  const int t_lo = split * split_keys;
  const int n = min(n_all, t_lo + split_keys);  // this block: [t_lo, n)

  for (int i = tid; i < kHG * RD; i += kThreads) {
    const int g = i / RD, c = i % RD;
    const int h = h0 + g;
    float v = 0.f;
    if (h < H) {
      const long long qh = (long long)b * H + h;
      v = c < R ? to_float(q_lat[qh * R + c])
                : to_float(q_rope[qh * Dr + (c - R)]);
    }
    sq[i] = v;
  }
  if (tid < kHG) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }

  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  // staging in 16-byte chunks: CR latent and Dr / cv rope chunks a row
  constexpr int cv = 16 / sizeof(T);
  const int CR = R / cv;
  const int C = CR + Dr / cv;
  const int total = kBK * C;

  for (int t0 = t_lo; t0 < n; t0 += kBK) {
    __syncthreads();  // the previous tile's reads are done
    if (tid < kBK) {
      const int t = t0 + tid;
      srow[tid] = t < n ? (long long)pt[b * pt_stride + t / page] * page +
                              t % page
                        : -1;
    }
    __syncthreads();
    for (int i0 = tid; i0 < total; i0 += kThreads * kInFlight) {
      uint4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total) {
          const int j = i / C, c = i % C;
          const long long r = srow[j];
          if (r >= 0)
            v[u] = c < CR ? __ldg(reinterpret_cast<const uint4*>(
                                ckv + r * R + c * cv))
                          : __ldg(reinterpret_cast<const uint4*>(
                                krope + r * Dr + (c - CR) * cv));
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads;
        if (i < total) {
          const int j = i / C, c = i % C;
          store_chunk(sk + j * RD + (c < CR ? c * cv : R + (c - CR) * cv),
                      v[u], ckv);
        }
      }
    }
    __syncthreads();

    // scores: a warp per (head, key) pair, its lanes splitting the width
    for (int pr = warp; pr < kHG * kBK; pr += kThreads / 32) {
      const int g = pr / kBK, j = pr % kBK;
      const float* qg = sq + g * RD;
      const float* kj = sk + j * RD;
      float s = 0.f;
      for (int c = lane; c < RD; c += 32) s = fmaf(qg[c], kj[c], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) ss[pr] = (t0 + j < n) ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per head, one key per lane
    if (warp < kHG) {
      const int g = warp;
      const float s = ss[g * kBK + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = (t0 + lane < n) ? expf(s - m_new) : 0.f;
      ss[g * kBK + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sc[g] = corr;
        sl[g] = sl[g] * corr + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // P . c_kv into this thread's (head, column) accumulators
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int i = tid + a * kThreads;
      if (i < kHG * R) {
        const int g = i / R, c = i % R;
        const float* pg = ss + g * kBK;
        float x = acc[a] * sc[g];
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) x = fmaf(pg[j], sk[j * RD + c], x);
        acc[a] = x;
      }
    }
  }
  __syncthreads();  // sm, sl are final (also when the loop never ran)

  // unnormalised partials: part (B, H, S, R), part_ml (B, H, S, 2)
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int i = tid + a * kThreads;
    if (i < kHG * R) {
      const int g = i / R, c = i % R;
      const int h = h0 + g;
      if (h < H) part[(((long long)b * H + h) * S + split) * R + c] = acc[a];
    }
  }
  if (tid < kHG && h0 + tid < H) {
    const long long o = (((long long)b * H + h0 + tid) * S + split) * 2;
    part_ml[o] = sm[tid];
    part_ml[o + 1] = sl[tid];
  }
}

// One block per (slot, head): out = sum_s w_s acc_s / max(sum_s w_s l_s,
// 1e-30), w_s = exp(m_s - max m), in split order.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_mla_combine(const float* __restrict__ part,
                  const float* __restrict__ part_ml, T* __restrict__ out,
                  int R, int S) {
  __shared__ float sw[kMaxSplits];
  __shared__ float sinv;
  const long long bh = blockIdx.x;
  const float* ml = part_ml + bh * S * 2;
  if (threadIdx.x == 0) {
    float mx = kNegInf;
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, ml[2 * s]);
    float l = 0.f;
    for (int s = 0; s < S; ++s) {
      sw[s] = expf(ml[2 * s] - mx);
      l += sw[s] * ml[2 * s + 1];
    }
    sinv = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* p = part + bh * S * R;
  for (int c = threadIdx.x; c < R; c += kCombineThreads) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v = fmaf(sw[s], p[(long long)s * R + c], v);
    out[bh * R + c] = from_float<T>(v * sinv);
  }
}

template <typename T>
cudaError_t launch(const void* q_lat, const void* q_rope, const void* ckv,
                   const void* krope, const int* pt, long long pt_stride,
                   int npages, int page, const int* lengths, float* part,
                   float* part_ml, void* out, int B, int H, int R, int Dr,
                   float scale, int splits, int split_keys,
                   cudaStream_t stream) {
  const int smem = smem_bytes(R + Dr);
  auto kernel = paged_mla_partial<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, (H + kHG - 1) / kHG, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(krope), pt,
      pt_stride, npages, page, lengths, part, part_ml, H, R, Dr, scale,
      split_keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_mla_combine<T><<<B * H, kCombineThreads, 0, stream>>>(
      part, part_ml, static_cast<T*>(out), R, splits);
  return cudaGetLastError();
}

}  // namespace mla
}  // namespace repro

// q_lat (B, H, R); q_rope (B, H, Dr); ckv_pages (NP+1, P, R); krope_pages
// (NP+1, P, Dr); page_table (B, npages) int32 with rows pt_stride apart;
// lengths (B,) int32; part (B, H, splits, R) and part_ml (B, H, splits, 2)
// f32 workspaces; out (B, H, R). Split s covers keys [s * split_keys,
// (s + 1) * split_keys); split_keys is a multiple of 32. R and Dr are
// multiples of 8 and both pools 16-byte aligned. Returns the CUDA error
// code of the launches (0 = success).
extern "C" int paged_mla_decode_fwd(const void* q_lat, const void* q_rope,
                                    const void* ckv_pages,
                                    const void* krope_pages,
                                    const int* page_table, long long pt_stride,
                                    int npages, int page_size,
                                    const int* lengths, void* part,
                                    void* part_ml, void* out, int B, int H,
                                    int R, int Dr, float scale, int splits,
                                    int split_keys, int dtype,
                                    void* stream) {
  if (B == 0 || H == 0) return 0;
  if (npages < 1 || page_size < 1 || pt_stride < npages || R < 1 ||
      R > repro::mla::kMaxR || R % 8 != 0 || Dr < 0 || Dr % 8 != 0 ||
      splits < 1 || splits > repro::mla::kMaxSplits || split_keys < 1 ||
      split_keys % repro::mla::kBK != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == REPRO_BF16)
    return static_cast<int>(repro::mla::launch<__nv_bfloat16>(
        q_lat, q_rope, ckv_pages, krope_pages, page_table, pt_stride, npages,
        page_size, lengths, pa, pm, out, B, H, R, Dr, scale, splits,
        split_keys, st));
  if (dtype == REPRO_F32)
    return static_cast<int>(repro::mla::launch<float>(
        q_lat, q_rope, ckv_pages, krope_pages, page_table, pt_stride, npages,
        page_size, lengths, pa, pm, out, B, H, R, Dr, scale, splits,
        split_keys, st));
  return cudaErrorInvalidValue;
}
