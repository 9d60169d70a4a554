// PRISM attention for Hopper: one softmax over [local K/V || segment-mean
// K/V], the means carrying an additive bias (log of the tokens each one
// stands for; -1e30 to hide the own partition, future partitions under
// causal attention, and empty segments).
//
// Replaces the TPU kernel `prism_attention_pallas` in
// src/repro/kernels/prism_attention/kernel.py (pallas_call at line 91).
// It computes the function of the plain version (ref.py beside the
// wrapper), for query row i of head h (KV head h / G, G = H / Hk):
//   s_loc[j]  = softcap(q_i . k_j * scale), or -1e30 where key j is
//               masked (kv_mask false, or j > q_offset + i when causal)
//   s_mean[m] = softcap(q_i . km_m * scale) + bias[m]
//   out_i     = softmax([s_loc || s_mean]) . [v || vm]
// Masked scores are the value -1e30 and stay in the softmax, as in the
// plain version: a row whose every key is masked gets uniform weights
// over all Nk + M keys.  (The Pallas kernel clamps its running max at
// -1e29 and gives l = 0, a NaN, on such a row.)  Keys past Nk or M in a
// ragged last tile contribute nothing.
//
// The means are read where the exchange's gather leaves them: a
// [B, P, L, Hk, dh] view, strided over B and P (element strides sb, sp;
// the V means have strides of their own), contiguous inside a partition's
// (L, Hk, dh).  Mean m is (p, l) = (m / L, m % L) and its bias is
// bias[b, m].  The flat [B, M, Hk, dh] form is P = 1, L = M.
//
// Widths.  Queries and keys are DQK wide, values and the output DV: the
// instantiations are (DQK, DV) = (16, 16), (64, 64), (128, 128), and
// (192, 128) for DeepSeek-V2's MLA attention, whose keys are the expanded
// latent (128) beside the shared rotary key (64) and whose values are 128
// wide (128 heads, one per KV head).  Each body is templated on both
// widths: Q K^T runs over DQK, P V and the accumulator over DV.  (16, 16)
// is the reduced configs' width, for small configs on the card, not for
// speed: a row is two 16-byte chunks, swizzled within the row (`swz`), and
// Q K^T is one k-step whose K fragments for two 8-key blocks come from one
// ldmatrix.x4.
//
// Bound: in bf16 at the exchange's shapes, bytes.  It must read q, the
// local K/V, the mean K/V that a query can see, the bias and the mask once
// and write the output, and do 4 flops per (query, key, dim).  For
// ViT-B/16 on two partitions (Nq = Nk = 100, M = 40, dh 64) that is ~58
// flops per byte, below the H100's bf16 ridge (~295): at 3.35 TB/s the
// read is the least time the card needs, ~1.8 us for the batch.  What the
// kernel is up against at that size is what one SM, holding one (batch
// row, KV head), can do alone: move its ~45 KB (at its 1/132 share of
// 3.35 TB/s that takes ~1.8 us, and 96 of the 132 SMs have work) and
// issue its warps' math, whose steps per tile depend on one another (the
// hi + lo split makes P V two thirds of the products).  The design
// overlaps the two and keeps every warp's chain of dependent steps per
// tile short.  Tried on the H100 and dropped: one
// bulk (TMA) copy per 128-byte K/V row in place of 16-byte cp.async (much
// slower), 64-key tiles, branches that skip a ragged tile's empty 8-key
// blocks, and Q staged through shared memory (none faster).
//
// bf16 (mma_body below; the serving and exchange paths):
//   * Warps.  A CTA is up to 8 consumer warps of 16 query rows and one
//     producer warp.  Row r of a (batch row, KV head) is query r / G of
//     head r % G, so the G heads that share a KV head share every K/V
//     tile read (at G = 32 one query spans two warps); a ragged last row
//     block is padded.  `row_plan` in kernel.py picks the consumer warps:
//     the ViT shape (G 1, 100 queries) is one CTA of 7 + 1 warps per
//     (batch row, KV head), 96 CTAs in one wave on 132 SMs.
//   * The producer warp fills a ring of STAGES tiles of TK keys with
//     16-byte cp.async.cg (K and V kept in bf16, chunks XOR-swizzled by
//     key & 7 so that ldmatrix, .trans for V, reads 8 keys at one chunk
//     from 8 bank groups) and, 4 bytes at a time, each tile's key bias:
//     the mean biases, or the kv_mask words over the tile's keys.  Each
//     slot has a full and an empty mbarrier: a lane's copies arrive on
//     the full one when they land (cp.async.mbarrier.arrive.noinc), lane
//     0 arrives with the tile's ordinal, and the consumers arrive on the
//     empty one when done; ordinal -1 ends the sequence.  There is no
//     block barrier in the loop, and a consumer never stalls issuing a
//     copy.  Mean tiles never cross a partition: tile (p, l0) holds means
//     l0 .. l0 + TK - 1 of partition p, contiguous in memory.  Every K/V
//     element is read from device memory once per CTA.
//   * The consumers run both products on the tensor cores: mma.sync
//     m16n8k16, bf16 operands, f32 accumulation of exact bf16 products.
//     Q fragments stay in registers for the whole key loop; `scale` is
//     applied to S in f32 after the product (folding it into bf16 q would
//     round q at dh 128).  Scores, mask, bias, softcap and the online
//     (m, l) live in the mma accumulator layout, in the log2 domain: a
//     lane holds two rows, whose max and sum take two quad shuffles each.
//     P = 2^{S - m} goes from the score registers into the A operand of
//     P V as bf16 hi + lo parts (p - hi is exact in f32 and its bf16
//     rounding is 2^-9 of it), so p keeps ~16 bits: the bf16 output must
//     lie within one bf16 step of the plain version per element, which
//     bf16 p alone misses near zero.  The next tile's S = Q K^T is issued
//     before this tile's softmax, so the two overlap.  The tile math is
//     straight-line code (a ragged tile's missing keys score -inf, their
//     V rows are zero): branches between the products serialised them.
//     mma.sync rather than wgmma: a (batch row, KV head) holds 100 query
//     rows here, and wgmma's 64-row granularity would pad 28 of every 128.
//   * Exact tile skips.  A tile whose every score is exactly -1e30 for
//     every row of the CTA adds exactly 0 once each of those rows has a key
//     scoring above -1e30: two f32 values on either side of -1e30 differ by
//     at least one f32 step there (7.6e22), so 2^{(-1e30 - m) log2 e} is
//     exactly 0 whenever the scores are below 1e22 in size, and a masked
//     tile read before the row's first visible one is scaled by 0 when
//     that one comes.  Two kinds of tile qualify: local tiles wholly in
//     the future of every row of the CTA under causal attention, and mean
//     tiles whose every bias is -1e30 (the own partition, future
//     partitions, empty segments).  The producer reads the row's biases
//     first thing, puts the local tiles that every row reads, then scans
//     the biases for the live mean tiles; if no mean is visible it checks
//     that the CTA's first query sees a local key (under causal attention
//     the later ones see more).  A CTA with a row that sees no key reads
//     every tile, so the uniform-weights rule holds.

// f32 (fma_body below): the CUDA-core body of the first version, kept as it
// was apart from reading the strided means.  A tensor-core product in f32
// would round to TF32, and its check is 1e-5; no main path runs it at
// scale (the ViT and llama paths are bf16).  One CTA of 128 threads per
// (32 query rows, KV head, batch row); 32-key tiles staged in shared
// memory as f32; scores by lane per key, p . V by thread per (row, dim).
//
// Built by repro_torch/kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas=-v
// into a shared library with a plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the JAX package's mask value
constexpr int GMAX = 32;           // most query heads per KV head
constexpr int MAX_DEVICES = 64;

// Where mean m of batch row b starts for KV head 0, in elements.
struct MeanLayout {
  long long sb, sp;                // K means: strides over B and over P
  long long vsb, vsp;              // V means: strides over B and over P
  int P, L;
  __device__ __forceinline__ size_t at(int b, int m, int Hk, int dh) const {
    const int p = m / L, l = m - p * L;
    return (size_t)(b * sb + p * sp) + (size_t)l * Hk * dh;
  }
  __device__ __forceinline__ size_t atv(int b, int m, int Hk, int dv) const {
    const int p = m / L, l = m - p * L;
    return (size_t)(b * vsb + p * vsp) + (size_t)l * Hk * dv;
  }
};

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
namespace fma_body {

constexpr int NT = 128;            // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int R = 32;              // query rows per CTA (G heads x TQ)
constexpr int TK = 32;             // keys per tile (one per lane)
constexpr int RPW = R / NWARPS;    // rows per warp in the softmax

__device__ __forceinline__ void unpack(const uint4& u, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// N floats from `from` to shared memory at `to` (16-byte aligned), 16
// bytes at a time, each scaled by `mul`.
template <int N>
__device__ __forceinline__ void sts(float* to, const float* from,
                                    float mul = 1.f) {
#pragma unroll
  for (int e = 0; e < N; e += 4)
    *reinterpret_cast<float4*>(to + e) =
        make_float4(from[e] * mul, from[e + 1] * mul, from[e + 2] * mul,
                    from[e + 3] * mul);
}

// K rows are padded to DQK + 4 floats (KS in the kernel).
template <int DQK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (R * DQK + TK * (DQK + 4) + TK * DV + R * TK + 4 * R);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(NT)
kernel(const float* __restrict__ q,          // [B, Nq, H, DQK]
       const float* __restrict__ k,          // [B, Nk, Hk, DQK]
       const float* __restrict__ v,          // [B, Nk, Hk, DV]
       const float* __restrict__ km,         // means, see MeanLayout
       const float* __restrict__ vm,
       const float* __restrict__ mean_bias,  // [B, M]
       const uint8_t* __restrict__ kv_mask,  // [B, Nk] or null
       float* __restrict__ out,              // [B, Nq, H, DV]
       int Nq, int Nk, MeanLayout ml, int H, int Hk, int TQ, int causal,
       int q_offset, float scale, float softcap) {
  constexpr int KS = DQK + 4;        // padded K row, in floats
  constexpr int RSTEP = NT / DV;     // rows between a thread's elements
  constexpr int NOUT = R / RSTEP;    // accumulator elements per thread
  constexpr int VEC = 4;             // floats per 16-byte load
  constexpr int QLOADS = R * DQK / VEC / NT;   // q loads per thread
  constexpr int KLOADS = TK * DQK / VEC / NT;  // K loads per thread
  constexpr int VLOADS = TK * DV / VEC / NT;   // V loads per thread
  static_assert(NT % DV == 0 && R % NWARPS == 0 && TK == 32 &&
                QLOADS * VEC * NT == R * DQK &&
                KLOADS * VEC * NT == TK * DQK && VLOADS * VEC * NT == TK * DV,
                "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                      // [R][DQK]  scaled queries
  float* sk = sq + R * DQK;              // [TK][KS]  K tile
  float* sv = sk + TK * KS;              // [TK][DV]  V tile
  float* sp = sv + TK * DV;              // [R][TK]   probabilities
  float* sa = sp + R * TK;               // [R]       rescale of this tile
  float* sm = sa + R;                    // [R]       running max
  float* sl = sm + R;                    // [R]       running sum

  const int q0 = blockIdx.x * TQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hk;
  const int M = ml.P * ml.L;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // queries of the G heads of this KV head, rows r = g * TQ + i
  {
    uint4 raw[QLOADS];
#pragma unroll
    for (int it = 0; it < QLOADS; ++it) {
      const int c = (tid + it * NT) * VEC;
      const int r = c / DQK, d = c % DQK;
      const int g = r / TQ, qi = q0 + r % TQ;
      raw[it] = make_uint4(0, 0, 0, 0);
      if (g < G && qi < Nq)
        raw[it] = *reinterpret_cast<const uint4*>(
            q + (((size_t)b * Nq + qi) * H + hk * G + g) * DQK + d);
    }
#pragma unroll
    for (int it = 0; it < QLOADS; ++it) {
      float f[VEC];
      unpack(raw[it], f);
      sts<VEC>(sq + (tid + it * NT) * VEC, f, scale);
    }
  }
  if (tid < R) {
    sm[tid] = -CUDART_INF_F;
    sl[tid] = 0.f;
  }

  float acc[NOUT];
#pragma unroll
  for (int i = 0; i < NOUT; ++i) acc[i] = 0.f;
  const int d_own = tid % DV;        // this thread's output dim
  const int r_own = tid / DV;        // and its first output row

  const int n_loc = (Nk + TK - 1) / TK;
  const int n_tiles = n_loc + (M + TK - 1) / TK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool is_mean = tile >= n_loc;
    const int j0 = (is_mean ? tile - n_loc : tile) * TK;
    const int n = is_mean ? M : Nk;
    uint4 kraw[KLOADS], vraw[VLOADS];
#pragma unroll
    for (int it = 0; it < KLOADS; ++it) {
      const int c = (tid + it * NT) * VEC;
      const int t = c / DQK, d = c % DQK;
      kraw[it] = make_uint4(0, 0, 0, 0);
      if (j0 + t < n) {
        const size_t src =
            (is_mean ? ml.at(b, j0 + t, Hk, DQK)
                     : ((size_t)b * Nk + j0 + t) * Hk * DQK) +
            (size_t)hk * DQK + d;
        kraw[it] = *reinterpret_cast<const uint4*>((is_mean ? km : k) + src);
      }
    }
#pragma unroll
    for (int it = 0; it < VLOADS; ++it) {
      const int c = (tid + it * NT) * VEC;
      const int t = c / DV, d = c % DV;
      vraw[it] = make_uint4(0, 0, 0, 0);
      if (j0 + t < n) {
        const size_t src =
            (is_mean ? ml.atv(b, j0 + t, Hk, DV)
                     : ((size_t)b * Nk + j0 + t) * Hk * DV) +
            (size_t)hk * DV + d;
        vraw[it] = *reinterpret_cast<const uint4*>((is_mean ? vm : v) + src);
      }
    }
    __syncthreads();                 // the last tile's p . V is done
#pragma unroll
    for (int it = 0; it < KLOADS; ++it) {
      const int c = (tid + it * NT) * VEC;
      float f[VEC];
      unpack(kraw[it], f);
      sts<VEC>(sk + (c / DQK) * KS + c % DQK, f);
    }
#pragma unroll
    for (int it = 0; it < VLOADS; ++it) {
      const int c = (tid + it * NT) * VEC;
      float f[VEC];
      unpack(vraw[it], f);
      sts<VEC>(sv + c, f);           // rows of DV floats, unpadded
    }
    __syncthreads();

    // scores of this warp's rows against key `lane`, then the online
    // softmax of each row across the warp
    const int j = j0 + lane;
    const bool in_range = j < n;
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const float* krow = sk + lane * KS;
#pragma unroll 2
    for (int d = 0; d < DQK; d += 4) {
      const float4 kd = lds4(krow + d);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qd = lds4(sq + (warp + NWARPS * i) * DQK + d);
        s[i] = fmaf(qd.x, kd.x, fmaf(qd.y, kd.y, fmaf(qd.z, kd.z,
                    fmaf(qd.w, kd.w, s[i]))));
      }
    }
    float bias = 0.f;
    bool key_ok = true;
    if (in_range) {
      if (is_mean)
        bias = mean_bias[(size_t)b * M + j];
      else if (kv_mask)
        key_ok = kv_mask[(size_t)b * Nk + j] != 0;
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NWARPS * i;
      float x = s[i];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      if (is_mean) {
        x += bias;
      } else {
        const int qi = q0 + r % TQ;
        if (!key_ok || (causal && q_offset + qi < j)) x = NEG_INF;
      }
      if (!in_range) x = -CUDART_INF_F;
      float tmax = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, tmax);   // finite: key j0 is in range
      const float p = in_range ? expf(x - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sp[r * TK + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        sa[r] = alpha;
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();

    // rescale and accumulate p . V into this thread's (row, dim) elements
#pragma unroll
    for (int i = 0; i < NOUT; ++i) acc[i] *= sa[r_own + RSTEP * i];
#pragma unroll 2
    for (int t = 0; t < TK; t += 4) {
      const float v0 = sv[t * DV + d_own], v1 = sv[(t + 1) * DV + d_own];
      const float v2 = sv[(t + 2) * DV + d_own], v3 = sv[(t + 3) * DV + d_own];
#pragma unroll
      for (int i = 0; i < NOUT; ++i) {
        const float4 pr = lds4(sp + (r_own + RSTEP * i) * TK + t);
        acc[i] = fmaf(pr.x, v0, fmaf(pr.y, v1, fmaf(pr.z, v2,
                      fmaf(pr.w, v3, acc[i]))));
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < NOUT; ++i) {
    const int r = r_own + RSTEP * i;
    const int g = r / TQ, qi = q0 + r % TQ;
    if (g < G && qi < Nq)
      out[(((size_t)b * Nq + qi) * H + hk * G + g) * DV + d_own] =
          acc[i] / sl[r];
  }
}

}  // namespace fma_body

// ---------------------------------------------------------------------------
// bf16: tensor cores, a cp.async ring, exact tile skips
// ---------------------------------------------------------------------------
namespace mma_body {

using bf16 = __nv_bfloat16;

constexpr int TK = 32;             // keys per ring tile
constexpr int STAGES = 6;          // tiles in the ring
constexpr int BPRE = 4;            // biases a producer lane reads first
constexpr int MAX_WARPS = 8;       // consumer warps, 16 query rows each
constexpr int NT_MAX = 32 * (MAX_WARPS + 1);   // and the producer warp

// Copies of 16 and 4 bytes into shared memory; the bytes past `bytes`
// are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// Waits for every cp.async this thread has issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldm(const void* p, uint32_t (&r)[4],
                                    bool trans) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// Where chunk `ch` of row `r` of a tile with CPR 16-byte chunks a row is
// stored: XOR-swizzled by r & 7 within each group of 8 chunks, or, for
// rows of 2 chunks (width 16), by r & 1.
template <int CPR>
__device__ __forceinline__ int swz(int r, int ch) {
  return ch ^ (r & ((CPR < 8 ? CPR : 8) - 1));
}

// mbarriers in shared memory: init, arrive, arrive when this thread's
// cp.async copies so far have landed (not counted in advance: .noinc),
// and wait for the completion of the phase of the given parity.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// 2^x (ex2.approx: 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p0, p1 as bf16 hi + lo parts: hi = bf16(p), lo = bf16(p - hi).
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(p0, p1);
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack(p0 - h.x, p1 - h.y);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <int DQK, int DV>
constexpr size_t ring_bytes() {
  return (size_t)STAGES * (TK * (DQK + DV) * sizeof(bf16) +
                           TK * sizeof(float) + 2 * sizeof(uint64_t) +
                           sizeof(int));
}

// Shared memory of one launch: the ring (tiles, key biases, barriers,
// ordinals) and one bit per mean tile.
template <int DQK, int DV>
size_t smem_bytes(int n_mean_tiles) {
  return ring_bytes<DQK, DV>() +
         sizeof(unsigned) * ((n_mean_tiles + 31) / 32);
}

// One ring tile: TK keys of the local K/V (ordinals 0 .. n_loc - 1) or of
// one partition's means (the rest, partition by partition).
struct Tile {
  const bf16* k;                   // K row of the tile's key 0, KV head hk
  const bf16* v;
  int n;                           // keys in the tile
  int j0;                          // local: position of key 0
  int bias0;                       // mean: index of key 0's bias
  bool mean;
};

// TO is the output type: bf16 on the serving path; f32 when a check
// wants the result before its final rounding to bf16.  The CTA is
// blockDim.x / 32 - 1 consumer warps of 16 query rows and one producer
// warp, the last.  K rows are DQK wide (CPRK 16-byte chunks, swizzled
// within each group of 8 chunks), V rows DV (CPRV chunks).
template <typename TO, int DQK, int DV>
__global__ void __launch_bounds__(NT_MAX, 1)
kernel(const bf16* __restrict__ q,           // [B, Nq, H, DQK]
       const bf16* __restrict__ k,           // [B, Nk, Hk, DQK]
       const bf16* __restrict__ v,           // [B, Nk, Hk, DV]
       const bf16* __restrict__ km,          // means, see MeanLayout
       const bf16* __restrict__ vm,
       const float* __restrict__ mean_bias,  // [B, M]
       const uint8_t* __restrict__ kv_mask,  // [B, Nk] or null
       TO* __restrict__ out,                 // [B, Nq, H, DV]
       int Nq, int Nk, MeanLayout ml, int H, int Hk, int causal,
       int q_offset, float scale, float softcap) {
  constexpr int CPRK = DQK / 8;      // 16-byte chunks per K row
  constexpr int CPRV = DV / 8;       // and per V row
  constexpr int KSTEPS = DQK / 16;   // k-steps of Q K^T
  constexpr int NBLK = TK / 8;       // 8-key score blocks of a tile
  constexpr float LOG2E = 1.4426950408889634f;
  static_assert(TK % 16 == 0 && (CPRK % 8 == 0 || CPRK == 2) &&
                    (CPRV % 8 == 0 || CPRV == 2) && TK / 4 + 1 <= TK,
                "tile");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);                  // [ST][TK][DQK]
  bf16* sv = sk + STAGES * TK * DQK;                         // [ST][TK][DV]
  float* skb = reinterpret_cast<float*>(sv + STAGES * TK * DV);  // [ST][TK]
  uint64_t* full = reinterpret_cast<uint64_t*>(skb + STAGES * TK);
  uint64_t* empty = full + STAGES;
  int* sord = reinterpret_cast<int*>(empty + STAGES);        // [ST]
  unsigned* live = reinterpret_cast<unsigned*>(sord + STAGES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int consumers = blockDim.x / 32 - 1;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hk;
  const int M = ml.P * ml.L;
  const int rows = Nq * G;
  const int row0 = blockIdx.x * consumers * 16;
  const int n_loc = (Nk + TK - 1) / TK;
  const int tpp = (ml.L + TK - 1) / TK;      // mean tiles per partition
  const int n_all = n_loc + ml.P * tpp;
  const size_t krow = (size_t)Hk * DQK;      // elements from key to key
  const size_t vrow = (size_t)Hk * DV;       // and from value to value

  auto tile_of = [&](int ord) {
    Tile t;
    if (ord < n_loc) {
      t.j0 = ord * TK;
      t.n = min(TK, Nk - t.j0);
      const size_t row = (size_t)b * Nk + t.j0;
      t.k = k + row * krow + (size_t)hk * DQK;
      t.v = v + row * vrow + (size_t)hk * DV;
      t.bias0 = 0;
      t.mean = false;
    } else {
      const int mt = ord - n_loc;
      const int p = mt / tpp, l0 = (mt - p * tpp) * TK;
      t.j0 = 0;
      t.n = min(TK, ml.L - l0);
      t.bias0 = b * M + p * ml.L + l0;
      t.k = km + ml.at(b, p * ml.L + l0, Hk, DQK) + (size_t)hk * DQK;
      t.v = vm + ml.atv(b, p * ml.L + l0, Hk, DV) + (size_t)hk * DV;
      t.mean = true;
    }
    return t;
  };

  // The first reads go out before anything waits: the producer's the
  // row's first BPRE * 32 biases, each consumer lane its Q fragments
  // (A operand, rows g / g + 8 of the warp, dims 2·tig and 8 + 2·tig of
  // each k-step; zeros for padded rows).
  const bool producer = warp == consumers;
  const int g = lane >> 2, tig = lane & 3;
  const int rA = row0 + warp * 16 + g, rB = rA + 8;
  const bool okA = !producer && rA < rows, okB = !producer && rB < rows;
  const int qiA = rA / G, qiB = rB / G;
  // (query, head) rows A and B: their index into q (DQK wide) and into
  // out (DV wide) are these times the width
  const size_t hA = ((size_t)b * Nq + (okA ? qiA : 0)) * H + hk * G + rA % G;
  const size_t hB = ((size_t)b * Nq + (okB ? qiB : 0)) * H + hk * G + rB % G;
  const size_t outA = hA * DV, outB = hB * DV;
  float bpre[BPRE];
  uint32_t qa[KSTEPS][4];
  if (producer) {
#pragma unroll
    for (int i = 0; i < BPRE; ++i) {
      const int m = lane + 32 * i;
      bpre[i] = m < M ? mean_bias[(size_t)b * M + m] : NEG_INF;
    }
  } else {
    const uint32_t* pA = reinterpret_cast<const uint32_t*>(q + hA * DQK);
    const uint32_t* pB = reinterpret_cast<const uint32_t*>(q + hB * DQK);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      qa[ks][0] = okA ? pA[8 * ks + tig] : 0u;
      qa[ks][1] = okB ? pB[8 * ks + tig] : 0u;
      qa[ks][2] = okA ? pA[8 * ks + 4 + tig] : 0u;
      qa[ks][3] = okB ? pB[8 * ks + 4 + tig] : 0u;
    }
  }
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 33);              // 32 copy lanes + the ordinal
      mbar_init(&empty[st], consumers);      // one arrival per consumer warp
    }
  }
  __syncthreads();

  if (producer) {
    // ---- the producer warp: which tiles to read, and their copies ----
    const int row_end = min(rows, row0 + consumers * 16);
    const int qi_min = row0 / G, qi_max = (row_end - 1) / G;
    const size_t mask_end = (size_t)gridDim.z * Nk;
    // Tile `ord` into ring slot `slot`: K and V rows in 16-byte chunks
    // swizzled by key, rows past the tile's keys zeroed; beside them the
    // key bias, 4 bytes a copy: a mean tile's biases, or the words of
    // kv_mask that cover a local tile's keys (its key x is byte
    // (b·Nk + j0) % 4 + x of the slot).
    auto issue = [&](int ord, int slot) {
      const Tile t = tile_of(ord);
      bf16* dk = sk + slot * TK * DQK;
      bf16* dv = sv + slot * TK * DV;
      // K and V rows of equal width go out together, chunk by chunk;
      // V rows of another width in a loop of their own
#pragma unroll 4
      for (int c = lane; c < TK * CPRK; c += 32) {
        const int r = c / CPRK, ch = c % CPRK;
        const bool ok = r < t.n;
        const size_t off = ok ? r * krow + ch * 8 : 0;
        const int dst = (r * CPRK + swz<CPRK>(r, ch)) * 8;
        cp_async16(dk + dst, t.k + off, ok ? 16 : 0);
        if constexpr (CPRV == CPRK)
          cp_async16(dv + dst, t.v + off, ok ? 16 : 0);
      }
      if constexpr (CPRV != CPRK) {
#pragma unroll 4
        for (int c = lane; c < TK * CPRV; c += 32) {
          const int r = c / CPRV, ch = c % CPRV;
          const bool ok = r < t.n;
          const size_t off = ok ? r * vrow + ch * 8 : 0;
          cp_async16(dv + (r * CPRV + swz<CPRV>(r, ch)) * 8, t.v + off,
                     ok ? 16 : 0);
        }
      }
      float* kb = skb + slot * TK;
      if (t.mean) {
        if (lane < t.n) cp_async4(kb + lane, mean_bias + t.bias0 + lane, 4);
      } else if (kv_mask && lane < TK / 4 + 1) {
        const size_t at = (((size_t)b * Nk + t.j0) & ~(size_t)3) + 4 * lane;
        const int bytes = at < mask_end ? (int)min((size_t)4, mask_end - at)
                                        : 0;
        cp_async4(kb + lane, kv_mask + (bytes ? at : 0), bytes);
      }
    };
    // the k-th tile read goes to slot k % STAGES once its consumers are
    // done with the slot's previous tile; ordinal -1 ends the sequence
    int filled = 0;
    auto put = [&](int ord) {
      const int slot = filled % STAGES, use = filled / STAGES;
      if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
      if (lane == 0) sord[slot] = ord;
      if (ord >= 0) issue(ord, slot);
      mbar_arrive_cp_async(&full[slot]);
      if (lane == 0) mbar_arrive(&full[slot]);
      ++filled;
    };
    // local tiles [0, loc_need) are read whatever the scan finds: those
    // holding a key at or before the CTA's last query (all of them without
    // causal attention), and always tile 0
    const int last = q_offset + qi_max;
    const int loc_need =
        causal ? (last < 0 ? 1 : min(n_loc, last / TK + 1)) : n_loc;
    for (int ord = 0; ord < loc_need; ++ord) put(ord);

    // Which other tiles to read.  Mean tile (p, l0 / TK) is live iff one
    // of its biases is above -1e30.  Skipping needs every row of the CTA
    // to see a key: any visible mean, or else the first query's local
    // keys.
    const int words = (ml.P * tpp + 31) / 32;
    for (int w = lane; w < words; w += 32) live[w] = 0u;
    __syncwarp();
    bool found = false;
    auto mark = [&](int m, float bias) {     // mean m has bias `bias`
      if (bias > NEG_INF) {
        const int p = m / ml.L;
        const int mt = p * tpp + (m - p * ml.L) / TK;
        atomicOr(&live[mt >> 5], 1u << (mt & 31));
        found = true;
      }
    };
#pragma unroll
    for (int i = 0; i < BPRE; ++i) mark(lane + 32 * i, bpre[i]);
    for (int m = lane + 32 * BPRE; m < M; m += 32)
      mark(m, mean_bias[(size_t)b * M + m]);
    bool skip = __any_sync(0xffffffffu, found);
    if (!skip) {
      const int lim = causal ? min(Nk, q_offset + qi_min + 1) : Nk;
      if (!kv_mask) {
        skip = lim > 0;
      } else {
        for (int j0 = 0; j0 < lim && !skip; j0 += 32) {
          const int j = j0 + lane;
          skip = __any_sync(0xffffffffu,
                            j < lim && kv_mask[(size_t)b * Nk + j]);
        }
      }
    }
    __syncwarp();
    if (!skip)
      for (int w = lane; w < words; w += 32) live[w] = ~0u;
    __syncwarp();
    // local tiles [0, loc_end) are read, then the live mean tiles
    const int loc_end = skip ? loc_need : n_loc;
    auto next_live = [&](int from) {
      if (from < n_loc) {
        if (from < loc_end) return from;
        from = n_loc;
      }
      const int nm = n_all - n_loc;
      for (int mt = from - n_loc; mt < nm;) {
        const unsigned w = live[mt >> 5] >> (mt & 31);
        if (w) {
          const int r = mt + __ffs(w) - 1;
          return r < nm ? n_loc + r : n_all;
        }
        mt = (mt | 31) + 1;
      }
      return n_all;
    };
    for (int ord = next_live(loc_need); ord < n_all; ord = next_live(ord + 1))
      put(ord);
    put(-1);
    cp_async_wait_all();                       // before the warp exits
    return;
  }

  // ---- the consumer warps ----
  const bool warp_live = row0 + warp * 16 < rows;
  float o[CPRV][4];
#pragma unroll
  for (int n = 0; n < CPRV; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float mA = -CUDART_INF_F, mB = -CUDART_INF_F, lA = 0.f, lB = 0.f;

  // The math of one tile for this warp's 16 rows, in the log2 domain.
  // Straight-line code: every score block and P V step of the tile runs
  // (keys past n score -inf and their V rows are zero), so the chains of
  // independent products interleave.
  const float rcap = softcap > 0.f ? 1.f / softcap : 0.f;
  // S = Q K^T of the tile in `slot`, one 8-key block per accumulator
  auto scores = [&](int slot, float (&s)[NBLK][4]) {
    const bf16* kt = sk + slot * TK * DQK;
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    if constexpr (CPRK == 2) {
      // width 16: one k-step; each ldmatrix.x4 reads the two chunks of two
      // 8-key blocks (matrix lane >> 3 is block 2i + (lane >> 4), chunk
      // (lane >> 3) & 1)
#pragma unroll
      for (int i = 0; i < NBLK / 2; ++i) {
        uint32_t kr[4];
        const int row = (2 * i + (lane >> 4)) * 8 + (lane & 7);
        ldm(kt + (row * CPRK + swz<CPRK>(row, (lane >> 3) & 1)) * 8, kr,
            false);
        mma(s[2 * i], qa[0], kr[0], kr[1]);
        mma(s[2 * i + 1], qa[0], kr[2], kr[3]);
      }
    } else {
#pragma unroll
      for (int kc = 0; kc < CPRK / 4; ++kc) {
        uint32_t kr[NBLK][4];
#pragma unroll
        for (int nb = 0; nb < NBLK; ++nb) {
          const int row = nb * 8 + (lane & 7);
          const int ch = 4 * kc + (lane >> 3);
          ldm(kt + (row * CPRK + swz<CPRK>(row, ch)) * 8, kr[nb], false);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nb = 0; nb < NBLK; ++nb)
            mma(s[nb], qa[2 * kc + h], kr[nb][2 * h], kr[nb][2 * h + 1]);
      }
    }
  };
  // the online softmax of the tile's scores `s` and O += P V
  auto update = [&](int ord, int slot, float (&s)[NBLK][4]) {
    const Tile t = tile_of(ord);
    const bf16* vt = sv + slot * TK * DV;
    const float* kb = skb + slot * TK;
    // scale, softcap, then the bias (means) or the mask (local keys);
    // times log2(e); the tile's max of each row
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] *= scale;
    if (softcap > 0.f) {
#pragma unroll
      for (int nb = 0; nb < NBLK; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nb][e] = softcap * tanhf(s[nb][e] * rcap);
    }
    if (t.mean) {
#pragma unroll
      for (int nb = 0; nb < NBLK; ++nb) {
        const int c = nb * 8 + 2 * tig;
        const float2 add = *reinterpret_cast<const float2*>(kb + c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nb][e] = c + (e & 1) < t.n
                         ? (s[nb][e] + ((e & 1) ? add.y : add.x)) * LOG2E
                         : -CUDART_INF_F;
      }
    } else {
      const uint8_t* mk = reinterpret_cast<const uint8_t*>(kb) +
                          (((size_t)b * Nk + t.j0) & 3);
      // the first key each row may not see (causal), or past the tile
      const int endA = causal ? min(t.n, q_offset + qiA - t.j0 + 1) : t.n;
      const int endB = causal ? min(t.n, q_offset + qiB - t.j0 + 1) : t.n;
#pragma unroll
      for (int nb = 0; nb < NBLK; ++nb) {
        const int c = nb * 8 + 2 * tig;
        const bool ok0 = !kv_mask || mk[c] != 0;
        const bool ok1 = !kv_mask || mk[c + 1] != 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c + (e & 1);
          const bool seen = key < (e < 2 ? endA : endB) && ((e & 1) ? ok1 : ok0);
          s[nb][e] = key < t.n ? (seen ? s[nb][e] : NEG_INF) * LOG2E
                               : -CUDART_INF_F;
        }
      }
    }
    float tA = -CUDART_INF_F, tB = -CUDART_INF_F;
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb) {
      tA = fmaxf(tA, fmaxf(s[nb][0], s[nb][1]));
      tB = fmaxf(tB, fmaxf(s[nb][2], s[nb][3]));
    }
    tA = fmaxf(tA, __shfl_xor_sync(0xffffffffu, tA, 1));
    tA = fmaxf(tA, __shfl_xor_sync(0xffffffffu, tA, 2));
    tB = fmaxf(tB, __shfl_xor_sync(0xffffffffu, tB, 1));
    tB = fmaxf(tB, __shfl_xor_sync(0xffffffffu, tB, 2));
    // key 0 of the tile is in range, so the new max is finite
    const float nA = fmaxf(mA, tA), nB = fmaxf(mB, tB);
    const float aA = ex2(mA - nA), aB = ex2(mB - nB);  // 0 on the first
    mA = nA;
    mB = nB;
    float sA = 0.f, sB = 0.f;
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb) {
      s[nb][0] = ex2(s[nb][0] - nA);
      s[nb][1] = ex2(s[nb][1] - nA);
      s[nb][2] = ex2(s[nb][2] - nB);
      s[nb][3] = ex2(s[nb][3] - nB);
      sA += s[nb][0] + s[nb][1];
      sB += s[nb][2] + s[nb][3];
    }
    lA = lA * aA + sA;
    lB = lB * aB + sB;
#pragma unroll
    for (int n = 0; n < CPRV; ++n) {
      o[n][0] *= aA;
      o[n][1] *= aA;
      o[n][2] *= aB;
      o[n][3] *= aB;
    }
    // O += P V, 16 keys a step, P as bf16 hi + lo
    const int j = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < TK / 16; ++ks) {
      uint32_t hi[4], lo[4];
      split(s[2 * ks][0], s[2 * ks][1], hi[0], lo[0]);
      split(s[2 * ks][2], s[2 * ks][3], hi[1], lo[1]);
      split(s[2 * ks + 1][0], s[2 * ks + 1][1], hi[2], lo[2]);
      split(s[2 * ks + 1][2], s[2 * ks + 1][3], hi[3], lo[3]);
      const int row = ks * 16 + (j & 1) * 8 + (lane & 7);
      uint32_t vr[CPRV / 2][4];
#pragma unroll
      for (int c = 0; c < CPRV / 2; ++c) {
        const int ch = 2 * c + (j >> 1);
        ldm(vt + (row * CPRV + swz<CPRV>(row, ch)) * 8, vr[c], true);
      }
#pragma unroll
      for (int c = 0; c < CPRV / 2; ++c) {
        mma(o[2 * c], hi, vr[c][0], vr[c][1]);
        mma(o[2 * c + 1], hi, vr[c][2], vr[c][3]);
      }
#pragma unroll
      for (int c = 0; c < CPRV / 2; ++c) {
        mma(o[2 * c], lo, vr[c][0], vr[c][1]);
        mma(o[2 * c + 1], lo, vr[c][2], vr[c][3]);
      }
    }
  };

  // The tiles in the order the producer puts them, until ordinal -1.
  // The next tile's S = Q K^T goes to the tensor cores before this
  // tile's softmax, so the two overlap.
  float sc[NBLK][4], sn[NBLK][4];
  mbar_wait(&full[0], 0);
  int ord = sord[0];
  if (ord >= 0 && warp_live) scores(0, sc);
  for (int kk = 0; ord >= 0; ++kk) {
    const int slot = kk % STAGES, next = (kk + 1) % STAGES;
    mbar_wait(&full[next], ((kk + 1) / STAGES) & 1);
    const int nord = sord[next];
    if (nord >= 0 && warp_live) scores(next, sn);
    if (warp_live) update(ord, slot, sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = sn[nb][e];
    ord = nord;
  }

  lA += __shfl_xor_sync(0xffffffffu, lA, 1);
  lA += __shfl_xor_sync(0xffffffffu, lA, 2);
  lB += __shfl_xor_sync(0xffffffffu, lB, 1);
  lB += __shfl_xor_sync(0xffffffffu, lB, 2);
  const float iA = 1.f / lA, iB = 1.f / lB;
#pragma unroll
  for (int n = 0; n < CPRV; ++n) {
    if (okA) store2(out + outA + 8 * n + 2 * tig, o[n][0] * iA, o[n][1] * iA);
    if (okB) store2(out + outB + 8 * n + 2 * tig, o[n][2] * iB, o[n][3] * iB);
  }
}

}  // namespace mma_body

// Lets `kernel` take up to the card's opt-in shared memory per CTA as
// dynamic shared memory, once per device.
template <typename K>
cudaError_t allow_smem(K kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

// Arguments of one launch.
struct Args {
  const void *q, *k, *v, *km, *vm, *bias, *mask;
  void* out;
  int B, Nq, Nk, H, Hk, causal, q_offset;
  MeanLayout ml;
  float scale, softcap;
  cudaStream_t stream;
};

// The instantiation for (T, TO, DQK, DV): its kernel and launch geometry.
template <typename T, typename TO, int DQK, int DV>
struct Body;

template <int DQK, int DV>
struct Body<float, float, DQK, DV> {
  static auto fn() { return fma_body::kernel<DQK, DV>; }
  static cudaError_t ready() {
    static bool done[MAX_DEVICES] = {};
    return allow_smem(fn(), done);
  }
  static int threads(int) { return fma_body::NT; }
  static size_t smem(const Args&) {
    return fma_body::smem_bytes<DQK, DV>();
  }
  static int launch(const Args& a, int) {
    const int TQ = fma_body::R / (a.H / a.Hk);
    const dim3 grid((a.Nq + TQ - 1) / TQ, a.Hk, a.B);
    fma_body::kernel<DQK, DV><<<grid, fma_body::NT, smem(a), a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.km),
        static_cast<const float*>(a.vm), static_cast<const float*>(a.bias),
        static_cast<const uint8_t*>(a.mask), static_cast<float*>(a.out),
        a.Nq, a.Nk, a.ml, a.H, a.Hk, TQ, a.causal, a.q_offset, a.scale,
        a.softcap);
    return 0;
  }
};

template <typename TO, int DQK, int DV>
struct Body<__nv_bfloat16, TO, DQK, DV> {
  static auto fn() { return mma_body::kernel<TO, DQK, DV>; }
  static cudaError_t ready() {
    static bool done[MAX_DEVICES] = {};
    return allow_smem(fn(), done);
  }
  static int threads(int warps) { return 32 * (warps + 1); }
  static size_t smem(const Args& a) {
    const int tpp = (a.ml.L + mma_body::TK - 1) / mma_body::TK;
    return mma_body::smem_bytes<DQK, DV>(a.ml.P * tpp);
  }
  static int launch(const Args& a, int warps) {
    if (warps < 1 || warps > mma_body::MAX_WARPS) return -1;
    const int rows = a.Nq * (a.H / a.Hk), per = 16 * warps;
    const dim3 grid((rows + per - 1) / per, a.Hk, a.B);
    using bf16 = __nv_bfloat16;
    mma_body::kernel<TO, DQK, DV>
        <<<grid, threads(warps), smem(a), a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.km),
        static_cast<const bf16*>(a.vm), static_cast<const float*>(a.bias),
        static_cast<const uint8_t*>(a.mask), static_cast<TO*>(a.out), a.Nq,
        a.Nk, a.ml, a.H, a.Hk, a.causal, a.q_offset, a.scale, a.softcap);
    return 0;
  }
};

template <typename T, typename TO, int DQK, int DV>
struct Launch {
  static int run(const Args& a, int warps) {
    using Bd = Body<T, TO, DQK, DV>;
    cudaError_t err = Bd::ready();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rc = Bd::launch(a, warps);
    if (rc != 0) return rc;
    return static_cast<int>(cudaGetLastError());
  }
};

// Registers, spilled bytes, shared memory per CTA and resident CTAs per SM
// (the bf16 body with `warps` warps and one word of tile bits).
template <typename T, typename TO, int DQK, int DV>
struct Attributes {
  static int run(int warps, int* out) {
    using Bd = Body<T, TO, DQK, DV>;
    cudaError_t err = Bd::ready();
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, Bd::fn());
    if (err != cudaSuccess) return static_cast<int>(err);
    Args none = {};
    none.ml.P = 1;
    none.ml.L = 1;
    const size_t smem = Bd::smem(none);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, Bd::fn(), Bd::threads(warps), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)(a.sharedSizeBytes + smem);
    out[3] = per_sm;
    return 0;
  }
};

// Calls F<T, TO, DQK, DV>::run(args...) for the (DQK, DV) widths, or
// returns -2 for widths the kernel does not take.
template <template <typename, typename, int, int> class F, typename T,
          typename TO, typename... A>
int widths(int dqk, int dv, A... args) {
  if (dqk == 16 && dv == 16) return F<T, TO, 16, 16>::run(args...);
  if (dqk == 64 && dv == 64) return F<T, TO, 64, 64>::run(args...);
  if (dqk == 128 && dv == 128) return F<T, TO, 128, 128>::run(args...);
  if (dqk == 192 && dv == 128) return F<T, TO, 192, 128>::run(args...);
  return -2;
}

// The same for the runtime choice of input and output types.
template <template <typename, typename, int, int> class F, typename... A>
int dispatch(int dqk, int dv, int is_bf16, int out_f32, A... args) {
  using bf16 = __nv_bfloat16;
  if (!is_bf16) return widths<F, float, float>(dqk, dv, args...);
  if (out_f32) return widths<F, bf16, float>(dqk, dv, args...);
  return widths<F, bf16, bf16>(dqk, dv, args...);
}

}  // namespace

// Plain C entry point.  Returns cudaGetLastError() after the launch (0 on
// success), or a negative code for a shape the kernel does not take.
// q and K are dqk wide, V and out dv wide.  Means: K [B, P, L, Hk, dqk]
// with element strides mean_sb (over B) and mean_sp (over P), V
// [B, P, L, Hk, dv] with mean_vsb and mean_vsp, each contiguous inside
// (L, Hk, ·); M = P * L, and the bias is [B, M].  kv_mask may be null (every local key valid).  is_bf16: 1 for
// bfloat16 q/k/v/means, 0 for float32.  out_f32: 1 writes the output as
// float32, 0 in the inputs' type (float32 inputs: 0 or 1 alike).  softcap
// 0 means none.  warps: warps per CTA of the bf16 body (1 to 8, from
// row_plan in kernel.py); the f32 body ignores it.
extern "C" int prism_attention_launch(
    const void* q, const void* k, const void* v, const void* km,
    const void* vm, const void* mean_bias, const void* kv_mask, void* out,
    int B, int Nq, int Nk, int P, int L, long long mean_sb,
    long long mean_sp, long long mean_vsb, long long mean_vsp, int H, int Hk,
    int dqk, int dv, int is_bf16, int out_f32, int causal, int q_offset,
    float scale, float softcap, int warps, void* stream) {
  if (B < 1 || Nq < 1 || Nk < 1 || P < 0 || L < 0 || Hk < 1 || H % Hk != 0)
    return -1;
  if (H / Hk > GMAX || B > 65535 || Hk > 65535) return -1;
  if ((long long)Nq * (H / Hk) > 0x7fffffffLL) return -1;
  if (P == 0 || L == 0) P = L = 0;
  const Args a = {q, k, v, km, vm, mean_bias, kv_mask, out, B, Nq, Nk, H,
                  Hk, causal, q_offset,
                  {mean_sb, mean_sp, mean_vsb, mean_vsp, P, L}, scale,
                  softcap, static_cast<cudaStream_t>(stream)};
  return dispatch<Launch>(dqk, dv, is_bf16, out_f32, a, warps);
}

// out[4] = registers, spilled bytes, shared memory per CTA, CTAs per SM of
// the instantiation (widths, input type, output type; `warps` warps for
// the bf16 body); 0 on success.
extern "C" int prism_attention_attributes(int dqk, int dv, int is_bf16,
                                          int out_f32, int warps, int* out) {
  return dispatch<Attributes>(dqk, dv, is_bf16, out_f32, warps, out);
}
