// Flash-decode for Hopper: one-token GQA attention partials over a KV
// cache, emitting the un-normalised (o·l, m, l) that the exact
// log-sum-exp merge across cache shards consumes.  One kernel body serves
// two cache layouts, each with its own C entry point:
//
//   flash_decode_launch        a dense cache [B, S, Hk, dh].  Replaces the
//                              TPU kernel `flash_decode_pallas` in
//                              src/repro/kernels/flash_decode/kernel.py
//                              (pallas_call at line 80).
//   flash_decode_paged_launch  a pool of pages [P, ps, Hk, dh] read through
//                              a per-row page table [B, MP]: row b's
//                              position j lives at
//                              pool[page_table[b, j / ps], j % ps], and
//                              S = MP * ps.  Replaces the TPU kernel
//                              `flash_decode_paged_pallas` in
//                              src/repro/kernels/flash_decode/paged.py
//                              (pallas_call at line 107).
//
// Both compute exactly what the TPU kernels compute:
//   s[h, t] = softcap((q[h] * scale) . k[t, h / G]) + bias[t]
//   m[h]    = max(-1e30, max_t s[h, t])
//   l[h]    = sum_t exp(s[h, t] - m[h])
//   o[h]    = sum_t exp(s[h, t] - m[h]) * v[t, h / G]
// with G = H / Hk query heads per KV head.  A fully masked row (every bias
// <= -1e30) gives m = -1e30, l = S and o = sum_t v[t], as in the JAX
// package.  Page-table entries may name the same physical page from
// several rows (a shared prefix) or the pool's trash page; ids are the
// caller's contract (0 <= id < P) and are not checked here.
//
// Bound: bytes.  The kernel must read the K and V rows of the positions
// that count once, 2 * positions * Hk * dh * itemsize bytes, against 4 * G
// flops per element read; at 3.35 TB/s that read is the least time the
// card needs.  The design keeps enough bytes in flight on enough SMs,
// keeps the math per tile short enough to hide under the next tile's
// copy, and reads no tile that cannot change the result.
//
// Split S.  The grid is (Hk, splits, B), the KV head fastest so that the
// heads of one row, which share each 1 KB cache row, run side by side.
// Each CTA (256 threads, one per SM) takes one (row, KV head) and a run
// of whole S tiles; `split_plan` in kernel.py picks `splits` (1 to 8) so
// that B * Hk * splits fills at most one wave of the card, and 1 where
// B * Hk already fills half of it or S fits one tile, so the `generate`
// shape stays one CTA per (row, head) with no merge.  The G query heads
// of a group share every K/V tile read from device memory.
//
// Merge in the same launch.  The splits of one (row, KV head) are one
// thread-block cluster.  After a cluster barrier (every rank has left its
// loop, so rank 0's ring is idle) each rank writes its partial
// (o_i, m_i, l_i) into rank 0's ring through distributed shared memory,
// arrives at a second barrier and exits; rank 0 waits at it and merges
// exactly,
//   m = max m_i,  l = sum e^{m_i - m} l_i,  o = sum e^{m_i - m} o_i,
// (the un-normalised form of ops.merge_partials).  No scratch in device
// memory, no counters to reset, one launch (a CUDA graph captures it as
// one node).  A ticket in device memory (threadfence +
// atomicAdd, the last CTA merging) would need a zero-filled counter per
// call and two L2 round trips, which cost more than the two barriers.
//
// The ring.  Each CTA keeps 3 tiles of K, V and bias in shared memory in
// their input type (bf16 stays bf16), filled with 16-byte `cp.async.cg`
// (bias 4 bytes at a time, `cp.async.ca`), positions past S zero-filled
// by the copy itself (src-size 0).  Tiles n + 1 and n + 2 are in flight
// while tile n's math runs: 64 KB per SM.  cp.async rather than TMA: the
// paged layout gathers rows from scattered pages at any page size (5
// included), which a tensor map cannot describe without one copy per
// position, and on this access pattern (128-byte rows 1 KB apart) 16-byte
// cp.async streamed at least as fast as one bulk copy per row on the
// H100.  16-byte chunks are stored XOR-swizzled by (position & 7), so the
// 8 rows an ldmatrix reads at one chunk fall in 8 different bank groups.
//
// The math of a tile (MmaMath, FmaMath below).  bf16 runs on the tensor
// cores (mma.m16n8k16, f32 accumulation of exact bf16 products; P split
// into bf16 hi + lo parts so p·V keeps ~16 bits of p): two block-wide
// barriers per tile (data ready; the tile's max per head).  f32 runs on
// the CUDA cores (a tensor-core product in f32 would round to TF32):
// three barriers (data ready, scores, softmax).  At G = 4 each bf16
// element read feeds 8 FMAs, so on the CUDA cores bf16 is bound by the
// math's latency rather than by memory.  Tile TS = 128 positions in bf16
// (16 per warp), 256, 64 or 32 in f32 (a 16 KB K tile); the ring is ~98 KB
// (bf16 dh 64, f32) or ~194 KB (bf16 dh 128) of dynamic shared memory
// (cudaFuncSetAttribute).  One CTA per SM at dh 64 and 128: two would cap
// registers at 128, where the bf16 path spills.
//
// Head widths 16, 64 and 128.  16 is the reduced configs' width (every
// example and CPU test config): a row is 2 bf16 or 4 f32 chunks, swizzled
// within the row (`swz`), one k-step of Q K^T whose K fragments for both
// n-tiles come from one ldmatrix.x4.  It exists so that small configs run
// on the card, not for speed: its rows are 32 bytes, so a bf16 ring is
// 26 KB that moves little per barrier.
//
// Paged addressing per page.  One ring step before its copies, the
// threads read the tile's page ids once each (at most TS of them, one per
// page the tile spans) into shared memory; a chunk's address is then
// (ids[s / ps - s0 / ps] * ps + s % ps) * row.  Any ps >= 1 works and a
// tile may span several pages.
//
// Read only the tiles that count.  Before its loop a CTA reads its range
// of the row's bias and marks each tile that holds a position with bias
// > -1e30.  If the row has such a position anywhere (its own range, or
// else a scan of the whole row, <= 8 KB from L2 at S 2048), the unmarked
// tiles are not read, except the range's first, which goes out before
// the mask is known so that its latency hides the bias read.  Exactness:
// let j be a masked position and v a valid one.  s_j <= softcap(dot_j) -
// 1e30 while s_v > -1e30 + softcap(dot_v), and two f32 values on either
// side of -1e30 differ by at least one f32 step there (7.6e22), so s_j - m
// < -104 whenever the scores are below 1e22 in size and e^{s_j - m} is
// exactly 0 in f32: j adds 0 to l and o and does not set m, whether its
// tile is skipped or read (a masked tile read before the row's first
// valid one is scaled by e^{-1e30 - m} = 0 when that one comes).  A split
// that reads no valid position emits m = -1e30, which the merge weights
// by exactly 0.  A fully masked row has no valid position, so every tile
// is read and m = -1e30, l = S, o = sum v come out as in the plain version
// (l as an exact integer sum; o in another order than the plain sum).
//
// Built by repro_torch/kernels/flash_decode/kernel.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas=-v
// into a shared library with a plain C interface, loaded with ctypes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int GMAX = 8;            // most query heads per KV head
constexpr int MASKW = 8;           // tile-mask words: 256 tiles per chunk
constexpr int BATCH = 4;           // tiles a warp marks per bias read
constexpr float NEG_INF = -1e30f;  // the JAX package's mask value
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SPLITS = 8;      // CTAs of a cluster (the portable most)

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte chunk of shared memory as floats.
__device__ __forceinline__ void chunk_f32(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

// Where a position's K/V row starts, in elements from the cache's base
// (the KV head's offset is added by the body).  `prepare` runs before the
// tile's copies are issued, a barrier between; `at` gives the row of
// position s of the tile starting at s0.  `Dense`: row b's cache is
// contiguous.  `Paged`: the tile's page ids, read once each into shared
// memory.
struct Dense {
  static constexpr bool kIds = false;  // addresses need no shared state
  size_t base;                         // b * S * row
  size_t row;                          // Hk * DH
  __device__ __forceinline__ void prepare(int, int, int, int) const {}
  __device__ __forceinline__ size_t at(int s, int, int) const {
    return base + (size_t)s * row;
  }
};

struct Paged {
  static constexpr bool kIds = true;
  const int* table;                    // row b of the page table, [MP]
  int ps;
  size_t row;
  int* ids;                            // [STAGES][TS] in shared memory
  int ts;                              // TS
  __device__ __forceinline__ void prepare(int s0, int S, int slot,
                                          int tid) const {
    const int p0 = s0 / ps;
    const int p1 = (min(s0 + ts, S) - 1) / ps;
    if (tid <= p1 - p0) ids[slot * ts + tid] = table[p0 + tid];
  }
  __device__ __forceinline__ size_t at(int s, int s0, int slot) const {
    const int page = ids[slot * ts + s / ps - s0 / ps];
    return ((size_t)page * ps + (size_t)(s % ps)) * row;
  }
};

// First marked tile at or after `from` in the chunk's mask, or n.
__device__ __forceinline__ int next_tile(const unsigned* mask, int from,
                                         int n) {
  while (from < n) {
    const unsigned w = mask[from >> 5] >> (from & 31);
    if (w) return from + __ffs(w) - 1;
    from = (from | 31) + 1;
  }
  return n;
}

// Where chunk `ch` of row `r` of a ring tile with CPR 16-byte chunks a row
// is stored: XOR-swizzled by r & 7 (rows of 8 chunks or more), or by the
// low bits of r that stay inside the row (dh 16: 2 bf16 or 4 f32 chunks,
// so 8 rows at one chunk fall in 4 or 2 bank groups, not 1).
template <int CPR>
__device__ __forceinline__ int swz(int r, int ch) {
  return ch ^ (r & ((CPR < 8 ? CPR : 8) - 1));
}

// The math of one tile, two ways.  Both keep the un-normalised online
// softmax of every query head of the group in f32 and leave, at the end,
// RG partial sums of o in `red` ([RG][8][DH]) and m, l in sm, sl.

// bf16: tensor cores.  Warp w owns the tile's 16 positions 16w..16w+15.
// Scores S = Q K^T with mma.m16n8k16 (Q's G rows padded to 16, f32
// accumulation of exact bf16 products), K fragments by ldmatrix from the
// swizzled ring; the tile's max per head crosses warps through shared
// memory (one barrier); P = e^{S - m} goes straight from the score
// registers into the A operand of P V as bf16 hi + lo parts (p - hi is
// exact in f32 and its bf16 rounding is 2^-9 of it, so P keeps ~16 bits),
// V fragments by ldmatrix.trans.  Each warp keeps o for its positions; the
// 8 warps' sums meet at the end.
template <int DH>
struct MmaMath {
  static constexpr int TS = 128;       // positions per tile
  static constexpr int RG = NWARPS;    // partial sums of o to reduce
  struct Shared {
    float wmax[NWARPS][8];             // each warp's max of the tile
    float lred[NWARPS][8];             // each warp's sum, at the end
  };
  uint32_t qa[DH / 16][2];             // Q fragments (rows g < 8)
  float o[DH / 8][2];                  // o of row g, dims 8n + 2·tig + {0,1}
  float m_run = NEG_INF, l_run = 0.f;  // row g; l over this lane's positions
  float scale, softcap;
  int lane, warp, g, tig;

  __device__ __forceinline__ MmaMath(const __nv_bfloat16* q, size_t head0,
                                     int G, float scale_, float softcap_,
                                     int tid)
      : scale(scale_), softcap(softcap_), lane(tid & 31), warp(tid >> 5),
        g((tid & 31) >> 2), tig(tid & 3) {
    const uint32_t* qw =
        reinterpret_cast<const uint32_t*>(q + (head0 + g) * DH);
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      qa[ks][0] = g < G ? qw[8 * ks + tig] : 0u;
      qa[ks][1] = g < G ? qw[8 * ks + 4 + tig] : 0u;
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = 0.f;
  }

  __device__ __forceinline__ void stage_q(Shared&) {}

  static __device__ __forceinline__ void
  mma(float (&d)[2], uint32_t a0, uint32_t a2, uint32_t b0, uint32_t b1) {
    float z2 = 0.f, z3 = 0.f;          // rows 8..15: padding
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(z2), "+f"(z3)
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
  }

  static __device__ __forceinline__ void ldm(const void* p, uint32_t (&r)[4],
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

  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }

  __device__ __forceinline__ void tile(Shared& sh,
                                       const __nv_bfloat16* kt,
                                       const __nv_bfloat16* vt,
                                       const float* bt, int s0, int S) {
    constexpr int CPR = DH / 8;        // 16-byte chunks per row
    const int p0 = warp * 16;
    float sa[2][2][2] = {};              // [n-tile][k-step parity][2]
    if constexpr (CPR >= 4) {
      // all K fragments first, then four independent chains of mma
      uint32_t kr[2][CPR / 4][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int row = p0 + 8 * nt + (lane & 7);
#pragma unroll
        for (int kc = 0; kc < CPR / 4; ++kc) {
          const int ch = 4 * kc + (lane >> 3);
          ldm(kt + (row * CPR + swz<CPR>(row, ch)) * 8, kr[nt][kc], false);
        }
      }
#pragma unroll
      for (int kc = 0; kc < CPR / 4; ++kc)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma(sa[nt][h], qa[2 * kc + h][0], qa[2 * kc + h][1],
                kr[nt][kc][2 * h], kr[nt][kc][2 * h + 1]);
    } else {
      // dh 16: one k-step; one ldmatrix.x4 reads both n-tiles' two chunks
      // (matrix lane >> 3 is n-tile lane >> 4, chunk (lane >> 3) & 1)
      uint32_t kr[4];
      const int row = p0 + 8 * (lane >> 4) + (lane & 7);
      ldm(kt + (row * CPR + swz<CPR>(row, (lane >> 3) & 1)) * 8, kr, false);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mma(sa[nt][0], qa[0][0], qa[0][1], kr[2 * nt], kr[2 * nt + 1]);
    }
    float sc[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      sc[nt][0] = sa[nt][0][0] + sa[nt][1][0];
      sc[nt][1] = sa[nt][0][1] + sa[nt][1][1];
    }
    float x[2][2];
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = p0 + 8 * nt + 2 * tig + e;
        float v = sc[nt][e] * scale;
        if (softcap > 0.f) v = softcap * tanhf(v / softcap);
        v += bt[pos];
        x[nt][e] = s0 + pos < S ? v : -CUDART_INF_F;
        tmax = fmaxf(tmax, x[nt][e]);
      }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    if (tig == 0) sh.wmax[warp][g] = tmax;
    __syncthreads();
    float m_new = m_run;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m_new = fmaxf(m_new, sh.wmax[w][g]);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    float p[2][2], sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nt][e] = expf(x[nt][e] - m_new);
        sum += p[nt][e];
      }
    l_run = l_run * alpha + sum;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
    }
    const uint32_t hi0 = pack(p[0][0], p[0][1]), hi1 = pack(p[1][0], p[1][1]);
    const __nv_bfloat162 h0 = *reinterpret_cast<const __nv_bfloat162*>(&hi0);
    const __nv_bfloat162 h1 = *reinterpret_cast<const __nv_bfloat162*>(&hi1);
    const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
    const uint32_t lo0 = pack(p[0][0] - f0.x, p[0][1] - f0.y);
    const uint32_t lo1 = pack(p[1][0] - f1.x, p[1][1] - f1.y);
    const int j = lane >> 3;
    const int row = p0 + (j & 1) * 8 + (lane & 7);
    uint32_t vr[CPR / 2][4];
#pragma unroll
    for (int c = 0; c < CPR / 2; ++c) {
      const int ch = 2 * c + (j >> 1);
      ldm(vt + (row * CPR + swz<CPR>(row, ch)) * 8, vr[c], true);
    }
#pragma unroll
    for (int c = 0; c < CPR / 2; ++c) {
      mma(o[2 * c], hi0, hi1, vr[c][0], vr[c][1]);
      mma(o[2 * c + 1], hi0, hi1, vr[c][2], vr[c][3]);
    }
#pragma unroll
    for (int c = 0; c < CPR / 2; ++c) {
      mma(o[2 * c], lo0, lo1, vr[c][0], vr[c][1]);
      mma(o[2 * c + 1], lo0, lo1, vr[c][2], vr[c][3]);
    }
  }

  __device__ __forceinline__ void finish(Shared& sh, float* red, float* sm,
                                         float* sl) {
    float l = l_run;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (tig == 0) sh.lred[warp][g] = l;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(red + (warp * 8 + g) * DH + 8 * n +
                                 2 * tig) = make_float2(o[n][0], o[n][1]);
    __syncthreads();
    if (warp == 0 && tig == 0) {
      float lt = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) lt += sh.lred[w][g];
      sm[g] = m_run;
      sl[g] = lt;
    }
  }
};

// f32: CUDA cores (tensor cores have no f32 product of full precision).
// Scores by TPP threads a position, each a part of the row dotted with
// every query head, joined by shuffles; the online softmax one warp per
// head; p·V by thread (vch, vtg): 16-byte column chunk vch of V over the
// positions vtg, vtg + TG, ... for all heads at once (one V load feeds
// GP * EPC FMAs); the TG groups meet at the end.
template <int DH, int GP>
struct FmaMath {
  using T = float;
  static constexpr int TS = 4096 / DH;          // K tile of 16 KB
  static constexpr int EPC = 4, CPR = DH / EPC, TPP = NT / TS;
  static constexpr int EPP = DH / TPP, CPP = EPP / EPC, TG = NT / CPR;
  static constexpr int RG = TG;
  static constexpr int QPT = (GP * DH + NT - 1) / NT;
  static_assert(TS % 32 == 0 && TS % TG == 0 && EPP % 4 == 0 && CPP >= 1 &&
                GP % 4 == 0 && GP <= NWARPS, "tile shape");
  struct Shared {
    // scaled queries, each score thread's part padded by 16 bytes so that
    // the parts of one position fall in different banks
    __align__(16) float sq[GP][TPP][EPP + 4];
    float sp[GP][TS];                            // scores
    __align__(16) float pp[TS][GP];              // probabilities
    float salpha[GP];                            // rescale of the tile
  };
  float qv[QPT];
  float acc[GP][EPC];
  float m_run = NEG_INF, l_run = 0.f;   // warp g < G: head g
  float softcap;
  int G, tid, lane, warp, vch, vtg;

  __device__ __forceinline__ FmaMath(const float* q, size_t head0, int G_,
                                     float scale, float softcap_, int tid_)
      : softcap(softcap_), G(G_), tid(tid_), lane(tid_ & 31),
        warp(tid_ >> 5), vch(tid_ % CPR), vtg(tid_ / CPR) {
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int i = tid + j * NT;
      qv[j] = i < G * DH ? q[head0 * DH + i] * scale : 0.f;
    }
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[g][e] = 0.f;
  }

  __device__ __forceinline__ void stage_q(Shared& sh) {
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int i = tid + j * NT;
      if (i < G * DH) sh.sq[i / DH][(i % DH) / EPP][i % EPP] = qv[j];
    }
  }

  __device__ __forceinline__ void tile(Shared& sh, const float* kt,
                                       const float* vt, const float* bt,
                                       int s0, int S) {
    {
      const int t = tid / TPP, part = tid % TPP;
      const float* kr = kt + t * DH;
      float kf[EPP];
#pragma unroll
      for (int e = 0; e < CPP; ++e) {
        const int ch = part * CPP + e;
        chunk_f32(kr + swz<CPR>(t, ch) * EPC, kf + e * EPC);
      }
      const float bs = bt[t];
      const bool live = s0 + t < S;
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g < G) {                         // block-uniform
          const float4* qg = reinterpret_cast<const float4*>(sh.sq[g][part]);
          float d0 = 0.f, d1 = 0.f;
#pragma unroll
          for (int e = 0; e < EPP; e += 4) {
            const float4 qe = qg[e / 4];
            d0 = fmaf(qe.x, kf[e], d0);
            d1 = fmaf(qe.y, kf[e + 1], d1);
            d0 = fmaf(qe.z, kf[e + 2], d0);
            d1 = fmaf(qe.w, kf[e + 3], d1);
          }
          float dot = d0 + d1;
#pragma unroll
          for (int off = TPP / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
          if (part == 0 && live) sh.sp[g][t] = dot + bs;
        }
      }
    }
    __syncthreads();

    // warp g keeps head g's running max and, lane by lane, its running sum
    if (warp < G) {
      const int g = warp;
      constexpr int PER = TS / 32;
      float x[PER];
      bool ok[PER];
      float tmax = -CUDART_INF_F;  // every tile holds a position < S
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int t = lane + 32 * j;
        ok[j] = s0 + t < S;
        x[j] = ok[j] ? sh.sp[g][t] : 0.f;
        if (ok[j]) tmax = fmaxf(tmax, x[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m_run, tmax);
      const float alpha = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float p = ok[j] ? expf(x[j] - m_new) : 0.f;
        sh.pp[lane + 32 * j][g] = p;
        sum += p;
      }
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (lane == 0) sh.salpha[g] = alpha;
    }
    __syncthreads();

    // p · V; V is zero past S
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float alpha = g < G ? sh.salpha[g] : 1.f;
      if (alpha != 1.f) {                    // block-uniform
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[g][e] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < TS / TG; ++j) {
      const int t = vtg + TG * j;
      float vf[EPC];
      chunk_f32(vt + (t * CPR + swz<CPR>(t, vch)) * EPC, vf);
      float p[GP];
#pragma unroll
      for (int g4 = 0; g4 < GP; g4 += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(&sh.pp[t][g4]);
        p[g4] = p4.x;
        p[g4 + 1] = p4.y;
        p[g4 + 2] = p4.z;
        p[g4 + 3] = p4.w;
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            acc[g][e] = fmaf(p[g], vf[e], acc[g][e]);
        }
      }
    }
  }

  __device__ __forceinline__ void finish(Shared&, float* red, float* sm,
                                         float* sl) {
    if (warp < G) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l_run += __shfl_xor_sync(0xffffffffu, l_run, off);
      if (lane == 0) {
        sm[warp] = m_run;
        sl[warp] = l_run;
      }
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g < G) {
#pragma unroll
        for (int e = 0; e < EPC; e += 4)
          *reinterpret_cast<float4*>(red + (vtg * 8 + g) * DH + vch * EPC +
                                     e) =
              make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                          acc[g][e + 3]);
      }
    }
  }
};

template <typename T, int DH, int GP>
struct MathOf {
  using type = FmaMath<DH, GP>;
};
template <int DH, int GP>
struct MathOf<__nv_bfloat16, DH, GP> {
  using type = MmaMath<DH>;
};

// Ring shape of one instantiation.
template <typename T, int DH, int GP>
struct Shape {
  using Math = typename MathOf<T, DH, GP>::type;
  static constexpr int TS = Math::TS;             // positions per tile
  static constexpr int STAGES = 3;                // tiles in the ring
  static constexpr int EPC = 16 / sizeof(T);      // elements per chunk
  static constexpr int CPR = DH / EPC;            // chunks per row
  static constexpr size_t RING_BYTES =
      (size_t)STAGES * (2 * TS * DH * sizeof(T) + TS * sizeof(float));
  static_assert(CPR >= 2 && TS <= NT && (TS * CPR) % NT == 0 &&
                ((size_t)Math::RG * 8 * DH +
                 (size_t)MAX_SPLITS * (8 * DH + 16)) * sizeof(float) <=
                    RING_BYTES,
                "tile shape");
};

template <typename T, int DH, int GP, typename Rows>
__device__ __forceinline__ void
flash_decode_body(const T* __restrict__ q,        // [B, H, DH]
                  const T* __restrict__ kb,       // K cache + hk * DH
                  const T* __restrict__ vb,       // V cache + hk * DH
                  const float* __restrict__ biasb,  // row b of [B, S]
                  float* __restrict__ o_out,      // [B, H, DH]
                  float* __restrict__ m_out,      // [B, H]
                  float* __restrict__ l_out,      // [B, H]
                  const Rows rows, int b, int hk, int split, int splits,
                  int H, int Hk, int S, float scale, float softcap) {
  using Sh = Shape<T, DH, GP>;
  using Math = typename Sh::Math;
  constexpr int TS = Sh::TS, STAGES = Sh::STAGES, EPC = Sh::EPC;
  constexpr int CPR = Sh::CPR, RG = Math::RG;

  extern __shared__ __align__(128) unsigned char ring[];
  T* sk = reinterpret_cast<T*>(ring);                   // [STAGES][TS][DH]
  T* sv = sk + STAGES * TS * DH;                        // [STAGES][TS][DH]
  float* sb = reinterpret_cast<float*>(sv + STAGES * TS * DH);  // [ST][TS]
  __shared__ typename Math::Shared msh;
  __shared__ float sm[8];                        // the group's m
  __shared__ float sl[8];                        // the group's l
  __shared__ unsigned smask[MASKW];              // tiles of the chunk to read

  const int G = H / Hk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t head0 = (size_t)b * H + (size_t)hk * G;
  const int ntiles = (S + TS - 1) / TS;
  const int per = (ntiles + splits - 1) / splits;
  const int t_lo = min(ntiles, split * per);
  const int t_hi = min(ntiles, t_lo + per);

  // the query reads go out first, beside the first bias and table reads
  Math math(q, head0, G, scale, softcap, tid);

  // Copy tile `tile` into ring slot `slot`: 16-byte chunks XOR-swizzled
  // by position, zeros past S.
  auto issue = [&](int tile, int slot) {
    const int s0 = tile * TS;
    T* dk = sk + slot * TS * DH;
    T* dv = sv + slot * TS * DH;
#pragma unroll
    for (int j = 0; j < TS * CPR / NT; ++j) {
      const int c = tid + j * NT;
      const int t = c / CPR, ch = c % CPR;
      const int s = s0 + t;
      const bool ok = s < S;
      const size_t off = ok ? rows.at(s, s0, slot) + ch * EPC : 0;
      const int dst = (t * CPR + swz<CPR>(t, ch)) * EPC;
      cp_async16(dk + dst, kb + off, ok);
      cp_async16(dv + dst, vb + off, ok);
    }
    if (tid < TS) {
      const int s = s0 + tid;
      cp_async4(sb + slot * TS + tid, biasb + (s < S ? s : 0), s < S);
    }
  };
  auto compute = [&](int tile, int slot) {
    math.tile(msh, sk + slot * TS * DH, sv + slot * TS * DH, sb + slot * TS,
              tile * TS, S);
  };
  // Mark the tiles [k0, k0 + NWARPS * BATCH) of the chunk from c0 that
  // hold a position with bias > -1e30: read, then mark.
  auto read_bias = [&](int c0, int n, int k0, float (&bv)[BATCH][TS / 32]) {
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int k = k0 + warp * BATCH + u;
#pragma unroll
      for (int j = 0; j < TS / 32; ++j) {
        const int s = (c0 + k) * TS + lane + 32 * j;
        bv[u][j] = k < n && s < S ? biasb[s] : NEG_INF;
      }
    }
  };
  auto mark = [&](int k0, const float (&bv)[BATCH][TS / 32]) {
    bool found = false;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      bool hit = false;
#pragma unroll
      for (int j = 0; j < TS / 32; ++j) hit |= bv[u][j] > NEG_INF;
      if (__any_sync(0xffffffffu, hit)) {
        const int k = k0 + warp * BATCH + u;
        if (lane == 0) atomicOr(&smask[k >> 5], 1u << (k & 31));
        found = true;
      }
    }
    return found;
  };

  // 0: unknown, 1: the row has a position with bias > -1e30, 2: it has none
  int row_state = 0;
  bool first = true;
  for (int c0 = t_lo; c0 < t_hi; c0 += 32 * MASKW) {
    const int n = min(32 * MASKW, t_hi - c0);
    // the chunk's first tile goes out before its mask is known (read
    // whatever its bias, it adds exactly 0 if it holds no valid position),
    // beside the first bias reads, or right after them where its
    // addresses need the page ids
    float bv[BATCH][TS / 32];
    if (row_state != 2) read_bias(c0, n, 0, bv);
    if constexpr (!Rows::kIds) {
      issue(c0, 0);
      cp_async_commit();
    }
    rows.prepare(c0 * TS, S, 0, tid);
    if (tid < MASKW) smask[tid] = 0u;
    __syncthreads();
    if constexpr (Rows::kIds) {
      issue(c0, 0);
      cp_async_commit();
    }
    if (first) {
      math.stage_q(msh);
      first = false;
    }
    if (row_state != 2) {
      bool found = mark(0, bv);
      for (int k0 = NWARPS * BATCH; k0 < n; k0 += NWARPS * BATCH) {
        read_bias(c0, n, k0, bv);
        found |= mark(k0, bv);
      }
      if (tid == 0) atomicOr(&smask[0], 1u);
      if (__syncthreads_or(found)) {
        row_state = 1;
      } else if (row_state == 0) {
        bool any = false;
        for (int s = tid; s < S && !any; s += NT) any = biasb[s] > NEG_INF;
        row_state = __syncthreads_or(any) ? 1 : 2;
      }
    }
    if (row_state == 2) {            // fully masked row: read every tile
      if (tid < MASKW) {
        const int left = n - 32 * tid;
        smask[tid] = left >= 32 ? 0xffffffffu
                                : (left > 0 ? (1u << left) - 1u : 0u);
      }
      __syncthreads();
    }

    // the ring over the marked tiles: ordinal k lives in slot k % STAGES;
    // ordinal 0 is the chunk's first tile, already on its way
    int d = next_tile(smask, 1, n);        // next tile whose ids to read
#pragma unroll
    for (int k = 1; k < STAGES; ++k) {
      if (d < n) rows.prepare((c0 + d) * TS, S, k, tid);
      d = next_tile(smask, d + 1, n);
    }
    __syncthreads();
    int is = next_tile(smask, 1, n);       // next tile to copy
#pragma unroll
    for (int k = 1; k < STAGES - 1; ++k) {
      if (is < n) issue(c0 + is, k);
      cp_async_commit();
      is = next_tile(smask, is + 1, n);
    }
    int cur = 0;
    for (int k = 0; cur < n; ++k) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();                     // tile k landed; slot k-1 free
      if (is < n) issue(c0 + is, (k + STAGES - 1) % STAGES);
      cp_async_commit();
      is = next_tile(smask, is + 1, n);
      if (d < n) rows.prepare((c0 + d) * TS, S, k % STAGES, tid);
      d = next_tile(smask, d + 1, n);
      compute(c0 + cur, k % STAGES);
      cur = next_tile(smask, cur + 1, n);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // sum the RG partial sums of o through the (now idle) ring
  float* red = reinterpret_cast<float*>(ring);    // [RG][8][DH]
  math.finish(msh, red, sm, sl);
  __syncthreads();
  auto reduced = [&](int i) {      // output pair i of the group: (g, d)
    const int g = i / (DH / 2), d = 2 * (i % (DH / 2));
    float2 r = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < RG; ++j) {
      const float2 x =
          *reinterpret_cast<const float2*>(red + (j * 8 + g) * DH + d);
      r.x += x.x;
      r.y += x.y;
    }
    return r;
  };

  if (splits == 1) {
    for (int i = tid; i < G * DH / 2; i += NT)
      *reinterpret_cast<float2*>(o_out + head0 * DH + 2 * i) = reduced(i);
    if (tid < G) {
      m_out[head0 + tid] = sm[tid];
      l_out[head0 + tid] = sl[tid];
    }
    return;
  }

  // once every rank has left its loop (rank 0's ring is idle), each rank
  // writes its partial (o, m, l) into rank 0's ring and leaves; rank 0
  // waits for all of them and merges
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int stride = G * DH + 2 * G;              // one rank's partial
  float* xchg = red + RG * 8 * DH;                // [splits][stride]
  float* mine = cluster.map_shared_rank(xchg, 0) + rank * stride;
  for (int i = tid; i < G * DH / 2; i += NT)
    *reinterpret_cast<float2*>(mine + 2 * i) = reduced(i);
  if (tid < G) {
    mine[G * DH + tid] = sm[tid];
    mine[G * DH + G + tid] = sl[tid];
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  __shared__ float sw[MAX_SPLITS][8];             // e^{m_r - m}, rank r
  if (tid < G) {
    float mstar = NEG_INF;
    for (int r = 0; r < splits; ++r)
      mstar = fmaxf(mstar, xchg[r * stride + G * DH + tid]);
    float l = 0.f;
    for (int r = 0; r < splits; ++r) {
      sw[r][tid] = expf(xchg[r * stride + G * DH + tid] - mstar);
      l += sw[r][tid] * xchg[r * stride + G * DH + G + tid];
    }
    m_out[head0 + tid] = mstar;
    l_out[head0 + tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < G * DH / 2; i += NT) {
    const int g = i / (DH / 2);
    float2 o = make_float2(0.f, 0.f);
    for (int r = 0; r < splits; ++r) {
      const float2 x =
          *reinterpret_cast<const float2*>(xchg + r * stride + 2 * i);
      o.x += sw[r][g] * x.x;
      o.y += sw[r][g] * x.y;
    }
    *reinterpret_cast<float2*>(o_out + head0 * DH + 2 * i) = o;
  }
}

template <typename T, int DH, int GP>
__global__ void __launch_bounds__(NT, 1)
flash_decode_kernel(const T* __restrict__ q,        // [B, H, DH]
                    const T* __restrict__ k,        // [B, S, Hk, DH]
                    const T* __restrict__ v,        // [B, S, Hk, DH]
                    const float* __restrict__ bias, // [B, S]
                    float* __restrict__ o_out,      // [B, H, DH]
                    float* __restrict__ m_out,      // [B, H]
                    float* __restrict__ l_out,      // [B, H]
                    int H, int Hk, int S, float scale, float softcap) {
  const int hk = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const size_t row = (size_t)Hk * DH;    // stride between cache positions
  const Dense rows{(size_t)b * S * row, row};
  flash_decode_body<T, DH, GP>(
      q, k + (size_t)hk * DH, v + (size_t)hk * DH, bias + (size_t)b * S,
      o_out, m_out, l_out, rows, b, hk, split, gridDim.y, H, Hk, S, scale,
      softcap);
}

template <typename T, int DH, int GP>
__global__ void __launch_bounds__(NT, 1)
flash_decode_paged_kernel(const T* __restrict__ q,        // [B, H, DH]
                          const T* __restrict__ k_pool,   // [P, ps, Hk, DH]
                          const T* __restrict__ v_pool,   // [P, ps, Hk, DH]
                          const int* __restrict__ table,  // [B, MP]
                          const float* __restrict__ bias, // [B, MP * ps]
                          float* __restrict__ o_out,      // [B, H, DH]
                          float* __restrict__ m_out,      // [B, H]
                          float* __restrict__ l_out,      // [B, H]
                          int H, int Hk, int ps, int MP, float scale,
                          float softcap) {
  using Sh = Shape<T, DH, GP>;
  __shared__ int ids[Sh::STAGES * Sh::TS];   // page ids of ring tiles
  const int hk = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int S = MP * ps;
  const Paged rows{table + (size_t)b * MP, ps, (size_t)Hk * DH, ids,
                   Sh::TS};
  flash_decode_body<T, DH, GP>(
      q, k_pool + (size_t)hk * DH, v_pool + (size_t)hk * DH,
      bias + (size_t)b * S, o_out, m_out, l_out, rows, b, hk, split,
      gridDim.y, H, Hk, S, scale, softcap);
}

// Lets a kernel take the ring as dynamic shared memory above 48 KB, once
// per device.
template <typename K>
cudaError_t allow_ring(K kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

// The instantiation of a layout for (T, DH, GP): its kernel, made ready
// for its ring.
template <bool PAGED, typename T, int DH, int GP>
struct Kernel {
  static auto fn() {
    if constexpr (PAGED)
      return flash_decode_paged_kernel<T, DH, GP>;
    else
      return flash_decode_kernel<T, DH, GP>;
  }
  static cudaError_t ready() {
    static bool done[MAX_DEVICES] = {};
    return allow_ring(fn(), Shape<T, DH, GP>::RING_BYTES, done);
  }
};

// The cache's addressing arguments: dense (S) or paged (table, ps, MP).
struct Layout {
  const int* table;
  int S, ps, MP;
};

template <bool PAGED, typename T, int DH, int GP>
int launch(const void* q, const void* k, const void* v, Layout lay,
           const void* bias, void* o, void* m, void* l, int B, int H, int Hk,
           int splits, float scale, float softcap, cudaStream_t stream) {
  using Kn = Kernel<PAGED, T, DH, GP>;
  cudaError_t err = Kn::ready();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the splits of one (row, KV head) form one cluster along y
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hk, splits, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Shape<T, DH, GP>::RING_BYTES;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* bt = static_cast<const float*>(bias);
  float* ot = static_cast<float*>(o);
  float* mt = static_cast<float*>(m);
  float* lt = static_cast<float*>(l);
  if constexpr (PAGED)
    err = cudaLaunchKernelEx(&cfg, flash_decode_paged_kernel<T, DH, GP>, qt,
                             kt, vt, lay.table, bt, ot, mt, lt, H, Hk, lay.ps,
                             lay.MP, scale, softcap);
  else
    err = cudaLaunchKernelEx(&cfg, flash_decode_kernel<T, DH, GP>, qt, kt, vt,
                             bt, ot, mt, lt, H, Hk, lay.S, scale, softcap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Registers, spilled bytes, shared memory per CTA and resident CTAs per
// SM of one instantiation.
template <bool PAGED, typename T, int DH, int GP>
int attributes(int* out) {
  using Kn = Kernel<PAGED, T, DH, GP>;
  const size_t ring = Shape<T, DH, GP>::RING_BYTES;
  cudaError_t err = Kn::ready();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, Kn::fn());
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kn::fn(), NT,
                                                      ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + ring);
  out[3] = per_sm;
  return 0;
}

// Calls F<PAGED, T, DH, GP>::run(args...) for the runtime choice, or
// returns -2 for a type or head dim the kernel does not take.
template <template <bool, typename, int, int> class F, bool PAGED,
          typename... A>
int dispatch(int dh, int is_bf16, int G, A... args) {
  const bool wide = G > 4;             // f32 only: bf16 pads to 16 rows
  if (is_bf16) {
    if (dh == 16) return F<PAGED, __nv_bfloat16, 16, 8>::run(args...);
    if (dh == 64) return F<PAGED, __nv_bfloat16, 64, 8>::run(args...);
    if (dh == 128) return F<PAGED, __nv_bfloat16, 128, 8>::run(args...);
  } else {
    if (dh == 16)
      return wide ? F<PAGED, float, 16, 8>::run(args...)
                  : F<PAGED, float, 16, 4>::run(args...);
    if (dh == 64)
      return wide ? F<PAGED, float, 64, 8>::run(args...)
                  : F<PAGED, float, 64, 4>::run(args...);
    if (dh == 128)
      return wide ? F<PAGED, float, 128, 8>::run(args...)
                  : F<PAGED, float, 128, 4>::run(args...);
  }
  return -2;
}

template <bool PAGED, typename T, int DH, int GP>
struct Launch {
  template <typename... A>
  static int run(A... args) {
    return launch<PAGED, T, DH, GP>(args...);
  }
};

template <bool PAGED, typename T, int DH, int GP>
struct Attributes {
  static int run(int* out) { return attributes<PAGED, T, DH, GP>(out); }
};

bool takes(int B, int H, int Hk, int splits) {
  return B >= 1 && B <= 65535 && Hk >= 1 && Hk <= 65535 && H % Hk == 0 &&
         H / Hk <= GMAX && splits >= 1 && splits <= MAX_SPLITS;
}

}  // namespace

// Plain C entry points.  Each returns cudaGetLastError() after the launch
// (0 on success), or a negative code for a shape the kernel does not
// take.  is_bf16: 1 for bfloat16 q/k/v, 0 for float32.  softcap 0 means
// none.  splits: CTAs along S for each (row, KV head), 1 to 8, from
// split_plan in kernel.py.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* bias, void* o,
                                   void* m, void* l, int B, int H, int Hk,
                                   int S, int dh, int is_bf16, int splits,
                                   float scale, float softcap,
                                   void* stream) {
  if (S < 1 || !takes(B, H, Hk, splits)) return -1;
  const Layout lay{nullptr, S, 0, 0};
  return dispatch<Launch, false>(dh, is_bf16, H / Hk, q, k, v, lay, bias, o,
                                 m, l, B, H, Hk, splits, scale, softcap,
                                 static_cast<cudaStream_t>(stream));
}

// P (pages in the pool) bounds only the arguments' sanity: the ids in the
// table are the caller's contract.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* bias, void* o, void* m, void* l, int B, int H, int Hk, int P,
    int ps, int MP, int dh, int is_bf16, int splits, float scale,
    float softcap, void* stream) {
  if (P < 1 || ps < 1 || MP < 1 || !takes(B, H, Hk, splits)) return -1;
  if ((long long)MP * ps > 0x7fffffffLL) return -1;
  const Layout lay{static_cast<const int*>(table), MP * ps, ps, MP};
  return dispatch<Launch, true>(dh, is_bf16, H / Hk, q, k_pool, v_pool, lay,
                                bias, o, m, l, B, H, Hk, splits, scale,
                                softcap, static_cast<cudaStream_t>(stream));
}

// out[4] = registers, spilled bytes, shared memory per CTA, CTAs per SM of
// the instantiation (paged or dense, dh, type and, for f32, heads per KV
// head rounded up to 4 or 8); 0 on success.
extern "C" int flash_decode_attributes(int paged, int dh, int is_bf16,
                                       int group, int* out) {
  if (paged) return dispatch<Attributes, true>(dh, is_bf16, group, out);
  return dispatch<Attributes, false>(dh, is_bf16, group, out);
}
