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
//   m[h]    = max_t s[h, t]                    (m starts at -1e30)
//   l[h]    = sum_t exp(s[h, t] - m[h])
//   o[h]    = sum_t exp(s[h, t] - m[h]) * v[t, h / G]
// with G = H / Hk query heads per KV head.  Positions the bias masks
// (-1e30) still count, exactly as the bias math says, so a fully masked
// row gives m = -1e30 and l = S, as in the JAX package; no page is
// skipped.  Positions past S in the ragged last tile contribute nothing.
// Page-table entries may name the same physical page from several rows
// (a shared prefix) or the pool's trash page; ids are the caller's
// contract (0 <= id < P) and are not checked here.
//
// Bound: bytes.  The kernel must read the K and V rows of every position
// it attends once, 2 * positions * Hk * dh * itemsize bytes, against ~4
// flops per element read; at 3.35 TB/s that read is the least time the
// card needs.
//
// Design: one CTA per (batch row, KV head).  The Pallas grid (B, H, S/TS)
// re-reads every K/V tile once per query head; here the G query heads of a
// group share each K/V tile read from device memory.  A loop over S tiles
// of TS positions carries an f32 online softmax (m, l, acc) in shared
// memory and registers, in place of the TPU's sequential grid axis.  The
// two layouts differ only in where a position's K/V row lies, which the
// body asks of an address mapper: `Dense` gives base + s * row; `Paged`
// resolves the tile's positions through the page table into shared memory
// at the start of each tile, so no gathered copy of the cache is ever
// made, and any page size >= 1 works (a tile may span several pages).
//   * the V tile is staged in shared memory as f32 (zeros past S);
//   * scores: two threads per cache position, each reading half of the
//     K row with 16-byte loads and dotting it with all G queries, joined
//     by one shuffle (a warp-wide butterfly per position and head made
//     the scores a chain of dependent shuffles that dominated the time);
//   * each thread owns fixed (head, dim) accumulator elements.
// Limits of this first version: the grid is B * Hk CTAs, so at batch 1
// llama3.2-1b (Hk = 8) fills only 8 of the H100's 132 SMs, and the paged
// layout reads every table position, the masked ones too.  Splitting S
// across CTAs with a merge pass, cp.async / TMA pipelining across tiles
// (the next tile's loads under this tile's math, whole pages at a time)
// and reading only the valid pages are later work.
//
// Built by repro_torch/kernels/flash_decode/kernel.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;            // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int TS = 64;             // cache positions per tile
constexpr int GMAX = 8;            // most query heads per KV head
constexpr float NEG_INF = -1e30f;  // the JAX package's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Load N consecutive elements starting at p as floats, 16 bytes at a
// time: p must be 16-byte aligned.
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* __restrict__ p,
                                         float* out) {
  static_assert(N % 8 == 0, "16-byte loads");
#pragma unroll
  for (int e = 0; e < N; e += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + e);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[e + 2 * j] = f.x;
      out[e + 2 * j + 1] = f.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float* out) {
  static_assert(N % 4 == 0, "16-byte loads");
#pragma unroll
  for (int e = 0; e < N; e += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + e);
    out[e] = f.x;
    out[e + 1] = f.y;
    out[e + 2] = f.z;
    out[e + 3] = f.w;
  }
}

// Where a position's K/V row starts, in elements from the cache's base
// (the KV head's offset is added by the body).  `Dense`: row b's cache
// is contiguous.  `Paged`: each tile's positions are looked up in row
// b's page table once, by `resolve`, into shared memory.
struct Dense {
  static constexpr bool kResolves = false;
  size_t base;                         // b * S * row
  size_t row;                          // Hk * DH
  __device__ __forceinline__ void resolve(int, int, int) {}
  __device__ __forceinline__ size_t at(int, int s) const {
    return base + (size_t)s * row;
  }
};

struct Paged {
  static constexpr bool kResolves = true;
  const int* table;                    // row b of the page table, [MP]
  int ps;
  size_t row;
  size_t* srow;                        // [TS] in shared memory
  __device__ __forceinline__ void resolve(int s0, int S, int tid) {
    if (tid < TS && s0 + tid < S) {
      const int s = s0 + tid;
      const size_t page = (size_t)table[s / ps];
      srow[tid] = (page * ps + (size_t)(s % ps)) * row;
    }
  }
  __device__ __forceinline__ size_t at(int t, int) const { return srow[t]; }
};

template <typename T, int DH, typename Rows>
__device__ __forceinline__ void
flash_decode_body(const T* __restrict__ q,        // [B, H, DH]
                  const T* __restrict__ kb,       // K cache + hk * DH
                  const T* __restrict__ vb,       // V cache + hk * DH
                  const float* __restrict__ biasb,  // row b of [B, S]
                  float* __restrict__ o_out,      // [B, H, DH]
                  float* __restrict__ m_out,      // [B, H]
                  float* __restrict__ l_out,      // [B, H]
                  Rows rows, int b, int hk, int H, int Hk, int S,
                  float scale, float softcap) {
  constexpr int VEC = 8;                 // V elements per staging load
  constexpr int NOUT = GMAX * DH / NT;   // accumulator elements per thread
  constexpr int VITER = TS * DH / VEC / NT;  // V staging loads per thread
  static_assert(TS * 2 == NT && DH % 16 == 0 && (GMAX * DH) % NT == 0 &&
                (TS * DH / VEC) % NT == 0, "tile shape");

  __shared__ float sq[GMAX][DH];   // scaled queries of the group
  __shared__ float sv[TS][DH];     // V tile, f32
  __shared__ float sp[GMAX][TS];   // scores, then probabilities
  __shared__ float sm[GMAX];       // running max
  __shared__ float sl[GMAX];       // running sum
  __shared__ float salpha[GMAX];   // rescale of this tile

  const int G = H / Hk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t head0 = (size_t)b * H + (size_t)hk * G;

  for (int i = tid; i < G * DH; i += NT) {
    const int g = i / DH, d = i % DH;
    sq[g][d] = to_f32(q[(head0 + g) * DH + d]) * scale;
  }
  if (tid < GMAX) {
    sm[tid] = NEG_INF;
    sl[tid] = 0.f;
  }
  float acc[NOUT];
#pragma unroll
  for (int i = 0; i < NOUT; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += TS) {
    if constexpr (Rows::kResolves) {
      rows.resolve(s0, S, tid);
      __syncthreads();
    }

    // stage the V tile as f32 (zeros past S, so 0 * v never meets garbage)
#pragma unroll
    for (int j = 0; j < VITER; ++j) {
      const int c = tid + j * NT;
      const int t = c / (DH / VEC);
      const int d0 = (c % (DH / VEC)) * VEC;
      float f[VEC];
      if (s0 + t < S) {
        load_f32<VEC>(vb + rows.at(t, s0 + t) + d0, f);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sv[t][d0 + e] = f[e];
    }

    // scores: two threads per cache position, each dotting one half of
    // the K row with all G query heads; one shuffle joins the halves
    {
      const int t = tid >> 1;
      const int half = tid & 1;
      const int s = s0 + t;
      float kf[DH / 2];
      if (s < S) {
        load_f32<DH / 2>(kb + rows.at(t, s) + half * (DH / 2), kf);
      } else {
#pragma unroll
        for (int e = 0; e < DH / 2; ++e) kf[e] = 0.f;
      }
      const float bs = s < S ? biasb[s] : 0.f;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {                         // block-uniform
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < DH / 2; ++e)
            dot += sq[g][half * (DH / 2) + e] * kf[e];
          dot += __shfl_xor_sync(0xffffffffu, dot, 1);
          if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
          if (half == 0 && s < S) sp[g][t] = dot + bs;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += NWARPS) {
      constexpr int PER = TS / 32;
      float x[PER];
      bool ok[PER];
      float tmax = -CUDART_INF_F;  // every tile holds a position < S
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int t = lane + 32 * j;
        ok[j] = s0 + t < S;
        x[j] = ok[j] ? sp[g][t] : 0.f;
        if (ok[j]) tmax = fmaxf(tmax, x[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, tmax);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float p = ok[j] ? expf(x[j] - m_new) : 0.f;
        sp[g][lane + 32 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        salpha[g] = alpha;
        sl[g] = sl[g] * alpha + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // accumulate p · V into this thread's (head, dim) elements
#pragma unroll
    for (int i = 0; i < NOUT; ++i) {
      const int idx = tid + i * NT;
      const int g = idx / DH, d = idx % DH;  // g is warp-uniform
      if (g < G) {
        float a0 = acc[i] * salpha[g], a1 = 0.f;   // two FMA chains
#pragma unroll 8
        for (int t = 0; t < TS; t += 2) {
          a0 += sp[g][t] * sv[t][d];
          a1 += sp[g][t + 1] * sv[t + 1][d];
        }
        acc[i] = a0 + a1;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < NOUT; ++i) {
    const int idx = tid + i * NT;
    const int g = idx / DH, d = idx % DH;
    if (g < G) o_out[(head0 + g) * DH + d] = acc[i];
  }
  if (tid < G) {
    m_out[head0 + tid] = sm[tid];
    l_out[head0 + tid] = sl[tid];
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q,        // [B, H, DH]
                    const T* __restrict__ k,        // [B, S, Hk, DH]
                    const T* __restrict__ v,        // [B, S, Hk, DH]
                    const float* __restrict__ bias, // [B, S]
                    float* __restrict__ o_out,      // [B, H, DH]
                    float* __restrict__ m_out,      // [B, H]
                    float* __restrict__ l_out,      // [B, H]
                    int H, int Hk, int S, float scale, float softcap) {
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row = (size_t)Hk * DH;    // stride between cache positions
  const Dense rows{(size_t)b * S * row, row};
  flash_decode_body<T, DH>(q, k + (size_t)hk * DH, v + (size_t)hk * DH,
                           bias + (size_t)b * S, o_out, m_out, l_out, rows,
                           b, hk, H, Hk, S, scale, softcap);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
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
  __shared__ size_t srow[TS];            // pool offset of each tile position
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int S = MP * ps;
  const Paged rows{table + (size_t)b * MP, ps, (size_t)Hk * DH, srow};
  flash_decode_body<T, DH>(q, k_pool + (size_t)hk * DH,
                           v_pool + (size_t)hk * DH, bias + (size_t)b * S,
                           o_out, m_out, l_out, rows, b, hk, H, Hk, S, scale,
                           softcap);
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, const void* bias,
            void* o, void* m, void* l, int B, int H, int Hk, int S,
            float scale, float softcap, cudaStream_t stream) {
  const dim3 grid(Hk, B);
  flash_decode_kernel<T, DH><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      H, Hk, S, scale, softcap);
}

template <typename T, int DH>
void launch_paged(const void* q, const void* k, const void* v,
                  const int* table, const void* bias, void* o, void* m,
                  void* l, int B, int H, int Hk, int ps, int MP, float scale,
                  float softcap, cudaStream_t stream) {
  const dim3 grid(Hk, B);
  flash_decode_paged_kernel<T, DH><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      H, Hk, ps, MP, scale, softcap);
}

}  // namespace

// Plain C entry points.  Each returns cudaGetLastError() after the launch
// (0 on success), or a negative code for a shape the kernel does not
// take.  is_bf16: 1 for bfloat16 q/k/v, 0 for float32.  softcap 0 means
// none.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* bias, void* o,
                                   void* m, void* l, int B, int H, int Hk,
                                   int S, int dh, int is_bf16, float scale,
                                   float softcap, void* stream) {
  if (B < 1 || S < 1 || Hk < 1 || H % Hk != 0 || H / Hk > GMAX) return -1;
  if (B > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (dh == 64)
      launch<__nv_bfloat16, 64>(q, k, v, bias, o, m, l, B, H, Hk, S, scale,
                                softcap, st);
    else if (dh == 128)
      launch<__nv_bfloat16, 128>(q, k, v, bias, o, m, l, B, H, Hk, S, scale,
                                 softcap, st);
    else
      return -2;
  } else {
    if (dh == 64)
      launch<float, 64>(q, k, v, bias, o, m, l, B, H, Hk, S, scale, softcap,
                        st);
    else if (dh == 128)
      launch<float, 128>(q, k, v, bias, o, m, l, B, H, Hk, S, scale, softcap,
                         st);
    else
      return -2;
  }
  return static_cast<int>(cudaGetLastError());
}

// P (pages in the pool) bounds only the arguments' sanity: the ids in the
// table are the caller's contract.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* bias, void* o, void* m, void* l, int B, int H, int Hk,
    int P, int ps, int MP, int dh, int is_bf16, float scale, float softcap,
    void* stream) {
  if (B < 1 || P < 1 || ps < 1 || MP < 1 || Hk < 1 || H % Hk != 0 ||
      H / Hk > GMAX)
    return -1;
  if (B > 65535 || (long long)MP * ps > 0x7fffffffLL) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  if (is_bf16) {
    if (dh == 64)
      launch_paged<__nv_bfloat16, 64>(q, k_pool, v_pool, tb, bias, o, m, l,
                                      B, H, Hk, ps, MP, scale, softcap, st);
    else if (dh == 128)
      launch_paged<__nv_bfloat16, 128>(q, k_pool, v_pool, tb, bias, o, m, l,
                                       B, H, Hk, ps, MP, scale, softcap, st);
    else
      return -2;
  } else {
    if (dh == 64)
      launch_paged<float, 64>(q, k_pool, v_pool, tb, bias, o, m, l, B, H,
                              Hk, ps, MP, scale, softcap, st);
    else if (dh == 128)
      launch_paged<float, 128>(q, k_pool, v_pool, tb, bias, o, m, l, B, H,
                               Hk, ps, MP, scale, softcap, st);
    else
      return -2;
  }
  return static_cast<int>(cudaGetLastError());
}
