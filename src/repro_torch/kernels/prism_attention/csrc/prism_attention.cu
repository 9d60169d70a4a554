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
// Bound: in bf16 at the exchange's shapes, bytes.  It must read q, the
// local K/V, the mean K/V, the bias and the mask once and write the
// output, and do 4 flops per (query, key, dim).  For ViT-B/16 on two
// partitions (Nq = Nk = 100, M = 40, dh 64) that is ~58 flops per byte,
// below the H100's bf16 ridge (~295) but above its f32 one (~20), so f32
// inputs are bound by operations.  The kernel here is far from either
// bound: it computes the products on the CUDA cores in f32.
//
// Design: one CTA of 128 threads per (query tile, KV head, batch row).  A
// CTA holds R = 32 query rows: TQ = R / G queries of each of the G query
// heads that share a KV head, so each K/V tile read from device memory
// serves all G heads (the Pallas grid (B, H, Nq/TQ) re-reads it per head).
// R is small so that many CTAs are in flight: at the ViT shape the grid
// is 4 x 12 x 8 = 384 CTAs, and each walks its key tiles one after
// another.
// The queries sit in shared memory, pre-scaled, in f32.  A loop over key
// tiles of TK = 32 positions, first the local keys then the means as
// further tiles, stages each K and V tile in shared memory as f32 and
// carries an online softmax (m, l) per row, in place of the TPU's whole
// [Nk] and [M] blocks in VMEM:
//   * scores: warp w owns rows w, w+4, ..., lane t owns key t of the tile,
//     so the row's max and sum are warp shuffles and the probabilities go
//     to shared memory once;
//   * p . V: each thread owns fixed (row, dim) accumulator elements.
// On the CUDA cores the products are bound by shared-memory reads, not by
// the FMAs: a first version read one float per FMA and ran slower than
// the plain version.  Here every read is 16 bytes: a query row's 4 dims
// (one broadcast to the warp) feed 4 FMAs, a lane's 4 K dims are reused
// over the warp's R / 4 rows, and a row's 4 probabilities (a broadcast) feed
// 4 FMAs against V values kept in registers.  K rows are padded to DH + 4
// floats so the 16-byte reads of the lanes of a quarter warp hit distinct
// banks.  Each thread issues all its 16-byte device loads of a q block or
// a K/V tile before its first store to shared memory, so their latencies
// overlap, and a tile's loads go out before the barrier that waits for
// the previous tile's p . V.
// Limits of this first version: no tensor cores (wgmma) and no cp.async
// or TMA pipelining of the next tile under this tile's math; under causal
// attention it still visits key tiles that are wholly in the future
// (their scores are -1e30, as the all-masked row needs them counted).
//
// Built by repro_torch/kernels/nvcc.py with
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
constexpr int R = 32;              // query rows per CTA (G heads x TQ)
constexpr int TK = 32;             // keys per tile (one per lane)
constexpr int RPW = R / NWARPS;    // rows per warp in the softmax
constexpr float NEG_INF = -1e30f;  // the JAX package's mask value

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The 16 bytes in u as floats: 8 bf16 values or 4 f32 ones.
template <typename T> __device__ __forceinline__ void unpack(const uint4& u,
                                                             float* out);
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u,
                                                      float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* out) {
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

// K rows are padded to DH + 4 floats (KS in the kernel).
template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (R * DH + TK * (DH + 4) + TK * DH + R * TK + 4 * R);
}

// TO is the output type: T on the serving path; f32 when a check wants
// the result before its final rounding to bf16.
template <typename T, typename TO, int DH>
__global__ void __launch_bounds__(NT)
prism_attention_kernel(const T* __restrict__ q,       // [B, Nq, H, DH]
                       const T* __restrict__ k,       // [B, Nk, Hk, DH]
                       const T* __restrict__ v,       // [B, Nk, Hk, DH]
                       const T* __restrict__ km,      // [B, M, Hk, DH]
                       const T* __restrict__ vm,      // [B, M, Hk, DH]
                       const float* __restrict__ mean_bias,  // [B, M]
                       const uint8_t* __restrict__ kv_mask,  // [B, Nk]|null
                       TO* __restrict__ out,          // [B, Nq, H, DH]
                       int Nq, int Nk, int M, int H, int Hk, int TQ,
                       int causal, int q_offset, float scale,
                       float softcap) {
  constexpr int KS = DH + 4;         // padded K row, in floats
  constexpr int RSTEP = NT / DH;     // rows between a thread's elements
  constexpr int NOUT = R / RSTEP;    // accumulator elements per thread
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int QLOADS = R * DH / VEC / NT;    // q loads per thread
  constexpr int KLOADS = TK * DH / VEC / NT;   // K (and V) loads per thread
  static_assert(NT % DH == 0 && R % NWARPS == 0 && TK == 32 &&
                QLOADS * VEC * NT == R * DH && KLOADS * VEC * NT == TK * DH,
                "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                      // [R][DH]   scaled queries
  float* sk = sq + R * DH;               // [TK][KS]  K tile
  float* sv = sk + TK * KS;              // [TK][DH]  V tile
  float* sp = sv + TK * DH;              // [R][TK]   probabilities
  float* sa = sp + R * TK;               // [R]       rescale of this tile
  float* sm = sa + R;                    // [R]       running max
  float* sl = sm + R;                    // [R]       running sum

  const int q0 = blockIdx.x * TQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // queries of the G heads of this KV head, rows r = g * TQ + i
  {
    uint4 raw[QLOADS];
#pragma unroll
    for (int it = 0; it < QLOADS; ++it) {
      const int c = (tid + it * NT) * VEC;
      const int r = c / DH, d = c % DH;
      const int g = r / TQ, qi = q0 + r % TQ;
      raw[it] = make_uint4(0, 0, 0, 0);
      if (g < G && qi < Nq)
        raw[it] = *reinterpret_cast<const uint4*>(
            q + (((size_t)b * Nq + qi) * H + hk * G + g) * DH + d);
    }
#pragma unroll
    for (int it = 0; it < QLOADS; ++it) {
      float f[VEC];
      unpack<T>(raw[it], f);
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
  const int d_own = tid % DH;        // this thread's output dim
  const int r_own = tid / DH;        // and its first output row

  const int n_loc = (Nk + TK - 1) / TK;
  const int n_tiles = n_loc + (M + TK - 1) / TK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool is_mean = tile >= n_loc;
    const int j0 = (is_mean ? tile - n_loc : tile) * TK;
    const int n = is_mean ? M : Nk;
    const T* kb = is_mean ? km : k;
    const T* vb = is_mean ? vm : v;
    uint4 kraw[KLOADS], vraw[KLOADS];
#pragma unroll
    for (int it = 0; it < KLOADS; ++it) {
      const int c = (tid + it * NT) * VEC;
      const int t = c / DH, d = c % DH;
      kraw[it] = vraw[it] = make_uint4(0, 0, 0, 0);
      if (j0 + t < n) {
        const size_t src = (((size_t)b * n + j0 + t) * Hk + hk) * DH + d;
        kraw[it] = *reinterpret_cast<const uint4*>(kb + src);
        vraw[it] = *reinterpret_cast<const uint4*>(vb + src);
      }
    }
    __syncthreads();                 // the last tile's p . V is done
#pragma unroll
    for (int it = 0; it < KLOADS; ++it) {
      const int c = (tid + it * NT) * VEC;
      const int t = c / DH, d = c % DH;
      float f[VEC];
      unpack<T>(kraw[it], f);
      sts<VEC>(sk + t * KS + d, f);
      unpack<T>(vraw[it], f);
      sts<VEC>(sv + t * DH + d, f);
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
    for (int d = 0; d < DH; d += 4) {
      const float4 kd = lds4(krow + d);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qd = lds4(sq + (warp + NWARPS * i) * DH + d);
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
      const float v0 = sv[t * DH + d_own], v1 = sv[(t + 1) * DH + d_own];
      const float v2 = sv[(t + 2) * DH + d_own], v3 = sv[(t + 3) * DH + d_own];
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
      out[(((size_t)b * Nq + qi) * H + hk * G + g) * DH + d_own] =
          from_f32<TO>(acc[i] / sl[r]);
  }
}

template <typename T, typename TO, int DH>
int launch(const void* q, const void* k, const void* v, const void* km,
           const void* vm, const void* bias, const void* mask, void* out,
           int B, int Nq, int Nk, int M, int H, int Hk, int causal,
           int q_offset, float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      prism_attention_kernel<T, TO, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int TQ = R / (H / Hk);
  const dim3 grid((Nq + TQ - 1) / TQ, Hk, B);
  prism_attention_kernel<T, TO, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(km),
      static_cast<const T*>(vm), static_cast<const float*>(bias),
      static_cast<const uint8_t*>(mask), static_cast<TO*>(out), Nq, Nk, M, H,
      Hk, TQ, causal, q_offset, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TO>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const void* km, const void* vm, const void* bias,
              const void* mask, void* out, int B, int Nq, int Nk, int M,
              int H, int Hk, int causal, int q_offset, float scale,
              float softcap, cudaStream_t st) {
  if (dh == 64)
    return launch<T, TO, 64>(q, k, v, km, vm, bias, mask, out, B, Nq, Nk, M,
                             H, Hk, causal, q_offset, scale, softcap, st);
  if (dh == 128)
    return launch<T, TO, 128>(q, k, v, km, vm, bias, mask, out, B, Nq, Nk, M,
                              H, Hk, causal, q_offset, scale, softcap, st);
  return -2;
}

}  // namespace

// Plain C entry point.  Returns cudaGetLastError() after the launch (0 on
// success), or a negative code for a shape the kernel does not take.
// kv_mask may be null (every local key valid).  is_bf16: 1 for bfloat16
// q/k/v/means, 0 for float32.  out_f32: 1 writes the output as float32,
// 0 in the inputs' type.  softcap 0 means none.
extern "C" int prism_attention_launch(
    const void* q, const void* k, const void* v, const void* km,
    const void* vm, const void* mean_bias, const void* kv_mask, void* out,
    int B, int Nq, int Nk, int M, int H, int Hk, int dh, int is_bf16,
    int out_f32, int causal, int q_offset, float scale, float softcap,
    void* stream) {
  if (B < 1 || Nq < 1 || Nk < 1 || M < 0 || Hk < 1 || H % Hk != 0) return -1;
  if (H / Hk > R || B > 65535 || Hk > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_dh<float, float>(dh, q, k, v, km, vm, mean_bias, kv_mask,
                                   out, B, Nq, Nk, M, H, Hk, causal,
                                   q_offset, scale, softcap, st);
  if (out_f32)
    return launch_dh<__nv_bfloat16, float>(dh, q, k, v, km, vm, mean_bias,
                                           kv_mask, out, B, Nq, Nk, M, H, Hk,
                                           causal, q_offset, scale, softcap,
                                           st);
  return launch_dh<__nv_bfloat16, __nv_bfloat16>(
      dh, q, k, v, km, vm, mean_bias, kv_mask, out, B, Nq, Nk, M, H, Hk,
      causal, q_offset, scale, softcap, st);
}
