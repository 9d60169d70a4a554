// Segment means for Hopper (PRISM Eq. 1): the column-wise mean of each of
// L equal token segments, with an optional validity mask, of one tensor or
// of two (K and V) in one launch.
//
// Replaces the TPU kernel `segment_means_pallas` in
// src/repro/kernels/segment_means/kernel.py (pallas_call at line 34) AND
// the masked variant that the JAX package composes around it in
// src/repro/kernels/dispatch.py:94-116 (means of x*mask, times seg, over
// max(count, 1), plus a separate count reduction).  Here one kernel reads
// each input and the mask once and writes both results, for T = 1 or 2
// inputs x_t of one shape [B, N, D]:
//   count[b, l]     = sum_{s < seg} mask[b, l*seg + s]      (seg if no mask)
//   out[t, b, l, d] = (sum_s x_t[b, l*seg + s, d] * mask[b, l*seg + s])
//                     / max(count[b, l], 1)
// with the sums in f32, the quotient taken as the sum times 1 / max(count,
// 1) (within an f32 rounding of the division), and out cast back to x's
// type.  The feature dims are flattened into D (any D: no lane padding).
//
// Bound: bytes.  It must read the T inputs (T*B*N*D elements) and the
// mask and write T*B*L*D means and the counts, for one add per element
// read; at 3.35 TB/s that traffic is the least time the card needs (0.88
// us for the ViT exchange's K and V, [8, 100, 768] bf16 each).  At that
// size the call is mostly launch and first-byte latency, so the design
// issues few, wide loads from one launch:
//   * one launch for K and V (the exchange used to launch once for each
//     and then copy both into one payload; the [T, B, L, D] output is that
//     payload);
//   * a thread owns one 16-byte lane (8 bf16 or 4 f32 features) of one
//     segment of one input, and issues the 16-byte loads of all of its
//     segment's tokens (up to SEGU at a time) before the first add;
//     neighbouring threads own neighbouring lanes, so each warp's loads
//     are contiguous 512-byte runs of one token row;
//   * a CTA of NT threads covers NT lanes of one batch row of one input,
//     a segment or two: the grid is (lanes of a row / NT, B, T), and the
//     ViT call (20 segments of 96 lanes, B 8, T 2) is 240 CTAs of 128
//     threads, under two a SM, with no division to find a thread's place
//     but one;
//   * the mean is the sum times one reciprocal of the count: on the H100
//     W IEEE divisions a thread cost more than the loads at this size.
// Every thread counts its segment's mask for itself (seg one-byte loads
// that hit in L1); the lane-0 thread of input 0 writes the count.  Where D
// is not a multiple of the lane width or an input or the output is not
// 16-byte aligned, the same threads load and store their lane's features
// one at a time (the scalar instantiation; the last lane of a row holds
// the tail).
//
// Built by repro_torch/kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas=-v
// into a shared library with a plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;            // threads per CTA
constexpr int SEGU = 8;            // tokens whose loads go out together

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The 16 bytes in u as floats (8 bf16 or 4 f32), and back.
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  const float4 x = *reinterpret_cast<const float4*>(&u);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return u;
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// VEC: 16-byte loads and stores (D a multiple of the lane width, every
// base 16-byte aligned), else one feature at a time.  MASK: a mask is
// given.  Both are template parameters, so no branch separates a thread's
// loads: they all go out before the first add.
template <typename T, bool VEC, bool MASK>
__global__ void __launch_bounds__(NT)
segment_means_kernel(const T* __restrict__ x0,          // [B, N, D]
                     const T* __restrict__ x1,          // [B, N, D] or null
                     const uint8_t* __restrict__ mask,  // [B, N] or null
                     T* __restrict__ out,               // [T, B, L, D]
                     float* __restrict__ counts,        // [B, L]
                     int B, int N, int D, int L) {
  constexpr int W = 16 / sizeof(T);            // features per lane
  const int lanes = (D + W - 1) / W;
  const int i = blockIdx.x * NT + threadIdx.x;  // lane of (b, t)
  if (i >= L * lanes) return;
  const int l = i / lanes, c = i - l * lanes;
  const int b = blockIdx.y, t = blockIdx.z;
  const T* x = t ? x1 : x0;
  const int seg = N / L;
  const size_t tok0 = (size_t)b * N + (size_t)l * seg;
  const int d0 = c * W;
  const int nd = min(W, D - d0);

  float acc[W];
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] = 0.f;
  float cnt = 0.f;
  for (int s0 = 0; s0 < seg; s0 += SEGU) {
    const int ns = min(SEGU, seg - s0);
    uint4 raw[SEGU];
    uint8_t mk[SEGU];
#pragma unroll
    for (int u = 0; u < SEGU; ++u) {
      if (u < ns) {
        if constexpr (VEC)
          raw[u] = *reinterpret_cast<const uint4*>(
              x + (tok0 + s0 + u) * D + d0);
        if constexpr (MASK) mk[u] = mask[tok0 + s0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < SEGU; ++u) {
      if (u < ns) {
        float f[W];
        if constexpr (VEC) {
          unpack(raw[u], f, T());
        } else {
          const T* row = x + (tok0 + s0 + u) * D + d0;
#pragma unroll
          for (int e = 0; e < W; ++e) f[e] = e < nd ? to_f32(row[e]) : 0.f;
        }
        const float m = MASK ? (float)mk[u] : 1.f;
        cnt += m;
#pragma unroll
        for (int e = 0; e < W; ++e) acc[e] += f[e] * m;
      }
    }
  }
  const float inv = 1.f / fmaxf(cnt, 1.f);   // one division, not W
#pragma unroll
  for (int e = 0; e < W; ++e) acc[e] *= inv;
  T* dst = out + (((size_t)t * B + b) * L + l) * D + d0;
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(dst) = pack(acc, T());
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e)
      if (e < nd) dst[e] = from_f32<T>(acc[e]);
  }
  if (t == 0 && c == 0) counts[(size_t)b * L + l] = cnt;
}

template <typename T, bool VEC, bool MASK>
int launch_as(const void* x0, const void* x1, const void* mask, void* out,
              void* counts, int B, int N, int D, int L, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  const long long per_row = (long long)L * ((D + W - 1) / W);
  if (per_row > 0x7fffffffLL - NT) return -1;
  const dim3 grid((unsigned)((per_row + NT - 1) / NT), B, x1 ? 2 : 1);
  segment_means_kernel<T, VEC, MASK><<<grid, NT, 0, st>>>(
      static_cast<const T*>(x0), static_cast<const T*>(x1),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out),
      static_cast<float*>(counts), B, N, D, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x0, const void* x1, const void* mask, void* out,
           void* counts, int B, int N, int D, int L, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = D % W == 0 && aligned(x0) && aligned(x1) && aligned(out);
  if (vec)
    return mask ? launch_as<T, true, true>(x0, x1, mask, out, counts, B, N,
                                           D, L, st)
                : launch_as<T, true, false>(x0, x1, mask, out, counts, B, N,
                                            D, L, st);
  return mask ? launch_as<T, false, true>(x0, x1, mask, out, counts, B, N, D,
                                          L, st)
              : launch_as<T, false, false>(x0, x1, mask, out, counts, B, N,
                                           D, L, st);
}

// Of the instantiation the exchange runs: 16-byte lanes, masked.
template <typename T>
int attributes(int* out) {
  const auto fn = segment_means_kernel<T, true, true>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = per_sm;
  return 0;
}

}  // namespace

// Plain C entry point.  Returns cudaGetLastError() after the launch (0 on
// success), or a negative code for a shape the kernel does not take.  x1
// may be null (one input: out is [1, B, L, D]); mask may be null (every
// token valid).  is_bf16: 1 for bfloat16 x/out, 0 for float32.
extern "C" int segment_means_launch(const void* x0, const void* x1,
                                    const void* mask, void* out,
                                    void* counts, int B, int N, int D, int L,
                                    int is_bf16, void* stream) {
  if (B < 1 || N < 1 || D < 1 || L < 1 || N % L != 0) return -1;
  if (B > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x0, x1, mask, out, counts, B, N, D, L, st);
  return launch<float>(x0, x1, mask, out, counts, B, N, D, L, st);
}

// out[4] = registers, spilled bytes, shared memory per CTA, CTAs per SM of
// the instantiation; 0 on success.
extern "C" int segment_means_attributes(int is_bf16, int* out) {
  return is_bf16 ? attributes<__nv_bfloat16>(out) : attributes<float>(out);
}
