// Segment means for Hopper (PRISM Eq. 1): the column-wise mean of each of
// L equal token segments, with an optional validity mask, in one pass.
//
// Replaces the TPU kernel `segment_means_pallas` in
// src/repro/kernels/segment_means/kernel.py (pallas_call at line 34) AND
// the masked variant that the JAX package composes around it in
// src/repro/kernels/dispatch.py:94-116 (means of x*mask, times seg, over
// max(count, 1), plus a separate count reduction).  Here one kernel reads
// x and the mask once and writes both results:
//   count[b, l] = sum_{s < seg} mask[b, l*seg + s]        (seg if no mask)
//   out[b, l, d] = (sum_s x[b, l*seg + s, d] * mask[b, l*seg + s])
//                  / max(count[b, l], 1)
// with the sums in f32 and out cast back to x's type.  x is [B, N, D]
// with the feature dims flattened into D (any D: no lane padding).
//
// Bound: bytes.  It must read x (B*N*D elements) and the mask and write
// B*L*D means, for one add per element read; at 3.35 TB/s that traffic is
// the least time the card needs.
//
// Design: one CTA per (D chunk of NT features, segment l, batch row b).
// Neighbouring threads read neighbouring features of the same token, so
// each warp's loads are contiguous; each thread walks the seg tokens of
// its segment, so there is no reduction across threads.  Every thread
// counts the mask for itself (seg one-byte loads that hit in L1); thread 0
// of the first D chunk writes the count.  Limits of this first version:
// scalar loads (2 bytes a thread in bf16, not 16), and one segment per
// CTA, which at the exchange's small shapes leaves the time to launch
// latency; vector loads are later work.
//
// Built by repro_torch/kernels/nvcc.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per CTA = features per CTA

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

template <typename T>
__global__ void __launch_bounds__(NT)
segment_means_kernel(const T* __restrict__ x,           // [B, N, D]
                     const uint8_t* __restrict__ mask,  // [B, N] or null
                     T* __restrict__ out,               // [B, L, D]
                     float* __restrict__ counts,        // [B, L]
                     int N, int D, int L) {
  const int d = blockIdx.x * NT + threadIdx.x;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int seg = N / L;
  const size_t tok0 = (size_t)b * N + (size_t)l * seg;

  float acc = 0.f;
  float cnt = 0.f;
  for (int s = 0; s < seg; ++s) {
    const float m = mask ? (float)mask[tok0 + s] : 1.f;
    cnt += m;
    if (d < D) acc += to_f32(x[(tok0 + s) * D + d]) * m;
  }
  if (d < D)
    out[((size_t)b * L + l) * D + d] = from_f32<T>(acc / fmaxf(cnt, 1.f));
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[(size_t)b * L + l] = cnt;
}

}  // namespace

// Plain C entry point.  Returns cudaGetLastError() after the launch (0 on
// success), or a negative code for a shape the kernel does not take.
// mask may be null (every token valid).  is_bf16: 1 for bfloat16 x/out,
// 0 for float32.
extern "C" int segment_means_launch(const void* x, const void* mask,
                                    void* out, void* counts, int B, int N,
                                    int D, int L, int is_bf16,
                                    void* stream) {
  if (B < 1 || N < 1 || D < 1 || L < 1 || N % L != 0) return -1;
  if (B > 65535 || L > 65535) return -1;
  const dim3 grid((D + NT - 1) / NT, L, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (is_bf16)
    segment_means_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), m,
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(counts), N, D,
        L);
  else
    segment_means_kernel<float><<<grid, NT, 0, st>>>(
        static_cast<const float*>(x), m, static_cast<float*>(out),
        static_cast<float*>(counts), N, D, L);
  return static_cast<int>(cudaGetLastError());
}
