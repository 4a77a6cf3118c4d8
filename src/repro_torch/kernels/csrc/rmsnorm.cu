// RMSNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/rmsnorm.py:rmsnorm_fwd (Pallas body
// `_rmsnorm_kernel`): per row, the mean square in fp32,
// x * rsqrt(var + eps) * scale, cast back to x's dtype.
//
// What bounds it on the H100: memory. Each element is read once and
// written once for about four operations, far below the ~295 operations
// per byte where the tensor cores would become the limit; so the bound is
// the bytes moved over 3.35 TB/s.
//
// What this design does about it: one warp owns one row and eight warps
// share a block. Each lane reads 16-byte vectors (8 bf16 or 4 fp32
// values), neighbouring lanes on neighbouring addresses, sums the squares
// in fp32, and the warp reduces with shuffles; no shared memory and no
// second launch. The second sweep that scales and writes the row reads it
// again from L1, where the first sweep just left it, so device memory
// sees one read and one write per element.
//
// Rows of d = 2048 (residual norms) and d = 128 (qk-norm) from one row
// (decode) to B*S*H (prefill). d must be a multiple of the vector width.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ y, long long rows, int d, float eps) {
  constexpr int N = 16 / sizeof(T);  // elements per 16-byte vector
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const int nvec = d / N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);

  float ss = 0.f;
  for (int i = lane; i < nvec; i += 32) {
    const uint4 raw = xr[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float t = to_f32(e[j]);
      ss = fmaf(t, t, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int i = lane; i < nvec; i += 32) {
    const uint4 raw = xr[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int j = 0; j < N; ++j)
      o[j] = from_f32<T>(to_f32(e[j]) * r * scale[i * N + j]);
    yr[i] = packed;
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* y, long long rows,
                   int d, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rmsnorm_kernel<T><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                      stream>>>(static_cast<const T*>(x), scale,
                                static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. x and y are (rows, d) contiguous and 16-byte
// aligned, scale is (d,) fp32. Returns the cudaError_t of the launch.
extern "C" int repro_rmsnorm_fwd(const void* x, const void* scale, void* y,
                                 long long rows, int d, float eps, int dtype,
                                 void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<const float*>(scale);
  if (rows <= 0 || d <= 0 || rows > (1LL << 33)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d % 4) return cudaErrorInvalidValue;
    return launch<float>(x, sc, y, rows, d, eps, st);
  }
  if (dtype == 1) {
    if (d % 8) return cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(x, sc, y, rows, d, eps, st);
  }
  return cudaErrorInvalidValue;
}
