// RMSNorm forward and backward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/rmsnorm.py:rmsnorm_fwd (Pallas body
// `_rmsnorm_kernel`): per row, the mean square in fp32,
// y = x * rsqrt(mean(x^2) + eps) * scale, cast back to x's dtype. The
// backward replaces src/repro/kernels/ops.py:_rn_bwd, `jax.vjp` over the
// oracle (the reference has no Pallas backward): with r = rsqrt(mean(x^2)
// + eps) and g = dy * scale, dx = r g - x r^3 sum(g x) / d, rounded once
// to x's dtype, and dscale = sum over rows of dy x r, in fp32.
//
// What bounds them on the H100: bytes. The forward reads x and writes y
// (4 R d bytes in bf16) for about four operations an element, the
// backward reads x and dy and writes dx (6 R d bytes) for about ten: far
// below the ~20 fp32 operations per byte where the CUDA cores would
// become the limit. So both are held to the bytes over 3.35 TB/s, and
// what decides how close they come is how many bytes each SM keeps in
// flight (about 20 KB covers device-memory latency) and how little else
// they move.
//
// The design. A row is held in registers, read once with 16-byte loads
// (8 bf16 or 4 fp32 a lane, neighbouring lanes on neighbouring
// addresses), every load of the row issued before the first sum, and
// written once. The width is a template parameter: TPR threads share a
// row and each holds VPT vectors of it (kCols = 16 columns at the exact
// widths d = 128, 2048 and 4096: the qk-norm, the residual norms and
// Mamba2's gated norm; any other width up to 2048 vectors takes a masked
// instance, the widest 8 vectors a thread for starcoder2-15b's 6144 in
// fp32), so the loops unroll and nothing spills at the port's bf16 widths
// up to 4096 (a wider row may spill in the backward). A 128-wide
// row goes to 8 lanes, so a warp normalises four qk-norm rows; a wide row
// spans warps, which add their sums through shared memory behind a named
// barrier of the row's own threads. The blocks walk the rows in a
// grid-stride loop, as many blocks as fit on the card at once, so one
// decode row and 65,536 qk-norm rows both fill it, and each thread loads
// its next row before it sums the current one, so that device memory
// always has loads to serve (without it both kernels took 5-15% longer on
// an H100). The forward reads scale as float4 from L1. The backward
// computes r again from the row it reads anyway (one pass: sum(x^2) and
// sum(g x) are reduced together), so the forward saves nothing but x; it
// keeps its columns of scale in registers across rows and sums dy x r
// into per-thread fp32 column partials. A block then adds its row slots'
// partials in a fixed order and writes one partial row to a workspace (at
// most kMaxBlocksPerSM blocks a multiprocessor, so the workspace stays a
// few MB), and a second small kernel adds those in a fixed order: no
// float atomics, so two calls give the same bits. With one block (a
// handful of rows) the block writes dscale itself.
//
// Shared memory staging, TMA and wgmma buy nothing for a row-local
// reduction at a few operations per byte. Triton would serve for a
// normalisation too; this stays CUDA C++ so that all the port's kernels
// share one nvcc build and one ctypes path.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;        // threads of a block, both row kernels
constexpr int kWarps = kBlock / 32;
// columns a thread holds at the exact widths (d = 128, 2048, 4096), in
// both kernels: the backward keeps its x, dy, scale and column partials
// in registers, and the forward does best with as many threads a row
constexpr int kCols = 16;
constexpr int kMaxBlocksPerSM = 4; // backward: caps its partial rows
constexpr int kAnyBlocksPerSM = 32; // the hardware's most: no cap
constexpr int kMaxDevices = 64;
constexpr int kReduceBlock = 1024; // dscale: 32 columns x 32 warps

template <typename T> struct Elems {  // elements of a 16-byte vector
  static constexpr int n = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& raw, float* f,
                                       float /*tag*/) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* f,
                                       __nv_bfloat16 /*tag*/) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack(const float* f, float /*tag*/) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16 /*tag*/) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}

// Row `row`'s VPT vectors of this thread (zeros past the last row or the
// row's end).
template <typename T, int TPR, int VPT, bool FULL>
__device__ __forceinline__ void load_row(uint4 (&v)[VPT],
                                         const T* __restrict__ p,
                                         long long row, long long rows, int d,
                                         int t) {
  const int nvec = d / Elems<T>::n;
  const uint4* r =
      reinterpret_cast<const uint4*>(p + (row < rows ? row : 0) * d);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = k * TPR + t;
    v[k] = (row < rows && (FULL || i < nvec)) ? r[i] : make_uint4(0, 0, 0, 0);
  }
}

// The threads of one row-group of TPR threads (TPR a multiple of 32)
// wait for each other only: barrier 1 + the group's index (0 is
// __syncthreads').
__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Sum v over the TPR threads of a row. Within a warp an xor butterfly
// (both partners add the same two numbers, so every lane gets the same
// bits); across the warps of a wide row, through `red` (this iteration's
// half of a double buffer, so one barrier an iteration suffices), added
// in warp order.
template <int TPR>
__device__ __forceinline__ float2 row_sum(float2 v, float2* red) {
#pragma unroll
  for (int off = (TPR < 32 ? TPR : 32) / 2; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  if constexpr (TPR > 32) {
    constexpr int W = TPR / 32;  // warps of a row
    const int warp = threadIdx.x / 32, first = warp - warp % W;
    if (threadIdx.x % 32 == 0) red[warp] = v;
    group_barrier(1 + warp / W, TPR);
    v = red[first];
#pragma unroll
    for (int w = 1; w < W; ++w) {
      v.x += red[first + w].x;
      v.y += red[first + w].y;
    }
  }
  return v;
}

// y = x * rsqrt(mean(x^2) + eps) * scale. TPR threads a row, VPT 16-byte
// vectors a thread; FULL: d == TPR * VPT * (elements a vector), so no
// vector is masked.
template <typename T, int TPR, int VPT, bool FULL>
__global__ void __launch_bounds__(kBlock, 2)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, long long rows, int d, float eps) {
  constexpr int N = Elems<T>::n;
  constexpr int RPB = kBlock / TPR;  // rows a block takes an iteration
  __shared__ float2 red[2][kWarps];
  const int t = threadIdx.x % TPR, slot = threadIdx.x / TPR;
  const int nvec = d / N;
  const float4* sc = reinterpret_cast<const float4*>(scale);
  int parity = 0;
  const long long stride = static_cast<long long>(gridDim.x) * RPB;
  const long long first = static_cast<long long>(blockIdx.x) * RPB + slot;
  uint4 v[VPT], next[VPT];
  load_row<T, TPR, VPT, FULL>(v, x, first, rows, d, t);
  // the loop's bounds are the block's, so every thread runs every
  // iteration and meets every shuffle and barrier
  for (long long base = static_cast<long long>(blockIdx.x) * RPB;
       base < rows; base += stride) {
    const long long row = base + slot;
    const bool live = row < rows;
    // the next row's loads fly while this one is summed and written
    load_row<T, TPR, VPT, FULL>(next, x, row + stride, rows, d, t);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      float f[N];
      unpack(v[k], f, T());
#pragma unroll
      for (int j = 0; j < N; ++j) ss = fmaf(f[j], f[j], ss);
    }
    ss = row_sum<TPR>(make_float2(ss, 0.f), red[parity]).x;
    parity ^= 1;
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    if (live) {
      uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = k * TPR + t;
        if (!FULL && i >= nvec) continue;
        float f[N];
        unpack(v[k], f, T());
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 s = sc[i * (N / 4) + q];
          f[4 * q] = f[4 * q] * r * s.x;
          f[4 * q + 1] = f[4 * q + 1] * r * s.y;
          f[4 * q + 2] = f[4 * q + 2] * r * s.z;
          f[4 * q + 3] = f[4 * q + 3] * r * s.w;
        }
        yr[i] = pack(f, T());
      }
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k) v[k] = next[k];
  }
}

// dx = r g - x r^3 sum(g x) / d with g = dy * scale, and this block's
// partial of dscale = sum over its rows of dy x r, written to
// part[blockIdx.x * d ...] (dscale itself when the grid is one block;
// skipped when part is null).
template <typename T, int TPR, int VPT, bool FULL>
__global__ void __launch_bounds__(kBlock, 2)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ scale, T* __restrict__ dx,
                   float* __restrict__ part, long long rows, int d,
                   float eps) {
  constexpr int N = Elems<T>::n;
  constexpr int CPT = VPT * N;       // columns a thread owns
  constexpr int RPB = kBlock / TPR;
  // row slots that own the same columns once a warp has folded its own
  constexpr int SLOTS = kBlock / (TPR < 32 ? 32 : TPR);
  constexpr int DMAX = TPR * CPT;    // the widest row this instance takes
  __shared__ float2 red[2][kWarps];
  __shared__ float cols[SLOTS > 1 ? SLOTS * DMAX : 1];
  const int t = threadIdx.x % TPR, slot = threadIdx.x / TPR;
  const int nvec = d / N;
  const float inv_d = 1.f / static_cast<float>(d);

  bool has[VPT];
  float s[CPT], acc[CPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = k * TPR + t;
    has[k] = FULL || i < nvec;
    const float4* sc = reinterpret_cast<const float4*>(scale);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = has[k] ? sc[i * (N / 4) + q]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      s[k * N + 4 * q] = v.x;
      s[k * N + 4 * q + 1] = v.y;
      s[k * N + 4 * q + 2] = v.z;
      s[k * N + 4 * q + 3] = v.w;
    }
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

  int parity = 0;
  const long long stride = static_cast<long long>(gridDim.x) * RPB;
  const long long first = static_cast<long long>(blockIdx.x) * RPB + slot;
  uint4 xv[VPT], gv[VPT], xn[VPT], gn[VPT];
  load_row<T, TPR, VPT, FULL>(xv, x, first, rows, d, t);
  load_row<T, TPR, VPT, FULL>(gv, dy, first, rows, d, t);
  for (long long base = static_cast<long long>(blockIdx.x) * RPB;
       base < rows; base += stride) {
    const long long row = base + slot;
    const bool live = row < rows;
    load_row<T, TPR, VPT, FULL>(xn, x, row + stride, rows, d, t);
    load_row<T, TPR, VPT, FULL>(gn, dy, row + stride, rows, d, t);
    float sxx = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      float xf[N], gf[N];
      unpack(xv[k], xf, T());
      unpack(gv[k], gf, T());
#pragma unroll
      for (int j = 0; j < N; ++j) {
        sxx = fmaf(xf[j], xf[j], sxx);
        sgx = fmaf(gf[j] * s[k * N + j], xf[j], sgx);
      }
    }
    const float2 tot = row_sum<TPR>(make_float2(sxx, sgx), red[parity]);
    parity ^= 1;
    const float r = rsqrtf(tot.x * inv_d + eps);
    const float coef = r * r * r * tot.y * inv_d;
    if (live) {
      uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        if (!has[k]) continue;
        float xf[N], gf[N], out[N];
        unpack(xv[k], xf, T());
        unpack(gv[k], gf, T());
#pragma unroll
        for (int j = 0; j < N; ++j) {
          out[j] = r * (gf[j] * s[k * N + j]) - xf[j] * coef;
          acc[k * N + j] = fmaf(gf[j] * xf[j], r, acc[k * N + j]);
        }
        dxr[k * TPR + t] = pack(out, T());
      }
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      xv[k] = xn[k];
      gv[k] = gn[k];
    }
  }
  if (part == nullptr) return;  // uniform: every thread leaves here

  // fold the row slots of a warp that own the same columns (lanes t,
  // t + TPR, ...), then the block's slots in slot order
  if constexpr (TPR < 32) {
#pragma unroll
    for (int off = TPR; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
  }
  float* out = part + static_cast<long long>(blockIdx.x) * d;
  if constexpr (SLOTS == 1) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (!has[k]) continue;
#pragma unroll
      for (int j = 0; j < N; ++j) out[(k * TPR + t) * N + j] = acc[k * N + j];
    }
  } else {
    // after the fold every lane of a narrow row's warp holds the same
    // sums: its first TPR lanes write them
    const int s_ = TPR < 32 ? threadIdx.x / 32 : slot;
    if (TPR >= 32 || threadIdx.x % 32 < TPR) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        if (!has[k]) continue;
#pragma unroll
        for (int j = 0; j < N; ++j)
          cols[s_ * DMAX + (k * TPR + t) * N + j] = acc[k * N + j];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += kBlock) {
      float sum = cols[c];
#pragma unroll
      for (int q = 1; q < SLOTS; ++q) sum += cols[q * DMAX + c];
      out[c] = sum;
    }
  }
}

// dscale[c] = sum over p of part[p * d + c], p in a fixed order: warp w
// adds the partial rows p = w, w + 32, ..., then warp 0 adds the 32 warp
// sums in warp order.
__global__ void __launch_bounds__(kReduceBlock)
rmsnorm_dscale_kernel(const float* __restrict__ part,
                      float* __restrict__ dscale, int nparts, int d) {
  __shared__ float sums[32][33];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (c < d)
    for (int p = w; p < nparts; p += 32)
      sum += part[static_cast<long long>(p) * d + c];
  sums[w][lane] = sum;
  __syncthreads();
  if (w == 0 && c < d) {
    float tot = sums[0][lane];
#pragma unroll
    for (int q = 1; q < 32; ++q) tot += sums[q][lane];
    dscale[c] = tot;
  }
}

template <int TPR_, int VPT_, bool FULL_> struct Cfg {
  static constexpr int TPR = TPR_, VPT = VPT_;
  static constexpr bool FULL = FULL_;
};

// The instance for a width, in both kernels: d / kCols threads a row at
// the exact widths, masked ones up to 2048 vectors otherwise. `f` is
// called with the Cfg.
template <typename T, typename F>
cudaError_t row_config(int d, F&& f) {
  constexpr int N = Elems<T>::n;
  const int nvec = d / N;
  if (d == 128) return f(Cfg<128 / kCols, kCols / N, true>());
  if (d == 2048) return f(Cfg<2048 / kCols, kCols / N, true>());
  if (d == 4096) return f(Cfg<4096 / kCols, kCols / N, true>());
  if (nvec <= 32) return f(Cfg<32, 1, false>());
  if (nvec <= 256) return f(Cfg<256, 1, false>());
  if (nvec <= 512) return f(Cfg<256, 2, false>());
  if (nvec <= 1024) return f(Cfg<256, 4, false>());
  if (nvec <= 2048) return f(Cfg<256, 8, false>());
  return cudaErrorInvalidValue;
}

// Blocks of `kernel` the current device holds at once, at most
// `max_per_sm` a multiprocessor (cached per device; each instance of the
// template, one per kernel instance and Tag, has its own cache).
template <typename Tag, typename K>
int resident_blocks(K kernel, int max_per_sm) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int sms = 0, per = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kBlock, 0);
  per = per < max_per_sm ? per : max_per_sm;
  const int n = (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  if (dev < kMaxDevices) cached[dev] = n;
  return n;
}

template <typename T, int TPR, int VPT, bool FULL> struct FwdTag {};
template <typename T, int TPR, int VPT, bool FULL> struct BwdTag {};

// A kernel's grid: one block per kBlock / TPR rows, at most as many
// blocks as are resident (the backward also at most kMaxBlocksPerSM a
// multiprocessor, as each of its blocks writes one partial row of
// dscale).
template <typename Tag, typename C, typename K>
long long grid_for(K kernel, long long rows, int max_per_sm) {
  const long long cap = resident_blocks<Tag>(kernel, max_per_sm);
  const long long groups = (rows + kBlock / C::TPR - 1) / (kBlock / C::TPR);
  return groups < cap ? groups : cap;
}

template <typename T, typename C>
long long bwd_grid(long long rows) {
  return grid_for<BwdTag<T, C::TPR, C::VPT, C::FULL>, C>(
      rmsnorm_bwd_kernel<T, C::TPR, C::VPT, C::FULL>, rows, kMaxBlocksPerSM);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* scale, void* y,
                       long long rows, int d, float eps, cudaStream_t st) {
  return row_config<T>(d, [&](auto cfg) {
    using C = decltype(cfg);
    auto* kernel = rmsnorm_fwd_kernel<T, C::TPR, C::VPT, C::FULL>;
    const auto grid = static_cast<unsigned>(
        grid_for<FwdTag<T, C::TPR, C::VPT, C::FULL>, C>(kernel, rows,
                                                          kAnyBlocksPerSM));
    kernel<<<grid, kBlock, 0, st>>>(static_cast<const T*>(x), scale,
                                    static_cast<T*>(y), rows, d, eps);
    return cudaGetLastError();
  });
}

template <typename T>
long long bwd_workspace_bytes(long long rows, int d) {
  long long bytes = 0;
  const cudaError_t err = row_config<T>(d, [&](auto cfg) {
    const long long grid = bwd_grid<T, decltype(cfg)>(rows);
    bytes = grid > 1 ? grid * d * static_cast<long long>(sizeof(float)) : 0;
    return cudaSuccess;
  });
  return err == cudaSuccess ? bytes : -1;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const float* scale,
                       void* dx, float* dscale, float* workspace,
                       long long rows, int d, float eps, cudaStream_t st) {
  return row_config<T>(d, [&](auto cfg) {
    using C = decltype(cfg);
    const long long grid = bwd_grid<T, C>(rows);
    float* part = dscale == nullptr ? nullptr
                  : grid > 1        ? workspace
                                    : dscale;
    if (part == nullptr && dscale != nullptr) return cudaErrorInvalidValue;
    rmsnorm_bwd_kernel<T, C::TPR, C::VPT, C::FULL>
        <<<static_cast<unsigned>(grid), kBlock, 0, st>>>(
            static_cast<const T*>(x), static_cast<const T*>(dy), scale,
            static_cast<T*>(dx), part, rows, d, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || dscale == nullptr || grid == 1) return err;
    rmsnorm_dscale_kernel<<<(d + 31) / 32, kReduceBlock, 0, st>>>(
        workspace, dscale, static_cast<int>(grid), d);
    return cudaGetLastError();
  });
}

bool bad_shape(long long rows, int d, int dtype) {
  return rows <= 0 || d <= 0 || rows > (1LL << 33) ||
         (dtype == 0 && d % 4) || (dtype == 1 && d % 8) ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. x and y are (rows, d) contiguous and 16-byte
// aligned, scale is (d,) fp32, 16-byte aligned; d at most 2048 16-byte
// vectors. Returns the cudaError_t of the launch.
extern "C" int repro_rmsnorm_fwd(const void* x, const void* scale, void* y,
                                 long long rows, int d, float eps, int dtype,
                                 void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<const float*>(scale);
  if (bad_shape(rows, d, dtype)) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_fwd<float>(x, sc, y, rows, d, eps, st);
  return launch_fwd<__nv_bfloat16>(x, sc, y, rows, d, eps, st);
}

// Bytes of fp32 workspace `repro_rmsnorm_bwd` needs for dscale at this
// shape on the current device (0: none); -1 for a shape it refuses.
extern "C" long long repro_rmsnorm_bwd_workspace_bytes(long long rows, int d,
                                                       int dtype) {
  if (bad_shape(rows, d, dtype)) return -1;
  if (dtype == 0) return bwd_workspace_bytes<float>(rows, d);
  return bwd_workspace_bytes<__nv_bfloat16>(rows, d);
}

// x, dy and dx are (rows, d) in the dtype, contiguous and 16-byte
// aligned; scale and dscale are (d,) fp32. dscale may be null and is then
// not computed; with dscale, workspace holds
// repro_rmsnorm_bwd_workspace_bytes. One or two launches on `stream`.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* dy,
                                 const void* scale, void* dx, void* dscale,
                                 void* workspace, long long rows, int d,
                                 float eps, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<const float*>(scale);
  auto* ds = static_cast<float*>(dscale);
  auto* ws = static_cast<float*>(workspace);
  if (bad_shape(rows, d, dtype)) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(x, dy, sc, dx, ds, ws, rows, d, eps, st);
  return launch_bwd<__nv_bfloat16>(x, dy, sc, dx, ds, ws, rows, d, eps, st);
}
