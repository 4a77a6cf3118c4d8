// Mamba2 SSD chunked scan forward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/ssd_scan.py:ssd_scan_fwd (Pallas body
// `_ssd_kernel`). For x:(b,s,h,p), dt:(b,s,h), A:(h,) negative and
// B,C:(b,s,g,n), head i reading group i / (h/g), per chunk of tokens:
//   cum    = cumsum(dt * A)
//   y_diag = ((C Bᵀ) ∘ exp(cum_l - cum_m)[l >= m] ∘ dt_m) x
//   y_off  = (C ∘ exp(cum)) S
//   S     <- exp(cum_last) S + (B ∘ exp(cum_last - cum) ∘ dt)ᵀ x
// with the (n, p) state S in fp32, carried across chunks from zero.
// Everything accumulates in fp32 from bf16 or fp32 loads; y is written in
// x's dtype.
//
// What bounds it on the H100: memory. At the mamba2-1.3b prefill shape
// (b=1, s=2048, h=64, p=64, n=128, g=1, chunk 256) the function needs about
// 35 MB of traffic (x and y in bf16, B, C, dt), 10.5 us at 3.35 TB/s, and
// about 6.5 GFLOP of products (the causal halves of the L x L terms,
// C Bᵀ once per group), 6.6 us on the bf16 tensor cores.
//
// What this design does about it, and what it leaves: the Pallas grid
// (b, h, chunk) walks the chunk axis in order on one core and keeps S in
// VMEM between grid steps. Hopper runs blocks in no order, so here one
// block owns a (batch, head, 32-column slice of p) and loops over the
// sequence itself, with its slice of S (n x 32 fp32) in shared memory.
// Splitting p in 32-column halves gives 128 blocks at the prefill shape
// for the 132 SMs, where (b, h) alone gives 64; each half recomputes
// C Bᵀ, which costs less than the idle SMs would. Every input byte is read
// once per slice and y is written once, so device memory sees about the
// bound's traffic. Each thread fetches the next tile's inputs as a few
// 16-byte vectors into registers while the current tile computes, so the
// loads' latency hides behind the arithmetic. The time goes to the
// products, which run here as fp32 FMAs on the CUDA cores from shared
// memory, read as float4 where a warp can share them. Tensor cores
// (mma.sync or wgmma on bf16 C Bᵀ, which is exact with fp32 accumulation)
// and TMA loads are for a later change.
//
// Shared memory: a 256-token chunk at n = 128 would need 128 KB each for
// B and C in fp32 plus a 256 KB score tile. SSD does not depend on the
// chunk length (the chunked form equals the token recurrence for any
// split), so the kernel works in its own 64-token tiles whatever chunk it
// is given: the same function up to rounding. A ragged last tile
// (s % 64 != 0, e.g. s = 32 or 200) is masked: its missing rows load as
// zeros with dt = 0, which adds nothing to the state, and are not written.
//
// Supported: n in {16, 32, 64, 128}, p a multiple of 32 (the launcher
// takes 32 and 64), any g dividing h. x, B and C may have any batch,
// sequence and head/group strides that are multiples of 16 bytes, with a
// contiguous last dimension and 16-byte aligned data; dt any strides; A
// and y contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kTile = 64;     // tokens per internal tile
constexpr int kCols = 32;     // columns of p per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <int N>
constexpr size_t smem_floats() {
  // B, C (rows padded by four floats), x, S, scores, dt, cum, weights
  return 2 * kTile * (N + 4) + kTile * kCols + N * kCols + kTile * kTile +
         3 * kTile;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes of T (8 bf16 or 4 fp32 values), upcast, into fp32 shared memory
template <typename T>
__device__ __forceinline__ void stash16(float* dst, const uint4& raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < static_cast<int>(16 / sizeof(T)); j += 4)
    *reinterpret_cast<float4*>(dst + j) =
        make_float4(to_f32(e[j]), to_f32(e[j + 1]), to_f32(e[j + 2]),
                    to_f32(e[j + 3]));
}

__device__ __forceinline__ float dot4(float4 a, const float* b, float acc) {
  acc = fmaf(a.x, b[0], acc);
  acc = fmaf(a.y, b[1], acc);
  acc = fmaf(a.z, b[2], acc);
  return fmaf(a.w, b[3], acc);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, int s, int h,
                int p, int g, long long xsb, long long xss, long long xsh,
                long long dsb, long long dss, long long dsh, long long bsb,
                long long bss, long long bsg, long long csb, long long css,
                long long csg) {
  // rows of B and C are 16-byte aligned for float4 reads, and padded so
  // that eight lanes reading eight rows at one k hit distinct banks
  constexpr int NP = N + 4;
  constexpr int KR = N / kWarps;  // state rows per thread
  // a tile's loads, as 16-byte vectors, a few per thread
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kRowVecs = N / VEC;                   // per row of B or C
  constexpr int kBCVecs = kTile * kRowVecs;
  constexpr int kBCIter = (kBCVecs + kThreads - 1) / kThreads;
  constexpr int kXRowVecs = kCols / VEC;              // per row of x
  constexpr int kXVecs = kTile * kXRowVecs;
  constexpr int kXIter = (kXVecs + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                  // kTile x NP
  float* Bs = Cs + kTile * NP;       // kTile x NP
  float* Xs = Bs + kTile * NP;       // kTile x kCols
  float* Ss = Xs + kTile * kCols;    // N x kCols, the carried state
  float* Gs = Ss + N * kCols;        // kTile x kTile, the masked scores
  float* dts = Gs + kTile * kTile;   // kTile
  float* cum = dts + kTile;          // kTile
  float* wts = cum + kTile;          // kTile: exp(cum_last - cum_m) dt_m

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int nps = p / kCols;
  const int ps = blockIdx.x % nps;
  const int hi = (blockIdx.x / nps) % h;
  const int bi = blockIdx.x / (nps * h);
  const int gi = hi / (h / g);
  const float a = A[hi];
  const int c0 = ps * kCols;

  const T* xb = x + bi * xsb + hi * xsh + c0;
  const float* db = dt + bi * dsb + hi * dsh;
  const T* Bb = Bm + bi * bsb + gi * bsg;
  const T* Cb = Cm + bi * csb + gi * csg;
  const long long ys = static_cast<long long>(h) * p;  // y's sequence stride
  T* yb = y + (static_cast<long long>(bi) * s * h + hi) * p + c0;

  // the next tile's inputs wait in registers while this tile computes:
  // every thread issues its few 16-byte loads at once, and their latency
  // hides behind the tile's arithmetic. Rows past s load as zeros (dt 0).
  uint4 rb[kBCIter], rc[kBCIter], rx[kXIter];
  float rdt;
  auto fetch = [&](int t0) {
#pragma unroll
    for (int it = 0; it < kBCIter; ++it) {
      const int v = tid + it * kThreads;
      const int r = v / kRowVecs, kv = v % kRowVecs;
      rb[it] = rc[it] = make_uint4(0u, 0u, 0u, 0u);
      if (v < kBCVecs && t0 + r < s) {
        const long long row = t0 + r;
        rb[it] = *reinterpret_cast<const uint4*>(Bb + row * bss + kv * VEC);
        rc[it] = *reinterpret_cast<const uint4*>(Cb + row * css + kv * VEC);
      }
    }
#pragma unroll
    for (int it = 0; it < kXIter; ++it) {
      const int v = tid + it * kThreads;
      const int r = v / kXRowVecs, c = v % kXRowVecs;
      rx[it] = make_uint4(0u, 0u, 0u, 0u);
      if (v < kXVecs && t0 + r < s)
        rx[it] = *reinterpret_cast<const uint4*>(
            xb + static_cast<long long>(t0 + r) * xss + c * VEC);
    }
    rdt = tid < kTile && t0 + tid < s
              ? db[static_cast<long long>(t0 + tid) * dss] : 0.f;
  };

  for (int i = tid; i < N * kCols; i += kThreads) Ss[i] = 0.f;
  fetch(0);

  for (int t0 = 0; t0 < s; t0 += kTile) {
    const int nv = min(kTile, s - t0);  // valid rows of this tile

    // ---- the fetched tile into shared memory, upcast to fp32
#pragma unroll
    for (int it = 0; it < kBCIter; ++it) {
      const int v = tid + it * kThreads;
      if (v < kBCVecs) {
        const int r = v / kRowVecs, kv = v % kRowVecs;
        stash16<T>(&Bs[r * NP + kv * VEC], rb[it]);
        stash16<T>(&Cs[r * NP + kv * VEC], rc[it]);
      }
    }
#pragma unroll
    for (int it = 0; it < kXIter; ++it) {
      const int v = tid + it * kThreads;
      if (v < kXVecs)
        stash16<T>(&Xs[(v / kXRowVecs) * kCols + (v % kXRowVecs) * VEC],
                   rx[it]);
    }
    if (tid < kTile) dts[tid] = rdt;
    __syncthreads();
    if (t0 + kTile < s) fetch(t0 + kTile);

    // ---- cum = inclusive cumsum of dt * A over the tile (one warp, two
    // rows a lane)
    if (warp == 0) {
      const float a0 = dts[2 * lane] * a, a1 = dts[2 * lane + 1] * a;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      cum[2 * lane] = excl + a0;
      cum[2 * lane + 1] = incl;
    }
    __syncthreads();

    // ---- masked scores G[l][m] = (C_l . B_m) exp(cum_l - cum_m) dt_m for
    // m <= l, else 0; each thread a 4 x 4 block of rows ty + 16i and
    // columns tx + 16j, four k at a time (float4 reads: 8 loads for 64
    // FMAs)
    {
      const int ty = tid / 16, tx = tid % 16;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N; k += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(&Cs[(ty + 16 * i) * NP + k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(&Bs[(tx + 16 * j) * NP + k]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b4[4] = {bv[j].x, bv[j].y, bv[j].z, bv[j].w};
            acc[i][j] = dot4(cv[i], b4, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = tx + 16 * j;
          // masked before exp: above the diagonal cum_l - cum_m > 0
          Gs[l * kTile + m] =
              m <= l ? acc[i][j] * expf(cum[l] - cum[m]) * dts[m] : 0.f;
        }
      }
      if (tid < kTile) wts[tid] = expf(cum[kTile - 1] - cum[tid]) * dts[tid];
    }
    __syncthreads();

    // ---- y = G x + exp(cum) (C S); each thread column `lane` of rows
    // warp + 8i, so a warp reads G and C as float4 broadcasts and x, S
    // along a row, four m (or k) at a time
    {
      float yd[kTile / kWarps], yo[kTile / kWarps];
#pragma unroll
      for (int i = 0; i < kTile / kWarps; ++i) yd[i] = yo[i] = 0.f;
#pragma unroll 2
      for (int m = 0; m < kTile; m += 4) {
        float xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = Xs[(m + q) * kCols + lane];
#pragma unroll
        for (int i = 0; i < kTile / kWarps; ++i)
          yd[i] = dot4(ld4(&Gs[(warp + kWarps * i) * kTile + m]), xv, yd[i]);
      }
#pragma unroll 2
      for (int k = 0; k < N; k += 4) {
        float sv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) sv[q] = Ss[(k + q) * kCols + lane];
#pragma unroll
        for (int i = 0; i < kTile / kWarps; ++i)
          yo[i] = dot4(ld4(&Cs[(warp + kWarps * i) * NP + k]), sv, yo[i]);
      }
#pragma unroll
      for (int i = 0; i < kTile / kWarps; ++i) {
        const int l = warp + kWarps * i;
        if (l < nv)
          yb[static_cast<long long>(t0 + l) * ys + lane] =
              from_f32<T>(yd[i] + expf(cum[l]) * yo[i]);
      }
    }
    __syncthreads();  // every thread has read S before it changes

    // ---- S <- exp(cum_last) S + sum_m B_m (w_m x_m); each thread column
    // `lane` of the KR consecutive state rows warp * KR + j, whose B
    // values a warp reads as broadcasts, four at a time where KR allows
    {
      const float decay = expf(cum[kTile - 1]);
      const int k0 = warp * KR;
      float acc[KR];
#pragma unroll
      for (int j = 0; j < KR; ++j)
        acc[j] = Ss[(k0 + j) * kCols + lane] * decay;
#pragma unroll 4
      for (int m = 0; m < kTile; ++m) {
        const float xv = Xs[m * kCols + lane] * wts[m];
        const float* bm = &Bs[m * NP + k0];
        if constexpr (KR % 4 == 0) {
#pragma unroll
          for (int j = 0; j < KR; j += 4) {
            const float4 bv = ld4(bm + j);
            acc[j] = fmaf(bv.x, xv, acc[j]);
            acc[j + 1] = fmaf(bv.y, xv, acc[j + 1]);
            acc[j + 2] = fmaf(bv.z, xv, acc[j + 2]);
            acc[j + 3] = fmaf(bv.w, xv, acc[j + 3]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < KR; ++j) acc[j] = fmaf(bm[j], xv, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < KR; ++j) Ss[(k0 + j) * kCols + lane] = acc[j];
    }
    __syncthreads();  // the next tile's loads overwrite B, C, x
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, void* y, int b, int s, int h,
                   int p, int g, const long long* st, cudaStream_t stream) {
  const size_t smem = smem_floats<N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(b) * h * (p / kCols);
  ssd_scan_kernel<T, N><<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), s, h, p, g, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int n, const void* x, const float* dt, const float* A,
                       const void* B, const void* C, void* y, int b, int s,
                       int h, int p, int g, const long long* st,
                       cudaStream_t stream) {
  switch (n) {
    case 16: return launch<T, 16>(x, dt, A, B, C, y, b, s, h, p, g, st, stream);
    case 32: return launch<T, 32>(x, dt, A, B, C, y, b, s, h, p, g, st, stream);
    case 64: return launch<T, 64>(x, dt, A, B, C, y, b, s, h, p, g, st, stream);
    case 128:
      return launch<T, 128>(x, dt, A, B, C, y, b, s, h, p, g, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of x, B, C and y: 0 = fp32, 1 = bf16; dt and A are fp32. Strides
// are in elements: x (batch, seq, head), dt (batch, seq, head), B and C
// (batch, seq, group); the last dimension of x, B and C is contiguous, A
// and y are contiguous. Returns the cudaError_t of the launch.
extern "C" int repro_ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, int dtype, int b, int s, int h, int p, int g,
    int n, long long xsb, long long xss, long long xsh, long long dsb,
    long long dss, long long dsh, long long bsb, long long bss, long long bsg,
    long long csb, long long css, long long csg, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || h <= 0 || g <= 0 || h % g || p <= 0 ||
      p % kCols || static_cast<long long>(b) * h * (p / kCols) > (1LL << 31) - 1)
    return cudaErrorInvalidValue;
  const long long strides[12] = {xsb, xss, xsh, dsb, dss, dsh,
                                 bsb, bss, bsg, csb, css, csg};
  // x, B and C move as 16-byte vectors
  const long long vec = dtype == 0 ? 4 : 8;
  for (int i : {0, 1, 2, 6, 7, 8, 9, 10, 11})
    if (strides[i] % vec) return cudaErrorInvalidValue;
  for (const void* ptr : {x, B, C})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  auto* dtf = static_cast<const float*>(dt);
  auto* af = static_cast<const float*>(A);
  if (dtype == 0)
    return dispatch_n<float>(n, x, dtf, af, B, C, y, b, s, h, p, g, strides,
                             st);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(n, x, dtf, af, B, C, y, b, s, h, p, g,
                                     strides, st);
  return cudaErrorInvalidValue;
}
