// Mamba2 SSD chunked scan forward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/ssd_scan.py:64 ssd_scan_fwd (Pallas body
// `_ssd_kernel`). For x:(b,s,h,p), dt:(b,s,h), A:(h,) negative and
// B,C:(b,s,g,n), head i reading group i / (h/g), per chunk of tokens:
//   cum    = cumsum(dt * A)
//   y_diag = ((C Bᵀ) ∘ exp(cum_l - cum_m)[l >= m] ∘ dt_m) x
//   y_off  = (C ∘ exp(cum)) S
//   S     <- exp(cum_last) S + (B ∘ exp(cum_last - cum) ∘ dt)ᵀ x
// with the (n, p) state S in fp32, carried across chunks from zero; y is
// written once, in x's dtype. SSD does not depend on the chunk length (the
// chunked form equals the token recurrence for any split), so the kernels
// pick their own: 128 tokens for bf16, 64 for fp32, whatever chunk the
// caller names. The same function up to rounding.
//
// What bounds it on the H100: memory. At the mamba2-1.3b prefill shape
// (b=1, s=2048, h=64, p=64, n=128, g=1) the function needs about 35 MB of
// traffic (x and y in bf16, B, C, dt), 10.5 us at 3.35 TB/s, and about
// 6.5 GFLOP of products (the causal halves of the L x L terms, C Bᵀ once
// per group), 6.6 us on the bf16 tensor cores.
//
// bf16: three chunk-parallel stages, the plain `ssd`'s own, each a kernel
// launched from `repro_ssd_scan_fwd` on the caller's stream. Blocks take a
// (batch, 128-token chunk, tile of `ht` heads of one B/C group); x, B and
// C arrive by TMA (tensor maps over the callers' strided views of the
// conv output; rows past s arrive as zeros, so a ragged last chunk needs
// no other mask than dt = 0), dt by plain loads (one fp32 a token and
// head is narrower than a TMA box row), and every product runs on
// `wgmma`, bf16 in and fp32 accumulated (hopper.cuh):
//  (a) `ssd_states_bf16_kernel`, one warpgroup over chunks 0..nc-2, 4
//      heads a block at the prefill shape: the per-head cum (an fp32 scan
//      over the chunk), and each head's local chunk state
//      (B ∘ exp(cum_last - cum) ∘ dt)ᵀ x as the (p, n) product (w ∘ x)ᵀ B,
//      with (w ∘ x)ᵀ rounded once to bf16 in registers as the A operand
//      (rows past p are zero) and B read MN-major from its TMA tile; the
//      tile goes to the workspace in fp32 beside the chunk's log2 decay.
//  (b) `ssd_state_pass_kernel`, over (batch, head, 1,024 state values):
//      S_in[c] = S; S = exp(cum_last_c) S + local_c, the chunks' loads
//      issued eight ahead of the dependent FMAs, S in fp32; S_in is
//      written in bf16 (rounded once, the operand of (c)).
//  (c) `ssd_out_bf16_kernel`, two warpgroups of 64 chunk rows over every
//      chunk, 8 heads a block at the prefill shape (one wave of 128
//      blocks): C Bᵀ once per block, kept in registers across its heads
//      (rows 0-63 need only columns 0-63: the causal half is skipped),
//      then per head y = exp(cum) ∘ (C S_in) (C and S_in from shared
//      memory, K-major) + (C Bᵀ ∘ decay ∘ dt) x, the masked scores rounded
//      once to bf16 as register A fragments and x read MN-major. Each
//      head's x and S_in arrive on a three-slot mbarrier ring while the
//      heads before compute; y is staged in shared memory as a TMA tile
//      and stored by TMA (rows past s are not written), overlapping the
//      next head.
// What this buys against the design it replaces (one block per (batch,
// head, 32 columns of p) walking all chunks in series with fp32 FMAs,
// 128 blocks for 132 SMs, C Bᵀ formed 128 times per chunk, 0.4555 ms at
// the prefill shape): every stage is chunk-parallel, C Bᵀ is formed
// h / ht = 8 times per chunk and (a) needs none, and no product runs on
// the CUDA cores. On the H100 at the prefill shape the three take about
// 0.021, 0.012 and 0.022 ms (PERF.md).
//
// The workspace (allocated by the caller; `repro_ssd_scan_workspace_bytes`
// gives its size) holds the local states in fp32 and S_in in bf16, each
// b (s/128) h p n values, and the chunk decays: 33.5 + 16.8 MB at the
// prefill shape, written and read once each (about 100 MB of traffic
// beside the 35 MB of the function's own; it fits the 50 MB L2 only in
// part), so this design cannot come nearer its bound than about 4x. The
// fp32 writes bound (a) (without them it took 0.013 ms against 0.021);
// (c) streams x, S_in and y at about two thirds of the memory rate.
// 256-token chunks would halve the workspace but need 256-row score
// tiles, 128 accumulator registers a thread for C Bᵀ alone in a 64-row
// warpgroup; fusing (b) into (c) would read every earlier chunk's state
// in each chunk. Both are left. Tried on the card and not kept: 2 or 4
// heads a block in (c), 2 or 8 in (a), 3 blocks an SM for (a) (it
// spills), TMA stores of (a)'s fp32 tiles, and issuing C S_in while the
// scores form (scripts/ssd_stage_variants.py; PERF.md).
//
// fp32 (the test and parity path) keeps the first design: one block per
// (batch, head, 32 columns of p) walking the sequence in 64-token tiles
// with the state in shared memory, every product an fp32 FMA on the CUDA
// cores (a bf16 or TF32 product would break the fp32 tolerance of 5e-4).
// The dispatch is by dtype alone.
//
// Supported: n in {16, 32, 64, 128}; p in {32, 64} for bf16, a multiple of
// 32 for fp32; any g dividing h. x, B and C may have any batch, sequence
// and head/group strides that are multiples of 16 bytes, with a contiguous
// last dimension and 16-byte aligned data; dt any strides; A and y
// contiguous. No atomics: two calls give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

namespace {

using namespace repro_hopper;

// ===================================================================== fp32
constexpr int kTile = 64;     // tokens per internal tile
constexpr int kCols = 32;     // columns of p per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int N>
constexpr size_t smem_floats() {
  // B, C (rows padded by four floats), x, S, scores, dt, cum, weights
  return 2 * kTile * (N + 4) + kTile * kCols + N * kCols + kTile * kTile +
         3 * kTile;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, const float* b, float acc) {
  acc = fmaf(a.x, b[0], acc);
  acc = fmaf(a.y, b[1], acc);
  acc = fmaf(a.z, b[2], acc);
  return fmaf(a.w, b[3], acc);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_fp32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y,
                     int s, int h, int p, int g, long long xsb, long long xss,
                     long long xsh, long long dsb, long long dss,
                     long long dsh, long long bsb, long long bss,
                     long long bsg, long long csb, long long css,
                     long long csg) {
  // rows of B and C are 16-byte aligned for float4 reads, and padded so
  // that eight lanes reading eight rows at one k hit distinct banks
  constexpr int NP = N + 4;
  constexpr int KR = N / kWarps;  // state rows per thread
  // a tile's loads, as 16-byte vectors, a few per thread
  constexpr int kRowVecs = N / 4;                     // per row of B or C
  constexpr int kBCVecs = kTile * kRowVecs;
  constexpr int kBCIter = (kBCVecs + kThreads - 1) / kThreads;
  constexpr int kXRowVecs = kCols / 4;                // per row of x
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

  const float* xb = x + bi * xsb + hi * xsh + c0;
  const float* db = dt + bi * dsb + hi * dsh;
  const float* Bb = Bm + bi * bsb + gi * bsg;
  const float* Cb = Cm + bi * csb + gi * csg;
  const long long ys = static_cast<long long>(h) * p;  // y's sequence stride
  float* yb = y + (static_cast<long long>(bi) * s * h + hi) * p + c0;

  // the next tile's inputs wait in registers while this tile computes:
  // every thread issues its few 16-byte loads at once, and their latency
  // hides behind the tile's arithmetic. Rows past s load as zeros (dt 0).
  float4 rb[kBCIter], rc[kBCIter], rx[kXIter];
  float rdt;
  auto fetch = [&](int t0) {
#pragma unroll
    for (int it = 0; it < kBCIter; ++it) {
      const int v = tid + it * kThreads;
      const int r = v / kRowVecs, kv = v % kRowVecs;
      rb[it] = rc[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < kBCVecs && t0 + r < s) {
        const long long row = t0 + r;
        rb[it] = ld4(Bb + row * bss + kv * 4);
        rc[it] = ld4(Cb + row * css + kv * 4);
      }
    }
#pragma unroll
    for (int it = 0; it < kXIter; ++it) {
      const int v = tid + it * kThreads;
      const int r = v / kXRowVecs, c = v % kXRowVecs;
      rx[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < kXVecs && t0 + r < s)
        rx[it] = ld4(xb + static_cast<long long>(t0 + r) * xss + c * 4);
    }
    rdt = tid < kTile && t0 + tid < s
              ? db[static_cast<long long>(t0 + tid) * dss] : 0.f;
  };

  for (int i = tid; i < N * kCols; i += kThreads) Ss[i] = 0.f;
  fetch(0);

  for (int t0 = 0; t0 < s; t0 += kTile) {
    const int nv = min(kTile, s - t0);  // valid rows of this tile

    // ---- the fetched tile into shared memory
#pragma unroll
    for (int it = 0; it < kBCIter; ++it) {
      const int v = tid + it * kThreads;
      if (v < kBCVecs) {
        const int r = v / kRowVecs, kv = v % kRowVecs;
        *reinterpret_cast<float4*>(&Bs[r * NP + kv * 4]) = rb[it];
        *reinterpret_cast<float4*>(&Cs[r * NP + kv * 4]) = rc[it];
      }
    }
#pragma unroll
    for (int it = 0; it < kXIter; ++it) {
      const int v = tid + it * kThreads;
      if (v < kXVecs)
        *reinterpret_cast<float4*>(
            &Xs[(v / kXRowVecs) * kCols + (v % kXRowVecs) * 4]) = rx[it];
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
              yd[i] + expf(cum[l]) * yo[i];
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

template <int N>
cudaError_t launch_fp32(const void* x, const float* dt, const float* A,
                        const void* B, const void* C, void* y, int b, int s,
                        int h, int p, int g, const long long* st,
                        cudaStream_t stream) {
  const size_t smem = smem_floats<N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fp32_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(b) * h * (p / kCols);
  ssd_scan_fp32_kernel<N><<<static_cast<unsigned>(blocks), kThreads, smem,
                            stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), s, h, p, g, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return cudaGetLastError();
}

// ===================================================================== bf16
constexpr int kChunk = 128;       // tokens per chunk
constexpr int kMaxHeads = 8;      // heads per block, at most
// (a) and (c) take the most heads a block that still leaves them this many
// blocks: 4 heads (240 blocks) and 8 (128 blocks, one wave at one block
// an SM) at the prefill shape, the fastest of 2, 4 and 8 there for each
// (PERF.md)
constexpr int kStatesBlocks = 192;
constexpr int kOutBlocks = 128;
constexpr int kHeadSlots = 3;     // the output pass's ring of heads
constexpr int kPassThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Inclusive prefix sums of scale * v[0..127] by one warp, four consecutive
// values a lane, into out; returns the total.
__device__ __forceinline__ float warp_cumsum128(const float* v, float scale,
                                                float* out, int lane) {
  const float4 q = *reinterpret_cast<const float4*>(v + 4 * lane);
  const float a0 = q.x * scale, a1 = a0 + q.y * scale,
              a2 = a1 + q.z * scale, a3 = a2 + q.w * scale;
  float incl = a3;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  const float excl = incl - a3;
  *reinterpret_cast<float4*>(out + 4 * lane) =
      make_float4(excl + a0, excl + a1, excl + a2, excl + a3);
  return __shfl_sync(0xffffffffu, incl, 31);
}

// dt of `ht` heads (h0..) for the chunk's rows into dts[j * kChunk + m],
// zero past s; consecutive threads read consecutive heads of a token.
__device__ __forceinline__ void load_dt(float* dts, const float* dt, int bi,
                                        int t0, int h0, int ht, int s,
                                        long long dsb, long long dss,
                                        long long dsh, int tid,
                                        int nthreads) {
  for (int i = tid; i < ht * kChunk; i += nthreads) {
    const int m = i / ht, j = i % ht;
    dts[j * kChunk + m] =
        t0 + m < s ? dt[bi * dsb + (t0 + m) * dss + (h0 + j) * dsh] : 0.f;
  }
}

// ---------------------------------------------------------- (a) states
template <int N, int P>
struct StatesSmem {
  using BT = Tile<N, kChunk>;
  using XT = Tile<P, kChunk>;
  static constexpr int kB = 0;
  static constexpr int kX = BT::kBytes;                 // + slot
  static constexpr int kDt = kX + 2 * XT::kBytes;       // kMaxHeads x kChunk
  static constexpr int kW = kDt + 4 * kMaxHeads * kChunk;
  static constexpr int kBars = kW + 4 * kMaxHeads * kChunk;
  static constexpr int kBytes = kBars + 8 * 3;          // B, two x slots
  static constexpr size_t kDynamic = kBytes + 1024;     // for the alignment
};

template <int N, int P>
__global__ void __launch_bounds__(128)
ssd_states_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_b,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       float* __restrict__ states,
                       float* __restrict__ chunk_log2_decay, int s, int h,
                       int g, int nc, int ht, long long dsb, long long dss,
                       long long dsh) {
  using L = StatesSmem<N, P>;
  using BT = typename L::BT;
  using XT = typename L::XT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* b_full = bars;
  uint64_t* x_full = bars + 1;
  float* dts = reinterpret_cast<float*>(smem + L::kDt);
  float* wts = reinterpret_cast<float*>(smem + L::kW);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = blockIdx.x * ht, c = blockIdx.y, bi = blockIdx.z;
  const int t0 = c * kChunk;
  const int gi = h0 / (h / g);

  if (tid == 0) {
    mbar_init(b_full, 1);
    mbar_init(&x_full[0], 1);
    mbar_init(&x_full[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue_x = [&](int j) {
    mbar_arrive_expect_tx(&x_full[j & 1], XT::kBytes);
    XT::load(smem + L::kX + (j & 1) * XT::kBytes, &map_x, &x_full[j & 1], t0,
             h0 + j, bi);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(b_full, BT::kBytes);
    BT::load(smem + L::kB, &map_b, b_full, t0, gi, bi);
    issue_x(0);
    if (ht > 1) issue_x(1);
  }

  load_dt(dts, dt, bi, t0, h0, ht, s, dsb, dss, dsh, tid, 128);
  __syncthreads();
  // w_m = exp(cum_last - cum_m) dt_m per head, in the log2 domain; the
  // chunk's decay exp(cum_last) goes to the state pass as cum_last log2 e
  for (int j = warp; j < ht; j += 4) {
    float* w = wts + j * kChunk;
    const float* d = dts + j * kChunk;
    const float total = warp_cumsum128(d, A[h0 + j] * kLog2e, w, lane);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 4 * lane + i;
      w[m] = exp2f(total - w[m]) * d[m];
    }
    if (lane == 0)
      chunk_log2_decay[(static_cast<long long>(bi) * nc + c) * h + h0 + j] =
          total;
  }
  __syncthreads();

  // stateᵀ (p x n) = (w ∘ x)ᵀ B: A = (w ∘ x)ᵀ from registers, rows p
  // (rows past P of the 64-row product are zero and dropped), B MN-major
  const int g8 = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g8, r1 = r0 + 8;
  const bool live = r0 < P;  // warp-uniform
  const uint32_t b_base = smem_u32(smem + L::kB);
  mbar_wait(b_full, 0);
  for (int j = 0; j < ht; ++j) {
    const int slot = j & 1;
    mbar_wait(&x_full[slot], (j >> 1) & 1);
    const unsigned char* xt = smem + L::kX + slot * XT::kBytes;
    const float* w = wts + j * kChunk;
    auto xw = [&](int m, int r) {
      return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                 xt + swizzled<2 * P>(m, 2 * r))) * w[m];
    };
    uint32_t a[kChunk / 16][4];
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const int m0 = 16 * kk + 2 * t;
      if (live) {
        a[kk][0] = pack_bf16(xw(m0, r0), xw(m0 + 1, r0));
        a[kk][1] = pack_bf16(xw(m0, r1), xw(m0 + 1, r1));
        a[kk][2] = pack_bf16(xw(m0 + 8, r0), xw(m0 + 9, r0));
        a[kk][3] = pack_bf16(xw(m0 + 8, r1), xw(m0 + 9, r1));
      } else {
        a[kk][0] = a[kk][1] = a[kk][2] = a[kk][3] = 0u;
      }
    }
    float acc[N / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      wgmma_rs<1>(acc, a[kk], BT::mnmajor(b_base, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (live) {
      float* out = states + ((static_cast<long long>(bi) * nc + c) * h +
                             h0 + j) * (P * N);
#pragma unroll
      for (int q = 0; q < N / 8; ++q) {
        *reinterpret_cast<float2*>(out + r0 * N + 8 * q + 2 * t) =
            make_float2(acc[4 * q], acc[4 * q + 1]);
        *reinterpret_cast<float2*>(out + r1 * N + 8 * q + 2 * t) =
            make_float2(acc[4 * q + 2], acc[4 * q + 3]);
      }
    }
    __syncthreads();  // every thread has read this slot
    if (tid == 0 && j + 2 < ht) issue_x(j + 2);
  }
}

// ------------------------------------------------------- (b) state pass
// One thread carries four consecutive state values of one (batch, head)
// across the chunks: S_in[c] = S, S = 2^(log2 decay_c) S + local_c.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const float* __restrict__ states,
                      const float* __restrict__ chunk_log2_decay,
                      __nv_bfloat16* __restrict__ s_in, int nc, int h,
                      int pn) {
  constexpr int kAhead = 8;
  const int v = blockIdx.x * kPassThreads + threadIdx.x;
  if (4 * v >= pn) return;
  const int hi = blockIdx.y, bi = blockIdx.z;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc - 1; c0 += kAhead) {
    float4 loc[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const long long hc = (static_cast<long long>(bi) * nc + c0 + k) * h + hi;
      if (c0 + k < nc - 1) {
        loc[k] = *reinterpret_cast<const float4*>(states + hc * pn + 4 * v);
        dec[k] = chunk_log2_decay[hc];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc - 1) {
        const float e = exp2f(dec[k]);
        S = make_float4(fmaf(S.x, e, loc[k].x), fmaf(S.y, e, loc[k].y),
                        fmaf(S.z, e, loc[k].z), fmaf(S.w, e, loc[k].w));
        const long long hc =
            (static_cast<long long>(bi) * nc + c0 + k + 1) * h + hi;
        uint2 packed;
        packed.x = pack_bf16(S.x, S.y);
        packed.y = pack_bf16(S.z, S.w);
        *reinterpret_cast<uint2*>(s_in + hc * pn + 4 * v) = packed;
      }
    }
  }
}

// ---------------------------------------------------------- (c) output
template <int N, int P>
struct OutSmem {
  using CT = Tile<N, kChunk>;   // C and B of the chunk
  using XT = Tile<P, kChunk>;   // x of one head
  using ST = Tile<N, P>;        // S_in of one head, (p, n)
  using YT = Tile<P, kChunk>;   // y of one head, staged for its store
  static constexpr int kC = 0;
  static constexpr int kB = CT::kBytes;
  static constexpr int kX = 2 * CT::kBytes;             // + slot
  static constexpr int kS = kX + kHeadSlots * XT::kBytes;  // + slot
  static constexpr int kY = kS + kHeadSlots * ST::kBytes;   // + buffer
  static constexpr int kDt = kY + 2 * YT::kBytes;           // heads x kChunk
  static constexpr int kCum = kDt + 4 * kMaxHeads * kChunk;
  static constexpr int kBars = kCum + 4 * kMaxHeads * kChunk;
  static constexpr int kBytes = kBars + 8 * (1 + kHeadSlots);  // C/B, slots
  static constexpr size_t kDynamic = kBytes + 1024;
};

struct OutArgs {
  const CUtensorMap* map_x;
  const CUtensorMap* map_s;
  const CUtensorMap* map_y;
  unsigned char* smem;
  uint64_t* head_full;
  const float* dts;
  const float* cum;
  int nc, ht, bi, c, h0, t0;
};

// Head j's x and S_in (none in the first chunk) into its ring slot
template <int N, int P>
__device__ __forceinline__ void issue_head(const OutArgs& q, int j) {
  using L = OutSmem<N, P>;
  using XT = typename L::XT;
  using ST = typename L::ST;
  const int slot = j % kHeadSlots;
  mbar_arrive_expect_tx(&q.head_full[slot],
                        XT::kBytes + (q.c > 0 ? ST::kBytes : 0));
  XT::load(q.smem + L::kX + slot * XT::kBytes, q.map_x, &q.head_full[slot],
           q.t0, q.h0 + j, q.bi);
  if (q.c > 0)
    ST::load(q.smem + L::kS + slot * ST::kBytes, q.map_s, &q.head_full[slot],
             0, q.h0 + j, q.bi * q.nc + q.c);
}

// Rows 64 wg .. 64 wg + 63 of the chunk, for each of the block's heads;
// NC = 64 (wg + 1) columns of C Bᵀ are causal for them.
template <int N, int P, int NC>
__device__ __forceinline__ void out_rows(const OutArgs& q, int wg, int tid) {
  using L = OutSmem<N, P>;
  using CT = typename L::CT;
  using XT = typename L::XT;
  using ST = typename L::ST;
  using YT = typename L::YT;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g8 = lane / 4, t = lane % 4;
  const int l0 = 64 * wg + 16 * warp + g8, l1 = l0 + 8;  // chunk rows
  const uint32_t c_base = smem_u32(q.smem + L::kC);
  const uint32_t b_base = smem_u32(q.smem + L::kB);

  // C Bᵀ for these rows, once for all the block's heads
  float cb[NC / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_ss<0>(cb, CT::kmajor(c_base, 64 * wg, kk),
                CT::kmajor(b_base, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(cb);

  for (int j = 0; j < q.ht; ++j) {
    const int slot = j % kHeadSlots;
    const float* cm = q.cum + j * kChunk;
    const float* dm = q.dts + j * kChunk;
    const float cl0 = cm[l0], cl1 = cm[l1];
    mbar_wait(&q.head_full[slot], (j / kHeadSlots) & 1);

    // y = exp(cum_l) (C S_in)_l; the first chunk has S_in = 0
    float yacc[P / 2];
    if (q.c > 0) {
      const uint32_t s_base = smem_u32(q.smem + L::kS + slot * ST::kBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss<0>(yacc, CT::kmajor(c_base, 64 * wg, kk),
                    ST::kmajor(s_base, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(yacc);
      const float e0 = exp2f(cl0), e1 = exp2f(cl1);
#pragma unroll
      for (int i = 0; i < P / 8; ++i) {
        yacc[4 * i] *= e0;
        yacc[4 * i + 1] *= e0;
        yacc[4 * i + 2] *= e1;
        yacc[4 * i + 3] *= e1;
      }
    } else {
#pragma unroll
      for (int i = 0; i < P / 2; ++i) yacc[i] = 0.f;
    }

    // y += scores x: the masked scores (C Bᵀ)_lm 2^(cum_l - cum_m) dt_m
    // for m <= l, rounded to bf16 as the A fragments; cb[4i + e] is row
    // (e < 2 ? l0 : l1), column 8i + 2t + (e & 1)
    uint32_t a[NC / 16][4];
#pragma unroll
    for (int i = 0; i < NC / 8; ++i) {
      const int m = 8 * i + 2 * t;
      const float2 cmm = *reinterpret_cast<const float2*>(cm + m);
      const float2 dmm = *reinterpret_cast<const float2*>(dm + m);
      const float v0 = m <= l0 ? cb[4 * i] * fast_exp2(cl0 - cmm.x) * dmm.x
                               : 0.f;
      const float v1 = m + 1 <= l0
                           ? cb[4 * i + 1] * fast_exp2(cl0 - cmm.y) * dmm.y
                           : 0.f;
      const float v2 = m <= l1 ? cb[4 * i + 2] * fast_exp2(cl1 - cmm.x) * dmm.x
                               : 0.f;
      const float v3 = m + 1 <= l1
                           ? cb[4 * i + 3] * fast_exp2(cl1 - cmm.y) * dmm.y
                           : 0.f;
      a[i / 2][2 * (i & 1)] = pack_bf16(v0, v1);
      a[i / 2][2 * (i & 1) + 1] = pack_bf16(v2, v3);
    }
    const uint32_t x_base = smem_u32(q.smem + L::kX + slot * XT::kBytes);
    fence_regs(yacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk)
      wgmma_rs<1>(yacc, a[kk], XT::mnmajor(x_base, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yacc);

    // y into staging buffer j % 2 as TMA's tile image (its store two
    // heads ago has read it), then one TMA store of the 128 rows; rows
    // past s are not written
    unsigned char* yt = q.smem + L::kY + (j & 1) * YT::kBytes;
#pragma unroll
    for (int i = 0; i < P / 8; ++i) {
      const int cb2 = 2 * (8 * i + 2 * t);  // byte of the column pair
      *reinterpret_cast<__nv_bfloat162*>(yt + swizzled<2 * P>(l0, cb2)) =
          __floats2bfloat162_rn(yacc[4 * i], yacc[4 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(yt + swizzled<2 * P>(l1, cb2)) =
          __floats2bfloat162_rn(yacc[4 * i + 2], yacc[4 * i + 3]);
    }
    fence_async_smem();
    // head j - 1's store has read the other buffer, which head j + 1 fills
    if (tid == 0) bulk_wait_read<0>();
    named_bar_sync(1, 256);  // y staged; both warpgroups have read the slot
    if (tid == 0) {
      YT::store(q.map_y, yt, q.t0, q.h0 + j, q.bi);
      bulk_commit();
      if (j + kHeadSlots < q.ht) issue_head<N, P>(q, j + kHeadSlots);
    }
  }
  if (tid == 0) bulk_wait<0>();  // y written before the block's end
}

template <int N, int P>
__global__ void __launch_bounds__(256, 1)
ssd_out_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_c,
                    const __grid_constant__ CUtensorMap map_s,
                    const __grid_constant__ CUtensorMap map_y,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    int s, int h, int g, int nc, int ht, long long dsb,
                    long long dss, long long dsh) {
  using L = OutSmem<N, P>;
  using CT = typename L::CT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* cb_full = bars;
  uint64_t* head_full = bars + 1;
  float* dts = reinterpret_cast<float*>(smem + L::kDt);
  float* cum = reinterpret_cast<float*>(smem + L::kCum);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = blockIdx.x * ht, c = blockIdx.y, bi = blockIdx.z;
  const int t0 = c * kChunk;
  const int gi = h0 / (h / g);

  if (tid == 0) {
    mbar_init(cb_full, 1);
    for (int i = 0; i < kHeadSlots; ++i) mbar_init(&head_full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const OutArgs q{&map_x, &map_s, &map_y, smem, head_full, dts, cum,
                  nc, ht, bi, c, h0, t0};
  if (tid == 0) {
    mbar_arrive_expect_tx(cb_full, 2 * CT::kBytes);
    CT::load(smem + L::kC, &map_c, cb_full, t0, gi, bi);
    CT::load(smem + L::kB, &map_b, cb_full, t0, gi, bi);
    for (int j = 0; j < kHeadSlots && j < ht; ++j) issue_head<N, P>(q, j);
  }

  // cum of each head in the log2 domain
  load_dt(dts, dt, bi, t0, h0, ht, s, dsb, dss, dsh, tid, 256);
  __syncthreads();
  for (int j = warp; j < ht; j += 8)
    warp_cumsum128(dts + j * kChunk, A[h0 + j] * kLog2e, cum + j * kChunk,
                   lane);
  __syncthreads();

  mbar_wait(cb_full, 0);
  if (tid < 128)
    out_rows<N, P, 64>(q, 0, tid);
  else
    out_rows<N, P, 128>(q, 1, tid);
}

// ------------------------------------------------------------- launches
inline long long align256(long long bytes) { return (bytes + 255) & ~255LL; }

struct Workspace {
  long long states, s_in, decay, total;
};

inline Workspace workspace_layout(int b, int s, int h, int p, int n) {
  const long long nc = (s + kChunk - 1) / kChunk;
  const long long vals = static_cast<long long>(b) * nc * h * p * n;
  Workspace w;
  w.states = 0;
  w.s_in = align256(4 * vals);
  w.decay = w.s_in + align256(2 * vals);
  w.total = nc > 1 ? w.decay + align256(4LL * b * nc * h) : 0;
  return w;
}

// Heads a bf16 block takes: the most (up to 8) that divide a group's heads
// while a grid of `chunks` x h / ht blocks keeps `target` blocks.
int heads_per_block(long long chunks, int h, int g, int target) {
  int ht = kMaxHeads;
  while (ht > 1 && ((h / g) % ht || chunks * (h / ht) < target)) ht /= 2;
  return ht;
}

template <int N, int P>
cudaError_t launch_bf16(const void* x, const float* dt, const float* A,
                        const void* B, const void* C, void* y, void* work,
                        int b, int s, int h, int g, const long long* st,
                        cudaStream_t stream) {
  const int nc = (s + kChunk - 1) / kChunk;
  // a size-1 dimension is never stepped; give TMA a valid stride for it
  auto nz = [](long long v, long long alt) { return v != 0 ? v : alt; };
  CUtensorMap map_x, map_b, map_c, map_y, map_s = {};
  cudaError_t err = encode_tile_map(&map_x, x, P, s, h, b, nz(st[0], P),
                                    nz(st[1], P), nz(st[2], P), kChunk);
  if (err == cudaSuccess)  // y is (b, s, h, p) contiguous
    err = encode_tile_map(&map_y, y, P, s, h, b, 1LL * s * h * P, 1LL * h * P,
                          P, kChunk);
  if (err == cudaSuccess)
    err = encode_tile_map(&map_b, B, N, s, g, b, nz(st[6], N), nz(st[7], N),
                          nz(st[8], N), kChunk);
  if (err == cudaSuccess)
    err = encode_tile_map(&map_c, C, N, s, g, b, nz(st[9], N), nz(st[10], N),
                          nz(st[11], N), kChunk);
  if (err != cudaSuccess) return err;

  const Workspace w = workspace_layout(b, s, h, P, N);
  auto* base = static_cast<unsigned char*>(work);
  if (nc > 1) {
    auto* states = reinterpret_cast<float*>(base + w.states);
    auto* s_in = reinterpret_cast<__nv_bfloat16*>(base + w.s_in);
    auto* decay = reinterpret_cast<float*>(base + w.decay);
    // S_in is (b nc, h, p, n), read by TMA
    err = encode_tile_map(&map_s, s_in, N, P, h, b * nc,
                          static_cast<long long>(h) * P * N, N,
                          static_cast<long long>(P) * N, P);
    if (err != cudaSuccess) return err;

    const int ht = heads_per_block(1LL * b * (nc - 1), h, g, kStatesBlocks);
    constexpr size_t smem_a = StatesSmem<N, P>::kDynamic;
    err = cudaFuncSetAttribute(ssd_states_bf16_kernel<N, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_a));
    if (err != cudaSuccess) return err;
    ssd_states_bf16_kernel<N, P><<<dim3(h / ht, nc - 1, b), 128, smem_a,
                                   stream>>>(
        map_x, map_b, dt, A, states, decay, s, h, g, nc, ht, st[3], st[4],
        st[5]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const int pn = P * N;
    const int pass_blocks = (pn / 4 + kPassThreads - 1) / kPassThreads;
    ssd_state_pass_kernel<<<dim3(pass_blocks, h, b), kPassThreads, 0,
                            stream>>>(states, decay, s_in, nc, h, pn);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  const int ht = heads_per_block(1LL * b * nc, h, g, kOutBlocks);
  constexpr size_t smem_c = OutSmem<N, P>::kDynamic;
  err = cudaFuncSetAttribute(ssd_out_bf16_kernel<N, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_c));
  if (err != cudaSuccess) return err;
  ssd_out_bf16_kernel<N, P><<<dim3(h / ht, nc, b), 256, smem_c, stream>>>(
      map_x, map_b, map_c, map_s, map_y, dt, A, s, h, g, nc, ht, st[3], st[4],
      st[5]);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_bf16_n(int n, const void* x, const float* dt,
                            const float* A, const void* B, const void* C,
                            void* y, void* work, int b, int s, int h, int g,
                            const long long* st, cudaStream_t stream) {
#define REPRO_SSD_CASE(N)                                                    \
  case N:                                                                    \
    return launch_bf16<N, P>(x, dt, A, B, C, y, work, b, s, h, g, st, stream);
  switch (n) {
    REPRO_SSD_CASE(16)
    REPRO_SSD_CASE(32)
    REPRO_SSD_CASE(64)
    REPRO_SSD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SSD_CASE
}

cudaError_t dispatch_fp32_n(int n, const void* x, const float* dt,
                            const float* A, const void* B, const void* C,
                            void* y, int b, int s, int h, int p, int g,
                            const long long* st, cudaStream_t stream) {
#define REPRO_SSD_CASE(N)                                                    \
  case N:                                                                    \
    return launch_fp32<N>(x, dt, A, B, C, y, b, s, h, p, g, st, stream);
  switch (n) {
    REPRO_SSD_CASE(16)
    REPRO_SSD_CASE(32)
    REPRO_SSD_CASE(64)
    REPRO_SSD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SSD_CASE
}

}  // namespace

// Bytes of device workspace `repro_ssd_scan_fwd` needs for these shapes (0
// for fp32 and for a bf16 sequence of one chunk).
extern "C" long long repro_ssd_scan_workspace_bytes(int dtype, int b, int s,
                                                    int h, int p, int n) {
  if (dtype != 1 || b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0) return 0;
  return workspace_layout(b, s, h, p, n).total;
}

// dtype of x, B, C and y: 0 = fp32, 1 = bf16; dt and A are fp32. Strides
// are in elements: x (batch, seq, head), dt (batch, seq, head), B and C
// (batch, seq, group); the last dimension of x, B and C is contiguous, A
// and y are contiguous. `work` holds `work_bytes` bytes of device memory,
// at least `repro_ssd_scan_workspace_bytes`. Returns the cudaError_t of the
// launches.
extern "C" int repro_ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* work, long long work_bytes, int dtype,
    int b, int s, int h, int p, int g, int n, long long xsb, long long xss,
    long long xsh, long long dsb, long long dss, long long dsh,
    long long bsb, long long bss, long long bsg, long long csb,
    long long css, long long csg, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || h <= 0 || g <= 0 || h % g || p <= 0 ||
      p % kCols || static_cast<long long>(b) * h * (p / kCols) > (1LL << 31) - 1)
    return cudaErrorInvalidValue;
  const long long strides[12] = {xsb, xss, xsh, dsb, dss, dsh,
                                 bsb, bss, bsg, csb, css, csg};
  // x, B and C move as 16-byte vectors or TMA boxes
  const long long vec = dtype == 0 ? 4 : 8;
  for (int i : {0, 1, 2, 6, 7, 8, 9, 10, 11})
    if (strides[i] % vec) return cudaErrorInvalidValue;
  for (const void* ptr : {x, B, C})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  auto* dtf = static_cast<const float*>(dt);
  auto* af = static_cast<const float*>(A);
  if (dtype == 0)
    return dispatch_fp32_n(n, x, dtf, af, B, C, y, b, s, h, p, g, strides, st);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (work_bytes < repro_ssd_scan_workspace_bytes(dtype, b, s, h, p, n) ||
      (s + kChunk - 1) / kChunk > 65535 || b > 65535)
    return cudaErrorInvalidValue;
  if (p == 32)
    return dispatch_bf16_n<32>(n, x, dtf, af, B, C, y, work, b, s, h, g,
                               strides, st);
  if (p == 64)
    return dispatch_bf16_n<64>(n, x, dtf, af, B, C, y, work, b, s, h, g,
                               strides, st);
  return cudaErrorInvalidValue;
}
