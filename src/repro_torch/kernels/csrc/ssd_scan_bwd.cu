// Mamba2 SSD chunked scan backward for Hopper (sm_90a), plain C interface.
//
// Replaces: none. The reference differentiates its SSD by `jax.vjp` over
// the oracle (src/repro/kernels/ops.py `_ssd_bwd`); the port did the same,
// autograd over `ref.ssd_scan_ref`, which recomputes the scan in fp32 with
// (b, chunks, groups, heads, L, L) temporaries. This kernel computes the
// exact gradient of the forward that ssd_scan.cu's header states, from the
// closed form that `ref.ssd_scan_bwd_ref` writes in plain PyTorch. Per
// chunk of tokens and head i (group i / (h/g)), with cum the cumsum of
// dt A in the chunk, Lg its last value, S_c the state entering chunk c and
// D_c the gradient of the state leaving it (D_last = 0,
// D_{c-1} = e^Lg_c D_c + sum_l e^cum_l C_l dy_lᵀ):
//   dx_m = sum_{l>=m} (C_l.B_m) e^(cum_l-cum_m) dt_m dy_l + w_m Dᵀ B_m
//   dB_m = sum_{l>=m} e^(cum_l-cum_m) dt_m (dy_l.x_m) C_l + w_m D x_m
//   dC_l = sum_{m<=l} e^(cum_l-cum_m) dt_m (dy_l.x_m) B_m + e^cum_l S dy_l
// with w_m = e^(Lg-cum_m) dt_m, dB and dC summed over the group's heads;
// ddt_m = sum_l (C_l.B_m) e^(cum_l-cum_m) (dy_l.x_m) + e^(Lg-cum_m) B_mᵀ D x_m
// + A da_m, where da is the reverse cumsum over the chunk of the gradient
// of cum (the terms M_lm = (C_l.B_m) e^(cum_l-cum_m) dt_m (dy_l.x_m): its
// row sums less its column sums, y_off_l.dy_l less u_m = w_m B_mᵀ D x_m,
// and on the last token sum_m u_m + e^Lg <D, S>); dA = sum dt da.
//
// What bounds it on the H100: the products, nearly as much as memory. At
// the mamba2-1.3b training shape (b=4, s=2048, h=64, p=64, n=128, g=1) a
// call reads x, dy, B, C and dt and writes dx, dB, dC and ddt, 214 MB (64
// us at 3.35 TB/s), and needs 64.7 GFLOP of products over 64-token chunks
// (`ssd_scan.bwd_cost`: the causal halves of the L x L terms and six
// state-sized products a chunk; 65 us at 989 TFLOP/s).
//
// Design: three stages, each a kernel on the caller's stream, over 64-token
// chunks (the scan does not depend on the chunk length, so the kernel
// picks its own, whatever chunk the caller names: a 64-row chunk is one
// warpgroup's wgmma tile, and no product needs a causal split). x, dy, B
// and C arrive by TMA (tensor maps over the callers' strided views; rows
// past s arrive as zeros and dt is zero there, so a ragged last chunk
// needs no other mask); every product runs on `wgmma`, bf16 in and fp32
// accumulated (hopper.cuh). Operands that arrive in bf16 stay bf16; an
// intermediate that feeds a product is rounded to bf16 once, where the
// forward rounds its counterpart (scores, weighted x, state tiles); the
// cumsums, exponentials, both recurrences, ddt and dA stay in fp32.
//  (1) `chunkscan_bwd_sweep_kernel`, one warpgroup a block over (batch,
//      head, 64 state columns), the state (p x 64) in fp32 registers: D
//      backward over the chunks, D = e^Lg D + (C ∘ e^cum)ᵀ dy as one
//      accumulating product a chunk, then S forward, S = e^Lg S +
//      (B ∘ w)ᵀ x (the forward's local state), the chunk tiles on a
//      three-slot TMA ring. Each chunk's S and D leave in bf16 (the
//      operands of (2)) by TMA stores from a staging tile; D also leaves
//      in fp32 as the registers' own image, read back a chunk ahead by the
//      S sweep for <D_c, S_c> in fp32 (a partial a warp). The chunk states
//      are recomputed here, not saved by the forward.
//  (2) `chunkscan_bwd_chunk_kernel`, two warpgroups a block over (batch,
//      chunk, up to 16 heads of one group), B and C loaded once, each
//      head's x, dy, S and D on a two-slot mbarrier ring. Warpgroup 0
//      takes the rows m: B Cᵀ once a block, then per head x dyᵀ and B Dᵀ,
//      the masked (B Cᵀ ∘ decay ∘ dt) and (x dyᵀ ∘ decay ∘ dt) rounded once
//      to bf16 as register A fragments, dx = that ∘ dy + w ∘ (B Dᵀ) stored
//      as bf16, and dB += (x dyᵀ ∘ ..) C + (w ∘ x) Dᵀ kept in registers
//      across the heads; the fp32 row sums give ddt's direct part.
//      Warpgroup 1 takes the rows l: C Bᵀ once, then per head dy xᵀ and
//      C Sᵀ, dC += (dy xᵀ ∘ decay ∘ dt) B + (e^cum ∘ dy) Sᵀ, and the row
//      sums of M and y_off.dy. Then each head's dcum, its reverse cumsum,
//      ddt and the chunk's share of dA, by one warp a head; dB and dC go
//      out in fp32, one partial a block.
//  (3) `chunkscan_bwd_reduce_kernel` sums dB's and dC's partials over the
//      head tiles of a group in order and writes them in B's dtype;
//      `chunkscan_bwd_da_kernel` sums dA's over batch and chunks in order.
// No atomics anywhere: two calls give the same bits. No kernel of this
// file has `ssd_` in its name, so nothing here is counted as the forward.
//
// The workspace (`repro_ssd_scan_bwd_workspace_bytes`) holds D's fp32
// image and S and D in bf16, each b (s/64) h 64 n values at most, the
// <D, S> and dA partials, and dB's and dC's partials in fp32 (b s g n a
// head tile of a group each): 0.57 GB at the training shape. On the H100
// there (PERF.md) the sweep moves about 0.94 GB in 0.33 ms, near the
// memory's rate, and the chunk kernel about 0.5 GB and 65 GFLOP in 0.23
// ms; the whole call takes 0.58 ms, 8.9x its bound. Tried and not kept: a
// chunk-parallel pass of the local states in fp32 and a state pass over
// them (0.71 ms for what the sweep does in 0.33); the sweep's bf16 states
// stored from registers (0.64 ms) and at four blocks an SM (0.58, spills);
// 8 heads a chunk block (0.27 ms against 0.23).
//
// Supported: bf16 x, dy, B, C; fp32 dt and A; p in {32, 64}; n in {16, 32,
// 64, 128}; any g dividing h. x, B and C may have any batch, sequence and
// head/group strides that are multiples of 16 bytes, with a contiguous last
// dimension and 16-byte aligned data; dt any strides; A, dy and every
// output contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

namespace {

using namespace repro_hopper;

constexpr int kL = 64;            // tokens per chunk
constexpr int kMaxHeads = 16;     // heads per block, at most
constexpr int kSlots = 2;         // the ring of heads
// (2) takes the most heads a block that still leaves this many blocks
constexpr int kChunkBlocks = 256;
constexpr int kSweepStages = 3;   // the sweeps' ring of chunk tiles
constexpr float kLog2e = 1.4426950408889634f;

// Inclusive prefix sums of scale * v[0..63] by one warp, two consecutive
// values a lane, into out; returns the total.
__device__ __forceinline__ float warp_cumsum64(const float* v, float scale,
                                               float* out, int lane) {
  const float2 q = *reinterpret_cast<const float2*>(v + 2 * lane);
  const float a0 = q.x * scale, a1 = a0 + q.y * scale;
  float incl = a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  const float excl = incl - a1;
  *reinterpret_cast<float2*>(out + 2 * lane) =
      make_float2(excl + a0, excl + a1);
  return __shfl_sync(0xffffffffu, incl, 31);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dt of `ht` heads (h0..) for the chunk's rows into dts[j * kL + m], zero
// past s; consecutive threads read consecutive heads of a token.
__device__ __forceinline__ void load_dt(float* dts, const float* dt, int bi,
                                        int t0, int h0, int ht, int s,
                                        long long dsb, long long dss,
                                        long long dsh, int tid,
                                        int nthreads) {
  for (int i = tid; i < ht * kL; i += nthreads) {
    const int m = i / ht, j = i % ht;
    dts[j * kL + m] =
        t0 + m < s ? dt[bi * dsb + (t0 + m) * dss + (h0 + j) * dsh] : 0.f;
  }
}

// a bf16 pair of a TMA tile P columns wide (one box), at (row, even col)
template <int P>
__device__ __forceinline__ float2 tile_pair(const unsigned char* tile, int row,
                                            int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      tile + swizzled<2 * P>(row, 2 * col)));
}

// ----------------------------------------------------------- (1) sweeps
// A sweep block carries kCols columns of a head's state: all of them up to
// n = 64, half of them at n = 128 (one TMA box of B or C), so a block's
// state is at most 64 x 64.
template <int N>
constexpr int kCols = N < 64 ? N : 64;
template <int N>
constexpr int kSplit = N / kCols<N>;

template <int N, int P>
struct SweepSmem {
  using MT = Tile<kCols<N>, kL>;  // the block's columns of B or C
  using XT = Tile<P, kL>;         // x or dy of the head
  using OT = Tile<kCols<N>, P>;   // a chunk's state (p, the block's n)
  static constexpr int kStage = MT::kBytes + XT::kBytes;
  static constexpr int kOut = kSweepStages * kStage;    // + buffer
  static constexpr int kDt = kOut + 2 * OT::kBytes;     // kL
  static constexpr int kW = kDt + 4 * kL;               // kL row weights
  static constexpr int kLg = kW + 4 * kL;               // the chunk's decay
  static constexpr int kBars = kLg + 16;
  static constexpr int kBytes = kBars + 8 * kSweepStages;
  static constexpr size_t kDynamic = kBytes + 1024;     // for the alignment
};

// One head's state, stateᵀ (p x n) in fp32 in the warpgroup's registers,
// columns col0 .. col0 + kCols - 1 (rows p: r0, r1 of the thread;
// acc[4q + e] at column 8q + 2t + (e & 1)), across one sweep of chunks,
// forward (S: 0 .. nc-1) or backward (D: nc-1 .. 0). Each chunk's state
// leaves in bf16, by TMA from a staging tile (`map_o`: S or D as (b nc, h,
// p, n)); D also in fp32 as the registers' image (`img32`: thread-major,
// so each store and load of a warp is 512 contiguous bytes), which the
// forward sweep reads a chunk ahead and dots with S in fp32, one partial
// a warp. Then, but after the last chunk, state = e^Lg state + (v ∘ t)ᵀ M
// for the chunk's tile t (x or dy) and M (B or C), weights v from its cum.
// `k` counts the chunks taken from the block's ring.
template <int N, int P, bool kForward>
__device__ __forceinline__ void sweep(
    unsigned char* smem, uint64_t* full, const CUtensorMap* map_t,
    const CUtensorMap* map_m, const CUtensorMap* map_o, const float* dt,
    float a2, int& k, int bi, int hi, int gi, int sp, int s, int h, int nc,
    long long dsb, long long dss, long long dsh, float* img32, float* dots) {
  using L = SweepSmem<N, P>;
  using MT = typename L::MT;
  using XT = typename L::XT;
  using OT = typename L::OT;
  constexpr int NB = kCols<N>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g8, r1 = r0 + 8;
  const bool live = r0 < P;  // warp-uniform
  const int col0 = sp * NB;
  float* dts = reinterpret_cast<float*>(smem + L::kDt);
  float* wts = reinterpret_cast<float*>(smem + L::kW);
  float* lg = reinterpret_cast<float*>(smem + L::kLg);
  const int first = kForward ? 0 : nc - 1, step = kForward ? 1 : -1;
  const int n_in = nc - 1;  // chunks whose tiles the sweep reads
  const int k0 = k;
  auto chunk_of = [&](int i) { return first + step * i; };
  auto issue = [&](int i) {  // the sweep's i-th chunk into the ring
    const int slot = (k0 + i) % kSweepStages;
    unsigned char* st = smem + slot * L::kStage;
    const int t0 = chunk_of(i) * kL;
    mbar_arrive_expect_tx(&full[slot], L::kStage);
    tma_load_4d(st, map_m, &full[slot], col0, t0, gi, bi);
    XT::load(st + MT::kBytes, map_t, &full[slot], t0, hi, bi);
  };
  if (tid == 0)
    for (int i = 0; i < kSweepStages && i < n_in; ++i) issue(i);
  auto load_row_dt = [&](int c) {
    const int row = c * kL + tid;
    return tid < kL && row < s ? dt[bi * dsb + row * dss + hi * dsh] : 0.f;
  };
  auto image = [&](int c) {  // this thread's fp32 image of D_c
    return img32 + (((static_cast<long long>(bi) * nc + c) * h + hi) *
                    kSplit<N> + sp) * (64 * NB) + 4 * tid;
  };
  float dn[NB / 2];  // D_c's image, loaded a chunk ahead (forward only)
  auto load_d = [&](int c) {
    if (!live) return;
    const float* d = image(c);
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(d + 512 * j);
      dn[4 * j] = v.x;
      dn[4 * j + 1] = v.y;
      dn[4 * j + 2] = v.z;
      dn[4 * j + 3] = v.w;
    }
  };
  if constexpr (kForward) load_d(first);
  float dtv = n_in > 0 ? load_row_dt(chunk_of(0)) : 0.f;

  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (int i = 0;; ++i) {
    const int c = chunk_of(i);
    // this chunk's state (S entering chunk c, or D leaving it) into staging
    // buffer i % 2 as TMA's tile image (its store two chunks ago has read
    // it)
    unsigned char* ot = smem + L::kOut + (i & 1) * OT::kBytes;
    if (live) {
#pragma unroll
      for (int q = 0; q < NB / 8; ++q) {
        const int cb = 2 * (8 * q + 2 * t);  // byte of the column pair
        *reinterpret_cast<uint32_t*>(ot + swizzled<2 * NB>(r0, cb)) =
            pack_bf16(acc[4 * q], acc[4 * q + 1]);
        *reinterpret_cast<uint32_t*>(ot + swizzled<2 * NB>(r1, cb)) =
            pack_bf16(acc[4 * q + 2], acc[4 * q + 3]);
      }
      if constexpr (!kForward) {
        float* d = image(c);
#pragma unroll
        for (int j = 0; j < NB / 8; ++j)
          *reinterpret_cast<float4*>(d + 512 * j) =
              make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                          acc[4 * j + 3]);
      }
    }
    fence_async_smem();
    if constexpr (kForward) {
      float dot = 0.f;
      if (live) {
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) dot += acc[j] * dn[j];
      }
      dot = warp_sum(dot);
      if (lane == 0)
        dots[((static_cast<long long>(bi) * nc + c) * h + hi) * 4 *
                 kSplit<N> + sp * 4 + warp] = dot;
      if (i < n_in) load_d(chunk_of(i + 1));
    }
    if (i < n_in && tid < kL) dts[tid] = dtv;
    __syncthreads();  // the state staged, this chunk's dt in place
    if (tid == 0) {
      tma_store_4d(map_o, ot, col0, 0, hi, bi * nc + c);
      bulk_commit();
    }
    if (i == n_in) break;

    // the chunk's cum (log2 domain) and row weights: w_m = e^(Lg - cum_m)
    // dt_m (forward) or e^cum_l (backward)
    const int slot = k % kSweepStages;
    if (i + 1 < n_in) dtv = load_row_dt(chunk_of(i + 1));
    if (warp == 0) {
      const float total = warp_cumsum64(dts, a2, wts, lane);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 2 * lane + e;
        wts[m] = kForward ? exp2f(total - wts[m]) * dts[m] : exp2f(wts[m]);
      }
      if (lane == 0) *lg = total;
    }
    __syncthreads();
    const float decay = exp2f(*lg);
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) acc[j] *= decay;

    // + (v ∘ t)ᵀ M: A = (v ∘ t)ᵀ from registers (rows p, depth the chunk's
    // rows; rows past P zero), M MN-major
    mbar_wait(&full[slot], (k / kSweepStages) & 1);
    const unsigned char* st = smem + slot * L::kStage;
    const unsigned char* tt = st + MT::kBytes;
    auto tv = [&](int m, int r) {
      return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                 tt + swizzled<2 * P>(m, 2 * r))) * wts[m];
    };
    uint32_t a[kL / 16][4];
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      const int m0 = 16 * kk + 2 * t;
      if (live) {
        a[kk][0] = pack_bf16(tv(m0, r0), tv(m0 + 1, r0));
        a[kk][1] = pack_bf16(tv(m0, r1), tv(m0 + 1, r1));
        a[kk][2] = pack_bf16(tv(m0 + 8, r0), tv(m0 + 9, r0));
        a[kk][3] = pack_bf16(tv(m0 + 8, r1), tv(m0 + 9, r1));
      } else {
        a[kk][0] = a[kk][1] = a[kk][2] = a[kk][3] = 0u;
      }
    }
    const uint32_t m_base = smem_u32(st);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk)
      wgmma_rs<1>(acc, a[kk], MT::mnmajor(m_base, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    // the store of the chunk before has read the buffer the next one fills
    if (tid == 0) bulk_wait_read<1>();
    __syncthreads();  // every thread has read this slot and the weights
    if (tid == 0 && i + kSweepStages < n_in) issue(i + kSweepStages);
    ++k;
  }
  if (tid == 0) bulk_wait<0>();  // the states written, the buffers free
  __syncthreads();
}

// One block a (column block, head, batch): the backward sweep of D (from
// dy and C), then the forward sweep of S (from x and B), which dots each
// S_c with D_c in fp32.
template <int N, int P>
__global__ void __launch_bounds__(128)
chunkscan_bwd_sweep_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_dy,
                           const __grid_constant__ CUtensorMap map_b,
                           const __grid_constant__ CUtensorMap map_c,
                           const __grid_constant__ CUtensorMap map_s,
                           const __grid_constant__ CUtensorMap map_d,
                           const float* __restrict__ dt,
                           const float* __restrict__ A,
                           float* __restrict__ d_image,
                           float* __restrict__ dots, int s, int h, int g,
                           int nc, long long dsb, long long dss,
                           long long dsh) {
  using L = SweepSmem<N, P>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  const int sp = blockIdx.x % kSplit<N>;
  const int hi = blockIdx.x / kSplit<N>, bi = blockIdx.y;
  const int gi = hi / (h / g);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSweepStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const float a2 = A[hi] * kLog2e;
  int k = 0;
  sweep<N, P, false>(smem, full, &map_dy, &map_c, &map_d, dt, a2, k, bi, hi,
                     gi, sp, s, h, nc, dsb, dss, dsh, d_image, nullptr);
  sweep<N, P, true>(smem, full, &map_x, &map_b, &map_s, dt, a2, k, bi, hi, gi,
                    sp, s, h, nc, dsb, dss, dsh, d_image, dots);
}

// ------------------------------------------------------------- (2) chunk
template <int N, int P>
struct ChunkSmem {
  using BT = Tile<N, kL>;   // B and C of the chunk
  using XT = Tile<P, kL>;   // x and dy of one head
  using ST = Tile<N, P>;    // S and D of one head, (p, n)
  static constexpr int kB = 0;
  static constexpr int kC = BT::kBytes;
  static constexpr int kX = 2 * BT::kBytes;               // + slot
  static constexpr int kDy = kX + kSlots * XT::kBytes;     // + slot
  static constexpr int kS = kDy + kSlots * XT::kBytes;     // + slot
  static constexpr int kD = kS + kSlots * ST::kBytes;      // + slot
  static constexpr int kDt = kD + kSlots * ST::kBytes;     // heads x kL
  static constexpr int kCum = kDt + 4 * kMaxHeads * kL;
  static constexpr int kDdt = kCum + 4 * kMaxHeads * kL;   // ddt's direct part
  static constexpr int kU = kDdt + 4 * kMaxHeads * kL;     // u_m
  static constexpr int kDcl = kU + 4 * kMaxHeads * kL;     // rows l's dcum
  static constexpr int kBars = kDcl + 4 * kMaxHeads * kL;
  static constexpr int kBytes = kBars + 8 * (1 + kSlots);
  static constexpr size_t kDynamic = kBytes + 1024;
};

struct ChunkArgs {
  unsigned char* smem;
  const float* dts;
  const float* cum;   // log2 domain
  float* ddt_direct;
  float* u;
  float* dcum_l;
  __nv_bfloat16* dx;
  int s, h, ht, bi, h0, t0;
};

// Warpgroup 0, rows m of the chunk: dx, ddt's direct part, u, and dB
// accumulated across the heads in `acc_b`; `bc` holds B Cᵀ (rows m).
template <int N, int P>
__device__ __forceinline__ void rows_m(const ChunkArgs& q, int j, int slot,
                                       const float (&bc)[kL / 2],
                                       float (&acc_b)[N / 2], int tid) {
  using L = ChunkSmem<N, P>;
  using BT = typename L::BT;
  using XT = typename L::XT;
  using ST = typename L::ST;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g8 = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g8, r1 = r0 + 8;
  const float* cm = q.cum + j * kL;
  const float* dm = q.dts + j * kL;
  const unsigned char* xt = q.smem + L::kX + slot * XT::kBytes;
  const uint32_t b_base = smem_u32(q.smem + L::kB);
  const uint32_t c_base = smem_u32(q.smem + L::kC);
  const uint32_t x_base = smem_u32(xt);
  const uint32_t dy_base = smem_u32(q.smem + L::kDy + slot * XT::kBytes);
  const uint32_t d_base = smem_u32(q.smem + L::kD + slot * ST::kBytes);

  // x dyᵀ (m, l) and B Dᵀ (m, p)
  float xdy[kL / 2], dx[P / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    wgmma_ss<0>(xdy, XT::kmajor(x_base, 0, kk), XT::kmajor(dy_base, 0, kk),
                kk > 0);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_ss<0>(dx, BT::kmajor(b_base, 0, kk), ST::kmajor(d_base, 0, kk),
                kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(xdy);
  fence_regs(dx);

  // for l >= m, with e = 2^(cum_l - cum_m): the scoresᵀ (B Cᵀ) e dt_m and
  // (x dyᵀ) e dt_m rounded once to bf16 as A fragments (depth l), and the
  // fp32 row sums of (B Cᵀ) e (x dyᵀ); xdy[4i + e] is row (e < 2 ? r0 :
  // r1), column 8i + 2t + (e & 1)
  const float cm0 = cm[r0], cm1 = cm[r1], dt0 = dm[r0], dt1 = dm[r1];
  float q0 = 0.f, q1 = 0.f;
  uint32_t ag[kL / 16][4], ah[kL / 16][4];
#pragma unroll
  for (int i = 0; i < kL / 8; ++i) {
    const int l = 8 * i + 2 * t;
    const float2 cl = *reinterpret_cast<const float2*>(cm + l);
    const float e00 = l >= r0 ? fast_exp2(cl.x - cm0) : 0.f;
    const float e01 = l + 1 >= r0 ? fast_exp2(cl.y - cm0) : 0.f;
    const float e10 = l >= r1 ? fast_exp2(cl.x - cm1) : 0.f;
    const float e11 = l + 1 >= r1 ? fast_exp2(cl.y - cm1) : 0.f;
    const float s00 = bc[4 * i] * e00, s01 = bc[4 * i + 1] * e01;
    const float s10 = bc[4 * i + 2] * e10, s11 = bc[4 * i + 3] * e11;
    q0 += s00 * xdy[4 * i] + s01 * xdy[4 * i + 1];
    q1 += s10 * xdy[4 * i + 2] + s11 * xdy[4 * i + 3];
    ag[i / 2][2 * (i & 1)] = pack_bf16(s00 * dt0, s01 * dt0);
    ag[i / 2][2 * (i & 1) + 1] = pack_bf16(s10 * dt1, s11 * dt1);
    ah[i / 2][2 * (i & 1)] =
        pack_bf16(xdy[4 * i] * e00 * dt0, xdy[4 * i + 1] * e01 * dt0);
    ah[i / 2][2 * (i & 1) + 1] =
        pack_bf16(xdy[4 * i + 2] * e10 * dt1, xdy[4 * i + 3] * e11 * dt1);
  }
  q0 = quad_sum(q0);
  q1 = quad_sum(q1);

  // B_mᵀ D x_m = x_m . (B Dᵀ)_m, then dx's state term w_m (B Dᵀ)_m
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int i = 0; i < P / 8; ++i) {
    const int p = 8 * i + 2 * t;
    const float2 x0 = tile_pair<P>(xt, r0, p), x1 = tile_pair<P>(xt, r1, p);
    v0 += dx[4 * i] * x0.x + dx[4 * i + 1] * x0.y;
    v1 += dx[4 * i + 2] * x1.x + dx[4 * i + 3] * x1.y;
  }
  v0 = quad_sum(v0);
  v1 = quad_sum(v1);
  const float last = cm[kL - 1];
  const float ew0 = exp2f(last - cm0), ew1 = exp2f(last - cm1);
  const float w0 = ew0 * dt0, w1 = ew1 * dt1;
#pragma unroll
  for (int i = 0; i < P / 8; ++i) {
    dx[4 * i] *= w0;
    dx[4 * i + 1] *= w0;
    dx[4 * i + 2] *= w1;
    dx[4 * i + 3] *= w1;
  }
  // (w ∘ x) as A fragments (depth p)
  uint32_t az[P / 16][4];
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk) {
    const int p = 16 * kk + 2 * t;
    const float2 a0 = tile_pair<P>(xt, r0, p), a1 = tile_pair<P>(xt, r1, p);
    const float2 a2 = tile_pair<P>(xt, r0, p + 8);
    const float2 a3 = tile_pair<P>(xt, r1, p + 8);
    az[kk][0] = pack_bf16(a0.x * w0, a0.y * w0);
    az[kk][1] = pack_bf16(a1.x * w1, a1.y * w1);
    az[kk][2] = pack_bf16(a2.x * w0, a2.y * w0);
    az[kk][3] = pack_bf16(a3.x * w1, a3.y * w1);
  }

  // dx += scoresᵀ dy; dB += (x dyᵀ ∘ decay ∘ dt) C + (w ∘ x) Dᵀ
  fence_regs(dx);
  fence_regs(acc_b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kL / 16; ++kk)
    wgmma_rs<1>(dx, ag[kk], XT::mnmajor(dy_base, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kL / 16; ++kk)
    wgmma_rs<1>(acc_b, ah[kk], BT::mnmajor(c_base, kk), 1);
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    wgmma_rs<1>(acc_b, az[kk], ST::mnmajor(d_base, kk), 1);
  wgmma_commit();

  // this head's rows: ddt's direct part and u_m = dt_m (its state term)
  if (t == 0) {
    q.ddt_direct[j * kL + r0] = q0 + ew0 * v0;
    q.ddt_direct[j * kL + r1] = q1 + ew1 * v1;
    q.u[j * kL + r0] = w0 * v0;
    q.u[j * kL + r1] = w1 * v1;
  }
  wgmma_wait<0>();
  fence_regs(dx);
  fence_regs(acc_b);
  const long long hp = static_cast<long long>(q.h) * P;
  __nv_bfloat16* out = q.dx + (static_cast<long long>(q.bi) * q.s + q.t0) * hp
                       + static_cast<long long>(q.h0 + j) * P;
#pragma unroll
  for (int i = 0; i < P / 8; ++i) {
    const int p = 8 * i + 2 * t;
    if (q.t0 + r0 < q.s)
      *reinterpret_cast<__nv_bfloat162*>(out + r0 * hp + p) =
          __floats2bfloat162_rn(dx[4 * i], dx[4 * i + 1]);
    if (q.t0 + r1 < q.s)
      *reinterpret_cast<__nv_bfloat162*>(out + r1 * hp + p) =
          __floats2bfloat162_rn(dx[4 * i + 2], dx[4 * i + 3]);
  }
}

// Warpgroup 1, rows l of the chunk: the row sums of M and y_off.dy into
// dcum_l, and dC accumulated across the heads in `acc_c`; `cb` holds C Bᵀ
// (rows l).
template <int N, int P>
__device__ __forceinline__ void rows_l(const ChunkArgs& q, int j, int slot,
                                       const float (&cb)[kL / 2],
                                       float (&acc_c)[N / 2], int tid) {
  using L = ChunkSmem<N, P>;
  using BT = typename L::BT;
  using XT = typename L::XT;
  using ST = typename L::ST;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g8 = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g8, r1 = r0 + 8;
  const float* cm = q.cum + j * kL;
  const float* dm = q.dts + j * kL;
  const unsigned char* dyt = q.smem + L::kDy + slot * XT::kBytes;
  const uint32_t b_base = smem_u32(q.smem + L::kB);
  const uint32_t c_base = smem_u32(q.smem + L::kC);
  const uint32_t x_base = smem_u32(q.smem + L::kX + slot * XT::kBytes);
  const uint32_t dy_base = smem_u32(dyt);
  const uint32_t s_base = smem_u32(q.smem + L::kS + slot * ST::kBytes);

  // dy xᵀ (l, m) and C Sᵀ (l, p)
  float dyx[kL / 2], cs[P / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    wgmma_ss<0>(dyx, XT::kmajor(dy_base, 0, kk), XT::kmajor(x_base, 0, kk),
                kk > 0);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_ss<0>(cs, BT::kmajor(c_base, 0, kk), ST::kmajor(s_base, 0, kk),
                kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dyx);
  fence_regs(cs);

  // for m <= l: (dy xᵀ) e dt_m rounded once to bf16 as A fragments (depth
  // m), and the fp32 row sums of M = (C Bᵀ) e dt_m (dy xᵀ)
  const float cl0 = cm[r0], cl1 = cm[r1];
  float m0s = 0.f, m1s = 0.f;
  uint32_t ah[kL / 16][4];
#pragma unroll
  for (int i = 0; i < kL / 8; ++i) {
    const int m = 8 * i + 2 * t;
    const float2 cmm = *reinterpret_cast<const float2*>(cm + m);
    const float2 dmm = *reinterpret_cast<const float2*>(dm + m);
    const float h00 = m <= r0 ? dyx[4 * i] * fast_exp2(cl0 - cmm.x) * dmm.x
                              : 0.f;
    const float h01 = m + 1 <= r0
                          ? dyx[4 * i + 1] * fast_exp2(cl0 - cmm.y) * dmm.y
                          : 0.f;
    const float h10 = m <= r1
                          ? dyx[4 * i + 2] * fast_exp2(cl1 - cmm.x) * dmm.x
                          : 0.f;
    const float h11 = m + 1 <= r1
                          ? dyx[4 * i + 3] * fast_exp2(cl1 - cmm.y) * dmm.y
                          : 0.f;
    m0s += cb[4 * i] * h00 + cb[4 * i + 1] * h01;
    m1s += cb[4 * i + 2] * h10 + cb[4 * i + 3] * h11;
    ah[i / 2][2 * (i & 1)] = pack_bf16(h00, h01);
    ah[i / 2][2 * (i & 1) + 1] = pack_bf16(h10, h11);
  }
  m0s = quad_sum(m0s);
  m1s = quad_sum(m1s);

  // y_off_l . dy_l = e^cum_l (C Sᵀ)_l . dy_l, and (e^cum ∘ dy) as A
  // fragments (depth p)
  const float ec0 = exp2f(cl0), ec1 = exp2f(cl1);
  float y0 = 0.f, y1 = 0.f;
  uint32_t ae[P / 16][4];
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 2 * kk + half;
      const int p = 8 * i + 2 * t;
      const float2 d0 = tile_pair<P>(dyt, r0, p), d1 = tile_pair<P>(dyt, r1, p);
      y0 += cs[4 * i] * d0.x + cs[4 * i + 1] * d0.y;
      y1 += cs[4 * i + 2] * d1.x + cs[4 * i + 3] * d1.y;
      ae[kk][2 * half] = pack_bf16(d0.x * ec0, d0.y * ec0);
      ae[kk][2 * half + 1] = pack_bf16(d1.x * ec1, d1.y * ec1);
    }
  }
  y0 = quad_sum(y0);
  y1 = quad_sum(y1);

  // dC += (dy xᵀ ∘ decay ∘ dt) B + (e^cum ∘ dy) Sᵀ
  fence_regs(acc_c);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kL / 16; ++kk)
    wgmma_rs<1>(acc_c, ah[kk], BT::mnmajor(b_base, kk), 1);
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    wgmma_rs<1>(acc_c, ae[kk], ST::mnmajor(s_base, kk), 1);
  wgmma_commit();
  if (t == 0) {
    q.dcum_l[j * kL + r0] = m0s + ec0 * y0;
    q.dcum_l[j * kL + r1] = m1s + ec1 * y1;
  }
  wgmma_wait<0>();
  fence_regs(acc_c);
}

// One warp a head, after every head's rows: dcum_l = dcum_l (rows l) -
// dt_l ddt_direct_l (its column sums and u), the last token's terms, the
// reverse cumsum da, ddt = ddt_direct + A da and the chunk's dt . da.
__device__ __forceinline__ void finish_head(const ChunkArgs& q, int j,
                                            const float* A, const float* dots,
                                            int nd, float* ddt, float* dA_part,
                                            long long hc, int lane) {
  const int l0 = 2 * lane, l1 = l0 + 1;
  const float* dm = q.dts + j * kL;
  const float* dd = q.ddt_direct + j * kL;
  float dc0 = q.dcum_l[j * kL + l0] - dm[l0] * dd[l0];
  float dc1 = q.dcum_l[j * kL + l1] - dm[l1] * dd[l1];
  float ds = 0.f;
  for (int k = lane; k < nd; k += 32) ds += dots[hc * nd + k];
  const float u_sum = warp_sum(q.u[j * kL + l0] + q.u[j * kL + l1]);
  ds = warp_sum(ds);
  if (lane == 31) dc1 += u_sum + exp2f(q.cum[j * kL + kL - 1]) * ds;
  // da_l = sum over l' >= l of dcum_l'
  float incl = dc0 + dc1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += v;
  }
  const float da0 = incl, da1 = incl - dc0;
  const float a = A[q.h0 + j];
  float* out = ddt + (static_cast<long long>(q.bi) * q.s + q.t0) * q.h +
               q.h0 + j;
  if (q.t0 + l0 < q.s) out[static_cast<long long>(l0) * q.h] = dd[l0] + a * da0;
  if (q.t0 + l1 < q.s) out[static_cast<long long>(l1) * q.h] = dd[l1] + a * da1;
  const float dtda = warp_sum(dm[l0] * da0 + dm[l1] * da1);
  if (lane == 0) dA_part[hc] = dtda;
}

template <int N, int P>
__global__ void __launch_bounds__(256, 1)
chunkscan_bwd_chunk_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_dy,
                           const __grid_constant__ CUtensorMap map_b,
                           const __grid_constant__ CUtensorMap map_c,
                           const __grid_constant__ CUtensorMap map_s,
                           const __grid_constant__ CUtensorMap map_d,
                           const float* __restrict__ dt,
                           const float* __restrict__ A,
                           const float* __restrict__ dots,
                           __nv_bfloat16* __restrict__ dx,
                           float* __restrict__ ddt,
                           float* __restrict__ dA_part,
                           float* __restrict__ dB_part,
                           float* __restrict__ dC_part, int b, int s, int h,
                           int g, int nc, int ht, long long dsb,
                           long long dss, long long dsh) {
  using L = ChunkSmem<N, P>;
  using BT = typename L::BT;
  using XT = typename L::XT;
  using ST = typename L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* bc_full = bars;
  uint64_t* head_full = bars + 1;
  float* dts = reinterpret_cast<float*>(smem + L::kDt);
  float* cum = reinterpret_cast<float*>(smem + L::kCum);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = tid / 128;
  const int h0 = blockIdx.x * ht, c = blockIdx.y, bi = blockIdx.z;
  const int t0 = c * kL;
  const int gi = h0 / (h / g);

  if (tid == 0) {
    mbar_init(bc_full, 1);
    for (int i = 0; i < kSlots; ++i) mbar_init(&head_full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto issue_head = [&](int j) {
    const int slot = j % kSlots;
    mbar_arrive_expect_tx(&head_full[slot], 2 * XT::kBytes + 2 * ST::kBytes);
    XT::load(smem + L::kX + slot * XT::kBytes, &map_x, &head_full[slot], t0,
             h0 + j, bi);
    XT::load(smem + L::kDy + slot * XT::kBytes, &map_dy, &head_full[slot], t0,
             h0 + j, bi);
    ST::load(smem + L::kS + slot * ST::kBytes, &map_s, &head_full[slot], 0,
             h0 + j, bi * nc + c);
    ST::load(smem + L::kD + slot * ST::kBytes, &map_d, &head_full[slot], 0,
             h0 + j, bi * nc + c);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(bc_full, 2 * BT::kBytes);
    BT::load(smem + L::kB, &map_b, bc_full, t0, gi, bi);
    BT::load(smem + L::kC, &map_c, bc_full, t0, gi, bi);
    for (int j = 0; j < kSlots && j < ht; ++j) issue_head(j);
  }

  load_dt(dts, dt, bi, t0, h0, ht, s, dsb, dss, dsh, tid, 256);
  __syncthreads();
  for (int j = warp; j < ht; j += 8)
    warp_cumsum64(dts + j * kL, A[h0 + j] * kLog2e, cum + j * kL, lane);
  __syncthreads();

  const ChunkArgs q{smem, dts, cum,
                    reinterpret_cast<float*>(smem + L::kDdt),
                    reinterpret_cast<float*>(smem + L::kU),
                    reinterpret_cast<float*>(smem + L::kDcl),
                    dx, s, h, ht, bi, h0, t0};

  // B Cᵀ (warpgroup 0, rows m) or C Bᵀ (warpgroup 1, rows l), once
  mbar_wait(bc_full, 0);
  const uint32_t b_base = smem_u32(smem + L::kB);
  const uint32_t c_base = smem_u32(smem + L::kC);
  float pair[kL / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_ss<0>(pair, BT::kmajor(wg == 0 ? b_base : c_base, 0, kk),
                BT::kmajor(wg == 0 ? c_base : b_base, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(pair);

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < ht; ++j) {
    const int slot = j % kSlots;
    mbar_wait(&head_full[slot], (j / kSlots) & 1);
    if (wg == 0)
      rows_m<N, P>(q, j, slot, pair, acc, tid);
    else
      rows_l<N, P>(q, j, slot, pair, acc, tid);
    __syncthreads();  // both warpgroups have read this slot
    if (tid == 0 && j + kSlots < ht) issue_head(j + kSlots);
  }

  const int nd = 4 * kSplit<N>;  // the sweeps' partials of <D, S>
  for (int j = warp; j < ht; j += 8)
    finish_head(q, j, A, dots, nd, ddt, dA_part,
                (static_cast<long long>(bi) * nc + c) * h + h0 + j, lane);

  // dB (warpgroup 0) or dC (warpgroup 1) of this head tile, in fp32
  const int part = blockIdx.x % ((h / g) / ht);
  float* out = (wg == 0 ? dB_part : dC_part) +
               ((static_cast<long long>(part) * b + bi) * s) * g * N +
               static_cast<long long>(gi) * N;
  const int g8 = lane / 4, t = lane % 4;
  const int r0 = 16 * (warp % 4) + g8, r1 = r0 + 8;
  const long long row_stride = static_cast<long long>(g) * N;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (t0 + r0 < s)
      *reinterpret_cast<float2*>(out + (t0 + r0) * row_stride + col) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
    if (t0 + r1 < s)
      *reinterpret_cast<float2*>(out + (t0 + r1) * row_stride + col) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// ------------------------------------------------------------ (3) sums
// dB and dC (blockIdx.y 0 and 1): the sum of `parts` fp32 partials of
// `count` values each, in order, into bf16 pairs.
__global__ void __launch_bounds__(256)
chunkscan_bwd_reduce_kernel(const float* __restrict__ dB_part,
                            const float* __restrict__ dC_part,
                            __nv_bfloat16* __restrict__ dB,
                            __nv_bfloat16* __restrict__ dC, long long count,
                            int parts) {
  const float* in = blockIdx.y == 0 ? dB_part : dC_part;
  __nv_bfloat16* out = blockIdx.y == 0 ? dB : dC;
  for (long long i = 2 * (static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x);
       i < count; i += 2LL * gridDim.x * blockDim.x) {
    float2 acc = *reinterpret_cast<const float2*>(in + i);
    for (int k = 1; k < parts; ++k) {
      const float2 v = *reinterpret_cast<const float2*>(in + k * count + i);
      acc.x += v.x;
      acc.y += v.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + i) =
        __floats2bfloat162_rn(acc.x, acc.y);
  }
}

// dA_h: the chunks' dt . da summed over batch and chunks, in order
__global__ void chunkscan_bwd_da_kernel(const float* __restrict__ dA_part,
                                        float* __restrict__ dA, int rows,
                                        int h) {
  const int hi = blockIdx.x * blockDim.x + threadIdx.x;
  if (hi >= h) return;
  float acc = 0.f;
  for (int r = 0; r < rows; ++r) acc += dA_part[static_cast<long long>(r) * h + hi];
  dA[hi] = acc;
}

// ------------------------------------------------------------- launches
inline long long align256(long long bytes) { return (bytes + 255) & ~255LL; }

struct Workspace {
  long long d32, s_bf, d_bf, dots, dA, dB, dC, total;
};

inline int chunk_heads(long long chunks, int h, int g, int target) {
  // the most heads (up to 16) that divide a group's heads while a grid of
  // `chunks` x h / ht blocks keeps `target` blocks
  int ht = kMaxHeads;
  while (ht > 1 && ((h / g) % ht || chunks * (h / ht) < target)) ht /= 2;
  return ht;
}

inline Workspace workspace_layout(int b, int s, int h, int p, int g, int n) {
  const long long nc = (s + kL - 1) / kL;
  const long long rows = static_cast<long long>(b) * nc * h;
  const long long vals = rows * p * n;
  const int parts = (h / g) / chunk_heads(b * nc, h, g, kChunkBlocks);
  const long long bc_vals = static_cast<long long>(b) * s * g * n;
  Workspace w;
  w.d32 = 0;  // the sweeps' register images: 64 rows at any p
  w.s_bf = w.d32 + align256(4 * rows * 64 * n);
  w.d_bf = w.s_bf + align256(2 * vals);
  w.dots = w.d_bf + align256(2 * vals);
  w.dA = w.dots + align256(4 * rows * 4 * (n > 64 ? n / 64 : 1));
  w.dB = w.dA + align256(4 * rows);
  w.dC = w.dB + align256(4 * parts * bc_vals);
  w.total = w.dC + align256(4 * parts * bc_vals);
  return w;
}

template <int N, int P>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* B, const void* C, const void* dy, void* dx,
                   float* ddt, float* dA, void* dB, void* dC, void* work,
                   int b, int s, int h, int g, const long long* st,
                   cudaStream_t stream) {
  const int nc = (s + kL - 1) / kL;
  auto nz = [](long long v, long long alt) { return v != 0 ? v : alt; };
  const Workspace w = workspace_layout(b, s, h, P, g, N);
  auto* base = static_cast<unsigned char*>(work);
  auto* d32 = reinterpret_cast<float*>(base + w.d32);
  auto* s_bf = reinterpret_cast<__nv_bfloat16*>(base + w.s_bf);
  auto* d_bf = reinterpret_cast<__nv_bfloat16*>(base + w.d_bf);
  auto* dots = reinterpret_cast<float*>(base + w.dots);
  auto* dA_part = reinterpret_cast<float*>(base + w.dA);
  auto* dB_part = reinterpret_cast<float*>(base + w.dB);
  auto* dC_part = reinterpret_cast<float*>(base + w.dC);

  CUtensorMap map_x, map_dy, map_b, map_c, map_s, map_d;
  cudaError_t err = encode_tile_map(&map_x, x, P, s, h, b, nz(st[0], P),
                                    nz(st[1], P), nz(st[2], P), kL);
  if (err == cudaSuccess)  // dy is (b, s, h, p) contiguous
    err = encode_tile_map(&map_dy, dy, P, s, h, b, 1LL * s * h * P,
                          1LL * h * P, P, kL);
  if (err == cudaSuccess)
    err = encode_tile_map(&map_b, B, N, s, g, b, nz(st[6], N), nz(st[7], N),
                          nz(st[8], N), kL);
  if (err == cudaSuccess)
    err = encode_tile_map(&map_c, C, N, s, g, b, nz(st[9], N), nz(st[10], N),
                          nz(st[11], N), kL);
  // S and D are (b nc, h, p, n)
  if (err == cudaSuccess)
    err = encode_tile_map(&map_s, s_bf, N, P, h, b * nc, 1LL * h * P * N, N,
                          1LL * P * N, P);
  if (err == cudaSuccess)
    err = encode_tile_map(&map_d, d_bf, N, P, h, b * nc, 1LL * h * P * N, N,
                          1LL * P * N, P);
  if (err != cudaSuccess) return err;

  // (1)
  {
    constexpr size_t smem = SweepSmem<N, P>::kDynamic;
    err = cudaFuncSetAttribute(chunkscan_bwd_sweep_kernel<N, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    chunkscan_bwd_sweep_kernel<N, P><<<dim3(h * kSplit<N>, b), 128, smem,
                                       stream>>>(
        map_x, map_dy, map_b, map_c, map_s, map_d, dt, A, d32, dots, s, h,
        g, nc, st[3], st[4], st[5]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // (2)
  const int ht = chunk_heads(1LL * b * nc, h, g, kChunkBlocks);
  {
    constexpr size_t smem = ChunkSmem<N, P>::kDynamic;
    err = cudaFuncSetAttribute(chunkscan_bwd_chunk_kernel<N, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    chunkscan_bwd_chunk_kernel<N, P><<<dim3(h / ht, nc, b), 256, smem,
                                       stream>>>(
        map_x, map_dy, map_b, map_c, map_s, map_d, dt, A, dots,
        static_cast<__nv_bfloat16*>(dx), ddt, dA_part, dB_part, dC_part, b, s,
        h, g, nc, ht, st[3], st[4], st[5]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // (3)
  const long long count = static_cast<long long>(b) * s * g * N;
  const long long pairs = count / 2;
  const int blocks = static_cast<int>(
      pairs / 256 + 1 < 1024 ? pairs / 256 + 1 : 1024);
  chunkscan_bwd_reduce_kernel<<<dim3(blocks, 2), 256, 0, stream>>>(
      dB_part, dC_part, static_cast<__nv_bfloat16*>(dB),
      static_cast<__nv_bfloat16*>(dC), count, (h / g) / ht);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunkscan_bwd_da_kernel<<<(h + 127) / 128, 128, 0, stream>>>(
      dA_part, dA, b * nc, h);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(int n, const void* x, const float* dt, const float* A,
                       const void* B, const void* C, const void* dy, void* dx,
                       float* ddt, float* dA, void* dB, void* dC, void* work,
                       int b, int s, int h, int g, const long long* st,
                       cudaStream_t stream) {
#define REPRO_SSD_BWD_CASE(N)                                                \
  case N:                                                                    \
    return launch<N, P>(x, dt, A, B, C, dy, dx, ddt, dA, dB, dC, work, b, s, \
                        h, g, st, stream);
  switch (n) {
    REPRO_SSD_BWD_CASE(16)
    REPRO_SSD_BWD_CASE(32)
    REPRO_SSD_BWD_CASE(64)
    REPRO_SSD_BWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SSD_BWD_CASE
}

}  // namespace

// Bytes of device workspace `repro_ssd_scan_bwd` needs for these shapes.
extern "C" long long repro_ssd_scan_bwd_workspace_bytes(int b, int s, int h,
                                                        int p, int g, int n) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || g <= 0 || n <= 0 || h % g)
    return 0;
  return workspace_layout(b, s, h, p, g, n).total;
}

// x, B, C, dy, dx, dB and dC in bf16; dt, A, ddt and dA in fp32. Strides
// are in elements: x (batch, seq, head), dt (batch, seq, head), B and C
// (batch, seq, group); the last dimension of x, B and C is contiguous; A,
// dy and the outputs are contiguous. `work` holds `work_bytes` bytes of
// device memory, at least `repro_ssd_scan_bwd_workspace_bytes`. Returns
// the cudaError_t of the launches.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* dy, void* dx, void* ddt, void* dA, void* dB,
    void* dC, void* work, long long work_bytes, int b, int s, int h, int p,
    int g, int n, long long xsb, long long xss, long long xsh, long long dsb,
    long long dss, long long dsh, long long bsb, long long bss,
    long long bsg, long long csb, long long css, long long csg,
    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || h <= 0 || g <= 0 || h % g || b > 65535 ||
      (s + kL - 1) / kL > 65535 ||
      work_bytes < repro_ssd_scan_bwd_workspace_bytes(b, s, h, p, g, n))
    return cudaErrorInvalidValue;
  const long long strides[12] = {xsb, xss, xsh, dsb, dss, dsh,
                                 bsb, bss, bsg, csb, css, csg};
  // x, B and C move as TMA boxes
  for (int i : {0, 1, 2, 6, 7, 8, 9, 10, 11})
    if (strides[i] % 8) return cudaErrorInvalidValue;
  for (const void* ptr : {x, B, C, dy})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  auto* dtf = static_cast<const float*>(dt);
  auto* af = static_cast<const float*>(A);
  auto* ddtf = static_cast<float*>(ddt);
  auto* dAf = static_cast<float*>(dA);
  if (p == 32)
    return dispatch_n<32>(n, x, dtf, af, B, C, dy, dx, ddtf, dAf, dB, dC,
                          work, b, s, h, g, strides, st);
  if (p == 64)
    return dispatch_n<64>(n, x, dtf, af, B, C, dy, dx, ddtf, dAf, dB, dC,
                          work, b, s, h, g, strides, st);
  return cudaErrorInvalidValue;
}
