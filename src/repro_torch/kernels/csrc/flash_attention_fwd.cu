// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_fwd
// (Pallas body `_fwd_kernel`): blocked online-softmax attention, causal
// (top-left, kpos <= qpos) or bidirectional, GQA with query head h reading
// KV head h / G, mask value -1e30, an `l == 0` guard, fp32 logsumexp out.
//
// What bounds it on the H100: the score and value products. At the main
// path's prefill (B=1, S=2048, H=16, hd=128, causal) the kernel must do
// about 17 GFLOP against 25 MB of input and output, some 700 operations
// per byte, so the tensor-core rate (989 TFLOP/s bf16) is the bound, not
// memory (3.35 TB/s): 0.0174 ms.
//
// What this design does about it (bf16, head dim 128): the Hopper shape
// of a fast kernel (machinery in hopper.cuh). One block owns one (batch,
// head, 128-query tile); query tiles are issued heaviest causal tile
// first.
//  * A producer warp loads Q once and keeps a 2-stage ring of 128-key K
//    and V tiles full with TMA (tensor maps over the reference layout with
//    its own strides; zero fill past S handles ragged lengths), each stage
//    completing on a full mbarrier and released by an empty one, so loads
//    overlap the math.
//  * Two consumer warpgroups of 64 query rows each run S = Q K^T on
//    `wgmma` (A = Q and B = K from shared memory, both K-major), the
//    online softmax in registers on the accumulator layout (exp2 with
//    scale * log2(e) folded in; the mask is built only on the diagonal and
//    ragged last tiles), then O += P V on `wgmma` with P rounded to bf16 in
//    registers as the A operand (as the Pallas kernel casts p to v's dtype)
//    and V read MN-major through the transpose flag.
//  * `setmaxnreg` gives the producer 24 registers and the consumers up to
//    240 (hopper.cuh says what it buys); the consumers hold O (64 a thread
//    at hd=128), S (64) and P (32) in at most R165, with 0 spill bytes.
// The running max, sum and O stay in registers in fp32; key tiles wholly
// above the diagonal are never loaded. Tried and not kept: issuing the
// next tile's S = Q K^T while P V runs (ptxas serialized the wgmmas,
// warning C7514) and ping-pong turns of the two consumer warpgroups
// around their products (no gain in a trial run).
//
// Head dims 32, 64 and 80 (stablelm, granite-moe, zamba2; hubert-xlarge)
// have a schedule of their own, `flash_fwd_bf16_overlap_kernel`. What
// bounds them: not the products. At hd 80 a 128 x 128 tile's two products
// take about 0.7 us of the tensor cores, its 16,384 exps about 0.55 us of
// the MUFU (16 a clock an SM), yet the design above took 1.9 us a tile at
// hubert's encode (B=1, S=2048, 16/16 heads, bidirectional: 0.0671 ms,
// 1.17x SDPA's 0.0574 on an H100 80GB HBM3 at 700 W) and still 1.6 us
// with both products removed: the softmax's dependent chain ran after
// each product's wait in both warpgroups at once, a block's set-up and
// drain cost about 5 us over the 8.5 stages of an average causal tile,
// and hd 80's five 16-column boxes made the K/V ring half as fast per
// byte as hd 64's (PERF.md, the forward's split).
// What the schedule does about it:
//  * Persistent blocks, one an SM, walk the (tile, head, batch) items
//    heaviest causal tile first in a snake order; the producer loads the
//    next tile's Q as soon as the consumers hold this one's, and its K/V
//    ring runs on across tiles, so a tile's set-up overlaps the last one.
//  * Q lives in registers as the A fragments of S = Q K^T (read from
//    shared memory once a tile).
//  * A 128-key stage is two 64-key units a, b. A warpgroup issues the last
//    stage's O += P_b V, S_a and S_b together; the softmax of a runs while
//    S_b runs, that of b while O += P_a V runs. No product is in flight
//    across stages or branches: ptxas serializes the products otherwise
//    (C7518); the first stage is an instance of its own.
//  * The row max is taken of the raw scores and p = exp2(s * scale *
//    log2(e) - m) is one FFMA before the exp, with two partial maxima and
//    sums a row.
//  * hd 80's K and V are two 64-column boxes under the 128B swizzle, the
//    second zero-filled past column 80 (`encode_tile_map`'s wide box), in
//    a 3-stage ring (4 below hd 80).
// On an H100 80GB HBM3 at 700 W, in turns with the design above within one
// call, it took 22% less device time at hubert's encode and over 40% less at
// stablelm's training shape (B=2, 32/32 heads of 64, causal); chip_smoke.py
// then read 0.0525 ms (0.92x SDPA's 0.0568) and 0.0998 ms (1.02x SDPA's
// 0.0976): at hd 64 it is level with SDPA, not ahead (PERF.md, §6).
// Tried and not kept: the turns above (equal at hd 80, 4% slower on the
// causal hd-64 shapes); the next unit's S = Q K^T issued a step ahead into
// a second buffer across iterations (serialized, C7518: +36%); 128-key
// units (spilled); skipping the empty upper half of the causal diagonal's
// last unit (no gain); a 5-stage ring at hd 64 (no gain).
//
// The design it replaces (64-query tiles of 4 warps,
// synchronous loads with two __syncthreads per key tile, `mma.sync`
// m16n8k16, the mask built on every tile) took 0.3516 ms on the device
// (0.3533 ms per call) at the main shape, 6.6x SDPA's 0.0537 ms, on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md, kernel table).
//
// fp32 inputs run as fp32 FMAs on the CUDA cores (a bf16 or TF32 product
// would break the fp32 tolerance of 2e-5): Q, K, V and the probability
// tile in shared memory, 4x4 score and 4x(hd/16) output register tiles per
// thread, 64-query blocks.
//
// Head dim 80 (hubert-xlarge's encoder) is not a whole number of the
// 64-column, 128B-swizzled boxes the other widths use, so its Q tile is
// five 16-column boxes under the 32B swizzle (hopper.cuh,
// `tile_box_cols`), its K and V tiles two 64-column boxes (above); P V
// runs as m64n80k16 with V's boxes one LBO apart; O is 40 fp32 registers
// a thread. Its bound at hubert's encode (B=1, S=2048, 16/16 heads,
// bidirectional) is 4 H S^2 hd = 21.47 GFLOP, 0.0217 ms at 989 TFLOP/s.
// The fp32 path takes it as 5 output columns a thread (78.6 KB of shared
// memory).
//
// Ragged lengths are masked in the kernel. Head dims 32, 64, 80 and 128;
// out in the input dtype, lse in fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace repro_hopper;

constexpr int kBlockQ = 64;   // the fp32 kernel's tiles
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;  // the reference kernel's mask value

// ===================================================================== fp32
constexpr int kThreadsX = 16;   // lanes sharing one group of query rows
constexpr int kThreadsY = 16;
constexpr int kThreads32 = kThreadsX * kThreadsY;
constexpr int kRowsPerThread = kBlockQ / kThreadsY;   // 4
constexpr int kColsPerThread = kBlockK / kThreadsX;   // 4

// max / sum across the 16 lanes of a warp that share `ty` (lane bits 0-3)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kThreadsX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kThreadsX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes_fp32() {
  // Q and K rows padded by one float: 16 lanes read 16 different rows at
  // the same column, which would otherwise hit one bank.
  return sizeof(float) * (kBlockQ * (HD + 1) + kBlockK * (HD + 1) +
                          kBlockK * HD + kBlockQ * (kBlockK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads32)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int H, int G, int Sq, int Sk,
                      long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh,
                      float scale, int causal) {
  constexpr int LDQ = HD + 1, LDK = HD + 1, LDV = HD, LDP = kBlockK + 1;
  constexpr int DPT = HD / kThreadsX;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * LDQ;
  float* Vs = Ks + kBlockK * LDK;
  float* Ps = Vs + kBlockK * LDV;

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX, ty = tid / kThreadsX;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * kBlockQ;
  const int row0 = ty * kRowsPerThread;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + (h / G) * k_sh;
  const float* vb = v + b * v_sb + (h / G) * v_sh;

  // Q tile, pre-multiplied by the softmax scale; rows past Sq are zero
  for (int e = tid; e < kBlockQ * HD; e += kThreads32) {
    const int r = e / HD, c = e % HD, qi = q0 + r;
    Qs[r * LDQ + c] = qi < Sq ? qb[qi * q_ss + c] * scale : 0.f;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][DPT];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last query are masked for every row
  const int k_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  const int nk = (k_end + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBlockK * HD; e += kThreads32) {
      const int r = e / HD, c = e % HD, ki = k0 + r;
      const bool ok = ki < Sk;
      Ks[r * LDK + c] = ok ? kb[ki * k_ss + c] : 0.f;
      Vs[r * LDV + c] = ok ? vb[ki * v_ss + c] : 0.f;
    }
    __syncthreads();

    // scores: rows row0..row0+3, columns tx + 16 j
    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = Qs[(row0 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        kv[j] = Ks[(tx + j * kThreadsX) * LDK + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int qi = q0 + row0 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int kj = k0 + tx + j * kThreadsX;
        const bool valid = kj < Sk && (!causal || kj <= qi);
        s[i][j] = valid ? s[i][j] : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(rmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int kj = k0 + tx + j * kThreadsX;
        // keys past Sk do not exist; causally masked ones weigh
        // exp(-1e30 - m) as in the reference kernel
        const float p = kj < Sk ? expf(s[i][j] - m_new) : 0.f;
        rsum += p;
        Ps[(row0 + i) * LDP + tx + j * kThreadsX] = p;
      }
      l[i] = l[i] * alpha + group_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V: rows row0..row0+3, columns tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float vv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = Vs[kk * LDV + tx + c * kThreadsX];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float p = Ps[(row0 + i) * LDP + kk];
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  // out is (B, Sq, H, hd) contiguous, lse (B, H, Sq)
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    float* ob = out + ((static_cast<long long>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < DPT; ++c) ob[tx + c * kThreadsX] = acc[i][c] / l_safe;
    if (tx == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qi] = m[i] + logf(l_safe);
  }
}

// ===================================================================== bf16
// One block: consumer warpgroups 0 and 1 (64 query rows each) and
// producer warpgroup 2 (one warp issues TMA, the rest idle).
constexpr int kFwdBlockM = 128;
constexpr int kFwdBlockN = 128;
constexpr int kFwdStages = 2;
constexpr int kFwdThreads = 384;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, int STAGES = kFwdStages, int KV_COLS = HD>
struct FwdSmem {
  using QTile = Tile<HD, kFwdBlockM>;
  using KVTile = Tile<KV_COLS, kFwdBlockN>;
  static constexpr int kQ = 0;
  static constexpr int kK = QTile::kBytes;                   // + stage
  static constexpr int kV = kK + STAGES * KVTile::kBytes;    // + stage
  static constexpr int kBars = kV + STAGES * KVTile::kBytes;
  // q full, STAGES full and STAGES empty barriers, q empty
  static constexpr int kBytes = kBars + 8 * (2 + 2 * STAGES);
  static constexpr size_t kDynamic = kBytes + 1024;  // for the alignment
};

template <int HD>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                      int H, int G, int Sq, int Sk, float scale, int causal) {
  using L = FwdSmem<HD>;
  using QTile = typename L::QTile;
  using KVTile = typename L::KVTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kFwdStages;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * kFwdBlockM;
  // causal: keys past the tile's last query are masked for every row
  const int k_end = causal ? min(Sk, q0 + kFwdBlockM) : Sk;
  const int nk = (k_end + kFwdBlockN - 1) / kFwdBlockN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (warp == 0 && lane == 0) {
      mbar_arrive_expect_tx(q_full, QTile::kBytes);
      QTile::load(smem + L::kQ, &map_q, q_full, q0, h, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kFwdStages;
        mbar_wait(&empty[s], ((kt / kFwdStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * KVTile::kBytes);
        KVTile::load(smem + L::kK + s * KVTile::kBytes, &map_k, &full[s],
                     kt * kFwdBlockN, h / G, b);
        KVTile::load(smem + L::kV + s * KVTile::kBytes, &map_v, &full[s],
                     kt * kFwdBlockN, h / G, b);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  setmaxnreg_inc<240>();
  const int c = wg;  // rows 64 c .. 64 c + 63 of the query tile
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + 64 * c;  // this warpgroup's first query
  const int qr0 = row_lo + 16 * warp + g, qr1 = qr0 + 8;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_base = smem_u32(smem + L::kQ);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  // running max (log2 domain, scaled) and this lane's part of the sum
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kFwdStages;
    const int k0 = kt * kFwdBlockN;
    mbar_wait(&full[s], (kt / kFwdStages) & 1);
    const uint32_t k_base = smem_u32(smem + L::kK + s * KVTile::kBytes);
    const uint32_t v_base = smem_u32(smem + L::kV + s * KVTile::kBytes);

    // S = Q K^T: 64 x kFwdBlockN
    float sc[kFwdBlockN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<0>(sc, QTile::kmajor(q_base, 64 * c, kk),
                  KVTile::kmajor(k_base, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scale into the log2 domain; mask only the diagonal and ragged tiles.
    // sc[4j + e] is (row e < 2 ? qr0 : qr1, key k0 + 8j + 2t + (e & 1)).
    const bool need_mask = (causal && k0 + kFwdBlockN - 1 > row_lo) ||
                           k0 + kFwdBlockN > Sk;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kFwdBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (need_mask) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? qr0 : qr1;
          // keys past Sk do not exist and weigh 0; causally masked ones
          // weigh exp(-1e30 - m) as in the reference kernel
          x = key >= Sk ? -INFINITY : (causal && key > row ? kNegInf : x);
        }
        sc[4 * j + e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = fast_exp2(m0 - mn0), a1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kFwdBlockN / 8; ++j) {
      sc[4 * j] = fast_exp2(sc[4 * j] - mn0);
      sc[4 * j + 1] = fast_exp2(sc[4 * j + 1] - mn0);
      sc[4 * j + 2] = fast_exp2(sc[4 * j + 2] - mn1);
      sc[4 * j + 3] = fast_exp2(sc[4 * j + 3] - mn1);
      rs0 += sc[4 * j] + sc[4 * j + 1];
      rs1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }

    // O += P V: P (rounded to bf16, as the reference casts p to v's dtype)
    // stays in registers as the A operand; V is MN-major
    uint32_t pa[kFwdBlockN / 16][4];
    to_a_frags(pa, sc);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdBlockN / 16; ++kk)
      wgmma_rs<1>(o, pa[kk], KVTile::mnmajor(v_base, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // out is (B, Sq, H, hd) contiguous, lse (B, H, Sq)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
  constexpr float kLn2 = 0.6931471805599453f;
  if (qr0 < Sq) {
    __nv_bfloat16* ob = out + ((static_cast<long long>(b) * Sq + qr0) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (t == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qr0] = m0 * kLn2 + logf(ls0);
  }
  if (qr1 < Sq) {
    __nv_bfloat16* ob = out + ((static_cast<long long>(b) * Sq + qr1) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    if (t == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qr1] = m1 * kLn2 + logf(ls1);
  }
}

// ----------------------------------------------------- bf16, hd <= 80
// The schedule for head dims 32, 64 and 80 (the file's header says why).

// Columns of the K and V tiles in shared memory: hd, or at hd 80 two
// 64-column boxes under the 128B swizzle, the second filled with zeros
// past column 80 by TMA (so each row is read as 160 bytes, not as five
// 32-byte pieces); the depth of their ring.
__host__ __device__ constexpr int kv_cols(int hd) {
  return hd > 64 && hd % 64 != 0 ? (hd + 63) / 64 * 64 : hd;
}
__host__ __device__ constexpr int small_stages(int hd) {
  return kv_cols(hd) > 64 ? 3 : 4;
}

// The t-th (iq, h, b) tile of this persistent block, false past the
// last: rounds of gridDim.x tiles, heaviest causal tiles first, alternate
// rounds taken in reverse (a snake) to even out the blocks' work.
__device__ __forceinline__ bool fwd_tile(int t, int nq, int H, int B, int& iq,
                                         int& h, int& b) {
  const int G = gridDim.x;
  const int i = t * G + ((t & 1) ? G - 1 - blockIdx.x : blockIdx.x);
  if (i >= nq * H * B) return false;
  iq = nq - 1 - i / (H * B);
  h = i % (H * B) % H;
  b = i % (H * B) / H;
  return true;
}

template <int HD>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_bf16_overlap_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ lse, int B, int H, int G,
                              int Sq, int Sk, float scale, int causal) {
  constexpr int S = small_stages(HD);
  constexpr int UN = kFwdBlockN / 2;  // keys a unit: two units a stage
  static_assert(HD <= 80, "the hd <= 80 schedule");
  using L = FwdSmem<HD, S, kv_cols(HD)>;
  using QTile = typename L::QTile;
  using KVTile = typename L::KVTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;
  uint64_t* q_empty = bars + 1 + 2 * S;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int nq = (Sq + kFwdBlockM - 1) / kFwdBlockM;
  // causal: keys past the tile's last query are masked for every row
  auto stages_of = [&](int iq) {
    const int k_end = causal ? min(Sk, (iq + 1) * kFwdBlockM) : Sk;
    return (k_end + kFwdBlockN - 1) / kFwdBlockN;
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (warp == 0 && lane == 0) {
      int iq, h, b, g = 0;  // g: the ring's running stage
      for (int t = 0; fwd_tile(t, nq, H, B, iq, h, b); ++t) {
        if (t > 0) mbar_wait(q_empty, (t - 1) & 1);
        mbar_arrive_expect_tx(q_full, QTile::kBytes);
        QTile::load(smem + L::kQ, &map_q, q_full, iq * kFwdBlockM, h, b);
        for (int kt = 0, nk = stages_of(iq); kt < nk; ++kt, ++g) {
          const int s = g % S;
          mbar_wait(&empty[s], ((g / S) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], 2 * KVTile::kBytes);
          KVTile::load(smem + L::kK + s * KVTile::kBytes, &map_k, &full[s],
                       kt * kFwdBlockN, h / G, b);
          KVTile::load(smem + L::kV + s * KVTile::kBytes, &map_v, &full[s],
                       kt * kFwdBlockN, h / G, b);
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  setmaxnreg_inc<240>();
  const int c = wg;  // rows 64 c .. 64 c + 63 of the query tile
  const int g = lane / 4, t = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_base = smem_u32(smem + L::kK);
  const uint32_t v_base = smem_u32(smem + L::kV);

  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st % S]);
  };

  float o[HD / 2];
  // running max (log2 domain, scaled), this lane's part of the sum, and
  // the last unit's rescale of O
  float m0, m1, l0, l1, a0, a1;
  float sa[UN / 2], sb[UN / 2];  // a stage's two units of scores
  uint32_t pa[UN / 16][4];
  uint32_t qa[HD / 16][4];  // this warp's rows of Q, as A fragments
  int row_lo, qr0, qr1, g0 = 0;  // g0: the ring's stage of the tile's first

  // S = Q K^T for unit u (key u * UN on) of ring stage st
  auto issue_s = [&](float (&sc)[UN / 2], int st, int u) {
    const uint32_t kb = k_base + (st % S) * KVTile::kBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_rs<0>(sc, qa[kk], KVTile::kmajor(kb, UN * (u & 1), kk), kk > 0);
    wgmma_commit();
  };
  // O += P V for unit u of ring stage st: P (rounded to bf16, as the
  // reference casts p to v's dtype) stays in registers as the A operand;
  // V is MN-major
  auto issue_pv = [&](int st, int u) {
    const uint32_t vb = v_base + (st % S) * KVTile::kBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < UN / 16; ++kk)
      wgmma_rs<1>(o, pa[kk], KVTile::mnmajor(vb, (UN / 16) * (u & 1) + kk),
                  1);
    wgmma_commit();
  };
  // the online softmax of unit u's scores, in place: the row max of the
  // raw scores, then p = exp2(s * scale_log2 - m) with one FFMA before
  // the exp; a0, a1 rescale O before the previous unit's P V.
  // sc[4j + e] is (row e < 2 ? qr0 : qr1, key k0 + 8j + 2t + (e & 1)).
  auto softmax = [&](float (&sc)[UN / 2], int u) {
    const int k0 = u * UN;
    // mask only the diagonal and ragged units: keys past Sk do not exist
    // and weigh 0; causally masked ones weigh exp(-1e30 - m) as in the
    // reference kernel
    if ((causal && k0 + UN - 1 > row_lo) || k0 + UN > Sk) {
#pragma unroll
      for (int j = 0; j < UN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? qr0 : qr1;
          sc[4 * j + e] = key >= Sk ? -INFINITY
                          : causal && key > row ? kNegInf : sc[4 * j + e];
        }
    }
    // two partial maxima and sums a row halve the dependent chains
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < UN / 8; ++j) {
      mx[2 * (j & 1)] = fmaxf(mx[2 * (j & 1)], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[2 * (j & 1) + 1] =
          fmaxf(mx[2 * (j & 1) + 1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(fmaxf(mx[0], mx[2])) * scale_log2);
    const float mn1 = fmaxf(m1, quad_max(fmaxf(mx[1], mx[3])) * scale_log2);
    a0 = fast_exp2(m0 - mn0);
    a1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < UN / 8; ++j) {
      sc[4 * j] = fast_exp2(fmaf(sc[4 * j], scale_log2, -mn0));
      sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -mn0));
      sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -mn1));
      sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -mn1));
      rs[2 * (j & 1)] += sc[4 * j] + sc[4 * j + 1];
      rs[2 * (j & 1) + 1] += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * a0 + (rs[0] + rs[2]);
    l1 = l1 * a1 + (rs[1] + rs[3]);
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
  };
  // Stage kt of the tile (units a = 2 kt and b = 2 kt + 1), no product in
  // flight across stages or branches (ptxas would serialize the products,
  // C7518): a warpgroup issues the last stage's O += P_b V (none in the
  // first stage, an instance of its own), then this stage's S_a and S_b;
  // the softmax of a runs while S_b does, that of b while O += P_a V does.
  auto stage = [&](int kt, auto first) {
    constexpr bool kFirst = decltype(first)::value;
    const int st = g0 + kt;
    mbar_wait(&full[st % S], (st / S) & 1);
    if constexpr (!kFirst) {
      rescale_o();
      issue_pv(st - 1, 2 * kt - 1);
    }
    issue_s(sa, st, 2 * kt);
    issue_s(sb, st, 2 * kt + 1);
    wgmma_wait<1>();
    fence_regs(sa);
    fence_regs(o);
    softmax(sa, 2 * kt);
    to_a_frags(pa, sa);
    rescale_o();
    issue_pv(st, 2 * kt);
    wgmma_wait<1>();
    fence_regs(sb);
    softmax(sb, 2 * kt + 1);
    wgmma_wait<0>();
    fence_regs(o);
    to_a_frags(pa, sb);
    if constexpr (!kFirst) release(st - 1);
  };

  // (the next tile is found at the start of each: so scheduled by ptxas,
  // hubert-xlarge's encode took 0.0522 ms on the H100 against 0.0570
  // with fwd_tile in the loop's test)
  int iq, h, b;
  bool more = fwd_tile(0, nq, H, B, iq, h, b);
  for (int tile = 0; more; ++tile) {
    const int q0 = iq * kFwdBlockM, nk = stages_of(iq);
    int iq_next, h_next, b_next;
    more = fwd_tile(tile + 1, nq, H, B, iq_next, h_next, b_next);
    row_lo = q0 + 64 * c;  // this warpgroup's first query
    qr0 = row_lo + 16 * warp + g;
    qr1 = qr0 + 8;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    m0 = m1 = kNegInf;
    l0 = l1 = a0 = a1 = 0.f;

    // this warp's 16 rows of Q as the A fragments of HD / 16 k-steps;
    // then the producer may load the next tile's Q
    mbar_wait(q_full, tile & 1);
    const int r = 64 * c + 16 * warp + g;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 16 * kk + 2 * t + 8 * (i >> 1);
        qa[kk][i] = *reinterpret_cast<const uint32_t*>(
            smem + L::kQ + (col / QTile::kBoxCols) * QTile::kBoxBytes +
            swizzled<QTile::kRowBytes>(r + 8 * (i & 1),
                                       2 * (col % QTile::kBoxCols)));
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty);

    stage(0, std::true_type{});
    for (int kt = 1; kt < nk; ++kt) stage(kt, std::false_type{});
    rescale_o();
    issue_pv(g0 + nk - 1, 2 * nk - 1);
    wgmma_wait<0>();
    fence_regs(o);
    release(g0 + nk - 1);
    g0 += nk;

    // out is (B, Sq, H, hd) contiguous, lse (B, H, Sq)
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
    const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
    constexpr float kLn2 = 0.6931471805599453f;
    if (qr0 < Sq) {
      __nv_bfloat16* ob =
          out + ((static_cast<long long>(b) * Sq + qr0) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (t == 0)
        lse[(static_cast<long long>(b) * H + h) * Sq + qr0] =
            m0 * kLn2 + logf(ls0);
    }
    if (qr1 < Sq) {
      __nv_bfloat16* ob =
          out + ((static_cast<long long>(b) * Sq + qr1) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      if (t == 0)
        lse[(static_cast<long long>(b) * H + h) * Sq + qr1] =
            m1 * kLn2 + logf(ls1);
    }
    iq = iq_next;
    h = h_next;
    b = b_next;
  }
}

// =================================================================== launch
template <int HD>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* out,
                        float* lse, int B, int Sq, int Sk, int H, int KV,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_fp32<HD>();
  auto kern = flash_fwd_fp32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  kern<<<grid, kThreads32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, H / KV,
      Sq, Sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
      causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out,
                        float* lse, int B, int Sq, int Sk, int H, int KV,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale, int causal, cudaStream_t stream) {
  // hd <= 80: the overlapped schedule, hd 80's K and V in 64-column boxes
  constexpr bool wide_kv = HD <= 80 && kv_cols(HD) != HD;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err =
      encode_tile_map(&map_q, q, HD, Sq, H, B, q_sb, q_ss, q_sh, kFwdBlockM);
  if (err == cudaSuccess)
    err = encode_tile_map(&map_k, k, HD, Sk, KV, B, k_sb, k_ss, k_sh,
                          kFwdBlockN, wide_kv);
  if (err == cudaSuccess)
    err = encode_tile_map(&map_v, v, HD, Sk, KV, B, v_sb, v_ss, v_sh,
                          kFwdBlockN, wide_kv);
  if (err != cudaSuccess) return err;
  const int nq = (Sq + kFwdBlockM - 1) / kFwdBlockM;
  if constexpr (HD <= 80) {
    constexpr size_t smem =
        FwdSmem<HD, small_stages(HD), kv_cols(HD)>::kDynamic;
    auto kern = flash_fwd_bf16_overlap_kernel<HD>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int dev, sms;  // one block an SM, or one a tile if fewer
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    kern<<<min(nq * H * B, sms), kFwdThreads, smem, stream>>>(
        map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), lse, B, H,
        H / KV, Sq, Sk, scale, causal);
  } else {
    constexpr size_t smem = FwdSmem<HD>::kDynamic;
    auto kern = flash_fwd_bf16_kernel<HD>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<dim3(nq, H, B), kFwdThreads, smem, stream>>>(
        map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), lse, H,
        H / KV, Sq, Sk, scale, causal);
  }
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int Sq, int Sk, int H,
                        int KV, long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale, int causal, cudaStream_t stream) {
#define REPRO_FA_CASE(HD)                                                     \
  case HD:                                                                    \
    return (BF16 ? launch_bf16<HD> : launch_fp32<HD>)(                        \
        q, k, v, out, lse, B, Sq, Sk, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss,    \
        k_sh, v_sb, v_ss, v_sh, scale, causal, stream);
  switch (hd) {
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(80)
    REPRO_FA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FA_CASE
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. q (B,Sq,H,hd), k/v (B,Sk,KV,hd) with the
// given element strides (the head_dim stride must be 1; for bf16, which
// loads through TMA tensor maps, every other stride a multiple of 8
// elements and the pointers 16-byte aligned); out (B,Sq,H,hd) contiguous
// in the input dtype; lse (B,H,Sq) fp32. Returns the cudaError_t of the
// launch.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int dtype, int B, int Sq, int Sk, int H, int KV, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (causal && Sq != Sk))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* lse_f = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_hd<false>(hd, q, k, v, out, lse_f, B, Sq, Sk, H, KV, q_sb,
                              q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                              scale, causal, st);
  if (dtype == 1) {
    const long long strides[] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                 v_sb, v_ss, v_sh};
    for (long long s : strides)
      if (s % 8) return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v)) % 16)
      return cudaErrorMisalignedAddress;
    return dispatch_hd<true>(hd, q, k, v, out, lse_f, B, Sq, Sk, H, KV, q_sb,
                             q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                             scale, causal, st);
  }
  return cudaErrorInvalidValue;
}
