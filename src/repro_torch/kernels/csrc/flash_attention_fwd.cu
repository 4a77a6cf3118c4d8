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
// What this design does about it (bf16): the Hopper shape of a fast
// kernel (machinery in hopper.cuh). One block owns one (batch, head,
// 128-query tile); query tiles are issued heaviest causal tile first.
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
// 64-column, 128B-swizzled boxes the other widths use, so its tiles are
// five 16-column boxes under the 32B swizzle (hopper.cuh,
// `tile_box_cols`): each box is one k-step of S = Q K^T, and P V runs as
// m64n80k16 with V's five boxes one LBO apart; O is 40 fp32 registers a
// thread. Its bound at hubert's encode (B=1, S=2048, 16/16 heads,
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

template <int HD>
struct FwdSmem {
  using QTile = Tile<HD, kFwdBlockM>;
  using KVTile = Tile<HD, kFwdBlockN>;
  static constexpr int kQ = 0;
  static constexpr int kK = QTile::kBytes;                       // + stage
  static constexpr int kV = kK + kFwdStages * KVTile::kBytes;    // + stage
  static constexpr int kBars = kV + kFwdStages * KVTile::kBytes;
  // q full, then kFwdStages full and kFwdStages empty barriers
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kFwdStages);
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
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err =
      encode_tile_map(&map_q, q, HD, Sq, H, B, q_sb, q_ss, q_sh, kFwdBlockM);
  if (err == cudaSuccess)
    err = encode_tile_map(&map_k, k, HD, Sk, KV, B, k_sb, k_ss, k_sh,
                          kFwdBlockN);
  if (err == cudaSuccess)
    err = encode_tile_map(&map_v, v, HD, Sk, KV, B, v_sb, v_ss, v_sh,
                          kFwdBlockN);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = FwdSmem<HD>::kDynamic;
  auto kern = flash_fwd_bf16_kernel<HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kFwdBlockM - 1) / kFwdBlockM, H, B);
  kern<<<grid, kFwdThreads, smem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), lse, H, H / KV,
      Sq, Sk, scale, causal);
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
