// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_bwd
// (Pallas bodies `_bwd_dq_kernel` and `_bwd_dkv_kernel`). With the forward's
// logsumexp `lse` and `delta = rowsum(dO * out)` (computed here by a small
// kernel, as XLA computed it beside the Pallas calls in the reference),
// each (query, key) pair recomputes
//     p  = exp(q.k * scale - lse)        (0 where masked: causal top-left,
//                                         keys past Sk, queries past Sq)
//     dp = dO.v
//     ds = p * (dp - delta) * scale
// and the gradients are dq = ds K, dk = ds^T Q, dv = p^T dO, with dk and dv
// summed over the G = H / KV query heads that share a KV head (GQA).
//
// What bounds it on the H100: the five products (q.k, dO.v, ds K, ds^T Q,
// p^T dO). At the training shape (B=2, S=2048, H=16, hd=128, causal) they
// are 10 * hd * pairs * H * B = 86 GFLOP against about 100 MB of inputs and
// outputs, so the tensor-core rate (989 TFLOP/s bf16) is the bound:
// 0.0869 ms.
//
// What this design does about it: three kernels, none with atomics, so the
// gradients are deterministic and dk/dv are summed over the GQA group
// inside the kernel.
//  * delta: 16-byte loads of dO and out, 16 lanes a row at hd = 128, fp32
//    sums; bound by its bytes (33.8 MB at the training shape: 0.0101 ms).
//  * dq: one block per (batch, head, 128-query tile) with Q and dO loaded
//    once and K, V streamed in 64-key tiles up to the diagonal; S = Q K^T,
//    dP = dO V^T and dQ += dS K on `wgmma`.
//  * dk/dv: one block per (batch, KV head, 64-key tile) with K and V
//    resident; Q, dO, lse and delta tiles of 64 queries stream through a
//    3-stage ring for each of the G query heads and each query tile from
//    the diagonal down. The two consumer warpgroups share the block's keys
//    and split the four products: warpgroup 0 runs S^T = K Q^T and
//    dV += P^T dO, warpgroup 1 dP^T = V dO^T and dK += dS^T Q, with P^T
//    handed over in fp32 through shared memory under two named barriers.
//    Each thread then holds one 64 x hd accumulator, not two, and the
//    consumers stay within R165. One warpgroup holding dK and dV for its
//    own 64 keys (128 a block) and running all four products spilled
//    1,148 bytes at hd = 128 although `setmaxnreg` granted its consumers
//    240 registers (ptxas allocated up to R192, then spilled), and took
//    0.665 ms against this design's 0.22 ms at the training shape (NVIDIA
//    H100 80GB HBM3, 700 W; PERF.md).
// bf16 inputs (hopper.cuh): a producer warp keeps the ring full with TMA
// (tensor maps over the reference layout; zero fill past S handles ragged
// lengths) on full/empty mbarriers; two consumer warpgroups of 64 rows
// each run the products, A and B from shared memory for the score
// products and the bf16-rounded P^T, dS^T (dS) from the accumulators in
// registers as the A operand of the gradient products (a deliberate
// difference, ROADMAP: the Pallas backward's products are fp32, since it
// casts ds to k's dtype after k became fp32), the MN-major B through the
// transpose flag; `setmaxnreg` as in the forward. q.k and dO.v are
// computed in both kernels: the two-pass design executes 14 of the 10
// units of product work (1.4x the bound's count).
//
// The design it replaces (64-row tiles of 4 warps, synchronous
// loads, `mma.sync` m16n8k16 on 32-column halves of each tile, delta in
// three PyTorch ops) took 1.3493 ms on the device (dq 0.6554 + dk/dv
// 0.6939; 1.3841 ms per call) at the training shape, 3.5x SDPA's backward
// (0.3955 ms), on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (PERF.md, kernel table).
//
// fp32 inputs run as fp32 FMAs on the CUDA cores (the 3e-4 gradient
// tolerance rules out bf16 or TF32 products): tiles in padded shared
// memory, 4x4 score register tiles per thread, 64-row tiles.
//
// Head dim 80 (hubert-xlarge) tiles as the forward does: five 16-column
// TMA boxes under the 32B swizzle (hopper.cuh), the score products over
// five K-major k-steps, and the gradient products dQ += dS K, dV += P^T dO
// and dK += dS^T Q as m64n80k16 with A from registers (40 accumulator
// registers a thread); no product takes an 80-wide A from shared memory.
//
// Ragged lengths are masked in the kernels. Head dims 32, 64, 80 and 128;
// causal needs Sq == Sk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace repro_hopper;

constexpr int kBlock = 64;  // query and key tile

// ===================================================================== fp32
constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kThreads32 = kThreadsX * kThreadsY;
constexpr int kRows = kBlock / kThreadsY;  // rows per thread: 4
constexpr int kCols = kBlock / kThreadsX;  // score columns per thread: 4
constexpr int kLDS = kBlock + 1;           // pitch of a score tile

// rows r0.. of a (rows, HD) fp32 matrix into a tile of pitch HD + 1; rows
// past n are zero
template <int HD>
__device__ __forceinline__ void load_tile_fp32(float* dst, const float* src,
                                               int r0, int n, long long stride,
                                               int tid) {
  for (int e = tid; e < kBlock * HD; e += kThreads32) {
    const int r = e / HD, c = e % HD;
    dst[r * (HD + 1) + c] = r0 + r < n ? src[(r0 + r) * stride + c] : 0.f;
  }
}

template <int HD>
constexpr size_t smem_dq_fp32() {
  return sizeof(float) * (4 * kBlock * (HD + 1) + kBlock * kLDS);
}

template <int HD>
__global__ void __launch_bounds__(kThreads32)
flash_bwd_dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq,
                         int H, int G, int Sq, int Sk,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         float scale, int causal) {
  constexpr int LD = HD + 1, DPT = HD / kThreadsX;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBlock * LD;
  float* Ks = dOs + kBlock * LD;
  float* Vs = Ks + kBlock * LD;
  float* dSs = Vs + kBlock * LD;

  const int tid = threadIdx.x, tx = tid % kThreadsX, ty = tid / kThreadsX;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * kBlock, row0 = ty * kRows;
  const float* kb = k + b * k_sb + (h / G) * k_sh;
  const float* vb = v + b * v_sb + (h / G) * v_sh;
  load_tile_fp32<HD>(Qs, q + b * q_sb + h * q_sh, q0, Sq, q_ss, tid);
  load_tile_fp32<HD>(dOs, dout + b * o_sb + h * o_sh, q0, Sq, o_ss, tid);

  const long long bh = (static_cast<long long>(b) * H + h) * Sq;
  float lse_r[kRows], del_r[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + row0 + i;
    lse_r[i] = qi < Sq ? lse[bh + qi] : 0.f;
    del_r[i] = qi < Sq ? delta[bh + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + kBlock) : Sk;
  const int nk = (k_end + kBlock - 1) / kBlock;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's readers are done
    load_tile_fp32<HD>(Ks, kb, k0, Sk, k_ss, tid);
    load_tile_fp32<HD>(Vs, vb, k0, Sk, v_ss, tid);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], ov[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = Qs[(row0 + i) * LD + d];
        ov[i] = dOs[(row0 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = Ks[(tx + j * kThreadsX) * LD + d];
        vv[j] = Vs[(tx + j * kThreadsX) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + row0 + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + j * kThreadsX;
        const bool valid = qi < Sq && kj < Sk && (!causal || kj <= qi);
        const float p = valid ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dSs[(row0 + i) * kLDS + tx + j * kThreadsX] =
            p * (dp[i][j] - del_r[i]) * scale;
      }
    }
    __syncthreads();

    // dq += dS K: rows row0..row0+3, columns tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      float kv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) kv[c] = Ks[kk * LD + tx + c * kThreadsX];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float ds = dSs[(row0 + i) * kLDS + kk];
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= Sq) continue;
    float* out = dq + ((static_cast<long long>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < DPT; ++c) out[tx + c * kThreadsX] = acc[i][c];
  }
}

template <int HD>
constexpr size_t smem_dkv_fp32() {
  return sizeof(float) * (4 * kBlock * (HD + 1) + 2 * kBlock * kLDS +
                          2 * kBlock);
}

template <int HD>
__global__ void __launch_bounds__(kThreads32)
flash_bwd_dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, int H, int G, int Sq, int Sk,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          long long o_sb, long long o_ss, long long o_sh,
                          float scale, int causal) {
  constexpr int LD = HD + 1, DPT = HD / kThreadsX;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlock * LD;
  float* Qs = Vs + kBlock * LD;
  float* dOs = Qs + kBlock * LD;
  float* Ps = dOs + kBlock * LD;    // p^T: (key, query)
  float* dSs = Ps + kBlock * kLDS;  // ds^T
  float* lse_s = dSs + kBlock * kLDS;
  float* del_s = lse_s + kBlock;

  const int tid = threadIdx.x, tx = tid % kThreadsX, ty = tid / kThreadsX;
  const int ik = blockIdx.x;  // the first key tiles see the most queries
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int KV = H / G;
  const int k0 = ik * kBlock, row0 = ty * kRows;
  load_tile_fp32<HD>(Ks, k + b * k_sb + kvh * k_sh, k0, Sk, k_ss, tid);
  load_tile_fp32<HD>(Vs, v + b * v_sb + kvh * v_sh, k0, Sk, v_ss, tid);

  float dk_acc[kRows][DPT], dv_acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (Sq + kBlock - 1) / kBlock;
  const int q_first = causal ? ik : 0;  // tiles above the diagonal add 0
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* qb = q + b * q_sb + h * q_sh;
    const float* ob = dout + b * o_sb + h * o_sh;
    const long long bh = (static_cast<long long>(b) * H + h) * Sq;
    for (int qt = q_first; qt < nq; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();  // the previous tile's readers are done
      load_tile_fp32<HD>(Qs, qb, q0, Sq, q_ss, tid);
      load_tile_fp32<HD>(dOs, ob, q0, Sq, o_ss, tid);
      if (tid < kBlock) {
        lse_s[tid] = q0 + tid < Sq ? lse[bh + q0 + tid] : 0.f;
        del_s[tid] = q0 + tid < Sq ? delta[bh + q0 + tid] : 0.f;
      }
      __syncthreads();

      // s^T, dp^T: key rows row0..row0+3, query columns tx + 16 j
      float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[kRows], vv[kRows], qv[kCols], ov[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kv[i] = Ks[(row0 + i) * LD + d];
          vv[i] = Vs[(row0 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qv[j] = Qs[(tx + j * kThreadsX) * LD + d];
          ov[j] = dOs[(tx + j * kThreadsX) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int ki = k0 + row0 + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = tx + j * kThreadsX, qj = q0 + c;
          const bool valid = qj < Sq && ki < Sk && (!causal || ki <= qj);
          const float p = valid ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
          Ps[(row0 + i) * kLDS + c] = p;
          dSs[(row0 + i) * kLDS + c] = p * (dp[i][j] - del_s[c]) * scale;
        }
      }
      __syncthreads();

      // dv += p^T dO, dk += ds^T Q: key rows row0..row0+3, columns tx + 16 c
#pragma unroll 4
      for (int qq = 0; qq < kBlock; ++qq) {
        float ov[DPT], qv[DPT];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          ov[c] = dOs[qq * LD + tx + c * kThreadsX];
          qv[c] = Qs[qq * LD + tx + c * kThreadsX];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = Ps[(row0 + i) * kLDS + qq];
          const float ds = dSs[(row0 + i) * kLDS + qq];
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            dv_acc[i][c] = fmaf(p, ov[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds, qv[c], dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int ki = k0 + row0 + i;
    if (ki >= Sk) continue;
    const long long off = ((static_cast<long long>(b) * Sk + ki) * KV + kvh) * HD;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dk[off + tx + c * kThreadsX] = dk_acc[i][c];
      dv[off + tx + c * kThreadsX] = dv_acc[i][c];
    }
  }
}


// ==================================================================== delta
// the dot product of kVec elements of dO and out: one 16-byte load of
// each for bf16 (the bf16 entry takes only 16-byte-aligned tensors with
// strides of 8 elements), one element for fp32 (which takes any strides)
template <typename T>
constexpr int kVec = sizeof(T) == 2 ? 8 : 1;

__device__ __forceinline__ float dot_vec(const float* o, const float* u) {
  return o[0] * u[0];
}
__device__ __forceinline__ float dot_vec(const __nv_bfloat16* o,
                                         const __nv_bfloat16* u) {
  const uint4 a = *reinterpret_cast<const uint4*>(o);
  const uint4 c = *reinterpret_cast<const uint4*>(u);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&c);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    acc += fx.x * fy.x;
    acc += fx.y * fy.y;
  }
  return acc;
}

// the largest power of two not above n (n >= 1)
constexpr int floor_pow2(int n) { return n >= 2 ? 2 * floor_pow2(n / 2) : 1; }

// delta[b, h, s] = sum_d dO[b, s, h, d] * out[b, s, h, d], fp32, in a
// fixed summation order. A row takes kLanes lanes, each reading kVec
// elements a load and striding by kLanes loads: the largest power of two
// not above the row's loads or 32 (16 at hd = 128 in bf16; 8 at hd = 80,
// whose ten loads lanes 0-1 take two of; 32 in fp32), so a row's lanes are
// one aligned group of a warp and the xor shuffles stay inside it (ten
// lanes a row would mix rows and cross warps). A block of 256 threads
// takes 256 / kLanes rows. It moves the bytes of dO, out and delta once:
// at the training shape (B=2, S=2048, H=16, hd=128, bf16) 33.8 MB, a
// bound of 0.0101 ms at 3.35 TB/s.
template <typename T, int HD>
struct DeltaShape {
  static constexpr int kLanes =
      floor_pow2(HD / kVec<T> < 32 ? HD / kVec<T> : 32);
  static constexpr int kRows = 256 / kLanes;  // rows per block
  static_assert(HD % kVec<T> == 0, "a row must be whole loads");
};

template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                       float* __restrict__ delta, long long rows, int Sq,
                       int H, long long o_sb, long long o_ss, long long o_sh,
                       long long u_sb, long long u_ss, long long u_sh) {
  constexpr int kLanes = DeltaShape<T, HD>::kLanes, V = kVec<T>;
  const long long row = static_cast<long long>(blockIdx.x) *
                            DeltaShape<T, HD>::kRows + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  // a warp may hold rows past the end: its lanes still join the shuffles
  const bool live = row < rows;
  const int h = static_cast<int>(row % H);
  const int s = static_cast<int>((row / H) % Sq);
  const long long b = row / (static_cast<long long>(H) * Sq);
  float acc = 0.f;
  if (live) {
    const T* o = dout + b * o_sb + s * o_ss + h * o_sh;
    const T* u = out + b * u_sb + s * u_ss + h * u_sh;
#pragma unroll
    for (int d = lane * V; d < HD; d += kLanes * V) acc += dot_vec(o + d, u + d);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && lane == 0) delta[(b * H + h) * Sq + s] = acc;
}

// ===================================================================== bf16
// Each block: consumer warpgroups 0 and 1 (64 rows each) and producer
// warpgroup 2 (one warp issues TMA, the rest idle).
constexpr int kWsThreads = 384;
constexpr int kStages = 2;     // the dq kernel's ring
constexpr int kDkvStages = 3;  // the dk/dv kernel's ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDqBlockM = 128;   // queries per dq block
constexpr int kDqBlockN = 64;    // keys per streamed tile
constexpr int kDkvBlockN = 64;   // keys per dk/dv block
constexpr int kDkvBlockM = 64;   // queries per streamed tile
constexpr int kPFull = 1, kPEmpty = 2;  // named barriers of the dk/dv kernel

template <int HD>
struct DqSmem {
  using QTile = Tile<HD, kDqBlockM>;
  using KTile = Tile<HD, kDqBlockN>;
  static constexpr int kQ = 0;
  static constexpr int kDO = QTile::kBytes;
  static constexpr int kK = 2 * QTile::kBytes;              // + stage
  static constexpr int kV = kK + kStages * KTile::kBytes;   // + stage
  static constexpr int kBars = kV + kStages * KTile::kBytes;
  static constexpr size_t kDynamic = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int HD>
struct DkvSmem {
  using KTile = Tile<HD, kDkvBlockN>;
  using QTile = Tile<HD, kDkvBlockM>;
  static constexpr int kK = 0;
  static constexpr int kV = KTile::kBytes;
  static constexpr int kQ = 2 * KTile::kBytes;                 // + stage
  static constexpr int kDO = kQ + kDkvStages * QTile::kBytes;  // + stage
  static constexpr int kLse = kDO + kDkvStages * QTile::kBytes;  // [stage][64]
  static constexpr int kDelta = kLse + kDkvStages * kDkvBlockM * 4;
  // P^T from warpgroup 0 to warpgroup 1: 32 values of each of 128 threads
  static constexpr int kP = kDelta + kDkvStages * kDkvBlockM * 4;
  static constexpr int kBars = kP + kDkvBlockN * kDkvBlockM * 4;
  static constexpr size_t kDynamic = kBars + 8 * (1 + 2 * kDkvStages) + 1024;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// rows `r` and `r + 8` of a 64 x HD accumulator as bf16 into row-major
// global rows dst0 and dst1 (null: row not written)
template <int HD>
__device__ __forceinline__ void store_acc_rows(__nv_bfloat16* dst0,
                                               __nv_bfloat16* dst1,
                                               const float (&acc)[HD / 2],
                                               int t) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (dst0)
      *reinterpret_cast<__nv_bfloat162*>(dst0 + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (dst1)
      *reinterpret_cast<__nv_bfloat162*>(dst1 + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int H, int G, int Sq,
                         int Sk, float scale, int causal) {
  using L = DqSmem<HD>;
  using QTile = typename L::QTile;
  using KTile = typename L::KTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * kDqBlockM;
  const int k_end = causal ? min(Sk, q0 + kDqBlockM) : Sk;
  const int nk = (k_end + kDqBlockN - 1) / kDqBlockN;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
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
      mbar_arrive_expect_tx(q_full, 2 * QTile::kBytes);
      QTile::load(smem + L::kQ, &map_q, q_full, q0, h, b);
      QTile::load(smem + L::kDO, &map_do, q_full, q0, h, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * KTile::kBytes);
        KTile::load(smem + L::kK + s * KTile::kBytes, &map_k, &full[s],
                    kt * kDqBlockN, h / G, b);
        KTile::load(smem + L::kV + s * KTile::kBytes, &map_v, &full[s],
                    kt * kDqBlockN, h / G, b);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  setmaxnreg_inc<240>();
  const int c = wg;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + 64 * c;
  const int qr[2] = {row_lo + 16 * warp + g, row_lo + 16 * warp + g + 8};
  const float scale_log2 = scale * kLog2e;
  const long long bh = (static_cast<long long>(b) * H + h) * Sq;
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = qr[r] < Sq ? lse[bh + qr[r]] * kLog2e : 0.f;
    del[r] = qr[r] < Sq ? delta[bh + qr[r]] : 0.f;
  }
  const uint32_t q_base = smem_u32(smem + L::kQ);
  const uint32_t do_base = smem_u32(smem + L::kDO);

  float acc[HD / 2];
  zero(acc);
  mbar_wait(q_full, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    const int k0 = kt * kDqBlockN;
    mbar_wait(&full[s], (kt / kStages) & 1);
    // a tile wholly above this warpgroup's diagonal adds 0
    if (!(causal && k0 > row_lo + 63)) {
      const uint32_t k_base = smem_u32(smem + L::kK + s * KTile::kBytes);
      const uint32_t v_base = smem_u32(smem + L::kV + s * KTile::kBytes);
      float sc[kDqBlockN / 2], dp[kDqBlockN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<0>(sc, QTile::kmajor(q_base, 64 * c, kk),
                    KTile::kmajor(k_base, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<0>(dp, QTile::kmajor(do_base, 64 * c, kk),
                    KTile::kmajor(v_base, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool need_mask =
          (causal && k0 + kDqBlockN - 1 > row_lo) || k0 + kDqBlockN > Sk;
#pragma unroll
      for (int j = 0; j < kDqBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = fast_exp2(sc[4 * j + e] * scale_log2 - lse2[r]);
          if (need_mask) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= Sk || (causal && key > qr[r])) p = 0.f;
          }
          sc[4 * j + e] = p * (dp[4 * j + e] - del[r]) * scale;  // ds
        }
      }
      uint32_t da[kDqBlockN / 16][4];
      to_a_frags(da, sc);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqBlockN / 16; ++kk)
        wgmma_rs<1>(acc, da[kk], KTile::mnmajor(k_base, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rows[r] = qr[r] < Sq
                  ? dq + ((static_cast<long long>(b) * Sq + qr[r]) * H + h) * HD
                  : nullptr;
  store_acc_rows<HD>(rows[0], rows[1], acc, t);
}

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int H, int G, int Sq,
                          int Sk, float scale, int causal) {
  using L = DkvSmem<HD>;
  using KTile = typename L::KTile;
  using QTile = typename L::QTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kDkvStages;
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* del_s = reinterpret_cast<float*>(smem + L::kDelta);
  float* p_s = reinterpret_cast<float*>(smem + L::kP);

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int ik = blockIdx.x;  // the first key tiles see the most queries
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int KV = H / G;
  const int k0 = ik * kDkvBlockN;
  const int nq = (Sq + kDkvBlockM - 1) / kDkvBlockM;
  // causal: query tiles before the block's first key add 0
  const int q_first = causal ? k0 / kDkvBlockM : 0;
  const int n_qt = nq - q_first;
  const int n_it = G * n_qt;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 32);  // every producer lane (lse and delta)
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * KTile::kBytes);
        KTile::load(smem + L::kK, &map_k, kv_full, k0, kvh, b);
        KTile::load(smem + L::kV, &map_v, kv_full, k0, kvh, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kDkvStages;
        const int h = kvh * G + it / n_qt;
        const int q0 = (q_first + it % n_qt) * kDkvBlockM;
        const long long bh = (static_cast<long long>(b) * H + h) * Sq;
        mbar_wait(&empty[s], ((it / kDkvStages) & 1) ^ 1);
        if (lane == 0) {  // the tiles first: their latency covers the rest
          mbar_expect_tx(&full[s], 2 * QTile::kBytes);
          QTile::load(smem + L::kQ + s * QTile::kBytes, &map_q, &full[s], q0,
                      h, b);
          QTile::load(smem + L::kDO + s * QTile::kBytes, &map_do, &full[s],
                      q0, h, b);
        }
#pragma unroll
        for (int i = lane; i < kDkvBlockM; i += 32) {
          const int qi = q0 + i;
          lse_s[s * kDkvBlockM + i] = qi < Sq ? lse[bh + qi] * kLog2e : 0.f;
          del_s[s * kDkvBlockM + i] = qi < Sq ? delta[bh + qi] : 0.f;
        }
        mbar_arrive(&full[s]);  // each lane releases its own stores
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  // Both warpgroups own the block's 64 keys. Warpgroup 0 computes
  // S^T = K Q^T, P^T, and dV += P^T dO; warpgroup 1 computes dP^T = V dO^T,
  // dS^T = P^T (dP^T - delta) scale with P^T from warpgroup 0, and
  // dK += dS^T Q. The two accumulators have one layout, so P^T passes
  // through shared memory thread to thread, in fp32, under two named
  // barriers: kPFull (warpgroup 0 arrives, 1 waits) and kPEmpty (the
  // reverse).
  setmaxnreg_inc<240>();
  const int g = lane / 4, t = lane % 4;
  const int kr[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_base = smem_u32(smem + L::kK);
  const uint32_t v_base = smem_u32(smem + L::kV);
  float* p_mine = p_s + (tid % 128);  // element i at p_mine[128 i]

  float acc[HD / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
  zero(acc);
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kDkvStages;
    const int q0 = (q_first + it % n_qt) * kDkvBlockM;
    mbar_wait(&full[s], (it / kDkvStages) & 1);
    const uint32_t q_base = smem_u32(smem + L::kQ + s * QTile::kBytes);
    const uint32_t do_base = smem_u32(smem + L::kDO + s * QTile::kBytes);
    // S^T or dP^T: 64 keys x 64 queries; sc[4j + e] is (key kr[e >> 1],
    // query q0 + 8j + 2t + (e & 1))
    float sc[kDkvBlockM / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<0>(sc, KTile::kmajor(wg == 0 ? k_base : v_base, 0, kk),
                  QTile::kmajor(wg == 0 ? q_base : do_base, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    if (wg == 0) {
      const float* lse2 = lse_s + s * kDkvBlockM;
      const bool need_mask =
          (causal && q0 < k0 + kDkvBlockN - 1) || q0 + kDkvBlockM > Sq;
#pragma unroll
      for (int j = 0; j < kDkvBlockM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          float p = fast_exp2(sc[4 * j + e] * scale_log2 - lse2[col]);
          if (need_mask) {
            const int qi = q0 + col;
            if (qi >= Sq || (causal && kr[e >> 1] > qi)) p = 0.f;
          }
          sc[4 * j + e] = p;
        }
      }
      if (it > 0) named_bar_sync(kPEmpty, 256);
#pragma unroll
      for (int i = 0; i < kDkvBlockM / 2; ++i) p_mine[128 * i] = sc[i];
      named_bar_arrive(kPFull, 256);
    } else {
      const float* del = del_s + s * kDkvBlockM;
      named_bar_sync(kPFull, 256);
#pragma unroll
      for (int j = 0; j < kDkvBlockM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          sc[4 * j + e] = p_mine[128 * (4 * j + e)] *
                          (sc[4 * j + e] - del[col]) * scale;  // ds^T
        }
      }
      if (it < n_it - 1) named_bar_arrive(kPEmpty, 256);
    }

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1): the bf16
    // rounding of P^T or dS^T as the A operand, dO or Q MN-major
    uint32_t pa[kDkvBlockM / 16][4];
    to_a_frags(pa, sc);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvBlockM / 16; ++kk)
      wgmma_rs<1>(acc, pa[kk],
                  QTile::mnmajor(wg == 0 ? do_base : q_base, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* out = wg == 0 ? dv : dk;
  __nv_bfloat16* rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rows[r] = kr[r] < Sk
                  ? out + ((static_cast<long long>(b) * Sk + kr[r]) * KV + kvh) * HD
                  : nullptr;
  store_acc_rows<HD>(rows[0], rows[1], acc, t);
}

// =================================================================== launch
struct Args {
  const void *q, *k, *v, *dout, *out;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KV;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh, u_sb, u_ss, u_sh;
  float scale;
  int causal;
};

template <typename T, int HD>
cudaError_t launch_delta(const Args& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.B) * a.Sq * a.H;
  constexpr int kRows = DeltaShape<T, HD>::kRows;
  flash_bwd_delta_kernel<T, HD><<<static_cast<unsigned>((rows + kRows - 1) /
                                                        kRows),
                                  256, 0, stream>>>(
      static_cast<const T*>(a.dout), static_cast<const T*>(a.out), a.delta,
      rows, a.Sq, a.H, a.o_sb, a.o_ss, a.o_sh, a.u_sb, a.u_ss, a.u_sh);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fp32(const Args& a, cudaStream_t stream) {
  auto kdq = flash_bwd_dq_fp32_kernel<HD>;
  auto kdkv = flash_bwd_dkv_fp32_kernel<HD>;
  constexpr size_t s_dq = smem_dq_fp32<HD>(), s_dkv = smem_dkv_fp32<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s_dq));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_dkv));
  if (err != cudaSuccess) return err;
  const int G = a.H / a.KV;
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *o = static_cast<const float*>(a.dout);
  kdq<<<dim3((a.Sq + kBlock - 1) / kBlock, a.H, a.B), kThreads32, s_dq,
        stream>>>(q, k, v, o, a.lse, a.delta, static_cast<float*>(a.dq), a.H,
                  G, a.Sq, a.Sk, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss,
                  a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh,
                  a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdkv<<<dim3((a.Sk + kBlock - 1) / kBlock, a.KV, a.B), kThreads32, s_dkv,
         stream>>>(q, k, v, o, a.lse, a.delta, static_cast<float*>(a.dk),
                   static_cast<float*>(a.dv), a.H, G, a.Sq, a.Sk, a.q_sb,
                   a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss,
                   a.v_sh, a.o_sb, a.o_ss, a.o_sh, a.scale, a.causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  // the same tensors, boxed as each kernel streams or keeps them
  CUtensorMap dq_q, dq_do, dq_k, dq_v, kv_q, kv_do, kv_k, kv_v;
  const struct {
    CUtensorMap* map;
    const void* base;
    int S, heads;
    long long sb, ss, sh;
    int rows;
  } maps[] = {
      {&dq_q, a.q, a.Sq, a.H, a.q_sb, a.q_ss, a.q_sh, kDqBlockM},
      {&dq_do, a.dout, a.Sq, a.H, a.o_sb, a.o_ss, a.o_sh, kDqBlockM},
      {&dq_k, a.k, a.Sk, a.KV, a.k_sb, a.k_ss, a.k_sh, kDqBlockN},
      {&dq_v, a.v, a.Sk, a.KV, a.v_sb, a.v_ss, a.v_sh, kDqBlockN},
      {&kv_q, a.q, a.Sq, a.H, a.q_sb, a.q_ss, a.q_sh, kDkvBlockM},
      {&kv_do, a.dout, a.Sq, a.H, a.o_sb, a.o_ss, a.o_sh, kDkvBlockM},
      {&kv_k, a.k, a.Sk, a.KV, a.k_sb, a.k_ss, a.k_sh, kDkvBlockN},
      {&kv_v, a.v, a.Sk, a.KV, a.v_sb, a.v_ss, a.v_sh, kDkvBlockN}};
  for (const auto& m : maps) {
    const cudaError_t err = encode_tile_map(m.map, m.base, HD, m.S, m.heads,
                                            a.B, m.sb, m.ss, m.sh, m.rows);
    if (err != cudaSuccess) return err;
  }
  auto kdq = flash_bwd_dq_bf16_kernel<HD>;
  auto kdkv = flash_bwd_dkv_bf16_kernel<HD>;
  constexpr size_t s_dq = DqSmem<HD>::kDynamic, s_dkv = DkvSmem<HD>::kDynamic;
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s_dq));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_dkv));
  if (err != cudaSuccess) return err;
  const int G = a.H / a.KV;
  kdq<<<dim3((a.Sq + kDqBlockM - 1) / kDqBlockM, a.H, a.B), kWsThreads, s_dq,
        stream>>>(dq_q, dq_do, dq_k, dq_v, a.lse, a.delta,
                  static_cast<__nv_bfloat16*>(a.dq), a.H, G, a.Sq, a.Sk,
                  a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdkv<<<dim3((a.Sk + kDkvBlockN - 1) / kDkvBlockN, a.KV, a.B), kWsThreads,
         s_dkv, stream>>>(kv_q, kv_do, kv_k, kv_v, a.lse, a.delta,
                          static_cast<__nv_bfloat16*>(a.dk),
                          static_cast<__nv_bfloat16*>(a.dv), a.H, G, a.Sq,
                          a.Sk, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool BF16, int HD>
cudaError_t launch_all(const Args& a, cudaStream_t stream) {
  const cudaError_t err =
      BF16 ? launch_delta<__nv_bfloat16, HD>(a, stream)
           : launch_delta<float, HD>(a, stream);
  if (err != cudaSuccess) return err;
  return BF16 ? launch_bf16<HD>(a, stream) : launch_fp32<HD>(a, stream);
}

template <bool BF16>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_all<BF16, 32>(a, stream);
    case 64: return launch_all<BF16, 64>(a, stream);
    case 80: return launch_all<BF16, 80>(a, stream);
    case 128: return launch_all<BF16, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; hd 32, 64, 80 or 128 (any other is
// cudaErrorInvalidValue). q, dout and out (B,Sq,H,hd), k/v (B,Sk,KV,hd)
// with the given element strides (the head_dim stride must be 1; for bf16,
// which loads q, k, v and dout through TMA tensor maps and dout and out in
// 16-byte vectors, their other strides multiples of 8 elements and their
// pointers 16-byte aligned); lse (B,H,Sq)
// fp32 contiguous; delta (B,H,Sq) fp32 contiguous, filled here with
// rowsum(dout * out); dq (B,Sq,H,hd) and dk/dv (B,Sk,KV,hd) contiguous in
// the input dtype. Launches the delta kernel, the dq kernel, then the
// dk/dv kernel, on `stream`; returns the first cudaError_t.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* out, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Sk, int H, int KV, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long u_sb, long long u_ss, long long u_sh,
    float scale, int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (causal && Sq != Sk))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, out, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv, B, Sq, Sk, H, KV,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
               o_ss, o_sh, u_sb, u_ss, u_sh, scale, causal};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<false>(hd, a, st);
  if (dtype == 1) {
    const long long strides[] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                                 v_ss, v_sh, o_sb, o_ss, o_sh, u_sb, u_ss,
                                 u_sh};
    for (long long s : strides)
      if (s % 8) return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
         reinterpret_cast<uintptr_t>(out)) %
        16)
      return cudaErrorMisalignedAddress;
    return dispatch_hd<true>(hd, a, st);
  }
  return cudaErrorInvalidValue;
}
