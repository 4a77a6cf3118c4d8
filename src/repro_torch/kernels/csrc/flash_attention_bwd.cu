// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_bwd
// (Pallas bodies `_bwd_dq_kernel` and `_bwd_dkv_kernel`). With the forward's
// logsumexp `lse` and `delta = rowsum(dO * out)` (a plain reduction in the
// launcher, as XLA computed it in the reference), each (query, key) pair
// recomputes
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
// outputs, so the tensor-core rate (989 TFLOP/s bf16) is the bound.
//
// What this design does about it: two kernels, neither with atomics, so
// the gradients are deterministic.
//  * dq: one block per (batch, head, 64-query tile) loops over the key
//    tiles up to the diagonal and keeps dq in registers (the Pallas grid's
//    sequential key axis becomes the loop).
//  * dk/dv: one block per (batch, KV head, 64-key tile) loops over the G
//    query heads of its group and over the query tiles from the diagonal
//    down, so it owns the group sum and no (B, H, Sk, hd) intermediate is
//    written (the reference sums per-head dk/dv outside its kernel).
// q.k and dO.v are computed in both kernels: the two-pass design executes
// 14 of the 10 units of product work (1.4x the bound's count).
//
// bf16 inputs run every product on the tensor cores (`mma.sync` m16n8k16,
// fp32 accumulation, fragments as in flash_attention_fwd.cu); p and ds are
// rounded to bf16 as the A operands of their products. Each of 4 warps owns
// 16 rows (queries in the dq kernel, keys in the dk/dv kernel) and works on
// 32-column halves of each 64-wide tile, to keep the accumulators in
// registers. Tiles load synchronously: no cp.async/TMA pipeline and no
// wgmma yet.
//
// fp32 inputs run as fp32 FMAs on the CUDA cores (the 3e-4 gradient
// tolerance rules out bf16 or TF32 products): tiles in padded shared
// memory, 4x4 score register tiles per thread.
//
// Ragged lengths are masked in the kernels. Head dims 32, 64 and 128;
// causal needs Sq == Sk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

using namespace repro_mma;

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

// ===================================================================== bf16
constexpr int kWarps16 = kBlock / 16;  // one warp per 16 rows
constexpr int kThreads16 = kWarps16 * 32;
constexpr int kHalf = kBlock / 2;      // columns a warp holds at once

template <int HD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src, int r0,
                                               int n, long long stride,
                                               int tid) {
  constexpr int LD = HD + 8, VPR = HD / 8;
  for (int e = tid; e < kBlock * VPR; e += kThreads16) {
    const int r = e / VPR, c = (e % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int HD>
constexpr size_t smem_bf16() {
  // four tiles, rows padded by 16 bytes (distinct banks per ldmatrix
  // phase), then 64 lse and 64 delta values
  return sizeof(__nv_bfloat16) * 4 * kBlock * (HD + 8) +
         sizeof(float) * 2 * kBlock;
}

// Rows r (16 per warp) against 32 columns: acc[j] += X[r] . Y[col]^T over
// the head dim, X's A fragments read from Xs, Y rows from Ys (both (rows,
// HD) row-major, pitch HD + 8), columns c0 + 8 j.
template <int HD>
__device__ __forceinline__ void product_nt(float (&acc)[kHalf / 8][4],
                                           const __nv_bfloat16* Xs, int xr0,
                                           const __nv_bfloat16* Ys, int c0,
                                           int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; kk += 2) {
    uint32_t a0[4], a1[4];
    load_a(a0, Xs, xr0, kk * 16, LD, lane);
    load_a(a1, Xs, xr0, kk * 16 + 16, LD, lane);
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j) {
      uint32_t bf[4];
      load_b_nt(bf, Ys, c0 + 8 * j, kk * 16, LD, lane);
      mma_bf16(acc[j], a0, bf[0], bf[1]);
      mma_bf16(acc[j], a1, bf[2], bf[3]);
    }
  }
}

// acc (16 rows x HD) += A (16 x 32, fragments af) . Y[k0..k0+31, :] with Y
// (rows, HD) row-major in shared memory
template <int HD>
__device__ __forceinline__ void product_nn(float (&acc)[HD / 8][4],
                                           const uint32_t (&af)[kHalf / 16][4],
                                           const __nv_bfloat16* Ys, int k0,
                                           int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < kHalf / 16; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < HD / 16; ++n2) {
      uint32_t bf[4];
      load_b_nn(bf, Ys, k0 + kk * 16, n2 * 16, LD, lane);
      mma_bf16(acc[2 * n2], af[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * n2 + 1], af[kk], bf[2], bf[3]);
    }
  }
}

template <int HD>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst,
                                                const float (&acc)[HD / 8][4],
                                                int half, int t) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads16)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int H, int G, int Sq,
                         int Sk, long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         float scale, int causal) {
  constexpr int LD = HD + 8, NT = HD / 8, SN = kHalf / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + kBlock * LD;
  __nv_bfloat16* Ks = dOs + kBlock * LD;
  __nv_bfloat16* Vs = Ks + kBlock * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * kBlock;
  const int qr[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const __nv_bfloat16* kb = k + b * k_sb + (h / G) * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + (h / G) * v_sh;

  load_tile_bf16<HD>(Qs, q + b * q_sb + h * q_sh, q0, Sq, q_ss, tid);
  load_tile_bf16<HD>(dOs, dout + b * o_sb + h * o_sh, q0, Sq, o_ss, tid);
  const long long bh = (static_cast<long long>(b) * H + h) * Sq;
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = qr[r] < Sq ? lse[bh + qr[r]] : 0.f;
    del_r[r] = qr[r] < Sq ? delta[bh + qr[r]] : 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int k_end = causal ? min(Sk, q0 + kBlock) : Sk;
  const int nk = (k_end + kBlock - 1) / kBlock;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16<HD>(Ks, kb, k0, Sk, k_ss, tid);
    load_tile_bf16<HD>(Vs, vb, k0, Sk, v_ss, tid);
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kh = half * kHalf;
      float s[SN][4], dp[SN][4];
      product_nt<HD>(s, Qs, warp * 16, Ks, kh, lane);    // q . k
      product_nt<HD>(dp, dOs, warp * 16, Vs, kh, lane);  // dO . v
      uint32_t dsf[kHalf / 16][4];
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kh + 8 * j + 2 * t + (e & 1), r = e / 2;
          const bool valid =
              qr[r] < Sq && key < Sk && (!causal || key <= qr[r]);
          const float p = valid ? expf(s[j][e] * scale - lse_r[r]) : 0.f;
          ds[e] = p * (dp[j][e] - del_r[r]) * scale;
        }
        dsf[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        dsf[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      product_nn<HD>(acc, dsf, Ks, kh, lane);  // dq += ds K
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (qr[r] < Sq)
      store_rows_bf16<HD>(
          dq + ((static_cast<long long>(b) * Sq + qr[r]) * H + h) * HD, acc, r,
          t);
}

template <int HD>
__global__ void __launch_bounds__(kThreads16)
flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int H, int G, int Sq,
                          int Sk, long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          long long o_sb, long long o_ss, long long o_sh,
                          float scale, int causal) {
  constexpr int LD = HD + 8, NT = HD / 8, SN = kHalf / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kBlock * LD;
  __nv_bfloat16* Qs = Vs + kBlock * LD;
  __nv_bfloat16* dOs = Qs + kBlock * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kBlock * LD);
  float* del_s = lse_s + kBlock;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ik = blockIdx.x;  // the first key tiles see the most queries
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int KV = H / G;
  const int k0 = ik * kBlock;
  const int kr[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  load_tile_bf16<HD>(Ks, k + b * k_sb + kvh * k_sh, k0, Sk, k_ss, tid);
  load_tile_bf16<HD>(Vs, v + b * v_sb + kvh * v_sh, k0, Sk, v_ss, tid);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int nq = (Sq + kBlock - 1) / kBlock;
  const int q_first = causal ? ik : 0;  // tiles above the diagonal add 0
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
    const __nv_bfloat16* ob = dout + b * o_sb + h * o_sh;
    const long long bh = (static_cast<long long>(b) * H + h) * Sq;
    for (int qt = q_first; qt < nq; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();  // the previous tile's readers are done
      load_tile_bf16<HD>(Qs, qb, q0, Sq, q_ss, tid);
      load_tile_bf16<HD>(dOs, ob, q0, Sq, o_ss, tid);
      if (tid < kBlock) {
        lse_s[tid] = q0 + tid < Sq ? lse[bh + q0 + tid] : 0.f;
        del_s[tid] = q0 + tid < Sq ? delta[bh + q0 + tid] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qh = half * kHalf;
        float s[SN][4], dp[SN][4];
        product_nt<HD>(s, Ks, warp * 16, Qs, qh, lane);    // k . q
        product_nt<HD>(dp, Vs, warp * 16, dOs, qh, lane);  // v . dO
        uint32_t pf[kHalf / 16][4], dsf[kHalf / 16][4];
#pragma unroll
        for (int j = 0; j < SN; ++j) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = qh + 8 * j + 2 * t + (e & 1), qi = q0 + c;
            const int key = kr[e / 2];
            const bool valid = qi < Sq && key < Sk && (!causal || key <= qi);
            p[e] = valid ? expf(s[j][e] * scale - lse_s[c]) : 0.f;
            ds[e] = p[e] * (dp[j][e] - del_s[c]) * scale;
          }
          pf[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
          pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
          dsf[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
          dsf[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        product_nn<HD>(dv_acc, pf, dOs, qh, lane);  // dv += p^T dO
        product_nn<HD>(dk_acc, dsf, Qs, qh, lane);  // dk += ds^T Q
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kr[r] >= Sk) continue;
    const long long off = ((static_cast<long long>(b) * Sk + kr[r]) * KV + kvh) * HD;
    store_rows_bf16<HD>(dk + off, dk_acc, r, t);
    store_rows_bf16<HD>(dv + off, dv_acc, r, t);
  }
}

// =================================================================== launch
template <int HD> auto dq_kernel(const float*) { return flash_bwd_dq_fp32_kernel<HD>; }
template <int HD> auto dq_kernel(const __nv_bfloat16*) {
  return flash_bwd_dq_bf16_kernel<HD>;
}
template <int HD> auto dkv_kernel(const float*) { return flash_bwd_dkv_fp32_kernel<HD>; }
template <int HD> auto dkv_kernel(const __nv_bfloat16*) {
  return flash_bwd_dkv_bf16_kernel<HD>;
}
template <int HD> constexpr size_t smem_dq(const float*) { return smem_dq_fp32<HD>(); }
template <int HD> constexpr size_t smem_dq(const __nv_bfloat16*) { return smem_bf16<HD>(); }
template <int HD> constexpr size_t smem_dkv(const float*) { return smem_dkv_fp32<HD>(); }
template <int HD> constexpr size_t smem_dkv(const __nv_bfloat16*) { return smem_bf16<HD>(); }
constexpr int threads_for(const float*) { return kThreads32; }
constexpr int threads_for(const __nv_bfloat16*) { return kThreads16; }

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KV;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh;
  float scale;
  int causal;
};

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr const T* tag = nullptr;
  auto kdq = dq_kernel<HD>(tag);
  auto kdkv = dkv_kernel<HD>(tag);
  constexpr size_t s_dq = smem_dq<HD>(tag), s_dkv = smem_dkv<HD>(tag);
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s_dq));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s_dkv));
  if (err != cudaSuccess) return err;
  const int G = a.H / a.KV;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *o = static_cast<const T*>(a.dout);
  kdq<<<dim3((a.Sq + kBlock - 1) / kBlock, a.H, a.B), threads_for(tag), s_dq,
        stream>>>(q, k, v, o, a.lse, a.delta, static_cast<T*>(a.dq), a.H, G,
                  a.Sq, a.Sk, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh,
                  a.v_sb, a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh, a.scale,
                  a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kdkv<<<dim3((a.Sk + kBlock - 1) / kBlock, a.KV, a.B), threads_for(tag),
         s_dkv, stream>>>(q, k, v, o, a.lse, a.delta, static_cast<T*>(a.dk),
                          static_cast<T*>(a.dv), a.H, G, a.Sq, a.Sk, a.q_sb,
                          a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb,
                          a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh, a.scale,
                          a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. q and dout (B,Sq,H,hd), k/v (B,Sk,KV,hd) with
// the given element strides (the head_dim stride must be 1; for bf16 every
// other stride a multiple of 8 and the pointers 16-byte aligned); lse and
// delta (B,H,Sq) fp32 contiguous; dq (B,Sq,H,hd) and dk/dv (B,Sk,KV,hd)
// contiguous in the input dtype. Launches the dq kernel, then the dk/dv
// kernel, on `stream`; returns the first cudaError_t.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int dtype, int B, int Sq, int Sk, int H, int KV, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (causal && Sq != Sk))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, dk, dv, B, Sq, Sk, H, KV,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
               o_ss, o_sh, scale, causal};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(hd, a, st);
  if (dtype == 1) {
    const long long strides[] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                 v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
    for (long long s : strides)
      if (s % 8) return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
        16)
      return cudaErrorMisalignedAddress;
    return dispatch_hd<__nv_bfloat16>(hd, a, st);
  }
  return cudaErrorInvalidValue;
}
