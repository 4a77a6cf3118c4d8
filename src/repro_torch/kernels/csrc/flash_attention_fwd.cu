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
// memory (3.35 TB/s).
//
// What this design does about it: it keeps every intermediate out of
// device memory. One block owns one (batch, head, 64-query tile) and walks
// the 64-key tiles of K and V in a loop inside the block (on the TPU the
// sequential `ik` grid axis carried the accumulators; on Hopper blocks run
// in parallel and in no order, so the loop replaces that axis). The running
// max `m`, sum `l` and the output accumulator stay in registers, in fp32.
// Key tiles wholly above the causal diagonal are never loaded, and query
// tiles are issued heaviest first so the causal triangle balances across
// SMs.
//
// bf16 inputs run both products on the tensor cores with `mma.sync`
// m16n8k16 (fp32 accumulation): each of 4 warps owns 16 query rows, holds
// its Q tile as A fragments in registers, reads K and V tiles from padded
// shared memory with `ldmatrix`, and turns the score accumulators into the
// A fragments of P V without leaving registers (P is rounded to bf16 for
// that product, as the Pallas kernel casts p to v's dtype). Tiles are
// loaded synchronously: no cp.async/TMA pipeline and no wgmma yet, which is
// what separates it from the bound.
//
// fp32 inputs run as fp32 FMAs on the CUDA cores (a bf16 or TF32 product
// would break the fp32 tolerance of 2e-5): Q, K, V and the probability
// tile in shared memory, 4x4 score and 4x(hd/16) output register tiles per
// thread.
//
// Ragged lengths (S % 64 != 0) are masked in the kernel. Head dims 32, 64
// and 128; out in the input dtype, lse in fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

using namespace repro_mma;

constexpr int kBlockQ = 64;
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
constexpr int kWarps16 = kBlockQ / 16;       // one warp per 16 query rows
constexpr int kThreads16 = kWarps16 * 32;
static_assert(kBlockQ == kBlockK, "load_tile moves tiles of kBlockK rows");

// max / sum across the 4 lanes of a quad, which share an accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD>
constexpr size_t smem_bytes_bf16() {
  // rows padded by 16 bytes so the 8 rows an ldmatrix phase reads fall
  // on distinct banks
  return sizeof(__nv_bfloat16) * (kBlockQ + 2 * kBlockK) * (HD + 8);
}

// rows r0.. of a (rows, HD) bf16 matrix with the given row stride, 16-byte
// vectors; rows past n are zero
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int n, long long stride, int tid) {
  constexpr int LD = HD + 8, VPR = HD / 8;
  for (int e = tid; e < kBlockK * VPR; e += kThreads16) {
    const int r = e / VPR, c = (e % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads16)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                      int H, int G, int Sq, int Sk,
                      long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh,
                      long long v_sb, long long v_ss, long long v_sh,
                      float scale, int causal) {
  constexpr int LD = HD + 8;
  constexpr int KSTEPS = HD / 16;   // k-steps of the score product
  constexpr int NT = HD / 8;        // n-tiles of the output
  constexpr int SN = kBlockK / 8;   // n-tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockQ * LD;
  __nv_bfloat16* Vs = Ks + kBlockK * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row group, column pair
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * kBlockQ;
  const int qr0 = q0 + warp * 16 + g, qr1 = qr0 + 8;  // this thread's rows

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + (h / G) * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + (h / G) * v_sh;

  load_tile<HD>(Qs, qb, q0, Sq, q_ss, tid);
  __syncthreads();
  uint32_t qf[KSTEPS][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LD + kk * 16 +
                            (lane / 16) * 8);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: lane partials

  const int k_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  const int nk = (k_end + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<HD>(Ks, kb, k0, Sk, k_ss, tid);
    load_tile<HD>(Vs, vb, k0, Sk, v_ss, tid);
    __syncthreads();

    // S = Q K^T: 16 x 64 per warp as 8 n-tiles of 8 keys
    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        uint32_t bk[4];  // b0, b1 of k-steps kk and kk + 1
        ldmatrix_x4(bk, Ks + (8 * j + lane % 8) * LD + kk * 16 +
                            (lane / 8) * 8);
        mma_bf16(s[j], qf[kk], bk[0], bk[1]);
        mma_bf16(s[j], qf[kk + 1], bk[2], bk[3]);
      }
    }

    // scale and mask; s[j] holds (qr0, key), (qr0, key+1), (qr1, key),
    // (qr1, key+1) with key = k0 + 8 j + 2 t
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < SN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? qr0 : qr1;
        const bool valid = key < Sk && (!causal || key <= row);
        s[j][e] = valid ? s[j][e] * scale : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P as the A fragments of P V: n-tiles 2 kk and 2 kk + 1 of the score
    // accumulators are exactly k-step kk's A fragment
    uint32_t pf[kBlockK / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      const int key = k0 + 8 * j + 2 * t;
      // keys past Sk do not exist; causally masked ones weigh
      // exp(-1e30 - m) as in the reference kernel
      const float p0 = key < Sk ? expf(s[j][0] - mn0) : 0.f;
      const float p1 = key + 1 < Sk ? expf(s[j][1] - mn0) : 0.f;
      const float p2 = key < Sk ? expf(s[j][2] - mn1) : 0.f;
      const float p3 = key + 1 < Sk ? expf(s[j][3] - mn1) : 0.f;
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }

    // O += P V, V read transposed: b0, b1 of n-tiles 2 n2 and 2 n2 + 1
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                       LD + n2 * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * n2], pf[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * n2 + 1], pf[kk], bv[2], bv[3]);
      }
    }
  }

  // out is (B, Sq, H, hd) contiguous, lse (B, H, Sq)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  if (qr0 < Sq) {
    __nv_bfloat16* ob = out + ((static_cast<long long>(b) * Sq + qr0) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][0] / ls0, acc[n][1] / ls0);
    if (t == 0) lse[(static_cast<long long>(b) * H + h) * Sq + qr0] = m0 + logf(ls0);
  }
  if (qr1 < Sq) {
    __nv_bfloat16* ob = out + ((static_cast<long long>(b) * Sq + qr1) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2] / ls1, acc[n][3] / ls1);
    if (t == 0) lse[(static_cast<long long>(b) * H + h) * Sq + qr1] = m1 + logf(ls1);
  }
}

// =================================================================== launch
template <int HD> auto kernel_for(const float*) { return flash_fwd_fp32_kernel<HD>; }
template <int HD> auto kernel_for(const __nv_bfloat16*) {
  return flash_fwd_bf16_kernel<HD>;
}
template <int HD> constexpr size_t smem_for(const float*) { return smem_bytes_fp32<HD>(); }
template <int HD> constexpr size_t smem_for(const __nv_bfloat16*) {
  return smem_bytes_bf16<HD>();
}
constexpr int threads_for(const float*) { return kThreads32; }
constexpr int threads_for(const __nv_bfloat16*) { return kThreads16; }

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int H, int KV,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   float scale, int causal, cudaStream_t stream) {
  constexpr const T* tag = nullptr;
  constexpr size_t smem = smem_for<HD>(tag);
  auto kern = kernel_for<HD>(tag);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  kern<<<grid, threads_for(tag), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, H / KV, Sq, Sk,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int Sq, int Sk, int H,
                        int KV, long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale, int causal, cudaStream_t stream) {
#define REPRO_FA_CASE(HD)                                                     \
  case HD:                                                                    \
    return launch<T, HD>(q, k, v, out, lse, B, Sq, Sk, H, KV, q_sb, q_ss,     \
                         q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,     \
                         causal, stream);
  switch (hd) {
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FA_CASE
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. q (B,Sq,H,hd), k/v (B,Sk,KV,hd) with the
// given element strides (the head_dim stride must be 1; for bf16 every
// other stride a multiple of 8 and the pointers 16-byte aligned); out
// (B,Sq,H,hd) contiguous in the input dtype; lse (B,H,Sq) fp32. Returns
// the cudaError_t of the launch.
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
    return dispatch_hd<float>(hd, q, k, v, out, lse_f, B, Sq, Sk, H, KV, q_sb,
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
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, lse_f, B, Sq, Sk, H,
                                      KV, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                      v_sb, v_ss, v_sh, scale, causal, st);
  }
  return cudaErrorInvalidValue;
}
