// Hopper (sm_90a) machinery shared by the bf16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu) and the stages of the
// bf16 SSD chunked scan (ssd_scan.cu).
//
// What each part is for:
//  * `encode_tile_map` (host, once per map and call): a TMA tensor map
//    over the reference layout (B, S, heads, hd), described to
//    the hardware as the 4-D tensor (hd, S, heads, B) with the tensor's own
//    strides, so strided views (q, k, v cut from one fused projection; the
//    SSD's x, B and C cut from the conv output) and the GQA head mapping
//    need no copy. A box is `rows` x `tile_box_cols(hd)` columns: 64 for
//    a multiple of 64, hd itself below 64, and 16 for any other multiple
//    of 16 (hubert's hd 80: five boxes), or on request wide boxes of 64
//    columns (hd 80 as two, the second zero-filled past column 80); TMA
//    fills rows past S with zeros, which is how ragged lengths arrive.
//    The swizzle spans one box row: 128B for 64-column boxes, 64B for
//    32-column and 32B for 16-column ones
//    (the SSD's d_state 16, hd 80): the same mode goes into the wgmma
//    descriptors below, and every tile's shared-memory base is 1024-byte
//    aligned so the pattern starts at its row 0.
//    `swizzled` gives the byte offset TMA used for a (row, column), for
//    threads that read a tile themselves.
//  * `tma_load_4d`: one `cp.async.bulk.tensor` box, completing on an
//    mbarrier with its byte count (`complete_tx`); `tma_store_4d` the
//    other way, from a tile threads wrote (the SSD output), in bulk
//    groups.
//  * `mbar_*`: the full/empty barrier rings. A full barrier expects the
//    producer's arrival plus the stage's bytes; an empty barrier expects one
//    arrival from each consumer warp once its wgmmas have read the stage.
//  * `Tile<HD, ROWS>`: the layout TMA writes (boxes of ROWS rows, one after
//    another) and the wgmma descriptors that read it: K-major (the head dim
//    is the product's depth: Q, K, dO, V in Q K^T and dO V^T; C and B in
//    C B^T, C and S in C S) and MN-major (the rows are the depth: V in P V,
//    K in dS K, Q and dO in dS^T Q and P^T dO, x in scores x, B in the
//    SSD's chunk states, with the transpose flag set).
//  * `wgmma_ss` / `wgmma_rs`: m64nNk16 bf16 -> fp32 products, A from
//    shared memory (N = 32, 64, 128) or from registers (N = 16, 32, 64,
//    80, 128), with the B-transpose flag as a template argument; `wgmma_fence`,
//    `wgmma_commit`, `wgmma_wait` and `fence_regs`, which keeps the compiler
//    from moving accumulator reads across the asynchronous product.
//  * The accumulator of m64nN gives warp w of the warpgroup rows 16w + g and
//    16w + g + 8 (g = lane / 4, t = lane % 4) with d[4j + e] at column
//    8j + 2t + (e & 1), row + 8 (e >> 1): per 16 rows the mma.sync C layout,
//    so two neighbouring 8-column tiles of a score accumulator, rounded to
//    bf16 pairs (`pack_bf16`), are one k-step's A fragment of the next
//    product (`to_a_frags`).
//  * `named_bar_*`: named barriers between the consumer warpgroups.
//  * `setmaxnreg`: the producer warpgroup of a 384-thread block drops to
//    24 registers a thread and the consumers may rise to 240, past the 168
//    the launch gives every thread. ptxas honours it (a probe holding 200
//    live floats a thread used R211 with 0 spill bytes, and spilled 492
//    bytes without it: scripts/probe_setmaxnreg.py). The flash kernels'
//    consumers use at most R165 either way, yet without it the forward
//    ran 2% and the dq kernel 4-5% slower on the H100 (PERF.md, PR 15).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_hopper {

// ------------------------------------------------------------------ host
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, fetched through the
// runtime so the library needs no link against libcuda
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The columns of one TMA box (and one swizzled shared-memory row) of a
// bf16 tile hd wide: 64 (a 128-byte row) for a multiple of 64, hd itself
// below 64, else 16 (a 32-byte row), so that hd is a whole number of
// boxes whenever it is a multiple of 16 (hd 80: five boxes of 16).
__host__ __device__ constexpr int tile_box_cols(int hd) {
  return hd % 64 == 0 ? 64 : hd < 64 ? hd : 16;
}

// A bf16 (B, S, heads, hd) tensor with element strides (sb, ss, sh) and a
// contiguous head dim, read or written in boxes of `rows` rows of one
// (batch, head); hd is 16, 32 or a multiple of 16 from 64 up, any other
// width an error (a box of 16 or 32 columns that did not tile hd would
// drop its last columns silently). `wide` reads a multiple of 16 above
// 64 that is not one of 64 (hd 80) in 64-column boxes instead, the last
// one filled with zeros past hd (a Tile of hd rounded up to 64 columns
// holds them); any other hd with `wide` is an error.
inline cudaError_t encode_tile_map(CUtensorMap* map, const void* base, int hd,
                                   int S, int heads, int B, long long sb,
                                   long long ss, long long sh, int rows,
                                   bool wide = false) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (wide && (hd <= 64 || hd % 64 == 0 || hd % 16 != 0))
    return cudaErrorInvalidValue;
  const int box_cols = wide ? 64 : tile_box_cols(hd);
  if (hd <= 0 || (!wide && hd % box_cols != 0) ||
      (box_cols != 16 && box_cols != 32 && box_cols != 64))
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- device
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after every mbar_init, before any other thread uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// add to the bytes the current phase waits for, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// Spin until the phase of the given parity has completed. A wait of more
// than about 10 s (2e10 cycles) can only be a deadlock: trap, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - start > 20000000000LL) __trap();
}

// one box of a 4-D tensor map at (column, row, head, batch) into `dst`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of a 4-D tensor map from `src` to (column, row, head, batch);
// rows past the tensor's end are not written. Issued by one thread, in
// bulk groups (`bulk_commit`); `bulk_wait_read<N>` returns once at most N
// of its groups still read shared memory, `bulk_wait<0>` once all are
// written. Shared memory written by threads is first made visible to the
// copy with `fence_async_smem`.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barriers (0 is __syncthreads): `count` threads in all, some that
// arrive and go on, some that wait
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode (1: 128B, 2: 64B,
// 3: 32B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// The byte offset TMA gives (row, byte b of the row) in a tile of rows of
// SW bytes written with the SW-byte swizzle (SW = 32, 64, 128): the
// 16-byte chunk index is XORed with address bits 7 and up, which for
// 128-byte rows is the row within its 8-row group.
template <int SW>
__device__ __forceinline__ int swizzled(int row, int b) {
  const int o = row * SW + b;
  return o ^ (((o >> 7) & (SW / 16 - 1)) << 4);
}

// The shared-memory image of a (ROWS, HD) bf16 tile as TMA writes it:
// HD / 64 boxes of ROWS rows x 128 bytes (one box of ROWS x 2 HD bytes at
// HD = 16 or 32; HD / 16 boxes of ROWS x 32 bytes at HD = 80), each row's
// 16-byte chunks swizzled as `swizzled` says.
template <int HD, int ROWS>
struct Tile {
  static constexpr int kBoxCols = tile_box_cols(HD);
  static constexpr int kRowBytes = kBoxCols * 2;  // = the swizzle width
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kBoxBytes = ROWS * kRowBytes;
  static constexpr int kBytes = kBoxes * kBoxBytes;
  static_assert(HD % kBoxCols == 0, "a tile must be whole boxes");
  static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes == 128,
                "a box row must be one swizzle width: 32, 64 or 128 bytes");
  static_assert(kBoxBytes % 1024 == 0, "boxes must keep 1024-byte alignment");

  // Issue the tile's boxes at (row r0, head, batch) on `bar`.
  static __device__ __forceinline__ void load(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int r0, int head,
                                              int batch) {
#pragma unroll
    for (int i = 0; i < kBoxes; ++i)
      tma_load_4d(static_cast<char*>(dst) + i * kBoxBytes, map, bar,
                  i * kBoxCols, r0, head, batch);
  }

  // Store the tile's boxes from `src` at (row r0, head, batch).
  static __device__ __forceinline__ void store(const CUtensorMap* map,
                                               const void* src, int r0,
                                               int head, int batch) {
#pragma unroll
    for (int i = 0; i < kBoxes; ++i)
      tma_store_4d(map, static_cast<const char*>(src) + i * kBoxBytes,
                   i * kBoxCols, r0, head, batch);
  }

  // K-major operand (the head dim is the depth): rows r0.. of the tile,
  // k-step kk (head-dim columns 16 kk .. 16 kk + 15). Within a swizzled
  // row a k-step is a 32-byte offset of the start address.
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int r0,
                                                    int kk) {
    constexpr int per_box = kBoxCols / 16;
    const uint32_t addr = base + (kk / per_box) * kBoxBytes + r0 * kRowBytes +
                          (kk % per_box) * 32;
    return make_desc(addr, 16, 8 * kRowBytes, kRowBytes);
  }

  // MN-major B operand (the rows are the depth, the head dim is N): rows
  // 16 kk .. 16 kk + 15. LBO steps from one box to the next along N (64
  // columns under the 128B swizzle, 16 under the 32B one), SBO from 8
  // rows to the next 8.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return make_desc(base + kk * 16 * kRowBytes, kBoxBytes, 8 * kRowBytes,
                     kRowBytes);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A score accumulator (64 x N) as the A fragments of N / 16 k-steps
template <int R>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[R / 8][4],
                                           const float (&s)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max / sum across the 4 lanes of a quad, which share an accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// m64n16k16, A from registers, B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
}

// m64n32k16, A and B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// m64n32k16, A from registers, B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
}

// m64n64k16, A and B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// m64n64k16, A from registers, B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
}

// m64n80k16, A from registers, B from shared memory (hd 80's O += P V)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
}

// m64n128k16, A and B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// m64n128k16, A from registers, B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TB));
}
}  // namespace repro_hopper
