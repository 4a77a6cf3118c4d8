// Event select for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/event_select.py:event_select_fwd (Pallas
// body `_event_select_kernel`): per row of an (n, m) candidate-event
// matrix (inf = masked), the minimum and the lowest column that attains
// it. All-inf rows give (inf, 0); -inf wins its row and resolves to its
// lowest column; a row holding a NaN gives (NaN, 0), as the Pallas body
// does (its min propagates the NaN and `ev == min` is false everywhere).
//
// What bounds it on the H100: memory, and at the fleet engine's widths
// the launch itself. Each element is read once for one comparison; at
// (65536, 8) float64 the 4.98 MB moved take 1.49 us at 3.35 TB/s, less
// than a launch costs.
//
// What this design does about it: nothing more than it must. One thread
// owns one row and scans it from column 0 with a strict `<`, which keeps
// the lowest column on ties; no shared memory, no padding, no second
// pass. A warp's 32 rows are contiguous, so its loads cover one span of
// device memory. The NaN's own bits are returned (the first NaN of the
// row), so the kernel equals its plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
event_select_kernel(const T* __restrict__ ev, T* __restrict__ t_out,
                    int* __restrict__ i_out, long long n, int m) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  const T* r = ev + row * m;
  T best = r[0];
  int arg = 0;
  int nan_at = (best != best) ? 0 : -1;
  for (int j = 1; j < m; ++j) {
    const T v = r[j];
    if (nan_at < 0 && v != v) nan_at = j;
    if (v < best) {
      best = v;
      arg = j;
    }
  }
  if (nan_at >= 0) {
    best = r[nan_at];
    arg = 0;
  }
  t_out[row] = best;
  i_out[row] = arg;
}

template <typename T>
cudaError_t launch(const void* ev, void* t, int* i, long long n, int m,
                   cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  event_select_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(static_cast<const T*>(ev),
                                     static_cast<T*>(t), i, n, m);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float64, 1 = float32. ev is (n, m) contiguous; t is (n,) of
// ev's type and i is (n,) int32. Returns the cudaError_t of the launch.
extern "C" int repro_event_select_fwd(const void* ev, void* t, void* i,
                                      long long n, int m, int dtype,
                                      void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* idx = static_cast<int*>(i);
  if (n <= 0 || m <= 0 || n > (1LL << 38)) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<double>(ev, t, idx, n, m, st);
  if (dtype == 1) return launch<float>(ev, t, idx, n, m, st);
  return cudaErrorInvalidValue;
}
