// K6: out = banded ELL @ X, with no stored band.
//
// Replaces graphlearning_tpu/ops/pallas_spmm.py banded_spmm (kernel
// _banded_kernel).  out[i, q] = sum over the slots j < k of row i whose
// column c = cols[i, j] lies in the window [winstart[i / R], + W) of
// vals[i, j] * X[c, q]; the other slots are the caller's residual.
//
// Bound: bytes.  The function must read the (n, k) slots once and write
// out once; X's rows come through L2 (at the class counts of the solvers X
// is a few MB).  The TPU kernel rebuilt a dense (R, WT) block per window
// tile by k compare/select passes so that its matrix unit could multiply
// it: n * W * k work and n * W * d products.  Here one thread owns one
// (row, column of d) and sums its row's in-window slots in slot order with
// FFMA: n * k * d work, whatever the window's width.  Threads of one row
// read the same slots (a broadcast) and neighbouring columns of X.  bf16
// values and X are widened to f32 on load; their products are exact in
// f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ell_spmm_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                    int k, const int* __restrict__ winstart, int R, int W,
                    const T* __restrict__ X, int d, long long total,
                    float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const long long row = t / d;
  const int q = (int)(t - row * d);
  const int lo = winstart[row / R];
  const int* c = cols + row * k;
  const T* v = vals + row * k;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) {
    const int cj = c[j];
    if ((unsigned int)(cj - lo) >= (unsigned int)W) continue;
    acc = fmaf(to_float(v[j]), to_float(X[(long long)cj * d + q]), acc);
  }
  out[t] = acc;
}

}  // namespace

// cols: (n, k) int32; vals: (n, k) and X: (rows, d), both float32
// (bf16 == 0) or both bfloat16; winstart: (n / R,) int32; out: (n, d)
// float32.  Every column in a window must be a row of X.  Returns
// cudaGetLastError() after the launch.
extern "C" int glt_ell_spmm(const int* cols, const void* vals, int bf16,
                            int k, const int* winstart, long long n, int R,
                            int W, const void* X, int d, float* out,
                            void* stream) {
  const long long total = n * (long long)d;
  if (total > 0) {
    const unsigned int blocks =
        (unsigned int)((total + THREADS - 1) / THREADS);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16) {
      ell_spmm_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
          cols, static_cast<const __nv_bfloat16*>(vals), k, winstart, R, W,
          static_cast<const __nv_bfloat16*>(X), d, total, out);
    } else {
      ell_spmm_kernel<float><<<blocks, THREADS, 0, s>>>(
          cols, static_cast<const float*>(vals), k, winstart, R, W,
          static_cast<const float*>(X), d, total, out);
    }
  }
  return (int)cudaGetLastError();
}
