// K4: build the rectangular (n, W) band from the padded ELL graph.
//
// Replaces graphlearning_tpu/ops/pallas_spmm.py materialize_band (kernel
// _band_build_kernel).  Row i of the band holds, at column c, the sum of
// that ELL row's slots whose column is winstart[i / R] + c, for c in
// [0, W); slots outside the window are dropped.
//
// Bound: bytes.  The band is zeroed by the caller.  One thread owns one
// (row, chunk of CW window columns): it reads the row's k slots (k <= 32 in
// practice) and writes its in-chunk cells, so no atomics are needed.  A
// column's duplicate slots are summed in f32 in slot order and rounded
// once, which matches the TPU kernel for both an f32 and a bf16 band.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TO>
__global__ void rect_build_kernel(const int* __restrict__ cols,
                                  const float* __restrict__ vals, int k,
                                  const int* __restrict__ winstart,
                                  long long n, int R, int W, int CW,
                                  TO* __restrict__ out) {
  const int nchunks = W / CW;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * nchunks) return;
  const long long row = t / nchunks;
  const int chunk = (int)(t - row * nchunks);
  const int base = winstart[row / R] + chunk * CW;
  const int* c = cols + row * k;
  const float* v = vals + row * k;
  TO* o = out + row * (long long)W + (long long)chunk * CW;
  for (int j = 0; j < k; ++j) {
    const int cj = c[j];
    const int lj = cj - base;
    if (lj < 0 || lj >= CW) continue;
    bool seen = false;
    for (int i = 0; i < j; ++i) {
      if (c[i] == cj) {
        seen = true;
        break;
      }
    }
    if (seen) continue;  // summed when its first slot came up
    float s = v[j];
    for (int i = j + 1; i < k; ++i) {
      if (c[i] == cj) s += v[i];
    }
    o[lj] = from_float<TO>(s);
  }
}

}  // namespace

// cols, vals: (n, k) int32 / float32; winstart: (n / R,) int32; out:
// (n, W) float32 (out_bf16 == 0) or bfloat16, zeroed.  W must be a
// multiple of CW.  Returns cudaGetLastError() after the launch.
extern "C" int glt_rect_build(const int* cols, const float* vals, int k,
                              const int* winstart, long long n, int R, int W,
                              int CW, void* out, int out_bf16, void* stream) {
  const long long total = n * (long long)(W / CW);
  if (total > 0) {
    const int threads = 256;
    const unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (out_bf16) {
      rect_build_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
          cols, vals, k, winstart, n, R, W, CW,
          static_cast<__nv_bfloat16*>(out));
    } else {
      rect_build_kernel<float><<<blocks, threads, 0, s>>>(
          cols, vals, k, winstart, n, R, W, CW, static_cast<float*>(out));
    }
  }
  return (int)cudaGetLastError();
}
