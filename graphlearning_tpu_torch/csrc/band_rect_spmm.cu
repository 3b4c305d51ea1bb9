// K5: out = rectangular band @ X window.
//
// Replaces graphlearning_tpu/ops/pallas_spmm.py band_spmm (kernel
// _band_matmul_kernel).  Row i of the (n, W) band holds the weights of the
// X rows winstart[i / R] + [0, W); out[i] = band[i, :] @ X[that window].
//
// Bound: the band's bytes at small d (about d/4 FFMA per f32 band byte,
// and every band cell is read, zero or not); near d = 128 the f32 FFMA
// issue rate.  Design: K3's CTA.  One CTA of ROWS threads owns ROWS output
// rows of one row block and a chunk of DC output columns.  It walks the
// block's window in steps of KC columns, staging the KC band columns of
// its rows (coalesced, a warp per row segment) and the KC matching X rows
// through shared memory, and accumulates in registers with FFMA.  Each
// output element is written once: no atomics and no zeroing pass.  bf16
// operands are widened to f32 on load; their products are exact in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 128;  // output rows per CTA, one per thread
constexpr int KC = 32;     // band columns staged per step

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int DC>
__global__ void __launch_bounds__(ROWS)
    rect_spmm_kernel(const T* __restrict__ band, int W, int R,
                     const int* __restrict__ winstart,
                     const T* __restrict__ X, int d, int nchunks,
                     float* __restrict__ out) {
  __shared__ float bs[ROWS][KC + 1];  // +1: conflict-free row reads
  __shared__ float xs[KC][DC];
  const int tid = threadIdx.x;
  const int chunk = (int)(blockIdx.x % nchunks);
  const long long grp = blockIdx.x / nchunks;
  const int groups = R / ROWS;
  const long long b = grp / groups;
  const int rg = (int)(grp - b * groups);
  const int dc0 = chunk * DC;
  const long long row0 = b * R + rg * ROWS;
  const T* brow0 = band + row0 * W;
  const long long x0 = winstart[b];

  float acc[DC];
#pragma unroll
  for (int q = 0; q < DC; ++q) acc[q] = 0.f;

  for (int c0 = 0; c0 < W; c0 += KC) {
    __syncthreads();  // previous step's reads of bs / xs are done
    for (int i = tid; i < ROWS * KC; i += ROWS) {
      const int rr = i / KC, cc = i % KC;
      bs[rr][cc] = to_float(brow0[(long long)rr * W + c0 + cc]);
    }
    for (int i = tid; i < KC * DC; i += ROWS) {
      const int rr = i / DC, q = i % DC;
      const int col = dc0 + q;
      xs[rr][q] = col < d ? to_float(X[(x0 + c0 + rr) * d + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const float a = bs[tid][j];
#pragma unroll
      for (int q = 0; q < DC; ++q) acc[q] = fmaf(a, xs[j][q], acc[q]);
    }
  }
  float* orow = out + (row0 + tid) * (long long)d + dc0;
#pragma unroll
  for (int q = 0; q < DC; ++q) {
    if (dc0 + q < d) orow[q] = acc[q];
  }
}

template <typename T, int DC>
int launch(const void* band, int W, int R, const int* winstart,
           long long nblocks, const void* X, int d, float* out,
           cudaStream_t s) {
  const int nchunks = (d + DC - 1) / DC;
  const long long ctas = nblocks * (R / ROWS) * nchunks;
  if (ctas > 0) {
    rect_spmm_kernel<T, DC><<<(unsigned int)ctas, ROWS, 0, s>>>(
        static_cast<const T*>(band), W, R, winstart,
        static_cast<const T*>(X), d, nchunks, out);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dc(const void* band, int W, int R, const int* winstart,
              long long nblocks, const void* X, int d, float* out,
              cudaStream_t s) {
#define GLT_LAUNCH(DC) \
  return launch<T, DC>(band, W, R, winstart, nblocks, X, d, out, s)
  if (d <= 1) GLT_LAUNCH(1);
  if (d <= 2) GLT_LAUNCH(2);
  if (d <= 4) GLT_LAUNCH(4);
  if (d <= 8) GLT_LAUNCH(8);
  if (d <= 16) GLT_LAUNCH(16);
  GLT_LAUNCH(32);
#undef GLT_LAUNCH
}

}  // namespace

// band: (nblocks*R, W) float32 (band_bf16 == 0) or bfloat16; winstart:
// (nblocks,) int32; X: (rows, d) of the band's type with rows >=
// max(winstart) + W; out: (nblocks*R, d) float32.  R must be a multiple of
// 128 and W of 32.  Returns cudaGetLastError() after the launch.
extern "C" int glt_rect_spmm(const void* band, int band_bf16, int W, int R,
                             const int* winstart, long long nblocks,
                             const void* X, int d, float* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_bf16) {
    return launch_dc<__nv_bfloat16>(band, W, R, winstart, nblocks, X, d, out,
                                    s);
  }
  return launch_dc<float>(band, W, R, winstart, nblocks, X, d, out, s);
}
