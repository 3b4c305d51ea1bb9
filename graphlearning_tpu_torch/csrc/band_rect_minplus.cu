// K8: one min-plus (Bellman-Ford or Hopf-Lax) relaxation round over the
// rectangular band.
//
// Replaces graphlearning_tpu/ops/pallas_spmm.py band_minplus (kernel
// _band_minplus_kernel).  Row i of the (n, W) band covers the columns
// winstart[i / R] + [0, W).  Over the cells c of row i with band value
// A > 0 (1/A with RECIP):
//   cand = d[c] + A f[c]                                  (plain)
//   cand = (A f[c] + sqrt((A f[c])^2 + 4 d[c]^2)) / 2     (HOPF)
// out_min[i] = min(1e30, min cand); with ARG, out_arg[i] = the smallest
// column among the least candidates, or -1 when no candidate is below
// 1e30 (the TPU kernel takes the smallest lane within a tile and keeps
// the earlier tile on ties: the same column).
//
// Bound: the band's bytes (a few flops per cell).  Design: K7's CTA.  One
// CTA of 8 warps owns ROWS rows of one row block and walks the block's
// window in chunks of CW columns, so no atomics are needed and the running
// minimum of each row stays in a register of its warp.  Each chunk of d
// and f is staged in shared memory; a warp reads a band row coalesced
// (lane l takes columns l, l + 32, ...) and reduces (min, column) with
// shuffles.  The candidate arithmetic uses the _rn intrinsics, so nvcc
// contracts nothing into an FMA: the result is bit-identical to the same
// f32 operations done one by one, as the plain torch twin does them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 64;                 // rows per CTA
constexpr int ROWS_PER_WARP = ROWS / WARPS;
constexpr float BIG = 1e30f;
constexpr int NO_ARG = 0x7fffffff;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <bool HOPF>
__device__ __forceinline__ float candidate(float a, float d, float f) {
  const float fa = __fmul_rn(a, f);
  if (HOPF) {
    const float q = __fadd_rn(__fmul_rn(fa, fa),
                              __fmul_rn(__fmul_rn(4.0f, d), d));
    return __fmul_rn(0.5f, __fadd_rn(fa, __fsqrt_rn(q)));
  }
  return __fadd_rn(d, fa);
}

template <typename T, bool HOPF, bool RECIP, bool ARG>
__global__ void __launch_bounds__(THREADS)
    rect_minplus_kernel(const T* __restrict__ band, int W, int R, int CW,
                        const int* __restrict__ winstart,
                        const float* __restrict__ d,
                        const float* __restrict__ f,
                        float* __restrict__ out_min,
                        int* __restrict__ out_arg) {
  extern __shared__ float smem[];
  float* dw = smem;        // d over the current chunk of the window
  float* fw = smem + CW;   // f over it
  const int groups = R / ROWS;
  const long long b = blockIdx.x / groups;
  const int rg = (int)(blockIdx.x - b * groups);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row0 = b * R + rg * ROWS + warp * ROWS_PER_WARP;
  const int ws = winstart[b];

  float best[ROWS_PER_WARP];
  int barg[ROWS_PER_WARP];
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    best[q] = BIG;
    barg[q] = -1;
  }

  for (int c0 = 0; c0 < W; c0 += CW) {
    const int cw = min(CW, W - c0);
    const int base = ws + c0;
    __syncthreads();  // the previous chunk's reads of dw / fw are done
    for (int i = threadIdx.x; i < cw; i += THREADS) {
      dw[i] = d[base + i];
      fw[i] = f[base + i];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      const T* arow = band + (row0 + q) * W + c0;
      float m = BIG;
      int a = NO_ARG;
      for (int c = lane; c < cw; c += 32) {
        float v = to_float(arow[c]);
        if (!(v > 0.0f)) continue;
        if (RECIP) v = __fdiv_rn(1.0f, v);
        const float cand = candidate<HOPF>(v, dw[c], fw[c]);
        if (cand < m) {  // columns ascend per lane: the smallest wins ties
          m = cand;
          a = c;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float m2 = __shfl_down_sync(0xffffffffu, m, off);
        const int a2 = __shfl_down_sync(0xffffffffu, a, off);
        if (m2 < m || (m2 == m && a2 < a)) {
          m = m2;
          a = a2;
        }
      }
      if (m < best[q]) {  // strict: the earlier chunk wins ties
        best[q] = m;
        barg[q] = base + a;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      out_min[row0 + q] = best[q];
      if (ARG) out_arg[row0 + q] = barg[q];
    }
  }
}

template <typename T, bool HOPF, bool RECIP, bool ARG>
int launch(const void* band, int W, int R, int CW, const int* winstart,
           long long nblocks, const float* d, const float* f, float* out_min,
           int* out_arg, cudaStream_t s) {
  const long long ctas = nblocks * (R / ROWS);
  if (ctas > 0) {
    const size_t shmem = 2 * (size_t)CW * sizeof(float);
    rect_minplus_kernel<T, HOPF, RECIP, ARG><<<(unsigned int)ctas, THREADS,
                                               shmem, s>>>(
        static_cast<const T*>(band), W, R, CW, winstart, d, f, out_min,
        out_arg);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* band, int W, int R, int CW, const int* winstart,
             long long nblocks, const float* d, const float* f,
             float* out_min, int* out_arg, int hopf, int recip, int track,
             cudaStream_t s) {
#define GLT_LAUNCH(H, RC, A)                                               \
  return launch<T, H, RC, A>(band, W, R, CW, winstart, nblocks, d, f,     \
                             out_min, out_arg, s)
  if (hopf) {
    if (recip) {
      if (track) GLT_LAUNCH(true, true, true);
      GLT_LAUNCH(true, true, false);
    }
    if (track) GLT_LAUNCH(true, false, true);
    GLT_LAUNCH(true, false, false);
  }
  if (recip) {
    if (track) GLT_LAUNCH(false, true, true);
    GLT_LAUNCH(false, true, false);
  }
  if (track) GLT_LAUNCH(false, false, true);
  GLT_LAUNCH(false, false, false);
#undef GLT_LAUNCH
}

}  // namespace

// band: (nblocks*R, W) float32 (band_bf16 == 0) or bfloat16; winstart:
// (nblocks,) int32; d, f: float32 of at least max(winstart) + W entries;
// out_min: (nblocks*R,) float32; out_arg: (nblocks*R,) int32 when
// track != 0 (may be null otherwise).  R must be a multiple of 64 and CW
// at most 6144.  Returns cudaGetLastError() after the launch.
extern "C" int glt_rect_minplus(const void* band, int band_bf16, int W,
                                int R, int CW, const int* winstart,
                                long long nblocks, const float* d,
                                const float* f, float* out_min,
                                int* out_arg, int hopf, int recip, int track,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_bf16) {
    return dispatch<__nv_bfloat16>(band, W, R, CW, winstart, nblocks, d, f,
                                   out_min, out_arg, hopf, recip, track, s);
  }
  return dispatch<float>(band, W, R, CW, winstart, nblocks, d, f, out_min,
                         out_arg, hopf, recip, track, s);
}
