// K9: the reductions of one Lipschitz (p-Laplace / AMLE) round over the
// unpacked tiled band.
//
// Replaces graphlearning_tpu/ops/pallas_spmm.py band_tiles_lip (kernel
// _tiles_lip_kernel).  For each output row i and class q < C, over the
// cells c of its row block's tiles with band value A:
//   sums[i, q] = sum A U[c, q]
//   mins[i, q] = min over A > 0 of U[c, q]   (3e38 where there is none)
//   maxs[i, q] = max over A > 0 of U[c, q]   (-3e38 where there is none)
//
// Layout: as K7 (band_tiles_minplus.cu); U is (rows, C) row-major.
//
// Bound: the band's bytes at small C; near C = 32 the f32 issue rate (a
// multiply-add and a compare pair per cell and class).  Design: the one of
// K2/K3 (band_tiles_spmm.cu): one CTA of ROWS threads owns ROWS rows of one
// row block, walks that block's tiles in order (no atomics), stages KC band
// columns of its rows (coalesced) and the KC matching rows of U through
// shared memory, and keeps each row's C sums (exact f32 FFMA; a bf16 band
// is widened on load), mins and maxes in registers.  Each output element
// is written once.  The min and max test A > 0 on the stored value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 128;  // rows per CTA, one per thread
constexpr int KC = 32;     // band columns staged per step
constexpr float BIG = 3e38f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int CC>
__global__ void __launch_bounds__(ROWS)
    tiles_lip_kernel(const T* __restrict__ band, int R, int WT,
                     const int* __restrict__ block_ptr,
                     const int* __restrict__ tile_start,
                     const float* __restrict__ U, int C,
                     float* __restrict__ sums, float* __restrict__ mins,
                     float* __restrict__ maxs) {
  __shared__ float bs[ROWS][KC + 1];  // +1: conflict-free row reads
  __shared__ float us[KC][CC];
  const int tid = threadIdx.x;
  const int groups = R / ROWS;
  const long long b = blockIdx.x / groups;
  const int rg = (int)(blockIdx.x - b * groups);

  float s[CC], mn[CC], mx[CC];
#pragma unroll
  for (int q = 0; q < CC; ++q) {
    s[q] = 0.f;
    mn[q] = BIG;
    mx[q] = -BIG;
  }

  const int tile_end = block_ptr[b + 1];
  for (int tile = block_ptr[b]; tile < tile_end; ++tile) {
    const T* brow0 = band + ((long long)tile * R + rg * ROWS) * WT;
    const long long base = tile_start[tile];
    for (int c0 = 0; c0 < WT; c0 += KC) {
      __syncthreads();  // the previous step's reads of bs / us are done
      for (int i = tid; i < ROWS * KC; i += ROWS) {
        const int rr = i / KC, cc = i % KC;
        bs[rr][cc] = to_float(brow0[(long long)rr * WT + c0 + cc]);
      }
      for (int i = tid; i < KC * CC; i += ROWS) {
        const int rr = i / CC, q = i % CC;
        us[rr][q] = q < C ? U[(base + c0 + rr) * C + q] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < KC; ++j) {
        const float a = bs[tid][j];
#pragma unroll
        for (int q = 0; q < CC; ++q) s[q] = fmaf(a, us[j][q], s[q]);
        if (a > 0.f) {
#pragma unroll
          for (int q = 0; q < CC; ++q) {
            mn[q] = fminf(mn[q], us[j][q]);
            mx[q] = fmaxf(mx[q], us[j][q]);
          }
        }
      }
    }
  }
  const long long row = b * R + rg * ROWS + tid;
#pragma unroll
  for (int q = 0; q < CC; ++q) {
    if (q < C) {
      sums[row * C + q] = s[q];
      mins[row * C + q] = mn[q];
      maxs[row * C + q] = mx[q];
    }
  }
}

template <typename T, int CC>
int launch(const void* band, int R, int WT, const int* block_ptr,
           const int* tile_start, long long nblocks, const float* U, int C,
           float* sums, float* mins, float* maxs, cudaStream_t s) {
  const long long ctas = nblocks * (R / ROWS);
  if (ctas > 0) {
    tiles_lip_kernel<T, CC><<<(unsigned int)ctas, ROWS, 0, s>>>(
        static_cast<const T*>(band), R, WT, block_ptr, tile_start, U, C, sums,
        mins, maxs);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_c(const void* band, int R, int WT, const int* block_ptr,
             const int* tile_start, long long nblocks, const float* U, int C,
             float* sums, float* mins, float* maxs, cudaStream_t s) {
#define GLT_LAUNCH(CC)                                                      \
  return launch<T, CC>(band, R, WT, block_ptr, tile_start, nblocks, U, C,   \
                       sums, mins, maxs, s)
  if (C <= 1) GLT_LAUNCH(1);
  if (C <= 2) GLT_LAUNCH(2);
  if (C <= 4) GLT_LAUNCH(4);
  if (C <= 8) GLT_LAUNCH(8);
  if (C <= 16) GLT_LAUNCH(16);
  GLT_LAUNCH(32);
#undef GLT_LAUNCH
}

}  // namespace

// band: (G*R, WT) float32 (band_bf16 == 0) or bfloat16; U: (rows, C)
// float32 with rows >= max(tile_start) + WT and 1 <= C <= 32; sums, mins,
// maxs: (nblocks*R, C) float32.  R must be a multiple of 128 and WT of 32.
// Returns cudaGetLastError() after the launch.
extern "C" int glt_tiles_lip(const void* band, int band_bf16, int R, int WT,
                             const int* block_ptr, const int* tile_start,
                             long long nblocks, const float* U, int C,
                             float* sums, float* mins, float* maxs,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_bf16) {
    return launch_c<__nv_bfloat16>(band, R, WT, block_ptr, tile_start,
                                   nblocks, U, C, sums, mins, maxs, s);
  }
  return launch_c<float>(band, R, WT, block_ptr, tile_start, nblocks, U, C,
                         sums, mins, maxs, s);
}
