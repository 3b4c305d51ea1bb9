// K9: the reductions of one Lipschitz (p-Laplace / AMLE) round over the
// live chunks of the unpacked tiled band.
//
// Replaces graphlearning_tpu/ops/pallas_spmm.py band_tiles_lip (kernel
// _tiles_lip_kernel).  For each output row i and class q < C, over the
// cells c of its row block's tiles with band value A:
//   sums[i, q] = sum A U[c, q]
//   mins[i, q] = min over A > 0 of U[c, q]   (3e38 where there is none)
//   maxs[i, q] = max over A > 0 of U[c, q]   (-3e38 where there is none)
//
// Layout and list: as K7 (band_tiles_minplus.cu); U is (rows, C)
// row-major.  A skipped chunk holds only zero cells, which add nothing.
//
// Bound: the bytes of the band's live chunks at small C; near C = 32 the
// f32 instruction rate on the nonzero cells (a multiply-add and a compare
// pair per cell and class).  Design: K7's walk (one warp a row group, two lanes
// a row, HALF columns a lane from 16-byte loads, the next chunk's loads
// started before the current chunk is reduced).  The chunk's KC rows of U
// (KC * C contiguous floats) go to a per-warp stage in shared memory by
// 16-byte cp.async, also one chunk ahead, two stages a warp.  A lane makes
// a mask of its nonzero cells from the loaded values and visits only
// those: it reads the cell again (an L1 hit) and its C values of U from
// the stage, adds A U into its row's C sums (exact f32 FFMA; a bf16 band
// is widened on load) and, for A > 0, takes the C mins and maxes, all in
// registers.  One __shfl_xor_sync a value combines the two lanes of a
// row, and the row's outputs are written once, split between its lanes:
// no atomics.  The min and max test A > 0 on the stored value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;     // output rows per warp: a row group of the list
constexpr int KC = 32;       // band columns per chunk
constexpr int HALF = KC / 2;  // columns per lane
constexpr int WARPS = 4;     // warps (row groups) per CTA
constexpr int THREADS = 32 * WARPS;
constexpr float BIG = 3e38f;
constexpr unsigned FULL = 0xffffffffu;

// A lane's HALF cells of one chunk row as stored: kept raw until the chunk
// is reduced, so the loads stay in flight meanwhile.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  float4 q[HALF / 4];
};
template <>
struct Raw<__nv_bfloat16> {
  uint4 q[HALF / 8];
};

__device__ __forceinline__ void load(Raw<float>& r, const float* p) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < HALF / 4; ++j) r.q[j] = __ldg(v + j);
}
__device__ __forceinline__ void load(Raw<__nv_bfloat16>& r,
                                     const __nv_bfloat16* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j) r.q[j] = __ldg(v + j);
}

// bit k set where cell k of the lane's HALF is nonzero (-0 is zero)
__device__ __forceinline__ unsigned nonzero(const Raw<float>& r) {
  unsigned mask = 0;
#pragma unroll
  for (int j = 0; j < HALF / 4; ++j) {
    const float4 t = r.q[j];
    mask |= ((__float_as_uint(t.x) << 1) != 0u) << (4 * j);
    mask |= ((__float_as_uint(t.y) << 1) != 0u) << (4 * j + 1);
    mask |= ((__float_as_uint(t.z) << 1) != 0u) << (4 * j + 2);
    mask |= ((__float_as_uint(t.w) << 1) != 0u) << (4 * j + 3);
  }
  return mask;
}
__device__ __forceinline__ unsigned nonzero(const Raw<__nv_bfloat16>& r) {
  unsigned mask = 0;
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j) {
    const unsigned w[4] = {r.q[j].x, r.q[j].y, r.q[j].z, r.q[j].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mask |= ((w[e] & 0x7fffu) != 0u) << (8 * j + 2 * e);
      mask |= ((w[e] & 0x7fff0000u) != 0u) << (8 * j + 2 * e + 1);
    }
  }
  return mask;
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(gmem));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// the lane's copies of all but the newest group have landed
__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One chunk as a lane loads it: its cells and where they lie.
template <typename T>
struct Chunk {
  Raw<T> a;
  const T* cells;  // the lane's first cell
};

template <typename T, int CC>
__global__ void __launch_bounds__(THREADS)
    tiles_lip_kernel(const T* __restrict__ band, int R, int WT,
                     const int* __restrict__ chunk_ptr,
                     const int* __restrict__ chunk_id,
                     const int* __restrict__ tile_start, long long groups,
                     const float* __restrict__ U, int C,
                     float* __restrict__ sums, float* __restrict__ mins,
                     float* __restrict__ maxs) {
  // each warp's two stages of a chunk's KC rows of U
  __shared__ __align__(16) float stage[WARPS][2][KC * CC];
  const long long grp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (grp >= groups) return;  // the whole warp
  const int lane = threadIdx.x & 31, h = lane & 1;
  const long long row = grp * ROWS + (lane >> 1);
  const int rin = (int)(row % R);  // the row within its block's tiles
  const int cpt = WT / KC;
  const int beg = chunk_ptr[grp], end = chunk_ptr[grp + 1];
  float(*ustage)[KC * CC] = stage[threadIdx.x / 32];

  // the list's entries beg + 32 w + lane, with their tile starts
  int w_id = 0, w_st = 0;
  auto window = [&](int e) {
    if (e < end) {
      w_id = chunk_id[e];
      w_st = tile_start[w_id / cpt];
    }
  };
  // chunk i's cells into ch and its rows of U into stage (i - beg) % 2;
  // past the list an empty copy group keeps the count of groups uniform
  auto fetch = [&](Chunk<T>& ch, int i) {
    if (i < end) {
      const int j = (i - beg) & 31;
      if (j == 0) window(i + lane);
      const int id = __shfl_sync(FULL, w_id, j);
      const int st = __shfl_sync(FULL, w_st, j);
      const int tile = id / cpt, c0 = (id - tile * cpt) * KC;
      ch.cells = band + ((long long)tile * R + rin) * WT + c0 + h * HALF;
      load(ch.a, ch.cells);
      const float* src = U + (long long)(st + c0) * C;
      float* dst = ustage[(i - beg) & 1];
      for (int p = lane; p < KC * C / 4; p += 32)  // its 16-byte pieces
        cp16(dst + 4 * p, src + 4 * p);
    }
    cp_commit();
  };

  float s[CC], mn[CC], mx[CC];
#pragma unroll
  for (int q = 0; q < CC; ++q) {
    s[q] = 0.f;
    mn[q] = BIG;
    mx[q] = -BIG;
  }
  auto reduce = [&](const Chunk<T>& ch, int i) {
    cp_wait_all_but_one();  // chunk i's rows of U: this lane's copies
    __syncwarp();           // ... and the warp's
    const float* us = ustage[(i - beg) & 1] + h * HALF * C;
    for (unsigned mask = nonzero(ch.a); mask; mask &= mask - 1) {
      const int k = __ffs(mask) - 1;
      const float a = to_float(__ldg(ch.cells + k));
      const float* u = us + k * C;
      const bool pos = a > 0.f;
#pragma unroll
      for (int q = 0; q < CC; ++q) {
        if (q < C) {
          const float v = u[q];
          s[q] = fmaf(a, v, s[q]);
          if (pos) {
            mn[q] = fminf(mn[q], v);
            mx[q] = fmaxf(mx[q], v);
          }
        }
      }
    }
  };

  // two buffers in turn: chunk i + 1 is loading while chunk i is reduced;
  // the warp syncs before a stage is filled again
  Chunk<T> c0, c1;
  if (beg < end) fetch(c0, beg);
  for (int i = beg; i < end; i += 2) {
    fetch(c1, i + 1);
    reduce(c0, i);
    if (i + 1 >= end) break;
    __syncwarp();
    fetch(c0, i + 2);
    reduce(c1, i + 1);
    __syncwarp();
  }

#pragma unroll
  for (int q = 0; q < CC; ++q) {
    s[q] += __shfl_xor_sync(FULL, s[q], 1);
    mn[q] = fminf(mn[q], __shfl_xor_sync(FULL, mn[q], 1));
    mx[q] = fmaxf(mx[q], __shfl_xor_sync(FULL, mx[q], 1));
    if (q < C && (q & 1) == h) {
      sums[row * C + q] = s[q];
      mins[row * C + q] = mn[q];
      maxs[row * C + q] = mx[q];
    }
  }
}

struct Args {
  const void* band;
  int R, WT;
  const int* chunk_ptr;
  const int* chunk_id;
  const int* tile_start;
  long long groups;
  const float* U;
  int C;
  float* sums;
  float* mins;
  float* maxs;
};

template <typename T, int CC>
int launch(const Args& a, cudaStream_t s) {
  const long long ctas = (a.groups + WARPS - 1) / WARPS;
  if (ctas > 0) {
    tiles_lip_kernel<T, CC><<<(unsigned int)ctas, THREADS, 0, s>>>(
        static_cast<const T*>(a.band), a.R, a.WT, a.chunk_ptr, a.chunk_id,
        a.tile_start, a.groups, a.U, a.C, a.sums, a.mins, a.maxs);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_c(const Args& a, cudaStream_t s) {
  if (a.C <= 1) return launch<T, 1>(a, s);
  if (a.C <= 2) return launch<T, 2>(a, s);
  if (a.C <= 4) return launch<T, 4>(a, s);
  if (a.C <= 8) return launch<T, 8>(a, s);
  if (a.C <= 16) return launch<T, 16>(a, s);
  return launch<T, 32>(a, s);
}

}  // namespace

// band: (G*R, WT) float32 (band_bf16 == 0) or bfloat16, 16-byte aligned;
// chunk_ptr, chunk_id, tile_start: as K7's (band_tiles_minplus.cu); U:
// (rows, C) float32 with rows >= max(tile_start) + WT and 1 <= C <= 32;
// sums, mins, maxs: (groups*ROWS, C) float32.  R must be a multiple of
// ROWS and WT of KC.  Returns cudaGetLastError() after the launch.
extern "C" int glt_tiles_lip(const void* band, int band_bf16, int R, int WT,
                             const int* chunk_ptr, const int* chunk_id,
                             const int* tile_start, long long groups,
                             const float* U, int C, float* sums, float* mins,
                             float* maxs, void* stream) {
  if (R % ROWS || WT % KC || C < 1 || C > 32)
    return (int)cudaErrorInvalidValue;
  const Args a{band, R, WT, chunk_ptr, chunk_id, tile_start, groups, U, C,
               sums, mins, maxs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_bf16) return launch_c<__nv_bfloat16>(a, s);
  return launch_c<float>(a, s);
}
