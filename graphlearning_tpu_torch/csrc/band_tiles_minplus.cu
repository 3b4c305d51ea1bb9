// K7: one min-plus (Bellman-Ford or Hopf-Lax) relaxation round over the
// live chunks of the unpacked tiled band.
//
// Replaces graphlearning_tpu/ops/pallas_spmm.py band_tiles_minplus (kernel
// _tiles_minplus_kernel).  For each output row i, over the cells c of its
// row block's tiles with band value A > 0 (1/A with RECIP):
//   cand = d[c] + A f[c]                                  (plain)
//   cand = (A f[c] + sqrt((A f[c])^2 + 4 d[c]^2)) / 2     (HOPF)
// out_min[i] = min(1e30, min cand); with ARG, out_arg[i] = the column of
// the least candidate (earlier tile, then smaller column, on ties), or -1
// when no candidate is below 1e30.
//
// Layout: tile g is band rows [g*R, g*R + R) of a (G*R, WT) band and
// covers columns [tile_start[g], + WT).  The live-chunk list
// (ops/band_spmm.py tiles_live_chunks) names, for each ROWS-row group of
// the output, the (ROWS, KC) chunks of its row block's tiles that hold a
// nonzero cell: chunk_id[chunk_ptr[i] .. chunk_ptr[i + 1]), entry
// g * (WT / KC) + c for columns [c*KC, c*KC + KC) of tile g, by tile in
// plan order, then by c.  A skipped chunk holds no cell A > 0, so no
// candidate.  On the smoke's band 6.7 % of the chunks are live.
//
// Bound: the bytes of the band's live chunks (a few flops per cell).
// Design: one warp owns one row group and walks its live chunks; two lanes
// serve each row, each taking HALF of the chunk's columns with 16-byte
// loads of the cells (64 B f32, 32 B bf16) and of their d and f, straight
// from global memory (d and f stay in L2).  The next chunk's loads are
// started before the current chunk is reduced, so a warp keeps about 2 KB
// in flight; the list's entries are read 32 at a time, one a lane, and
// broadcast by shuffles.  No shared memory and no barrier.  Each lane keeps
// its row's least candidate, its column and its place in the list order
// (a later cell wins only when strictly smaller); one __shfl_xor_sync
// combines the two lanes, the earlier place on ties: the first least
// candidate in tile order, then column order, as the TPU kernel and the
// twin give.  Each output is written once: no atomics.  The candidate
// arithmetic uses the _rn intrinsics, so nvcc contracts nothing into an
// FMA: the result is bit-identical to the same f32 operations done one by
// one, as the plain torch twin does them.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;     // output rows per warp: a row group of the list
constexpr int KC = 32;       // band columns per chunk
constexpr int HALF = KC / 2;  // columns per lane
constexpr int WARPS = 4;     // warps (row groups) per CTA
constexpr int THREADS = 32 * WARPS;
constexpr float BIG = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

// A lane's HALF cells of one chunk row as stored, or HALF f32 values: kept
// raw until the chunk is reduced, so the loads stay in flight meanwhile.
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

__device__ __forceinline__ float part(const float4& t, int j) {
  return j == 0 ? t.x : j == 1 ? t.y : j == 2 ? t.z : t.w;
}
__device__ __forceinline__ unsigned part(const uint4& t, int j) {
  return j == 0 ? t.x : j == 1 ? t.y : j == 2 ? t.z : t.w;
}

// cell k of a lane's HALF (k a constant after unrolling), exact in f32
__device__ __forceinline__ float cell(const Raw<float>& r, int k) {
  return part(r.q[k >> 2], k & 3);
}
__device__ __forceinline__ float cell(const Raw<__nv_bfloat16>& r, int k) {
  const unsigned w = part(r.q[k >> 3], (k >> 1) & 3);
  return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
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

// One chunk as a lane loads it: its cells, d and f, and where it lies.
template <typename T>
struct Chunk {
  Raw<T> a;
  Raw<float> d, f;
  int col;  // absolute column of the lane's first cell
};

template <typename T, bool HOPF, bool RECIP, bool ARG>
__global__ void __launch_bounds__(THREADS)
    tiles_minplus_kernel(const T* __restrict__ band, int R, int WT,
                         const int* __restrict__ chunk_ptr,
                         const int* __restrict__ chunk_id,
                         const int* __restrict__ tile_start,
                         long long groups, const float* __restrict__ d,
                         const float* __restrict__ f,
                         float* __restrict__ out_min,
                         int* __restrict__ out_arg) {
  const long long grp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (grp >= groups) return;  // the whole warp
  const int lane = threadIdx.x & 31, h = lane & 1;
  const long long row = grp * ROWS + (lane >> 1);
  const int rin = (int)(row % R);  // the row within its block's tiles
  const int cpt = WT / KC;
  const int beg = chunk_ptr[grp], end = chunk_ptr[grp + 1];

  // the list's entries beg + 32 w + lane, with their tile starts
  int w_id = 0, w_st = 0;
  auto window = [&](int e) {
    if (e < end) {
      w_id = chunk_id[e];
      w_st = tile_start[w_id / cpt];
    }
  };
  auto fetch = [&](Chunk<T>& ch, int i) {
    const int j = (i - beg) & 31;
    if (j == 0) window(i + lane);
    const int id = __shfl_sync(FULL, w_id, j);
    const int st = __shfl_sync(FULL, w_st, j);
    const int tile = id / cpt, cin = (id - tile * cpt) * KC + h * HALF;
    load(ch.a, band + ((long long)tile * R + rin) * WT + cin);
    load(ch.d, d + st + cin);
    load(ch.f, f + st + cin);
    ch.col = st + cin;
  };

  float m = BIG;
  int arg = -1, at = INT_MAX;  // the least candidate's column and place
  auto reduce = [&](const Chunk<T>& ch, int i) {
    const int at0 = (i - beg) * KC + h * HALF;
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      float v = cell(ch.a, k);
      if (!(v > 0.0f)) continue;
      if (RECIP) v = __fdiv_rn(1.0f, v);
      const float cand = candidate<HOPF>(v, cell(ch.d, k), cell(ch.f, k));
      if (cand < m) {  // the lane's cells come in list order
        m = cand;
        if (ARG) {
          arg = ch.col + k;
          at = at0 + k;
        }
      }
    }
  };

  // two buffers in turn: chunk i + 1 is loading while chunk i is reduced
  Chunk<T> c0, c1;
  if (beg < end) fetch(c0, beg);
  for (int i = beg; i < end; i += 2) {
    if (i + 1 < end) fetch(c1, i + 1);
    reduce(c0, i);
    if (i + 1 >= end) break;
    if (i + 2 < end) fetch(c0, i + 2);
    reduce(c1, i + 1);
  }

  const float m2 = __shfl_xor_sync(FULL, m, 1);
  if (ARG) {
    const int arg2 = __shfl_xor_sync(FULL, arg, 1);
    const int at2 = __shfl_xor_sync(FULL, at, 1);
    if (m2 < m || (m2 == m && at2 < at)) {
      m = m2;
      arg = arg2;
    }
  } else {
    m = fminf(m, m2);
  }
  if (h == 0) {
    out_min[row] = m;
    if (ARG) out_arg[row] = m < BIG ? arg : -1;
  }
}

struct Args {
  const void* band;
  int R, WT;
  const int* chunk_ptr;
  const int* chunk_id;
  const int* tile_start;
  long long groups;
  const float* d;
  const float* f;
  float* out_min;
  int* out_arg;
};

template <typename T, bool HOPF, bool RECIP, bool ARG>
int launch(const Args& a, cudaStream_t s) {
  const long long ctas = (a.groups + WARPS - 1) / WARPS;
  if (ctas > 0) {
    tiles_minplus_kernel<T, HOPF, RECIP, ARG>
        <<<(unsigned int)ctas, THREADS, 0, s>>>(
            static_cast<const T*>(a.band), a.R, a.WT, a.chunk_ptr,
            a.chunk_id, a.tile_start, a.groups, a.d, a.f, a.out_min,
            a.out_arg);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int hopf, int recip, int track,
             cudaStream_t s) {
#define GLT_LAUNCH(H, RC, A) return launch<T, H, RC, A>(a, s)
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

// band: (G*R, WT) float32 (band_bf16 == 0) or bfloat16, 16-byte aligned;
// chunk_ptr (groups + 1,) and chunk_id: int32, the live chunks of each
// ROWS-row group of the output (groups = nblocks*R / ROWS), as above;
// tile_start: (G,) int32, multiples of WT; d, f: float32, 16-byte aligned,
// of at least max(tile_start) + WT entries; out_min: (groups*ROWS,)
// float32; out_arg: (groups*ROWS,) int32 when track != 0 (may be null
// otherwise).  R must be a multiple of ROWS and WT of KC.  Returns
// cudaGetLastError() after the launch.
extern "C" int glt_tiles_minplus(const void* band, int band_bf16, int R,
                                 int WT, const int* chunk_ptr,
                                 const int* chunk_id, const int* tile_start,
                                 long long groups, const float* d,
                                 const float* f, float* out_min,
                                 int* out_arg, int hopf, int recip,
                                 int track, void* stream) {
  if (R % ROWS || WT % KC) return (int)cudaErrorInvalidValue;
  const Args a{band, R, WT, chunk_ptr, chunk_id, tile_start, groups, d, f,
               out_min, out_arg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_bf16) return dispatch<__nv_bfloat16>(a, hopf, recip, track, s);
  return dispatch<float>(a, hopf, recip, track, s);
}
