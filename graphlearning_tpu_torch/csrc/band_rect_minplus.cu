// K8: one min-plus (Bellman-Ford or Hopf-Lax) relaxation round over the
// live chunks of the rectangular band.
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
// Bound: the bytes of the band's live chunks (a few flops per cell).  The
// list of live chunks (ops/band_spmm.py rect_live_chunks) names, for the
// ROWS-row group of CTA i, the KC-column chunks that hold a nonzero cell,
// ascending: chunk_col[chunk_ptr[i] .. chunk_ptr[i + 1]).  A skipped chunk
// holds no cell A > 0, so no candidate: the min and the argmin are those
// of the whole window.  On the smoke's band 16 % of the chunks are live.
//
// Design.  One CTA of 8 warps owns the ROWS rows of one group and walks
// its live chunks through an NSTAGE-deep ring in shared memory, filled by
// 16-byte cp.async.cg NSTAGE - 1 chunks ahead: each stage holds a chunk's
// (ROWS, KC) band cells as stored (f32 or bf16) and its KC values of d and
// f.  A warp owns 8 rows, and lane l takes the chunk's columns 2l and
// 2l + 1: for each row it keeps its least candidate and that candidate's
// column over all the chunks.  The columns a lane sees ascend and a later
// one wins only when strictly smaller, so one shuffle reduction a row at
// the end, the smaller column on ties, gives the smallest column among
// the least candidates.  Each output is written once: no atomics.  The
// candidate arithmetic uses the _rn intrinsics, so nvcc contracts nothing
// into an FMA: the result is bit-identical to the same f32 operations done
// one by one, as the plain torch twin does them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 64;     // rows per CTA: a row group of the chunk list
constexpr int KC = 64;       // band columns per chunk
constexpr int NSTAGE = 4;    // ring stages
constexpr int ROWS_PER_WARP = ROWS / WARPS;
constexpr float BIG = 1e30f;
constexpr int NO_ARG = 0x7fffffff;

// One ring stage: the chunk's cells row by row, then its d and f
template <typename T>
struct Stage {
  static constexpr int BAND = ROWS * KC * (int)sizeof(T);
  static constexpr int BYTES = BAND + 2 * KC * (int)sizeof(float);
  static_assert(BAND % 16 == 0 && BYTES % 16 == 0, "16-byte stages");
};

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the cells of columns 2l and 2l + 1 of a staged chunk row, exact in f32
__device__ __forceinline__ float2 cells(const float* row, int lane) {
  return reinterpret_cast<const float2*>(row)[lane];
}
__device__ __forceinline__ float2 cells(const __nv_bfloat16* row, int lane) {
  return __bfloat1622float2(
      reinterpret_cast<const __nv_bfloat162*>(row)[lane]);
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

// one cell of column col into the running (m, a) of its row and lane
template <bool HOPF, bool RECIP, bool ARG>
__device__ __forceinline__ void relax(float v, float d, float f, int col,
                                      float& m, int& a) {
  if (!(v > 0.0f)) return;
  if (RECIP) v = __fdiv_rn(1.0f, v);
  const float cand = candidate<HOPF>(v, d, f);
  if (cand < m) {  // the lane's columns ascend: the smallest wins ties
    m = cand;
    if (ARG) a = col;
  }
}

template <typename T, bool HOPF, bool RECIP, bool ARG>
__global__ void __launch_bounds__(THREADS)
    rect_minplus_kernel(const T* __restrict__ band, int W, int R,
                        const int* __restrict__ winstart,
                        const int* __restrict__ chunk_ptr,
                        const int* __restrict__ chunk_col,
                        const float* __restrict__ d,
                        const float* __restrict__ f,
                        float* __restrict__ out_min,
                        int* __restrict__ out_arg) {
  using S = Stage<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const int ws = winstart[row0 / R];
  const int c_beg = chunk_ptr[blockIdx.x], c_end = chunk_ptr[blockIdx.x + 1];
  const char* rows = reinterpret_cast<const char*>(band + row0 * W);

  int p = c_beg;  // producer cursor: the next chunk to stage
  auto issue = [&](int stage_idx) {
    if (p < c_end) {
      unsigned char* st = smem + stage_idx * S::BYTES;
      const int col = chunk_col[p++] * KC;
      constexpr int PIECES = KC * (int)sizeof(T) / 16;  // a chunk row's
      const char* src = rows + (long long)col * sizeof(T);
      for (int q = tid; q < ROWS * PIECES; q += THREADS) {
        const int r = q / PIECES, k = q - r * PIECES;
        cp16(st + r * KC * (int)sizeof(T) + k * 16,
             src + (long long)r * W * sizeof(T) + k * 16);
      }
      constexpr int VP = KC * (int)sizeof(float) / 16;  // d's pieces
      if (tid < 2 * VP) {
        const float* v = tid < VP ? d : f;
        const int k = tid % VP;
        cp16(st + S::BAND + (tid / VP) * KC * (int)sizeof(float) + k * 16,
             v + (long long)ws + col + 4 * k);
      }
    }
    cp_commit();  // an empty group past the end keeps the count uniform
  };

  float best[ROWS_PER_WARP];
  int barg[ROWS_PER_WARP];
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    best[q] = BIG;
    barg[q] = NO_ARG;
  }

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) issue(s);
  for (int i = c_beg; i < c_end; ++i) {
    cp_wait<NSTAGE - 2>();  // chunk i has landed (this thread's copies)
    __syncthreads();        // ... everyone's; chunk i - 1's stage is free
    issue((i - c_beg + NSTAGE - 1) % NSTAGE);
    const unsigned char* st = smem + ((i - c_beg) % NSTAGE) * S::BYTES;
    const T* cs = reinterpret_cast<const T*>(st);
    const float2 dv = reinterpret_cast<const float2*>(st + S::BAND)[lane];
    const float2 fv =
        reinterpret_cast<const float2*>(st + S::BAND + KC * 4)[lane];
    const int col = ws + chunk_col[i] * KC + 2 * lane;
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      const float2 a = cells(cs + (warp * ROWS_PER_WARP + q) * KC, lane);
      relax<HOPF, RECIP, ARG>(a.x, dv.x, fv.x, col, best[q], barg[q]);
      relax<HOPF, RECIP, ARG>(a.y, dv.y, fv.y, col + 1, best[q], barg[q]);
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    float m = best[q];
    int a = barg[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_down_sync(0xffffffffu, m, off);
      const int a2 = __shfl_down_sync(0xffffffffu, a, off);
      if (m2 < m || (m2 == m && a2 < a)) {
        m = m2;
        a = a2;
      }
    }
    if (lane == 0) {
      const long long row = row0 + warp * ROWS_PER_WARP + q;
      out_min[row] = m;
      if (ARG) out_arg[row] = m < BIG ? a : -1;
    }
  }
}

struct Args {
  const void* band;
  int W, R;
  const int* winstart;
  const int* chunk_ptr;
  const int* chunk_col;
  long long nblocks;
  const float* d;
  const float* f;
  float* out_min;
  int* out_arg;
};

template <typename T, bool HOPF, bool RECIP, bool ARG>
int launch(const Args& a, cudaStream_t s) {
  const long long ctas = a.nblocks * (a.R / ROWS);
  if (ctas == 0) return (int)cudaSuccess;
  constexpr int SMEM = NSTAGE * Stage<T>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      rect_minplus_kernel<T, HOPF, RECIP, ARG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  rect_minplus_kernel<T, HOPF, RECIP, ARG>
      <<<(unsigned int)ctas, THREADS, SMEM, s>>>(
          static_cast<const T*>(a.band), a.W, a.R, a.winstart, a.chunk_ptr,
          a.chunk_col, a.d, a.f, a.out_min, a.out_arg);
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

// band: (nblocks*R, W) float32 (band_bf16 == 0) or bfloat16, 16-byte
// aligned; winstart: (nblocks,) int32, multiples of 4; chunk_ptr
// (nblocks*R/ROWS + 1,) and chunk_col: int32, the live KC-column chunks of
// each ROWS-row group, ascending; d, f: float32, 16-byte aligned, of at
// least max(winstart) + W entries; out_min: (nblocks*R,) float32; out_arg:
// (nblocks*R,) int32 when track != 0 (may be null otherwise).  R must be a
// multiple of ROWS and W of KC.  Returns cudaGetLastError() after the
// launch.
extern "C" int glt_rect_minplus(const void* band, int band_bf16, int W,
                                int R, const int* winstart,
                                const int* chunk_ptr, const int* chunk_col,
                                long long nblocks, const float* d,
                                const float* f, float* out_min,
                                int* out_arg, int hopf, int recip, int track,
                                void* stream) {
  if (R % ROWS || W % KC) return (int)cudaErrorInvalidValue;
  const Args a{band, W, R, winstart, chunk_ptr, chunk_col, nblocks, d, f,
               out_min, out_arg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_bf16) return dispatch<__nv_bfloat16>(a, hopf, recip, track, s);
  return dispatch<float>(a, hopf, recip, track, s);
}
