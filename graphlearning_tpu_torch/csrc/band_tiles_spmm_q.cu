// K10 and K11: out = quantized packed band @ X.
//
// K10 replaces graphlearning_tpu/ops/pallas_spmm.py
// band_tiles_spmm_packed_rowq (kernel _tiles_packed_rowq_kernel): an int8
// band of 1 or 2 planes side by side in each row, (G*R, planes*S*WT), with
// a per-row power-of-two scale srow:
//   out[row] = srow[row] * (q_hi @ X + (q_lo @ X) / 254)   (planes = 2)
//   out[row] = srow[row] * (q_hi @ X)                      (planes = 1)
// planes = 2 takes f32 X, planes = 1 bf16 X.
//
// K11 replaces band_tiles_spmm_packed_i8 (kernel _tiles_packed_i8_kernel):
// a bf16 plane hi and an int8 plane q, both (G*R, S*WT); each cell is
//   a = hi + q * 2^(e - 15),
// with e hi's exponent, rebuilt from hi's exponent bits.  Both terms fit in
// 16 significant bits at hi's exponent, so a is exact in f32.  X is f32.
//
// Layout as K2 (band_tiles_spmm.cu): slab g is band rows [g*R, g*R + R);
// its tile s multiplies X rows [slab_starts[g*S + s], + WT); only the first
// slab_ntiles[g] tiles are real; the slabs of output row block b are
// block_ptr[b] .. block_ptr[b + 1] - 1.  In K10 plane lo of a cell sits
// S*WT columns after plane hi.
//
// Bound: at small d the band's bytes (1, 2 or 3 a cell); near d = 128 the
// f32 FFMA issue rate.  The exact-grade floor on this card is the bf16
// tensor cores' (int8 values are exact in bf16, so mma.sync or wgmma on
// bf16 operands computes the same products), K2's route now.  Design: the
// FFMA CTA K2 had before its tensor-core ring.  ROWS threads own ROWS
// output rows of one block and a chunk of DC output columns; they walk the
// block's slabs, staging KC band columns of their rows (byte loads, one
// warp per row segment; no 16-byte loads, whose alignment is not checked
// here), widened (K10) or rebuilt (K11) to f32, and the KC matching X rows
// through shared memory, and accumulate in registers with FFMA.  K10 keeps acc_hi and acc_lo apart and writes
// srow[row] * (acc_hi + acc_lo / 254) in the epilogue: the row's scale is
// fused there, where the JAX package scaled after the kernel.  The TPU's
// bf16 hi/lo split of X, which emulated f32 on its matrix unit, is not
// carried over: f32 FFMA takes X whole.  No atomics, no zeroing pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 128;  // output rows per CTA, one per thread
constexpr int KC = 32;     // band columns staged per step

enum Mode { ROWQ2 = 0, ROWQ1 = 1, I8 = 2 };

__device__ __forceinline__ float x_float(float v) { return v; }
__device__ __forceinline__ float x_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// hi + q * 2^(e - 15): the exponent field of hi, moved to an f32's place,
// is 2^e (0 for a zero or subnormal hi, whose q is 0).
__device__ __forceinline__ float dequant_i8(__nv_bfloat16 hi, signed char q) {
  const unsigned int bits = __bfloat16_as_ushort(hi);
  const float u = __uint_as_float((bits & 0x7F80u) << 16);
  return fmaf((float)q, u * 0x1p-15f, __bfloat162float(hi));
}

template <int MODE, typename XT, int DC>
__global__ void __launch_bounds__(ROWS)
    tiles_spmm_q_kernel(const signed char* __restrict__ q,
                        const __nv_bfloat16* __restrict__ hi, long long ld,
                        long long lo_off, const float* __restrict__ srow,
                        int R, const int* __restrict__ block_ptr,
                        const int* __restrict__ slab_starts,
                        const int* __restrict__ slab_ntiles, int S, int WT,
                        const XT* __restrict__ X, int d, int nchunks,
                        float* __restrict__ out) {
  constexpr bool TWO = MODE == ROWQ2;
  __shared__ float bs[ROWS][KC + 1];  // +1: conflict-free row reads
  __shared__ float bl[TWO ? ROWS : 1][KC + 1];
  __shared__ float xs[KC][DC];
  const int tid = threadIdx.x;
  const int chunk = (int)(blockIdx.x % nchunks);
  const long long grp = blockIdx.x / nchunks;
  const int groups = R / ROWS;
  const long long b = grp / groups;
  const int rg = (int)(grp - b * groups);
  const int dc0 = chunk * DC;

  float acc[DC];
  float acc_lo[TWO ? DC : 1];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;
#pragma unroll
  for (int c = 0; c < (TWO ? DC : 1); ++c) acc_lo[c] = 0.f;

  const int slab_end = block_ptr[b + 1];
  for (int slab = block_ptr[b]; slab < slab_end; ++slab) {
    const long long row0 = ((long long)slab * R + rg * ROWS) * ld;
    const int ncols = slab_ntiles[slab] * WT;
    for (int c0 = 0; c0 < ncols; c0 += KC) {
      const int t = c0 / WT;
      const long long xrow0 =
          (long long)slab_starts[(long long)slab * S + t] + (c0 - t * WT);
      __syncthreads();  // previous step's reads of bs / bl / xs are done
      for (int i = tid; i < ROWS * KC; i += ROWS) {
        const int rr = i / KC, cc = i % KC;
        const long long at = row0 + (long long)rr * ld + c0 + cc;
        if constexpr (MODE == I8) {
          bs[rr][cc] = dequant_i8(hi[at], q[at]);
        } else {
          bs[rr][cc] = (float)q[at];
          if constexpr (TWO) bl[rr][cc] = (float)q[at + lo_off];
        }
      }
      for (int i = tid; i < KC * DC; i += ROWS) {
        const int rr = i / DC, c = i % DC;
        const int col = dc0 + c;
        xs[rr][c] = col < d ? x_float(X[(xrow0 + rr) * d + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float a = bs[tid][j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[c] = fmaf(a, xs[j][c], acc[c]);
        if constexpr (TWO) {
          const float a_lo = bl[tid][j];
#pragma unroll
          for (int c = 0; c < DC; ++c)
            acc_lo[c] = fmaf(a_lo, xs[j][c], acc_lo[c]);
        }
      }
    }
  }
  const long long row = b * R + rg * ROWS + tid;
  float scale = 1.f;
  if constexpr (MODE != I8) scale = srow[row];
  float* orow = out + row * (long long)d + dc0;
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    if (dc0 + c < d) {
      float v = acc[c];
      if constexpr (TWO) v += acc_lo[c] / 254.f;
      orow[c] = scale * v;
    }
  }
}

struct Args {
  const signed char* q;
  const __nv_bfloat16* hi;
  long long ld, lo_off;
  const float* srow;
  int R;
  const int *block_ptr, *slab_starts, *slab_ntiles;
  int S, WT;
  long long nblocks;
  const void* X;
  int d;
  float* out;
  cudaStream_t stream;
};

template <int MODE, typename XT, int DC>
int launch(const Args& a) {
  const int nchunks = (a.d + DC - 1) / DC;
  const long long ctas = a.nblocks * (a.R / ROWS) * nchunks;
  if (ctas > 0) {
    tiles_spmm_q_kernel<MODE, XT, DC><<<(unsigned int)ctas, ROWS, 0,
                                        a.stream>>>(
        a.q, a.hi, a.ld, a.lo_off, a.srow, a.R, a.block_ptr, a.slab_starts,
        a.slab_ntiles, a.S, a.WT, static_cast<const XT*>(a.X), a.d, nchunks,
        a.out);
  }
  return (int)cudaGetLastError();
}

template <int MODE, typename XT>
int launch_dc(const Args& a) {
  if (a.d <= 1) return launch<MODE, XT, 1>(a);
  if (a.d <= 2) return launch<MODE, XT, 2>(a);
  if (a.d <= 4) return launch<MODE, XT, 4>(a);
  if (a.d <= 8) return launch<MODE, XT, 8>(a);
  if (a.d <= 16) return launch<MODE, XT, 16>(a);
  return launch<MODE, XT, 32>(a);
}

}  // namespace

// K10.  qband: (G*R, planes*S*WT) int8; srow: (nblocks*R,) float32; X: (rows, d) float32 (planes 2) or bfloat16 (planes 1); out:
// (nblocks*R, d) float32.  R must be a multiple of 128 and WT of 32.
// Returns cudaGetLastError() after the launch.
extern "C" int glt_tiles_spmm_rowq(const void* qband, int planes,
                                   const float* srow, int R,
                                   const int* block_ptr,
                                   const int* slab_starts,
                                   const int* slab_ntiles, int S, int WT,
                                   long long nblocks, const void* X, int d,
                                   float* out, void* stream) {
  const long long sw = (long long)S * WT;
  const Args a{static_cast<const signed char*>(qband), nullptr, planes * sw,
               sw, srow, R, block_ptr, slab_starts, slab_ntiles, S, WT,
               nblocks, X, d, out, static_cast<cudaStream_t>(stream)};
  if (planes == 2) return launch_dc<ROWQ2, float>(a);
  return launch_dc<ROWQ1, __nv_bfloat16>(a);
}

// K11.  hi: (G*R, S*WT) bfloat16; q: the same shape, int8; X: (rows, d)
// float32; out: (nblocks*R, d) float32.  R must be a multiple of 128 and WT
// of 32.  Returns cudaGetLastError() after the launch.
extern "C" int glt_tiles_spmm_i8(const void* hi, const void* q, int R,
                                 const int* block_ptr, const int* slab_starts,
                                 const int* slab_ntiles, int S, int WT,
                                 long long nblocks, const void* X, int d,
                                 float* out, void* stream) {
  const long long sw = (long long)S * WT;
  const Args a{static_cast<const signed char*>(q),
               static_cast<const __nv_bfloat16*>(hi), sw, 0, nullptr, R,
               block_ptr, slab_starts, slab_ntiles, S, WT, nblocks, X, d,
               out, static_cast<cudaStream_t>(stream)};
  return launch_dc<I8, float>(a);
}
