// K2 and K3: out = tiled band @ X, on the tensor cores.
//
// Replaces graphlearning_tpu/ops/pallas_spmm.py band_tiles_spmm_packed
// (kernel _tiles_packed_kernel; K2, slabs of S same-block tiles) and
// band_tiles_spmm (kernel _tiles_matmul_kernel; K3, S = 1).
//
// Layout: slab g is band rows [g*R, g*R + R) of a (G*R, S*WT) band; its
// tile s multiplies X rows [slab_starts[g*S + s], + WT).  Only the first
// slab_ntiles[g] tiles are real (pads trail and are skipped).  The slabs
// of output row block b are block_ptr[b] .. block_ptr[b + 1] - 1.  Tile
// starts are multiples of WT, so the X rows of a KC-column chunk are one
// contiguous block of KC * d elements.
//
// Bound.  At d = 2-3 (the class count of a fit) the band's bytes: the
// product is about d/2 multiply-adds per f32 band byte, so the card's
// 3.35 TB/s sets it.  At d = 128 the band's bytes too (0.6 ms for the
// bench's 442 M f32 cells), provided the dense tile product, which is
// 99 % zeros, stays off the 67 TFLOP/s FFMA pipe: 2 * 442 M * 128 dense
// operations take 1.7 ms there, and 3xTF32 (three TF32 products) 0.7 ms
// at the tensor cores' 495 TFLOP/s; about 10 % of the m16 x k8 band
// fragments hold a nonzero, and only those reach the tensor cores.
//
// Design.
// - Ring: NSTAGE shared-memory stages, each a (ROWS, KC) band chunk and
//   its KC X rows, filled by 16-byte cp.async.cg NSTAGE - 1 chunks ahead
//   of the MMAs, one __syncthreads a chunk.  The band is read from device
//   memory once per product for d <= DMAX: one CTA holds all of d for its
//   rows; the wrapper splits wider X into DMAX-column launches.
// - MMA: mma.sync m16n8k16 on bf16 operands with f32 sums, or m16n8k8 on
//   TF32 in 3xTF32 (a_hi x_hi + a_hi x_lo + a_lo x_hi, about 2^-21
//   relative) for the exact f32 mode.  d is padded to the MMA's n = 8 in
//   the fragment loads and masked in the epilogue.  A warp votes on each
//   of its m16 band fragments: an all-zero one is skipped, and a K slice
//   with none left skips its X fragments too, so the tensor-core and
//   shared-memory work follow the occupied cells.
// - Warps: ROWS = 64 rows a CTA (four m16 tiles), so a row block of R
//   rows has R / 64 CTAs.  The 8 warps split each chunk's K slices (and
//   d above 32 columns, and for bf16 at small d the rows); their partial
//   tiles are summed in shared memory before one store.  Each output
//   element is written once: no atomics, no zeroing pass, a
//   deterministic result.
// - At d = 128 each 64-row CTA stages its X window from L2 for itself:
//   2 bytes of X a band byte in f32, the cost that remains there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROWS = 64;     // output rows per CTA
constexpr int KC = 64;       // band columns per ring stage
constexpr int DMAX = 128;    // widest d that one launch covers
constexpr int NSTAGE = 4;    // ring stages
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

template <typename T>
struct Mode;
template <>
struct Mode<float> {
  static constexpr int KM = 8;        // MMA depth (m16n8k8 TF32)
  static constexpr int LDA = KC + 4;  // staged band row: conflict-free loads
};
template <>
struct Mode<__nv_bfloat16> {
  static constexpr int KM = 16;       // m16n8k16 bf16
  static constexpr int LDA = KC + 8;
};

// Warp layout for a padded d of DN columns: WK warps split the chunk's K
// slices, WN split d in 32-column groups, WM split the rows.
template <typename T, int DN>
struct Geo {
  static constexpr int NSLICE = KC / Mode<T>::KM;
  static constexpr int WN = DN > 32 ? DN / 32 : 1;
  static constexpr int WK =
      WARPS / WN < NSLICE ? WARPS / WN : NSLICE;
  static constexpr int WM = WARPS / (WN * WK);
  static constexpr int MT = ROWS / 16 / WM;          // m16 tiles a warp
  static constexpr int NT = (DN > 32 ? 32 : DN) / 8;  // n8 tiles a warp
  static constexpr int A_BYTES = ROWS * Mode<T>::LDA * (int)sizeof(T);
  static constexpr int STAGE = A_BYTES + KC * DN * (int)sizeof(T);
  static constexpr int RING = NSTAGE * STAGE;
  static constexpr int RED = WK * ROWS * DN * 4;     // partial tiles, f32
  static constexpr int SMEM = RING > RED ? RING : RED;
  static_assert(WN * WK * WM == WARPS && MT >= 1, "warp layout");
  static_assert(A_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte stages");
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

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One staged chunk into the warp's accumulators: K slices wk, wk + WK, ...
// of rows [wm*MT*16, +MT*16) and columns [wn*32, +NT*8) of d.  A slice
// whose band fragments are all zero in the warp's rows costs their loads
// and one vote each: its X fragments are neither loaded nor split.
template <typename T, int DN>
__device__ __forceinline__ void mma_chunk(const unsigned char* stage, int dc,
                                          int wm, int wn, int wk, int g,
                                          int t,
                                          float (&acc)[Geo<T, DN>::MT]
                                                      [Geo<T, DN>::NT][4]) {
  using G = Geo<T, DN>;
  // a staged band row in 32-bit words; one word holds 1 f32 or 2 bf16
  constexpr int LDW = Mode<T>::LDA * (int)sizeof(T) / 4;
  constexpr int KW = Mode<T>::KM * (int)sizeof(T) / 4;  // words a slice
  const uint32_t* Aw = reinterpret_cast<const uint32_t*>(stage);
  const int n_lo = wn * 32;
#pragma unroll
  for (int si = 0; si < G::NSLICE / G::WK; ++si) {
    const int ks = wk + si * G::WK;
    const int k0 = ks * Mode<T>::KM;
    // m16 fragment words: rows g / g + 8, words t / t + 4 of the slice
    // (columns t / t + 4 in TF32, 2t / 2t + 8 in bf16)
    uint32_t a[G::MT][4];
    unsigned live = 0;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      const uint32_t* w =
          Aw + ((wm * G::MT + mt) * 16 + g) * LDW + ks * KW + t;
      a[mt][0] = w[0];
      a[mt][1] = w[8 * LDW];
      a[mt][2] = w[4];
      a[mt][3] = w[8 * LDW + 4];
      if (__any_sync(0xffffffffu,
                     (a[mt][0] | a[mt][1] | a[mt][2] | a[mt][3]) != 0u))
        live |= 1u << mt;
    }
    if (!live) continue;
    if constexpr (std::is_same<T, float>::value) {
      const float* Xs = reinterpret_cast<const float*>(stage + G::A_BYTES);
      uint32_t bh[G::NT][2], bl[G::NT][2];
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const int n = n_lo + nt * 8 + g;
        float x0 = 0.f, x1 = 0.f;
        if (n < dc) {
          x0 = Xs[(k0 + t) * dc + n];
          x1 = Xs[(k0 + t + 4) * dc + n];
        }
        split(x0, bh[nt][0], bl[nt][0]);
        split(x1, bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        if (!(live >> mt & 1u)) continue;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split(__uint_as_float(a[mt][q]), ah[q], al[q]);
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          if (n_lo + nt * 8 < dc) {
            mma_tf32(acc[mt][nt], al, bh[nt]);
            mma_tf32(acc[mt][nt], ah, bl[nt]);
            mma_tf32(acc[mt][nt], ah, bh[nt]);
          }
        }
      }
    } else {
      const uint16_t* Xh =
          reinterpret_cast<const uint16_t*>(stage + G::A_BYTES);
      uint32_t b[G::NT][2];
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const int n = n_lo + nt * 8 + g;
        b[nt][0] = b[nt][1] = 0u;
        if (n < dc) {
          const uint16_t* x = Xh + (k0 + 2 * t) * dc + n;
          b[nt][0] = (uint32_t)x[0] | ((uint32_t)x[dc] << 16);
          b[nt][1] = (uint32_t)x[8 * dc] | ((uint32_t)x[9 * dc] << 16);
        }
      }
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        if (!(live >> mt & 1u)) continue;
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          if (n_lo + nt * 8 < dc) mma_bf16(acc[mt][nt], a[mt], b[nt]);
        }
      }
    }
  }
}

template <typename T, int DN>
__global__ void __launch_bounds__(THREADS, DN <= 32 ? 2 : 1)
    tiles_spmm_kernel(const T* __restrict__ band, long long band_ld, int R,
                      const int* __restrict__ block_ptr,
                      const int* __restrict__ slab_starts,
                      const int* __restrict__ slab_ntiles, int S, int WT,
                      const T* __restrict__ X, int dc,
                      float* __restrict__ out, long long ldo) {
  using G = Geo<T, DN>;
  constexpr int LDA = Mode<T>::LDA;
  constexpr int PIECES = KC * (int)sizeof(T) / 16;  // 16 B a band row
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp % G::WK;
  const int wn = (warp / G::WK) % G::WN;
  const int wm = warp / (G::WK * G::WN);
  const int groups = R / ROWS;
  const long long b = blockIdx.x / groups;
  const int rg = (int)(blockIdx.x - b * groups);
  const int slab_beg = block_ptr[b], slab_end = block_ptr[b + 1];
  int total = 0;  // chunks of this CTA
  for (int sl = slab_beg; sl < slab_end; ++sl)
    total += slab_ntiles[sl] * (WT / KC);

  // producer cursor: the next chunk to stage
  int p_slab = slab_beg, p_col = 0;
  int p_ncols = p_slab < slab_end ? slab_ntiles[p_slab] * WT : 0;
  const int x_pieces = KC * dc * (int)sizeof(T) / 16;
  auto issue = [&](int stage_idx) {
    if (p_slab < slab_end) {
      unsigned char* st = smem + stage_idx * G::STAGE;
      const int tile = p_col / WT;
      const long long xrow0 =
          (long long)slab_starts[(long long)p_slab * S + tile] +
          (p_col - tile * WT);
      const T* src = band + ((long long)p_slab * R + rg * ROWS) * band_ld +
                     p_col;
      for (int p = tid; p < ROWS * PIECES; p += THREADS) {
        const int r = p / PIECES, q = p - r * PIECES;
        cp16(st + r * LDA * (int)sizeof(T) + q * 16,
             reinterpret_cast<const char*>(src + r * band_ld) + q * 16);
      }
      const char* xsrc = reinterpret_cast<const char*>(X + xrow0 * dc);
      for (int p = tid; p < x_pieces; p += THREADS)
        cp16(st + G::A_BYTES + p * 16, xsrc + p * 16);
      p_col += KC;
      if (p_col >= p_ncols) {
        ++p_slab;
        p_col = 0;
        if (p_slab < slab_end) p_ncols = slab_ntiles[p_slab] * WT;
      }
    }
    cp_commit();  // an empty group past the end keeps the count uniform
  };

  float acc[G::MT][G::NT][4];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) issue(s);
  for (int i = 0; i < total; ++i) {
    cp_wait<NSTAGE - 2>();  // chunk i has landed (this thread's copies)
    __syncthreads();        // ... everyone's; chunk i - 1's stage is free
    issue((i + NSTAGE - 1) % NSTAGE);
    mma_chunk<T, DN>(smem + (i % NSTAGE) * G::STAGE, dc, wm, wn, wk, g, t,
                     acc);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the partial tiles now

  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
    const int row = (wm * G::MT + mt) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      const int col = wn * 32 + nt * 8 + 2 * t;
      float* p = red + ((long long)wk * ROWS + row) * DN + col;
      *reinterpret_cast<float2*>(p) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * DN) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncthreads();
  float* orow = out + (b * R + rg * ROWS) * ldo;
  for (int e = tid; e < ROWS * dc; e += THREADS) {
    const int r = e / dc, c = e - r * dc;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < G::WK; ++w) s += red[(w * ROWS + r) * DN + c];
    orow[r * ldo + c] = s;
  }
}

template <typename T, int DN>
int launch(const void* band, long long band_ld, int R, const int* block_ptr,
           const int* slab_starts, const int* slab_ntiles, int S, int WT,
           long long nblocks, const void* X, int dc, float* out,
           long long ldo, cudaStream_t s) {
  using G = Geo<T, DN>;
  const long long ctas = nblocks * (R / ROWS);
  if (ctas == 0) return (int)cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      tiles_spmm_kernel<T, DN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::SMEM);
  if (e != cudaSuccess) return (int)e;
  tiles_spmm_kernel<T, DN><<<(unsigned int)ctas, THREADS, G::SMEM, s>>>(
      static_cast<const T*>(band), band_ld, R, block_ptr, slab_starts,
      slab_ntiles, S, WT, static_cast<const T*>(X), dc, out, ldo);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dn(const void* band, long long band_ld, int R,
              const int* block_ptr, const int* slab_starts,
              const int* slab_ntiles, int S, int WT, long long nblocks,
              const void* X, int dc, float* out, long long ldo,
              cudaStream_t s) {
#define GLT_LAUNCH(DN)                                                     \
  return launch<T, DN>(band, band_ld, R, block_ptr, slab_starts,           \
                       slab_ntiles, S, WT, nblocks, X, dc, out, ldo, s)
  if (dc <= 8) GLT_LAUNCH(8);
  if (dc <= 16) GLT_LAUNCH(16);
  if (dc <= 32) GLT_LAUNCH(32);
  if (dc <= 64) GLT_LAUNCH(64);
  GLT_LAUNCH(128);
#undef GLT_LAUNCH
}

}  // namespace

// band: (G*R, band_ld) float32 (band_bf16 == 0) or bfloat16, 16-byte
// aligned; X: (rows, d) of the same type, contiguous, 16-byte aligned;
// out: row r, column c at out[r * ldo + c], float32, (nblocks*R) rows.
// R must be a multiple of ROWS, WT of KC, tile starts of WT, and
// 1 <= d <= DMAX.  Returns cudaGetLastError() after the launch.
extern "C" int glt_tiles_spmm(const void* band, int band_bf16,
                              long long band_ld, int R, const int* block_ptr,
                              const int* slab_starts, const int* slab_ntiles,
                              int S, int WT, long long nblocks, const void* X,
                              int d, float* out, long long ldo,
                              void* stream) {
  if (d < 1 || d > DMAX || R % ROWS || WT % KC || ldo < d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_bf16) {
    return launch_dn<__nv_bfloat16>(band, band_ld, R, block_ptr, slab_starts,
                                    slab_ntiles, S, WT, nblocks, X, d, out,
                                    ldo, s);
  }
  return launch_dn<float>(band, band_ld, R, block_ptr, slab_starts,
                          slab_ntiles, S, WT, nblocks, X, d, out, ldo, s);
}
