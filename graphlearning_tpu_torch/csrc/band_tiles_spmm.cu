// K2, K3, K5, K10 and K11: out = band @ X, on the tensor cores.
//
// Replaces graphlearning_tpu/ops/pallas_spmm.py band_tiles_spmm_packed
// (kernel _tiles_packed_kernel; K2, slabs of S same-block tiles),
// band_tiles_spmm (kernel _tiles_matmul_kernel; K3, S = 1), band_spmm
// (kernel _band_matmul_kernel; K5, the rectangular band),
// band_tiles_spmm_packed_rowq (kernel _tiles_packed_rowq_kernel; K10) and
// band_tiles_spmm_packed_i8 (kernel _tiles_packed_i8_kernel; K11).
//
// Layout of the tiled bands (K2, K3, K10, K11): slab g is band rows
// [g*R, g*R + R) of a (G*R, S*WT) band; its tile s multiplies X rows
// [slab_starts[g*S + s], + WT).  Only the first slab_ntiles[g] tiles are
// real (pads trail and are skipped).  The slabs of output row block b are
// block_ptr[b] .. block_ptr[b + 1] - 1.  Tile starts are multiples of WT,
// so the X rows of a KC-column chunk are one contiguous block of KC * d
// elements.
//
// Layout of the rectangular band (K5): row i of the (n, W) band weighs
// the X rows winstart[i / R] + [0, W).  The list of live chunks
// (ops/band_spmm.py rect_live_chunks) names, for the ROWS-row group of
// CTA i, the KC-column chunks that hold a nonzero cell, ascending:
// chunk_col[chunk_ptr[i] .. chunk_ptr[i + 1]).  Chunk c multiplies the X
// rows winstart + KC * c, one contiguous block again.  The CTA stages
// only those chunks: on the smoke's band (0.27 % nonzero) 16 % of the
// chunks are live, so K5 reads a sixth of the dense band's bytes, where
// its FFMA predecessor streamed every cell.
//
// Band formats (the template parameter F), each cell in one or two
// planes of the stored layout:
// - F32, BF16 (K2, K3): one plane of f32 or bf16 cells.
// - ROWQ2, ROWQ1 (K10): int8 planes q_hi (and q_lo, S*WT columns after it
//   in the same row) with a power-of-two row scale srow:
//     out[row] = srow[row] * sum (q_hi + q_lo / 254) * x    (ROWQ2)
//     out[row] = srow[row] * sum q_hi * x                   (ROWQ1)
// - I8 (K11): a bf16 plane hi and an int8 plane q, the cell
//     a = hi + q * 2^(e - 15),
//   e hi's exponent, exact in f32 (both terms fit in 16 significant bits
//   at hi's exponent).
// X is f32 for F32, ROWQ2 and I8, bf16 for BF16 and ROWQ1; out is f32.
//
// Bound.  At d = 2-3 (the class count of a fit) the band's bytes: the
// product is about d/2 multiply-adds per f32 band byte, so the card's
// 3.35 TB/s sets it.  At d = 128 the band's bytes too (0.6 ms for the
// bench's 442 M f32 cells, 0.13-0.4 ms at the quantized formats' 1-3
// bytes a cell), provided the dense tile product, which is 99 % zeros,
// stays off the 67 TFLOP/s FFMA pipe: 2 * 442 M * 128 dense operations
// take 1.7 ms there, and 3xTF32 (three TF32 products) 0.7 ms at the tensor
// cores' 495 TFLOP/s; about 10 % of the m16 x k8 band fragments hold a
// nonzero, and only those reach the tensor cores.  Measured at d = 128
// (PERF.md), what holds the kernel is its work on each band fragment
// (loads, votes, rebuilt cells, X splits) with one CTA an SM: a 128-row
// CTA, which halves X's L2 bytes, is faster than a 64-row one, and so
// are 16 warps in place of 8 for 3xTF32, but not by the bytes' ratio.
//
// Design.
// - Ring: up to NSTAGE shared-memory stages, each a (rows, KC) band chunk
//   of every plane, copied as stored (4, 2, 2, 1 or 3 bytes a cell), and
//   its KC X rows, filled by 16-byte cp.async.cg NST - 1 chunks ahead of
//   the MMAs, one __syncthreads a chunk.  The band is read from device
//   memory once per product for d <= DMAX: one CTA holds all of d for its
//   rows; the wrapper splits wider X into DMAX-column launches.
// - MMA: mma.sync m16n8k16 on bf16 operands with f32 sums (BF16; ROWQ1,
//   whose int8 cells are exact in bf16), or m16n8k8 on TF32 in 3xTF32
//   (a_hi x_hi + a_hi x_lo + a_lo x_hi, about 2^-21 relative) for the
//   exact grade (F32, ROWQ2, I8).  The quantized cells are rebuilt in f32
//   at the fragment load (ROWQ2: q_hi + q_lo / 254, one f32 rounding,
//   2^-24 of the cell; I8: exact) and split as F32's, so the exact modes
//   share one product; the row scale srow is a power of two, applied
//   exactly in the epilogue.  (Taking q_hi and q_lo as the TF32 hi and lo
//   parts as they are would round q_lo / 254 or drop q_lo * x_lo, about
//   2^-19 of the row's largest cell.)  The tensor cores round each sum
//   toward zero, so a fragment's 3xTF32 products go into zeroed sums that
//   FADD adds, rounded to nearest, to the accumulators: accumulated in the
//   MMA they biased an output by about -2^-24 of itself, and a masked CG
//   Laplace solve on the fit's band ended 40x further from the f64
//   solution than the plain f32 path's, 10x with the FADD (the MMA still
//   truncates where one k slice of a row holds several cells; PERF.md).
//   d is padded to the MMA's n = 8 in the fragment loads and masked in the
//   epilogue.  A warp votes on each of its m16 band fragments: an all-zero
//   one is skipped, and a K slice with none left skips its X fragments
//   too, so the tensor-core and shared-memory work follow the occupied
//   cells.  ROWQ2 and I8 number
//   the k of a TF32 fragment so that a thread's two columns are adjacent
//   (k = t, t + 4 at columns 2t, 2t + 1): one 16-bit load fetches both of
//   an int8 plane.
// - Producer: the slabs of the CTA's row block (K2, K3, K10, K11), or
//   the live chunks of its row group (K5): a template parameter.
// - Warps: ROWS = 64 rows a CTA for K2/K3/K5 (four m16 tiles), QROWS = 128
//   for the quantized formats where R allows (their smaller band stage
//   leaves room: each CTA stages its X window for twice the rows).  A row
//   block of R rows has R / rows CTAs.  The 8 warps (16 for 3xTF32 above
//   32 columns of d) split each chunk's K slices (and d above 32 columns,
//   and the rows where a warp would hold more than four, or two, m16
//   tiles or, for bf16 at small d, run out of slices); their partial
//   tiles are summed in shared memory before one store.
//   Each output element is written once: no atomics, no zeroing pass, a
//   deterministic result.
// - FFMA consumer: the exact F32 format at d <= FMA_DMAX (K2, K3, K5 at a
//   fit's class count) sums on the FFMA pipe, a template parameter as the
//   K5 producer is.  There the tensor cores buy nothing (an m16n8k8
//   fragment pads d = 2 to 8 columns) and their sums round toward zero
//   where one k slice of a row holds several cells: the fit's masked
//   Laplace solve ended 10x further from the f64 solution than the plain
//   f32 path's (PERF.md).  FFMA rounds each sum to nearest.  A thread owns
//   one row of the CTA and a quarter of each chunk's columns, so every
//   output is summed in column order by one thread, then its four
//   quarters in order: the twin's order of error.  A warp's 32 rows read
//   their band cells as float4 (the 272-byte rows put a quarter warp on
//   distinct banks) and the X rows as broadcasts; a 32-row x 4-column
//   block with no nonzero cell costs its load and one vote.  At d <= 16 a
//   64 x 64 chunk is at most 65536 FMAs over 256 threads, under the time
//   its 16 KB take to arrive: the product stays bound by the band's bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROWS = 64;      // output rows per CTA of K2/K3/K5
constexpr int QROWS = 128;    // ... of K10/K11 where R is a multiple of it
constexpr int KC = 64;        // band columns per ring stage
constexpr int DMAX = 128;     // widest d that one launch covers
constexpr int FMA_DMAX = 16;  // widest d of the exact grade's FFMA consumer
constexpr int NSTAGE = 4;     // ring stages, fewer where they do not fit
constexpr int WIN_ALIGN = 8;  // K5 window starts are multiples of it
// ... so a chunk's X rows start on 16 bytes at any d, bf16 at d=1 too
static_assert(WIN_ALIGN * 2 % 16 == 0, "K5's X chunks in 16-byte pieces");
constexpr int SMEM_MAX = 232448;  // shared memory a block can use
constexpr int SMEM_SM = 233472;   // ... an SM has

enum Fmt { F32, BF16, ROWQ2, ROWQ1, I8 };

// What a format stages and multiplies: X's type, whether the product is
// 3xTF32 (else bf16), whether a TF32 fragment's two columns are adjacent
// (PERM), and for each plane the bytes a cell (B0, B1) and the bytes of a
// staged chunk row (L0, L1: 16-byte rows, padded so that the fragment
// loads of a warp hit distinct banks).
template <int F>
struct Fm;
template <>
struct Fm<F32> {
  using X = float;
  static constexpr bool TF32 = true, PERM = false;
  static constexpr int B0 = 4, B1 = 0, L0 = (KC + 4) * 4, L1 = 0;
};
template <>
struct Fm<BF16> {
  using X = __nv_bfloat16;
  static constexpr bool TF32 = false, PERM = false;
  static constexpr int B0 = 2, B1 = 0, L0 = (KC + 8) * 2, L1 = 0;
};
template <>
struct Fm<ROWQ2> {
  using X = float;
  static constexpr bool TF32 = true, PERM = true;
  static constexpr int B0 = 1, B1 = 1, L0 = KC + 16, L1 = KC + 16;
};
template <>
struct Fm<ROWQ1> {
  using X = __nv_bfloat16;
  static constexpr bool TF32 = false, PERM = false;
  static constexpr int B0 = 1, B1 = 0, L0 = KC + 16, L1 = 0;
};
template <>
struct Fm<I8> {
  using X = float;
  static constexpr bool TF32 = true, PERM = true;
  static constexpr int B0 = 2, B1 = 1, L0 = (KC + 8) * 2, L1 = KC + 16;
};

// Warp layout for format F, RW rows and a padded d of DN columns: NW
// warps, of which WN split d in 32-column groups, WM the rows (at most
// MTMAX m16 tiles a warp) and WK the chunk's K slices.  Above 32 columns a
// CTA is alone on its SM (its ring fills the shared memory), and the
// 3xTF32 formats take 16 warps of two m16 tiles each: twice the warps to
// hide the latency of their longer fragment work (splits, rebuilt cells),
// in fewer registers.  The bf16 formats measured slower so (PERF.md).
template <int F, int RW, int DN>
struct Geo {
  using M = Fm<F>;
  static constexpr int KM = M::TF32 ? 8 : 16;  // MMA depth
  static constexpr int NSLICE = KC / KM;
  static constexpr int NW = DN > 32 && M::TF32 ? 16 : 8;
  static constexpr int THREADS = NW * 32;
  static constexpr int MTMAX = NW == 16 ? 2 : 4;
  static constexpr int WN = DN > 32 ? DN / 32 : 1;
  static constexpr int WM0 = RW / (16 * MTMAX);
  static constexpr int WK = NW / (WN * WM0) < NSLICE ? NW / (WN * WM0)
                                                     : NSLICE;
  static constexpr int WM = NW / (WN * WK);
  static constexpr int MT = RW / 16 / WM;           // m16 tiles a warp
  static constexpr int NT = (DN > 32 ? 32 : DN) / 8;  // n8 tiles a warp
  static constexpr int A_BYTES = RW * (M::L0 + M::L1);
  static constexpr int STAGE =
      A_BYTES + KC * DN * (int)sizeof(typename M::X);
  static constexpr int NST =
      SMEM_MAX / STAGE < NSTAGE ? SMEM_MAX / STAGE : NSTAGE;
  static constexpr int RING = NST * STAGE;
  static constexpr int RED = WK * RW * DN * 4;      // partial tiles, f32
  static constexpr int SMEM = RING > RED ? RING : RED;
  // CTAs an SM: two where d is narrow and the shared memory allows
  static constexpr int OCC = DN <= 32 && 2 * (SMEM + 1024) <= SMEM_SM ? 2
                                                                      : 1;
  static_assert(WN * WK * WM == NW && MT >= 1 && MT <= MTMAX,
                "warp layout");
  static_assert(NST >= 2 && SMEM <= SMEM_MAX, "shared memory");
  static_assert(A_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte stages");
};

// The FFMA consumer's layout (F32, d <= FMA_DMAX padded to DN): 8 warps,
// warp w on rows [(w % WM) * 32, + 32), one row a lane, and the KW chunk
// columns [(w / WM) * KW, + KW); their WK partial sums per output are added
// in shared memory as the MMA warps' are.
template <int RW, int DN>
struct GeoF {
  static constexpr int NW = 8;
  static constexpr int THREADS = NW * 32;
  static constexpr int WM = RW / 32;
  static constexpr int WK = NW / WM;
  static constexpr int KW = KC / WK;
  static constexpr int A_BYTES = RW * Fm<F32>::L0;
  static constexpr int STAGE = A_BYTES + KC * DN * 4;
  static constexpr int NST =
      SMEM_MAX / STAGE < NSTAGE ? SMEM_MAX / STAGE : NSTAGE;
  static constexpr int RING = NST * STAGE;
  static constexpr int RED = WK * RW * DN * 4;
  static constexpr int SMEM = RING > RED ? RING : RED;
  static constexpr int OCC = 2 * (SMEM + 1024) <= SMEM_SM ? 2 : 1;
  static_assert(WM * WK == NW && KW % 4 == 0 && DN <= FMA_DMAX,
                "FFMA layout");
  static_assert(NST >= 2 && SMEM <= SMEM_MAX, "shared memory");
  static_assert(A_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte stages");
};

template <int F, int RW, int DN, bool FFMA>
using GeoOf = std::conditional_t<FFMA, GeoF<RW, DN>, Geo<F, RW, DN>>;

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

// cvt.rna.tf32.f32 (nearest, ties away from zero) for finite x, by two
// integer operations
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
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

__device__ __forceinline__ uint32_t ld16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The raw A fragment of m16 tile rows r / r + 8 at slice column k0: four
// words, zero exactly where the cells are.  F32 and BF16: the words as
// staged (TF32: columns t / t + 4; bf16: pairs at 2t / 2t + 8).  ROWQ1:
// the int8 pairs at 2t / 2t + 8.  ROWQ2: q_hi | q_lo << 8 of columns 2t /
// 2t + 1 (PERM).  I8: hi's bits of columns 2t / 2t + 1; q is merged in by
// i8_merge for the live fragments only (q is 0 where hi is).
template <int F, int RW>
__device__ __forceinline__ void load_a(const unsigned char* stage, int r,
                                       int k0, int t, uint32_t (&a)[4]) {
  using M = Fm<F>;
  if constexpr (F == F32 || F == BF16) {
    constexpr int LDW = M::L0 / 4;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(stage) + r * LDW +
                        k0 * M::B0 / 4 + t;
    a[0] = w[0];
    a[1] = w[8 * LDW];
    a[2] = w[4];
    a[3] = w[8 * LDW + 4];
  } else if constexpr (F == ROWQ1) {
    const unsigned char* p = stage + r * M::L0 + k0 + 2 * t;
    a[0] = ld16(p);
    a[1] = ld16(p + 8 * M::L0);
    a[2] = ld16(p + 8);
    a[3] = ld16(p + 8 * M::L0 + 8);
  } else if constexpr (F == ROWQ2) {
    const unsigned char* h = stage + r * M::L0 + k0 + 2 * t;
    const unsigned char* l = stage + RW * M::L0 + r * M::L1 + k0 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // rows r, r + 8
      const uint32_t hh = ld16(h + i * 8 * M::L0);
      const uint32_t ll = ld16(l + i * 8 * M::L1);
      a[i] = (hh & 0xFFu) | (ll & 0xFFu) << 8;
      a[i + 2] = hh >> 8 | (ll & 0xFF00u);
    }
  } else {  // I8
    const unsigned char* h = stage + r * M::L0 + 2 * (k0 + 2 * t);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t hh = ld32(h + i * 8 * M::L0);
      a[i] = hh & 0xFFFFu;
      a[i + 2] = hh >> 16;
    }
  }
}

// I8: q of the fragment's cells into bits 16-23 of each raw word
template <int RW>
__device__ __forceinline__ void i8_merge(const unsigned char* stage, int r,
                                         int k0, int t, uint32_t (&a)[4]) {
  using M = Fm<I8>;
  const unsigned char* q = stage + RW * M::L0 + r * M::L1 + k0 + 2 * t;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t qq = ld16(q + i * 8 * M::L1);
    a[i] |= (qq & 0xFFu) << 16;
    a[i + 2] |= (qq & 0xFF00u) << 8;
  }
}

// The int8 in bits 8i .. 8i + 7 of w as an exact f32, by integer
// operations and one add: 2^23 + (q + 128) has q + 128 in its mantissa.
template <int I>
__device__ __forceinline__ float i8_f32(uint32_t w) {
  return __uint_as_float(0x4B000000u | ((w >> (8 * I) & 0xFFu) ^ 0x80u)) -
         8388736.f;
}

// An exact-grade cell in f32 from its raw word
template <int F>
__device__ __forceinline__ float cell_f32(uint32_t w) {
  if constexpr (F == F32) {
    return __uint_as_float(w);
  } else if constexpr (F == ROWQ2) {
    return fmaf(i8_f32<1>(w), 1.f / 254.f, i8_f32<0>(w));
  } else {  // I8: hi + q * 2^(e - 15); 2^e from hi's exponent bits
    const float hi = __uint_as_float(w << 16);
    const float u = __uint_as_float((w & 0x7F80u) << 16);
    return fmaf(i8_f32<2>(w), u * 0x1p-15f, hi);
  }
}

// A bf16 fragment word from its raw word: ROWQ1's two int8 cells, whose
// f32 values are exact in their upper halves
template <int F>
__device__ __forceinline__ uint32_t cell_bf16x2(uint32_t w) {
  if constexpr (F == BF16) {
    return w;
  } else {
    return __byte_perm(__float_as_uint(i8_f32<0>(w)),
                       __float_as_uint(i8_f32<1>(w)), 0x7632);
  }
}

// One staged chunk into the warp's accumulators: K slices wk, wk + WK, ...
// of rows [wm*MT*16, +MT*16) and columns [wn*32, +NT*8) of d.  A slice
// whose band fragments are all zero in the warp's rows costs their loads
// and one vote each: its X fragments are neither loaded nor split.
template <int F, int RW, int DN>
__device__ __forceinline__ void mma_chunk(
    const unsigned char* stage, int dc, int wm, int wn, int wk, int g, int t,
    float (&acc)[Geo<F, RW, DN>::MT][Geo<F, RW, DN>::NT][4]) {
  using G = Geo<F, RW, DN>;
  using M = Fm<F>;
  const int n_lo = wn * 32;
#pragma unroll
  for (int si = 0; si < G::NSLICE / G::WK; ++si) {
    const int k0 = (wk + si * G::WK) * G::KM;
    uint32_t a[G::MT][4];
    unsigned live = 0;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      const int r = (wm * G::MT + mt) * 16 + g;
      load_a<F, RW>(stage, r, k0, t, a[mt]);
      if (__any_sync(0xffffffffu,
                     (a[mt][0] | a[mt][1] | a[mt][2] | a[mt][3]) != 0u)) {
        live |= 1u << mt;
        if constexpr (F == I8) i8_merge<RW>(stage, r, k0, t, a[mt]);
      }
    }
    if (!live) continue;
    if constexpr (M::TF32) {
      const float* Xs = reinterpret_cast<const float*>(stage + G::A_BYTES);
      // X rows of the fragment's k = t and t + 4
      const int kb0 = M::PERM ? k0 + 2 * t : k0 + t;
      const int kb1 = M::PERM ? kb0 + 1 : kb0 + 4;
      uint32_t bh[G::NT][2], bl[G::NT][2];
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const int n = n_lo + nt * 8 + g;
        float x0 = 0.f, x1 = 0.f;
        if (n < dc) {
          x0 = Xs[kb0 * dc + n];
          x1 = Xs[kb1 * dc + n];
        }
        split(x0, bh[nt][0], bl[nt][0]);
        split(x1, bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        if (!(live >> mt & 1u)) continue;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split(cell_f32<F>(a[mt][q]), ah[q], al[q]);
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          if (n_lo + nt * 8 < dc) {
            // the tensor cores round a sum toward zero: products into
            // zeroed sums, added to acc by FADD, rounded to nearest
            float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(lo, al, bh[nt]);
            mma_tf32(lo, ah, bl[nt]);
            mma_tf32(hi, ah, bh[nt]);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nt][q] += hi[q] + lo[q];
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
        uint32_t ab[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) ab[q] = cell_bf16x2<F>(a[mt][q]);
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          if (n_lo + nt * 8 < dc) mma_bf16(acc[mt][nt], ab, b[nt]);
        }
      }
    }
  }
}

// One staged F32 chunk into a thread's FFMA sums: its row's cells at
// columns [k_lo, + KW) times those X rows, all DN columns (the columns past
// dc read the next X rows or stale stage bytes and are never stored).
template <int RW, int DN>
__device__ __forceinline__ void ffma_chunk(const unsigned char* stage,
                                           int row, int k_lo, int dc,
                                           float (&acc)[DN]) {
  using G = GeoF<RW, DN>;
  const float* a =
      reinterpret_cast<const float*>(stage) + row * (Fm<F32>::L0 / 4) + k_lo;
  const float* Xs =
      reinterpret_cast<const float*>(stage + G::A_BYTES) + k_lo * dc;
#pragma unroll
  for (int j = 0; j < G::KW; j += 4) {
    const float4 c4 = *reinterpret_cast<const float4*>(a + j);
    if (!__any_sync(0xffffffffu, c4.x != 0.f || c4.y != 0.f ||
                                     c4.z != 0.f || c4.w != 0.f))
      continue;
    const float cell[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* x = Xs + (j + q) * dc;
#pragma unroll
      for (int c = 0; c < DN; ++c) acc[c] = fmaf(cell[q], x[c], acc[c]);
    }
  }
}

// RW rows of a plane's KC-column chunk, 16-byte pieces, into rows of L
// bytes
template <int RW, int B, int L, int THREADS>
__device__ __forceinline__ void stage_plane(unsigned char* dst,
                                            const char* src, long long ld,
                                            int tid) {
  constexpr int PIECES = KC * B / 16;
  for (int p = tid; p < RW * PIECES; p += THREADS) {
    const int r = p / PIECES, q = p - r * PIECES;
    cp16(dst + r * L + q * 16, src + r * ld + q * 16);
  }
}

struct Args {
  const char* band0;  // plane 0, row stride ld0 bytes
  long long ld0;
  const char* band1;  // plane 1 (ROWQ2, I8), row stride ld1 bytes
  long long ld1;
  const float* srow;  // ROWQ2, ROWQ1: the row scales
  int R;
  const int* block_ptr;
  const int* slab_starts;
  const int* slab_ntiles;
  int S, WT;
  long long nblocks;
  const void* X;
  int dc;
  float* out;
  long long ldo;
  // K5 (null for the tiled bands): the live-chunk list and the window
  // starts; WT holds W and S is 0
  const int* chunk_ptr;
  const int* chunk_col;
  const int* winstart;
};

// RECT: the producer walks the live-chunk list (K5), else the slabs; FFMA:
// the FFMA consumer (F32 only), else the MMAs.  Both template parameters,
// so each instantiation compiles as it would alone.
template <int F, int RW, int DN, bool RECT, bool FFMA>
__global__ void __launch_bounds__(GeoOf<F, RW, DN, FFMA>::THREADS,
                                  GeoOf<F, RW, DN, FFMA>::OCC)
    tiles_spmm_kernel(const Args args) {
  using G = GeoOf<F, RW, DN, FFMA>;
  using M = Fm<F>;
  using XT = typename M::X;
  static_assert(!FFMA || F == F32, "the FFMA consumer is F32's");
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = args.R, S = args.S, WT = args.WT, dc = args.dc;
  const int* __restrict__ slab_ntiles = args.slab_ntiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = R / RW;
  const long long b = blockIdx.x / groups;
  const int rg = (int)(blockIdx.x - b * groups);
  // the chunks of this CTA: its live chunks (K5), or its block's slabs
  int slab_beg = 0, slab_end = 0, p_i = 0, p_end = 0, total = 0;
  if constexpr (RECT) {
    p_i = args.chunk_ptr[blockIdx.x];
    p_end = args.chunk_ptr[blockIdx.x + 1];
    total = p_end - p_i;
  } else {
    slab_beg = args.block_ptr[b];
    slab_end = args.block_ptr[b + 1];
    for (int sl = slab_beg; sl < slab_end; ++sl)
      total += slab_ntiles[sl] * (WT / KC);
  }
  const long long xwin = RECT ? (long long)args.winstart[b] : 0;

  // producer cursor: the next chunk to stage
  int p_slab = slab_beg, p_col = 0;
  int p_ncols = p_slab < slab_end ? slab_ntiles[p_slab] * WT : 0;
  const int x_pieces = KC * dc * (int)sizeof(XT) / 16;
  const char* X = static_cast<const char*>(args.X);
  // one chunk into ring stage stage_idx: the RW band rows from row0 at
  // column col of each plane, and the KC X rows from xrow0
  auto stage = [&](int stage_idx, long long row0, long long col,
                   long long xrow0) {
    unsigned char* st = smem + stage_idx * G::STAGE;
    stage_plane<RW, M::B0, M::L0, G::THREADS>(
        st, args.band0 + row0 * args.ld0 + col * M::B0, args.ld0, tid);
    if constexpr (M::B1 > 0)
      stage_plane<RW, M::B1, M::L1, G::THREADS>(
          st + RW * M::L0, args.band1 + row0 * args.ld1 + col * M::B1,
          args.ld1, tid);
    const char* xsrc = X + xrow0 * dc * (long long)sizeof(XT);
    for (int p = tid; p < x_pieces; p += G::THREADS)
      cp16(st + G::A_BYTES + p * 16, xsrc + p * 16);
  };
  auto issue = [&](int stage_idx) {
    if constexpr (RECT) {
      if (p_i < p_end) {
        const long long col = (long long)args.chunk_col[p_i++] * KC;
        stage(stage_idx, b * R + rg * RW, col, xwin + col);
      }
    } else if (p_slab < slab_end) {
      const int tile = p_col / WT;
      stage(stage_idx, (long long)p_slab * R + rg * RW, p_col,
            (long long)args.slab_starts[(long long)p_slab * S + tile] +
                (p_col - tile * WT));
      p_col += KC;
      if (p_col >= p_ncols) {
        ++p_slab;
        p_col = 0;
        if (p_slab < slab_end) p_ncols = slab_ntiles[p_slab] * WT;
      }
    }
    cp_commit();  // an empty group past the end keeps the count uniform
  };

  float* red = reinterpret_cast<float*>(smem);
  if constexpr (FFMA) {
    const int row = (warp % G::WM) * 32 + lane, kg = warp / G::WM;
    float acc[DN];
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[c] = 0.f;
#pragma unroll
    for (int s = 0; s < G::NST - 1; ++s) issue(s);
    for (int i = 0; i < total; ++i) {
      cp_wait<G::NST - 2>();
      __syncthreads();
      issue((i + G::NST - 1) % G::NST);
      ffma_chunk<RW, DN>(smem + (i % G::NST) * G::STAGE, row, kg * G::KW, dc,
                         acc);
    }
    cp_wait<0>();
    __syncthreads();
    float* p = red + ((long long)kg * RW + row) * DN;
#pragma unroll
    for (int c = 0; c < DN; ++c) p[c] = acc[c];
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int wk = warp % G::WK;
    const int wn = (warp / G::WK) % G::WN;
    const int wm = warp / (G::WK * G::WN);
    float acc[G::MT][G::NT][4];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll
    for (int s = 0; s < G::NST - 1; ++s) issue(s);
    for (int i = 0; i < total; ++i) {
      cp_wait<G::NST - 2>();  // chunk i has landed (this thread's copies)
      __syncthreads();        // ... everyone's; chunk i - 1's stage is free
      issue((i + G::NST - 1) % G::NST);
      mma_chunk<F, RW, DN>(smem + (i % G::NST) * G::STAGE, dc, wm, wn, wk,
                           g, t, acc);
    }
    cp_wait<0>();
    __syncthreads();  // the ring is free: it holds the partial tiles now

#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      const int row = (wm * G::MT + mt) * 16 + g;
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const int col = wn * 32 + nt * 8 + 2 * t;
        float* p = red + ((long long)wk * RW + row) * DN + col;
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(p + 8 * DN) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
  __syncthreads();
  const long long row0 = b * R + rg * RW;
  float* orow = args.out + row0 * args.ldo;
  for (int e = tid; e < RW * dc; e += G::THREADS) {
    const int r = e / dc, c = e - r * dc;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < G::WK; ++w) s += red[(w * RW + r) * DN + c];
    // the row's power-of-two scale, exact
    if constexpr (F == ROWQ2 || F == ROWQ1) s *= args.srow[row0 + r];
    orow[r * args.ldo + c] = s;
  }
}

template <int F, int RW, int DN, bool RECT, bool FFMA = false>
int launch(const Args& a, cudaStream_t s) {
  using G = GeoOf<F, RW, DN, FFMA>;
  const long long ctas = a.nblocks * (a.R / RW);
  if (ctas == 0) return (int)cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      tiles_spmm_kernel<F, RW, DN, RECT, FFMA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  tiles_spmm_kernel<F, RW, DN, RECT, FFMA>
      <<<(unsigned int)ctas, G::THREADS, G::SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// K2/K3/K5: ROWS rows.  K10/K11: QROWS where R is a multiple of it, else
// ROWS (the 128-row CTA measured no slower at any d: PERF.md).
template <int F, int DN, bool RECT>
int launch_rows(const Args& a, cudaStream_t s) {
  if constexpr (F != F32 && F != BF16) {
    if (a.R % QROWS == 0) return launch<F, QROWS, DN, RECT>(a, s);
  }
  return launch<F, ROWS, DN, RECT>(a, s);
}

bool bad_geometry(const Args& a) {
  return a.dc < 1 || a.dc > DMAX || a.R % ROWS || a.WT % KC || a.ldo < a.dc;
}

// The consumer follows d: F32 at d <= FMA_DMAX sums by FFMA (d padded to
// 2, 4, 8 or 16 columns), everything else on the tensor cores.
template <int F, bool RECT = false>
int launch_dn(const Args& a, cudaStream_t s) {
  if (bad_geometry(a)) return (int)cudaErrorInvalidValue;
  if constexpr (F == F32) {
    if (a.dc <= 2) return launch<F32, ROWS, 2, RECT, true>(a, s);
    if (a.dc <= 4) return launch<F32, ROWS, 4, RECT, true>(a, s);
    if (a.dc <= 8) return launch<F32, ROWS, 8, RECT, true>(a, s);
    if (a.dc <= FMA_DMAX) return launch<F32, ROWS, 16, RECT, true>(a, s);
  } else {
    if (a.dc <= 8) return launch_rows<F, 8, RECT>(a, s);
    if (a.dc <= 16) return launch_rows<F, 16, RECT>(a, s);
  }
  if (a.dc <= 32) return launch_rows<F, 32, RECT>(a, s);
  if (a.dc <= 64) return launch_rows<F, 64, RECT>(a, s);
  return launch_rows<F, 128, RECT>(a, s);
}

}  // namespace

// K2/K3.  band: (G*R, band_ld) float32 (band_bf16 == 0) or bfloat16,
// 16-byte aligned; X: (rows, d) of the same type, contiguous, 16-byte
// aligned; out: row r, column c at out[r * ldo + c], float32, (nblocks*R)
// rows.  R must be a multiple of ROWS, WT of KC, tile starts of WT, and
// 1 <= d <= DMAX.  Returns cudaGetLastError() after the launch.
extern "C" int glt_tiles_spmm(const void* band, int band_bf16,
                              long long band_ld, int R, const int* block_ptr,
                              const int* slab_starts, const int* slab_ntiles,
                              int S, int WT, long long nblocks, const void* X,
                              int d, float* out, long long ldo,
                              void* stream) {
  const long long cell = band_bf16 ? 2 : 4;
  const Args a{static_cast<const char*>(band), band_ld * cell, nullptr, 0,
               nullptr, R, block_ptr, slab_starts, slab_ntiles, S, WT,
               nblocks, X, d, out, ldo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_bf16) return launch_dn<BF16>(a, s);
  return launch_dn<F32>(a, s);
}

// K5.  band: (nblocks*R, W) float32 (band_bf16 == 0) or bfloat16, 16-byte
// aligned; winstart: (nblocks,) int32, multiples of 8; chunk_ptr
// (nblocks*R/ROWS + 1,) and chunk_col: int32, the live KC-column chunks of
// each ROWS-row group, ascending; X: (rows, d) of the band's type,
// contiguous, 16-byte aligned, rows >= max(winstart) + W; out as K2's.  R
// must be a multiple of ROWS, W of KC, and 1 <= d <= DMAX.
extern "C" int glt_rect_spmm(const void* band, int band_bf16, int W, int R,
                             const int* winstart, const int* chunk_ptr,
                             const int* chunk_col, long long nblocks,
                             const void* X, int d, float* out, long long ldo,
                             void* stream) {
  const long long cell = band_bf16 ? 2 : 4;
  const Args a{static_cast<const char*>(band), W * cell, nullptr, 0,
               nullptr, R, nullptr, nullptr, nullptr, 0, W, nblocks, X, d,
               out, ldo, chunk_ptr, chunk_col, winstart};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (band_bf16) return launch_dn<BF16, true>(a, s);
  return launch_dn<F32, true>(a, s);
}

// K10.  qband: (G*R, planes*S*WT) int8, 16-byte aligned, plane lo S*WT
// columns after plane hi; srow: (nblocks*R,) float32; X: (rows, d) float32
// (planes 2) or bfloat16 (planes 1), 16-byte aligned; out and the
// geometry as K2's.
extern "C" int glt_tiles_spmm_rowq(const void* qband, int planes,
                                   const float* srow, int R,
                                   const int* block_ptr,
                                   const int* slab_starts,
                                   const int* slab_ntiles, int S, int WT,
                                   long long nblocks, const void* X, int d,
                                   float* out, long long ldo,
                                   void* stream) {
  const long long sw = (long long)S * WT;
  const char* q = static_cast<const char*>(qband);
  const Args a{q, planes * sw, q + sw, planes * sw, srow, R, block_ptr,
         slab_starts, slab_ntiles, S, WT, nblocks, X, d, out, ldo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes == 2) return launch_dn<ROWQ2>(a, s);
  if (planes == 1) return launch_dn<ROWQ1>(a, s);
  return (int)cudaErrorInvalidValue;
}

// K11.  hi: (G*R, S*WT) bfloat16; q: the same shape, int8; both 16-byte
// aligned; X: (rows, d) float32, 16-byte aligned; out and the geometry as
// K2's.
extern "C" int glt_tiles_spmm_i8(const void* hi, const void* q, int R,
                                 const int* block_ptr, const int* slab_starts,
                                 const int* slab_ntiles, int S, int WT,
                                 long long nblocks, const void* X, int d,
                                 float* out, long long ldo, void* stream) {
  const long long sw = (long long)S * WT;
  const Args a{static_cast<const char*>(hi), 2 * sw,
               static_cast<const char*>(q), sw, nullptr, R, block_ptr,
               slab_starts, slab_ntiles, S, WT, nblocks, X, d, out, ldo};
  return launch_dn<I8>(a, static_cast<cudaStream_t>(stream));
}
