// The plain ELL product: out = W @ X over each row's real slots.
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA as a
// gather of every padded slot, X[cols] (n, k, d), and one batched
// product.  In torch that form writes and reads back the (n, k, d)
// intermediate, with every row padded to the largest degree (k = 125 for
// a mean of 16 on the 20-d ten-cluster graph: 1.05 GB at d = 30, nearly
// 7 in 8 of it padding).  Here out[i, q] = sum over j < deg[i] of
// vals[i, j] * X[cols[i, j], q], and nothing is materialised.
//
// Bound: bytes.  The least traffic is the real slots' values and column
// indices once, X read once and out written once (about 26 MB on that
// graph at d = 30); X's rows come through L2 (X is 8.4 MB there, inside
// the 50 MB L2), so the product also moves about nnz * d * 4 bytes from
// L2, 136 MB there.  Design:
//   * a sub-group of G lanes owns a row, one column of X a lane: G is the
//     next power of two >= d up to 32, so a warp holds 32 / G rows; for d
//     > 32 a warp owns a row and a block of 32 * NC columns (NC <= 4
//     columns a lane, more blocks in gridDim.y);
//   * blocks of 2 warps: a block's warps stay resident until its longest
//     row is done, and the degrees are skewed (up to 125 for a mean of
//     16); against blocks of 8 warps this took 0.0506 ms in place of
//     0.0546 at d = 30 on that graph, 0.0856 in place of 0.1094 at d = 57
//     (H100 SXM, CUDA graph of 20 products);
//   * the sub-group loads its row's slots G at a time, coalesced, and
//     broadcasts each slot's column and value by shuffle; the lanes then
//     read neighbouring columns of one X row;
//   * the X loads of up to 8 slots are issued before their FMAs, so a
//     warp keeps several L2 reads in flight;
//   * each (row, column) sums its slots in slot order with float32 FFMA,
//     no TF32, no atomics: the result is the same in every run.
// Every row's loop runs to the warp's largest degree (its shuffles need
// the whole warp), each lane predicating its loads and FMAs on its own
// row's degree; at one row a warp (d > 16) that is the row's own degree.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 8;      // X loads in flight before their FMAs
constexpr int NC_MAX = 4;      // columns a lane for d > 32
constexpr unsigned FULL = 0xffffffffu;

template <int G, int NC>
__global__ void __launch_bounds__(THREADS)
    plain_ell_spmm_kernel(const int* __restrict__ cols,
                          const float* __restrict__ vals,
                          const int* __restrict__ deg, int k, long long n,
                          const float* __restrict__ X, long long ldx, int d,
                          float* __restrict__ out) {
  constexpr int ROWS = THREADS / G;        // rows a block
  constexpr int U = G < UNROLL ? G : UNROLL;
  const int lane = threadIdx.x & 31;
  const int sl = lane & (G - 1);           // lane within the row's group
  const long long row = (long long)blockIdx.x * ROWS + threadIdx.x / G;
  const int col0 = blockIdx.y * 32 * NC + sl;
  int rdeg = 0;
  if (row < n) rdeg = min(deg[row], k);
  const int wdeg = G == 32 ? rdeg : __reduce_max_sync(FULL, rdeg);
  const long long base_slot = row * k;

  float acc[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) acc[m] = 0.f;

  for (int base = 0; base < wdeg; base += G) {
    const int s = base + sl;
    int c = 0;
    float v = 0.f;
    if (s < rdeg) {
      c = cols[base_slot + s];
      v = vals[base_slot + s];
    }
    const int cnt = rdeg - base;           // this row's slots in the group
    const int wcnt = wdeg - base;          // the warp's largest
#pragma unroll
    for (int t0 = 0; t0 < G; t0 += U) {
      if (t0 >= wcnt) break;               // the same in the whole warp
      float xv[U][NC];
      float vv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ct = __shfl_sync(FULL, c, t0 + u, G);
        vv[u] = __shfl_sync(FULL, v, t0 + u, G);
        const float* xr = X + (long long)ct * ldx;
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const int q = col0 + 32 * m;
          xv[u][m] = (t0 + u < cnt && q < d) ? __ldg(xr + q) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t0 + u < cnt) {
#pragma unroll
          for (int m = 0; m < NC; ++m) acc[m] = fmaf(vv[u], xv[u][m], acc[m]);
        }
      }
    }
  }
  if (row < n) {
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int q = col0 + 32 * m;
      if (q < d) out[row * d + q] = acc[m];
    }
  }
}

template <int G, int NC>
void launch(const int* cols, const float* vals, const int* deg, int k,
            long long n, const float* X, long long ldx, int d, float* out,
            cudaStream_t s) {
  constexpr int ROWS = THREADS / G;
  const dim3 grid((unsigned int)((n + ROWS - 1) / ROWS),
                  (unsigned int)((d + 32 * NC - 1) / (32 * NC)));
  plain_ell_spmm_kernel<G, NC><<<grid, THREADS, 0, s>>>(cols, vals, deg, k,
                                                        n, X, ldx, d, out);
}

}  // namespace

// cols: (n, k) int32, vals: (n, k) float32, each row's deg[i] real slots
// first; deg: (n,) int32; X: float32 rows of d values at a row stride of
// ldx elements, one row for every column the real slots name; out: (n, d)
// float32, contiguous.  The thread mapping follows d.  Returns
// cudaGetLastError() after the launch.
extern "C" int glt_plain_ell_spmm(const int* cols, const float* vals,
                                  const int* deg, int k, long long n,
                                  const float* X, long long ldx, int d,
                                  float* out, void* stream) {
  if (n > 0 && d > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d <= 1) {
      launch<1, 1>(cols, vals, deg, k, n, X, ldx, d, out, s);
    } else if (d <= 2) {
      launch<2, 1>(cols, vals, deg, k, n, X, ldx, d, out, s);
    } else if (d <= 4) {
      launch<4, 1>(cols, vals, deg, k, n, X, ldx, d, out, s);
    } else if (d <= 8) {
      launch<8, 1>(cols, vals, deg, k, n, X, ldx, d, out, s);
    } else if (d <= 16) {
      launch<16, 1>(cols, vals, deg, k, n, X, ldx, d, out, s);
    } else if (d <= 32) {
      launch<32, 1>(cols, vals, deg, k, n, X, ldx, d, out, s);
    } else if (d <= 64) {
      launch<32, 2>(cols, vals, deg, k, n, X, ldx, d, out, s);
    } else if (d <= 96) {
      launch<32, 3>(cols, vals, deg, k, n, X, ldx, d, out, s);
    } else {
      launch<32, NC_MAX>(cols, vals, deg, k, n, X, ldx, d, out, s);
    }
  }
  return (int)cudaGetLastError();
}
