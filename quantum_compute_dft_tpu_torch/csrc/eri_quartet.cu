// K4: the quartet stage of the McMurchie-Davidson two-electron integrals
// for Hopper (sm_90a), in f64.
//
// Replaces the eager tile of integrals/two_electron.py::_quartet_kernel (the
// port of quantum_compute_dft_tpu/integrals/two_electron.py::_block_runner,
// which XLA compiles; the JAX package has no Pallas kernel for it).  Same
// arithmetic per primitive quartet (bra pair primitive c, ket pair primitive
// d; p, q exponent sums, P, Q centres, E~ the pairs' Hermite coefficients
// times the contraction weights):
//
//   alpha = p q / (p + q),  PQ = P - Q,  F_n = boys_fast(alpha |PQ|^2)
//   R^n_tuv by the recursion of integrals/mcmurchie.py::r_tensor
//   (ab|cd) += 2 pi^2.5 / (p q sqrt(p + q))
//              sum_{a,b} E~bra[a] E~ket[b] (-1)^(t_b+u_b+v_b) R^0[a + b]
//
// summed over the 9 x 9 primitive pairs of each contracted pair quartet.
// The Boys function is integrals/boys.py::boys_fast: the same Taylor table
// (7 terms around nodes 1/16 apart, up to x = 12; passed in, orders mmax ..
// mmax + 7 at each node), the same downward recursion, the same large-x
// branch (erf, upward recursion).  Every quartet the eager tiles compute is
// computed; nothing is screened, nothing runs below f64.  Divisions by
// constants are products with their reciprocals, and 1 / (p + q) comes from
// one rsqrt, so values differ from the eager tiles' in the last bits.
//
// What bounds it on this card: f64 arithmetic.  A primitive quartet is
// ~190 f64 operations besides the contraction at L = 2 (pair geometry, the
// Boys function, the R recursion's 65 entries, the prefactor) and 2 (nc^2 +
// nc) in it (nc = 10 Hermite combinations a pair at L = 2, 35 at L = 4):
// 417 at L = 2, 3,744 at L = 4 (two_electron.k4_flops); the inputs are a
// few MB and the output is written once.  The eager tiles ran ~300
// launches a 128 x 128 block, each writing and re-reading a (128, 128, 9, 9)
// intermediate (10.6 MB) in device memory.  Design:
//   * one thread owns a contracted (row pair, column pair) quartet and
//     loops over its 81 primitive quartets with the Boys values, the R
//     recursion (in place in one register array, highest order first) and
//     the contraction in registers; nothing intermediate leaves the SM;
//   * a block is kRows row pairs (one a thread) by kCols column pairs; it
//     stages its column pairs' Hermite data (q, Q, 1 / q and E~ times the
//     parity) and the Boys table in shared memory; each thread reads its row
//     pair from the packed table, field-major, so a warp's reads coalesce;
//   * every index of the recursion and the contraction is a compile-time
//     constant: the kernel is a template on L = 2 lmax (0, 2 or 4), built
//     one L per library (-DK4_L), so Boys orders reach 2 L (8 at d shells)
//     and R has up to 165 terms;
//   * the output is written once: the (nrow, ncol) block of a pivot panel,
//     the symmetric matrix (upper triangle computed, each value written to
//     both halves), or the diagonal (ab|ab) alone, one thread a pair.
//
// Inputs (checked by the Python wrapper, integrals/two_electron.py):
//   table  (9, 4 + nc, npair) f64: per primitive c and field f (p, Px, Py,
//          Pz, E~[0..nc-1] cw) the value of every pair, pairs contiguous;
//   boys   (kTabNodes, 8) f64: F_{mmax + k}(x_i), mmax = 2 L;
//   rows, cols: int32 indices into the table's pairs.

#include <cuda_runtime.h>

#ifndef K4_L
#error "build with -DK4_L=<pair angular momentum bound 2 lmax: 0, 2 or 4>"
#endif

namespace {

constexpr int kPrim = 9;        // primitive pairs of a contracted pair (3 x 3)
constexpr int kRows = 128;      // row pairs of a block, one a thread
constexpr int kCols = 8;        // column pairs of a block
constexpr int kTabNodes = 194;  // boys_fast's nodes: 0, 1/16, ..., 12 + 1/16
constexpr int kTabTerms = 8;    // orders mmax .. mmax + 7 at each node
constexpr double kTabXmax = 12.0;
constexpr double kTabDx = 0.0625;
constexpr double kTwoPi25 = 34.986836655249725;   // 2 pi^2.5
constexpr double kHalfSqrtPi = 0.8862269254527579;

__host__ __device__ constexpr int ncombo(int l) {
  return (l + 1) * (l + 2) * (l + 3) / 6;
}

// position of (t, u, v) in mcmurchie.hermite_combos(l): t outer, then u, v
__host__ __device__ constexpr int combo(int l, int t, int u, int v) {
  return ncombo(l) - ncombo(l - t) + u * (l - t + 1) - u * (u - 1) / 2 + v;
}

template <int L>
struct Shape {
  static constexpr int LT = 2 * L;          // Boys orders 0 .. LT
  static constexpr int NC = ncombo(L);      // Hermite combinations a pair
  static constexpr int NR = ncombo(LT);     // R^0 terms of a quartet
  static constexpr int NF = 4 + NC;         // table fields a primitive
  static constexpr int NK = 5 + NC;         // staged ket fields a primitive
};

// F_0 .. F_M at x (integrals/boys.py::boys_fast); tab: orders M .. M + 7
template <int M>
__device__ __forceinline__ void boys(double x, const double* tab, double* f) {
  if (x < kTabXmax) {
    const int i = __double2int_rn(x * (1.0 / kTabDx));
    const double dx = i * kTabDx - x;
    const double* c = tab + i * kTabTerms;
    double top = c[kTabTerms - 1];
#pragma unroll
    for (int k = kTabTerms - 2; k >= 0; --k)
      top = c[k] + top * dx * (1.0 / (k + 1));
    const double e = exp(-x);
    f[M] = top;
#pragma unroll
    for (int m = M; m > 0; --m)
      f[m - 1] = (2.0 * x * f[m] + e) * (1.0 / (2 * m - 1));
  } else {
    const double sx = sqrt(x);
    f[0] = kHalfSqrtPi / sx * erf(sx);
    const double e = exp(-x);
    const double h = 0.5 / x;
#pragma unroll
    for (int m = 0; m < M; ++m) f[m + 1] = ((2 * m + 1) * f[m] - e) * h;
  }
}

// R^0_tuv for t + u + v <= LT (mcmurchie.r_tensor): layer n = LT .. 0 in
// place, each layer's highest total order first, so every entry still
// reads the layer n + 1 values of the orders below it
template <int LT>
__device__ __forceinline__ void hermite_r(double alpha, double x, double y,
                                          double z, const double* f,
                                          double* r) {
  double pw[LT + 1];
  pw[0] = 1.0;
#pragma unroll
  for (int n = 1; n <= LT; ++n) pw[n] = pw[n - 1] * (-2.0 * alpha);
#pragma unroll
  for (int n = LT; n >= 0; --n) {
#pragma unroll
    for (int m = LT - n; m >= 1; --m) {
#pragma unroll
      for (int t = 0; t <= m; ++t) {
#pragma unroll
        for (int u = 0; u <= m - t; ++u) {
          const int v = m - t - u;
          double val;
          if (t > 0) {
            val = x * r[combo(LT, t - 1, u, v)];
            if (t > 1) val = (t - 1) * r[combo(LT, t - 2, u, v)] + val;
          } else if (u > 0) {
            val = y * r[combo(LT, t, u - 1, v)];
            if (u > 1) val = (u - 1) * r[combo(LT, t, u - 2, v)] + val;
          } else {
            val = z * r[combo(LT, t, u, v - 1)];
            if (v > 1) val = (v - 1) * r[combo(LT, t, u, v - 2)] + val;
          }
          r[combo(LT, t, u, v)] = val;
        }
      }
    }
    r[0] = pw[n] * f[n];
  }
}

// one primitive quartet: bra (p, 1/p, P, E~) against the staged ket kd
template <int L>
__device__ __forceinline__ double primitive(double p, double ip, double px,
                                            double py, double pz,
                                            const double* e1,
                                            const double* kd,
                                            const double* tab) {
  using S = Shape<L>;
  const double q = kd[0];
  const double x = px - kd[1], y = py - kd[2], z = pz - kd[3];
  const double rs = rsqrt(p + q);
  const double alpha = p * q * (rs * rs);
  double f[S::LT + 1];
  boys<S::LT>(alpha * (x * x + y * y + z * z), tab, f);
  double r[S::NR];
  hermite_r<S::LT>(alpha, x, y, z, f, r);
  double acc = 0.0;
  int a = 0;
#pragma unroll
  for (int t1 = 0; t1 <= L; ++t1)
#pragma unroll
    for (int u1 = 0; u1 <= L - t1; ++u1)
#pragma unroll
      for (int v1 = 0; v1 <= L - t1 - u1; ++v1) {
        double s = 0.0;
        int b = 0;
#pragma unroll
        for (int t2 = 0; t2 <= L; ++t2)
#pragma unroll
          for (int u2 = 0; u2 <= L - t2; ++u2)
#pragma unroll
            for (int v2 = 0; v2 <= L - t2 - u2; ++v2) {
              s += kd[5 + b] * r[combo(S::LT, t1 + t2, u1 + u2, v1 + v2)];
              ++b;
            }
        acc += e1[a] * s;
        ++a;
      }
  return kTwoPi25 * ip * kd[4] * rs * acc;
}

// the ket fields of primitive d of `pair` (q, Q, 1/q, E~ cw times parity)
template <int L>
__device__ __forceinline__ void load_ket(const double* __restrict__ table,
                                         int npair, int pair, int d,
                                         double* kd) {
  using S = Shape<L>;
  const double* src = table + static_cast<size_t>(d) * S::NF * npair + pair;
  kd[0] = src[0];
  kd[1] = src[npair];
  kd[2] = src[2 * npair];
  kd[3] = src[3 * npair];
  kd[4] = 1.0 / kd[0];
  int b = 0;
#pragma unroll
  for (int t = 0; t <= L; ++t)
#pragma unroll
    for (int u = 0; u <= L - t; ++u)
#pragma unroll
      for (int v = 0; v <= L - t - u; ++v) {
        const double e = src[static_cast<size_t>(4 + b) * npair];
        kd[5 + b] = ((t + u + v) & 1) ? -e : e;
        ++b;
      }
}

// the bra fields of primitive c of `pair`: p, P, E~ cw
template <int L>
__device__ __forceinline__ void load_bra(const double* __restrict__ table,
                                         int npair, int pair, int c,
                                         double& p, double& px, double& py,
                                         double& pz, double* e1) {
  using S = Shape<L>;
  const double* src = table + static_cast<size_t>(c) * S::NF * npair + pair;
  p = src[0];
  px = src[npair];
  py = src[2 * npair];
  pz = src[3 * npair];
#pragma unroll
  for (int a = 0; a < S::NC; ++a)
    e1[a] = src[static_cast<size_t>(4 + a) * npair];
}

__device__ __forceinline__ void stage_boys(const double* __restrict__ boys_tab,
                                           double* s_tab) {
  for (int k = threadIdx.x; k < kTabNodes * kTabTerms; k += blockDim.x)
    s_tab[k] = boys_tab[k];
}

// (rows[i] | cols[j]) for a kRows x kCols block; kSym: rows == cols, only
// j >= i computed, each value written at (i, j) and (j, i)
template <int L, bool kSym>
__global__ void __launch_bounds__(kRows)
eri_block_kernel(int npair, const double* __restrict__ table,
                 const double* __restrict__ boys_tab,
                 const int* __restrict__ rows, int nrow,
                 const int* __restrict__ cols, int ncol,
                 double* __restrict__ out) {
  using S = Shape<L>;
  __shared__ double s_tab[kTabNodes * kTabTerms];
  __shared__ double s_ket[kCols][kPrim][S::NK];
  const int row0 = blockIdx.y * kRows;
  const int j0 = blockIdx.x * kCols;
  if (kSym && j0 + kCols <= row0) return;   // wholly below the diagonal
  stage_boys(boys_tab, s_tab);
  for (int k = threadIdx.x; k < kCols * kPrim; k += blockDim.x) {
    const int jj = k / kPrim, d = k % kPrim;
    double* kd = s_ket[jj][d];
    if (j0 + jj < ncol) {
      load_ket<L>(table, npair, cols[j0 + jj], d, kd);
    } else {
      for (int f = 0; f < S::NK; ++f) kd[f] = 0.0;
    }
  }
  __syncthreads();
  const int i = row0 + threadIdx.x;
  if (i >= nrow) return;
  const int row = rows[i];
#pragma unroll 1
  for (int jj = 0; jj < kCols; ++jj) {
    const int j = j0 + jj;
    if (j >= ncol || (kSym && j < i)) continue;
    double v = 0.0;
#pragma unroll 1
    for (int c = 0; c < kPrim; ++c) {
      double p, px, py, pz, e1[S::NC];
      load_bra<L>(table, npair, row, c, p, px, py, pz, e1);
      const double ip = 1.0 / p;
#pragma unroll 1
      for (int d = 0; d < kPrim; ++d)
        v += primitive<L>(p, ip, px, py, pz, e1, s_ket[jj][d], s_tab);
    }
    out[static_cast<size_t>(i) * ncol + j] = v;
    if (kSym && j != i) out[static_cast<size_t>(j) * ncol + i] = v;
  }
}

// out[i] = (rows[i] | rows[i]), one thread a pair
template <int L>
__global__ void __launch_bounds__(kRows)
eri_diag_kernel(int npair, const double* __restrict__ table,
                const double* __restrict__ boys_tab,
                const int* __restrict__ rows, int nrow,
                double* __restrict__ out) {
  using S = Shape<L>;
  __shared__ double s_tab[kTabNodes * kTabTerms];
  stage_boys(boys_tab, s_tab);
  __syncthreads();
  const int i = blockIdx.x * kRows + threadIdx.x;
  if (i >= nrow) return;
  const int row = rows[i];
  double v = 0.0;
#pragma unroll 1
  for (int d = 0; d < kPrim; ++d) {
    double kd[S::NK];
    load_ket<L>(table, npair, row, d, kd);
#pragma unroll 1
    for (int c = 0; c < kPrim; ++c) {
      double p, px, py, pz, e1[S::NC];
      load_bra<L>(table, npair, row, c, p, px, py, pz, e1);
      v += primitive<L>(p, 1.0 / p, px, py, pz, e1, kd, s_tab);
    }
  }
  out[i] = v;
}

}  // namespace

extern "C" {

// the pair angular momentum bound this library was built for
int eri_quartet_l() { return K4_L; }

// One launch on `stream`.  mode 0: out (nrow, ncol) = (rows[i] | cols[j]);
// mode 1: out (nrow, nrow) symmetric over rows (cols unused); mode 2: out
// (nrow,) = (rows[i] | rows[i]).  Returns cudaGetLastError() after the
// launch (0: launched), -1 for an unknown mode or a grid too tall.
int eri_quartet(int mode, int npair, const double* table,
                const double* boys_tab, const int* rows, int nrow,
                const int* cols, int ncol, double* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_blocks = (nrow + kRows - 1) / kRows;
  if (nrow <= 0 || row_blocks > 65535) return -1;
  switch (mode) {
    case 0: {
      if (ncol <= 0) return -1;
      dim3 grid((ncol + kCols - 1) / kCols, row_blocks);
      eri_block_kernel<K4_L, false><<<grid, kRows, 0, st>>>(
          npair, table, boys_tab, rows, nrow, cols, ncol, out);
      break;
    }
    case 1: {
      dim3 grid((nrow + kCols - 1) / kCols, row_blocks);
      eri_block_kernel<K4_L, true><<<grid, kRows, 0, st>>>(
          npair, table, boys_tab, rows, nrow, rows, nrow, out);
      break;
    }
    case 2:
      eri_diag_kernel<K4_L><<<row_blocks, kRows, 0, st>>>(
          npair, table, boys_tab, rows, nrow, out);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
