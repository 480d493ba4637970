// K5: the AO planes (values, and with deriv 1 their gradients) at the grid
// points for Hopper (sm_90a), in f64.
//
// Replaces the eager chunks of engine/ao_eval.py::_eval_chunk (the port of
// quantum_compute_dft_tpu/engine/ao_eval.py::_eval_chunk, which XLA
// compiles; the JAX package has no Pallas kernel for the AO planes).  Same
// function of the basis set's flat primitive-term table, term by term:
//
//   d = r_g - centre_mu,  arg_t = -alpha_t |d|^2,
//   e_t = arg_t > -85 ? exp(arg_t) : 0        (the plain version's tail cut)
//   ao[g, mu]         = sum_t  w_t dx^px dy^py dz^pz e_t
//   grad[k, g, mu]    = sum_t  w_t (p_k d_k^(p_k - 1) - 2 alpha_t d_k^(p_k + 1))
//                               (the other two monomials) e_t
//
// with the terms summed in order t = 0 .. T - 1 and every power a chain of
// products, as the plain version's _int_pow.  All of it is f64; nothing is
// screened beyond that cut (a term it cuts, or a zero-weight padding term,
// adds an exact zero in the plain version and is skipped here).  The order
// of the three-term sums and the exp's last bits differ from PyTorch's, so
// values agree to rounding.
//
// What bounds it on this card: the bytes written.  The planes are f64 and
// written once: ngrid x nao x 8 B, four times that with gradients (DHA at
// grid 3: 3.08 GB, 0.92 ms at 3.35 TB/s; 0.77 GB without gradients); the
// inputs are a few kB.  Close behind come the f64 exponentials (ngrid x nao
// x T of them, 2.9e8 at DHA).  The eager chunks ran ~40 host steps a call,
// each writing and re-reading (16384, nao, T, 3) f64 intermediates in
// device memory (~180 MB each at DHA), ~0.37 s a DHA call with gradients.
// On an H100 80GB HBM3 at 700 W, K5 takes 2.24 ms there (41% of the bound)
// and 1.45 ms without gradients (16% of its 0.23 ms).
// Design:
//   * one launch for the whole grid, templated on deriv; nothing
//     intermediate leaves the registers;
//   * a block owns a tile of consecutive points (about 8 outputs a thread:
//     kThreads * 8 / nao points, at most kMaxTile) and stages their
//     coordinates in shared memory; its outputs are the contiguous range
//     ao[g0 .. g0 + tile, :] of each plane, walked by the block's threads
//     with the AO index fastest, so every store of a warp is 32 neighbouring
//     doubles;
//   * the per-AO table is packed field-major by the wrapper (centre x, y, z,
//     then alpha and weight per term: (3 + 2T, nao) f64; the three powers of
//     a term in one int, px + 8 py + 64 pz: (T, nao) int32), so a warp's
//     loads of one field coalesce; it is read through the read-only cache.
//
// Inputs (checked by the Python wrapper, engine/ao_eval.py):
//   coords (ngrid, 3) f64; table (3 + 2T, nao) f64; powers (T, nao) int32,
//   each power 0 .. 4 (so d^(p + 1) reaches 5); ao (ngrid, nao) f64 and, with deriv 1, grad
//   (3, ngrid, nao) f64, all contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOutputsPerThread = 8;
constexpr int kMaxTile = 64;   // points a block, at most
constexpr double kCut = -85.0;

// b^p for a small p >= 0 by chained products (1 for p = 0)
__device__ __forceinline__ double ipow(double b, int p) {
  double acc = 1.0;
#pragma unroll 1
  for (int k = 0; k < p; ++k) acc *= b;
  return acc;
}

template <int kDeriv>
__global__ void __launch_bounds__(kThreads)
ao_planes_kernel(int ngrid, int nao, int nterm, int tile,
                 const double* __restrict__ coords,
                 const double* __restrict__ table,
                 const int* __restrict__ powers, double* __restrict__ ao,
                 double* __restrict__ grad) {
  __shared__ double s_xyz[3 * kMaxTile];
  const long long g0 = static_cast<long long>(blockIdx.x) * tile;
  const long long left = ngrid - g0;
  const int npts = left < tile ? static_cast<int>(left) : tile;
  for (int i = threadIdx.x; i < 3 * npts; i += kThreads)
    s_xyz[i] = coords[3 * g0 + i];
  __syncthreads();

  const long long plane = static_cast<long long>(ngrid) * nao;
  const long long base = g0 * nao;
  const int nout = npts * nao;
  const double* alpha = table + 3 * nao;
  const double* weight = table + (3 + nterm) * nao;
  for (int i = threadIdx.x; i < nout; i += kThreads) {
    const int p = i / nao;
    const int mu = i - p * nao;
    const double dx = s_xyz[3 * p] - __ldg(table + mu);
    const double dy = s_xyz[3 * p + 1] - __ldg(table + nao + mu);
    const double dz = s_xyz[3 * p + 2] - __ldg(table + 2 * nao + mu);
    const double r2 = dx * dx + dy * dy + dz * dz;
    double v = 0.0, gx = 0.0, gy = 0.0, gz = 0.0;
#pragma unroll 1
    for (int t = 0; t < nterm; ++t) {
      const double a = __ldg(alpha + t * nao + mu);
      const double w = __ldg(weight + t * nao + mu);
      const double arg = -a * r2;
      if (!(arg > kCut) || w == 0.0) continue;
      const double e = exp(arg);
      const int pw = __ldg(powers + t * nao + mu);
      const int px = pw & 7, py = (pw >> 3) & 7, pz = pw >> 6;
      const double xp = ipow(dx, px), yp = ipow(dy, py), zp = ipow(dz, pz);
      v += w * (xp * yp * zp) * e;
      if (kDeriv) {
        const double a2 = 2.0 * a;
        const double fx =
            (px > 0 ? px * ipow(dx, px - 1) : 0.0) - a2 * (xp * dx);
        const double fy =
            (py > 0 ? py * ipow(dy, py - 1) : 0.0) - a2 * (yp * dy);
        const double fz =
            (pz > 0 ? pz * ipow(dz, pz - 1) : 0.0) - a2 * (zp * dz);
        gx += w * (fx * (yp * zp)) * e;
        gy += w * (fy * (xp * zp)) * e;
        gz += w * (fz * (xp * yp)) * e;
      }
    }
    ao[base + i] = v;
    if (kDeriv) {
      grad[base + i] = gx;
      grad[plane + base + i] = gy;
      grad[2 * plane + base + i] = gz;
    }
  }
}

}  // namespace

extern "C" {

// One launch on `stream`: ao (and with deriv 1, grad) over all ngrid points.
// Returns cudaGetLastError() after the launch (0: launched), -1 for
// arguments it does not take.
int ao_eval(int deriv, int ngrid, int nao, int nterm, const double* coords,
            const double* table, const int* powers, double* ao, double* grad,
            void* stream) {
  if (ngrid <= 0 || nao <= 0 || nterm <= 0 || (deriv != 0 && deriv != 1) ||
      (deriv == 1 && grad == nullptr))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int tile = (kThreads * kOutputsPerThread + nao - 1) / nao;
  tile = tile < 1 ? 1 : (tile > kMaxTile ? kMaxTile : tile);
  const long long blocks = (static_cast<long long>(ngrid) + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return -1;
  if (deriv == 1)
    ao_planes_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        ngrid, nao, nterm, tile, coords, table, powers, ao, grad);
  else
    ao_planes_kernel<0><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        ngrid, nao, nterm, tile, coords, table, powers, ao, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
