// K6: the Becke partition (Becke, JCP 88, 2547 (1988)) of every grid point
// with respect to its owning atom, for Hopper (sm_90a), in f64.
//
// Replaces the eager chunks of grids/becke.py::becke_weights (the port of
// quantum_compute_dft_tpu/grids/becke.py::becke_weights, which XLA
// compiles; the JAX package has no Pallas kernel for the partition).  Same
// function, with the Appendix size adjustment:
//
//   d_i      = |r_g - R_i|
//   mu_ij    = (d_i - d_j) / R_ij,  nu_ij = mu_ij + a_ij (1 - mu_ij^2)
//   p        = nu_ij, then three times p = 0.5 p (3 - p^2)
//   s_ij     = 0.5 (1 - p)
//   P_i      = prod_{j != i} s_ij      (j ascending)
//   w[g]     = P_own(g) / sum_i P_i
//
// every ordered pair evaluated, nothing screened or cut.  The wrapper hands
// the per-molecule tables {1/R_ij, a_ij} (a_ij from the Bragg radii,
// clamped to +-0.5, as the plain version computes it), so the kernel
// multiplies where the plain version divides; that, the order of the
// products and the contraction of the polynomial into FMAs make the two
// agree to rounding.
//
// What bounds it on this card: f64 arithmetic.  15 f64 instructions an
// ordered pair (2 for mu, 2 for nu, 9 for the polynomial, 1 for s, 1 for the
// product), ngrid natm (natm - 1) pairs: DHA at grid 3, 1.95e9 pairs, 1.7 ms
// at the 34 TFLOP/s vector rate (17e12 f64 instructions a second).  Inputs
// and output are a few MB.  The eager chunks wrote and re-read ~22
// (chunk, natm, natm) f64 intermediates a chunk in device memory, 15
// host-synced chunks at DHA.
// Design:
//   * one launch for the whole grid, one thread a point, no shared memory,
//     so nothing bounds the number of atoms and occupancy is set by the
//     registers alone;
//   * a thread walks the atoms i in tiles of kTile: the tile's d_i and its
//     kTile products P_i live in registers, and each d_j (one sqrt) serves
//     the whole tile, so the square roots are natm^2 / kTile a point and
//     the tile's kTile independent chains keep the f64 pipes busy; a ragged
//     last tile repeats its last atom and does not count it;
//   * the tables, {1/R_ij, a_ij} as one double2, are read by every thread
//     of a warp at the same index (a broadcast) through the read-only
//     cache; the self factor (j = i) is a select of 1.0, as in the plain
//     version.  Keeping each point's natm distances in shared memory
//     instead, with or without the tables beside them, ran slower on an
//     H100 (fewer warps a multiprocessor: 2.95 and 3.83 ms at DHA grid 3,
//     32.0 ms at the 117-atom north star's grid 1, against 2.82 and 10.4).
//
// Inputs (checked by the Python wrapper, grids/becke.py): coords (ngrid, 3)
// f64; owner (ngrid,) int32 in 0 .. natm - 1; atoms (natm, 3) f64; tables
// (natm, natm, 2) f64; w (ngrid,) f64; all contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// atoms a tile; on an H100 at DHA grid 3, 4 / 8 / 16 ran 2.99 / 2.82 /
// 2.92 ms (48 / 76 / 128 registers, no spills)
constexpr int kTile = 8;

__device__ __forceinline__ double distance(double x, double y, double z,
                                           const double* __restrict__ atom) {
  const double dx = x - __ldg(atom);
  const double dy = y - __ldg(atom + 1);
  const double dz = z - __ldg(atom + 2);
  return sqrt(dx * dx + dy * dy + dz * dz);
}

// s(nu_ij) from d_i, d_j and the pair's {1/R_ij, a_ij}
__device__ __forceinline__ double step(double di, double dj, double2 t) {
  const double mu = (di - dj) * t.x;
  double p = mu + t.y * (1.0 - mu * mu);
#pragma unroll
  for (int k = 0; k < 3; ++k) p = 0.5 * p * (3.0 - p * p);
  return 0.5 * (1.0 - p);
}

__global__ void __launch_bounds__(kThreads)
becke_kernel(int ngrid, int natm, const double* __restrict__ coords,
             const int* __restrict__ owner, const double* __restrict__ atoms,
             const double2* __restrict__ tables, double* __restrict__ w) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (g >= ngrid) return;
  const double x = coords[3 * g], y = coords[3 * g + 1], z = coords[3 * g + 2];
  const int own = owner[g];
  double sum = 0.0, p_own = 0.0;
#pragma unroll 1
  for (int i0 = 0; i0 < natm; i0 += kTile) {
    int row[kTile];
    double di[kTile], p[kTile];
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const int i = i0 + k < natm ? i0 + k : natm - 1;
      row[k] = i * natm;
      di[k] = distance(x, y, z, atoms + 3 * i);
      p[k] = 1.0;
    }
#pragma unroll 1
    for (int j = 0; j < natm; ++j) {
      const double dj = distance(x, y, z, atoms + 3 * j);
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const double s = step(di[k], dj, __ldg(tables + row[k] + j));
        p[k] *= i0 + k == j ? 1.0 : s;
      }
    }
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      if (i0 + k < natm) {
        sum += p[k];
        if (i0 + k == own) p_own = p[k];
      }
    }
  }
  w[g] = p_own / sum;
}

}  // namespace

extern "C" {

// One launch on `stream`: w over all ngrid points.  Returns
// cudaGetLastError() after the launch (0: launched), -1 for arguments it
// does not take.
int becke_weights(int ngrid, int natm, const double* coords, const int* owner,
                  const double* atoms, const double* tables, double* w,
                  void* stream) {
  if (ngrid <= 0 || natm <= 1) return -1;
  const long long blocks = (static_cast<long long>(ngrid) + kThreads - 1) /
                           kThreads;
  if (blocks > 0x7fffffffLL) return -1;
  becke_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      ngrid, natm, coords, owner, atoms,
      reinterpret_cast<const double2*>(tables), w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
