// Native host-side DFT engine with the reference-compatible C ABI.
//
// Implements the same four entry points as the reference CUDA engine
// (ref src/dft_solver.h:66-88): DFT_CreateSolver / DFT_DestroySolver /
// DFT_ComputeXC / DFT_ComputeCoulomb, so callers written against the
// reference's ctypes wrapper (ref dft.py:15-95) can switch by pointing at
// this library -- here the pointers are host memory and the compute is
// OpenMP CPU. The TPU path (engine/) is the primary engine; this is the
// portable native fallback plus the framework's native-runtime component.
//
// Design notes (deliberately different from the reference's CUDA):
//  * XC potentials are produced by forward-mode automatic differentiation
//    over a two-tangent dual number (value, d/drho, d/dsigma) -- the same
//    derivatives-by-AD philosophy as the JAX engine, immune to hand-derived
//    formula transcription errors.
//  * One fused pass per grid block: density + functional + V_xc
//    accumulation without materializing the (ngrid x nao) B matrix.
//  * V_xc = dE_xc/dD: B = w (vrho phi + 4 vsigma grad-rho . grad-phi)
//    before the symmetrization, as the reference's gga_fused_kernel
//    (ref src/dft_solver.cu:427-430).  The JAX package's copy of this file
//    has 2 vsigma, half the sigma term; DFT_SetSigmaFactor(solver, 2)
//    reproduces it, for comparisons with that package.
//  * No cuBLAS/Eigen: small blocked matmuls with OpenMP are plenty for a
//    host fallback.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC dft_host.cpp -o libdft_host.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kRhoEps = 1e-10;   // density floor (matches the JAX engine;
//                                     see xc/functionals.py on why 1e-10)
constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------------
// Dual2: value + two tangents (d/drho, d/dsigma)
// ---------------------------------------------------------------------
struct Dual2 {
  double v, dr, ds;
};

inline Dual2 make_rho(double r) { return {r, 1.0, 0.0}; }
inline Dual2 make_sigma(double s) { return {s, 0.0, 1.0}; }
inline Dual2 c(double x) { return {x, 0.0, 0.0}; }

inline Dual2 operator+(Dual2 a, Dual2 b) { return {a.v + b.v, a.dr + b.dr, a.ds + b.ds}; }
inline Dual2 operator-(Dual2 a, Dual2 b) { return {a.v - b.v, a.dr - b.dr, a.ds - b.ds}; }
inline Dual2 operator-(Dual2 a) { return {-a.v, -a.dr, -a.ds}; }
inline Dual2 operator*(Dual2 a, Dual2 b) {
  return {a.v * b.v, a.dr * b.v + a.v * b.dr, a.ds * b.v + a.v * b.ds};
}
inline Dual2 operator/(Dual2 a, Dual2 b) {
  double inv = 1.0 / b.v;
  double q = a.v * inv;
  return {q, (a.dr - q * b.dr) * inv, (a.ds - q * b.ds) * inv};
}
inline Dual2 operator+(Dual2 a, double b) { return {a.v + b, a.dr, a.ds}; }
inline Dual2 operator+(double a, Dual2 b) { return b + a; }
inline Dual2 operator-(Dual2 a, double b) { return {a.v - b, a.dr, a.ds}; }
inline Dual2 operator-(double a, Dual2 b) { return {a - b.v, -b.dr, -b.ds}; }
inline Dual2 operator*(Dual2 a, double b) { return {a.v * b, a.dr * b, a.ds * b}; }
inline Dual2 operator*(double a, Dual2 b) { return b * a; }
inline Dual2 operator/(double a, Dual2 b) { return c(a) / b; }
inline Dual2 operator/(Dual2 a, double b) { return {a.v / b, a.dr / b, a.ds / b}; }

inline Dual2 chain(double f, double fp, Dual2 x) {
  return {f, fp * x.dr, fp * x.ds};
}
inline Dual2 pow_(Dual2 x, double p) {
  double f = std::pow(x.v, p);
  return chain(f, p * f / x.v, x);
}
inline Dual2 log_(Dual2 x) { return chain(std::log(x.v), 1.0 / x.v, x); }
inline Dual2 exp_(Dual2 x) { double f = std::exp(x.v); return chain(f, f, x); }
inline Dual2 expm1_(Dual2 x) { return chain(std::expm1(x.v), std::exp(x.v), x); }
inline Dual2 sqrt_(Dual2 x) { double f = std::sqrt(x.v); return chain(f, 0.5 / f, x); }
inline Dual2 atan_(Dual2 x) { return chain(std::atan(x.v), 1.0 / (1.0 + x.v * x.v), x); }
inline Dual2 asinh_(Dual2 x) {
  return chain(std::asinh(x.v), 1.0 / std::sqrt(1.0 + x.v * x.v), x);
}
inline Dual2 min_(Dual2 x, double cap) { return x.v <= cap ? x : c(cap); }

// ---------------------------------------------------------------------
// Functionals: f(rho, sigma) = rho * eps_xc  (closed shell)
// Constants identical to the reference engine (ref src/dft_solver.cu:12-49).
// ---------------------------------------------------------------------
const double kCx = 0.7385587663820224;

inline Dual2 slater_x(Dual2 rho) { return -kCx * pow_(rho, 1.0 / 3.0); }

inline Dual2 vwn_eps(Dual2 rho, double A, double b, double c0, double x0) {
  Dual2 rs = pow_(c(3.0 / (4.0 * kPi)) / rho, 1.0 / 3.0);
  Dual2 x = sqrt_(rs);
  Dual2 X = x * x + b * x + c0;
  double Q = std::sqrt(4.0 * c0 - b * b);
  double X0 = x0 * x0 + b * x0 + c0;
  Dual2 at = atan_(c(Q) / (2.0 * x + b));
  return A * (log_(x * x / X) + (2.0 * b / Q) * at -
              (b * x0 / X0) * (log_((x - x0) * (x - x0) / X) +
                               (2.0 * (2.0 * x0 + b) / Q) * at));
}

inline Dual2 vwn5_c(Dual2 rho) { return vwn_eps(rho, 0.0310907, 3.72744, 12.9352, -0.10498); }
inline Dual2 vwn_rpa_c(Dual2 rho) { return vwn_eps(rho, 0.0310907, 13.0720, 42.7198, -0.409286); }

const double kApw92 = 0.03109069086965489503;

inline Dual2 pw92_c(Dual2 rho) {
  Dual2 rs = pow_(c(3.0 / (4.0 * kPi)) / rho, 1.0 / 3.0);
  Dual2 srs = sqrt_(rs);
  Dual2 q = 2.0 * kApw92 *
            (7.5957 * srs + 3.5876 * rs + 1.6382 * rs * srs + 0.49294 * rs * rs);
  return -2.0 * kApw92 * (1.0 + 0.21370 * rs) * log_(1.0 + 1.0 / q);
}

inline Dual2 pbe_x(Dual2 rho, Dual2 sigma) {
  const double kappa = 0.804, mu = 0.2195149727645171;
  Dual2 kf = pow_(3.0 * kPi * kPi * rho, 1.0 / 3.0);
  Dual2 s = sqrt_(sigma) / (2.0 * kf * rho);
  Dual2 s2 = min_(s * s, 1e12);
  Dual2 F = 1.0 + kappa * (1.0 - 1.0 / (1.0 + (mu / kappa) * s2));
  return -kCx * pow_(rho, 1.0 / 3.0) * F;
}

inline Dual2 pbe_c(Dual2 rho, Dual2 sigma) {
  const double beta = 0.066725, gam = kApw92;
  Dual2 ec = pw92_c(rho);
  Dual2 kf = pow_(3.0 * kPi * kPi * rho, 1.0 / 3.0);
  Dual2 t = sqrt_(sigma * kPi) / (4.0 * sqrt_(kf) * rho);
  Dual2 t2 = min_(t * t, 1e20);
  Dual2 em = expm1_(-ec / gam);
  if (std::fabs(em.v) < 1e-20) em = c(em.v >= 0 ? 1e-20 : -1e-20);
  Dual2 A = min_((beta / gam) / em, 1e20);
  Dual2 at2 = A * t2;
  Dual2 Q = (1.0 + at2) / (1.0 + at2 + at2 * at2);
  Dual2 H = gam * log_(1.0 + (beta / gam) * t2 * Q);
  return ec + H;
}

const double kBetaB88 = 0.0042;

inline Dual2 b88_x_corr(Dual2 rho_s, Dual2 sigma_s) {
  Dual2 r43 = pow_(rho_s, 4.0 / 3.0);
  Dual2 x = sqrt_(sigma_s) / r43;
  Dual2 den = 1.0 + 6.0 * kBetaB88 * x * asinh_(x);
  return -kBetaB88 * x * x / den * pow_(rho_s, 1.0 / 3.0);
}

inline Dual2 lyp_c(Dual2 rho, Dual2 sigma) {
  const double A = 0.04918, B = 0.132, C0 = 0.2533, D = 0.349;
  const double CF = 2.87123400018819108;
  Dual2 rm13 = pow_(rho, -1.0 / 3.0);
  Dual2 rm53 = rm13 * rm13 * rm13 * rm13 * rm13;
  Dual2 dinv = 1.0 / (1.0 + D * rm13);
  Dual2 G = exp_(-C0 * rm13) * dinv;
  Dual2 delta = C0 * rm13 + D * rm13 * dinv;
  Dual2 H1 = -A * rho * dinv;
  Dual2 H2a = -A * B * CF * rho * G;
  Dual2 H2b = (A * B / 72.0) * sigma * rm53 * G * (3.0 + 7.0 * delta);
  return (H1 + H2a + H2b) / rho;
}

enum SolverKind { kLDA = 0, kGGA = 1, kB3LYP = 2 };

// f(rho, sigma) = rho * eps for each functional family
inline Dual2 f_xc(int kind, Dual2 rho, Dual2 sigma) {
  switch (kind) {
    case kLDA:
      return rho * (slater_x(rho) + vwn5_c(rho));
    case kGGA:
      return rho * (pbe_x(rho, sigma) + pbe_c(rho, sigma));
    default: {
      Dual2 eps = 0.80 * slater_x(rho) + 0.72 * b88_x_corr(0.5 * rho, 0.25 * sigma) +
                  0.19 * vwn_rpa_c(rho) + 0.81 * lyp_c(rho, sigma);
      return rho * eps;
    }
  }
}

struct HostSolver {
  int kind;
  double sigma_factor;  // of w vsigma grad-rho . grad-phi in B
};

}  // namespace

extern "C" {

HostSolver* DFT_CreateSolver(int type) {
  if (type < 0 || type > 2) return nullptr;
  return new HostSolver{type, 4.0};
}

// The factor of w vsigma grad-rho . grad-phi in B: 4 (the default) gives
// V_xc = dE_xc/dD, 2 the JAX package's V_xc.
void DFT_SetSigmaFactor(HostSolver* s, double factor) {
  if (s) s->sigma_factor = factor;
}

void DFT_DestroySolver(HostSolver* s) { delete s; }

// Same signature as the reference (ref src/dft_solver.h:77-83), pointers as
// uint64 -- here they are host addresses.
double DFT_ComputeXC(HostSolver* solver, int ngrid, int nao,
                     uint64_t dm_ptr, uint64_t ao_ptr, uint64_t ao_grad_ptr,
                     uint64_t w_ptr, uint64_t vxc_ptr) {
  if (!solver) return 0.0;
  const double* dm = reinterpret_cast<const double*>(dm_ptr);
  const double* ao = reinterpret_cast<const double*>(ao_ptr);
  const double* grad = reinterpret_cast<const double*>(ao_grad_ptr);
  const double* w = reinterpret_cast<const double*>(w_ptr);
  double* vxc = reinterpret_cast<double*>(vxc_ptr);
  const bool needs_grad = solver->kind != kLDA;
  const double* gx = grad;
  const double* gy = grad ? grad + (size_t)ngrid * nao : nullptr;
  const double* gz = grad ? grad + 2 * (size_t)ngrid * nao : nullptr;

  std::memset(vxc, 0, sizeof(double) * nao * nao);
  double exc = 0.0;

#ifdef _OPENMP
  int nthreads = omp_get_max_threads();
#else
  int nthreads = 1;
#endif
  std::vector<double> vloc((size_t)nthreads * nao * nao, 0.0);

#pragma omp parallel reduction(+ : exc)
  {
#ifdef _OPENMP
    double* vt = vloc.data() + (size_t)omp_get_thread_num() * nao * nao;
#else
    double* vt = vloc.data();
#endif
    std::vector<double> phi_d(nao), b_row(nao);

#pragma omp for schedule(static)
    for (int g = 0; g < ngrid; ++g) {
      const double* phi = ao + (size_t)g * nao;
      // phi_D = D phi ; rho = phi . phi_D
      double rho = 0.0;
      for (int i = 0; i < nao; ++i) {
        double acc = 0.0;
        const double* drow = dm + (size_t)i * nao;
        for (int j = 0; j < nao; ++j) acc += drow[j] * phi[j];
        phi_d[i] = acc;
        rho += acc * phi[i];
      }
      if (rho < kRhoEps) continue;

      double grx = 0.0, gry = 0.0, grz = 0.0, sig = 0.0;
      if (needs_grad) {
        const double* gxr = gx + (size_t)g * nao;
        const double* gyr = gy + (size_t)g * nao;
        const double* gzr = gz + (size_t)g * nao;
        for (int i = 0; i < nao; ++i) {
          grx += gxr[i] * phi_d[i];
          gry += gyr[i] * phi_d[i];
          grz += gzr[i] * phi_d[i];
        }
        grx *= 2.0; gry *= 2.0; grz *= 2.0;
        sig = grx * grx + gry * gry + grz * grz;
        if (sig < 1e-18) sig = 1e-18;
      }

      Dual2 f = f_xc(solver->kind, make_rho(rho), make_sigma(sig));
      double wg = w[g];
      exc += wg * f.v;
      double vrho = f.dr, vsig = f.ds;

      // accumulate V += phi (w vrho phi + c w vsig gdot)^T symmetric half
      if (needs_grad) {
        const double* gxr = gx + (size_t)g * nao;
        const double* gyr = gy + (size_t)g * nao;
        const double* gzr = gz + (size_t)g * nao;
        for (int i = 0; i < nao; ++i) {
          double gdot = grx * gxr[i] + gry * gyr[i] + grz * gzr[i];
          b_row[i] = wg * (vrho * phi[i] + solver->sigma_factor * vsig * gdot);
        }
      } else {
        for (int i = 0; i < nao; ++i) b_row[i] = wg * vrho * phi[i];
      }
      for (int i = 0; i < nao; ++i) {
        double pi_ = phi[i];
        double* vrow = vt + (size_t)i * nao;
        for (int j = 0; j < nao; ++j) vrow[j] += pi_ * b_row[j];
      }
    }
  }

  // combine thread-local halves and symmetrize: V = (Vh + Vh^T)/2
  for (int t = 0; t < nthreads; ++t) {
    const double* vt = vloc.data() + (size_t)t * nao * nao;
    for (size_t k = 0; k < (size_t)nao * nao; ++k) vxc[k] += vt[k];
  }
  for (int i = 0; i < nao; ++i)
    for (int j = 0; j < i; ++j) {
      double s = 0.5 * (vxc[(size_t)i * nao + j] + vxc[(size_t)j * nao + i]);
      vxc[(size_t)i * nao + j] = s;
      vxc[(size_t)j * nao + i] = s;
    }
  return exc;
}

// J = ERI_(nao^2 x nao^2) . vec(D)  (ref src/dft_solver.cu:550-555 semantics)
void DFT_ComputeCoulomb(HostSolver* solver, int nao, uint64_t eri_ptr,
                        uint64_t dm_ptr, uint64_t j_ptr) {
  if (!solver) return;
  const double* eri = reinterpret_cast<const double*>(eri_ptr);
  const double* dm = reinterpret_cast<const double*>(dm_ptr);
  double* out = reinterpret_cast<double*>(j_ptr);
  size_t n2 = (size_t)nao * nao;
#pragma omp parallel for schedule(static)
  for (long long r = 0; r < (long long)n2; ++r) {
    const double* row = eri + (size_t)r * n2;
    double acc = 0.0;
    for (size_t k = 0; k < n2; ++k) acc += row[k] * dm[k];
    out[r] = acc;
  }
}

}  // extern "C"
