// f32 XC functionals with forward-mode derivatives, for the fused XC kernel.
//
// The JAX package evaluates (e, vrho, vsigma) inside its Pallas kernel with
// jax.value_and_grad (engine/pallas_xc.py::_functional_eval).  CUDA has no
// autodiff, so the potentials come from a two-tangent dual number
// (value, d/drho, d/dsigma) -- the float counterpart of the Dual2 in the JAX
// package's native host engine (runtime/dft_host.cpp) -- over functionals
// written in the operation order of xc/functionals.py.
//
// f32 semantics of _functional_eval, kept exactly:
//   * rho floor 1e-10 and sigma floor 1e-18; every output is zeroed where
//     rho <= 1e-10, and vsigma is NOT masked by sigma > 1e-18 (unlike the
//     f64 Functional.exc_vxc);
//   * the f32 clamps: big = 1e8 (tiny = 1e-8) in pbe_c, xmax = 1e8 in
//     b88_x_corr; s^2 <= 1e12 in pbe_x;
//   * a clamped quantity is a constant (zero tangents), as the gradient of
//     jnp.minimum is zero on the clamped side.
// Accurate libm calls (powf, logf, expf, expm1f, asinhf, atanf): the file
// must not be built with --use_fast_math.
#pragma once

#include <math.h>

#ifndef XC_HD
#define XC_HD __host__ __device__ __forceinline__
#endif

namespace xc {

struct D2 {
  float v, r, s;  // value, d/drho, d/dsigma
};

XC_HD D2 cst(float x) { return {x, 0.f, 0.f}; }
XC_HD D2 operator+(D2 a, D2 b) { return {a.v + b.v, a.r + b.r, a.s + b.s}; }
XC_HD D2 operator-(D2 a, D2 b) { return {a.v - b.v, a.r - b.r, a.s - b.s}; }
XC_HD D2 operator-(D2 a) { return {-a.v, -a.r, -a.s}; }
XC_HD D2 operator*(D2 a, D2 b) {
  return {a.v * b.v, a.r * b.v + a.v * b.r, a.s * b.v + a.v * b.s};
}
XC_HD D2 operator/(D2 a, D2 b) {
  float q = a.v / b.v;
  return {q, (a.r - q * b.r) / b.v, (a.s - q * b.s) / b.v};
}
XC_HD D2 operator+(D2 a, float b) { return {a.v + b, a.r, a.s}; }
XC_HD D2 operator+(float a, D2 b) { return b + a; }
XC_HD D2 operator-(D2 a, float b) { return {a.v - b, a.r, a.s}; }
XC_HD D2 operator-(float a, D2 b) { return {a - b.v, -b.r, -b.s}; }
XC_HD D2 operator*(D2 a, float b) { return {a.v * b, a.r * b, a.s * b}; }
XC_HD D2 operator*(float a, D2 b) { return b * a; }
XC_HD D2 operator/(D2 a, float b) { return {a.v / b, a.r / b, a.s / b}; }
XC_HD D2 operator/(float a, D2 b) { return cst(a) / b; }

XC_HD D2 chain(float f, float fp, D2 x) { return {f, fp * x.r, fp * x.s}; }
XC_HD D2 pow_(D2 x, float p) {
  float f = powf(x.v, p);
  return chain(f, p * f / x.v, x);
}
XC_HD D2 sqrt_(D2 x) {
  float f = sqrtf(x.v);
  return chain(f, 0.5f / f, x);
}
XC_HD D2 log_(D2 x) { return chain(logf(x.v), 1.f / x.v, x); }
XC_HD D2 exp_(D2 x) {
  float f = expf(x.v);
  return chain(f, f, x);
}
XC_HD D2 expm1_(D2 x) { return chain(expm1f(x.v), expf(x.v), x); }
XC_HD D2 atan_(D2 x) { return chain(atanf(x.v), 1.f / (1.f + x.v * x.v), x); }
XC_HD D2 asinh_(D2 x) {
  return chain(asinhf(x.v), 1.f / sqrtf(1.f + x.v * x.v), x);
}
XC_HD D2 min_(D2 x, float cap) { return x.v <= cap ? x : cst(cap); }

// constants of xc/functionals.py, folded in double and rounded once, as
// the JAX package folds its Python-float constants
constexpr double kPi = 3.14159265358979323846;
constexpr float kCx = 0.7385587663820224f;
constexpr double kApw92 = 0.03109069086965489503;
constexpr float kThird = (float)(1.0 / 3.0);

XC_HD D2 slater_x(D2 rho) { return -kCx * pow_(rho, kThird); }

XC_HD D2 vwn_eps(D2 rho, double A, double b, double c, double x0) {
  D2 rs = pow_(cst((float)(3.0 / (4.0 * kPi))) / rho, kThird);
  D2 x = sqrt_(rs);
  D2 X = x * x + (float)b * x + (float)c;
  double Q = sqrt(4.0 * c - b * b);
  double X0 = x0 * x0 + b * x0 + c;
  D2 at = atan_(cst((float)Q) / (2.f * x + (float)b));
  D2 xm = x - (float)x0;
  return (float)A * (log_(x * x / X) + (float)(2.0 * b / Q) * at -
                     (float)(b * x0 / X0) *
                         (log_(xm * xm / X) + (float)(2.0 * (2.0 * x0 + b) / Q) * at));
}

XC_HD D2 vwn5_c(D2 rho) { return vwn_eps(rho, 0.0310907, 3.72744, 12.9352, -0.10498); }
XC_HD D2 vwn_rpa_c(D2 rho) { return vwn_eps(rho, 0.0310907, 13.0720, 42.7198, -0.409286); }

XC_HD D2 pw92_c(D2 rho) {
  D2 rs = pow_(cst((float)(3.0 / (4.0 * kPi))) / rho, kThird);
  D2 srs = sqrt_(rs);
  D2 q = (float)(2.0 * kApw92) *
         (7.5957f * srs + 3.5876f * rs + 1.6382f * rs * srs + 0.49294f * rs * rs);
  return (float)(-2.0 * kApw92) * (1.f + 0.21370f * rs) * log_(1.f + 1.f / q);
}

XC_HD D2 pbe_x(D2 rho, D2 sigma) {
  const float kappa = 0.804f, mu = 0.2195149727645171f;
  D2 kf = pow_((float)(3.0 * kPi * kPi) * rho, kThird);
  D2 s = sqrt_(sigma) / (2.f * kf * rho);
  D2 s2 = min_(s * s, 1e12f);
  D2 F = 1.f + kappa * (1.f - 1.f / (1.f + mu * s2 / kappa));
  return -kCx * pow_(rho, kThird) * F;
}

XC_HD D2 pbe_c(D2 rho, D2 sigma) {
  const float gam = (float)kApw92;
  const float bg = (float)(0.066725 / kApw92);  // beta / gamma
  const float big = 1e8f, tiny = 1e-8f;         // the f32 clamps of pbe_c
  D2 ec = pw92_c(rho);
  D2 kf = pow_((float)(3.0 * kPi * kPi) * rho, kThird);
  D2 t = sqrt_(sigma * (float)kPi) / (4.f * sqrt_(kf) * rho);
  D2 t2 = min_(t * t, big);
  D2 em = expm1_(-ec / gam);
  if (fabsf(em.v) < tiny) {
    float sg = em.v > 0.f ? 1.f : (em.v < 0.f ? -1.f : 0.f);
    em = cst(sg * tiny + tiny * 1e-8f);
  }
  D2 A = min_(bg / em, big);
  D2 at2 = A * t2;
  D2 Q = (1.f + at2) / (1.f + at2 + at2 * at2);
  D2 H = gam * log_(1.f + bg * t2 * Q);
  return ec + H;
}

XC_HD D2 b88_x_corr(D2 rho_s, D2 sigma_s) {
  const float beta = 0.0042f;
  D2 rho43 = pow_(rho_s, (float)(4.0 / 3.0));
  D2 x = min_(sqrt_(sigma_s) / rho43, 1e8f);  // f32 xmax
  D2 denom = 1.f + (float)(6.0 * 0.0042) * x * asinh_(x);
  return -beta * x * x / denom * pow_(rho_s, kThird);
}

XC_HD D2 lyp_c(D2 rho, D2 sigma) {
  const double A = 0.04918, B = 0.132, CF = 2.87123400018819108;
  const float C = 0.2533f, D = 0.349f;
  D2 rm13 = pow_(rho, (float)(-1.0 / 3.0));
  D2 rm53 = rm13 * rm13 * rm13 * rm13 * rm13;
  D2 expv = exp_(-C * rm13);
  D2 deninv = 1.f / (1.f + D * rm13);
  D2 G = expv * deninv;
  D2 delta = C * rm13 + D * rm13 * deninv;
  D2 H1 = (float)(-A) * rho * deninv;
  D2 H2a = (float)(-A * B * CF) * rho * G;
  D2 H2b = (float)(A * B / 72.0) * sigma * rm53 * G * (3.f + 7.f * delta);
  return (H1 + H2a + H2b) / rho;
}

// Functional kinds (engine/fused_xc.py passes Functional.kind):
// 0 LDA (Slater + VWN5), 1 PBE, 2 B3LYP, 3 zero (Hartree-Fock).
template <int KIND>
XC_HD D2 f_xc(D2 rho, D2 sigma) {
  if (KIND == 0) return rho * (slater_x(rho) + vwn5_c(rho));
  if (KIND == 1) return rho * (pbe_x(rho, sigma) + pbe_c(rho, sigma));
  if (KIND == 2) {
    D2 eps = 0.80f * slater_x(rho) + 0.72f * b88_x_corr(0.5f * rho, 0.25f * sigma) +
             0.19f * vwn_rpa_c(rho) + 0.81f * lyp_c(rho, sigma);
    return rho * eps;
  }
  return cst(0.f);
}

// (e, vrho, vsigma) at one grid point with the floors and masks of
// _functional_eval.
template <int KIND>
XC_HD void eval_point(float rho, float sigma, float* e, float* vr, float* vs) {
  const bool live = rho > 1e-10f;
  D2 r = {fmaxf(rho, 1e-10f), 1.f, 0.f};
  D2 s = {fmaxf(sigma, 1e-18f), 0.f, 1.f};
  D2 f = f_xc<KIND>(r, s);
  *e = live ? f.v : 0.f;
  *vr = live ? f.r : 0.f;
  *vs = live ? f.s : 0.f;
}

}  // namespace xc
