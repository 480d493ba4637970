"""Exchange-correlation functional library (closed-shell / RKS) in torch.

Port of ``quantum_compute_dft_tpu/xc/functionals.py``: the same energy
densities f(rho, sigma) = rho * eps_xc(rho, sigma), the same constants and
the same floors, with the potentials

    vrho   = df/drho,      vsigma = df/dsigma

by automatic differentiation (``torch.func.grad_and_value`` mapped over
the grid with ``torch.func.vmap``, as the JAX package maps
``jax.value_and_grad``).  The JAX package composes atan/asinh/expm1 from
exp/log/sqrt because the TPU kernel compiler lacks them; here the plain
``torch.atan``/``torch.asinh``/``torch.expm1`` are used.

Every function takes float64 or float32 tensors; the clamps that keep f32
intermediates finite (``big`` in pbe_c, ``xmax`` in b88_x_corr) follow
the tensor's dtype exactly as in the JAX package, so the f32 plain
version of the fused XC kernel (engine/fused_xc.py) reuses them.

B3LYP mix (Gaussian convention, VWN-RPA):
  eps_xc = 0.80 eps_x^Slater + 0.72 eps_x^B88 + 0.19 eps_c^VWN-RPA
           + 0.81 eps_c^LYP
with B88 evaluated spin-resolved as b88(rho/2, sigma/4) and 20% exact
exchange applied in the SCF driver.
"""

from __future__ import annotations

import dataclasses
from math import pi, sqrt

import torch
from torch.func import grad_and_value, vmap

# Density/sigma floors of the JAX package (not the 1e-12/1e-20 of the
# original CUDA engine): the port is held to the JAX reference.
RHO_EPS = 1e-10
MIN_GRAD = 1e-18


def _is64(x: torch.Tensor) -> bool:
    return x.dtype == torch.float64


# ---------------------------------------------------------------------------
# LDA pieces: eps(rho)
# ---------------------------------------------------------------------------

_CX = 0.7385587663820224  # (3/4)(3/pi)^(1/3)


def slater_x(rho):
    return -_CX * rho ** (1.0 / 3.0)


def _vwn_eps(rho, A, b, c, x0):
    rs = (3.0 / (4.0 * pi * rho)) ** (1.0 / 3.0)
    x = torch.sqrt(rs)
    X = x * x + b * x + c
    Q = sqrt(4.0 * c - b * b)
    X0 = x0 * x0 + b * x0 + c
    atan_term = torch.atan(Q / (2.0 * x + b))
    return A * (
        torch.log(x * x / X)
        + 2.0 * b / Q * atan_term
        - b * x0 / X0
        * (torch.log((x - x0) ** 2 / X) + 2.0 * (2.0 * x0 + b) / Q * atan_term)
    )


def vwn5_c(rho):
    """VWN5 paramagnetic correlation (the reference LDA path)."""
    return _vwn_eps(rho, 0.0310907, 3.72744, 12.9352, -0.10498)


def vwn_rpa_c(rho):
    """VWN-RPA (a.k.a. VWN3) -- the Gaussian-convention B3LYP ingredient."""
    return _vwn_eps(rho, 0.0310907, 13.0720, 42.7198, -0.409286)


_A_PW92 = 0.03109069086965489503


def pw92_c(rho):
    rs = (3.0 / (4.0 * pi * rho)) ** (1.0 / 3.0)
    srs = torch.sqrt(rs)
    q = 2.0 * _A_PW92 * (
        7.5957 * srs + 3.5876 * rs + 1.6382 * rs * srs + 0.49294 * rs * rs
    )
    return -2.0 * _A_PW92 * (1.0 + 0.21370 * rs) * torch.log(1.0 + 1.0 / q)


# ---------------------------------------------------------------------------
# GGA pieces: eps(rho, sigma)
# ---------------------------------------------------------------------------


def pbe_x(rho, sigma):
    kappa, mu = 0.804, 0.2195149727645171
    kf = (3.0 * pi * pi * rho) ** (1.0 / 3.0)
    # s = |grad rho| / (2 kf rho), assembled as a single ratio
    s = torch.sqrt(sigma) / (2.0 * kf * rho)
    s2 = torch.clamp(s * s, max=1e12)
    F = 1.0 + kappa * (1.0 - 1.0 / (1.0 + mu * s2 / kappa))
    return -_CX * rho ** (1.0 / 3.0) * F


def pbe_c(rho, sigma):
    beta, gamma_ = 0.066725, _A_PW92
    # clamps: 1e20 in f64 (the reference's), 1e8 in f32 so A*t2 squared
    # stays finite -- H is saturated far below either bound
    big = 1e20 if _is64(rho) else 1e8
    ec_lda = pw92_c(rho)
    kf = (3.0 * pi * pi * rho) ** (1.0 / 3.0)
    t = torch.sqrt(sigma * pi) / (4.0 * torch.sqrt(kf) * rho)
    t2 = torch.clamp(t * t, max=big)
    expm1x = torch.expm1(-ec_lda / gamma_)
    tiny = 1.0 / big
    A = (beta / gamma_) / torch.where(
        torch.abs(expm1x) < tiny, torch.sign(expm1x) * tiny + tiny * 1e-8,
        expm1x)
    A = torch.clamp(A, max=big)
    at2 = A * t2
    Q = (1.0 + at2) / (1.0 + at2 + at2 * at2)
    H = gamma_ * torch.log(1.0 + (beta / gamma_) * t2 * Q)
    return ec_lda + H


_BETA_B88 = 0.0042


def b88_x_corr(rho_s, sigma_s):
    """B88 exchange *correction* per spin channel, eps per electron of the
    channel density rho_s (the Slater part is separate)."""
    rho43 = rho_s ** (4.0 / 3.0)
    # clamp the reduced gradient (x^2 overflows f32 past ~1e19)
    xmax = 1e15 if _is64(rho_s) else 1e8
    x = torch.clamp(torch.sqrt(sigma_s) / rho43, max=xmax)
    denom = 1.0 + 6.0 * _BETA_B88 * x * torch.asinh(x)
    return -_BETA_B88 * x * x / denom * rho_s ** (1.0 / 3.0)


def lyp_c(rho, sigma):
    A, B, C, D = 0.04918, 0.132, 0.2533, 0.349
    CF = 2.87123400018819108
    rm13 = rho ** (-1.0 / 3.0)
    rm53 = rm13 ** 5
    expv = torch.exp(-C * rm13)
    deninv = 1.0 / (1.0 + D * rm13)
    G = expv * deninv
    delta = C * rm13 + D * rm13 * deninv
    H1 = -A * rho * deninv
    H2a = -A * B * CF * rho * G
    H2b = (A * B / 72.0) * sigma * rm53 * G * (3.0 + 7.0 * delta)
    return (H1 + H2a + H2b) / rho


# ---------------------------------------------------------------------------
# Composed functionals with autodiff potentials
# ---------------------------------------------------------------------------


def value_and_potentials(f, needs_grad: bool, rho_s, sig_s=None):
    """(f, df/drho[, df/dsigma]) at already-floored inputs, elementwise."""
    if needs_grad:
        (vr, vs), e = vmap(grad_and_value(f, argnums=(0, 1)))(rho_s, sig_s)
        return e, vr, vs
    vr, e = vmap(grad_and_value(f))(rho_s)
    return e, vr, None


@dataclasses.dataclass(frozen=True)
class Functional:
    """A closed-shell XC functional: f(rho, sigma) -> energy density rho*eps.

    needs_grad: whether sigma (and AO gradients) are required.
    hyb_coeff:  fraction of exact exchange mixed in by the SCF driver.
    kind:       the functional's index in the CUDA kernel's switch
                (csrc/fused_xc.cu: 0 LDA, 1 PBE, 2 B3LYP, 3 zero).
    sigma_factor: the factor c of w vsigma grad-rho_k . grad-phi in the
                GGA potential's B.  With 4, V_xc = dE_xc/dD (the sigma
                term is 2 vsigma grad-rho . grad(phi_u phi_v)); with 2,
                V_xc is the JAX package's, half that term (jax_potential).
                Every XC implementation reads it from here.
    """

    name: str
    f: callable
    needs_grad: bool
    hyb_coeff: float = 0.0
    kind: int = 0
    sigma_factor: float = 4.0

    def jax_potential(self) -> "Functional":
        """This functional with the JAX package's V_xc (sigma_factor 2),
        for comparisons with it; name, kind, hyb_coeff and f unchanged."""
        return dataclasses.replace(self, sigma_factor=2.0)

    def exc_vxc(self, rho, sigma=None):
        """-> (e = rho*eps, vrho, vsigma) with the reference floors applied."""
        rho_s = torch.clamp(rho, min=RHO_EPS)
        live = rho > RHO_EPS
        zero = torch.zeros_like(rho)
        if self.needs_grad:
            sig_s = torch.clamp(sigma, min=MIN_GRAD)
            e, vr, vs = value_and_potentials(self.f, True, rho_s, sig_s)
            return (
                torch.where(live, e, zero),
                torch.where(live, vr, zero),
                torch.where(live & (sigma > MIN_GRAD), vs, zero),
            )
        e, vr, _ = value_and_potentials(self.f, False, rho_s)
        return torch.where(live, e, zero), torch.where(live, vr, zero), None


def _f_lda(rho):
    return rho * (slater_x(rho) + vwn5_c(rho))


def _f_pbe(rho, sigma):
    return rho * (pbe_x(rho, sigma) + pbe_c(rho, sigma))


def _f_b3lyp(rho, sigma):
    eps = (
        0.80 * slater_x(rho)
        + 0.72 * b88_x_corr(0.5 * rho, 0.25 * sigma)
        + 0.19 * vwn_rpa_c(rho)
        + 0.81 * lyp_c(rho, sigma)
    )
    return rho * eps


def _f_zero(rho):
    return 0.0 * rho


LDA = Functional("LDA", _f_lda, needs_grad=False, kind=0)
GGA = Functional("GGA", _f_pbe, needs_grad=True, kind=1)   # PBE
B3LYP = Functional("B3LYP", _f_b3lyp, needs_grad=True, hyb_coeff=0.2, kind=2)
# Hartree-Fock as the degenerate functional (100% exact exchange, no XC)
HF = Functional("HF", _f_zero, needs_grad=False, hyb_coeff=1.0, kind=3)

FUNCTIONALS = {"LDA": LDA, "GGA": GGA, "PBE": GGA, "B3LYP": B3LYP, "HF": HF}
