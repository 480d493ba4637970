"""Closed-shell exchange-correlation energy densities f(rho, sigma) =
rho * eps_xc, in plain torch, with the density floors the configurations
state (rho <= 1e-10 and sigma <= 1e-18 contribute nothing).

LDA: Slater exchange + VWN5.  PBE: PBE exchange + PBE correlation on PW92.
B3LYP (Gaussian convention): 0.80 Slater + 0.72 B88 + 0.19 VWN-RPA +
0.81 LYP, with 20% exact exchange added by the SCF.
"""

from __future__ import annotations

from math import pi, sqrt

import torch

RHO_EPS = 1e-10
SIGMA_EPS = 1e-18
_CX = 0.7385587663820224   # (3/4)(3/pi)^(1/3)
_A_PW92 = 0.03109069086965489503


def slater(rho):
    return -_CX * rho ** (1.0 / 3.0)


def _vwn(rho, A, b, c, x0):
    x = torch.sqrt((3.0 / (4.0 * pi * rho)) ** (1.0 / 3.0))
    X = x * x + b * x + c
    Q = sqrt(4.0 * c - b * b)
    X0 = x0 * x0 + b * x0 + c
    at = torch.atan(Q / (2.0 * x + b))
    return A * (torch.log(x * x / X) + 2.0 * b / Q * at
                - b * x0 / X0 * (torch.log((x - x0) ** 2 / X)
                                 + 2.0 * (2.0 * x0 + b) / Q * at))


def vwn5(rho):
    return _vwn(rho, 0.0310907, 3.72744, 12.9352, -0.10498)


def vwn_rpa(rho):
    return _vwn(rho, 0.0310907, 13.0720, 42.7198, -0.409286)


def pw92(rho):
    rs = (3.0 / (4.0 * pi * rho)) ** (1.0 / 3.0)
    srs = torch.sqrt(rs)
    q = 2.0 * _A_PW92 * (7.5957 * srs + 3.5876 * rs + 1.6382 * rs * srs
                         + 0.49294 * rs * rs)
    return -2.0 * _A_PW92 * (1.0 + 0.21370 * rs) * torch.log(1.0 + 1.0 / q)


def pbe_x(rho, sigma):
    kappa, mu = 0.804, 0.2195149727645171
    kf = (3.0 * pi * pi * rho) ** (1.0 / 3.0)
    s2 = torch.clamp(sigma / (2.0 * kf * rho) ** 2, max=1e12)
    return slater(rho) * (1.0 + kappa - kappa / (1.0 + mu * s2 / kappa))


def pbe_c(rho, sigma):
    beta, gamma = 0.066725, _A_PW92
    ec = pw92(rho)
    kf = (3.0 * pi * pi * rho) ** (1.0 / 3.0)
    t2 = torch.clamp(sigma * pi / (16.0 * kf * rho * rho), max=1e20)
    A = torch.clamp((beta / gamma) / torch.expm1(-ec / gamma), max=1e20)
    at2 = A * t2
    Q = (1.0 + at2) / (1.0 + at2 + at2 * at2)
    return ec + gamma * torch.log(1.0 + (beta / gamma) * t2 * Q)


def b88(rho_s, sigma_s):
    """B88's gradient correction per spin channel (eps per electron of the
    channel)."""
    beta = 0.0042
    x = torch.clamp(torch.sqrt(sigma_s) / rho_s ** (4.0 / 3.0), max=1e15)
    return -beta * x * x / (1.0 + 6.0 * beta * x * torch.asinh(x)) * (
        rho_s ** (1.0 / 3.0))


def lyp(rho, sigma):
    A, B, C, D = 0.04918, 0.132, 0.2533, 0.349
    CF = 2.87123400018819108
    rm13 = rho ** (-1.0 / 3.0)
    ex = torch.exp(-C * rm13)
    di = 1.0 / (1.0 + D * rm13)
    G = ex * di
    delta = C * rm13 + D * rm13 * di
    return (-A * rho * di - A * B * CF * rho * G
            + A * B / 72.0 * sigma * rm13 ** 5 * G * (3.0 + 7.0 * delta)) / rho


FUNCTIONALS = {
    "LDA": (lambda r, s: r * (slater(r) + vwn5(r)), False, 0.0),
    "GGA": (lambda r, s: r * (pbe_x(r, s) + pbe_c(r, s)), True, 0.0),
    "B3LYP": (lambda r, s: r * (0.80 * slater(r)
                                + 0.72 * b88(0.5 * r, 0.25 * s)
                                + 0.19 * vwn_rpa(r) + 0.81 * lyp(r, s)),
              True, 0.2),
}
FUNCTIONALS["PBE"] = FUNCTIONALS["GGA"]


def energy_density(name: str, rho, sigma):
    """Floored f(rho, sigma) per point; zero where rho <= RHO_EPS."""
    f, gga, _ = FUNCTIONALS[name]
    r = torch.clamp(rho, min=RHO_EPS)
    s = torch.clamp(sigma, min=SIGMA_EPS) if gga else None
    return torch.where(rho > RHO_EPS, f(r, s), torch.zeros_like(rho))
