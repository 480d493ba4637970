"""f64 XC engine: density on the grid, E_xc, and the V_xc matrix.

Port of ``quantum_compute_dft_tpu/engine/xc_engine.py`` (``_xc_block``,
``_xc_scan``, ``xc_step``, ``xc_energy``):

    rho_g   = sum_uv D_uv phi_u(g) phi_v(g)
    grad-rho, sigma for GGAs
    e_g     = rho_g * eps_xc(rho_g, sigma_g)
    E_xc    = sum_g w_g e_g
    B_gi    = w_g (vrho_g phi_i + c vsigma_g grad-rho . grad-phi_i)
    V_xc    = phi^T B, symmetrized

in float64 torch ops, chunked over the grid so the temporaries stay bounded.
c is ``functional.sigma_factor``: 4 by default, so that V_xc is dE_xc/dD,
its sigma term 2 vsigma grad-rho . grad(phi_u phi_v) as the reference's
CUDA engine forms it (dft_solver.cu:427-430).  The JAX package forms B
with 2 vsigma, half that term; ``functional.jax_potential()`` carries c =
2 and reproduces its V_xc, for comparisons with it.
This is the port of XLA code, not of a kernel: its products are
``torch.matmul``.  The per-cycle f32 XC build of the 'fast' schedule is
the hand-written CUDA kernel of engine/fused_xc.py.
"""

from __future__ import annotations

import torch

from quantum_compute_dft_tpu_torch.xc.functionals import Functional


def _xc_block(functional: Functional, dm, aot, wt, grt, want_v: bool = True):
    """(E_xc, V_half) contribution of one grid block -- TRANSPOSED
    (nao, g) layout.  want_v=False skips the B assembly and the V GEMM."""
    phi_d = dm @ aot                               # (nao, g)
    rho = torch.sum(phi_d * aot, dim=0)            # (g,)

    if functional.needs_grad:
        # grad rho_k = 2 sum_uv D_uv dphi_u/dk phi_v  (D symmetric)
        grad_rho = 2.0 * torch.einsum("kng,ng->kg", grt, phi_d)  # (3, g)
        sigma = torch.sum(grad_rho * grad_rho, dim=0)
        e, vrho, vsigma = functional.exc_vxc(rho, sigma)
        exc = wt @ e
        if not want_v:
            return exc, None
        gdot = torch.einsum("kg,kng->ng", grad_rho, grt)
        bt = wt[None, :] * (vrho[None, :] * aot
                            + functional.sigma_factor * vsigma[None, :] * gdot)
    else:
        e, vrho, _ = functional.exc_vxc(rho)
        exc = wt @ e
        if not want_v:
            return exc, None
        bt = (wt * vrho)[None, :] * aot
    return exc, aot @ bt.T


# grid points per chunk (one chunk up to 2 * _XC_CHUNK points).  The JAX
# package uses 32768 to fit a 16 GB TPU.  On the card each chunk costs a
# few hundred small kernel launches for the functional and its derivative,
# which pace the f64 cycles of a GGA on the host, while a chunk's
# temporaries are a few (nao, chunk) f64 planes, 0.69 GB each for a
# 553,156-point grid at nao 155.  So a grid of up to a million points is
# one chunk here.
_XC_CHUNK = 524288


def _xc_scan(functional: Functional, dm, ao, weights, ao_grad, want_v: bool):
    """Shared chunked driver for xc_step / xc_energy: (nao, g) layout,
    fixed-size grid chunks (one chunk up to 2 * _XC_CHUNK points)."""
    g = ao.shape[0]
    aot = ao.T
    grt = None if ao_grad is None else ao_grad.transpose(1, 2)
    c = g if g <= 2 * _XC_CHUNK else _XC_CHUNK
    exc = torch.zeros((), dtype=dm.dtype, device=dm.device)
    v_half = torch.zeros_like(dm) if want_v else None
    for s in range(0, g, c):
        e_b, v_b = _xc_block(
            functional, dm, aot[:, s:s + c], weights[s:s + c],
            grt[:, :, s:s + c] if functional.needs_grad else None,
            want_v=want_v,
        )
        exc = exc + e_b
        if want_v:
            v_half = v_half + v_b
    return exc, v_half


def xc_step(
    functional: Functional,
    dm: torch.Tensor,          # (nao, nao)
    ao: torch.Tensor,          # (ngrid, nao)
    weights: torch.Tensor,     # (ngrid,)
    ao_grad: torch.Tensor | None = None,   # (3, ngrid, nao) planar layout
):
    """-> (E_xc 0-dim tensor, V_xc (nao, nao) symmetric), float64; V_xc
    under the functional's sigma_factor."""
    exc, v_half = _xc_scan(functional, dm, ao, weights, ao_grad, want_v=True)
    return exc, 0.5 * (v_half + v_half.T)


def xc_energy(
    functional: Functional,
    dm: torch.Tensor,
    ao: torch.Tensor,
    weights: torch.Tensor,
    ao_grad: torch.Tensor | None = None,
):
    """E_xc only (no V_xc matrix): the final f64 energy evaluation."""
    exc, _ = _xc_scan(functional, dm, ao, weights, ao_grad, want_v=False)
    return exc
