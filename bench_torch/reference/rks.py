"""Plain restricted Kohn-Sham in torch float64: the reference energy.

    E[D] = tr(D h) + 1/2 tr(D J) - c/4 tr(D K) + E_xc[D] + E_nuc

with J and K from the pair-packed electron-repulsion matrix G[ab, cd]
(integrals.eri_packed; J = G d, K by blocks of rows unpacked on the
device), E_xc a quadrature on the grid, and the Kohn-Sham matrix F = dE/dD
(the XC part by autograd through the density and its gradient).  The SCF
starts from atomic occupations on the diagonal, mixes with Pulay's DIIS on
FDS - SDF, and stops when the energy moves by less than 1e-10 Eh and the
commutator's largest element is below 1e-7.  Imports nothing of the
program under test.
"""

from __future__ import annotations

import torch

from . import basis, grid, integrals, xc

# atomic occupations of the guess, per shell: (1s), (2s, 2p x3),
# (3s, 3p x3)
_OCC = {"H": ((1.0,),), "C": ((2.0,), (2.0, 2 / 3, 2 / 3, 2 / 3)),
        "N": ((2.0,), (2.0, 1.0, 1.0, 1.0)),
        "O": ((2.0,), (2.0, 4 / 3, 4 / 3, 4 / 3)),
        "P": ((2.0,), (2.0, 2.0, 2.0, 2.0), (2.0, 1.0, 1.0, 1.0)),
        "S": ((2.0,), (2.0, 2.0, 2.0, 2.0), (2.0, 4 / 3, 4 / 3, 4 / 3))}

# elements of a block of K's rows: G's rows (ij) and their (i, j, k, l)
K_BUDGET = 1 << 28


def ao_values(shells, coords, deriv: bool):
    """(phi (g, nao), grad (3, g, nao) | None) at the points."""
    cols, gcols = [], []
    for sh in shells:
        c = torch.as_tensor(sh.center, device=coords.device)
        a = torch.as_tensor(sh.alphas, device=coords.device)
        k = torch.as_tensor(sh.coeffs, device=coords.device)  # (3, ncomp)
        d = coords - c
        e = torch.exp(-(d * d).sum(1)[:, None] * a)            # (g, 3)
        rad = e @ k                                            # (g, ncomp)
        drad = (e * (-2.0 * a)) @ k                            # d/dr2 * 2
        cols.append(rad[:, :1])
        if deriv:
            gcols.append(d[:, :, None] * drad[:, None, :1])
        if sh.kind == "sp":
            cols.append(d * rad[:, 1:2])
            if deriv:
                g = d[:, :, None] * d[:, None, :] * drad[:, 1:2, None]
                g = g + torch.eye(3, dtype=d.dtype, device=d.device) * \
                    rad[:, 1:2, None]
                gcols.append(g)
    phi = torch.cat(cols, 1)
    if not deriv:
        return phi, None
    return phi, torch.cat(gcols, 2).permute(1, 0, 2)


class Reference:
    """The molecule's integrals and grid on `device`; energy(functional)
    runs the SCF."""

    def __init__(self, mol: basis.Mol, grid_level: int, device,
                 chunk: int = 1 << 16):
        self.mol, self.device, self.chunk = mol, device, chunk
        self._ao = {}
        self.shells = basis.shells(mol)
        n = self.nao = basis.nao(self.shells)
        classes = integrals.pair_classes(self.shells, device)
        s, t, v = integrals.one_electron(classes, n, mol.coords, mol.charges,
                                         device)
        self.s, self.h = s, t + v
        self.eri = integrals.eri_packed(classes, n, device)
        del classes
        # the pair index of each (a, b), and the pairs a >= b in packed order
        a = torch.arange(n, device=device)
        hi = torch.maximum(a[:, None], a[None])
        self.pair_of = hi * (hi + 1) // 2 + torch.minimum(a[:, None], a[None])
        self.tril = tuple(torch.tril_indices(n, n, device=device))
        # rows i of K a block: G's rows (ij) and their unpacked (i, j, k, l)
        npair = self.eri.shape[0]
        self.k_rows = max(1, K_BUDGET // (n * npair + n ** 3))
        self.coords, self.weights = grid.build(mol, grid_level, device)
        self.e_nuc = mol.energy_nuc()
        occ = []
        for sym in mol.symbols:
            for o in _OCC[sym]:
                occ.extend(o)
        self.dm0 = torch.diag(torch.tensor(occ, dtype=torch.float64,
                                           device=device))

    def jk(self, dm, exchange: bool):
        """(J, K | None) of the density: J = G d with d_ab = D_ab + D_ba
        (a > b) and d_aa = D_aa; K_ik = sum_jl (ij|kl) D_jl, a block of
        rows i at a time from G's rows (ij), unpacked over (k, l)."""
        n = self.nao
        d = (dm + dm.T - torch.diag(torch.diag(dm)))[self.tril]
        j = (self.eri @ d)[self.pair_of]
        if not exchange:
            return j, None
        k = torch.empty_like(dm)
        cols = self.pair_of.reshape(-1)
        for i in range(0, n, self.k_rows):
            rows = self.pair_of[i:i + self.k_rows].reshape(-1)
            slab = self.eri.index_select(0, rows).index_select(1, cols)
            k[i:i + self.k_rows] = torch.matmul(
                slab.view(-1, n, n, n), dm[:, :, None]).sum(1)[..., 0]
        return j, k

    def xc(self, name: str, dm):
        """(E_xc, V_xc = dE_xc/dD) on the grid, in chunks of points."""
        _, gga, _ = xc.FUNCTIONALS[name]
        d = dm.detach().clone().requires_grad_(True)
        e_tot, v = 0.0, torch.zeros_like(dm)
        for i in range(0, self.weights.shape[0], self.chunk):
            if (i, gga) not in self._ao:
                self._ao[(i, gga)] = ao_values(
                    self.shells, self.coords[i:i + self.chunk], gga)
            phi, dphi = self._ao[(i, gga)]
            ds = 0.5 * (d + d.T)
            pd = phi @ ds
            rho = (pd * phi).sum(1)
            sigma = None
            if gga:
                grad = 2.0 * (dphi * pd[None]).sum(2)
                sigma = (grad * grad).sum(0)
            e = (self.weights[i:i + self.chunk]
                 * xc.energy_density(name, rho, sigma)).sum()
            (gv,) = torch.autograd.grad(e, d)
            e_tot += float(e.detach())
            v += gv
        return e_tot, v

    def energy(self, name: str, max_cycle: int = 100, tol_e: float = 1e-10,
               tol_comm: float = 1e-7) -> float:
        """The converged total energy (Eh); raises when the SCF does not
        converge."""
        hyb = xc.FUNCTIONALS[name][2]
        nocc = self.mol.nocc
        w, u = torch.linalg.eigh(self.s)
        x = u @ torch.diag(w.rsqrt()) @ u.T
        dm, e_old = self.dm0, None
        focks, errs = [], []
        for _ in range(max_cycle):
            j, k = self.jk(dm, hyb != 0.0)
            exc, vxc = self.xc(name, dm)
            ek = 0.0 if k is None else float((dm * k).sum())
            e = (float((dm * self.h).sum()) + 0.5 * float((dm * j).sum())
                 - 0.25 * hyb * ek + exc + self.e_nuc)
            f = self.h + j + vxc if k is None else \
                self.h + j - 0.5 * hyb * k + vxc
            err = x.T @ (f @ dm @ self.s - self.s @ dm @ f) @ x
            comm = float(err.abs().max())
            done = e_old is not None and abs(e - e_old) < tol_e
            if done and comm < tol_comm:
                self.last_dm = dm        # the converged density
                return e
            e_old = e
            focks.append(f)
            errs.append(err)
            focks, errs = focks[-8:], errs[-8:]
            m = len(focks)
            b = torch.zeros(m + 1, m + 1, dtype=torch.float64,
                            device=self.device)
            for a in range(m):
                for c in range(m):
                    b[a, c] = (errs[a] * errs[c]).sum()
            b[m, :m] = b[:m, m] = -1.0
            rhs = torch.zeros(m + 1, dtype=torch.float64, device=self.device)
            rhs[m] = -1.0
            coef = torch.linalg.lstsq(b, rhs[:, None]).solution[:m, 0]
            f = sum(cf * fk for cf, fk in zip(coef, focks))
            _, c_mo = torch.linalg.eigh(x.T @ f @ x)
            c_occ = (x @ c_mo)[:, :nocc]
            dm = 2.0 * c_occ @ c_occ.T
        raise RuntimeError(f"reference SCF ({name}) did not converge in "
                           f"{max_cycle} cycles")
