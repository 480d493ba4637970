"""High-level restricted Kohn-Sham API of the port.

Port of ``quantum_compute_dft_tpu/kohn_sham.py``: basis, one- and
two-electron integrals, grid and AO planes are built by this package
(torch f64 on the given device), then the SCF runs.  ERIs are in-core up
to AUTO_DF_NAO and density-fitted above it, by pivoted Cholesky or by an
RI auxiliary tier.  The one-electron integrals, the Cholesky factor, small
in-core ERIs and the grid go through the disk cache of setup_cache.py, at
the JAX package's four points.  The entry points run on the GPU unless the
caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from quantum_compute_dft_tpu_torch import setup_cache
from quantum_compute_dft_tpu_torch.basis import build_basis
from quantum_compute_dft_tpu_torch.basis.basis_set import sad_occupations
from quantum_compute_dft_tpu_torch.engine.ao_eval import (
    LAUNCHES as AO_LAUNCHES,
    eval_ao,
)
from quantum_compute_dft_tpu_torch.grids import Grid, build_grid
from quantum_compute_dft_tpu_torch.grids.becke import (
    LAUNCHES as BECKE_LAUNCHES,
)
from quantum_compute_dft_tpu_torch.integrals import eri_full, one_electron
from quantum_compute_dft_tpu_torch.integrals.cholesky import (
    cholesky_eri_vectors,
)
from quantum_compute_dft_tpu_torch.integrals.two_electron import LAUNCHES
from quantum_compute_dft_tpu_torch.integrals.density_fitting import (
    AUX_LEVELS,
    df_tensors,
    ri_factor,
    synced_time,
)
from quantum_compute_dft_tpu_torch.mol import Molecule
from quantum_compute_dft_tpu_torch.scf.driver import (
    SCFResult,
    SCFSystem,
    make_system,
    scf_host,
)
from quantum_compute_dft_tpu_torch.utils.profiling import span, spanned
from quantum_compute_dft_tpu_torch.xc.functionals import FUNCTIONALS, Functional

# in-core ERIs below/at this nao, density fitting above (see prepare)
AUTO_DF_NAO = 64
# the pivoted Cholesky's residual-diagonal threshold (df_aux='parity'):
# the JAX package's, and a decade tighter for a functional with exact
# exchange.  The factor's error enters the exchange energy once for every
# pair of occupied orbitals, and J's once: at 1e-7, B3LYP on riboflavin
# (nao 155) lands 2.7-3.5e-6 Eh from in-core ERIs, at 1e-8 3.4e-7.
CD_TOL = 1e-7
CD_TOL_EXACT_EXCHANGE = 1e-8
# in-core ERI tensors are cached up to this nao ((nao^4) * 8 B: 330 MB at 80)
CACHE_ERI_NAO = 80


@dataclasses.dataclass
class KSSetup:
    sys: SCFSystem
    functional: Functional
    nao: int
    ngrid: int
    nocc: int
    build_time: float
    grid: Grid | None = None
    # seconds of build_time spent in the Cholesky factorization (DF only;
    # 0 when the factor came from the setup cache)
    df_time: float = 0.0
    # the density-fitting factor: None (in-core ERIs), "parity" (Cholesky),
    # "tight"/"fast" (RI tiers) or "override" (_df_override)
    df_aux: str | None = None
    # seconds of build_time spent in the RI build (aux integrals, metric
    # eigh and the factor B), with its split: j3c_s, v2c_s, c2s_s (the
    # integral loops and the cart->sph transform), factor_s, and naux (the
    # metric directions kept)
    ri_time: float = 0.0
    ri_split: dict | None = None
    # seconds of build_time per phase (device work finished at each mark):
    # one_electron_s, two_electron_s (ERIs or the DF factor), grid_s, ao_s,
    # system_s (uploads, S^-1/2 and the factor's copies); inside them, the
    # setup cache's cache_load_s and cache_store_s (the store's copy to the
    # host included) and, when the Cholesky ran, its cholesky_card_s,
    # cholesky_host_s and cholesky_panels (integrals/cholesky.py); when the
    # Cholesky or the in-core ERIs ran, eri_kernel_launches (K4 launches,
    # integrals/two_electron.py: 0 on the CPU); ao_kernel_launches (K5
    # launches, engine/ao_eval.py: 1 on CUDA, 0 on the CPU);
    # becke_kernel_launches (K6 launches, grids/becke.py: 1 on CUDA when the
    # grid was built, 0 on the CPU or when it was loaded or given) and, when
    # the partition ran, becke_s (its seconds inside grid_s)
    setup_split: dict | None = None
    # the artifacts loaded from the setup cache instead of built: any of
    # "int1e", "cdvec" (the Cholesky factor), "eri", "grid"
    cache_hits: tuple = ()


def _device(device) -> torch.device:
    """The device to run on; the default, cuda, needs a GPU (the CPU runs
    only when asked for, as the CLI's --device cpu)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} (the default is 'cuda') needs a CUDA "
            "GPU; pass device='cpu' to run on the CPU")
    return dev


def _functional(functional: str | Functional) -> Functional:
    if isinstance(functional, Functional):
        return functional
    return FUNCTIONALS[functional.upper()]


@spanned("prepare")
def prepare(
    mol: Molecule,
    functional: str | Functional = "LDA",
    grid_level: int = 3,
    grid: Grid | None = None,
    prune: bool = True,
    density_fit: bool | None = None,
    df_aux: str = "parity",
    _df_override: tuple | None = None,
    device="cuda",
    cd_tol: float | None = None,
) -> KSSetup:
    """Basis, integrals, grid and AO planes on `device`.

    density_fit=None auto-selects: in-core ERIs up to nao AUTO_DF_NAO,
    density fitting above.  df_aux picks the factorization:
      'parity' (default): pivoted-Cholesky ERI vectors, tol CD_TOL (1e-7),
        or CD_TOL_EXACT_EXCHANGE (1e-8) when the functional has exact
        exchange (elementwise ERI error <= tol by construction); cd_tol
        replaces that choice, for comparisons with the JAX package, whose
        factor is CD_TOL's for every functional;
      'tight' / 'fast': the even-tempered RI auxiliary tiers
        (integrals/density_fitting.py): a cheaper build, with errors that
        grow with size (~1e-5 / 1e-4 Eh from the Cholesky energy at DHA,
        nao 152).
    _df_override=(j3c, v2c) supplies the factorization from outside, as the
    JAX package's hook: (L, None) a Cholesky factor (e.g. another
    tolerance's), (j3c, v2c) RI integrals and their metric; it implies
    density fitting.

    The setup cache (setup_cache.py) serves the one-electron integrals,
    the Cholesky factor (df_aux='parity', one per threshold, stored as its
    rows over the AO pairs i <= j and unpacked on `device`), in-core ERIs
    up to nao
    CACHE_ERI_NAO and the grid (when `grid` is not given); an override
    factor and the RI tiers are not cached, as in the JAX package.
    KSSetup.cache_hits names what was loaded, and df_time stays 0 when the
    factor was.

    Its stages are spans (utils/profiling.py): prepare.one_electron,
    prepare.two_electron, prepare.grid, prepare.ao and prepare.system,
    each ending at the device-synced mark of its setup_split entry."""
    device = _device(device)
    t0 = time.time()
    fn = _functional(functional)
    basis = build_basis(mol)
    ck = setup_cache.molecule_basis_key(mol, basis)
    hits = []
    extra = dict(cache_load_s=0.0, cache_store_s=0.0)

    def cached(kind, key, names, build):
        """Tensors on `device` from the cache, else from build() (stored)."""
        got = setup_cache.load(kind, key, names, into=extra)
        if got is not None:
            hits.append(kind)
            return [torch.as_tensor(a, device=device) for a in got]
        out = build()
        setup_cache.store(kind, key, into=extra, **dict(zip(names, out)))
        return out

    with span("prepare.one_electron"):
        s, t, v = cached("int1e", ck, ("s", "t", "v"), lambda: one_electron(
            basis, mol.coords, mol.charges, device=device))
        marks = [t0, synced_time(device)]
    if density_fit is None:
        density_fit = basis.nao > AUTO_DF_NAO
    eri = l_vec = None
    df_time = ri_time = 0.0
    ri_split = None
    with span("prepare.two_electron"):
        if _df_override is not None:
            df_aux = "override"
            j3c, v2c = (None if a is None else torch.as_tensor(
                a, dtype=torch.float64, device=device) for a in _df_override)
            l_vec = j3c if v2c is None else ri_factor(j3c, v2c)[0]
            j3c = v2c = None
        elif not density_fit:
            df_aux = None

            def incore():
                launches = LAUNCHES["K4"]
                out = eri_full(basis, device=device)
                extra["eri_kernel_launches"] = LAUNCHES["K4"] - launches
                return (out,)

            if basis.nao <= CACHE_ERI_NAO:
                (eri,) = cached("eri", ck, ("eri",), incore)
            else:
                (eri,) = incore()
        elif df_aux == "parity":
            t_df = time.time()
            tol = cd_tol or (CD_TOL if fn.hyb_coeff == 0.0
                             else CD_TOL_EXACT_EXCHANGE)
            iu, ju = (torch.as_tensor(a, device=device)
                      for a in np.triu_indices(basis.nao))

            def factor():
                nonlocal df_time, l_vec
                l_vec = cholesky_eri_vectors(basis, tol=tol, device=device,
                                             timings=extra)
                df_time = time.time() - t_df
                return (l_vec[iu, ju],)

            (l_tri,) = cached("cdvec", f"{ck}_tol{tol:g}", ("l_tri",),
                              factor)
            if l_vec is None:
                l_vec = l_tri.new_empty((basis.nao, basis.nao,
                                         l_tri.shape[1]))
                l_vec[iu, ju] = l_tri
                l_vec[ju, iu] = l_tri
            del l_tri
        elif df_aux in AUX_LEVELS:
            t_df = synced_time(device)
            ri_split = {}
            j3c, v2c = df_tensors(basis, mol, aux_level=df_aux, device=device,
                                  timings=ri_split)
            t_b = synced_time(device)
            l_vec, ri_split["naux"] = ri_factor(j3c, v2c)
            del j3c, v2c
            ri_split["factor_s"] = synced_time(device) - t_b
            ri_time = synced_time(device) - t_df
        else:
            raise ValueError(f"df_aux must be 'parity', 'tight' or 'fast', "
                             f"not {df_aux!r}")
        marks.append(synced_time(device))
    with span("prepare.grid"):
        launches = BECKE_LAUNCHES["K6"]
        if grid is None:
            gkey = f"{ck}_L{grid_level}_p{int(prune)}"
            got = setup_cache.load("grid", gkey,
                                   ("coords", "weights", "atom_idx"),
                                   into=extra)
            if got is not None:
                hits.append("grid")
                grid = Grid(*got)
            else:
                grid = build_grid(mol, level=grid_level, prune=prune,
                                  device=device, timings=extra)
                setup_cache.store("grid", gkey, into=extra,
                                  coords=grid.coords, weights=grid.weights,
                                  atom_idx=grid.atom_idx)
        extra["becke_kernel_launches"] = BECKE_LAUNCHES["K6"] - launches
        marks.append(synced_time(device))
    with span("prepare.ao"):
        launches = AO_LAUNCHES["K5"]
        if fn.needs_grad:
            ao, ao_grad = eval_ao(basis, grid.coords, deriv=1, device=device)
        else:
            ao = eval_ao(basis, grid.coords, deriv=0, device=device)
            ao_grad = None
        extra["ao_kernel_launches"] = AO_LAUNCHES["K5"] - launches
        marks.append(synced_time(device))
    with span("prepare.system"):
        sys = make_system(
            t + v, s, eri, ao, grid.weights, ao_grad, mol.energy_nuc(),
            mol.nocc, sad_occ=sad_occupations(basis, mol.charges, mol.nelec),
            nopen=mol.nopen, device=device, df_l=l_vec,
            build_k=fn.hyb_coeff != 0.0,
        )
        marks.append(synced_time(device))
    split = dict(zip(("one_electron_s", "two_electron_s", "grid_s", "ao_s",
                      "system_s"), np.diff(marks).tolist()))
    split.update(extra)
    return KSSetup(sys=sys, functional=fn, nao=basis.nao, ngrid=grid.ngrid,
                   nocc=mol.nocc, build_time=marks[-1] - t0, grid=grid,
                   df_time=df_time, df_aux=df_aux, ri_time=ri_time,
                   ri_split=ri_split, setup_split=split,
                   cache_hits=tuple(hits))


def setup_from_arrays(hcore, s, eri, ao, ao_grad, weights, e_nuc, nocc,
                      nopen, sad_occ, functional: str | Functional,
                      device="cuda", df_l=None) -> KSSetup:
    """A setup from precomputed numpy arrays (e.g. the JAX package's
    KSSetup arrays), so the SCF can be compared apart from the setup.
    With eri=None, df_l is the density-fitting factor (nao, nao, naux)."""
    device = _device(device)
    t0 = time.time()
    fn = _functional(functional)
    sys = make_system(hcore, s, eri, ao, weights,
                      ao_grad if fn.needs_grad else None, e_nuc, nocc,
                      sad_occ=sad_occ, nopen=nopen, device=device, df_l=df_l,
                      build_k=fn.hyb_coeff != 0.0)
    ao = np.asarray(ao)
    return KSSetup(sys=sys, functional=fn, nao=ao.shape[1],
                   ngrid=ao.shape[0], nocc=int(nocc),
                   build_time=time.time() - t0)


def run(
    mol: Molecule,
    functional: str | Functional = "LDA",
    grid_level: int = 3,
    callback=None,
    xc_impl: str = "f64",
    density_fit: bool | None = None,
    device="cuda",
    **kwargs,
) -> SCFResult:
    """prepare, then scf_host on the f64 schedule by default, as the JAX
    package's run; kwargs (smear_kt, mixer, max_cycle, ...) go to
    scf_host."""
    setup = prepare(mol, functional, grid_level=grid_level,
                    density_fit=density_fit, device=device)
    return scf_host(setup.sys, setup.functional, callback=callback,
                    xc_impl=xc_impl, **kwargs)
