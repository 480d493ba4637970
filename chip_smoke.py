"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its result and seconds on its own line; any failure
raises and the script exits non-zero without the final line):

  1. environment: nvidia-smi name/power limit, device, torch/scipy/nvcc
  2. build the fused XC kernels (K1 GGA body, K2 LDA body, K3 and the K1
     variants) from csrc/
     b. K4, the ERI quartet kernel (csrc/eri_quartet.cu), against its plain
        version (the eager tiles of integrals/two_electron.py) on the card:
        DHA's diagonal (all 11,628 pairs), its first pivot panel (the 128
        largest diagonals of the pairs that survive the Cholesky's
        screening at 1e-7) and a ragged pivot set (77 pivots), Benzene's
        whole in-core W and the Se atom's (d shells, L = 4); each within
        K4_TOL of the largest |W|, one launch a call by the counter, with
        torch.cuda.synchronize() after each; K4 and plain ms (median of 25
        calls, CUDA events) beside the bound: K4's f64 operations
        (two_electron.k4_flops, times 81 primitive quartets a quartet) at
        67 TFLOP/s, with the 34 TFLOP/s vector rate beside it
     c. K5, the AO-plane kernel (csrc/ao_eval.cu), against its plain
        version (engine/ao_eval.eval_ao_reference, the eager chunks) on the
        card: DHA and Vitamin-B2 at grid 3 with deriv 0 and 1, and the north
        star's grid-1 points (C33H56N7O17P3S, 540,054 points, nao 377) with
        deriv 1; each plane within K5_TOL of its largest magnitude, one
        launch a call, with torch.cuda.synchronize() after it; K5 (on the
        packed table and coordinates on the card), the whole eval_ao call
        (packing and the coordinates' upload included) and plain ms (median
        of 25 calls, CUDA events) beside the bound: the planes' f64 bytes,
        written once, at 3.35 TB/s
  3. each kernel against its plain PyTorch version and the f64 engine on
     H2O (grid 1) and benzene (grid 3) for LDA/GGA/B3LYP, and above npad
     64 at the density-fitting shapes: Decane's first 65 AOs (npad 72,
     ragged), Decane and DHA (npad 72, 152; grid 3) and the first 65,536
     grid-1 points of C17H31O6N5S (npad 184) and of C33H56N7O17P3S (npad
     384, and its first 197 AOs: npad 200, ragged; 184 and 200 end on a
     half k16 step of the streaming rho kernel's bf16 mode), K1 (B3LYP)
     and K2 (LDA);
     bitwise equal results from two calls (deterministic reductions),
     finiteness of the device functional over extreme (rho, sigma), kernel
     and plain times of K1 and K2 at benzene, Decane, DHA and npad 384
     (median of 25 calls, CUDA events) beside each one's bound; the rho, V
     and reduce kernels of K1 and of K2 timed apart at DHA from one
     torch.profiler trace each; the two products alone as full-f32
     torch.matmul at DHA, for context
     c. K3 (phi_D as the 3-pass bf16 split in K1's and K2's rho kernels),
        GGA and LDA bodies, and phi3 (K3's GGA body), at every shape of
        3a/3b: against the plain K3 (relative dE 1e-5, max dV 5e-5) and the
        f64 engine (3e-4 and 3e-3, the JAX package's K3 contract), bitwise
        equal over two calls, with no more device memory than K1's or K2's
        call on the same planes (no phi_D or B^T plane); times at benzene
        and DHA, and the kernel split at DHA (torch.profiler)
     d. the ablations nophi (K1's kernels with no phi_D product: the rho
        kernel reads no density) and nov (K1's rho kernel and E sum, no V
        kernel) at every GGA shape of 3a/3b: against their plain versions
        (relative dE 1e-5, max dV 5e-5 of max(1, max |V|)), bitwise equal
        over two calls, with no more device memory than K1's call; nov's V
        exactly zero and its E K1's bit for bit; times at benzene and DHA,
        the kernel split at DHA (torch.profiler), and K1's time at DHA
        attributed: V = K1 - nov, the phi_D product (with D's staging) =
        K1's rho kernel - nophi's
     e. K1base (K1 on the four-kernel pipeline, the base of noprod and
        nofunc), the K1 ablations on that pipeline (noprod, nofunc) and the
        split2 row sums at benzene (PBE) and DHA (B3LYP), split2 also in
        the LDA body,
        against their own plain versions (relative dE 1e-5; max dV 1e-5 for
        K1base and split2, of max(1, max |V|) 5e-5 for the ablations, whose
        V reaches 1e10 (nofunc), and 2e-3 for noprod, see TOL_NOPROD_V);
        times
  4. the main paths, each with the kernels' launch counts set to 0 just
     before it and read just after, through the port's CLI in process with
     --xc-impl fast at grid level 3:
     a. in-core: GGA benzene, LDA H2O and B3LYP H2Se against the reference
        energies;
     b. density fitting (auto above nao 64): B3LYP Decane and DHA against
        docs/RESULTS.md, and LDA Decane against the port's own
        --xc-impl f64 run of the same molecule
     c. FON-RKS and the annealing ladder: B3LYP CuO on the CLI's defaults
        (the fast integer-occupation attempt fails, the ladder runs on the
        f64 loop) within 1e-7 Eh of its golden row at the row's kT 0.2 (when
        the ladder stops at another kT, the golden tool's recheck, rungs
        down to 0.2 on damped mixing, is held to the row instead);
        GGA (K1) and LDA (K2) CaCO3 at --smear-kt 0.2, fast against f64
        within 1e-7 Eh, each kernel launched at least once per CaCO3
        kernel-phase cycle
     d. the RI auxiliary tiers: B3LYP Decane with --df-aux tight and
        --df-aux fast through the CLI, each within 1e-7 Eh of the JAX
        package's CPU energy for the same tier and grid
        (docs/ri_reference_cpu.json, tools/ri_reference.py); the card's
        RI tensors against the CPU's (H2O 'tight', H2Se 'fast') within
        1e-11 of their largest magnitude; DHA B3LYP on the 'fast' tier, one
        kohn_sham.prepare for both scf_host schedules, fast within 1e-7 Eh
        of f64, and on the 'tight' tier (fast schedule), each with its RI
        build seconds and peak device memory beside 4b's Cholesky seconds
        and its distance from the Cholesky row's energy (the tier's error,
        printed, not bounded); K1 launched at least once per kernel-phase
        cycle of these runs; and a checkpoint round trip:
        H2O LDA through the CLI with --checkpoint twice (f64 schedule), the
        second run resuming from the first's density in no more cycles,
        within 1e-8 Eh
     e. the north star, C33H56N7O17P3S B3LYP at grid level 1 (nao 377,
        540,054 points) on a pivoted-Cholesky factor at tol 1e-5 handed to
        kohn_sham.prepare(_df_override=...) by tools/torch_northstar.py's
        setup and scf, the f64 schedule, within 1e-6 Eh of the JAX
        package's v5e energy (its rank and grid size printed beside the JAX
        package's); then K1 and its plain version timed at its converged
        density on the whole grid (npad 384), after it is held against its
        plain version and the f64 engine there.  The fast schedule's kernel
        phase stalls there (tools/torch_northstar.py, PERF.md): it is not
        run here
     f. the CLI entry points ported last, through the CLI in process:
        (a) Benzene/PBE on its native grid written to a 6-column file at
        full precision and read back with --grid-file, within 1e-10 Eh of
        the native-grid run; (b) the setup cache: Decane/B3LYP cold then
        warm in one fresh cache directory (the warm prepare loads the
        Cholesky factor and the grid; energies within 1e-12 Eh), and DHA
        cold (kohn_sham.prepare) then warm (its --jit-loop run in (d)), the
        setup seconds printed; (c) --validate native on H2O/B3LYP and
        Benzene/PBE, each with --xc-impl f64 and the default fast: the C++
        host engine's energy within 1e-8 Eh of the f64 schedule's energy at
        its density (tests/test_runtime.py's bar) and 1e-7 Eh of the fast
        schedule's (the golden bar); (d) --jit-loop (scf_jit, CUDA graphs)
        on H2O/B3LYP in-core and DHA/B3LYP density-fitted, converged and
        within 1e-9 Eh of scf_host(xc_impl="f64") on the same setup, and the
        SCF wall and device-busy share (torch.profiler) of one scf_jit and
        one scf_host f64 run each at Benzene/PBE and DHA/B3LYP, beside
        scf_jit's wall with a block of 1 cycle between host reads; (e)
        --xc-impl pallas on Benzene/PBE, converged and within
        5e-5 |E_xc| of the f64 energy (the kernel's contract).  Every phase
        before this one runs with the setup cache off (DFT_SETUP_CACHE=0),
        so its setup seconds are cold builds
     g. the sharded SCF (parallel/) through tools/torch_northstar_mesh.py's
        ranks, one process each: (a) two gloo ranks sharing card 0: H2O/B3LYP
        in-core, the sharded XC and J/K against xc_step and the single-device
        J/K within 1e-11; Decane/B3LYP on a Cholesky factor (rank 0 builds
        it, rank 1 loads it), 5 cycles beside scf_iteration within the JAX
        parity rule (|dE| <= 1e-8, max|dD| <= 1e-7), then the sharded loop
        to |dE| < 1e-8 and ||dD|| < 1e-9 within 5e-9 Eh of
        scf_host(xc_impl="f64", conv_tol_d=1e-9) on rank 0's setup; (b) NCCL
        at world torch.cuda.device_count(), one card a rank: DHA/B3LYP
        density-fitted, converged the same way within 5e-9 Eh of scf_host
        f64 and 1e-6 Eh of docs/RESULTS.md, each loop's synced wall per
        cycle printed.  After the last step every rank's density equals rank
        0's bit for bit.  The sharded path runs the f64 engine, as the JAX
        package's does: the ranks' K1/K2 launches are printed (0 expected)
     h. the basis generators and the tools: atomic_energy (atomic HF,
        basis/atomic_scf.py) on the card for O, Cu, Se and I within
        ATOMIC_TOL of the JAX package's CPU values
        (docs/atomic_reference_cpu.json, tools/atomic_reference.py), with
        seconds per call; optimize_zetas for O and for Cu (4sp frozen)
        within ZETA_RTOL of the same file's zetas, each trial energy and
        trial zeta of its path (tools/optimizer_trace.py) within
        ATOMIC_TOL and ZETA_RTOL of the CPU run's (else the first
        evaluation at which they part is printed and the phase fails),
        O also within 1.5% of the published 7.66 / 2.25;
        tools/torch_oracle_diffs.py's rows H2O/B3LYP, H2Se/B3LYP
        (in-core) and Benzene/B3LYP (Cholesky DF) on the fast schedule
        against the C++ engine, and its DHA grid-1 fixed-density E_xc/V_xc
        through the f64 engine and K1; two rows of the 57-molecule sweep
        at full size through tools/torch_run_all_molecules.run_one,
        Lysergide (nao 145) and Hexachlorobenzene (nao 84) B3LYP grid 3,
        within SWEEP_TOL of docs/results_58_r5.json; K1 launched at least
        once (its tools_launches)
     i. the sweep rescue protocol: tools/torch_rescue_ladder.py's
        rescue_system on ABAQ/B3LYP (grid 3, density-fitted) from SAD with
        the protocol docs/rescue_h100.json records, converged to the full
        rule at its kT (0.015) within 1e-7 Eh of that file's energy and
        1e-6 Eh (the DF parity bar) of the JAX package's record
        (docs/results_58.json); seconds and cycles printed.  The kT check
        pins the record's protocol, not a physical outcome: from the kT
        0.015 density both packages' CDIIS integer finish converges to a
        state below the record, and the protocol's mix+cdiis finish fails
        in both (docs/rescue_h100.json "integer_finish")
  5. the variant sweep (tools/torch_xc_sweep.py, in process) at DHA grid 3
     with the launch counts set to 0 just before it: one JSON line per
     variant, one launch of each variant's kernel per kernel call it made,
     each E within 1e-5 of its plain version; K3, phi3, nophi and nov read
     against K1 (the rows on its kernels)
  6. one B3LYP job on Vitamin-B2 (nao 155, the pivoted Cholesky, grid 3)
     through cli.run as the benchmark's vitb2.sto3g.grid3.cd runs it, within
     the configuration's 3e-6 Eh of the plain reference (bench_torch/
     reference), with torch.cuda.synchronize() after each; its K builds:
     the f32 aux-major K in each kernel-phase cycle, the f64 K in each
     verify cycle and the final energy

Phase 4 holds the port to the JAX package's recorded energies, which carry
its GGA potential (half the sigma term of dE_xc/dD): its SCFs run on the
functional's jax_potential() copy (cli.run: half_sigma=True, JAX_CLI).
Phases 3 and 6 run the default, so phase 3
holds K1 to its plain version and to the f64 engine at V_xc = dE_xc/dD.

The last three lines are the kernels' JSON record (every kernel with its
launches on its path, its largest deviation from its plain version, its
time, the plain version's, its bound and what sets it, and library_ms:
null, since no one PyTorch call computes a fused XC body, a quartet
block or the AO planes; K4's and K5's launches are 4a's and 4b's), the
card's name and power limit, and {"ok": true, "device": {...}}.  Imports
nothing of JAX; needs a CUDA GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS = os.path.join(HERE, "tools")

# relative |dE| and max |dV|: kernel vs its plain f32 version (both f32,
# other summation order), and kernel vs the f64 engine (the Pallas
# kernel's contract, tests/test_pallas.py)
TOL_PLAIN = 1e-5
TOL_F64 = 5e-5
# K3 (3-pass bf16 phi_D): max dV against its plain version, and (relative
# dE, max dV) against the f64 engine (tests/test_pallas.py's K3 contract)
TOL_K3_PLAIN_V = 5e-5
TOL_K3_F64 = 3e-4, 3e-3
# the ablations' max dV against their plain versions, of max(1, max |V|).
# noprod's rho = sum phi_D cancels to near zero at some points, where the
# B3LYP potentials amplify the f32 rounding of that sum: 6.3e-4 of max |V|
# at DHA grid 3 (E agrees to 7e-8); scaling D by 1 + 1e-7 xi moves noprod's
# V by 3.5e-4 of max |V| there, K1's by 1.5e-7
TOL_ABLATE_V = 5e-5
TOL_NOPROD_V = 2e-3
# K4 against its plain version (both f64; other summation order, products
# with reciprocals and one rsqrt in place of divisions), of max |W|
K4_TOL = 1e-12
# the card's f64 peaks (NVIDIA's H100 SXM data sheet): tensor-core FMA and
# the vector units
F64_PEAK, F64_VECTOR = 67e12, 34e12
# K5 against its plain version (both f64; the order of the term sums and
# the exp's last bits differ), of the largest |ao| (and of the largest
# |grad|); K5's bound, the bytes of its planes at the card's HBM rate
# (NVIDIA's H100 SXM data sheet)
K5_TOL = 1e-13
HBM_BYTES_S = 3.35e12
# phase 2c's shapes: (molecule, grid level, derivs)
AO_SHAPES = (("DHA", 3, (0, 1)), ("Vitamin-B2", 3, (0, 1)),
             ("C33H56N7O17P3S", 1, (1,)))
# K6 against its plain version (both f64; the order of the products and
# 1/R_ij against the division differ), absolute per weight (weights lie in
# [0, 1]); its bound: K6_PAIR_OPS f64 instructions an ordered atom pair
# (2 for mu, 2 for nu, 9 for the polynomial, 1 for s, 1 for the product) at
# the vector rate, F64_VECTOR / 2 instructions a second (an FMA counts 2)
K6_TOL = 1e-12
K6_PAIR_OPS = 15
# phase 2d's shapes: (molecule, grid level)
BECKE_SHAPES = (("DHA", 3), ("Vitamin-B2", 3), ("C33H56N7O17P3S", 1))
# phase 4 holds the port to the JAX package's recorded energies (BENCH,
# docs/RESULTS.md, the golden rows, the RI references, the north star, the
# sweep, the rescue record), whose GGA potential has half the sigma term of
# dE_xc/dD: every SCF there runs on the functional's jax_potential() copy
# (scf_host, scf_jit), and cli.run with the keyword that selects it;
# phases 3 and 6 run the default.  Its Cholesky factor is at 1e-7 for
# every functional (the port takes 1e-8 under exact exchange): a prepare
# or job compared with it passes CD_TOL
CD_TOL = 1e-7
JAX_CLI = dict(half_sigma=True, cd_tol=CD_TOL)
BENZENE_E = -229.10950264    # BENCH_r05.json, Benzene PBE grid 3
BENZENE_TOL = 1e-6
# docs/RESULTS.md:61, 68 (B3LYP grid 3, density-fitted).  The reference
# rows come from another Cholesky factorization: the DF parity bar of
# tests/test_density_fitting.py
DECANE_E = -389.66540042
DHA_E = -995.41205421
DF_TOL = 1e-6
FAST_VS_F64_TOL = 1e-7       # tests/test_torch_scf.py
# phase 4d: the RI tiers against the JAX package's CPU energies, and the
# checkpoint round trip (tests/test_aux.py's resume bar)
RI_REF = os.path.join(HERE, "docs", "ri_reference_cpu.json")
RI_TOL = 1e-7
RESUME_TOL = 1e-8
# the card's j3c and v2c against the same built on the CPU, of their
# largest magnitude (tests/test_torch_ri.py's bar against the JAX package)
RI_CPU_TOL = 1e-11
# (molecule, tier) of that check: g aux functions on O, and the Hermite sum
# to 8 (d shells on Se with g aux functions)
RI_CPU_CHECK = (("H2O", "tight"), ("H2Se", "fast"))
# phase 4e: the north star within 1e-6 Eh of the JAX package's L1 run on
# one v5e (tools/torch_northstar.py holds its molecule, energy, grid size
# and factor rank)
NORTHSTAR_TOL = 1e-6
GOLDEN_TOL = 1e-7            # tests/golden_energies.json's tolerance
# phase 4f: --grid-file against the native grid (the same points, written
# at full precision); the setup cache's warm run against its cold one;
# --validate native against the f64 schedule at its density
# (tests/test_runtime.py's stationary-energy bar) and the fast schedule
# (GOLDEN_TOL); scf_jit against scf_host f64 (tests/test_scf.py's bar); the
# pallas schedule against f64, of |E_xc| (the kernel's contract, TOL_F64)
GRID_FILE_TOL = 1e-10
CACHE_TOL = 1e-12
NATIVE_F64_TOL = 1e-8
JIT_TOL = 1e-9
# phase 4g: the sharded loop (to ||dD|| < 1e-9) against scf_host f64 on the
# same setup (tests/test_parallel.py:121-136); the builders' bar is the
# tool's BUILDERS_TOL
MESH_LOOP_TOL = 5e-9
MESH_D_TOL = 1e-9
# phase 4h: atomic energies on the card against the JAX package's CPU
# values, the optimized zetas (relative), the O zetas against the
# published 1s 7.66 / 2sp 2.25 (basis/zeta_optimized.py), and the sweep
# rows against docs/results_58_r5.json (tools/compare_sweeps.py's parity)
ATOMIC_REF = os.path.join(HERE, "docs", "atomic_reference_cpu.json")
ATOMIC_TOL = 1e-9
ZETA_RTOL = 1e-8
O_PUBLISHED = {"1s": 7.66, "2sp": 2.25}
O_PUBLISHED_RTOL = 0.015
SWEEP_REF = os.path.join(HERE, "docs", "results_58_r5.json")
SWEEP_TOL = 2e-6
SWEEP_ROWS = ("Lysergide", "Hexachlorobenzene")
# phase 4i: the rescue protocol of docs/rescue_h100.json on ABAQ/B3LYP
# (grid 3, density-fitted) against that file's own energy, and against the
# JAX package's record (docs/results_58.json) at the DF parity bar
RESCUE_REF = os.path.join(HERE, "docs", "rescue_h100.json")
RESCUE_TOL = 1e-7
# phase 4c's electronic temperature (Eh): that of the golden table's six
# smeared rows (tools/gen_golden.py's ladder)
FON_KT = 0.2
# phase 3's density-fitting shapes: (molecule, grid level, first points),
# and the molecules also checked on their first AOs (ragged npad 72 and
# 200; npad 184 and 200 take the streaming rho kernel's last half k16 step)
DF_SHAPES = (("Decane", 3, None), ("DHA", 3, None),
             ("C17H31O6N5S", 1, 65536), ("C33H56N7O17P3S", 1, 65536))
DF_SUB_AOS = {"Decane": 65, "C33H56N7O17P3S": 197}
KERNEL_SRC = "quantum_compute_dft_tpu_torch/csrc/fused_xc.cu"
K4_SRC = "quantum_compute_dft_tpu_torch/csrc/eri_quartet.cu"
K5_SRC = "quantum_compute_dft_tpu_torch/csrc/ao_eval.cu"
K6_SRC = "quantum_compute_dft_tpu_torch/csrc/becke.cu"
# the eager chunks K6 replaces, the port of the JAX package's partition
# (which XLA compiles: no Pallas kernel)
K6_REPLACES = ("quantum_compute_dft_tpu_torch/grids/becke.py::becke_weights"
               " (quantum_compute_dft_tpu/grids/becke.py::becke_weights)")
# the eager chunks K5 replaces, the port of the JAX package's AO evaluation
# (which XLA compiles: no Pallas kernel)
K5_REPLACES = ("quantum_compute_dft_tpu_torch/engine/ao_eval.py::_eval_chunk"
               " (quantum_compute_dft_tpu/engine/ao_eval.py::_eval_chunk)")
# the eager tile K4 replaces, the port of the JAX package's quartet stage
# (which XLA compiles: no Pallas kernel)
K4_REPLACES = ("quantum_compute_dft_tpu_torch/integrals/two_electron.py::"
               "_quartet_kernel (quantum_compute_dft_tpu/integrals/"
               "two_electron.py::_block_runner)")
_PX = "quantum_compute_dft_tpu/engine/pallas_xc.py:"
REPLACES = {
    "K1": _PX + "201", "K2": _PX + "269", "K1base": _PX + "201",
    "K3": _PX + "157",
    "nophi": _PX + "219", "phi3": _PX + "221", "noprod": _PX + "227",
    "nofunc": _PX + "243", "nov": _PX + "262", "split2": _PX + "187",
}
KERNEL_NAMES = {
    "K1": "K1 fused_xc GGA body", "K2": "K2 fused_xc LDA body",
    "K1base": "K1base fused_xc GGA body on the four-kernel pipeline",
    "K3": "K3 fused_xc phi_D as the 3-pass bf16 split (both bodies)",
    "nophi": "K1 ablation nophi (K1's kernels, no phi_D product)",
    "phi3": "K1 ablation phi3 (K3's GGA body)",
    "noprod": "K1 ablation noprod", "nofunc": "K1 ablation nofunc",
    "nov": "K1 ablation nov (K1's rho kernel and reduce, no V kernel)",
    "split2": "fused_xc split2 row sums",
}


def _phase(name, t0, msg):
    print(f"[phase {name}] {msg} ({time.time() - t0:.2f} s)", flush=True)


def phase_env():
    t0 = time.time()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    import scipy

    from quantum_compute_dft_tpu_torch.engine import fused_xc

    nvcc = subprocess.run([fused_xc._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(smi.splitlines()[0])
    print(f"device: {torch.cuda.get_device_name(0)}  count: "
          f"{torch.cuda.device_count()}  torch {torch.__version__} (cuda "
          f"{torch.version.cuda})  scipy {scipy.__version__}  nvcc: {nvcc}")
    _phase("1 environment", t0, "ok")
    return smi.splitlines()[0]


def phase_build():
    t0 = time.time()
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    path = fused_xc.build()
    fused_xc._lib()
    _phase("2 build", t0, f"built {os.path.relpath(path, HERE)}")


def _k4_case(label, fn, plain, nquartet, l_pair, reps):
    """One K4 case: one launch, synchronized, against its plain version;
    -> its record (error, ms, plain ms, bound ms)."""
    import torch
    import torch_kernel_timing as kt

    from quantum_compute_dft_tpu_torch.integrals import two_electron

    before = two_electron.LAUNCHES["K4"]
    out = fn()
    torch.cuda.synchronize()  # a fault shows at the kernel that made it
    launches = two_electron.LAUNCHES["K4"] - before
    ref = plain()
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    if launches != 1 or out.shape != ref.shape or not err <= K4_TOL * scale:
        raise AssertionError(f"K4 {label}: {launches} launches, max |diff| "
                             f"{err:.3e} of max |W| {scale:.3e}")
    ms = kt.cuda_ms(fn, reps=reps)
    plain_ms = kt.cuda_ms(plain, reps=reps, warm=1)
    flops = nquartet * 81 * two_electron.k4_flops(l_pair)
    bound = flops / F64_PEAK * 1e3
    r = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
         "vector_bound_ms": flops / F64_VECTOR * 1e3, "max_abs_err": err,
         "max_abs_w": scale, "quartets": nquartet, "flops": flops}
    print(f"  K4 {label} (L={l_pair}, {nquartet} quartets, {flops:.3e} f64 "
          f"ops): max |diff| {err:.2e} of max |W| {scale:.3e}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of {reps}), bound "
          f"{bound:.4f} ms at 67 TFLOP/s ({100 * bound / ms:.1f}%), "
          f"{r['vector_bound_ms']:.4f} ms at 34", flush=True)
    return r


def phase_k4(dev, reps=25):
    """2b: K4 against its plain version at DHA, Benzene and the Se atom;
    -> {case: record}."""
    t0 = time.time()
    import warnings

    import numpy as np

    from quantum_compute_dft_tpu_torch.basis import build_basis
    from quantum_compute_dft_tpu_torch.integrals import two_electron as te
    from quantum_compute_dft_tpu_torch.mol import Molecule, from_xyz_file

    def pairs_of(mol):
        with warnings.catch_warnings():  # Se's tables are 'optimized'
            warnings.simplefilter("ignore", RuntimeWarning)
            basis = build_basis(mol)
        lp = 2 * int(basis.cart_powers.max())
        iu, _, *hermite = te.pair_data(basis, dev)
        return te.quartet_pairs(*hermite, lp), np.arange(len(iu)), lp

    def mol_file(name):
        return from_xyz_file(os.path.join(HERE, "molecules", name + ".xyz"))

    out = {}
    pairs, rows, lp = pairs_of(mol_file("DHA"))
    out["dha_diagonal"] = _k4_case(
        "DHA diagonal", lambda: te.eri_diagonal(pairs, rows, 128),
        lambda: te.eri_diagonal_reference(pairs, rows, 128), len(rows), lp,
        reps)
    # the Cholesky's screening (tol 1e-7) and its first pivot panel
    d = te.eri_diagonal(pairs, rows, 128).cpu().numpy()
    sel = np.nonzero(d > 1e-14 / d.max())[0]
    piv = sel[np.argsort(-d[sel])[:128]]
    ragged = np.random.default_rng(15).choice(sel, 77, replace=False)
    for key, cols in (("dha_panel", piv), ("dha_ragged", ragged)):
        out[key] = _k4_case(
            f"DHA {key[4:]} ({len(sel)} x {len(cols)})",
            lambda c=cols: te.eri_columns(pairs, sel, c, 128),
            lambda c=cols: te.eri_columns_reference(pairs, sel, c, 128),
            len(sel) * len(cols), lp, reps)
    del pairs
    for key, mol, block in (
            ("benzene_w", mol_file("Benzene"), 64),
            ("se_w", Molecule(symbols=("Se",), coords=np.zeros((1, 3))), 16)):
        pairs, rows, lp = pairs_of(mol)
        d = te.eri_diagonal(pairs, rows, block).cpu().numpy()
        sel = np.nonzero(d * d.max() > 1e-24)[0]  # eri_packed's screening
        n = len(sel)
        out[key] = _k4_case(
            f"{key.split('_')[0]} W ({n} pairs)",
            lambda p=pairs, s=sel, b=block: te.eri_matrix(p, s, b),
            lambda p=pairs, s=sel, b=block: te.eri_matrix_reference(p, s, b),
            n * (n + 1) // 2, lp, reps)
    _phase("2b K4", t0, f"K4 within {K4_TOL:g} of max |W| at L = 2 (DHA "
           "diagonal, first panel and ragged pivots; Benzene W) and L = 4 "
           "(Se W), one launch a call")
    return out


def phase_ao(dev, reps=25):
    """2c: K5 against its plain version at AO_SHAPES; -> {case: record}."""
    t0 = time.time()
    import torch
    import torch_kernel_timing as kt

    from quantum_compute_dft_tpu_torch.basis import build_basis
    from quantum_compute_dft_tpu_torch.engine import ao_eval
    from quantum_compute_dft_tpu_torch.grids import build_grid
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file

    out = {}
    for name, level, derivs in AO_SHAPES:
        mol = from_xyz_file(os.path.join(HERE, "molecules", name + ".xyz"))
        basis = build_basis(mol)
        coords = build_grid(mol, level=level, device=dev).coords
        ngrid, nao = coords.shape[0], basis.nao
        tab = ao_eval.pack_table(basis, dev)
        crd = torch.as_tensor(coords, device=dev)
        for deriv in derivs:
            def kernel(d=deriv):
                return ao_eval._k5(tab, crd, d)

            def whole(d=deriv):
                return ao_eval.eval_ao(basis, coords, d, device=dev)

            def plain(d=deriv):
                return ao_eval.eval_ao_reference(basis, coords, d,
                                                 device=dev)

            before = ao_eval.LAUNCHES["K5"]
            got = whole()
            torch.cuda.synchronize()  # a fault shows at the kernel
            launches = ao_eval.LAUNCHES["K5"] - before
            ref = plain()
            torch.cuda.synchronize()
            pairs = list(zip(got, ref)) if deriv else [(got, ref)]
            errs = [float((a - b).abs().max()) / float(b.abs().max())
                    for a, b in pairs]
            ok = all(a.shape == b.shape and a.is_contiguous()
                     for a, b in pairs)
            del got, ref, pairs
            label = f"{name} grid {level} deriv {deriv} ({ngrid} x {nao})"
            if launches != 1 or not ok or not max(errs) <= K5_TOL:
                raise AssertionError(f"K5 {label}: {launches} launches, "
                                     f"relative max |diff| {errs}")
            ms = kt.cuda_ms(kernel, reps=reps)
            whole_ms = kt.cuda_ms(whole, reps=reps)
            plain_ms = kt.cuda_ms(plain, reps=reps, warm=1)
            nbytes = ngrid * nao * 8 * (4 if deriv else 1)
            bound = nbytes / HBM_BYTES_S * 1e3
            out[f"{name}_L{level}_d{deriv}"] = {
                "ms": ms, "whole_ms": whole_ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bytes": nbytes, "ngrid": ngrid,
                "nao": nao, "max_rel_err": max(errs)}
            print(f"  K5 {label}: max |diff| {max(errs):.2e} of the largest "
                  f"value; kernel {ms:.4f} ms, eval_ao {whole_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms (median of {reps}), bound "
                  f"{bound:.4f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s, "
                  f"{100 * bound / ms:.1f}%)", flush=True)
            torch.cuda.empty_cache()
    _phase("2c K5", t0, f"K5 within {K5_TOL:g} of the largest value of "
           "each plane at every shape, one launch a call")
    return out


def phase_becke(dev, reps=25):
    """2d: K6 against its plain version at BECKE_SHAPES; -> {case:
    record}."""
    t0 = time.time()
    import numpy as np
    import torch
    import torch_kernel_timing as kt

    from quantum_compute_dft_tpu_torch.grids import becke, build_grid
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file

    out = {}
    for name, level in BECKE_SHAPES:
        mol = from_xyz_file(os.path.join(HERE, "molecules", name + ".xyz"))
        grid = build_grid(mol, level=level, device=dev)
        args = (grid.coords, mol.coords, grid.atom_idx, mol.bragg_radii())
        natm, ngrid = mol.natm, grid.ngrid
        crd = torch.as_tensor(grid.coords, device=dev)
        own = torch.as_tensor(grid.atom_idx, dtype=torch.int32, device=dev)
        xyz = torch.as_tensor(mol.coords, device=dev)
        tab = becke.k6_tables(xyz, torch.as_tensor(mol.bragg_radii(),
                                                   device=dev))

        def kernel():
            return becke._k6(crd, own, xyz, tab)

        def whole():
            return becke.becke_partition(*args, device=dev)

        def plain():
            return becke.becke_weights_chunked(*args, device=dev)

        before = becke.LAUNCHES["K6"]
        got = whole()
        launches = becke.LAUNCHES["K6"] - before
        ref = plain()
        err = float(np.abs(got - ref).max())
        label = f"{name} grid {level} ({ngrid} points, {natm} atoms)"
        if launches != 1 or got.shape != ref.shape or not err <= K6_TOL:
            raise AssertionError(f"K6 {label}: {launches} launches, max "
                                 f"|diff| {err:.3e}")
        ms = kt.cuda_ms(kernel, reps=reps)
        whole_ms = kt.cuda_ms(whole, reps=reps)
        plain_ms = kt.cuda_ms(plain, reps=reps, warm=1)
        pairs = ngrid * natm * (natm - 1)
        bound = pairs * K6_PAIR_OPS / (F64_VECTOR / 2) * 1e3
        out[f"{name}_L{level}"] = {
            "ms": ms, "whole_ms": whole_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "pairs": pairs, "pair_ops": K6_PAIR_OPS,
            "ngrid": ngrid, "natm": natm, "max_abs_err": err}
        print(f"  K6 {label}: max |diff| {err:.2e}; kernel {ms:.4f} ms, "
              f"becke_partition {whole_ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(median of {reps}), bound {bound:.4f} ms ({pairs:.4e} "
              f"ordered pairs x {K6_PAIR_OPS} f64 instructions at "
              f"{F64_VECTOR / 2:.3g}/s, {100 * bound / ms:.1f}%)",
              flush=True)
        del crd, own, got, ref
        torch.cuda.empty_cache()
    _phase("2d K6", t0, f"K6 within {K6_TOL:g} of the plain weights at "
           "every shape, one launch a call")
    return out


def _compare(label, kid, case, rec, variant=None, tol_plain=(TOL_PLAIN,
             TOL_PLAIN), tol_f64=(TOL_F64, TOL_F64), v_scaled=False):
    """One kernel call of `variant` against its plain version (and, with
    tol_f64, the f64 engine), and two calls bitwise equal; records the
    worst plain deviation under `kid`.  v_scaled: the plain max dV bound
    is taken of max(1, max |V|).  -> the kernel's V."""
    import numpy as np
    import torch

    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step

    variant = variant or {}
    fn, dm, aot, wt, grads, n, ao64, w64, grad64 = case[1:]
    e_k, v_k = fused_xc.fused_xc(fn, dm, aot, wt, grads, n, **variant)
    e_k2, v_k2 = fused_xc.fused_xc(fn, dm, aot, wt, grads, n, **variant)
    if not (torch.equal(e_k, e_k2) and torch.equal(v_k, v_k2)):
        raise AssertionError(f"{kid} {label}: two kernel calls differ "
                             "(reductions must be deterministic)")
    e_p, v_p = fused_xc.fused_xc_reference(fn, dm, aot, wt, grads, n,
                                           **variant)
    torch.cuda.synchronize()
    e_k, e_p = float(e_k), float(e_p)
    dv_p = float(torch.abs(v_k - v_p).max())
    de_p = abs(e_k - e_p) / abs(e_p)
    tol_v = tol_plain[1]
    if v_scaled:
        tol_v *= max(1.0, float(v_p.abs().max()))
    msg = (f"  {kid} {label} nao={n} npad={aot.shape[0]} points="
           f"{ao64.shape[0]}: rel dE plain {de_p:.2e}")
    ok = (np.isfinite([e_k, dv_p]).all() and bool(torch.isfinite(v_k).all())
          and de_p < tol_plain[0] and dv_p < tol_v)
    if tol_f64 is not None:
        e_64, v_64 = xc_step(fn, dm, ao64, w64, grad64)
        e_64 = float(e_64)
        dv_64 = float(torch.abs(v_k - v_64).max())
        de_64 = abs(e_k - e_64) / abs(e_64)
        msg += f" f64 {de_64:.2e}; max dV plain {dv_p:.2e} f64 {dv_64:.2e}"
        ok = ok and np.isfinite(dv_64) and de_64 < tol_f64[0] and \
            dv_64 < tol_f64[1]
    else:
        msg += f"; max dV plain {dv_p:.2e} (max |V| {float(v_p.abs().max()):.3e})"
    print(msg, flush=True)
    if not ok:
        raise AssertionError(f"{kid} {label} outside tolerance")
    rec[kid]["max_abs_err"] = max(rec[kid]["max_abs_err"], dv_p)
    return v_k


def _time(kid, label, case, rec, key, variant=None):
    """Kernel and plain ms (median of 25, CUDA events) beside the bound
    (tools/torch_kernel_timing.py: on the nao AOs and the grid's points of
    this case), recorded under key + ms, plain_ms, bound_ms, bound_by."""
    import torch_kernel_timing as kt

    from quantum_compute_dft_tpu_torch.engine import fused_xc

    variant = variant or {}
    args = case[1:7]
    ms = kt.cuda_ms(lambda: fused_xc.fused_xc(*args, **variant))
    plain = kt.cuda_ms(lambda: fused_xc.fused_xc_reference(*args, **variant))
    bound, by, t_b, t_o, t_fp32 = kt.xc_bound(kid, case[1].needs_grad,
                                              case[6], case[7].shape[0])
    rec[kid].update({key + "ms": ms, key + "plain_ms": plain,
                     key + "bound_ms": bound, key + "bound_by": by})
    print(f"  {kid} {label} time: kernel {ms:.4f} ms, plain {plain:.4f} ms "
          f"(median of 25), bound {bound:.4f} ms ({by}; bytes {t_b:.4f}, "
          f"tensor-core ops {t_o:.4f}{' (phi_D at the bf16 rate)' if kid in kt.BF16_PHI else ''}, "
          f"FP32 ops {t_fp32:.4f})", flush=True)


# phase 3b's timed shapes of K1 and K2 -> their record key prefix
DF_TIMED = {"Decane grid 3": "decane_", "DHA grid 3": "dha_",
            "C33H56N7O17P3S grid 1 first 65536 points": "npad384_"}


def _profile(kid, case, rec, calls=10, variant=None, key="dha_split_ms"):
    """A fused XC call's kernels (K1's or K2's, or a variant's) timed apart
    from one torch.profiler trace of `calls` calls: device ms per call of
    each kernel, printed and recorded under `key`."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from quantum_compute_dft_tpu_torch.engine import fused_xc

    args = case[1:7]
    variant = variant or {}
    for _ in range(3):
        fused_xc.fused_xc(*args, **variant)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fused_xc.fused_xc(*args, **variant)
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        m = re.search(r"(xc_rho\w*|xc_\w+_v_kernel|xc_reduce_kernel|"
                      r"xc_split_dm_kernel|xc_pad_dm_kernel)", ev.key)
        dev_us = getattr(ev, "device_time_total", 0) or getattr(
            ev, "cuda_time_total", 0)
        if m and dev_us:
            split[m.group(1)] = dev_us / 1e3 / calls
    if not split:
        raise AssertionError(f"{kid} profile: the trace shows no device time")
    rec[kid][key] = split
    print(f"  {kid} {case[0]} kernel split (torch.profiler, device ms per call, "
          f"{calls} calls): " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in split.items()),
          flush=True)


def _products_matmul(case, rec):
    """For context: K1's two products alone as full-f32 torch.matmul
    (phi_D = D AO, and V's AO B^T at its shapes) on this case's planes."""
    import torch_kernel_timing as kt

    from quantum_compute_dft_tpu_torch.engine import fused_xc

    dm, aot = case[2], case[3]
    dm_p = fused_xc._pad_dm(dm, aot.shape[0])
    with fused_xc._full_f32_matmul():
        ms = kt.cuda_ms(lambda: (dm_p @ aot, aot @ aot.T))
    rec["K1"]["dha_products_matmul_ms"] = ms
    print(f"  K1 {case[0]}: the two products alone as full-f32 torch.matmul "
          f"{ms:.4f} ms (median of 25)", flush=True)


def _df_shapes(dev):
    """The density-fitting-size planes: (label, dm, ao, w, grad) f64 on the
    card with a seeded perturbed SAD density."""
    import numpy as np
    import torch

    from quantum_compute_dft_tpu_torch.basis import build_basis
    from quantum_compute_dft_tpu_torch.basis.basis_set import sad_occupations
    from quantum_compute_dft_tpu_torch.engine.ao_eval import eval_ao
    from quantum_compute_dft_tpu_torch.grids import build_grid
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file

    rng = np.random.default_rng(23)
    for name, level, npts in DF_SHAPES:
        mol = from_xyz_file(os.path.join(HERE, "molecules", name + ".xyz"))
        basis = build_basis(mol)
        grid = build_grid(mol, level=level, device=dev)
        coords, w = grid.coords[:npts], grid.weights[:npts]
        ao, grad = eval_ao(basis, coords, deriv=1, device=dev)
        n = basis.nao
        pert = rng.standard_normal((n, n)) * 1e-2
        dm = torch.tensor(np.diag(sad_occupations(basis, mol.charges,
                                                  mol.nelec)) + pert + pert.T,
                          device=dev)
        w = torch.tensor(w, device=dev)
        label = f"{name} grid {level}" + (f" first {npts} points" if npts
                                          else "")
        if name in DF_SUB_AOS:
            k = DF_SUB_AOS[name]
            yield (f"{name} first {k} AOs grid {level}"
                   + (f" first {npts} points" if npts else ""), dm[:k, :k],
                   ao[:, :k].contiguous(), w, grad[:, :, :k].contiguous())
        yield label, dm, ao, w, grad


def phase_kernels(dev):
    """Kernel vs plain vs f64 engine; returns per-kernel records and the
    checked cases (label, functional, dm, packed planes, n, f64 planes),
    which phases 3c, 3d and 3e reuse."""
    t0 = time.time()
    import numpy as np
    import torch

    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf.driver import initial_guess
    from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS

    rec = {k: {"max_abs_err": 0.0} for k in REPLACES}
    cases = []
    rng = np.random.default_rng(7)
    for mol_name, level in (("H2O", 1), ("Benzene", 3)):
        mol = from_xyz_file(os.path.join(HERE, "molecules", mol_name + ".xyz"))
        for fname in ("LDA", "GGA", "B3LYP"):
            setup = kohn_sham.prepare(mol, fname, grid_level=level, device=dev)
            s, fn = setup.sys, setup.functional
            n = setup.nao
            pert = rng.standard_normal((n, n)) * 1e-2
            dm = initial_guess(s) + torch.as_tensor(pert + pert.T, device=dev)
            aot, wt, grads = fused_xc.pack_inputs(s.ao, s.weights, s.ao_grad,
                                                  needs_grad=fn.needs_grad)
            kid = "K1" if fn.needs_grad else "K2"
            case = (f"{mol_name}/{fname}", fn, dm, aot, wt, grads, n, s.ao,
                    s.weights, s.ao_grad)
            _compare(case[0], kid, case, rec)
            if mol_name == "Benzene" and fname in ("LDA", "GGA"):
                _time(kid, f"benzene {fname}", case, rec, "")
            cases.append(case)
    _phase("3a kernels, in-core shapes", t0, "K1/K2 match the plain "
           "version and the f64 engine")

    t1 = time.time()
    for label, dm, ao, w, grad in _df_shapes(dev):
        n = dm.shape[0]
        for kid, fname in (("K1", "B3LYP"), ("K2", "LDA")):
            fn = FUNCTIONALS[fname]
            g = grad if fn.needs_grad else None
            aot, wt, grads = fused_xc.pack_inputs(ao, w, g,
                                                  needs_grad=fn.needs_grad)
            case = (f"{label}/{fname}", fn, dm, aot, wt, grads, n, ao, w, g)
            _compare(case[0], kid, case, rec)
            if label in DF_TIMED:
                _time(kid, f"{label} {fname}", case, rec, DF_TIMED[label])
            if label.startswith("DHA"):
                _profile(kid, case, rec)
                if kid == "K1":
                    _products_matmul(case, rec)
            cases.append(case)
    _phase("3b kernels, density-fitting shapes", t1, "K1/K2 match the plain "
           "version and the f64 engine at npad 72, 152, 184, 200 and 384")

    # the device functional over the extreme (rho, sigma) mesh of
    # tests/test_pallas.py must stay finite
    r = np.concatenate([[0.0], 10.0 ** np.linspace(-12, 4, 40)])
    sg = np.concatenate([[0.0], 10.0 ** np.linspace(-20, 8, 40)])
    R, S = np.meshgrid(r, sg)
    rho = torch.tensor(R.ravel(), dtype=torch.float32, device=dev)
    sig = torch.tensor(S.ravel(), dtype=torch.float32, device=dev)
    for fname in ("LDA", "GGA", "B3LYP"):
        outs = fused_xc.functional_eval(FUNCTIONALS[fname], rho, sig)
        for a in outs:
            if a is not None and not bool(torch.isfinite(a).all()):
                raise AssertionError(f"non-finite {fname} functional on the "
                                     "extreme (rho, sigma) mesh")
    _phase("3 kernels", t0, "K1/K2 match the plain version and the f64 "
           "engine; functional finite over the extreme mesh")
    return rec, cases


# the cases timed in 3c-3e -> their record key prefix ("" benzene GGA body)
TIMED = {"Benzene/GGA": "", "Benzene/LDA": "lda_", "DHA grid 3/B3LYP": "dha_",
         "DHA grid 3/LDA": "dha_lda_"}


def _extra_bytes(case, variant):
    """Device memory one kernel call allocates beyond what was live."""
    import torch

    from quantum_compute_dft_tpu_torch.engine import fused_xc

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_xc.fused_xc(*case[1:7], **variant)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_k3(cases, rec):
    """K3 (GGA and LDA bodies) and phi3 (GGA) at every phase-3 shape: the
    bf16 mode of K1's and K2's kernels, held to the plain K3 and the f64
    engine, with no more device memory than K1's or K2's call (no phi_D or
    B^T plane); times at benzene and DHA, and the kernel split at DHA."""
    from quantum_compute_dft_tpu_torch.engine.fused_xc import VARIANTS

    t0 = time.time()
    for case in cases:
        kids = ("K3", "phi3") if case[1].needs_grad else ("K3",)
        for kid in kids:
            variant = VARIANTS[kid]
            _compare(case[0], kid, case, rec, variant,
                     (TOL_PLAIN, TOL_K3_PLAIN_V), TOL_K3_F64)
            extra, base = _extra_bytes(case, variant), _extra_bytes(case, {})
            if extra > base:
                raise AssertionError(f"{kid} {case[0]}: {extra} bytes "
                                     f"allocated, K1/K2 {base}")
            if case[0] in TIMED:
                _time(kid, case[0], case, rec, TIMED[case[0]], variant)
            if case[0].startswith("DHA grid 3/"):
                _profile(kid, case, rec, variant=variant,
                         key=TIMED[case[0]] + "split_ms")
    _phase("3c K3 and phi3", t0, "K3 (GGA and LDA bodies) and phi3 match "
           "the plain K3 and the f64 engine at every phase-3 shape, with "
           "K1's or K2's memory")


def _rho_ms(split):
    """The rho kernel's ms in a _profile split."""
    return sum(v for k, v in split.items() if k.startswith("xc_rho"))


def phase_k1_ablations(cases, rec):
    """nophi and nov (GGA body) at every phase-3 shape: K1's kernels with no
    phi_D product and with no V kernel, held to their plain versions, with
    no more device memory than K1's call; nov's V exactly zero and its E
    K1's bit for bit; times at benzene and DHA, the kernel split at DHA,
    and K1's DHA time attributed to V and to the phi_D product."""
    import torch

    from quantum_compute_dft_tpu_torch.engine import fused_xc

    t0 = time.time()
    for case in cases:
        if not case[1].needs_grad:
            continue
        for kid in ("nophi", "nov"):
            variant = fused_xc.VARIANTS[kid]
            v = _compare(case[0], kid, case, rec, variant,
                         (TOL_PLAIN, TOL_ABLATE_V), None, v_scaled=True)
            extra, base = _extra_bytes(case, variant), _extra_bytes(case, {})
            if extra > base:
                raise AssertionError(f"{kid} {case[0]}: {extra} bytes "
                                     f"allocated, K1 {base}")
            if kid == "nov":
                e_nov = fused_xc.fused_xc(*case[1:7], **variant)[0]
                e_k1 = fused_xc.fused_xc(*case[1:7])[0]
                if bool(v.any()) or not torch.equal(e_nov, e_k1):
                    raise AssertionError(f"nov {case[0]}: V is not zero or "
                                         f"E {float(e_nov)} is not K1's "
                                         f"{float(e_k1)}")
            if case[0] in TIMED:
                _time(kid, case[0], case, rec, TIMED[case[0]], variant)
            if case[0].startswith("DHA grid 3/"):
                _profile(kid, case, rec, variant=variant,
                         key=TIMED[case[0]] + "split_ms")
    k1 = rec["K1"]
    v_ms = k1["dha_ms"] - rec["nov"]["dha_ms"]
    phi_ms = _rho_ms(k1["dha_split_ms"]) - _rho_ms(rec["nophi"]["dha_split_ms"])
    k1["dha_attribution"] = {"v_ms": v_ms, "v_share": v_ms / k1["dha_ms"],
                             "phi_product_ms": phi_ms,
                             "phi_product_share": phi_ms / k1["dha_ms"]}
    print(f"  K1 at DHA ({k1['dha_ms']:.4f} ms): V = K1 - nov {v_ms:.4f} ms "
          f"({v_ms / k1['dha_ms']:.1%}); phi_D product with D's staging = "
          f"K1's rho kernel - nophi's {phi_ms:.4f} ms "
          f"({phi_ms / k1['dha_ms']:.1%}); whole calls K1 - nophi "
          f"{k1['dha_ms'] - rec['nophi']['dha_ms']:.4f} ms", flush=True)
    _phase("3d nophi and nov", t0, "nophi and nov match their plain "
           "versions at every GGA shape of phase 3, with K1's memory; nov's "
           "V is zero and its E is K1's")


def phase_variants(cases, rec):
    """K1base, noprod and nofunc (GGA body) and split2 (both bodies), the
    four-kernel pipeline, at benzene and DHA against their plain versions;
    times in the GGA body."""
    from quantum_compute_dft_tpu_torch.engine.fused_xc import (
        ABLATIONS,
        VARIANTS,
        route,
    )

    t0 = time.time()
    for case in cases:
        label, fn = case[0], case[1]
        if label not in TIMED:
            continue
        kids = ("split2",)
        if fn.needs_grad:  # the ablations on K1's kernels are in 3c and 3d
            kids = ("K1base", "split2", *(
                a for a in ABLATIONS if route(fn, ablate=a)[0] == "pipeline"))
        for kid in kids:
            variant = VARIANTS[kid]
            tol_v = (TOL_NOPROD_V if kid == "noprod" else TOL_ABLATE_V
                     if kid in ABLATIONS else TOL_PLAIN)
            _compare(label, kid, case, rec, variant, (TOL_PLAIN, tol_v),
                     None, v_scaled=kid in ABLATIONS)
            if fn.needs_grad:
                _time(kid, label, case, rec, TIMED[label], variant)
    _phase("3e the four-kernel pipeline", t0, "K1base, noprod, nofunc and "
           "split2 match their plain versions at benzene and DHA")


def _golden_row(molecule, functional):
    with open(os.path.join(HERE, "tests", "golden_energies.json")) as f:
        g = json.load(f)
    for row in g["rows"]:
        if row["molecule"] == molecule and row["functional"] == functional:
            return row
    raise KeyError((molecule, functional))


def _golden(molecule, functional):
    return _golden_row(molecule, functional)["e_tot"], GOLDEN_TOL


def _reset_launches():
    from quantum_compute_dft_tpu_torch.engine import ao_eval, fused_xc
    from quantum_compute_dft_tpu_torch.grids import becke
    from quantum_compute_dft_tpu_torch.integrals import two_electron

    for k in fused_xc.LAUNCHES:
        fused_xc.LAUNCHES[k] = 0
    two_electron.LAUNCHES["K4"] = 0
    ao_eval.LAUNCHES["K5"] = 0
    becke.LAUNCHES["K6"] = 0


def _cli(fname, mol, dev, e_ref, *args):
    """One run of the port's CLI in process at grid level 3; prints its
    line (dE_ref against e_ref, n/a for None) -> (setup, SCFResult)."""
    import torch

    from quantum_compute_dft_tpu_torch import cli

    t1 = time.time()
    setup, res, scf_s = cli.run([
        fname, mol, "--molecules-dir", os.path.join(HERE, "molecules"),
        "--grid-level", "3", "--device", dev.type, *args], **JAX_CLI)
    torch.cuda.synchronize()
    dref = "n/a" if e_ref is None else f"{res.e_tot - e_ref:+.2e}"
    jk = cli.jk_label(setup)
    print(f"  {fname} {mol} {' '.join(args) or '(CLI defaults)'}: converged="
          f"{res.converged} cycles={res.n_iter} (kernel "
          f"{res.fast_cycles}, f64 verify {res.verify_cycles}) kT="
          f"{res.smear_kt:g} E={res.e_tot:.10f} dE_ref={dref} setup "
          f"{setup.build_time:.2f} s ({jk}) SCF {scf_s:.3f} s, total "
          f"{time.time() - t1:.2f} s", flush=True)
    return setup, res


def _run_path(name, runs, dev):
    """CLI runs in process with the launch counts set to 0 just before and
    read just after; returns the counts and the Cholesky seconds per
    molecule.  runs: (functional, molecule, xc_impl, reference energy,
    tolerance); the reference "previous" is the energy of the run before,
    None checks convergence only."""
    from quantum_compute_dft_tpu_torch.engine import ao_eval, fused_xc
    from quantum_compute_dft_tpu_torch.grids import becke
    from quantum_compute_dft_tpu_torch.integrals import two_electron

    t0 = time.time()
    _reset_launches()
    fast_cycles = {"K1": 0, "K2": 0}
    cholesky_s = {}
    e_prev = None
    for fname, mol, xc_impl, e_ref, tol in runs:
        e_ref = e_prev if e_ref == "previous" else e_ref
        setup, res = _cli(fname, mol, dev, e_ref, "--xc-impl", xc_impl)
        if setup.df_aux == "parity":
            cholesky_s[mol] = setup.df_time
        if xc_impl == "fast":
            fast_cycles["K1" if setup.functional.needs_grad else "K2"] += \
                res.fast_cycles
        if not res.converged or (e_ref is not None
                                 and abs(res.e_tot - e_ref) >= tol):
            raise AssertionError(f"{fname} {mol}: E={res.e_tot} vs "
                                 f"{e_ref} (tol {tol})")
        e_prev = res.e_tot
    launches = dict(fused_xc.LAUNCHES, **two_electron.LAUNCHES,
                    **ao_eval.LAUNCHES, **becke.LAUNCHES)
    for kid in ("K1", "K2"):
        if launches[kid] < max(1, fast_cycles[kid]):
            raise AssertionError(f"{name}: {kid} {launches[kid]} launches "
                                 f"for {fast_cycles[kid]} kernel-phase "
                                 "cycles")
    _phase(name, t0, f"launches {launches}, kernel-phase cycles "
           f"{fast_cycles}")
    return launches, cholesky_s


def phase_main(dev):
    """The port's CLI entry in process on both paths; returns the launch
    counts of each and the density-fitted path's Cholesky seconds."""
    incore, _ = _run_path("4a main path, in-core", (
        ("GGA", "Benzene", "fast", BENZENE_E, BENZENE_TOL),
        ("LDA", "H2O", "fast") + _golden("H2O", "LDA"),
        ("B3LYP", "H2Se", "fast") + _golden("H2Se", "B3LYP")), dev)
    df, cholesky_s = _run_path("4b main path, density fitting", (
        ("B3LYP", "Decane", "fast", DECANE_E, DF_TOL),
        ("B3LYP", "DHA", "fast", DHA_E, DF_TOL),
        ("LDA", "Decane", "f64", None, None),
        ("LDA", "Decane", "fast", "previous", FAST_VS_F64_TOL)), dev)
    return incore, df, cholesky_s


def phase_fon(dev):
    """4c: FON-RKS and the annealing ladder through the CLI, with the launch
    counts set to 0 just before and read just after; returns them.  CuO
    B3LYP on the CLI's defaults: the fast integer-occupation attempt fails
    and the ladder's result must match the golden row at its kT; CaCO3 GGA
    (K1) and LDA (K2) at --smear-kt FON_KT, fast against f64."""
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    import torch_run_all_molecules as tool

    t0 = time.time()
    _reset_launches()
    row = _golden_row("CuO", "B3LYP")
    setup, res = _cli("B3LYP", "CuO", dev, row["e_tot"])
    cuo_k1 = fused_xc.LAUNCHES["K1"]
    if not (res.converged and res.smear_kt > 0.0 and cuo_k1 > 0):
        raise AssertionError(f"CuO B3LYP: the ladder did not converge after "
                             f"the integer attempt (K1 launches {cuo_k1})")
    e, kt = res.e_tot, res.smear_kt
    cuo = f"the CLI's ladder at kT {kt:g}"
    if kt != row["smear_kt"]:
        # which rung is the coldest to converge hangs on rounding (ADIIS
        # on CuO's kT 0.25 rung, see tool.RECHECK_MIXER; the JAX package
        # itself now stops at 0.35 on the CPU, tools/golden_drift.py
        # --ladder): hold the energy at the row's kT by the recheck
        rr = tool.recheck(setup.sys, setup.functional, row["smear_kt"])
        e, kt = rr.e_tot, rr.smear_kt
        cuo += (f", then the recheck ({tool.RECHECK_MIXER} rungs) at kT "
                f"{kt:g}: converged={rr.converged} cycles={rr.n_iter} "
                f"E={e:.10f} dE_ref={e - row['e_tot']:+.2e}")
        print(f"  B3LYP CuO: {cuo}", flush=True)
        if not rr.converged:
            raise AssertionError("CuO B3LYP: the recheck did not converge")
    if kt != row["smear_kt"] or abs(e - row["e_tot"]) >= GOLDEN_TOL:
        raise AssertionError(f"CuO B3LYP: E={e} at kT {kt} vs "
                             f"{row['e_tot']} at kT {row['smear_kt']}")
    fast_cycles = {"K1": 0, "K2": 0}
    for fname, kid in (("GGA", "K1"), ("LDA", "K2")):
        e = {}
        for xc_impl in ("f64", "fast"):
            _, res = _cli(fname, "CaCO3", dev, e.get("f64"), "--xc-impl",
                          xc_impl, "--smear-kt", str(FON_KT))
            if not (res.converged and res.smear_kt == FON_KT):
                raise AssertionError(f"CaCO3 {fname} {xc_impl} at kT "
                                     f"{FON_KT} did not converge")
            e[xc_impl] = res.e_tot
            if xc_impl == "fast":
                fast_cycles[kid] += res.fast_cycles
        if abs(e["fast"] - e["f64"]) >= FAST_VS_F64_TOL:
            raise AssertionError(f"CaCO3 {fname} kT {FON_KT}: fast {e['fast']}"
                                 f" vs f64 {e['f64']}")
    launches = dict(fused_xc.LAUNCHES)
    caco3 = {"K1": launches["K1"] - cuo_k1, "K2": launches["K2"]}
    for kid in ("K1", "K2"):
        if caco3[kid] < max(1, fast_cycles[kid]):
            raise AssertionError(f"4c: {kid} {caco3[kid]} launches for "
                                 f"{fast_cycles[kid]} kernel-phase cycles")
    _phase("4c FON and the ladder", t0, f"CuO B3LYP ({cuo}) within "
           f"{GOLDEN_TOL:g} of the golden row at kT {row['smear_kt']:g} (K1 "
           f"launches {cuo_k1}); CaCO3 at kT {FON_KT:g} fast = f64; "
           f"launches {launches}, CaCO3 kernel-phase cycles {fast_cycles}")
    return launches


def phase_ri(dev, cholesky_s):
    """4d: the RI tiers and the checkpoint round trip, with the launch
    counts set to 0 just before and read just after; returns them.
    cholesky_s: 4b's Cholesky seconds per molecule, printed beside the RI
    build's."""
    import contextlib
    import io

    import torch

    from quantum_compute_dft_tpu_torch import cli, kohn_sham
    from quantum_compute_dft_tpu_torch.basis import build_basis
    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.integrals.density_fitting import (
        df_tensors,
    )
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf.driver import scf_host

    with open(RI_REF) as f:
        ref = {(r["molecule"], r["functional"], r["grid_level"], r["tier"]): r
               for r in json.load(f)["rows"]}
    t0 = time.time()
    _reset_launches()
    fast_cycles = 0
    for tier in ("tight", "fast"):
        row = ref[("Decane", "B3LYP", 3, tier)]
        setup, res = _cli("B3LYP", "Decane", dev, row["e_tot"], "--df-aux",
                          tier)
        fast_cycles += res.fast_cycles
        print(f"    RI build {setup.ri_time:.2f} s {json.dumps(setup.ri_split)}"
              f"; the JAX package's robust-fit J energy "
              f"{row['e_tot_robust_fit']:.10f} ({res.e_tot - row['e_tot_robust_fit']:+.2e})",
              flush=True)
        if not res.converged or abs(res.e_tot - row["e_tot"]) >= RI_TOL:
            raise AssertionError(f"Decane B3LYP {tier}: E={res.e_tot} vs the "
                                 f"JAX package's {row['e_tot']} (tol {RI_TOL})")

    for name, tier in RI_CPU_CHECK:
        mol = from_xyz_file(os.path.join(HERE, "molecules", name + ".xyz"))
        basis = build_basis(mol)
        ref = df_tensors(basis, mol, aux_level=tier)
        got = df_tensors(basis, mol, aux_level=tier, device=dev)
        rel = [float((g.cpu() - r).abs().max() / r.abs().max())
               for r, g in zip(ref, got)]
        print(f"  {name} '{tier}' RI tensors on the card against the CPU: "
              f"j3c {rel[0]:.2e}, v2c {rel[1]:.2e} of their largest "
              "magnitude", flush=True)
        if not max(rel) < RI_CPU_TOL:
            raise AssertionError(f"{name} {tier}: the card's RI tensors "
                                 f"depart from the CPU's by {max(rel)}")
        del ref, got

    mol = from_xyz_file(os.path.join(HERE, "molecules", "DHA.xyz"))
    e = {}
    for tier, schedules in (("fast", ("fast", "f64")), ("tight", ("fast",))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        setup = kohn_sham.prepare(mol, "B3LYP", grid_level=3,
                                  density_fit=True, df_aux=tier, device=dev)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        for xc_impl in schedules:
            t1 = time.time()
            res = scf_host(setup.sys, setup.functional.jax_potential(),
                           xc_impl=xc_impl)
            torch.cuda.synchronize()
            if not res.converged:
                raise AssertionError(f"DHA B3LYP {tier} tier, {xc_impl}: did "
                                     "not converge")
            e[tier, xc_impl] = res.e_tot
            if xc_impl == "fast":
                fast_cycles += res.fast_cycles
            print(f"  B3LYP DHA RI {tier} tier --xc-impl {xc_impl}: cycles="
                  f"{res.n_iter} (kernel {res.fast_cycles}, f64 verify "
                  f"{res.verify_cycles}) E={res.e_tot:.10f} dE_cholesky_row="
                  f"{res.e_tot - DHA_E:+.2e} SCF {time.time() - t1:.3f} s",
                  flush=True)
        print(f"  DHA {tier} setup {setup.build_time:.2f} s: RI build (naux "
              f"{setup.ri_split['naux']}) {setup.ri_time:.2f} s "
              f"{json.dumps(setup.ri_split)}, peak device memory {peak:.2f} "
              f"GB, against 4b's Cholesky {cholesky_s['DHA']:.2f} s",
              flush=True)
        del setup
    de = e["fast", "fast"] - e["fast", "f64"]
    print(f"  DHA 'fast' tier: fast - f64 {de:+.2e}", flush=True)
    if abs(de) >= FAST_VS_F64_TOL:
        raise AssertionError(f"DHA B3LYP fast tier: fast {e['fast', 'fast']} "
                             f"vs f64 {e['fast', 'f64']}")
    launches = dict(fused_xc.LAUNCHES)
    if launches["K1"] < max(1, fast_cycles):
        raise AssertionError(f"4d: K1 {launches['K1']} launches for "
                             f"{fast_cycles} kernel-phase cycles")

    ck = os.path.join(HERE, "build", "chip_smoke_checkpoint.npz")
    os.makedirs(os.path.dirname(ck), exist_ok=True)
    if os.path.exists(ck):
        os.remove(ck)
    runs = []
    for _ in range(2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _, res, _ = cli.run([
                "LDA", "H2O", "--molecules-dir", os.path.join(HERE, "molecules"),
                "--grid-level", "3", "--device", dev.type, "--xc-impl", "f64",
                "--checkpoint", ck])
        runs.append((res, "Resuming from checkpoint" in out.getvalue()))
        print(f"  LDA H2O --checkpoint: resumed={runs[-1][1]} converged="
              f"{res.converged} cycles={res.n_iter} E={res.e_tot:.10f}",
              flush=True)
    (r1, resumed1), (r2, resumed2) = runs
    if (resumed1 or not resumed2 or not (r1.converged and r2.converged)
            or r2.n_iter > r1.n_iter or abs(r2.e_tot - r1.e_tot) >= RESUME_TOL):
        raise AssertionError("4d: the checkpoint round trip did not resume")
    _phase("4d RI tiers and checkpoints", t0, f"Decane tight/fast within "
           f"{RI_TOL:g} of the JAX package; the card's RI tensors = the "
           f"CPU's; DHA fast tier fast = f64; "
           f"launches {launches}, kernel-phase cycles {fast_cycles}; the "
           f"checkpoint resumed ({r1.n_iter} then {r2.n_iter} cycles)")
    return launches


def phase_northstar(dev, rec):
    """4e: the north star on the f64 schedule through prepare's external
    factor hook (tools/torch_northstar.py's setup and scf, the factor built
    here, not cached), then K1 timed on its whole grid (recorded under
    northstar_ in K1's record)."""
    import torch
    import torch_northstar as ns

    from quantum_compute_dft_tpu_torch.scf.driver import _packed_for

    t0 = time.time()
    setup, factor = ns.setup(device=dev, cache=False)
    res, t_scf = ns.scf(setup, "f64")
    de = res.e_tot - ns.JAX_E
    rank = factor["cd_rank"]
    print(f"  B3LYP {ns.MOLECULE} grid {ns.GRID_LEVEL}: nao={setup.nao} "
          f"ngrid={setup.ngrid} (JAX {ns.JAX_NGRID}) Cholesky tol "
          f"{ns.CD_TOL:g} rank {rank} (JAX {ns.JAX_CD_RANK}) "
          f"{factor['cholesky_s']:.2f} s, prepare {setup.build_time:.2f} s "
          f"{json.dumps(setup.setup_split)}; f64: converged={res.converged} "
          f"cycles={res.n_iter} E={res.e_tot:.10f} dE_jax={de:+.2e} SCF "
          f"{t_scf:.3f} s", flush=True)
    if (setup.ngrid != ns.JAX_NGRID or not res.converged
            or abs(de) >= NORTHSTAR_TOL):
        raise AssertionError(f"north star: E={res.e_tot} vs {ns.JAX_E} "
                             f"(tol {NORTHSTAR_TOL}), ngrid {setup.ngrid}")
    fn = setup.functional
    aot, wt, grads = _packed_for(setup.sys, fn.needs_grad)
    s = setup.sys
    case = (f"{ns.MOLECULE} grid {ns.GRID_LEVEL}, whole grid", fn, res.dm,
            aot, wt, grads, setup.nao, s.ao, s.weights, s.ao_grad)
    _compare(case[0], "K1", case, rec)
    _time("K1", case[0], case, rec, "northstar_")
    del setup, s, case, aot, wt, grads
    torch.cuda.empty_cache()
    _phase("4e north star", t0, f"f64 schedule within {NORTHSTAR_TOL:g} Eh "
           f"of the JAX package ({de:+.2e}); rank {rank}, ngrid "
           f"{ns.JAX_NGRID}")


def _cli_quiet(fname, mol, dev, *args):
    """One CLI run in process at grid level 3 with its output captured ->
    (setup, SCFResult, SCF seconds, output text)."""
    import contextlib
    import io

    import torch

    from quantum_compute_dft_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        setup, res, scf_s = cli.run([
            fname, mol, "--molecules-dir", os.path.join(HERE, "molecules"),
            "--grid-level", "3", "--device", dev.type, *args], **JAX_CLI)
    torch.cuda.synchronize()
    return setup, res, scf_s, out.getvalue()


def _profiled(fn, dev):
    """One run of fn() under torch.profiler -> (result, wall s, device
    busy s, busy share)."""
    import torch

    from quantum_compute_dft_tpu_torch.utils.profiling import (
        busy_seconds,
        trace,
    )

    torch.cuda.synchronize(dev)
    with trace(os.path.join(HERE, "build", "chip_smoke_trace")) as prof:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize(dev)
        wall = time.time() - t0
    busy = busy_seconds(prof)
    if busy <= 0.0:
        raise AssertionError("the profile shows no device time")
    return out, wall, busy, busy / wall


def _jit_vs_host(label, setup, dev, rec):
    """scf_jit and scf_host f64 on one setup: unprofiled walls (scf_jit
    also with a block of 1 cycle between host reads), then one profiled run
    each (wall and device-busy share); records them under rec[label] ->
    (scf_jit's (dm, eb, n, done), host SCFResult)."""
    from quantum_compute_dft_tpu_torch.scf import driver
    from quantum_compute_dft_tpu_torch.scf.driver import scf_host, scf_jit

    s, fn = setup.sys, setup.functional.jax_potential()
    t0 = time.time()
    jit = scf_jit(s, fn)
    w_jit = time.time() - t0
    block, driver.JIT_BLOCK = driver.JIT_BLOCK, 1
    try:
        t0 = time.time()
        scf_jit(s, fn)
        w_jit1 = time.time() - t0
    finally:
        driver.JIT_BLOCK = block
    t0 = time.time()
    host = scf_host(s, fn, xc_impl="f64")
    w_host = time.time() - t0
    _, pw_jit, busy_jit, share_jit = _profiled(
        lambda: scf_jit(s, fn), dev)
    _, pw_host, busy_host, share_host = _profiled(
        lambda: scf_host(s, fn, xc_impl="f64"), dev)
    rec[label] = {"jit_cycles": jit[2], "host_cycles": host.n_iter,
                  "jit_wall_s": w_jit, "jit_block1_wall_s": w_jit1,
                  "host_wall_s": w_host,
                  "jit_profiled_wall_s": pw_jit, "jit_busy_s": busy_jit,
                  "jit_busy_share": share_jit,
                  "host_profiled_wall_s": pw_host, "host_busy_s": busy_host,
                  "host_busy_share": share_host,
                  "de_jit_host": jit[1].e_tot - host.e_tot}
    print(f"  {label}: scf_jit {jit[2]} cycles, wall {w_jit:.4f} s (block "
          f"of 1 cycle: {w_jit1:.4f} s); "
          f"scf_host f64 {host.n_iter} cycles, wall {w_host:.4f} s; "
          f"profiled: scf_jit {pw_jit:.4f} s, busy {busy_jit:.4f} s "
          f"({100 * share_jit:.1f}%), scf_host {pw_host:.4f} s, busy "
          f"{busy_host:.4f} s ({100 * share_host:.1f}%); E jit - host "
          f"{jit[1].e_tot - host.e_tot:+.2e}", flush=True)
    return jit, host


def phase_cli(dev):
    """4f: --grid-file, the setup cache, --validate native, --jit-loop and
    --xc-impl pallas through the CLI, with the launch counts set to 0 just
    before and read just after; returns them and the numbers it recorded."""
    import re
    import shutil
    import tempfile

    import numpy as np

    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.grids import build_grid
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf.driver import energy_of_dm

    t0 = time.time()
    _reset_launches()
    rec = {}
    fast_cycles = 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_4f_",
                           dir=os.path.join(HERE, "build"))

    # (a) --grid-file: the native grid at full precision, read back
    mol = from_xyz_file(os.path.join(HERE, "molecules", "Benzene.xyz"))
    grid = build_grid(mol, level=3, device=dev)
    gfile = os.path.join(tmp, "benzene_L3.grid")
    np.savetxt(gfile, np.column_stack([grid.atom_idx, grid.coords,
                                       grid.weights, grid.weights]),
               fmt=["%d"] + ["%.17g"] * 5)
    _, native, _, _ = _cli_quiet("GGA", "Benzene", dev)
    _, filed, _, _ = _cli_quiet("GGA", "Benzene", dev, "--grid-file", gfile)
    fast_cycles += native.fast_cycles + filed.fast_cycles
    de = filed.e_tot - native.e_tot
    print(f"  (a) GGA Benzene --grid-file ({grid.ngrid} points): E="
          f"{filed.e_tot:.10f}, native grid {native.e_tot:.10f} ({de:+.2e}),"
          f" BENCH {native.e_tot - BENZENE_E:+.2e}", flush=True)
    if not (native.converged and filed.converged
            and abs(de) < GRID_FILE_TOL
            and abs(native.e_tot - BENZENE_E) < BENZENE_TOL):
        raise AssertionError("4f (a): --grid-file run departs from the "
                             "native grid's")

    # (b) the setup cache, in a fresh directory
    env = {k: os.environ.get(k) for k in ("DFT_SETUP_CACHE",
                                          "DFT_SETUP_CACHE_DIR")}
    os.environ.update(DFT_SETUP_CACHE="1",
                      DFT_SETUP_CACHE_DIR=os.path.join(tmp, "cache"))
    try:
        runs = [_cli_quiet("B3LYP", "Decane", dev) for _ in range(2)]
        (cold, r_cold, _, _), (warm, r_warm, _, _) = runs
        fast_cycles += r_cold.fast_cycles + r_warm.fast_cycles
        de = r_warm.e_tot - r_cold.e_tot
        rec["decane_cache"] = {
            "cold_setup_s": cold.build_time, "warm_setup_s": warm.build_time,
            "cold_cholesky_s": cold.df_time, "warm_hits": warm.cache_hits,
            "cold_split": cold.setup_split, "warm_split": warm.setup_split}
        print(f"  (b) B3LYP Decane setup cold {cold.build_time:.3f} s "
              f"(Cholesky {cold.df_time:.3f} s, hits {cold.cache_hits}), "
              f"warm {warm.build_time:.3f} s (hits {warm.cache_hits}, "
              f"split {json.dumps(warm.setup_split)}); E warm - cold "
              f"{de:+.2e}", flush=True)
        if (cold.cache_hits or not {"cdvec", "grid"} <= set(warm.cache_hits)
                or warm.df_time != 0.0 or abs(de) > CACHE_TOL
                or abs(r_cold.e_tot - DECANE_E) >= DF_TOL):
            raise AssertionError("4f (b): the warm Decane run did not load "
                                 "the factor and grid, or departs")
        dha = from_xyz_file(os.path.join(HERE, "molecules", "DHA.xyz"))
        cold = kohn_sham.prepare(dha, "B3LYP", grid_level=3, device=dev,
                                 cd_tol=CD_TOL)
        print(f"  (b) B3LYP DHA setup cold {cold.build_time:.3f} s "
              f"(Cholesky {cold.df_time:.3f} s)", flush=True)
        rec["dha_cache"] = {"cold_setup_s": cold.build_time,
                            "cold_cholesky_s": cold.df_time}
        del cold

        # (d) --jit-loop; DHA's prepare is its warm setup
        jit_rec = {}
        for fname, name, ref_label in (("B3LYP", "H2O", None),
                                       ("B3LYP", "DHA", "DHA/B3LYP")):
            setup, res, scf_s, _ = _cli_quiet(fname, name, dev, "--jit-loop")
            host = None
            if ref_label is None:
                from quantum_compute_dft_tpu_torch.scf.driver import scf_host

                host = scf_host(setup.sys, setup.functional.jax_potential(),
                                xc_impl="f64")
            else:
                rec["dha_cache"].update(warm_setup_s=setup.build_time,
                                        warm_hits=setup.cache_hits)
                print(f"  (b) B3LYP DHA setup warm {setup.build_time:.3f} s "
                      f"(hits {setup.cache_hits})", flush=True)
                if not {"cdvec", "grid"} <= set(setup.cache_hits):
                    raise AssertionError("4f (b): DHA's warm prepare did not "
                                         "load the factor and grid")
                _, host = _jit_vs_host(ref_label, setup, dev, jit_rec)
            de = res.e_tot - host.e_tot
            print(f"  (d) {fname} {name} --jit-loop: converged={res.converged}"
                  f" cycles={res.n_iter} E={res.e_tot:.10f} SCF {scf_s:.3f} s;"
                  f" scf_host f64 {host.n_iter} cycles, E - host {de:+.2e}",
                  flush=True)
            if not (res.converged and abs(de) < JIT_TOL):
                raise AssertionError(f"4f (d): {name} --jit-loop {res.e_tot} "
                                     f"vs scf_host f64 {host.e_tot}")
            del setup
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # (c) --validate native
    for fname, name in (("B3LYP", "H2O"), ("GGA", "Benzene")):
        e_nat = {}
        for xc_impl in ("f64", "fast"):
            setup, res, _, out = _cli_quiet(fname, name, dev, "--xc-impl",
                                            xc_impl, "--validate", "native")
            m = re.search(r"native C\+\+ \(\w+\) energy : (\S+) Ha\s+\[(\d+) "
                          r"cycles\][\s\S]*native engine time\s+: (\S+) s", out)
            if m is None:
                raise AssertionError(f"4f (c): no native energy in:\n{out}")
            e = float(m.group(1))
            if xc_impl == "f64":
                e_ref = energy_of_dm(setup.sys, setup.functional,
                                     res.dm).e_tot
                tol = NATIVE_F64_TOL
            else:
                fast_cycles += res.fast_cycles
                e_ref, tol = res.e_tot, GOLDEN_TOL
            e_nat[xc_impl] = e - e_ref
            print(f"  (c) {fname} {name} --xc-impl {xc_impl} --validate "
                  f"native: native E={e:.10f} ({m.group(2)} cycles, "
                  f"{m.group(3)} s on the host), the {xc_impl} schedule's "
                  f"{e_ref:.10f}, {e - e_ref:+.2e}", flush=True)
            if not (res.converged and abs(e - e_ref) < tol):
                raise AssertionError(f"4f (c): native {e} vs {xc_impl} "
                                     f"{e_ref} (tol {tol})")
        rec[f"native_{name}"] = e_nat

    # (d) Benzene/PBE walls and busy shares; (e) --xc-impl pallas
    setup, pal, _, _ = _cli_quiet("GGA", "Benzene", dev, "--xc-impl",
                                  "pallas")
    _, host = _jit_vs_host("Benzene/PBE", setup, dev, jit_rec)
    bar = TOL_F64 * abs(host.energy.e_xc)
    de = pal.e_tot - host.e_tot
    rec["jit"] = jit_rec
    rec["pallas_benzene"] = {"cycles": pal.n_iter, "de_f64": de,
                             "bar": bar}
    print(f"  (e) GGA Benzene --xc-impl pallas: converged={pal.converged} "
          f"cycles={pal.n_iter} E={pal.e_tot:.10f}, f64 {host.e_tot:.10f} "
          f"({de:+.2e}, bar {bar:.2e})", flush=True)
    if not (pal.converged and abs(de) <= bar):
        raise AssertionError("4f (e): the pallas schedule outside the "
                             "kernel's contract")
    fast_cycles += pal.fast_cycles
    launches = dict(fused_xc.LAUNCHES)
    if launches["K1"] < max(1, fast_cycles):
        raise AssertionError(f"4f: K1 {launches['K1']} launches for "
                             f"{fast_cycles} kernel-phase cycles")
    shutil.rmtree(tmp, ignore_errors=True)
    _phase("4f CLI entry points", t0, f"--grid-file, the setup cache, "
           f"--validate native, --jit-loop and --xc-impl pallas within their "
           f"bars; launches {launches}, kernel-phase cycles {fast_cycles}; "
           f"{json.dumps(rec)}")
    return launches


def _mesh(label, cfg, world, backend, device, e_ref=None):
    """One tools/torch_northstar_mesh.py run in `world` rank processes; its
    line, and raises when it misses a bar -> the record."""
    import torch_northstar_mesh as mesh

    t0 = time.time()
    out = mesh.run(cfg, world, backend, device)
    bad = mesh.failures(out)
    launches = {k: sum(r[k] for r in out["launches_by_rank"])
                for k in ("K1", "K2")}
    msg = (f"  {label} ({world} {backend} ranks on {device}): nao="
           f"{out['nao']} ngrid={out['ngrid']} cd_rank={out['cd_rank']}; "
           f"spread {out['spread']:g}")
    if "builders" in out:
        msg += f"; builders {json.dumps(out['builders'])}"
    if "parity_rows" in out:
        rows = out["parity_rows"]
        msg += (f"; parity {len(rows)} cycles, max |dE| "
                f"{max(abs(r['dE']) for r in rows):.2e}, max|dD| "
                f"{max(r['max_dD'] for r in rows):.2e}")
    ref = out.get("reference")
    if ref is not None:
        msg += (f"; sharded loop converged={out['converged']} "
                f"{out['cycles']} cycles E={out['e_tot']:.10f} "
                f"{1e3 * out['scf_s'] / out['cycles']:.2f} ms/cycle (median "
                f"{1e3 * out['cycle_s_median']:.2f}), scf_host "
                f"f64 {ref['cycles']} cycles "
                f"{1e3 * ref['s'] / ref['cycles']:.2f} ms/cycle, E - scf_host "
                f"{ref['dE_mesh']:+.2e}")
        if not (ref["converged"] and abs(ref["dE_mesh"]) < MESH_LOOP_TOL):
            bad.append(f"E - scf_host {ref['dE_mesh']}")
        if e_ref is not None:
            msg += f", dE_ref {out['e_tot'] - e_ref:+.2e}"
            if abs(out["e_tot"] - e_ref) >= DF_TOL:
                bad.append(f"E {out['e_tot']} vs {e_ref}")
    print(msg + f"; K1/K2 launches {launches} ({time.time() - t0:.2f} s)",
          flush=True)
    if bad:
        raise AssertionError(f"4g {label}: {bad}")
    return launches


def phase_mesh():
    """4g: the sharded SCF over rank processes (tools/torch_northstar_mesh.py),
    two gloo ranks on card 0, then NCCL over every card; returns the ranks'
    K1/K2 launches (the f64 engine's path: 0)."""
    import shutil
    import tempfile

    import torch

    import torch_northstar_mesh as mesh

    t0 = time.time()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_4g_",
                           dir=os.path.join(HERE, "build"))
    launches = [
        _mesh("(a) B3LYP H2O grid 3 in-core builders",
              mesh.config("H2O", grid_level=3, cd_tol=0, modes=("builders",)),
              2, "gloo", "cuda:0"),
        _mesh("(a) B3LYP Decane grid 3 Cholesky DF",
              mesh.config("Decane", grid_level=3, cd_tol=1e-7, cycles=5,
                          d_tol=MESH_D_TOL, reference=True, factor_dir=tmp),
              2, "gloo", "cuda:0"),
        _mesh("(b) B3LYP DHA grid 3 Cholesky DF",
              mesh.config("DHA", grid_level=3, cd_tol=1e-7,
                          modes=("converge",), d_tol=MESH_D_TOL,
                          reference=True, factor_dir=tmp),
              torch.cuda.device_count(), "nccl", "cuda", DHA_E)]
    shutil.rmtree(tmp, ignore_errors=True)
    total = {k: sum(n[k] for n in launches) for k in ("K1", "K2")}
    _phase("4g sharded SCF", t0, f"builders within {mesh.BUILDERS_TOL:g}, "
           f"parity within the JAX rule, loops within {MESH_LOOP_TOL:g} Eh of "
           f"scf_host f64, the ranks' densities bitwise equal; ranks' "
           f"launches {total}")
    return total


def _parting(trace, ref_trace):
    """The first optimizer evaluation at which the card's trial zetas or
    energy leave the CPU run's -> a message, or None."""
    for i, ((z, e), (zr, er)) in enumerate(zip(trace, ref_trace)):
        if z.keys() != zr.keys() or any(
                abs(z[k] / zr[k] - 1.0) >= ZETA_RTOL for k in z):
            return f"evaluation {i}: trial zetas {z} vs {zr}"
        if abs(e - er) >= ATOMIC_TOL:
            return f"evaluation {i} at {z}: E {e!r} vs {er!r}"
    if len(trace) != len(ref_trace):
        return f"{len(trace)} evaluations vs {len(ref_trace)}"
    return None


def phase_tools(dev):
    """4h: the basis generators, the oracle rows and two sweep rows, with
    the launch counts set to 0 just before and read just after; returns
    them."""
    import torch

    from quantum_compute_dft_tpu_torch.basis import atomic_scf
    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.runtime import build_library

    import torch_oracle_diffs as oracle
    import torch_run_all_molecules as sweep_tool
    from optimizer_trace import optimize_traced

    t0 = time.time()
    with open(ATOMIC_REF) as f:
        ref = json.load(f)
    with open(SWEEP_REF) as f:
        sweep_ref = json.load(f)
    _reset_launches()
    bad = []
    for sym in ("O", "Cu", "Se", "I"):
        t1 = time.time()
        e = atomic_scf.atomic_energy(sym, device=dev)
        torch.cuda.synchronize()
        de = e - ref["energies"][sym]["e"]
        print(f"  atomic_energy {sym}: E={e:.12f} dE_cpu={de:+.2e} "
              f"({1e3 * (time.time() - t1):.1f} ms)", flush=True)
        if not abs(de) < ATOMIC_TOL:
            bad.append(f"atomic_energy {sym} dE {de}")
    for sym, frozen in (("O", ()), ("Cu", ("4sp",))):
        t1 = time.time()
        zetas, e, trace = optimize_traced(atomic_scf, sym,
                                          frozen_shells=frozen, device=dev)
        r = ref["optimize"][sym]
        rel = max(abs(zetas[k] / r["zetas"][k] - 1.0) for k in r["zetas"])
        msg = (f"  optimize_zetas {sym} (frozen {list(frozen)}): {zetas} "
               f"E={e:.12f} dE_cpu={e - r['e']:+.2e} max rel dzeta "
               f"{rel:.1e}, {len(trace)} evaluations "
               f"({time.time() - t1:.2f} s)")
        part = _parting(trace, r["trace"])
        if part:
            msg += f"; first parting from the CPU run: {part}"
            bad.append(f"optimize_zetas {sym} parts from the CPU run: {part}")
        print(msg, flush=True)
        if not (rel < ZETA_RTOL and abs(e - r["e"]) < ATOMIC_TOL):
            bad.append(f"optimize_zetas {sym}: {zetas} vs {r['zetas']}")
        if sym == "O" and any(abs(zetas[k] / z - 1.0) >= O_PUBLISHED_RTOL
                              for k, z in O_PUBLISHED.items()):
            bad.append(f"O zetas {zetas} vs published {O_PUBLISHED}")
    build_library()
    for name, fn, df in (("H2O", "B3LYP", False), ("H2Se", "B3LYP", False),
                         ("Benzene", "B3LYP", True)):
        r = oracle.scf_row(name, fn, df, "fast", dev)
        print(f"  oracle {name}/{fn}{' DF' if df else ''} fast: dE_stat "
              f"{r['de']:.2e} (bar {r['tol']:g}), cycles {r['cycles']} "
              f"(kernel {r['fast_cycles']}), native {r['native_cycles']} "
              f"({r['seconds']:.2f} s)", flush=True)
        if not r["within"]:
            bad.append(f"oracle {name}/{fn}: {r}")
    for r in oracle.dha_rows(dev):
        print(f"  oracle DHA/B3LYP fixed density, {r['engine']}: dE_xc "
              f"{r['de_xc']:.2e} max dV {r['dv_xc']:.2e} (ngrid "
              f"{r['ngrid']})", flush=True)
        if not r["within"]:
            bad.append(f"oracle DHA {r['engine']}: {r}")
    for name in SWEEP_ROWS:
        row = sweep_tool.run_one(name, "B3LYP", 3, "fast", dev)
        e_ref = sweep_ref[f"{name}/B3LYP"]["e_tot"]
        de = row["e_tot"] - e_ref
        print(f"  sweep {name}/B3LYP nao={row['nao']} ngrid={row['ngrid']}:"
              f" converged={row['converged']} cycles={row['n_iter']} (kernel"
              f" {row['fast_cycles']}) E={row['e_tot']:.10f} dE_r5={de:+.2e} "
              f"setup {row['setup_s']:.2f} s SCF {row['scf_s']:.2f} s",
              flush=True)
        if not (row["converged"] and abs(de) <= SWEEP_TOL):
            bad.append(f"sweep {name}: dE {de}")
    launches = dict(fused_xc.LAUNCHES)
    if launches["K1"] < 1:
        bad.append(f"K1 launched {launches['K1']} times")
    if bad:
        raise AssertionError(f"4h: {bad}")
    _phase("4h basis generators and tools", t0, f"atomic energies within "
           f"{ATOMIC_TOL:g} Eh and zetas within {ZETA_RTOL:g} of the CPU; "
           f"oracle rows within their bars; sweep rows within {SWEEP_TOL:g};"
           f" launches {launches}")
    return launches


def phase_rescue(dev):
    """4i: tools/torch_rescue_ladder.py's rescue_system on ABAQ/B3LYP at
    grid 3 from SAD with the protocol of docs/rescue_h100.json, with the
    launch counts set to 0 just before and read just after; the result
    converged to the full rule at the protocol's kT, within RESCUE_TOL of
    the file's energy and DF_TOL of the JAX package's record.  The kT is
    the record's protocol, not the lowest state: with CDIIS the integer
    finish from the kT 0.015 density converges below the record in the
    JAX package's loop as in the port's, and with the protocol's
    mix+cdiis it fails in both (docs/rescue_h100.json "integer_finish"), so
    a protocol whose integer finish converges would leave this check.
    Returns the counts."""
    import torch

    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf.driver import scf_host

    import torch_rescue_ladder as rescue

    t0 = time.time()
    with open(RESCUE_REF) as f:
        ref = json.load(f)
    proto, record = ref["protocol"], ref["record"]
    mol = from_xyz_file(os.path.join(HERE, "molecules",
                                     proto["molecule"] + ".xyz"))
    _reset_launches()
    setup = kohn_sham.prepare(mol, "B3LYP", grid_level=proto["grid_level"],
                              device=dev, cd_tol=CD_TOL)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    cycles = []

    def counted(sys_, fn, **kw):
        r = scf_host(sys_, fn.jax_potential(), **kw)
        cycles.append(r.n_iter)
        return r

    t1 = time.time()
    r = rescue.rescue_system(setup.sys, setup.functional,
                             env=dict(proto["knobs"]), runner=counted)
    torch.cuda.synchronize()
    scf_s = time.time() - t1
    launches = dict(fused_xc.LAUNCHES)
    if r is None or not r.converged:
        raise AssertionError(f"4i: {proto['molecule']} not converged by "
                             f"{proto['knobs']}")
    de_row, de_rec = r.e_tot - proto["e_tot"], r.e_tot - record["e_tot"]
    print(f"  rescue {proto['molecule']}/B3LYP grid {proto['grid_level']} "
          f"{proto['knobs']}: converged kT={r.smear_kt:g} E={r.e_tot:.10f} "
          f"dE_row={de_row:+.2e} dE_jax={de_rec:+.2e}; {sum(cycles)} cycles "
          f"in {len(cycles)} SCF runs (the last {r.n_iter}); setup "
          f"{setup_s:.2f} s, rescue {scf_s:.2f} s", flush=True)
    if not (r.smear_kt == proto["smear_kt"] and abs(de_row) < RESCUE_TOL
            and abs(de_rec) < DF_TOL):
        raise AssertionError(f"4i: kT {r.smear_kt} E {r.e_tot} vs the "
                             f"row's {proto['smear_kt']} {proto['e_tot']} "
                             f"and the record {record['e_tot']}")
    _phase("4i rescue protocol", t0, f"ABAQ within {RESCUE_TOL:g} Eh of "
           f"its row and {DF_TOL:g} of the JAX record at kT "
           f"{r.smear_kt:g}; launches {launches}")
    return launches


def phase_sweep():
    """The variant sweep's entry point at DHA grid 3, in process, with the
    launch counts set to 0 just before and read just after; returns them."""
    t0 = time.time()
    import numpy as np

    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS

    import torch_xc_sweep

    _reset_launches()
    rows = torch_xc_sweep.sweep(["DHA", "3"])
    launches = dict(fused_xc.LAUNCHES)
    expect = dict.fromkeys(launches, 0)
    for row in rows:
        (name,) = fused_xc.launch_names(
            FUNCTIONALS["B3LYP"], **fused_xc.VARIANTS[row["variant"]])
        expect[name] += row["calls"]
        de = abs(row["e_xc"] - row["e_xc_plain"]) / abs(row["e_xc_plain"])
        if not (np.isfinite(row["e_xc"]) and de < TOL_PLAIN):
            raise AssertionError(f"sweep {row['variant']}: E {row['e_xc']} "
                                 f"vs plain {row['e_xc_plain']}")
    if [r["variant"] for r in rows] != list(fused_xc.VARIANTS):
        raise AssertionError("the sweep did not run every variant")
    bases = {r["variant"]: r["base"] for r in rows}
    if any(bases[k] != "K1" for k in ("K3", "phi3", "nophi", "nov")):
        raise AssertionError(f"sweep bases {bases}: the rows on K1's "
                             "kernels are read against K1")
    if launches != expect:
        raise AssertionError(f"sweep launches {launches}, expected one per "
                             f"kernel call: {expect}")
    _phase("5 variant sweep (DHA grid 3)", t0, f"launches {launches}")
    return launches


def phase_vitamin_b2(dev):
    """6: one B3LYP job on Vitamin-B2 (riboflavin, nao 155, the pivoted
    Cholesky) through cli.run as the benchmark's configuration
    vitb2.sto3g.grid3.cd runs it, at the default V_xc = dE_xc/dD, held to
    the plain reference of bench_torch/reference at the configuration's
    limit; its K builds are the f32 aux-major K's in the kernel phase and
    the f64 K's in the verify cycles and the final energy."""
    import contextlib
    import gc
    import io

    import torch

    from bench_torch import harness
    from quantum_compute_dft_tpu_torch import cli

    t0 = time.time()
    cfg = harness.load_json(os.path.join(HERE, "bench_torch", "configs",
                                         "vitb2.sto3g.grid3.cd.json"))
    path = os.path.join(HERE, cfg["molecule"])
    with contextlib.redirect_stdout(io.StringIO()):
        setup, res, scf_s = cli.run(["B3LYP", path, *cfg["argv"], "--device",
                                     dev.type])
    torch.cuda.synchronize()
    job_s = time.time() - t0
    e, nao, ngrid = res.e_tot, setup.nao, setup.ngrid
    counts = (res.fast_cycles, res.verify_cycles, res.k_builds_fast,
              res.k_builds_f64)
    del setup, res
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.time()
    syms, xyz = harness.read_xyz(path)
    e_ref = harness.reference_energies(cfg, ["B3LYP"], syms, xyz,
                                       dev)["B3LYP"]
    torch.cuda.synchronize()
    gap = abs(e - e_ref)
    print(f"  B3LYP Vitamin-B2 nao={nao} ngrid={ngrid}: E={e:.10f}, "
          f"reference {e_ref:.10f}, |dE| {gap:.3e} (limit "
          f"{cfg['energy_limit_eh']:g}); cycles kernel {counts[0]} + verify "
          f"{counts[1]}, K builds f32 {counts[2]} / f64 {counts[3]}; job "
          f"{job_s:.2f} s (SCF {scf_s:.3f} s), reference "
          f"{time.time() - t1:.2f} s", flush=True)
    if (nao, ngrid) != (cfg["nao"], 553156):
        raise AssertionError(f"6: nao {nao}, ngrid {ngrid}: not the "
                             "configuration's")
    if not gap < cfg["energy_limit_eh"]:
        raise AssertionError(f"6: Vitamin-B2 B3LYP {e} vs the reference "
                             f"{e_ref}")
    if counts[2] != counts[0] or counts[3] != counts[1] + 1:
        raise AssertionError(f"6: K builds {counts[2:]} for cycles "
                             f"{counts[:2]}")
    _phase("6 Vitamin-B2 B3LYP", t0, f"within {gap:.2e} Eh of the plain "
           "reference")


def main() -> int:
    # every phase times cold setup builds; phase 4f turns the setup cache
    # on in a directory of its own
    os.environ["DFT_SETUP_CACHE"] = "0"
    smi = phase_env()
    phase_build()
    import torch

    dev = torch.device("cuda")
    k4 = phase_k4(dev)
    ao = phase_ao(dev)
    bk = phase_becke(dev)
    rec, cases = phase_kernels(dev)
    phase_k3(cases, rec)
    phase_k1_ablations(cases, rec)
    phase_variants(cases, rec)
    del cases
    torch.cuda.empty_cache()
    incore, df, cholesky_s = phase_main(dev)
    fon = phase_fon(dev)
    ri = phase_ri(dev, cholesky_s)
    phase_northstar(dev, rec)
    cli = phase_cli(dev)
    phase_mesh()
    tools = phase_tools(dev)
    rescue = phase_rescue(dev)
    sweep = phase_sweep()
    phase_vitamin_b2(dev)

    kernels = []
    for kid in REPLACES:
        entry = {"name": KERNEL_NAMES[kid], "route": "cuda",
                 "source": KERNEL_SRC, "replaces": REPLACES[kid]}
        if kid in ("K1", "K2"):  # the SCF's kernels: the main paths' counts
            entry.update(launches=df[kid], incore_launches=incore[kid],
                         fon_launches=fon[kid], ri_launches=ri[kid],
                         cli_launches=cli[kid], tools_launches=tools[kid],
                         rescue_launches=rescue[kid],
                         sweep_launches=sweep[kid])
        else:
            entry["launches"] = sweep[kid]
        if entry["launches"] < 1:
            raise AssertionError(f"{kid} was not launched on its path")
        entry.update(rec[kid])
        entry["library_ms"] = None  # no one PyTorch call is a fused XC body
        missing = {"ms", "plain_ms", "bound_ms", "bound_by"} - set(entry)
        if missing:
            raise AssertionError(f"{kid}: no {sorted(missing)} in this run")
        kernels.append(entry)
    if min(incore["K4"], df["K4"]) < 1:
        raise AssertionError("K4 was not launched on the main paths")
    kernels.append({
        "name": "K4 ERI quartet stage", "route": "cuda",
        "source": K4_SRC, "replaces": K4_REPLACES, "launches": df["K4"],
        "incore_launches": incore["K4"],
        "max_abs_err": max(r["max_abs_err"] for r in k4.values()),
        **{k: k4["dha_panel"][k] for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "f64 operations at 67 TFLOP/s",
        "cases": k4, "library_ms": None})
    if min(incore["K5"], df["K5"]) < 1:
        raise AssertionError("K5 was not launched on the main paths")
    kernels.append({
        "name": "K5 AO planes", "route": "cuda", "source": K5_SRC,
        "replaces": K5_REPLACES, "launches": df["K5"],
        "incore_launches": incore["K5"],
        "max_rel_err": max(r["max_rel_err"] for r in ao.values()),
        **{k: ao["DHA_L3_d1"][k] for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "f64 bytes written at 3.35 TB/s", "cases": ao,
        "library_ms": None})
    if min(incore["K6"], df["K6"]) < 1:
        raise AssertionError("K6 was not launched on the main paths")
    kernels.append({
        "name": "K6 Becke partition", "route": "cuda", "source": K6_SRC,
        "replaces": K6_REPLACES, "launches": df["K6"],
        "incore_launches": incore["K6"],
        "max_abs_err": max(r["max_abs_err"] for r in bk.values()),
        **{k: bk["DHA_L3"][k] for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": f"f64 instructions ({K6_PAIR_OPS} an ordered atom "
                    "pair) at 17e12 a second", "cases": bk,
        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path[:0] = [HERE, TOOLS]
    sys.exit(main())
