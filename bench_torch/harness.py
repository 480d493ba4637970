"""One run of one cell of the port's benchmark.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
(``configs/<name>.json``: the molecule, the CLI's arguments, the limit of
the energy comparison) and a traffic mix (``traffic/<name>.json``: the
functionals of one round and the setup cache's state).  One user runs jobs
back to back, each the reference's CLI entry ``cli.run`` in-process, with
stdout to a sink.  Set-up imports the program, builds or loads its kernels
and runs one warm-up round; the window then runs whole rounds until
``--seconds`` have passed.  With ``--trace 1`` one more round runs under
``torch.profiler`` and each per-layer metric's reader
(``metrics/<name>.py``) reads the run.  Last, the program's state is
freed and the plain reference (``reference/``) computes each functional's
energy at the run's geometry, which every job's energy is held to.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The workload entry, its configuration and its traffic, by name."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return dict(workload=wl,
                config=load_json(os.path.join(ROOT, conf["file"])),
                traffic=load_json(os.path.join(HERE, "traffic",
                                               wl["traffic"] + ".json")),
                bench=bench)


# the pool of placements every run draws its geometries from
POOL_SEED = 20261017
# what a job of a warm cell has to load from the setup cache
# (KSSetup.cache_hits): the two-electron tensors and the grid
WARM_LOADS = {"two-electron": {"eri", "cdvec"}, "grid": {"grid"}}


def read_xyz(path: str):
    with open(path) as f:
        rows = [ln.split() for ln in f.read().splitlines()[2:] if ln.split()]
    return [r[0] for r in rows], np.array([[float(v) for v in r[1:4]]
                                           for r in rows])


def _placement(xyz, rng):
    """xyz under a rigid rotation and translation drawn from rng."""
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    shift = rng.uniform(-2.0, 2.0, 3)
    return (xyz - xyz.mean(0)) @ q.T + shift


def seeded_geometry(xyz_path: str, seed: int):
    """The published geometry under a rigid rotation and translation drawn
    from the seed: (symbols, (natm, 3) Angstrom)."""
    syms, xyz = read_xyz(xyz_path)
    return syms, _placement(xyz, np.random.default_rng(seed))


def geometry_pool(xyz_path: str, n: int, seed: int):
    """The configuration's n placements of the published geometry, the
    same for every seed, in an order drawn from the seed: every run does
    the same work (the SCF's cycle count depends on the placement through
    rounding), in another order.  -> (symbols, [(natm, 3) Angstrom])."""
    syms, xyz = read_xyz(xyz_path)
    rng = np.random.default_rng(POOL_SEED)
    pool = [_placement(xyz, rng) for _ in range(n)]
    return syms, [pool[i] for i in np.random.default_rng(seed).permutation(n)]


def write_xyz(path: str, syms, xyz) -> None:
    with open(path, "w") as f:
        f.write(f"{len(syms)}\nseeded geometry (angstrom)\n")
        for s, (x, y, z) in zip(syms, xyz):
            f.write(f"{s} {float(x)!r} {float(y)!r} {float(z)!r}\n")


@dataclasses.dataclass
class Run:
    """What a run hands its metric readers."""
    jobs: list            # one dict per job in the window
    device: str           # "cuda" or "cpu"
    profile: dict | None = None   # the traced round (busy, spans)
    kept: dict = dataclasses.field(default_factory=dict)  # fn -> (setup, res)

    def mean(self, key: str):
        vals = [j[key] for j in self.jobs if j.get(key) is not None]
        return statistics.fmean(vals) if vals else None


class Jobs:
    """Runs the cell's jobs through the CLI entry, round after round (one
    job per functional of the traffic, each round on the next geometry of
    the run's order), each with the setup cache of the traffic's state: a
    new empty directory per job ("cold") or the run's own directory
    ("warm"), which the warm-up fills for every geometry."""

    def __init__(self, config: dict, traffic: dict, paths: list, device: str,
                 scratch: str):
        self.config, self.traffic, self.paths = config, traffic, paths
        self.device, self.scratch = device, scratch
        self.cache = traffic["cache"]
        if self.cache not in ("cold", "warm"):
            raise ValueError(f"traffic cache must be cold or warm, not "
                             f"{self.cache!r}")
        self.warm_dir = os.path.join(scratch, "setup_cache")
        self.n = self.next = 0

    def argv(self, functional: str, path: str) -> list:
        args = [functional, path, *self.config["argv"]]
        if self.device == "cpu":
            args += ["--device", "cpu"]
        return args

    def one(self, functional: str, geom: int, keep: bool = False,
            filling: bool = False) -> dict:
        """Run one job on geometry `geom`; -> its record (and, with keep,
        its setup and result under "kept").  A job fails when it raises,
        does not converge, or loads other than the traffic's cache state
        says: nothing from a cold cache, the two-electron tensors and the
        grid from a warm one; a job `filling` the warm cache is not held
        to it."""
        from quantum_compute_dft_tpu_torch import cli

        if self.cache == "cold":
            cache_dir = os.path.join(self.scratch, f"cold_{self.n}")
        else:
            cache_dir = self.warm_dir
        self.n += 1
        os.environ["DFT_SETUP_CACHE_DIR"] = cache_dir
        rec = dict(functional=functional, geom=geom, ok=False)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                setup, res, scf_s = cli.run(self.argv(functional,
                                                      self.paths[geom]))
        except Exception as e:   # a job that raises is a failed job
            rec["error"] = f"{type(e).__name__}: {e}"[:300]
            return rec
        finally:
            if self.cache == "cold":
                shutil.rmtree(cache_dir, ignore_errors=True)
        hits = set(setup.cache_hits)
        if filling:          # may load what an earlier job of it stored
            missed = []
        elif self.cache == "cold":
            missed = sorted(hits)
        else:
            missed = [k for k in ("two-electron", "grid")
                      if not hits & WARM_LOADS[k]]
        if missed:
            rec["error"] = (f"cache state {self.cache!r} broken: loaded "
                            f"{sorted(hits)}, problem {missed}")
        rec.update(
            ok=bool(res.converged) and not missed, e_tot=float(res.e_tot),
            wall_s=time.perf_counter() - t0, prepare_s=setup.build_time,
            scf_s=scf_s, fast_cycles=res.fast_cycles,
            verify_cycles=res.verify_cycles, n_iter=res.n_iter,
            nao=setup.nao, ngrid=setup.ngrid, cache_hits=setup.cache_hits,
            **{k: v for k, v in (setup.setup_split or {}).items()})
        if keep:
            rec["kept"] = (setup, res)
        return rec

    def round(self, keep: bool = False, filling: bool = False) -> list:
        g = self.next % len(self.paths)
        self.next += 1
        return [self.one(fn, g, keep, filling)
                for fn in self.traffic["functionals"]]

    def warm_up(self) -> list:
        """One round, or with a warm cache one round per geometry, which
        fills it; raises SystemExit when a job of it fails."""
        warm = self.cache == "warm"
        n = len(self.paths) if warm else 1
        recs = sum((self.round(filling=warm) for _ in range(n)), [])
        bad = [r for r in recs if not r["ok"]]
        if bad:
            why = bad[0].get("error", "not converged")
            raise SystemExit(f"warm-up failed: {why}")
        return recs


def _metric_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def traced_round(jobs: Jobs, device: str) -> tuple[list, dict]:
    """One round under torch.profiler, with spans around the calls into
    prepare and the SCF loop.  -> (its records, the profile's summary:
    busy seconds over the round, the round's length, the SCF spans, the
    device's busiest operations and the host operations that its longest
    idle gaps fell in)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.scf import driver

    def span(fn, label):
        def wrapped(*a, **k):
            with record_function(label):
                out = fn(*a, **k)
                if device == "cuda":
                    torch.cuda.synchronize()
                return out
        return wrapped

    orig = kohn_sham.prepare, driver.scf_host
    kohn_sham.prepare = span(orig[0], "bench.prepare")
    driver.scf_host = span(orig[1], "bench.scf")
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        with profile(activities=acts) as prof:
            with record_function("bench.round"):
                recs = jobs.round(keep=True)
    finally:
        kohn_sham.prepare, driver.scf_host = orig
    t_read = time.perf_counter()
    # the raw events (ns): FunctionEvent trees cost ~70 us an event to build
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in events:
        span = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            # device work: kernels, copies and sets; not the device-side
            # ranges that record_function adds for its spans
            annotation = getattr(e, "is_user_annotation", lambda: False)()
            if not annotation and not span[2].startswith("bench."):
                dev.append(span)
        elif e.device_type() == DeviceType.CPU:
            host.append(span)
    rnd = next(e for e in host if e[2] == "bench.round")
    scf = [(s, e) for s, e, n in host if n == "bench.scf"]
    spans = [(s, e) for s, e, _ in dev]
    from bench_torch import roofline

    by_op = {}
    for s, e, n in dev:
        by_op[n] = by_op.get(n, 0.0) + (e - s) * 1e-9
    # the SCF's 100 longest idle gaps, summed by the innermost host
    # operation that was running at each gap's middle
    idle = {}
    ops = [(s, e, n) for s, e, n in host if not n.startswith("bench.")
           and any(s < hi and e > lo for lo, hi in scf)]
    all_gaps = [g for lo, hi in scf for g in roofline.gaps(spans, lo, hi)]
    longest = sorted(all_gaps, key=lambda g: g[0] - g[1])[:100]
    for gs, ge in longest:
        mid = 0.5 * (gs + ge)
        inner = [(e - s, n) for s, e, n in ops if s <= mid <= e]
        name = min(inner)[1] if inner else "python (no torch op)"
        idle[name] = idle.get(name, 0.0) + (ge - gs) * 1e-9
    print(f"trace: {len(events)} events read in "
          f"{time.perf_counter() - t_read:.3f} s", file=sys.stderr)
    summary = dict(
        window_s=(rnd[1] - rnd[0]) * 1e-9,
        busy_s=roofline.union_seconds(spans, rnd[0], rnd[1]) * 1e-9,
        scf_s=sum(e - s for s, e in scf) * 1e-9,
        scf_busy_s=sum(roofline.union_seconds(spans, s, e)
                       for s, e in scf) * 1e-9,
        device_ops=sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:10])
    return recs, summary


def reference_energies(config: dict, functionals, syms, xyz,
                       device: str) -> dict:
    """The plain reference's energy of each functional at one geometry."""
    from bench_torch.reference import basis, rks

    ref = rks.Reference(basis.mol_from_angstrom(syms, xyz),
                        config["grid_level"], device)
    return {fn: ref.energy(fn) for fn in dict.fromkeys(functionals)}


def setup_parts(t_start: float, device: str) -> dict:
    """Imports the program and loads its kernel library, which the first
    run of a checkout builds (nvcc), so that a run records its one-off
    build apart from the rest of its set-up: -> seconds from the process's
    start to the program imported, seconds in the library's load, and
    whether it built."""
    from quantum_compute_dft_tpu_torch import cli  # noqa: F401

    parts = dict(import_s=time.perf_counter() - t_start)
    if device == "cuda":
        from quantum_compute_dft_tpu_torch.engine import fused_xc

        t0 = time.perf_counter()
        parts["kernels_built"] = not fused_xc.library_path().exists()
        fused_xc.build()
        parts["kernels_s"] = time.perf_counter() - t0
    return parts


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", config_path: str | None = None,
        jobs_cls=Jobs) -> dict:
    """One run; -> the result's fields.  `config_path` replaces the cell's
    configuration (the CPU rehearsal's H2O), `jobs_cls` the job runner
    (the tests' control)."""
    import torch

    c = cell(workload)
    config = load_json(config_path) if config_path else c["config"]
    traffic = c["traffic"]
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="bench_torch_") as scratch:
        syms, geoms = geometry_pool(os.path.join(ROOT, config["molecule"]),
                                    config["geometries"], seed)
        paths = []
        for i, xyz in enumerate(geoms):
            paths.append(os.path.join(scratch, f"geometry_{i}.xyz"))
            write_xyz(paths[-1], syms, xyz)
        jobs = jobs_cls(config, traffic, paths, device, scratch)
        parts = setup_parts(t_start, device)
        t_warm = time.perf_counter()
        jobs.warm_up()                     # shapes, lazy imports, the cache
        parts["warm_up_s"] = time.perf_counter() - t_warm
        print(f"set-up: {json.dumps(parts)}", file=sys.stderr)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_start
        window = []
        while True:
            window += jobs.round()
            if time.perf_counter() - t_w0 >= seconds:
                break
        t_w1 = time.perf_counter()
        for j in window:
            print("job " + json.dumps({k: j.get(k) for k in (
                "functional", "geom", "ok", "wall_s", "prepare_s", "scf_s",
                "two_electron_s", "fast_cycles", "verify_cycles")}),
                file=sys.stderr)
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else None)
        answers = list(window)
        rn = Run(jobs=[j for j in window if j["ok"]], device=device)
        if trace:
            recs, rn.profile = traced_round(jobs, device)
            answers += recs
            rn.kept = {r["functional"]: r.pop("kept") for r in recs
                       if "kept" in r}
            metrics = {}
            for m in c["bench"]["per_layer"]:
                if workload not in m.get("workloads", [workload]):
                    continue
                val = _metric_reader(m["name"])(rn)
                if val is not None:
                    metrics[m["name"]] = dict(value=val, unit=m["unit"])
        else:
            metrics = dict(
                setup_s=setup_s,
                solve_s=(t_w1 - t_w0) / len(window),
                prepare_s=rn.mean("prepare_s"),
                scf_s=rn.mean("scf_s"))
            units = {m["name"]: m["unit"] for m in c["bench"]["end_to_end"]}
            metrics = {k: dict(value=v, unit=units[k])
                       for k, v in metrics.items() if v is not None}
        profile = rn.profile
        rn.kept.clear()
        del rn, jobs
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        refs = {g: reference_energies(config, traffic["functionals"], syms,
                                      geoms[g], device)
                for g in sorted({j["geom"] for j in answers if j["ok"]})}
        print(f"reference: {time.perf_counter() - t_ref:.3f} s for "
              f"{len(refs)} geometries; window: {t_w1 - t_w0:.3f} s, "
              f"{len(window)} jobs", file=sys.stderr)
    limit = config["energy_limit_eh"]
    compared = {}
    for fn in dict.fromkeys(traffic["functionals"]):
        gaps = [abs(j["e_tot"] - refs[j["geom"]][fn]) for j in answers
                if j["ok"] and j["functional"] == fn]
        compared[f"energy_gap_{fn}"] = dict(
            value=max(gaps) if gaps else None, limit=limit)
    failed = sum(not j["ok"] for j in answers)
    correct = (failed == 0 and all(v["value"] is not None
                                   and v["value"] <= limit
                                   for v in compared.values()))
    return dict(correct=correct, attempted=len(window),
                failed=sum(not j["ok"] for j in window), metrics=metrics,
                peak=peak, profile=profile, compared=compared,
                setup_parts=parts,
                references={fn: [refs[g][fn] for g in refs]
                            for fn in dict.fromkeys(traffic["functionals"])})
