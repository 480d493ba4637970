"""The PyTorch port stands alone: no JAX and no JAX-package import.

A subprocess with JAX and the JAX package blocked in sys.modules imports
every module of the port; a source scan of the port, chip_smoke.py, the
port's tools (tools/torch_*.py) and the multi-rank tests' rank functions
(tests/torch_parallel_ranks.py) finds no import of either; and no
string in the port's code (docstrings aside, which cite the modules each
one ports) names a path inside the JAX package, so nothing there is read
or built at run time (the port keeps its own copies, such as
runtime/dft_host.cpp).
"""

import ast
import os
import pkgutil
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "quantum_compute_dft_tpu_torch"


def _port_modules():
    import quantum_compute_dft_tpu_torch as pkg

    names = [PKG]
    for info in pkgutil.walk_packages(pkg.__path__, PKG + "."):
        if not info.name.endswith("__main__"):
            names.append(info.name)
    return names


def test_port_imports_without_jax():
    mods = _port_modules()
    assert len(mods) > 20, mods
    for name in ("runtime.ffi", "runtime.native_scf", "setup_cache",
                 "utils.profiling", "parallel", "parallel.mesh",
                 "parallel.sharded", "parallel.sharded_scf",
                 "parallel.launch", "basis.atomic_scf", "basis.stong_fit"):
        assert f"{PKG}.{name}" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['quantum_compute_dft_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
        "sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


_BAD = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+quantum_compute_dft_tpu\b"
    r"(?!_torch)|from\s+quantum_compute_dft_tpu\b(?!_torch))", re.M)


def test_source_scan_finds_no_jax_import():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, PKG)):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    tools = [os.path.join(ROOT, "tools", n)
             for n in os.listdir(os.path.join(ROOT, "tools"))
             if n.startswith("torch_") and n.endswith(".py")]
    assert os.path.join(ROOT, "tools", "torch_run_all_molecules.py") in tools
    assert os.path.join(ROOT, "tools", "torch_northstar.py") in tools
    assert os.path.join(ROOT, "tools", "torch_kernel_timing.py") in tools
    assert os.path.join(ROOT, "tools", "torch_northstar_mesh.py") in tools
    for name in ("optimize_heavy_zetas", "apply_optimized_zetas", "rescue_ladder",
                 "rescue_search",
                 "zeta_sensitivity", "oracle_diffs", "grid_error_study",
                 "import_basis", "results_md", "atomic_timing"):
        assert os.path.join(ROOT, "tools", f"torch_{name}.py") in tools
    files += tools
    # the optimizer's trace helper, which chip_smoke.py imports
    files.append(os.path.join(ROOT, "tools", "optimizer_trace.py"))
    # the rank functions of the multi-rank tests (spawned ranks import it)
    files.append(os.path.join(ROOT, "tests", "torch_parallel_ranks.py"))
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            for m in _BAD.finditer(f.read()):
                bad.append((os.path.relpath(path, ROOT), m.group(0).strip()))
    assert not bad, bad


_JAX_PATH = re.compile(r"quantum_compute_dft_tpu(?!_torch)")


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                yield body[0].value


def test_port_code_names_no_jax_package_path():
    bad = []
    for base, _, names in os.walk(os.path.join(ROOT, PKG)):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(base, n)
            with open(path) as f:
                tree = ast.parse(f.read())
            docs = {id(d) for d in _docstrings(tree)}
            for node in ast.walk(tree):
                if (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and id(node) not in docs
                        and _JAX_PATH.search(node.value)):
                    bad.append((os.path.relpath(path, ROOT), node.value))
    assert not bad, bad
