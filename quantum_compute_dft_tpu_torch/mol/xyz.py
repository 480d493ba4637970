"""XYZ file handling.

Reads the standard XYZ format the reference consumes: an atom-count line, a
comment line, then ``El x y z`` rows in Angstrom (behavior of
ref dft.py:97-99 + grid.py:42-47, where the two header lines are stripped
and the body is handed to PySCF).  Also accepts header-less bodies.
"""

from __future__ import annotations

from quantum_compute_dft_tpu_torch.mol.elements import normalize_symbol


def parse_xyz_text(text: str) -> list[tuple[str, tuple[float, float, float]]]:
    """Parse XYZ text -> [(symbol, (x, y, z) in Angstrom), ...].

    Tolerates a count+comment header (skipped when the first line is a lone
    integer) or a bare body of ``El x y z`` lines.
    """
    lines = [ln for ln in text.splitlines()]
    if lines and lines[0].split() and _is_int(lines[0].split()[0]) and len(lines[0].split()) == 1:
        lines = lines[2:]
    atoms = []
    for ln in lines:
        parts = ln.replace(",", " ").split()
        if not parts:
            continue
        if len(parts) < 4:
            raise ValueError(f"Malformed XYZ line: {ln!r}")
        sym = normalize_symbol(parts[0])
        xyz = tuple(float(v) for v in parts[1:4])
        atoms.append((sym, xyz))
    if not atoms:
        raise ValueError("XYZ input contains no atoms")
    return atoms


def load_xyz(path: str) -> list[tuple[str, tuple[float, float, float]]]:
    with open(path) as f:
        return parse_xyz_text(f.read())


def load_xyz_as_string(path: str) -> str:
    """Strip the two header lines, mirroring ref dft.py:97-99."""
    with open(path) as f:
        lines = f.readlines()
    return "".join(lines[2:])


def _is_int(tok: str) -> bool:
    try:
        int(tok)
        return True
    except ValueError:
        return False
