"""Import STO-3G basis data from an NWChem-format .dat file into the port.

    python tools/torch_import_basis.py BASIS.dat [--write OUT.py]

The port of tools/import_basis.py.  Parses NWChem-format basis blocks (the
format Basis-Set-Exchange distributes) and reports, per element, the
largest relative exponent deviation and the largest coefficient deviation
from the port's tables (quantum_compute_dft_tpu_torch/basis/data.py).
With --write OUT.py it writes a module holding the parsed per-element
shell tables; saved as quantum_compute_dft_tpu_torch/basis/sto3g_override.py
it is preferred by the port's basis/data.py over its generated tables.
The output path is explicit: nothing is written into a package unless
asked.  format_nwchem writes the port's own tables in the same format.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse_nwchem(text: str):
    """-> {element: [(shell_letter, [(exp, c1[, c2]) ...]), ...]}"""
    out: dict[str, list] = {}
    cur = None
    for raw in text.splitlines():
        line = raw.split("#")[0].strip()
        if not line or line.upper().startswith(("BASIS", "END")):
            continue
        parts = line.split()
        if parts[0][0].isalpha():
            el, shell = parts[0], parts[1].upper()
            el = el[0].upper() + el[1:].lower()
            out.setdefault(el, []).append((shell, []))
            cur = out[el][-1][1]
        else:
            if cur is None:
                raise ValueError(f"primitive row before shell header: {line!r}")
            cur.append(tuple(float(x.replace("D", "E").replace("d", "e"))
                             for x in parts))
    return out


def to_shell_table(parsed):
    """-> {element: [(l, alphas, coeffs), ...]} splitting SP/SPD shells."""
    lmap = {"S": 0, "P": 1, "D": 2, "F": 3, "G": 4}
    out = {}
    for el, shells in parsed.items():
        rows = []
        for shell, prims in shells:
            exps = [p[0] for p in prims]
            if shell in lmap:
                rows.append((lmap[shell], tuple(exps),
                             tuple(p[1] for p in prims)))
            else:  # SP, SPD composite shells share exponents
                for k, letter in enumerate(shell):
                    rows.append((lmap[letter], tuple(exps),
                                 tuple(p[1 + k] for p in prims)))
        out[el] = rows
    return out


def format_nwchem(symbols) -> str:
    """The port's STO-3G tables for `symbols` as an NWChem .dat text (sp
    shells as SP blocks, full double precision)."""
    from quantum_compute_dft_tpu_torch.basis.data import element_shells

    lines = ["BASIS \"ao basis\" PRINT"]
    for el in symbols:
        rows = element_shells(el)
        i = 0
        while i < len(rows):
            name, l, a, c = rows[i]
            cols = [c]
            if (i + 1 < len(rows) and rows[i + 1][0] == name
                    and rows[i + 1][1] == l + 1 == 1):
                cols.append(rows[i + 1][3])
                i += 1
            lines.append(f"{el} {'SP' if len(cols) == 2 else 'SPD'[l]}")
            for k, x in enumerate(a):
                lines.append("  " + "  ".join(repr(float(v)) for v in
                                              (x, *(cc[k] for cc in cols))))
            i += 1
    lines.append("END")
    return "\n".join(lines) + "\n"


def diff(table) -> dict:
    """Per element: (max relative exponent deviation, max absolute
    coefficient deviation) against the port's tables, or a message."""
    from quantum_compute_dft_tpu_torch.basis.data import element_shells

    out = {}
    for el, rows in sorted(table.items()):
        try:
            ours = element_shells(el)
        except Exception:
            out[el] = "not in the port's tables"
            continue
        if len(ours) != len(rows):
            out[el] = f"shell count differs ({len(ours)} vs {len(rows)})"
            continue
        we = wc = 0.0
        for (_, l, a, c), (l2, a2, c2) in zip(ours, rows):
            if l != l2 or len(a) != len(a2):
                out[el] = f"shell layout differs (l {l} vs {l2})"
                break
            we = max(we, max(abs(x - y) / abs(y) for x, y in zip(a, a2)))
            wc = max(wc, max(abs(x - y) for x, y in zip(c, c2)))
        else:
            out[el] = (we, wc)
    return out


def write_override(table, path: str):
    with open(path, "w") as f:
        f.write('"""STO-3G tables imported by tools/torch_import_basis.py; '
                'preferred over data.py."""\n\n')
        f.write(f"SHELLS = {table!r}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("datfile")
    ap.add_argument("--write", metavar="OUT.py", default=None,
                    help="write the parsed tables as a sto3g_override module")
    args = ap.parse_args(argv)

    with open(args.datfile) as f:
        table = to_shell_table(parse_nwchem(f.read()))
    print(f"parsed {len(table)} elements")
    for el, d in diff(table).items():
        if isinstance(d, str):
            print(f"  {el}: {d}")
        else:
            print(f"  {el}: max rel exponent deviation {d[0]:.2e}, "
                  f"max coefficient deviation {d[1]:.2e}")
    if args.write:
        write_override(table, args.write)
        print(f"wrote {args.write}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
