"""Element data: symbols, atomic numbers, Bragg-Slater radii.

Covers every element appearing in the reference molecule set
(SURVEY.md section 2.3): H, He, C, N, O, F, Na, Si, P, S, Cl, Ca, Cu,
As, Se, Br, Mo, I -- plus the rest of periods 1-5 so arbitrary XYZ input
works.
"""

SYMBOLS = [
    "X",  # ghost
    "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe",
]

Z_OF = {s: z for z, s in enumerate(SYMBOLS)}
# Case-insensitive lookup (XYZ files sometimes use lowercase).
Z_OF.update({s.upper(): z for z, s in enumerate(SYMBOLS)})
Z_OF.update({s.lower(): z for z, s in enumerate(SYMBOLS)})

# Bragg-Slater atomic radii in Angstrom (J. C. Slater, JCP 41, 3199 (1964)),
# used for the Becke-partition atomic size adjustment and radial grid scaling.
# H is conventionally bumped to 0.35 A in quadrature codes.
BRAGG_ANGSTROM = {
    "H": 0.35, "He": 1.40,
    "Li": 1.45, "Be": 1.05, "B": 0.85, "C": 0.70, "N": 0.65, "O": 0.60,
    "F": 0.50, "Ne": 1.50,
    "Na": 1.80, "Mg": 1.50, "Al": 1.25, "Si": 1.10, "P": 1.00, "S": 1.00,
    "Cl": 1.00, "Ar": 1.88,
    "K": 2.20, "Ca": 1.80, "Sc": 1.60, "Ti": 1.40, "V": 1.35, "Cr": 1.40,
    "Mn": 1.40, "Fe": 1.40, "Co": 1.35, "Ni": 1.35, "Cu": 1.35, "Zn": 1.35,
    "Ga": 1.30, "Ge": 1.25, "As": 1.15, "Se": 1.15, "Br": 1.15, "Kr": 2.02,
    "Rb": 2.35, "Sr": 2.00, "Y": 1.80, "Zr": 1.55, "Nb": 1.45, "Mo": 1.45,
    "Tc": 1.35, "Ru": 1.30, "Rh": 1.35, "Pd": 1.40, "Ag": 1.60, "Cd": 1.55,
    "In": 1.55, "Sn": 1.45, "Sb": 1.45, "Te": 1.40, "I": 1.40, "Xe": 2.16,
}

ANGSTROM_TO_BOHR = 1.0 / 0.52917721092  # CODATA 2010, matches PySCF's value


def bragg_bohr(symbol: str) -> float:
    return BRAGG_ANGSTROM[normalize_symbol(symbol)] * ANGSTROM_TO_BOHR


def normalize_symbol(symbol: str) -> str:
    s = symbol.strip()
    s = s[0].upper() + s[1:].lower() if len(s) > 1 else s.upper()
    if s not in Z_OF:
        raise KeyError(f"Unknown element symbol: {symbol!r}")
    return s
