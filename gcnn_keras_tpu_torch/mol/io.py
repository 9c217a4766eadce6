"""Element symbols by atomic number and the extended-xyz comment line's
parsers; the counterpart of ``gcnn_keras_tpu/mol/io.py``'s
``PERIODIC_TABLE``, ``_parse_extxyz_comment`` and ``_parse_properties``
(its readers and writers are not ported), copied so that the port imports
nothing of the JAX package."""
from typing import Dict, List, Tuple

PERIODIC_TABLE = [
    "n", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn",
    "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb",
    "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In",
    "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm",
    "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta",
    "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At",
    "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu",
]


def _parse_extxyz_comment(comment: str) -> Dict[str, str]:
    """``key=value`` pairs of an extended-xyz comment line (values in
    double quotes may hold spaces)."""
    out = {}
    token = ""
    key = None
    in_quote = False
    for ch in comment.strip() + " ":
        if ch == '"':
            in_quote = not in_quote
        elif ch == "=" and not in_quote and key is None:
            key = token
            token = ""
        elif ch == " " and not in_quote:
            if key is not None:
                out[key] = token
                key = None
            token = ""
        else:
            token += ch
    return out


def _parse_properties(spec: str) -> List[Tuple[str, str, int]]:
    """``Properties=name:kind:width:...`` -> ``[(name, kind, width), ...]``."""
    parts = spec.split(":")
    return [(parts[k], parts[k + 1], int(parts[k + 2])) for k in range(0, len(parts), 3)]
