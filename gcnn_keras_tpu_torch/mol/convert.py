"""Batch molecule conversion; counterpart of ``gcnn_keras_tpu/mol/convert.py``
(kgcnn's ``MolConverter``).

SMILES become mol blocks through RDKit (``graph_rdkit.py``) or OpenBabel
(``graph_babel.py``) on a process pool (conformer generation is CPU-bound),
or through an external conformer program (balloon-style, run as a
subprocess) on a thread pool. The process pool starts its workers with
``spawn``: a forked child of a process that runs torch's threads may hang.
"""
from __future__ import annotations

import logging
import multiprocessing
import subprocess
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import List, Optional

logger = logging.getLogger(__name__)


def _convert_one(smiles: str, backend: str, sanitize: bool,
                 add_hydrogen: bool, make_conformers: bool,
                 optimize_conformer: bool) -> Optional[str]:
    """One SMILES to a mol block (None where the backend fails); at module
    level so that the process pool can pickle it."""
    if backend == "openbabel":
        from .graph_babel import MolecularGraphOpenBabel as Graph
    else:
        from .graph_rdkit import MolecularGraphRDKit as Graph
    mg = Graph().from_smiles(smiles, sanitize=sanitize, add_hydrogen=add_hydrogen,
                             make_conformers=make_conformers,
                             optimize_conformer=optimize_conformer)
    return mg.to_mol_block() if mg.mol is not None else None


class MolConverter:
    def __init__(self, num_workers: int = 4, external_program: Optional[dict] = None,
                 sanitize: bool = True, add_hydrogen: bool = True,
                 make_conformers: bool = True, optimize_conformer: bool = True,
                 backend: str = "rdkit", pool: str = "process"):
        self.num_workers = num_workers
        self.external_program = external_program
        self.sanitize = sanitize
        self.add_hydrogen = add_hydrogen
        self.make_conformers = make_conformers
        self.optimize_conformer = optimize_conformer
        self.backend = backend
        self.pool = pool

    def _one(self, smiles: str) -> Optional[str]:
        if self.external_program:
            return self._external(smiles)
        return _convert_one(smiles, self.backend, self.sanitize, self.add_hydrogen,
                            self.make_conformers, self.optimize_conformer)

    def _external(self, smiles: str) -> Optional[str]:
        """The external program's standard output for ``smiles``, the last
        argument of ``[class_name, *config["args"]]``; None where it fails
        or outlasts ``timeout`` (60 s)."""
        cfg = self.external_program
        cmd = [cfg["class_name"]] + list(cfg.get("config", {}).get("args", []))
        try:
            out = subprocess.run(cmd + [smiles], capture_output=True,
                                 timeout=cfg.get("timeout", 60), check=True)
            return out.stdout.decode()
        except (OSError, subprocess.SubprocessError, UnicodeDecodeError) as e:
            logger.warning("external converter failed for %s: %s", smiles, e)
            return None

    def smile_to_mol(self, smiles_list: List[str]) -> List[Optional[str]]:
        """A mol block (or None) for each SMILES, in order."""
        if self.num_workers <= 1 or len(smiles_list) < 2:
            return [self._one(s) for s in smiles_list]
        if self.pool == "process" and not self.external_program:
            args = [(s, self.backend, self.sanitize, self.add_hydrogen,
                     self.make_conformers, self.optimize_conformer) for s in smiles_list]
            with ProcessPoolExecutor(max_workers=self.num_workers,
                                     mp_context=multiprocessing.get_context("spawn")) as ex:
                return list(ex.map(_convert_one, *zip(*args)))
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            return list(ex.map(self._one, smiles_list))

    def smile_to_sdf(self, smiles_list: List[str], output_file: str) -> str:
        """Write the converted molecules to ``output_file`` as an SDF, each
        block followed by ``$$$$``; failures are left out."""
        blocks = self.smile_to_mol(smiles_list)
        with open(output_file, "w") as f:
            for b in blocks:
                if b:
                    f.write(b + "\n$$$$\n")
        return output_file
