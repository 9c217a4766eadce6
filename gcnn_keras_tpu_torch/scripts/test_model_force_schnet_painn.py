"""The golden-IO check of a trained SchNet or PAiNN force model;
counterpart of the root ``test_model_force_schnet_painn.py``.

    python -m gcnn_keras_tpu_torch.scripts.test_model_force_schnet_painn
        --checkpoint DIR [--device cpu] [--script force_schnet|force_painn]
        [--inputs 'input_*.txt'] [--golden output.json] [--cutoff 5.0]
        [--record] [--atol 1e-4] [--conf C.json]

``test_model_force_hdnnp``'s input files, checkpoint, record and check,
without angle triples and with the neighbours within ``--cutoff``.
"""
from __future__ import annotations

import sys
from typing import List, Optional

from gcnn_keras_tpu_torch.scripts.test_model_force_hdnnp import parser, run


def main(argv: Optional[List[str]] = None) -> dict:
    ap = parser("force_schnet", scripts=["force_schnet", "force_painn"])
    ap.add_argument("--cutoff", type=float, default=5.0)
    args = ap.parse_args(argv)
    return run(args, cutoff=args.cutoff, need_angles=False)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
