"""Small tools; counterpart of ``gcnn_keras_tpu/utils/tools.py``."""
from __future__ import annotations

import subprocess


def get_git_hash(path: str = ".") -> str:
    """The commit checked out at ``path``, or ``"unknown"`` outside a git
    repository."""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=path,
            stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return "unknown"
