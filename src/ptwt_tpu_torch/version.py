"""Version metadata (reference: upstream ptwt ``src/ptwt/version.py``)."""

from __future__ import annotations

import subprocess
from pathlib import Path

VERSION = "0.1.0"

VERSION_PARTS = tuple(int(part) for part in VERSION.split("."))


def _get_git_hash() -> str:
    """Return the short git hash of the working tree, or '' outside git."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=Path(__file__).parent,
            capture_output=True,
            text=True,
            timeout=5,
        )
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


def get_version(with_git_hash: bool = False) -> str:
    """Return the package version, optionally suffixed with the git hash."""
    git_hash = _get_git_hash() if with_git_hash else ""
    return f"{VERSION}+{git_hash}" if git_hash else VERSION
