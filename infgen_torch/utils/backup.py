"""Snapshot of the source tree at the start of a run (port of
infgen_tpu/utils/backup.py)."""

import fnmatch
import os
import shutil

# run outputs and build products under the repository's root
_SKIP = ("runs", "__pycache__", "backup_source", "build", "snapshot")


def backup_source(save_dir: str, repo_root: str = None,
                  patterns=("*.py", "*.yaml", "*.md")) -> str:
    """Copy the source files under `repo_root` (default the directory that
    holds infgen_torch) into <save_dir>/backup_source. Returns that
    directory."""
    repo_root = repo_root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    dst_root = os.path.join(save_dir, "backup_source")
    save_abs = os.path.abspath(save_dir)
    for dirpath, dirnames, filenames in os.walk(repo_root):
        dirnames[:] = [d for d in dirnames
                       if not d.startswith(".") and d not in _SKIP
                       and os.path.join(os.path.abspath(dirpath), d)
                       != save_abs]
        for fn in filenames:
            if any(fnmatch.fnmatch(fn, p) for p in patterns):
                src = os.path.join(dirpath, fn)
                dst = os.path.join(dst_root, os.path.relpath(src, repo_root))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(src, dst)
    return dst_root
