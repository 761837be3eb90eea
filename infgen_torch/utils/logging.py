"""Process-aware logging (port of infgen_tpu/utils/logging.py): messages
carry the process's rank in a torch.distributed group (0 without one);
other ranks log warnings only unless asked."""

import logging
import os
import sys
from typing import Optional

import torch.distributed as dist


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def get_logger(name: str = "infgen_torch", log_file: Optional[str] = None,
               rank_zero_only: bool = True) -> logging.Logger:
    """The logger `name` of this rank, writing to stderr and, when given,
    to `log_file` (a file is added once per path)."""
    rank = _rank()
    logger = logging.getLogger(f"{name}.r{rank}")
    fmt = logging.Formatter(
        f"%(asctime)s [rank {rank}] %(levelname)s %(message)s", "%H:%M:%S")
    if not logger.handlers:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.setLevel(logging.INFO)
        if rank_zero_only and rank != 0:
            logger.setLevel(logging.WARNING)
    if log_file and not any(
            getattr(h, "baseFilename", None) == os.path.abspath(log_file)
            for h in logger.handlers):
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def close_log_file(logger: logging.Logger, log_file: Optional[str]):
    """Remove and close the handler that get_logger added for `log_file`,
    so that a later run in the same process writes to its own file only."""
    path = os.path.abspath(log_file) if log_file else None
    for h in list(logger.handlers):
        if path and getattr(h, "baseFilename", None) == path:
            logger.removeHandler(h)
            h.close()


def maybe_wandb_init(project: str, config: dict):
    """A wandb run when the `wandb` package is installed and its init
    succeeds (offline unless WANDB_MODE says otherwise: a training machine
    may have no network), else None."""
    try:
        import wandb
        return wandb.init(project=project, config=config,
                          mode=os.environ.get("WANDB_MODE", "offline"))
    except Exception:
        return None
