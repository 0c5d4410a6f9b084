"""Process logging: counterpart of ``projectiontrainer_tpu/utils/logging.py:setup_logging``."""

from __future__ import annotations

import logging
import os


def setup_logging(name: str = "projectiontrainer_tpu_torch") -> logging.Logger:
    """INFO on rank 0, WARNING elsewhere (rank from the ``RANK`` environment
    variable torchrun sets; a single process is rank 0)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO if int(os.environ.get("RANK", "0")) == 0 else logging.WARNING)
    return logger
