"""Structured logging for the port (one stderr handler on the package root)."""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def get_logger(name: str = "mcpt_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("MCPT_TORCH_LOGLEVEL", "INFO").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s",
                              datefmt="%H:%M:%S")
        )
        root = logging.getLogger("montecarlopathtracing_torch")
        root.addHandler(handler)
        root.setLevel(level)
        _CONFIGURED = True
    return logging.getLogger(name)
