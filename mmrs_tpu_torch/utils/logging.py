"""Structured logging.

Replaces the reference's prints and ad-hoc file logs
(CLIP/lab3.py:13 `image_processing.log`,
CLIP/union_dataset.py:13 `combined_image_processing.log`).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
_configured = False


def get_logger(name: str, logfile: Optional[str] = None) -> logging.Logger:
    global _configured
    if not _configured:
        logging.basicConfig(level=logging.INFO, format=_FORMAT, stream=sys.stderr)
        _configured = True
    logger = logging.getLogger(name)
    # exact-path compare: endswith() let a logfile that is a SUFFIX of
    # an attached handler's path (e.g. image_processing.log vs
    # combined_image_processing.log — the two reference filenames) be
    # silently skipped
    if logfile is not None and not any(
        isinstance(h, logging.FileHandler)
        and h.baseFilename == os.path.abspath(logfile)
        for h in logger.handlers
    ):
        fh = logging.FileHandler(logfile)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger
