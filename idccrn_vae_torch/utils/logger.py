"""File/console logger matching the reference surface
(utils/logger.py:13-37: type 1 = file handler, type 2 = stream).

The port's copy of `idccrn_vae_tpu/utils/logger.py`; loggers are named
under `idccrn_vae_torch`."""

from __future__ import annotations

import logging


def get_logger(path: str = "", logger_type: int = 2,
               name: str = "idccrn_vae_torch") -> logging.Logger:
    logger = logging.getLogger(name if logger_type == 2 else f"{name}:{path}")
    logger.setLevel(logging.INFO)
    if logger.handlers:
        return logger
    fmt = logging.Formatter(
        "%(asctime)s - %(levelname)s - %(message)s", "%Y-%m-%d %H:%M:%S"
    )
    if logger_type == 1:
        handler: logging.Handler = logging.FileHandler(path)
    else:
        handler = logging.StreamHandler()
    handler.setFormatter(fmt)
    logger.addHandler(handler)
    logger.propagate = False
    return logger
