"""Dual-sink logger: console + rotating file + optional GUI/callback tee.

Parity with reference `core/utils/logger.py:20-122` (console +
RotatingFileHandler 2 MB x 3 backups, `log_info/warning/error/debug` compat
API, `set_gui_callback` mirroring every record into a UI callback).
"""
from __future__ import annotations

import logging
import os
from logging.handlers import RotatingFileHandler
from typing import Callable, Optional


class Logger:
    _MAX_BYTES = 2 * 1024 * 1024
    _BACKUPS = 3

    def __init__(self, name: str = "synt_isic_tpu_torch", log_dir: Optional[str] = None,
                 level: int = logging.INFO, console: bool = True):
        self._logger = logging.getLogger(name)
        self._logger.setLevel(level)
        self._logger.propagate = False
        self._callback: Optional[Callable[[str, str], None]] = None

        fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        if console and not any(isinstance(h, logging.StreamHandler)
                               and not isinstance(h, RotatingFileHandler)
                               for h in self._logger.handlers):
            sh = logging.StreamHandler()
            sh.setFormatter(fmt)
            self._logger.addHandler(sh)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"{name}.log")
            if not any(isinstance(h, RotatingFileHandler) and getattr(h, "baseFilename", None) == os.path.abspath(path)
                       for h in self._logger.handlers):
                fh = RotatingFileHandler(path, maxBytes=self._MAX_BYTES,
                                         backupCount=self._BACKUPS, encoding="utf-8")
                fh.setFormatter(fmt)
                self._logger.addHandler(fh)

    # -- compat API (reference logger.py:67-77) --------------------------------
    def log_info(self, msg: str) -> None:
        self._emit("info", msg)

    def log_warning(self, msg: str) -> None:
        self._emit("warning", msg)

    def log_error(self, msg: str) -> None:
        self._emit("error", msg)

    def log_debug(self, msg: str) -> None:
        self._emit("debug", msg)

    # -- GUI / callback tee (reference logger.py:80-94) -------------------------
    def set_gui_callback(self, callback: Callable[[str, str], None]) -> None:
        """callback(message, level) is invoked for every record."""
        self._callback = callback

    def _emit(self, level: str, msg: str) -> None:
        getattr(self._logger, level)(msg)
        if self._callback is not None:
            try:
                self._callback(msg, level)
            except Exception:
                pass  # a broken UI callback must never kill the pipeline
