"""Tagged run logging and byte formatting.

Counterpart: ``adi_thermal_fields_tpu/io/logging.py::log`` and
``::fmt_bytes`` (copies).
"""
from __future__ import annotations

import sys

__all__ = ["log", "fmt_bytes"]


def log(msg: str, *, tag: str | None = None, file=None) -> None:
    prefix = f"[{tag}] " if tag else ""
    print(prefix + msg, flush=True, file=file or sys.stdout)


def fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} PiB"
