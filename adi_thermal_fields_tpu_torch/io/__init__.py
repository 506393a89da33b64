"""Host I/O helpers."""
from .logging import fmt_bytes, log

__all__ = ["log", "fmt_bytes"]
