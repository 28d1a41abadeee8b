"""ANSI in-place progress helpers and main-process printing.

Counterpart of fastenhancer_tpu/utils/terminal.py: the train loop's
`\\rEpoch e - Train i/n (x%)` line is rewritten in place and cleared at
the end of the epoch, on rank 0 only.
"""
from __future__ import annotations

import sys

from .. import parallel


def verbose() -> bool:
    """True on the logging process, rank 0 (`parallel`)."""
    return parallel.rank() == 0


def clear_previous_line() -> None:
    sys.stdout.write("\033[F\033[K\r")


def clear_current_line() -> None:
    sys.stdout.write("\033[2K\r")


def progress(msg: str) -> None:
    """Overwrite the current terminal line with msg (rank 0 only)."""
    if verbose():
        sys.stdout.write(f"\r\033[2K{msg}")
        sys.stdout.flush()
