"""ANSI in-place progress helpers and main-process printing.

Counterpart of fastenhancer_tpu/utils/terminal.py for one process: the
train loop's `\\rEpoch e - Train i/n (x%)` line is rewritten in place and
cleared at the end of the epoch.
"""
from __future__ import annotations

import sys


def verbose() -> bool:
    """True on the logging process (one process: always)."""
    return True


def clear_current_line() -> None:
    sys.stdout.write("\033[2K\r")
