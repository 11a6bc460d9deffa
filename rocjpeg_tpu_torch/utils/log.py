"""Library logging — the rocjpeg_commons.h analog.

The reference's ERR macro (rocjpeg_commons.h:41) is always on and prints to
stderr; err() does the same. Its debug-only INFO macro has no caller in the
port, so it has no counterpart here.
"""

from __future__ import annotations

import sys


def err(msg: str) -> None:
    print(f"ERROR: {msg}", file=sys.stderr, flush=True)
