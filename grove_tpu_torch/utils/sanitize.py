"""The runtime sanitizer switch.

Counterpart of ``grove_tpu/analysis/sanitize.py``'s ``enabled``, the one part
of that module the port reads: with ``GROVE_TPU_SANITIZE`` set, the delta
state audits its free-capacity rows against a full recount every tick.
"""

from __future__ import annotations

import os


def enabled() -> bool:
    """True when the process runs in sanitizer mode."""
    return os.environ.get("GROVE_TPU_SANITIZE", "").lower() not in (
        "",
        "0",
        "false",
    )
