"""The runtime sanitizer switches.

Counterpart of ``grove_tpu/analysis/sanitize.py``'s ``enabled`` and
``store_guard_enabled``, the parts of that module the port reads: with
``GROVE_TPU_SANITIZE`` set, the delta state audits its free-capacity rows
against a full recount every tick; with ``GROVE_TPU_STORE_GUARD`` (or the
sanitizer) set, the store keeps a canonical blob of every commit and the
harness checks at the end of each converge that no reader mutated a
read-only view.
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


def store_guard_enabled() -> bool:
    """The store's byte-compare write guard: ``GROVE_TPU_STORE_GUARD``, or
    sanitizer mode (the sanitizer generalizes the guard)."""
    if os.environ.get("GROVE_TPU_STORE_GUARD", "").lower() not in (
        "",
        "0",
        "false",
    ):
        return True
    return enabled()
