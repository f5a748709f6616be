"""The host block of a measurement artifact.

Counterpart of ``grove_tpu/observability/hostinfo.py``: the facts a
host-side number depends on, stamped beside it: logical CPUs, the cgroup
CPU quota in force (v2 ``cpu.max``, else v1 ``cfs_quota_us`` /
``cfs_period_us``), the Python version, whether the build is
free-threading, and optionally the control-plane executor backend.
"""

from __future__ import annotations

import os
import sys
from typing import Optional


def _cgroup_cpu_quota() -> Optional[float]:
    """Effective CPU limit in cores from the cgroup, None when unlimited
    or unreadable. Reads v2 first (`cpu.max`: "<quota> <period>" or
    "max <period>"), then the v1 cfs pair."""
    try:
        with open("/sys/fs/cgroup/cpu.max", "r", encoding="ascii") as fh:
            quota_s, period_s = fh.read().split()
        if quota_s == "max":
            return None
        return round(int(quota_s) / int(period_s), 3)
    except (OSError, ValueError):
        pass
    try:
        with open(
            "/sys/fs/cgroup/cpu/cpu.cfs_quota_us", "r", encoding="ascii"
        ) as fh:
            quota = int(fh.read().strip())
        if quota <= 0:
            return None
        with open(
            "/sys/fs/cgroup/cpu/cpu.cfs_period_us", "r", encoding="ascii"
        ) as fh:
            period = int(fh.read().strip())
        return round(quota / period, 3)
    except (OSError, ValueError):
        return None


def host_block(backend: Optional[str] = None) -> dict:
    """The artifact ``"host"`` block. ``backend`` names the control-plane
    executor that produced the surrounding numbers ("serial", "thread",
    "process") when the caller knows it; omitted otherwise."""
    block = {
        "nproc": os.cpu_count(),
        "cgroup_cpu_quota": _cgroup_cpu_quota(),
        "python": sys.version.split()[0],
        # free-threading builds report GIL absence here; GIL builds (and
        # pythons predating the flag) report False — the honesty flag for
        # every thread-backend scaling claim
        "free_threading": not getattr(sys, "_is_gil_enabled", lambda: True)(),
    }
    if backend is not None:
        block["backend"] = backend
    return block
