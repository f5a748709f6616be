"""Build/version info (reference internal/version, ldflags-injected there;
a plain module here). Also pins the init-waiter contract version the pod
runtime expects (the reference pins its initc image tag the same way,
initcontainer.go:110). Counterpart of ``grove_tpu/version.py``, with its
values: the port speaks the same contract."""

from __future__ import annotations

from dataclasses import dataclass

VERSION = "0.1.0"
INIT_WAITER_CONTRACT = "v1"  # {"podcliques": [{pclq,min_available}], "podgang"}


@dataclass(frozen=True)
class VersionInfo:
    version: str = VERSION
    init_waiter_contract: str = INIT_WAITER_CONTRACT


def get() -> VersionInfo:
    return VersionInfo()
