"""Device selection, device health and numeric mode for the PyTorch port.

Counterpart of ``grove_tpu/utils/platform.py``. The JAX module probes an
accelerator and falls back to the CPU; the port never falls back: an entry
point called without a device runs on the card or raises.

- ``resolve_device``: the device of an entry point (``cuda`` unless the
  caller asks for another, and raise without CUDA).
- ``check_platform_available``, ``probe_device_health``,
  ``last_probe_detail``, ``ensure_healthy_backend``: the card's health. The
  probe runs a trivial CUDA product in a detached child process; on timeout
  the child is killed and abandoned (a child wedged in device init may
  ignore SIGKILL). ``ensure_healthy_backend`` raises when the card is
  unhealthy, so ``force_cpu_platform`` (the JAX module's re-pin onto the
  CPU) has no counterpart here.
- ``host_machine_fingerprint`` and ``cpu_subprocess_env``: the host's CPU
  feature hash and the environment of a child that must stay off the card.
  The JAX module's ``enable_compile_cache`` maps to the kernel build
  directory of ``ops/_build.py``.
- ``strict_fp32`` and ``card_info``.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, Optional, Tuple, Union

import torch

# Diagnostics of the most recent probe_device_health call: the verdict,
# the reason, the child's output tail and whether a retry can help.
_last_probe: Optional[dict] = None

# the note of a healthy probe, memoized per process
_backend_note: Optional[str] = None

# the probe child: a trivial CUDA product, read back; "OK cpu" where CUDA is
# absent, so a caller that requires the card can tell the two apart
_PROBE_CODE = (
    "import torch\n"
    "dev = 'cuda' if torch.cuda.is_available() else 'cpu'\n"
    "x = torch.ones((128, 128), device=dev)\n"
    "y = float((x @ x).sum().item())\n"
    "print('OK', dev, torch.cuda.get_device_name(0) if dev == 'cuda' else '')\n"
)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``. Raises ``RuntimeError`` when no device is given and CUDA is
    absent — the caller must ask for the CPU explicitly (as the tests do)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain"
            " PyTorch path on the CPU"
        )
    return torch.device("cuda")


def last_probe_detail() -> Optional[dict]:
    """Diagnostics of the most recent probe (None before any probe)."""
    return _last_probe


def check_platform_available(env: Optional[dict] = None) -> Optional[str]:
    """Fast precheck: can a CUDA device appear at all? Returns None when it
    can, else the reason. A torch built without CUDA, or a
    ``CUDA_VISIBLE_DEVICES`` that hides every device, is a deterministic
    configuration error: probing again can never help. Initializes no
    device (the JAX module runs its plugin discovery in a child; a torch
    build and an environment variable need none)."""
    if not torch.backends.cuda.is_built():
        return (
            f"torch {torch.__version__} was built without CUDA; no card can come"
            " up in this installation"
        )
    visible = (env if env is not None else os.environ).get("CUDA_VISIBLE_DEVICES")
    if visible is not None and visible.strip() in ("", "-1"):
        return (
            f"CUDA_VISIBLE_DEVICES={visible!r} hides every device; fix the"
            " environment instead of retrying the probe"
        )
    return None


def probe_device_health(
    timeout_s: float = 60.0,
    env: Optional[dict] = None,
    require_accelerator: bool = False,
    precheck: bool = True,
) -> bool:
    """Run a trivial CUDA product in a detached child process. On timeout the
    child is killed and abandoned: a child wedged in uninterruptible device
    sleep ignores SIGKILL, and waiting on it would hang the caller.

    ``env``: the child's environment (default: this process's).
    ``require_accelerator`` also rejects a child that ran on the CPU.
    Every call records its verdict, reason, the child's output tail and
    ``retryable`` (False for a deterministic configuration error) in
    :func:`last_probe_detail`."""
    import pathlib
    import sys
    import tempfile
    import time

    def _record(ok: bool, reason: str, output: str = "", retryable: bool = True) -> bool:
        global _last_probe
        tail = output.strip()
        if len(tail) > 2000:
            tail = "...(truncated)...\n" + tail[-2000:]
        _last_probe = {
            "ok": ok,
            "reason": reason,
            "output_tail": tail,
            "require_accelerator": require_accelerator,
            "retryable": retryable,
        }
        return ok

    if precheck:
        unavailable = check_platform_available(env)
        if unavailable is not None:
            return _record(False, unavailable, retryable=False)

    out = tempfile.NamedTemporaryFile(mode="w+", delete=False)
    out_path = out.name
    proc = subprocess.Popen(
        [sys.executable, "-c", _PROBE_CODE],
        stdout=out,
        stderr=subprocess.STDOUT,
        cwd=pathlib.Path(__file__).resolve().parents[2],
        start_new_session=True,
        env=env,
    )
    try:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if proc.poll() is not None:
                break
            time.sleep(0.2)
        else:
            proc.kill()
            # read what the abandoned child managed to write: a wedged init
            # usually logged where first
            partial = ""
            try:
                out.seek(0)
                partial = out.read()
            except OSError:
                pass
            return _record(
                False,
                f"probe child hung past {timeout_s:.0f}s (killed and abandoned:"
                " the card wedged in device init?)",
                partial,
            )
        out.seek(0)
        text = out.read()
        if proc.returncode != 0 or "OK" not in text:
            return _record(
                False,
                f"probe child exited rc={proc.returncode} without OK (CUDA failed"
                " during import or the product; see output_tail)",
                text,
            )
        if require_accelerator and "OK cpu" in text:
            return _record(
                False,
                "probe succeeded but on the CPU: no CUDA device is available"
                " (see output_tail)",
                text,
            )
        return _record(True, "", text)
    finally:
        out.close()
        if proc.poll() is not None:  # unlink only once the child is gone
            try:
                os.unlink(out_path)
            except OSError:
                pass


def ensure_healthy_backend(
    timeout_s: float = 60.0, retries: int = 1, retry_wait_s: float = 0.0
) -> str:
    """Probe the card, up to ``retries`` times with ``retry_wait_s`` between
    attempts (a deterministic configuration error stops at once). Returns
    ``"default"`` once the card answered; that answer is memoized per
    process. Raises ``RuntimeError`` with the probe's reason when the card
    is unhealthy: the port never falls back to the CPU."""
    global _backend_note
    if _backend_note is None:
        import time as _time

        for attempt in range(max(retries, 1)):
            if attempt and retry_wait_s:
                _time.sleep(retry_wait_s)
            if probe_device_health(timeout_s, require_accelerator=True):
                _backend_note = "default"
                break
            if not (last_probe_detail() or {}).get("retryable", True):
                break
        if _backend_note is None:
            detail = last_probe_detail() or {}
            tail = detail.get("output_tail")
            raise RuntimeError(
                "the CUDA device is not healthy: "
                f"{detail.get('reason', 'probe failed')}"
                + (f"\nprobe child output tail:\n{tail}" if tail else "")
            )
    return _backend_note


def host_machine_fingerprint() -> str:
    """Stable fingerprint of the host's CPU feature set (the md5 of the
    first ``flags`` line of ``/proc/cpuinfo``, else of the machine and
    processor names), as the JAX module computes it."""
    import hashlib

    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags") or line.startswith("Features"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    if not flags:
        import platform as _platform

        flags = f"{_platform.machine()}|{_platform.processor()}"
    return hashlib.md5(flags.encode()).hexdigest()[:8]


def cpu_subprocess_env() -> Dict[str, str]:
    """The environment of a child process that must run on the CPU: every
    CUDA device hidden. The JAX module's ``n_devices`` (virtual XLA CPU
    devices) has no counterpart: a torch child sees one CPU, and the port's
    ranks are processes (``parallel/multihost.py``)."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def strict_fp32() -> None:
    """Turn TF32 off for float32 matrix products and convolutions. The
    solver's commit product multiplies integer-valued counts by demands and
    must be exact; TF32 keeps only 10 mantissa bits. cuDNN's flag defaults
    to True."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_info() -> Tuple[str, str]:
    """(name, power limit) of card 0, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them. Raises when
    ``nvidia-smi`` is missing or fails."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        check=True,
        capture_output=True,
        text=True,
        timeout=30,
    ).stdout
    first = out.strip().splitlines()[0]
    name, _, limit = first.rpartition(",")
    return name.strip(), limit.strip()
