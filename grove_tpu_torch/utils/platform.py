"""Device selection and numeric mode for the PyTorch port.

Counterpart of ``grove_tpu/utils/platform.py``. The JAX module probes an
accelerator and falls back to the CPU; the port never falls back: an entry
point called without a device runs on the card or raises.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple, Union

import torch


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
