"""Time the fill kernel (grove_tpu_torch/csrc/fill.cu) over launch shapes.

For each case — the synthetic chunk of ``chip_smoke.py`` (C=32, P=3,
N=5,120, R=2, shared free, 50 % mask), the fill calls of one chunk-wave of
the main path (``chip_smoke.path_fill_cases``) and a near-empty fill (every
count 0, 4 nodes) — and each launch shape (cluster size K, threads per
CTA), prints one JSON line: the median device time of one call between
CUDA events (``chip_smoke._median_ms``) and the mean kernel duration that
``torch.profiler`` records over 50 back-to-back launches. Every shape's
results are checked bit for bit against the plain version first.

    python3 scripts/fill_sweep.py [--out build/fill_sweep.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from grove_tpu_torch.ops import fill as fill_mod  # noqa: E402
from grove_tpu_torch.utils.platform import card_info  # noqa: E402


def _profiled_us(fn, reps=50):
    """Mean duration of the fill kernel over `reps` back-to-back calls, from
    the profiler's device events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durations = [e.time_range.elapsed_us() for e in prof.events()
                 if "fill_kernel" in e.name and str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sum(durations) / len(durations) if durations else None


def _cases():
    rng = np.random.default_rng(0)
    cases = [("synthetic", chip_smoke._fill_inputs(rng, 32, 3, 5120, 2, True, 0.5),
              {"with_free_after": True})]
    cases += chip_smoke.path_fill_cases()
    empty = chip_smoke._fill_inputs(rng, 32, 3, 4, 2, True, 0.5)
    empty[3].zero_()
    cases.append(("empty", empty, {"with_free_after": True}))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/fill_sweep.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = ", ".join(card_info())
    print(card, flush=True)
    auto = fill_mod._launch_shape
    rows = []
    for name, fargs, kw in _cases():
        c, p, r = fargs[2].shape
        n = fargs[1].shape[-1]
        want = fill_mod.fill_batch_ref(*fargs, **kw)
        shapes = {auto(c, p, n, r)[:2]}
        shapes |= {(k, t) for k in (2, 4, 8) for t in (128, 160, 192, 256, 320, 512)}
        for k, threads in sorted(shapes):
            per_cta = -(-n // k)
            slice_ = -(-per_cta // 4) * 4
            if slice_ > fill_mod._MAX_RUN * threads:
                continue  # more nodes per thread than the kernel is built for
            shape = (k, threads, slice_, None)
            fill_mod._launch_shape = lambda *a, shape=shape: shape
            try:
                got = fill_mod.fill_batch(*fargs, **kw)
                torch.cuda.synchronize()
                chip_smoke._check_equal(f"{name} K={k} threads={threads}", got, want)
                ms = chip_smoke._median_ms(lambda: fill_mod.fill_batch(*fargs, **kw))
                prof_us = _profiled_us(lambda: fill_mod.fill_batch(*fargs, **kw))
            finally:
                fill_mod._launch_shape = auto
            row = {"case": name, "C": c, "P": p, "N": n, "R": r, "K": k, "threads": threads,
                   "auto": (k, threads) == auto(c, p, n, r)[:2], "event_us": ms * 1e3,
                   "profiled_us": prof_us, "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        for row in rows:
            fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
