"""Seeded trend + seasonal forecaster over the time-series ring.

Counterpart of ``grove_tpu/observability/forecast.py``: per gauge series, a
float64 closed-form least-squares trend over the ``(tick, value)`` samples
of the training window, phase-binned seasonal means of its residuals, a
band of ``BAND_Z`` residual standard deviations, ``N_POINTS`` prediction
points across the horizon and their peak, and the skill against a
lag-horizon persistence baseline (fed back as ``forecast_skill/<name>``
when asked). Fewer than ``MIN_SAMPLES`` samples give a flat persistence
model; an empty window an ``n: 0`` shell. A pure function of the ring (no
wall clock, no random numbers) in numpy, the same terms in the same order
as the JAX module, so it gives the same bits. Off by default
(``GROVE_TPU_FORECAST=1`` or ``FORECASTER.enable()``).
"""

from __future__ import annotations

import os
from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

import numpy as np

from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.timeseries import TIMESERIES

# First-class forecast series (the skill feed): gauge
# `forecast_skill/<series>` holds persistence_mae - model_mae per scoring
# round — positive means the model beats the naive baseline.
SERIES_FORECAST_SKILL = "forecast_skill"

DEFAULT_PERIOD = 600.0  # seconds; matches the traffic model's diurnal
DEFAULT_HORIZON = 300.0  # seconds of look-ahead
DEFAULT_HISTORY = 1800.0  # training window (3 diurnal periods)
N_PHASE_BINS = 48  # phase bins per period (clamped to period ticks)
N_POINTS = 12  # emitted prediction points across the horizon
BAND_Z = 2.0  # confidence band half-width in residual stds
MIN_SAMPLES = 8  # below this, degrade to flat persistence


def _fit(
    ticks: List[int], vals: np.ndarray, period_ticks: int
) -> Tuple[float, float, np.ndarray, int, float]:
    """Closed-form trend + seasonal fit: returns ``(intercept, slope,
    seasonal_bins, n_bins, sigma)``. All arithmetic is float64 in a fixed
    order — the NumPy oracle reproduces it term for term."""
    x = np.asarray(ticks, dtype=np.float64)
    n = float(x.size)
    sx = float(x.sum())
    sy = float(vals.sum())
    sxx = float((x * x).sum())
    sxy = float((x * vals).sum())
    denom = n * sxx - sx * sx
    slope = (n * sxy - sx * sy) / denom if denom != 0.0 else 0.0
    intercept = (sy - slope * sx) / n
    resid = vals - (intercept + slope * x)
    n_bins = min(N_PHASE_BINS, period_ticks)
    bins = np.asarray(
        [(t % period_ticks) * n_bins // period_ticks for t in ticks],
        dtype=np.int64,
    )
    seasonal = np.zeros(n_bins, dtype=np.float64)
    for b in range(n_bins):
        mask = bins == b
        cnt = int(mask.sum())
        if cnt:
            seasonal[b] = float(resid[mask].sum()) / cnt
    adj = resid - seasonal[bins]
    sigma = float(np.sqrt((adj * adj).sum() / n))
    return intercept, slope, seasonal, n_bins, sigma


def _phase_bin(tick: int, period_ticks: int, n_bins: int) -> int:
    return (tick % period_ticks) * n_bins // period_ticks


class Forecaster:
    """Process-global (``FORECASTER``), off by default. Holds only the
    model configuration and the watched-series set; every forecast is
    recomputed from the ring on demand — no fitted state survives between
    calls, so there is nothing to drift or to invalidate."""

    def __init__(self) -> None:
        self.enabled = os.environ.get("GROVE_TPU_FORECAST", "") not in (
            "",
            "0",
            "false",
        )
        self.clock = None
        self.period = DEFAULT_PERIOD
        self.horizon = DEFAULT_HORIZON
        self.history = DEFAULT_HISTORY
        self._watched: List[str] = []

    # -- lifecycle -------------------------------------------------------

    def enable(
        self,
        clock=None,
        period: Optional[float] = None,
        horizon: Optional[float] = None,
        history: Optional[float] = None,
    ) -> "Forecaster":
        if clock is not None:
            self.clock = clock
        if period is not None:
            self.period = float(period)
        if horizon is not None:
            self.horizon = float(horizon)
        if history is not None:
            self.history = float(history)
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self._watched = []
        self.clock = None
        self.period = DEFAULT_PERIOD
        self.horizon = DEFAULT_HORIZON
        self.history = DEFAULT_HISTORY

    def watch(self, name: str) -> None:
        """Register a series for the default ``report()`` sweep."""
        if name not in self._watched:
            self._watched.append(name)

    def watched(self) -> List[str]:
        return list(self._watched)

    # -- time ------------------------------------------------------------

    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return now
        clock = self.clock if self.clock is not None else TIMESERIES.clock
        return clock.now() if clock is not None else 0.0

    # -- the forecast ----------------------------------------------------

    def forecast(
        self,
        name: str,
        horizon: Optional[float] = None,
        now: Optional[float] = None,
        feed: bool = False,
    ) -> dict:
        """One series' horizon forecast. ``feed=True`` records the skill
        verdict into the ring (the remediator's per-tick scoring call);
        read surfaces (apiserver/cli) leave the ring untouched."""
        vt = self._now(now)
        horizon_s = float(horizon if horizon is not None else self.horizon)
        res = TIMESERIES.resolution
        samples = TIMESERIES.gauge_samples(name, self.history, now=vt)
        doc: dict = {
            "series": name,
            "n": len(samples),
            "now": vt,
            "horizon_s": horizon_s,
            "period_s": self.period,
        }
        METRICS.inc("forecast_evaluations_total")
        if not samples:
            doc["model"] = "absent"
            return doc
        ticks = [t for t, _ in samples]
        vals = np.asarray([v for _, v in samples], dtype=np.float64)
        t1 = TIMESERIES.tick_of(vt)
        period_ticks = max(2, int(round(self.period / res)))
        horizon_ticks = max(1, int(round(horizon_s / res)))
        last = float(vals[-1])
        if len(samples) < MIN_SAMPLES:
            # too sparse to fit: flat persistence with a dispersion band
            mean_v = float(vals.sum()) / vals.size
            dev = vals - mean_v
            sigma = float(np.sqrt((dev * dev).sum() / vals.size))
            intercept, slope = last, 0.0
            seasonal = np.zeros(1, dtype=np.float64)
            n_bins = 1
            doc["model"] = "persistence"
            predict_from = 0.0  # slope*tick term vanishes; flat at last
        else:
            intercept, slope, seasonal, n_bins, sigma = _fit(
                ticks, vals, period_ticks
            )
            doc["model"] = "diurnal-trend"
            predict_from = 1.0
        doc.update(
            {
                "last": last,
                "slope_per_s": slope / res,
                "sigma": sigma,
            }
        )
        # prediction points across (t1, t1 + horizon]
        step = max(1, horizon_ticks // N_POINTS)
        points = []
        peak = None
        for tf in range(t1 + step, t1 + horizon_ticks + 1, step):
            if predict_from:
                mean = (
                    intercept
                    + slope * float(tf)
                    + float(seasonal[_phase_bin(tf, period_ticks, n_bins)])
                )
            else:
                mean = last
            row = {
                "at_s": tf * res,
                "mean": mean,
                "lo": mean - BAND_Z * sigma,
                "hi": mean + BAND_Z * sigma,
            }
            points.append(row)
            if peak is None or mean > peak["mean"]:
                peak = {"at_s": row["at_s"], "mean": mean}
        doc["points"] = points
        doc["peak"] = peak
        # skill: fitted MAE vs persistence lag-horizon MAE over the same
        # subset (samples with a lag-`horizon` predecessor in the window)
        if doc["model"] == "diurnal-trend":
            pairs_i = []
            pairs_j = []
            for i, t in enumerate(ticks):
                j = bisect_right(ticks, t - horizon_ticks) - 1
                if j >= 0:
                    pairs_i.append(i)
                    pairs_j.append(j)
            if pairs_i:
                xi = np.asarray(
                    [ticks[i] for i in pairs_i], dtype=np.float64
                )
                bi = np.asarray(
                    [
                        _phase_bin(ticks[i], period_ticks, n_bins)
                        for i in pairs_i
                    ],
                    dtype=np.int64,
                )
                yi = vals[np.asarray(pairs_i, dtype=np.int64)]
                yj = vals[np.asarray(pairs_j, dtype=np.int64)]
                fitted = intercept + slope * xi + seasonal[bi]
                mae = float(np.abs(yi - fitted).sum()) / yi.size
                pmae = float(np.abs(yi - yj).sum()) / yi.size
                doc["mae"] = mae
                doc["persistence_mae"] = pmae
                doc["skill"] = pmae - mae
                if feed:
                    TIMESERIES.gauge(
                        f"{SERIES_FORECAST_SKILL}/{name}",
                        doc["skill"],
                        vt=vt,
                    )
        return doc

    def report(
        self,
        names: Optional[List[str]] = None,
        horizon: Optional[float] = None,
        now: Optional[float] = None,
    ) -> dict:
        """The ``GET /debug/forecast`` document: one forecast per watched
        (or requested) series."""
        targets = names if names else self.watched()
        return {
            "enabled": self.enabled,
            "period_s": self.period,
            "horizon_s": float(
                horizon if horizon is not None else self.horizon
            ),
            "history_s": self.history,
            "forecasts": [
                self.forecast(n, horizon=horizon, now=now) for n in targets
            ],
        }


FORECASTER = Forecaster()
