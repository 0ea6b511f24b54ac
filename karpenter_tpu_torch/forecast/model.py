"""Pluggable demand forecasters: EWMA baseline + Holt-Winters seasonal.

A copy of the JAX package's `forecast/model.py`: the same numpy arithmetic
in the same order, so the same series gives a bit-equal envelope.

Each forecaster maps a concurrency series (from `series.DemandSeries`) to
a `ForecastEnvelope`: per-step mean plus upper/lower confidence bands.
Pure NumPy, deterministic given the input — same series, same envelope,
byte for byte.  The band grows as sqrt(h) with the forecast step, the
standard random-walk widening, and is clamped at zero (demand counts
cannot go negative).

Holt-Winters needs at least two full seasons to estimate its seasonal
components; until then it degrades gracefully to Holt's linear method
(level + trend), which is what actually predicts a diurnal ramp-up during
the first simulated day — the trend term sees the climb coming before the
seasonal term has any history at all.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class ForecastEnvelope:
    """Per-step demand forecast: `mean[h]`, `upper[h]`, `lower[h]` for
    h = 1..steps ahead of the last observation."""
    mean: np.ndarray
    upper: np.ndarray
    lower: np.ndarray

    @property
    def steps(self) -> int:
        return len(self.mean)


def _envelope(mean: np.ndarray, sigma: float, z: float) -> ForecastEnvelope:
    h = np.arange(1, len(mean) + 1, dtype=np.float64)
    band = z * sigma * np.sqrt(h)
    mean = np.maximum(mean, 0.0)
    return ForecastEnvelope(mean=mean,
                            upper=np.maximum(mean + band, 0.0),
                            lower=np.maximum(mean - band, 0.0))


class EWMAForecaster:
    """Exponentially-weighted level with an EW residual variance: the flat
    baseline.  Forecast mean is the level at every step; the band comes
    from the smoothed one-step residual."""

    name = "ewma"

    def __init__(self, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)

    def forecast(self, values: np.ndarray, steps: int,
                 z: float = 1.64) -> ForecastEnvelope:
        values = np.asarray(values, dtype=np.float64)
        if len(values) == 0:
            zero = np.zeros(steps, dtype=np.float64)
            return ForecastEnvelope(zero, zero.copy(), zero.copy())
        level = float(values[0])
        var = 0.0
        a = self.alpha
        for v in values[1:]:
            resid = float(v) - level
            var = (1.0 - a) * var + a * resid * resid
            level = (1.0 - a) * level + a * float(v)
        mean = np.full(steps, level, dtype=np.float64)
        return _envelope(mean, math.sqrt(max(var, 0.0)), z)


class HoltWintersForecaster:
    """Additive Holt-Winters (level + trend + seasonal).  With fewer than
    two full seasons of history the seasonal components are unidentifiable,
    so the model falls back to Holt's linear method — the trend term alone
    already anticipates monotone ramps."""

    name = "holtwinters"

    def __init__(self, alpha: float = 0.35, beta: float = 0.1,
                 gamma: float = 0.2, season_length: int = 24):
        for nm, v in (("alpha", alpha), ("beta", beta), ("gamma", gamma)):
            if not 0.0 < v <= 1.0:
                raise ValueError(f"{nm} must be in (0, 1], got {v}")
        if season_length < 1:
            raise ValueError(f"season_length must be >= 1, got {season_length}")
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.gamma = float(gamma)
        self.season_length = int(season_length)

    # ------------------------------------------------------------------
    def forecast(self, values: np.ndarray, steps: int,
                 z: float = 1.64) -> ForecastEnvelope:
        values = np.asarray(values, dtype=np.float64)
        m = self.season_length
        if len(values) >= 2 * m and m >= 2:
            mean, sigma = self._holt_winters(values, steps)
        else:
            mean, sigma = self._holt(values, steps)
        return _envelope(mean, sigma, z)

    # EW weight for the residual variance: the band must track the CURRENT
    # demand regime — a diurnal trough after a busy day would otherwise
    # keep a peak-sized confidence band (and peak-sized headroom) all night
    VAR_DECAY = 0.03

    def _holt(self, values: np.ndarray, steps: int):
        """Level + trend only (the < 2-seasons fallback)."""
        n = len(values)
        if n == 0:
            return np.zeros(steps, dtype=np.float64), 0.0
        level = float(values[0])
        trend = float(values[1] - values[0]) if n > 1 else 0.0
        a, b, d = self.alpha, self.beta, self.VAR_DECAY
        var = 0.0
        for t in range(1, n):
            pred = level + trend
            resid = float(values[t]) - pred
            var = (1.0 - d) * var + d * resid * resid
            last = level
            level = a * float(values[t]) + (1.0 - a) * (level + trend)
            trend = b * (level - last) + (1.0 - b) * trend
        h = np.arange(1, steps + 1, dtype=np.float64)
        mean = level + trend * h
        return mean, math.sqrt(max(var, 0.0))

    def _holt_winters(self, values: np.ndarray, steps: int):
        n, m = len(values), self.season_length
        a, b, g, d = self.alpha, self.beta, self.gamma, self.VAR_DECAY
        first = float(np.mean(values[:m]))
        second = float(np.mean(values[m:2 * m]))
        level = first
        trend = (second - first) / m
        seasonal = (values[:m] - first).astype(np.float64).copy()
        var = 0.0
        for t in range(m, n):
            v = float(values[t])
            s = seasonal[t % m]
            pred = level + trend + s
            resid = v - pred
            var = (1.0 - d) * var + d * resid * resid
            last = level
            level = a * (v - s) + (1.0 - a) * (level + trend)
            trend = b * (level - last) + (1.0 - b) * trend
            seasonal[t % m] = g * (v - level) + (1.0 - g) * s
        h = np.arange(1, steps + 1, dtype=np.float64)
        season_idx = (n + np.arange(steps)) % m
        mean = level + trend * h + seasonal[season_idx]
        return mean, math.sqrt(max(var, 0.0))


_KINDS = {"ewma": EWMAForecaster, "holtwinters": HoltWintersForecaster}


def make_forecaster(kind: str, season_length: int = 24, **kw):
    """Forecaster registry: `kind` is "ewma" or "holtwinters"."""
    if kind not in _KINDS:
        raise ValueError(
            f"unknown forecaster {kind!r} (expected one of {sorted(_KINDS)})")
    if kind == "holtwinters":
        kw.setdefault("season_length", season_length)
    return _KINDS[kind](**kw)
