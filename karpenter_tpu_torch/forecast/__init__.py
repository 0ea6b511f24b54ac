"""Demand forecasting + proactive provisioning (predictive headroom).

The port of the JAX package's `forecast/` (its exports, the same names).

Karpenter's provisioning model is purely reactive: a node launches only
after pods are already unschedulable, so every demand spike pays the full
node-ready latency on the critical path.  This package closes that gap:

  * `series`  — bounded per-pod-class ring of arrival/departure
    observations, fed from the cluster's admission/bind path on the
    injectable clock (identical live and under ``sim/``);
  * `model`   — pluggable forecasters (EWMA baseline, Holt-Winters
    seasonal) producing a demand envelope with confidence bands, pure
    NumPy and deterministic given the series;
  * `headroom` — the HeadroomController that converts the envelope (plus
    a spot-risk prior learned from observed reclaim rates) into
    low-priority placeholder claims placed through the existing
    ``Provisioner.solve``/classpack path, TTL-protected from the
    consolidation sweep and evicted the instant a real pod needs the slot.

Gated off by default; enable with ``--forecast`` (or ``--feature-gates
Forecast=true``).
"""

from .headroom import (HEADROOM_CLASS_LABEL, HEADROOM_EXPIRY_ANNOTATION,
                       HEADROOM_LABEL, HEADROOM_PRIORITY, ForecastResult,
                       HeadroomConfig, HeadroomController, SpotRiskPrior,
                       headroom_expiry, is_headroom)
from .model import (EWMAForecaster, ForecastEnvelope, HoltWintersForecaster,
                    make_forecaster)
from .series import DemandSeries, pod_class

__all__ = [
    "DemandSeries", "pod_class",
    "ForecastEnvelope", "EWMAForecaster", "HoltWintersForecaster",
    "make_forecaster",
    "HeadroomController", "HeadroomConfig", "ForecastResult",
    "SpotRiskPrior", "is_headroom", "headroom_expiry",
    "HEADROOM_LABEL", "HEADROOM_CLASS_LABEL", "HEADROOM_EXPIRY_ANNOTATION",
    "HEADROOM_PRIORITY",
]
