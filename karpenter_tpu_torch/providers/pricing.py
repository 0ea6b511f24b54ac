"""Pricing provider: on-demand + spot price store with static fallback and a
12h refresh controller.

A copy of the JAX package's `providers/pricing.py`, less its liveness
check (which nothing calls).  Each refresh sets the price-estimate gauge.
It re-implements
karpenter:pkg/providers/pricing/pricing.go:
  * `on_demand_price` / `spot_price` lookups (:118-143);
  * `update_on_demand_pricing` from the price-list API (:145) and
    `update_spot_pricing` from spot price history (:308) — each keeps the
    previous table on API failure;
  * static fallback tables baked in at construction
    (zz_generated.pricing_aws*.go analog: here derived from the generated
    catalog's list prices);
  * a controller requeueing every 12h
    (karpenter:pkg/providers/pricing/controller.go:40).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from ..catalog.instancetype import InstanceType
from ..cloud.fake import CloudError
from ..utils import metrics
from ..utils.events import ChangeMonitor

log = logging.getLogger("karpenter_tpu_torch.pricing")

PRICING_REFRESH_INTERVAL = 12 * 3600.0  # controller.go:40
SPOT_DISCOUNT_FALLBACK = 0.30  # spot ≈ 30% of OD when no history exists


def static_price_table(catalog: Sequence[InstanceType]) -> Dict[str, float]:
    """Fallback table: cheapest on-demand offering per type from the
    generated catalog (the reference bakes scraped price tables in)."""
    out: Dict[str, float] = {}
    for it in catalog:
        od = [o.price for o in it.offerings if o.capacity_type == "on-demand"]
        if od:
            out[it.name] = min(od)
    return out


class PricingProvider:
    def __init__(self, pricing_api=None, cloud=None,
                 static_fallback: Optional[Dict[str, float]] = None,
                 clock: Callable[[], float] = time.time):
        self.pricing_api = pricing_api
        self.cloud = cloud
        self.clock = clock
        self._lock = threading.Lock()
        self._od: Dict[str, float] = dict(static_fallback or {})
        self._static = dict(static_fallback or {})
        self._spot: Dict[Tuple[str, str], float] = {}
        # per-table refresh counters: liveness is PER TABLE, so an OD-only
        # refresh never degrades catalog spot prices to the synthetic
        # discount (and vice versa); the pair keys catalog memoization
        self._od_seq = 0
        self._spot_seq = 0
        self._monitor = ChangeMonitor()

    @property
    def seq_num(self) -> Tuple[int, int]:
        with self._lock:
            return (self._od_seq, self._spot_seq)

    # ---- lookups (pricing.go:118-143) ----
    def on_demand_price(self, instance_type: str) -> Optional[float]:
        with self._lock:
            return self._od.get(instance_type)

    def spot_price(self, instance_type: str, zone: str) -> Optional[float]:
        """Zonal spot price; falls back to a discount off on-demand when no
        history exists (the reference initializes spot=OD until history
        arrives, pricing.go:136-143)."""
        with self._lock:
            p = self._spot.get((instance_type, zone))
            if p is not None:
                return p
            od = self._od.get(instance_type)
            return od * SPOT_DISCOUNT_FALLBACK if od is not None else None

    # ---- refresh (pricing.go:145,308) ----
    def update_on_demand_pricing(self) -> bool:
        if self.pricing_api is None:
            return False
        try:
            prices = self.pricing_api.list_prices()
        except CloudError as e:
            log.warning("on-demand price refresh failed, keeping stale table: %s", e)
            return False
        if not prices:
            return False
        with self._lock:
            self._od = {**self._static, **prices}
            self._od_seq += 1
        if self._monitor.has_changed("od-prices", tuple(sorted(prices.items()))):
            log.info("refreshed %d on-demand prices", len(prices))
        gauge = metrics.instance_price_estimate()
        for itype, price in prices.items():
            gauge.set(price, {"instance_type": itype, "capacity_type": "on-demand",
                              "zone": ""})
        return True

    def update_spot_pricing(self) -> bool:
        if self.cloud is None:
            return False
        try:
            history = self.cloud.describe_spot_price_history()
        except CloudError as e:
            log.warning("spot price refresh failed, keeping stale table: %s", e)
            return False
        if not history:
            return False  # no data is not a refresh (matches the OD guard)
        with self._lock:
            self._spot.update(history)
            self._spot_seq += 1
        gauge = metrics.instance_price_estimate()
        for (itype, zone), price in history.items():
            gauge.set(price, {"instance_type": itype, "capacity_type": "spot",
                              "zone": zone})
        return True


class PricingController:
    """Requeue-every-12h refresh loop (pricing/controller.go:40)."""

    def __init__(self, provider: PricingProvider,
                 interval: float = PRICING_REFRESH_INTERVAL,
                 clock: Callable[[], float] = time.time):
        self.provider = provider
        self.interval = interval
        self.clock = clock
        self._next_run = 0.0

    def reconcile(self) -> bool:
        """Refresh if due; returns whether a refresh ran."""
        now = self.clock()
        if now < self._next_run:
            return False
        self.provider.update_on_demand_pricing()
        self.provider.update_spot_pricing()
        self._next_run = now + self.interval
        return True
