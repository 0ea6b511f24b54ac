"""The cloud seam of the port: the in-memory fake cloud, the ICE cache and
the CloudProvider that turns NodeClaims into launches (copies of the JAX
package's `cloud/`, trimmed to what provisioning reaches)."""

from .cache import TTLCache, UnavailableOfferings, UNAVAILABLE_OFFERINGS_TTL
from .fake import (CloudError, CloudInstance, FakeCloud, FleetError,
                   FleetOverride, FleetResult, ICE_CODE)
from .provider import (CloudProvider, InstanceTypesProvider,
                       InsufficientCapacityError, MAX_INSTANCE_TYPES,
                       MIN_SPOT_FLEXIBILITY, NodeClassNotFoundError,
                       ProviderCircuitBreaker, RetryPolicy)
