"""The cloud seam of the port: the in-memory fake cloud, its interruption
queue and auxiliary services (identity, parameter store, price list,
control plane), the windowed request batcher, the ICE cache, the error
taxonomy, and the CloudProvider that launches, terminates, lists and
drift-checks NodeClaims (copies of the JAX package's `cloud/`)."""

from .cache import TTLCache, UnavailableOfferings, UNAVAILABLE_OFFERINGS_TTL
from .fake import (CloudError, CloudInstance, FakeCloud, FleetError,
                   FleetOverride, FleetResult, ICE_CODE, ImageInfo,
                   LaunchTemplateInfo, SecurityGroupInfo, SubnetInfo)
from .provider import (CloudProvider, InstanceTypesProvider,
                       InsufficientCapacityError, MAX_INSTANCE_TYPES,
                       MIN_SPOT_FLEXIBILITY, NodeClassNotFoundError,
                       ProviderCircuitBreaker, RetryPolicy, static_hash)
from .queue import FakeQueue
