"""Controllers of the port: provisioning, disruption (the decision and
its execution), termination, the nodeclaim lifecycle, interruption and
garbage collection."""

from .provisioning import Provisioner, ProvisioningResult, claim_from_decision
from .disruption import DisruptionController, DisruptionResult
from .termination import TerminationController, TerminationResult
from .lifecycle import LifecycleController, LifecycleResult
from .interruption import InterruptionController, InterruptionResult
from .garbagecollection import (GarbageCollectionController, GCResult,
                                TaggingController)
