"""Cloud error taxonomy: code classification, not string matching.

A copy of the JAX package's `cloud/errors.py` (the analog of Karpenter's
error classifier, pkg/errors/errors.go:56-103): call sites ask *what kind*
of failure they got — not-found, already-exists, unfulfillable capacity,
launch-template-not-found, retryable — instead of comparing code strings
inline.  `CloudError` is the transport (cloud/fake.py);
`InsufficientCapacityError` / `NodeClassNotFoundError` (cloud/provider.py)
are the launch path's wrappers on top.
"""

from __future__ import annotations

from typing import Optional

from .fake import ICE_CODE

# errors.go:56-66 notFoundErrorCodes (and the fake cloud's own spellings)
NOT_FOUND_CODES = frozenset({
    "InstanceNotFound",
    "InvalidInstanceID.NotFound",
    "InvalidLaunchTemplateId.NotFound",
    "InvalidLaunchTemplateName.NotFoundException",
    "ParameterNotFound",
    "ImageNotFound",
    "NoSuchEntity",
    "ResourceNotFoundException",
})

# errors.go alreadyExistsErrorCodes
ALREADY_EXISTS_CODES = frozenset({
    "EntityAlreadyExists",
    "AlreadyExists",
    "InvalidLaunchTemplateName.AlreadyExistsException",
})

# errors.go:83-94 unfulfillableCapacityErrorCodes — fleet error codes that
# mean "this offering cannot be fulfilled right now" and feed the ICE cache
# rather than fail the claim
UNFULFILLABLE_CAPACITY_CODES = frozenset({
    ICE_CODE,
    "InsufficientInstanceCapacity",
    "MaxSpotInstanceCountExceeded",
    "VcpuLimitExceeded",
    "UnfulfillableCapacity",
    "Unsupported",
    "InsufficientFreeAddressesInSubnet",
})

LAUNCH_TEMPLATE_NOT_FOUND_CODES = frozenset({
    "InvalidLaunchTemplateId.NotFound",
    "InvalidLaunchTemplateName.NotFoundException",
})

# transient faults worth an in-call retry: throttles and provider-side
# internal errors.  Not unfulfillable capacity — that is a state, fed to
# the ICE cache, and asking the same offering again cannot change it.
RETRYABLE_CODES = frozenset({
    "RequestLimitExceeded",
    "Throttling",
    "ThrottlingException",
    "RequestThrottled",
    "TooManyRequestsException",
    "InternalError",
    "InternalFailure",
    "ServiceUnavailable",
    "Unavailable",
})


def _code(err: Optional[BaseException]) -> str:
    return getattr(err, "code", "") or ""


def is_not_found(err: Optional[BaseException]) -> bool:
    """IsNotFound (errors.go:68-74): the named resource no longer exists —
    for a delete that is success (idempotent terminate), for a get the
    object is gone."""
    c = _code(err)
    return c in NOT_FOUND_CODES or c.endswith(".NotFound") \
        or c.endswith("NotFoundException")


def is_already_exists(err: Optional[BaseException]) -> bool:
    """IsAlreadyExists: a create raced another creator — the resource is
    there, go on as if the create succeeded."""
    c = _code(err)
    return c in ALREADY_EXISTS_CODES or "AlreadyExists" in c


def is_unfulfillable_capacity(err: Optional[BaseException]) -> bool:
    """IsUnfulfillableCapacity (errors.go:96-103): feed the ICE cache and
    try other offerings instead of failing the claim."""
    return _code(err) in UNFULFILLABLE_CAPACITY_CODES


def is_launch_template_not_found(err: Optional[BaseException]) -> bool:
    """IsLaunchTemplateNotFound: the cached template was deleted — drop it
    and create it again."""
    return _code(err) in LAUNCH_TEMPLATE_NOT_FOUND_CODES


def is_retryable(err: Optional[BaseException]) -> bool:
    """IsRetryable: a transient throttle or internal fault — the SAME
    request may be retried after a jittered backoff (provider.RetryPolicy).
    Unfulfillable capacity is deliberately excluded."""
    return _code(err) in RETRYABLE_CODES


def classify(err) -> str:
    """One-word classification for logs.  Duck-typed on `code`, so a
    fleet's per-override errors (fake.FleetError) classify as CloudError
    exceptions do."""
    if not _code(err):
        return "other"
    if is_unfulfillable_capacity(err):
        return "unfulfillable_capacity"
    if is_launch_template_not_found(err):
        return "launch_template_not_found"
    if is_not_found(err):
        return "not_found"
    if is_already_exists(err):
        return "already_exists"
    if is_retryable(err):
        return "retryable"
    return "cloud_error"
