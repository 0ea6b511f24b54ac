"""L2 providers: the capacity-provider data plane.

Copies of the JAX package's `providers/`.  Each module mirrors one package
of Karpenter's pkg/providers/ tree, re-expressed over the fake cloud
substrate:

  pricing          on-demand/spot price store + refresh controller
  subnet           placement-target discovery w/ in-flight IP accounting
  securitygroup    firewall-group discovery
  instanceprofile  identity-profile lifecycle
  version          control-plane version cache
  imagefamily      image resolution + per-family bootstrap userdata
  launchtemplate   launch-template ensure/cache/invalidate
"""

from typing import Dict


def matches_selector(obj_id: str, obj_tags: Dict[str, str],
                     selector: Dict[str, str], obj_name: str = "") -> bool:
    """Selector-term semantics (AND within a term): special keys `id` and
    `name` match identity, everything else matches tags; `"*"` is a tag-exists
    wildcard (karpenter:pkg/apis/v1beta1/ec2nodeclass.go selector terms)."""
    for k, v in selector.items():
        if k == "id":
            if obj_id != v:
                return False
        elif k == "name":
            if obj_name != v:
                return False
        elif v == "*":
            if k not in obj_tags:
                return False
        elif obj_tags.get(k) != v:
            return False
    return True
