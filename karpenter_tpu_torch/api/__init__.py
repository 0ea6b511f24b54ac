from .resources import ResourceList, parse_quantity, DEFAULT_AXES, DEFAULT_SCALES, CPU, MEMORY, EPHEMERAL_STORAGE, PODS, GPU, NEURON, POD_ENI
from .requirements import Requirement, Requirements, IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT
from .taints import Taint, Toleration, tolerates_all, NO_SCHEDULE, PREFER_NO_SCHEDULE, NO_EXECUTE
from .objects import (Pod, Node, NodeClaim, NodeClass, NodePool, NodePoolTemplate,
                      KubeletConfiguration, Disruption, PodDisruptionBudget,
                      TopologySpreadConstraint, PodAffinityTerm, pool_view)
from . import labels
