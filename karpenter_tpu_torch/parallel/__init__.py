"""The fleet-scale sharded solve (the ShardedSolve gate): the partition
planner, the pod-batch sharded solve and the partitioned mesh driver, on
shard-batched kernels (the port of the JAX package's `parallel/`)."""

from .driver import maybe_solve_partitioned, solve_partitioned
from .partition import PartitionPlan, plan_partition
from .sharded import (DCN_AXIS, ICI_AXIS, SHARD_AXIS, Mesh, make_host_mesh,
                      make_pod_mesh, solve_sharded, split_counts)
