"""The operator layer of the port: the options it reads and the feature
gates, the `Operator` that builds the provider graph over the fake cloud,
and `build_controllers` (copies of the JAX package's `operator/`; its
command line, controller manager, pod batch window and endpoints come with
ROADMAP.md queue B3)."""

from .operator import Operator, build_controllers
from .options import Options

__all__ = ["Operator", "Options", "build_controllers"]
