"""The operator layer of the port: the options it reads, its command line
and the feature gates, the `Operator` that builds the provider graph over
the fake cloud, `build_controllers`, and the `ControllerManager` that runs
the controllers' loops and serves the endpoints (copies of the JAX
package's `operator/`)."""

from .manager import ControllerManager, PodBatchWindow
from .operator import Operator, build_controllers
from .options import Options

__all__ = ["ControllerManager", "Operator", "Options", "PodBatchWindow",
           "build_controllers"]
