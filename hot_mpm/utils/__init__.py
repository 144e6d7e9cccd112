"""Config tree, timers, structured metrics logging."""

from hot_mpm.utils.config import (  # noqa: F401
    SimConfig,
    SolverConfig,
    MultigridConfig,
    MeshConfig,
)
from hot_mpm.utils.timing import PhaseTimer  # noqa: F401
from hot_mpm.utils.metrics import MetricsLogger  # noqa: F401
