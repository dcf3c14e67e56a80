"""Partition lanes: K independent FFD problems in one device program.

The lane half of the JAX package's ``parallel/``. On one card the lanes run
as ONE launch of the FFD kernel (``ops/ffd_cuda.py`` ``ffd_solve_lanes``,
one thread-block cluster a lane). The multi-device half (a device mesh,
the sharded solve, screen and merge, lanes sharded over devices) needs more
than one card and raises ``NotImplementedError``.
"""

from .mesh import (  # noqa: F401
    lane_plans,
    lanes_mode,
    make_mesh,
    merge_partition_plans,
    merge_sharded_plan,
    screen_sharded,
    solve_partition_lanes,
    solve_sharded,
    stack_lane_problems,
)
