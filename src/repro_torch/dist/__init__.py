"""Distribution helpers: the port of ``repro.dist``.

The process-wide sharding context (:mod:`.context`), a mesh of device
positions that one process drives (:class:`Mesh`), and the fleet's
task-axis placement rules (:class:`FleetShardingRules`).  The TP/EP
planner ``ShardingRules`` waits for ROADMAP item 22 with its only caller,
``launch/dryrun.py``."""
from . import context  # noqa: F401
from .mesh import Mesh, make_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    FleetShardingRules, Replicas, TaskShards, gather_tasks, map_shards,
)
