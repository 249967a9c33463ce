"""Distribution helpers: the port of ``repro.dist``.

The process-wide sharding context (:mod:`.context`), a mesh of device
positions that one process drives (:class:`Mesh`), the TP/EP placement
planner that the dry run reads (:class:`ShardingRules`) and the fleet's
task-axis placement rules (:class:`FleetShardingRules`)."""
from . import context  # noqa: F401
from .mesh import Mesh, make_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    FleetShardingRules, Replicas, ShardingRules, TaskShards, gather_tasks,
    map_shards,
)
