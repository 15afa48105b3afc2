"""Distribution: the sharding resolver and host-side fault tolerance.

* ``sharding`` — resolves the models' logical-axis annotations into
  per-dimension specs for a mesh (a DeviceMesh or a named-size mapping)
  and DTensor placements; ``shard_put``, ``constrain_activations``.
* ``fault`` — the work queue, the heartbeat and the restartable loop.
"""
from . import fault, sharding  # noqa: F401
