"""Multi-device execution of the port (counterpart of
hairfastgan_tpu/parallel): the data mesh and data parallelism (mesh.py)
and the H-band spatial sharding of one swap (spatial.py)."""

from hairfastgan_torch.parallel.mesh import (  # noqa: F401
    MOVES,
    MeshPlan,
    Replicas,
    data_mesh_for_batch,
    data_parallel,
    gather,
    local_devices,
    make_mesh,
    move,
    reduce_shards,
    replicate,
    shard_batch,
)
from hairfastgan_torch.parallel.spatial import (  # noqa: F401
    SpatialPlan,
    make_sharded_swap,
    sharded_synthesis,
)
