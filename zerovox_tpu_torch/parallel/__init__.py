"""Device-mesh parallelism: DP batch splitting and TP channel sharding
(parallel.tp), the time-parallel vocoder and the two-stage device pipeline
in one process, and runs of several processes (parallel.distributed:
initialize_distributed, make_pod_mesh) for training."""

from .distributed import initialize_distributed, make_pod_mesh, pod_device_grid
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, parse_mesh_spec, single_device_mesh
from .sharding import (batch_specs, param_partition_specs, replicated_specs, shard_batch,
                       shard_params)
from .infer import make_sharded_synthesize
from .pipeline import PipelinedTTS
from .seq import TimeParallelVocoder

__all__ = ["make_mesh", "single_device_mesh", "parse_mesh_spec", "Mesh",
           "DATA_AXIS", "MODEL_AXIS",
           "param_partition_specs", "replicated_specs", "shard_params",
           "shard_batch", "batch_specs", "make_sharded_synthesize",
           "PipelinedTTS", "TimeParallelVocoder",
           "initialize_distributed", "make_pod_mesh", "pod_device_grid"]
