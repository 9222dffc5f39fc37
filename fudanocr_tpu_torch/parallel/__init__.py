"""Parallelism utilities (port of fudanocr_tpu/parallel; re-exported from
core/mesh for discoverability).

Data parallelism: one process per card, the batch sharded over the
'data' axis (`core/mesh`: `setup_distributed`, `make_mesh_for_batch`, the
collectives the modules reach through `data_parallel`, and the per-rank
batch helpers). The 'model' axis of parallel/tp.py places parameters as
DTensors for tensor parallelism, and `TensorParallel` runs a module's step
on them.
"""

from fudanocr_tpu_torch.core.mesh import (Mesh, data_parallel,
                                          host_shard_indices,
                                          local_batch_size, local_device,
                                          make_mesh_for_batch, shard_batch,
                                          setup_distributed)
from fudanocr_tpu_torch.parallel.tp import (TensorParallel, last_dim_spec,
                                            make_mesh, shard_params_tp)
