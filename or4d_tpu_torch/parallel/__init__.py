"""Data and model parallelism on ``torch.distributed`` (port of
``or4d_tpu/parallel``): one process a rank, a (dp, mp) mesh of ranks, the
SceneBatch sharding rule, and the collectives that make a rank's step
compute what the JAX package's one program computes over the global batch.
:mod:`or4d_tpu_torch.parallel.launch` starts D ranks on one machine.
"""

from or4d_tpu_torch.parallel.mesh import Mesh, make_mesh, replicated, shard_batch

__all__ = ["Mesh", "make_mesh", "replicated", "shard_batch"]
