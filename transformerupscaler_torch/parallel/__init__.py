"""Several devices driven from one process (JAX counterpart:
transformerupscaler_tpu/parallel/): ``make_mesh``, batch-sharded inference
(``batch_infer.ShardedUpscaler``) and head sharding
(``activation_sharding`` / ``maybe_shard_heads``)."""

from transformerupscaler_torch.parallel.context import (  # noqa: F401
    activation_sharding,
    maybe_shard_heads,
)
from transformerupscaler_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
