"""Data parallelism over ``torch.distributed`` and device meshes
(counterpart of ``gligen_tpu/parallel/``)."""

from gligen_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    process_batch_slice,
    replicate,
    shard_batch,
)
