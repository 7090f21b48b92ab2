"""Multi-GPU: process-group start-up, the data-parallel / FSDP meshes and
rules for KD training, and Megatron tensor parallelism for serving (port of
``pea_diffusion_tpu/parallel``)."""
from .distributed import initialize
from .mesh import (
    DATA_AXIS,
    DCN_AXIS,
    FSDP_AXIS,
    batch_sharding,
    fsdp_sharding,
    make_hybrid_mesh,
    make_mesh,
    replicated,
    shard_batch,
    shard_params,
)

__all__ = ["DATA_AXIS", "DCN_AXIS", "FSDP_AXIS", "batch_sharding", "fsdp_sharding",
           "make_hybrid_mesh", "make_mesh", "replicated", "shard_batch", "shard_params",
           "initialize"]
