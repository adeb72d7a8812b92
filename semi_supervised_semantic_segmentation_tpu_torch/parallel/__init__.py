from semi_supervised_semantic_segmentation_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce_sum,
    broadcast_from_rank0,
    gather_rows,
    make_mesh,
    shard_batch,
)
