"""Data parallelism (torch port of `lseg_tpu/parallel`): one process per
GPU over `torch.distributed`; see `parallel.dist`."""

from lseg_tpu_torch.parallel.dist import (  # noqa: F401
    all_gather_rows,
    all_reduce_,
    all_reduce_sum,
    batch_shard,
    broadcast_module,
    create_mesh,
    init_distributed,
    rank_rows,
    sync_batchnorm_,
)
