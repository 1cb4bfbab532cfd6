"""Data and tensor parallelism (torch port of `lseg_tpu/parallel`): one
process per GPU over `torch.distributed`; see `parallel.dist` (the
process groups of the ("data", "model") mesh, the data-parallel
collectives) and `parallel.tensor` (the model group's Megatron layout)."""

from lseg_tpu_torch.parallel.dist import (  # noqa: F401
    Mesh,
    all_gather_rows,
    all_reduce_,
    all_reduce_sum,
    batch_shard,
    broadcast_module,
    create_mesh,
    data_group,
    init_distributed,
    model_group,
    rank_rows,
    sync_batchnorm_,
)
from lseg_tpu_torch.parallel.tensor import (  # noqa: F401
    copy_to_model,
    gather_grads,
    gather_module,
    param_shardings,
    reduce_from_model,
    shard_module_,
)
