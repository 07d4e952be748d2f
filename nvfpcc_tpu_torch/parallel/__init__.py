"""Block-data-parallel training over a ``torch.distributed`` group."""

from nvfpcc_tpu_torch.parallel.mesh import (  # noqa: F401
    BLOCK_AXIS,
    Mesh,
    gather_rows,
    init_distributed,
    make_mesh,
    pad_blocks,
    padded_block_count,
    replicate,
    run_group,
    shard_train_arrays,
    under_torchrun,
)
