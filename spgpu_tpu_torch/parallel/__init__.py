"""The distributed layer: row partitions, the halo exchange and the
distributed SpMV and Krylov solves, one process per shard over
``torch.distributed`` (NCCL on CUDA devices, gloo on the CPU).

Counterpart of :mod:`spgpu_tpu.parallel` (``shard_map`` over a device
mesh there): the packed partitions (:mod:`.partition_packed`, kernels #1,
#4, #7 and the complex128 kernel on each shard), the classic one
(:mod:`.partition_whell`, kernel #15), the HELL one (:mod:`.partition`,
plain torch products), the exchange and product (:mod:`.dist_spmv`), the
solves (:mod:`.dist_solve`) and the ranks (:mod:`.group`).  The TPU's
row-block containers (``blocks.py``) are not ported: the port builds one
layout at any size; nor is ``make_row_mesh``: the group is
``torch.distributed``'s.
"""

from spgpu_tpu_torch.parallel.dist_solve import (  # noqa: F401
    DistSolveHandle,
    dist_bicgstab,
    dist_cg,
)
from spgpu_tpu_torch.parallel.dist_spmv import (  # noqa: F401
    ShardedHandle,
    dist_spmv,
    make_dist_matvec,
)
from spgpu_tpu_torch.parallel.group import (  # noqa: F401
    RankGroup,
    destroy_rank_group,
    init_rank_group,
    run_ranks,
)
from spgpu_tpu_torch.parallel.partition import (  # noqa: F401
    PartitionedMatrix,
    partition_coo_rows,
)
from spgpu_tpu_torch.parallel.partition_packed import (  # noqa: F401
    PackedPartition,
    from_numpy_partition,
    partition_coo_rows_packed,
)
from spgpu_tpu_torch.parallel.partition_whell import (  # noqa: F401
    PartitionedWhell,
    partition_coo_rows_whell,
)

__all__ = [
    "PartitionedMatrix",
    "partition_coo_rows",
    "PartitionedWhell",
    "partition_coo_rows_whell",
    "PackedPartition",
    "partition_coo_rows_packed",
    "from_numpy_partition",
    "dist_spmv",
    "make_dist_matvec",
    "ShardedHandle",
    "dist_cg",
    "dist_bicgstab",
    "DistSolveHandle",
    "RankGroup",
    "init_rank_group",
    "destroy_rank_group",
    "run_ranks",
]
