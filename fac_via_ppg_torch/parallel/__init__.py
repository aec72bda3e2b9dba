"""Several GPUs, one process each (torch.distributed): the (data x model)
mesh and its collectives (`mesh`), and the placement rules of params and
optimizer state over it (`sharding`).  The port of
fac_via_ppg_tpu/parallel/."""

from fac_via_ppg_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_rows,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
