"""Distribution over `torch.distributed` ranks (torch counterpart of
`repro.distributed`): the ambient mesh (`context`), the sums across ranks
(`collectives`), the row-sharded memory placement (`sharded_lram`) and
the placement of a model over the mesh (`sharding`)."""

from repro_torch.distributed.context import (  # noqa: F401
    Mesh,
    axis_group,
    batch_axes,
    constrain,
    get_mesh,
    set_mesh,
)
