"""Distribution over `torch.distributed` ranks (torch counterpart of
`repro.distributed`): the ambient mesh (`context`), the sums and gathers
across ranks, plain, differentiable and compressed (`collectives`), the
GPipe pipeline over an axis (`pipeline`), failure detection (`fault`),
and, imported as submodules (they import the model's layers, which
import this package), the row-sharded memory placement (`sharded_lram`)
and the placement of a model over the mesh: GSPMD's FSDP x TP rules for
the dense weights and their blocks (`sharding`)."""

from repro_torch.distributed.collectives import (  # noqa: F401
    compressed_psum,
)
from repro_torch.distributed.context import (  # noqa: F401
    Mesh,
    axis_group,
    batch_axes,
    batch_group,
    constrain,
    get_mesh,
    set_mesh,
)
from repro_torch.distributed.pipeline import pipeline_apply  # noqa: F401
