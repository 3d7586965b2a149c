"""Stateless synthetic data (torch counterpart of `repro.data`): numpy
batches derived from (config, step), handed to the model as tensors.

Public surface: `DataConfig`, `get_batch` (mlm/clm objectives), `IGNORE`,
and `make_fact_table` / `fact_eval_batch` for the fact-recall probe.
"""

from repro_torch.data.synthetic import (  # noqa: F401
    IGNORE,
    DataConfig,
    fact_eval_batch,
    get_batch,
    make_fact_table,
)
