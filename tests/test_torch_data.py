"""Port parity: the port's copy of the synthetic data pipeline gives the
reference's batches byte for byte (same numpy generators, same draws)."""

import numpy as np
import pytest

from repro import data as j_data
from repro.data import synthetic as j_synthetic
from repro_torch import data


def _configs(objective: str, kind: str):
    kw = dict(vocab_size=300, seq_len=40, global_batch=6, kind=kind,
              objective=objective, num_facts=64, seed=11)
    return data.DataConfig(**kw), j_data.DataConfig(**kw)


@pytest.mark.parametrize("objective", ["mlm", "clm"])
@pytest.mark.parametrize("kind", ["facts", "zipf"])
def test_get_batch_byte_equal(objective, kind):
    cfg, j_cfg = _configs(objective, kind)
    for step in (0, 1, 7, 10_000_000):
        for shard in ((0, 1), (1, 3)):
            got = data.get_batch(cfg, step, shard=shard)
            want = j_data.get_batch(j_cfg, step, shard=shard)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes(), (step, k)


def test_fact_table_and_probe_byte_equal():
    cfg, j_cfg = _configs("mlm", "facts")
    table = data.make_fact_table(cfg)
    assert table.tobytes() == j_data.make_fact_table(j_cfg).tobytes()
    got = data.fact_eval_batch(cfg, n=9, table=table)
    want = j_synthetic.fact_eval_batch(j_cfg, n=9)
    for k in ("tokens", "labels"):
        assert got[k].tobytes() == want[k].tobytes()
    assert data.IGNORE == j_synthetic.IGNORE
    assert (got["labels"] != data.IGNORE).sum() == 9 * 3


def test_mlm_masking_recipe():
    """15% of positions carry labels; the mask token is vocab - 1."""
    cfg, _ = _configs("mlm", "zipf")
    cfg = data.DataConfig(**{**cfg.__dict__, "global_batch": 64,
                             "seq_len": 128})
    b = data.get_batch(cfg, 3)
    frac = (b["labels"] != data.IGNORE).mean()
    assert 0.12 < frac < 0.18
    masked = b["tokens"][b["labels"] != data.IGNORE]
    assert 0.7 < (masked == cfg.mask_token).mean() < 0.9
