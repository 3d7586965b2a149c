"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where no NVIDIA GPU is present (the
kernels have no CPU interpret mode).  This file imports no JAX, so it
runs on a machine with a card and PyTorch only:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import quant
from repro_torch.core import indexing, lookup
from repro_torch.core.lram import LRAMConfig
from repro_torch.kernels import e8_lookup, gather_interp, tiered_gather
from repro_torch.memstore import TieredSpec, TieredValueStore


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 128, 2048])
def test_kernels_match_plain_on_card(cuda_device, n):
    """K2 idx/w and K1 output against the plain versions on the card:
    weights bit-equal (same summation order), K1 to 1e-5."""
    spec = indexing.choose_torus(20)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    q = torch.rand(n, 8, generator=gen, device=cuda_device) * 16
    before = e8_lookup.lram_query.launches
    idx, w = e8_lookup.lram_query(q, spec)
    assert e8_lookup.lram_query.launches == before + 1
    idx_p, w_p = e8_lookup.lram_query_plain(q, spec)
    torch.testing.assert_close(w, w_p, rtol=0, atol=0)
    values = torch.randn(spec.num_locations, 64, generator=gen,
                         device=cuda_device)
    out = gather_interp.gather_interp(values, idx, w)
    torch.testing.assert_close(
        out, gather_interp.gather_interp_plain(values, idx, w),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_reference_plan_refuses_cuda_tables(cuda_device):
    plan = lookup.resolve(LRAMConfig(log2_locations=16))
    with pytest.raises(lookup.LookupPlanError):
        plan.interp(torch.zeros(16, 4, device=cuda_device),
                    torch.zeros(1, 32, dtype=torch.int32,
                                device=cuda_device),
                    torch.zeros(1, 32, device=cuda_device))


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    spec = indexing.choose_torus(16)
    idx = torch.zeros(2, 32, dtype=torch.int32, device=cuda_device)
    w = torch.zeros(2, 32, device=cuda_device)
    values = torch.zeros(16, 4, device=cuda_device)
    with pytest.raises(TypeError):
        gather_interp.gather_interp(values.double(), idx, w)
    with pytest.raises(TypeError):
        gather_interp.gather_interp(values, idx.long(), w)
    with pytest.raises(ValueError):
        gather_interp.gather_interp(values, idx[:, :8], w)
    q = torch.zeros(4, 8, device=cuda_device)
    with pytest.raises(TypeError):
        e8_lookup.lram_query(q.double(), spec)
    with pytest.raises(ValueError):
        e8_lookup.lram_query(q, spec, top_k=233)


def _quantized(values: torch.Tensor, kind: str):
    q, s = quant.quantize_rows_np(values.cpu().numpy(), kind)
    return (quant.as_torch_payload(q).to(values.device),
            torch.from_numpy(s).to(values.device))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("n", [1, 128, 2048])
def test_b4_matches_plain_on_card(cuda_device, kind, n):
    """B4 (int8 and e4m3 payloads) against its plain version, rtol 2e-5 /
    atol 1e-6 (both fold the scale into the weight; the sum order
    differs)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    values = torch.randn(1 << 16, 64, generator=gen, device=cuda_device)
    q, s = _quantized(values, kind)
    idx = torch.randint(0, 1 << 16, (n, 32), generator=gen,
                        device=cuda_device, dtype=torch.int32)
    w = torch.rand(n, 32, generator=gen, device=cuda_device)
    before = gather_interp.gather_interp_quant.launches
    out = gather_interp.gather_interp_quant(q, s, idx, w)
    assert gather_interp.gather_interp_quant.launches == before + 1
    torch.testing.assert_close(
        out, gather_interp.gather_interp_quant_plain(q, s, idx, w),
        rtol=2e-5, atol=1e-6)


def _resident_call(device, n, gen, slots=32, shard_rows=8192, shards=128):
    slot_table = torch.full((shards,), -1, dtype=torch.int32)
    resident = torch.randperm(shards, generator=gen)[:slots]
    slot_table[resident] = torch.randperm(slots, generator=gen).int()
    pick = resident[torch.randint(0, slots, (n, 32), generator=gen)]
    gid = (pick * shard_rows
           + torch.randint(0, shard_rows, (n, 32), generator=gen)).int()
    w = torch.rand(n, 32, generator=gen)
    return slot_table.to(device), gid.to(device), w.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "int8", "fp8"])
@pytest.mark.parametrize("n", [1, 128, 2048])
def test_b5_b6_match_plain_on_card(cuda_device, kind, n):
    """B5 (fp32 cache) and B6 (int8, e4m3 cache) against their plain
    versions on a 32-slot x 8192-row cache, rtol 2e-5 / atol 1e-6."""
    gen = torch.Generator().manual_seed(n)
    slot_table, gid, w = _resident_call(cuda_device, n, gen)
    cache = torch.randn(32 * 8192, 64, generator=gen).to(cuda_device)
    if kind == "none":
        before = tiered_gather.tiered_gather.launches
        out = tiered_gather.tiered_gather(cache, gid, slot_table, w,
                                          shard_rows=8192, resident=True)
        assert tiered_gather.tiered_gather.launches == before + 1
        want = tiered_gather.tiered_gather_plain(cache, gid, slot_table, w,
                                                 shard_rows=8192)
    else:
        q, s = _quantized(cache, kind)
        before = tiered_gather.tiered_gather_quant.launches
        out = tiered_gather.tiered_gather_quant(
            q, s, gid, slot_table, w, shard_rows=8192, resident=True)
        assert tiered_gather.tiered_gather_quant.launches == before + 1
        want = tiered_gather.tiered_gather_quant_plain(
            q, s, gid, slot_table, w, shard_rows=8192)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=1e-6)


@pytest.mark.cuda
def test_b5_marks_rows_of_absent_shards_nan(cuda_device):
    """A row whose shard has no slot comes out NaN, never an out-of-bounds
    read (the wrapper is handed a residency verdict it cannot check)."""
    slot_table = torch.tensor([0, -1], dtype=torch.int32, device=cuda_device)
    cache = torch.ones(4, 8, device=cuda_device)
    idx = torch.tensor([[0, 1], [4, 5]], dtype=torch.int32,
                       device=cuda_device)
    w = torch.ones(2, 2, device=cuda_device)
    out = tiered_gather.tiered_gather(cache, idx, slot_table, w,
                                      shard_rows=4, resident=True)
    assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "int8"])
def test_tiered_store_on_card_matches_cpu_store(cuda_device, kind):
    """The same store on the card (B5/B6 when resident, K1/B4 on the
    overflow route) and on the CPU (plain versions): equal stats, gathers
    to 1e-5; the reference cell raises on the card."""
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(16 * 256, 64)).astype(np.float32)
    spec = TieredSpec(shard_rows=256, cache_slots=4, use_pallas=True,
                      quant=kind)
    stores = [TieredValueStore.from_dense(dense, spec) for _ in range(2)]
    stores[1].to(cuda_device)
    for shards in ([0, 1], [2, 3, 5, 6, 7, 9], [2, 3]):
        idx = (np.asarray(shards)[rng.integers(0, len(shards), (64, 32))]
               * 256 + rng.integers(0, 256, (64, 32))).astype(np.int32)
        w = rng.uniform(0, 1, (64, 32)).astype(np.float32)
        cpu = stores[0].gather(torch.from_numpy(idx), torch.from_numpy(w))
        card = stores[1].gather(torch.from_numpy(idx).to(cuda_device),
                                torch.from_numpy(w).to(cuda_device))
        torch.testing.assert_close(card.cpu(), cpu, rtol=1e-5, atol=1e-5)
        assert stores[0].stats == stores[1].stats
    ref = TieredValueStore.from_dense(dense, TieredSpec(
        shard_rows=256, cache_slots=4, quant=kind)).to(cuda_device)
    with pytest.raises(lookup.LookupPlanError):
        ref.gather(torch.zeros(1, 32, dtype=torch.int32, device=cuda_device),
                   torch.zeros(1, 32, device=cuda_device))
