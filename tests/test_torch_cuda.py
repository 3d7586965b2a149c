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
from repro_torch.core import indexing, lattice, lookup
from repro_torch.core.lram import LRAMConfig
from repro_torch.kernels import (e8_lookup, gather_interp, ops,
                                 sharded_gather, tiered_gather)
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
@pytest.mark.parametrize("top_k", [1, 8, 32, 33, 232])
@pytest.mark.parametrize("n", [1, 128, 2048, 65536])
def test_lram_query_bit_equal_to_plain_on_card(cuda_device, n, top_k):
    """K2 on uniform torus queries, on `lattice.tie_queries` (exact
    ties of weight, most at the top-32's cut) and on its variant with
    ties in |q - decode(q)|: weights and indices bit-equal to the plain
    version, whose stable sorts keep the lower candidate first among
    equal weights and the lower coordinate first in the canonical sort;
    one chunk (top_k <= 32) or several."""
    spec = indexing.choose_torus(20)
    gen = torch.Generator(device=cuda_device).manual_seed(n + top_k)
    K = torch.tensor(spec.K, dtype=torch.float32, device=cuda_device)
    for q in (torch.rand(n, 8, generator=gen, device=cuda_device) * K,
              *(torch.from_numpy(lattice.tie_queries(
                  n, spec.K, seed=n, distinct=d)).to(cuda_device)
                for d in (True, False))):
        idx, w = e8_lookup.lram_query(q, spec, top_k)
        idx_p, w_p = e8_lookup.lram_query_plain(q, spec, top_k)
        torch.testing.assert_close(w, w_p, rtol=0, atol=0)
        torch.testing.assert_close(idx, idx_p, rtol=0, atol=0)


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


def _resident_call(device, n, gen, slots=32, shard_rows=8192, shards=128,
                   top_k=32):
    slot_table = torch.full((shards,), -1, dtype=torch.int32)
    resident = torch.randperm(shards, generator=gen)[:slots]
    slot_table[resident] = torch.randperm(slots, generator=gen).int()
    pick = resident[torch.randint(0, slots, (n, top_k), generator=gen)]
    gid = (pick * shard_rows
           + torch.randint(0, shard_rows, (n, top_k), generator=gen)).int()
    w = torch.rand(n, top_k, generator=gen)
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


def _b5_split(cache, gid, slot_table, w, split, shard_rows):
    """B5 through its C entry with an explicit split (warps a query)."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.function("tiered_gather", "tiered_gather_f32_split",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
    out = torch.empty(gid.shape[0], cache.shape[1], device=cache.device)
    _build.check(fn(cache.data_ptr(), gid.data_ptr(), slot_table.data_ptr(),
                    w.data_ptr(), out.data_ptr(), gid.shape[0], gid.shape[1],
                    cache.shape[1], tiered_gather._log2(shard_rows), split,
                    cache.device.index,
                    torch.cuda.current_stream().cuda_stream), "B5 split")
    return out


def _b6_split(q, scale, gid, slot_table, w, split, wide, shard_rows):
    """B6 through its C entry with an explicit split and variant (wide 1:
    8-byte loads where they fit; 0: byte pairs)."""
    import ctypes

    from repro_torch.kernels import _build

    symbol = {torch.int8: "tiered_gather_quant_i8_split",
              torch.float8_e4m3fn: "tiered_gather_quant_e4m3_split"}
    fn = _build.function("tiered_gather", symbol[q.dtype],
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p])
    out = torch.empty(gid.shape[0], q.shape[1], device=q.device)
    _build.check(fn(q.data_ptr(), scale.data_ptr(), gid.data_ptr(),
                    slot_table.data_ptr(), w.data_ptr(), out.data_ptr(),
                    gid.shape[0], gid.shape[1], q.shape[1],
                    tiered_gather._log2(shard_rows), split, wide,
                    q.device.index, torch.cuda.current_stream().cuda_stream),
                 "B6 split")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [32, 20])
@pytest.mark.parametrize("m", [64, 8, 7, 72, 128])
@pytest.mark.parametrize("n", [1, 128, 2048])
def test_b5_b6_every_split_matches_plain_on_card(cuda_device, n, m, top_k):
    """B5 and B6 (gather_batched.cuh's body through the slot table) on K2's
    indices and weights into a 2^16-row table, against their plain
    versions (rtol 2e-5 / atol 1e-6): the entry's own choice and every
    split; B6 on int8 and e4m3 caches with the wide loads and with byte
    pairs (m = 64, 8, 72, 128) or single bytes (m = 7), the wide loads'
    ragged last chunk (m = 72) and their tile reused over two 64-column
    chunks (m = 128).  Two caches: 16 of 64 shards resident in shuffled
    slots, and a full 128-slot cache with the identity slot table.  At
    every split B5 adds in K1's order and B6, on either layout, in B4's
    byte pairs' order, bit for bit: each equals K1's / B4's explicit-split
    entry over the rows the slot table maps to.  B6's entry also takes
    caches whose base is 1, 2 or 4 bytes past an 8-byte boundary (single
    bytes, byte pairs), bit-equal to B4's entry on the same table."""
    _, _, idx, w, values, _ = _gather_case(cuda_device, n, m, top_k,
                                           "uniform", seed=3)
    gen = torch.Generator().manual_seed(n + m + top_k)
    shards, slots, shard_rows = 64, 16, values.shape[0] // 64
    log2r = tiered_gather._log2(shard_rows)
    resident = torch.randperm(shards, generator=gen)[:slots]
    slot_table = torch.full((shards,), -1, dtype=torch.int32)
    slot_table[resident] = torch.randperm(slots, generator=gen).int()
    resident = resident.to(cuda_device)
    gid = ((resident[(idx >> log2r) % slots] << log2r)
           | (idx & (shard_rows - 1))).int()
    cache = torch.randn(slots * shard_rows, m, generator=gen)
    cases = [(cache.to(cuda_device), slot_table.to(cuda_device), gid,
              shard_rows),
             (values, torch.arange(128, dtype=torch.int32,
                                   device=cuda_device), idx,
              values.shape[0] // 128)]
    for cache, slot_table, gid, shard_rows in cases:
        rows = tiered_gather.cache_rows(gid, slot_table,
                                        shard_rows).int().contiguous()
        want = tiered_gather.tiered_gather_plain(cache, gid, slot_table, w,
                                                 shard_rows=shard_rows)
        before = tiered_gather.tiered_gather.launches
        got = tiered_gather.tiered_gather(cache, gid, slot_table, w,
                                          shard_rows=shard_rows,
                                          resident=True)
        assert tiered_gather.tiered_gather.launches == before + 1
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
        for split in (1, 2, 4, 8):
            got = _b5_split(cache, gid, slot_table, w, split, shard_rows)
            torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
            assert torch.equal(got, _k1_split(cache, rows, w, split))
        for kind in ("int8", "fp8"):
            q, s = _quantized(cache, kind)
            want = tiered_gather.tiered_gather_quant_plain(
                q, s, gid, slot_table, w, shard_rows=shard_rows)
            before = tiered_gather.tiered_gather_quant.launches
            got = tiered_gather.tiered_gather_quant(
                q, s, gid, slot_table, w, shard_rows=shard_rows,
                resident=True)
            assert tiered_gather.tiered_gather_quant.launches == before + 1
            torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
            for split in (1, 2, 4, 8):
                pairs = _b4_split(q, s, rows, w, split, 0)
                for wide in (0, 1):
                    got = _b6_split(q, s, gid, slot_table, w, split, wide,
                                    shard_rows)
                    torch.testing.assert_close(got, want, rtol=2e-5,
                                               atol=1e-6)
                    assert torch.equal(got, pairs)
            for offset in (1, 2, 4):
                qo = _misaligned(q, offset)
                got = tiered_gather.tiered_gather_quant(
                    qo, s, gid, slot_table, w, shard_rows=shard_rows,
                    resident=True)
                torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
                assert torch.equal(
                    got, gather_interp.gather_interp_quant(qo, s, rows, w))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 7])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_b6_marks_rows_of_absent_shards_nan(cuda_device, kind, m):
    """B6's twin of the B5 test: a row with a candidate whose shard has no
    slot comes out NaN in every column, never an out-of-bounds read, with
    the wide loads (m = 8) and on single bytes (m = 7), at the entry's
    split and at every explicit one."""
    slot_table = torch.tensor([0, -1], dtype=torch.int32, device=cuda_device)
    q, s = _quantized(torch.ones(4, m, device=cuda_device), kind)
    idx = torch.tensor([[0, 1], [4, 5], [2, 6]], dtype=torch.int32,
                       device=cuda_device)
    w = torch.ones(3, 2, device=cuda_device)
    outs = [tiered_gather.tiered_gather_quant(q, s, idx, slot_table, w,
                                              shard_rows=4, resident=True)]
    outs += [_b6_split(q, s, idx, slot_table, w, split, wide, 4)
             for split in (1, 2, 4, 8) for wide in (0, 1)]
    for out in outs:
        assert torch.isfinite(out[0]).all() and torch.isnan(out[1:]).all()


@pytest.mark.cuda
def test_b5_b6_refuse_caches_of_2_31_rows(cuda_device):
    """The kernels keep a cache row in an int32, so the wrappers refuse a
    cache of 2^31 rows (expanded views: no memory is taken)."""
    rows = 2**31
    slot_table = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    idx = torch.zeros(1, 32, dtype=torch.int32, device=cuda_device)
    w = torch.ones(1, 32, device=cuda_device)
    cache = torch.zeros(1, 64, device=cuda_device).expand(rows, 64)
    with pytest.raises(ValueError, match="int32"):
        tiered_gather.tiered_gather(cache, idx, slot_table, w,
                                    shard_rows=rows, resident=True)
    q = torch.zeros(1, 64, dtype=torch.int8,
                    device=cuda_device).expand(rows, 64)
    scale = torch.ones(1, device=cuda_device).expand(rows)
    with pytest.raises(ValueError, match="int32"):
        tiered_gather.tiered_gather_quant(q, scale, idx, slot_table, w,
                                          shard_rows=rows, resident=True)


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


def _bwd_inputs(device, n, m=64, log2=20, seed=0):
    """K2's (idx, w) for n random torus queries, a table and an upstream
    gradient g, on the card."""
    spec = indexing.choose_torus(log2)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.rand(n, 8, generator=gen, device=device) \
        * torch.tensor(spec.K, dtype=torch.float32, device=device)
    with torch.no_grad():
        idx, w = e8_lookup.lram_query(q, spec)
    values = torch.randn(spec.num_locations, m, generator=gen,
                         device=device)
    g = torch.randn(n, m, generator=gen, device=device)
    return spec, q, idx, w, values, g


@pytest.mark.cuda
@pytest.mark.parametrize("with_dq", [True, False])
@pytest.mark.parametrize("n", [1, 128, 2048])
def test_lookup_bwd_matches_plain_on_card(cuda_device, with_dq, n):
    """Both instantiations of the backward kernel against
    `lookup_bwd_plain`: dvalues to atol 1e-5 (atomics add in a varying
    order), dq / dw to rtol 1e-4 / atol 1e-5 (sums in another order)."""
    spec, q, idx, w, values, g = _bwd_inputs(cuda_device, n)
    extra = {"q": q, "spec": spec} if with_dq else {}
    before = ops.lookup_bwd.launches
    dv, small = ops.lookup_bwd(values, idx, w, g, **extra)
    assert ops.lookup_bwd.launches == before + 1
    dv_p, small_p = ops.lookup_bwd_plain(values, idx, w, g, **extra)
    torch.cuda.synchronize()
    assert small.shape == small_p.shape == ((n, 8) if with_dq else (n, 32))
    torch.testing.assert_close(dv, dv_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(small, small_p, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("queries", ["uniform", "clustered"])
@pytest.mark.parametrize("stage", ["dq", "dw"])
@pytest.mark.parametrize("m", [62, 64, 256])
def test_scatter_instances_match_plain_on_card(cuda_device, m, stage,
                                               queries):
    """The scatter instances at widths of one and of four 64-column chunks
    and one not a multiple of 4 (62), on uniform queries and on clustered
    ones (32 queries near each of 64 points: rows hit by 32 and more pairs,
    which the sum's chunks cut and add atomically), on the whole table and
    on the upper half as a range shard at base 2^19: dvalues to atol 1e-5,
    dq / dw to rtol 1e-4 / atol 1e-5 against `lookup_bwd_plain`."""
    spec, q, idx, w, values, g = _bwd_inputs(cuda_device, 2048, m=m)
    if queries == "clustered":
        gen = torch.Generator(device=cuda_device).manual_seed(m)
        q = (q[:64].repeat(32, 1) + 1e-3 * torch.rand(
            2048, 8, generator=gen, device=cuda_device)).contiguous()
        with torch.no_grad():
            idx, w = e8_lookup.lram_query(q, spec)
        assert torch.unique(idx, return_counts=True)[1].max() > 32
    extra = {"q": q, "spec": spec} if stage == "dq" else {}
    dv, small = ops.lookup_bwd(values, idx, w, g, **extra)
    dv_p, small_p = ops.lookup_bwd_plain(values, idx, w, g, **extra)
    torch.testing.assert_close(dv, dv_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(small, small_p, rtol=1e-4, atol=1e-5)
    base = 2**19
    shard = values[base:].contiguous()
    before = ops.lookup_bwd_range.launches
    dv, small = ops.lookup_bwd_range(shard, idx, w, g, base, **extra)
    assert ops.lookup_bwd_range.launches == before + 1
    dv_p, small_p = ops.lookup_bwd_plain(shard, idx, w, g, extra.get("q"),
                                         spec, base=base)
    torch.testing.assert_close(dv, dv_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(small, small_p, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_forward_kernels_refuse_inputs_that_need_grad(cuda_device):
    """The forward kernels' outputs carry no grad_fn, so under grad mode
    they raise when an input requires grad; the differentiable forms
    (lram_lookup, gather_interp_vjp) carry it, and no_grad is fine."""
    spec, q, idx, w, values, g = _bwd_inputs(cuda_device, 16, log2=16)
    values.requires_grad_()
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        gather_interp.gather_interp(values, idx, w)
    with pytest.raises(RuntimeError, match="no gradient"):
        e8_lookup.lram_query(qg, spec)
    with torch.no_grad():
        gather_interp.gather_interp(values, idx, w)
        e8_lookup.lram_query(qg, spec)
    out = ops.lram_lookup(values, qg, spec)
    (out * g).sum().backward()
    assert values.grad is not None and qg.grad is not None
    wg = w.clone().requires_grad_()
    gather_interp.gather_interp_vjp(values, idx, wg).sum().backward()
    assert wg.grad is not None


@pytest.mark.cuda
def test_smoke_train_steps_on_card_match_cpu(cuda_device):
    """Three lram-bert-medium smoke steps through the training CLI on the
    card (K2, K1 and the backward kernel) and on the CPU (plain versions)
    from the same seed's weights and batches: losses and grad norms to
    rtol 1e-4 (atomics and another summation order)."""
    from repro_torch.launch import train

    argv = ["--arch", "lram-bert-medium", "--smoke", "--placement",
            "pallas", "--steps", "3", "--batch", "4", "--seq", "32"]
    before = ops.lookup_bwd.launches
    card = train.main(argv + ["--device", "cuda"])
    assert ops.lookup_bwd.launches == before + 3
    cpu = train.main(argv + ["--device", "cpu"])
    for a, b in zip(card.records, cpu.records):
        np.testing.assert_allclose([a["loss"], a["grad_norm"]],
                                   [b["loss"], b["grad_norm"]], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["dq", "dw"])
@pytest.mark.parametrize("kind", ["none", "int8", "fp8"])
@pytest.mark.parametrize("n", [1, 128, 2048])
def test_backward_without_scatter_matches_plain_on_card(cuda_device, kind,
                                                        stage, n):
    """The instances without scatter (fp32 rows: `lookup_bwd_rows`; 1-byte
    rows with per-row scales: `lookup_bwd_quant`, B4's VJP without dq)
    over a shuffled flat table, as a tiered store's flat route hands it
    over, against `lookup_bwd_plain` with the same rows: dq / dw to rtol
    1e-4 / atol 1e-5 (sums in another order), one launch each."""
    spec, q, idx, w, values, g = _bwd_inputs(cuda_device, n, log2=16)
    perm = torch.randperm(values.shape[0], device=cuda_device)
    rows = torch.argsort(perm)[idx.long()].int().contiguous()
    table, scale = values[perm].contiguous(), None
    if kind != "none":
        pay, s = quant.quantize_rows_np(table.cpu().numpy(), kind)
        table = quant.as_torch_payload(pay).to(cuda_device)
        scale = torch.from_numpy(s).to(cuda_device)
    extra = {"idx": idx, "q": q, "spec": spec} if stage == "dq" else {}
    fn = ops.lookup_bwd_rows if kind == "none" else ops.lookup_bwd_quant
    args = (table, rows) if kind == "none" else (table, scale, rows)
    before = fn.launches
    got = fn(*args, w, g, **extra)
    assert fn.launches == before + 1
    _, want = ops.lookup_bwd_plain(table, idx, w, g, extra.get("q"), spec,
                                   scale=scale, rows=rows, scatter=False)
    torch.cuda.synchronize()
    assert got.shape == want.shape == ((n, 8) if stage == "dq" else (n, 32))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_gather_interp_quant_vjp_on_card(cuda_device, kind):
    """B4 raises under grad mode when w needs a gradient; its VJP form
    carries one: dw equal to the plain version's (rtol 1e-4 / atol
    1e-5), with one launch of the backward kernel."""
    spec, q, idx, w, values, g = _bwd_inputs(cuda_device, 64, log2=16)
    pay, s = quant.quantize_rows_np(values.cpu().numpy(), kind)
    tq = quant.as_torch_payload(pay).to(cuda_device)
    ts = torch.from_numpy(s).to(cuda_device)
    wg = w.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        gather_interp.gather_interp_quant(tq, ts, idx, wg)
    before = ops.lookup_bwd_quant.launches
    out = gather_interp.gather_interp_quant_vjp(tq, ts, idx, wg)
    (out * g).sum().backward()
    assert ops.lookup_bwd_quant.launches == before + 1
    _, want = ops.lookup_bwd_plain(tq, idx, w, g, scale=ts, scatter=False)
    torch.testing.assert_close(wg.grad, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["lram-tiered", "lram-tiered-q8"])
def test_tiered_smoke_train_on_card_matches_cpu(cuda_device, arch):
    """Three smoke steps of a tiered arch through the training CLI on the
    card (K2, K1 or B4 over the flat route, the backward without scatter,
    the host write-back) and on the CPU (plain versions): losses and grad
    norms to rtol 1e-4, one backward launch and one write-back a step."""
    from repro_torch.launch import train

    argv = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "4",
            "--seq", "32"]
    fn = ops.lookup_bwd_rows if arch == "lram-tiered" else \
        ops.lookup_bwd_quant
    before = fn.launches
    card = train.main(argv + ["--device", "cuda"])
    assert fn.launches == before + 3
    cpu = train.main(argv + ["--device", "cpu"])
    assert card.stores[0].stats["writebacks"] == 3
    for a, b in zip(card.records, cpu.records):
        np.testing.assert_allclose([a["loss"], a["grad_norm"]],
                                   [b["loss"], b["grad_norm"]], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_dense_quantized_layer_gradient_on_card_matches_cpu(cuda_device,
                                                            kind):
    """A dense 1-byte table's memory layer in train mode is differentiable
    in its input on the card (K2, B4, then `lookup_bwd_quant` with dq; the
    table frozen): y and dL/dx equal the CPU's plain path to rtol 1e-4 /
    atol 1e-5."""
    from repro_torch.core import lram

    cfg = LRAMConfig(log2_locations=16, heads=2, query_norm="batch",
                     interp_impl="pallas", table_quant=kind)
    layer = lram.LRAM(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 5, 32, generator=torch.Generator().manual_seed(1))
    g = torch.randn(3, 5, 128, generator=torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", cuda_device):
        tx = x.to(dev).detach().requires_grad_()
        before = ops.lookup_bwd_quant.launches
        y = lram.lram_apply(layer.to(dev), tx, train=True)
        (y * g.to(dev)).sum().backward()
        launched = ops.lookup_bwd_quant.launches - before
        out[str(dev)] = (y.detach().cpu(), tx.grad.cpu(), launched)
    (y0, g0, n0), (y1, g1, n1) = out["cpu"], out[str(cuda_device)]
    assert (n0, n1) == (0, 1)
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(g1, g0, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "int8"])
def test_tiered_interp_on_card_matches_cpu(cuda_device, kind):
    """`tiered_interp` differentiable in w, on a card store and a CPU store
    with fewer slots than the lookup names shards (K1 or B4 over the flat
    route, then the backward without scatter with dw, then the host
    write-back): y and dw to rtol 1e-4 / atol 1e-5, one backward launch,
    equal stats and dirty sets, tables to atol 1e-6 (fp32; w (x) g formed
    from the same numbers) or equal payloads (int8: the same stochastic
    draws on the host)."""
    from repro_torch.memstore.interp import tiered_interp

    rng = np.random.default_rng(0)
    dense = rng.normal(size=(16 * 256, 64)).astype(np.float32)
    spec = TieredSpec(shard_rows=256, cache_slots=4, use_pallas=True,
                      quant=kind)
    idx = rng.integers(0, dense.shape[0], (64, 32)).astype(np.int32)
    w = rng.uniform(0, 1, (64, 32)).astype(np.float32)
    g = rng.normal(size=(64, 64)).astype(np.float32)
    fn = ops.lookup_bwd_rows if kind == "none" else ops.lookup_bwd_quant
    out = {}
    for dev in ("cpu", cuda_device):
        store = TieredValueStore.from_dense(dense, spec).to(dev)
        store.writeback_lr = 1e-2
        tw = torch.from_numpy(w).to(dev).requires_grad_()
        before = fn.launches
        y = tiered_interp(store, torch.from_numpy(idx).to(dev), tw)
        (y * torch.from_numpy(g).to(dev)).sum().backward()
        out[str(dev)] = (y.detach().cpu(), tw.grad.cpu(),
                         fn.launches - before, dict(store.stats),
                         set(store._dirty), store.to_dense())
    (y0, dw0, n0, st0, d0, t0), (y1, dw1, n1, st1, d1, t1) = \
        out["cpu"], out[str(cuda_device)]
    assert (n0, n1) == (0, 1)
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dw1, dw0, rtol=1e-4, atol=1e-5)
    assert st0 == st1 and st1["writebacks"] == 1 and d0 == d1
    if kind == "none":
        np.testing.assert_allclose(t1, t0, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(t1, t0)


def _range_inputs(device, n, kind, base, rows, seed=0):
    """K2's indices into a 2^20-row table and a shard [base, base + rows)
    of it (fp32, or 1-byte with scales), with q, w and g."""
    spec, q, idx, w, values, g = _bwd_inputs(device, n, seed=seed)
    shard, scale = values[base:base + rows].contiguous(), None
    if kind != "none":
        pay, s = quant.quantize_rows_np(shard.cpu().numpy(), kind)
        shard = quant.as_torch_payload(pay).to(device)
        scale = torch.from_numpy(s).to(device)
    return spec, q, idx, w, shard, scale, g


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "int8", "fp8"])
@pytest.mark.parametrize("n", [1, 128, 2048])
def test_sharded_gather_matches_plain_on_card(cuda_device, kind, n):
    """The range gather on both halves of a 2-way split against its plain
    version (fp32 rtol / atol 1e-5; 1-byte rtol 2e-5 / atol 1e-6, B4's),
    one launch each; the two partials sum to the whole gather."""
    rows = 2**19
    parts = []
    for base in (0, rows):
        spec, q, idx, w, shard, scale, g = _range_inputs(cuda_device, n,
                                                         kind, base, rows)
        if kind == "none":
            fn, args = sharded_gather.sharded_gather, (shard,)
            plain = sharded_gather.sharded_gather_plain
            tol = (1e-5, 1e-5)
        else:
            fn, args = sharded_gather.sharded_gather_quant, (shard, scale)
            plain = sharded_gather.sharded_gather_quant_plain
            tol = (2e-5, 1e-6)
        before = fn.launches
        got = fn(*args, idx, w, base)
        assert fn.launches == before + 1
        torch.testing.assert_close(got, plain(*args, idx, w, base),
                                   rtol=tol[0], atol=tol[1])
        parts.append(got)
    if kind == "none":
        _, _, idx, w, values, _ = _bwd_inputs(cuda_device, n)
        torch.testing.assert_close(parts[0] + parts[1],
                                   gather_interp.gather_interp(values, idx,
                                                               w),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["dq", "dw"])
@pytest.mark.parametrize("kind", ["none", "int8", "fp8"])
@pytest.mark.parametrize("n", [1, 128, 2048])
def test_lookup_bwd_range_matches_plain_on_card(cuda_device, kind, stage,
                                                n):
    """The range backward against `lookup_bwd_plain` with the range mask:
    the shard's dvalues to atol 1e-5 (atomics), dq / dw to rtol 1e-4 /
    atol 1e-5; for fp32 the two halves' partials sum to the whole
    backward's dq / dw and their dvalues are its halves."""
    rows = 2**19
    got = []
    for base in (0, rows):
        spec, q, idx, w, shard, scale, g = _range_inputs(cuda_device, n,
                                                         kind, base, rows)
        extra = {"q": q, "spec": spec} if stage == "dq" else {}
        before = ops.lookup_bwd_range.launches
        dv, small = ops.lookup_bwd_range(shard, idx, w, g, base,
                                         scale=scale, **extra)
        assert ops.lookup_bwd_range.launches == before + 1
        dv_p, small_p = ops.lookup_bwd_plain(
            shard, idx, w, g, extra.get("q"), spec, scale=scale,
            scatter=kind == "none", base=base)
        torch.cuda.synchronize()
        assert (dv is None) == (kind != "none")
        if dv is not None:
            torch.testing.assert_close(dv, dv_p, rtol=0, atol=1e-5)
        torch.testing.assert_close(small, small_p, rtol=1e-4, atol=1e-5)
        got.append((dv, small))
    if kind == "none":
        spec, q, idx, w, values, g = _bwd_inputs(cuda_device, n)
        dv, small = ops.lookup_bwd(values, idx, w, g, **(
            {"q": q, "spec": spec} if stage == "dq" else {}))
        torch.testing.assert_close(torch.cat([got[0][0], got[1][0]]), dv,
                                   rtol=0, atol=1e-5)
        torch.testing.assert_close(got[0][1] + got[1][1], small, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
def test_range_gathers_refuse_inputs_that_need_grad(cuda_device):
    spec, q, idx, w, shard, _, g = _range_inputs(cuda_device, 16, "none", 0,
                                                 2**19)
    shard.requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        sharded_gather.sharded_gather(shard, idx, w, 0)
    with torch.no_grad():
        sharded_gather.sharded_gather(shard, idx, w, 0)


@pytest.mark.cuda
def test_mesh_train_on_one_card_matches_dense(cuda_device, tmp_path):
    """Four ranks on the one card (gloo, data 2 x model 2) train the
    lram-bert-medium smoke config 3 steps with the sharded table: K2, the
    range gather and the range backward launch on every rank (the
    backward once a step), and the losses and grad norms equal the
    single-process dense run on the card to rtol 1e-4."""
    import json

    from _ranks import run_ranks
    from repro_torch.launch import train

    argv = ["--arch", "lram-bert-medium", "--smoke", "--steps", "3",
            "--batch", "4", "--seq", "32"]
    code = f"""
import json, sys
from repro_torch.kernels import e8_lookup, ops, sharded_gather
from repro_torch.launch import train
run = train.main({argv!r} + ["--placement", "sharded", "--use-mesh"])
print(json.dumps({{"records": run.records, "launches": [
    e8_lookup.lram_query.launches, sharded_gather.sharded_gather.launches,
    ops.lookup_bwd_range.launches]}}))
"""
    from repro_torch.kernels import _build

    _build.build_all()  # once, before the ranks load the libraries
    outs = run_ranks(code, 4, tmp_path, timeout=300)
    dense = train.main(argv + ["--placement", "pallas"])
    for out in outs:
        rank = json.loads(out.strip().splitlines()[-1])
        k2, gather, bwd = rank["launches"]
        assert k2 >= 3 and gather >= 3 and bwd == 3
        for a, b in zip(rank["records"], dense.records):
            np.testing.assert_allclose([a["loss"], a["grad_norm"]],
                                       [b["loss"], b["grad_norm"]],
                                       rtol=1e-4)


def _gather_case(device, n, m, top_k, queries, seed=0):
    """K2's top_k indices for n torus queries into a 2^16-row table of
    width m, uniform or clustered (64 queries near each of n / 64 points,
    as training's queries crowd rows): (spec, q, idx, w, the table, an
    upstream gradient g)."""
    spec = indexing.choose_torus(16)
    gen = torch.Generator(device=device).manual_seed(seed + n + m + top_k)
    K = torch.tensor(spec.K, dtype=torch.float32, device=device)
    q = torch.rand(n, 8, generator=gen, device=device) * K
    if queries == "clustered" and n >= 64:
        near = torch.arange(n, device=device) % (n // 64)
        q = (q[near] + 1e-3 * torch.rand(n, 8, generator=gen,
                                         device=device)).contiguous()
    with torch.no_grad():
        idx, w = e8_lookup.lram_query(q, spec, top_k)
    values = torch.randn(spec.num_locations, m, generator=gen,
                         device=device)
    g = torch.randn(n, m, generator=gen, device=device)
    return spec, q, idx, w, values, g


def _k1_split(values, idx, w, split):
    """K1 through its C entry with an explicit split (warps a query)."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.function("gather_interp", "gather_interp_f32_split",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
    out = torch.empty(idx.shape[0], values.shape[1], device=values.device)
    _build.check(fn(values.data_ptr(), idx.data_ptr(), w.data_ptr(),
                    out.data_ptr(), idx.shape[0], idx.shape[1],
                    values.shape[1], split, values.device.index,
                    torch.cuda.current_stream().cuda_stream), "K1 split")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [1, 8, 32, 33])
@pytest.mark.parametrize("m", [62, 64, 256])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 2048, 65536])
def test_k1_matches_plain_on_card(cuda_device, n, m, top_k):
    """K1 (gather_batched.cuh's body) against its plain version to 1e-5 on
    uniform and clustered queries, across the split threshold (n), the odd
    column and the 64-column loop (m) and one or two candidate batches
    (top_k): the split the entry picks and every split."""
    for queries in ("uniform", "clustered"):
        _, _, idx, w, values, _ = _gather_case(cuda_device, n, m, top_k,
                                               queries)
        want = gather_interp.gather_interp_plain(values, idx, w)
        before = gather_interp.gather_interp.launches
        got = gather_interp.gather_interp(values, idx, w)
        assert gather_interp.gather_interp.launches == before + 1
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for split in (1, 2, 4, 8):
            torch.testing.assert_close(_k1_split(values, idx, w, split),
                                       want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [1, 8, 32, 33])
@pytest.mark.parametrize("m", [62, 64, 256])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 2048, 65536])
def test_range_gather_matches_plain_on_card(cuda_device, n, m, top_k):
    """Row 9's range gather (the compacting body) against its plain
    version on fp32 (1e-5) and int8 / e4m3 shards (rtol 2e-5 / atol 1e-6),
    uniform and clustered queries, with every index in the shard (the
    whole table), none (a shard past the table's rows) and half (the upper
    half of the table)."""
    for queries in ("uniform", "clustered"):
        _, _, idx, w, values, _ = _gather_case(cuda_device, n, m, top_k,
                                               queries, seed=1)
        rows = values.shape[0]
        for base, shard_rows in ((0, rows), (rows, rows // 2),
                                 (rows // 2, rows // 2)):
            src = values[base % rows:base % rows + shard_rows]
            for kind in ("none", "int8", "fp8"):
                if kind == "none":
                    args, tol = (src.contiguous(),), (1e-5, 1e-5)
                    fn = sharded_gather.sharded_gather
                    plain = sharded_gather.sharded_gather_plain
                else:
                    pay, s = quant.quantize_rows_np(src.cpu().numpy(), kind)
                    args = (quant.as_torch_payload(pay).to(cuda_device),
                            torch.from_numpy(s).to(cuda_device))
                    tol = (2e-5, 1e-6)
                    fn = sharded_gather.sharded_gather_quant
                    plain = sharded_gather.sharded_gather_quant_plain
                got = fn(*args, idx, w, base)
                want = plain(*args, idx, w, base)
                torch.testing.assert_close(got, want, rtol=tol[0],
                                           atol=tol[1])
                if base == rows:
                    assert not got.any()


def _b4_split(q, scale, idx, w, split, wide):
    """B4 through its C entry with an explicit split and variant (wide 1:
    8-byte loads where they fit; 0: byte pairs)."""
    import ctypes

    from repro_torch.kernels import _build

    symbol = {torch.int8: "gather_interp_quant_i8_split",
              torch.float8_e4m3fn: "gather_interp_quant_e4m3_split"}
    fn = _build.function("gather_interp_quant", symbol[q.dtype],
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])
    out = torch.empty(idx.shape[0], q.shape[1], device=q.device)
    _build.check(fn(q.data_ptr(), scale.data_ptr(), idx.data_ptr(),
                    w.data_ptr(), out.data_ptr(), idx.shape[0], idx.shape[1],
                    q.shape[1], split, wide, q.device.index,
                    torch.cuda.current_stream().cuda_stream), "B4 split")
    return out


def _misaligned(q: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of the 1-byte table q whose base lies `offset` bytes past an
    8-byte boundary."""
    buf = torch.empty(q.numel() + 8, dtype=torch.uint8, device=q.device)
    flat = buf[offset:offset + q.numel()]
    flat.copy_(q.view(torch.uint8).reshape(-1))
    view = flat.view(q.dtype).view(q.shape)
    assert view.data_ptr() % 8 == offset
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [8, 32, 40])
@pytest.mark.parametrize("m", [64, 66, 128])
@pytest.mark.parametrize("n", [1, 128, 2048])
def test_b4_every_split_matches_plain_on_card(cuda_device, n, m, top_k):
    """B4 (gather_batched.cuh's body) on int8 and e4m3 tables, uniform and
    clustered queries, against its plain version (rtol 2e-5 / atol 1e-6):
    the entry's own choice, every split with the wide loads and with byte
    pairs, and tables whose base is 1, 2 or 4 bytes past an 8-byte
    boundary.  With one warp a query on byte pairs it adds in the old
    body's order, bit for bit: the order of K1's one-warp instance
    (itself bit-equal to the old body) on the payload as fp32 with the
    scale folded into the weight."""
    for queries in ("uniform", "clustered"):
        _, _, idx, w, values, _ = _gather_case(cuda_device, n, m, top_k,
                                               queries, seed=2)
        for kind in ("int8", "fp8"):
            q, s = _quantized(values, kind)
            want = gather_interp.gather_interp_quant_plain(q, s, idx, w)
            before = gather_interp.gather_interp_quant.launches
            got = gather_interp.gather_interp_quant(q, s, idx, w)
            assert gather_interp.gather_interp_quant.launches == before + 1
            torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
            for split in (1, 2, 4, 8):
                for wide in (0, 1):
                    torch.testing.assert_close(
                        _b4_split(q, s, idx, w, split, wide), want,
                        rtol=2e-5, atol=1e-6)
            ws = (w * s[idx.long()]).contiguous()
            assert torch.equal(_b4_split(q, s, idx, w, 1, 0),
                               _k1_split(quant.take_rows(
                                   q, torch.arange(q.shape[0],
                                                   device=cuda_device)),
                                   idx, ws, 1))
            for offset in (1, 2, 4):
                torch.testing.assert_close(
                    gather_interp.gather_interp_quant(
                        _misaligned(q, offset), s, idx, w),
                    want, rtol=2e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["dq", "dw"])
@pytest.mark.parametrize("top_k", [8, 32, 40])
@pytest.mark.parametrize("m", [64, 66, 128])
def test_backward_without_scatter_layouts_on_card(cuda_device, m, top_k,
                                                  stage):
    """Row 8's body in every instance without scatter, on both layouts
    (the wide one: 1-byte rows at m = 64 and 128; byte or fp32 pairs at
    m = 66 and for fp32 rows), uniform and clustered queries: the rows
    instances over a shuffled flat table (`lookup_bwd_rows`,
    `lookup_bwd_quant`), and the 1-byte range instances on a shard that
    holds all, none or half of the table, against `lookup_bwd_plain` (rtol
    1e-4 / atol 1e-5); a candidate outside the shard has a dw of exactly
    0."""
    for queries in ("uniform", "clustered"):
        spec, q, idx, w, values, g = _gather_case(cuda_device, 2048, m,
                                                  top_k, queries)
        extra = {"q": q, "spec": spec} if stage == "dq" else {}
        perm = torch.randperm(values.shape[0], device=cuda_device)
        rows = torch.argsort(perm)[idx.long()].int().contiguous()
        flat = values[perm].contiguous()
        for kind in ("none", "int8", "fp8"):
            table, scale = flat, None
            if kind != "none":
                table, scale = _quantized(flat, kind)
            fn = ops.lookup_bwd_rows if kind == "none" \
                else ops.lookup_bwd_quant
            args = (table, rows) if kind == "none" else (table, scale, rows)
            before = fn.launches
            got = fn(*args, w, g, **({"idx": idx, **extra}
                                     if stage == "dq" else {}))
            assert fn.launches == before + 1
            _, want = ops.lookup_bwd_plain(table, idx, w, g, extra.get("q"),
                                           spec, scale=scale, rows=rows,
                                           scatter=False)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        num = values.shape[0]
        for base, shard_rows in ((0, num), (num, num // 2),
                                 (num // 2, num // 2)):
            src = values[base % num:base % num + shard_rows]
            ok = sharded_gather.local_rows(idx, base, shard_rows)[1]
            for kind in ("int8", "fp8"):
                shard, scale = _quantized(src.contiguous(), kind)
                before = ops.lookup_bwd_range.launches
                dv, got = ops.lookup_bwd_range(shard, idx, w, g, base,
                                               scale=scale, **extra)
                assert ops.lookup_bwd_range.launches == before + 1
                assert dv is None
                _, want = ops.lookup_bwd_plain(
                    shard, idx, w, g, extra.get("q"), spec, scale=scale,
                    scatter=False, base=base)
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
                if stage == "dw":
                    assert not got[~ok].any()
                    if base == num:
                        assert not ok.any()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["lram-tiered", "lram-tiered-q8"])
def test_decode_graph_matches_eager_on_card(cuda_device, arch):
    """The dense pallas cells' decode tick as one CUDA graph (smoke
    config): one capture, every request's tokens those of the eager twin
    and the K2 / gather launch counts of the trace equal (a replay adds
    what the capture recorded).  A tiered placement runs eagerly."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

    cfg = configs.get_smoke_config(arch)
    dense = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    gather = (gather_interp.gather_interp if cfg.lram.table_quant == "none"
              else gather_interp.gather_interp_quant)
    runs = []
    for c, graph in ((dense, True), (dense, False), (cfg, True)):
        model = transformer.init(c, seed=0).to(cuda_device)
        engine = ServeEngine(model, EngineConfig(slots=2, max_len=16,
                                                 cuda_graph=graph))
        trace = synthetic_trace(np.random.default_rng(1), 4,
                                vocab_size=c.vocab_size, max_prompt=8,
                                max_gen=8)
        engine.warmup([r.prompt_len for r in trace])
        before = (e8_lookup.lram_query.launches, gather.launches)
        report = engine.run(trace)
        torch.cuda.synchronize()
        runs.append((report, e8_lookup.lram_query.launches - before[0],
                     gather.launches - before[1]))
    (g, g_k2, g_k1), (e, e_k2, e_k1), (t, _, _) = runs
    assert g.cuda_graph and g.graph_captures == 1
    assert g.graph_ticks == len(g.step_s) > 0
    assert not e.cuda_graph and e.graph_captures == 0
    assert not t.cuda_graph and t.graph_captures == 0  # host work: eager
    assert [r.tokens for r in g.requests] == [r.tokens for r in e.requests]
    assert g_k2 == e_k2 > 0 and g_k1 == e_k1 > 0


@pytest.mark.cuda
@pytest.mark.parametrize("warmup", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mixtral-8x7b",
                                  "mamba2-1.3b"])
def test_moe_and_ssm_decode_graph_matches_eager_on_card(cuda_device, arch,
                                                        dtype, warmup):
    """The MoE and SSM smoke archs with the memory FFN on `pallas`: the
    decode tick as one CUDA graph (one capture, every tick replayed; an
    SSM's state and conv window written in place under it) gives the
    eager twin's tokens, first logits and K2 / K1 launch counts.  Without
    `warmup` the capture comes at the first tick, on the served state."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace
    from repro_torch.serving.engine import _GRAPH_WARMUP

    cfg = configs.with_lram(configs.get_smoke_config(arch, dtype=dtype), 16)
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    runs = []
    for graph in (True, False):
        model = transformer.init(cfg, seed=0).to(cuda_device)
        engine = ServeEngine(model, EngineConfig(slots=2, max_len=16,
                                                 cuda_graph=graph))
        trace = synthetic_trace(np.random.default_rng(1), 4,
                                vocab_size=cfg.vocab_size, max_prompt=8,
                                max_gen=8)
        if warmup:
            engine.warmup([r.prompt_len for r in trace])
        before = (e8_lookup.lram_query.launches,
                  gather_interp.gather_interp.launches)
        report = engine.run(trace)
        torch.cuda.synchronize()
        runs.append((report, e8_lookup.lram_query.launches - before[0],
                     gather_interp.gather_interp.launches - before[1]))
    (g, g_k2, g_k1), (e, e_k2, e_k1) = runs
    assert g.cuda_graph and g.graph_captures == 1
    assert g.graph_ticks == len(g.step_s) > 0
    assert not e.cuda_graph and e.graph_captures == 0
    assert [r.tokens for r in g.requests] == [r.tokens for r in e.requests]
    for a, b in zip(g.requests, e.requests):
        np.testing.assert_array_equal(a.first_logits, b.first_logits)
    # a capture in the run adds its eager warm-up ticks' launches
    extra = 0 if warmup else _GRAPH_WARMUP * len(cfg.lram_layers)
    assert g_k2 - extra == e_k2 > 0 and g_k1 - extra == e_k1 > 0


@pytest.mark.cuda
@pytest.mark.parametrize("warmup", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_decode_graph_matches_eager_on_card(cuda_device, dtype,
                                                   warmup):
    """zamba2's smoke config (no memory layer: the reference allows none
    in a hybrid): the decode tick as one CUDA graph (one capture, every
    tick replayed; every unit's Mamba state and conv window written in
    place beside the shared block's K/V) gives the eager twin's tokens
    and first logits, and launches no kernel of the port.  Without
    `warmup` the capture comes at the first tick, on the served state
    (its warm-up ticks must not advance the state twice)."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

    cfg = configs.get_smoke_config("zamba2-2.7b", dtype=dtype)
    runs = []
    for graph in (True, False):
        model = transformer.init(cfg, seed=0).to(cuda_device)
        engine = ServeEngine(model, EngineConfig(slots=2, max_len=16,
                                                 cuda_graph=graph))
        trace = synthetic_trace(np.random.default_rng(1), 4,
                                vocab_size=cfg.vocab_size, max_prompt=8,
                                max_gen=8)
        if warmup:
            engine.warmup([r.prompt_len for r in trace])
        before = (e8_lookup.lram_query.launches,
                  gather_interp.gather_interp.launches)
        report = engine.run(trace)
        torch.cuda.synchronize()
        assert (e8_lookup.lram_query.launches,
                gather_interp.gather_interp.launches) == before
        runs.append(report)
    g, e = runs
    assert g.cuda_graph and g.graph_captures == 1
    assert g.graph_ticks == len(g.step_s) > 0
    assert not e.cuda_graph and e.graph_captures == 0
    assert [r.tokens for r in g.requests] == [r.tokens for r in e.requests]
    for a, b in zip(g.requests, e.requests):
        np.testing.assert_array_equal(a.first_logits, b.first_logits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-72b"])
def test_encdec_and_vlm_on_card_match_cpu(cuda_device, arch, dtype):
    """whisper-small's and qwen2-vl-72b's smoke configs with the memory
    FFN on `pallas` (K2 and K1 on the card, their plain versions on the
    CPU), the same weights and inputs (encoder frames; vision embeddings
    on a 2 x 2 frame with M-RoPE positions): the prefill's logits and 4
    decode steps' card against CPU, float32 to 1e-5, bfloat16 to 2^-8 x
    (layers + 1) x the largest logit; K2 and K1 launched on the card."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.with_lram(configs.get_smoke_config(arch, dtype=dtype), 16)
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    model = transformer.init(cfg, seed=0).eval()
    rng = np.random.default_rng(3)
    b, s, steps = 2, 8, 4
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + steps)))
    extras = {}
    if cfg.family == "encdec":
        extras["encoder_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32))
    else:
        extras["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
        patch = torch.arange(cfg.vision_tokens)
        pos = torch.empty((3, s), dtype=torch.long)
        pos[0, :4], pos[1, :4], pos[2, :4] = 0, patch // 2, patch % 2
        pos[:, 4:] = 2 + torch.arange(s - 4)
        extras["positions"] = pos[:, None].expand(3, b, s)
    got = {}
    for device in (cuda_device, torch.device("cpu")):
        model.to(device)
        before = (e8_lookup.lram_query.launches,
                  gather_interp.gather_interp.launches)
        with torch.no_grad():
            logits, cache = transformer.prefill(
                model, toks[:, :s].to(device), s + steps,
                **{k: v.to(device) for k, v in extras.items()})
            outs = [logits.float().cpu()]
            for t in range(s, s + steps):
                outs.append(transformer.decode_step(
                    model, toks[:, t:t + 1].to(device),
                    torch.full((b,), t, device=device), cache).float().cpu())
        launched = (e8_lookup.lram_query.launches - before[0],
                    gather_interp.gather_interp.launches - before[1])
        got[device.type] = outs
        if device.type == "cuda":
            assert launched[0] > 0 and launched[1] > 0
    for a, ref in zip(got["cuda"], got["cpu"]):
        assert torch.isfinite(a).all()
        if dtype == "float32":
            torch.testing.assert_close(a, ref, rtol=1e-5, atol=1e-5)
        else:
            tol = 2.0**-8 * (cfg.num_layers + 1) * ref.abs().max().item()
            assert (a - ref).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["lram-tiered", "lram-tiered-q8"])
def test_overlay_decode_graph_matches_eager_on_card(cuda_device, arch):
    """Per-tenant overlays under the decode graph (smoke config, dense
    pallas cell, 2 tenants): one capture across the whole multi-tenant
    trace (attach, write-back and detach only refresh the packs), every
    request's tokens and each tenant's overlay rows those of the eager
    twin (ids equal, payloads to 1e-6), and an anonymous trace through the
    overlay engine gives the overlay-free engine's tokens and first
    logits bit for bit."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

    cfg = configs.get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    model = transformer.init(cfg, seed=0).to(cuda_device)

    def run(graph, tenants, rows=4):
        engine = ServeEngine(model, EngineConfig(
            slots=2, max_len=16, cuda_graph=graph, overlay_rows=rows))
        trace = synthetic_trace(np.random.default_rng(1), 6,
                                vocab_size=cfg.vocab_size, max_prompt=8,
                                max_gen=8, tenants=tenants)
        engine.warmup([r.prompt_len for r in trace])
        report = engine.run(trace)
        torch.cuda.synchronize()
        return engine, report

    (ge, g), (ee, e) = run(True, 2), run(False, 2)
    assert g.cuda_graph and g.graph_captures == 1
    assert g.graph_ticks == len(g.step_s) > 0
    assert not e.cuda_graph and e.graph_captures == 0
    assert [r.tokens for r in g.requests] == [r.tokens for r in e.requests]
    assert g.overlay["writebacks"] == e.overlay["writebacks"] > 0
    for tid, ov in ge.overlays.overlays.items():
        twin = ee.overlays.overlays[tid]
        for layer in range(ov.num_layers):
            assert ov.packed_rows(layer) == twin.packed_rows(layer)
            for r in ov.packed_rows(layer):
                np.testing.assert_allclose(ov.read(layer, r),
                                           twin.read(layer, r), atol=1e-6)
    (_, anon), (_, plain) = run(True, 0), run(True, 0, rows=0)
    for a, b in zip(anon.requests, plain.requests):
        assert a.tokens == b.tokens
        np.testing.assert_array_equal(a.first_logits, b.first_logits)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["none", "int8", "fp8"])
def test_mmap_store_gathers_match_ram_on_card(cuda_device, kind, tmp_path):
    """An mmap-backed store on the card against its RAM twin: the same
    gathers bit for bit (B5 / B6 resident, K1 / B4 on the overflow
    route), the same fills."""
    rng = np.random.default_rng(5)
    dense = rng.normal(size=(8192, 64)).astype(np.float32)
    spec = TieredSpec(shard_rows=512, cache_slots=4, use_pallas=True,
                      quant=kind)
    ram = TieredValueStore.from_dense(dense, spec).to(cuda_device)
    mm = TieredValueStore.from_dense(dense, TieredSpec(
        shard_rows=512, cache_slots=4, use_pallas=True, quant=kind,
        backing="mmap", backing_dir=str(tmp_path))).to(cuda_device)
    assert isinstance(mm._host, np.memmap)
    for span in (2048, 8192):  # resident shards, then overflow rows
        idx = torch.from_numpy(rng.integers(0, span, (128, 32)).astype(
            np.int32)).to(cuda_device)
        w = torch.from_numpy(rng.random((128, 32)).astype(
            np.float32)).to(cuda_device)
        torch.testing.assert_close(mm.gather(idx, w), ram.gather(idx, w),
                                   rtol=0, atol=0)
    assert mm.stats == ram.stats


@pytest.mark.cuda
def test_obs_on_the_card_is_free_and_profiles_the_kernels(cuda_device,
                                                           tmp_path):
    """The dense pallas cell (smoke config) under the decode graph, served
    with obs off and then armed with a profile directory, the capture
    inside the profiled `serve.run` (no warm-up): one capture each, the
    same tokens and K2 / K1 launch counts, one `serve.decode_tick` span a
    tick, and the torch.profiler trace holds CUDA kernel events of K2 and
    K1 (its CUDA activities)."""
    import dataclasses
    import json
    import os

    from repro_torch import configs, obs
    from repro_torch.models import transformer
    from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

    cfg = configs.get_smoke_config("lram-tiered")
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, interp_impl="pallas"))
    runs = []
    try:
        for armed in (False, True):
            if armed:
                obs.configure(metrics_dir=str(tmp_path / "m"),
                              profile_dir=str(tmp_path / "p"))
            model = transformer.init(cfg, seed=0).to(cuda_device)
            engine = ServeEngine(model, EngineConfig(slots=2, max_len=16))
            trace = synthetic_trace(np.random.default_rng(1), 4,
                                    vocab_size=cfg.vocab_size, max_prompt=8,
                                    max_gen=8)
            before = (e8_lookup.lram_query.launches,
                      gather_interp.gather_interp.launches)
            report = engine.run(trace)
            torch.cuda.synchronize()
            runs.append((report, e8_lookup.lram_query.launches - before[0],
                         gather_interp.gather_interp.launches - before[1]))
        ticks = [s for s in obs.tracer().finished
                 if s.name == "serve.decode_tick"]
    finally:
        obs.disable()
    (off, k2, k1), (on, k2_on, k1_on) = runs
    assert off.graph_captures == on.graph_captures == 1
    assert [r.tokens for r in on.requests] == [r.tokens for r in off.requests]
    assert (k2_on, k1_on) == (k2, k1) and k2 > 0 and k1 > 0
    assert len(ticks) == len(on.step_s)
    (name,) = os.listdir(tmp_path / "p")
    events = json.loads((tmp_path / "p" / name).read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("lram_query" in k for k in kernels), sorted(kernels)[:20]
    assert any("gather" in k for k in kernels), sorted(kernels)[:20]


# ------------------------------------------- bfloat16 and float16 tables


def _k1_split(values, idx, w, split):
    """K1 through its C entry at an explicit split (not counted)."""
    import ctypes

    from repro_torch.kernels import _build

    suffix = gather_interp.TABLE_KINDS[values.dtype][0]
    out = torch.empty(idx.shape[0], values.shape[1], device=values.device)
    fn = _build.function(
        "gather_interp", f"gather_interp_{suffix}_split",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    _build.check(fn(values.data_ptr(), idx.data_ptr(), w.data_ptr(),
                    out.data_ptr(), idx.shape[0], idx.shape[1],
                    values.shape[1], split, values.device.index,
                    torch.cuda.current_stream().cuda_stream), "K1 split")
    return out


# a 2-byte table dtype -> its instances' launch counters
HALF = {
    torch.bfloat16: (gather_interp.gather_interp_bf16, ops.lookup_bwd_bf16,
                     ops.lookup_bwd_range_bf16,
                     sharded_gather.sharded_gather_bf16),
    torch.float16: (gather_interp.gather_interp_f16, ops.lookup_bwd_f16,
                    ops.lookup_bwd_range_f16,
                    sharded_gather.sharded_gather_f16),
}


def _ulps(a, b, dtype):
    """Elementwise distance of two fp32 tensors rounded to the 2-byte
    `dtype`, in its ulps."""
    def scale(t):
        x = t.to(dtype).view(torch.int16).int()
        return torch.where(x < 0, -32768 - x, x)
    return (scale(a) - scale(b)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("m", [64, 7])
@pytest.mark.parametrize("n", [1, 128, 2048, 65536])
def test_k1_half_bit_equal_to_fp32_instance_on_card(cuda_device, n, m,
                                                    dtype):
    """K1 on a bf16 or fp16 table: one launch counted on its dtype's
    instance (`gather_interp_bf16` / `_f16`), bit-equal to the fp32
    instance on `values.float()` (each row widened exactly, the same adds
    in the same order), at every split too, and within rtol 2e-5 / atol
    1e-6 of the plain version (K2's weights)."""
    spec, q, idx, w, values, _ = _bwd_inputs(cuda_device, n, m=m)
    vh = values.to(dtype)
    counter = HALF[dtype][0]
    before = (counter.launches, gather_interp.gather_interp.launches)
    out = gather_interp.gather_interp(vh, idx, w)
    assert (counter.launches, gather_interp.gather_interp.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(out, gather_interp.gather_interp(vh.float(), idx, w))
    torch.testing.assert_close(
        out, gather_interp.gather_interp_plain(vh, idx, w), rtol=2e-5,
        atol=1e-6)
    if n <= 2048:
        for split in (1, 2, 4, 8):
            assert torch.equal(_k1_split(vh, idx, w, split),
                               _k1_split(vh.float(), idx, w, split)), split


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("stage", ["dq", "dw"])
@pytest.mark.parametrize("n", [1, 128, 2048])
def test_lookup_bwd_half_matches_fp32_instance_on_card(cuda_device, stage,
                                                       n, dtype):
    """The backward's bf16 / fp16 scatter instances (dense, and on the
    upper half as a range shard): one launch each, counted on its dtype's
    `lookup_bwd_*` / `lookup_bwd_range_*`; dq / dw bit-equal to the fp32
    instance's on the widened rows (their sums run in lane and candidate
    order, which the placement does not touch); the fp32 dvalues to atol
    1e-5 of the fp32 instance's and the plain version's (a row's sum runs
    in placement order, which atomics set) and, rounded once to the
    table's dtype, within one of its ulps of the plain version's; dq / dw
    to rtol 1e-4 / atol 1e-5 of the plain version's."""
    spec, q, idx, w, values, g = _bwd_inputs(cuda_device, n)
    vh = values.to(dtype)
    extra = {"q": q, "spec": spec} if stage == "dq" else {}
    base = 2**19
    _, dense, ranged, _ = HALF[dtype]
    for counter, table, at in ((dense, vh, None),
                               (ranged, vh[base:].contiguous(), base)):
        def run(t):
            if at is None:
                return ops.lookup_bwd(t, idx, w, g, **extra)
            return ops.lookup_bwd_range(t, idx, w, g, at, **extra)

        before = counter.launches
        dv, small = run(table)
        assert counter.launches == before + 1
        dv32, small32 = run(table.float())
        dv_p, small_p = ops.lookup_bwd_plain(table, idx, w, g,
                                             extra.get("q"), spec, base=at)
        torch.cuda.synchronize()
        assert dv.dtype == torch.float32
        assert torch.equal(small, small32)
        torch.testing.assert_close(dv, dv32, rtol=0, atol=1e-5)
        torch.testing.assert_close(dv, dv_p, rtol=0, atol=1e-5)
        torch.testing.assert_close(small, small_p, rtol=1e-4, atol=1e-5)
        assert _ulps(dv, dv_p, dtype).max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("n", [1, 128, 2048, 32768])
def test_range_gather_half_bit_equal_to_fp32_instance_on_card(cuda_device,
                                                              n, dtype):
    """The range gather on both halves of a bf16 or fp16 table: one
    launch each, counted on its dtype's `sharded_gather_*`, bit-equal to
    the fp32 instance on the shard widened, within 2e-5 / 1e-6 of the
    plain version."""
    spec, q, idx, w, values, _ = _bwd_inputs(cuda_device, n)
    vh = values.to(dtype)
    counter = HALF[dtype][3]
    rows = 2**19
    for base in (0, rows):
        shard = vh[base:base + rows]
        before = counter.launches
        got = sharded_gather.sharded_gather(shard, idx, w, base)
        assert counter.launches == before + 1
        assert torch.equal(got, sharded_gather.sharded_gather(
            shard.float(), idx, w, base))
        torch.testing.assert_close(
            got, sharded_gather.sharded_gather_plain(shard, idx, w, base),
            rtol=2e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_dense_layer_gradient_on_card_matches_cpu(cuda_device, dtype):
    """`lram_apply` on the dense `pallas` cell with a bf16 or fp16 table:
    the forward and the gradients of x and of the table (in its dtype,
    rounded once: within one of its ulps, rtol 2^-7 / 2^-10) on the card
    against the CPU's plain versions."""
    from repro_torch.core import lram

    cfg = LRAMConfig(log2_locations=16, heads=4, interp_impl="pallas",
                     table_dtype=dtype)
    layer = lram.lram_init(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn(8, 16, cfg.in_dim, generator=torch.Generator()
                    .manual_seed(1))
    outs = []
    for device in ("cpu", cuda_device):
        layer_d = lram.lram_init(cfg).to(device)
        layer_d.load_state_dict(layer.state_dict())
        xd = x.to(device, copy=True).requires_grad_()
        y = lram.lram_apply(layer_d, xd)
        y.square().sum().backward()
        outs.append((y.detach().cpu(), xd.grad.cpu(),
                     layer_d.values.grad.float().cpu()))
    (y0, gx0, gv0), (y1, gx1, gv1) = outs
    assert layer.values.dtype == cfg.torch_table_dtype
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gx1, gx0, rtol=1e-4, atol=1e-5)
    ulp = 2**-7 if dtype == "bfloat16" else 2**-10
    torch.testing.assert_close(gv1, gv0, rtol=ulp, atol=1e-6)
