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
