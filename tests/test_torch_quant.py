"""Port parity: quantized storage (`repro_torch.quant`) and kernel B4's
plain version, against the JAX package.

The codec must give bit-equal payloads and scales (fp8 compared as bytes);
B4's plain version is held against `gather_interp_quant_pallas` run in
interpret mode; the dense int8/fp8 lookup cells against the reference's
layer on the same payload.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as j_quant
from repro.core import lram as j_lram
from repro.kernels import gather_interp as j_gather
from repro_torch import quant
from repro_torch.core import lookup, lram
from repro_torch.kernels import gather_interp

KINDS = ("int8", "fp8")


def _payload_bytes(q: np.ndarray) -> np.ndarray:
    """A reference payload in the port's host form: int8 stays int8, an
    fp8 array (an ml_dtypes dtype) becomes its uint8 bytes."""
    return q if q.dtype == np.int8 else q.view(np.uint8)


@pytest.mark.parametrize("kind", KINDS)
def test_codec_payloads_and_scales_bit_equal(kind):
    """x / scale, round half to even, clip: payload bytes and scales equal
    the reference's bit for bit, over normal rows, rows with exact ties
    and an all-zero row."""
    rng = np.random.default_rng(0)
    v = (rng.normal(size=(512, 64)) * 0.02).astype(np.float32)
    v[0] = 0.0
    v[1, :4] = [127.0, 0.5, -1.5, 2.5]  # ties on the int8 grid
    q, s = quant.quantize_rows_np(v, kind)
    jq, js = j_quant.quantize_rows_np(v, kind)
    assert q.dtype == quant.storage_dtype(kind) and q.dtype.itemsize == 1
    np.testing.assert_array_equal(q, _payload_bytes(jq))
    np.testing.assert_array_equal(s.view(np.uint32),
                                  np.asarray(js, np.float32).view(np.uint32))
    np.testing.assert_array_equal(quant.dequantize_rows_np(q, s),
                                  j_quant.dequantize_rows_np(jq, js))


def test_codec_constants_match_reference():
    for kind in KINDS:
        assert quant.qmax(kind) == j_quant.qmax(kind)
        assert quant.bytes_per_entry(64, kind) \
            == j_quant.bytes_per_entry(64, kind) == 68
    assert quant.bytes_per_entry(64, None) == 256
    q, s = quant.quantize_int8(np.array([0.3, -2.0, 1.0], np.float32))
    jq, js = j_quant.quantize_int8(np.array([0.3, -2.0, 1.0], np.float32))
    np.testing.assert_array_equal(q, jq)
    assert s == js
    with pytest.raises(ValueError):
        quant.check_kind("int4")


@pytest.mark.parametrize("kind", KINDS)
def test_b4_plain_matches_pallas(kind):
    """B4's plain version (the wrapper on CPU tensors) against
    gather_interp_quant_pallas in interpret mode, rtol 2e-5 / atol 1e-6:
    both fold the scale into the weight before the fp32 sum."""
    rng = np.random.default_rng(3)
    v = rng.normal(size=(512, 64)).astype(np.float32)
    q, s = quant.quantize_rows_np(v, kind)
    jq, js = j_quant.quantize_rows_np(v, kind)
    idx = rng.integers(0, 512, size=(2, 5, 32)).astype(np.int32)
    w = rng.uniform(0, 1, size=(2, 5, 32)).astype(np.float32)
    before = gather_interp.gather_interp_quant.launches
    got = gather_interp.gather_interp_quant(
        quant.as_torch_payload(q), torch.from_numpy(s),
        torch.from_numpy(idx), torch.from_numpy(w))
    assert gather_interp.gather_interp_quant.launches == before
    want = j_gather.gather_interp_quant_pallas(
        jnp.asarray(jq), jnp.asarray(js), jnp.asarray(idx), jnp.asarray(w),
        interpret=True)
    assert got.shape == (2, 5, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_quantized_gather_within_max_abs_error_bound(kind):
    """|B4 - fp32 gather| <= max_abs_error_bound, and the bound equals the
    reference's."""
    rng = np.random.default_rng(4)
    v = (rng.normal(size=(4096, 64)) * 0.02).astype(np.float32)
    table = quant.QuantizedTable.from_dense(v, kind)
    idx = torch.from_numpy(rng.integers(0, 4096, size=(64, 32))
                           .astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    out_q = gather_interp.gather_interp_quant(table.q, table.scale, idx, w)
    out_fp = gather_interp.gather_interp_plain(torch.from_numpy(v), idx, w)
    bound = quant.max_abs_error_bound(table.scale, w, kind)
    assert bound == pytest.approx(j_quant.max_abs_error_bound(
        table.scale.numpy(), w.numpy(), kind), rel=1e-6)
    assert (out_q - out_fp).abs().max().item() <= bound + 1e-6


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kernel", ["reference", "pallas"])
def test_dense_quantized_cells_match_reference_layer(kind, kernel):
    """The dense int8/fp8 cells: the port's layer on the reference's
    payload (carried bit for bit) against the reference's layer, to
    1e-5 (the reference dequantizes before weighting)."""
    kw = dict(log2_locations=16, heads=4, query_norm="rms",
              table_quant=kind)
    j_cfg = j_lram.LRAMConfig(**kw)
    params, state = j_lram.lram_init(jax.random.PRNGKey(1), j_cfg)
    cfg = lram.LRAMConfig(lookup_kernel=kernel, **kw)
    plan = lookup.resolve(cfg)
    assert plan.cell == ("dense", kind, kernel)
    layer = lram.LRAM(cfg)
    table = params["values"]
    layer.values = plan.table_from_payload(
        _payload_bytes(np.asarray(table.q)), np.asarray(table.scale))
    layer.qnorm.scale.data = torch.from_numpy(
        np.array(params["qnorm"]["scale"]))
    assert isinstance(layer.values, quant.QuantizedTable)
    np.testing.assert_array_equal(
        layer.values.q.view(torch.uint8).numpy(),
        np.asarray(table.q).view(np.uint8))
    x = np.random.default_rng(5).normal(size=(3, 7, 64)).astype(np.float32)
    y = lram.lram_apply(layer, torch.from_numpy(x))
    jy, _ = j_lram.lram_apply(params, state, jnp.asarray(x), j_cfg)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def test_quantized_table_is_a_module_of_buffers():
    v = np.random.default_rng(6).normal(size=(64, 8)).astype(np.float32)
    t = quant.QuantizedTable.from_dense(v, "fp8")
    assert t.q.dtype == torch.float8_e4m3fn and t.scale.shape == (64,)
    assert set(t.state_dict()) == {"q", "scale"}
    assert (t.num_rows, t.m) == (64, 8)
    np.testing.assert_allclose(t.dequantize().numpy(),
                               quant.dequantize_rows_np(
                                   t.q.view(torch.uint8).numpy(),
                                   t.scale.numpy()))
    with pytest.raises(TypeError):
        quant.QuantizedTable(t.q, t.scale, "int8")
