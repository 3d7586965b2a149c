"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where no NVIDIA GPU is present (the
kernels have no CPU interpret mode).  This file imports no JAX, so it
runs on a machine with a card and PyTorch only:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.core import indexing, lookup
from repro_torch.core.lram import LRAMConfig
from repro_torch.kernels import e8_lookup, gather_interp


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
