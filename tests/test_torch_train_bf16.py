"""Training the public archs in bfloat16 (qwen2-1.5b, mamba2-1.3b,
phi3.5-moe-42b-a6.6b), each with the paper's memory FFN
(`with_lram(..., 16)`, the `pallas` cell: the kernels' plain versions on
the CPU), held against the JAX package's `build_train_step` run op by op
(`jax.disable_jit()`, `tests/_families.py` says why), and resumed from
the port's own bfloat16 checkpoints through the training CLI.

Three Adam steps (lr 1e-3, the table's 10x, clip 1.0) from weights
converted bit for bit, on the reference's batches (2 x 16 tokens, one
shape for every arch so that the op-by-op runs share compiled
primitives):

* every step's loss and grad norm within `bf16_tol` (2^-8 x (layers + 1)
  x the reference's value);
* step 1's gradients (same weights, same batch) within the same relative
  bound of the reference's, leaf by leaf: |g - g_ref| <= 2^-8 x (layers
  + 1) x (|g_ref| + 2^-8 x G), G the reference's global gradient norm (a
  floor for a leaf whose gradient is rounding alone, such as attention's
  key bias, zero in exact arithmetic);
* the update itself: each of the port's steps, replayed through the
  reference's `adam_update` on the port's own parameters, moments and
  gradients before the step, gives the port's float32 moments bit for
  bit and its parameters after the step within one ulp (plus the last
  bits of float32 arithmetic), the bfloat16 ones bit for bit on all but
  2^-10 of them, once the gradients are clipped by the port's global
  norm (held to rtol 1e-5 of the reference's `global_norm`: the sum runs
  in another order).  A step that updated nothing, had the wrong sign
  or cast back to bfloat16 otherwise than by rounding to nearest fails
  here;
* the parameters after the three steps against the reference's run:
  the two runs' gradients differ by bfloat16 rounding, and Adam
  normalises each element's step, so an element whose gradient is near
  zero, or whose first moment cancels across the steps, moves apart by up
  to 2 eta a step (eta = lr x the leaf's multiplier): an element near
  zero, such as a bias that starts at 0, where Adam's first step is
  +-lr by the sign of a tiny gradient.  Each step moves an element by at
  most eta * c (c = sqrt(sum_i w_i^2 / u_i) over Adam's bias-corrected
  weights of the first and second moments, <= 1.0037 for 3 steps, taken
  as 1.01) plus half an ulp of rounding to the leaf's dtype.  So every
  element is within 2 x steps x (eta x 1.01 + ulp / 2) of the
  reference's, and at most 2% of the bfloat16 elements of an arch are
  more than one ulp apart: the ulp at the largest magnitude the element
  can have passed through (its start, or either end, plus steps x eta x
  1.01), as each step rounds there.

The leaves keep their dtypes: bfloat16 weights, a float32 table and
mamba's float32 `A_log` / `D` / `dt_bias`, Adam's moments float32.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import bf16_tol, model, pair
from repro import data as j_data
from repro import optim as j_optim
from repro.launch import train as j_train
from repro_torch import configs, optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed.fault import SimulatedFailure
from repro_torch.launch import convert, train
from repro_torch.optim import adam

ARCHS = ("qwen2-1.5b", "mamba2-1.3b", "phi3.5-moe-42b-a6.6b")
BATCH, SEQ, STEPS, LR = 2, 16, 3, 1e-3
ADAM_C = 1.01  # Adam's largest step over eta, 3 steps (module docstring)
LOG2 = 16


def ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One unit in the last place of `dtype` at |x| (x float32; 0 at 0)."""
    mant = {torch.bfloat16: 7, torch.float32: 23}[dtype]
    mag = x.abs()
    e = torch.floor(torch.log2(mag.clamp(min=torch.finfo(torch.float32)
                                          .tiny)))
    return torch.where(mag > 0, torch.exp2(e - mant), torch.zeros_like(mag))


def to_jax(t: torch.Tensor) -> jax.Array:
    """A CPU tensor as a JAX array of the same dtype and bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def cloned(d: dict) -> dict:
    return {k: v.detach().clone() for k, v in d.items()}


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """Both packages' three steps on one arch: (port cfg, the start and
    end parameters of the port, the reference's end parameters in the
    port's names, each package's (loss, grad norm) by step, the port's
    Adam state, the port's steps as (parameters, moments, step and
    gradients before, parameters and moments after), the reference's
    step-1 gradients in the port's names)."""
    arch = request.param
    j_cfg, params, state, cfg = pair(arch, "bfloat16")
    m = model(cfg, params, state).train()
    start = cloned(dict(m.named_parameters()))
    dcfg = j_data.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, objective=cfg.objective,
                             seed=0)
    batches = [j_data.get_batch(dcfg, step=s) for s in range(STEPS)]
    j_grads, j_adam = [], j_optim.adam_update

    def j_keeping(grads, *args, **kw):
        j_grads.append(grads)
        return j_adam(grads, *args, **kw)

    j_step = j_train.build_train_step(j_cfg, j_optim.OptimConfig(lr=LR))
    j_opt, residual, want = j_optim.adam_init(params), jnp.zeros(()), []
    j_optim.adam_update = j_keeping
    try:
        with jax.disable_jit():
            for b in batches:
                params, j_opt, state, residual, jm = j_step(
                    params, j_opt, state, residual,
                    jax.tree.map(jnp.asarray, b))
                want.append((float(jm["loss"]), float(jm["grad_norm"])))
    finally:
        j_optim.adam_update = j_adam
    steps, adam_update = [], optim.adam_update

    def keeping(params_, grads, opt_state_, *args, **kw):
        before = (cloned(params_), cloned(opt_state_["mu"]),
                  cloned(opt_state_["nu"]), opt_state_["step"].clone(),
                  cloned(grads))
        stats = adam_update(params_, grads, opt_state_, *args, **kw)
        steps.append((before, (cloned(params_), cloned(opt_state_["mu"]),
                               cloned(opt_state_["nu"]),
                               stats["grad_norm"].clone())))
        return stats

    step = train.build_train_step(m, optim.OptimConfig(lr=LR))
    opt_state = optim.adam_init(dict(m.named_parameters()))
    got = []
    optim.adam_update = keeping
    try:
        for b in batches:
            met = step(opt_state, train.batch_to(b, "cpu"))
            got.append((met["loss"].item(), met["grad_norm"].item()))
    finally:
        optim.adam_update = adam_update
    end = cloned(dict(m.named_parameters()))
    ref_end = convert.state_dict_from_jax(jax.tree.map(np.asarray, params),
                                          {}, cfg)
    ref_grads = convert.state_dict_from_jax(
        jax.tree.map(np.asarray, j_grads[0]), {}, cfg)
    return (cfg, start, end, ref_end, np.array(got), np.array(want),
            opt_state, steps, ref_grads)


def test_losses_match_jax_op_by_op(runs):
    cfg, _, _, _, got, want, *_ = runs
    print("losses", got[:, 0], want[:, 0])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0,
                               atol=bf16_tol(cfg, want[:, 0]))


def test_grad_norms_match_jax_op_by_op(runs):
    cfg, _, _, _, got, want, *_ = runs
    print("grad norms", got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0,
                               atol=bf16_tol(cfg, want[:, 1]))


def test_step1_gradients_match_jax_op_by_op(runs):
    """Leaf by leaf |g - g_ref| <= 2^-8 x (layers + 1) x (|g_ref| + 2^-8 x
    G) in the L2 norm (module docstring), each in its leaf's dtype."""
    cfg, *_, steps, ref_grads = runs
    grads = steps[0][0][4]
    assert set(grads) == set(ref_grads)
    rel = 2.0**-8 * (cfg.num_layers + 1)
    total = math.sqrt(sum(float(g.float().square().sum())
                          for g in ref_grads.values()))
    worst = []
    for k, g in grads.items():
        want = ref_grads[k]
        assert g.dtype == want.dtype, k
        err = float((g.float() - want.float()).norm())
        bound = rel * (float(want.float().norm()) + 2.0**-8 * total)
        assert err <= bound, (k, err, bound)
        worst.append((err / bound, k))
    print(cfg.name, "largest error over its bound:", max(worst))


def test_adam_update_matches_reference_on_the_ports_gradients(runs):
    """Each of the port's steps replayed through the reference's
    `adam_update` (op by op) on the port's own state before it: the clip's
    global norm to rtol 1e-5 (`global_norm`, summed in another order),
    then, with the gradients clipped by the port's norm, the float32
    moments bit for bit, every parameter after the step within one ulp of
    its dtype plus 2^-20 x eta x 1.01 (XLA's and torch's float32 divide
    and square root may differ in the last bits of the step, which is at
    most eta x 1.01), the bfloat16 elements bit for bit on all but 2^-10
    of them, the dtypes kept (module docstring)."""
    cfg, *_, steps, _ = runs
    for t, ((params, mu, nu, step, grads),
            (p_after, mu_after, nu_after, gnorm)) in enumerate(steps):
        np.testing.assert_allclose(
            gnorm.item(), float(j_optim.global_norm(
                {k: to_jax(g) for k, g in grads.items()})), rtol=1e-5)
        scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
        with jax.disable_jit():
            new_p, new_opt, _ = j_optim.adam_update(
                {k: to_jax(g.float() * scale) for k, g in grads.items()},
                {"mu": {k: to_jax(v) for k, v in mu.items()},
                 "nu": {k: to_jax(v) for k, v in nu.items()},
                 "step": to_jax(step)},
                {k: to_jax(p) for k, p in params.items()},
                j_optim.OptimConfig(lr=LR, grad_clip=0.0))
        differ = total = 0
        for k, p in p_after.items():
            want = convert.tensor_from_numpy(np.asarray(new_p[k]))
            assert p.dtype == want.dtype == params[k].dtype, k
            assert mu_after[k].dtype == nu_after[k].dtype == torch.float32
            a, b = p.float(), want.float()
            eta = LR * adam.lr_mult(k, optim.OptimConfig(lr=LR))
            u = ulp(torch.maximum(a.abs(), b.abs()), p.dtype)
            assert bool(((a - b).abs() <= u + 2.0**-20 * eta * ADAM_C)
                        .all()), (t, k, float((a - b).abs().max()))
            if p.dtype == torch.bfloat16:
                differ += int((a != b).sum())
                total += p.numel()
            for got, moment in ((mu_after, "mu"), (nu_after, "nu")):
                np.testing.assert_array_equal(
                    got[k].numpy(), np.asarray(new_opt[moment][k]),
                    err_msg=f"step {t} {moment} {k}")
        assert differ <= total * 2.0**-10, (t, differ, total)
        print(f"{cfg.name} step {t}: {differ} of {total} elements differ "
              f"from the reference's update by an ulp")


def test_parameters_within_adams_bound(runs):
    """Every element within 2 x steps x (eta x 1.01 + ulp / 2) of the
    reference's run, at most 2% of the bfloat16 elements more than one
    ulp (at the largest magnitude passed through) apart, every leaf in
    its dtype and Adam's moments float32 (module docstring)."""
    cfg, start, end, ref_end, *_, opt_state, _, _ = runs
    assert set(end) == set(ref_end)
    beyond = total = 0
    for k, p in end.items():
        want = ref_end[k]
        assert p.dtype == want.dtype == start[k].dtype, k
        assert opt_state["mu"][k].dtype == torch.float32, k
        a, b, p0 = p.float(), want.float(), start[k].float()
        eta = LR * adam.lr_mult(k, optim.OptimConfig(lr=LR))
        mag = torch.maximum(torch.maximum(a.abs(), b.abs()), p0.abs())
        u = ulp(mag, p.dtype)
        diff = (a - b).abs()
        bound = 2 * STEPS * (eta * ADAM_C + u / 2)
        assert bool((diff <= torch.maximum(u, bound)).all()), (
            k, float(diff.max()), float((diff - bound).max()))
        if p.dtype == torch.bfloat16:
            passed = ulp(mag + STEPS * eta * ADAM_C, p.dtype)
            beyond += int((diff > passed).sum())
            total += p.numel()
    print(f"{cfg.name}: {beyond} of {total} bfloat16 elements more than "
          f"one ulp from the reference's")
    assert beyond <= 0.02 * total, (beyond, total)


# ---------------------------------------------------------------------------
# the chunked SSD scan's backward where a chunk's decay overflows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt_value", [0.05, 3.0], ids=["small", "overflow"])
def test_chunked_scan_gradients(dt_value):
    """`ssd_chunked`'s forward and gradients against the JAX package's.
    With steps of 3.0 and A = -16 the log decay spans 45 a position, and
    exp(cl_i - cl_j) of the masked upper triangle overflows: the
    reference's gradients are NaN there (ROADMAP C8: its 0 * inf), the
    port masks before the exp and gives the sequential scan's (JAX's
    `ssd_sequential`, which no overflow reaches) to 1e-5.  With small
    steps both chunked scans agree to 1e-5."""
    from repro.models import mamba2 as j_mamba2
    from repro_torch.models import mamba2

    rng = np.random.default_rng(4)
    b, s, h, p, g, n = 2, 16, 2, 4, 1, 4
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    B, C = (rng.standard_normal((b, s, g, n)).astype(np.float32)
            for _ in range(2))
    dt = np.full((b, s, h), dt_value, np.float32)
    A = np.array([-16.0, -1.0], np.float32)

    def j_grads(fn):
        return jax.value_and_grad(lambda *a: fn(*a, jnp.asarray(A))[0].sum(),
                                  argnums=(0, 1, 2, 3))(x, B, C, dt)

    j_y, j_chunked = j_grads(lambda *a: j_mamba2.ssd_chunked(*a, chunk=8))
    _, j_seq = j_grads(j_mamba2.ssd_sequential)
    ts = [torch.tensor(t, requires_grad=True) for t in (x, B, C, dt)]
    y = mamba2.ssd_chunked(*ts, torch.tensor(A), chunk=8)[0].sum()
    y.backward()
    np.testing.assert_allclose(y.item(), float(j_y), rtol=1e-6)
    overflow = dt_value > 1
    assert all(np.isfinite(np.asarray(g)).all() for g in j_chunked) \
        is not overflow
    want = j_seq if overflow else j_chunked
    for t, w in zip(ts, want):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints through the CLI
# ---------------------------------------------------------------------------

def bf16_smoke(get):
    """`get_smoke_config` in bfloat16 with the memory FFN (2^16 rows)."""
    def smoke(name, **kw):
        return configs.with_lram(get(name, **{"dtype": "bfloat16", **kw}),
                                 LOG2)
    return smoke


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_checkpoint_resume_is_bit_for_bit(arch, tmp_path, capsys,
                                               monkeypatch):
    """`train --smoke` on the bfloat16 config (the registry replaced: the
    smoke configs are float32), checkpoints every 2 steps, a failure
    before step 3, a relaunch: it resumes from step 2 and every step's
    loss and grad norm equals the uninterrupted run's bit for bit.  The
    checkpoint holds the bfloat16 leaves as bfloat16 (`<V2` files, the
    reference's) beside float32 moments and tables."""
    monkeypatch.setattr(configs, "get_smoke_config",
                        bf16_smoke(configs.get_smoke_config))
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--placement",
            "pallas", "--batch", "2", "--seq", "16", "--steps", "4",
            "--json"]
    full = train.main(argv)
    ckpt = argv + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with pytest.raises(SimulatedFailure, match="step 3"):
        train.main(ckpt + ["--simulate-failure-at", "3"])
    crashed = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith('{"step"')][-3:]
    resumed = train.main(ckpt)
    assert "resumed from step 2\n" in capsys.readouterr().out
    assert [r["step"] for r in resumed.records] == [2, 3]
    key = ("loss", "grad_norm", "aux")
    straight = [[r[k] for k in key] for r in full.records]
    assert [[r[k] for k in key] for r in crashed] == straight[:3]
    assert [[r[k] for k in key] for r in resumed.records] == straight[2:]
    assert np.isfinite(straight).all()
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    step_dir = os.path.join(str(tmp_path), "step_000000000004")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    dtypes = {}
    for meta in leaves.values():
        arr = np.load(os.path.join(step_dir, meta["file"]))
        dtypes.setdefault(meta["dtype"], set()).add(arr.dtype.str)
    assert dtypes["bfloat16"] == {"|V2"}, dtypes
    assert dtypes["float32"] == {"<f4"}, dtypes
    params = {n[len("params/"):]: meta["dtype"]
              for n, meta in leaves.items() if n.startswith("params/")}
    for moment in ("mu", "nu"):
        assert {n[len(f"opt/{moment}/"):]: meta["dtype"]
                for n, meta in leaves.items()
                if n.startswith(f"opt/{moment}/")} == dict.fromkeys(
                    params, "float32")
    assert [params[n] for n in params if "lram/values" in n] == ["float32"]
    assert "bfloat16" in params.values()
