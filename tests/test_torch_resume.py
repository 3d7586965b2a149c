"""Crash and resume through the port's training CLI, on the CPU: after
`--simulate-failure-at`, a relaunch with the same `--ckpt-dir` resumes
from the newest checkpoint and gives the uninterrupted run's losses; a
checkpoint the JAX package's train step wrote resumes in the port to the
losses of a JAX relaunch; `serve --ckpt-dir` serves the trained weights.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro import data as j_data
from repro import optim as j_optim
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import lookup as j_lookup
from repro.launch import train as j_train
from repro.models import transformer as j_tf
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed.fault import SimulatedFailure
from repro_torch.launch import serve, train
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace

ARGS = ["--smoke", "--device", "cpu", "--json", "--batch", "2", "--seq",
        "16", "--steps", "6"]


def _steps(out: str) -> list[dict]:
    return [json.loads(x) for x in out.splitlines()
            if x.startswith('{"step"')]


@pytest.fixture
def deterministic():
    """The plain-autograd cell's table gradient (an indexed accumulate)
    adds in thread order on the CPU unless deterministic algorithms are
    on; the reference's XLA scatter is deterministic."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("arch", ["lram-bert-small", "lram-bert-pkm",
                                  "lram-tiered", "lram-tiered-q8"])
def test_resume_after_a_simulated_failure(arch, tmp_path, capsys,
                                          deterministic):
    """Saves every 3 steps, a failure before step 4, a relaunch: it
    prints `resumed from step 3` and steps 3-5 give the uninterrupted
    run's losses and grad norms bit for bit.  For the int8 tiered table
    only step 3: the write-back's stochastic rounding then draws from a
    fresh generator, as the reference's relaunch does."""
    argv = ["--arch", arch, *ARGS]
    full = _steps_of(train.main(argv))
    capsys.readouterr()
    ckpt = argv + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    with pytest.raises(SimulatedFailure, match="step 4"):
        train.main(ckpt + ["--simulate-failure-at", "4"])
    crashed = _steps(capsys.readouterr().out)
    assert [r["step"] for r in crashed] == [0, 1, 2, 3]
    resumed = train.main(ckpt)
    out = capsys.readouterr().out
    assert "resumed from step 3\n" in out
    assert resumed.start_step == 3
    assert [r["step"] for r in resumed.records] == [3, 4, 5]
    got = [(r["loss"], r["grad_norm"]) for r in crashed[:3]
           + resumed.records]
    n = 4 if arch == "lram-tiered-q8" else 6
    assert got[:n] == full[:n]
    assert crashed[3]["loss"] == resumed.records[0]["loss"]
    assert CheckpointManager(str(tmp_path)).all_steps() == [3, 6]


def _steps_of(run):
    return [(r["loss"], r["grad_norm"]) for r in run.records]


@pytest.mark.parametrize("arch", ["lram-bert-small", "lram-tiered-q8"])
def test_jax_checkpoint_resumes_in_the_port(arch, tmp_path):
    """The JAX package trains 2 steps (its train step, its stores bound and
    warmed as its CLI binds them) and saves; the port's CLI resumes from
    that checkpoint and its next 3 losses and grad norms are within rtol
    1e-4 of a JAX relaunch that restores it into a fresh, warmed tree."""
    k, batch, seq = 2, 2, 16
    j_cfg = j_configs.get_smoke_config(arch)
    opt_cfg = j_optim.OptimConfig(lr=1e-4)
    dcfg = j_data.DataConfig(vocab_size=j_cfg.vocab_size, seq_len=seq,
                             global_batch=batch, objective=j_cfg.objective,
                             seed=0)

    def launch():
        params, state = j_tf.init(jax.random.PRNGKey(0), j_cfg)
        for _, store in j_lookup.find_stores(params):
            store.writeback_lr = 1e-3
            store.warm()
        return {"params": params, "opt": j_optim.adam_init(params),
                "model_state": state}

    def run(tree, steps):
        step_fn = j_train.build_train_step(j_cfg, opt_cfg)
        params, opt, state = tree["params"], tree["opt"], tree["model_state"]
        residual, out = jnp.zeros(()), []
        for s in steps:
            params, opt, state, residual, m = step_fn(
                params, opt, state, residual,
                jax.tree.map(jnp.asarray, j_data.get_batch(dcfg, step=s)))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return {"params": params, "opt": opt, "model_state": state}, out

    trained, _ = run(launch(), range(k))
    mgr = JCheckpointManager(str(tmp_path))
    mgr.save(k, trained)
    found, restored = mgr.restore(launch(), step=k)
    assert found == k
    _, want = run(restored, range(k, k + 3))
    got = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", str(k + 3), "--batch", str(batch),
                      "--seq", str(seq), "--ckpt-dir", str(tmp_path)])
    assert got.start_step == k
    np.testing.assert_allclose(_steps_of(got), want, rtol=1e-4)


def test_serve_restores_the_trained_model(tmp_path, capsys):
    """`serve --ckpt-dir` on the CPU serves what `train` saved: the first
    logits of every request equal those of the trained model itself, to
    1e-5 (the tiered table streamed into a fresh store)."""
    run = train.main(["--arch", "lram-tiered", *ARGS, "--steps", "3",
                      "--ckpt-dir", str(tmp_path)])
    capsys.readouterr()
    argv = ["--arch", "lram-tiered", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "4", "--json"]
    report = serve.main(argv + ["--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0]) == {"restored_step": 3}
    trace = synthetic_trace(np.random.default_rng(0), 4,
                            vocab_size=run.model.cfg.vocab_size,
                            max_prompt=8, max_gen=4)
    want = ServeEngine(run.model, EngineConfig(slots=2, max_len=12)).run(
        trace)
    assert len(report.requests) == len(want.requests) == 4
    for a, b in zip(report.requests, want.requests):
        np.testing.assert_allclose(a.first_logits, b.first_logits,
                                   atol=1e-5)
    with pytest.raises(SystemExit, match="no restorable checkpoint"):
        serve.main(argv + ["--ckpt-dir", str(tmp_path / "empty")])
