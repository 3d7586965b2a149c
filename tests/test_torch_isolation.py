"""The port stands alone: `repro_torch` (its `memctl` lifecycle package
and its overlay modules included) and `chip_smoke.py` import neither
JAX, nor the JAX package, nor `ml_dtypes` (the card's machine lacks it),
and import no triton or CUDA build at import; a CPU serve with a live
spill, multi-tenant serves with the overlay lifecycle, a serve from an
mmap-backed table, serves of the dense public archs (one with the memory
FFN, one in bfloat16, the sliding window's ring), serves of the MoE, SSM
and hybrid archs, a dry-run cell on meta tensors, a training run with
growth and telemetry, and a serve and a training run with obs armed
(`--metrics-dir`, `--profile-dir`) load none of them either."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import configs

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)(\.|\s)"
    r"|import\s+(triton|ml_dtypes)|from\s+(triton|ml_dtypes))", re.M)


def _port_files():
    """The port, chip_smoke.py and the port's tools (the card A/B and
    sweep tools and the L2 model)."""
    tools = [REPO / "tools" / f"{name}.py"
             for name in ("kernel_ab", "gather_sweep", "l2_order_model")]
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + tools


def test_port_files_have_no_forbidden_imports():
    files = _port_files()
    assert len(files) > 20
    # the lifecycle package is the port's own copy (no numpy-only module
    # of the JAX package either)
    assert {f.name for f in files if f.parent.name == "memctl"} == {
        "__init__.py", "telemetry.py", "growth.py", "migrate.py",
        "controller.py"}
    # and so are the per-tenant overlays
    assert {str(f.relative_to(PORT)) for f in files
            if f.name == "overlay.py"} == {"core/overlay.py",
                                           "serving/overlay.py"}
    # and so is the observability package
    assert {f.name for f in files if f.parent.name == "obs"} == {
        "__init__.py", "registry.py", "trace.py", "export.py"}
    # and so are the public archs' configs (dense, MoE, SSM, hybrid,
    # enc-dec, VLM)
    assert {f.name for f in files if f.parent.name == "configs"} >= {
        "yi_9b.py", "qwen2_1_5b.py", "starcoder2_3b.py",
        "h2o_danube3_4b.py", "phi3_5_moe.py", "mixtral_8x7b.py",
        "mamba2_1_3b.py", "zamba2_2_7b.py", "whisper_small.py",
        "qwen2_vl_72b.py"}
    # and so are the dry-run and its analysis (the shape set, the
    # collective tally, the roofline)
    assert {f.name for f in files if f.parent.name == "analysis"} == {
        "__init__.py", "collectives.py", "roofline.py"}
    assert PORT / "launch" / "dryrun.py" in files
    assert PORT / "configs" / "shapes.py" in files
    # and so are the MoE and SSM blocks
    assert {str(f.relative_to(PORT)) for f in files
            if f.name in ("moe.py", "mamba2.py")} == {"models/moe.py",
                                                     "models/mamba2.py"}
    bad = {str(f.relative_to(REPO)): m.group(0).strip()
           for f in files for m in [FORBIDDEN.search(f.read_text())] if m}
    assert not bad, bad


@pytest.mark.parametrize("line,hit", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from repro.core import lram", True), ("import repro", True),
    ("from repro_torch.core import lram", False),
    ("import repro_torch", False), ("    import triton", True),
    ("import ml_dtypes", True), ("from ml_dtypes import float8_e4m3fn", True),
])
def test_forbidden_pattern(line, hit):
    assert bool(FORBIDDEN.search(line)) == hit


def test_import_and_cpu_serve_leave_no_jax_modules():
    code = """
import importlib, json, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.launch import serve
served = 0
for args in (["--placement", "pallas"], [], ["--arch", "lram-tiered-q8"]):
    rep = serve.main(args + ["--smoke", "--device", "cpu", "--batch", "1",
                             "--prompt-len", "4", "--gen", "2",
                             "--requests", "1"])
    served += len(rep.requests)
rep = serve.main(["--placement", "pallas", "--spill-at-tick", "1",
                  "--smoke", "--device", "cpu", "--batch", "1",
                  "--prompt-len", "4", "--gen", "3", "--requests", "1"])
served += len(rep.requests)
for args in (["--tenants", "2"], ["--arch", "lram-tiered-q8", "--tenants",
                                  "2", "--overlay-ttl", "1"]):
    rep = serve.main(args + ["--smoke", "--device", "cpu", "--batch", "1",
                             "--prompt-len", "4", "--gen", "3",
                             "--requests", "1"])
    served += len(rep.requests)
import dataclasses, numpy as np, tempfile
from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, ServeEngine, synthetic_trace
cfg = configs.get_smoke_config("lram-tiered")
with tempfile.TemporaryDirectory() as d:
    cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
        cfg.lram, tiered=dataclasses.replace(cfg.lram.tiered,
                                             backing="mmap",
                                             backing_dir=d)))
    rep = ServeEngine(transformer.init(cfg), EngineConfig(
        slots=1, max_len=8, overlay_rows=4)).run(synthetic_trace(
            np.random.default_rng(0), 1, vocab_size=256, max_prompt=4,
            max_gen=3, tenants=1))
    served += len(rep.requests)
for arch in configs.ARCHS:
    if configs.get_smoke_config(arch).family in ("encdec", "vlm"):
        continue  # the engine refuses them, as the reference's does
    rep = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "1", "--prompt-len", "10", "--gen", "2",
                      "--requests", "1", "--warmup"])
    served += len(rep.requests)
cfg = configs.with_lram(configs.get_smoke_config(
    "h2o-danube-3-4b", dtype="bfloat16"), 16)
cfg = dataclasses.replace(cfg, lram=dataclasses.replace(
    cfg.lram, interp_impl="pallas"))
rep = ServeEngine(transformer.init(cfg), EngineConfig(slots=1, max_len=14)
                  ).run(synthetic_trace(np.random.default_rng(0), 1,
                                        vocab_size=256, max_prompt=11,
                                        max_gen=3))
served += len(rep.requests)
from repro_torch.launch import train
run = train.main(["--arch", "lram-bert-medium", "--smoke", "--device", "cpu",
                  "--placement", "pallas", "--steps", "2", "--batch", "2",
                  "--seq", "8", "--grow-at", "1:17", "--telemetry"])
from repro_torch.analysis import roofline
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import dryrun
art = dryrun.run_cell("yi-9b", "train", False,
                      cfg=configs.get_smoke_config("yi-9b"),
                      cell=ShapeCell("train", 8, 2, "train"),
                      mesh_shape=(1, 2))
assert roofline.analyze_artifact(dict(art, shape="train_4k"))
bad = sorted(n for n in sys.modules if n.split(".")[0]
             in ("jax", "jaxlib", "repro", "triton", "ml_dtypes"))
print(json.dumps({"bad": bad, "requests": served,
                  "train_steps": len(run.records)}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    # 7 serves of the memory archs, one of each public arch the engine
    # serves (configs.ARCHS less the enc-dec and VLM archs: 4 dense, 1
    # hybrid, 2 MoE, 1 SSM) and the bfloat16 danube with its memory FFN
    assert len(configs.ARCHS) == 10
    assert out == {"bad": [], "requests": 7 + len(configs.ARCHS) - 2 + 1,
                   "train_steps": 2}


def test_cpu_serve_and_train_with_obs_leave_no_jax_modules(tmp_path):
    """A CPU serve with `--metrics-dir --profile-dir` (torch.profiler) and
    a CPU training run with `--metrics-dir --telemetry` write their files
    and load none of jax, the JAX package, ml_dtypes or triton."""
    code = f"""
import json, os, sys
from repro_torch.launch import serve, train
rep = serve.main(["--smoke", "--device", "cpu", "--batch", "1",
                  "--prompt-len", "4", "--gen", "2", "--requests", "1",
                  "--metrics-dir", {str(tmp_path / "serve")!r},
                  "--profile-dir", {str(tmp_path / "prof")!r}])
run = train.main(["--arch", "lram-bert-medium", "--smoke", "--device",
                  "cpu", "--placement", "pallas", "--steps", "2",
                  "--batch", "2", "--seq", "8", "--telemetry",
                  "--metrics-dir", {str(tmp_path / "train")!r}])
bad = sorted(n for n in sys.modules if n.split(".")[0]
             in ("jax", "jaxlib", "repro", "triton", "ml_dtypes"))
print(json.dumps({{"bad": bad, "requests": len(rep.requests),
                  "train_steps": len(run.records)}}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "requests": 1, "train_steps": 2}
    for sub in ("serve", "train"):
        assert sorted(os.listdir(tmp_path / sub)) == ["metrics.jsonl",
                                                      "metrics.prom"]
    assert len(os.listdir(tmp_path / "prof")) == 1
