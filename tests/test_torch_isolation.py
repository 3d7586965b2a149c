"""The port stands alone: `repro_torch` and `chip_smoke.py` import neither
JAX, nor the JAX package, nor `ml_dtypes` (the card's machine lacks it),
and import no triton or CUDA build at import."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)(\.|\s)"
    r"|import\s+(triton|ml_dtypes)|from\s+(triton|ml_dtypes))", re.M)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_files_have_no_forbidden_imports():
    files = _port_files()
    assert len(files) > 20
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
from repro_torch.launch import train
run = train.main(["--arch", "lram-bert-medium", "--smoke", "--device", "cpu",
                  "--placement", "pallas", "--steps", "2", "--batch", "2",
                  "--seq", "8"])
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
    assert out == {"bad": [], "requests": 3, "train_steps": 2}
