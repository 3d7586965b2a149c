"""Run a code string as the ranks of one `torch.distributed` run, each a
fresh Python process (the way `run_in_subprocess` in conftest.py runs a
snippet): RANK, WORLD_SIZE, LOCAL_RANK and LOCAL_WORLD_SIZE set as torchrun
sets them, MASTER_ADDR / MASTER_PORT on localhost for `env://`, and
TEST_INIT_METHOD a `file://` rendezvous in the test's tmp_path.  The
ranks import the port only (PYTHONPATH=src), one thread each."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code: str, world: int, tmp_path, *, timeout: int = 120,
              env: dict | None = None) -> list[str]:
    """Each rank's stdout; raises with every rank's output when a rank
    fails, and kills them all when the run outlasts `timeout` seconds (a
    rank waiting in a collective that another never issues)."""
    base = dict(os.environ)
    base.update({
        "PYTHONPATH": os.path.join(REPO, "src") + os.pathsep
        + base.get("PYTHONPATH", ""),
        "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
        "TEST_INIT_METHOD": f"file://{tmp_path}/rendezvous",
        "OMP_NUM_THREADS": "1", **(env or {})})
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO,
        env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate() for p in procs]
        raise AssertionError(
            f"ranks outlasted {timeout} s (a missing collective?):\n"
            + "\n".join(f"--- rank {r} ---\n{o}\n{e}"
                        for r, (o, e) in enumerate(logs)))
    if any(p.returncode for p in procs):
        raise AssertionError("\n".join(
            f"--- rank {r} (rc={p.returncode}) ---\n{o}\n{e}"
            for r, (p, (o, e)) in enumerate(zip(procs, outs))))
    return [o for o, _ in outs]
