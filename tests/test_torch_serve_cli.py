"""The port's serve CLI (`repro_torch.launch.serve`) beside the reference's
(`repro.launch.serve`): `--rate` / `--fixed-len` traces, arrivals
honoured by the engine, the lifecycle flags (`--spill-at-tick`, `--hbm-budget-mb`, `--grow-to`
with `--ckpt-dir`) and the report's graph fields."""

import json

import numpy as np
import pytest

from repro.serving import synthetic_trace as j_synthetic_trace
from repro_torch.launch import serve, train

SMOKE = ["--arch", "lram-tiered", "--smoke", "--device", "cpu"]


def _traced(monkeypatch):
    """Record the traces `serve.main` builds."""
    traces = []

    def trace(*args, **kw):
        traces.append(serve_trace(*args, **kw))
        return traces[-1]

    serve_trace = serve.synthetic_trace
    monkeypatch.setattr(serve, "synthetic_trace", trace)
    return traces


@pytest.mark.parametrize("flags", [["--rate", "40", "--fixed-len"],
                                   ["--rate", "25"], ["--fixed-len"]])
def test_trace_flags_give_the_reference_trace(monkeypatch, flags):
    """The CLI's trace for `--rate` / `--fixed-len` is the reference's
    `synthetic_trace` for the same seed: arrivals, prompts and budgets
    bit-equal."""
    traces = _traced(monkeypatch)
    serve.main(SMOKE + ["--batch", "2", "--prompt-len", "6", "--gen", "3",
                        "--requests", "5", "--seed", "3"] + flags)
    (trace,) = traces
    args = serve.build_argparser().parse_args(SMOKE + flags)
    want = j_synthetic_trace(
        np.random.default_rng(3), 5, vocab_size=256, max_prompt=6,
        max_gen=3, rate=args.rate, mixed=not args.fixed_len)
    assert [r.arrival_s for r in trace] == [r.arrival_s for r in want]
    assert [r.max_new_tokens for r in trace] == \
        [r.max_new_tokens for r in want]
    for a, b in zip(trace, want):
        np.testing.assert_array_equal(a.prompt, b.prompt)
    if args.fixed_len:
        assert {r.prompt_len for r in trace} == {6}
    if args.rate:
        assert trace[-1].arrival_s > 0


def test_engine_honours_arrivals(monkeypatch):
    """No request is admitted before its arrival (Poisson arrivals at 40
    requests a second)."""
    traces = _traced(monkeypatch)
    report = serve.main(SMOKE + ["--batch", "2", "--prompt-len", "4",
                                 "--gen", "2", "--requests", "4", "--rate",
                                 "40", "--fixed-len"])
    arrival = {r.id: r.arrival_s for r in traces[0]}
    assert len(report.requests) == 4
    for r in report.requests:
        assert r.admit_s >= arrival[r.id]


@pytest.mark.parametrize("flag", [["--spill-at-tick", "2"],
                                  ["--hbm-budget-mb", "1"]])
def test_lifecycle_flags_spill_with_requests_in_flight(flag, capsys):
    """A dense smoke table (16 MiB) spilled between decode ticks, by tick
    or by budget: one spill event printed, every request served with the
    tokens of the run without it; the report carries the store's stats
    and, on the CPU, no graph."""
    argv = SMOKE + ["--placement", "pallas", "--batch", "2", "--prompt-len",
                    "6", "--gen", "6", "--json"]
    plain = serve.main(argv)
    capsys.readouterr()
    report = serve.main(argv + flag)
    lines = capsys.readouterr().out.splitlines()
    (events,) = [json.loads(x)["lifecycle"] for x in lines
                 if x.startswith('{"lifecycle"')]
    assert [e["event"] for e in events] == ["spill"]
    assert events[0]["placement"] == "dense->tiered"
    assert [r.tokens for r in report.requests] == \
        [r.tokens for r in plain.requests]
    summary = json.loads(lines[-1])
    assert summary["cache"]["hit_rate"] >= 0
    assert summary["cuda_graph"] is False and summary["graph_captures"] == 0


def test_grow_to_serves_a_grown_checkpoint(tmp_path, capsys):
    """`train --grow-at 1:17` checkpoints a grown table; `serve --grow-to
    17 --ckpt-dir` grows before the restore and serves it; a size below
    the table's is refused."""
    ckpt = str(tmp_path / "ck")
    train.main(SMOKE + ["--steps", "3", "--batch", "2", "--seq", "16",
                        "--grow-at", "1:17", "--ckpt-dir", ckpt])
    capsys.readouterr()
    report = serve.main(SMOKE + ["--batch", "2", "--prompt-len", "4",
                                 "--gen", "3", "--grow-to", "17",
                                 "--ckpt-dir", ckpt])
    lines = capsys.readouterr().out.splitlines()
    assert '{"restored_step": 3}' in lines
    assert len(report.requests) == 4
    with pytest.raises(ValueError, match="can only grow"):
        serve.main(SMOKE + ["--grow-to", "15"])
