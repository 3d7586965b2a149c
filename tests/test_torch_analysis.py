"""Port parity for the dry-run's static pieces against the JAX package,
in process (no fake world, no compile):

* `validate_cell` / `shapes.skip_reason` give the reference's skip
  reasons, word for word, for every arch x shape;
* `shapes.input_specs` gives the reference's `ShapeDtypeStruct`s' shapes
  and dtypes leaf for leaf (the decode cache from `transformer.
  cache_specs`), as empty meta tensors;
* `sharding.cache_pspecs` gives the reference's `PartitionSpec` entry for
  entry for every arch's decode_32k and long_500k (where not skipped)
  caches on the 16 x 16 and 2 x 16 x 16 meshes (a duck mesh: the
  reference reads only `shape` and `axis_names`), and `batch_spec` its
  `batch_pspec`;
* the collective tally's ring factors give the reference's HLO parser's
  counts and wire bytes, on its unit test's lines and (hypothesis) on
  HLO lines made from random (op, bytes, group) records;
* `roofline.analyze_artifact` and `render_table` give the reference's
  rows and table on the same artifacts with its constants passed, and
  the port's defaults are the H100 data sheet's;
* `batch_slice` takes a VLM's (3, B, S) M-RoPE positions along B;
* every member's block, where `block_index` places it, tiles the leaf once.
"""

import json
import math
import types

import numpy as np
import pytest
import torch

from _hypo import given, settings, st
from repro import configs as j_configs
from repro.analysis import hlo as j_hlo
from repro.analysis import roofline as j_roofline
from repro.configs import shapes as j_shapes
from repro.distributed import sharding as j_sharding
from repro.models import transformer as j_tf
from repro_torch import configs
from repro_torch.analysis import collectives as coll
from repro_torch.analysis import roofline
from repro_torch.configs import shapes
from repro_torch.distributed import collectives as dcoll
from repro_torch.distributed import sharding
from repro_torch.models import transformer
from repro_torch.models.config import validate_cell

CELLS = [(a, s) for a in configs.ARCHS for s in shapes.SHAPES]
PODS = {"16x16": {"data": 16, "model": 16},
        "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _duck(sizes: dict):
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_skip_reasons_match_reference(arch, shape):
    for lram in (0, 20):
        cfg, ref = configs.get_config(arch), j_configs.get_config(arch)
        if lram and cfg.family != "hybrid":
            cfg = configs.with_lram(cfg, lram)
            ref = j_configs.with_lram(ref, lram)
        assert cfg.name == ref.name
        want = j_shapes.skip_reason(ref, shape)
        assert validate_cell(cfg, shape) == want
        assert shapes.skip_reason(cfg, shape) == want
    # long_500k is skipped exactly for the full-attention archs
    assert (shapes.skip_reason(configs.get_config(arch), shape) is None) \
        == (shape != "long_500k" or configs.get_config(arch).family in (
            "ssm", "hybrid") or configs.get_config(arch).attention == "swa")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    cfg = configs.with_lram(configs.get_config(arch), 20) \
        if arch != "zamba2-2.7b" else configs.get_config(arch)
    ref_cfg = j_configs.get_config(arch)
    if arch != "zamba2-2.7b":
        ref_cfg = j_configs.with_lram(ref_cfg, 20)
    got = dict(_flat(shapes.input_specs(cfg, shape)))
    want = dict(_flat(j_shapes.input_specs(ref_cfg, shape)))
    assert sorted(got) == sorted(want)
    for path, sd in want.items():
        t = got[path]
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(sd.shape), path
        assert str(t.dtype).removeprefix("torch.") == np.dtype(
            sd.dtype).name, path


CACHE_CELLS = [(a, s, m) for a in configs.ARCHS
               for s in ("decode_32k", "long_500k") for m in PODS
               if shapes.skip_reason(configs.get_config(a), s) is None]


@pytest.mark.parametrize("arch,shape,mesh", CACHE_CELLS)
def test_cache_pspecs_match_reference(arch, shape, mesh):
    cell = shapes.SHAPES[shape]
    cfg, ref_cfg = configs.get_config(arch), j_configs.get_config(arch)
    duck = _duck(PODS[mesh])
    got = sharding.cache_pspecs(
        transformer.cache_shapes(cfg, cell.global_batch, cell.seq_len),
        cfg, duck)
    want = j_sharding.cache_pspecs(
        j_tf.cache_specs(ref_cfg, cell.global_batch, cell.seq_len),
        ref_cfg, duck)
    assert sorted(got) == sorted(want)
    for seg, leaves in want.items():
        assert sorted(got[seg]) == sorted(leaves)
        for k, spec in leaves.items():
            assert got[seg][k] == tuple(spec), (seg, k)
    # the same placement from a cache of tensors
    assert sharding.cache_pspecs(
        shapes.input_specs(cfg, shape)["cache"], cfg, duck) == got
    assert sharding.batch_spec(duck) == tuple(j_sharding.batch_pspec(duck))


# the reference's own unit-test lines (tests/test_dryrun_machinery.py)
HLO = """
  %ag = bf16[8,128]{1,0} all-gather(%p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[256]{0} all-reduce(%x), replica_groups=[32,16]<=[512], to_apply=%sum
  %rs = f32[64]{0} reduce-scatter(%y), replica_groups={{0,1}}, dimensions={0}
  %cp = bf16[4,4]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
  %ars = (f32[128]{0}, f32[128]{0}) all-reduce-start(%w), replica_groups={{0,1,2,3}}
"""
RECORDS = [("all-gather", 2 * 8 * 128, 4), ("all-reduce", 4 * 256, 16),
           ("reduce-scatter", 4 * 64, 2), ("collective-permute", 2 * 16, 2),
           ("all-reduce", 4 * 128, 4)]


def _same_stats(got: coll.CollectiveStats, want) -> None:
    assert got.counts == want.counts
    assert got.raw_bytes == pytest.approx(want.raw_bytes)
    assert sorted(got.wire_bytes) == sorted(want.wire_bytes)
    for op, b in want.wire_bytes.items():
        assert got.wire_bytes[op] == pytest.approx(b, rel=1e-12)
    assert got.total_wire_bytes == pytest.approx(want.total_wire_bytes,
                                                 rel=1e-12)


def test_ring_factors_match_reference_unit_lines():
    _same_stats(coll.stats(RECORDS), j_hlo.parse_collectives(HLO))


def _hlo_line(i: int, op: str, nbytes: int, g: int) -> str:
    if op == "collective-permute":
        return (f"  %c{i} = u8[{nbytes}]{{0}} {op}(%p), "
                f"source_target_pairs={{{{0,1}}}}")
    groups = ",".join(map(str, range(g)))
    return (f"  %c{i} = u8[{nbytes}]{{0}} {op}(%p), "
            f"replica_groups={{{{{groups}}}}}")


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(coll.OPS),
                          st.integers(1, 1 << 30), st.integers(2, 64)),
                min_size=1, max_size=12))
def test_ring_factors_match_reference_parser(records):
    text = "\n".join(_hlo_line(i, *r) for i, r in enumerate(records))
    _same_stats(coll.stats(records), j_hlo.parse_collectives(text))


def test_tally_records_each_collective_once_by_site(group_sizes):
    with dcoll.recording() as records:
        dcoll._record("all-gather", 64, _G(4))
        with dcoll.site("blocks"):
            dcoll._record("reduce-scatter", 16, _G(4))
            dcoll._record("all-reduce", 8, _G(2))
    st_ = coll.stats(records)
    assert st_.counts == {"all-gather": 1, "reduce-scatter": 1,
                          "all-reduce": 1}
    assert st_.gathered_bytes("step") == 64
    assert st_.summed_bytes("blocks") == 4 * 16 + 8
    assert st_.wire_bytes == {"all-gather": 48.0, "reduce-scatter": 48.0,
                              "all-reduce": 8.0}
    # nothing recorded outside `recording`
    dcoll._record("all-reduce", 8, _G(2))
    assert len(records) == 3


class _G:
    """A stand-in process group: `dist.get_world_size` reads its size."""

    def __init__(self, n):
        self.n = n


@pytest.fixture
def group_sizes(monkeypatch):
    real = dcoll.dist.get_world_size
    monkeypatch.setattr(dcoll.dist, "get_world_size",
                        lambda g=None: g.n if isinstance(g, _G) else real(g))


def _artifacts():
    """Reference-format artifacts (an extrapolated and a scanned-only
    cell, one of each mode) and a port one (full depth)."""
    base = {"status": "ok", "devices": 256, "params_active": 1_543_000_000,
            "mesh": "single"}
    return [
        {**base, "arch": "qwen2-1.5b", "shape": "train_4k",
         "scanned": {"flops_per_device": 9e12},
         "extrapolated": {"flops_per_device": 4.2e14,
                          "bytes_per_device": 3.1e12,
                          "total_wire_bytes_per_device": 7.7e10}},
        {**base, "arch": "yi-9b", "shape": "prefill_32k",
         "params_active": 8_800_000_000,
         "scanned": {"flops_per_device": 2.3e15, "bytes_per_device": 8e11,
                     "total_wire_bytes_per_device": None}},
        {**base, "arch": "mamba2-1.3b", "shape": "decode_32k",
         "extrapolated": {"flops_per_device": 4.1e9,
                          "bytes_per_device": 2.9e9,
                          "total_wire_bytes_per_device": 3.3e9}},
        {**base, "arch": "zamba2-2.7b", "shape": "long_500k",
         "extrapolated": {"flops_per_device": 3.0e9,
                          "bytes_per_device": None,
                          "total_wire_bytes_per_device": 1.0e8}},
        {**base, "arch": "x", "shape": "train_4k", "status": "skipped"},
    ]


def test_analyze_artifact_and_table_match_reference():
    consts = dict(peak_flops=j_roofline.PEAK_FLOPS,
                  hbm_bw=j_roofline.HBM_BW, link_bw=j_roofline.ICI_BW)
    rows, ref_rows = [], []
    for art in _artifacts():
        got = roofline.analyze_artifact(art, **consts)
        want = j_roofline.analyze_artifact(art)
        assert got == want
        if want:
            rows.append(got)
            ref_rows.append(want)
    assert len(rows) == 4
    assert roofline.render_table(rows) == j_roofline.render_table(ref_rows)


def test_roofline_defaults_are_the_h100_data_sheet():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    art = _artifacts()[0]
    port = {k: v for k, v in art.items() if k not in ("scanned",
                                                      "extrapolated")}
    port.update(source="full_depth", full_depth=art["extrapolated"])
    row = roofline.analyze_artifact(port)
    assert row["source"] == "full_depth"
    assert row["t_compute_s"] == 4.2e14 / 989e12
    assert row["t_memory_s"] == 3.1e12 / 3.35e12
    assert row["t_collective_s"] == 7.7e10 / 450e9
    assert row["useful_flops_ratio"] == pytest.approx(
        6 * 1_543_000_000 * 4096 * 256 / 256 / 4.2e14)


def test_roofline_report_names_the_nvlink_bound(tmp_path):
    art = dict(_artifacts()[0], mesh_shape={"data": 16, "model": 16})
    (tmp_path / "a.json").write_text(json.dumps(art))
    out = tmp_path / "r.md"
    roofline.main(["--dir", str(tmp_path), "--out", str(out),
                   "--json-out", str(tmp_path / "r.json")])
    text = out.read_text()
    assert "989 TFLOP/s" in text and "450 GB/s NVLink" in text
    assert "only a lower bound" in text
    assert "| qwen2-1.5b | train_4k |" in text


class _Mesh:
    """A duck `context.Mesh`: shape, axis names, this rank's coordinates
    (`index`, `size`, `axes_key` as the real one's)."""

    def __init__(self, sizes: dict, coords: dict):
        self.shape, self.axis_names = dict(sizes), tuple(sizes)
        self.coords = dict(coords)

    def axes_key(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes):
        return math.prod(self.shape[a] for a in self.axes_key(axes))

    def index(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


@pytest.mark.parametrize("sizes", [{"data": 4, "model": 1},
                                   {"data": 3, "model": 2},
                                   {"pod": 2, "data": 2, "model": 2}])
def test_batch_slice_takes_mrope_positions_along_the_batch(sizes):
    n = sizes["data"] * sizes.get("pod", 1)
    b, s = 2 * n, 5
    tokens = torch.arange(b * s).reshape(b, s)
    positions = torch.arange(3 * b * s).reshape(3, b, s)
    vision = torch.arange(b * 2 * 4.0).reshape(b, 2, 4)
    for d in range(n):
        coords = {"model": 0, "data": d % sizes["data"]}
        if "pod" in sizes:
            coords["pod"] = d // sizes["data"]
        got = sharding.batch_slice(_Mesh(sizes, coords), {
            "tokens": tokens, "positions": positions,
            "vision_embeds": vision})
        rows = slice(2 * d, 2 * d + 2)
        assert torch.equal(got["tokens"], tokens[rows])
        assert torch.equal(got["positions"], positions[:, rows])
        assert torch.equal(got["vision_embeds"], vision[rows])


@pytest.mark.parametrize("sizes,spec,shape", [
    ({"data": 2, "model": 4}, ("data", "model"), (6, 8)),
    ({"data": 2, "model": 4}, ("model", "data"), (8, 6)),
    ({"data": 2, "model": 4}, (None, ("data", "model")), (3, 16)),
    ({"pod": 2, "data": 2, "model": 2}, (("pod", "data"), "model"),
     (4, 6)),
    ({"pod": 2, "data": 3, "model": 2}, ("model", None, ("data", "pod")),
     (2, 5, 12)),
])
def test_member_blocks_tile_the_leaf_once(sizes, spec, shape):
    """The gather writes member j's block where `block_index` places
    `_member_coords(j)`: the members' blocks cover the leaf, each element
    once, and member j is the rank at those coordinates."""
    mesh = _Mesh(sizes, {a: 0 for a in sizes})
    axes = mesh.axes_key(sharding.spec_axes(spec))
    hits = torch.zeros(shape, dtype=torch.int64)
    for j in range(mesh.size(axes)):
        coords = sharding._member_coords(mesh, axes, j)
        assert _Mesh(sizes, coords).index(axes) == j
        hits[sharding.block_index(shape, spec, mesh, coords)] += 1
    assert torch.equal(hits, torch.ones_like(hits))
