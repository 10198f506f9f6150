"""The port's decision tools (bevfusion_tpu_torch/tools/measure_tiles.py,
bench_tiled_proto.py, profile_encoder2.py, bench_mxu_micro.py) on the CPU.

The numpy copies are held to the JAX tools' own functions, loaded from
``tools/`` by path, bit for bit: ``voxel_coords``, ``downsample``,
``tile_stats``' counts and ``zext_stats``' line (``tools/measure_tiles.py``),
``build_tiling_np``'s four maps (``tools/bench_tiled_proto.py``; the port's
is vectorised). ``downsample`` is held to the port's own
``ops/sparse_conv.py:downsample_sites``. The tiled chain, in fp32, is held
to the port's ``sparse_conv_plain`` chain (the engine chain on the CPU) on
the valid sites within 1e-5 of the scale (fp32 sums in another order), and
its first conv to the JAX ``subm_gather_gemm``. The meta chain of
``profile_encoder2`` must build the rulebooks the encoder's forward builds,
bit for bit. Times here are the CPU's host times at toy sizes, not the
card's.
"""
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.ops import sparse_conv as jsp
from bevfusion_tpu_torch.models.sparse_encoder import SparseEncoder
from bevfusion_tpu_torch.ops import sparse_conv as sp
from bevfusion_tpu_torch.runtime.flagship import synthetic_lidar_scan
from bevfusion_tpu_torch.tools import bench_mxu_micro as mm
from bevfusion_tpu_torch.tools import bench_tiled_proto as tp
from bevfusion_tpu_torch.tools import measure_tiles as mt
from bevfusion_tpu_torch.tools import profile_encoder2 as pe2

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN_POINTS = 5000
FP32_ORDER = 1e-5  # of the scale: fp32 sums in another order


@functools.lru_cache(maxsize=None)
def _jax_tool(name):
    """The JAX package's ``tools/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _scan_coords():
    """The ~5,000-point ring scan's sites on the 1440 x 1440 x 41 grid."""
    pts, mask = synthetic_lidar_scan(SCAN_POINTS, mt.PCR, seed=0)
    return mt.voxel_coords(pts[mask])


def _tiny_parity_coords():
    """The JAX tool's tiny grid: 160 sites of 12 x 12 x 8 from numpy seed 0."""
    rng = np.random.RandomState(0)
    flat = np.sort(rng.choice(12 * 12 * 8, 160, replace=False))
    return np.stack([flat // 96, (flat // 8) % 12, flat % 8], 1), (12, 12, 8)


def _assert_maps_equal(got, want):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
        else:
            assert type(g) is type(w) and g == w


@pytest.mark.parametrize("case", ["tiny", "scan-442", "scan-444"])
def test_build_tiling_np_maps_equal_the_jax_tools(case):
    if case == "tiny":
        coords, grid = _tiny_parity_coords()
        tile, cap = (4, 4, 4), 256
    else:
        coords, grid = _scan_coords(), (1440, 1440, 41)
        tile, cap = ((4, 4, 2) if case == "scan-442" else (4, 4, 4)), len(_scan_coords()) + 37
    want = _jax_tool("bench_tiled_proto").build_tiling_np(coords, grid, tile, cap)
    _assert_maps_equal(tp.build_tiling_np(coords, grid, tile, cap), want)


def test_measure_tiles_copies_equal_the_jax_tools(capsys):
    jmt = _jax_tool("measure_tiles")
    pts, mask = synthetic_lidar_scan(SCAN_POINTS, mt.PCR, seed=0)
    c0 = mt.voxel_coords(pts[mask])
    assert np.array_equal(c0, jmt.voxel_coords(pts[mask])) and len(c0) > 1000
    coords, grids = [c0], [(1440, 1440, 41)]
    for p in ((1, 1, 1), (1, 1, 1), (1, 1, 0)):
        c, g = mt.downsample(coords[-1], grids[-1], p=p)
        jc, jg = jmt.downsample(coords[-1], grids[-1], p=p)
        assert g == jg and c.dtype == jc.dtype and np.array_equal(c, jc)
        coords.append(c)
        grids.append(g)
    for (c, g), (ci, co) in zip(zip(coords, grids), mt.STAGE_CHANNELS):
        for tile in ((4, 4, 2), (8, 8, 4), (16, 16, g[2])):
            got = mt.tile_stats(c, g, tile, ci, co, "s")
            want = jmt.tile_stats(c, g, tile, ci, co, "s")
            vol, pvol = np.prod(tile), np.prod(np.add(tile, 2))
            assert got["T"] == want["T"] and got["dens"] == want["dens"]
            assert got["bytes"] == want["T"] * (pvol * ci + vol * co) * 2
        capsys.readouterr()
        mt.zext_stats(c, g, 8, 8, "s")
        line = capsys.readouterr().out
        jmt.zext_stats(c, g, 8, 8, "s")
        assert line == capsys.readouterr().out


@pytest.mark.parametrize("padding", [(1, 1, 1), (1, 1, 0)])
def test_downsample_equals_the_ports_downsample_sites(padding):
    coords, grid = _scan_coords(), sp.SparseGrid(1440, 1440, 41)
    want, og = mt.downsample(coords, tuple(grid), p=padding)
    ids = sp.lin_ids(torch.as_tensor(coords), grid)
    cap = len(want) + 50
    got, mask = sp.downsample_sites(ids, grid, 3, 2, padding, cap)
    assert tuple(sp.conv_out_shape(grid, 3, 2, padding)) == og
    want_ids = (want[:, 0] * og[1] + want[:, 1]) * og[2] + want[:, 2]
    assert np.array_equal(got[mask].numpy(), want_ids) and int(mask.sum()) == len(want)


@functools.lru_cache(maxsize=None)
def _chain_case(C=8, tile=(4, 4, 2)):
    """Stage inputs at the scan's sites: fp32 feats, weights, random scales
    and shifts (the affine and ReLU both at work)."""
    coords = _scan_coords()
    rng = np.random.RandomState(1)
    s = tp.stage_inputs(rng, coords, (1440, 1440, 41), C, len(coords) + 29, tile, "cpu")
    scales = torch.as_tensor(rng.uniform(0.5, 1.5, (tp.NCONV, C)).astype(np.float32))
    shifts = torch.as_tensor(rng.uniform(-0.2, 0.2, (tp.NCONV, C)).astype(np.float32))
    weights = s.weights * 5 - 0.2  # of both signs, so ReLU cuts
    return s._replace(weights=weights, scales=scales, shifts=shifts)


@pytest.mark.parametrize("nconv", [1, 4])
def test_tiled_chain_matches_the_plain_chain_on_the_sites(nconv):
    s = _chain_case()
    valid = s.ids < s.grid.size
    with torch.no_grad():
        got = tp.site_rows(tp.tiled_chain(s.feats, tp.conv3d_weights(s.weights[:nconv],
                                                                     torch.float32),
                                          s.scales[:nconv], s.shifts[:nconv], s.tiling,
                                          torch.float32), s.tiling)
        want = tp.engine_chain(s.feats, s.weights[:nconv], s.scales[:nconv],
                               s.shifts[:nconv], s.ids, s.grid, torch.float32)
    assert got.dtype == want.dtype == torch.float32
    assert float((want[valid] > 0).float().mean()) > 0.2  # ReLU passes some, cuts some
    assert float((want[valid] == 0).float().mean()) > 0.05
    scale = max(want[valid].abs().max().item(), 1.0)
    assert (got[valid] - want[valid]).abs().max().item() <= FP32_ORDER * scale
    assert not got[~valid].any()  # the sentinel rows come back 0


def test_tiled_first_conv_matches_jax_subm_gather_gemm():
    s = _chain_case()
    valid = (s.ids < s.grid.size).numpy()
    ones, zeros = torch.ones(1, s.feats.shape[1]), torch.zeros(1, s.feats.shape[1])
    with torch.no_grad():
        got = tp.site_rows(tp.tiled_chain(s.feats, tp.conv3d_weights(s.weights[:1], torch.float32),
                                          ones, zeros, s.tiling, torch.float32, relu=False),
                           s.tiling).numpy()
    # the port's table, site-major [cap, 27] (bit-equal to the JAX one: test_torch_sparse_conv)
    nbr = jnp.asarray(sp.build_subm_rulebook(s.ids, s.grid).t().numpy())
    want = np.asarray(jsp.subm_gather_gemm(jnp.asarray(s.feats.numpy()), nbr,
                                           jnp.asarray(s.weights[0].numpy())))
    scale = max(float(np.abs(want[valid]).max()), 1.0)
    assert np.abs(got[valid] - want[valid]).max() <= FP32_ORDER * scale


def test_parity_and_a_stage_run_on_the_cpu():
    """The tool's parity (fp32) and one small stage timed on the CPU: the
    engine chain launches nothing there, and every row is finite."""
    par = tp.parity("cpu")
    assert par["max_err"] < tp.PARITY_TOL
    coords = _scan_coords()
    s = tp.stage_inputs(par["rng"], coords, (1440, 1440, 41), 16, len(coords) + 5, (4, 4, 2),
                        "cpu")
    launches = sp.sparse_conv_bf16.launches
    with torch.no_grad():
        gaps = tp.conv_gaps(s, s.ids < s.grid.size)
        row = tp.bench_stage("stage0", coords, (1440, 1440, 41), 16, s, "cpu", iters=1, warmup=0)
    assert sp.sparse_conv_bf16.launches == launches
    assert all(g["bad"] == 0 for g in gaps.values()), gaps
    for k in ("tiled_ms", "engine_ms", "rulebook_ms", "k1_ms", "tiled_bound_ms", "k1_bound_ms",
              "fused_estimate_ms_per_conv"):
        assert np.isfinite(row[k]) and row[k] > 0, k
    assert row["T"] == s.tiling.T and 0 < row["density"] <= 1
    split = row["engine_split"]  # nothing runs on a card here: the traces are empty
    assert split["busy_ms"] == split["k1_busy_ms"] == split["rulebook_busy_ms"] == 0
    assert split["rest_ms"] == pytest.approx(row["engine_ms"] - row["rulebook_ms"]
                                             - tp.NCONV * row["k1_ms"])
    assert split["idle_ms"] == row["engine_ms"]


ENCODER = dict(in_channels=5, sparse_shape=(128, 128, 33), base_channels=4, output_channels=16,
               encoder_channels=((4, 4, 8), (8, 8, 16), (16, 16, 16), (16, 16)),
               encoder_paddings=((0, 0, 1), (0, 0, 1), (0, 0, (1, 1, 0)), (0, 0)),
               block_type="basicblock", site_caps=(1600, 900, 500))


def _encoder_inputs():
    """1,500 sites of a ring scan on the 128 x 128 x 33 grid (sorted ids, a
    2,048-site cap) and seeded voxel features."""
    pts, mask = synthetic_lidar_scan(20000, (-16.0, -16.0, -4.0, 16.0, 16.0, 4.0), seed=5)
    p = pts[mask]
    c = np.clip(np.floor((p[:, :3] - np.array([-16.0, -16.0, -4.0])) / [0.25, 0.25, 0.25]),
                0, [127, 127, 32]).astype(np.int64)
    flat = np.unique((c[:, 0] * 128 + c[:, 1]) * 33 + c[:, 2])[:1500]
    coords = np.zeros((2048, 3), np.int32)
    coords[:len(flat)] = np.stack([flat // (128 * 33), (flat // 33) % 128, flat % 33], 1)
    mask = np.arange(2048) < len(flat)
    feats = np.random.RandomState(0).rand(2048, 5).astype(np.float32)
    return torch.as_tensor(feats), torch.as_tensor(coords), torch.as_tensor(mask)


@pytest.mark.parametrize("dense_from_stage", [3, -1])
def test_meta_chain_builds_the_forwards_rulebooks(dense_from_stage, monkeypatch):
    torch.manual_seed(0)
    enc = SparseEncoder(**ENCODER, dense_from_stage=dense_from_stage).eval()
    feats, coords, mask = _encoder_inputs()
    calls = []

    def recording(name):
        fn = getattr(sp, name)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, out))
            return out
        return wrapped

    for name in ("downsample_sites", "build_subm_rulebook", "build_conv_rulebook"):
        monkeypatch.setattr(sp, name, recording(name))
    with torch.no_grad():
        enc(feats[None], coords[None], mask[None])
    forward, calls[:] = list(calls), []
    meta = pe2.meta_chain(enc, coords, mask)
    assert [n for n, _ in calls] == [n for n, _ in forward]
    for (name, a), (_, b) in zip(calls, forward):
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))  # downsample_sites: (ids, mask)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
    n_conv = sum(n == "build_conv_rulebook" for n, _ in forward)
    assert n_conv == (2 if dense_from_stage == 3 else 4)  # conv_out's too where it is sparse
    assert ("conv_out conv" in meta) == (dense_from_stage == -1)
    absent = pe2.absent(enc, meta)
    assert len(absent) == (4 if dense_from_stage == 3 else 2)


def test_profile_encoder2_prints_both_rows_on_the_cpu(capsys):
    torch.manual_seed(0)
    enc = SparseEncoder(**ENCODER).eval()
    feats, coords, mask = _encoder_inputs()
    r = pe2.profile_encoder2(enc, feats, coords, mask, "cpu", torch.float32, iters=1, warmup=0)
    for k in ("meta_ms", "meta_host_ms", "meta_ops_ms", "encoder_ms", "encoder_host_ms",
              "encoder_ops_ms"):
        assert np.isfinite(r[k]) and r[k] > 0, k
    pe2.print_result(r)
    out = capsys.readouterr().out
    assert "meta chain (all rulebooks, queued ahead)" in out
    assert "full encoder float32 (queued ahead)" in out
    assert "meta chain (one call traced)" in out and "full encoder (one call traced)" in out
    assert r["encoder_trace"]["device_busy_ms"] == 0 and r["encoder_trace"]["idle_share"] == 1
    assert "level 3 is dense in the port" in out and "build_windowed_rulebook" in out


def test_mxu_micro_scatters_build_equal_tables_and_a_tiny_sweep_runs():
    packed, split, packed_bytes, split_bytes = mm.table_scatters(5000, 700, "cpu")
    for acc in (torch.tensor(0), torch.tensor(1)):
        t = packed(acc)
        assert t.shape == (5001, 3) and int(t.sum()) > 0
        assert torch.equal(t, torch.stack(split(acc), 1))
    assert split_bytes > packed_bytes
    rows = mm.run("cpu", iters=1, k_sweep=[(64, K, 16, "oh") for K in (32, 64)], n_sweep=[],
                  bands=[], table_rows=4000, gather_rows=300)
    assert len(rows) == 1 + 2 + len(mm.GATHER_WIDTHS) + 2
    assert all(np.isfinite(r["us"]) and r["us"] > 0 for r in rows)
