"""Port parity of the sparse-conv cost breakdown
(bevfusion_tpu_torch/tools/bench_kernel_variants.py, K7) on the CPU.

The modes are held to the function the JAX tool was written to isolate,
the windowed gather-GEMM (``windowed_gather_gemm``, run in Pallas's
interpret mode): ``current`` and ``noskip`` are ``sparse_conv_plain``
without epilogue exactly, and within 1e-2 * max(|ref|, 1) of the TPU
kernel, which rounds its operands and its output to bf16 (2^-8 relative
per rounding). ``nogather`` and ``noproduct`` are held to numpy formulas
at 1e-5 (fp32, only the summation order differs). The JAX tool's own
``run_variant(mode="current")`` no longer computes the conv: it decodes
the int16 window selectors as ``v // 256 - 1``, ``v % 256``, an encoding
``build_windowed_rulebook`` no longer emits (``(relp + 1) * 8 + slot``).
One test pins that, and the port's breakdown is not held to the stale
tool.
"""
import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bevfusion_tpu.ops import sparse_conv as jsp
from bevfusion_tpu.ops import sparse_conv_windowed as wg
from bevfusion_tpu_torch.ops import sparse_conv as sp
from bevfusion_tpu_torch.tools import bench_kernel_variants as kv
from tests.test_torch_sparse_conv import _ring_sites

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP, SITES, BLK = 1024, 700, 256  # a 1024-site cap holding 700 sites, 256-site TPU blocks


@functools.lru_cache(maxsize=None)
def _scan(C, seed=0):
    """700 sites of a voxelized ring scan in a 1024-site cap, the
    offset-major table, and bf16-valued fp32 features [CAP, C] and weights
    [27, C, C] (so the TPU kernel's bf16 operands hold the same values)."""
    ids, grid = _ring_sites()
    valid = np.sort(ids[ids < grid.size])[:SITES]
    assert len(valid) == SITES
    sites = np.full(CAP, grid.size, np.int32)
    sites[:SITES] = valid
    nbr = np.array(jsp.build_subm_rulebook(jnp.asarray(sites), grid, 3, offset_major=True))
    rng = np.random.RandomState(seed)
    feats = (rng.randn(CAP, C) * (sites < grid.size)[:, None]).astype(np.float32)
    w = (rng.randn(27, C, C) / np.sqrt(27 * C)).astype(np.float32)
    feats, w = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (feats, w))
    return feats, nbr, w


def _windowed(feats, nbr, w):
    """The TPU kernel (K2's body: ``interpret`` takes the non-winproj path)."""
    C = feats.shape[1]
    wrb = wg.build_windowed_rulebook(jnp.asarray(nbr), C, blk=BLK, offset_major=True)
    assert int(wrb.overflow) == 0
    packed = wg.pack_sites(jnp.asarray(feats, jnp.bfloat16), C)
    out = wg.windowed_gather_gemm(packed, wrb, jnp.asarray(w, jnp.bfloat16), C, CAP, blk=BLK,
                                  interpret=True)
    return np.asarray(wg.unpack_sites(out, C), np.float32), wrb, packed


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("mode", ["current", "noskip"])
def test_current_and_noskip_plain_are_the_plain_conv(mode):
    feats, nbr, w = _torch(*_scan(16))
    got = kv.sparse_conv_variant_plain(feats, nbr, w, mode)
    assert torch.equal(got, sp.sparse_conv_plain(feats, nbr, w))
    launches = kv.sparse_conv_variant.launches
    assert torch.equal(kv.sparse_conv_variant(feats, nbr, w, mode, 128), got)  # CPU: no launch
    assert kv.sparse_conv_variant.launches == launches


@pytest.mark.parametrize("C", [16, 32])
def test_current_and_noskip_match_the_windowed_tpu_kernel(C):
    feats, nbr, w = _scan(C)
    want, _, _ = _windowed(feats, nbr, w)
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(want).max() > 0.5
    for mode in ("current", "noskip"):
        got = kv.sparse_conv_variant_plain(*_torch(feats, nbr, w), mode).numpy()
        assert np.abs(got - want).max() <= 1e-2 * scale, mode


def test_nogather_and_noproduct_plain_match_numpy():
    feats, nbr, w = _scan(16, seed=1)
    K = nbr.shape[0]
    hit = nbr >= 0
    want_ng = sum(hit[k][:, None] * (feats @ w[k]) for k in range(K))
    want_np = sum(np.where(hit[k][:, None], feats[np.maximum(nbr[k], 0)], 0.0) for k in range(K))
    got_ng = kv.sparse_conv_variant_plain(*_torch(feats, nbr, w), "nogather").numpy()
    got_np = kv.sparse_conv_variant_plain(*_torch(feats, nbr, w), "noproduct").numpy()
    assert got_ng.shape == (CAP, 16) and got_np.shape == (CAP, 16)
    for got, want in ((got_ng, want_ng), (got_np, want_np)):
        assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)
    # a strided table (cap_out < cap_in): nogather reads each output row's own input row
    g = _torch(feats, nbr[:, :512], w)
    want = sum(hit[k, :512, None] * (feats[:512] @ w[k]) for k in range(K))
    got = kv.sparse_conv_variant_plain(*g, "nogather").numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)


def test_rejects_an_unknown_mode_or_tile():
    feats, nbr, w = _torch(*_scan(16))
    with pytest.raises(ValueError):
        kv.sparse_conv_variant(feats, nbr, w, "roll")
    with pytest.raises(ValueError):
        kv.sparse_conv_variant(feats, nbr, w, "current", 32)


def _stale_tool():
    """tools/bench_kernel_variants.py with its ``pallas_call`` in interpret
    mode; the JAX settings its import changes are put back."""
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "jax_bench_kernel_variants", os.path.join(ROOT, "tools", "bench_kernel_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    interp = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = interp
    return mod


def test_the_jax_tools_current_mode_is_stale():
    """The JAX tool's ``current`` differs from the production kernel by
    more than 1e-1 * max: its numbers are not the conv's (ROADMAP Queue 3)."""
    feats, nbr, w = _scan(16)
    want, wrb, packed = _windowed(feats, nbr, w)
    tool = _stale_tool()
    got = tool.run_variant(packed, wrb, jnp.asarray(w, jnp.bfloat16), 16, CAP, wg.SLACK, BLK,
                           "current")
    got = np.asarray(wg.unpack_sites(got, 16), np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() > 1e-1 * max(np.abs(want).max(), 1.0)


def test_breakdown_on_the_cpu():
    """The tool's breakdown runs at a tiny size on the CPU (host times, not
    the card's): every mode's time and bound, the split, and noskip equal
    to current."""
    feats, nbr, w = _torch(*_scan(16))
    rows = kv.breakdown([("tiny", feats, nbr, w)], "cpu", iters=1, warmup=0)
    assert [r["tile"] for r in rows] == list(kv.TILES)
    for r in rows:
        assert set(r["modes"]) == set(kv.MODES)
        assert all(np.isfinite(m["ms"]) and m["bound_ms"] > 0 for m in r["modes"].values())
        assert r["noskip_vs_current"] == 0.0
        assert np.isfinite(r["gather_ms"] + r["product_ms"] + r["skip_saves_ms"])
    hits = int((nbr >= 0).sum())
    t_ops = 2 * hits * 16 * 16 / 67e12 * 1e3
    t_bytes = (2 * CAP * 16 * 4 + 27 * CAP * 4 + 27 * 256 * 4) / 3.35e12 * 1e3
    b, by = kv.mode_bound(feats, nbr, w, feats, "current")
    assert b == pytest.approx(max(t_ops, t_bytes))
    assert by == ("operations" if t_ops >= t_bytes else "bytes")
    b, by = kv.mode_bound(feats, nbr, w, feats, "noproduct")  # no weight read, Cin adds a hit
    assert b == pytest.approx(max(hits * 16 / 67e12 * 1e3,
                                  (2 * CAP * 16 * 4 + 27 * CAP * 4) / 3.35e12 * 1e3))
