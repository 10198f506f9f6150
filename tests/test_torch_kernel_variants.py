"""Port parity of the sparse-conv cost breakdown
(bevfusion_tpu_torch/tools/bench_kernel_variants.py, K7) on the CPU.

The modes are held to the function the JAX tool was written to isolate,
the windowed gather-GEMM (``windowed_gather_gemm``, run in Pallas's
interpret mode): ``current`` and ``noskip`` are ``sparse_conv_plain``
without epilogue exactly, and within 1e-2 * max(|ref|, 1) of the TPU
kernel, which rounds its operands and its output to bf16 (2^-8 relative
per rounding). ``nogather`` and ``noproduct`` are held to numpy formulas
at 1e-5 (fp32, only the summation order differs). The tensor-core
family's plain versions are held to numpy in float64 at 1e-5 (fp32
summation order), ``tc_1xtf32``'s with both operands rounded to TF32 first
(its products are then exact in fp32), and ``tc``'s to the JAX
``subm_gather_gemm``. The JAX tool's own
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
from tests.test_torch_tf32_split import tf32_rna

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


@pytest.mark.parametrize("bad", ["mode", "tile", "cin_ne_cout", "wide"])
def test_tensor_core_modes_reject_what_they_do_not_take(bad):
    """On the CPU too: an unknown mode, a tile other than K1/K2's 64, or
    weights other than the submanifold convs' (Cin == Cout <= 64)."""
    feats, nbr, w = _torch(*_scan(16))
    mode, tile = "tc", 64
    if bad == "mode":
        mode = "tc_bf16"
    elif bad == "tile":
        tile = 128
    elif bad == "cin_ne_cout":
        w = w[:, :, :8].contiguous()
    else:
        feats, w = feats.repeat(1, 5), torch.zeros(27, 80, 80)
    launches = kv.sparse_conv_variant.launches
    with pytest.raises(ValueError):
        kv.sparse_conv_variant(feats, nbr, w, mode, tile)
    assert kv.sparse_conv_variant.launches == launches


def _np_conv(feats, nbr, w):
    """sum_k x[nbr[k]] @ W[k] in float64, misses zero."""
    hit = nbr >= 0
    f, w = feats.astype(np.float64), w.astype(np.float64)
    return sum(np.where(hit[k][:, None], f[np.maximum(nbr[k], 0)], 0.0) @ w[k]
               for k in range(nbr.shape[0]))


def _np_tf32(a):
    """fp32 -> TF32, round to nearest with ties away from zero (numpy)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(np.float32)


@pytest.mark.parametrize("mode", kv.TC_MODES)
def test_tensor_core_modes_plain_match_numpy(mode):
    """Each tensor-core mode's plain version against numpy in float64 at
    1e-5 * max(|ref|, 1); the CPU wrapper takes it without a launch."""
    feats, nbr, w = _scan(32, seed=2)
    feats = feats + np.random.RandomState(3).randn(*feats.shape).astype(np.float32) * 1e-3
    hit = nbr >= 0
    K = nbr.shape[0]
    if mode in ("tc", "tc_noskip"):
        want = _np_conv(feats, nbr, w)
    elif mode == "tc_nogather":
        want = sum(hit[k][:, None] * (feats.astype(np.float64) @ w[k]) for k in range(K))
    elif mode == "tc_noproduct":
        want = sum(np.where(hit[k][:, None], feats[np.maximum(nbr[k], 0)], 0.0).astype(np.float64)
                   for k in range(K))
    else:
        want = _np_conv(_np_tf32(feats), nbr, _np_tf32(w))
        # the operands did change: one TF32 rounding each moves the conv
        assert np.abs(_np_conv(feats, nbr, w) - want).max() > 1e-5 * np.abs(want).max()
    args = _torch(feats, nbr, w)
    got = kv.sparse_conv_variant_plain(*args, mode).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)
    launches = kv.sparse_conv_variant.launches
    assert torch.equal(kv.sparse_conv_variant(*args, mode), torch.from_numpy(got))
    assert kv.sparse_conv_variant.launches == launches


def test_tf32_rounding_is_the_kernels():
    """The tool's TF32 rounding equals the emulation of ``cvt.rna.tf32.f32``
    that tests/test_torch_tf32_split.py pins, ties and carries included,
    and the numpy form used above."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * 10.0 ** rng.randint(-6, 6, 4096)).astype(np.float32)
    ties = np.array([0x3F801000, 0xBF801000, 0x3FFFF000, 0x3F803000], np.uint32).view(np.float32)
    x = torch.from_numpy(np.concatenate([x, ties]))
    got = kv.tf32_rna(x)
    assert torch.equal(got.view(torch.int32), tf32_rna(x).view(torch.int32))
    assert np.array_equal(got.numpy().view(np.int32), _np_tf32(x.numpy()).view(np.int32))


@pytest.mark.parametrize("C", [16, 32])
def test_tc_plain_matches_the_jax_gather_gemm(C):
    """``tc``'s plain version (K1/K2 without epilogue) against the JAX
    package's ``subm_gather_gemm`` on the same fp32 operands."""
    feats, nbr, w = _scan(C, seed=4)
    want = np.asarray(jsp.subm_gather_gemm(jnp.asarray(feats), jnp.asarray(nbr.T),
                                           jnp.asarray(w)))
    got = kv.sparse_conv_variant_plain(*_torch(feats, nbr, w), "tc").numpy()
    assert np.abs(want).max() > 0.5
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)


def test_slab_fill_counts_the_slabs_the_kernel_multiplies():
    """Against a loop over a hand-made table: 3 offsets, 40 output sites
    (three 16-row slabs, the last one ragged; one 64-site tile), rows past
    cap_in counted as misses."""
    cap_out, cap_in = 40, 30
    nbr = np.full((3, cap_out), -1, np.int32)
    nbr[0, [0, 1, 2]] = [5, 6, 7]        # offset 0: slab 0 only
    nbr[1, [3, 17, 39]] = [1, 2, 3]      # offset 1: slabs 0, 1, 2
    nbr[2, [20, 21]] = [cap_in, 40]      # offset 2: only misses (past cap_in)
    nbr[2, 33] = 29                      # ... and one hit in slab 2
    hits, slabs, tiles = 0, 0, 0
    for k in range(3):
        hit = (nbr[k] >= 0) & (nbr[k] < cap_in)
        hits += int(hit.sum())
        slabs += sum(bool(hit[s:s + 16].any()) for s in range(0, cap_out, 16))
        tiles += sum(bool(hit[t:t + 64].any()) for t in range(0, cap_out, 64))
    got = kv.slab_fill(torch.from_numpy(nbr), cap_in)
    assert (hits, slabs, tiles) == (7, 5, 3)
    assert (got["hit_pairs"], got["slab_pairs"], got["tile_pairs"]) == (hits, slabs, tiles)
    assert got["fill"] == pytest.approx(7 / (16 * 5))
    assert got["tile_fill"] == pytest.approx(7 / (64 * 3))


def test_family_of_each_mode():
    assert {kv.family_of(m) for m in kv.MODES} == {"scalar"}
    assert {kv.family_of(m) for m in kv.TC_MODES} == {"tc"}
    with pytest.raises(ValueError):
        kv.family_of("nohot")


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
    the card's): every mode's time and bound in both families, the split,
    noskip equal to current and tc_noskip to tc, and the slab fill."""
    feats, nbr, w = _torch(*_scan(16))
    rows = kv.breakdown([("tiny", feats, nbr, w)], "cpu", iters=1, warmup=0)
    assert [(r["family"], r["tile"]) for r in rows] == [("scalar", t) for t in kv.TILES] + [
        ("tc", kv.TC_TILE)]
    for r in rows:
        assert set(r["modes"]) == set(kv.FAMILIES[r["family"]])
        assert all(np.isfinite(m["ms"]) and m["bound_ms"] > 0 and m["bound_fp32_fma_ms"] > 0
                   for m in r["modes"].values())
        assert r["noskip_vs"] == 0.0
        assert np.isfinite(r["gather_ms"] + r["product_ms"] + r["skip_saves_ms"])
    tc = rows[-1]
    assert np.isfinite(tc["split_ms"])
    assert tc["slab_fill"] == kv.slab_fill(nbr, CAP) and 0 < tc["slab_fill"]["fill"] <= 1
    hits = int((nbr >= 0).sum())
    t_ops = 2 * hits * 16 * 16 / 67e12 * 1e3
    t_bytes = (2 * CAP * 16 * 4 + 27 * CAP * 4 + 27 * 256 * 4) / 3.35e12 * 1e3
    b, by = kv.mode_bound(feats, nbr, w, feats, "current")
    assert b == pytest.approx(max(t_ops, t_bytes))
    assert by == ("operations" if t_ops >= t_bytes else "bytes")
    b, by = kv.mode_bound(feats, nbr, w, feats, "noproduct")  # no weight read, Cin adds a hit
    assert b == pytest.approx(max(hits * 16 / 67e12 * 1e3,
                                  (2 * CAP * 16 * 4 + 27 * CAP * 4) / 3.35e12 * 1e3))
    assert kv.mode_bound(feats, nbr, w, feats, "tc_noproduct") == (b, by)
    # the tensor cores: three TF32 products per useful multiply-add, or one
    for mode, products in (("tc", 3), ("tc_noskip", 3), ("tc_nogather", 3), ("tc_1xtf32", 1)):
        t_tc = products * 2 * hits * 16 * 16 / 495e12 * 1e3
        assert kv.mode_bound(feats, nbr, w, feats, mode)[0] == pytest.approx(max(t_tc, t_bytes))
        assert kv.fma_bound(feats, nbr, w, feats, mode) == pytest.approx(max(t_ops, t_bytes))
