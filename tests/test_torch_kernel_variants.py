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
``subm_gather_gemm``. The bf16 family's plain versions (bf16 operands, fp32
sums, one rounding to bf16) are held to the same numpy sums within one bf16
rounding (2^-7 relative) plus 1e-5 of the scale, and ``bf16``'s to the JAX
``subm_gather_gemm`` on bf16 operands (fp32 sums, one rounding) within one
bf16 rounding plus the fp32 order's 1e-4 of the scale. The dw_bf16 family
(K3 bf16's kernel) computes weight gradients: ``dw_bf16``'s plain version is
``sparse_conv_dw_plain`` and within the fp32 order's 1e-4 of the JAX
gradient of ``subm_gather_gemm`` on bf16-valued operands; its other modes
are held to numpy. The JAX tool's own
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
BF16_REL = 2.0 ** -7  # one bf16 rounding, relative


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


@pytest.mark.parametrize("family", ["tc", "bf16", "dw_bf16"])
@pytest.mark.parametrize("bad", ["mode", "tile", "cin_ne_cout", "wide", "dtype"])
def test_tensor_core_modes_reject_what_they_do_not_take(bad, family):
    """On the CPU too: an unknown mode, a tile other than K1/K2's 64, weights
    other than the submanifold convs' (Cin == Cout <= 64), or operands of the
    other family's dtype (fp32 for tc, bf16 for bf16). The dw_bf16 family
    (``sparse_conv_dw_variant``): an unknown mode, its modes through the
    conv's entry (``tile``), dout of another width, a width other than 16,
    32 and 64, operands other than bf16."""
    feats, nbr, w = _torch(*_scan(16))
    dtype = torch.bfloat16 if family != "tc" else torch.float32
    feats, w = feats.to(dtype), w.to(dtype)
    if family == "dw_bf16":
        dout, mode = feats.clone(), "dw_bf16"
        if bad == "mode":
            mode = "dw_bf16_bf8"
        elif bad == "cin_ne_cout":
            dout = dout[:, :8].contiguous()
        elif bad == "wide":
            feats, dout = feats[:, :12].contiguous(), dout[:, :12].contiguous()
        elif bad == "dtype":
            dout = dout.float()
        launches = kv.sparse_conv_variant.launches
        with pytest.raises(TypeError if bad == "dtype" else ValueError):
            if bad == "tile":
                kv.sparse_conv_variant(feats, nbr, w, mode)
            else:
                kv.sparse_conv_dw_variant(feats, nbr, dout, mode)
        assert kv.sparse_conv_variant.launches == launches
        return
    mode, tile = family, 64
    if bad == "mode":
        mode = f"{family}_bf8"
    elif bad == "tile":
        tile = 128
    elif bad == "cin_ne_cout":
        w = w[:, :, :8].contiguous()
    elif bad == "wide":
        feats, w = feats.repeat(1, 5), torch.zeros(27, 80, 80, dtype=dtype)
    else:
        feats, w = feats.to(torch.float16), w.to(torch.float16)
    launches = kv.sparse_conv_variant.launches
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
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


@pytest.mark.parametrize("mode", kv.TC_MODES + kv.BF16_MODES)
def test_tensor_core_modes_plain_match_numpy(mode):
    """Each tensor-core and bf16 mode's plain version against numpy in
    float64: at 1e-5 * max(|ref|, 1) in fp32, within one bf16 rounding plus
    that for the bf16 family (its operands bf16-valued, so numpy sees the
    same numbers); the CPU wrapper takes it without a launch."""
    feats, nbr, w = _scan(32, seed=2)
    bf16 = mode in kv.BF16_MODES
    if not bf16:
        feats = feats + np.random.RandomState(3).randn(*feats.shape).astype(np.float32) * 1e-3
    hit = nbr >= 0
    K = nbr.shape[0]
    if mode in ("tc", "tc_noskip", "bf16", "bf16_noskip"):
        want = _np_conv(feats, nbr, w)
    elif mode in ("tc_nogather", "bf16_nogather"):
        want = sum(hit[k][:, None] * (feats.astype(np.float64) @ w[k]) for k in range(K))
    elif mode in ("tc_noproduct", "bf16_noproduct"):
        want = sum(np.where(hit[k][:, None], feats[np.maximum(nbr[k], 0)], 0.0).astype(np.float64)
                   for k in range(K))
    else:
        want = _np_conv(_np_tf32(feats), nbr, _np_tf32(w))
        # the operands did change: one TF32 rounding each moves the conv
        assert np.abs(_np_conv(feats, nbr, w) - want).max() > 1e-5 * np.abs(want).max()
    args = _torch(feats, nbr, w)
    if bf16:
        args = [args[0].bfloat16(), args[1], args[2].bfloat16()]
    got_t = kv.sparse_conv_variant_plain(*args, mode)
    got = got_t.float().numpy()
    assert got.shape == want.shape and got_t.dtype == (torch.bfloat16 if bf16 else torch.float32)
    scale = max(np.abs(want).max(), 1.0)
    limit = (BF16_REL * np.abs(want) if bf16 else 0.0) + 1e-5 * scale
    assert (np.abs(got - want) <= limit).all()
    if bf16:  # one rounding of the fp32 sum: not the float64 sum itself
        assert (got != want).any()
    launches = kv.sparse_conv_variant.launches
    assert torch.equal(kv.sparse_conv_variant(*args, mode), got_t)
    assert kv.sparse_conv_variant.launches == launches


@pytest.mark.parametrize("mode", kv.DW_BF16_MODES[1:])
def test_dw_bf16_modes_plain_match_numpy(mode):
    """The dw_bf16 family's other modes against numpy on a table with
    entries past cap_in (misses): ``dw_bf16_nogather`` the sum over hit
    pairs of each site's own feats row times its dout row (float64, within
    the fp32 order's 1e-5 of the scale), ``dw_bf16_noproduct`` and
    ``dw_bf16_compact`` every element of dW[k] the hit pairs of offset k,
    exactly."""
    feats, nbr, _ = _scan(16, seed=5)
    nbr = nbr.copy()
    nbr[4, :300:3] = CAP + 7  # misses: past cap_in
    dout = torch.from_numpy(np.random.RandomState(6).randn(CAP, 16).astype(np.float32))
    dout = dout.bfloat16().float().numpy()
    hit = (nbr >= 0) & (nbr < CAP)
    if mode == "dw_bf16_nogather":
        f, d = feats.astype(np.float64), dout.astype(np.float64)
        want = np.stack([(f * hit[k][:, None]).T @ d for k in range(nbr.shape[0])])
    else:
        want = np.broadcast_to(hit.sum(1)[:, None, None], (nbr.shape[0], 16, 16))
    x16, nbr_t, d16 = _torch(feats, nbr, dout)
    got = kv.sparse_conv_dw_variant_plain(x16.bfloat16(), nbr_t, d16.bfloat16(), mode).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if mode == "dw_bf16_nogather":
        assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)
    else:
        assert np.array_equal(got, want)


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


@pytest.mark.parametrize("mode", ["tc", "bf16", "dw_bf16"])
@pytest.mark.parametrize("C", [16, 32])
def test_tc_plain_matches_the_jax_gather_gemm(C, mode):
    """``tc``'s plain version (K1/K2 without epilogue) against the JAX
    package's ``subm_gather_gemm`` on the same fp32 operands at 1e-5;
    ``bf16``'s (K1/K2 bf16 without epilogue) against it on the same bf16
    operands (fp32 sums, one rounding to bf16 in both) within one bf16
    rounding plus 1e-4 of the scale: the two fp32 sums differ in order,
    then each rounds once. ``dw_bf16``'s (K3 bf16: an fp32 dW of bf16
    rows) equal to ``sparse_conv_dw_plain`` and within 1e-4 of the scale of
    the JAX gradient of ``subm_gather_gemm`` with respect to its weight, on
    the same bf16-valued operands and output gradient (exact products, the
    two fp32 sums in different orders)."""
    feats, nbr, w = _scan(C, seed=4)
    if mode == "dw_bf16":
        dout = torch.from_numpy(np.random.RandomState(C).randn(CAP, C).astype(np.float32))
        dout = dout.bfloat16().float().numpy()

        def f(wt):
            return jnp.sum(jsp.subm_gather_gemm(jnp.asarray(feats), jnp.asarray(nbr.T), wt)
                           * dout)

        want = np.asarray(jax.grad(f)(jnp.asarray(w)))
        x16, nbr_t, d16 = _torch(feats, nbr, dout)
        x16, d16 = x16.bfloat16(), d16.bfloat16()
        got = kv.sparse_conv_dw_variant_plain(x16, nbr_t, d16, mode)
        assert got.dtype == torch.float32
        assert torch.equal(got, sp.sparse_conv_dw_plain(x16, nbr_t, d16))
        launches = kv.sparse_conv_variant.launches
        assert torch.equal(kv.sparse_conv_dw_variant(x16, nbr_t, d16, mode), got)  # CPU: plain
        assert kv.sparse_conv_variant.launches == launches
        assert np.abs(want).max() > 0.5
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * scale
        return
    dt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    want = np.asarray(jsp.subm_gather_gemm(jnp.asarray(feats, dt), jnp.asarray(nbr.T),
                                           jnp.asarray(w, dt)), np.float32)
    args = _torch(feats, nbr, w)
    if mode == "bf16":
        args = [args[0].bfloat16(), args[1], args[2].bfloat16()]
    got = kv.sparse_conv_variant_plain(*args, mode).float().numpy()
    assert np.abs(want).max() > 0.5
    scale = max(np.abs(want).max(), 1.0)
    limit = BF16_REL * np.abs(want) + 1e-4 * scale if mode == "bf16" else 1e-5 * scale
    assert (np.abs(got - want) <= limit).all()


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
    assert {kv.family_of(m) for m in kv.BF16_MODES} == {"bf16"}
    assert {kv.family_of(m) for m in kv.DW_BF16_MODES} == {"dw_bf16"}
    assert kv.CONV_MODES == kv.MODES + kv.TC_MODES + kv.BF16_MODES
    assert kv.ALL_MODES == kv.CONV_MODES + kv.DW_BF16_MODES
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
    the card's): every mode's time and bound in the three families, the
    split, noskip equal to current, tc_noskip to tc and bf16_noskip to bf16,
    and the slab fill; a subset of the families on request."""
    feats, nbr, w = _torch(*_scan(16))
    rows = kv.breakdown([("tiny", feats, nbr, w)], "cpu", iters=1, warmup=0)
    assert [(r["family"], r["tile"]) for r in rows] == [("scalar", t) for t in kv.TILES] + [
        ("tc", kv.TC_TILE), ("bf16", kv.TC_TILE), ("dw_bf16", None)]
    dw = rows.pop()
    assert set(dw["modes"]) == set(kv.DW_BF16_MODES) and "plan" not in dw
    assert all(np.isfinite(m["ms"]) and m["bound_ms"] > 0 for m in dw["modes"].values())
    ms = {m: v["ms"] for m, v in dw["modes"].items()}
    assert dw["product_ms"] == ms["dw_bf16"] - ms["dw_bf16_noproduct"]
    assert dw["ring_ms"] == ms["dw_bf16_noproduct"] - ms["dw_bf16_compact"]
    x16 = feats.bfloat16()
    g = torch.Generator().manual_seed(CAP)  # the row's output gradient
    d16 = torch.randn(CAP, 16, generator=g).bfloat16()
    y = kv.sparse_conv_dw_variant(x16, nbr, d16)
    t_dw = 2 * int((nbr >= 0).sum()) * 16 * 16 / 989e12 * 1e3
    t_dw_bytes = (2 * CAP * 16 * 2 + 27 * CAP * 4 + 27 * 256 * 4) / 3.35e12 * 1e3
    assert kv.dw_mode_bound(x16, nbr, d16, y, "dw_bf16") == (max(t_dw, t_dw_bytes), "bytes")
    assert kv.dw_mode_bound(x16, nbr, d16, y, "dw_bf16_compact")[0] == pytest.approx(
        (27 * CAP * 4 + 27 * 256 * 4) / 3.35e12 * 1e3)
    for r in rows:
        assert set(r["modes"]) == set(kv.FAMILIES[r["family"]])
        assert all(np.isfinite(m["ms"]) and m["bound_ms"] > 0 and m["bound_fp32_fma_ms"] > 0
                   for m in r["modes"].values())
        assert r["noskip_vs"] == 0.0
        assert np.isfinite(r["gather_ms"] + r["product_ms"] + r["skip_saves_ms"])
    tc, b16 = rows[-2:]
    assert np.isfinite(tc["split_ms"]) and "plan" not in b16  # no plan off the card
    assert np.isfinite(b16["tiles_ms"]) and "tiles_ms" not in tc
    for r in (tc, b16):
        assert r["slab_fill"] == kv.slab_fill(nbr, CAP) and 0 < r["slab_fill"]["fill"] <= 1
    only = kv.breakdown([("tiny", feats, nbr, w)], "cpu", iters=1, warmup=0, families=("bf16",))
    assert [r["family"] for r in only] == ["bf16"]
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
    # bf16: the bf16 operands' bytes, one bf16 product a useful multiply-add at 989 TFLOP/s
    x16, w16 = feats.bfloat16(), w.bfloat16()
    t_bytes16 = (2 * CAP * 16 * 2 + 27 * CAP * 4 + 27 * 256 * 2) / 3.35e12 * 1e3
    for mode in ("bf16", "bf16_noskip", "bf16_nogather"):
        t_tc = 2 * hits * 16 * 16 / 989e12 * 1e3
        assert kv.mode_bound(x16, nbr, w16, x16, mode)[0] == pytest.approx(max(t_tc, t_bytes16))
    b, _ = kv.mode_bound(x16, nbr, w16, x16, "bf16_noproduct")
    assert b == pytest.approx(max(hits * 16 / 67e12 * 1e3,
                                  (2 * CAP * 16 * 2 + 27 * CAP * 4) / 3.35e12 * 1e3))
