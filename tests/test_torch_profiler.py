"""The port's profiler (bevfusion_tpu_torch/utils/profiler.py) against the
JAX package's (bevfusion_tpu/utils/profiler.py), and the FLOPs it adds for
the port's own kernels, on the CPU.

FLOPs: a matmul counts 2*M*K*N in both, exactly. A convolution counts
2 * Cin * kh * kw per output element in PyTorch's ``FlopCounterMode``;
XLA's cost analysis counts only the taps that land inside the input, so
with zero padding it counts fewer by construction: exactly the padded
taps, which the test computes (equal counts without padding).
"""
import ast
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from bevfusion_tpu.utils import profiler as jprof
from bevfusion_tpu_torch.ops import bev_pool as bp
from bevfusion_tpu_torch.ops import sparse_conv as sp
from bevfusion_tpu_torch.utils import profiler

torch.set_num_threads(2)


def test_matmul_flops_equal_xla():
    a, b = np.ones((64, 96), np.float32), np.ones((96, 40), np.float32)
    want = jprof.flops_of(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))["flops"]
    got = profiler.flops_of(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    assert got["flops"] == want == 2 * 64 * 96 * 40
    assert got["kernel_flops"] == 0


def _in_bounds_taps(size, k, stride, pad):
    """Taps of one axis that land inside the input, summed over outputs."""
    out = (size + 2 * pad - k) // stride + 1
    return sum(0 <= o * stride - pad + t < size for o in range(out) for t in range(k)), out


@pytest.mark.parametrize("pad,stride", [(0, 1), (1, 1), (1, 2)])
def test_conv_flops_vs_xla(pad, stride):
    N, H, W, Cin, Cout, k = 2, 16, 20, 24, 32, 3
    conv = nn.Conv2d(Cin, Cout, k, stride, pad, bias=False)
    x = torch.randn(N, Cin, H, W)
    got = profiler.flops_of(conv, x)["flops"]
    taps_h, Ho = _in_bounds_taps(H, k, stride, pad)
    taps_w, Wo = _in_bounds_taps(W, k, stride, pad)
    assert got == 2 * N * Ho * Wo * Cout * Cin * k * k  # every tap, padded or not
    want = jprof.flops_of(
        lambda a, w: jax.lax.conv_general_dilated(a, w, (stride, stride), ((pad, pad), (pad, pad)),
                                                  dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.ones((N, H, W, Cin)), jnp.ones((k, k, Cin, Cout)))["flops"]
    assert want == 2 * N * taps_h * taps_w * Cout * Cin  # only the taps inside the input
    assert want == got * (taps_h * taps_w) / (Ho * Wo * k * k)
    if pad == 0:
        assert want == got


def _conv_operands(cin=8, cout=16, seed=0):
    grid = sp.SparseGrid(12, 12, 6)
    rng = np.random.RandomState(seed)
    ids = np.full(500, grid.size, np.int32)
    ids[:400] = np.sort(rng.choice(grid.size, 400, replace=False))
    nbr = sp.build_subm_rulebook(torch.from_numpy(ids), grid)
    feats = torch.from_numpy(rng.randn(500, cin).astype(np.float32))
    w = torch.from_numpy(rng.randn(27, cin, cout).astype(np.float32))
    return feats, nbr, w


def test_kernel_flops_are_the_hit_pairs():
    """A sparse conv adds 2*Cin*Cout per hit pair (``nbr >= 0``), not the
    dense matmul of its plain version; through ``SparseConvFunction`` the
    forward, the backward-data (mirrored weights) and the weight gradient
    each add theirs."""
    feats, nbr, w = _conv_operands()
    hits = int((nbr >= 0).sum())
    assert 0 < hits < nbr.numel()
    got = profiler.flops_of(lambda: sp.sparse_conv(feats, nbr, w))  # looked up when called
    assert got["kernels"] == {"sparse_conv": 2 * hits * 8 * 16}
    assert got["aten_flops"] == 0 and got["flops"] == 2 * hits * 8 * 16

    def launch():  # what a wrapper does on the card, through its module's name
        sp.sparse_conv.launches += 1

    before = sp.sparse_conv.launches
    profiler.flops_of(launch)
    assert sp.sparse_conv.launches == before + 1  # counted on the wrapper itself

    x, wt = feats.clone().requires_grad_(), w.clone().requires_grad_()
    got = profiler.flops_of(lambda: sp.SparseConvFunction.apply(x, wt, nbr).sum().backward())
    assert got["kernels"] == {"sparse_conv": 2 * (2 * hits * 8 * 16),
                              "sparse_conv_dw": 2 * hits * 8 * 16}
    assert got["aten_flops"] == 0


COUNTED = {"sparse_conv", "sparse_conv_dw", "bev_pool"}
REPO = pathlib.Path(__file__).resolve().parents[1]


def test_no_caller_binds_a_counted_wrapper_by_name():
    """``flops_of`` counts the kernels by swapping the wrappers in their
    modules (``ops.sparse_conv``, ``ops.bev_pool``) for the call, so every
    caller must look them up through the module when it calls: a
    ``from ...ops.sparse_conv import sparse_conv`` anywhere in the port or
    in chip_smoke.py would bind the unswapped wrapper and drop its FLOPs."""
    files = sorted((REPO / "bevfusion_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bound = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.split(".")[-1] in ("sparse_conv", "bev_pool")):
                bound += [f"{f.relative_to(REPO)}:{node.lineno} {a.name}"
                          for a in node.names if a.name in COUNTED]
    assert len(files) > 40 and not bound, bound


def test_pool_flops_are_two_per_point_and_channel():
    B, N, D, fH, fW, C, Z, X, Y = 1, 2, 5, 3, 4, 6, 1, 8, 8
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, Z * X * Y, (B, N, D, fH, fW)))
    valid = torch.from_numpy(rng.rand(B, N, D, fH, fW) < 0.8)
    iv = bp.build_intervals(ids, valid, Z * X * Y)
    depth = torch.rand(B, N, D, fH, fW)
    ctx = torch.randn(B, N, fH, fW, C)
    got = profiler.flops_of(lambda: bp.bev_pool(depth, ctx, iv, Z, X, Y))
    assert got["kernels"] == {"bev_pool": 2 * int(valid.sum()) * C}
    assert got["aten_flops"] == 0


def test_time_fn_keys_and_the_card_default():
    r = profiler.time_fn(lambda a: a * 2, torch.ones(8), iters=3, warmup=1, device="cpu")
    assert set(r) == {"mean_ms", "median_ms", "fps"}
    assert all(np.isfinite(v) and v > 0 for v in r.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            profiler.time_fn(lambda: None)  # the card unless the caller asks for the CPU


def test_time_fn_queue_ahead_on_the_cpu_is_the_host_clock():
    """``queue_ahead`` concerns the card only: on the CPU the host clock
    times each call, with or without it."""
    calls = []
    r = profiler.time_fn(lambda: calls.append(time.sleep(0.002)), iters=3, warmup=1,
                         device="cpu", queue_ahead=True)
    assert set(r) == {"mean_ms", "median_ms", "fps"} and len(calls) == 4
    assert r["median_ms"] >= 2.0


def test_bound_is_the_larger_of_operations_and_bytes():
    assert profiler.bound(67e9, 0) == (pytest.approx(1.0), "operations")
    assert profiler.bound(0, 3.35e9) == (pytest.approx(1.0), "bytes")
    assert profiler.bound(67e9, 0, profiler.TF32_FLOPS)[0] == pytest.approx(67 / 495)
    assert profiler.nbytes(torch.ones(3, 4), None, torch.ones(2, dtype=torch.bfloat16)) == 52


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "tr" / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())


def test_device_trace_on_the_cpu_sees_no_card():
    """``device_trace`` runs the call a warmup, a timed call and one a
    session, and counts only the card's activities: on the CPU none, busy 0,
    idle 1."""
    calls = []
    r = profiler.device_trace(lambda: calls.append(torch.ones(64, 64) @ torch.ones(64, 64)),
                              ("mm",), device="cpu", sessions=2)
    assert len(calls) == 4
    assert set(r) == {"wall_ms", "device_activities", "device_busy_ms", "mark_ms", "idle_share",
                      "activities_per_session", "top"}
    assert r["wall_ms"] > 0 and r["device_activities"] == 0 and r["top"] == []
    assert r["activities_per_session"] == [0, 0]
    assert r["device_busy_ms"] == r["mark_ms"] == 0 and r["idle_share"] == 1
