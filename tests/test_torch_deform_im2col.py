"""D1, the deformable im2col (``csrc/deform_conv.cu``), where the kernel
cannot run: its launch plan (``deform_im2col_plan``) and a numpy
transcription of the kernel's decomposition held to the plain version.

The transcription fills the column as the kernel does: blocks over tiles
of one output row, each block's (position, tap) table (four corner element
offsets and weights, the mask), then the threads' walk over the block's
run of channel vectors with the kernel's quotients (multiplies by a
reciprocal) and its increments. Each product and sum is a float32 numpy
operation rounded on its own, so the column must equal
``deform_im2col_plain``'s bit for bit; it also counts each (n, k, c)
written exactly once. The card's kernel is held to the plain version in
``tests/test_torch_cuda.py``; the plain version to the JAX package in
``tests/test_torch_long_tail.py``.
"""
import numpy as np
import pytest
import torch

from bevfusion_tpu_torch.ops import deform_conv as dc

torch.set_num_threads(2)

F32 = np.float32


def _rcp(d):
    """The host's reciprocal for the kernel's quotients: ceil(2^32 / d)."""
    return ((1 << 32) + d - 1) // d


def _quot(n, m):
    return (np.asarray(n, np.int64) * m) >> 32


def kernel_transcription(x, off, mask, kw, stride, pad, plan):
    """``csrc/deform_conv.cu``'s blocks in numpy float32 on ``plan``: x [B,
    H, W, C], off [B, Ho, Wo, 2K], mask [B, Ho, Wo, K] or None -> col [B*Ho*Wo,
    K*C]."""
    B, H, W, C = x.shape
    K = kw * kw
    Ho, Wo = (H + 2 * pad - kw) // stride + 1, (W + 2 * pad - kw) // stride + 1
    P, T, V = plan["positions"], plan["threads"], plan["vec"]
    xf, of = x.reshape(-1), off.reshape(-1)
    mf = None if mask is None else mask.reshape(-1)
    col = np.zeros(B * Ho * Wo * K * C, F32)
    seen = np.zeros(col.size, np.int64)
    cv = C // V
    tid = np.arange(T)
    dq = int(_quot(T, _rcp(cv)))
    dr = T - dq * cv
    for b in range(B):
        for oy in range(Ho):
            for ox0 in range(0, Wo, P):
                pairs = min(P, Wo - ox0) * K
                n0 = (b * Ho + oy) * Wo + ox0
                # phase 1: a thread a pair t = p*K + k
                t = np.arange(pairs)
                p = _quot(t, _rcp(K))
                k = t - p * K
                ky = _quot(k, _rcp(kw))
                kx = k - ky * kw
                py = (oy * stride - pad + ky).astype(F32) + of[2 * (n0 * K + t)]
                px = ((ox0 + p) * stride - pad + kx).astype(F32) + of[2 * (n0 * K + t) + 1]
                y0, x0 = np.floor(py), np.floor(px)
                wy, wx = py - y0, px - x0
                uy, ux = F32(1) - wy, F32(1) - wx
                corners = ((y0, x0, uy * ux), (y0, x0 + F32(1), uy * wx),
                           (y0 + F32(1), x0, wy * ux), (y0 + F32(1), x0 + F32(1), wy * wx))
                at, wt = [], []
                for cy, cx, cw in corners:
                    inside = (cy >= 0) & (cy < H) & (cx >= 0) & (cx < W)
                    yi = np.clip(cy, 0, H - 1).astype(np.int64)
                    xi = np.clip(cx, 0, W - 1).astype(np.int64)
                    at.append(((b * H + yi) * W + xi) * C)
                    wt.append(np.where(inside, cw, F32(0)))
                mk = None if mf is None else mf[n0 * K + t]
                # phase 2: thread tid's vectors tid, tid + T, ... of the block's run
                vectors = pairs * cv
                pair = _quot(tid, _rcp(cv))
                c = tid - pair * cv
                for v0 in range(0, vectors, T):
                    live = v0 + tid < vectors
                    v, pr, cc = v0 + tid[live], pair[live], c[live]
                    assert np.array_equal(v, pr * cv + cc)
                    for j in range(V):
                        a = [xf[at[q][pr] + cc * V + j] for q in range(4)]
                        r = a[0] * wt[0][pr] + a[1] * wt[1][pr]
                        r = r + a[2] * wt[2][pr]
                        r = r + a[3] * wt[3][pr]
                        if mk is not None:
                            r = r * mk[pr]
                        e = n0 * K * C + v * V + j
                        col[e] = r
                        seen[e] += 1
                    c, pair = c + dr, pair + dq
                    wrap = c >= cv
                    c[wrap] -= cv
                    pair[wrap] += 1
    assert (seen == 1).all()
    return col.reshape(B * Ho * Wo, K * C)


def _inputs(seed, B, H, W, C, stride, modulated):
    """Offsets of a few pixels, some taps on integers, some far outside."""
    rng = np.random.RandomState(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.randn(B, H, W, C).astype(F32)
    off = rng.uniform(-3.0, 3.0, (B, Ho, Wo, 18))
    on_int = rng.rand(*off.shape) < 0.3
    off[on_int] = np.round(off[on_int])
    off[rng.rand(*off.shape) < 0.05] = 40.0
    mask = rng.rand(B, Ho, Wo, 9).astype(F32) if modulated else None
    return x, off.astype(F32), mask


# the card tests' forms: vectors (C 64, 4), scalars (C 5, 33), rows shorter than a block's 16
# positions (7, 6), of one more (17), ragged (33, 20, 65), stride 2, B = 2, modulated and not
@pytest.mark.parametrize("B,H,W,C,stride,modulated", [
    (1, 6, 7, 64, 1, False), (1, 5, 33, 4, 1, True), (2, 9, 11, 5, 2, False),
    (2, 9, 11, 5, 2, True), (1, 4, 17, 33, 1, True), (2, 5, 40, 64, 2, True),
    (1, 3, 65, 8, 1, False)])
def test_kernel_transcription_equals_plain(B, H, W, C, stride, modulated):
    x, off, mask = _inputs(B * H * W + C, B, H, W, C, stride, modulated)
    Ho, Wo = off.shape[1:3]
    plan = dc.deform_im2col_plan(B, Ho, Wo, C, 9)
    assert plan["vec"] == (4 if C % 4 == 0 else 1)
    got = kernel_transcription(x, off, mask, 3, stride, 1, plan)
    want = dc.deform_im2col_plain(torch.from_numpy(x), torch.from_numpy(off),
                                  None if mask is None else torch.from_numpy(mask), 3, stride, 1)
    assert np.array_equal(got, want.numpy())


def test_kernel_transcription_scalar_form_of_a_vector_shape():
    """x not 16-byte aligned: the plan takes the scalar form at C % 4 == 0."""
    x, off, mask = _inputs(7, 1, 5, 9, 12, 1, True)
    plan = dc.deform_im2col_plan(1, 5, 9, 12, 9, aligned=False)
    assert plan["vec"] == 1
    want = dc.deform_im2col_plain(torch.from_numpy(x), torch.from_numpy(off),
                                  torch.from_numpy(mask), 3, 1, 1)
    assert np.array_equal(kernel_transcription(x, off, mask, 3, 1, 1, plan), want.numpy())


def test_deform_im2col_plan_choices():
    assert dc.deform_im2col_plan(1, 128, 128, 64, 9) == {
        "positions": 16, "threads": 512, "vec": 4, "smem_bytes": 16 * 9 * 36}
    assert dc.deform_im2col_plan(2, 5, 6, 5, 9)["positions"] == 6  # a row shorter than 16
    assert dc.deform_im2col_plan(2, 5, 17, 5, 9)["positions"] == 16  # 16 + 1: a block of 1
    assert dc.deform_im2col_plan(1, 4, 7, 33, 9)["vec"] == 1
    assert dc.deform_im2col_plan(1, 4, 7, 64, 9, aligned=False)["vec"] == 1
    assert dc.deform_im2col_plan(1, 1, 1, 4, 1)["threads"] == 32  # one vector: one warp
    assert dc.deform_im2col_plan(1, 9, 9, 4, 9)["threads"] == 96  # 9 x 9 vectors
    assert dc.deform_im2col_plan(1, 64, 64, 16, 121)["positions"] == 11  # 11 x 11 taps: 48 KB


def test_deform_im2col_plan_limits():
    """Every plan within the kernel's block; sizes it refuses raise."""
    for K in (1, 4, 9, 25, 49, 81, 121, 1225):
        for Wo in (1, 2, 15, 16, 17, 100, 1000):
            for C in (1, 3, 4, 5, 64, 256, 65535):
                p = dc.deform_im2col_plan(1, 3, Wo, C, K)
                assert 1 <= p["positions"] <= min(16, Wo)
                assert p["smem_bytes"] == p["positions"] * K * 36 <= 48 * 1024
                assert 32 <= p["threads"] <= 512 and p["threads"] % 32 == 0
                assert p["vec"] in (1, 4) and C % p["vec"] == 0
    for args in ((0, 4, 4, 4, 9), (65536, 4, 4, 4, 9), (1, 65536, 4, 4, 9), (1, 4, 4, 65536, 9),
                 (1, 4, 4, 4, 37 * 37)):
        with pytest.raises(ValueError):
            dc.deform_im2col_plan(*args)


def test_deform_im2col_refuses_sizes_past_int32_before_allocating():
    """The column of x [1, 1024, 1024, 16] with 13 x 13 taps has 2.8 G
    elements: the launch raises on the shapes (meta tensors, no memory)."""
    x = torch.empty(1, 1024, 1024, 16, device="meta")
    with pytest.raises(ValueError, match="32-bit"):
        dc._launch_im2col(x, torch.empty(1, device="meta"), None, 13, 1, 6)
    x = torch.empty(1, 1024, 1024, 16, device="meta")  # 9 taps: 151 M elements, in range
    with pytest.raises(ValueError, match="offset must be"):
        dc._launch_im2col(x, torch.empty(1, device="meta"), None, 3, 1, 1)
