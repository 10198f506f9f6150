"""Port parity of the PointNet++ ops (``ops/pointnet.py``) and modules
(``models/pointnet_modules.py``) against the JAX package.

Indices, neighbour lists and masks are held equal; fp32 tensors at
max|d| <= 1e-5 * max(|want|, 1) (``RTOL``). Every top-k and sort is stable:
ties resolve to the lowest index, as ``jnp.sort``, ``jax.lax.top_k`` and
``jnp.argmax`` do, so the tests build ties on purpose (points on a lattice,
duplicated points) and masked points.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models import pointnet_modules as jax_pm
from bevfusion_tpu.ops import pointnet as jpn
from bevfusion_tpu_torch.models.pointnet_modules import PointFPModule, PointSAModuleMSG
from bevfusion_tpu_torch.ops import pointnet as pn
from tests.torch_port_helpers import load_bridged, random_variables, rel_err

torch.set_num_threads(2)

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(seed, n=96, lattice=True):
    """Points on a 0.5 m lattice (many equal distances) with duplicates, or
    gaussian ones; and a mask with a few points off."""
    rng = np.random.RandomState(seed)
    if lattice:
        xyz = rng.randint(-4, 5, (n, 3)).astype(np.float32) * 0.5
        xyz[n // 2:n // 2 + 6] = xyz[:6]  # duplicates
    else:
        xyz = rng.randn(n, 3).astype(np.float32)
    mask = rng.rand(n) > 0.15
    return xyz, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lattice", [True, False])
def test_furthest_point_sample_matches_jax(lattice, masked):
    """Ties on the lattice go to the lowest index; masked points are taken
    only when nothing else is left (npoint above the valid count)."""
    xyz, mask = _cloud(0 if lattice else 1)
    m = mask if masked else None
    npoint = int(mask.sum()) + 4 if masked else 40
    want = np.asarray(jax.jit(functools.partial(jpn.furthest_point_sample, npoint=npoint))(
        xyz, mask=m))
    got = pn.furthest_point_sample(_t(xyz), npoint, None if m is None else _t(m))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and got[0] == 0
    if masked:
        assert mask[got.numpy()[:int(mask.sum())]].all()


def test_furthest_point_sample_batch_is_each_sample():
    """The batched form (one kernel launch on the card) is each sample's."""
    clouds = [_cloud(s) for s in (2, 3)]
    xyz, mask = np.stack([c[0] for c in clouds]), np.stack([c[1] for c in clouds])
    got = pn.furthest_point_sample(_t(xyz), 20, _t(mask))
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(),
                                      pn.furthest_point_sample(_t(xyz[b]), 20, _t(mask[b])))


def fps_kernel_transcription(xyz, npoint, mask=None):
    """``csrc/pointnet.cu``'s blocks in numpy fp32 on the form ``fps_plan``
    gives: the points dealt to the sample's T threads (a cluster's blocks
    one after the other; j = t + k T, slots past N at -inf), each round the
    distance update rounded op by op, a thread's first slot of its largest
    distance, the warp's largest distance as an ordered int and the lowest
    index holding it, then the sample's from the warps' slots, whose
    coordinates are the next round's. xyz [N, 3], mask [N] or None ->
    [npoint] int."""
    n = xyz.shape[0]
    plan = pn.fps_plan(n)
    T, P = plan["threads"] * plan["cluster"], plan["points"]
    j = np.arange(T)[:, None] + np.arange(P)[None, :] * T  # [T, P]
    inside = j < n
    pts = np.where(inside[..., None], xyz[np.minimum(j, n - 1)], 0).astype(np.float32)
    valid = np.ones(n, bool) if mask is None else mask
    dist = np.where(inside, np.where(valid[np.minimum(j, n - 1)], 1e10, -1.0),
                    -np.inf).astype(np.float32)
    out, last = [0], xyz[0]
    for _ in range(1, npoint):
        dx, dy, dz = np.moveaxis(pts - last, -1, 0)
        dist = np.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        bk = dist.argmax(1)  # the first slot of the thread's largest
        bits = dist[np.arange(T), bk].view(np.int32)
        key = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).reshape(-1, 32)
        idx = (np.arange(T) + bk * T).reshape(-1, 32)
        wkey = key.max(1)
        wj = np.where(key == wkey[:, None], idx, np.iinfo(np.int32).max).min(1)
        bj = int(np.where(wkey == wkey.max(), wj, np.iinfo(np.int32).max).min())
        out.append(bj)
        last = xyz[bj]
    return np.array(out)


@pytest.mark.parametrize("n,npoint,masked", [
    (96, 40, False), (96, 90, True), (700, 64, True), (1300, 64, False), (2048, 48, True),
    (9000, 24, False), (8193, 24, True), (20000, 8, True), (32768, 6, False)])
def test_fps_kernel_transcription_equals_plain(n, npoint, masked):
    """The kernel's blocks on the lattice (ties across threads, warps and
    blocks), masked or not, one block a sample (1, 2, 3 and 4 points a
    thread) and clusters of four blocks (past 8,192 points): the plain
    version's indices."""
    rng = np.random.RandomState(n)
    xyz = (rng.randint(-6, 7, (n, 3)) * 0.5).astype(np.float32)
    mask = rng.rand(n) > 0.3 if masked else None
    got = fps_kernel_transcription(xyz, npoint, mask)
    want = pn.furthest_point_sample_plain(_t(xyz)[None], npoint,
                                          None if mask is None else _t(mask)[None])[0]
    np.testing.assert_array_equal(got, want.numpy())


def test_square_distance_matches_jax():
    a, b = _cloud(4, 30, lattice=False)[0], _cloud(5, 20, lattice=False)[0]
    assert rel_err(pn.square_distance(_t(a), _t(b)).numpy(),
                   np.asarray(jpn.square_distance(a, b))) <= RTOL


@pytest.mark.parametrize("masked", [False, True])
def test_ball_query_matches_jax(masked):
    """First-found (index) order, padded with the first hit; a query with no
    point inside gets index 0 and valid False; more samples than points."""
    xyz, mask = _cloud(6)
    m = mask if masked else None
    q = np.concatenate([xyz[:10], np.full((2, 3), 50.0, np.float32)])  # two far queries
    for radius, nsample in ((0.8, 8), (1.2, 200)):
        want_idx, want_valid = jpn.ball_query(radius, nsample, xyz, q, m)
        got_idx, got_valid = pn.ball_query(radius, nsample, _t(xyz), _t(q),
                                           None if m is None else _t(m))
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert not got_valid[-2:].any() and (got_idx[-2:] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_knn_and_three_nn_match_jax(masked):
    """Equal distances on the lattice in index order."""
    xyz, mask = _cloud(7)
    m = mask if masked else None
    q = xyz[::7] + 0.25
    want_idx, want_d = jpn.knn(6, xyz, q, m)
    got_idx, got_d = pn.knn(6, _t(xyz), _t(q), None if m is None else _t(m))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert rel_err(got_d.numpy(), np.asarray(want_d)) <= RTOL
    want_d3, want_i3 = jpn.three_nn(q, xyz, m)
    got_d3, got_i3 = pn.three_nn(_t(q), _t(xyz), None if m is None else _t(m))
    np.testing.assert_array_equal(got_i3.numpy(), np.asarray(want_i3))
    assert rel_err(got_d3.numpy(), np.asarray(want_d3)) <= RTOL


def test_gather_group_interpolate_and_paconv_match_jax():
    rng = np.random.RandomState(8)
    feats = rng.randn(40, 5).astype(np.float32)
    idx = rng.randint(0, 40, (12, 3)).astype(np.int32)
    np.testing.assert_array_equal(pn.gather_points(_t(feats), _t(idx[:, 0])).numpy(),
                                  np.asarray(jpn.gather_points(feats, idx[:, 0])))
    np.testing.assert_array_equal(pn.group_points(_t(feats), _t(idx)).numpy(),
                                  np.asarray(jpn.group_points(feats, idx)))
    d = rng.rand(12, 3).astype(np.float32)
    w = np.asarray(jpn.interpolation_weights(d))
    assert rel_err(pn.interpolation_weights(_t(d)).numpy(), w) <= RTOL
    assert rel_err(pn.three_interpolate(_t(feats), _t(idx), _t(w)).numpy(),
                   np.asarray(jpn.three_interpolate(feats, idx, w))) <= RTOL
    S, K, M, C, N = 6, 4, 3, 8, 20
    scores = rng.rand(S, K, M).astype(np.float32)
    pf, cf = rng.randn(N, M, C).astype(np.float32), rng.randn(N, M, C).astype(np.float32)
    kidx = rng.randint(0, N, (S, K)).astype(np.int32)
    assert rel_err(pn.assign_score_withk(_t(scores), _t(pf), _t(cf), _t(kidx)).numpy(),
                   np.asarray(jpn.assign_score_withk(scores, pf, cf, kidx))) <= RTOL


def test_sa_msg_and_fp_modules_match_jax():
    """Multi-scale set abstraction (masked points) then feature propagation,
    eval (running statistics), through the bridge's LiDAR-backbone names."""
    xyz, mask = _cloud(9, 128, lattice=False)
    feats = np.random.RandomState(10).randn(128, 6).astype(np.float32)
    sa_cfg = dict(num_point=16, radii=(0.5, 1.0), sample_nums=(8, 16),
                  mlp_channels=((8, 16), (8, 12)))
    jsa = jax_pm.PointSAModuleMSG(**sa_cfg)
    jx = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(mask))
    v_sa = random_variables(jsa.init, *jx, seed=11)
    want_xyz, want_f = jax.jit(jsa.apply)(v_sa, *jx)
    sa = load_bridged(PointSAModuleMSG(**sa_cfg, in_channels=6), v_sa, "lidar_backbone",
                      "encoders.lidar.backbone.")
    with torch.no_grad():
        got_xyz, got_f = sa(_t(xyz), _t(feats), _t(mask))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got_f.shape == (16, 28) and rel_err(got_f.numpy(), np.asarray(want_f)) <= RTOL

    jfp = jax_pm.PointFPModule(mlp_channels=(10, 7))
    v_fp = random_variables(jfp.init, xyz, want_xyz, feats, want_f, seed=12)
    want = np.asarray(jax.jit(jfp.apply)(v_fp, xyz, want_xyz, feats, want_f))
    fp = load_bridged(PointFPModule((10, 7), in_channels=28 + 6), v_fp, "lidar_backbone",
                      "encoders.lidar.backbone.")
    with torch.no_grad():
        got = fp(_t(xyz), got_xyz, _t(feats), got_f).numpy()
    assert rel_err(got, want) <= RTOL


def test_sa_module_without_features_and_xyz():
    """No input features: the group's offsets alone; ``use_xyz=False`` with
    features: the features alone (the first layer's width follows)."""
    xyz, _ = _cloud(13, 64, lattice=False)
    feats = np.random.RandomState(14).randn(64, 4).astype(np.float32)
    for use_xyz, f, cin in ((True, None, 3), (False, feats, 4)):
        jm = jax_pm.PointSAModule(num_point=8, radii=(0.8,), sample_nums=(8,),
                                  mlp_channels=((6,),), use_xyz=use_xyz)
        jx = (jnp.asarray(xyz), None if f is None else jnp.asarray(f))
        v = random_variables(jm.init, *jx, seed=15)
        assert v["params"]["mlp0"]["fc0"]["kernel"].shape[0] == cin
        _, want = jax.jit(jm.apply)(v, *jx)
        m = load_bridged(PointSAModuleMSG(8, (0.8,), (8,), ((6,),), use_xyz=use_xyz,
                                          in_channels=0 if f is None else 4),
                         v, "lidar_backbone", "encoders.lidar.backbone.")
        with torch.no_grad():
            _, got = m(_t(xyz), None if f is None else _t(f))
        assert rel_err(got.numpy(), np.asarray(want)) <= RTOL
