"""The port's GT database and ObjectPaste (bevfusion_tpu_torch/data/
dbsampler.py, data/converter.py, tools/create_data.py) against the JAX
package's, bit for bit, and the stable per-sample seed
(data/nuscenes.py:sample_seed).

- ``points_in_rbbox_libm`` (``core/box_np.py``) against the JAX package's
  native C++ call (``bevfusion_tpu.native.points_in_rbbox``, the one its
  ObjectPaste makes) on seeded points and on points placed on the faces,
  the top, the bottom and the corners of boxes, and ``points_in_rbbox``
  against the JAX package's numpy one (its converter's); the two JAX tests
  disagree on face points (pinned);
- ``_boxes_overlap_bev`` on seeded rotated boxes;
- ``create_gt_database`` on a synthesized train split: the same crop
  files, byte for byte, and the same dbinfos pkl; ``tools/create_data.py
  --skip-infos`` writes the same; ``create_nuscenes_infos`` raises the
  devkit's ImportError in both packages;
- ``DataBaseSampler.sample_all`` and ``ObjectPaste`` on seeded scenes with
  the same ``_rng``, at every epoch around ``stop_epoch`` (after it the
  scene passes through unchanged), and the whole train pipeline of the
  flagship config, ObjectPaste first, on the synthesized set;
- the same sample gives the same bytes in two processes with different
  ``PYTHONHASHSEED`` values; the JAX package's ``hash(token)`` seed does
  not (its fault, pinned).
"""
import functools
import os
import pickle
import subprocess
import sys
import zlib

import numpy as np
import pytest

from bevfusion_tpu import native as jax_native
from bevfusion_tpu.core import box_np as jbox
from bevfusion_tpu.data import converter as jconverter
from bevfusion_tpu.data import dbsampler as jdb
from bevfusion_tpu.data import nuscenes as jnusc
from bevfusion_tpu.data import points as jpoints
from bevfusion_tpu_torch.config import load_config
from bevfusion_tpu_torch.core import box_np as pbox
from bevfusion_tpu_torch.data import converter as pconverter
from bevfusion_tpu_torch.data import dbsampler as pdb
from bevfusion_tpu_torch.data import nuscenes as pnusc
from bevfusion_tpu_torch.data import points as ppoints
from bevfusion_tpu_torch.data import synthetic
from bevfusion_tpu_torch.runtime.flagship import FLAGSHIP_CONFIG
from bevfusion_tpu_torch.tools import create_data
from tests.test_torch_data import same

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = list(synthetic.CLASSES)
PCR = (-30.0, -30.0, -5.0, 30.0, 30.0, 3.0)


def _boxes(rng, n):
    return np.concatenate([rng.uniform(-25, 25, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                           rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
                          -1).astype(np.float32)


def _on_surfaces(boxes, rng, per_box=400):
    """Points on each box's four side faces, top, bottom and corners (box
    frame: |lx| = dx/2 or |ly| = dy/2, lz = 0 or dz), placed in float64 and
    rounded to float32."""
    out = []
    for x, y, z, dx, dy, dz, yaw in boxes.astype(np.float64):
        u = rng.uniform(-0.5, 0.5, (per_box, 3)) * [dx, dy, dz]
        u[:, 2] += dz / 2
        k = np.arange(per_box) % 7
        u[k == 0, 0], u[k == 1, 0] = dx / 2, -dx / 2
        u[k == 2, 1], u[k == 3, 1] = dy / 2, -dy / 2
        u[k == 4, 2], u[k == 5, 2] = 0.0, dz
        u[k == 6] = np.array([dx / 2, -dy / 2, dz]) * rng.choice([-1, 1], (np.sum(k == 6), 3))
        c, s = np.cos(yaw), np.sin(yaw)
        out.append(np.stack([x + c * u[:, 0] - s * u[:, 1], y + s * u[:, 0] + c * u[:, 1],
                             z + u[:, 2], rng.rand(per_box), rng.rand(per_box)], -1))
    return np.concatenate(out).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_points_in_rbbox_equals_the_native_call(seed):
    """200,000 seeded points and 2,800 on the surfaces of 50 boxes: the
    port's ``points_in_rbbox_libm`` and the JAX package's C++ loop give the
    same mask; the port's ``points_in_rbbox`` and the JAX package's numpy
    one (which its converter calls) give the same mask."""
    assert jax_native.available(), "the JAX package's native host library did not build"
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, 50)
    pts = np.concatenate([np.concatenate([rng.uniform(-30, 30, (200000, 2)),
                                          rng.uniform(-3, 3, (200000, 1)),
                                          rng.rand(200000, 2)], -1).astype(np.float32),
                          _on_surfaces(boxes[:7], rng)])
    got = pbox.points_in_rbbox_libm(pts, boxes)
    want = jax_native.points_in_rbbox(pts, boxes)
    assert got.dtype == want.dtype == bool and got.shape == want.shape == (len(pts), 50)
    np.testing.assert_array_equal(got, want)
    assert 1000 < got[-2800:].sum() < 2800  # the surface points sit on the boundary
    np.testing.assert_array_equal(pbox.points_in_rbbox(pts, boxes),
                                  jbox.points_in_rbbox(pts, boxes))


def test_the_jax_packages_two_point_in_box_tests_disagree_on_faces():
    """The JAX package's numpy test (its converter's, and its ObjectPaste's
    where the C++ library does not build) and its C++ loop (its
    ObjectPaste's) differ on points on a box's face: numpy's float32 sin and
    cos are not the C library's sinf and cosf in the last bit (box 3 of seed
    0: its sin), which moves such a point across the face."""
    rng = np.random.RandomState(0)
    boxes = _boxes(rng, 50)
    pts = _on_surfaces(boxes[:7], rng)
    numpy_mask, native_mask = jbox.points_in_rbbox(pts, boxes), jax_native.points_in_rbbox(
        pts, boxes)
    assert 0 < (numpy_mask != native_mask).sum() < 100
    np.testing.assert_array_equal(pbox.points_in_rbbox_libm(pts, boxes), native_mask)


def test_boxes_overlap_matches_jax():
    rng = np.random.RandomState(3)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    a[:, :2] *= 0.2  # crowded, so some overlap
    ca, cb = pbox.corners_bev(a[:, [0, 1, 3, 4, 6]]), pbox.corners_bev(b[:, [0, 1, 3, 4, 6]])
    got = pdb._boxes_overlap_bev(ca, cb)
    same(got, jdb._boxes_overlap_bev(ca, cb))
    same(pdb._boxes_overlap_bev(ca, ca), jdb._boxes_overlap_bev(ca, ca))
    assert 0 < got.sum() < got.size
    same(pdb._boxes_overlap_bev(ca[:0], cb), jdb._boxes_overlap_bev(ca[:0], cb))


# ---------------------------------------------------------------- the GT database

@functools.lru_cache(maxsize=None)
def _train_set(root):
    """Six train samples (boxes around keyframe points) and three val ones."""
    synthetic.write_synthetic_nuscenes(
        root, num_samples=3, num_cameras=1, image_hw=(32, 64), points_per_sweep=3000,
        num_sweeps=2, point_cloud_range=PCR, num_gt=8, seed=4, train_samples=6)
    return root


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    return _train_set(str(tmp_path_factory.mktemp("nusc")))


def _tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


@functools.lru_cache(maxsize=None)
def _databases(root):
    """The GT database of the train split written by each package (and by
    the port's CLI) into its own directory: {writer: {file: bytes}}."""
    info = os.path.join(root, "nuscenes_infos_train.pkl")
    out = {}
    for name, write in (
            ("port", lambda d: pconverter.create_gt_database(d, info, CLASSES)),
            ("jax", lambda d: jconverter.create_gt_database(d, info, CLASSES)),
            ("cli", lambda d: create_data.main(["nuscenes", "--root", d, "--skip-infos"]))):
        d = os.path.join(root, f"db_{name}")
        os.makedirs(d)
        if name == "cli":
            with open(info, "rb") as f, open(os.path.join(d, "nuscenes_infos_train.pkl"),
                                              "wb") as g:
                g.write(f.read())
        write(d)
        out[name] = _tree_bytes(d)
    return out


def test_gt_database_matches_jax(nusc_root):
    dbs = _databases(nusc_root)
    got, want = dbs["port"], dbs["jax"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    infos = pickle.loads(want["nuscenes_dbinfos_train.pkl"])
    crops = [i for v in infos.values() for i in v]
    assert len(crops) == 6 * 8 and len(got) == 6 * 8 + 1
    assert sum(i["num_points_in_gt"] >= 5 for i in crops) >= 24  # the boxes hold points
    cli = dict(dbs["cli"])
    cli.pop("nuscenes_infos_train.pkl")
    assert cli == got


def test_create_nuscenes_infos_needs_the_devkit_in_both(tmp_path):
    errors = []
    for mod in (pconverter, jconverter):
        with pytest.raises(ImportError) as err:
            mod.create_nuscenes_infos(str(tmp_path))
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    with pytest.raises(ImportError):
        create_data.main(["nuscenes", "--root", str(tmp_path)])


# ---------------------------------------------------------------- sampling and pasting

def _sampler_cfg(root, rate=1.0):
    return {"dataset_root": os.path.join(root, "db_port"),
            "info_path": os.path.join(root, "db_port", "nuscenes_dbinfos_train.pkl"),
            "rate": rate, "prepare": {"filter_by_difficulty": [-1],
                                      "filter_by_min_points": {c: 5 for c in CLASSES}},
            "classes": CLASSES,
            "sample_groups": {"car": 2, "truck": 3, "construction_vehicle": 7, "bus": 4,
                              "trailer": 6, "barrier": 2, "motorcycle": 6, "bicycle": 6,
                              "pedestrian": 2, "traffic_cone": 2},
            "points_loader": {"type": "LoadPointsFromFile", "load_dim": 5, "use_dim": 5}}


def _scene(pkg, seed):
    pts_mod, box_mod = pkg
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-30, 30, (3000, 2)), rng.uniform(-2, 1, (3000, 1)),
                          rng.rand(3000, 2)], -1).astype(np.float32)
    boxes = np.concatenate([_boxes(rng, 5), rng.uniform(-2, 2, (5, 2)).astype(np.float32)], -1)
    return {"points": pts_mod.LiDARPoints(pts, 5), "gt_bboxes_3d": box_mod.LiDARBoxes3D(boxes, 9),
            "gt_labels_3d": rng.randint(0, 10, 5), "_rng": np.random.RandomState(seed + 100)}


@pytest.mark.parametrize("rate", [1.0, 0.5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_all_matches_jax(nusc_root, seed, rate):
    _databases(nusc_root)
    got = pdb.DataBaseSampler(**_sampler_cfg(nusc_root, rate))
    want = jdb.DataBaseSampler(**_sampler_cfg(nusc_root, rate))
    same(got.db_infos, want.db_infos)
    scene = _scene((ppoints, pbox), seed)
    args = (scene["gt_bboxes_3d"].tensor, scene["gt_labels_3d"])
    out = got.sample_all(*args, np.random.RandomState(seed))
    same(out, want.sample_all(*args, np.random.RandomState(seed)))
    assert out is not None and len(out["gt_labels_3d"]) >= 3


@pytest.mark.parametrize("epoch", [None, 0, 2, 3, 5])
def test_object_paste_matches_jax_around_stop_epoch(nusc_root, epoch):
    """``stop_epoch`` 3: before it the sampled crops come first in the
    cloud, the points inside the sampled boxes are gone; from epoch 3 on
    the scene passes through."""
    _databases(nusc_root)
    outs = []
    for mod, pkg in ((pdb, (ppoints, pbox)), (jdb, (jpoints, jbox))):
        paste = mod.ObjectPaste(dict(_sampler_cfg(nusc_root), type="DataBaseSampler"),
                                stop_epoch=3)
        if epoch is not None:
            paste.set_epoch(epoch)
        outs.append((paste(_scene(pkg, 7)), _scene(pkg, 7)))
    (got, scene), (want, _) = outs
    same(got, want)
    pasted = len(got["gt_labels_3d"]) - len(scene["gt_labels_3d"])
    if epoch is not None and epoch >= 3:
        assert pasted == 0
        same(got["points"].tensor, scene["points"].tensor)
    else:
        assert pasted >= 3 and len(got["points"]) != len(scene["points"])
        inside = pbox.points_in_rbbox(scene["points"].coord,
                                      got["gt_bboxes_3d"].tensor[len(scene["gt_labels_3d"]):, :7])
        n_crop = len(got["points"]) - (len(scene["points"]) - inside.any(-1).sum())
        same(got["points"].tensor[n_crop:], scene["points"].tensor[~inside.any(-1)])


def _flagship_root(root):
    """A dataset root for the flagship config: the port's GT database of the
    train split with the train infos beside it."""
    _databases(root)
    db = os.path.join(root, "db_port") + "/"
    with open(os.path.join(root, "nuscenes_infos_train.pkl"), "rb") as f, \
            open(db + "nuscenes_infos_train.pkl", "wb") as g:
        g.write(f.read())
    return db


def test_flagship_train_pipeline_with_object_paste_matches_jax(nusc_root, monkeypatch):
    """The flagship config's train pipeline (``ObjectPaste`` first of the
    augmentations; every step bar LoadBEVSegmentation, which needs a map)
    on the train split, epochs 0 and 1: both packages give the same bytes
    when the JAX one seeds each sample as the port does (its ``hash`` of the
    token replaced by ``zlib.crc32``)."""
    root = _flagship_root(nusc_root)
    cfg = load_config(FLAGSHIP_CONFIG, overrides={"dataset_root": root, "max_points": 20000})
    train = dict(cfg.data.train.dataset, pipeline=[
        s for s in cfg.train_pipeline if s["type"] != "LoadBEVSegmentation"])
    monkeypatch.setattr(jnusc, "hash", lambda token: zlib.crc32(token.encode()), raising=False)
    ps, js = pnusc.build_dataset(train), jnusc.build_dataset(train)
    for epoch in (0, 1):
        ps.set_epoch(epoch)
        js.set_epoch(epoch)
        for i in range(2):
            got = ps[i]
            same(got, js[i], f"epoch {epoch} sample {i}")
            assert got["gt_valid"].sum() > 8  # the sample's boxes and the pasted ones


# ---------------------------------------------------------------- the seed

_DIGEST = """
import hashlib, sys, zlib
sys.path.insert(0, {root!r})
import numpy as np
from bevfusion_tpu_torch.config import load_config
from bevfusion_tpu_torch.runtime.flagship import FLAGSHIP_CONFIG
from bevfusion_tpu_torch.data import nuscenes as pnusc
from bevfusion_tpu.data import nuscenes as jnusc
cfg = load_config(FLAGSHIP_CONFIG, overrides={{"dataset_root": {root_db!r}, "max_points": 20000}})
train = dict(cfg.data.train.dataset, pipeline=[
    s for s in cfg.train_pipeline if s["type"] != "LoadBEVSegmentation"])
for name, mod in (("port", pnusc), ("jax", jnusc)):
    ds = mod.build_dataset(train)
    ds.set_epoch(1)
    sample = ds[1]
    h = hashlib.sha256()
    for k in sorted(sample):
        h.update(k.encode() + np.ascontiguousarray(sample[k]).tobytes())
    print(name, h.hexdigest(), pnusc.sample_seed(ds.data_infos[1]["token"], 1))
"""


def test_sample_bytes_do_not_depend_on_the_hash_seed(nusc_root):
    """Sample 1 of the train split at epoch 1 through the flagship's train
    pipeline, in two processes (``PYTHONHASHSEED`` 1 and 2): the port gives
    the same bytes in both, the JAX package (``hash(token)``) does not."""
    code = _DIGEST.format(root=ROOT, root_db=_flagship_root(nusc_root))
    outs = []
    for hash_seed in ("1", "2"):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=120, env=dict(os.environ, PYTHONHASHSEED=hash_seed,
                                                   JAX_PLATFORMS="cpu"))
        assert out.returncode == 0, out.stderr[-2000:]
        outs.append(dict(line.split(" ", 1) for line in out.stdout.splitlines()
                         if line.startswith(("port ", "jax "))))
    assert outs[0]["port"] == outs[1]["port"]
    assert outs[0]["jax"] != outs[1]["jax"]
    token = "synthetic_train_5_0001"
    assert outs[0]["port"].split()[1] == str(pnusc.sample_seed(token, 1)) == str(
        (zlib.crc32(token.encode()) + 131071) % 2**31)
