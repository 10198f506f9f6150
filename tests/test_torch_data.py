"""The port's host data layer (bevfusion_tpu_torch/core/box_np.py and
bevfusion_tpu_torch/data/) against the JAX package's, bit for bit.

- the box and point containers, every geometric op;
- every pipeline step on the same seeded sample, the train-mode ones with
  the same explicit ``_rng``; the file loaders on files written here (PNG
  images, ``.bin`` / ``.npy`` points, sweeps, a painted point cloud);
- ``NuScenesDataset.__getitem__`` on a synthesized info pkl (six PNG
  cameras, nine sweeps; ``data/synthetic.py``) through the flagship
  config's test pipeline and through an augmenting pipeline, then
  ``collate``, ``format_results``' JSON, ``evaluate_map`` and
  ``CBGSDataset``'s indices;
- the loader: the same batches in the same order as the JAX loader on one
  shard; on 2 and 3 ranks every sample exactly once (the JAX loader's
  drop of the last samples of uneven shards is pinned); a worker's error
  reaches the consumer.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

import bevfusion_tpu.data as jdata
from bevfusion_tpu import native as jax_native
from bevfusion_tpu.core import box_np as jbox
from bevfusion_tpu.data import loader as jloader
from bevfusion_tpu.data import loading as jloading
from bevfusion_tpu.data import nuscenes as jnusc
from bevfusion_tpu.data import points as jpoints
from bevfusion_tpu.data import transforms as jtf
from bevfusion_tpu.registry import DATASETS as JAX_DATASETS
from bevfusion_tpu.registry import PIPELINES as JAX_PIPELINES
import bevfusion_tpu_torch.data as pdata
from bevfusion_tpu_torch.config import load_config
from bevfusion_tpu_torch.core import box_np as pbox
from bevfusion_tpu_torch.data import loader as ploader
from bevfusion_tpu_torch.data import loading as ploading
from bevfusion_tpu_torch.data import nuscenes as pnusc
from bevfusion_tpu_torch.data import points as ppoints
from bevfusion_tpu_torch.data import synthetic
from bevfusion_tpu_torch.data import transforms as ptf
from bevfusion_tpu_torch.registry import DATASETS, PIPELINES
from bevfusion_tpu_torch.runtime.flagship import FLAGSHIP_CONFIG
from tests import torch_port_helpers

torch.set_num_threads(2)


def same(a, b, what=""):
    """Equal dtype, shape and bytes (numpy arrays, containers of them, or
    anything else by ==)."""
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    elif hasattr(a, "tensor"):  # LiDARPoints / LiDARBoxes3D
        assert type(a).__name__ == type(b).__name__, what
        same(a.tensor, b.tensor, what)
    elif isinstance(a, (np.ndarray, np.generic)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), what
    elif isinstance(a, np.random.RandomState):
        same(a.get_state()[1], b.get_state()[1], what)
    else:
        assert a == b, (what, a, b)


def _boxes(rng, n=6):
    return np.concatenate([rng.uniform(-30, 30, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                           rng.uniform(0.5, 4, (n, 3)), rng.uniform(-4, 4, (n, 1)),
                           rng.uniform(-2, 2, (n, 2))], -1).astype(np.float32)


def _points(rng, n=400):
    return np.concatenate([rng.uniform(-40, 40, (n, 2)), rng.uniform(-4, 2, (n, 1)),
                           rng.rand(n, 2)], -1).astype(np.float32)


# ---------------------------------------------------------------- containers

BOX_OPS = {
    "gravity_center": lambda b: b.gravity_center,
    "bev": lambda b: b.bev,
    "corners": lambda b: b.corners(),
    "rotate": lambda b: (b.rotate(0.7), b.tensor),
    "translate": lambda b: (b.translate([1.5, -2.0, 0.25]), b.tensor),
    "scale": lambda b: (b.scale(1.07), b.tensor),
    "flip_h": lambda b: (b.flip("horizontal"), b.tensor),
    "flip_v": lambda b: (b.flip("vertical"), b.tensor),
    "in_range_bev": lambda b: b.in_range_bev([-20, -20, -5, 20, 20, 3]),
    "limit_yaw": lambda b: (b.limit_yaw(0.5, 2 * np.pi), b.tensor),
    "copy": lambda b: b.copy().tensor,
}


@pytest.mark.parametrize("op", sorted(BOX_OPS))
def test_boxes_match_jax(op):
    t = _boxes(np.random.RandomState(1), 8)
    got = BOX_OPS[op](pbox.LiDARBoxes3D(t.copy(), 9))
    want = BOX_OPS[op](jbox.LiDARBoxes3D(t.copy(), 9))
    same(got, want, op)


def test_box_functions_match_jax():
    rng = np.random.RandomState(2)
    t = _boxes(rng, 8)
    pts = _points(rng, 500)
    same(pbox.rotation_2d(0.3), jbox.rotation_2d(0.3))
    same(pbox.corners_bev(t[:, [0, 1, 3, 4, 6]]), jbox.corners_bev(t[:, [0, 1, 3, 4, 6]]))
    same(pbox.points_in_rbbox(pts, t[:, :7]), jbox.points_in_rbbox(pts, t[:, :7]))
    assert pbox.points_in_rbbox(pts, t[:, :7] * [1, 1, 1, 10, 10, 10, 1]).any()


POINT_OPS = {
    "coord": lambda p: p.coord,
    "getitem": lambda p: p[np.arange(len(p)) % 3 == 0].tensor,
    "rotate": lambda p: (p.rotate(-0.4), p.tensor),
    "translate": lambda p: (p.translate([0.5, 1.0, -0.1]), p.tensor),
    "scale": lambda p: (p.scale(0.93), p.tensor),
    "flip_h": lambda p: (p.flip("horizontal"), p.tensor),
    "flip_v": lambda p: (p.flip("vertical"), p.tensor),
    "shuffle": lambda p: (p.shuffle(np.random.RandomState(5)), p.tensor),
    "in_range_3d": lambda p: p.in_range_3d([-20, -20, -3, 20, 20, 1]),
    "in_range_bev": lambda p: p.in_range_bev([-20, -20, 20, 20]),
    "cat": lambda p: type(p).cat([p, p.copy()]).tensor,
}


@pytest.mark.parametrize("op", sorted(POINT_OPS))
def test_points_match_jax(op):
    t = _points(np.random.RandomState(3))
    same(POINT_OPS[op](ppoints.LiDARPoints(t.copy(), 5)),
         POINT_OPS[op](jpoints.LiDARPoints(t.copy(), 5)), op)


def test_registries_hold_the_jax_names():
    """Every pipeline step and dataset the JAX package registers (since the
    train entry point, ``ObjectPaste`` too: data/dbsampler.py)."""
    assert set(JAX_PIPELINES.keys()) - set(PIPELINES._registry) == set()
    assert set(PIPELINES._registry) <= set(JAX_PIPELINES.keys())
    assert set(DATASETS._registry) == set(JAX_DATASETS.keys())
    assert PIPELINES.get("GTDepth") is ptf.GTDepth
    assert PIPELINES.get("ObjectPaste").__module__ == "bevfusion_tpu_torch.data.dbsampler"
    # bevfusion_tpu/data/__init__.py's names
    for name in ("dbsampler", "loading", "transforms", "DataLoader", "collate", "CBGSDataset",
                 "NuScenesDataset", "build_dataset", "LiDARPoints"):
        assert hasattr(jdata, name) and hasattr(pdata, name), name


# ---------------------------------------------------------------- transforms

def _sample(pkg, seed=0, P=600, N=2, H=64, W=128):
    """A seeded pipeline state for ``pkg`` (the port's or the JAX data
    modules), its ``_rng`` given explicitly."""
    pts_mod, box_mod = pkg
    rng = np.random.RandomState(seed)
    intr = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    intr[:, 0, 0] = intr[:, 1, 1] = 80.0
    intr[:, 0, 2], intr[:, 1, 2] = W / 2, H / 2
    return {
        "img": [rng.rand(H, W, 3).astype(np.float32) * 255 for _ in range(N)],
        "points": pts_mod.LiDARPoints(_points(rng, P), 5),
        "gt_bboxes_3d": box_mod.LiDARBoxes3D(_boxes(rng, 7), 9),
        "gt_labels_3d": np.array([0, 3, 9, -1, 4, 12, 2]),
        "gt_masks_bev": (rng.rand(3, 20, 20) < 0.4).astype(np.float32),
        "lidar2image": intr, "img_aug_matrix": np.tile(np.eye(4, dtype=np.float32), (N, 1, 1)),
        "lidar_aug_matrix": np.eye(4, dtype=np.float32),
        "camera_intrinsics": intr.copy(), "metas": {"token": "t0"},
        "_rng": np.random.RandomState(seed + 1),
    }


PORT, JAX = (ppoints, pbox), (jpoints, jbox)
AUG = dict(final_dim=(32, 64), resize_lim=(0.4, 0.6), bot_pct_lim=(0.0, 0.2),
           rot_lim=(-5.4, 5.4), rand_flip=True)
PCR = [-30.0, -30.0, -3.0, 30.0, 30.0, 1.0]
# each step as (name, kwargs); several run more than once or one after another
STEPS = {
    "image_aug_train": [("ImageAug3D", dict(AUG, is_train=True))],
    "image_aug_test": [("ImageAug3D", dict(AUG, resize_lim=(0.48, 0.48), is_train=False))],
    "rot_scale_trans_train": [("GlobalRotScaleTrans", dict(
        resize_lim=(0.9, 1.1), rot_lim=(-0.78, 0.78), trans_lim=0.5, is_train=True))],
    "rot_scale_trans_test": [("GlobalRotScaleTrans", dict(
        resize_lim=(1.0, 1.0), rot_lim=(0.0, 0.0), trans_lim=0.0, is_train=False))],
    "random_flip": [("RandomFlip3D", {})] * 4,
    "points_range_filter": [("PointsRangeFilter", dict(point_cloud_range=PCR))],
    "object_range_filter": [("ObjectRangeFilter", dict(point_cloud_range=PCR))],
    "object_name_filter": [("ObjectNameFilter", dict(classes=list("abcdefghij")))],
    "point_shuffle": [("PointShuffle", {})],
    "image_normalize": [("ImageNormalize", dict(mean=[0.485, 0.456, 0.406],
                                                std=[0.229, 0.224, 0.225]))],
    "grid_mask": [("GridMask", dict(use_h=True, use_w=True, max_epoch=6, prob=1.0,
                                    fixed_prob=True))] * 2,
    "gt_depth": [("ImageAug3D", dict(AUG, is_train=True)), ("GTDepth", dict(keyframe_only=True))],
    "pad_batch": [("PadBatch", dict(max_points=800, max_gt_boxes=10))],
    "pad_batch_truncates": [("PadBatch", dict(max_points=100, max_gt_boxes=3))],
    "collect": [("ObjectRangeFilter", dict(point_cloud_range=PCR)),
                ("GTDepth", {}), ("PadBatch", dict(max_points=800, max_gt_boxes=10)),
                ("Collect3D", dict(keys=["img", "points", "gt_bboxes_3d"],
                                   meta_keys=["camera_intrinsics", "lidar2image",
                                              "img_aug_matrix", "lidar_aug_matrix"]))],
    "train_chain": [("ImageAug3D", dict(AUG, is_train=True)),
                    ("GlobalRotScaleTrans", dict(resize_lim=(0.9, 1.1), rot_lim=(-0.78, 0.78),
                                                 trans_lim=0.5, is_train=True)),
                    ("RandomFlip3D", {}), ("PointsRangeFilter", dict(point_cloud_range=PCR)),
                    ("ObjectRangeFilter", dict(point_cloud_range=PCR)),
                    ("ObjectNameFilter", dict(classes=list("abcdefghij"))),
                    ("ImageNormalize", dict(mean=[0.5] * 3, std=[0.25] * 3)),
                    ("PointShuffle", {}), ("GTDepth", dict(keyframe_only=True)),
                    ("PadBatch", dict(max_points=700, max_gt_boxes=8))],
}


def _run(steps, module, registry, pkg, seed):
    data = _sample(pkg, seed)
    for name, kw in steps:
        step = registry.get(name)(**kw)
        assert type(step).__module__ == module.__name__
        data = step(data)
    return data


@pytest.mark.parametrize("name", sorted(STEPS))
@pytest.mark.parametrize("seed", [0, 7])
def test_transform_matches_jax(name, seed):
    got = _run(STEPS[name], ptf, PIPELINES, PORT, seed)
    want = _run(STEPS[name], jtf, JAX_PIPELINES, JAX, seed)
    same(got, want, name)


def test_grid_mask_epoch_ramp_matches_jax():
    masks = []
    for tf, pkg in ((ptf, PORT), (jtf, JAX)):
        gm = tf.GridMask(use_h=True, use_w=False, max_epoch=4, prob=0.9, mode=0)
        out = []
        for epoch in range(4):
            gm.set_epoch(epoch)
            out.append((gm.prob, gm(_sample(pkg, seed=epoch))["img"]))
        masks.append(out)
    same(masks[0], masks[1])


@pytest.mark.parametrize("deg", [0.0, 3.7, -12.0])
def test_image_helpers_match_jax(deg):
    img = np.random.RandomState(4).rand(45, 80, 3).astype(np.float32)
    same(ptf._bilinear_resize_hwc(img, (31, 97)), jtf._bilinear_resize_hwc(img, (31, 97)))
    same(ptf._rotate_image_hwc(img, deg), jtf._rotate_image_hwc(img, deg))


# ---------------------------------------------------------------- loaders

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A PNG, a keyframe and three sweeps as .bin, the keyframe as .npy too,
    and a painted (PointPainting / MVP) point cloud beside it."""
    from PIL import Image

    root = tmp_path_factory.mktemp("files")
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (36, 60, 3)).astype(np.uint8)
    Image.fromarray(img).save(root / "cam.png")
    os.makedirs(root / "samples" / "LIDAR_TOP")
    pts = _points(rng, 700)
    pts[:10, :2] = rng.uniform(-0.9, 0.9, (10, 2))  # close points for remove_close
    lidar = str(root / "samples" / "LIDAR_TOP" / "key.bin")
    pts.tofile(lidar)
    np.save(root / "key.npy", pts)
    sweeps = []
    for j in range(3):
        path = str(root / f"sweep{j}.bin")
        _points(rng, 300 + 50 * j).tofile(path)
        a = 0.01 * (j + 1)
        sweeps.append({"data_path": path, "timestamp": 1_000_000 - 50_000 * (j + 1),
                       "sensor2lidar_rotation": np.array([[np.cos(a), -np.sin(a), 0.01],
                                                          [np.sin(a), np.cos(a), 0.0],
                                                          [-0.01, 0.0, 1.0]]),
                       "sensor2lidar_translation": np.array([-0.2 * (j + 1), 0.05, 0.01])})
    vdir = root / "virtual_points" / "samples" / "LIDAR_TOP_VIRTUAL"
    os.makedirs(vdir)
    np.save(vdir / "key.bin.pkl.npy", {
        "real_points": rng.rand(50, 15).astype(np.float32),
        "virtual_points": rng.rand(30, 14).astype(np.float32),
        "real_points_indice": rng.choice(700, 50, replace=False)}, allow_pickle=True)
    return {"root": root, "png": str(root / "cam.png"), "img": img, "lidar": lidar,
            "npy": str(root / "key.npy"), "sweeps": sweeps}


def _state(files, **extra):
    return dict({"image_paths": [files["png"]] * 2, "lidar_path": files["lidar"],
                 "timestamp": 1_000_000, "sweeps": files["sweeps"],
                 "ann_info": {"gt_bboxes_3d": _boxes(np.random.RandomState(8), 4)[:, :7],
                              "gt_labels_3d": np.array([1, 2, 3, 4])}}, **extra)


LOAD_STEPS = {
    "images": [("LoadMultiViewImageFromFiles", {})],
    "images_float": [("LoadMultiViewImageFromFiles", dict(to_float32=True))],
    "points": [("LoadPointsFromFile", dict(load_dim=5, use_dim=5))],
    "points_use_dim": [("LoadPointsFromFile", dict(load_dim=5, use_dim=[0, 1, 2, 4]))],
    "points_16_beams": [("LoadPointsFromFile", dict(reduce_beams=16))],
    "points_4_beams": [("LoadPointsFromFile", dict(reduce_beams=4))],
    "points_painted": [("LoadPointsFromFile", dict(load_augmented="pointpainting"))],
    "points_mvp": [("LoadPointsFromFile", dict(load_augmented="mvp"))],
    "sweeps": [("LoadPointsFromFile", {}), ("LoadPointsFromMultiSweeps", dict(
        sweeps_num=9, use_dim=5, remove_close=True, pad_empty_sweeps=True))],
    "sweeps_drawn": [("LoadPointsFromFile", dict(use_dim=4)), ("LoadPointsFromMultiSweeps", dict(
        sweeps_num=2, use_dim=4))],
    "sweeps_test_mode": [("LoadPointsFromFile", {}), ("LoadPointsFromMultiSweeps", dict(
        sweeps_num=2, use_dim=5, test_mode=True, reduce_beams=16))],
    "annotations": [("LoadAnnotations3D", {})],
    "bev_segmentation": [("LoadBEVSegmentation", dict(
        dataset_root="", xbound=[-50, 50, 0.5], ybound=[-50, 50, 0.5],
        classes=["drivable_area", "divider"]))],
}


@pytest.mark.parametrize("name", sorted(LOAD_STEPS))
def test_loader_step_matches_jax(files, name):
    outs = []
    for registry, module in ((PIPELINES, ploading), (JAX_PIPELINES, jloading)):
        data = _state(files, _rng=np.random.RandomState(3))
        for step, kw in LOAD_STEPS[name]:
            t = registry.get(step)(**kw)
            assert type(t).__module__ == module.__name__
            data = t(data)
        outs.append(data)
    same(outs[0], outs[1], name)
    if name == "images":
        same(outs[0]["img"][0], files["img"])  # the PNG's own bytes
    if name == "bev_segmentation":  # no map location: zero masks on the 200 x 200 canvas
        assert outs[0]["gt_masks_bev"].shape == (2, 200, 200) and not outs[0]["gt_masks_bev"].any()


def test_point_file_forms_and_beam_reduction_match_jax(files):
    same(ploading._load_points_bin(files["npy"], 5), jloading._load_points_bin(files["npy"], 5))
    same(ploading._load_points_bin(files["npy"], 5), ploading._load_points_bin(files["lidar"], 5))
    pts = _points(np.random.RandomState(9), 3000) * [1, 1, 3, 1, 1]
    for beams in (32, 16, 4, 1):
        same(ploading.reduce_lidar_beams(pts, beams), jloading.reduce_lidar_beams(pts, beams))


def test_sweep_transform_equals_the_native_loop(files):
    """The port's numpy sweep transform against the JAX package's C++ loop
    (built with g++ on first use), bit for bit."""
    assert jax_native.available(), "the JAX package's native host library did not build"
    rng = np.random.RandomState(10)
    for dim in (4, 5, 6):
        pts = rng.uniform(-60, 60, (5000, dim)).astype(np.float32)
        rot = synthetic._rotation(rng.normal(0, 0.3, 3))
        trans = rng.normal(0, 2, 3)
        same(ploading._transform_sweep_points(pts, rot, trans, 0.15),
             jax_native.transform_sweep_points(pts, rot, trans, 0.15))


# ---------------------------------------------------------------- the dataset

@functools.lru_cache(maxsize=None)
def _synthetic_set(root):
    return synthetic.write_synthetic_nuscenes(
        root, num_samples=3, image_hw=(90, 160), points_per_sweep=700, num_sweeps=9, num_gt=5,
        seed=2)


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    _synthetic_set(root)
    return root


def _datasets(root, pipeline=None, **kw):
    """The flagship config's test dataset (or ``pipeline``) over the
    synthesized set, built by each package."""
    cfg = load_config(FLAGSHIP_CONFIG, overrides={"dataset_root": root + "/", "max_points": 8000})
    test = dict(cfg.data.test, **kw)
    if pipeline is not None:
        test["pipeline"] = pipeline
    return pnusc.build_dataset(test), jnusc.build_dataset(test)


def test_dataset_items_match_jax(nusc_root):
    ps, js = _datasets(nusc_root)
    assert type(ps) is pnusc.NuScenesDataset and len(ps) == len(js) == 3
    for i in range(3):
        got, want = ps[i], js[i]
        same(got, want, f"sample {i}")
        assert got["img"].shape == (6, 256, 704, 3)
        assert 9 * 700 < got["points_mask"].sum() <= 10 * 700  # keyframe + 9 sweeps, in range
    for i in range(3):
        same(ps.get_data_info(i), js.get_data_info(i), f"info {i}")
        same(ps.get_ann_info(i), js.get_ann_info(i), f"ann {i}")
        same(ps.get_cat_ids(i), js.get_cat_ids(i), f"cats {i}")


def test_dataset_with_augmentation_matches_jax(nusc_root, monkeypatch):
    """A training-style pipeline: each sample's RNG is seeded from its
    token and the epoch. The port takes the token's CRC-32
    (``sample_seed``), the JAX package its ``hash``, which changes from
    process to process; the JAX dataset here is fed the port's seed (its
    ``hash`` replaced by ``zlib.crc32``), so the two agree transform for
    transform."""
    import zlib

    monkeypatch.setattr(jnusc, "hash", lambda token: zlib.crc32(token.encode()), raising=False)
    cfg = load_config(FLAGSHIP_CONFIG, overrides={"dataset_root": nusc_root + "/"})
    pipeline = [s for s in cfg.train_pipeline if s["type"] not in ("ObjectPaste",
                                                                    "LoadBEVSegmentation")]
    for s in pipeline:
        if s["type"] == "PadBatch":
            s["max_points"] = 8000
        if s["type"] == "GridMask":
            s["prob"], s["max_epoch"] = 0.7, 6
    ps, js = _datasets(nusc_root, pipeline, test_mode=False)
    for epoch in (0, 2):
        ps.set_epoch(epoch)
        js.set_epoch(epoch)
        for i in range(2):
            same(ps[i], js[i], f"epoch {epoch} sample {i}")


def test_collate_format_results_and_map_match_jax(nusc_root, tmp_path):
    ps, js = _datasets(nusc_root)
    samples = [ps[i] for i in range(3)]
    for s in samples:
        s["metas"] = {"token": "x"}
    same(ploader.collate(samples), jloader.collate(samples))
    same(ploader.collate([dict(s, pool_lut={"a": np.ones((1, 3))}) for s in samples]),
         jloader.collate([dict(s, pool_lut={"a": np.ones((1, 3))}) for s in samples]))

    rng = np.random.RandomState(11)
    results = [{"boxes_3d": _boxes(rng, 5), "scores_3d": rng.rand(5).astype(np.float32),
                "labels_3d": rng.randint(0, 10, 5),
                "masks_bev": rng.rand(6, 200, 200).astype(np.float32),
                "gt_masks_bev": rng.rand(6, 200, 200) < 0.3} for _ in range(3)]
    paths = [str(tmp_path / name / "results_nusc.json") for name in ("port", "jax")]
    same(ps.format_results(results, paths[0]), js.format_results(results, paths[1]))
    texts = [open(p).read() for p in paths]
    assert texts[0] == texts[1]
    assert set(json.loads(texts[0])["results"]) == {f"synthetic_2_{i:04d}" for i in range(3)}
    got, want = ps.evaluate_map(results), js.evaluate_map(results)
    assert got == want and set(got) == {f"map/{c}/iou@max" for c in ps.map_classes} | {
        "map/mean/iou@max"}


def test_cbgs_indices_match_jax(nusc_root):
    cfg = load_config(FLAGSHIP_CONFIG, overrides={"dataset_root": nusc_root + "/"})
    train = dict(cfg.data.train)
    train["dataset"] = dict(train["dataset"], ann_file=cfg.data.test.ann_file,
                            pipeline=cfg.test_pipeline)
    got, want = pnusc.build_dataset(train), jnusc.build_dataset(train)
    assert type(got) is pnusc.CBGSDataset
    assert got.sample_indices == want.sample_indices and len(got) > 3


def test_quaternions_and_rig_match(nusc_root):
    rng = np.random.RandomState(12)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        same(pnusc.quaternion_to_matrix(q), jnusc.quaternion_to_matrix(q))
        R = pnusc.quaternion_to_matrix(q).astype(np.float64)
        back = synthetic.matrix_to_quaternion(R)
        np.testing.assert_allclose(back * np.sign(q[0]), q, atol=1e-6)
    ring = synthetic.camera_ring(6, (900, 1600))
    ring.update(camera2ego=ring["camera2lidar"], lidar2camera=ring["camera2lidar"],
                lidar2image=ring["camera2lidar"])
    same(synthetic.jittered_rig(ring, 5), torch_port_helpers.jittered_rig(ring, 5))
    assert np.allclose(np.linalg.det(ring["camera2lidar"][0, :, :3, :3]), 1.0, atol=1e-6)


# ---------------------------------------------------------------- the loader

class _Indexed:
    """Sample i is {"img": [[i]]}; an index in ``fail`` raises."""

    def __init__(self, n, fail=()):
        self.n, self.fail = n, set(fail)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i in self.fail:
            raise ValueError(f"sample {i} is broken")
        return {"img": np.full((1, 1), i, np.float32), "metas": {"i": i}}


def _ids(loader):
    return [int(v) for batch in loader for v in batch["img"].reshape(-1)]


@pytest.mark.parametrize("shuffle,drop_last,bs", [(False, False, 1), (True, False, 2),
                                                  (True, True, 3)])
def test_loader_matches_jax_on_one_shard(nusc_root, shuffle, drop_last, bs):
    ds = _Indexed(11)
    for epoch in (0, 1):
        got = ploader.DataLoader(ds, bs, shuffle, num_workers=3, seed=4, drop_last=drop_last)
        want = jloader.DataLoader(ds, bs, shuffle, num_workers=3, seed=4, drop_last=drop_last)
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert len(got) == len(want)
        same(list(got), list(want))
    ps, js = _datasets(nusc_root)
    same(list(ploader.DataLoader(ps, 2, drop_last=False)),
         list(jloader.DataLoader(js, 2, drop_last=False)))


@pytest.mark.parametrize("world,n", [(2, 3), (2, 8), (3, 7), (3, 11)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_sharded_loader_yields_every_sample_once(world, n, shuffle):
    ds = _Indexed(n)
    ids = []
    for rank in range(world):
        loader = ploader.DataLoader(ds, 1, shuffle, num_workers=2, drop_last=False,
                                    num_shards=world, shard_id=rank)
        got = _ids(loader)
        assert len(loader) == len(got)
        ids += got
    assert sorted(ids) == list(range(n))


def test_jax_loader_drops_the_last_samples_of_uneven_shards():
    """The fault the port repairs, pinned: the JAX loader gives every shard
    ``len(dataset) // num_shards`` samples, so with 3 samples on 2 ranks
    sample 2 is never loaded (on nuScenes val, 6,019 samples on 8 ranks,
    3 samples)."""
    ds = _Indexed(3)
    per_rank = [_ids(jloader.DataLoader(ds, 1, num_workers=1, drop_last=False, num_shards=2,
                                        shard_id=r)) for r in range(2)]
    assert per_rank == [[0], [1]]
    assert len(jloader.DataLoader(_Indexed(6019), 1, drop_last=False, num_shards=8)) * 8 == 6016


def test_loader_raises_a_workers_error():
    loader = ploader.DataLoader(_Indexed(6, fail={4}), 1, num_workers=2, drop_last=False)
    with pytest.raises(ValueError, match="sample 4 is broken"):
        list(loader)
