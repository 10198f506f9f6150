"""Shared helpers of the tests that hold the PyTorch port to the JAX package."""
import jax
import numpy as np

from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu.registry import PIPELINES as JAX_PIPELINES
from bevfusion_tpu_torch.data import synthetic
from bevfusion_tpu_torch.registry import PIPELINES
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from tests.test_bevfusion_model import make_batch, tiny_fused_config


def random_variables(init, *args, seed=0):
    """Seeded random numpy variables with the structure ``init(key, *args)``
    gives (traced with ``jax.eval_shape``, nothing compiled): He-normal
    kernels, small biases, and BatchNorm / LayerNorm affines and running
    statistics that make every eval normalisation do real work."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)

    def one(path, s):
        name = path[-1].key
        if name in ("kernel", "weight"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return rng.normal(1.0, 0.1, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, s.shape).astype(np.float32)  # bias, mean

    return {col: jax.tree_util.tree_map_with_path(one, tree) for col, tree in shapes.items()}


def load_bridged(module, variables, flax_name, torch_prefix):
    """Carry a standalone flax module's variables into the port's module
    through the bridge (the module sits under ``flax_name`` in the fused
    model, ``torch_prefix`` in the checkpoint); strict."""
    wrapped = {col: {flax_name: tree} for col, tree in variables.items()}
    sd = jax_to_torch_state_dict(wrapped)
    assert all(k.startswith(torch_prefix) for k in sd), sorted(sd)[:3]
    module.load_state_dict({k[len(torch_prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def rel_err(got, want):
    """max|got - want| / max(max|want|, 1)."""
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0))


def tiny_lidar_model(seed=11):
    """The tiny LiDAR-only detector of tests/test_bevfusion_model.py: (config,
    JAX model, points batch, random variables). The heatmap logits are kept
    moderate so the sigmoid is not saturated and ranked scores stay apart."""
    cfg = tiny_fused_config(with_camera=False)
    jm = jax_build_model(cfg)
    batch = {k: v for k, v in make_batch().items() if k in ("points", "points_mask")}
    variables = random_variables(jm.init, batch, seed=seed)
    variables["params"]["head_modules_object"]["heatmap_conv1"]["conv"]["kernel"] *= 0.2
    return cfg, jm, batch, variables


def _rotation(axis_angle):
    """Rodrigues: axis-angle [3] -> rotation [3, 3] (float64)."""
    theta = np.linalg.norm(axis_angle)
    k = axis_angle / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K


def jittered_rig(mats, seed, rot_std=0.02, trans_std=0.05):
    """``mats`` (numpy camera matrices under the batch's key names) with
    every camera2lidar moved by a small seeded rotation and translation,
    and lidar2camera / lidar2image / camera2ego made consistent with it.
    An axis-aligned rig puts frustum points exactly on cell boundaries,
    where two fp32 routes may quantize to adjacent cells; a jittered one
    does not."""
    rng = np.random.RandomState(seed)
    c2l = np.array(mats["camera2lidar"], np.float64)
    B, N = c2l.shape[:2]
    for b in range(B):
        for n in range(N):
            c2l[b, n, :3, :3] = _rotation(rng.normal(0, rot_std, 3)) @ c2l[b, n, :3, :3]
            c2l[b, n, :3, 3] += rng.normal(0, trans_std, 3)
    l2c = np.linalg.inv(c2l)
    intr = np.array(mats["camera_intrinsics"], np.float64)
    out = dict(mats)
    out.update(camera2lidar=c2l.astype(np.float32), camera2ego=c2l.astype(np.float32),
               lidar2camera=l2c.astype(np.float32),
               lidar2image=np.einsum("bnij,bnjk->bnik", intr, l2c).astype(np.float32))
    return out


def boundary_margin(frustum, dx, bx, nx, mats):
    """Smallest distance (m), over the frustum points in or next to the
    grid, from a point to a cell boundary plane, with the geometry in
    float64: a margin well above fp32 rounding means every fp32 route
    assigns every point the same cell."""
    f8 = np.float64
    img_aug = np.asarray(mats["img_aug_matrix"], f8)
    c2l = np.asarray(mats["camera2lidar"], f8)
    intr = np.asarray(mats["camera_intrinsics"], f8)[..., :3, :3]
    la = np.asarray(mats["lidar_aug_matrix"], f8)
    pts = np.asarray(frustum, f8)[None, None] - img_aug[:, :, None, None, None, :3, 3]
    pts = np.einsum("bnij,bndhwj->bndhwi", np.linalg.inv(img_aug[..., :3, :3]), pts)
    pts = np.concatenate([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], -1)
    pts = np.einsum("bnij,bndhwj->bndhwi", c2l[..., :3, :3] @ np.linalg.inv(intr), pts)
    pts = pts + c2l[:, :, None, None, None, :3, 3]
    pts = np.einsum("bij,bndhwj->bndhwi", la[:, :3, :3], pts) + la[:, None, None, None, None, :3, 3]
    q = (pts - (np.asarray(bx, f8) - np.asarray(dx, f8) / 2)) / np.asarray(dx, f8)
    near = ((q >= -1) & (q <= np.asarray(nx, f8) + 1)).all(-1)
    return float((np.abs(q - np.round(q)) * np.asarray(dx, f8))[near].min())


# ---------------------------------------------------------------- the tiny models from files
# (tests/test_torch_eval.py, tests/test_torch_train_cli*.py; registered here, in a module
# that pytest never collects, so it is imported once per process)

EVAL_RIG_SEED = 1  # a jitter whose frustum points all keep >= 1e-4 m from cell boundaries
PCR = [-16.0, -16.0, -4.0, 16.0, 16.0, 4.0]
MAP_CLASSES = ["drivable_area", "divider"]
MATS = ["camera_intrinsics", "camera2ego", "lidar2ego", "lidar2camera", "camera2lidar",
        "lidar2image", "img_aug_matrix", "lidar_aug_matrix"]


class PointMasksBEV:
    """Test-only map targets on the tiny map head's 16 x 16 grid of 1 m:
    class 0 where a point falls, class 1 where a box centre does."""

    def __call__(self, data):
        masks = np.zeros((2, 16, 16), np.float32)
        for k, xy in enumerate((data["points"].tensor[:, :2], data["gt_bboxes_3d"].tensor[:, :2])):
            ij = np.floor(xy + 8).astype(int)
            ok = ((ij >= 0) & (ij < 16)).all(1)
            masks[k, ij[ok, 0], ij[ok, 1]] = 1.0
        data["gt_masks_bev"] = masks
        return data


PIPELINES.register(PointMasksBEV)
JAX_PIPELINES.register()(PointMasksBEV)


def tiny_config(head):
    """The tiny fused model with ``head`` and a test pipeline at its sizes
    (the nuScenes pipeline's steps), the dataset under ``dataset_root``."""
    return {
        "dataset_root": "data/nuscenes/", "point_cloud_range": PCR,
        "model": tiny_fused_config(head=head),
        "test_pipeline": [
            {"type": "LoadMultiViewImageFromFiles", "to_float32": True},
            {"type": "LoadPointsFromFile", "coord_type": "LIDAR", "load_dim": 5, "use_dim": 5},
            {"type": "LoadPointsFromMultiSweeps", "sweeps_num": 9, "load_dim": 5, "use_dim": 5,
             "pad_empty_sweeps": True, "remove_close": True},
            {"type": "LoadAnnotations3D", "with_bbox_3d": True, "with_label_3d": True},
            {"type": "ImageAug3D", "final_dim": [32, 64], "resize_lim": [0.5, 0.5],
             "bot_pct_lim": [0.0, 0.0], "rot_lim": [0.0, 0.0], "rand_flip": False,
             "is_train": False},
            {"type": "GlobalRotScaleTrans", "resize_lim": [1.0, 1.0], "rot_lim": [0.0, 0.0],
             "trans_lim": 0.0, "is_train": False},
            {"type": "LoadBEVSegmentation", "dataset_root": "${dataset_root}",
             "xbound": [-8.0, 8.0, 1.0], "ybound": [-8.0, 8.0, 1.0], "classes": MAP_CLASSES},
            {"type": "PointsRangeFilter", "point_cloud_range": "${point_cloud_range}"},
            {"type": "PointMasksBEV"},
            {"type": "ImageNormalize", "mean": [0.485, 0.456, 0.406],
             "std": [0.229, 0.224, 0.225]},
            {"type": "PadBatch", "max_points": 512, "max_gt_boxes": 8},
            {"type": "Collect3D", "keys": ["img", "points", "gt_bboxes_3d", "gt_labels_3d",
                                           "gt_masks_bev"], "meta_keys": MATS}],
        "data": {"test": {
            "type": "NuScenesDataset", "dataset_root": "${dataset_root}",
            "ann_file": "${dataset_root + 'nuscenes_infos_val.pkl'}",
            "pipeline": "${test_pipeline}",
            "object_classes": list(synthetic.CLASSES), "map_classes": MAP_CLASSES,
            "modality": {"use_camera": True, "use_lidar": True}, "test_mode": True}},
    }
