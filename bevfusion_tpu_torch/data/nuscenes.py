"""NuScenesDataset + CBGS wrapper (host side, numpy).

A copy of ``bevfusion_tpu/data/nuscenes.py``, held to it by
tests/test_torch_data.py. Behavioral reference:
mmdet3d/datasets/nuscenes_dataset.py (info-pkl loading :193-208,
calibration matrix construction :209-286, CBGS cat ids :169-191,
detection eval via nuScenes devkit :410-466, map IoU sweep :498-531) and
dataset_wrappers.py:7-76 (class-balanced resampling).

One fault repaired: the JAX package seeds a sample's pipeline RNG with
``hash(token)``, which ``PYTHONHASHSEED`` changes from process to
process, so a run resumed in a new process draws other augmentations
than the run it continues. Here the seed is ``sample_seed(token, epoch)``,
a CRC-32 of the token: the same in every process. The test pipeline draws
nothing from it.
"""
from __future__ import annotations

import os
import pickle
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from ..registry import DATASETS, PIPELINES

__all__ = ["NuScenesDataset", "CBGSDataset", "build_dataset", "quaternion_to_matrix",
           "sample_seed"]


def sample_seed(token: str, epoch: int) -> int:
    """The pipeline RNG's seed for the sample ``token`` in ``epoch``: the
    JAX package's ``(hash(token) + epoch * 131071) % 2**31`` with the
    token's CRC-32 for ``hash``, so it does not change between processes."""
    return (zlib.crc32(token.encode()) + max(epoch, 0) * 131071) % (2**31)


def quaternion_to_matrix(q) -> np.ndarray:
    """(w, x, y, z) -> 3x3 rotation (replaces pyquaternion)."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ],
        np.float32,
    )


def build_pipeline(steps) -> List[Any]:
    return [PIPELINES.build(dict(s)) for s in steps]


@DATASETS.register
class NuScenesDataset:
    """Reads the converter's nuscenes_infos_{train,val}.pkl and yields
    numpy sample dicts through the pipeline."""

    DefaultAttribute = {
        "car": "vehicle.parked",
        "pedestrian": "pedestrian.moving",
        "trailer": "vehicle.parked",
        "truck": "vehicle.parked",
        "bus": "vehicle.moving",
        "motorcycle": "cycle.without_rider",
        "construction_vehicle": "vehicle.parked",
        "bicycle": "cycle.without_rider",
        "barrier": "",
        "traffic_cone": "",
    }

    def __init__(
        self,
        dataset_root: str,
        ann_file: str,
        pipeline,
        object_classes,
        map_classes=None,
        modality=None,
        test_mode: bool = False,
        use_valid_flag: bool = False,
        box_type_3d: str = "LiDAR",
        load_interval: int = 1,
        dataset=None,  # tolerated for wrapper-style configs
        **kwargs,
    ):
        self.dataset_root = dataset_root
        self.object_classes = list(object_classes)
        self.map_classes = list(map_classes or [])
        self.modality = modality or {"use_camera": True, "use_lidar": True}
        self.test_mode = test_mode
        self.use_valid_flag = use_valid_flag
        self.load_interval = load_interval
        self.epoch = -1

        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        self.data_infos = sorted(data["infos"], key=lambda e: e["timestamp"])
        self.data_infos = self.data_infos[:: self.load_interval]
        self.metadata = data.get("metadata", {})
        self.version = self.metadata.get("version", "v1.0-trainval")

        self.pipeline = build_pipeline(pipeline)

    def __len__(self):
        return len(self.data_infos)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        for t in self.pipeline:
            if hasattr(t, "set_epoch"):
                t.set_epoch(epoch)

    # -- info -> sample dict -------------------------------------------

    def get_cat_ids(self, idx: int) -> List[int]:
        """Category ids present in a sample (CBGS support,
        nuscenes_dataset.py:169-191)."""
        info = self.data_infos[idx]
        if self.use_valid_flag:
            mask = info["valid_flag"]
            names = set(np.asarray(info["gt_names"])[mask])
        else:
            names = set(info["gt_names"])
        return [self.object_classes.index(n) for n in names if n in self.object_classes]

    def get_ann_info(self, idx: int) -> Dict[str, Any]:
        info = self.data_infos[idx]
        if self.use_valid_flag:
            mask = np.asarray(info["valid_flag"], bool)
        else:
            mask = np.asarray(info["num_lidar_pts"]) > 0
        boxes = np.asarray(info["gt_boxes"], np.float32)[mask]
        names = np.asarray(info["gt_names"])[mask]
        if "gt_velocity" in info:
            vel = np.asarray(info["gt_velocity"], np.float32)[mask]
            vel = np.nan_to_num(vel)
            boxes = np.concatenate([boxes, vel], axis=-1)
        labels = np.array(
            [self.object_classes.index(n) if n in self.object_classes else -1
             for n in names],
            np.int64,
        )
        return {"gt_bboxes_3d": boxes, "gt_labels_3d": labels, "gt_names": names}

    def get_data_info(self, idx: int) -> Dict[str, Any]:
        info = self.data_infos[idx]
        data: Dict[str, Any] = {
            "token": info["token"],
            "lidar_path": info["lidar_path"],
            "sweeps": info["sweeps"],
            "timestamp": info["timestamp"],
        }
        if "location" in info:
            data["location"] = info["location"]

        ego2global = np.eye(4, dtype=np.float32)
        ego2global[:3, :3] = quaternion_to_matrix(info["ego2global_rotation"])
        ego2global[:3, 3] = info["ego2global_translation"]
        data["ego2global"] = ego2global

        lidar2ego = np.eye(4, dtype=np.float32)
        lidar2ego[:3, :3] = quaternion_to_matrix(info["lidar2ego_rotation"])
        lidar2ego[:3, 3] = info["lidar2ego_translation"]
        data["lidar2ego"] = lidar2ego

        if self.modality.get("use_camera"):
            paths, l2c, l2i, c2e, intr, c2l = [], [], [], [], [], []
            for _, cam in info["cams"].items():
                paths.append(cam["data_path"])
                s2l_r = np.asarray(cam["sensor2lidar_rotation"], np.float64)
                s2l_t = np.asarray(cam["sensor2lidar_translation"], np.float64)
                lidar2cam = np.eye(4, dtype=np.float32)
                lidar2cam[:3, :3] = np.linalg.inv(s2l_r)
                lidar2cam[:3, 3] = -(np.linalg.inv(s2l_r) @ s2l_t)
                l2c.append(lidar2cam)
                ci = np.eye(4, dtype=np.float32)
                ci[:3, :3] = cam["cam_intrinsic"]
                intr.append(ci)
                l2i.append((ci @ lidar2cam).astype(np.float32))
                ce = np.eye(4, dtype=np.float32)
                ce[:3, :3] = quaternion_to_matrix(cam["sensor2ego_rotation"])
                ce[:3, 3] = cam["sensor2ego_translation"]
                c2e.append(ce)
                cl = np.eye(4, dtype=np.float32)
                cl[:3, :3] = s2l_r
                cl[:3, 3] = s2l_t
                c2l.append(cl)
            data["image_paths"] = paths
            data["lidar2camera"] = np.stack(l2c)
            data["lidar2image"] = np.stack(l2i)
            data["camera2ego"] = np.stack(c2e)
            data["camera_intrinsics"] = np.stack(intr)
            data["camera2lidar"] = np.stack(c2l)

        data["ann_info"] = self.get_ann_info(idx)
        return data

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        """prepare_train_data semantics incl. the retry-on-empty-GT loop
        (custom_3d.py:284-297): training samples without GT are skipped."""
        for _ in range(len(self)):
            sample = self._get_single(idx)
            if self.test_mode or sample.get("gt_valid") is None or \
                    bool(np.asarray(sample["gt_valid"]).any()):
                return sample
            idx = (idx + 1) % len(self)
        return sample

    def _get_single(self, idx: int) -> Dict[str, Any]:
        data = self.get_data_info(idx)
        data["img_aug_matrix"] = np.tile(
            np.eye(4, dtype=np.float32),
            (len(data.get("image_paths", [1])), 1, 1),
        )
        data["lidar_aug_matrix"] = np.eye(4, dtype=np.float32)
        data["_rng"] = np.random.RandomState(sample_seed(data["token"], self.epoch))
        for t in self.pipeline:
            data = t(data)
        data.pop("_rng", None)
        return data

    # -- evaluation -----------------------------------------------------

    def evaluate_map(self, results) -> Dict[str, float]:
        """Multi-threshold IoU sweep over [0.35..0.65]
        (nuscenes_dataset.py:498-531)."""
        thresholds = np.linspace(0.35, 0.65, 7)  # 0.05 steps
        num_classes = len(self.map_classes)
        num_th = len(thresholds)
        tp = np.zeros((num_classes, num_th))
        fp = np.zeros((num_classes, num_th))
        fn = np.zeros((num_classes, num_th))
        for result in results:
            pred = np.asarray(result["masks_bev"], np.float32)
            label = np.asarray(result["gt_masks_bev"], bool)
            p = pred[None] >= thresholds[:, None, None, None]
            l = label[None]
            tp += (p & l).sum(axis=(2, 3)).T
            fp += (p & ~l).sum(axis=(2, 3)).T
            fn += (~p & l).sum(axis=(2, 3)).T
        ious = tp / np.maximum(tp + fp + fn, 1)
        metrics = {}
        for i, name in enumerate(self.map_classes):
            metrics[f"map/{name}/iou@max"] = float(ious[i].max())
        metrics["map/mean/iou@max"] = float(ious.max(axis=1).mean())
        return metrics

    def format_results(self, results, out_path: Optional[str] = None):
        """Detection results -> nuScenes submission dict with the
        reference's attribute inference (nuscenes_dataset.py:337-409).
        Boxes must already be in global frame is handled here via
        lidar->global per sample."""
        nusc_annos = {}
        for i, det in enumerate(results):
            info = self.data_infos[i]
            boxes = np.asarray(det["boxes_3d"], np.float32)
            scores = np.asarray(det["scores_3d"], np.float32)
            labels = np.asarray(det["labels_3d"], np.int64)

            l2e = np.eye(4, dtype=np.float64)
            l2e[:3, :3] = quaternion_to_matrix(info["lidar2ego_rotation"])
            l2e[:3, 3] = info["lidar2ego_translation"]
            e2g = np.eye(4, dtype=np.float64)
            e2g[:3, :3] = quaternion_to_matrix(info["ego2global_rotation"])
            e2g[:3, 3] = info["ego2global_translation"]
            l2g = e2g @ l2e

            annos = []
            for b, s, lab in zip(boxes, scores, labels):
                name = self.object_classes[int(lab)]
                center = np.ones(4)
                center[:3] = b[:3]
                center[2] += b[5] / 2  # bottom -> gravity
                gc = (l2g @ center)[:3]
                yaw = b[6]
                # yaw in global frame
                fwd = l2g[:3, :3] @ np.array([np.cos(yaw), np.sin(yaw), 0.0])
                gyaw = np.arctan2(fwd[1], fwd[0])
                vel = l2g[:3, :3] @ np.array([b[7], b[8], 0.0]) if b.shape[0] > 7 else np.zeros(3)

                speed = np.linalg.norm(vel[:2])
                if name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
                    attr = "vehicle.moving" if speed > 0.2 else self.DefaultAttribute[name]
                elif name in ("bicycle", "motorcycle"):
                    attr = "cycle.with_rider" if speed > 0.2 else self.DefaultAttribute[name]
                else:
                    attr = self.DefaultAttribute[name]

                # nuScenes boxes are (w, l, h) with quaternion yaw
                q = np.array([np.cos(gyaw / 2), 0, 0, np.sin(gyaw / 2)])
                annos.append({
                    "sample_token": info["token"],
                    "translation": gc.tolist(),
                    "size": [float(b[3]), float(b[4]), float(b[5])],
                    "rotation": q.tolist(),
                    "velocity": [float(vel[0]), float(vel[1])],
                    "detection_name": name,
                    "detection_score": float(s),
                    "attribute_name": attr,
                })
            nusc_annos[info["token"]] = annos
        submission = {
            "meta": {
                "use_camera": bool(self.modality.get("use_camera")),
                "use_lidar": bool(self.modality.get("use_lidar")),
                "use_radar": False,
                "use_map": False,
                "use_external": False,
            },
            "results": nusc_annos,
        }
        if out_path:
            import json

            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            with open(out_path, "w") as f:
                json.dump(submission, f)
        return submission

    def evaluate_detection(self, results, out_dir: str) -> Dict[str, float]:
        """Full nuScenes devkit DetectionEval (nuscenes_dataset.py:410-466).
        Requires the devkit + raw dataset; gated import."""
        res_path = os.path.join(out_dir, "results_nusc.json")
        self.format_results(results, res_path)
        from nuscenes import NuScenes
        from nuscenes.eval.detection.config import config_factory
        from nuscenes.eval.detection.evaluate import NuScenesEval

        nusc = NuScenes(version=self.version, dataroot=self.dataset_root, verbose=False)
        eval_set = "val" if "train" in self.version or "trainval" in self.version else "mini_val"
        nusc_eval = NuScenesEval(
            nusc, config=config_factory("detection_cvpr_2019"),
            result_path=res_path, eval_set=eval_set,
            output_dir=out_dir, verbose=False,
        )
        nusc_eval.main(render_curves=False)
        import json

        with open(os.path.join(out_dir, "metrics_summary.json")) as f:
            metrics = json.load(f)
        out = {
            "object/map": metrics["mean_ap"],
            "object/nds": metrics["nd_score"],
        }
        for k, v in metrics["tp_errors"].items():
            out[f"object/{k}"] = v
        return out


@DATASETS.register
class CBGSDataset:
    """Class-balanced resampling wrapper (dataset_wrappers.py:7-76):
    duplicate sample indices so every class's frequency approaches
    1/num_classes."""

    def __init__(self, dataset):
        if isinstance(dataset, dict):
            dataset = build_dataset(dataset)
        self.dataset = dataset
        self.sample_indices = self._get_sample_indices()

    def _get_sample_indices(self):
        classes = self.dataset.object_classes
        num_classes = len(classes)
        cls_to_samples = {i: [] for i in range(num_classes)}
        for idx in range(len(self.dataset)):
            for cid in self.dataset.get_cat_ids(idx):
                cls_to_samples[cid].append(idx)
        duplicated = sum(len(v) for v in cls_to_samples.values())
        if duplicated == 0:
            return list(range(len(self.dataset)))
        frac = 1.0 / num_classes
        ratios = [frac / (len(v) / duplicated) if len(v) else 0.0
                  for v in cls_to_samples.values()]
        indices = []
        rng = np.random.RandomState(0)
        for cid, samples in cls_to_samples.items():
            if not samples:
                continue
            n = int(len(samples) * ratios[cid])
            indices.extend(rng.choice(samples, n).tolist())
        return indices

    def __len__(self):
        return len(self.sample_indices)

    def set_epoch(self, epoch):
        self.dataset.set_epoch(epoch)

    def __getitem__(self, idx):
        return self.dataset[self.sample_indices[idx]]

    def __getattr__(self, name):
        return getattr(self.dataset, name)


def build_dataset(cfg) -> Any:
    cfg = dict(cfg)
    t = cfg.pop("type")
    if t == "CBGSDataset":
        return CBGSDataset(cfg["dataset"])
    return DATASETS.get(t)(**cfg)
