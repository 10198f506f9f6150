"""Offline data preparation: nuScenes info pkls + GT database.

A copy of ``bevfusion_tpu/data/converter.py``, held to it by
tests/test_torch_dbsampler.py: ``create_gt_database`` bit for bit (the crop
files and the dbinfos pkl), ``create_nuscenes_infos`` up to its gated
import of the nuScenes devkit. Behavioral reference:
tools/data_converter/nuscenes_converter.py (create_nuscenes_infos /
_fill_trainval_infos:142+ — per-sample lidar path, <=10 sweeps with
relative poses, per-camera calibration via obtain_sensor2top:324, GT boxes
+ velocity + valid_flag) and create_gt_database.py:111 (per-GT point crops
for ObjectPaste).

``create_nuscenes_infos`` requires the nuScenes devkit + raw dataset
(gated imports); it emits the same pickle schema the reference consumes,
so info files are interchangeable between the frameworks.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np

from ..core.box_np import points_in_rbbox

__all__ = ["create_nuscenes_infos", "create_gt_database"]


def _sensor2top(nusc, sensor_token, l2e_t, l2e_r_mat, e2g_t, e2g_r_mat, sensor_type):
    """Sweep/camera record with sensor->keyframe-lidar transform
    (nuscenes_converter.py:324+)."""
    from pyquaternion import Quaternion

    sd_rec = nusc.get("sample_data", sensor_token)
    cs_record = nusc.get("calibrated_sensor", sd_rec["calibrated_sensor_token"])
    pose_record = nusc.get("ego_pose", sd_rec["ego_pose_token"])
    data_path = str(nusc.get_sample_data_path(sensor_token))
    info = {
        "data_path": data_path,
        "type": sensor_type,
        "sample_data_token": sensor_token,
        "sensor2ego_translation": cs_record["translation"],
        "sensor2ego_rotation": cs_record["rotation"],
        "ego2global_translation": pose_record["translation"],
        "ego2global_rotation": pose_record["rotation"],
        "timestamp": sd_rec["timestamp"],
    }
    l2e_r_s = Quaternion(info["sensor2ego_rotation"]).rotation_matrix
    l2e_t_s = np.array(info["sensor2ego_translation"])
    e2g_r_s = Quaternion(info["ego2global_rotation"]).rotation_matrix
    e2g_t_s = np.array(info["ego2global_translation"])

    # sensor->global->keyframe-ego->keyframe-lidar
    R = (l2e_r_s.T @ e2g_r_s.T) @ (
        np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T
    )
    T = (l2e_t_s @ e2g_r_s.T + e2g_t_s) @ (
        np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T
    )
    T -= (
        e2g_t @ (np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T)
        + l2e_t @ np.linalg.inv(l2e_r_mat).T
    )
    info["sensor2lidar_rotation"] = R.T
    info["sensor2lidar_translation"] = T
    return info


def create_nuscenes_infos(root_path: str, info_prefix: str = "nuscenes",
                          version: str = "v1.0-trainval", max_sweeps: int = 10):
    from nuscenes import NuScenes
    from nuscenes.utils import splits
    from pyquaternion import Quaternion

    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)
    if version == "v1.0-trainval":
        train_scenes, val_scenes = splits.train, splits.val
    elif version == "v1.0-mini":
        train_scenes, val_scenes = splits.mini_train, splits.mini_val
    elif version == "v1.0-test":
        train_scenes, val_scenes = splits.test, []
    else:
        raise ValueError(version)
    scene_name_to_token = {s["name"]: s["token"] for s in nusc.scene}
    train_tokens = {scene_name_to_token[n] for n in train_scenes if n in scene_name_to_token}
    val_tokens = {scene_name_to_token[n] for n in val_scenes if n in scene_name_to_token}
    test = version == "v1.0-test"

    camera_types = ["CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT"]

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        lidar_token = sample["data"]["LIDAR_TOP"]
        sd_rec = nusc.get("sample_data", lidar_token)
        cs_record = nusc.get("calibrated_sensor", sd_rec["calibrated_sensor_token"])
        pose_record = nusc.get("ego_pose", sd_rec["ego_pose_token"])
        lidar_path, boxes, _ = nusc.get_sample_data(lidar_token)

        info = {
            "lidar_path": str(lidar_path),
            "token": sample["token"],
            "sweeps": [],
            "cams": {},
            "location": nusc.get(
                "log", nusc.get("scene", sample["scene_token"])["log_token"]
            )["location"],
            "lidar2ego_translation": cs_record["translation"],
            "lidar2ego_rotation": cs_record["rotation"],
            "ego2global_translation": pose_record["translation"],
            "ego2global_rotation": pose_record["rotation"],
            "timestamp": sample["timestamp"],
        }
        l2e_r_mat = Quaternion(info["lidar2ego_rotation"]).rotation_matrix
        e2g_r_mat = Quaternion(info["ego2global_rotation"]).rotation_matrix
        l2e_t = np.array(info["lidar2ego_translation"])
        e2g_t = np.array(info["ego2global_translation"])

        for cam in camera_types:
            cam_token = sample["data"][cam]
            _, _, cam_intrinsic = nusc.get_sample_data(cam_token)
            cam_info = _sensor2top(nusc, cam_token, l2e_t, l2e_r_mat,
                                   e2g_t, e2g_r_mat, cam)
            cam_info["cam_intrinsic"] = cam_intrinsic
            info["cams"][cam] = cam_info

        # past lidar sweeps
        sweeps = []
        rec = sd_rec
        while len(sweeps) < max_sweeps:
            if rec["prev"] == "":
                break
            sweep = _sensor2top(nusc, rec["prev"], l2e_t, l2e_r_mat,
                                e2g_t, e2g_r_mat, "lidar")
            sweeps.append(sweep)
            rec = nusc.get("sample_data", rec["prev"])
        info["sweeps"] = sweeps

        if not test:
            annotations = [nusc.get("sample_annotation", t) for t in sample["anns"]]
            locs = np.array([b.center for b in boxes]).reshape(-1, 3)
            dims = np.array([b.wlh for b in boxes]).reshape(-1, 3)
            rots = np.array([b.orientation.yaw_pitch_roll[0] for b in boxes]).reshape(-1, 1)
            velocity = np.array(
                [nusc.box_velocity(t)[:2] for t in sample["anns"]]
            ).reshape(-1, 2)
            # velocity global -> lidar frame
            for i in range(len(boxes)):
                v = np.array([*velocity[i], 0.0])
                v = v @ np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T
                velocity[i] = v[:2]
            names = np.array([_general_to_detection(b.name) for b in boxes])
            # nuScenes box: center is gravity; our boxes are bottom-center
            # with (w, l, h) -> (dx, dy, dz): wlh = (w, l, h), dims (l, w, h)
            gt_boxes = np.concatenate([locs, dims[:, [1, 0, 2]], rots], axis=1)
            gt_boxes[:, 2] -= gt_boxes[:, 5] / 2
            # mmdet3d pre-refactor yaw convention: -yaw - pi/2
            gt_boxes[:, 6] = -gt_boxes[:, 6] - np.pi / 2
            info["gt_boxes"] = gt_boxes
            info["gt_names"] = names
            info["gt_velocity"] = velocity
            info["num_lidar_pts"] = np.array([a["num_lidar_pts"] for a in annotations])
            info["num_radar_pts"] = np.array([a["num_radar_pts"] for a in annotations])
            info["valid_flag"] = np.array(
                [(a["num_lidar_pts"] + a["num_radar_pts"]) > 0 for a in annotations],
                bool,
            )

        if sample["scene_token"] in train_tokens:
            train_infos.append(info)
        else:
            val_infos.append(info)

    meta = {"version": version}
    if test:
        _dump(os.path.join(root_path, f"{info_prefix}_infos_test.pkl"),
              {"infos": train_infos, "metadata": meta})
    else:
        _dump(os.path.join(root_path, f"{info_prefix}_infos_train.pkl"),
              {"infos": train_infos, "metadata": meta})
        _dump(os.path.join(root_path, f"{info_prefix}_infos_val.pkl"),
              {"infos": val_infos, "metadata": meta})
    return len(train_infos), len(val_infos)


_DETECTION_NAMES = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "vehicle.car": "car",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.trailer": "trailer",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
}


def _general_to_detection(name: str) -> str:
    return _DETECTION_NAMES.get(name, name)


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    print("wrote", path)


def create_gt_database(root_path: str, info_path: str, used_classes,
                       db_prefix: str = "nuscenes", load_dim: int = 5):
    """Crop per-GT point clouds for ObjectPaste
    (create_gt_database.py:111): each GT's points, box-centered, saved as
    .bin plus a dbinfos pkl."""
    with open(info_path, "rb") as f:
        infos = pickle.load(f)["infos"]

    db_dir = os.path.join(root_path, f"{db_prefix}_gt_database")
    os.makedirs(db_dir, exist_ok=True)
    db_infos: Dict[str, List[dict]] = {c: [] for c in used_classes}

    for idx, info in enumerate(infos):
        pts = np.fromfile(info["lidar_path"], np.float32).reshape(-1, load_dim)
        boxes = np.asarray(info["gt_boxes"], np.float32)
        names = info["gt_names"]
        if boxes.size == 0:
            continue
        inside = points_in_rbbox(pts[:, :3], boxes[:, :7])
        for gi in range(len(boxes)):
            name = str(names[gi])
            if name not in used_classes:
                continue
            crop = pts[inside[:, gi]].copy()
            crop[:, :3] -= boxes[gi, :3]
            fname = f"{info['token']}_{name}_{gi}.bin"
            crop.astype(np.float32).tofile(os.path.join(db_dir, fname))
            db_infos[name].append({
                "name": name,
                "path": os.path.join(f"{db_prefix}_gt_database", fname),
                "gt_idx": gi,
                "box3d_lidar": boxes[gi],
                "num_points_in_gt": int(inside[:, gi].sum()),
                "difficulty": 0,
            })
        if idx % 500 == 0:
            print(f"gt database: {idx}/{len(infos)}")

    _dump(os.path.join(root_path, f"{db_prefix}_dbinfos_train.pkl"), db_infos)
