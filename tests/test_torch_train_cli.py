"""The port's train entry point (bevfusion_tpu_torch/tools/train.py) and what
it stands on, on the CPU.

A synthesized nuScenes-format set (``data/synthetic.py``: two cameras of
64 x 128 PNGs, a keyframe and two sweeps as ``.bin``, a train split of its
own seed beside the val split) and its GT database (``create_gt_database``)
feed the tiny models of tests/test_bevfusion_model.py (the fused
TransFusion detector and the fused map-segmentation model) through a train
pipeline with every augmentation of the nuScenes one: ``ObjectPaste`` (until
``stop_epoch`` 1), ``ImageAug3D``, ``GlobalRotScaleTrans``, ``RandomFlip3D``,
``GridMask``, ``PointShuffle``, ``GTDepth``, under ``CBGSDataset``. Checked:

- ``AdamW.state_dict`` / ``load_state_dict``: a copy restored from it
  takes the same next steps bit for bit; a missing name or a wrong shape
  raises; ``save_checkpoint`` with the optimizer and ``restore_checkpoint``
  round-trip it; resuming from a weights-only file raises;
- ``load_weights`` (load_from): a LiDAR-only checkpoint into the fused
  model loads what is there and lists the camera branch and the fuser as
  missing; a shape mismatch raises;
- the CLI on both tiny models: 2 epochs, then a run resumed from
  ``epoch_1``; the resumed run's final weights and optimizer state are the
  uninterrupted run's bit for bit, and ``epoch_1`` / ``epoch_2`` hold the
  optimizer state and ``{epoch, iter}``; the seg model's per-epoch eval is
  ``map`` (its metrics in the run's ``metrics.jsonl``); the load_from run
  prints the keys it left missing;
- the compute dtype: a config with ``configs/default.yaml``'s ``precision``
  trains in bf16, ``precision.compute_dtype=float32`` on the command line
  in fp32; a bf16 run resumed from its ``epoch_1`` is bit-identical, as an
  fp32 one; a bf16 run's checkpoint resumes strictly in fp32 and an fp32
  run's in bf16 (the checkpoints hold fp32 weights and moments either way);
- ``eval_metrics``: every config the port serves takes its metric from its
  heads (bbox for the detectors, map for the seg configs);
- ``MetricLogger`` writes the JAX logger's records and text lines for the
  same logs, taking floats only at its interval.
"""
import functools
import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch
import yaml

from bevfusion_tpu.utils.logging import MetricLogger as JaxMetricLogger
from bevfusion_tpu_torch.config import load_config
from bevfusion_tpu_torch.data import synthetic
from bevfusion_tpu_torch.data.converter import create_gt_database
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.runtime.checkpoint import (load_weights, restore_checkpoint,
                                                    save_checkpoint)
from bevfusion_tpu_torch.runtime.train import AdamW
from bevfusion_tpu_torch.tools import train as train_cli
from bevfusion_tpu_torch.utils.logging import MetricLogger
from tests.test_bevfusion_model import tiny_fused_config
from tests.torch_port_helpers import EVAL_RIG_SEED, MAP_CLASSES, PCR, tiny_config

torch.set_num_threads(2)

CLASSES = list(synthetic.CLASSES)
AUG2D = {"final_dim": [32, 64], "resize_lim": [0.45, 0.55], "bot_pct_lim": [0.0, 0.0],
         "rot_lim": [-5.4, 5.4], "rand_flip": True, "is_train": True}


def tiny_train_config(head):
    """``tests/torch_port_helpers.py:tiny_config(head)`` (the tiny eval config of
    tests/test_torch_eval.py) with a train split: the
    nuScenes train pipeline's steps at the tiny sizes (``ObjectPaste`` from
    the set's GT database until epoch 1), CBGS, B = 2, 2 epochs, AdamW with
    the flagship's schedules, a log line every step, two checkpoints kept."""
    cfg = tiny_config(head)
    load = cfg["test_pipeline"][:4]
    db_sampler = {
        "dataset_root": "${dataset_root}",
        "info_path": "${dataset_root + 'nuscenes_dbinfos_train.pkl'}", "rate": 1.0,
        "prepare": {"filter_by_difficulty": [-1],
                    "filter_by_min_points": {c: 2 for c in CLASSES}},
        "classes": CLASSES, "sample_groups": {"car": 2, "truck": 2, "bus": 1, "pedestrian": 2,
                                             "traffic_cone": 2},
        "points_loader": {"type": "LoadPointsFromFile", "coord_type": "LIDAR", "load_dim": 5,
                          "use_dim": 5}}
    test = {s["type"]: s for s in cfg["test_pipeline"]}
    cfg["gt_paste_stop_epoch"] = 1
    cfg["train_pipeline"] = load + [
        {"type": "ObjectPaste", "stop_epoch": "${gt_paste_stop_epoch}", "db_sampler": db_sampler},
        dict(AUG2D, type="ImageAug3D"),
        {"type": "GlobalRotScaleTrans", "resize_lim": [0.95, 1.05], "rot_lim": [-0.3, 0.3],
         "trans_lim": 0.2, "is_train": True},
        test["LoadBEVSegmentation"], {"type": "RandomFlip3D"}, test["PointsRangeFilter"],
        {"type": "ObjectRangeFilter", "point_cloud_range": "${point_cloud_range}"},
        {"type": "ObjectNameFilter", "classes": CLASSES}, {"type": "PointMasksBEV"},
        test["ImageNormalize"],
        {"type": "GridMask", "use_h": True, "use_w": True, "max_epoch": "${max_epochs}",
         "rotate": 1, "offset": False, "ratio": 0.5, "mode": 1, "prob": 0.5, "fixed_prob": True},
        {"type": "PointShuffle"}, {"type": "GTDepth", "keyframe_only": True},
        {"type": "PadBatch", "max_points": 1024, "max_gt_boxes": 12},
        dict(test["Collect3D"], keys=["img", "points", "gt_bboxes_3d", "gt_labels_3d",
                                      "gt_masks_bev", "depths"])]
    dataset = {"type": "NuScenesDataset", "dataset_root": "${dataset_root}",
               "object_classes": CLASSES, "map_classes": MAP_CLASSES,
               "modality": {"use_camera": True, "use_lidar": True}}
    cfg["data"] = {
        "samples_per_gpu": 2, "workers_per_gpu": 2,
        "train": {"type": "CBGSDataset", "dataset": dict(
            dataset, ann_file="${dataset_root + 'nuscenes_infos_train.pkl'}",
            pipeline="${train_pipeline}", test_mode=False, use_valid_flag=True)},
        "val": dict(dataset, ann_file="${dataset_root + 'nuscenes_infos_val.pkl'}",
                    pipeline="${test_pipeline}", test_mode=False),
        "test": cfg["data"]["test"]}
    cfg.update({
        "seed": 0, "max_epochs": 2,
        "optimizer": {"type": "AdamW", "lr": 2.0e-3, "weight_decay": 0.01},
        "optimizer_config": {"grad_clip": {"max_norm": 35, "norm_type": 2}},
        "lr_config": {"policy": "CosineAnnealing", "warmup": "linear", "warmup_iters": 3,
                      "warmup_ratio": 0.33333333, "min_lr_ratio": 1.0e-3},
        "momentum_config": {"policy": "cyclic"},
        "checkpoint": {"interval": 1, "max_keep": 2},
        "logging": {"interval": 1, "tensorboard": False},
        "evaluation": {"interval": 1}})
    return cfg


@functools.lru_cache(maxsize=None)
def write_set(root):
    """The tiny val split (that of tests/test_torch_eval.py, more points), a train split
    of four samples from its own seed, and the GT database of the train
    split; returns ``root``."""
    synthetic.write_synthetic_nuscenes(
        root, num_samples=3, num_cameras=2, image_hw=(64, 128), points_per_sweep=300,
        num_sweeps=2, point_cloud_range=PCR, num_gt=4, seed=1, rig_seed=EVAL_RIG_SEED, focal=0.47,
        train_samples=4)
    create_gt_database(root, os.path.join(root, "nuscenes_infos_train.pkl"), CLASSES)
    return root


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    return write_set(str(tmp_path_factory.mktemp("nusc")))


def config_file(root, head, **changes):
    """The tiny train config of ``head`` under ``root`` as a YAML file."""
    cfg = tiny_train_config(head)
    cfg.update(changes, dataset_root=root + "/")
    path = os.path.join(root, f"train_{head}_{zlib.crc32(repr(changes).encode())}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def lidar_compatible(model_cfg):
    """``model_cfg`` (the tiny fused model) with a fuser of 16 channels, so
    its decoder takes what the tiny LiDAR-only model's takes, as the real
    fused and LiDAR-only configs' decoders both take 256."""
    model_cfg = dict(model_cfg, fuser=dict(model_cfg["fuser"], out_channels=16))
    model_cfg["decoder"] = dict(model_cfg["decoder"], backbone=dict(
        model_cfg["decoder"]["backbone"], in_channels=16))
    return model_cfg


def _states_equal(a, b):
    """Bit-equal state dicts: the same keys, dtypes and values."""
    assert list(a) == list(b)
    return [k for k in a if not (a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]))]


def _ckpt(path):
    return torch.load(path, map_location="cpu", weights_only=False)


# ---------------------------------------------------------------- the optimizer state

def _tiny_step(model, opt, x):
    opt.zero_grad()
    model(x).square().mean().backward()
    opt.step()


def _optimizer(model):
    return AdamW(model.named_parameters(), lambda t: 1e-2 * (0.9 ** t), weight_decay=0.01,
                 max_norm=1.0, momentum_schedule=lambda t: 0.9 - 0.01 * t,
                 custom_keys={"bias": {"decay_mult": 0}})


def test_adamw_state_round_trips(tmp_path):
    """Three steps, then the state into a fresh copy (in memory and through
    a checkpoint): two more steps from each give the same weights and
    moments bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 8, generator=g)
    model = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.ReLU(), torch.nn.Linear(8, 4))
    opt = _optimizer(model)
    for _ in range(3):
        _tiny_step(model, opt, x)
    state = opt.state_dict()
    assert state["count"] == 3 and set(state["mu"]) == {n for n, _ in model.named_parameters()}
    save_checkpoint(str(tmp_path / "epoch_1"), model, meta={"epoch": 1, "iter": 3}, optimizer=opt)
    copies = []
    for via_file in (False, True):
        twin = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.ReLU(), torch.nn.Linear(8, 4))
        twin_opt = _optimizer(twin)
        if via_file:
            meta = restore_checkpoint(str(tmp_path / "epoch_1"), twin, twin_opt)
            assert meta == {"epoch": 1, "iter": 3}
        else:
            twin.load_state_dict(model.state_dict())
            twin_opt.load_state_dict(state)
        copies.append((twin, twin_opt))
    for _ in range(2):
        for m, o in [(model, opt)] + copies:
            _tiny_step(m, o, x)
    for twin, twin_opt in copies:
        assert not _states_equal(twin.state_dict(), model.state_dict())
        for key in ("mu", "nu"):
            assert not _states_equal(twin_opt.state_dict()[key], opt.state_dict()[key])
        assert twin_opt.count == opt.count == 5


def test_train_step_dropout_is_seeded_from_the_step():
    """``make_train_step`` reseeds the dropout generator from (seed, step):
    a model and optimizer restored after step 1 draw, at steps 2 and 3, the
    masks the uninterrupted run drew (the same losses and weights)."""
    from bevfusion_tpu_torch.models.layers import Dropout
    from bevfusion_tpu_torch.runtime.train import make_train_step

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc, self.drop = torch.nn.Linear(8, 8), Dropout(0.5)

        def forward(self, batch):
            return {"loss/x": self.drop(self.fc(batch["x"])).square().mean()}

    torch.manual_seed(0)
    x = {"x": torch.randn(4, 8)}
    model = Net()
    opt = _optimizer(model)
    step = make_train_step(model, opt, "cpu", seed=3)
    step(x)
    resumed = Net()
    resumed.load_state_dict(model.state_dict())
    resumed_opt = _optimizer(resumed)
    resumed_opt.load_state_dict(opt.state_dict())
    resumed_step = make_train_step(resumed, resumed_opt, "cpu", seed=3)
    want = [float(step(x)["loss/total"]) for _ in range(2)]
    got = [float(resumed_step(x)["loss/total"]) for _ in range(2)]
    assert got == want
    assert not _states_equal(resumed.state_dict(), model.state_dict())


def test_adamw_state_is_strict(tmp_path):
    model = torch.nn.Linear(4, 2)
    opt = _optimizer(model)
    state = opt.state_dict()
    with pytest.raises(KeyError, match="missing"):
        opt.load_state_dict({"count": 1, "mu": {"weight": state["mu"]["weight"]},
                             "nu": state["nu"]})
    with pytest.raises(ValueError, match="shape"):
        opt.load_state_dict({"count": 1, "mu": {"weight": torch.zeros(2, 5),
                                                "bias": torch.zeros(2)}, "nu": state["nu"]})
    save_checkpoint(str(tmp_path / "weights.pth"), model)
    with pytest.raises(KeyError, match="no optimizer state"):
        restore_checkpoint(str(tmp_path / "weights.pth"), model, opt)


def test_load_weights_lists_what_it_left_missing(tmp_path):
    """A LiDAR-only checkpoint into the fused model (the fused recipe's
    load_from): the LiDAR branch, decoder and head load, the camera branch
    and the fuser are missing and keep their weights. Into the tiny fused
    model as written (its fuser gives 24 channels, the LiDAR-only decoder
    takes 16) it raises on the decoder's shapes."""
    lidar = flagship.init_weights(build_model(tiny_fused_config(with_camera=False), "cpu"), 1)
    path = str(tmp_path / "lidar.pth")
    save_checkpoint(path, lidar)
    fused = flagship.init_weights(build_model(lidar_compatible(tiny_fused_config()), "cpu"), 2)
    camera_before = {k: v.clone() for k, v in fused.state_dict().items()
                     if k.startswith(("encoders.camera", "fuser"))}
    missing, unexpected = load_weights(path, fused)
    # torch keeps a BatchNorm's own num_batches_tracked where the file has none, unlisted
    assert unexpected == [] and sorted(missing) == sorted(
        k for k in camera_before if not k.endswith("num_batches_tracked"))
    state = fused.state_dict()
    assert set(state) - set(camera_before) == set(lidar.state_dict())
    for k, v in lidar.state_dict().items():
        assert torch.equal(state[k], v), k
    for k, v in camera_before.items():
        assert torch.equal(state[k], v), k
    with pytest.raises(ValueError, match="decoder.backbone"):
        load_weights(path, build_model(tiny_fused_config(), "cpu"))


# ---------------------------------------------------------------- the CLI

def _run(path, run_dir, *extra):
    return train_cli.main([path, "--run-dir", str(run_dir), "--device", "cpu", *extra])


@pytest.mark.parametrize("head", ["object", "map"])
def test_resumed_run_is_bit_identical(nusc_root, tmp_path, head):
    """Run A, 2 epochs; run B resumed from A's ``epoch_1``: B's final
    weights and optimizer state are A's, bit for bit, and so are its losses.
    The detector (TransFusion's dropout and Swin's drop-path on) skips its
    eval (no devkit here); the seg model evaluates ``map`` every epoch and
    writes no ``best``: ``save_best`` defaults to ``mAP``, which no metric
    key matches (the JAX CLI's default too)."""
    changes = {}
    if head == "object":  # dropout and drop-path on: the resumed steps must draw the same masks
        model = tiny_config(head)["model"]
        model["heads"]["object"]["dropout"] = 0.1
        model["encoders"]["camera"]["backbone"]["drop_path_rate"] = 0.2
        changes = {"evaluation": {"interval": 1, "disable": True}, "model": model}
    path = config_file(nusc_root, head, **changes)
    a = _run(path, tmp_path / "a")
    assert a["start_epoch"] == 0 and a["steps_per_epoch"] >= 2
    assert sorted(os.listdir(tmp_path / "a")) == ["configs.yaml", "epoch_1", "epoch_2",
                                                  "metrics.jsonl"]
    for epoch in (1, 2):
        ckpt = _ckpt(tmp_path / "a" / f"epoch_{epoch}")
        assert ckpt["meta"] == {"epoch": epoch, "iter": epoch * a["steps_per_epoch"]}
        assert ckpt["optimizer"]["count"] == epoch * a["steps_per_epoch"]
    assert len(a["history"]) == 2 * a["steps_per_epoch"]
    assert all(np.isfinite(r["loss"]) for r in a["history"])
    b = _run(path, tmp_path / "b", "--resume-from", str(tmp_path / "a" / "epoch_1"))
    assert b["start_epoch"] == 1 and [r["epoch"] for r in b["history"]] == [1] * len(
        b["history"])
    assert [r["loss"] for r in b["history"]] == [r["loss"] for r in a["history"]][
        a["steps_per_epoch"]:]
    got, want = _ckpt(tmp_path / "b" / "epoch_2"), _ckpt(tmp_path / "a" / "epoch_2")
    assert not _states_equal(got["state_dict"], want["state_dict"])
    for key in ("mu", "nu"):
        assert not _states_equal(got["optimizer"][key], want["optimizer"][key])
    assert got["optimizer"]["count"] == want["optimizer"]["count"] and got["meta"] == want["meta"]
    records = [json.loads(line) for line in open(tmp_path / "a" / "metrics.jsonl")]
    assert [r["step"] for r in records if not r.get("eval")] == list(range(len(a["history"])))
    if head == "map":
        keys = {f"map/{c}/iou@max" for c in MAP_CLASSES} | {"map/mean/iou@max"}
        assert set(a["eval"]) == {1, 2} and set(a["eval"][2]) == keys
        assert a["eval"][2] == b["eval"][2]
        assert [set(r) - {"epoch", "eval", "time"} for r in records if r.get("eval")] == [keys] * 2
    saved = yaml.safe_load(open(tmp_path / "a" / "configs.yaml"))
    assert saved["max_epochs"] == 2 and saved["dataset_root"] == nusc_root + "/"


def test_load_from_run_prints_the_missing_keys(nusc_root, tmp_path, capsys):
    """The fused recipe: start from a LiDAR-only checkpoint. The run lists
    the camera branch's and the fuser's keys as missing, trains one epoch
    (an override)."""
    lidar = flagship.init_weights(build_model(tiny_fused_config(with_camera=False), "cpu"), 3)
    ckpt = str(tmp_path / "lidar.pth")
    save_checkpoint(ckpt, lidar)
    model = lidar_compatible(tiny_config("object")["model"])
    path = config_file(nusc_root, "object", evaluation={"disable": True}, model=model)
    out = _run(path, tmp_path / "load", "--load-from", ckpt, "max_epochs=1")
    printed = capsys.readouterr().out
    assert out["unexpected_keys"] == [] and out["missing_keys"]
    assert {".".join(k.split(".")[:2]) for k in out["missing_keys"]} == {
        "encoders.camera", "fuser.0", "fuser.1"}
    assert f"{len(out['missing_keys'])} keys of the model missing" in printed
    assert "encoders.camera.backbone.patch_embed.projection.weight" in printed
    assert len(out["history"]) == out["steps_per_epoch"] and os.path.exists(
        tmp_path / "load" / "epoch_1")


def test_save_best_names_a_metric_key(nusc_root, tmp_path):
    """``evaluation.save_best`` naming a real key writes ``best`` (with the
    optimizer state) after the first eval."""
    path = config_file(nusc_root, "map", evaluation={"interval": 1,
                                                     "save_best": "map/mean/iou@max"})
    out = _run(path, tmp_path / "run", "max_epochs=1")
    best = _ckpt(tmp_path / "run" / "best")
    assert best["meta"] == {"epoch": 1, "iter": out["steps_per_epoch"]} and "optimizer" in best
    assert not _states_equal(best["state_dict"], _ckpt(tmp_path / "run" / "epoch_1")["state_dict"])


def test_eval_metrics_come_from_the_heads():
    """Every config the port serves: bbox for a detector, map for a seg
    config; a config's ``evaluation.metric`` wins. (The JAX CLI takes bbox
    for all of them: tests/test_torch_train_cli_jax.py.)"""
    paths = {p: "map" for p in flagship.SEG_CONFIGS.values()}
    paths.update({p: "bbox" for p in [flagship.FLAGSHIP_CONFIG, flagship.LIDAR_SLICE_CONFIG,
                                      *flagship.DET_CAMERA_CONFIGS.values(),
                                      *flagship.PILLAR_CONFIGS.values()]})
    assert len(paths) == 10
    for p, metric in paths.items():
        cfg = load_config(p)
        assert "metric" not in (cfg.get("evaluation") or {}), p
        assert train_cli.eval_metrics(cfg) == [metric], p
    cfg = load_config(flagship.FLAGSHIP_CONFIG, overrides={"evaluation.metric": "map"})
    assert train_cli.eval_metrics(cfg) == ["map"]


def test_cli_refuses_the_card_without_one_and_several_processes(nusc_root, monkeypatch):
    path = config_file(nusc_root, "map")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main([path, "--run-dir", os.path.join(nusc_root, "unused")])
    # several processes train data-parallel (tests/test_torch_parallel.py); a backend that
    # cannot hold the device's tensors is refused before any group is joined
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        train_cli.main([path, "--device", "cpu", "--dist-backend", "nccl"])


# ---------------------------------------------------------------- the logger

def test_metric_logger_matches_jax(tmp_path, capsys, monkeypatch):
    """The same logs into both loggers (interval 2, steps 0-4 of an epoch,
    then an eval): the same records but their wall time, and the same text
    lines. The port's logger reads nothing between its intervals."""
    # the JAX logger's TensorBoard import fails (it would load TensorFlow here)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    class Unread:
        def __float__(self):
            raise AssertionError("read between intervals")

    lines = []
    for name, cls, kw in (("port", MetricLogger, {"tensorboard": False}),
                          ("jax", JaxMetricLogger, {})):
        os.makedirs(tmp_path / name)
        logger = cls(str(tmp_path / name), interval=2, **kw)
        for it in range(5):
            logs = {"loss/total": torch.tensor(1.5 / (it + 1)), "loss/object/heatmap": 0.25 * it}
            if it % 2 and name == "port":
                logs = {k: Unread() for k in logs}
            logger.log(1, it, 5, logs)
        logger.log_eval(1, {"map/mean/iou@max": 0.5, "note": "x"})
        lines.append(capsys.readouterr().out)
    recs = [[{k: v for k, v in json.loads(line).items() if k != "time"}
             for line in open(tmp_path / name / "metrics.jsonl")] for name in ("port", "jax")]
    assert recs[0] == recs[1] and len(recs[0]) == 4
    assert lines[0] == lines[1] and "[E1 0/5]" in lines[0] and "[E1 eval]" in lines[0]


def test_compute_dtype_bf16_resume_and_across_dtypes(nusc_root, tmp_path):
    """The tiny detector with the default config's ``precision`` (bf16):
    run A, 2 epochs; B resumed from A's ``epoch_1`` is A bit for bit; C
    resumes A's ``epoch_1`` in fp32 (``precision.compute_dtype=float32``);
    D resumes C's fp32 ``epoch_2`` in bf16 for a third epoch."""
    default = load_config(os.path.join(flagship.REPO_ROOT, "configs/default.yaml"))
    assert default.precision.compute_dtype == "bfloat16"
    path = config_file(nusc_root, "object", precision=dict(default.precision),
                       evaluation={"interval": 1, "disable": True})
    a = _run(path, tmp_path / "a")
    assert a["compute_dtype"] == "bfloat16"
    assert all(np.isfinite(r["loss"]) for r in a["history"])
    ckpt = _ckpt(tmp_path / "a" / "epoch_2")
    assert all(v.dtype in (torch.float32, torch.int64) for v in ckpt["state_dict"].values())
    assert all(v.dtype == torch.float32 for key in ("mu", "nu")
               for v in ckpt["optimizer"][key].values())
    b = _run(path, tmp_path / "b", "--resume-from", str(tmp_path / "a" / "epoch_1"))
    assert b["compute_dtype"] == "bfloat16" and b["start_epoch"] == 1
    assert [r["loss"] for r in b["history"]] == [r["loss"] for r in a["history"]][
        a["steps_per_epoch"]:]
    got, want = _ckpt(tmp_path / "b" / "epoch_2"), _ckpt(tmp_path / "a" / "epoch_2")
    assert not _states_equal(got["state_dict"], want["state_dict"])
    for key in ("mu", "nu"):
        assert not _states_equal(got["optimizer"][key], want["optimizer"][key])
    c = _run(path, tmp_path / "c", "--resume-from", str(tmp_path / "a" / "epoch_1"),
             "precision.compute_dtype=float32")
    assert c["compute_dtype"] == "float32" and c["start_epoch"] == 1
    assert all(np.isfinite(r["loss"]) for r in c["history"])
    assert [r["loss"] for r in c["history"]] != [r["loss"] for r in b["history"]]
    d = _run(path, tmp_path / "d", "--resume-from", str(tmp_path / "c" / "epoch_2"),
             "max_epochs=3")
    assert d["compute_dtype"] == "bfloat16" and d["start_epoch"] == 2
    assert len(d["history"]) == d["steps_per_epoch"]
    assert all(np.isfinite(r["loss"]) for r in d["history"])
