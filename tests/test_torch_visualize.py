"""``utils/visualize.py`` and ``tools/visualize.py`` against the JAX
package's: the three renderers' PNGs byte-equal on the same arrays, and
the tool's ``--mode gt`` on a synthesized nuScenes-format set
(``data/synthetic.py``) writing the same files, byte for byte, as the JAX
tool; ``--mode pred`` on the tiny fused model from a checkpoint on the
CPU writes every view."""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from bevfusion_tpu.utils import visualize as jax_viz
from bevfusion_tpu_torch.data import synthetic
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.runtime.checkpoint import save_checkpoint
from bevfusion_tpu_torch.tools import visualize as viz_cli
from bevfusion_tpu_torch.utils import visualize as viz
from tests.torch_port_helpers import EVAL_RIG_SEED, MAP_CLASSES, PCR, tiny_config

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = list(synthetic.CLASSES)


def _boxes(rng, n):
    return np.concatenate([rng.uniform(-12, 12, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                           rng.uniform(1, 4, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
                           rng.randn(n, 2)], -1).astype(np.float32)


def _same_files(a, b):
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


@pytest.mark.parametrize("view", ["lidar", "camera", "map"])
def test_renderers_write_the_jax_modules_bytes(tmp_path, view):
    rng = np.random.RandomState(3)
    boxes, labels = _boxes(rng, 5), rng.randint(0, len(CLASSES), 5)
    points = rng.uniform(-15, 15, (300, 5)).astype(np.float32)
    image = rng.uniform(0, 255, (64, 128, 3))
    masks = rng.rand(2, 16, 16) > 0.5
    lidar2image = np.eye(4, dtype=np.float32)  # a pinhole looking down +x
    lidar2image[:3, :3] = [[64, -40, 0], [32, 0, -40], [1, 0, 0]]
    ahead = boxes + np.array([20, 0, 0, 0, 0, 0, 0, 0, 0], np.float32)
    for mod, out in ((viz, tmp_path / "port"), (jax_viz, tmp_path / "jax")):
        path = str(out / f"{view}.png")
        if view == "lidar":
            mod.visualize_lidar(path, points, boxes, labels, CLASSES, xlim=(-16, 16),
                                ylim=(-16, 16))
        elif view == "camera":
            mod.visualize_camera(path, image, ahead, labels, lidar2image, CLASSES)
        else:
            mod.visualize_map(path, masks, MAP_CLASSES)
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    synthetic.write_synthetic_nuscenes(
        root, num_samples=2, num_cameras=2, image_hw=(64, 128), points_per_sweep=64,
        num_sweeps=2, point_cloud_range=PCR, num_gt=4, seed=1, rig_seed=EVAL_RIG_SEED,
        focal=0.47)
    cfg = tiny_config("object")
    cfg.update(dataset_root=root + "/", object_classes=CLASSES, map_classes=MAP_CLASSES)
    cfg["data"]["val"] = cfg["data"]["test"]
    path = os.path.join(root, "viz.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _jax_tool(argv):
    spec = importlib.util.spec_from_file_location("jax_visualize_tool",
                                                  os.path.join(ROOT, "tools", "visualize.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = sys.argv
    sys.argv = ["visualize.py", *argv]
    try:
        mod.main()
    finally:
        sys.argv = saved


def test_gt_mode_writes_the_jax_tools_files(tmp_path, config_path):
    _jax_tool([config_path, "--out-dir", str(tmp_path / "jax")])
    assert viz_cli.main([config_path, "--out-dir", str(tmp_path / "port")]) == 0
    names = _same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert {"sample00000/lidar.png", "sample00000/cam1.png", "sample00001/map.png"} <= set(names)


def test_pred_mode_renders_the_models_boxes_from_a_checkpoint(tmp_path, config_path):
    from bevfusion_tpu_torch.config import load_config

    model = flagship.init_weights(build_model(load_config(config_path).model, "cpu"), 0)
    ckpt = str(tmp_path / "epoch_1")
    save_checkpoint(ckpt, model)
    assert viz_cli.main([config_path, "--mode", "pred", "--checkpoint", ckpt, "--device", "cpu",
                         "--bbox-score", "0.0", "--out-dir", str(tmp_path / "pred")]) == 0
    for s in ("sample00000", "sample00001"):
        assert sorted(os.listdir(tmp_path / "pred" / s)) == ["cam0.png", "cam1.png", "lidar.png"]
    with pytest.raises(ValueError):
        viz_cli.main([config_path, "--mode", "pred", "--device", "cpu"])
