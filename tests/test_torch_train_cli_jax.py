"""The port's train entry point against the JAX package's train step, and
the JAX train CLI's faults that the tiny models show, pinned.

On the synthesized set of tests/test_torch_train_cli.py (its tiny train
config: the train pipeline with ObjectPaste and every augmentation, CBGS,
B = 2):

- the first batch of each package's dataset and loader is the same, bit
  for bit, once the JAX dataset seeds each sample as the port does;
- step 0's losses under the port's CLI (``--load-from`` the JAX variables
  carried across by the bridge; the logger's first record) equal those the
  JAX package's ``make_train_step`` takes on that batch with those
  variables, to 1e-4 relative (the loss tolerance of
  tests/test_torch_train_grad.py; measured 1.2e-6 for the total, 4.3e-5 at
  most), and ``stats/object/matched_ious`` to 1e-4 absolute (a mean IoU;
  at 0.0023 it is 2.3e-7 off, 9.9e-5 of itself). The JAX side runs the
  step's loss function (``model.apply(training=True)`` and the sum of the
  ``loss/`` entries) jitted alone: the whole step's trace and compile take
  ~60 s on the CPU, its forward ~17 s;
- the JAX CLI's load_from (tools/train.py:107-110) replaces the whole
  parameter tree: from a LiDAR-only checkpoint the fused model's camera
  branch and fuser are gone and its first step raises;
- the JAX CLI evaluates with ``metric=eval_cfg.get("metric", "bbox")``
  (tools/train.py:157), no seg config names a metric, and the JAX dataset's
  detection eval of a seg model's results raises: its per-epoch eval of a
  seg config fails where the port's evaluates ``map``.
"""
import functools
import json
import os
import unittest.mock
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.config import load_config as jax_load_config
from bevfusion_tpu.data import DataLoader as JaxDataLoader
from bevfusion_tpu.data import build_dataset as jax_build_dataset
from bevfusion_tpu.data import nuscenes as jnusc
from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu.runtime import checkpoint as jax_checkpoint
from bevfusion_tpu.runtime import train as jax_train
from bevfusion_tpu_torch.config import load_config
from bevfusion_tpu_torch.data import DataLoader, build_dataset
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.models.vtransforms import lss_constants
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from bevfusion_tpu_torch.runtime.checkpoint import save_checkpoint
from bevfusion_tpu_torch.tools import train as train_cli
from tests.test_torch_data import same
from tests.test_torch_train_cli import config_file, lidar_compatible, write_set
from tests.torch_port_helpers import MATS, boundary_margin, random_variables, tiny_config

torch.set_num_threads(2)

LOSS_RTOL = 1e-4
STATS_ATOL = 1e-4  # matched_ious, a mean IoU in [0, 1]: a small overlap's rounding is large in it


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    return write_set(str(tmp_path_factory.mktemp("nusc")))


def _crc32_seed():
    """The JAX dataset's ``hash`` of a token replaced by the port's CRC-32."""
    return unittest.mock.patch.object(jnusc, "hash", lambda t: zlib.crc32(t.encode()),
                                      create=True)


def _first_batches(path):
    """Batch 0 of epoch 0 from each package's train dataset and loader as
    each CLI builds them (samples_per_gpu, shuffle, workers_per_gpu, seed)."""
    out = []
    with _crc32_seed():
        for load, build, Loader in ((load_config, build_dataset, DataLoader),
                                    (jax_load_config, jax_build_dataset, JaxDataLoader)):
            cfg = load(path)
            loader = Loader(build(cfg.data.train), batch_size=cfg.data.samples_per_gpu,
                            shuffle=True, num_workers=cfg.data.workers_per_gpu, seed=cfg.seed)
            loader.set_epoch(0)
            out.append(next(iter(loader)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_step0(root):
    """The tiny detector's config file (its fuser of 16 channels, as
    ``lidar_compatible`` makes it), the JAX model, the first batch (the same
    from both packages), the JAX variables and the losses of the JAX step's
    loss function on that batch."""
    model = lidar_compatible(tiny_config("object")["model"])
    path = config_file(root, "object", evaluation={"disable": True}, max_epochs=1, model=model)
    got, want = _first_batches(path)
    got.pop("metas", None)
    want.pop("metas", None)
    same(got, want)
    cfg = jax_load_config(path)
    vt = cfg.model["encoders"]["camera"]["vtransform"]
    dx, bx, nx, frustum = lss_constants(vt["image_size"], vt["feature_size"], vt["xbound"],
                                        vt["ybound"], vt["zbound"], vt["dbound"])
    assert boundary_margin(frustum, dx, bx, nx, {k: want[k] for k in MATS}) > 1e-4
    jm = jax_build_model(cfg.model)
    batch = {k: jnp.asarray(v) for k, v in want.items()}
    variables = random_variables(jm.init, {k: v for k, v in batch.items()
                                           if not k.startswith("gt_")}, seed=14)
    variables["params"]["head_modules_object"]["heatmap_conv1"]["conv"]["kernel"] *= 0.2

    def losses_of(params):  # make_train_step's loss function, the forward it differentiates
        losses, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, batch,
                             training=True, mutable=["batch_stats", "intermediates"],
                             rngs={"dropout": jax.random.PRNGKey(0)})
        return dict(losses, **{"loss/total": sum(v for k, v in losses.items()
                                                 if k.startswith("loss/"))})

    logs = jax.jit(losses_of)(variables["params"])
    return path, jm, batch, variables, {k: float(v) for k, v in logs.items()}


def test_step0_losses_under_the_cli_match_the_jax_train_step(nusc_root, tmp_path):
    path, _, _, variables, want = _jax_step0(nusc_root)
    ckpt = str(tmp_path / "bridged.pth")
    model = build_model(load_config(path).model, "cpu")
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    save_checkpoint(ckpt, model)
    out = train_cli.main([path, "--run-dir", str(tmp_path / "run"), "--device", "cpu",
                          "--load-from", ckpt])
    assert out["missing_keys"] == [] and out["unexpected_keys"] == []
    first = json.loads(open(tmp_path / "run" / "metrics.jsonl").readline())
    assert (first["epoch"], first["iter"]) == (0, 0)
    got = {k: v for k, v in first.items() if "/" in k}
    assert set(got) == set(want) and want["stats/object/matched_ious"] > 0
    for k, v in want.items():
        tol = STATS_ATOL if k.startswith("stats/") else LOSS_RTOL * max(abs(v), 1e-6)
        assert abs(got[k] - v) <= tol, (k, got[k], v)
    assert got["loss/total"] == out["history"][0]["loss"]


def test_jax_load_from_replaces_the_whole_parameter_tree(nusc_root, tmp_path):
    """A LiDAR-only TrainState (the fused model's tree without the camera
    branch and the fuser: the tiny LiDAR-only model's tree) saved as the JAX
    CLI saves it, then the JAX CLI's load_from on the fused model
    (tools/train.py:107-110): the params are the LiDAR-only tree, and the
    first step raises for the camera branch's parameters. The port's
    load_from keeps them
    (tests/test_torch_train_cli.py::test_load_weights_lists_what_it_left_missing)."""
    _, fused, batch, fv, _ = _jax_step0(nusc_root)
    lidar = {k: v for k, v in fv["params"].items() if not k.startswith(("camera_", "fuser"))}
    assert sorted(lidar) == ["decoder_backbone", "decoder_neck", "head_modules_object",
                             "lidar_backbone"]
    tx_of = lambda params: jax_train.build_optimizer({"lr": 1e-3}, 1e-3, params)  # noqa: E731
    jax_checkpoint.save_checkpoint(str(tmp_path / "epoch_1"), jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=lidar, batch_stats=fv["batch_stats"],
        opt_state=tx_of(lidar).init(lidar)))
    tx = tx_of(fv["params"])
    state = jax_train.TrainState(step=jnp.zeros((), jnp.int32), params=fv["params"],
                                 batch_stats=fv["batch_stats"], opt_state=tx.init(fv["params"]))
    loaded = jax_checkpoint.restore_checkpoint(str(tmp_path / "epoch_1"))
    state = state.replace(params=loaded.get("params", loaded),
                          batch_stats=loaded.get("batch_stats", fv["batch_stats"]))
    assert sorted(state.params) == sorted(lidar)
    with pytest.raises(Exception, match="camera_backbone"):
        jax_train.make_train_step(fused, tx)(state, batch, {"dropout": jax.random.PRNGKey(0)})


def test_jax_cli_would_evaluate_the_seg_configs_as_detectors(nusc_root):
    """No seg config names ``evaluation.metric``, so the JAX CLI's eval of
    each is ``bbox``; the JAX dataset's detection eval of the seg model's
    per-sample results (``masks_bev``, ``gt_masks_bev``) raises, where the
    port's CLI takes ``map`` from the head."""
    for p in flagship.SEG_CONFIGS.values():
        cfg = jax_load_config(p)
        assert (cfg.get("evaluation") or {}).get("metric", "bbox") == "bbox", p
        assert train_cli.eval_metrics(load_config(p)) == ["map"], p
    cfg = jax_load_config(config_file(nusc_root, "map"))
    dataset = jax_build_dataset(cfg.data.val)
    results = [{"masks_bev": np.zeros((2, 16, 16), np.float32),
                "gt_masks_bev": np.zeros((2, 16, 16), bool)} for _ in range(len(dataset))]
    with pytest.raises(KeyError, match="boxes_3d"):
        dataset.evaluate_detection(results, os.path.join(nusc_root, "jax_bbox_eval"))
    assert set(dataset.evaluate_map(results)) >= {"map/mean/iou@max"}
