"""The port's checkpoints (bevfusion_tpu_torch/runtime/checkpoint.py).

- save then restore gives the same state dict, bit for bit, and the meta;
- ``keep`` prunes the ``epoch_N`` / ``step_N`` files beside a new one to
  the newest by N (``epoch_10`` after ``epoch_9``), and leaves ``best``;
- the reference's checkpoint layout (tests/torch_ref/skeleton.py, the
  released ``.pth`` key tree: ``{"state_dict": ..., "meta": ...}``, or the
  bare state dict) restores strictly into the full-width model; a missing
  or unexpected key raises;
- JAX variables carried across by the bridge, saved and restored, are the
  bridge's tensors;
- an orbax directory (the JAX package's checkpoint) raises and names the
  bridge.
"""
import os

import pytest
import torch

import tests.torch_ref.skeleton as skeleton
from bevfusion_tpu_torch.config import load_config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from bevfusion_tpu_torch.runtime.checkpoint import restore_checkpoint, save_checkpoint
from bevfusion_tpu_torch.runtime.flagship import LIDAR_SLICE_CONFIG, init_weights
from tests.test_bevfusion_model import tiny_fused_config
from tests.torch_port_helpers import tiny_lidar_model

torch.set_num_threads(2)


def _tiny(seed):
    return init_weights(build_model(tiny_fused_config(head="map"), "cpu"), seed)


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def test_save_restore_round_trips_bit_for_bit(tmp_path):
    src, dst = _tiny(1), _tiny(2)
    assert not torch.equal(src.state_dict()["fuser.0.weight"], dst.state_dict()["fuser.0.weight"])
    path = str(tmp_path / "run" / "epoch_3.pth")
    save_checkpoint(path, src, meta={"epoch": 3, "config": "tiny"})
    assert restore_checkpoint(path, dst) == {"epoch": 3, "config": "tiny"}
    _assert_same_state(src, dst)
    assert not os.path.exists(path + ".tmp")


def test_keep_prunes_to_the_newest(tmp_path):
    model = _tiny(0)
    save_checkpoint(str(tmp_path / "best.pth"), model)
    for n in (1, 2, 9, 10):
        save_checkpoint(str(tmp_path / f"epoch_{n}.pth"), model, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["best.pth", "epoch_10.pth", "epoch_9.pth"]
    save_checkpoint(str(tmp_path / "step_500"), model, keep=1)  # the JAX module's names
    save_checkpoint(str(tmp_path / "step_1000"), model, keep=1)
    assert sorted(os.listdir(tmp_path)) == ["best.pth", "step_1000"]


def test_reference_layout_restores_strictly(tmp_path):
    """The released-checkpoint key tree of TransFusion-L (voxelnet_0p075) at
    full width, in the .pth layout and bare."""
    ref = skeleton.LidarOnlyDetSkeleton()
    torch.manual_seed(0)
    for p in ref.parameters():
        p.data.normal_()
    model = build_model(load_config(LIDAR_SLICE_CONFIG).model, "cpu")
    pth, bare = str(tmp_path / "ref.pth"), str(tmp_path / "bare.pth")
    torch.save({"state_dict": ref.state_dict(), "meta": {"epoch": 20}, "optimizer": {}}, pth)
    torch.save(ref.state_dict(), bare)
    assert restore_checkpoint(pth, model) == {"epoch": 20}
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in ref.state_dict().items())
    assert restore_checkpoint(bare, model) == {}
    sd = dict(ref.state_dict())
    sd.pop(next(iter(sd)))
    torch.save({"state_dict": sd}, pth)
    with pytest.raises(RuntimeError, match="Missing key"):
        restore_checkpoint(pth, model)
    torch.save({"state_dict": dict(ref.state_dict(), extra=torch.zeros(1))}, pth)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        restore_checkpoint(pth, model)


def test_bridged_jax_weights_survive_a_checkpoint(tmp_path):
    cfg, _, _, variables = tiny_lidar_model()
    bridged = jax_to_torch_state_dict(variables)
    model = build_model(cfg, "cpu")
    model.load_state_dict(bridged, strict=True)
    path = str(tmp_path / "bridged.pth")
    save_checkpoint(path, model)
    restored = build_model(cfg, "cpu")
    restore_checkpoint(path, restored)
    sd = restored.state_dict()
    assert set(sd) == set(bridged)
    assert all(torch.equal(sd[k], bridged[k].to(sd[k].dtype)) for k in bridged)


def test_orbax_directory_names_the_bridge(tmp_path):
    (tmp_path / "epoch_1").mkdir()
    with pytest.raises(ValueError, match="runtime/bridge.py"):
        restore_checkpoint(str(tmp_path / "epoch_1"), _tiny(0))
