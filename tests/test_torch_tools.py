"""The port's measurement tools (bevfusion_tpu_torch/tools/) on the CPU, on
the tiny fused model of tests/test_bevfusion_model.py.

Each profiling tool runs its module's own forward with a timer as the
``timed`` hook: the output must equal the plain forward's exactly (the
same ops in the same order on the same device), and every row it returns
must be finite. The times here are host times of the CPU
at toy sizes, not measurements of the card. Every tool's ``main`` runs
on the card unless ``--device cpu``: without CUDA it raises.
"""
import copy
import functools
import importlib
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bevfusion_tpu_torch.config import Config, load_config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.tools import (bench_iou, bench_train_step, benchmark, profile_encoder,
                                       profile_meta, profile_stages, profile_vtransform)
from tests.test_bevfusion_model import make_batch, tiny_fused_config

torch.set_num_threads(2)

TOOLS = ["bench_tile_micro", "bench_kernel_variants", "profile_meta", "profile_encoder",
         "profile_vtransform", "profile_stages", "bench_train_step", "benchmark", "bench_iou"]


def _batch(training=False):
    cfg = tiny_fused_config()
    batch = {k: torch.from_numpy(np.array(v)) for k, v in make_batch(B=1, N=2, P=512).items()
             if training or not k.startswith("gt_")}
    batch["img"] = batch["img"].permute(0, 1, 4, 2, 3).contiguous()
    return flagship.add_pool_lut(Config.from_dict({"model": cfg}), batch)


@functools.lru_cache(maxsize=None)
def _tiny():
    model = flagship.init_weights(build_model(tiny_fused_config(), "cpu"), 0).eval()
    return model, _batch()


def _finite(rows, key="ms"):
    return all(r[key] is None or math.isfinite(r[key]) for r in rows)


def test_profile_stages_chain_gives_the_models_boxes():
    model, batch = _tiny()
    rows, out = profile_stages.profile_stages(model, batch, "cpu", iters=1, warmup=0,
                                              flops=True)
    boxes = out["boxes"]
    with torch.no_grad():
        want = model(batch)["boxes"]
    assert set(boxes) == set(want)
    for k in want:
        assert torch.equal(boxes[k], want[k]), k
    assert [r["stage"] for r in rows] == [
        "camera/backbone", "camera/neck", "camera/vtransform", "lidar/voxelize",
        "lidar/sparse_encoder", "fuser", "decoder/backbone", "decoder/neck", "head/forward",
        "head/decode"]
    for key in ("ms", "gflop", "tflops", "peak_share"):
        assert _finite(rows, key), key
    assert rows[0]["gflop"] > 0 and rows[4]["gflop"] > 0  # Swin's matmuls; the sparse convs


def test_profile_encoder_chain_gives_the_encoders_output():
    model, batch = _tiny()
    enc = model.encoders["lidar"]["backbone"]
    with torch.no_grad():
        vox = model.lidar_voxelize(batch["points"], batch["points_mask"])
        want = enc(vox.feats, vox.coords, vox.mask)
        rows, got = profile_encoder.profile_encoder(enc, vox.feats[0], vox.coords[0],
                                                    vox.mask[0], "cpu", iters=1, warmup=0)
    assert torch.equal(got, want)
    assert _finite(rows) and len(rows) > 10
    names = " ".join(r["op"] for r in rows)
    for piece in ("conv_input", "s0.0 subm conv1", "s1 strided conv", "s2 densify",
                  "dense conv3d", "conv_out"):
        assert piece in names, piece


def test_profile_encoder_times_an_all_sparse_encoder():
    """With no dense stage the encoder's ``conv_out`` runs sparse; the
    timed forward still gives the plain forward's output."""
    model, batch = _tiny()
    enc = copy.deepcopy(model.encoders["lidar"]["backbone"])
    enc.dense_from_stage = -1
    with torch.no_grad():
        vox = model.lidar_voxelize(batch["points"], batch["points_mask"])
        want = enc(vox.feats, vox.coords, vox.mask)
        rows, got = profile_encoder.profile_encoder(enc, vox.feats[0], vox.coords[0],
                                                    vox.mask[0], "cpu", iters=1, warmup=0)
    assert torch.equal(got, want) and _finite(rows)
    names = [r["op"] for r in rows]
    assert not any("dense" in n or "densify" in n for n in names), names
    assert sum("strided conv" in n for n in names) == 3 and "conv_out" in names[-1]


def test_profile_meta_times_the_port_ops_and_marks_the_tpu_only_ones_absent():
    model, batch = _tiny()
    enc = model.encoders["lidar"]["backbone"]
    with torch.no_grad():
        vox = model.lidar_voxelize(batch["points"], batch["points_mask"])
        stages = enc.sparse_sites(vox.coords[0], vox.mask[0])
        rows = profile_meta.profile_meta(enc, vox.coords[0], vox.mask[0], "cpu", iters=1,
                                         warmup=0)
    # dense_from_stage 3: stages 0-2 run sparse, the strided convs of 0 and 1 too
    assert [s["down"] is not None for s in stages] == [True, True, False]
    assert [s["channels"] for s in stages] == [4, 8, 16]
    absent = [r for r in rows if r["ms"] is None]
    assert absent and all(any(t in r["op"] for t in profile_meta.TPU_ONLY) for r in absent)
    timed = [r["op"] for r in rows if r["ms"] is not None]
    assert sum("build_subm_rulebook" in o for o in timed) == 3
    assert sum("downsample_sites" in o for o in timed) == 2
    assert sum("build_conv_transpose_rulebook" in o for o in timed) == 2
    assert _finite(rows)


@pytest.mark.parametrize("route", ["lut", "in_graph"])
def test_profile_vtransform_chain_gives_the_modules_output(route):
    model, batch = _tiny()
    if route == "in_graph":
        batch = {k: v for k, v in batch.items() if k != "pool_lut"}
    cam = model.encoders["camera"]
    img = batch["img"]
    with torch.no_grad():
        feats = cam["neck"](cam["backbone"](img.reshape(-1, *img.shape[2:])))[0]
        feats = feats.view(*img.shape[:2], *feats.shape[1:])
        want = cam["vtransform"](feats, batch["points"], batch["points_mask"], batch)
        rows, got = profile_vtransform.profile_vtransform(cam["vtransform"], feats, batch, "cpu",
                                                          iters=1, warmup=0)
    assert torch.equal(got, want)
    assert _finite(rows) and len(rows) == 9
    assert rows[-1]["op"].startswith("build_pool_lut on the host")


def test_bench_train_step_runs_two_steps():
    flag = load_config(flagship.FLAGSHIP_CONFIG)
    cfg = Config.from_dict({"model": tiny_fused_config(), "optimizer": flag.optimizer,
                            "optimizer_config": flag.optimizer_config,
                            "lr_config": flag.lr_config, "momentum_config": flag.momentum_config})
    model = flagship.init_weights(build_model(cfg.model, "cpu"), 0)
    res = bench_train_step.train_steps(cfg, model, _batch(training=True), "cpu", steps=2,
                                       warmup=0)
    assert len(res["losses"]) == 2 and all(math.isfinite(v) for v in res["losses"])
    assert res["optimizer_steps"] == 2 and not res["unchanged"]
    assert len(res["auction_ms"]) >= 2  # one matcher call per step and sample at least
    line = bench_train_step.result_line(res)
    assert {"metric", "value", "unit", "loss_total", "steps_per_s"} <= set(line)
    assert line["metric"] == "flagship_train_step_ms"
    assert all(math.isfinite(line[k]) for k in ("value", "loss_total", "steps_per_s",
                                                "forward_ms", "backward_ms", "optimizer_ms"))


def test_bench_train_step_main_takes_a_centerhead_config(tmp_path, capsys):
    """``--config`` with a tiny camera CenterHead detector (AwareBEVDepth, so
    the step adds the depth loss): one JSON line, the metric named after the
    file, no matcher."""
    from tests.test_torch_camera_det_model import tiny_det_config

    flag = load_config(flagship.FLAGSHIP_CONFIG)
    path = tmp_path / "tiny_bevdepth.yaml"
    path.write_text(json.dumps({  # JSON is YAML
        "image_size": [32, 64], "point_cloud_range": [-16.0, -16.0, -5.0, 16.0, 16.0, 3.0],
        "model": tiny_det_config("bevdepth"), "optimizer": dict(flag.optimizer),
        "optimizer_config": dict(flag.optimizer_config), "lr_config": dict(flag.lr_config)}))
    assert bench_train_step.main(["--config", str(path), "--device", "cpu", "--steps", "1",
                                  "--points", "3000"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "tiny_bevdepth_train_step_ms" and line["auction_ms"] is None
    assert all(math.isfinite(line[k]) for k in ("value", "loss_total", "forward_ms"))


def test_benchmark_latency_on_the_cpu():
    model, batch = _tiny()
    r = benchmark.latency(model, batch, "cpu", iters=2, warmup=1)
    assert len(r["frames_ms"]) == 2 and math.isfinite(r["mean_ms"]) and r["fps"] > 0


@pytest.mark.parametrize("config,batch_size,error,match", [
    ("configs/nuscenes/det/centerhead/lssfpn/camera+radar/resnet50/dlss.yaml", 1, ValueError,
     r"depth branch gives 32 x 88 .* 16 x 44"),
    ("addfuser", 1, NotImplementedError, "not ported: fuser: AddFuser"),
    (None, 2, NotImplementedError, "batch size 2"),
])
def test_benchmark_raises_for_what_the_port_does_not_build(config, batch_size, error, match,
                                                           tmp_path):
    if config == "addfuser":  # every config's modules are ported: a made one names a type
        config = tmp_path / "addfuser.yaml"  # the port lacks
        config.write_text("model:\n  type: BEVFusion\n  fuser:\n    type: AddFuser\n"
                          "    in_channels: [80, 256]\n    out_channels: 256\n")
    with pytest.raises(error, match=match):
        benchmark.build(None if config is None else str(config), "cpu", batch_size=batch_size)


def test_bench_iou_compares_another_checkouts_iou_3d():
    """``--compare`` with this checkout as the other: the same IoUs, and a
    finite time for each version and shape."""
    other = bench_iou.load_other(str(Path(__file__).resolve().parents[1]))
    rows = bench_iou.bench([("matcher", 12, 5), ("nms", 9, 9)], "cpu", iters=2, warmup=1,
                           other=other)
    assert [r["max_abs_diff"] for r in rows] == [0.0, 0.0]
    assert _finite(rows) and _finite(rows, "other_ms")
    boxes = torch.from_numpy(bench_iou.random_boxes(9, 0))
    assert torch.allclose(bench_iou.iou3d.iou_3d(boxes, boxes).diagonal(), torch.ones(9))


@pytest.mark.parametrize("tool", TOOLS)
def test_every_tool_runs_on_the_card_unless_told_otherwise(tool):
    """``main`` defaults to the card; with no CUDA it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"bevfusion_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main([])
