"""The port's eval loop (bevfusion_tpu_torch/runtime/eval.py) and eval CLI
(bevfusion_tpu_torch/tools/test.py) against the JAX package's, on files.

A synthesized nuScenes-format set (``data/synthetic.py``: two cameras of
64 x 128 PNGs, a keyframe and two sweeps as ``.bin``, a jittered rig with
no frustum point within 1e-4 m of a BEV cell boundary) goes through each
package's dataset, loader and ``evaluate_dataset`` with the same weights
(JAX variables carried across by the bridge) on the tiny models of
tests/test_bevfusion_model.py: the fused map-segmentation model and the
fused TransFusion detector. Its map targets come from a test-only
pipeline step (cells hit by points, cells of box centres), so the IoU
sweep has something to count. Checked:

- masks within 1e-5 (max |d|), boxes, scores and labels within 1e-5
  relative where the JAX scores are apart (a tie may decode either way);
- ``to_model_batch`` gives ``synthetic_batch``'s layout;
- the two-rank merge (``collect_results_cpu``) in dataset order, in one
  process and across processes, and with uneven shards;
- the CLI on the CPU with its overrides: the JAX path's map metrics;
  ``--eval bbox`` writes the submission and raises the devkit's
  ImportError.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bevfusion_tpu.config import load_config as jax_load_config
from bevfusion_tpu.data import DataLoader as JaxDataLoader
from bevfusion_tpu.data import build_dataset as jax_build_dataset
from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu.runtime import eval as jax_eval
from bevfusion_tpu_torch.config import load_config
from bevfusion_tpu_torch.data import DataLoader, build_dataset, synthetic
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.models.vtransforms import lss_constants
from bevfusion_tpu_torch.runtime import eval as peval
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from bevfusion_tpu_torch.runtime.checkpoint import save_checkpoint
from bevfusion_tpu_torch.tools import test as test_cli
from tests.test_bevfusion_model import tiny_fused_config
from tests.torch_port_helpers import EVAL_RIG_SEED as RIG_SEED
from tests.torch_port_helpers import (MATS, PCR, boundary_margin, random_variables, rel_err,
                                      tiny_config)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _set(root):
    """Three samples under ``root``; asserts the rig keeps every frustum
    point off the cell boundaries."""
    synthetic.write_synthetic_nuscenes(
        root, num_samples=3, num_cameras=2, image_hw=(64, 128), points_per_sweep=64,
        num_sweeps=2, point_cloud_range=PCR, num_gt=4, seed=1, rig_seed=RIG_SEED, focal=0.47)
    return root


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    return _set(str(tmp_path_factory.mktemp("nusc")))


def _datasets(root, head):
    cfg = tiny_config(head)
    cfg["dataset_root"] = root + "/"
    path = os.path.join(root, f"{head}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return (build_dataset(load_config(path).data.test),
            jax_build_dataset(jax_load_config(path).data.test), path)


@functools.lru_cache(maxsize=None)
def _jax_eval(root, head):
    """The JAX package's evaluate_dataset on the set: (variables, the
    per-sample results its metric got, the metric)."""
    _, jds, _ = _datasets(root, head)
    batch = next(iter(JaxDataLoader(jds, 1, num_workers=1, drop_last=False)))
    vt = tiny_fused_config()["encoders"]["camera"]["vtransform"]
    dx, bx, nx, frustum = lss_constants(vt["image_size"], vt["feature_size"], vt["xbound"],
                                        vt["ybound"], vt["zbound"], vt["dbound"])
    for i in range(len(jds)):
        sample = jds[i]
        assert boundary_margin(frustum, dx, bx, nx, {k: sample[k][None] for k in MATS}) > 1e-4
    jm = jax_build_model(tiny_fused_config(head=head))
    init_batch = {k: jnp.asarray(v) for k, v in batch.items()
                  if k not in ("metas", "gt_masks_bev")}
    variables = random_variables(jm.init, init_batch, seed=12)
    if head == "object":
        variables["params"]["head_modules_object"]["heatmap_conv1"]["conv"]["kernel"] *= 0.2
    seen = []
    metric = "map" if head == "map" else "bbox"
    evaluate = jds.evaluate_map if head == "map" else (lambda results, out_dir: {})
    name = "evaluate_map" if head == "map" else "evaluate_detection"
    setattr(jds, name, lambda results, *a: seen.append(results) or evaluate(results, *a))
    loader = JaxDataLoader(jds, 1, num_workers=2, drop_last=False)
    metrics = jax_eval.evaluate_dataset(jm, variables, jds, loader, metric=metric,
                                        out_dir=os.path.join(root, "jax_eval"))
    return variables, seen[0], metrics


def _port_model(root, head):
    variables, *_ = _jax_eval(root, head)
    model = build_model(tiny_fused_config(head=head), "cpu")
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    return model


def _port_eval(root, head, world=1):
    """The port's evaluate_dataset on the set, over ``world`` ranks in this
    process (the high ranks first): (results, metric)."""
    pds, *_ = _datasets(root, head)
    model = _port_model(root, head)
    seen = []
    evaluate = pds.evaluate_map if head == "map" else (lambda results, out_dir: {})
    name = "evaluate_map" if head == "map" else "evaluate_detection"
    setattr(pds, name, lambda results, *a: seen.append(results) or evaluate(results, *a))
    tmpdir = os.path.join(root, f"parts_{head}_{world}")
    for rank in reversed(range(world)):
        loader = DataLoader(pds, 1, num_workers=2, drop_last=False, num_shards=world,
                            shard_id=rank)
        metrics = peval.evaluate_dataset(model, pds, loader, metric="map" if head == "map"
                                         else "bbox", rank=rank, world=world, tmpdir=tmpdir)
        assert (metrics is None) == (rank > 0)
    return seen[0], metrics


def test_seg_eval_matches_jax(nusc_root):
    _, want, want_metrics = _jax_eval(nusc_root, "map")
    got, metrics = _port_eval(nusc_root, "map")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"masks_bev", "gt_masks_bev"}
        assert g["masks_bev"].shape == w["masks_bev"].shape == (2, 16, 16)
        assert np.abs(g["masks_bev"] - w["masks_bev"]).max() <= RTOL
        np.testing.assert_array_equal(g["gt_masks_bev"], w["gt_masks_bev"])
        assert 0.05 < w["gt_masks_bev"].mean() < 0.9 and np.std(w["masks_bev"]) > 0.05
    assert metrics == want_metrics and 0 < metrics["map/mean/iou@max"] < 1


def test_detection_eval_matches_jax(nusc_root):
    _, want, _ = _jax_eval(nusc_root, "object")
    got, _ = _port_eval(nusc_root, "object")
    assert len(got) == len(want) == 3
    kept = 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"boxes_3d", "scores_3d", "labels_3d"}
        assert g["boxes_3d"].shape == w["boxes_3d"].shape and g["boxes_3d"].shape[1] == 9
        s = w["scores_3d"]
        gaps = np.abs(s[:, None] - s[None, :]) + np.eye(len(s))
        apart = gaps.min(1) > 1e-3
        kept += apart.sum()
        np.testing.assert_array_equal(g["labels_3d"][apart], w["labels_3d"][apart])
        for key in ("boxes_3d", "scores_3d"):
            assert rel_err(g[key][apart], np.asarray(w[key])[apart]) <= RTOL, key
    assert kept >= 8


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_eval_merges_in_dataset_order(nusc_root, world):
    """2 and 3 ranks over 3 samples (the 2-rank shards uneven): the merged
    results are the one-rank results, in dataset order."""
    one, metrics = _port_eval(nusc_root, "map")
    got, merged_metrics = _port_eval(nusc_root, "map", world=world)
    assert len(got) == 3 and merged_metrics == metrics
    for g, w in zip(got, one):
        np.testing.assert_array_equal(g["masks_bev"], w["masks_bev"])


def test_to_model_batch_has_the_synthetic_batch_layout(nusc_root):
    pds, *_ = _datasets(nusc_root, "map")
    np_batch = next(iter(DataLoader(pds, 2, num_workers=1, drop_last=False)))
    np_batch.pop("metas", None)
    gt = np_batch.pop("gt_masks_bev")
    batch = peval.to_model_batch(np_batch, "cpu")
    want = flagship.synthetic_batch(load_config(flagship.FLAGSHIP_CONFIG), B=2, num_points=512)
    assert set(want) <= set(batch)
    for k, v in want.items():  # the same keys, dtypes and axes (two cameras here, not six)
        assert batch[k].dtype == v.dtype and batch[k].dim() == v.dim(), k
        assert batch[k].shape[0] == 2 and batch[k].shape[-1] == v.shape[-1] or k == "img", k
    assert tuple(batch["img"].shape) == (2, 2, 3, 32, 64)  # [B, N, 3, H, W]
    assert tuple(batch["points"].shape) == (2, 512, 5) and batch["lidar2ego"].shape == (2, 4, 4)
    np.testing.assert_array_equal(batch["img"].permute(0, 1, 3, 4, 2).numpy(), np_batch["img"])
    assert gt.shape == (2, 2, 16, 16)


class _Passthrough(torch.nn.Module):
    """``masks_bev`` = the image's first channel: the sample's index."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(1))

    def forward(self, batch):
        return {"masks_bev": batch["img"][:, 0, :1] * self.w}


class _IndexSet:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"img": np.full((1, 4, 4, 1), float(i), np.float32),
                "gt_masks_bev": np.zeros((1, 4, 4), bool)}

    def evaluate_map(self, results):
        ok = [int(round(float(r["masks_bev"][0, 0, 0]))) == i for i, r in enumerate(results)]
        return {"order_ok": float(np.mean(ok)), "n": float(len(results))}


@pytest.mark.parametrize("n", [8, 7])
def test_evaluate_dataset_two_rank_merge(tmp_path, n):
    """As tests/test_multiprocess_eval.py does for the JAX package: rank 1 writes
    its part first, rank 0 merges and runs the metric; with 7 samples the
    shards are uneven and the merge still holds all of them."""
    ds, model = _IndexSet(n), _Passthrough()
    tmpdir = str(tmp_path / "parts")
    for rank in (1, 0):
        loader = DataLoader(ds, 1, num_workers=1, drop_last=False, num_shards=2, shard_id=rank)
        out = peval.evaluate_dataset(model, ds, loader, metric="map", rank=rank, world=2,
                                     tmpdir=tmpdir)
    assert out == {"order_ok": 1.0, "n": float(n)}


def test_collect_results_across_processes(tmp_path):
    """Ranks 1 and 2 in their own processes (the atomic rename); rank 0
    polls, merges in dataset order and truncates."""
    n, world = 11, 3
    assert sorted(i for r in range(world) for i in peval.shard_indices(n, r, world)) == list(
        range(n))
    assert [list(peval.shard_indices(n, r, world)) for r in range(world)] == [
        list(jax_eval.shard_indices(n, r, world)) for r in range(world)]
    code = ("import sys; sys.path.insert(0, {root!r})\n"
            "from bevfusion_tpu_torch.runtime.eval import collect_results_cpu\n"
            "rank = int(sys.argv[1])\n"
            "collect_results_cpu([('s', i) for i in range({n}) if i % {w} == rank], {n},"
            " sys.argv[2], rank, {w})\n").format(root=ROOT, n=n, w=world)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(tmp_path)])
             for r in (1, 2)]
    merged = peval.collect_results_cpu([("s", i) for i in range(0, n, world)], n,
                                       str(tmp_path), 0, world)
    assert all(p.wait(timeout=120) == 0 for p in procs)
    assert merged == [("s", i) for i in range(n)]


def _save_bridged(root, head):
    ckpt = os.path.join(root, f"{head}_ckpt", "epoch_1.pth")
    save_checkpoint(ckpt, _port_model(root, head), meta={"epoch": 1})
    return ckpt


def test_cli_applies_overrides_and_matches_jax(nusc_root, tmp_path, capsys):
    """tools/test.py on the CPU: the config's dataset root points nowhere,
    the override points it at the set; the map metrics are the JAX
    path's. Without the override the run fails to find the info pkl."""
    _, _, want = _jax_eval(nusc_root, "map")
    _, _, path = _datasets(nusc_root, "map")
    cfg = yaml.safe_load(open(path))
    cfg["dataset_root"] = str(tmp_path / "missing") + "/"
    bad = str(tmp_path / "tiny_map.yaml")
    with open(bad, "w") as f:
        yaml.safe_dump(cfg, f)
    ckpt = _save_bridged(nusc_root, "map")
    argv = [bad, ckpt, "--eval", "map", "--device", "cpu", "--out-dir", str(tmp_path / "out")]
    with pytest.raises(FileNotFoundError):
        test_cli.main(argv)
    metrics = test_cli.main(argv + [f"dataset_root={nusc_root}/"])
    assert metrics == want
    printed = capsys.readouterr().out
    assert f"map/mean/iou@max: {want['map/mean/iou@max']:.4f}" in printed
    assert test_cli.parse_overrides(["a.b=1", "c=[1, 2]", "d=x"]) == {
        "a.b": 1, "c": [1, 2], "d": "x"}


def test_cli_bbox_writes_the_submission_then_needs_the_devkit(nusc_root, tmp_path):
    """--eval bbox on the tiny detector: results_nusc.json with the three
    tokens, then the nuScenes devkit's ImportError (the devkit is not
    installed here), not swallowed."""
    _, _, path = _datasets(nusc_root, "object")
    out = tmp_path / "out"
    try:
        import nuscenes  # noqa: F401
        has_devkit = True
    except ImportError:
        has_devkit = False
    argv = [path, _save_bridged(nusc_root, "object"), "--eval", "bbox", "--device", "cpu",
            "--out-dir", str(out)]
    with pytest.raises(Exception) as err:
        test_cli.main(argv)
    if not has_devkit:
        assert isinstance(err.value, ImportError)
    import json

    sub = json.load(open(out / "results_nusc.json"))
    assert set(sub["results"]) == {f"synthetic_1_{i:04d}" for i in range(3)}
    assert all(np.isfinite(a["translation"]).all() for v in sub["results"].values() for a in v)


def test_cli_refuses_the_card_without_one(nusc_root):
    if torch.cuda.is_available():
        return
    _, _, path = _datasets(nusc_root, "map")
    with pytest.raises(RuntimeError, match="cuda"):
        test_cli.main([path, "unused.pth", "--eval", "map"])


def test_cli_two_processes_merge_through_torch_distributed(nusc_root, tmp_path):
    """tools/test.py as torchrun starts it: two CPU processes (gloo, the
    rendezvous on localhost), each evaluating its shard of the three
    samples; rank 0 merges and reports the one-process metrics. A stale
    part left in the parts directory by an earlier run is cleared first."""
    import socket

    _, _, want = _jax_eval(nusc_root, "map")
    _, _, path = _datasets(nusc_root, "map")
    ckpt = _save_bridged(nusc_root, "map")
    out = tmp_path / "out"
    os.makedirs(out / "parts")
    with open(out / "parts" / "part_1.pkl", "wb") as f:  # a stale part of another run
        f.write(b"stale")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("import sys, json; sys.path.insert(0, {root!r})\n"
            "import torch; torch.set_num_threads(1)\n"
            "import tests.test_torch_eval\n"  # registers the test-only map targets
            "from bevfusion_tpu_torch.tools import test\n"
            "m = test.main(sys.argv[1:])\n"
            "print('METRICS', json.dumps(m))\n").format(root=ROOT)
    argv = [path, ckpt, "--eval", "map", "--device", "cpu", "--out-dir", str(out)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code] + argv, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port), JAX_PLATFORMS="cpu"))
        for r in (0, 1)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    import json

    got = [json.loads(line.split(" ", 1)[1]) for o in outs for line in o.splitlines()
           if line.startswith("METRICS")]
    assert got[0] == want and got[1] is None
