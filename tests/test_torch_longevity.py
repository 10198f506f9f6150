"""``tools/train_longevity.py`` on the tiny fused model on the CPU: six
steps over one cyclic schedule with a resume probe of two steps at mid-run
(bit-identical), the loss curve equal bit for bit to six calls of
``runtime/train.py:make_train_step`` driven by hand (the probe moves
nothing), the JSON's keys, and the BatchNorm norm and the probe's fallback
gaps on known tensors; the probe's fallback rule on a toy run whose steps
differ run to run: a sound restore passes it, a restore that loses AdamW's
first moment is refused."""
import math

import pytest

import numpy as np
import torch

from bevfusion_tpu_torch.config import Config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.runtime import flagship, train
from bevfusion_tpu_torch.tools import train_longevity as tl
from tests.test_bevfusion_model import make_batch, tiny_fused_config

torch.set_num_threads(2)

STEPS, PROBE, LR = 6, 2, 1e-3
LR_CONFIG = {"policy": "cyclic"}


def _scenes(cfg):
    out = []
    for seed in (0, 1):
        b = {k: torch.from_numpy(np.array(v))
             for k, v in make_batch(B=1, N=2, P=256, G=3, seed=seed).items()}
        b["img"] = b["img"].permute(0, 1, 4, 2, 3).contiguous()
        out.append(flagship.add_pool_lut(Config.from_dict({"model": cfg}), b))
    return out


def _model(cfg):
    return flagship.init_weights(build_model(cfg, "cpu"), 0)


def test_longevity_run_holds_its_probe_and_the_hand_driven_steps(tmp_path):
    cfg = tiny_fused_config()
    batches = _scenes(cfg)
    res = tl.run(_model(cfg), batches, STEPS, LR_CONFIG, LR, PROBE, "cpu",
                 str(tmp_path / "ckpt"), log=lambda s: None)
    assert res["resume_bit_identical"] is True
    assert res["resume_rule"] == "bit-identical under deterministic algorithms"
    assert res["resume_probe"]["bit_equal_tensors"] == res["resume_probe"]["tensors"]
    assert (tmp_path / "ckpt" / f"step_{STEPS // 2 + 1}").exists()
    assert len(res["losses"]) == STEPS and all(map(math.isfinite, res["losses"]))
    assert res["loss_curve_every20"] == res["losses"][::20]
    assert res["loss_first"] == res["losses"][0] and res["loss_last"] == res["losses"][-1]
    assert res["launches_per_step"] == {name: 0 for name in tl.COUNTERS}  # the CPU: plain
    assert "drop no neighbour" in res["window_overflow"]
    assert res["lr_schedule"].startswith("cyclic")

    model = _model(cfg)
    opt = train.build_optimizer({"weight_decay": 0.01}, train.build_lr_schedule(
        LR_CONFIG, LR, STEPS), model, grad_clip={"max_norm": 35})
    step = train.make_train_step(model, opt, "cpu")
    want = [float(step(batches[i % 2])["loss/total"]) for i in range(STEPS)]
    assert res["losses"] == want


def test_bn_norm_and_part_gaps():
    bn = torch.nn.BatchNorm1d(3)
    bn.running_mean.fill_(2.0)
    bn.running_var.fill_(1.0)
    assert tl.bn_norm(torch.nn.Sequential(bn)) == math.sqrt(3 * 4 + 3 * 1)
    ref = {"param/a": torch.tensor([3.0, 4.0]), "nu/a": torch.tensor([1.0])}
    got = {"param/a": torch.tensor([3.0, 4.5]), "nu/a": torch.tensor([1.0])}
    assert tl.part_gaps(got, ref) == {"param": 0.1, "nu": 0.0}


def _noisy_run(noise: float):
    """A toy model, its AdamW and a step whose input carries ``noise`` drawn
    afresh on every call, so two runs of the same steps differ (as the
    card's atomics make them), after three steps that fill the moments."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    opt = train.build_optimizer({"weight_decay": 0.01}, lambda t: 1e-2, model,
                                grad_clip={"max_norm": 35})
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    rng = torch.Generator().manual_seed(2)

    def one(i: int) -> float:
        opt.zero_grad()
        loss = (model(x + noise * torch.randn(x.shape, generator=rng)) ** 2).mean()
        loss.backward()
        opt.step()
        return float(loss.detach())

    for i in range(3):
        one(i)
    return model, opt, one


def test_probe_fallback_passes_a_sound_restore(tmp_path):
    model, opt, one = _noisy_run(1e-3)
    out = tl.probe(model, opt, one, 3, PROBE, str(tmp_path))
    assert out["bit_identical"] is False and out["rule"].startswith("2x the mean")
    assert all(out["gaps"][p] > 0 for p in ("param", "mu", "nu"))


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_probe_refuses_a_restore_that_loses_the_first_moment(tmp_path, monkeypatch, noise):
    """The reruns start from the state held in memory, so a fault of the
    restore moves B alone and the fallback cannot excuse it."""
    restore = tl.restore_checkpoint

    def lossy(path, model, opt=None):
        meta = restore(path, model, opt)
        if opt is not None:
            for t in opt.mu:
                t.zero_()
        return meta

    monkeypatch.setattr(tl, "restore_checkpoint", lossy)
    model, opt, one = _noisy_run(noise)
    with pytest.raises(AssertionError, match="resume probe"):
        tl.probe(model, opt, one, 3, PROBE, str(tmp_path))
