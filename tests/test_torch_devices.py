"""The port's entry points run on the card unless the caller asks for the
CPU: ``device`` defaults to ``"cuda"``, and without CUDA the default
raises instead of falling back to the CPU."""
import inspect

import pytest
import torch
import torch.nn as nn

from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.runtime import flagship, train
from tests.test_bevfusion_model import tiny_fused_config

torch.set_num_threads(2)


def _calls():
    """(entry point, a call of it that leaves ``device`` at its default)."""
    model = nn.Linear(2, 2)
    opt = train.AdamW(model.named_parameters(), lambda t: 1e-3)
    return [
        (build_model, lambda: build_model(tiny_fused_config())),
        (flagship.build_flagship, lambda: flagship.build_flagship(num_points=100)),
        (flagship.build_flagship, lambda: flagship.build_flagship(num_points=100,
                                                                  training=True)),
        (flagship.build_lidar_slice, lambda: flagship.build_lidar_slice(num_points=100)),
        (train.make_train_step, lambda: train.make_train_step(model, opt)),
    ]


@pytest.mark.parametrize("i", range(5))
def test_entry_point_defaults_to_the_card(i):
    fn, call = _calls()[i]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_cpu_is_taken_only_when_asked():
    model = build_model(tiny_fused_config(), "cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
