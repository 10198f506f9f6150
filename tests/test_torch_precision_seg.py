"""The bf16 parity of tests/test_torch_precision_models.py for the tiny
fused map-segmentation model and the tiny ResNet camera CenterHead
detector (a file of its own: the JAX compiles of two models at two dtypes
take most of its time). Measured on the CPU: the port's bf16 gap to JAX
fp32 is 1.1-1.2x the JAX bf16 gap for the seg model (BEV map and logits)
and 1.8-2.3x for the CenterHead model (ResNet-50's residual sums), against
the multiple of 3 held."""
import pytest
import torch

from tests.test_torch_precision_models import assert_bf16_gaps

torch.set_num_threads(2)


@pytest.mark.parametrize("kind", ["fused-seg", "centerhead-resnet"])
def test_port_bf16_is_as_close_to_jax_fp32_as_jax_bf16(kind):
    assert_bf16_gaps(kind)
