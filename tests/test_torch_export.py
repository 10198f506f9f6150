"""``tools/export.py`` on the tiny fused model on the CPU.

The eval boxes of the tiny fused TransFusion detector (the JAX variables
carried across, as tests/test_torch_fused_model.py does, the host pooling
LUT) exported through ``torch.export`` at fp32 and at bf16 autocast: the
graph holds one ``bevfusion::`` node a hand kernel (the encoder's 15 sparse
convs, on the bf16 op at bf16, and one pool), ``torch.export.save`` ->
``load`` -> run gives the eager boxes bit for bit, and the fp32 boxes are
the JAX model's at that test's tolerance. A batch size other than 1 and a
leaf that is not a tensor raise.
"""
import numpy as np
import pytest
import torch

from bevfusion_tpu_torch.config import Config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.ops import library
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from bevfusion_tpu_torch.tools import export
from tests.test_torch_fused_model import _jax_run
from tests.torch_port_helpers import rel_err

torch.set_num_threads(2)

RTOL = 2.5e-3  # tests/test_torch_fused_model.py: the sparse encoder's bound
WANT_OPS = {"float32": {"sparse_conv": 15, "bev_pool": 1},
            "bfloat16": {"sparse_conv_bf16": 15, "bev_pool": 1}}


def _model_and_batch(dtype):
    cfg, batch, variables, _, want_boxes = _jax_run()
    model = build_model(cfg, "cpu", dtype=dtype)
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tbatch["img"] = tbatch["img"].permute(0, 1, 4, 2, 3).contiguous()
    return model, flagship.add_pool_lut(Config.from_dict({"model": cfg}), tbatch), want_boxes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_save_load_run_is_eager_and_holds_the_ops(tmp_path, dtype):
    model, batch, want_boxes = _model_and_batch(dtype)
    ep = export.export_model(model, batch)
    assert library.op_counts(ep.graph_module) == dict(
        {name: 0 for name in library.OPS}, **WANT_OPS[dtype])
    path = str(tmp_path / "sub" / "model.pt2")
    assert export.save(ep, path) > 0
    with torch.no_grad():
        eager = model(batch)["boxes"]
        loaded = torch.export.load(path)
        got = loaded.module()(batch)
    assert library.op_counts(loaded.graph_module) == library.op_counts(ep.graph_module)
    assert set(got) == {"bboxes", "scores", "labels", "mask"}
    for k in got:
        assert got[k].dtype == eager[k].dtype and torch.equal(got[k], eager[k]), k
    if dtype == "float32":  # the JAX model's boxes where its ranked scores are apart
        s = want_boxes["scores"][0]
        apart = (np.abs(s[:, None] - s[None, :]) + np.eye(len(s))).min(1) > 1e-3
        assert apart.sum() >= len(s) // 2
        np.testing.assert_array_equal(got["labels"][0].numpy()[apart],
                                      want_boxes["labels"][0][apart])
        for key in ("bboxes", "scores"):
            assert rel_err(got[key][0].numpy()[apart], want_boxes[key][0][apart]) <= RTOL


def test_export_refuses_what_it_does_not_take():
    with pytest.raises(NotImplementedError):
        export.main(["--batch-size", "2", "--device", "cpu"])
    model, batch, _ = _model_and_batch("float32")
    with pytest.raises(TypeError, match="meta"):
        export.export_model(model, dict(batch, meta=3))
    model.heads = torch.nn.ModuleDict({"map": torch.nn.Identity()})
    with pytest.raises(NotImplementedError):  # no object head, no boxes
        export.BoxesForward(model)
