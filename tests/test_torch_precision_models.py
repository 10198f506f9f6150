"""Whole tiny models at bf16 in both packages: the port's bf16 policy
against the JAX package's ``dtype=bfloat16``.

Three tiny models (the fused detector of tests/test_bevfusion_model.py,
the fused map-segmentation model of tests/test_torch_seg_model.py and the
ResNet camera CenterHead detector of tests/test_torch_camera_det_model.py)
are built in both packages with the same random weights (JAX variables
carried across by the bridge) and run at eval on a jittered rig: JAX at
fp32 (the reference) and at bf16, the port at bf16. Compared before any
top-k: the BEV map into the head (the decoder neck's first map) and the
head's logits (the dense heatmap, the seg classifier's logits, every
CenterHead task's heatmap), as relative gaps in norm, ``||x - ref|| /
||ref||`` against the JAX fp32 output. Held: the port at bf16 is no
further from the JAX fp32 output than ``GAP_MULTIPLE`` times the JAX bf16
output's own gap (both are printed), and is a real bf16 run (its gap above
``MIN_GAP``). A bf16 run rounds each layer's output and weights to 8
significant bits at other places in the two packages (the JAX package
rounds the sparse convs' outputs before their BatchNorm, the port once
after the fused epilogue; the port keeps the attention logits and the
query positions fp32 where the JAX package rounds q * scale and the
centers), so the two bf16 gaps are of one size, not equal.

Also pinned: the JAX bf16 detector's decoded boxes are bf16 (its decode
fault, tests/test_torch_precision.py), the port's are fp32 and within
1e-5 of the port's decode of the same raw predictions in float64.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu_torch.config import Config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from tests.test_bevfusion_model import make_batch, tiny_fused_config
from tests.test_torch_camera_det_model import _jax_run as det_jax_run
from tests.test_torch_camera_det_model import tiny_det_config
from tests.test_torch_seg_model import _batch as seg_batch
from tests.test_torch_seg_model import tiny_seg_config
from tests.torch_port_helpers import jittered_rig, random_variables

torch.set_num_threads(2)

RIG_SEED = 9  # a jitter whose frustum points all keep >= 1e-4 m from cell boundaries
GAP_MULTIPLE = 3.0
MIN_GAP = 1e-4  # a bf16 run's gap is ~1e-3 or more; fp32 ones are ~1e-6
# the last two run in tests/test_torch_precision_seg.py
KINDS = ("fused-det", "fused-seg", "centerhead-resnet")


def _config(kind):
    return {"fused-det": tiny_fused_config, "fused-seg": lambda: tiny_seg_config("fused"),
            "centerhead-resnet": lambda: tiny_det_config("resnet")}[kind]()


def _inputs(kind):
    """(numpy eval batch, variables) of the kind's tiny model."""
    cfg = _config(kind)
    if kind == "centerhead-resnet":
        batch, variables, *_ = det_jax_run("resnet")  # heads moderated as that test has them
        return batch, variables
    if kind == "fused-seg":
        batch = {k: v for k, v in seg_batch("fused").items() if k != "gt_masks_bev"}
    else:
        batch = {k: np.asarray(v) for k, v in make_batch().items() if not k.startswith("gt_")}
        batch.update(jittered_rig(batch, RIG_SEED))
    variables = random_variables(jax_build_model(cfg).init, batch, seed=12)
    if kind == "fused-det":
        variables["params"]["head_modules_object"]["heatmap_conv1"]["conv"]["kernel"] *= 0.2
    return batch, variables


def _captured(module, method):
    return method == "__call__" and module.name in ("decoder_neck", "head_modules_object",
                                                    "cls2")


def _nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


@functools.lru_cache(maxsize=None)
def _jax(kind, dtype):
    """The JAX model's (BEV map into the head, [logits maps], boxes or None)
    at ``dtype``, NCHW fp32 numpy."""
    batch, variables = _inputs(kind)
    jm = jax_build_model(_config(kind), dtype=dtype)

    @jax.jit
    def run(v, b):
        out, inter = jm.apply(v, b, capture_intermediates=_captured, mutable=["intermediates"])
        return out, inter["intermediates"]

    out, inter = run(variables, batch)
    bev = inter["decoder_neck"]["__call__"][0]
    bev = bev[0] if isinstance(bev, (list, tuple)) else bev
    if kind == "fused-seg":
        logits = [inter["head_modules_map"]["cls2"]["__call__"][0]]
    else:
        preds = inter["head_modules_object"]["__call__"][0]
        logits = ([preds["dense_heatmap"]] if kind == "fused-det"
                  else [p["heatmap"] for p in preds])
    boxes = out.get("boxes")
    return _nchw(bev), [_nchw(x) for x in logits], boxes


@functools.lru_cache(maxsize=None)
def _port(kind, dtype=torch.bfloat16):
    """The port's (BEV map into the head, [logits maps], boxes, raw head
    predictions) at ``dtype``, fp32 numpy maps."""
    batch, variables = _inputs(kind)
    cfg = _config(kind)
    model = build_model(cfg, "cpu", dtype)
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 1, 4, 2, 3).contiguous()  # NHWC -> [B, N, 3, H, W]
    tb = flagship.add_pool_lut(Config.from_dict({"model": cfg}), tb)
    seen = {}

    def keep(name):
        return lambda mod, args, out: seen.setdefault(name, out)

    hooks = [model.decoder["neck"].register_forward_hook(keep("bev"))]
    if kind == "fused-seg":
        hooks.append(model.heads["map"].classifier.register_forward_hook(keep("logits")))
    else:
        hooks.append(model.heads["object"].register_forward_hook(keep("preds")))
    with torch.no_grad():
        out = model(tb)
    for h in hooks:
        h.remove()
    bev = seen["bev"][0] if isinstance(seen["bev"], (list, tuple)) else seen["bev"]
    if kind == "fused-seg":
        logits = [seen["logits"]]
    elif kind == "fused-det":
        logits = [seen["preds"]["dense_heatmap"]]
    else:
        logits = [p["heatmap"] for p in seen["preds"]]
    return (bev.float().numpy(), [x.float().numpy() for x in logits], out.get("boxes"),
            seen.get("preds"), model)


def _gap(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def assert_bf16_gaps(kind):
    """The port's bf16 gap to JAX fp32 within ``GAP_MULTIPLE`` x JAX bf16's,
    for the BEV map into the head and every logits map; both printed."""
    ref_bev, ref_logits, _ = _jax(kind, jnp.float32)
    j_bev, j_logits, _ = _jax(kind, jnp.bfloat16)
    p_bev, p_logits, *_ = _port(kind)
    pairs = [("BEV into the head", p_bev, j_bev, ref_bev)]
    pairs += [(f"logits {i}", p, j, r) for i, (p, j, r) in
              enumerate(zip(p_logits, j_logits, ref_logits))]
    for what, p, j, r in pairs:
        assert p.shape == j.shape == r.shape, what
        assert np.std(r) > 0.05, what  # real maps, not a plateau
        port_gap, jax_gap = _gap(p, r), _gap(j, r)
        print(f"{kind} {what}: port bf16 {port_gap:.3e}, JAX bf16 {jax_gap:.3e} from JAX fp32")
        assert MIN_GAP < port_gap <= GAP_MULTIPLE * jax_gap, (what, port_gap, jax_gap)


def test_port_bf16_detector_is_as_close_to_jax_fp32_as_jax_bf16():
    assert_bf16_gaps("fused-det")


def test_port_fp32_stays_at_fp32_parity():
    """The same comparison at fp32: the port's fp32 path is unchanged by the
    policy (its gap to JAX fp32 a rounding-level one)."""
    ref_bev, ref_logits, _ = _jax("fused-det", jnp.float32)
    p_bev, p_logits, *_ = _port("fused-det", torch.float32)
    assert _gap(p_bev, ref_bev) < MIN_GAP and _gap(p_logits[0], ref_logits[0]) < MIN_GAP


def test_decoded_boxes_bf16_in_jax_fp32_in_the_port():
    _, _, jax_boxes = _jax("fused-det", jnp.bfloat16)
    assert jax_boxes["bboxes"].dtype == jnp.bfloat16  # the JAX decode fault
    _, _, boxes, preds, model = _port("fused-det")
    assert preds["center"].dtype == torch.float32  # the positions added in fp32
    assert preds["heatmap"].dtype == torch.bfloat16  # the rest at the compute dtype
    assert boxes["bboxes"].dtype == boxes["scores"].dtype == torch.float32
    with torch.no_grad():
        f64 = model.heads["object"].get_bboxes(
            {k: v.double() if v.is_floating_point() else v for k, v in preds.items()})
    for key in ("bboxes", "scores"):
        want = f64[key].float()
        assert (boxes[key] - want).abs().max() <= 1e-5 * max(want.abs().max(), 1.0), key
    assert torch.equal(boxes["labels"], f64["labels"])
