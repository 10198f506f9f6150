"""Port parity of the BEV tail: SECOND + SECONDFPN, the TransFusion decoder
layer, and the head forward + get_bboxes on one shared BEV map.

Same random weights on both sides (through the bridge), fp32:
max|d| <= 1e-4 * max(|ref|, 1). The head's top-k runs on a heatmap whose
selected scores are pairwise distinct (gaps checked), so tie order cannot
decide which queries either side picks (the decode-tie hazard of
tests/test_full_model_golden.py).
"""
import jax
import numpy as np
import torch

import bevfusion_tpu.models  # noqa: F401  (registers the JAX modules)
import bevfusion_tpu_torch.models  # noqa: F401  (registers the port's modules)
from bevfusion_tpu import registry as jreg
from bevfusion_tpu.models.heads.transformer import TransformerDecoderLayer as JaxDecoderLayer
from bevfusion_tpu_torch import registry as treg
from bevfusion_tpu_torch.models.heads.transformer import TransformerDecoderLayer
from tests.test_bevfusion_model import tiny_fused_config
from tests.torch_port_helpers import load_bridged, random_variables, rel_err

torch.set_num_threads(2)

CFG = tiny_fused_config(with_camera=False)


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def test_second_and_secondfpn_match_jax():
    x = np.random.RandomState(0).randn(1, 16, 16, 16).astype(np.float32)  # NHWC
    jb = jreg.BACKBONES.build(CFG["decoder"]["backbone"])
    jn = jreg.NECKS.build(CFG["decoder"]["neck"])
    vb = random_variables(jb.init, x, seed=1)
    feats = jb.apply(vb, x)
    vn = random_variables(jn.init, feats, seed=2)
    want_neck = jn.apply(vn, feats)[0]

    tb = load_bridged(treg.BACKBONES.build(CFG["decoder"]["backbone"]), vb,
                      "decoder_backbone", "decoder.backbone.")
    tn = load_bridged(treg.NECKS.build(CFG["decoder"]["neck"]), vn,
                      "decoder_neck", "decoder.neck.")
    with torch.no_grad():
        got = tb(torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous())
        got_neck = tn(got)[0]
    assert len(got) == len(feats) == 2
    for g, w in zip(got, feats):
        assert rel_err(g.numpy(), _nchw(w)) <= 1e-4
    assert got_neck.shape == (1, 48, 16, 16)  # deconv upsampled stage 2 back to 16^2
    assert rel_err(got_neck.numpy(), _nchw(want_neck)) <= 1e-4


def test_decoder_layer_matches_jax():
    rng = np.random.RandomState(3)
    d, heads, P, K = 16, 4, 8, 40
    q, k = rng.randn(2, P, d).astype(np.float32), rng.randn(2, K, d).astype(np.float32)
    qp = (rng.rand(2, P, 2) * 16).astype(np.float32)
    kp = (rng.rand(2, K, 2) * 16).astype(np.float32)
    jl = JaxDecoderLayer(d, heads, 32, dropout=0.0)
    v = random_variables(jl.init, q, k, qp, kp, seed=4)
    want = np.asarray(jl.apply(v, q, k, qp, kp))
    layer = TransformerDecoderLayer(d, heads, 32)
    load_bridged(layer, {col: {"decoder0": t} for col, t in v.items()},
                 "head_modules_object", "heads.object.decoder.0.")
    with torch.no_grad():
        got = layer(*map(torch.from_numpy, (q, k, qp, kp))).numpy()
    assert rel_err(got, want) <= 1e-4


def test_transfusion_head_forward_and_decode_match_jax():
    cfg = CFG["heads"]["object"]
    x = np.random.RandomState(5).randn(1, 16, 16, 48).astype(np.float32)
    jh = jreg.HEADS.build(cfg)
    v = random_variables(jh.init, x, seed=6)
    # moderate logits: an unsaturated sigmoid keeps the top scores apart
    v["params"]["heatmap_conv1"]["conv"]["kernel"] *= 0.2
    want = jax.tree_util.tree_map(np.asarray, jh.apply(v, x))
    want_boxes = jax.tree_util.tree_map(np.asarray, jh.apply(v, want, method=jh.get_bboxes))

    head = load_bridged(treg.HEADS.build(cfg), v, "head_modules_object", "heads.object.")
    with torch.no_grad():
        got = head(torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous())
        got_boxes = head.get_bboxes(got)

    assert rel_err(got["dense_heatmap"].numpy(), _nchw(want["dense_heatmap"])) <= 1e-4
    # the queries both sides select are separated by clear score gaps
    top = np.sort(np.max(want["query_heatmap_score"], -1)[0])[::-1]
    assert np.min(-np.diff(top)) > 1e-4, top
    np.testing.assert_array_equal(got["query_labels"].numpy(), want["query_labels"])
    for key in ("query_heatmap_score", "heatmap", "center", "height", "dim", "rot", "vel"):
        assert rel_err(got[key].numpy(), want[key]) <= 1e-4, key
    np.testing.assert_array_equal(got_boxes["labels"].numpy(), want_boxes["labels"])
    np.testing.assert_array_equal(got_boxes["mask"].numpy(), want_boxes["mask"])
    for key in ("bboxes", "scores"):
        assert rel_err(got_boxes[key].numpy(), want_boxes[key]) <= 1e-4, key
