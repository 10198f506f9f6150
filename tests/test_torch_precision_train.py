"""One bf16 train step of the tiny fused detector against the JAX package's
bf16 training forward.

The tiny fused model of tests/test_bevfusion_model.py (dropout rates 0)
is built in both packages with the same random weights (the bridge), the
JAX one with ``dtype=bfloat16``, the port's with ``dtype=torch.bfloat16``,
on the jittered rig and six ground-truth boxes. At random init bf16 flips
the heatmap's top-k between the packages, so the port replays the JAX
step's proposals (its top-k of the JAX dense heatmap, ranked as the JAX
head ranks them) and takes its Hungarian targets from the JAX step's
predictions (the matcher's input). Held:

- every loss of the port's step (through the bf16 K1/K2 and K3's plain
  versions on the CPU) within ``LOSS_RTOL`` of the JAX bf16 step's, the
  matched IoUs within ``IOU_ATOL`` (both sides round each layer to bf16 at
  other places: measured 4e-4 heatmap, 9.3e-3 bbox, 1.6e-2 cls, 2e-3 IoUs);
- the parameters, their gradients and AdamW's moments are fp32 after the
  step, every parameter has a finite gradient, and ``state_dict()`` has the
  fp32 model's keys and dtypes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from bevfusion_tpu_torch.runtime.train import build_lr_schedule, build_optimizer, make_train_step
from tests.test_bevfusion_model import make_batch, tiny_fused_config
from tests.test_torch_train_grad import _train_outputs
from tests.torch_port_helpers import jittered_rig, random_variables

torch.set_num_threads(2)

RIG_SEED = 9  # a jitter whose frustum points all keep >= 1e-4 m from cell boundaries
LOSS_RTOL = 3e-2
IOU_ATOL = 2e-2


@functools.lru_cache(maxsize=None)
def _jax_bf16_step():
    """The JAX bf16 model's training losses and predictions (numpy)."""
    cfg = tiny_fused_config()
    batch = {k: np.asarray(v) for k, v in make_batch(G=6).items()}
    batch.update(jittered_rig(batch, RIG_SEED))
    eval_batch = {k: v for k, v in batch.items() if not k.startswith("gt_")}
    variables = random_variables(jax_build_model(cfg).init, eval_batch, seed=12)
    variables["params"]["head_modules_object"]["heatmap_conv1"]["conv"]["kernel"] *= 0.2
    jm = jax_build_model(cfg, dtype=jnp.bfloat16)
    (losses, preds), _ = jax.jit(lambda v, b: jm.apply(
        v, b, method=_train_outputs, mutable=["batch_stats", "intermediates"]))(variables, batch)
    to_np = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float32))
    return cfg, batch, variables, to_np(losses), to_np(preds)


def _jax_proposals(head, dense):
    """The JAX head's top-k of its dense heatmap ``dense`` [B, ncls, H, W]
    (fp32 sigmoid, the peak filter, class-major, ties to the lower index):
    the flat indices the port's ``_proposals`` returns."""
    B, ncls, H, W = dense.shape
    heat = dense.sigmoid()
    pad = head.nms_kernel_size // 2
    local_max = torch.zeros_like(heat)
    local_max[:, :, pad:H - pad, pad:W - pad] = F.max_pool2d(heat, head.nms_kernel_size, 1, 0)
    if head.test_cfg.get("dataset") == "nuScenes" and ncls >= 10:
        local_max[:, 8:10] = heat[:, 8:10]
    heat = heat * (heat == local_max)
    return head._proposals(heat.reshape(B, -1), head.num_proposals)


@functools.lru_cache(maxsize=None)
def _port_bf16_step():
    cfg, batch, variables, _, jpreds = _jax_bf16_step()
    model = build_model(cfg, "cpu", torch.bfloat16)
    model.load_state_dict(jax_to_torch_state_dict(variables), strict=True)
    head = model.heads["object"]
    top = _jax_proposals(head, torch.from_numpy(jpreds["dense_heatmap"]).permute(0, 3, 1, 2))
    head._proposals = lambda scores, P: top
    jax_preds = {k: torch.from_numpy(jpreds[k])
                 for k in ("heatmap", "center", "height", "dim", "rot", "vel")}
    targets = head._targets
    head._targets = lambda b, preds, *args: targets(b, jax_preds, *args)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 1, 4, 2, 3).contiguous()
    optimizer = build_optimizer({}, build_lr_schedule(None, 1e-4, 10), model)
    logs = make_train_step(model, optimizer, "cpu")(tb)
    return model, optimizer, {k: float(v) for k, v in logs.items()}


def test_bf16_step_losses_match_the_jax_bf16_step():
    *_, want, _ = _jax_bf16_step()
    _, _, got = _port_bf16_step()
    assert set(want) < set(got)
    for name, w in want.items():
        print(f"{name}: port {got[name]:.6f}, JAX {float(w):.6f}")
        if name.startswith("stats/"):
            assert abs(got[name] - float(w)) <= IOU_ATOL
        else:
            assert abs(got[name] - float(w)) <= LOSS_RTOL * abs(float(w)), name
    assert np.isfinite(got["loss/total"])


def test_bf16_step_keeps_fp32_state():
    model, optimizer, _ = _port_bf16_step()
    assert model.compute_dtype == torch.bfloat16
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
    assert all(t.dtype == torch.float32 for t in optimizer.mu + optimizer.nu)
    fp32 = build_model(tiny_fused_config(), "cpu").state_dict()
    got = model.state_dict()
    assert list(got) == list(fp32)
    assert all(got[k].dtype == fp32[k].dtype for k in fp32)
