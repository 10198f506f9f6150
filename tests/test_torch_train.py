"""The port's training machinery.

- The optimizer (clip-by-global-norm -> Adam with a per-step beta1 ->
  decoupled weight decay -> lr -> lr multipliers) against the JAX package's
  optax chain, fed the same numpy gradients for 3 steps with the flagship's
  optimizer, grad-clip, lr and momentum config; parameters to 1e-6
  relative after each step (ceiling 1e-6: fp32 elementwise arithmetic in
  another order).
- The lr and momentum schedules against the JAX package's optax schedules
  at a set of steps, to 1e-6 of the schedule's largest value: the port
  computes in float64, optax in float32, whose rounding near the end of the
  cosine decay is 5e-6 of the (small) value itself and 1e-9 of the peak.
- Dropout and DropPath draw from an explicit generator: active in training
  at the configured rate, reproducible from the seed, identity at eval.
- Four train steps of the port on the tiny fused model lower the loss
  (as tests/test_training.py does for the JAX package).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from bevfusion_tpu.runtime import train as jax_train
from bevfusion_tpu_torch.config import Config, load_config
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.models.layers import Dropout, DropPath, set_dropout_generator
from bevfusion_tpu_torch.runtime import flagship, train
from tests.test_bevfusion_model import make_batch, tiny_fused_config

torch.set_num_threads(2)

RTOL = 1e-6
TOTAL_STEPS = 1000


def _flagship_cfg():
    return load_config(flagship.FLAGSHIP_CONFIG)


LR_CONFIGS = {
    "flagship": lambda: (_flagship_cfg().lr_config, 2e-4),  # CosineAnnealing, linear warmup
    "cyclic": lambda: ({"policy": "cyclic"}, 1e-4),
    "cyclic_pair": lambda: ({"policy": "cyclic", "target_ratio": [10, 1e-4],
                             "step_ratio_up": 0.25}, 1e-4),
    "fixed": lambda: (None, 3e-4),
}
STEPS = [0, 1, 2, 99, 249, 250, 251, 399, 400, 401, 499, 500, 501, 750, 999, 1000, 1300]


@pytest.mark.parametrize("name", sorted(LR_CONFIGS))
def test_lr_schedule_matches_optax(name):
    cfg, base = LR_CONFIGS[name]()
    want = jax_train.build_lr_schedule(cfg, base, TOTAL_STEPS)
    got = train.build_lr_schedule(cfg, base, TOTAL_STEPS)
    peak = max(abs(float(want(t))) for t in STEPS)
    for t in STEPS:
        assert abs(got(t) - float(want(t))) <= RTOL * peak, (t, got(t), float(want(t)))


def test_momentum_schedule_matches_optax():
    cfg = _flagship_cfg().momentum_config
    want = jax_train.build_momentum_schedule(cfg, 0.9, TOTAL_STEPS)
    got = train.build_momentum_schedule(cfg, 0.9, TOTAL_STEPS)
    for t in STEPS:
        assert abs(got(t) - float(want(t))) <= RTOL * 0.9, t
    assert train.build_momentum_schedule(None, 0.9, 10) is None
    assert train.build_momentum_schedule({"policy": "fixed"}, 0.9, 10) is None


def _toy():
    """A small module and the same parameters as a JAX tree (torch names
    with the dots as tree levels)."""
    torch.manual_seed(0)
    model = nn.ModuleDict({"head": nn.Linear(6, 4), "backbone": nn.Conv1d(3, 5, 1)})
    model.register_parameter("bias_table", nn.Parameter(torch.randn(7)))
    tree = {}
    for name, p in model.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    return model, tree


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("paramwise", [False, True])
def test_optimizer_matches_optax_step_for_step(paramwise):
    cfg = _flagship_cfg()
    opt_cfg = dict(cfg.optimizer)
    if paramwise:  # keys that name the same parameters in both trees
        opt_cfg["paramwise_cfg"] = {"custom_keys": {"head": {"lr_mult": 0.1},
                                                    "bias_table": {"decay_mult": 0}}}
    grad_clip = cfg.optimizer_config.grad_clip
    lr_cfg, base = cfg.lr_config, opt_cfg["lr"]
    model, tree = _toy()
    jsched = jax_train.build_lr_schedule(lr_cfg, base, TOTAL_STEPS)
    jmom = jax_train.build_momentum_schedule(cfg.momentum_config, 0.9, TOTAL_STEPS)
    tx = jax_train.build_optimizer(opt_cfg, jsched, tree, grad_clip=grad_clip,
                                   momentum_schedule=jmom)
    state = tx.init(tree)
    opt = train.build_optimizer(opt_cfg, train.build_lr_schedule(lr_cfg, base, TOTAL_STEPS),
                                model, grad_clip,
                                train.build_momentum_schedule(cfg.momentum_config, 0.9,
                                                              TOTAL_STEPS))
    rng = np.random.RandomState(5)
    params = dict(model.named_parameters())
    for step, scale in enumerate((0.5, 40.0, 3.0)):  # the second step is clipped
        grads = {n: (rng.randn(*p.shape) * scale).astype(np.float32) for n, p in params.items()}
        jgrads = jax.tree_util.tree_map(lambda x: x, tree)
        for name, _ in _leaves(tree):
            node = jgrads
            *path, leaf = name.split(".")
            for k in path:
                node = node[k]
            node[leaf] = jnp.asarray(grads[name])
        updates, state = tx.update(jgrads, state, tree)
        tree = jax.tree_util.tree_map(lambda p, u: p + u, tree, updates)
        for n, p in params.items():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        for name, want in _leaves(tree):
            got = params[name].detach().numpy()
            err = np.max(np.abs(got - np.asarray(want))) / max(np.max(np.abs(want)), 1e-30)
            assert err <= RTOL, (step, name, err)
    assert opt.count == 3


def test_dropout_and_drop_path_draw_from_the_generator():
    x = torch.ones(200, 500)
    drop = Dropout(0.25).train()
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    y = drop(x)
    assert abs((y == 0).float().mean().item() - 0.25) < 0.01
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(drop(x), y)  # reproducible from the seed
    drop.generator = torch.Generator().manual_seed(4)
    assert not torch.equal(drop(x), y)
    assert torch.equal(drop.eval()(x), x)

    path = DropPath(0.2).train()
    path.generator = torch.Generator().manual_seed(0)
    z = path(torch.ones(4000, 3, 5))
    per_sample = (z == 0).all(-1).all(-1)
    assert abs(per_sample.float().mean().item() - 0.2) < 0.03
    assert ((z == 0) == per_sample[:, None, None]).all()  # one draw per sample


def test_model_dropout_is_active_in_training_and_reproducible():
    """The tiny fused model with the flagship's drop-path rate (0.2, linear
    over Swin's blocks as the JAX package spaces it) and the decoder's
    dropout 0.1: a freshly seeded generator repeats a training forward,
    another seed changes it."""
    cfg = tiny_fused_config()
    cfg["encoders"]["camera"]["backbone"]["drop_path_rate"] = 0.2
    cfg["heads"]["object"]["dropout"] = 0.1
    model = flagship.init_weights(build_model(cfg, "cpu"), 0).train()
    rates = [m.rate for m in model.encoders["camera"]["backbone"].modules()
             if isinstance(m, DropPath)]
    np.testing.assert_allclose(rates[::2], np.linspace(0, 0.2, 3), rtol=1e-12)
    assert sum(isinstance(m, Dropout) and m.rate == 0.1 for m in model.modules()) == 6
    batch = {k: torch.from_numpy(np.array(v)) for k, v in make_batch().items()}
    batch["img"] = batch["img"].permute(0, 1, 4, 2, 3).contiguous()

    def heat(seed):
        set_dropout_generator(model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return model.predict(batch)["heatmap"]

    a, b, c = heat(0), heat(0), heat(1)
    assert torch.equal(a, b) and not torch.allclose(a, c)


def test_four_train_steps_lower_the_loss():
    cfg = tiny_fused_config()
    model = flagship.init_weights(build_model(cfg, "cpu"), 0)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in make_batch(B=1, N=2, P=256, G=3).items()}
    batch["img"] = batch["img"].permute(0, 1, 4, 2, 3).contiguous()
    batch = flagship.add_pool_lut(Config.from_dict({"model": cfg}), batch)
    opt = train.build_optimizer({"type": "AdamW", "lr": 1e-3, "weight_decay": 0.01},
                                train.build_lr_schedule({"policy": "cyclic"}, 1e-3, 10), model,
                                grad_clip={"max_norm": 35})
    step = train.make_train_step(model, opt, "cpu")
    marks = []
    losses = [float(step(batch, marks.append)["loss/total"]) for _ in range(4)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert opt.count == 4 and model.training
    assert marks == ["forward", "backward", "optimizer"] * 4
