"""Shared helpers of the tests that hold the PyTorch port to the JAX package."""
import jax
import numpy as np

from bevfusion_tpu.models import build_model as jax_build_model
from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
from tests.test_bevfusion_model import make_batch, tiny_fused_config


def random_variables(init, *args, seed=0):
    """Seeded random numpy variables with the structure ``init(key, *args)``
    gives (traced with ``jax.eval_shape``, nothing compiled): He-normal
    kernels, small biases, and BatchNorm / LayerNorm affines and running
    statistics that make every eval normalisation do real work."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)

    def one(path, s):
        name = path[-1].key
        if name in ("kernel", "weight"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return rng.normal(1.0, 0.1, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, s.shape).astype(np.float32)  # bias, mean

    return {col: jax.tree_util.tree_map_with_path(one, tree) for col, tree in shapes.items()}


def load_bridged(module, variables, flax_name, torch_prefix):
    """Carry a standalone flax module's variables into the port's module
    through the bridge (the module sits under ``flax_name`` in the fused
    model, ``torch_prefix`` in the checkpoint); strict."""
    wrapped = {col: {flax_name: tree} for col, tree in variables.items()}
    sd = jax_to_torch_state_dict(wrapped)
    assert all(k.startswith(torch_prefix) for k in sd), sorted(sd)[:3]
    module.load_state_dict({k[len(torch_prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def rel_err(got, want):
    """max|got - want| / max(max|want|, 1)."""
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0))


def tiny_lidar_model(seed=11):
    """The tiny LiDAR-only detector of tests/test_bevfusion_model.py: (config,
    JAX model, points batch, random variables). The heatmap logits are kept
    moderate so the sigmoid is not saturated and ranked scores stay apart."""
    cfg = tiny_fused_config(with_camera=False)
    jm = jax_build_model(cfg)
    batch = {k: v for k, v in make_batch().items() if k in ("points", "points_mask")}
    variables = random_variables(jm.init, batch, seed=seed)
    variables["params"]["head_modules_object"]["heatmap_conv1"]["conv"]["kernel"] *= 0.2
    return cfg, jm, batch, variables
