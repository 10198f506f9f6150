"""The port's copy of the flax <-> torch rule table
(``bevfusion_tpu_torch/runtime/adapter.py``) against the JAX package's
original (``bevfusion_tpu/runtime/adapter.py``): for every flax path of
the five BASELINE config trees (the configs of
tests/test_checkpoint_adapter.py), both give the same torch key and the
same converter (same name, same output on a random array)."""
import functools
import os

import jax
import numpy as np
import pytest

from bevfusion_tpu.config import load_config
from bevfusion_tpu.models import build_model
from bevfusion_tpu.runtime import adapter as jax_adapter
from bevfusion_tpu.runtime.flagship import FLAGSHIP_CONFIG, synthetic_batch
from bevfusion_tpu_torch.runtime import adapter
from tests.test_checkpoint_adapter import _BASELINE_CASES, _REPO

CONFIGS = [os.path.relpath(FLAGSHIP_CONFIG, _REPO)] + [c for c, _ in _BASELINE_CASES]


@functools.lru_cache(maxsize=None)
def _flax_paths(cfg_path):
    """'col:a/b/c' path -> shape, of the config's variables (traced only)."""
    cfg = load_config(os.path.join(_REPO, cfg_path))
    model = build_model(cfg.model)
    batch = synthetic_batch(cfg, B=1, num_points=1000)
    shapes = jax.eval_shape(lambda b: model.init(jax.random.PRNGKey(0), b, training=False),
                            batch)
    out = {}
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes.get(col, {}))[0]:
            out["/".join(k.key for k in path)] = leaf.shape
    return out


@pytest.mark.parametrize("cfg_path", CONFIGS)
def test_rule_table_copy_equals_the_original(cfg_path):
    paths = _flax_paths(cfg_path)
    assert len(paths) > 50
    rng = np.random.RandomState(0)
    for path, shape in paths.items():
        want, got = jax_adapter.flax_to_torch_key(path), adapter.flax_to_torch_key(path)
        if want is None:
            assert got is None, path
            continue
        assert got is not None and got[0] == want[0], (path, got, want)
        assert got[1].__name__ == want[1].__name__, path
        if got[1].__name__ != "_id" and len(shape) >= 2:
            w = rng.randn(*shape[::-1]).astype(np.float32)  # a torch-layout array
            try:
                expect = want[1](w)
            except (ValueError, IndexError):
                continue  # this converter takes another rank
            np.testing.assert_array_equal(got[1](w), expect)
