"""The port imports no JAX; its main path imports nothing of the JAX package."""
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAIN_PATH = [
    "bevfusion_tpu_torch",
    "bevfusion_tpu_torch.config",
    "bevfusion_tpu_torch.registry",
    "bevfusion_tpu_torch.native",
    "bevfusion_tpu_torch.ops.voxelize",
    "bevfusion_tpu_torch.ops.sparse_conv",
    "bevfusion_tpu_torch.ops.grid",
    "bevfusion_tpu_torch.ops.bev_pool",
    "bevfusion_tpu_torch.core.coders",
    "bevfusion_tpu_torch.models",
    "bevfusion_tpu_torch.models.layers",
    "bevfusion_tpu_torch.models.sparse_encoder",
    "bevfusion_tpu_torch.models.second",
    "bevfusion_tpu_torch.models.swin",
    "bevfusion_tpu_torch.models.necks",
    "bevfusion_tpu_torch.models.vtransforms",
    "bevfusion_tpu_torch.models.fusers",
    "bevfusion_tpu_torch.models.heads.transformer",
    "bevfusion_tpu_torch.models.heads.transfusion",
    "bevfusion_tpu_torch.models.bevfusion",
    "bevfusion_tpu_torch.runtime.flagship",
]


def _imported_after(modules):
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print(' '.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    return set(out.stdout.split())


def test_main_path_imports_neither_jax_nor_the_jax_package():
    mods = _imported_after(MAIN_PATH)
    assert {"bevfusion_tpu_torch.ops.sparse_conv", "bevfusion_tpu_torch.ops.bev_pool"} <= mods
    assert not {m for m in mods if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))}
    assert not {m for m in mods if m == "bevfusion_tpu" or m.startswith("bevfusion_tpu.")}


def test_bridge_imports_no_jax():
    """The weight bridge reads the JAX package's jax-free rule table only."""
    mods = _imported_after(MAIN_PATH + ["bevfusion_tpu_torch.runtime.bridge"])
    assert "jax" not in mods and not any(m.startswith("flax") for m in mods)
