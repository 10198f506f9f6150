"""The port imports neither JAX nor anything of the JAX package: not its
main path, not the weight bridge, not any module of ``bevfusion_tpu_torch``
(walked with ``pkgutil``), and not ``chip_smoke.py``."""
import ast
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
    "bevfusion_tpu_torch.ops.library",
    "bevfusion_tpu_torch.ops.grid",
    "bevfusion_tpu_torch.ops.bev_pool",
    "bevfusion_tpu_torch.ops.iou3d",
    "bevfusion_tpu_torch.ops.nms",
    "bevfusion_tpu_torch.core.coders",
    "bevfusion_tpu_torch.models",
    "bevfusion_tpu_torch.models.layers",
    "bevfusion_tpu_torch.models.sparse_encoder",
    "bevfusion_tpu_torch.models.second",
    "bevfusion_tpu_torch.models.swin",
    "bevfusion_tpu_torch.models.necks",
    "bevfusion_tpu_torch.models.resnet",
    "bevfusion_tpu_torch.models.vtransforms",
    "bevfusion_tpu_torch.models.fusers",
    "bevfusion_tpu_torch.models.pillar_encoder",
    "bevfusion_tpu_torch.models.radar_encoder",
    "bevfusion_tpu_torch.models.heads.transformer",
    "bevfusion_tpu_torch.models.heads.transfusion",
    "bevfusion_tpu_torch.models.heads.segm",
    "bevfusion_tpu_torch.models.heads.centerpoint",
    "bevfusion_tpu_torch.models.bevdepth",
    "bevfusion_tpu_torch.models.bevfusion",
    "bevfusion_tpu_torch.data.transforms",
    "bevfusion_tpu_torch.runtime.flagship",
    "bevfusion_tpu_torch.runtime.train",
    "bevfusion_tpu_torch.parallel",
]

# every module of the port, found by walking the package in the subprocess
WALK = "__walk__"


def _imported_after(modules):
    """The names in ``sys.modules`` after a fresh interpreter imports
    ``modules`` (``WALK`` stands for every module of bevfusion_tpu_torch),
    and the names it walked."""
    code = ("import importlib, pkgutil, sys\n"
            f"mods = {modules!r}\n"
            f"if {WALK!r} in mods:\n"
            "    import bevfusion_tpu_torch as pkg\n"
            "    mods = [m for m in mods if m != " + repr(WALK) + "] + [\n"
            "        i.name for i in pkgutil.walk_packages(pkg.__path__, 'bevfusion_tpu_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "print(' '.join(mods))\n"
            "print(' '.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    asked, loaded = out.stdout.splitlines()[-2:]
    return set(loaded.split()), asked.split()


def _assert_no_jax(mods):
    assert not {m for m in mods if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))}
    assert not {m for m in mods if m == "bevfusion_tpu" or m.startswith("bevfusion_tpu.")}


def test_main_path_imports_neither_jax_nor_the_jax_package():
    mods, _ = _imported_after(MAIN_PATH)
    assert {"bevfusion_tpu_torch.ops.sparse_conv", "bevfusion_tpu_torch.ops.bev_pool",
            "bevfusion_tpu_torch.ops.library"} <= mods
    _assert_no_jax(mods)


def test_bridge_imports_no_jax():
    """The weight bridge reads the port's own copy of the rule table."""
    mods, _ = _imported_after(MAIN_PATH + ["bevfusion_tpu_torch.runtime.bridge"])
    assert "bevfusion_tpu_torch.runtime.adapter" in mods
    _assert_no_jax(mods)


def test_every_port_module_imports_no_jax():
    mods, walked = _imported_after([WALK])
    for name in ("runtime.bridge", "runtime.adapter", "runtime.train", "core.matching", "data.transforms",
                 "models.losses", "ops.gaussian", "ops.iou3d", "devices", "utils.profiler",
                 "tools.bench_tile_micro", "tools.bench_kernel_variants", "tools.profile_meta",
                 "tools.profile_encoder", "tools.profile_vtransform", "tools.profile_stages",
                 "tools.bench_train_step", "tools.benchmark", "core.box_np", "data.points",
                 "data.loading", "data.loader", "data.nuscenes", "data.synthetic",
                 "runtime.checkpoint", "runtime.eval", "tools.test", "tools.train", "parallel",
                 "parallel.dryrun", "tools.dryrun_flagship_sharded", "ops.library",
                 "tools.export", "tools.train_longevity", "tools.visualize", "utils.visualize",
                 "core.box_np_ops", "core.box_modes", "core.anchors", "core.assign_sample",
                 "ops.deform_conv", "ops.pointnet", "models.vovnet", "models.dla",
                 "models.pointnet_modules", "tools.measure_tiles", "tools.bench_tiled_proto",
                 "tools.profile_encoder2", "tools.bench_mxu_micro", "ops.auction"):
        assert f"bevfusion_tpu_torch.{name}" in walked, name
    assert len(walked) >= 40
    _assert_no_jax(mods)


def _is_port_module(name):
    path = os.path.join(ROOT, *name.split("."))
    return os.path.exists(path + ".py") or os.path.exists(os.path.join(path, "__init__.py"))


def _chip_smoke_imports():
    """Every module ``chip_smoke.py`` imports, at top level or inside a
    function (``from pkg import mod`` counts ``pkg.mod``)."""
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
            mods.update(f"{node.module}.{a.name}" for a in node.names
                        if _is_port_module(f"{node.module}.{a.name}"))
    return mods


def test_chip_smoke_imports_no_jax():
    wanted = _chip_smoke_imports()
    assert {"bevfusion_tpu_torch.tools.bench_train_step", "bevfusion_tpu_torch.ops.sparse_conv",
            "bevfusion_tpu_torch.utils.profiler"} <= wanted
    mods, _ = _imported_after(sorted(wanted) + ["chip_smoke"])
    assert "chip_smoke" in mods
    _assert_no_jax(mods)
