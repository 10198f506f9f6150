"""Model export: the eval forward as a ``torch.export`` program (``.pt2``).

Counterpart of the JAX package's ``tools/export.py``, which serialises the
bf16 eval forward, ``out["boxes"]``, as StableHLO through ``jax.export``
(reference tools/export.py: ONNX for TensorRT)::

    python -m bevfusion_tpu_torch.tools.export [CONFIG] [--checkpoint CKPT] \\
        [--out build/export/model.pt2] [--batch-size 1] [--points 120000] [--device cuda]

The config (the fused flagship by default) is built at full width on a
synthetic batch of one sample (``runtime/flagship.py:build_flagship``),
with seeded random weights, or the checkpoint's weights through
``runtime/checkpoint.py:load_weights`` (the names that match; the counts of
missing and unexpected keys are printed). It computes in the config's
``precision.compute_dtype`` (bf16 for every config under ``configs/``, as
the JAX tool exports it; ``export_model`` takes a model at any dtype). A batch size
other than 1 raises ``NotImplementedError``, as ``tools/benchmark.py``
does; so does a config without an object head (the JAX tool's
``out["boxes"]``).

``torch.export.export(..., strict=False)`` traces the forward. Every hand
kernel is a ``bevfusion::`` custom op (``ops/library.py``) and lands in the
graph as one node; the autocast regions of a bf16 forward become
submodules of the graph, which ``ops/library.py:op_counts`` walks. The
program's inputs are the batch's tensors, every leaf a tensor: the images,
points and their mask, the camera matrices, and the pooling LUT's cell ids
and five interval arrays (``pool_lut``, computed once for the rig). Their
shapes are fixed at export: another rig's LUT, with other lengths, needs
its own export. Nothing of the forward branches on a tensor's value on
that route. If a part of the forward cannot be traced, the tool raises and
names it; it never exports a plain-path graph in its place. A trace takes
the Python branches that run while it traces: under
``torch.use_deterministic_algorithms`` on the card ``F.interpolate``'s
bilinear resize is a decomposition (for its backward's sake), the CUDA
kernel otherwise, and the two differ by rounding at fp32; export in the
mode the program is to run in.

The program is written with ``torch.export.save`` (the byte count and the
count of each ``bevfusion::`` op are printed). To run it::

    import torch
    import bevfusion_tpu_torch.ops  # registers the bevfusion:: ops first
    boxes = torch.export.load("build/export/model.pt2").module()(batch)

where ``batch`` holds the same keys and shapes on the export's device.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..devices import resolve_device
from ..ops.library import op_counts
from ..runtime import precision

DEFAULT_OUT = os.path.join("build", "export", "model.pt2")


class BoxesForward(nn.Module):
    """The eval forward's boxes: ``model(batch)["boxes"]`` (the JAX tool's
    ``infer``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        if "object" not in model.heads:
            raise NotImplementedError("export: the config has no object head; the exported "
                                      "program returns the eval forward's boxes")
        self.model = model

    def forward(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return self.model(batch)["boxes"]


def _tensor_leaves(batch: Dict[str, Any], prefix: str = "") -> None:
    """Raise a TypeError naming any leaf of ``batch`` that is not a tensor:
    the program's inputs are tensors only."""
    for k, v in batch.items():
        if isinstance(v, dict):
            _tensor_leaves(v, f"{prefix}{k}.")
        elif not isinstance(v, torch.Tensor):
            raise TypeError(f"export: batch[{prefix}{k}] is a {type(v).__name__}, not a tensor")


def export_model(model: nn.Module, batch: Dict[str, Any]) -> torch.export.ExportedProgram:
    """``torch.export`` of ``model``'s eval boxes on ``batch`` (non-strict,
    every kernel a ``bevfusion::`` node). A part that cannot be traced
    raises a RuntimeError that names it."""
    _tensor_leaves(batch)
    model.eval()
    try:
        with torch.no_grad():
            return torch.export.export(BoxesForward(model), (batch,), strict=False)
    except Exception as e:  # the tracer's own message names the op and the line
        raise RuntimeError(f"export: the eval forward cannot be exported: "
                           f"{type(e).__name__}: {e}") from e


def save(ep: torch.export.ExportedProgram, out: str) -> int:
    """Write ``ep`` to ``out`` (parents made); returns its size in bytes."""
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.export.save(ep, out)
    return os.path.getsize(out)


def run(config: Optional[str] = None, checkpoint: Optional[str] = None, out: str = DEFAULT_OUT,
        batch_size: int = 1, points: int = 120000, device="cuda") -> Dict[str, Any]:
    """Build, export and save; returns the model, the batch, the program
    and a summary (``bytes``, ``op_counts``, ``export_s`` and ``save_s``
    in seconds, ``dtype``)."""
    from ..config import load_config
    from ..runtime.checkpoint import load_weights
    from ..runtime.flagship import FLAGSHIP_CONFIG
    from .benchmark import build

    dev = resolve_device(device)
    dt = precision.config_dtype(load_config(config or FLAGSHIP_CONFIG))
    _, model, batch = build(config, dev, points, batch_size, dt)
    missing = unexpected = None
    if checkpoint:
        missing, unexpected = load_weights(checkpoint, model)
    t0 = time.perf_counter()
    ep = export_model(model, batch)
    export_s = time.perf_counter() - t0
    nbytes = save(ep, out)
    summary = {"out": out, "bytes": nbytes, "op_counts": op_counts(ep.graph_module),
               "export_s": export_s, "save_s": time.perf_counter() - t0 - export_s,
               "dtype": precision.dtype_name(dt), "device": str(dev)}
    if checkpoint:
        summary.update(missing_keys=len(missing), unexpected_keys=len(unexpected))
    return {"model": model, "batch": batch, "program": ep, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--points", type=int, default=120000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    precision.apply_tf32_defaults()
    s = run(args.config, args.checkpoint, args.out, args.batch_size, args.points,
            args.device)["summary"]
    if args.checkpoint:
        print(f"weights from {args.checkpoint}: {s['missing_keys']} keys missing, "
              f"{s['unexpected_keys']} unexpected")
    ops = ", ".join(f"bevfusion::{k} {v}" for k, v in s["op_counts"].items() if v) or "none"
    print(f"exported {s['bytes']} bytes to {s['out']} ({s['dtype']}, {s['device']}, "
          f"{s['export_s']:.1f} s); ops: {ops}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
