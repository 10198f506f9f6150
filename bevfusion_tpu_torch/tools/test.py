"""Evaluation CLI: a config and a checkpoint -> the dataset's metrics.

Counterpart of the JAX package's ``tools/test.py`` (reference:
tools/test.py: build the test dataset and the model, load the
checkpoint, run the model, dataset.evaluate with --eval bbox|map)::

    python -m bevfusion_tpu_torch.tools.test CONFIG CKPT --eval bbox|map \\
        [--out-dir D] [--device cuda] [k.e.y=v ...]

The checkpoint is the port's (``runtime/checkpoint.py:save_checkpoint``)
or a reference ``.pth``. The dotted overrides are applied to the config
(``dataset_root=/data/nuscenes/`` moves every path under it), as the JAX
package's train CLI applies them; its test CLI parses them and drops
them. ``--eval bbox`` writes ``results_nusc.json`` under the output
directory and then needs the nuScenes devkit. Under ``torchrun`` (``WORLD_SIZE``
> 1) each process evaluates its round-robin shard on ``cuda:LOCAL_RANK``
and rank 0 merges the parts through ``<out-dir>/parts`` and reports; the
group's backend is NCCL on the card and gloo on the CPU
(``parallel.join``)::

    torchrun --nproc_per_node N -m bevfusion_tpu_torch.tools.test CONFIG CKPT --eval map
"""
from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List, Optional

import torch
import yaml

from ..config import load_config
from ..data import DataLoader, build_dataset
from ..devices import resolve_device
from .. import parallel
from ..models import build_model
from ..runtime import precision
from ..runtime.checkpoint import restore_checkpoint
from ..runtime.eval import evaluate_dataset


def parse_overrides(opts: List[str]) -> Dict[str, object]:
    """``["a.b=1", "c=[1, 2]"]`` -> ``{"a.b": 1, "c": [1, 2]}``, each value
    read as YAML (the JAX package's tools/train.py:19-25)."""
    out = {}
    for o in opts:
        k, v = o.split("=", 1)
        out[k] = yaml.safe_load(v)
    return out


def local_device(device) -> torch.device:
    """``device``, or under torchrun on the card ``cuda:LOCAL_RANK`` (made
    the current device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    return dev


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("--eval", default="bbox", choices=["bbox", "map"])
    ap.add_argument("--out-dir", default="runs/eval")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs="*", help="config overrides k.e.y=value")
    # intermixed: overrides may follow the options (the argparse of some Python 3.12
    # releases otherwise gives the empty ``opts`` to the first two positionals' chunk
    # and refuses the overrides)
    args = ap.parse_intermixed_args(argv)

    device = local_device(args.device)
    rank, world, joined = parallel.join(device)
    tmpdir = os.path.join(args.out_dir, "parts")
    if world > 1:
        if rank == 0:  # no part of an earlier run may stand in for this one's
            shutil.rmtree(tmpdir, ignore_errors=True)
        torch.distributed.barrier()

    cfg = load_config(args.config, overrides=parse_overrides(args.opts))
    precision.apply_tf32_defaults()
    model = build_model(cfg.model, device)  # fp32, as the JAX CLI (tools/test.py:41)
    restore_checkpoint(args.checkpoint, model)
    dataset = build_dataset(cfg.data.test)
    # round-robin dataset shard per process (multi_gpu_test semantics,
    # reference tools/test.py:198-203)
    loader = DataLoader(dataset, batch_size=1, shuffle=False, num_workers=2,
                        drop_last=False, num_shards=world, shard_id=rank)
    os.makedirs(args.out_dir, exist_ok=True)
    metrics = evaluate_dataset(model, dataset, loader, metric=args.eval, out_dir=args.out_dir,
                               rank=rank, world=world, tmpdir=tmpdir)
    if joined:
        torch.distributed.destroy_process_group()
    if metrics is None:  # non-zero ranks: rank 0 evaluates and reports
        return None
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
