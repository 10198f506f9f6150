"""Dry run of the fused flagship's data-parallel train step at full width.

Counterpart of ``tools/dryrun_flagship_sharded.py`` (the JAX package runs
the flagship's train step under GSPMD batch sharding on a virtual CPU mesh,
at half scale on the host). Here N processes join a
``torch.distributed`` group (``parallel.init``), each takes its sample of a
global batch of N (``runtime/flagship.py:synthetic_batch`` with its
training targets, ``parallel.shard_batch``; the pooling LUT of its own
rows) and runs the train step of ``runtime/train.py`` at full width: the
global-batch BatchNorm moments and loss normalisers, the gradients summed
over the ranks::

    python -m bevfusion_tpu_torch.tools.dryrun_flagship_sharded [--ranks 2] \\
        [--device cuda] [--dist-backend nccl|gloo] [--dtype bfloat16|float32] \\
        [--steps 2] [--points 120000]

Rank r runs on ``cuda:(r mod the cards)``. NCCL refuses two ranks on one
card, so more ranks than cards need ``--dist-backend gloo`` (gloo on CUDA
tensors); the backend is never switched for the caller. Each rank prints a
JSON line: its loss of the global batch a step, ms a step (host clock
around a synchronised step, after one warmup step), its peak device memory,
and the launches a step of K1/K2 (``sparse_conv``, or ``sparse_conv_bf16``
at bf16), K3 (``sparse_conv_dw``, ``sparse_conv_dw_bf16``) and K4
(``bev_pool``). The launcher prints them and exits non-zero if a rank
failed, a loss is not finite or the ranks logged different losses.
``--steps 0`` runs no step: the group, the build at full width, rank 0's
weights broadcast and checked on every rank.
``--device cpu`` runs it on the CPU (gloo; slow at full width).
"""
from __future__ import annotations

import argparse
import json
import math
import socket
import subprocess
import sys
from typing import Any, Dict, List, Optional

import torch

from .. import parallel
from ..devices import resolve_device
from ..runtime import precision

MODULE = "bevfusion_tpu_torch.tools.dryrun_flagship_sharded"


def counters() -> Dict[str, Any]:
    """The wrappers of K1/K2, K3 (fp32 and bf16) and K4, whose ``launches``
    count their kernels' launches."""
    from ..ops import bev_pool as bp
    from ..ops import sparse_conv as sp

    return {"sparse_conv": sp.sparse_conv, "sparse_conv_dw": sp.sparse_conv_dw,
            "sparse_conv_bf16": sp.sparse_conv_bf16,
            "sparse_conv_dw_bf16": sp.sparse_conv_dw_bf16, "bev_pool": bp.bev_pool}


def rank_batch(cfg, rank: int, world: int, device, num_points: int = 120000,
               seed: int = 0) -> Dict[str, Any]:
    """Rank ``rank``'s rows of the global synthetic batch of ``world``
    samples, with its training targets and pooling LUT, on ``device``."""
    from ..runtime.flagship import add_pool_lut, add_train_targets, batch_to, synthetic_batch

    batch = synthetic_batch(cfg, B=world, num_points=num_points, seed=seed, training=True)
    batch = add_train_targets(cfg, parallel.shard_batch(batch, rank, world), seed)
    return batch_to(add_pool_lut(cfg, batch), device)


def rank_steps(cfg, model, batch, device, steps: int = 2) -> Dict[str, Any]:
    """``steps`` train steps after one warmup (``bench_train_step.train_steps``)
    with the kernels' launch counts set to 0 just before and read just
    after: the losses, ms a step, peak memory and launches a step. At
    ``steps`` 0 no step runs (the group, the build and the broadcast alone)."""
    from .bench_train_step import train_steps

    kernels = counters()
    for c in kernels.values():
        c.launches = 0
    if steps == 0:
        peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else None
        return {"losses": [], "step_ms": [], "peak_mem_bytes": peak,
                "launches_per_step": dict.fromkeys(kernels, 0.0)}
    res = train_steps(cfg, model, batch, device, steps=steps, warmup=1)
    return {"losses": res["losses"], "step_ms": [ph["step"] for ph in res["steps"]],
            "peak_mem_bytes": res["peak_mem_bytes"],
            "launches_per_step": {k: c.launches / (steps + 1) for k, c in kernels.items()}}


def rank_main(args) -> Dict[str, Any]:
    """One rank: join the group, build the flagship (the same seeded weights
    on every rank, then rank 0's broadcast), run ``rank_steps`` on its rows."""
    from ..config import load_config
    from ..models import build_model
    from ..runtime.flagship import FLAGSHIP_CONFIG, init_weights

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", args.rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    parallel.init(dev, args.dist_backend, f"tcp://localhost:{args.port}", args.rank,
                  args.ranks, timeout_s=600)
    try:
        precision.apply_tf32_defaults()
        dtype = precision.parse_dtype(args.dtype)
        cfg = load_config(FLAGSHIP_CONFIG)
        model = init_weights(build_model(cfg.model, "cpu", dtype), seed=0).to(dev)
        parallel.replicate_state(dict(model.state_dict()))
        batch = rank_batch(cfg, args.rank, args.ranks, dev, args.points)
        out = rank_steps(cfg, model, batch, dev, args.steps)
        parallel.assert_replicated(dict(model.state_dict()), "the weights after the steps")
    finally:
        torch.distributed.destroy_process_group()
    return dict(out, rank=args.rank, world=args.ranks, device=str(dev),
                kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                dtype=args.dtype, backend=parallel.backend_for(dev, args.dist_backend))


def launch(argv: List[str], ranks: int) -> List[Dict[str, Any]]:
    """Start the ``ranks`` processes of this tool on ``argv`` and return
    their JSON lines (raises if one fails)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-m", MODULE, *argv, "--rank", str(r),
                               "--port", str(port)], stdout=subprocess.PIPE, text=True)
             for r in range(ranks)]
    outs = [p.communicate()[0] for p in procs]
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"dryrun_flagship_sharded: ranks {failed} failed")
    return [json.loads(next(line for line in o.splitlines() if line.startswith("{")))
            for o in outs]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default=None, choices=parallel.BACKENDS)
    ap.add_argument("--dtype", default="bfloat16", choices=list(precision.COMPUTE_DTYPES))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--points", type=int, default=120000)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        print(json.dumps(rank_main(args)))
        return 0
    dev = resolve_device(args.device)
    backend = parallel.backend_for(dev, args.dist_backend)
    if dev.type == "cuda" and backend == "nccl" and args.ranks > torch.cuda.device_count():
        raise ValueError(f"{args.ranks} ranks on {torch.cuda.device_count()} cards: NCCL "
                         "refuses two ranks on one card; pass --dist-backend gloo")
    rows = launch(list(argv if argv is not None else sys.argv[1:]), args.ranks)
    for row in rows:
        print(json.dumps(row))
    losses = {tuple(r["losses"]) for r in rows}
    if len(losses) != 1 or not all(math.isfinite(v) for v in rows[0]["losses"]):
        raise RuntimeError(f"dryrun_flagship_sharded: the ranks' losses {sorted(losses)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
