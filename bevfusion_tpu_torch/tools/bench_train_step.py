"""Train-step benchmark.

Counterpart of ``tools/bench_train_step.py``: the training step at batch 1
of the fused flagship, or of the config ``--config`` names, through
``runtime/train.py`` (forward with the heads' losses, TransFusion's with
its auction matcher, and the depth loss where the config has one; backward
through the sparse-conv and BEV-pool autograd Functions; AdamW with the
config's clip and schedules), fp32 with cuDNN's TF32 as PyTorch sets it
(the port has no bf16 training yet), on ``runtime/flagship.py``'s synthetic
batch and its training targets. Each step is split into forward, backward
and optimizer on the host clock around synchronises, and the auction
matcher's calls inside the forward are timed alone.

    python -m bevfusion_tpu_torch.tools.bench_train_step [--config PATH] [--steps 10]

Prints one JSON line with the JAX tool's keys (``metric``, named after the
config's file, ``value``, ``unit``, ``loss_total``, ``steps_per_s``) and
the split; ``auction_ms`` is null where no matcher runs.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import time

import torch

from ..devices import resolve_device
from ..utils.profiler import synchronize

HORIZON = 1000  # steps of the lr and momentum schedules


@contextlib.contextmanager
def timed_auction(records, device):
    """Each call of the head's auction matcher timed on the host clock
    around synchronises, appended to ``records`` as (ms, rows assigned,
    valid rows)."""
    from ..models.heads import transfusion

    auction = transfusion.auction_assignment

    def timed(cost, row_valid, col_valid):
        synchronize(device)
        t0 = time.perf_counter()
        out = auction(cost, row_valid, col_valid)
        assigned = int((out >= 0).sum())
        records.append(((time.perf_counter() - t0) * 1e3, assigned, int(row_valid.sum())))
        return out

    transfusion.auction_assignment = timed
    try:
        yield
    finally:
        transfusion.auction_assignment = auction


def train_steps(cfg, model, batch, device="cuda", steps: int = 5, warmup: int = 2,
                seed: int = 0):
    """``steps`` train steps after ``warmup`` through the port's trainer
    (``build_optimizer`` with the config's clip, cosine lr with linear
    warmup and cyclic momentum over a 1000-step horizon). Returns the
    median ms of each phase (``ms_median``: forward, backward, optimizer,
    step), every step's phases and total loss, the auction matcher's calls,
    the parameters the steps left unchanged and, on the card, the peak
    device memory. Raises if a loss is not finite."""
    from ..runtime import train

    dev = resolve_device(device)
    opt_cfg = cfg.optimizer
    opt = train.build_optimizer(
        opt_cfg, train.build_lr_schedule(cfg.lr_config, opt_cfg.lr, HORIZON), model,
        cfg.optimizer_config.grad_clip,
        train.build_momentum_schedule(cfg.get("momentum_config"), 0.9, HORIZON))
    step = train.make_train_step(model, opt, dev, seed=seed)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    def one():
        phases, t = {}, [0.0]

        def mark(name):
            synchronize(dev)
            now = time.perf_counter()
            phases[name] = (now - t[0]) * 1e3
            t[0] = now

        synchronize(dev)
        t[0] = time.perf_counter()
        logs = step(batch, mark)
        phases["step"] = sum(phases.values())
        return {k: v.item() for k, v in logs.items()}, phases

    for _ in range(warmup):
        one()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    records, auctions = [], []
    with timed_auction(auctions, dev):
        for _ in range(steps):
            records.append(one())
    bad = [logs for logs, _ in records if not all(math.isfinite(v) for v in logs.values())]
    if bad:
        raise RuntimeError(f"train step: non-finite logs {bad[0]}")
    return {
        "ms_median": {k: statistics.median(ph[k] for _, ph in records)
                      for k in ("forward", "backward", "optimizer", "step")},
        "steps": [ph for _, ph in records], "losses": [logs["loss/total"] for logs, _ in records],
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
        "auction_ms": [ms for ms, _, _ in auctions],
        "auction_assigned": [[a, v] for _, a, v in auctions],
        "optimizer_steps": opt.count,
        "unchanged": [n for n, p in model.named_parameters() if torch.equal(p.detach(), before[n])],
    }


def result_line(res, name: str = "flagship") -> dict:
    """The JAX tool's JSON keys, the metric named ``{name}_train_step_ms``,
    with the split and the matcher's median (null where it never ran)."""
    ms = res["ms_median"]
    tf32 = "TF32 convs" if torch.backends.cudnn.allow_tf32 else "no TF32"
    return {"metric": f"{name}_train_step_ms", "value": ms["step"],
            "unit": f"ms/step, median (B=1, fp32, {tf32}, fwd+bwd+AdamW)",
            "loss_total": res["losses"][-1], "steps_per_s": 1e3 / ms["step"],
            "forward_ms": ms["forward"], "backward_ms": ms["backward"],
            "optimizer_ms": ms["optimizer"],
            "auction_ms": statistics.median(res["auction_ms"]) if res["auction_ms"] else None,
            "peak_mem_bytes": res["peak_mem_bytes"]}


def main(argv=None) -> int:
    from ..runtime.flagship import build_flagship

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="a config the port builds (default: the fused flagship)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--points", type=int, default=120000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, model, batch = build_flagship(dev, num_points=args.points, training=True,
                                       config_path=args.config)
    name = os.path.splitext(os.path.basename(args.config))[0] if args.config else "flagship"
    print(json.dumps(result_line(train_steps(cfg, model, batch, dev, args.steps), name)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
