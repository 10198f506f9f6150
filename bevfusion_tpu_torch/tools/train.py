"""Training CLI: a config -> epochs of train steps on a dataset, a
checkpoint an epoch, the val metric every ``evaluation.interval`` epochs.

Counterpart of the JAX package's ``tools/train.py`` (reference:
tools/train.py + mmdet3d/apis/train.py, epoch-based, CheckpointHook and
DistEvalHook)::

    python -m bevfusion_tpu_torch.tools.train CONFIG [--run-dir D] [--seed S] \\
        [--load-from F] [--resume-from F] [--device cuda] [--dist-backend nccl|gloo] \\
        [k.e.y=v ...]
    torchrun --nproc_per_node N -m bevfusion_tpu_torch.tools.train CONFIG ...

The loop is the JAX CLI's: the config with its dotted overrides, dumped as
``configs.yaml`` in the run directory; the train dataset and
``DataLoader(samples_per_gpu, shuffle, workers_per_gpu, seed)``; the lr and
momentum schedules over ``max_epochs`` x the loader's length; AdamW; then
``--resume-from`` (weights, optimizer state and step, strictly; training
goes on at epoch step // steps-an-epoch) or ``--load-from`` (the weights
whose names match, the rest listed, as mmcv's ``strict=False``); each epoch
``loader.set_epoch``, the steps, ``epoch_N`` (with the optimizer state,
``checkpoint.max_keep`` kept) and, unless ``evaluation.disable``, the val
metric through ``runtime/eval.py:evaluate_dataset``. The model's initial
weights are drawn on the CPU from ``seed`` (torch's default init), so they
are the same on any device; dropout is seeded from (seed, step)
(``runtime/train.py:make_train_step``): a resumed run repeats the
uninterrupted one. The metric comes from the model's heads (``object``:
bbox, ``map``: map) unless the config names ``evaluation.metric``; the JAX
CLI takes bbox for every config, so its seg runs fail at their first eval
(the detection eval finds no boxes). ``evaluation.save_best`` (default
``mAP``, which no metric key matches, as in the JAX CLI) writes ``best``
when it names a key. The model computes in the config's
``precision.compute_dtype``, as the JAX CLI (``configs/default.yaml``:
``bfloat16``; ``precision.compute_dtype=float32`` on the command line for
fp32; ``runtime/precision.py``): the parameters, gradients, AdamW's
moments and so the checkpoints are fp32 at either dtype, and a checkpoint
of one dtype resumes at the other. The TF32 switches are the fp32 runs'
defaults (``precision.apply_tf32_defaults``).

Under ``torchrun`` (``WORLD_SIZE`` N > 1) the run is data-parallel
(``parallel``): each rank joins the group (``--dist-backend``: NCCL by
default on the card, gloo on the CPU; gloo on the card where several ranks
share one card, which NCCL refuses), steps on ``cuda:LOCAL_RANK`` with
``samples_per_gpu`` samples of its own, its rows of each global batch of
N x ``samples_per_gpu`` (``DataLoader(replicas=N)``, the JAX CLI's global
batch ``samples_per_gpu * jax.device_count()``), and every rank runs
``len(loader)`` steps an epoch, over which the schedules run. Each step
computes the one-process step of the global batch
(``runtime/train.py:make_train_step``). Rank 0's initial state (weights,
and the optimizer's after a resume) is broadcast to every rank
(``--resume-from`` and ``--load-from`` are read on every rank); before
each checkpoint every rank's weights are checked bit-equal to rank 0's;
rank 0 alone writes the checkpoints, ``configs.yaml`` and the log, and a
barrier follows. The per-epoch eval is sharded round-robin and rank 0
merges the parts through ``runtime/eval.py:evaluate_dataset``. A
checkpoint of any world size resumes at any other.
"""
from __future__ import annotations

import argparse
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import torch

from .. import parallel
from ..config import load_config
from ..data import DataLoader, build_dataset
from ..models import build_model
from ..runtime.checkpoint import load_weights, restore_checkpoint, save_checkpoint
from ..runtime import precision
from ..runtime.eval import evaluate_dataset, to_model_batch
from ..runtime.train import (build_lr_schedule, build_momentum_schedule, build_optimizer,
                             make_train_step)
from ..utils.logging import MetricLogger
from ..utils.profiler import synchronize
from .test import local_device, parse_overrides

HEAD_METRICS = (("object", "bbox"), ("map", "map"))


def eval_metrics(cfg) -> List[str]:
    """The val metrics of ``cfg``: ``evaluation.metric`` where the config
    names it, else one a head (``object`` -> bbox, ``map`` -> map)."""
    named = (cfg.get("evaluation") or {}).get("metric")
    if named:
        return [named] if isinstance(named, str) else list(named)
    heads = {k for k, v in (cfg.model.get("heads") or {}).items() if v}
    return [metric for head, metric in HEAD_METRICS if head in heads]


def _barrier(world: int) -> None:
    if world > 1:
        torch.distributed.barrier()


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the training; returns what it did: ``run_dir``, ``compute_dtype``,
    ``start_epoch``, ``steps_per_epoch``, ``rank`` and ``world``, ``missing_keys`` /
    ``unexpected_keys`` of ``--load-from``, ``replicated`` (the tensors rank 0's
    broadcast changed on this rank), ``checkpoints`` written (by rank 0), ``eval``
    ({epoch: metrics}, on rank 0) and ``history``, one record a step (epoch,
    iter, ``loss`` of the global batch, ``wait_ms`` spent waiting on the loader,
    ``step_ms`` of the step up to a synchronise)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--load-from", default=None)
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default=None, choices=parallel.BACKENDS,
                    help="the process group's backend under torchrun (default: nccl on the "
                         "card, gloo on the CPU)")
    ap.add_argument("opts", nargs="*", help="config overrides k.e.y=value")
    args = ap.parse_intermixed_args(argv)  # overrides may follow the options (tools/test.py)

    device = local_device(args.device)
    rank, world, joined = parallel.join(device, args.dist_backend)
    cfg = load_config(args.config, overrides=parse_overrides(args.opts))
    if args.seed is not None:
        cfg["seed"] = args.seed
    seed = int(cfg.get("seed", 0))
    run_dir = args.run_dir or os.path.join(
        "runs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(run_dir, exist_ok=True)
    if rank == 0:
        cfg.dump(os.path.join(run_dir, "configs.yaml"))

    precision.apply_tf32_defaults()
    dtype = precision.config_dtype(cfg)
    print(f"compute dtype {precision.dtype_name(dtype)} (precision.compute_dtype)")
    torch.manual_seed(seed)
    model = build_model(cfg.model, "cpu", dtype).to(device)
    loader = DataLoader(build_dataset(cfg.data.train), batch_size=cfg.data.samples_per_gpu,
                        shuffle=True, num_workers=cfg.data.workers_per_gpu, seed=seed,
                        replicas=world, replica=rank)
    max_epochs, steps_per_epoch = int(cfg.max_epochs), len(loader)
    total_steps = max_epochs * steps_per_epoch
    optimizer = build_optimizer(
        cfg.optimizer, build_lr_schedule(cfg.get("lr_config"), cfg.optimizer.lr, total_steps),
        model, grad_clip=(cfg.get("optimizer_config") or {}).get("grad_clip"),
        momentum_schedule=build_momentum_schedule(cfg.get("momentum_config"), 0.9, total_steps))

    out: Dict[str, Any] = {"run_dir": run_dir, "compute_dtype": precision.dtype_name(dtype),
                           "steps_per_epoch": steps_per_epoch, "rank": rank, "world": world,
                           "missing_keys": [], "unexpected_keys": [], "checkpoints": [],
                           "eval": {}, "history": []}
    resume, load_from = args.resume_from or cfg.get("resume_from"), \
        args.load_from or cfg.get("load_from")
    start_epoch = 0
    if resume:
        restore_checkpoint(resume, model, optimizer)
        start_epoch = optimizer.count // steps_per_epoch
        print(f"resumed from {resume} at step {optimizer.count} (epoch {start_epoch})")
    elif load_from:
        out["missing_keys"], out["unexpected_keys"] = load_weights(load_from, model)
        print(f"loaded {load_from}: {len(out['missing_keys'])} keys of the model missing "
              f"from it, {len(out['unexpected_keys'])} of its keys unexpected")
        for name in ("missing_keys", "unexpected_keys"):
            if out[name]:
                print(f"  {name.split('_')[0]}: {', '.join(out[name])}")
    out["start_epoch"] = start_epoch
    if world > 1:  # rank 0's state on every rank, then held bit-equal
        state = dict(model.state_dict())
        if resume:
            state.update({f"optimizer.{k}.{n}": t for k in ("mu", "nu")
                          for n, t in optimizer.state_dict()[k].items()})
        out["replicated"] = parallel.replicate_state(state)
        parallel.assert_replicated(state, "the initial state")
        print(f"rank {rank} of {world}: {len(out['replicated'])} tensors took rank 0's values")

    step = make_train_step(model, optimizer, device, seed=seed)
    log_cfg = cfg.get("logging") or {}
    logger = MetricLogger(run_dir, interval=int(log_cfg.get("interval", 50)),
                          tensorboard=bool(log_cfg.get("tensorboard", True))) \
        if rank == 0 else None
    eval_cfg = cfg.get("evaluation") or {}
    eval_interval = int(eval_cfg.get("interval", 1))
    val_dataset = None
    if cfg.get("data", {}).get("val") and not eval_cfg.get("disable", False):
        val_dataset = build_dataset(cfg.data.val)
        val_loader = DataLoader(val_dataset, batch_size=1, shuffle=False, num_workers=2,
                                drop_last=False, num_shards=world, shard_id=rank)
    best_score, best_key = None, eval_cfg.get("save_best", "mAP")
    keep = int((cfg.get("checkpoint") or {}).get("max_keep", 1))

    losses = []
    for epoch in range(start_epoch, max_epochs):
        loader.set_epoch(epoch)
        batches = iter(loader)
        for it in range(steps_per_epoch):
            t0 = time.perf_counter()
            np_batch = next(batches)
            t1 = time.perf_counter()
            np_batch.pop("metas", None)
            logs = step(to_model_batch(np_batch, device))
            synchronize(device)
            t2 = time.perf_counter()
            if logger:
                logger.log(epoch, it, steps_per_epoch, logs)
            losses.append(logs["loss/total"])
            out["history"].append({"epoch": epoch, "iter": it, "wait_ms": (t1 - t0) * 1e3,
                                   "step_ms": (t2 - t1) * 1e3})
        path = os.path.join(run_dir, f"epoch_{epoch + 1}")
        parallel.assert_replicated(dict(model.state_dict()), f"epoch {epoch + 1}'s weights")
        if rank == 0:
            save_checkpoint(path, model, keep=keep,
                            meta={"epoch": epoch + 1, "iter": optimizer.count},
                            optimizer=optimizer)
            out["checkpoints"].append(path)
        _barrier(world)
        if val_dataset is not None and (epoch + 1) % eval_interval == 0:
            metrics: Optional[Dict[str, float]] = {}
            eval_dir = os.path.join(run_dir, f"eval_epoch_{epoch + 1}")
            for metric in eval_metrics(cfg):
                parts = os.path.join(eval_dir, f"parts_{metric}")
                if rank == 0:  # no part of an earlier run may stand in for this one's
                    shutil.rmtree(parts, ignore_errors=True)
                _barrier(world)
                got = evaluate_dataset(model, val_dataset, val_loader, metric=metric,
                                       out_dir=eval_dir, rank=rank, world=world, tmpdir=parts)
                metrics = None if got is None else dict(metrics, **got)
            model.train()
            if rank == 0:
                logger.log_eval(epoch, metrics)
                out["eval"][epoch + 1] = metrics
                score = metrics.get(best_key)
                if score is not None and (best_score is None or score > best_score):
                    best_score = score
                    save_checkpoint(os.path.join(run_dir, "best"), model, keep=keep,
                                    meta={"epoch": epoch + 1, "iter": optimizer.count},
                                    optimizer=optimizer)
            _barrier(world)
    if logger:
        logger.close()
    if joined:
        torch.distributed.destroy_process_group()
    for rec, loss in zip(out["history"], losses):
        rec["loss"] = float(loss)
    print("training complete:", run_dir)
    return out


if __name__ == "__main__":
    main()
