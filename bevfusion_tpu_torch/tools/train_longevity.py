"""Training longevity: one run of N train steps at flagship scale over one
whole learning-rate schedule, with a resume probe at mid-run.

Counterpart of the JAX package's ``tools/train_longevity.py``::

    python -m bevfusion_tpu_torch.tools.train_longevity [--steps 2000] [--points 120000] \\
        [--scenes 8] [--base-lr 1e-4] [--resume-probe 10] [--device cuda] \\
        [--out build/longevity/longevity.json]

The flagship (``runtime/flagship.py:build_flagship(training=True)``) at
its config's compute dtype (bf16), B = 1, on ``--scenes`` seeded synthetic
scenes (each with 64 ground-truth boxes and the host pooling LUT) cycled
step by step; AdamW with weight decay 0.01 and clip 35 over the config's
``lr_config`` stretched so that one schedule spans exactly ``--steps``
(``runtime/train.py:build_lr_schedule``); the step is
``runtime/train.py:make_train_step``, whose dropout is seeded from the
step. Checks, each of which raises:

- the total loss is finite at every step;
- every 100 steps the norm of the BatchNorm running statistics is
  sampled, and must be finite;
- each step launches the same kernels as the one before;
- the resume probe: after step ``--steps // 2`` a checkpoint
  (``runtime/checkpoint.py``: weights, buffers, AdamW's moments and step
  count) is saved, ``--resume-probe`` steps run (A), the checkpoint is
  restored and the same steps run again (B); A and B are compared tensor
  by tensor (parameters, buffers, both moments, the step count). Both run
  under PyTorch's deterministic algorithms (cuDNN deterministic; on the
  card the voxel means' and the pool backward's ``index_add_`` are
  otherwise atomics), and B must equal A bit for bit. Were it not so,
  the ops that warned are named and two more reruns (A', A'', each from
  a copy of the state held in memory, so each repeats A) hold B by the
  rule of ``chip_smoke.py`` 11e: each part within 2x the mean of the
  reruns' gaps to A, and AdamW's ``nu`` within ``RESUME_NU_GAP`` in norm.
  The JSON says which rule ran. The run then goes on from the state at
  the save, so the probe moves nothing of the loss curve.

The JAX tool also asserts zero window overflow every step; the port's
rulebooks drop no neighbour pair (``runtime/train.py:make_train_step``), so
there is nothing to read, and the JSON says so.

The JSON (``--out``) has the JAX tool's keys (steps, points, scenes, ms a
step on average, the first, least and last loss, the loss every 20 steps,
the BatchNorm norm every 100 steps, the resume result, the schedule) and
``device`` (``nvidia-smi``'s name and power limit on the card), ``dtype``,
``launches_per_step`` of each kernel, ``resume_rule``, ``nondeterministic_ops``
and ``window_overflow``. The average step time leaves the probe out
(``resume_probe_s``). Set ``CUBLAS_WORKSPACE_CONFIG`` before the first
cuBLAS call for a deterministic probe on the card (``main`` does).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import sys
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn as nn

from ..devices import resolve_device
from ..ops.library import COUNTERS
from ..runtime import precision
from ..runtime.checkpoint import restore_checkpoint, save_checkpoint
from ..runtime.train import build_lr_schedule, build_optimizer, make_train_step

DEFAULT_OUT = os.path.join("build", "longevity", "longevity.json")
BN_EVERY = 100  # steps between two samples of the BatchNorm statistics' norm
CURVE_EVERY = 20  # steps between two points of the loss curve
# the fallback resume rule (chip_smoke.py 11e): each part within this many times the mean of two
# reruns' gaps, and the second moment's gap in norm within RESUME_NU_GAP
RESUME_FACTOR = 2.0
RESUME_NU_GAP = 0.37
WINDOW_OVERFLOW = ("none to read: the port's rulebooks drop no neighbour pair "
                   "(runtime/train.py:make_train_step)")


def scene_batches(cfg, first: Dict[str, Any], scenes: int, points: int, device) -> List[Dict]:
    """``first`` (scene 0, ``build_flagship``'s batch) and ``scenes - 1``
    more seeded training batches (seeds 1.., the JAX tool's), each with its
    training targets and pooling LUT, on ``device``."""
    from ..runtime.flagship import add_pool_lut, add_train_targets, batch_to, synthetic_batch

    return [first] + [
        batch_to(add_pool_lut(cfg, add_train_targets(
            cfg, synthetic_batch(cfg, B=1, num_points=points, seed=s, training=True), s)), device)
        for s in range(1, scenes)]


def bn_norm(model: nn.Module) -> float:
    """The norm of every BatchNorm running mean and variance together."""
    total = sum(float((b.float() ** 2).sum()) for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var")))
    return math.sqrt(total)


def state_tensors(model: nn.Module, optimizer) -> Dict[str, torch.Tensor]:
    """Copies of every parameter, buffer and AdamW moment, by part and
    name, and AdamW's step count."""
    out = {f"param/{n}": p.detach().clone() for n, p in model.named_parameters()}
    out.update({f"buffer/{n}": b.detach().clone() for n, b in model.named_buffers()})
    sd = optimizer.state_dict()
    for part in ("mu", "nu"):
        out.update({f"{part}/{n}": t.detach().clone() for n, t in sd[part].items()})
    out["count/"] = torch.tensor(sd["count"])
    return out


def part_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per part (param, buffer, mu, nu): ``||got - ref|| / ||ref||`` over
    the part's tensors together."""
    num, den = {}, {}
    for name, r in ref.items():
        part = name.split("/", 1)[0]
        d, r = (got[name].double() - r.double()), r.double()
        num[part] = num.get(part, 0.0) + float((d * d).sum())
        den[part] = den.get(part, 0.0) + float((r * r).sum())
    return {p: math.sqrt(num[p]) / max(math.sqrt(den[p]), 1e-30) for p in num}


@contextlib.contextmanager
def deterministic(record: Optional[List[str]] = None):
    """PyTorch's deterministic algorithms and cuDNN's, warnings only (the
    switches as they were after); the message of every op that has no
    deterministic form goes to ``record`` where given."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        if record is not None:
            record.extend(sorted({str(w.message).splitlines()[0] for w in caught
                                  if "deterministic" in str(w.message)}))
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]


def run(model: nn.Module, batches: List[Dict[str, Any]], steps: int, lr_config,
        base_lr: float = 1e-4, resume_probe: int = 10, device="cuda",
        ckpt_dir: str = os.path.join("build", "longevity", "ckpt"),
        log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Train ``model`` for ``steps`` steps on ``batches`` cycled, with the
    resume probe after step ``steps // 2`` (none for ``resume_probe`` 0);
    returns the JSON's fields (``device``, ``points``, ``scenes`` and
    ``dtype`` are the caller's)."""
    dev = resolve_device(device)
    sched = build_lr_schedule(lr_config, base_lr, steps)
    opt = build_optimizer({"weight_decay": 0.01}, sched, model, grad_clip={"max_norm": 35})
    step = make_train_step(model, opt, dev)

    def one(i: int) -> float:
        return float(step(batches[i % len(batches)])["loss/total"])  # synchronises

    def launches() -> Dict[str, int]:
        return {name: c.launches for name, c in COUNTERS.items()}

    losses: List[float] = []
    bn: List[List[float]] = []
    per_step: Optional[Dict[str, int]] = None
    resume: Dict[str, Any] = {"steps": resume_probe}
    mid = steps // 2
    run_s, t0 = 0.0, time.perf_counter()
    for i in range(steps):
        before = launches()
        t_step = time.perf_counter()
        total = one(i)
        if i:  # step 0 pays every first call (cuDNN's algorithm search)
            run_s += time.perf_counter() - t_step
        now = {k: v - before[k] for k, v in launches().items()}
        if per_step is not None and now != per_step:
            raise AssertionError(f"step {i} launched {now}, step {i - 1} {per_step}")
        per_step = now
        losses.append(total)
        if not math.isfinite(total):
            raise AssertionError(f"non-finite loss at step {i}: {total}")
        if i % BN_EVERY == 0 and i:
            bn.append([i, bn_norm(model)])
            if not math.isfinite(bn[-1][1]):
                raise AssertionError(f"non-finite BatchNorm statistics at step {i}")
            log(f"step {i:5d} loss={total:9.4f} bn|.|={bn[-1][1]:.2f} "
                f"({run_s / i * 1e3:.0f} ms/step avg)")
        if i == mid and resume_probe:
            t_probe = time.perf_counter()
            resume = probe(model, opt, one, i + 1, resume_probe, ckpt_dir)
            resume["seconds"] = time.perf_counter() - t_probe
            log(f"step {i}: resume probe of {resume_probe} steps: {resume['rule']}, "
                f"bit-identical={resume['bit_identical']}")
    return {
        "steps": steps, "ms_per_step_avg": run_s / max(steps - 1, 1) * 1e3,
        "wall_s": time.perf_counter() - t0,
        "loss_first": losses[0], "loss_min": min(losses), "loss_last": losses[-1],
        "loss_curve_every20": losses[::CURVE_EVERY], "bn_norm_every100": bn, "losses": losses,
        "window_overflow": WINDOW_OVERFLOW,
        "resume_bit_identical": resume.get("bit_identical"), "resume_rule": resume.get("rule"),
        "nondeterministic_ops": resume.get("nondeterministic_ops", []),
        "resume_probe": resume, "resume_probe_s": resume.get("seconds", 0.0),
        "launches_per_step": per_step,
        "lr_schedule": f"{(lr_config or {}).get('policy', 'fixed')} (the config's lr_config), "
                       f"one whole schedule over {steps} steps",
    }


def probe(model, opt, one, first: int, n: int, ckpt_dir: str) -> Dict[str, Any]:
    """The resume probe at step ``first``: save, run ``n`` steps (A),
    restore, run them again (B), hold B to A. The fallback's reruns (A',
    A'') start from a copy of the state held in memory at the save, not
    from the file: they repeat A, so a restore that loses or corrupts a
    part moves B alone. The run then goes on from that copy."""
    path = os.path.join(ckpt_dir, f"step_{first}")
    save_checkpoint(path, model, meta={"iter": first}, optimizer=opt)
    held = copy.deepcopy((model.state_dict(), opt.state_dict()))
    ops: List[str] = []

    def from_memory() -> None:
        model.load_state_dict(held[0], strict=True)
        opt.load_state_dict(held[1])

    def rerun(start: Optional[str]) -> Dict[str, torch.Tensor]:
        if start == "file":
            restore_checkpoint(path, model, opt)
        elif start == "memory":
            from_memory()
        with deterministic(ops):
            for j in range(n):
                one(first + j)
        return state_tensors(model, opt)

    a, b = rerun(None), rerun("file")
    equal = [k for k in a if torch.equal(a[k], b[k])]
    out: Dict[str, Any] = {"steps": n, "tensors": len(a), "bit_equal_tensors": len(equal),
                           "bit_identical": len(equal) == len(a),
                           "nondeterministic_ops": sorted(set(ops))}
    if out["bit_identical"]:
        out["rule"] = "bit-identical under deterministic algorithms"
    else:
        reruns = [part_gaps(rerun("memory"), a) for _ in range(2)]
        gaps = part_gaps(b, a)
        base = {p: sum(r[p] for r in reruns) / 2 for p in gaps}
        out.update(rule=f"{RESUME_FACTOR:g}x the mean of two reruns' gaps, nu within "
                        f"{RESUME_NU_GAP} (chip_smoke 11e)", gaps=gaps, rerun_gaps=reruns)
        holds = all(gaps[p] <= RESUME_FACTOR * base[p] for p in gaps) \
            and gaps.get("nu", 0.0) <= RESUME_NU_GAP
        if not holds:
            raise AssertionError(f"resume probe: B's gaps {gaps} against the reruns' {reruns}; "
                                 f"ops without a deterministic form: {out['nondeterministic_ops']}")
    from_memory()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--points", type=int, default=120000)
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--base-lr", type=float, default=1e-4)
    ap.add_argument("--resume-probe", type=int, default=10,
                    help="steps re-run after the mid-run restore")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    # cuBLAS takes deterministic workspaces only if told before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from ..config import load_config
    from ..runtime.flagship import FLAGSHIP_CONFIG, build_flagship
    from ..utils.profiler import card_line

    dev = resolve_device(args.device)
    precision.apply_tf32_defaults()
    dtype = precision.config_dtype(load_config(FLAGSHIP_CONFIG))
    t0 = time.perf_counter()
    cfg, model, batch0 = build_flagship(dev, num_points=args.points, training=True, dtype=dtype)
    batches = scene_batches(cfg, batch0, args.scenes, args.points, dev)
    print(f"init: {time.perf_counter() - t0:.1f} s", flush=True)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    res = run(model, batches, args.steps, cfg.get("lr_config"), args.base_lr, args.resume_probe,
              dev, os.path.join(out_dir, "ckpt"), log=lambda s: print(s, flush=True))
    res.update(points=args.points, scenes=args.scenes, dtype=precision.dtype_name(dtype),
               device=card_line() if dev.type == "cuda" else "cpu")
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("losses", "loss_curve_every20", "bn_norm_every100")}))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
