"""Training step: schedules, the optimizer and one train step.

Counterpart of ``bevfusion_tpu/runtime/train.py`` (reference
mmdet3d/apis/train.py:19-126): AdamW with paramwise lr / decay
multipliers, gradient clipping at a global max-norm, cyclic or
cosine-annealing learning rate (linear warmup) and cyclic momentum.

The schedules give optax's numbers (``optax.join_schedules``,
``cosine_onecycle_schedule``, ``cosine_decay_schedule``,
``linear_schedule``), not ``torch.optim.lr_scheduler``'s, and the
optimizer applies the JAX package's optax chain in its order:
clip-by-global-norm -> Adam (beta1 per step from the momentum schedule)
-> decoupled weight decay on every parameter -> learning rate -> lr
multipliers. Schedules are plain functions of the step count. The
optimizer's state (``AdamW.state_dict``) holds the moments and the step
count by parameter name, so a run resumes where it stopped.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn as nn

from .. import parallel
from ..devices import resolve_device
from ..models.layers import set_dropout_generator

__all__ = ["build_lr_schedule", "build_momentum_schedule", "build_optimizer", "AdamW",
           "make_train_step", "step_seed"]

Schedule = Callable[[int], float]


def _cos_interp(start: float, end: float, pct: float) -> float:
    """optax's cosine interpolation from start (pct 0) to end (pct 1)."""
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """``optax.join_schedules([first, second], [boundary])``."""
    return lambda t: first(t) if t < boundary else second(t - boundary)


def _cosine_decay(init: float, decay_steps: int, alpha: float) -> Schedule:
    """``optax.cosine_decay_schedule(init, decay_steps, alpha)``."""
    def sched(t):
        c = min(t, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)
    return sched


def build_lr_schedule(lr_config: Optional[dict], base_lr: float, total_steps: int) -> Schedule:
    """Fixed, cyclic (mmcv CyclicLrUpdater as the JAX package approximates
    it: a cosine ramp to ``base_lr * target_ratio`` over ``step_ratio_up``
    of the steps, then cosine decay) or CosineAnnealing (optional linear
    warmup from ``base_lr * warmup_ratio``) learning rate per step."""
    cfg = dict(lr_config or {})
    policy = (cfg.get("policy") or "fixed").lower()
    if policy == "fixed":
        return lambda t: base_lr
    if policy == "cyclic":
        ratio = cfg.get("target_ratio", 5.0)
        up, down = ratio if isinstance(ratio, (tuple, list)) else (ratio, 1e-4)
        step_up = int(cfg.get("step_ratio_up", 0.4) * total_steps)
        s = max(step_up, 1)
        # cosine_onecycle_schedule(2 s, peak, pct_start 0.5, div up, final_div 1):
        # base -> peak over [0, s), back to base over [s, 2 s), then base
        peak = base_lr * up

        def ramp(t):
            if t < s:
                return _cos_interp(base_lr, peak, t / s)
            return _cos_interp(peak, base_lr, (t - s) / s) if t < 2 * s else base_lr

        return _join(ramp, _cosine_decay(peak, max(total_steps - step_up, 1), down / up),
                     step_up)
    if policy == "cosineannealing":
        warmup = int(cfg.get("warmup_iters", 0))
        ratio = float(cfg.get("warmup_ratio", 1.0 / 3))
        decay = _cosine_decay(base_lr, max(total_steps - warmup, 1),
                              float(cfg.get("min_lr_ratio", 1e-3)))
        if warmup > 0 and cfg.get("warmup") == "linear":
            start = base_lr * ratio

            def warm(t):
                return (start - base_lr) * (1 - min(max(t, 0), warmup) / warmup) + base_lr

            return _join(warm, decay, warmup)
        return decay
    raise ValueError(f"unsupported lr policy {policy}")


def build_momentum_schedule(momentum_config: Optional[dict], base_m: float,
                            total_steps: int) -> Optional[Schedule]:
    """Cyclic beta1 (mmcv CyclicMomentumUpdaterHook): cosine from ``base_m``
    down to ``base_m * target_ratio[0]`` over ``step_ratio_up`` of the
    steps, then back to ``base_m * target_ratio[1]``. None for an absent or
    fixed config (constant beta1)."""
    cfg = dict(momentum_config or {})
    policy = (cfg.get("policy") or "fixed").lower()
    if policy == "fixed":
        return None
    if policy != "cyclic":
        raise ValueError(f"unsupported momentum policy {policy}")
    tr = cfg.get("target_ratio", (0.85 / 0.95, 1.0))
    dip, end = (float(tr[0]), float(tr[1])) if isinstance(tr, (tuple, list)) else (float(tr), 1.0)
    step_up = int(float(cfg.get("step_ratio_up", 0.4)) * total_steps)

    def anneal(start, stop, steps):
        return lambda t: _cos_interp(start, stop, min(max(t / max(steps, 1), 0.0), 1.0))

    return _join(anneal(base_m, base_m * dip, step_up),
                 anneal(base_m * dip, base_m * end, total_steps - step_up), step_up)


class AdamW:
    """The JAX package's optax chain over ``params`` (name, tensor) pairs,
    reading each tensor's ``.grad`` (None counts as zero):

        g <- g * min(1, max_norm / ||g||)   (global norm, if max_norm)
        m <- b1_t m + (1 - b1_t) g,  v <- b2 v + (1 - b2) g^2
        u <- m / (1 - b1_t^n) / (sqrt(v / (1 - b2^n)) + eps) + wd * decay * p
        p <- p - lr_t * lr_mult * u

    with n the 1-based step, ``b1_t`` from ``momentum_schedule`` (or
    ``b1``) and ``lr_t`` from ``lr_schedule`` at the 0-based step. Updates
    in place with ``torch._foreach_*`` ops. ``state_dict`` /
    ``load_state_dict`` carry ``mu``, ``nu`` (by parameter name) and
    ``count``, the optax state's counterpart."""

    def __init__(self, params: Iterable[Tuple[str, torch.Tensor]], lr_schedule: Schedule,
                 weight_decay: float = 0.01, max_norm: Optional[float] = None,
                 momentum_schedule: Optional[Schedule] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 custom_keys: Optional[Dict[str, dict]] = None):
        named = [(n, p) for n, p in params if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.lr_schedule, self.momentum_schedule = lr_schedule, momentum_schedule
        self.weight_decay, self.max_norm = float(weight_decay), max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        custom = dict(custom_keys or {})
        # mmcv paramwise_cfg: a custom key matches a parameter whose name holds it
        self.decay = [0.0 if any(k in n and float(m.get("decay_mult", 1.0)) == 0.0
                                 for k, m in custom.items()) else 1.0 for n in self.names]
        self.lr_mult = [next((float(m["lr_mult"]) for k, m in reversed(list(custom.items()))
                              if k in n and "lr_mult" in m), 1.0) for n in self.names]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def state_dict(self) -> Dict[str, object]:
        """``{"count": n, "mu": {name: tensor}, "nu": {name: tensor}}`` (the
        tensors themselves, not copies)."""
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Copy ``state`` (``state_dict``'s layout, on any device) into this
        optimizer's moments; every parameter name must be there with its
        shape, and no other (as ``load_state_dict(strict=True)``)."""
        for key in ("mu", "nu"):
            got = state[key]
            if set(got) != set(self.names):
                missing, unexpected = set(self.names) - set(got), set(got) - set(self.names)
                raise KeyError(f"optimizer state {key}: missing {sorted(missing)[:5]}, "
                               f"unexpected {sorted(unexpected)[:5]}")
            with torch.no_grad():
                for name, t in zip(self.names, getattr(self, key)):
                    if got[name].shape != t.shape:
                        raise ValueError(f"optimizer state {key}[{name}]: shape "
                                         f"{tuple(got[name].shape)}, want {tuple(t.shape)}")
                    t.copy_(got[name])
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.max_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            clip = torch.where(norm < self.max_norm, torch.ones_like(norm),
                               self.max_norm / norm)
            grads = torch._foreach_mul(grads, clip)
        b1 = self.b1 if self.momentum_schedule is None else self.momentum_schedule(self.count)
        lr = self.lr_schedule(self.count)
        self.count += 1
        n, b2 = self.count, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        mu_hat = torch._foreach_div(self.mu, 1 - b1 ** n)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1 - b2 ** n))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, [
                self.weight_decay * d for d in self.decay]))
        torch._foreach_add_(self.params, torch._foreach_mul(upd, [-lr * m for m in self.lr_mult]))


def build_optimizer(optimizer_cfg: dict, lr_schedule: Schedule, model: nn.Module,
                    grad_clip: Optional[dict] = None,
                    momentum_schedule: Optional[Schedule] = None) -> AdamW:
    """``AdamW`` over the model's parameters from the config's
    ``optimizer`` (weight_decay, paramwise_cfg.custom_keys) and
    ``optimizer_config.grad_clip`` trees (b2 0.999, eps 1e-8, b1 0.9 unless
    a momentum schedule drives it)."""
    cfg = dict(optimizer_cfg or {})
    return AdamW(model.named_parameters(), lr_schedule,
                 weight_decay=float(cfg.get("weight_decay", 0.01)),
                 max_norm=float(grad_clip.get("max_norm", 35)) if grad_clip else None,
                 momentum_schedule=momentum_schedule,
                 custom_keys=(cfg.get("paramwise_cfg") or {}).get("custom_keys"))


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The dropout generator's seed at optimizer step ``step`` of a run
    seeded with ``seed``, on data-parallel rank ``rank`` (each rank draws
    its own masks for its own samples): ``seed * 2**32 + step`` on rank 0,
    as in one process; on another rank a 64-bit BLAKE2b digest of the three,
    which shares no field with rank 0's seeds."""
    if rank == 0:
        return seed * 2**32 + step
    digest = hashlib.blake2b(f"{seed},{step},{rank}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little")


def make_train_step(model: nn.Module, optimizer: AdamW, device="cuda", seed: int = 0):
    """One train step of ``model`` on ``device`` (the card unless the
    caller passes ``"cpu"``): the model goes to training mode, its dropout
    and drop-path draw from a ``torch.Generator`` seeded before every step
    with ``step_seed(seed, optimizer.count)``, as the JAX train CLI keys its
    dropout with the step (``PRNGKey(state.step)``): a run resumed at step
    n draws the masks that the uninterrupted run drew there.

    Returns ``step(batch, mark=None) -> logs``: forward (the loss dict),
    ``backward()`` of the sum of its ``loss/`` entries, the optimizer
    update; ``logs`` holds the detached loss dict and ``loss/total``.

    Under data parallelism (``parallel.active()``: a process group of N
    ranks, each stepping on its own b samples) the step computes the
    one-process step of the global batch of N*b: the BatchNorm moments and
    every loss normaliser are the global batch's, so each rank's loss is
    its share of the global loss; after ``backward`` the gradients are
    summed over the ranks (``parallel.sum_gradients``, one flat all-reduce
    after backward: no collective runs inside the backward but those of
    the BatchNorm sums, so every rank issues them in the same order), and
    clipping and AdamW see the global gradient. ``logs`` then holds the
    global batch's losses on every rank. Dropout draws from
    ``step_seed(seed, step, rank)``. At world size 1 no collective runs.
    ``mark(phase)``, if given, is called after "forward", "backward" and
    "optimizer" (a timer hook). The JAX step's ``diag/window_overflow`` has
    no counterpart: the port's rulebooks drop no neighbor pair. The forward
    runs at the model's compute dtype (``runtime/precision.py``; at bf16
    the sparse convs' data gradients through the bf16 K1/K2 and their
    weight gradients through the bf16 K3); the parameters, gradients and
    AdamW's moments are fp32, and there is no loss scaling, as in the JAX
    package."""
    dev = resolve_device(device)
    model.to(dev).train()
    generator = torch.Generator(device=dev)
    set_dropout_generator(model, generator)

    def step(batch: Dict[str, torch.Tensor], mark: Optional[Callable[[str], None]] = None):
        generator.manual_seed(step_seed(seed, optimizer.count, parallel.rank()))
        losses = model(batch)
        total = sum(v for k, v in losses.items() if k.startswith("loss/"))
        if mark:
            mark("forward")
        optimizer.zero_grad()
        total.backward()
        parallel.sum_gradients(optimizer.params)
        if mark:
            mark("backward")
        optimizer.step()
        if mark:
            mark("optimizer")
        logs = {k: v.detach() for k, v in losses.items()}
        logs["loss/total"] = total.detach()
        if parallel.active():  # each rank's losses are shares of the global ones
            keys = [k for k in logs if k.startswith("loss/")]
            summed = parallel.all_sum(torch.stack([logs[k].double() for k in keys]))
            logs.update({k: v.to(logs[k].dtype) for k, v in zip(keys, summed)})
        return logs

    return step
