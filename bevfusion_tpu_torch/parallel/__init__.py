"""Data parallelism on ``torch.distributed``.

Counterpart of ``bevfusion_tpu/parallel/__init__.py``. The JAX package
trains data-parallel as one GSPMD program over a ``dp`` mesh axis: the
batch is sharded, the parameters are replicated, and the gradient
all-reduce and the global-batch BatchNorm moments (the reference's
NaiveSyncBatchNorm, mmdet3d/ops/norm.py) fall out of the program. The port
runs one process a rank (``torchrun``) and writes those collectives out:

- ``join`` / ``init``: the process group, from torchrun's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or from explicit arguments; the backend is explicit
  (``backend_for``): NCCL for ``cuda``, gloo for ``cpu``, and gloo on CUDA
  tensors where the caller asks for it (two ranks on one card, which NCCL
  refuses). Nothing falls back to another backend.
- ``rank``, ``world``, ``active``: where no group exists, rank 0 of 1.
- ``all_sum``: a tensor summed over the ranks, autograd-aware where it
  needs a gradient (the backward sums the ranks' gradients).
- ``masked_moments``: the two-pass (mean, biased variance) of BatchNorm
  over every rank's entries, with autograd through both sums.
- ``count_sum`` and ``mean``: a loss normaliser, or a mean's element
  count, summed over the ranks before its clamp, so each rank's loss is
  its share of the global-batch loss.
- ``sum_gradients``: the gradients summed (not averaged) over the ranks
  after backward, in one flat all-reduce per dtype.
- ``replicate_state`` / ``assert_replicated``: rank 0's tensors broadcast
  to every rank (``replicate_state`` of the JAX package), and the check
  that every rank holds the same bits.
- ``shard_batch``: rank r's rows ``[r*b, (r+1)*b)`` of a global batch
  (``P("dp")``'s contiguous split).

With no process group, or at world size 1, every function returns its
input or computes what the one-process code computes, with the same
operations, and issues no collective. Only ``torch.distributed``'s
``all_reduce`` and ``broadcast`` are used: the two collectives gloo runs
on CUDA tensors.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["backend_for", "init", "join", "rank", "world", "active", "all_sum", "masked_moments",
           "count_sum", "mean", "sum_gradients", "replicate_state", "assert_replicated",
           "shard_batch"]

BACKENDS = ("nccl", "gloo")


def backend_for(device, backend: Optional[str] = None) -> str:
    """The backend of a process group whose tensors live on ``device``:
    ``backend`` where given (``gloo`` on CUDA tensors is allowed, ``nccl``
    on the CPU is not), else NCCL for ``cuda`` and gloo for ``cpu``."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the port runs {' or '.join(BACKENDS)}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend nccl needs CUDA tensors; device {dev} is not a card "
                         "(use gloo)")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("backend nccl: this PyTorch has no NCCL")
    return backend


def init(device, backend: Optional[str] = None, init_method: str = "env://",
         rank_: Optional[int] = None, world_: Optional[int] = None,
         timeout_s: Optional[float] = None) -> str:
    """Join a process group on ``device``'s backend (``backend_for``) by
    ``init_method`` (``env://``: torchrun's ``MASTER_*``, ``RANK``,
    ``WORLD_SIZE``; or ``tcp://host:port`` with ``rank_`` and ``world_``).
    Returns the backend."""
    name = backend_for(device, backend)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    if rank_ is not None:
        kw.update(rank=rank_, world_size=world_)
    dist.init_process_group(name, init_method=init_method, **kw)
    return name


def join(device, backend: Optional[str] = None) -> Tuple[int, int, bool]:
    """(rank, world, joined) of this process: where torchrun's
    ``WORLD_SIZE`` > 1, the group joined here through its environment
    (``joined``) unless the caller holds one already; else (0, 1, False).
    The caller destroys a group it joined."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return 0, 1, False
    joined = not dist.is_initialized()
    if joined:
        init(device, backend)
    return dist.get_rank(), dist.get_world_size(), joined


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the group, 0 without one."""
    return dist.get_rank() if _group() else 0


def world() -> int:
    """The group's size, 1 without one."""
    return dist.get_world_size() if _group() else 1


def active() -> bool:
    """Whether the ranks must be summed over: a group of more than one."""
    return world() > 1


def _summed(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


class _AllSum(torch.autograd.Function):
    """The sum over the ranks whose backward sums the ranks' gradients
    (``torch.distributed.nn.functional.all_reduce`` with SUM, which torch
    2.13 deprecates)."""

    @staticmethod
    def forward(ctx, t):
        return _summed(t)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad)


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (``t`` itself at world size 1),
    autograd-aware where ``t`` needs a gradient: the backward sums the
    ranks' gradients, so each rank's inputs receive the global loss's
    gradient through the sum."""
    if not active():
        return t
    return _AllSum.apply(t) if t.requires_grad else _summed(t)


def masked_moments(x: torch.Tensor, m: Optional[torch.Tensor], dims
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) over ``dims`` (kept) of ``x``'s entries
    where ``m`` is 1 (``m`` 0/1 broadcastable to ``x``; None: every entry),
    taken in two passes over every rank: the sum and the count, then the
    sum of squared deviations from the global mean. The count is summed
    over the ranks before its clamp to 1 (the ranks' active sites differ).
    At world size 1 the operations are the one-process BatchNorm's."""
    sync = active()
    if m is None:
        s = x.sum(dims, keepdim=True)
        cnt = torch.tensor(float(x.numel() // s.numel()), dtype=x.dtype, device=x.device)
    else:
        s, cnt = (x * m).sum(dims, keepdim=True), m.sum()
    if sync:  # one collective for the sums and the count
        packed = all_sum(torch.cat([s.flatten(), cnt.reshape(1).to(s.dtype)]))
        s, cnt = packed[:-1].view(s.shape), packed[-1].detach()
    cnt = torch.clamp(cnt, min=1.0)
    mu = s / cnt
    dev = (x - mu) ** 2 if m is None else (x - mu) ** 2 * m
    q = dev.sum(dims, keepdim=True)
    return mu, (all_sum(q) if sync else q) / cnt


def count_sum(t: torch.Tensor) -> torch.Tensor:
    """A loss normaliser (a count, no gradient) summed over the ranks."""
    return all_sum(t.detach())


def mean(loss: torch.Tensor) -> torch.Tensor:
    """``loss.mean()`` over the global batch: at world size > 1 this
    rank's sum over the element count of every rank."""
    if not active():
        return loss.mean()
    n = count_sum(torch.tensor(float(loss.numel()), dtype=loss.dtype, device=loss.device))
    return loss.sum() / n


def _by_dtype(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def sum_gradients(params: List[torch.Tensor]) -> None:
    """Every parameter's ``.grad`` summed over the ranks, in one flat
    all-reduce per dtype (a missing gradient counts as zero and becomes
    one). The loss of each rank is its share of the global-batch loss, so
    the sum, not DDP's average, is the global gradient. No-op at world
    size 1."""
    if not active():
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    for idx in _by_dtype(grads).values():
        flat = _flatten_dense_tensors([grads[i] for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        for i, g in zip(idx, _unflatten_dense_tensors(flat, [grads[i] for i in idx])):
            params[i].grad = g


def _broadcast_flat(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Rank 0's values of ``tensors`` (one broadcast per dtype), as new
    tensors shaped like them."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _by_dtype(tensors).values():
        flat = _flatten_dense_tensors([tensors[i].detach() for i in idx]).clone()
        dist.broadcast(flat, src=0)
        for i, t in zip(idx, _unflatten_dense_tensors(flat, [tensors[i] for i in idx])):
            out[i] = t
    return out


@torch.no_grad()
def replicate_state(tensors: Dict[str, torch.Tensor]) -> List[str]:
    """Rank 0's values copied into every rank's ``tensors`` (a state
    dict's, an optimizer's moments), in place. Returns the names whose
    values on this rank differed from rank 0's before the copy. No-op at
    world size 1."""
    if not active():
        return []
    names = list(tensors)
    differed = []
    for name, got in zip(names, _broadcast_flat([tensors[n] for n in names])):
        if not torch.equal(tensors[name], got):
            differed.append(name)
            tensors[name].copy_(got)
    return differed


@torch.no_grad()
def assert_replicated(tensors: Dict[str, torch.Tensor], what: str = "state") -> None:
    """Raise on every rank unless every rank holds rank 0's bits in each of
    ``tensors``. No-op at world size 1."""
    if not active():
        return
    names = list(tensors)
    own = [n for n, got in zip(names, _broadcast_flat([tensors[n] for n in names]))
           if not torch.equal(tensors[n], got)]
    dev = next(iter(tensors.values())).device if tensors else torch.device("cpu")
    bad = torch.tensor([float(len(own))], device=dev)
    dist.all_reduce(bad, op=dist.ReduceOp.SUM)
    if bad.item():
        raise RuntimeError(f"{what}: {int(bad.item())} tensors differ from rank 0's across the "
                           f"ranks (on rank {rank()}: {own[:5]})")


def shard_batch(batch: Dict[str, object], rank_: int, world_: int) -> Dict[str, object]:
    """Rank ``rank_``'s rows ``[r*b, (r+1)*b)`` of every tensor of a global
    batch of ``world_ * b`` samples (lists, such as ``metas``, alike).
    ``pool_lut`` is left out: its intervals index the whole batch (rebuild
    it for the shard, ``runtime/flagship.py:add_pool_lut``)."""
    out = {}
    for k, v in batch.items():
        if k == "pool_lut":
            continue
        B = len(v)
        if B % world_:
            raise ValueError(f"shard_batch: {k} holds {B} samples, not a multiple of {world_}")
        b = B // world_
        out[k] = v[rank_ * b:(rank_ + 1) * b]
    return out
