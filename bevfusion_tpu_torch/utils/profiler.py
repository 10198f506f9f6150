"""Profiling and timing harness of the port.

Counterpart of ``bevfusion_tpu/utils/profiler.py``, with the same three
names, plus the timers and bounds that ``chip_smoke.py`` and every tool
of ``bevfusion_tpu_torch/tools/`` share, so all of them time things one
way:

- ``trace(logdir)``: ``torch.profiler`` around the block (the card's
  kernels too, where there is one), a Chrome trace written into ``logdir``;
- ``time_fn``: ms per call (mean and median) and calls per second; CUDA
  events between back-to-back calls on the card, the host clock on the CPU;
- ``flops_of``: the FLOPs a call runs, ``FlopCounterMode`` for the ATen
  ops plus the useful FLOPs of the port's own kernels (a ``ctypes``
  launch, which that counter cannot see); peak device memory on the card;
- ``frame_ms``: the host-clock times of synchronised calls with their
  peak device memory;
- ``op_timer`` / ``untimed``: a ``timed(name, fn)`` hook that the model's
  forwards call around each piece; ``untimed`` (their default) just runs
  it, ``op_timer`` times it (one row a piece);
- ``bound`` / ``nbytes``: the least time the card could take for a piece
  of work, from its operations and the bytes it must move.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..devices import resolve_device

__all__ = ["trace", "time_fn", "flops_of", "frame_ms", "op_timer", "untimed", "bound",
           "nbytes", "synchronize", "FP32_FLOPS", "TF32_FLOPS", "BF16_FLOPS", "HBM_BYTES_PER_S"]

# NVIDIA H100 SXM, dense rates without sparsity, at the full 700 W power
# limit (NVIDIA's data sheet): fp32 outside the tensor cores, the tensor
# cores in TF32 and in bf16, and HBM3
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where available);
    on exit the Chrome trace is written to ``<logdir>/trace.json``. Yields
    the profiler (``key_averages()`` for sums by op)."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def synchronize(device) -> None:
    """Wait for the card's work when ``device`` is a CUDA device."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _event_times(fn: Callable, warmup: int, iters: int) -> List[float]:
    """ms of each of ``iters`` back-to-back calls after ``warmup``: CUDA
    events recorded between consecutive calls, one synchronise at the end.
    The host queues the calls ahead of the card, so a kernel's interval is
    its time on the card, not its wrapper's host time; where the host is
    the slower, the interval is the host's time per call."""
    for _ in range(warmup):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    torch.cuda.synchronize()
    events[0].record()
    for end in events[1:]:
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in zip(events, events[1:])]


def frame_ms(fn: Callable, warmup: int = 5, iters: int = 20,
             device="cuda") -> Tuple[List[float], Optional[int]]:
    """Host-clock ms of each of ``iters`` calls after warmup, each ending
    in a synchronise on ``device``, and the peak device memory (bytes) over
    them (None on the CPU)."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    synchronize(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    frames = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        frames.append((time.perf_counter() - t0) * 1e3)
    return frames, torch.cuda.max_memory_allocated() if cuda else None


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3,
            device="cuda") -> Dict[str, float]:
    """ms per call of ``fn(*args)`` after ``warmup`` calls: ``mean_ms``,
    ``median_ms`` and ``fps`` (calls per second at the mean). On the card
    (the default) CUDA events sit between back-to-back calls, so a call is
    its time on the card (``_event_times``); on the CPU (``device="cpu"``)
    the host clock times each call."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        times = _event_times(lambda: fn(*args), warmup, iters)
    else:
        times, _ = frame_ms(lambda: fn(*args), warmup, iters, dev)
    mean = statistics.mean(times)
    return {"mean_ms": mean, "median_ms": statistics.median(times), "fps": 1e3 / mean}


def untimed(name: str, fn: Callable):
    """The ``timed`` hook that times nothing: ``fn()``."""
    return fn()


def op_timer(rows: List[dict], device="cuda", iters: int = 10, warmup: int = 2,
             flops: bool = False) -> Callable:
    """A ``timed(name, fn)`` that appends ``{"op": name, "ms": median ms of
    fn()}`` (``time_fn`` on ``device``) to ``rows``, with ``flops_of(fn)``
    under ``"flops"`` if asked, and returns one more ``fn()``: a forward
    given it as its ``timed`` hook then gives its own output. The pieces
    run several times, so the forward must be at eval."""
    def timed(name: str, fn: Callable):
        row = {"op": name,
               "ms": time_fn(fn, iters=iters, warmup=warmup, device=device)["median_ms"]}
        if flops:
            row["flops"] = flops_of(fn, device=device)["flops"]
        rows.append(row)
        return fn()
    return timed


def bound(flops: float, nbytes: float, peak_flops: float = FP32_FLOPS):
    """The least time (ms) the card could take: the larger of the
    operations over ``peak_flops`` (fp32 without tensor cores unless told)
    and the bytes over the memory rate; and which of the two it is."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    """Bytes of the tensors (None skipped), each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class _Counted:
    """A kernel wrapper that adds its useful FLOPs to ``counts[name]``,
    then runs the wrapper with every dispatch mode off, so the ATen ops of
    a plain version (on the CPU) are not counted twice. ``launches`` is the
    wrapper's own count, which the wrapper reaches through its module's
    name while it is replaced."""

    def __init__(self, name, fn, flops, counts):
        self.name, self.fn, self.flops, self.counts = name, fn, flops, counts

    def __call__(self, *args, **kwargs):
        from torch.utils._python_dispatch import _disable_current_modes

        self.counts[self.name] = self.counts.get(self.name, 0) + self.flops(*args)
        with _disable_current_modes():
            return self.fn(*args, **kwargs)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n


@contextlib.contextmanager
def _counted_kernels(counts: Dict[str, int]):
    """The port's kernel wrappers, each replaced for the duration by a
    ``_Counted`` one: 2*Cin*Cout FLOPs per hit pair ``nbr >= 0`` of a sparse
    conv or its weight gradient, 2*C per pooled point."""
    from ..ops import bev_pool as bp
    from ..ops import sparse_conv as sp

    saved = sp.sparse_conv, sp.sparse_conv_dw, bp.bev_pool

    def counted(name, fn, flops):
        return _Counted(name, fn, flops, counts)

    def conv_flops(feats, nbr, weight, *_):
        return 2 * int((nbr >= 0).sum()) * weight.shape[1] * weight.shape[2]

    def dw_flops(feats, nbr, dout):
        return 2 * int((nbr >= 0).sum()) * feats.shape[-1] * dout.shape[-1]

    def pool_flops(depth, ctx, intervals, *_):
        return 2 * intervals.ranks_depth.numel() * ctx.shape[-1]

    sp.sparse_conv = counted("sparse_conv", saved[0], conv_flops)
    sp.sparse_conv_dw = counted("sparse_conv_dw", saved[1], dw_flops)
    bp.bev_pool = counted("bev_pool", saved[2], pool_flops)
    try:
        yield
    finally:
        sp.sparse_conv, sp.sparse_conv_dw, bp.bev_pool = saved


def flops_of(fn: Callable, *args, device=None) -> Dict[str, float]:
    """The FLOPs one call of ``fn(*args)`` runs: ``aten_flops`` from
    ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions,
    attention; elementwise ops count 0, as that counter defines them),
    ``kernel_flops`` from the port's kernels by name (``kernels``), and
    their sum ``flops``. With a CUDA ``device``, also the call's peak device
    memory ``peak_mem_bytes``."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = None if device is None else resolve_device(device)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels: Dict[str, int] = {}
    with FlopCounterMode(display=False) as counter, _counted_kernels(kernels):
        fn(*args)
    aten = counter.get_total_flops()
    out = {"flops": float(aten + sum(kernels.values())), "aten_flops": float(aten),
           "kernel_flops": float(sum(kernels.values())), "kernels": kernels}
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize()
        out["peak_mem_bytes"] = float(torch.cuda.max_memory_allocated())
    return out
