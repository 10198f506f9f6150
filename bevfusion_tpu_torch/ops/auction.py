"""The auction matcher of the TransFusion head's Hungarian assignment, as one
hand-written kernel (``csrc/auction.cu``, the custom op ``bevfusion::auction``
of ``ops/library.py``) and its plain version.

Counterpart of ``bevfusion_tpu/core/matching.py:auction_assignment``
(reference HungarianAssigner3D, mmdet3d/core/bbox/assigners/
hungarian_assigner.py:85-143, which ships the cost to scipy on the host):
the JAX package's single eps phase, bids and tie-breaks, so both packages
return the same assignment (a scipy matcher could pick another optimum).
``core/matching.py`` re-exports the public functions beside the cost.

The JAX ``lax.while_loop`` is one kernel on the card: every round of a
problem in one block (``lanes`` threads a row, every bidding row at once,
two barriers a round: ``auction_plan``), the stop test taken on the
device, one launch a call and no host sync in the middle of a train step.
The prologue (``value``, ``spread``, ``eps``) is torch ops shared by both
versions, so the kernel and the plain version start from the same bits.
The plain version is a Python loop of tensor ops that reads the stop flag
on the host every
``_CHECK_EVERY`` rounds; a round in which no row bids changes nothing, so it
returns what the JAX loop returns, and it counts only the rounds in which a
row bid, the JAX loop's count.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import native

__all__ = ["MAX_SMEM", "auction_value", "auction_rounds_plain", "auction_rounds",
           "auction_assignment_plain", "auction_assignment", "auction_plan", "auction_probe",
           "build_kernels"]

_BIG = 1e9
_CHECK_EVERY = 8  # the plain version's rounds between two host reads of the stop flag
MAX_SMEM = 232448  # the shared memory a block may take: value is staged there where it fits


def auction_value(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor,
                  eps_scale: float = 0.002):
    """The prologue both versions share: ``value`` [R, C] fp32, ``-cost`` on
    valid (row, column) pairs and -1e9 elsewhere, and ``eps`` (a 0-dim fp32
    tensor) = spread * eps_scale / max(R, 1), spread the range of the valid
    values (at least 1)."""
    R = cost.shape[0]
    dev = cost.device
    value = -torch.where(row_valid[:, None] & col_valid[None, :], cost.float(),
                         torch.tensor(_BIG, device=dev))
    finite = torch.where(value > -_BIG / 2, value, torch.tensor(float("inf"), device=dev))
    spread = torch.clamp(value.max() - finite.min(), min=1.0)
    return value, spread * eps_scale / max(R, 1)


def auction_rounds_plain(value: torch.Tensor, row_valid: torch.Tensor, eps: torch.Tensor,
                         max_iters: int):
    """Plain PyTorch version of the kernel: the forward auction on ``value``
    [R, C] from zero prices, ``row_valid`` [R] bool, ``eps`` 0-dim. Returns
    (assign [R] int64, the column of each row or -1; price [C] fp32; rounds,
    a 0-dim int32: the rounds in which a row bid, at most ``max_iters``)."""
    R, C = value.shape
    dev = value.device
    rows = torch.arange(R, device=dev)
    cols = torch.arange(C, device=dev)
    price = torch.zeros(C, device=dev)
    owner = torch.full((C,), -1, dtype=torch.long, device=dev)
    assign = torch.full((R,), -1, dtype=torch.long, device=dev)
    rounds = torch.zeros((), dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    it = 0
    while it < max_iters and bool(((assign < 0) & row_valid).any()):
        for _ in range(min(_CHECK_EVERY, max_iters - it)):
            net = value - price[None, :]
            best_v, best_j = net.max(1)
            second_v = net.scatter(1, best_j[:, None], float("-inf")).max(1).values
            bid = best_v - second_v + eps
            bidding = (assign < 0) & row_valid
            rounds += bidding.any()
            bid_amt = torch.where(bidding, bid, neg_inf)
            col_best_bid = torch.full((C + 1,), float("-inf"), device=dev).scatter_reduce(
                0, torch.where(bidding, best_j, C), bid_amt, "amax")[:C]
            is_winner = bidding & (bid_amt == col_best_bid[best_j])
            win_row = torch.full((C + 1,), R, dtype=torch.long, device=dev).scatter_reduce(
                0, torch.where(is_winner, best_j, C), torch.where(is_winner, rows, R),
                "amin")[:C]
            got_bid = win_row < R
            owner = torch.where(got_bid, win_row, owner)
            price = torch.where(got_bid, price + col_best_bid, price)
            assign = torch.full((R + 1,), -1, dtype=torch.long, device=dev)
            assign[torch.where(owner >= 0, owner, R)] = cols
            assign = assign[:R]
            it += 1
    return torch.where(row_valid, assign, -1), price, rounds


MAX_THREADS = 1024


def auction_plan(R: int, C: int, staged: bool = True) -> dict:
    """The block the kernel launches for one problem of R rows and C
    columns: ``lanes`` threads a row (the largest power of two <= 32 with
    R * lanes <= 1024; past 1024 rows one, the rows strided over the
    groups), ``threads`` a block (R * lanes rounded up to whole warps, at
    most 1024), value's row stride ``ldv`` in floats (rows padded to
    ``lanes`` mod 32 where staged, so a warp's row groups start on distinct
    banks), whether value is staged in shared memory (``staged`` asks for
    it; where it fits), and the shared bytes a block takes, of them
    ``scratch_bytes`` for the round's state (``csrc/auction.cu``'s layout;
    the launch refuses a block past the limits). ``threads`` 0: the size is
    refused (the scratch does not fit)."""
    lanes = 32
    while lanes > 1 and R * lanes > MAX_THREADS:
        lanes //= 2
    scratch = (16 * C + 4 * R + 4 + 15) // 16 * 16
    ldv = C + (lanes - C) % 32
    stage = staged and scratch + 4 * R * ldv <= MAX_SMEM
    return {"threads": 0 if scratch > MAX_SMEM else min(MAX_THREADS, -(-R * lanes // 32) * 32),
            "lanes": lanes, "ldv": ldv if stage else C, "staged": int(stage),
            "smem_bytes": scratch + 4 * R * ldv if stage else scratch, "scratch_bytes": scratch}


@functools.lru_cache(maxsize=None)
def _library():
    lib = native.load_library("auction")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bevf_auction.argtypes = [vp, vp, vp] + [i32] * 8 + [vp] * 5
    lib.bevf_auction.restype = i32
    return lib


def build_kernels() -> None:
    """Compile and load the kernel library (done anyway at first launch)."""
    _library()


def _launch_auction(value: torch.Tensor, row_valid: torch.Tensor, eps: torch.Tensor,
                    max_iters: int, staged: bool = True, probe: Optional[torch.Tensor] = None):
    """Check the operands, allocate the outputs and launch the kernel on the
    current stream: ``value`` [N, R, C] fp32, ``row_valid`` [N, R] bool,
    ``eps`` [N] fp32, the N problems one block each -> (assign [N, R] int64,
    price [N, C] fp32, rounds [N] int32). ``staged=False`` reads ``value``
    from global memory even where it fits in shared memory (the kernel's
    second form, held to plain by ``chip_smoke.py``); ``probe`` (int64
    [max_iters, probe_words(R)]) launches the probe form. The block is
    ``auction_plan``'s. An empty call launches nothing; returns (the
    outputs, whether it launched)."""
    if value.dim() != 3:
        raise ValueError(f"auction: want value [N, R, C], got {tuple(value.shape)}")
    N, R, C = value.shape
    for label, t, dtype, shape in (("value", value, torch.float32, (N, R, C)),
                                   ("row_valid", row_valid, torch.bool, (N, R)),
                                   ("eps", eps, torch.float32, (N,))):
        if t.device != value.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"auction: {label} must be contiguous {dtype} {shape} on "
                             f"{value.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    plan = auction_plan(R, C, staged)
    if max_iters < 0 or (R and C and not plan["threads"]):
        raise ValueError(f"auction: max_iters {max_iters} (>= 0), R {R} and C {C} "
                         f"(the scratch, 16 C + 4 R + 4 bytes, within {MAX_SMEM})")
    if probe is not None and (probe.device != value.device or probe.dtype != torch.int64
                              or probe.shape != (max(max_iters, 1), probe_words(R))):
        raise ValueError(f"auction: probe must be int64 [{max(max_iters, 1)}, {probe_words(R)}]")
    dev = value.device
    assign = torch.empty((N, R), dtype=torch.int64, device=dev)  # the kernel writes every entry
    price = torch.empty((N, C), dtype=torch.float32, device=dev)
    rounds = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0 or R == 0 or C == 0:
        return (assign.fill_(-1), price.zero_(), rounds.zero_()), False
    with torch.cuda.device(dev):
        rc = _library().bevf_auction(
            value.data_ptr(), row_valid.data_ptr(), eps.data_ptr(), N, R, C, max_iters,
            plan["threads"], plan["lanes"], plan["ldv"], plan["staged"], assign.data_ptr(),
            price.data_ptr(), rounds.data_ptr(),
            None if probe is None else probe.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"auction: kernel launch failed with cudaError {rc}")
    return (assign, price, rounds), True


PROBE_PHASES = ("scan (thread 0)", "merge + key (thread 0)", "bid barrier wait",
                "column pass (thread 0)", "column barrier wait")
PROBE_ROW = ("scan start", "scan end", "merge end", "key end")  # a bidding row's record


def probe_words(R: int) -> int:
    """A round's probe record (``csrc/auction.cu:probe_words``): thread 0's
    6 stamps, each warp's arrival at the two barriers (2 x 32), each row's 4."""
    return 6 + 64 + 4 * R


def auction_probe(value: torch.Tensor, row_valid: torch.Tensor, eps: torch.Tensor,
                  max_iters: int, staged: bool = True):
    """The kernel's probe form on one problem (CUDA tensors): the same
    outputs, and for every round it ran, block 0's ``clock64()`` record in
    cycles from the round's start (thread 0's first stamp; each warp reads
    its own clock, so only a warp's own differences are durations):
    thread 0's cycles in each of ``PROBE_PHASES``; each warp's arrival at
    the bid barrier and at the column barrier; each bidding row's
    ``PROBE_ROW`` moments (-1 where the row did not bid). Returns ((assign,
    price, rounds), cycles [rounds, 5], warps [rounds, 2, 32] (-1 past the
    block's warps), rows [rounds, R, 4]), the last three int64 on the CPU.
    Counts no launch."""
    R = value.shape[0]
    probe = torch.zeros((max(max_iters, 1), probe_words(R)), dtype=torch.int64,
                        device=value.device)
    (assign, price, rounds), _ = _launch_auction(value[None], row_valid[None], eps[None],
                                                 max_iters, staged, probe)
    rec = probe[:int(rounds[0])].cpu()
    start = rec[:, :1]
    warps = torch.where(rec[:, 6:70] > 0, rec[:, 6:70] - start, -1).view(-1, 2, 32)
    rows = rec[:, 70:].view(-1, R, 4)
    rows = torch.where(rows > 0, rows - start[:, :, None], -1)
    return ((assign[0], price[0], rounds[0]), rec[:, 1:6] - rec[:, :5], warps, rows)


def auction_rounds(value: torch.Tensor, row_valid: torch.Tensor, eps: torch.Tensor,
                   max_iters: int):
    """The auction on the prologue's ``value`` [R, C], ``row_valid`` [R] and
    ``eps`` (0-dim): (assign [R] int64, price [C] fp32, rounds 0-dim int32).

    The op ``bevfusion::auction`` (``ops/library.py``): CUDA tensors launch
    the hand-written kernel (one block, every round) on the current stream;
    CPU tensors take ``auction_rounds_plain``.
    ``auction_assignment.launches`` counts kernel launches."""
    return torch.ops.bevfusion.auction(value, row_valid, eps, max_iters)


def _auction_rounds(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor,
                    eps_scale: float = 0.002, max_iters: int = 2000, plain: bool = False):
    """(assign, price, rounds) of the kernel's op or, with ``plain``, of the
    plain version, on ``auction_assignment``'s arguments."""
    value, eps = auction_value(cost.detach(), row_valid, col_valid, eps_scale)
    if plain:
        return auction_rounds_plain(value, row_valid, eps, max_iters)
    return auction_rounds(value, row_valid, eps, max_iters)


def auction_assignment_plain(cost: torch.Tensor, row_valid: torch.Tensor,
                             col_valid: torch.Tensor, eps_scale: float = 0.002,
                             max_iters: int = 2000) -> torch.Tensor:
    """``auction_assignment`` through the plain version, on any device."""
    return _auction_rounds(cost, row_valid, col_valid, eps_scale, max_iters, plain=True)[0]


def auction_assignment(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor,
                       eps_scale: float = 0.002, max_iters: int = 2000) -> torch.Tensor:
    """Minimise sum of cost[r, assign[r]] over valid rows and columns.

    cost [R, C] (R = ground truths, C = proposals). Returns assign [R]
    int64, the column of each row or -1 (unassigned or invalid). Forward
    auction on v = -cost from zero prices with one eps = spread *
    eps_scale / R: within spread * eps_scale of the optimum. CUDA tensors
    run it as one kernel launch (``auction_assignment.launches`` counts
    them), CPU tensors through the plain version."""
    return _auction_rounds(cost, row_valid, col_valid, eps_scale, max_iters)[0]


auction_assignment.launches = 0
