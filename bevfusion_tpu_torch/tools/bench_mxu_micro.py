"""Chained microbenchmarks of the card's matmul, row-gather and scatter rates
at the sparse encoder's own shapes.

Counterpart of ``tools/bench_mxu_micro.py``, with its shapes and its 40
repetitions a chain:

1. the matmul K-sweep, 4608 x K x 128 for K = 32/64/128/256 (the JAX tool's
   one-hot gather shape): does a K = 64 product take half the time of
   K = 128 on the tensor cores?
2. the matmul N-sweep at K1's widths, 16384 x 432 x N for N = 16/32/64/128
   (432 = 27 offsets x 16 channels): a yardstick for whether ``wgmma``
   would pay at 64 (``PERF.md`` §7);
3. the two band shapes of the tiled conv, 2780·64 x 256 x 128 and
   2314·16 x 256 x 128;
4. row gathers of 120,000 random rows from a [2,073,600, Cm] int32 table
   for Cm = 3/8/9/128. The JAX tool asked whether the TPU pads a small
   minor dimension to 128 lanes; that question is the TPU's. On the card
   the sweep shows the gather's rate by row width;
5. the packed [XY+1, 3] int32 table scatter (the column table's build form)
   against three 1-D scatters, which build the same table.

``lax.scan``'s data dependency becomes a Python loop of the 40 calls, each
folding one element of its result into a running scalar (one more small
launch a repetition, as the scan's carry), the whole chain queued ahead of
the card (``utils/profiler.py:time_fn(..., queue_ahead=True)``). The
matmuls are bf16 ``torch.matmul`` (fp32 sums, bf16 out), the JAX tool's
``jnp.dot`` outside any Pallas kernel. The scatters drop an out-of-range
row (the JAX ``mode="drop"``) into a spare row past the table's end. Each
row prints µs a repetition and TFLOP/s or rows/s, and its share of the
H100's 989 TFLOP/s bf16 or of its 3.35 TB/s (each input byte read once,
each output byte written once); the fold alone is timed too, the floor of
a repetition.

Run: ``python -m bevfusion_tpu_torch.tools.bench_mxu_micro`` (on the card).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..devices import resolve_device
from ..utils.profiler import BF16_FLOPS, HBM_BYTES_PER_S, card_line, time_fn

REPS = 40
K_SWEEP = [(4608, K, 128, "oh") for K in (32, 64, 128, 256)]
N_SWEEP = [(16384, 432, N, "conv") for N in (16, 32, 64, 128)]
BANDS = [(2780 * 64, 256, 128, "band-s1"), (2314 * 16, 256, 128, "band-s2")]
TABLE_ROWS = 2073600  # the 1440 x 1440 column table
GATHER_ROWS = 120000
GATHER_WIDTHS = (3, 8, 9, 128)


def chain_us(fn, device, iters: int = 5) -> float:
    """µs a repetition of ``fn`` (one chain of ``REPS``), queued ahead."""
    ms = time_fn(fn, iters=iters, warmup=2, device=device, queue_ahead=True)["median_ms"]
    return ms * 1e3 / REPS


def bench_fold(device="cuda", iters: int = 5) -> dict:
    """The fold alone: ``REPS`` adds of one element into the running scalar."""
    dev = resolve_device(device)
    y = torch.ones((2, 2), dtype=torch.bfloat16, device=dev)

    def f():
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(REPS):
            acc = acc + y[0, 0]
        return acc

    return {"what": "fold", "us": chain_us(f, dev, iters)}


def bench_matmul_chain(M: int, K: int, N: int, label: str = "", device="cuda",
                       iters: int = 5) -> dict:
    """``REPS`` bf16 matmuls [M, K] @ [K, N], a different [K, N] each, each
    folding its [0, 0] into the running scalar."""
    dev = resolve_device(device)
    a = torch.ones((M, K), dtype=torch.bfloat16, device=dev)
    ws = torch.full((REPS, K, N), 0.01, dtype=torch.bfloat16, device=dev)

    def f():
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for w in ws:
            acc = acc + torch.matmul(a, w)[0, 0]
        return acc

    us = chain_us(f, dev, iters)
    tflops = 2 * M * K * N / us / 1e6
    return {"what": f"mm {label} M{M} K{K} N{N}", "us": us, "tflops": tflops,
            "share": tflops * 1e12 / BF16_FLOPS}


def bench_take_rows(R: int, Cm: int, n_idx: int, label: str = "", device="cuda",
                    iters: int = 5, seed: int = 0) -> dict:
    """``REPS`` gathers of ``n_idx`` random rows of a [R, Cm] int32 table, a
    different index set each, each folding an element into the scalar."""
    dev = resolve_device(device)
    tab = torch.ones((R, Cm), dtype=torch.int32, device=dev)
    idx = torch.as_tensor(np.random.RandomState(seed).randint(0, R, (REPS, n_idx)), device=dev)

    def f():
        acc = torch.zeros((), dtype=torch.int32, device=dev)
        for ix in idx:
            g = tab.index_select(0, ix)
            acc = acc + g[0, 0] + acc % 7
        return acc

    us = chain_us(f, dev, iters)
    moved = n_idx * (2 * Cm * 4 + idx.element_size())  # rows read and written, indices read
    return {"what": f"take {label} [{R},{Cm}] x{n_idx}", "us": us, "mrows_per_s": n_idx / us,
            "share": moved / (us * 1e-6) / HBM_BYTES_PER_S}


def table_scatters(XY: int, cap: int, device="cuda", seed: int = 0):
    """The packed and the 1-D forms of the column table's build: (packed(),
    split(), the bytes of each), each a function of the running scalar that
    returns the table [XY+1, 3] (split's as three [XY+1] columns). Rows
    ``tgt + acc % 2`` that fall past the table land in a spare row, dropped."""
    dev = resolve_device(device)
    tgt = torch.as_tensor(np.random.RandomState(seed).permutation(XY + 1)[:cap], device=dev)
    v3 = torch.ones((cap, 3), dtype=torch.int32, device=dev)
    v1 = torch.ones((cap,), dtype=torch.int32, device=dev)

    def packed(acc):
        t = torch.zeros((XY + 2, 3), dtype=torch.int32, device=dev)
        t[tgt + acc % 2] = v3
        return t[: XY + 1]

    def split(acc):
        rows = tgt + acc % 2
        out = []
        for _ in range(3):
            o = torch.zeros((XY + 2,), dtype=torch.int32, device=dev)
            o[rows] = v1
            out.append(o[: XY + 1])
        return out

    # the table written, the values and the rows read (the 1-D form reads the rows thrice)
    moved = (XY + 1) * 3 * 4 + cap * 3 * 4
    return packed, split, moved + cap * tgt.element_size(), moved + 3 * cap * tgt.element_size()


def bench_table_scatter(XY: int, cap: int, device="cuda", iters: int = 5) -> list:
    """``REPS`` builds of the packed table and of the three 1-D ones, each
    folding an element into the scalar: a row each."""
    dev = resolve_device(device)
    packed, split, packed_bytes, split_bytes = table_scatters(XY, cap, dev)

    def f3():
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(REPS):
            acc = acc + packed(acc)[0, 0]
        return acc

    def f1():
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(REPS):
            o = split(acc)
            acc = acc + o[0][0] + o[1][1] + o[2][2]
        return acc

    rows = []
    for what, fn, n_bytes in (("scatter [XY+1,3] packed", f3, packed_bytes),
                              ("scatter 3x [XY+1] 1d", f1, split_bytes)):
        us = chain_us(fn, dev, iters)
        rows.append({"what": what, "us": us, "share": n_bytes / (us * 1e-6) / HBM_BYTES_PER_S})
    return rows


def run(device="cuda", iters: int = 5, k_sweep=K_SWEEP, n_sweep=N_SWEEP, bands=BANDS,
        table_rows: int = TABLE_ROWS, gather_rows: int = GATHER_ROWS) -> list:
    """Every row of the tool, in its order (the sizes shrink for a CPU run)."""
    dev = resolve_device(device)
    rows = [bench_fold(dev, iters)]
    rows += [bench_matmul_chain(M, K, N, label, dev, iters) for M, K, N, label in
             list(k_sweep) + list(n_sweep) + list(bands)]
    rows += [bench_take_rows(table_rows, Cm, gather_rows, f"tbl{Cm}", dev, iters)
             for Cm in GATHER_WIDTHS]
    rows += bench_table_scatter(table_rows, gather_rows, dev, iters)
    return rows


def print_rows(rows) -> None:
    for r in rows:
        if "tflops" in r:
            rate = (f"-> {r['tflops']:7.1f} TFLOP/s ({r['share']:.3f} of "
                    f"{BF16_FLOPS / 1e12:.0f} bf16)")
        elif "mrows_per_s" in r:
            rate = (f"({r['mrows_per_s']:8.1f} M rows/s, {r['share']:.3f} of "
                    f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        elif "share" in r:
            rate = f"({r['share']:.3f} of {HBM_BYTES_PER_S / 1e12:.2f} TB/s)"
        else:
            rate = "(the fold alone: a repetition's floor)"
        print(f"{r['what']:40s} {r['us']:9.2f} us {rate}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"device: {card_line()}")
    print_rows(run(dev, args.iters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
