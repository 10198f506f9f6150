"""Microbenchmarks of the card's memory system and matmul rate.

Counterpart of ``tools/bench_tile_micro.py``, with the hand-written
kernels of ``csrc/tile_micro.cu`` in place of its two Pallas kernels:

1. ``bench_ew``     - PyTorch's ``x + 1`` on 128 MiB of bf16 (the
                      elementwise rate);
2. ``bench_copy``   - K5 ``copy_add_one``: the same function as a
                      hand-written copy (the copy rate every ``bytes``
                      bound divides by);
3. ``bench_gather`` - K6 ``gather_tiles``: ``steps`` blocks, each reading
                      G random tiles of R rows of 256 B from a pool (the
                      random-tile gather rate, from L2 or from HBM by the
                      pool's size);
4. ``bench_matmul`` - bf16 ``torch.matmul`` at the sparse convs' im2col
                      shapes (outside any kernel, as the JAX tool's
                      ``jnp.dot``).

Run: ``python -m bevfusion_tpu_torch.tools.bench_tile_micro`` (on the card).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import sys

import numpy as np
import torch

from .. import native
from ..devices import resolve_device
from ..utils.profiler import BF16_FLOPS, bound, nbytes, time_fn

ROW = 128  # bf16 values of a pool row (256 B)
L2_BYTES = 50e6  # the H100's L2 cache
# the JAX tool's settings (tools/bench_tile_micro.py:126-137): (T, R, G,
# steps) per gather, (M, K, N) per matmul; then the row size the sparse
# convs gather (256 B) over their largest feature table (160,000 rows)
GATHERS = [(8192, 32, 8, 4096), (8192, 128, 8, 2048), (8192, 512, 4, 1024),
           (8192, 8, 8, 4096), (160000, 1, 8, 16384)]
MATMULS = [(4096, 432, 16), (4096, 432, 128), (16384, 432, 128), (16384, 864, 32),
           (16384, 1728, 64), (8192, 128, 128)]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = native.load_library("tile_micro")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bevf_copy_add_one_bf16.argtypes = [vp, vp, i64, vp]
    lib.bevf_copy_add_one_bf16.restype = i32
    lib.bevf_gather_tiles_bf16.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp]
    lib.bevf_gather_tiles_bf16.restype = i32
    return lib


def build_kernels() -> None:
    """Compile and load the kernel library (done anyway at first launch)."""
    _lib()


def _check_bf16(what: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{what}: want bfloat16, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: want a contiguous, 16-byte aligned tensor")


def _raise_on(what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError {rc}")


# ----------------------------------------------------------------------
# K5: the copy
# ----------------------------------------------------------------------

def copy_add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: ``x + 1``."""
    return x + 1


def copy_add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for a contiguous bf16 ``x`` of a multiple of 8 values
    ([M, 1024] in the probe). CUDA tensors launch the hand-written copy
    kernel on the current stream; CPU tensors take ``copy_add_one_plain``.
    ``copy_add_one.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return copy_add_one_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"copy_add_one: unsupported device {x.device}")
    _check_bf16("copy_add_one: x", x)
    if x.numel() % 8:
        raise ValueError(f"copy_add_one: {x.numel()} values, want a multiple of 8")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _lib().bevf_copy_add_one_bf16(x.data_ptr(), out.data_ptr(), x.numel(),
                                           torch.cuda.current_stream().cuda_stream)
    _raise_on("copy_add_one", rc)
    copy_add_one.launches += 1
    return out


copy_add_one.launches = 0


# ----------------------------------------------------------------------
# K6: the tile gather
# ----------------------------------------------------------------------

def _check_gather_args(pool: torch.Tensor, slots: torch.Tensor, R: int, G: int) -> int:
    """Raise unless pool is [rows >= R, 128], slots [steps * G] int32 on
    pool's device and G >= 2; returns steps."""
    if pool.dim() != 2 or pool.shape[1] != ROW or pool.shape[0] < R or R < 1:
        raise ValueError(f"gather_tiles: want pool [rows >= R, {ROW}], got "
                         f"{tuple(pool.shape)} with R = {R}")
    if G < 2:
        raise ValueError(f"gather_tiles: G = {G}; the output sums the last two tiles, G >= 2")
    if slots.dim() != 1 or slots.numel() == 0 or slots.numel() % G:
        raise ValueError(f"gather_tiles: want slots [steps * {G}], got {tuple(slots.shape)}")
    if slots.dtype != torch.int32 or slots.device != pool.device:
        raise TypeError(f"gather_tiles: want int32 slots on {pool.device}, got {slots.dtype} "
                        f"on {slots.device}")
    return slots.numel() // G


def gather_tiles_plain(pool: torch.Tensor, slots: torch.Tensor, R: int, G: int) -> torch.Tensor:
    """Plain PyTorch version of K6: every tile's R rows gathered in one
    ``index_select`` ([steps * G, R, 128]), then the last step's tiles G-2
    and G-1 summed."""
    _check_gather_args(pool, slots, R, G)
    rows = (slots.long()[:, None] + torch.arange(R, device=pool.device)).reshape(-1)
    tiles = pool.index_select(0, rows).view(-1, R, ROW)
    return tiles[-2] + tiles[-1]


def gather_tiles(pool: torch.Tensor, slots: torch.Tensor, R: int, G: int) -> torch.Tensor:
    """``[R, 128] = pool[slots[-2] : +R] + pool[slots[-1] : +R]`` (bf16),
    where pool [T*R, 128] bf16 and slots [steps * G] int32 hold row starts
    (G >= 2; every start + R within the pool). CUDA tensors launch the
    hand-written gather on the current stream: one block per step reads
    all G of its tiles; a start outside the pool trips a device-side
    assert. CPU tensors take ``gather_tiles_plain``.
    ``gather_tiles.launches`` counts kernel launches."""
    if pool.device.type == "cpu":
        return gather_tiles_plain(pool, slots, R, G)
    if pool.device.type != "cuda":
        raise ValueError(f"gather_tiles: unsupported device {pool.device}")
    steps = _check_gather_args(pool, slots, R, G)
    _check_bf16("gather_tiles: pool", pool)
    if not slots.is_contiguous():
        raise ValueError("gather_tiles: slots must be contiguous")
    out = torch.empty((R, ROW), dtype=torch.bfloat16, device=pool.device)
    with torch.cuda.device(pool.device):
        rc = _lib().bevf_gather_tiles_bf16(pool.data_ptr(), slots.data_ptr(), out.data_ptr(),
                                           pool.shape[0], R, G, steps,
                                           torch.cuda.current_stream().cuda_stream)
    _raise_on("gather_tiles", rc)
    gather_tiles.launches += 1
    return out


gather_tiles.launches = 0


def gather_inputs(T: int, R: int, G: int, steps: int, device, seed: int = 0):
    """(pool [T*R, 128] bf16 of seeded noise, slots [steps*G] int32 tile
    starts drawn uniformly from the T tiles, as the JAX tool draws them)."""
    rng = np.random.RandomState(seed)
    dev = resolve_device(device)
    slots = torch.from_numpy((rng.randint(0, T, steps * G) * R).astype(np.int32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = torch.randn(T * R, ROW, generator=g, device=dev).to(torch.bfloat16)
    return pool, slots


# ----------------------------------------------------------------------
# the probes
# ----------------------------------------------------------------------

def bench_ew(device="cuda", iters: int = 20, warmup: int = 5):
    """PyTorch's ``x + 1`` on [64, 1024, 1024] bf16 (128 MiB): ms and GB/s
    (read + write)."""
    dev = resolve_device(device)
    x = torch.ones((64, 1024, 1024), dtype=torch.bfloat16, device=dev)
    ms = time_fn(lambda: x + 1, iters=iters, warmup=warmup, device=dev)["median_ms"]
    return {"ms": ms, "gb_per_s": 2 * nbytes(x) / ms / 1e6}


def bench_copy(M: int = 65536, device="cuda", iters: int = 20, warmup: int = 5, seed: int = 0):
    """K5 on x [M, 1024] bf16 of seeded noise: its median ms, the plain
    version's, PyTorch's ``x + 1`` (``library_ms``, the one call computing
    the same function), the bound (each byte read once, written once) and
    GB/s."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, 1024, generator=g, device=dev).to(torch.bfloat16)

    def t(fn):
        return time_fn(fn, iters=iters, warmup=warmup, device=dev)["median_ms"]

    ms, plain_ms, library_ms = t(lambda: copy_add_one(x)), t(lambda: copy_add_one_plain(x)), \
        t(lambda: x + 1)
    b_ms, b_by = bound(M * 1024, 2 * nbytes(x))
    return {"shape": f"[{M}, 1024] bf16", "bytes": 2 * nbytes(x), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "gb_per_s": 2 * nbytes(x) / ms / 1e6}


def bench_gather(T: int, R: int, G: int, steps: int, device="cuda", iters: int = 20,
                 warmup: int = 5, seed: int = 0):
    """K6 at one setting: median ms of the kernel and of its plain version;
    the bound: each distinct tile the slots name read once (a tile drawn
    again is read again by the kernel, but need not come from memory
    again), the output written once, the slots read once, over the HBM
    rate; GB/s of all tile reads, ns per tile, the pool's bytes and whether
    it fits the L2. Where it does, the timed calls find the pool in the L2,
    so the HBM bound is no floor: ``hbm_share`` is None there."""
    dev = resolve_device(device)
    pool, slots = gather_inputs(T, R, G, steps, dev, seed)

    def t(fn):
        return time_fn(fn, iters=iters, warmup=warmup, device=dev)["median_ms"]

    ms, plain_ms = t(lambda: gather_tiles(pool, slots, R, G)), \
        t(lambda: gather_tiles_plain(pool, slots, R, G))
    tile_bytes = R * ROW * 2
    distinct = int(torch.unique(slots).numel())
    b_ms, b_by = bound(R * ROW, distinct * tile_bytes + tile_bytes + nbytes(slots))
    l2_resident = nbytes(pool) <= L2_BYTES
    return {"shape": f"R={R} G={G} steps={steps} T={T}", "R": R, "G": G, "steps": steps,
            "tile_bytes": tile_bytes, "distinct_tiles": distinct, "pool_bytes": nbytes(pool),
            "l2_resident": l2_resident, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "hbm_share": None if l2_resident else b_ms / ms,
            "gb_per_s": steps * G * tile_bytes / ms / 1e6, "ns_per_tile": ms * 1e6 / (steps * G)}


def gather_share(r) -> str:
    """A K6 row's share of its HBM bound, or why there is none."""
    if r["hbm_share"] is None:
        return "L2-resident, no HBM share"
    return f"{r['hbm_share']:.3f} of the HBM bound"


def bench_matmul(M: int, K: int, N: int, device="cuda", iters: int = 50, warmup: int = 5):
    """bf16 ``torch.matmul`` [M, K] @ [K, N] (fp32 accumulation, bf16 out):
    median ms, TFLOP/s and the share of the bf16 tensor-core peak."""
    dev = resolve_device(device)
    a = torch.ones((M, K), dtype=torch.bfloat16, device=dev)
    b = torch.ones((K, N), dtype=torch.bfloat16, device=dev)
    ms = time_fn(lambda: torch.matmul(a, b), iters=iters, warmup=warmup, device=dev)["median_ms"]
    tflops = 2 * M * K * N / ms / 1e9
    return {"shape": f"M{M} K{K} N{N}", "ms": ms, "tflops": tflops,
            "peak_share": tflops * 1e12 / BF16_FLOPS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}")
    ew = bench_ew(dev, args.iters)
    print(f"torch x + 1   128 MiB r+w: {ew['ms']:8.4f} ms -> {ew['gb_per_s']:7.1f} GB/s")
    c = bench_copy(device=dev, iters=args.iters)
    print(f"K5 copy       {c['shape']}: {c['ms']:8.4f} ms -> {c['gb_per_s']:7.1f} GB/s, bound "
          f"{c['bound_ms']:.4f} ms ({c['bound_ms'] / c['ms']:.3f} of it); torch x + 1 "
          f"{c['library_ms']:.4f} ms")
    for T, R, G, steps in GATHERS:
        r = bench_gather(T, R, G, steps, dev, args.iters)
        print(f"K6 gather     {r['shape']}: {r['ms']:8.4f} ms -> {r['gb_per_s']:7.1f} GB/s, "
              f"{r['ns_per_tile']:7.1f} ns/tile ({r['tile_bytes']} B tiles), pool "
              f"{r['pool_bytes'] / 1e6:.1f} MB, {r['distinct_tiles']} distinct tiles, "
              f"{gather_share(r)}; plain {r['plain_ms']:.4f} ms")
    for M, K, N in MATMULS:
        r = bench_matmul(M, K, N, dev)
        print(f"matmul bf16   {r['shape']}: {r['ms']:8.4f} ms -> {r['tflops']:7.1f} TFLOP/s "
              f"({r['peak_share']:.3f} of the bf16 peak)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
