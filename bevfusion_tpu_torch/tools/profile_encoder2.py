"""The sparse encoder's meta chain alone and its whole forward, each timed as
one chain beside the per-op profile.

Counterpart of ``tools/profile_encoder2.py``, which times the windowed
encoder's meta chain (every site and rulebook op, no conv) and its whole
forward, each as one jitted program, to take out the per-dispatch overhead
that inflates ``tools/profile_encoder.py``'s per-op numbers. The port's
counterpart of one jitted program is ``utils/profiler.py:time_fn(...,
queue_ahead=True)``: the card waits until the host has queued the chain's
calls (its sleep sized from the warmup calls, at most 0.1 s). That reading
is the chain's time on the card without the host's gaps between launches
only as far as the wait and the card's launch queue (about a thousand
launches) hold the calls: past either, the host is back in it. No CUDA
graph, no ``torch.compile``. The host clock's reading (``queue_ahead=False``:
CUDA events between calls as they come) stands beside it, and the sums of
``profile_encoder``'s per-op rows beside both. The card's own time comes
from one call of each chain under ``torch.profiler``
(``utils/profiler.py:device_trace``): its kernels' busy time and the
share of the call's wall time the card is idle, so whether the card or
the host sets the chain's pace shows.

(a) ``meta_chain``: what the port's ``SparseEncoder.forward`` runs of sites
and rulebooks, in its order (``models/sparse_encoder.py``): the downsampled
sites of each sparse level (``sparse_sites``), the submanifold rulebook of
each level (``_subm_rulebooks``), the strided convs' (``_conv_rulebooks``),
and ``conv_out``'s sites and rulebook where the last level runs sparse. The
flagship's last level is dense (``dense_from_stage`` 3: stage 3 and
``conv_out`` on ``F.conv3d``), so its chain has no level-3 rulebook and no
``conv_out`` rulebook; they are printed as absent, as are the JAX chain's
TPU-only ops (``build_column_table``, ``build_windowed_rulebook``).
(b) the whole encoder forward at eval, bf16 by default (the JAX tool's
``dtype=jnp.bfloat16``: the bf16 kernels, 15 launches at the flagship),
``--dtype float32`` for fp32.

Both at the flagship's scan and the config's ``site_caps``, as
``tools/profile_encoder.py``.

Run: ``python -m bevfusion_tpu_torch.tools.profile_encoder2 [--dtype bfloat16|float32]``
(on the card).
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..devices import resolve_device
from ..models.sparse_encoder import _conv_rulebooks, _subm_rulebooks
from ..ops import sparse_conv as sp
from ..runtime import precision
from ..utils.profiler import card_line, device_trace, time_fn
from .profile_encoder import profile_encoder

TPU_ONLY = ("build_column_table", "build_windowed_rulebook")
# K1/K2's kernels, bf16 and fp32 (3xTF32), as the profiler names them
K12_KERNELS = ("sparse_conv_bf16_kernel", "sparse_conv_tc_kernel")


def last_level_sparse(enc) -> bool:
    """Whether ``enc``'s last level, and so ``conv_out``, runs sparse (no
    stage is dense)."""
    return not 0 <= enc.dense_from_stage < len(list(enc.encoder_layers.children()))


def meta_chain(enc, coords: torch.Tensor, mask: torch.Tensor) -> dict:
    """Every site and rulebook op of ``enc``'s eval forward on one sample
    (coords [M, 3], mask [M]), no conv, in the forward's order: {name:
    output}, ``"s{k} sites"`` (ids, mask) of each level after the first,
    ``"s{k} subm"`` each level's submanifold table, ``"s{k} conv"`` the
    strided conv's from level k, and where the last level is sparse
    ``"conv_out sites"`` and ``"conv_out conv"``."""
    out = {}
    with torch.no_grad():
        stages = enc.sparse_sites(coords, mask)
        for k, st in enumerate(stages):
            if k > 0:
                out[f"s{k} sites"] = (st["ids"], st["mask"])
            out[f"s{k} subm"] = _subm_rulebooks([st])[0]
            if st["down"] is not None:
                out[f"s{k} conv"] = _conv_rulebooks([st], [stages[k + 1]], st["down"][0], None,
                                                    enc.DOWN_KERNEL, enc.DOWN_STRIDE)[0][0]
        if last_level_sparse(enc):
            st, kernel, stride = stages[-1], enc.OUT_KERNEL, enc.OUT_STRIDE
            grid = sp.conv_out_shape(st["grid"], kernel, stride, 0)
            ids, m = sp.downsample_sites(st["ids"], st["grid"], kernel, stride, 0,
                                         st["ids"].shape[0])
            out["conv_out sites"] = (ids, m)
            out["conv_out conv"] = _conv_rulebooks([st], [{"ids": ids, "mask": m, "grid": grid}],
                                                   0, None, kernel, stride)[0][0]
    return out


def absent(enc, meta: dict) -> list:
    """The JAX chain's ops that ``enc``'s meta chain (``meta_chain``'s
    output) has no counterpart of."""
    rows = [f"{op} (TPU-only, not ported)" for op in TPU_ONLY]
    if not last_level_sparse(enc):
        levels = sum(name.endswith(" subm") for name in meta)
        rows += [f"s{levels} rulebooks (level {levels} is dense in the port)",
                 "conv_out sites and rulebook (dense in the port)"]
    return rows


def encoder_forward(enc, feats, coords, mask, dtype, device):
    """One eval forward of ``enc`` on one sample at ``dtype`` (feats [M, C]
    cast to it, the forward under the model's autocast)."""
    with torch.no_grad(), precision.autocast(dtype, device):
        return enc(precision.to_compute(feats, dtype)[None], coords[None], mask[None])


def profile_encoder2(enc, feats, coords, mask, device="cuda", dtype=torch.bfloat16,
                     iters: int = 10, warmup: int = 3) -> dict:
    """(a) the meta chain and (b) the whole forward of ``enc`` (at eval),
    each timed as one chain, queued ahead and on the host clock (median ms
    a call), beside the sums of ``profile_encoder``'s per-op rows (its meta
    rows, all its rows) at the same dtype, and one call of each traced
    (``device_trace``): {"meta_ms", "meta_host_ms", "meta_ops_ms",
    "meta_trace", "encoder_ms", "encoder_host_ms", "encoder_ops_ms",
    "encoder_trace", "absent": [...], "dtype"}."""
    dev = resolve_device(device)

    def timed(fn, queue_ahead):
        return time_fn(fn, iters=iters, warmup=warmup, device=dev,
                       queue_ahead=queue_ahead)["median_ms"]

    def meta():
        return meta_chain(enc, coords, mask)

    def forward():
        return encoder_forward(enc, feats, coords, mask, dtype, dev)

    with precision.autocast(dtype, dev), torch.no_grad():
        rows, _ = profile_encoder(enc, precision.to_compute(feats, dtype), coords, mask, dev,
                                  iters, warmup)
    return {"dtype": precision.dtype_name(dtype),
            "meta_ms": timed(meta, True), "meta_host_ms": timed(meta, False),
            "meta_ops_ms": sum(r["ms"] for r in rows if "meta:" in r["op"]),
            "meta_trace": device_trace(meta, device=dev),
            "encoder_ms": timed(forward, True), "encoder_host_ms": timed(forward, False),
            "encoder_ops_ms": sum(r["ms"] for r in rows),
            "encoder_trace": device_trace(forward, K12_KERNELS, dev),
            "absent": absent(enc, meta())}


def trace_line(t) -> str:
    """A ``device_trace`` result in one line."""
    return (f"{t['device_busy_ms']:8.3f} ms busy of {t['wall_ms']:.3f} wall, idle "
            f"{100 * t['idle_share']:.1f}%, {t['device_activities']} kernels and copies (the "
            f"sessions saw {t['activities_per_session']})")


def print_result(r, width: int = 52) -> None:
    print(f"{'meta chain (all rulebooks, queued ahead)':{width}s} {r['meta_ms']:8.3f} ms")
    print(f"{'meta chain (host clock)':{width}s} {r['meta_host_ms']:8.3f} ms")
    print(f"{'meta chain (profile_encoder meta rows, summed)':{width}s} "
          f"{r['meta_ops_ms']:8.3f} ms")
    print(f"{'meta chain (one call traced)':{width}s} {trace_line(r['meta_trace'])}")
    for op in r["absent"]:
        print(f"{'  ' + op:{width}s} absent")
    print(f"{'full encoder ' + r['dtype'] + ' (queued ahead)':{width}s} {r['encoder_ms']:8.3f} ms")
    print(f"{'full encoder ' + r['dtype'] + ' (host clock)':{width}s} "
          f"{r['encoder_host_ms']:8.3f} ms")
    print(f"{'full encoder (profile_encoder rows, summed)':{width}s} "
          f"{r['encoder_ops_ms']:8.3f} ms")
    t = r["encoder_trace"]
    print(f"{'full encoder (one call traced)':{width}s} {trace_line(t)}; K1/K2 "
          f"{t['mark_ms']:.3f} ms; most device time: " + "; ".join(
              f"{k['name']} x{k['count']} {k['ms']:.3f} ms" for k in t["top"]))


def main(argv=None) -> int:
    from ..runtime.flagship import build_flagship

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=120000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16", choices=list(precision.COMPUTE_DTYPES))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"device: {card_line()}")
    precision.apply_tf32_defaults()
    dtype = precision.parse_dtype(args.dtype)
    _, model, batch = build_flagship(dev, num_points=args.points, dtype=dtype)
    with torch.no_grad():
        vox = model.lidar_voxelize(batch["points"], batch["points_mask"])
    print_result(profile_encoder2(model.encoders["lidar"]["backbone"], vox.feats[0],
                                  vox.coords[0], vox.mask[0], dev, dtype, args.iters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
