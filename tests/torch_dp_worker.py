"""The data-parallel runs of tests/test_torch_parallel.py: the train steps
of one model at one rank, and the script each gloo rank runs.

Imports the port and torch only (no JAX), so a rank starts in a few
seconds. ``python tests/torch_dp_worker.py SPEC OUT RANK WORLD PORT`` joins
a gloo group on ``tcp://localhost:PORT`` and runs every job of the spec
file (``torch.save`` of ``{"cases": {name: {"cfg", "state", "batch"}},
"jobs": [{"name", "case", "steps", "without", "dtype"}]}``) on its rows of the
case's batch (``parallel.shard_batch``), then saves ``{job: run_steps(...)}``
to OUT. ``without`` names a sync to patch out: ``moments`` (each rank's
BatchNorm takes its own moments), ``normalisers`` (each rank's loss
normalisers and means count its own samples) or ``gradients`` (no sum of
the gradients after backward).
"""
import contextlib
import os
import sys
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bevfusion_tpu_torch import parallel  # noqa: E402
from bevfusion_tpu_torch.models import build_model  # noqa: E402
from bevfusion_tpu_torch.runtime.train import (build_lr_schedule,  # noqa: E402
                                               build_momentum_schedule, build_optimizer,
                                               make_train_step)

HORIZON = 100  # steps of the schedules


def run_steps(cfg, state, batch, steps, dtype=torch.float64):
    """``steps`` train steps of the model of ``cfg`` from ``state`` in
    ``dtype`` on ``batch`` through ``make_train_step`` (AdamW with clip 35,
    cyclic lr and momentum): per step the logs and every parameter's
    gradient as AdamW sees it (after the sum over the ranks; None where
    the parameter has none), then the state dict."""
    model = build_model(cfg, "cpu")
    model.load_state_dict(state, strict=True)
    model.to(dtype)
    batch = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
             for k, v in batch.items()}
    opt = build_optimizer({"lr": 1e-3, "weight_decay": 0.01},
                          build_lr_schedule({"policy": "cyclic"}, 1e-3, HORIZON), model,
                          grad_clip={"max_norm": 35},
                          momentum_schedule=build_momentum_schedule({"policy": "cyclic"}, 0.9,
                                                                    HORIZON))
    step = make_train_step(model, opt, "cpu", seed=0)
    params = dict(model.named_parameters())
    records = []
    for _ in range(steps):
        grads = {}

        def mark(phase):
            if phase == "backward":
                grads.update({n: None if p.grad is None else p.grad.clone()
                              for n, p in params.items()})

        logs = step(batch, mark)
        records.append({"logs": {k: float(v) for k, v in logs.items()}, "grads": grads})
    return {"steps": records, "state": {k: v.clone() for k, v in model.state_dict().items()}}


@contextlib.contextmanager
def without(sync):
    """The port with one of its syncs patched out (None: as it is)."""
    if sync is None:
        yield
        return
    if sync == "moments":
        moments = parallel.masked_moments

        def local(x, m, dims):
            with mock.patch.object(parallel, "active", lambda: False):
                return moments(x, m, dims)

        patch = mock.patch.object(parallel, "masked_moments", local)
    elif sync == "normalisers":
        patch = mock.patch.object(parallel, "count_sum", lambda t: t)
    elif sync == "gradients":
        patch = mock.patch.object(parallel, "sum_gradients", lambda params: None)
    else:
        raise ValueError(sync)
    with patch:
        yield


def main(spec_path, out_path, rank, world, port):
    torch.set_num_threads(1)
    parallel.init("cpu", "gloo", f"tcp://localhost:{port}", rank, world, timeout_s=300)
    spec = torch.load(spec_path, weights_only=False)
    out = {}
    for job in spec["jobs"]:
        case = spec["cases"][job["case"]]
        with without(job.get("without")):
            dtype = getattr(torch, job.get("dtype", "float64"))
            out[job["name"]] = run_steps(case["cfg"], case["state"],
                                         parallel.shard_batch(case["batch"], rank, world),
                                         job["steps"], dtype)
    torch.save(out, out_path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
