"""Data parallelism on ``torch.distributed`` (bevfusion_tpu_torch/parallel),
on the CPU over gloo.

The contract: a train step at world size N with b samples a rank computes
the one-process step of the global batch of N*b samples (the JAX package's
GSPMD step, tests/test_parallel.py): the same losses, gradients, BatchNorm
running statistics and parameters after AdamW, up to summation order.

- Two gloo ranks x 1 sample against one process at B = 2, two steps, in
  float64 (``RTOL``), on three tiny models that between them hold every
  normaliser the port sums over the ranks: the fused TransFusion detector
  (``num_pos``, the heatmap's ``avg_factor``, ``matched_ious``), the camera
  CenterHead detector with BEVDepth's depth loss (``num_pos``, ``num``, the
  depth foreground) and the fused seg model (the means). The two samples
  differ in ground-truth count, active voxels and depth foreground, so a
  per-rank normaliser or per-rank moments would show. The ranks end with
  the same bits.
- The same comparison fails with each sync patched out (the BatchNorm
  moments, the normalisers, the gradient sum).
- With no process group the step issues no collective; rank 0 keeps the
  one-process dropout seed, the other ranks' share no field with it; the
  BatchNorm helper both norms take under data parallelism is torch's.
- The loader's training shard at world sizes 2 and 3.
- ``tools/train.py`` as two CPU processes for two epochs against one
  process at twice ``samples_per_gpu``; a checkpoint of either world size
  resumes at the other.
- ``slow``: the port's 2-rank step against the JAX package's 2-device GSPMD
  step in a subprocess (as tests/test_parallel.py runs it).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from bevfusion_tpu_torch import parallel
from bevfusion_tpu_torch.data import DataLoader
from bevfusion_tpu_torch.data.transforms import GTDepth
from bevfusion_tpu_torch.models import build_model
from bevfusion_tpu_torch.runtime import flagship
from bevfusion_tpu_torch.tools import train as train_cli
from tests.test_bevfusion_model import make_batch, tiny_fused_config
from tests.test_torch_camera_det_model import tiny_det_config
from tests.torch_dp_worker import HORIZON, run_steps
from bevfusion_tpu_torch.runtime.train import build_lr_schedule

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
RTOL = 1e-9  # float64, relative in norm per tensor: summation order only
ZERO = 1e-9  # of the largest norm in the group: a tensor zero but for rounding
STEPS = 2
LR_SCHEDULE = build_lr_schedule({"policy": "cyclic"}, 1e-3, HORIZON)  # run_steps' schedule
# fp32 train CLI runs, the losses of world 2 against world 1 from the same weights: the
# first step's differ by rounding (measured 6.7e-7); the tiny model's fp32 training then
# amplifies it step by step (6.5e-3 by the sixth; tests/test_torch_camera_det_model.py
# measures 2-65% moves of these models' fp32 gradients under rounding)
CLI_FIRST_RTOL = 1e-5
CLI_RTOL = 5e-2
ADAM_NOISE = 2.0  # |update| / lr of Adam on a rounding-level gradient, with margin
CASES = ("transfusion", "centerhead-depth", "seg")
SYNCS = ("moments", "normalisers", "gradients")


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _case(name):
    """(model config, global batch of 2 as CPU tensors): sample 1 has fewer
    valid boxes and a masked tail of points (fewer active voxels, less depth
    foreground) than sample 0."""
    cfg = {"transfusion": lambda: tiny_fused_config(),
           "centerhead-depth": lambda: tiny_det_config("bevdepth"),
           "seg": lambda: tiny_fused_config(head="map")}[name]()
    batch = {k: np.array(v) for k, v in make_batch(B=2, G=16 if name != "transfusion" else 4,
                                                   seed=5).items()}
    batch["gt_valid"][1, batch["gt_valid"].shape[1] // 2:] = False
    batch["points_mask"][1, 160:] = False
    if name == "seg":
        batch["gt_masks_bev"] = (np.random.RandomState(6).rand(2, 2, 16, 16) < 0.3).astype(
            np.float32)
    if name == "centerhead-depth":
        batch["depths"] = np.stack([GTDepth()({
            "points": batch["points"][b][batch["points_mask"][b]], "img": list(batch["img"][b]),
            **{k: batch[k][b] for k in ("lidar2image", "img_aug_matrix", "lidar_aug_matrix")}
        })["depths"] for b in range(2)])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["img"] = tb["img"].permute(0, 1, 4, 2, 3).contiguous()  # NHWC -> [B, N, 3, H, W]
    return cfg, tb


def spawn_ranks(argv_of, world=2, timeout=600, env=None):
    """``world`` processes ``argv_of(rank)``; their stdout, each exit 0."""
    procs = [subprocess.Popen(argv_of(r), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=dict(os.environ, **(env(r) if env else {})))
             for r in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert [p.returncode for p in procs] == [0] * world, "\n".join(outs)
    return outs


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The one-process runs at B = 2 and each rank's runs (a job a case, and
    one step of the TransFusion model with each sync patched out), from one
    launch of two gloo ranks."""
    tmp = tmp_path_factory.mktemp("dp")
    cases = {}
    for name in CASES:
        cfg, batch = _case(name)
        model = flagship.init_weights(build_model(cfg, "cpu"), seed=3)
        cases[name] = {"cfg": cfg, "state": model.state_dict(), "batch": batch}
    jobs = [{"name": n, "case": n, "steps": STEPS} for n in CASES]
    jobs += [{"name": f"without-{s}", "case": "transfusion", "steps": 1, "without": s}
             for s in SYNCS]
    spec = str(tmp / "spec.pt")
    torch.save({"cases": cases, "jobs": jobs}, spec)
    port = free_port()
    spawn_ranks(lambda r: [sys.executable, WORKER, spec, str(tmp / f"out_{r}.pt"), str(r), "2",
                           str(port)])
    ranks = [torch.load(tmp / f"out_{r}.pt", weights_only=False) for r in range(2)]
    refs = {n: run_steps(c["cfg"], c["state"], c["batch"], STEPS) for n, c in cases.items()}
    return refs, ranks, cases


def _gap(got, want):
    """Relative gap in norm of two tensors (None counts as zero)."""
    got = torch.zeros_like(want) if got is None else got
    return float((got.double() - want.double()).norm()), float(want.double().norm())


def mismatches(ref, run, steps=STEPS, rtol=RTOL):
    """What of ``run`` is off ``ref`` (same weights, same global batch) by
    more than ``rtol`` relative in norm: each step's logs and each gradient,
    then the final parameters and BatchNorm running statistics. A tensor
    whose norm is below ``ZERO`` of its group's largest is held to that
    floor instead. A parameter whose gradient was such rounding noise at a
    step (a conv bias before a BatchNorm) is held to AdamW's steps: Adam
    scales a rounding-level gradient to an update of about the learning
    rate, whatever its sign, so each element may move by ``ADAM_NOISE`` x the
    learning rates' sum. Returns [(what, gap)] and the largest gap of those
    held."""
    bad, worst = [], 0.0

    def held(what, diff, norm, floor):
        nonlocal worst
        if diff <= floor:
            return
        if diff <= rtol * norm:
            worst = max(worst, diff / norm)
        else:
            bad.append((what, diff / norm if norm > floor else diff))

    noise = set()
    for i in range(steps):
        want, got = ref["steps"][i], run["steps"][i]
        for k, v in want["logs"].items():
            held(f"step {i} {k}", abs(got["logs"][k] - v), abs(v), 0.0)
        grads = {n: g for n, g in want["grads"].items() if g is not None}
        floor = ZERO * max(float(g.double().norm()) for g in grads.values())
        noise |= {n for n, g in grads.items() if float(g.double().norm()) <= floor}
        for n, g in grads.items():
            held(f"step {i} grad {n}", *_gap(got["grads"][n], g), floor)
    lr = sum(LR_SCHEDULE(t) for t in range(steps))
    floats = {k: v for k, v in ref["state"].items() if v.is_floating_point()}
    for kind, keys in (("param", [k for k in floats if "running" not in k]),
                       ("bn stats", [k for k in floats if "running" in k])):
        floor = ZERO * max(float(floats[k].double().norm()) for k in keys)
        for k in keys:
            if k in noise:
                floor_k = ADAM_NOISE * lr * floats[k].numel() ** 0.5
                held(f"{kind} {k} (noise gradient)", *_gap(run["state"][k], floats[k]), floor_k)
            else:
                held(f"{kind} {k}", *_gap(run["state"][k], floats[k]), floor)
    return bad, worst


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_one_process_at_the_global_batch(dp_runs, case):
    """Two steps at 2 ranks x 1 sample against one process at B = 2: every
    loss, every gradient, the parameters after AdamW and the BatchNorm
    running statistics within RTOL; the ranks' final states bit-equal; every
    normaliser's count differs between the two samples."""
    refs, ranks, cases = dp_runs
    for r, run in enumerate(ranks):
        bad, worst = mismatches(refs[case], run[case])
        assert not bad, (r, bad[:5])
        assert worst > 0.0 or case == "seg", worst  # not one process run twice
    a, b = (run[case]["state"] for run in ranks)
    assert all(torch.equal(a[k], b[k]) for k in a)
    batch = cases[case]["batch"]
    assert int(batch["gt_valid"][0].sum()) != int(batch["gt_valid"][1].sum())
    assert int(batch["points_mask"][0].sum()) != int(batch["points_mask"][1].sum())
    if case == "centerhead-depth":
        fg = [(batch["depths"][b] > 0).sum().item() for b in range(2)]
        assert fg[0] != fg[1]


@pytest.mark.parametrize("sync", SYNCS)
def test_the_comparison_fails_with_a_sync_patched_out(dp_runs, sync):
    """The TransFusion step of the ranks with one sync patched out misses the
    one-process step: its gradients (and, without the moments' sum, the
    BatchNorm statistics) leave the tolerance."""
    refs, ranks, _ = dp_runs
    for run in ranks:
        bad, _ = mismatches(refs["transfusion"], run[f"without-{sync}"], steps=1)
        kinds = {what.split()[2] if what.startswith("step") else what.split()[0]
                 for what, _ in bad}
        assert "grad" in kinds, bad[:5]
        if sync == "moments":
            assert "bn" in kinds, bad[:5]


def test_without_a_group_the_step_issues_no_collective(monkeypatch):
    """No process group: every parallel function is the one-process code and
    no collective runs (``torch.distributed``'s are patched to raise); two
    steps equal themselves bit for bit."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective ran without a process group")

    for name in ("all_reduce", "broadcast", "barrier"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    cfg, batch = _case("transfusion")
    state = flagship.init_weights(build_model(cfg, "cpu"), seed=3).state_dict()
    a = run_steps(cfg, state, batch, 1, dtype=torch.float32)
    b = run_steps(cfg, state, batch, 1, dtype=torch.float32)
    assert parallel.world() == 1 and parallel.rank() == 0 and not parallel.active()
    assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
    x = torch.randn(3, 4, requires_grad=True)
    assert parallel.all_sum(x) is x and torch.equal(parallel.count_sum(x.detach()), x.detach())
    assert parallel.replicate_state({"x": x}) == []
    parallel.assert_replicated({"x": x})
    assert torch.equal(parallel.mean(x), x.mean())


def test_step_seed_keeps_rank_0_and_gives_other_ranks_their_own_streams():
    """Rank 0 draws the one-process stream (``seed * 2**32 + step``); another
    rank's seed is a digest that shares no field with rank 0's, so (seed,
    rank 1) is not (seed + 2**24, rank 0), and every (seed, step, rank)
    gives its own seed, within the generator's 64 bits."""
    from bevfusion_tpu_torch.runtime.train import step_seed

    assert step_seed(3, 5) == step_seed(3, 5, 0) == 3 * 2**32 + 5
    assert step_seed(3, 5, 1) != step_seed(3 + 2**24, 5, 0)
    seeds = [step_seed(s, t, r) for s in (0, 1, 2**24) for t in (0, 1, 7) for r in range(4)]
    assert len(set(seeds)) == len(seeds)
    for r in range(1, 4):
        torch.Generator().manual_seed(step_seed(2**32 - 1, 2**32 - 1, r))


def test_batch_norm_train_is_the_one_process_batch_norm():
    """``layers.batch_norm_train``, the training forward both BatchNorms take
    under data parallelism (and the masked one always), against torch's
    batch norm and the one-process running statistics at world size 1."""
    from bevfusion_tpu_torch.models.layers import BatchNorm2d, batch_norm_train

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 4, 5, generator=g, dtype=torch.float64) * 3 + 1
    a, b = BatchNorm2d(3).double().train(), BatchNorm2d(3).double().train()
    with torch.no_grad():
        for bn in (a, b):
            bn.weight.copy_(torch.tensor([0.5, 1.0, 2.0]))
            bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    want = a(x)
    got = batch_norm_train(b, x, None, [0, 2, 3])
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    for k in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.allclose(getattr(b, k).double(), getattr(a, k).double(), rtol=1e-12), k
    m = (torch.rand(2, 1, 4, 5, generator=g) < 0.5).double()
    bn = BatchNorm2d(3).double().train()
    y = batch_norm_train(bn, x, m, [0, 2, 3])
    mean = (x * m).sum((0, 2, 3)) / m.sum()
    assert torch.allclose(bn.running_mean, 0.9 * torch.zeros(3, dtype=torch.float64) + 0.1 * mean)
    assert torch.allclose((y * m).sum((0, 2, 3)), m.sum() * bn.bias.detach(), atol=1e-9)


def test_backend_is_explicit():
    assert parallel.backend_for("cpu") == "gloo"
    assert parallel.backend_for("cpu", "gloo") == "gloo"
    assert parallel.backend_for("cuda", "gloo") == "gloo"
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        parallel.backend_for("cpu", "nccl")
    with pytest.raises(ValueError, match="mpi"):
        parallel.backend_for("cpu", "mpi")
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match="no NCCL"):
            parallel.backend_for("cuda")


def test_shard_batch_takes_contiguous_rows():
    batch = {"x": torch.arange(6)[:, None], "metas": list("abcdef"), "pool_lut": {}}
    parts = [parallel.shard_batch(batch, r, 3) for r in range(3)]
    assert [p["x"].flatten().tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    assert [p["metas"] for p in parts] == [["a", "b"], ["c", "d"], ["e", "f"]]
    assert all("pool_lut" not in p for p in parts)
    with pytest.raises(ValueError, match="multiple of 4"):
        parallel.shard_batch(batch, 0, 4)


class _Numbers:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"points": np.array([i])}


@pytest.mark.parametrize("world", [2, 3])
def test_training_shard_is_each_ranks_rows_of_the_global_batches(world):
    """Uneven lengths, shuffled, ``drop_last``: rank r's batch k is rows
    [r*b, (r+1)*b) of the one-process loader's batch k at world*b, and
    every rank yields the same number of batches, floor(n / (world*b))."""
    b = 2
    for n in (13, 14, 2 * world * b + 1):
        one = DataLoader(_Numbers(n), batch_size=world * b, shuffle=True, seed=4, num_workers=2)
        one.set_epoch(1)
        want = [x["points"][:, 0].tolist() for x in one]
        got = []
        for r in range(world):
            dl = DataLoader(_Numbers(n), batch_size=b, shuffle=True, seed=4, num_workers=2,
                            replicas=world, replica=r)
            dl.set_epoch(1)
            got.append([x["points"][:, 0].tolist() for x in dl])
            assert len(dl) == n // (world * b) == len(got[-1])
        assert [sum((g[k] for g in got), []) for k in range(len(want))] == want
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(_Numbers(5), batch_size=1, drop_last=False, replicas=2)


# ---------------------------------------------------------------- the train CLI

CLI_CODE = ("import sys, json; sys.path.insert(0, {root!r})\n"
            "import torch; torch.set_num_threads(1)\n"
            "import tests.torch_port_helpers  # registers the test-only map targets\n"
            "from bevfusion_tpu_torch.tools import train\n"
            "for argv in json.loads(sys.argv[1]):\n"
            "    out = train.main(argv)\n"
            "    print('OUT', json.dumps({{k: out[k] for k in ('rank', 'world', 'steps_per_epoch',\n"
            "        'start_epoch', 'checkpoints', 'replicated', 'eval')}}\n"
            "        | {{'losses': [r['loss'] for r in out['history']]}}))\n")


CLI_TIMEOUT = 240  # s for both jobs of both ranks: ~8x an idle machine's ~30 s


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The tiny seg model's train CLI (its per-epoch map eval on): W1, one
    process at samples_per_gpu 2, two epochs; W2, two gloo processes at 1,
    two epochs, then resumed from W1's epoch_1; last W1 resumed from W2's."""
    from tests.test_torch_train_cli import config_file, write_set

    root = write_set(str(tmp_path_factory.mktemp("nusc")))
    tmp = tmp_path_factory.mktemp("runs")
    path = config_file(root, "map")

    def argv(run, *extra):
        return [path, "--run-dir", str(tmp / run), "--device", "cpu", *extra]

    w1 = train_cli.main(argv("w1"))
    port = free_port()
    jobs = [argv("w2", "data.samples_per_gpu=1"),
            argv("w2_from_w1", "--resume-from", str(tmp / "w1" / "epoch_1"),
                 "data.samples_per_gpu=1")]
    outs = spawn_ranks(  # ~30 s on an idle machine; a hang fails at CLI_TIMEOUT
        lambda r: [sys.executable, "-c", CLI_CODE.format(root=ROOT), json.dumps(jobs)],
        timeout=CLI_TIMEOUT, env=lambda r: {"WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
    w2 = [[json.loads(line[4:]) for line in o.splitlines() if line.startswith("OUT ")]
          for o in outs]
    w1_from_w2 = train_cli.main(argv("w1_from_w2", "--resume-from", str(tmp / "w2" / "epoch_1")))
    return tmp, w1, w2, w1_from_w2


def losses_close(got, want):
    """Two runs' losses from the same state: the first step's within
    ``CLI_FIRST_RTOL``, every one within ``CLI_RTOL``."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    assert len(got) == len(want) and gaps[0] <= CLI_FIRST_RTOL and max(gaps) <= CLI_RTOL, gaps


def test_train_cli_two_processes_equal_one_process_at_twice_the_batch(cli_runs):
    """Both ranks take the one-process run's steps an epoch and log its
    losses (the global batch's, the same bits on both ranks; ``losses_close``);
    rank 0 alone writes the checkpoints, the config and the
    log, and evaluates; every rank started from rank 0's weights unchanged."""
    tmp, w1, w2, _ = cli_runs
    (r0, _), (r1, _) = w2
    assert (r0["rank"], r1["rank"], r0["world"], r1["world"]) == (0, 1, 2, 2)
    assert r0["steps_per_epoch"] == r1["steps_per_epoch"] == w1["steps_per_epoch"] >= 2
    assert len(r0["losses"]) == len(r1["losses"]) == 2 * w1["steps_per_epoch"]
    assert r0["losses"] == r1["losses"]
    losses_close(r0["losses"], [r["loss"] for r in w1["history"]])
    assert r0["checkpoints"] == [str(tmp / "w2" / f"epoch_{e}") for e in (1, 2)]
    assert r1["checkpoints"] == [] and r0["replicated"] == r1["replicated"] == []
    assert sorted(os.listdir(tmp / "w2")) == ["configs.yaml", "epoch_1", "epoch_2",
                                               "eval_epoch_1", "eval_epoch_2", "metrics.jsonl"]
    assert r1["eval"] == {} and set(r0["eval"]) == {"1", "2"}
    for epoch, metrics in r0["eval"].items():
        assert set(metrics) == set(w1["eval"][int(epoch)])
        assert all(np.isfinite(v) for v in metrics.values())
    ckpt = torch.load(tmp / "w2" / "epoch_2", map_location="cpu", weights_only=False)
    assert ckpt["meta"] == {"epoch": 2, "iter": 2 * w1["steps_per_epoch"]}


def test_checkpoints_resume_across_world_sizes(cli_runs):
    """A world-1 checkpoint resumes at world 2 and a world-2 one at world 1:
    the resumed epoch's losses are the uninterrupted runs' (``losses_close``)."""
    _, w1, w2, w1_from_w2 = cli_runs
    n = w1["steps_per_epoch"]
    want = [r["loss"] for r in w1["history"]][n:]
    for run in (w2[0][1], w2[1][1]):
        assert run["start_epoch"] == 1 and len(run["losses"]) == n
        losses_close(run["losses"], want)
    assert w1_from_w2["start_epoch"] == 1
    losses_close([r["loss"] for r in w1_from_w2["history"]], w2[0][0]["losses"][n:])


REJOIN_CODE = ("import sys; sys.path.insert(0, {root!r})\n"
               "import torch, torch.distributed as dist\n"
               "from bevfusion_tpu_torch import parallel\n"
               "for i in range({n}):\n"
               "    r, w, joined = parallel.join('cpu')\n"
               "    assert joined and w == 2\n"
               "    x = parallel.all_sum(torch.full((3,), float(r + 1 + i)))\n"
               "    print('SUM', i, x.tolist(), flush=True)\n"
               "    dist.destroy_process_group()\n")
REJOINS = 12
REJOIN_TIMEOUT = 60  # s: a working run takes ~5 s; a second join that meets the old
# group's store waits on it for good (torch's 30-minute default) and is killed here


def test_ranks_join_destroy_and_join_again_on_one_port():
    """Two gloo processes join through torchrun's environment, take a
    collective and destroy the group ``REJOINS`` times on one
    ``MASTER_PORT``, as the train CLI's jobs do in one process: every group
    is a new rendezvous (``parallel.init`` keeps one store a process and a
    key prefix a group), so no rank meets the store of the group before.
    Joining through ``env://`` afresh each time hung or broke in 1 of 3
    six-join runs and in 5 of 7 CLI fixtures on an idle machine."""
    port = free_port()
    outs = spawn_ranks(
        lambda r: [sys.executable, "-c", REJOIN_CODE.format(root=ROOT, n=REJOINS)],
        timeout=REJOIN_TIMEOUT,
        env=lambda r: {"WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
    for out in outs:
        sums = [line.split(" ", 2)[1:] for line in out.splitlines() if line.startswith("SUM ")]
        assert sums == [[str(i), str([2.0 * i + 3.0] * 3)] for i in range(REJOINS)], out


def test_tiny_dryrun_is_the_tests_tiny_model_and_steps_at_two_ranks():
    """``parallel/dryrun.py`` (the counterpart of
    ``__graft_entry__.dryrun_multichip``): its config is the tiny fused model
    of tests/test_bevfusion_model.py and its batch that file's
    ``make_batch``; two gloo processes take one finite step."""
    from bevfusion_tpu_torch.parallel import dryrun

    assert dryrun.TINY_FUSED == tiny_fused_config()
    want = {k: np.asarray(v) for k, v in make_batch(B=2, seed=3).items()}
    want["img"] = want["img"].transpose(0, 1, 4, 2, 3)
    got = dryrun.tiny_batch(B=2, seed=3)
    assert set(got) == set(want) and all(np.array_equal(got[k].numpy(), want[k]) for k in want)
    out = subprocess.run([sys.executable, "-m", "bevfusion_tpu_torch.parallel.dryrun",
                          "--ranks", "2"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dryrun_multichip(2): ok, loss/total=" in out.stdout


# ---------------------------------------------------------------- against the JAX step

JAX_WORKER = r"""
import os, pickle, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bevfusion_tpu.models import build_model
from tests.test_bevfusion_model import make_batch, tiny_fused_config
from tests.test_torch_train_grad import RIG_SEED, _train_outputs
from tests.torch_port_helpers import jittered_rig, random_variables

cfg = tiny_fused_config()
batch = {k: np.array(v) for k, v in make_batch(B=2, G=6).items()}
batch["gt_valid"][1, 3:] = False
batch["points_mask"][1, 160:] = False
batch.update(jittered_rig(batch, RIG_SEED))
variables = random_variables(build_model(cfg).init,
                             {k: v for k, v in batch.items() if not k.startswith("gt_")}, seed=12)
variables["params"]["head_modules_object"]["heatmap_conv1"]["conv"]["kernel"] *= 0.2
jm = build_model(cfg, dtype=jnp.float64)  # flax's fp32 variance is 2-5% off (ROADMAP Queue 3)
f64 = lambda t: jax.tree_util.tree_map(
    lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, t)
v64, b64 = f64(variables), f64(batch)
mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
dp, repl = NamedSharding(mesh, P("dp")), NamedSharding(mesh, P())

def loss_fn(params, b):
    (losses, _), new_vars = jm.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                     b, method=_train_outputs,
                                     mutable=["batch_stats", "intermediates"])
    total = sum(v for k, v in losses.items() if k.startswith("loss/"))
    return total, (losses, new_vars["batch_stats"])

step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), in_shardings=(repl, dp))
sharded = {k: jax.device_put(jnp.asarray(v), dp) for k, v in b64.items()}
assert len(sharded["points"].sharding.device_set) == 2
(total, (losses, stats)), grads = step(jax.device_put(v64["params"], repl), sharded)
to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
with open(sys.argv[1], "wb") as f:
    pickle.dump({"cfg": cfg, "batch": batch, "variables": to_np(variables), "total": float(total),
                 "losses": to_np(losses), "stats": to_np(stats), "grads": to_np(grads)}, f)
"""


@pytest.mark.slow
def test_two_ranks_equal_the_jax_two_device_step(tmp_path):
    """The JAX package's train forward and backward as one GSPMD program over
    a 2-device CPU mesh (batch sharded on ``dp``, parameters replicated; the
    tiny fused model of tests/test_torch_train_grad.py at B = 2, the samples'
    boxes and points apart) against the port's step at 2 gloo ranks x 1
    sample on the bridged weights, both in float64 (in fp32 the sparse depth
    branch's first weight gradient came out 79% off the JAX one, where
    flax's E[x^2] - E[x]^2 variance cancels: ROADMAP Queue 3): the losses to ``LOSS_RTOL``, every
    gradient to ``GRAD_RTOL`` in norm (the zero-but-for-rounding ones to
    ``ZERO_GRAD`` of the global norm), the BatchNorm running statistics after
    the forward to ``STATS_RTOL`` (tests/test_torch_train_grad.py's gates for
    one process against ``jax.value_and_grad``)."""
    import pickle

    from bevfusion_tpu_torch.runtime.bridge import jax_to_torch_state_dict
    from tests.test_torch_train_grad import GRAD_RTOL, LOSS_RTOL, STATS_RTOL, ZERO_GRAD
    from tests.torch_port_helpers import rel_err

    out = tmp_path / "jax.pkl"
    env = dict(os.environ, REPO_ROOT=ROOT, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=2").strip())
    proc = subprocess.run([sys.executable, "-c", JAX_WORKER, str(out)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = pickle.load(open(out, "rb"))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in want["batch"].items()}
    batch["img"] = batch["img"].permute(0, 1, 4, 2, 3).contiguous()
    spec = str(tmp_path / "spec.pt")
    torch.save({"cases": {"jax": {"cfg": want["cfg"], "batch": batch,
                                  "state": jax_to_torch_state_dict(want["variables"])}},
                "jobs": [{"name": "jax", "case": "jax", "steps": 1}]}, spec)
    port = free_port()
    spawn_ranks(lambda r: [sys.executable, WORKER, spec, str(tmp_path / f"out_{r}.pt"), str(r),
                           "2", str(port)])
    got = torch.load(tmp_path / "out_0.pt", weights_only=False)["jax"]
    logs = got["steps"][0]["logs"]
    for k, v in want["losses"].items():
        assert abs(logs[k] - float(v)) <= LOSS_RTOL * max(abs(float(v)), 1e-6), (k, logs[k], v)
    assert abs(logs["loss/total"] - want["total"]) <= LOSS_RTOL * abs(want["total"])
    grads = got["steps"][0]["grads"]
    ref = {k: w for k, w in jax_to_torch_state_dict({"params": want["grads"]}).items()
           if k in grads}
    assert set(ref) == set(grads) and all(g is not None for g in grads.values())
    global_norm = np.sqrt(sum(float(np.sum(w.numpy() ** 2)) for w in ref.values()))
    bad = {}
    for k, w in ref.items():
        diff, norm = _gap(grads[k], w)
        limit = ZERO_GRAD * global_norm if norm <= ZERO_GRAD * global_norm else GRAD_RTOL * norm
        if diff > limit:
            bad[k] = diff / max(norm, 1e-30)
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:8]
    stats = jax_to_torch_state_dict({"batch_stats": want["stats"]})
    keys = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 40
    for k in keys:
        assert rel_err(got["state"][k].numpy(), stats[k].numpy()) <= STATS_RTOL, k


def test_flagship_dryrun_tool_on_the_cpu():
    """``tools/dryrun_flagship_sharded.py``'s pieces at a tiny size (the card
    runs it at full width, chip_smoke.py's tools phase): a rank's rows of the
    global synthetic batch with its own targets and pooling LUT; a rank's
    steps with the launch counts (0: the CPU runs the plain versions); the
    launcher refuses NCCL without a card for each rank."""
    from bevfusion_tpu_torch.config import Config, load_config
    from bevfusion_tpu_torch.parallel.dryrun import PCR, TINY_FUSED, tiny_batch
    from bevfusion_tpu_torch.tools import dryrun_flagship_sharded as tool

    cfg = Config.from_dict({"model": TINY_FUSED, "image_size": [32, 64],
                            "point_cloud_range": PCR})
    whole = flagship.synthetic_batch(cfg, B=2, num_points=500, seed=1, training=True)
    got = tool.rank_batch(cfg, 1, 2, "cpu", num_points=500, seed=1)
    for k in ("img", "points", "gt_boxes", "camera2lidar"):
        assert torch.equal(got[k], whole[k][1:2]), k
    assert got["depths"].shape[:2] == (1, 6) and "cell_ids" in got["pool_lut"]
    train_cfg = load_config(flagship.FLAGSHIP_CONFIG)  # its optimizer, clip and schedules
    model = flagship.init_weights(build_model(TINY_FUSED, "cpu"), seed=0)
    out = tool.rank_steps(train_cfg, model, tiny_batch(B=1), "cpu", steps=1)
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    assert out["launches_per_step"] == dict.fromkeys(tool.counters(), 0.0)
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        tool.main(["--device", "cpu", "--dist-backend", "nccl"])


def test_flagship_dryrun_tool_takes_no_step_at_zero_steps():
    """``--steps 0`` (chip_smoke.py's tools phase): a rank builds and holds its
    weights but runs no step, so nothing is launched and nothing moves."""
    from bevfusion_tpu_torch.config import load_config
    from bevfusion_tpu_torch.parallel.dryrun import TINY_FUSED, tiny_batch
    from bevfusion_tpu_torch.tools import dryrun_flagship_sharded as tool

    model = flagship.init_weights(build_model(TINY_FUSED, "cpu"), seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = tool.rank_steps(load_config(flagship.FLAGSHIP_CONFIG), model, tiny_batch(B=1), "cpu",
                          steps=0)
    assert out == {"losses": [], "step_ms": [], "peak_mem_bytes": None,
                   "launches_per_step": dict.fromkeys(tool.counters(), 0.0)}
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
