"""The numerics of the weight-gradient kernel's summation, on the CPU: the
fp32 form (3xTF32) first, then the bf16 form (below).

``csrc/sparse_conv_dw.cu`` sums ``dW[k] = sum_o feats[nbr[k, o]]^T dout[o]``
with the output sites as the reduction depth, on the tensor cores in the
3xTF32 split, hundreds of 8-site mma steps deep. A block takes one offset
and one chunk of ``sp.DW_CHUNK`` output sites and compacts its hit pairs in
site order. P, the wider of the gathered dout and feats rows, is the mma's
M side; the 8 warps split P's 16-row slabs and, where there are fewer than
8, the steps (warp group g takes steps g, g + G, ...). Per step each warp
adds the big*big' product, taken from a zero accumulator, to its own sum on
the FP32 units, and lets only the two small terms accumulate on the tensor
cores; the warp groups' sums, then the chunks', are added in order.

The tensor cores' fp32 accumulation truncates (on an H100 one accumulator
carried through the forward kernel's 27 offsets was 1e-4 off at C = 64).
It is modelled here as: the products of TF32 values are exact, every addend
of a step (the 8 products and the accumulator) is truncated to 24 bits
below the largest one's exponent, and the sum is truncated to fp32. No
kernel runs here, so the rule is held on the CPU: the kernel's order
against the float64 product on seeded rulebooks at the encoder's widths,
with hit counts up to a full chunk, within ``GATE``; and one fp32
accumulator carried on the tensor cores through a whole chunk, which
misses it where the products of a sum share a sign. The same numpy-seeded
operands go through ``sparse_conv_dw_plain``.
"""
import numpy as np
import pytest
import torch

from bevfusion_tpu_torch.ops import sparse_conv as sp
from tests.test_torch_tf32_split import GATE, split_tf32

torch.set_num_threads(2)

WARPS = 8  # a block of the kernel


def to_fp32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def tc_accumulate(c: torch.Tensor, prods: torch.Tensor) -> torch.Tensor:
    """One mma step's accumulation on the tensor cores: fp32 ``c [...]`` plus
    the exact products ``prods [..., 8]`` (float64), each addend truncated
    to 24 bits below the largest one's exponent, the sum truncated to fp32."""
    x = torch.cat([c.double()[..., None], prods], -1)
    _, e = torch.frexp(x.abs().amax(-1, keepdim=True))  # largest = m * 2^e, 0.5 <= m < 1
    ulp = torch.ldexp(torch.ones_like(x[..., :1]), e - 24)
    return to_fp32_toward_zero((torch.trunc(x / ulp) * ulp).sum(-1))


def kernel_layout(cin: int, cout: int):
    """(P is dout, warp groups G) of the kernel for these widths."""
    p_is_dout = cout >= cin
    mp = next(m for m in (16, 32, 64, 128) if m >= max(cin, cout))
    return p_is_dout, WARPS // (mp // 16)


def chunk_sum(a: torch.Tensor, b: torch.Tensor, groups: int, mode: str) -> torch.Tensor:
    """sum_s a[e, s] * b[e, s] for each entry e, the sites in the kernel's
    steps of 8, step q to warp group q % groups. ``mode``: "kernel" (the
    3xTF32 order above), "one accumulator" (all three products on the
    tensor cores into one fp32 sum, groups ignored) or "exact" (float64)."""
    if mode == "one accumulator":
        groups = 1
    E, L = a.shape
    pad = -L % (8 * groups)
    a, b = (torch.nn.functional.pad(t, (0, pad)).view(E, -1, groups, 8) for t in (a, b))
    if mode == "exact":
        return (a.double() * b.double()).sum((1, 3)).sum(-1)
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    acc = torch.zeros(E, groups)
    small = torch.zeros(E, groups)
    for i in range(a.shape[1]):
        lo_hi = as_[:, i].double() * bb[:, i].double()
        hi_lo = ab[:, i].double() * bs[:, i].double()
        big = ab[:, i].double() * bb[:, i].double()
        if mode == "one accumulator":
            for prods in (lo_hi, hi_lo, big):
                acc = tc_accumulate(acc, prods)
            continue
        small = tc_accumulate(tc_accumulate(small, lo_hi), hi_lo)
        acc = acc + tc_accumulate(torch.zeros_like(acc), big)
    warp = acc + small
    total = warp[:, 0]
    for g in range(1, groups):
        total = total + warp[:, g]
    return total


def emulate_dw(feats, nbr, dout, k, entries, mode):
    """dW[k, ci, co] for the ``entries`` [E, 2] (ci, co) of offset ``k``, as
    the kernel sums them: per chunk of ``sp.DW_CHUNK`` sites its hit pairs
    in site order, then the chunks in order."""
    cap_in, (cin, cout) = feats.shape[0], (feats.shape[1], dout.shape[1])
    p_is_dout, groups = kernel_layout(cin, cout)
    ci, co = entries[:, 0], entries[:, 1]
    total = torch.zeros(len(entries), dtype=torch.float64 if mode == "exact" else torch.float32)
    for begin in range(0, nbr.shape[1], sp.DW_CHUNK):
        row = nbr[k, begin:begin + sp.DW_CHUNK].long()
        o = torch.nonzero((row >= 0) & (row < cap_in)).squeeze(1)
        x, d = feats[row[o]][:, ci].t(), dout[begin + o][:, co].t()  # [E, hits]
        a, b = (d, x) if p_is_dout else (x, d)
        total = total + chunk_sum(a.contiguous(), b.contiguous(), groups, mode)
    return total


def _case(cin, cout, strided, seed, nonnegative):
    """A dense seeded site set (the deepest offset hits most of the first
    DW_CHUNK output sites: all of them at a submanifold table), its table,
    features and an output gradient: standard normal, or their magnitudes
    (``nonnegative``: every product of a sum has one sign, as where ReLU
    outputs meet a same-signed gradient)."""
    rng = np.random.RandomState(seed)
    grid = sp.SparseGrid(40, 40, 24) if strided else sp.SparseGrid(20, 20, 12)
    n = int(0.8 * grid.size) if strided else 3200
    cap = n + 200
    ids = np.full(cap, grid.size, np.int32)
    ids[:n] = np.sort(rng.choice(grid.size, n, replace=False))
    ids = torch.from_numpy(ids)
    if strided:
        og = sp.conv_out_shape(grid, 3, 2, 1)
        out_ids, _ = sp.downsample_sites(ids, grid, 3, 2, 1, og.size)
        nbr = sp.build_conv_rulebook(ids, out_ids, grid, og, 3, 2, 1)
    else:
        nbr = sp.build_subm_rulebook(ids, grid)
    feats = rng.randn(cap, cin).astype(np.float32)
    dout = rng.randn(nbr.shape[1], cout).astype(np.float32)
    if nonnegative:
        feats, dout = np.abs(feats), np.abs(dout)
    return torch.from_numpy(feats), nbr, torch.from_numpy(dout)


SHAPES = [(5, 16, False), (16, 16, False), (16, 32, True), (32, 32, False), (32, 64, True),
          (64, 64, False)]
ENTRIES = 512  # (ci, co) entries of the deepest offset emulated a shape


def _deepest(nbr, cap_in):
    """The offset with the most hits in the first chunk, and that count."""
    first = nbr[:, :sp.DW_CHUNK]
    hits = ((first >= 0) & (first < cap_in)).sum(1)
    return int(hits.argmax()), int(hits.max())


@pytest.mark.parametrize("nonnegative", [False, True], ids=["signed", "nonnegative"])
@pytest.mark.parametrize("cin,cout,strided", SHAPES)
def test_kernel_order_holds_fp32_accuracy(cin, cout, strided, nonnegative):
    """The kernel's order within GATE of float64 at the encoder's widths, on
    signed and on same-signed operands; one accumulator carried on the
    tensor cores through the chunk misses GATE where the products share a
    sign (its truncation toward zero then never cancels: about 4 ulp a
    step), and stays well above the kernel's order on signed ones."""
    feats, nbr, dout = _case(cin, cout, strided, cin * cout, nonnegative)
    k, hits = _deepest(nbr, feats.shape[0])
    assert hits >= (0.7 if strided else 1.0) * sp.DW_CHUNK
    ref = sp.sparse_conv_dw_plain(feats.double(), nbr, dout.double())
    scale = max(ref.abs().max().item(), 1.0)
    rng = np.random.RandomState(cin + cout)
    pairs = np.stack(np.meshgrid(np.arange(cin), np.arange(cout), indexing="ij"), -1)
    pairs = pairs.reshape(-1, 2)
    entries = torch.from_numpy(pairs[rng.permutation(len(pairs))[:ENTRIES]])
    want = ref[k, entries[:, 0], entries[:, 1]]
    # the emulation's bookkeeping (compaction, steps, groups, chunks) is the plain version's sum
    exact = emulate_dw(feats.double(), nbr, dout.double(), k, entries, "exact")
    assert (exact - want).abs().max().item() <= 1e-12 * scale
    errs = {mode: (emulate_dw(feats, nbr, dout, k, entries, mode).double() - want).abs().max()
            .item() / scale for mode in ("kernel", "one accumulator")}
    plain = sp.sparse_conv_dw_plain(feats, nbr, dout)[k, entries[:, 0], entries[:, 1]]
    errs["plain fp32"] = (plain.double() - want).abs().max().item() / scale
    print(f"{cin}->{cout}{' strided' if strided else ''}, offset {k}, {hits} hits in the first "
          f"chunk: max|d| / max(|f64|, 1) " + ", ".join(f"{m} {v:.3e}" for m, v in errs.items()))
    assert errs["kernel"] <= GATE
    if nonnegative:
        assert errs["one accumulator"] > GATE
    else:
        assert errs["one accumulator"] > 4 * errs["kernel"]


# ----------------------------------------------------------------------
# the bf16 form (csrc/sparse_conv_dw_bf16.cuh)
# ----------------------------------------------------------------------
#
# The bf16 form multiplies bf16 rows: each product is exact in fp32, and only
# the tensor cores' truncating accumulation and the FP32 adds round. A block
# takes one offset and one chunk of ``sp.DW_CHUNK`` output sites and
# compacts its hit pairs in site order; its stages of STAGE_HITS hit pairs go
# to its teams in turn (stage j to team j % G; a team: one to eight warps
# sharing a ring). A team sums its stages in order, 16 hit pairs a mma step,
# carried on the tensor cores for RUN steps and then added into its FP32
# sum (round to nearest); the block adds its teams' sums in team order, and
# pass 2 the chunks' in chunk order.

BF16_GATE = 1e-4  # chip_smoke.py phase 5b's K3 bf16 gate, of max(|float64 product|, 1)
RUN = 8  # 16-site mma steps carried on the tensor cores before an FP32 add
STAGE_HITS = 32  # hit pairs a stage


def bf16_layout(cin: int, cout: int):
    """(warps a team, teams a block) of the bf16 kernel for these widths, as
    sparse_conv_dw_bf16.cuh's Layout computes them: P the wider of dout and
    feats padded to 16..128, Q the other to 8..128; a warp holds the sums of
    H 16-row slabs of P, H = 2 where Q is 8 to 32 wide; a block two teams'
    warps, 4 to 8."""
    mp = next(m for m in (16, 32, 64, 128) if m >= max(cin, cout))
    nq = next(n for n in (8, 16, 32, 64, 128) if n >= min(cin, cout))
    team = mp // (16 * (2 if mp >= 32 and nq <= 32 else 1))
    return team, min(max(2 * team, 4), 8) // team


def tc_run_sum(a: torch.Tensor, b: torch.Tensor, run) -> torch.Tensor:
    """sum_s a[..., s] * b[..., s] (bf16 values in fp32 tensors) as a team
    sums it: the sites in 16-deep mma steps on the tensor cores
    (``tc_accumulate``), ``run`` steps a run from a zero accumulator, each
    run added into an fp32 sum; ``run`` None: one accumulator through the
    whole stream. float64 operands: the exact sum."""
    if a.dtype == torch.float64:
        return (a * b).sum(-1)
    pad = -a.shape[-1] % 16
    a, b = (torch.nn.functional.pad(t, (0, pad)).double() for t in (a, b))
    a, b = a.unflatten(-1, (-1, 16)), b.unflatten(-1, (-1, 16))
    acc = total = torch.zeros(a.shape[:-2])
    for i in range(a.shape[-2]):
        acc = tc_accumulate(acc, a[..., i, :] * b[..., i, :])
        if run is not None and (i + 1) % run == 0:
            total, acc = total + acc, torch.zeros_like(acc)
    return total + acc


def emulate_dw_bf16(feats, nbr, dout, k, entries, run=RUN, teams=None):
    """dW[k, ci, co] for the ``entries`` [E, 2] of offset ``k`` as the bf16
    kernel sums them: ``teams`` a block, by default the kernel's for these
    widths (1 with a chunk as long as the table: one team taking every hit
    pair of the offset in one stream)."""
    cap_in, (cin, cout) = feats.shape[0], (feats.shape[1], dout.shape[1])
    g = teams or bf16_layout(cin, cout)[1]
    chunk = nbr.shape[1] if teams == 1 else sp.DW_CHUNK
    ci, co = entries[:, 0], entries[:, 1]
    total = None
    for begin in range(0, nbr.shape[1], chunk):
        row = nbr[k, begin:begin + chunk].long()
        o = torch.nonzero((row >= 0) & (row < cap_in)).squeeze(1)
        x, d = feats[row[o]][:, ci].t(), dout[begin + o][:, co].t()  # [E, hits]
        stages = -(-len(o) // STAGE_HITS)
        pad = stages * STAGE_HITS - len(o)
        x, d = (torch.nn.functional.pad(t, (0, pad)).unflatten(1, (stages, STAGE_HITS))
                for t in (x, d))  # zeros past the last hit add nothing
        block = None
        for t in range(min(g, stages)):  # team t's stages t, t + g, ..., then the teams in order
            team = tc_run_sum(x[:, t::g].flatten(1), d[:, t::g].flatten(1), run)
            block = team if block is None else block + team
        if block is not None:
            total = block if total is None else total + block
    return total


def _bf16_case(cin, cout, strided, seed, nonnegative):
    feats, nbr, dout = _case(cin, cout, strided, seed, nonnegative)
    return feats.bfloat16().float(), nbr, dout.bfloat16().float()


def _bf16_errors(feats, nbr, dout, k, entries, **kw):
    ref = sp.sparse_conv_dw_plain(feats.double(), nbr, dout.double())
    scale = max(ref.abs().max().item(), 1.0)
    want = ref[k, entries[:, 0], entries[:, 1]]
    exact = emulate_dw_bf16(feats.double(), nbr, dout.double(), k, entries, **kw)
    assert (exact - want).abs().max().item() <= 1e-12 * scale
    return {mode: (emulate_dw_bf16(feats, nbr, dout, k, entries, run=run, **kw).double()
                   - want).abs().max().item() / scale
            for mode, run in (("kernel", RUN), ("one accumulator", None))}


def _entries(cin, cout, seed, n=ENTRIES):
    pairs = np.stack(np.meshgrid(np.arange(cin), np.arange(cout), indexing="ij"), -1)
    pairs = pairs.reshape(-1, 2)
    return torch.from_numpy(pairs[np.random.RandomState(seed).permutation(len(pairs))[:n]])


@pytest.mark.parametrize("nonnegative", [False, True], ids=["signed", "nonnegative"])
@pytest.mark.parametrize("cin,cout,strided", SHAPES)
def test_bf16_kernel_order_holds_the_gate(cin, cout, strided, nonnegative):
    """The bf16 kernel's order at the encoder's widths (its own teams a
    block, a block a chunk) within BF16_GATE of float64, with the same
    numpy-seeded operands rounded to bf16, on signed and same-signed
    operands, hit counts up to a whole chunk; a team's stream here is at
    most a chunk over its teams, so a run of RUN steps and one accumulator
    through each stream nearly agree."""
    feats, nbr, dout = _bf16_case(cin, cout, strided, cin * cout, nonnegative)
    k, hits = _deepest(nbr, feats.shape[0])
    errs = _bf16_errors(feats, nbr, dout, k, _entries(cin, cout, cin + cout))
    team, g = bf16_layout(cin, cout)
    print(f"{cin}->{cout}{' strided' if strided else ''}, offset {k}, teams of {team} warps, "
          f"{g} a block: max|d| / max(|f64|, 1) "
          + ", ".join(f"{m} {v:.3e}" for m, v in errs.items()))
    assert errs["kernel"] <= BF16_GATE / 20
    assert errs["one accumulator"] <= BF16_GATE


@pytest.mark.parametrize("sites", [4096, 16384])
@pytest.mark.parametrize("nonnegative", [False, True], ids=["signed", "nonnegative"])
def test_bf16_run_length_on_a_long_stream(sites, nonnegative):
    """One stream of 4,096 hit pairs (twice a chunk: as long as one team's
    would be with a longer chunk) and four times that: every site of a
    dense submanifold set hits the centre offset, and one team takes them
    all. Runs of RUN steps stay 100x inside BF16_GATE. One accumulator
    carried through the stream grows with its length where the products
    share a sign (truncation toward zero never cancels): within the gate at
    4,096 same-signed hits, past it at 16,384; on signed operands it stays
    well inside."""
    rng = np.random.RandomState(sites)
    grid = sp.SparseGrid(32, 32, 16) if sites == 4096 else sp.SparseGrid(64, 64, 16)
    ids = np.full(sites + 100, grid.size, np.int32)
    ids[:sites] = np.sort(rng.choice(grid.size, sites, replace=False))
    nbr = sp.build_subm_rulebook(torch.from_numpy(ids), grid)
    feats = torch.from_numpy(rng.randn(len(ids), 16).astype(np.float32)).bfloat16().float()
    dout = torch.from_numpy(rng.randn(len(ids), 16).astype(np.float32)).bfloat16().float()
    if nonnegative:
        feats, dout = feats.abs(), dout.abs()
    k = 13  # the centre offset: every site hits
    assert int((nbr[k] >= 0).sum()) == sites
    errs = _bf16_errors(feats, nbr, dout, k, _entries(16, 16, sites, 64), teams=1)
    print(f"{sites} hits in one stream, {'same-signed' if nonnegative else 'signed'}: "
          + ", ".join(f"{m} {v:.3e}" for m, v in errs.items()))
    assert errs["kernel"] <= BF16_GATE / 100
    if not nonnegative:
        assert errs["one accumulator"] <= BF16_GATE / 10
    elif sites == 4096:
        assert BF16_GATE / 10 < errs["one accumulator"] <= BF16_GATE
    else:
        assert errs["one accumulator"] > BF16_GATE
