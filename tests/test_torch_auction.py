"""The auction matcher (``ops/auction.py``, re-exported by ``core/matching.py``)
on the CPU.

- ``auction_assignment_plain`` equals the JAX ``auction_assignment`` bit for
  bit in ``assign`` on made problems: random costs, integer-valued costs
  with duplicated columns (ties), near-equal costs that exhaust
  ``max_iters``, invalid rows and columns, R > C, R = 1, C = 1 with R = 2
  (an infinite bid, then NaN bids), and the from-files shape (R = 140 with
  15 valid);
- a numpy transcription of the CUDA kernel's round (``csrc/auction.cu``: a
  G-lane group's top-2 over its columns and the butterfly merge with their
  tie rules, the column's 64-bit key of bid and row, the column pass with
  the exact count of unassigned rows as the stop test) equals the plain
  version in ``assign``, ``price`` and the rounds on the same problems, and
  at every group width the plan gives (chosen by R); the key's order; the
  launch plans (``auction_plan``, ``fps_plan``) within a block's limits;
- the op ``bevfusion::auction``: its CPU form is the plain version, its fake
  form gives the three outputs' shapes and dtypes, and a CPU call counts no
  launch.

The kernel itself is held to the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s matcher phase.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from bevfusion_tpu.core import matching as jax_matching
from bevfusion_tpu_torch.core import matching
from bevfusion_tpu_torch.ops import auction as au

torch.set_num_threads(2)


def _problem(name):
    """(cost [R, C] fp32, row_valid [R], col_valid [C], max_iters) of a made
    case, from a numpy seed."""
    rng = np.random.RandomState(sum(map(ord, name)))
    R, C, iters = {"random": (12, 30, 2000), "flagship shape": (64, 200, 2000),
                   "ties": (10, 24, 2000), "exhausts max_iters": (16, 40, 50),
                   "invalid rows and columns": (14, 30, 2000), "R > C": (9, 5, 60),
                   "R = 1": (1, 25, 2000), "C = 1, R = 2": (2, 1, 20),
                   "from files": (140, 200, 2000)}[name]
    cost = rng.rand(R, C).astype(np.float32)
    row_valid, col_valid = np.ones(R, bool), np.ones(C, bool)
    if name == "ties":  # integer costs; rows copies of three, columns of twelve
        cost = rng.randint(0, 4, (3, C // 2)).astype(np.float32)
        cost = cost[rng.randint(0, 3, R)][:, rng.randint(0, C // 2, C)]
    elif name == "exhausts max_iters":  # every row wants the same three near-equal columns
        cost = (rng.rand(R, C) * 1e-3 + np.where(np.arange(C) < 3, 0.0, 0.5)).astype(np.float32)
    elif name == "invalid rows and columns":
        row_valid[rng.rand(R) < 0.3] = False
        col_valid[rng.rand(C) < 0.3] = False
    elif name == "from files":  # 15 ground truths of 140 slots
        row_valid[15:] = False
    return cost, row_valid, col_valid, iters


CASES = ["random", "flagship shape", "ties", "exhausts max_iters", "invalid rows and columns",
         "R > C", "R = 1", "C = 1, R = 2", "from files"]


def _plain(name):
    cost, row_valid, col_valid, iters = _problem(name)
    t = [torch.from_numpy(a) for a in (cost, row_valid, col_valid)]
    return au._auction_rounds(*t, max_iters=iters, plain=True), t, iters


@pytest.mark.parametrize("name", CASES)
def test_plain_equals_jax(name):
    cost, row_valid, col_valid, iters = _problem(name)
    want = np.asarray(jax_matching.auction_assignment(
        jnp.asarray(cost), jnp.asarray(row_valid), jnp.asarray(col_valid), max_iters=iters))
    got = matching.auction_assignment_plain(*(torch.from_numpy(a) for a in (cost, row_valid,
                                                                             col_valid)),
                                            max_iters=iters)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[~row_valid] == -1).all()
    assert len(set(want[want >= 0])) == (want >= 0).sum()  # a column to one row at most


def test_cases_reach_what_they_are_for():
    """The ties tie, the exhausting cases run out of rounds, C = 1 bids
    inf then NaN (its price is inf and one row stays unassigned)."""
    (assign, price, rounds), _, iters = _plain("exhausts max_iters")
    assert int(rounds) == iters and (assign < 0).any()
    (assign, price, rounds), _, iters = _plain("R > C")
    assert int(rounds) == iters and (assign >= 0).sum() == 5
    (assign, price, rounds), _, iters = _plain("C = 1, R = 2")
    assert assign.tolist() == [0, -1] and int(rounds) == iters and torch.isinf(price).all()
    cost = _problem("ties")[0]
    assert any(len(set(row)) < len(row) for row in cost)
    (assign, price, rounds), _, _ = _plain("from files")
    assert (assign[:15] >= 0).all() and (assign[15:] == -1).all() and 0 < int(rounds) < 2000


def _lane_top2(net, G=32, w=1):
    """The kernel's lanes of a G-lane row group: lane l takes its columns
    in order, w at a time (w = 4: the kernel's four-column loads), chunks
    l, l + G, ...; its first column sets (best, j), then a larger value
    moves best to second, an equal or smaller one competes for second.
    net [R, C] -> best, j, second [R, G] (a lane with no column: -inf,
    INT_MAX, -inf)."""
    R, C = net.shape
    best = np.full((R, G), -np.inf, np.float32)
    j = np.full((R, G), np.iinfo(np.int32).max, np.int64)
    second = np.full((R, G), -np.inf, np.float32)
    first = np.ones(G, bool)
    for c0 in range(0, C, G * w):
        for e in range(w):
            cols = c0 + np.arange(G) * w + e  # each lane's next column
            lanes = np.nonzero(cols < C)[0]
            v, c = net[:, cols[lanes]], cols[lanes]
            b, s = best[:, lanes], second[:, lanes]
            up = (v > b) | first[lanes]
            second[:, lanes] = np.where(first[lanes], s, np.where(up, b, np.where(v > s, v, s)))
            best[:, lanes] = np.where(up, v, b)
            j[:, lanes] = np.where(up, c, j[:, lanes])
            first[lanes] = False
    return best, j, second


def _merge(best, j, second):
    """The group's butterfly of shuffles (xor G/2, ..., 1): the larger best,
    of equal ones the lower index; second the largest of both seconds and
    the other best. Every lane ends with the same; lane 0's is returned."""
    G = best.shape[1]
    lanes = np.arange(G)
    off = G // 2
    while off:
        ob, oj, os_ = best[:, lanes ^ off], j[:, lanes ^ off], second[:, lanes ^ off]
        theirs = (ob > best) | ((ob == best) & (oj < j))
        lost = np.where(theirs, best, ob)
        s = np.where(second > os_, second, os_)
        second = np.where(s > lost, s, lost)
        best, j = np.where(theirs, ob, best), np.where(theirs, oj, j)
        off //= 2
    return best[:, 0], j[:, 0], second[:, 0]


def column_key(bid, rows):
    """The column's 64-bit key of ``csrc/auction.cu``: (bid bits << 32) |
    (0xFFFFFFFF - row), for fp32 ``bid`` and int ``rows`` (arrays)."""
    bits = np.asarray(bid, np.float32).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - np.asarray(rows, np.uint64))


def kernel_transcription(value, row_valid, eps, max_iters):
    """``csrc/auction.cu``'s block, step for step, in numpy fp32: value [R,
    C], row_valid [R], eps fp32 -> (assign [R], price [C], rounds). Every
    bidding row's G-lane group (G = ``auction_plan``'s lanes) takes its top-2 (four columns a load where the staged form does) and
    merges it; each bid goes to its column's key by a
    64-bit max; the column pass takes the winner from the key and keeps the
    count of unassigned valid rows exact, the stop test."""
    R, C = value.shape
    G = au.auction_plan(R, C)["lanes"]
    width = 4 if C % 4 == 0 and G >= 4 else 1  # the staged form's four-column loads
    price = np.zeros(C, np.float32)
    owner = np.full(C, -1, np.int64)
    assign = np.where(row_valid, -1, -2).astype(np.int64)  # -2: never bids
    unassigned = int(row_valid.sum())
    it = 0
    while it < max_iters and unassigned > 0:
        rows = np.nonzero(assign == -1)[0]
        net = (value[rows] - price[None, :]).astype(np.float32)
        best, j, second = _merge(*_lane_top2(net, G, width))
        bid = ((best - second).astype(np.float32) + eps).astype(np.float32)
        keys = np.zeros(C, np.uint64)
        np.maximum.at(keys, j, column_key(bid, rows))
        for c in np.nonzero(keys)[0]:  # the column pass
            bits = np.uint32(keys[c] >> np.uint64(32))
            if bits > 0x7F800000:  # a NaN bid: no winner
                continue
            w = int(np.uint64(0xFFFFFFFF) - (keys[c] & np.uint64(0xFFFFFFFF)))
            price[c] = np.float32(price[c] + bits.view(np.float32))
            if owner[c] >= 0:
                assign[owner[c]] = -1
            else:
                unassigned -= 1
            assign[w] = c
            owner[c] = w
        it += 1
    assert unassigned == int(((assign == -1) & row_valid).sum())  # the count stayed exact
    return np.where(assign >= 0, assign, -1), price, it


def _transcription_against_plain(cost, row_valid, col_valid, iters):
    value, eps = au.auction_value(cost, row_valid, col_valid)
    assign, price, rounds = au.auction_rounds_plain(value, row_valid, eps, iters)
    with np.errstate(invalid="ignore"):  # C = 1: inf - inf
        got = kernel_transcription(value.numpy(), row_valid.numpy(), eps.numpy(), iters)
    np.testing.assert_array_equal(got[0], assign.numpy())
    np.testing.assert_array_equal(got[1].view(np.int32), price.numpy().view(np.int32))
    assert got[2] == int(rounds)


@pytest.mark.parametrize("name", CASES)
def test_kernel_transcription_equals_plain(name):
    """At the plan's lanes a row: equal to plain in assign, price bits and
    rounds."""
    _, t, iters = _plain(name)
    _transcription_against_plain(*t, iters)


@pytest.mark.parametrize("kind", ["random", "contested"])
@pytest.mark.parametrize("R,C,lanes", [(1, 200, 32), (33, 200, 16), (63, 31, 16), (65, 200, 8),
                                       (140, 33, 4), (300, 48, 2), (600, 40, 1),
                                       (1100, 36, 1)])
def test_kernel_transcription_at_other_widths(R, C, lanes, kind):
    """At every lanes-a-row width the plan gives, chosen by R (32 lanes at R
    = 1, 16 past 32 rows, 8 past 64, 4 at 140, 2, then 1; past 1024 rows
    strided over the groups), on random and near-equal costs: equal to
    plain all the same."""
    rng = np.random.RandomState(R * C)
    cost = rng.rand(R, C).astype(np.float32)
    if kind == "contested":  # every row wants the same three near-equal columns
        cost = (cost * 1e-3 + np.where(np.arange(C) < 3, 0.0, 0.5)).astype(np.float32)
    assert au.auction_plan(R, C)["lanes"] == lanes
    _transcription_against_plain(torch.from_numpy(cost), torch.ones(R, dtype=torch.bool),
                                 torch.ones(C, dtype=torch.bool), 60)


def _merge_case(G, w=1):
    """Rows whose best value repeats across lanes and within a lane, and a
    row of -inf, merged by G-lane groups; checked against torch.max."""
    net = np.full((4, 70), -3.0, np.float32)
    net[0, [5, 37, 69]] = 2.0  # one lane (5), twice more in lane 5's columns (G = 32)
    net[1, [40, 9]] = 2.0  # lane 8 has it at 40, lane 9 at 9: the first index is 9 (G = 32)
    net[2, 33], net[2, 1] = 2.0, 1.5  # the same lane: best at 33, second 1.5 earlier (G = 32)
    net[3] = -np.inf
    best, j, second = _merge(*_lane_top2(net, G, w))
    t = torch.from_numpy(net)
    want_v, want_j = t.max(1)
    want_s = t.scatter(1, want_j[:, None], float("-inf")).max(1).values
    np.testing.assert_array_equal(j, want_j.numpy())
    np.testing.assert_array_equal(best, want_v.numpy())
    np.testing.assert_array_equal(second, want_s.numpy())
    assert j.tolist() == [5, 9, 33, 0] and second.tolist()[:3] == [2.0, 2.0, 1.5]


def test_lane_merge_keeps_the_first_index_and_counts_a_tie_as_second():
    """The merge returns torch.max's first index and the plain version's
    second value (a warp's 32 lanes)."""
    _merge_case(32)


@pytest.mark.parametrize("G,w", [(2, 1), (4, 1), (16, 1), (4, 4), (16, 4), (32, 4)])
def test_lane_merge_at_group_widths(G, w):
    """The same at the narrower groups a row may have, and with four
    columns a load."""
    _merge_case(G, w)


def test_column_key_orders_bids_then_the_lowest_row():
    """The key's unsigned order: the larger bid first (its bits' order is
    the float order over bids > 0, +inf and NaN, NaN on top), of equal bids
    the lowest row; a NaN bid's key is one the column pass refuses; no real
    bid packs to key 0 ("no bid")."""
    rng = np.random.RandomState(23)
    bids = np.concatenate([rng.rand(200).astype(np.float32) * 10.0 ** rng.randint(-40, 30, 200),
                           [np.float32(1.4e-45), np.float32(3.4e38), np.inf]]).astype(np.float32)
    bids = bids[bids > 0]
    rows = rng.randint(0, 300, bids.size)
    keys = column_key(bids, rows)
    ranked = keys[np.lexsort((rows, -bids.astype(np.float64)))]  # larger bid, then lower row
    assert (ranked[:-1] >= ranked[1:]).all()
    assert (keys > 0).all() and column_key(np.float32(1.4e-45), 0xFFFFFFFF) > 0
    tied = column_key(np.full(5, 0.25, np.float32), [7, 3, 9, 4, 3])
    assert int(np.argmax(tied)) == 1 and tied[1] == tied[4]
    nan = column_key(np.float32(np.nan), 0)
    assert nan > column_key(np.float32(np.inf), 0)
    assert np.uint32(nan >> np.uint64(32)) > 0x7F800000  # refused: no winner
    assert np.uint32(column_key(np.float32(np.inf), 5) >> np.uint64(32)) == 0x7F800000


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name", ["ties", "C = 1, R = 2"])
def test_op_cpu_form_is_plain_and_counts_no_launch(name):
    (assign, price, rounds), (cost, row_valid, col_valid), iters = _plain(name)
    value, eps = au.auction_value(cost, row_valid, col_valid)
    launches = au.auction_assignment.launches
    got = torch.ops.bevfusion.auction(value, row_valid, eps, iters)
    for g, w in zip(got, (assign, price, rounds)):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(_bits(g), _bits(w))
    assert torch.equal(matching.auction_assignment(cost, row_valid, col_valid, max_iters=iters),
                       assign)
    assert au.auction_assignment.launches == launches


def test_op_fake_gives_the_three_shapes():
    row_valid, col_valid = torch.ones(7, dtype=torch.bool), torch.ones(11, dtype=torch.bool)
    value, eps = au.auction_value(torch.rand(7, 11), row_valid, col_valid)
    with FakeTensorMode() as mode:
        out = torch.ops.bevfusion.auction(mode.from_tensor(value), mode.from_tensor(row_valid),
                                          mode.from_tensor(eps), 30)
    assert [(o.shape, o.dtype) for o in out] == [
        (torch.Size([7]), torch.int64), (torch.Size([11]), torch.float32),
        (torch.Size([]), torch.int32)]


def test_kernel_launch_refuses_what_it_does_not_take():
    """The launch checks its operands before it builds or launches anything."""
    value = torch.zeros(1, 4, 5)
    ok = dict(row_valid=torch.ones(1, 4, dtype=torch.bool), eps=torch.ones(1))
    for bad in (dict(ok, row_valid=torch.ones(1, 4)), dict(ok, eps=torch.ones(2)),
                dict(ok, row_valid=torch.ones(1, 5, dtype=torch.bool))):
        with pytest.raises(ValueError):
            au._launch_auction(value, bad["row_valid"], bad["eps"], 10)
    with pytest.raises(ValueError):
        au._launch_auction(torch.zeros(1, 4, 20000), ok["row_valid"], ok["eps"], 10)
    assert au.auction_plan(140, 200)["staged"] and not au.auction_plan(200, 300)["staged"]


def test_launch_plans_stay_within_a_block():
    """``auction_plan`` at R 1..256, C 1..512 (staged or not) and ``fps_plan``
    at N 1..32,768: at most 1024 threads in whole warps and 232,448 bytes
    of shared memory; the auction's rows each get their lanes (the largest
    power of two <= 32 with R * lanes <= 1024), its staged rows padded to
    ``lanes`` mod 32; D2's slots cover N with fewer than two dead slots a
    thread (no power-of-two ladder)."""
    from bevfusion_tpu_torch.ops import pointnet as pn

    for R in range(1, 257):
        lanes = 32
        while R * lanes > au.MAX_THREADS:
            lanes //= 2
        for C in range(1, 513):
            for staged in (True, False):
                p = au.auction_plan(R, C, staged)
                assert p["lanes"] == lanes and 32 <= p["threads"] <= au.MAX_THREADS
                assert p["threads"] % 32 == 0 and p["threads"] >= R * lanes
                assert p["scratch_bytes"] <= p["smem_bytes"] <= au.MAX_SMEM
                assert p["ldv"] == C if not p["staged"] else (
                    C <= p["ldv"] < C + 32 and p["ldv"] % 32 == lanes % 32)
                assert p["staged"] <= staged
    assert au.auction_plan(64, 200) == {"threads": 1024, "lanes": 16, "ldv": 208, "staged": 1,
                                        "smem_bytes": 3472 + 64 * 208 * 4,
                                        "scratch_bytes": 3472}
    assert au.auction_plan(140, 200)["lanes"] == 4 and au.auction_plan(1, 200)["threads"] == 32
    assert au.auction_plan(1100, 36)["lanes"] == 1 and au.auction_plan(1100, 36)["threads"] == 1024
    for n in range(1, pn.FPS_MAX_POINTS + 1):
        p = pn.fps_plan(n)
        cl, slots = p["cluster"], p["points"]
        assert p["threads"] <= 1024 and p["threads"] % 32 == 0 and p["smem_bytes"] <= au.MAX_SMEM
        assert 0 <= slots * p["threads"] * cl - n < cl * (32 * slots + 1)
        assert 1 <= slots <= 8 and cl == (1 if n <= 8192 else 4)
    assert pn.fps_plan(20000) == {"threads": 640, "points": 8, "smem_bytes": 1728, "cluster": 4}
    assert [pn.fps_plan(n)["threads"] for n in (2048, 1024, 512, 256)] == [512, 512, 512, 256]
    assert {pn.fps_plan(n)["points"] for n in (512, 513, 1300, 2048, 2049, 3000, 3500, 8192)} \
        == set(range(1, 9))  # every points-a-thread form is some N's
    for n in (0, 32769):
        with pytest.raises(ValueError):
            pn.fps_plan(n)
