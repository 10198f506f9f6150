"""The auction matcher (``ops/auction.py``, re-exported by ``core/matching.py``)
on the CPU.

- ``auction_assignment_plain`` equals the JAX ``auction_assignment`` bit for
  bit in ``assign`` on made problems: random costs, integer-valued costs
  with duplicated columns (ties), near-equal costs that exhaust
  ``max_iters``, invalid rows and columns, R > C, R = 1, C = 1 with R = 2
  (an infinite bid, then NaN bids), and the from-files shape (R = 140 with
  15 valid);
- a numpy transcription of the CUDA kernel's round (``csrc/auction.cu``: a
  lane's top-2 over its columns and the butterfly merge with their tie
  rules, the max of the bids on their int bits, the lowest winning row, the
  in-place column pass) equals the plain version in ``assign``, ``price``
  and the rounds on the same problems;
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


def _lane_top2(net):
    """The kernel's lanes: lane l takes columns l, l + 32, ... in order;
    its first column sets (best, j), then a larger value moves best to
    second, an equal or smaller one competes for second. net [R, C] ->
    best, j, second [R, 32] (a lane with no column: -inf, INT_MAX, -inf)."""
    R, C = net.shape
    best = np.full((R, 32), -np.inf, np.float32)
    j = np.full((R, 32), np.iinfo(np.int32).max, np.int64)
    second = np.full((R, 32), -np.inf, np.float32)
    for k in range(0, C, 32):
        lanes = np.arange(min(32, C - k))
        v = net[:, k + lanes]
        if k == 0:
            best[:, lanes], j[:, lanes] = v, k + lanes
            continue
        b, s = best[:, lanes], second[:, lanes]
        up = v > b
        second[:, lanes] = np.where(up, b, np.where(v > s, v, s))
        best[:, lanes] = np.where(up, v, b)
        j[:, lanes] = np.where(up, k + lanes, j[:, lanes])
    return best, j, second


def _merge(best, j, second):
    """The butterfly of shuffles (xor 16, 8, 4, 2, 1): the larger best, of
    equal ones the lower index; second the largest of both seconds and the
    other best. Every lane ends with the same; lane 0's is returned."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        ob, oj, os_ = best[:, lanes ^ off], j[:, lanes ^ off], second[:, lanes ^ off]
        theirs = (ob > best) | ((ob == best) & (oj < j))
        lost = np.where(theirs, best, ob)
        s = np.where(second > os_, second, os_)
        second = np.where(s > lost, s, lost)
        best, j = np.where(theirs, ob, best), np.where(theirs, oj, j)
    return best[:, 0], j[:, 0], second[:, 0]


def kernel_transcription(value, row_valid, eps, max_iters):
    """``csrc/auction.cu``'s block, step for step, in numpy fp32: value [R,
    C], row_valid [R], eps fp32 -> (assign [R], price [C], rounds)."""
    R, C = value.shape
    price = np.zeros(C, np.float32)
    owner = np.full(C, -1, np.int64)
    assign = np.full(R, -1, np.int64)
    int_min = np.iinfo(np.int32).min
    it = 0
    while True:
        bidding = (assign < 0) & row_valid
        if not bidding.any() or it >= max_iters:
            break
        rows = np.nonzero(bidding)[0]
        net = (value[rows] - price[None, :]).astype(np.float32)
        best, j, second = _merge(*_lane_top2(net))
        bid = ((best - second).astype(np.float32) + eps).astype(np.float32)
        col_best = np.full(C, int_min, np.int64)
        np.maximum.at(col_best, j, bid.view(np.int32).astype(np.int64))
        win = np.full(C, R, np.int64)
        wins = col_best[j].astype(np.int32).view(np.float32) == bid
        np.minimum.at(win, j[wins], rows[wins])
        for c in np.nonzero(win < R)[0]:  # the column pass
            price[c] = np.float32(price[c] + col_best[c].astype(np.int32).view(np.float32))
            if owner[c] >= 0:
                assign[owner[c]] = -1
            assign[win[c]] = c
            owner[c] = win[c]
        it += 1
    return np.where(row_valid, assign, -1), price, it


@pytest.mark.parametrize("name", CASES)
def test_kernel_transcription_equals_plain(name):
    (assign, price, rounds), (cost, row_valid, col_valid), iters = _plain(name)
    value, eps = au.auction_value(cost, row_valid, col_valid)
    with np.errstate(invalid="ignore"):  # C = 1: inf - inf
        got = kernel_transcription(value.numpy(), row_valid.numpy(), eps.numpy(), iters)
    np.testing.assert_array_equal(got[0], assign.numpy())
    np.testing.assert_array_equal(got[1].view(np.int32), price.numpy().view(np.int32))
    assert got[2] == int(rounds)


def test_lane_merge_keeps_the_first_index_and_counts_a_tie_as_second():
    """Rows whose best value repeats across lanes and within a lane, and a
    row of -inf: the merge returns torch.max's first index and the plain
    version's second value."""
    net = np.full((4, 70), -3.0, np.float32)
    net[0, [5, 37, 69]] = 2.0  # one lane (5), twice more in lane 5's columns
    net[1, [40, 9]] = 2.0  # lane 8 has it at 40, lane 9 at 9: the first index is 9
    net[2, 33], net[2, 1] = 2.0, 1.5  # the same lane: best at 33, second 1.5 earlier
    net[3] = -np.inf
    best, j, second = _merge(*_lane_top2(net))
    t = torch.from_numpy(net)
    want_v, want_j = t.max(1)
    want_s = t.scatter(1, want_j[:, None], float("-inf")).max(1).values
    np.testing.assert_array_equal(j, want_j.numpy())
    np.testing.assert_array_equal(best, want_v.numpy())
    np.testing.assert_array_equal(second, want_s.numpy())
    assert j.tolist() == [5, 9, 33, 0] and second.tolist()[:3] == [2.0, 2.0, 1.5]


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
    assert au.value_staged(140, 200) and not au.value_staged(200, 300)
