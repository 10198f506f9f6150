"""Port parity of the sparse conv's training path against the JAX package.

- ``build_conv_transpose_rulebook`` is bit-equal to the JAX table;
- ``sparse_conv_dw_plain`` (the weight-gradient kernel's plain version) and
  ``SparseConvFunction`` on CPU tensors (plain forward, backward-data through
  the same conv with mirrored / transposed weights, backward-weight) match
  ``jax.grad`` of ``subm_gather_gemm`` at a submanifold, a strided and the
  (1, 1, 3)/(1, 1, 2) ``conv_out`` shape; fp32, only the summation order
  differs, so max|d| <= 1e-5 * max(|want|, 1);
- ``MaskedBatchNorm`` in training: output and running statistics against the
  JAX ``MaskedBatchNorm`` (moments over the active rows, biased variance).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_tpu.models.sparse_encoder import MaskedBatchNorm as JaxMaskedBN
from bevfusion_tpu.ops import sparse_conv as jsp
from bevfusion_tpu_torch.models.sparse_encoder import MaskedBatchNorm
from bevfusion_tpu_torch.ops import sparse_conv as sp
from tests.test_torch_sparse_conv import SITES, _ring_sites

torch.set_num_threads(2)

TOL = 1e-5  # fp32, summation order only
SHAPES = {  # name -> (kernel, stride, padding, Cin, Cout); stride None = submanifold
    "subm 16->16": (3, None, 1, 16, 16),
    "strided 16->32": (3, 2, 1, 16, 32),
    "conv_out 8->12": ((1, 1, 3), (1, 1, 2), 0, 8, 12),
}


def _close(got, want):
    return float(np.max(np.abs(got - want))) <= TOL * max(float(np.max(np.abs(want))), 1.0)


@pytest.mark.parametrize("name", sorted(SITES))
@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (3, 2, (1, 1, 0)), ((1, 1, 3), (1, 1, 2), 0)])
def test_transpose_rulebook_bit_equal(name, k, s, p):
    ids, grid = SITES[name]()
    og = jsp.conv_out_shape(grid, k, s, p)
    out_ids, _ = jsp.downsample_sites(jnp.asarray(ids), grid, k, s, p, ids.shape[0])
    want = np.asarray(jsp.build_conv_transpose_rulebook(jnp.asarray(ids), out_ids, grid, og,
                                                        k, s, p, offset_major=True))
    got = sp.build_conv_transpose_rulebook(torch.from_numpy(ids),
                                           torch.from_numpy(np.array(out_ids)),
                                           sp.SparseGrid(*grid), sp.SparseGrid(*og), k, s, p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() >= (ids < grid.size).sum()  # every input site is read


@functools.lru_cache(maxsize=None)
def _grad_case(name):
    """Ring-scan sites, a gather table, and random feats / weight / dout;
    the JAX gradients of sum(subm_gather_gemm(feats, nbr, W) * dout)."""
    k, s, p, cin, cout = SHAPES[name]
    ids, grid = _ring_sites()
    rng = np.random.RandomState(7)
    K = int(np.prod(sp._triple(k)))
    valid_in = ids < grid.size
    feats = (rng.randn(ids.shape[0], cin) * valid_in[:, None]).astype(np.float32)
    nbr_t = None
    if s is None:
        nbr = jsp.build_subm_rulebook(jnp.asarray(ids), grid, k, offset_major=True)
        cap_out = ids.shape[0]
    else:
        og = jsp.conv_out_shape(grid, k, s, p)
        out_ids, _ = jsp.downsample_sites(jnp.asarray(ids), grid, k, s, p, ids.shape[0])
        nbr = jsp.build_conv_rulebook(jnp.asarray(ids), out_ids, grid, og, k, s, p,
                                      offset_major=True)
        nbr_t = np.array(jsp.build_conv_transpose_rulebook(jnp.asarray(ids), out_ids, grid, og,
                                                           k, s, p, offset_major=True))
        cap_out = out_ids.shape[0]
    nbr = np.array(nbr)
    w = (rng.randn(K, cin, cout) / np.sqrt(K * cin)).astype(np.float32)
    dout = rng.randn(cap_out, cout).astype(np.float32)

    def f(x, wt):
        return jnp.sum(jsp.subm_gather_gemm(x, jnp.asarray(nbr.T), wt) * dout)

    d_feats, d_w = jax.grad(f, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w))
    return feats, nbr, nbr_t, w, dout, np.asarray(d_feats), np.asarray(d_w)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_dw_plain_matches_jax_grad(name):
    feats, nbr, _, _, dout, _, want = _grad_case(name)
    got = sp.sparse_conv_dw_plain(torch.from_numpy(feats), torch.from_numpy(nbr),
                                  torch.from_numpy(dout)).numpy()
    assert got.shape == want.shape
    assert _close(got, want)
    # the wrapper takes the plain version for CPU tensors (no launch)
    launches = sp.sparse_conv_dw.launches
    via = sp.sparse_conv_dw(torch.from_numpy(feats), torch.from_numpy(nbr),
                            torch.from_numpy(dout)).numpy()
    np.testing.assert_array_equal(via, got)
    assert sp.sparse_conv_dw.launches == launches


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_sparse_conv_function_matches_jax_grad(name):
    feats, nbr, nbr_t, w, dout, want_feats, want_w = _grad_case(name)
    x = torch.from_numpy(feats).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = sp.SparseConvFunction.apply(x, wt, torch.from_numpy(nbr),
                                    None if nbr_t is None else torch.from_numpy(nbr_t))
    want_y = sp.sparse_conv_plain(x.detach(), torch.from_numpy(nbr), wt.detach())
    np.testing.assert_array_equal(y.detach().numpy(), want_y.numpy())
    (y * torch.from_numpy(dout)).sum().backward()
    assert _close(x.grad.numpy(), want_feats)
    assert _close(wt.grad.numpy(), want_w)


def test_sparse_conv_function_skips_backward_data_without_input_grad():
    """conv_input's voxel features need no gradient: only the weight gets one."""
    feats, nbr, _, w, dout, _, want_w = _grad_case("subm 16->16")
    x = torch.from_numpy(feats)
    wt = torch.from_numpy(w).requires_grad_()
    (sp.SparseConvFunction.apply(x, wt, torch.from_numpy(nbr)) * torch.from_numpy(dout)).sum() \
        .backward()
    assert x.grad is None and _close(wt.grad.numpy(), want_w)


@pytest.mark.parametrize("momentum", [0.01, 0.1])
def test_masked_bn_training_matches_jax(momentum):
    """One training step of MaskedBatchNorm over rows of two samples: the
    output (inactive rows zero) and the running statistics after it."""
    rng = np.random.RandomState(3)
    C = 8
    x = rng.randn(2, 50, C).astype(np.float32) * 2 + 1
    mask = rng.rand(2, 50) > 0.3
    gamma, beta = rng.normal(1, 0.2, C), rng.normal(0, 0.2, C)
    mean0, var0 = rng.normal(0, 0.2, C), rng.uniform(0.5, 1.5, C)
    jv = {"params": {"scale": jnp.asarray(gamma, jnp.float32),
                     "bias": jnp.asarray(beta, jnp.float32)},
          "batch_stats": {"mean": jnp.asarray(mean0, jnp.float32),
                          "var": jnp.asarray(var0, jnp.float32)}}
    want, upd = JaxMaskedBN(eps=1e-3, momentum=momentum).apply(
        jv, jnp.asarray(x), jnp.asarray(mask), training=True, mutable=["batch_stats"])
    bn = MaskedBatchNorm(C, eps=1e-3, momentum=momentum).train()
    with torch.no_grad():
        for t, v in ((bn.weight, gamma), (bn.bias, beta), (bn.running_mean, mean0),
                     (bn.running_var, var0)):
            t.copy_(torch.as_tensor(v))
    got = bn.sparse(torch.from_numpy(x.reshape(-1, C)), torch.from_numpy(mask.reshape(-1)))
    assert _close(got.detach().numpy(), np.asarray(want).reshape(-1, C))
    assert _close(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]))
    assert _close(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]))
