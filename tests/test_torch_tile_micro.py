"""Port parity of the memory probes (bevfusion_tpu_torch/tools/bench_tile_micro.py)
against the TPU kernels of tools/bench_tile_micro.py, run in Pallas's
interpret mode on the CPU.

The two Pallas bodies are copied here from tools/bench_tile_micro.py:50-61
and :77-106 (the tool builds them inside functions that time them rather
than return them). bf16 in and out, and both sides add in fp32 and round
once to bf16, so the plain versions must equal the bodies bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bevfusion_tpu_torch.tools import bench_tile_micro as tm

torch.set_num_threads(2)


def _k5_pallas(x, blk):
    """tools/bench_tile_micro.py:50-61 (bench_copy_bw's kernel), interpret mode."""
    M = x.shape[0]

    def kern(i_ref, o_ref):
        o_ref[:] = i_ref[:] + 1

    return pl.pallas_call(
        kern,
        grid=(M // blk,),
        in_specs=[pl.BlockSpec((blk, 1024), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((blk, 1024), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((M, 1024), jnp.bfloat16),
        interpret=True,
    )(x)


def _k6_pallas(slots, pool, R, G, steps):
    """tools/bench_tile_micro.py:77-106 (bench_dma_rand's kernel), interpret mode."""
    def kern(slots_ref, pool_hbm, o_ref, scr, sems):
        s = pl.program_id(0)

        def dma(g, slot):
            start = pl.multiple_of(slots_ref[s * G + g], 8)
            return pltpu.make_async_copy(
                pool_hbm.at[pl.ds(start, R)], scr.at[slot], sems.at[slot])

        for g in range(G):
            dma(g, g % 2).start()
            if g > 0:
                dma(g - 1, (g - 1) % 2).wait()
            if g == G - 1:
                dma(g, g % 2).wait()
        acc = scr[0] + scr[1]
        o_ref[:] = acc.astype(jnp.bfloat16)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(steps,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec((R, 128), lambda s, *_: (0, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, R, 128), jnp.bfloat16), pltpu.SemaphoreType.DMA((2,))],
    )
    return pl.pallas_call(kern, grid_spec=grid_spec,
                          out_shape=jax.ShapeDtypeStruct((R, 128), jnp.bfloat16),
                          interpret=True)(slots, pool)


def _bf16(a):
    """numpy float32 -> (torch bf16, jax bf16) holding the same values."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _bits(t):
    return t.view(torch.int16).numpy()


def test_copy_plain_equals_the_tpu_body():
    rng = np.random.RandomState(0)
    x_t, x_j = _bf16((rng.randn(64, 1024) * 4).astype(np.float32))
    want = torch.from_numpy(np.array(_k5_pallas(x_j, 32).astype(jnp.float32))).to(torch.bfloat16)
    got = tm.copy_add_one_plain(x_t)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the wrapper takes the plain version for a CPU tensor: no launch
    launches = tm.copy_add_one.launches
    np.testing.assert_array_equal(_bits(tm.copy_add_one(x_t)), _bits(want))
    assert tm.copy_add_one.launches == launches


@pytest.mark.parametrize("G", [2, 3, 4, 8])
def test_gather_plain_equals_the_tpu_body(G):
    T, R, steps = 16, 8, 3
    rng = np.random.RandomState(G)
    pool_t, pool_j = _bf16((rng.randn(T * R, 128) * 3).astype(np.float32))
    slots = (rng.randint(0, T, steps * G) * R).astype(np.int32)
    want = np.array(_k6_pallas(jnp.asarray(slots), pool_j, R, G, steps).astype(jnp.float32))
    want = torch.from_numpy(want).to(torch.bfloat16)
    got = tm.gather_tiles_plain(pool_t, torch.from_numpy(slots), R, G)
    assert got.shape == (R, 128) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    launches = tm.gather_tiles.launches
    np.testing.assert_array_equal(_bits(tm.gather_tiles(pool_t, torch.from_numpy(slots), R, G)),
                                  _bits(want))
    assert tm.gather_tiles.launches == launches


def test_gather_plain_reads_the_last_steps_last_two_tiles():
    pool, slots = tm.gather_inputs(T=10, R=3, G=4, steps=5, device="cpu", seed=1)
    assert pool.shape == (30, 128) and slots.dtype == torch.int32
    assert int(slots.min()) >= 0 and int(slots.max()) + 3 <= 30 and (slots % 3 == 0).all()
    a, b = (int(s) for s in slots[-2:])
    assert torch.equal(tm.gather_tiles_plain(pool, slots, 3, 4), pool[a:a + 3] + pool[b:b + 3])


@pytest.mark.parametrize("bad", ["G1", "slots_len", "slots_dtype", "pool_width", "engine"])
def test_gather_rejects_what_it_does_not_take(bad):
    pool, slots = tm.gather_inputs(T=8, R=2, G=4, steps=2, device="cpu")
    R, G, engine = 2, 4, "tma"
    if bad == "G1":
        G = 1
    elif bad == "slots_len":
        slots = slots[:-1]
    elif bad == "slots_dtype":
        slots = slots.long()
    elif bad == "engine":
        engine = "dma"
    else:
        pool = pool[:, :64]
    with pytest.raises((ValueError, TypeError)):
        tm.gather_tiles(pool, slots, R, G, engine)


@pytest.mark.parametrize("engine,G", [("tma", 2048), ("tma", 2049), ("cp_async", 2049)])
def test_gather_takes_g_up_to_what_the_tma_engine_stages(engine, G):
    """On every device, the TMA engine takes G <= 2048 (the slots a block
    stages in shared memory at once); the first form takes any G."""
    pool, _ = tm.gather_inputs(T=8, R=2, G=4, steps=2, device="cpu")
    slots = torch.zeros(2 * G, dtype=torch.int32)
    if engine == "tma" and G > tm.TMA_MAX_G:
        with pytest.raises(ValueError):
            tm.gather_tiles(pool, slots, 2, G, engine)
    else:
        assert torch.equal(tm.gather_tiles(pool, slots, 2, G, engine), pool[0:2] + pool[0:2])


def test_probe_functions_on_the_cpu():
    """The probes' functions run at a tiny size on the CPU and give finite
    rows with their bounds (their times are host times, not the card's)."""
    c = tm.bench_copy(M=64, device="cpu", iters=2, warmup=1)
    g = tm.bench_gather(T=16, R=8, G=3, steps=4, device="cpu", iters=2, warmup=1)
    m = tm.bench_matmul(64, 32, 16, device="cpu", iters=2, warmup=1)
    for row in (c, g, m):
        assert all(np.isfinite(v) for v in row.values() if isinstance(v, float)), row
    assert c["bound_by"] == g["bound_by"] == "bytes"
    assert g["pool_bytes"] == 16 * 8 * 256 and g["l2_resident"]
    assert c["bound_ms"] == pytest.approx(2 * 64 * 1024 * 2 / 3.35e12 * 1e3)
    # each distinct tile of the 12 drawn read once (a tile drawn twice is
    # not read from memory twice), the output and the slots once
    _, slots = tm.gather_inputs(16, 8, 3, 4, "cpu")
    distinct = len(np.unique(slots.numpy()))
    assert g["distinct_tiles"] == distinct < 12
    assert g["bound_ms"] == pytest.approx((distinct * 8 * 256 + 8 * 256 + 4 * 12) / 3.35e12 * 1e3)
    assert g["hbm_share"] is None  # the pool fits the L2: the HBM bound is no floor there
    assert tm.gather_share(g) == "L2-resident, no HBM share"
    assert tm.gather_share(dict(g, hbm_share=0.5)) == "0.500 of the HBM bound"


def test_gather_bench_reports_both_engines_on_the_cpu():
    """``bench_gather`` times both engines in one run (here both take the
    plain path, host times): per engine ms, GB/s and ns per tile of all
    tile reads, the HBM share and the rate of all reads over 3.35 TB/s;
    the top level is the TMA engine's, which ``gather_tiles`` launches."""
    T, R, G, steps = 16, 8, 3, 4
    g = tm.bench_gather(T=T, R=R, G=G, steps=steps, device="cpu", iters=2, warmup=1)
    assert set(g["engines"]) == set(tm.ENGINES) == {"tma", "cp_async"}
    reads = steps * G * R * 256
    for e in g["engines"].values():
        assert np.isfinite(e["ms"]) and e["ms"] > 0
        assert e["gb_per_s"] == pytest.approx(reads / e["ms"] / 1e6)
        assert e["ns_per_tile"] == pytest.approx(e["ms"] * 1e6 / (steps * G))
        assert e["reads_over_hbm"] == pytest.approx(e["gb_per_s"] * 1e9 / 3.35e12)
        assert e["hbm_share"] is None  # L2-resident
    for key in ("ms", "gb_per_s", "ns_per_tile", "hbm_share", "reads_over_hbm"):
        assert g[key] == g["engines"]["tma"][key]
    assert np.isfinite(g["plain_ms"]) and g["library_ms"] is None


def test_gather_counts_no_launch_on_the_cpu():
    pool, slots = tm.gather_inputs(T=8, R=2, G=4, steps=2, device="cpu")
    before = tm.gather_tiles.launches, dict(tm.gather_tiles.launches_by_engine)
    for engine in tm.ENGINES:
        assert torch.equal(tm.gather_tiles(pool, slots, 2, 4, engine),
                           tm.gather_tiles_plain(pool, slots, 2, 4))
    assert (tm.gather_tiles.launches, tm.gather_tiles.launches_by_engine) == before
