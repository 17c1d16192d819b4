"""The port's two probe kernels' plain versions (kernels/probes.py) on
the CPU: against the reference probes themselves, run as Pallas kernels in
interpret mode (`debug_lc_prim2.kernel`, exact; `profile_overhead.make`
for the kinds empty, dma and dma+compute, the first two exact, the third
to rtol = atol = 1e-5), and against a float64 numpy evaluation of what
each kind computes; the bound's operation counts at the probe's shapes;
the wrappers check their inputs and count no launch on the CPU. The CUDA
kernels are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pbrt_tpu_torch.kernels import probes

_cache_dir = jax.config.jax_compilation_cache_dir
import debug_lc_prim2  # noqa: E402
import profile_overhead  # noqa: E402  (sets a compilation cache directory on import)

jax.config.update("jax_compilation_cache_dir", _cache_dir)


@pytest.mark.parametrize("tile", [256, 1024])
def test_compact_plain_is_val_times_mask(tile):
    mask, val = probes.compact_inputs(tile, "cpu")
    assert int(mask.sum()) > 128            # more set lanes than one LC block
    before = probes.compact.launches
    out, slot = probes.compact(mask, val)
    assert probes.compact.launches == before
    m, v = mask.numpy()[0], val.numpy()[0]
    np.testing.assert_array_equal(out.numpy()[0], np.where(m > 0.5, v, 0.0))
    np.testing.assert_array_equal(slot.numpy()[0], np.where(m > 0.5, 1, -1))
    assert slot.dtype == torch.int32


@pytest.mark.parametrize("p", [0.7, 0.0, 1.0, "graded"])
def test_compact_equals_the_reference_probe(p):
    """`debug_lc_prim2.kernel` in interpret mode (its TILE, 256) returns
    the same out and slot as the port, exactly: masks of 0 and 1 set with
    probability p, and a graded mask in [0, 1), which both take as set
    above 0.5 (out = val there, not val·mask); val 0 and -0.0 on set and
    unset lanes, which the reference leaves at out 0, slot -1."""
    tile = debug_lc_prim2.TILE
    mask, val = probes.compact_inputs(tile, "cpu", seed=4, p=0.5 if p == "graded" else p,
                                      zeros=True)
    if p == "graded":
        mask = torch.as_tensor(np.random.RandomState(5).rand(1, tile).astype(np.float32))
    set_zero = (mask > 0.5) & (val == 0)
    assert p == 0.0 or (set_zero & torch.signbit(val)).any() and \
        (set_zero & ~torch.signbit(val)).any()
    out, slot = pl.pallas_call(
        debug_lc_prim2.kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_shape=[jax.ShapeDtypeStruct((1, 1, tile), jnp.float32),
                   jax.ShapeDtypeStruct((1, 1, tile), jnp.int32)],
        interpret=True,
    )(mask.numpy()[None], val.numpy()[None])
    got_out, got_slot = probes.compact(mask, val)
    np.testing.assert_array_equal(np.asarray(out)[0].view(np.int32),
                                  got_out.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(slot)[0], got_slot.numpy())
    assert (got_slot[set_zero] == -1).all()


def _reference_overhead(kind, packed, planes, corder, counts):
    """`profile_overhead.make(kind)` over nt tiles, with the block specs of
    profile_overhead.py:104-110 and TPU interpret mode (its async copies
    and DMA semaphores); out (nt, TILE)."""
    po = profile_overhead
    nt, cw, T = counts.shape[0], corder.shape[1], po.TILE
    in_specs = [pl.BlockSpec((1, 1, 1), lambda i: (i, 0, 0), memory_space=pltpu.SMEM),
                pl.BlockSpec((1, 1, cw), lambda i: (i, 0, 0), memory_space=pltpu.SMEM),
                pl.BlockSpec((1, 1, cw), lambda i: (i, 0, 0), memory_space=pltpu.SMEM)] \
        + [pl.BlockSpec((1, 1, T), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)] * 8 \
        + [pl.BlockSpec(memory_space=pl.ANY)]
    f = pl.pallas_call(
        po.make(kind), grid=(nt,), in_specs=in_specs,
        out_specs=[pl.BlockSpec((1, 1, T), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((nt, 1, T), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((2, 16, 5, po.CH, po.K), jnp.float32),
                        pltpu.SemaphoreType.DMA((2, po.CH))],
        interpret=pltpu.InterpretParams())
    P = planes.numpy().reshape(8, nt, 1, T)
    out = f(counts.numpy()[:, None, None], corder.numpy()[:, None, :],
            np.zeros((nt, 1, cw), np.float32), *P, packed.numpy())[0]
    return np.asarray(out)[:, 0]


@pytest.mark.parametrize("ref_kind,kind", [("empty", "empty"), ("dma", "stage"),
                                           ("dma+compute", "stage+compute")])
def test_overhead_equals_the_reference_probe(ref_kind, kind):
    """The reference probe's kinds against the port's at its layout
    (packed (C, 16, 5, K)), 4 tiles of 20 clusters and CPAD 32, counts
    16, 12 (a partial last round), 0 and 16. empty and stage (dma) agree
    exactly; stage+compute to rtol = atol = 1e-5, because the reference
    takes its 16-term dots on the matrix unit's path (a dot_general in
    interpret mode) and the port sums the products in turn in float32."""
    assert (profile_overhead.CH, profile_overhead.K) == (probes.CH, probes.K)
    nt, tile = 4, profile_overhead.TILE
    packed, planes, corder, _ = probes.overhead_inputs(0, "cpu", nt=nt, tile=tile, c=20,
                                                       cpad=32, seed=3)
    counts = torch.tensor([16, 12, 0, 16], dtype=torch.int32)
    want = _reference_overhead(ref_kind, packed, planes, corder, counts)
    got = probes.overhead(kind, packed, planes, corder, counts, tile).numpy()
    if kind == "stage+compute":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
    if kind != "empty":
        assert (got[2] == 0).all()


@pytest.mark.parametrize("kind", probes.KINDS)
def test_overhead_plain_computes_each_kind(kind):
    nt, tile, count = 6, 64, 20            # three rounds, the last one partial
    packed, planes, corder, counts = probes.overhead_inputs(count, "cpu", nt=nt, tile=tile)
    counts[1] = 0
    before = probes.overhead.launches
    out = probes.overhead(kind, packed, planes, corder, counts, tile).numpy()
    assert probes.overhead.launches == before
    P = planes.numpy().astype(np.float64).reshape(8, nt, tile)
    F = packed.numpy().astype(np.float64)
    want = np.zeros((nt, tile))
    for t in range(nt):
        if kind == "empty":
            want[t] = P[0, t]
            continue
        for r in range(-(-int(counts[t]) // probes.CH)):
            cids = corder[t, r * probes.CH:(r + 1) * probes.CH].numpy()
            if kind == "stage":
                want[t] += F[cids[0], 0, 0, 0]
            else:
                feats = F[cids].transpose(1, 0, 2, 3).reshape(16, -1)   # (16, slots)
                lanes = np.concatenate([P[:, t], P[:, t]])              # (16, tile)
                want[t] += (lanes.T @ feats).min(-1)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    if kind != "empty":
        assert (out[1] == 0).all()


def test_overhead_counts_at_the_probe_shapes():
    """stage+compute at count 64: 1,024 tiles × 8 rounds × 256 lanes ×
    5,120 slots × 32 operations (n5 = 5), a fifth of it at n5 = 1; the
    non-fused issue ceiling counts twice the bound's operations."""
    ops5 = probes.overhead_ops("stage+compute", 64)
    assert ops5 == 1024 * 8 * 256 * 5120 * 32
    assert probes.overhead_ops("stage+compute", 64, n5=1) * 5 == ops5
    assert probes.overhead_ceiling_ops("stage+compute", 64) == 2 * ops5
    assert abs(ops5 / 67e12 * 1e3 - 5.13) < 0.01            # ms, the bound
    assert probes.overhead_ops("stage", 12, nt=2, tile=64) == 2 * 2 * 64


def test_probe_wrappers_check_inputs():
    mask, val = probes.compact_inputs(256, "cpu")
    with pytest.raises(TypeError):
        probes.compact(mask.double(), val)
    with pytest.raises(ValueError):
        probes.compact(mask, val[:, :128])
    packed, planes, corder, counts = probes.overhead_inputs(8, "cpu", nt=2, tile=64)
    with pytest.raises(ValueError):
        probes.overhead("dma", packed, planes, corder, counts, 64)
    with pytest.raises(ValueError):
        probes.overhead("stage", packed, planes, corder[:, :-1], counts, 64)
    with pytest.raises(TypeError):
        probes.overhead("stage", packed, planes, corder.long(), counts, 64)
    with pytest.raises(ValueError):
        probes.overhead("stage", packed, planes, corder, counts, 48)
    with pytest.raises(ValueError):       # the tracers' (C, 24, K) layout
        probes.overhead("stage", packed.reshape(packed.shape[0], -1, probes.K)[:, :24]
                        .contiguous(), planes, corder, counts, 64)
