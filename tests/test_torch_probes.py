"""The port's two probe kernels' plain versions (kernels/probes.py) on
the CPU: the compaction probe returns val·mask and slot 1/-1 at the
probe's tile (256) and the port's (1,024); the overhead probe's three
kinds against a float64 numpy evaluation of what each kind computes
(rtol 1e-5: float32 sums of 16 products against float64); the wrappers
check their inputs and count no launch on the CPU. The CUDA kernels are
held to these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 7)."""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.kernels import probes


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
                want[t] += F[cids[0], 0, 0]
            else:
                feats = F[cids][:, :16].transpose(1, 0, 2).reshape(16, -1)   # (16, slots)
                lanes = np.concatenate([P[:, t], P[:, t]])                    # (16, tile)
                want[t] += (lanes.T @ feats).min(-1)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    if kind != "empty":
        assert (out[1] == 0).all()


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
