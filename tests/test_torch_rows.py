"""`diff.rows`: gathers of rows from small trained tables, on the CPU.

- the plain version of the row-gradient kernel (its order of sums, at
  an H100's grid) against a float64 index_add_, to 1e-6 of each entry's
  sum of magnitudes, over tables (6, 3), (1, 3), (1,), (48, 1) (one
  chunk of the kernel's shared memory) and (100, 3) (seven chunks), ids
  (N,) and (S, B), N 0, 1, 1,000 and 262,147, most ids on row 0 and some
  negative;
- `rows()` on the CPU is `table[idx]`: the same values and gradients, bit
  for bit (torch on one thread, where its own accumulate repeats), and
  the same autograd node; under no_grad, or for a table
  that does not require grad, it gives `table[idx]` with no graph;
- the autograd Function itself (the kernel's route; its backward's
  launch stood in for by the plain version on the CPU) gives
  `table[idx]` forward and the plain version's gradient backward;
- the counters `diff.row_grads` and `diff.row_grads_plain` record inside
  `trace.recording()` only.

The kernel against the plain version, bit for bit, is in
tests/test_torch_cuda.py."""
import math

import numpy as np
import pytest
import torch

from pbrt_tpu_torch import trace
from pbrt_tpu_torch.diff import rows as rmod

H100_BLOCKS = rmod.ROW_BLOCKS_PER_SM * 132     # an H100's 132 multiprocessors


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU accumulate of duplicate ids runs in parallel and its
    sums change with the threads' order; on one thread table[idx]'s
    gradient repeats bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _id_shape(n, two_d):
    if not two_d:
        return (n,)
    if n == 0:
        return (0, 5)
    d = max(k for k in range(1, math.isqrt(n) + 1) if n % k == 0)
    return (d, n // d)


def _case(shape, n, two_d, seed=5):
    """A table requiring grad, ids of shape _id_shape(n, two_d) (80% on
    row 0, a tenth of the rest counted from the end) and an incoming
    gradient of both signs."""
    gen = torch.Generator().manual_seed(seed + n)
    r = shape[0]
    table = torch.rand(shape, generator=gen).requires_grad_(True)
    ids = torch.randint(0, r, (n,), generator=gen)
    ids = torch.where(torch.rand(n, generator=gen) < 0.8, 0, ids)
    ids = torch.where(torch.rand(n, generator=gen) < 0.1, ids - r, ids)
    idx = ids.reshape(_id_shape(n, two_d))
    w = torch.rand(idx.shape + shape[1:], generator=gen) * 2.0 - 1.0
    return table, idx, w


def _float64_grad(table, idx, w):
    """(ref, Σ|w|) per table entry, in float64."""
    flat = idx.reshape(-1) % table.shape[0]
    g = w.reshape(flat.numel(), math.prod(table.shape[1:])).double()
    ref = torch.zeros(table.shape[0], g.shape[1], dtype=torch.float64).index_add_(0, flat, g)
    mag = torch.zeros_like(ref).index_add_(0, flat, g.abs())
    return ref.reshape(-1), mag.reshape(-1)


@pytest.mark.parametrize("n", [0, 1, 1000, 262147])
@pytest.mark.parametrize("two_d", [False, True], ids=["N", "SxB"])
@pytest.mark.parametrize("shape", [(6, 3), (1, 3), (1,), (48, 1), (100, 3)], ids=str)
def test_rows_and_the_plain_row_gradient(shape, two_d, n, monkeypatch):
    table, idx, w = _case(shape, n, two_d)
    cols = math.prod(shape[1:])
    blocks = rmod.grid(shape[0] * cols, H100_BLOCKS)[0]

    # the plain version's sums against float64
    plain = rmod.row_grad_plain(idx.reshape(-1), w.reshape(n, cols), shape[0], blocks)
    ref, mag = _float64_grad(table, idx, w)
    assert plain.dtype == torch.float32 and plain.shape == (shape[0] * cols,)
    assert ((plain.double() - ref).abs() <= 1e-6 * mag).all()
    assert torch.equal(plain[mag == 0], torch.zeros(int((mag == 0).sum())))

    # rows() on the CPU is table[idx], forward and backward, bit for bit
    want = table[idx]
    (g_want,) = torch.autograd.grad((want * w).sum(), table)
    got = rmod.rows(table, idx)
    assert type(got.grad_fn) is type(want.grad_fn)
    (g_got,) = torch.autograd.grad((got * w).sum(), table)
    assert torch.equal(got, want) and torch.equal(g_got, g_want)

    # no graph where no gradient is asked for
    with torch.no_grad():
        off = rmod.rows(table, idx)
    fixed = rmod.rows(table.detach(), idx)
    assert off.grad_fn is None and fixed.grad_fn is None
    assert torch.equal(off, want) and torch.equal(fixed, want)

    # the Function: table[idx] forward, the plain version's sums backward
    monkeypatch.setattr(rmod, "row_grad",
                        lambda i, g, r: rmod.row_grad_plain(i, g, r, blocks))
    out = rmod._Rows.apply(table, idx)
    (g_fn,) = torch.autograd.grad((out * w).sum(), table)
    assert torch.equal(out, want)
    assert torch.equal(g_fn.reshape(-1), plain)


def test_row_gradient_counters_record_only_while_tracing(monkeypatch):
    table = torch.rand(6, 3).requires_grad_(True)
    idx = torch.tensor([0, 5, 5, -1])
    trace.clear()
    rmod.rows(table, idx)
    assert trace.counters() == {}
    with trace.recording() as rec:
        rmod.rows(table, idx)                          # CPU: the plain gather
        rmod.rows(table.detach(), idx)                 # no grad: not counted
        with torch.no_grad():
            rmod.rows(table, idx)
        monkeypatch.setattr(rmod, "takes_kernel", lambda t, i: True)
        out = rmod.rows(table, idx)                    # the kernel's route
    assert rec.counters() == {"diff.row_grads": 1, "diff.row_grads_plain": 1}
    assert isinstance(out.grad_fn, torch.autograd.function.BackwardCFunction)
    rmod.rows(table, idx)
    assert trace.counters() == rec.counters()
    trace.clear()


def test_what_takes_the_kernel():
    """The device, the dtypes and the entries decide (grad mode and
    requires_grad in rows()); the CPU never takes it; the grid keeps about
    2·SMs blocks over chunks of 48 entries; the wrapper refuses what the
    kernel cannot take, a CPU tensor among them."""
    idx = torch.tensor([0, 5])
    assert not rmod.takes_kernel(torch.rand(6, 3), idx)
    assert rmod.ROW_CHUNK == 48 and rmod.ROW_MAX_ENTRIES == 48 * 65535
    assert [rmod.grid(e, 264) for e in (1, 18, 48, 49, 300, 48 * 264, 48 * 300)] == [
        (264, 1), (264, 1), (264, 1), (132, 2), (37, 7), (1, 264), (1, 300)]
    with pytest.raises(ValueError):
        rmod.row_grad(torch.zeros(4, dtype=torch.int64), torch.zeros(4, 1), 48 * 65535 + 1)
    with pytest.raises(ValueError):
        rmod.row_grad(torch.zeros(4, dtype=torch.int32), torch.zeros(4, 3), 6)
    with pytest.raises(ValueError):
        rmod.row_grad(torch.tensor([0, 1, 1]), torch.ones(3, 2), 2)
    np.testing.assert_array_equal(
        rmod.row_grad_plain(torch.tensor([0, 1, 1]), torch.ones(3, 2), 2, 1).numpy(),
        [1, 1, 2, 2])
