"""Gathers of rows from tables that autograd trains: `rows(table, idx)`
is `table[idx]`, with a backward on the card that is one launch of
`row_grad_kernel` (kernels/csrc/cluster.cu) in place of PyTorch's
index_put_(accumulate=True).

That backward sorts the ids and then sums each id's run of duplicates
serially, in one group of as many threads as a row is wide: the Cornell
box's 6-row `kd` and 1-row `emit`, gathered by 262,144 lanes a bounce,
left the card behind a handful of threads for about 14 ms a gather. The
kernel sums each block's lanes into per-thread accumulators in shared
memory, reduces them in a fixed tree, and lets the last block to finish
add the blocks' partials in block order: deterministic, with no float
atomic. A table of more than ROW_CHUNK entries is cut into chunks of
ROW_CHUNK, one a row of the grid, which leaves each entry's order of sums
as it is. `row_grad_plain` repeats that order op for op.

`rows` takes the kernel where the backward will run it: grad mode on, a
float32 table on the card that requires grad, int64 or int32 ids.
Everywhere else it returns `table[idx]` itself, the same op: every render
(no table requires grad), the CPU and other dtypes. The two counters
`diff.row_grads` (the kernel's gathers) and `diff.row_grads_plain` (a
table that requires grad, gathered the plain way) record while
pbrt_tpu_torch.trace records."""
from __future__ import annotations

import math
import threading

import torch
from torch.autograd.function import once_differentiable

from .. import trace
from ..kernels import cluster_cuda as ckern

ROW_THREADS = 256                     # threads a block (kRowThreads)
ROW_CHUNK = 48 * 1024 // (4 * ROW_THREADS)   # entries a block: float accumulators a thread in 48 KB
ROW_MAX_ENTRIES = ROW_CHUNK * 65535   # a grid has at most 65,535 rows of chunks
ROW_BLOCKS_PER_SM = 2

_lock = threading.Lock()
_tickets = {}     # (device index, stream) -> u32 tickets, one a chunk, 0 between launches


def row_grad_plain(idx, g, n_rows, blocks, threads=ROW_THREADS):
    """The kernel's sums in its order: (n_rows · cols,) f32 from idx (n,)
    int64 and g (n, cols) f32, with `blocks` blocks a chunk. Thread k of
    the blocks·threads adds lanes k, k + blocks·threads, ... in turn into
    its accumulators; each block's threads are reduced in the tree
    acc[t] += acc[t + s], s = threads/2, ..., 1; the blocks' partials are
    summed in block order. An accumulator that a lane does not touch adds
    +0.0, which leaves every value but −0.0 as it is, and no accumulator is
    ever −0.0."""
    n, cols = g.shape
    ne = n_rows * cols
    width = blocks * threads
    idx = torch.where(idx < 0, idx + n_rows, idx)
    ent = idx[:, None] * cols + torch.arange(cols, device=g.device)
    acc = torch.zeros((width, ne), dtype=torch.float32, device=g.device)
    for k0 in range(0, n, width):
        k1 = min(n, k0 + width)
        step = torch.zeros((k1 - k0, ne), dtype=torch.float32, device=g.device)
        acc[:k1 - k0] = acc[:k1 - k0] + step.scatter_(1, ent[k0:k1], g[k0:k1])
    acc = acc.view(blocks, threads, ne)
    s = threads // 2
    while s:
        acc[:, :s] = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    part = acc[:, 0]
    out = part[0]
    for b in range(1, blocks):
        out = out + part[b]
    return out


def grid(entries, sm_blocks):
    """(blocks a chunk, chunks) of a launch over `entries` table entries
    on a card of `sm_blocks` = ROW_BLOCKS_PER_SM · multiprocessors: a chunk
    of ROW_CHUNK entries a grid row, and about sm_blocks blocks in all,
    whatever the lanes (compaction shrinks them bounce by bounce; a block's
    fixed cost is its tree and its partial)."""
    chunks = -(-entries // ROW_CHUNK)
    return max(1, sm_blocks // chunks), chunks


def launch_grid(device, entries):
    """grid(entries, ·) on the card `device`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return grid(entries, ROW_BLOCKS_PER_SM * sms)


def _ticket(device, stream, chunks):
    key = (device.index, stream.cuda_stream)
    with _lock:
        t = _tickets.get(key)
        if t is None or t.numel() < chunks:
            t = _tickets[key] = torch.zeros(chunks, dtype=torch.int32, device=device)
        return t


def row_grad(idx, g, n_rows, _blocks=None):
    """(n_rows · cols,) f32 on the card: the sum of g's rows (n, cols) f32
    by their id idx (n,) int64, one launch of row_grad_kernel on
    launch_grid's grid (`_blocks` blocks a chunk in its place: the tests'
    other grids)."""
    n, cols = g.shape
    if tuple(idx.shape) != (n,) or idx.dtype != torch.int64 or g.dtype != torch.float32:
        raise ValueError(f"row_grad: idx {tuple(idx.shape)} {idx.dtype}, "
                         f"g {tuple(g.shape)} {g.dtype}")
    ne = n_rows * cols
    if not 0 < ne <= ROW_MAX_ENTRIES:
        raise ValueError(f"row_grad: {n_rows}·{cols} entries, at most {ROW_MAX_ENTRIES}")
    dev = g.device
    if dev.type != "cuda" or idx.device != dev or not (idx.is_contiguous()
                                                       and g.is_contiguous()):
        raise ValueError("row_grad: idx and g must be contiguous on one card")
    blocks, chunks = launch_grid(dev, ne)
    blocks = _blocks or blocks
    lib = ckern.load_library()
    ticket = _ticket(dev, torch.cuda.current_stream(dev), chunks)
    partial = torch.empty((blocks, ne), dtype=torch.float32, device=dev)
    out = torch.empty(ne, dtype=torch.float32, device=dev)
    err = lib.pbrt_row_grad(ckern._ptr(idx), ckern._ptr(g), ckern._ptr(partial),
                            ckern._ptr(ticket), ckern._ptr(out), n, n_rows, cols, blocks,
                            ckern._stream(g))
    if err:
        raise RuntimeError(f"row gradient kernel launch failed: cudaError {err}")
    row_grad.launches += 1
    return out


row_grad.launches = 0


class _Rows(torch.autograd.Function):
    """table[idx] whose backward is row_grad."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        shape = ctx.table_shape
        cols = math.prod(shape[1:])
        idx = idx.reshape(-1).to(grad.device, torch.int64).contiguous()
        g = row_grad(idx, grad.reshape(idx.numel(), cols).contiguous(), shape[0])
        return g.view(shape), None


def takes_kernel(table, idx):
    """Whether the kernel can take the backward of table[idx]: a float32
    table on the card with at most ROW_MAX_ENTRIES entries, int64 or int32
    ids."""
    return (table.is_cuda and table.dtype == torch.float32
            and 0 < table.numel() <= ROW_MAX_ENTRIES
            and idx.dtype in (torch.int64, torch.int32))


def rows(table, idx):
    """table[idx] for a table (R,) or (R, C, ...) and ids of any shape:
    the same op and bits forward; where a gradient is asked for and
    `takes_kernel`, a backward of one row_grad launch."""
    if table.requires_grad and torch.is_grad_enabled():
        if takes_kernel(table, idx):
            trace.count("diff.row_grads", 1)
            return _Rows.apply(table, idx)
        trace.count("diff.row_grads_plain", 1)
    return table[idx]
