"""The comparison that decides `correct`: the numbers compared and their
limits. Each cell's limits are a file of their own, limits/<cell>.json,
set from the readings PERF.md gives (sound runs of the port below, the
control above)."""
from __future__ import annotations

import json
import os
import sys

import torch

from .manifest import BENCH_DIR

# a pixel channel agrees when |port - reference| <= ATOL + RTOL |reference|
ATOL, RTOL = 1e-4, 1e-3


def limits(cell_name):
    with open(os.path.join(BENCH_DIR, "limits", f"{cell_name}.json")) as f:
        return json.load(f)


def image_numbers(img, ref):
    """Numbers of one frame against the reference's: the share of pixels
    that disagree in some channel (NaN disagrees) and the gap of the
    image sums over the reference's."""
    a, b = img.double().cpu(), ref.double().cpu()
    ok = ((a - b).abs() <= ATOL + RTOL * b.abs()).all(-1)
    return {"pixel_mismatch_share": float(1.0 - ok.double().mean()),
            "image_sum_gap": float((a.sum() - b.sum()).abs() / b.abs().sum())}


def _norm(x):
    return float(torch.linalg.vector_norm(x.double()))


def leaf_gaps(prog, ref):
    """Worst leaf's gap between the norms of prog's and ref's leaves (dicts
    of tensors), over the larger of the reference leaf's norm and the
    median leaf's. Leaves whose reference norm is under a thousandth of
    the median leaf's are left out (nought to rounding)."""
    norms = {k: _norm(v) for k, v in ref.items()}
    med = sorted(norms.values())[(len(norms) - 1) // 2]
    gaps = [abs(_norm(prog[k]) - n) / max(n, med) for k, n in norms.items()
            if n >= 1e-3 * med]
    return max(gaps) if gaps else 0.0


def judge(numbers, lim):
    """(correct, compared): each number beside its limit, in the order of
    the limits file. A number that is NaN or missing fails."""
    compared = {}
    ok = True
    for k, limit in lim.items():
        v = numbers.get(k)
        compared[k] = {"value": v, "limit": limit}
        ok = ok and v is not None and v <= limit
    return ok, compared


def say(compared):
    """The numbers compared, beside their limits, as the last lines of
    standard error."""
    for k, c in compared.items():
        print(f"compared {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
