"""Device milliseconds per traced training step in TrainStep.backward:
the union of the device's activity inside each `backward` span (the
forward is synchronised before the span and the span ends in
torch.cuda.synchronize(), so what runs on the device inside it is the
backward's work). The profiler slows the host's issue, not the device's
kernels, so this reads the backward's device time, not its wall time."""
from pbench import stats


def read(r):
    spans = r.trace.spans.get("backward")
    if not spans or not r.trace.device:
        return None
    dev = [(s, e) for _, s, e in r.trace.device]
    return 1e3 * sum(stats.union_seconds(dev, lo, hi) for lo, hi in spans) / r.n
