"""The share of a step's wall time in which no operation runs on the
device, in %: one minus the device's busy time a step (the union of
device intervals over the profiled steps) over the step's wall time
untraced (the host clock over as many steps run just before the profile,
in the same run), so that the profiler's cost on the host's issue does
not count as idle time."""


def read(r):
    if not r.trace.device or not r.untraced_s:
        return None
    return 100.0 * (1.0 - r.busy_s() / r.n / r.untraced_s)
