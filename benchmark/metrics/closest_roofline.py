"""The closest-hit kernel's share of its roofline over the profiled
frames: the least time of its launches (pbench/roofline.py, counted from
the rays and hits at geom/cluster._trace) over their measured device
time, in %."""


def read(r):
    roof = r.roofline("closest")
    measured = r.kernel_seconds(lambda n: "closest_kernel" in n)
    if roof is None or measured <= 0.0:
        return None
    return 100.0 * roof["least_s"] / measured
