"""Device milliseconds per profiled frame in the cluster tracer's
kernels (kernels/csrc/cluster.cu): coverage, tile order, closest hit and
any hit."""

TRACER = ("coverage_lanes_kernel", "coverage_columns_kernel", "tile_order_kernel",
          "closest_kernel", "occluded_kernel")


def is_tracer(name):
    return any(k in name for k in TRACER)


def read(r):
    if not any(is_tracer(k[0]) for k in r.kernels()):
        return None
    return 1e3 * r.kernel_seconds(is_tracer) / r.n
