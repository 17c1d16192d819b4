"""Device milliseconds per profiled frame in every kernel outside the
cluster tracer: shading, lights, sampler, integrator bookkeeping, the
tracer's sorting and padding, and the quadric pass."""
import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_metric_tracer_names", os.path.join(os.path.dirname(__file__),
                                              "tracer_device_ms_per_frame.py"))
_tracer = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_tracer)


def read(r):
    if not r.kernels():
        return None
    return 1e3 * r.kernel_seconds(lambda n: not _tracer.is_tracer(n)) / r.n
