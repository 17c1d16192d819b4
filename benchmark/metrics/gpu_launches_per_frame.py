"""Device kernels launched per profiled frame (driver and integrators)."""


def read(r):
    k = r.kernels()
    return len(k) / r.n if k else None
