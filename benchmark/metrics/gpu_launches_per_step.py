"""Device kernels launched per profiled training step (forward, backward and update)."""


def read(r):
    k = r.kernels()
    return len(k) / r.n if k else None
