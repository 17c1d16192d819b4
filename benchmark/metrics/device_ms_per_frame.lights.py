"""Device milliseconds a profiled frame in the kernels launched inside the
lights' spans (lights.emission: the emission pickup; lights.nee:
select_light and nee_light_defer). The innermost port span open when the
kernel's launch call began decides (pbench/layers.py)."""
from pbench import layers


def read(r):
    return layers.per_frame(r, "device_s", "lights", 1e3)
