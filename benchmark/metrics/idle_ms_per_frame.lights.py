"""Milliseconds a profiled frame in which the device idles, in the gaps
that began inside the lights' spans (lights.emission: the emission
pickup; lights.nee: select_light and nee_light_defer). The innermost
port span open when the gap began decides (pbench/layers.py)."""
from pbench import layers


def read(r):
    return layers.per_frame(r, "idle_s", "lights", 1e3)
