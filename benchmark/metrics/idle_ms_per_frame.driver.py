"""Milliseconds a profiled frame in which the device idles, in the gaps
that began inside the driver layer's own spans (driver.render,
driver.camera, driver.film, driver.li, driver.bounce: what they hold
outside the other layers' spans). The innermost port span open when the
gap began decides (pbench/layers.py)."""
from pbench import layers


def read(r):
    return layers.per_frame(r, "idle_s", "driver", 1e3)
