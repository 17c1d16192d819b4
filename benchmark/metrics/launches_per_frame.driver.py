"""Kernels a profiled frame launched inside the driver layer's own spans
(driver.render, driver.camera, driver.film, driver.li, driver.bounce:
what they hold outside the other layers' spans). The innermost port span
open when the kernel's launch call began decides (pbench/layers.py)."""
from pbench import layers


def read(r):
    return layers.per_frame(r, "launches", "driver")
