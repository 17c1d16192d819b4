"""Readings that set a medium cell's limits: readings.py's render
readings (the port's frame, the control, each planted fault, a seed
each), with the medium cell's scene, integrator and reference
(pbench/medium_render.py).

    python3 benchmark/medium_readings.py --workload fog_box.volpath_4spp --seeds 11,12,13 \\
        [--control] [--faults]

Prints one JSON line a seed and reading."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import readings  # noqa: E402
from pbench import medium_render  # noqa: E402

if __name__ == "__main__":
    with medium_render.ported():
        sys.exit(readings.main())
