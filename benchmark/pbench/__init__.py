"""The benchmark harness of the PyTorch and CUDA port (pbrt_tpu_torch).

run.py runs one cell once. Everything that belongs to one configuration,
one traffic mix or one per-layer metric is a file of its own that the
harness finds by the name BENCHMARK.json gives: configs/<config>.json,
traffic/<mix>.json and metrics/<metric>.py. The frozen arithmetic (peaks,
the roofline work count, the union of device intervals, the percentile
over all frames) and the comparison that decides `correct` live here; the
plain reference the comparison runs is plainref/."""
