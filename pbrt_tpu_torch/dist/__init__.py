"""Multi-device rendering on torch.distributed (counterpart of
pbrt_tpu/dist): pixel sharding over the ranks of a process group and the
inverse-rendering step with its gradient all-reduce (sharding.py), and
the multi-process entry (multihost.py)."""
