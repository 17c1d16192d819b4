"""Differentiable and inverse rendering on torch.autograd (counterpart of
pbrt_tpu/diff): parameter views over a Scene, losses, the fit loop and its
finite-difference check (inverse.py), resumable renders and the pytree
checkpoint in the reference's .npz layout (checkpoint.py), and the
config-5 demo (demo.py)."""
