"""Differentiable and inverse rendering on torch.autograd (counterpart of
pbrt_tpu/diff/inverse.py).

Every random number is a pure function of (pixel, sample, dim), so
differentiating the wavefront integrator is path-replay backprop: the same
paths are traced again under autograd with the same sampling decisions,
and gradients flow through the continuous shading chain (BSDF values,
light emission, camera response). Visibility is detached: the scene
queries hand the tracers detached rays (geom/scene.py), so the CUDA
kernels need no backward pass and give the plain versions' gradients.

The reference's gradient covers kd, ks, kr, kt and light emit. Its eta and
roughness gradients come out NaN on the Cornell box (a NaN in the branch a
`where` does not select still reaches the gradient); the port keeps the
same arithmetic and does not mask it.

Provides: parameter views over a Scene, an L2 and a relative-L2 loss, the
fit loop on torch.optim.Adam (the counterpart of optax.adam) and the
finite-difference check.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch

from .checkpoint import tree_flatten, tree_map

# ------------------------------------------------ parameter views

MATERIAL_FIELDS = ("kd", "ks", "kr", "kt", "roughness", "eta")


def material_params(scene, fields=MATERIAL_FIELDS):
    return {f: getattr(scene.materials, f) for f in fields}


def light_params(scene):
    return {"emit": scene.lights.emit}


def default_params(scene):
    return {"materials": material_params(scene), "lights": light_params(scene)}


def apply_params(scene, params):
    """A new Scene with the given tables' fields replaced. The new Scene
    builds its own light_power cache, so the power strategy's pmf follows
    emit as in the reference."""
    sc = scene
    if "materials" in params:
        sc = dataclasses.replace(sc, materials=dataclasses.replace(sc.materials,
                                                                   **params["materials"]))
    if "lights" in params:
        sc = dataclasses.replace(sc, lights=dataclasses.replace(sc.lights, **params["lights"]))
    return sc


def clamp_params(params):
    """Project back into physically valid ranges after a gradient step."""
    out = dict(params)
    if "materials" in out:
        m = dict(out["materials"])
        for k in ("kd", "ks", "kr", "kt"):
            if k in m:
                m[k] = torch.clamp(m[k], 0.0, 1.0)
        if "roughness" in m:
            m["roughness"] = torch.clamp(m["roughness"], 1e-3, 1.0)
        if "eta" in m:
            m["eta"] = torch.clamp(m["eta"], 1.01, 3.0)
        out["materials"] = m
    if "lights" in out:
        lt = dict(out["lights"])
        if "emit" in lt:
            lt["emit"] = torch.clamp(lt["emit"], min=0.0)
        out["lights"] = lt
    return out


# ------------------------------------------------------- losses

def l2_loss(img, target):
    return torch.mean((img - target) ** 2)


def rel_l2_loss(img, target):
    """Relative L2, the usual inverse-rendering loss (weights down the MC
    noise of bright pixels); the denominator carries no gradient."""
    return torch.mean((img - target) ** 2 / (torch.square(img.detach()) + 1e-2))


# ----------------------------------------------------- optimisation

def leaf_params(tree):
    """Fresh leaf tensors (requires_grad) holding the values of `tree`."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)


def grads_of(loss, leaves):
    """d loss / d leaves, zeros where a leaf does not reach the loss (as
    jax.grad gives them)."""
    return torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)


class FitState(NamedTuple):
    params: dict        # leaf tensors, updated in place by the optimiser
    opt_state: Any      # the torch.optim optimiser over the params' leaves
    step: int


def make_fit_step(render_fn, loss_fn=rel_l2_loss, optimizer=None,
                  param_get=default_params, param_set=apply_params):
    """render_fn(scene, step) -> (H, W, 3) image (`step` may seed the
    sampler so each iteration uses fresh paths). `optimizer` builds a
    torch.optim optimiser from a list of tensors (default Adam at 2e-2,
    betas and eps as optax.adam). Returns (init_fn, step_fn)."""
    optimizer = optimizer or functools.partial(torch.optim.Adam, lr=2e-2)

    def init_fn(scene):
        params = leaf_params(param_get(scene))
        return FitState(params, optimizer(tree_flatten(params)[0]), 0)

    def step_fn(state: FitState, scene, target):
        leaves, _ = tree_flatten(state.params)
        img = render_fn(param_set(scene, state.params), state.step)
        loss = loss_fn(img, target)
        for p, g in zip(leaves, grads_of(loss, leaves)):
            p.grad = g
        state.opt_state.step()
        with torch.no_grad():
            for p, c in zip(leaves, tree_flatten(clamp_params(state.params))[0]):
                p.copy_(c)
        return FitState(state.params, state.opt_state, state.step + 1), loss.detach()

    return init_fn, step_fn


def fit(scene, target, render_fn, n_steps=100, **kw):
    """Optimise scene parameters to match `target`. Returns (optimised
    scene, loss history)."""
    init_fn, step_fn = make_fit_step(render_fn, **kw)
    state = init_fn(scene)
    losses = []
    for _ in range(n_steps):
        state, loss = step_fn(state, scene, target)
        losses.append(float(loss))
    return apply_params(scene, tree_map(torch.Tensor.detach, state.params)), losses


def finite_difference_check(scene, render_fn, param_path, eps=1e-3, loss_fn=None,
                            target=None):
    """Central-difference gradient of ONE scalar parameter beside the
    autograd one. param_path: (group, field, index tuple). Returns
    (autograd_grad, fd_grad)."""
    group, field, idx = param_path
    loss_fn = loss_fn or (lambda img: torch.mean(img))

    def loss_at(value):
        arr = default_params(scene)[group][field].detach().clone()
        arr[idx] = value
        return loss_fn(render_fn(apply_params(scene, {group: {field: arr}}), 0))

    base = default_params(scene)[group][field][idx].detach()
    v = base.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_at(v), v)
    with torch.no_grad():
        lp = loss_at(base + eps)
        lm = loss_at(base - eps)
    return float(g), float((lp - lm) / (2 * eps))
