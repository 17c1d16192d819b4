"""The PyTorch port's Metropolis light transport against pbrt_tpu, and
path.li's provider.

MLT on the specular Cornell box (mirror and glass spheres, area light),
8×8, depth 2, 256 bootstrap samples, 64 chains, 2 mutations a pixel (two
mutation steps), the port's native scene against the JAX scene. The
reference runs its own render (tests/test_torch_bdpt.reference_jit), its
mutation loop's carry read after every step by a debug callback; the
port's chains are read by wrapping its mutation step (mlt._mutate). So
the chains are compared after every mutation: the seeded states and, at
each step, each chain's u (atol 1e-6), L and luminance (rtol 1e-4, atol
1e-6) and film position (atol 1e-4), and whether it took its proposal. A
chain whose accept decision differs leaves the comparison from then on,
and only if a float64 re-evaluation of its decision (|u_accept − min(1,
lum_prop / lum_cur)| < 1e-5 on the port's luminances) puts it at its
threshold, as tests/test_torch_media.py exempts media decisions. The
image is held at rtol 1e-4, atol 1e-6 and by the pixel check of
tests/test_oracle.py, away from the pixels around the positions any such
chain held or proposed after it left.

Depth 2, not 3: the reference's render takes about 61 s at depth 3 on an
8-core CPU, 52 s of it tracing and compiling its two jitted programs
(35 s at depth 2). The mutation step has no
branch that depends on the depth: the large and the small step, the wrap,
both expected-value splats and the accept run the same code, over D =
DIM_BOUNCE0 + depth · DIMS_PER_BOUNCE + 2 columns. Depth 2 has the
provider serve a bounce past the first (its per-bounce dimensions);
depth 3 would add one more bounce of the same path.li code, which
tests/test_torch_path.py holds to the reference at depth 5.

path.li with default_provider passed in equals path.li without one, bit
for bit (the matte box, no compaction, no texture). Torch runs on one
thread."""
import jax
import numpy as np
import torch

from pbrt_tpu.integrate import mlt as jmlt
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_oracle import _check
from tests.test_torch_bdpt import reference_jit
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)

from pbrt_tpu_torch import bridge, scenes as tscenes
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.integrate import driver as tdriver, mlt as tmlt, path as tpath

RES, DEPTH = 8, 2
MARGIN = 1e-5


def jax_chains(scene, cam, cfg):
    """The reference's render and its chains' (u, L, p, lum) before the
    first mutation and after each."""
    states, real = [], jax.lax.fori_loop

    def record(*carry):
        states.append([np.asarray(c) for c in carry])

    def fori_loop(lo, hi, body, init):
        jax.debug.callback(record, *init[:4], ordered=True)

        def step(i, carry):
            carry = body(i, carry)
            jax.debug.callback(record, *carry[:4], ordered=True)
            return carry
        return real(lo, hi, step, init)

    jax.lax.fori_loop = fori_loop
    try:
        with reference_jit():
            img = np.asarray(jmlt.render(scene, cam, cfg))
    finally:
        jax.lax.fori_loop = real
    return img, states


def port_chains(monkeypatch, tcfg):
    """The port's render and its chains' states: the seeded state, then
    after each mutation the state with the step's p_prop, lum_prop,
    accept, u_accept, take and lum_prev (lum_cur before it), read by
    wrapping the render's mutation step."""
    steps, real = [], tmlt._mutate

    def mutate(scene, camera, cfg, seed, m, chains, splat):
        out = real(scene, camera, cfg, seed, m, chains, splat)
        if not steps:
            steps.append({k + "_cur": v.numpy().copy() for k, v in chains.items()})
        st = {k + "_cur": v.numpy().copy() for k, v in out[0].items()}
        st.update({k: v.numpy().copy() for k, v in out[3].items()}, lum_prev=chains["lum"].numpy())
        steps.append(st)
        return out

    monkeypatch.setattr(tmlt, "_mutate", mutate)
    img_t, stats = tmlt.render(tscenes.cornell_spheres(True, "area", "cpu", tile=256),
                               tscenes.cornell_camera((RES, RES), "cpu"), tcfg,
                               return_stats=True)
    return img_t.numpy(), stats, steps


def test_mlt_matches_jax_after_every_mutation(monkeypatch):
    jcfg = jmlt.MLTConfig(width=RES, height=RES, max_depth=DEPTH, n_bootstrap=256, n_chains=64,
                          mutations_per_pixel=2)
    img_j, states_j = jax_chains(jcornell_spheres(specular=True, light="area"),
                                 jcornell_camera((RES, RES)), jcfg)
    img_t, stats, steps = port_chains(monkeypatch, bridge.mlt_config(jcfg))
    n_mut = RES * RES * 2 // 64
    assert len(steps) == n_mut + 1 and len(states_j) == n_mut + 1
    assert float(stats["rays_traced"]) >= 256 + 64 * (n_mut + 1)
    seeded, steps = steps[0], steps[1:]
    for k, (j, tol) in zip(("u_cur", "L_cur", "p_cur", "lum_cur"),
                           zip(states_j[0], (dict(atol=1e-6), dict(rtol=1e-4, atol=1e-6),
                                             dict(atol=1e-4), dict(rtol=1e-4, atol=1e-6)))):
        np.testing.assert_allclose(seeded[k], j, err_msg=k, **tol)
    same = np.ones(64, bool)        # chains still in the comparison
    prev_u_j = states_j[0][0]
    left = []                        # (chain, mutation) where a chain left
    for m, st in enumerate(steps):
        u_j, L_j, p_j, lum_j = states_j[m + 1]
        take_j = (u_j != prev_u_j).any(-1)
        prev_u_j = u_j
        differ = same & (take_j != st["take"])
        accept64 = np.minimum(1.0, st["lum_prop"].astype(np.float64)
                              / np.maximum(st["lum_prev"].astype(np.float64), 1e-12))
        margin = np.abs(st["u_accept"].astype(np.float64) - accept64)
        assert (margin[differ] < MARGIN).all(), \
            f"mutation {m}: chains {np.nonzero(differ)[0]} decide apart away from threshold"
        left += [(c, m) for c in np.nonzero(differ)[0]]
        same &= ~differ
        np.testing.assert_allclose(st["u_cur"][same], u_j[same], atol=1e-6)
        np.testing.assert_allclose(st["L_cur"][same], L_j[same], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(st["lum_cur"][same], lum_j[same], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(st["p_cur"][same], p_j[same], atol=1e-4)
    assert same.sum() >= 60 and any(st["take"].any() for st in steps)

    # the image, away from where the chains that left could splat
    keep = np.ones((RES, RES), bool)
    for c, m0 in left:
        for m in range(m0, n_mut):
            for p in (steps[m]["p_cur"][c], steps[m]["p_prop"][c], states_j[m][2][c],
                      states_j[m + 1][2][c]):
                x, y = int(p[0]), int(p[1])
                keep[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2] = False
    assert keep.mean() > 0.5 and np.isfinite(img_t).all() and img_t.mean() > 0.05
    np.testing.assert_allclose(img_t[keep], img_j[keep], rtol=1e-4, atol=1e-6)
    _check(img_t[keep], img_j[keep])


def test_default_provider_equals_no_provider():
    cfg = tdriver.RenderConfig(width=RES, height=RES, spp=2, max_depth=3,
                               sampler=tsmp.SamplerConfig(kind="random", spp=2))
    scene = tscenes.cornell_spheres(False, "area", "cpu", tile=256)
    pid, sid = tdriver.lane_ids(cfg, 0, 2, "cpu")
    o, d, _, _ = tdriver.camera_rays(tscenes.cornell_camera((RES, RES), "cpu"), cfg, pid, sid)
    plain = tpath.li(scene, o, d, pid, sid, cfg)
    given = tpath.li(scene, o, d, pid, sid, cfg,
                     provider=tpath.default_provider(cfg, pid, sid))
    assert torch.equal(plain, given) and plain.shape == (2, RES * RES, 3)
    assert float(plain.mean()) > 0.05
