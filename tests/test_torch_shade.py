"""PyTorch port vs the JAX package, per lane: material resolve / sample /
evaluate / pdf for the bench's matte and plastic materials, the mip-mapped
image texture lookup, and area-light sampling.

Inputs are random (wo, u, uv) batches made with numpy. Tolerance: rtol
1e-4 with atol 1e-6 for values near zero (transcendentals differ by an ulp
between XLA and PyTorch)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.shade import materials as jmat
from pbrt_tpu.shade import textures as jtex
from pbrt_tpu.lights import lights as jlights
from scenes.bunny import mesh_scene

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.geom import bvh as tbvh
from pbrt_tpu_torch.geom import instances as tinst
from pbrt_tpu_torch.shade import materials as tmat
from pbrt_tpu_torch.shade import media as tmedia
from pbrt_tpu_torch.shade import textures as ttex
from pbrt_tpu_torch.lights import lights as tlights

RTOL, ATOL = 1e-4, 1e-6
TRI_FIELDS = ("positions", "indices", "normals", "uvs", "has_normals", "material_id",
              "light_id")


def scene_tree(js):
    """The JAX scene's arrays as the dict bridge.scene_from_numpy takes."""
    a = lambda obj, names: {n: np.asarray(getattr(obj, n)) for n in names}  # noqa: E731
    lt = js.lights
    lights = a(lt, [k for k, _ in tlights.COLUMNS])
    for part in ("conditional", "marginal"):
        d1 = getattr(lt.env_dist, part)
        lights.update({f"{part}_{k}": np.asarray(getattr(d1, k))
                       for k in ("func", "cdf", "func_int")})
    lights["env_index"] = lt.env_index
    n_quad = int(js.quad.kind.shape[0])
    tree = dict(
        tri=a(js.tri, TRI_FIELDS),
        quad=a(js.quad, js.quad._fields) if n_quad else None,
        clusters=a(js.clusters, js.clusters._fields) if js.clusters is not None else None,
        materials=a(js.materials, ("kind", "remap_roughness", *tmat.FLOAT_COLUMNS,
                                   *tmat.TEXTURE_COLUMNS)),
        lights=lights, textures=None,
        light_distrib=(a(js.light_distrib, js.light_distrib._fields)
                       if js.light_distrib is not None else None),
        world_center=np.asarray(js.world_center),
        world_radius=float(js.world_radius), quad_count=n_quad,
        instance_count=len(js.instances or ()),
        instances=[dict(proto=a(s.proto, TRI_FIELDS), **a(s, [k for k, _ in tinst.COLUMNS]),
                        animated=s.animated) for s in js.instances or ()] or None,
        bvh=a(js.bvh, tbvh.COLUMNS) if js.bvh is not None else None,
        media=a(js.media, tmedia.COLUMNS) if js.media is not None else None)
    for k in ("med_inside", "med_outside"):
        col = getattr(js.materials, k)
        tree["materials"][k] = None if col is None else np.asarray(col)
    sss, ft = js.materials.sss_table, js.materials.fourier_table
    tree["materials"]["sss_table"] = None if sss is None else a(sss, sss._fields)
    tree["materials"]["fourier_table"] = None if ft is None else dict(
        a(ft, ("mu", "a", "m")), eta=ft.eta, m_max=ft.m_max)
    if js.textures is not None:
        tree["textures"] = a(js.textures, ttex.COLUMNS)
        tree["textures"]["atlas_base"] = js.textures.atlas_base
    return tree


@pytest.fixture(scope="module")
def scenes():
    js = mesh_scene(subdivisions=1, use_bvh=True)
    return js, bridge.scene_from_numpy(scene_tree(js), "cpu", tile=256)


def _close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **{"rtol": RTOL, "atol": ATOL, **kw})


def _batch(n, seed):
    r = np.random.RandomState(seed)
    wo = r.randn(n, 3)
    wo[: n // 8, 2] *= -1.0
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    wo[:, 2] = np.where(np.abs(wo[:, 2]) < 1e-3, 1e-3, wo[:, 2])
    return dict(
        wo=wo, wi=(lambda v: (v / np.linalg.norm(v, axis=-1, keepdims=True)))(
            r.randn(n, 3)).astype(np.float32),
        u_lobe=r.rand(n).astype(np.float32), u2=r.rand(n, 2).astype(np.float32),
        uv=(r.rand(n, 2) * 5 - 2).astype(np.float32),
        p=r.rand(n, 3).astype(np.float32),
        fp=np.exp(r.uniform(np.log(1e-5), np.log(0.3), n)).astype(np.float32))


def test_material_resolve_sample_evaluate_pdf(scenes):
    js, ts = scenes
    b = _batch(4096, 0)
    mid = np.random.RandomState(1).randint(0, js.materials.kind.shape[0], 4096)
    J = {k: jnp.asarray(v) for k, v in b.items()}
    T = {k: torch.as_tensor(v) for k, v in b.items()}
    jlp = jmat.resolve(js.materials, jnp.asarray(mid), J["uv"], J["p"], js.textures, fp=J["fp"])
    tlp = tmat.resolve(ts.materials, torch.as_tensor(mid), T["uv"], T["p"], ts.textures,
                       fp=T["fp"])
    for f in ("kind", "kd", "ks", "ax", "ay", "eta", "sigma"):
        _close(getattr(tlp, f), getattr(jlp, f))
    kinds = js.materials.kinds_present
    assert kinds == ts.materials.kinds_present == (0, 1)
    jwi, jf, jpdf, _, _ = jmat.sample(jlp, kinds, J["wo"], J["u_lobe"], J["u2"])
    twi, tf, tpdf, _, _ = tmat.sample(tlp, kinds, T["wo"], T["u_lobe"], T["u2"])
    _close(twi, jwi)
    _close(tf, jf)
    _close(tpdf, jpdf)
    _close(tmat.evaluate_f(tlp, kinds, T["wo"], T["wi"]),
           jmat.evaluate_f(jlp, kinds, J["wo"], J["wi"]))
    _close(tmat.pdf(tlp, kinds, T["wo"], T["wi"]), jmat.pdf(jlp, kinds, J["wo"], J["wi"]))


@pytest.mark.parametrize("with_footprint", [True, False])
def test_image_texture_lookup(scenes, with_footprint):
    js, ts = scenes
    b = _batch(4096, 2)
    tid = np.zeros(4096, np.int64)
    fp = b["fp"] if with_footprint else None
    j = jtex.evaluate(js.textures, jnp.asarray(tid), jnp.asarray(b["uv"]),
                      jnp.asarray(b["p"]), fp=None if fp is None else jnp.asarray(fp))
    t = ttex.evaluate(ts.textures, torch.as_tensor(tid), torch.as_tensor(b["uv"]),
                      torch.as_tensor(b["p"]), fp=None if fp is None else torch.as_tensor(fp))
    _close(t, j)


def test_area_light_sampling_and_pdfs(scenes):
    js, ts = scenes
    r = np.random.RandomState(3)
    n = 4096
    p_ref = (r.rand(n, 3) * np.array([1.0, 0.9, -1.0])).astype(np.float32)
    u2 = r.rand(n, 2).astype(np.float32)
    lt = np.zeros(n, np.int64)
    jls = jlights.sample_li(js.lights, js, jnp.asarray(lt), jnp.asarray(p_ref),
                            jnp.asarray(u2), js.world_radius)
    tls = tlights.sample_li(ts.lights, ts, torch.as_tensor(lt), torch.as_tensor(p_ref),
                            torch.as_tensor(u2), ts.world_radius)
    for k in ("wi", "li", "pdf", "p_light", "dist", "ng_l"):
        _close(tls[k], jls[k])
    np.testing.assert_array_equal(tls["is_delta"].numpy(), np.asarray(jls["is_delta"]))
    ng = r.randn(n, 3).astype(np.float32)
    w = r.randn(n, 3).astype(np.float32)
    lid = r.randint(-1, 1, n)
    _close(tlights.area_light_radiance(ts.lights, torch.as_tensor(lid), torch.as_tensor(ng),
                                       torch.as_tensor(w)),
           jlights.area_light_radiance(js.lights, jnp.asarray(lid), jnp.asarray(ng),
                                       jnp.asarray(w)))
    p_hit = np.asarray(jls["p_light"])
    _close(tlights.pdf_li_area_scene(ts.lights, ts, torch.as_tensor(lid),
                                     torch.as_tensor(p_ref),
                                     torch.as_tensor(p_hit), torch.as_tensor(ng)),
           jlights.pdf_li_area_scene(js.lights, js, jnp.asarray(lid), jnp.asarray(p_ref),
                                     jnp.asarray(p_hit), jnp.asarray(ng)))
