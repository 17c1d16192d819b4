"""Every texture kind and every material kind against pbrt_tpu, per lane.

- Textures: a table with a row of each kind (scale and mix rows nesting
  others) evaluated at numpy-seeded uv and points, negative coordinates
  included; marble lane by lane (the JAX package evaluates it right on one
  lane only: it broadcasts p (N, 3) against the scale (N,)). The
  reference's perlin runs compiled (jax.jit of the same function). Perlin's
  lattice hash (the gradient index) bit for bit at negative corners, the
  noise, fbm and turbulence allclose. The port's evaluation restricted to
  the kinds a channel's ids reach equals the full one on those ids.
- Materials: rows of kinds 0–8 and 10–12 with a texture on every channel,
  resolved, sampled, evaluated and their pdfs; a mix row's evaluate_f with
  the table given; both packages refusing the pdf and sample of a mix row.

Tolerance: rtol 1e-5, atol 1e-6; sampled values, and textured channels
(the noise kinds sum octaves that cancel), as in tests/test_torch_bxdf.py:
at most 0.5% of lanes past rtol 1e-5, none past 1e-3. The JAX BSSRDF table of the subsurface row is the port's arrays
(tests/test_torch_sss.py holds the two tables equal bit for bit): the
functions here do not read it. Torch runs on one thread."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import rng as jrng
from pbrt_tpu.shade import bssrdf as jbss
from pbrt_tpu.shade import fourier as jfou
from pbrt_tpu.shade import materials as jmat
from pbrt_tpu.shade import textures as jtex
from tests.test_torch_bxdf import close, close_sampled
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)

from pbrt_tpu_torch.core import rng as trng
from pbrt_tpu_torch.scenes import wood_image
from pbrt_tpu_torch.shade import bssrdf as tbss
from pbrt_tpu_torch.shade import fourier as tfou
from pbrt_tpu_torch.shade import materials as tmat
from pbrt_tpu_torch.shade import textures as ttex

N = 4096


def port_sss_table(g=0.0, eta=1.33, **kw):
    """The port's profile table as the JAX package's BSSRDFTable."""
    arrs = tbss.beam_diffusion_table_np(g, eta)
    return jbss.BSSRDFTable(*(jnp.asarray(arrs[k]) for k in tbss.FIELDS))


@pytest.fixture
def jax_sss_table(monkeypatch):
    monkeypatch.setattr(jbss, "compute_beam_diffusion_table", port_sss_table)


@pytest.fixture(autouse=True)
def jit_perlin(monkeypatch):
    """The reference's perlin compiled as one program: the noise kinds call
    it hundreds of times, each thousands of ops when run op by op."""
    monkeypatch.setattr(jtex, "perlin", jit_perlin.compiled)


jit_perlin.compiled = jax.jit(jtex.perlin)


def texture_rows(tx, marble=False):
    """A row of each kind (marble only with `marble`); ids in order."""
    ids = [tx.constant((0.2, 0.4, 0.6)), tx.uv()]
    ids.append(tx.scale(ids[1], (2.0, 0.5, 1.0)))
    ids.append(tx.bilerp((0.1, 0.2, 0.3), (0.9, 0.1, 0.0), (0.3, 0.8, 0.2), (0.5, 0.5, 1.0)))
    ids.append(tx.checkerboard((0.9, 0.9, 0.9), (0.1, 0.2, 0.1), su=3.0, sv=5.0))
    ids.append(tx.checkerboard((0.7, 0.1, 0.1), (0.1, 0.1, 0.7), dims=3))
    ids.append(tx.dots((1.0, 0.8, 0.0), (0.0, 0.2, 0.4), su=4.0, sv=4.0))
    ids.append(tx.mix(ids[6], ids[3], 0.3))
    ids.append(tx.fbm(octaves=5, omega=0.6))
    ids.append(tx.wrinkled(octaves=3, omega=0.5))
    ids.append(tx.windy())
    ids.append(tx.image(wood_image(32), su=2.0, sv=3.0))
    if marble:
        ids.append(tx.marble(octaves=6, omega=0.5, scale=2.0, variation=0.4))
    return ids


def points(n, seed):
    r = np.random.RandomState(seed)
    return ((r.rand(n, 2) * 6 - 3).astype(np.float32), (r.rand(n, 3) * 8 - 4).astype(np.float32),
            np.exp(r.uniform(np.log(1e-4), np.log(0.3), n)).astype(np.float32))


def test_every_texture_kind():
    jb, tb = jtex.TextureBuilder(), ttex.TextureBuilder()
    ids = texture_rows(jb)
    assert texture_rows(tb) == ids
    jt, tt = jb.build(), tb.build("cpu")
    assert tt.kinds_present == jt.kinds_present == tuple(k for k in range(13) if k != 11)
    for k in ttex.COLUMNS:
        np.testing.assert_array_equal(getattr(tt, k).numpy(), np.asarray(getattr(jt, k)), k)
    uv, p, fp = points(N, 1)
    tid = np.random.RandomState(2).randint(-1, len(ids), N)
    T = [torch.as_tensor(a) for a in (tid, uv, p, fp)]
    t = ttex.evaluate(tt, *T[:3], fp=T[3])
    close(t, jtex.evaluate(jt, *(jnp.asarray(a) for a in (tid, uv, p)), fp=jnp.asarray(fp)))
    # only the kinds the ids reach: the same values on lanes of those ids
    some = [ids[7], ids[4], ids[11]]
    lanes = torch.as_tensor(np.isin(tid, some))
    assert ttex.reachable(tt, some) == ((2, 5, 12), (3, 7))
    assert torch.equal(ttex.evaluate(tt, *T[:3], fp=T[3], ids=some)[lanes], t[lanes])
    # the image at level 0 (no footprint)
    img = torch.as_tensor(np.full(N, ids[11]))
    close(ttex.evaluate(tt, img, *T[1:3], ids=[ids[11]]),
          jtex._image_lookup(jt, jt.atlas_slot[ids[11]],
                             jnp.asarray(uv) * jnp.asarray([2.0, 3.0], jnp.float32)))


def test_marble_lane_by_lane():
    jb, tb = jtex.TextureBuilder(), ttex.TextureBuilder()
    for b in (jb, tb):
        b.constant(0.5)
        b.marble(octaves=6, omega=0.5, scale=2.0, variation=0.4)
    jt, tt = jb.build(), tb.build("cpu")
    uv, p, _ = points(16, 3)
    tid = np.random.RandomState(3).randint(0, 2, 16)
    t = ttex.evaluate(tt, torch.as_tensor(tid), torch.as_tensor(uv), torch.as_tensor(p))
    for i in range(16):
        j = jtex.evaluate(jt, jnp.asarray(tid[i:i + 1]), jnp.asarray(uv[i:i + 1]),
                          jnp.asarray(p[i:i + 1]))
        close(t[i:i + 1], j)
    with pytest.raises(ValueError):      # the reference's broadcast, more than one lane
        jtex.evaluate(jt, jnp.asarray(tid[:4]), jnp.asarray(uv[:4]), jnp.asarray(p[:4]))


def test_perlin_lattice_hash_and_noise():
    r = np.random.RandomState(4)
    corners = r.randint(-2 ** 20, 2 ** 20, (N, 3))
    corners[:8] = [[-1, -1, -1], [-1, 0, 0], [0, -1, 5], [-7, 3, -2], [2 ** 31 - 2, 0, 0],
                   [-2 ** 31 + 1, 0, 0], [0, 0, 0], [1, 1, 1]]
    h_j = np.asarray(jrng.uniform_u32(*(jnp.asarray(corners[:, k], jnp.int32)
                                        .astype(jnp.uint32) for k in range(3)))) & 15
    h_t = (trng.uniform_u32(*(torch.as_tensor(corners[:, k]) for k in range(3))) & 15).numpy()
    np.testing.assert_array_equal(h_t, h_j.astype(np.int64))
    p = (r.rand(N, 3) * 40 - 20).astype(np.float32)
    close(ttex.perlin(torch.as_tensor(p)), jtex.perlin(jnp.asarray(p)))
    octv, om = r.randint(1, 9, N), r.uniform(0.3, 0.8, N).astype(np.float32)
    for fn in ("fbm_noise", "turbulence"):
        close(getattr(ttex, fn)(torch.as_tensor(p), torch.as_tensor(octv), torch.as_tensor(om)),
              getattr(jtex, fn)(jnp.asarray(p), jnp.asarray(octv), jnp.asarray(om)))


def material_rows(tx, fourier_table):
    """A row of each kind but mix, a texture on every channel somewhere;
    the Fourier row on `fourier_table`."""
    ids = texture_rows(tx)
    c, uv, scale, bil, chk, chk3, dots, mix, fbm, wr, windy, img = ids
    return [dict(kind=tmat.MAT_MATTE, kd=0.5, sigma=20.0, kd_tex=img, sigma_tex=scale),
            dict(kind=tmat.MAT_PLASTIC, kd=(0.4, 0.2, 0.1), ks=0.3, roughness=(0.1, 0.2),
                 kd_tex=mix, ks_tex=chk, roughness_tex=wr),
            dict(kind=tmat.MAT_GLASS, kr=1.0, kt=1.0, eta=1.5, kt_tex=bil),
            dict(kind=tmat.MAT_GLASS, kr=1.0, kt=0.9, eta=1.4, roughness=(0.2, 0.2),
                 remap_roughness=False, kr_tex=c),
            dict(kind=tmat.MAT_METAL, metal_eta=(0.2, 0.92, 1.1), metal_k=(3.9, 2.45, 2.14),
                 ks=1.0, roughness=(0.05, 0.3), ks_tex=chk3),
            dict(kind=tmat.MAT_MIRROR, kr=0.9, kr_tex=dots),
            dict(kind=tmat.MAT_SUBSTRATE, kd=(0.5, 0.3, 0.2), ks=0.05, roughness=(0.1, 0.1),
                 roughness_tex=windy),
            dict(kind=tmat.MAT_TRANSLUCENT, kd=0.5, kr=0.4, kt=0.6, kt_tex=fbm),
            dict(kind=tmat.MAT_UBER, kd=0.3, ks=0.2, kr=0.1, opacity=(0.8, 0.9, 1.0),
                 roughness=(0.15, 0.15), eta=1.6, kd_tex=uv),
            dict(kind=tmat.MAT_DISNEY, kd=(0.8, 0.3, 0.2),
                 aux=(0.3, 0.2, 0.5, 0.5, 0.4, 0.8, 0.4, 0.0), kd_tex=chk),
            dict(kind=tmat.MAT_SUBSURFACE, eta=1.33, kr=1.0, kt=1.0,
                 aux=(0.2, 0.5, 1.5, 30.0, 30.0, 30.0, 0.0, 1.0), bump_tex=fbm),
            dict(kind=tmat.MAT_HAIR, kd=(0.3, 0.2, 0.1), ks=0.4, roughness=(0.3, 0.3)),
            dict(kind=tmat.MAT_FOURIER, fourier_table=fourier_table)]


def both_tables():
    jb, tb = jtex.TextureBuilder(), ttex.TextureBuilder()
    jm = jmat.build_materials(material_rows(jb, jfou.make_lambertian_table((0.6, 0.4, 0.3))))
    tm = tmat.build_materials(material_rows(tb, tfou.make_lambertian_table((0.6, 0.4, 0.3))),
                              "cpu")
    return jm, tm, jb.build(), tb.build("cpu")


def test_every_material_kind(jax_sss_table):
    jm, tm, jt, tt = both_tables()
    assert tm.kinds_present == jm.kinds_present == tuple(k for k in range(13) if k != 9)
    assert tm.tex_channels == jm.tex_channels and tm.has_bump and jm.has_bump
    r = np.random.RandomState(5)
    mid = r.randint(0, len(jm.kind), N)
    uv, p, fp = points(N, 6)
    from tests.test_torch_bxdf import batch, both
    J, T = both(batch(7))
    jlp = jmat.resolve(jm, jnp.asarray(mid), jnp.asarray(uv), jnp.asarray(p), jt,
                       fp=jnp.asarray(fp))
    tlp = tmat.resolve(tm, torch.as_tensor(mid), torch.as_tensor(uv), torch.as_tensor(p), tt,
                       fp=torch.as_tensor(fp))
    for f in ("kind", "eta", "metal_eta", "metal_k", "opacity", "aux"):
        np.testing.assert_array_equal(getattr(tlp, f).numpy(), np.asarray(getattr(jlp, f)), f)
    assert (tlp.rough_is_zero.numpy() != np.asarray(jlp.rough_is_zero)).mean() <= 5e-3
    for f in ("kd", "ks", "kr", "kt", "ax", "ay", "sigma"):     # textured: noise cancels
        close_sampled(getattr(tlp, f), getattr(jlp, f))
    kinds = jm.kinds_present
    close(tmat.evaluate_f(tlp, kinds, T["wo"], T["wi"]),
          jmat.evaluate_f(jlp, kinds, J["wo"], J["wi"]))
    close(tmat.pdf(tlp, kinds, T["wo"], T["wi"]), jmat.pdf(jlp, kinds, J["wo"], J["wi"]))
    ts = tmat.sample(tlp, kinds, T["wo"], T["u"], T["u2"])
    js = jmat.sample(jlp, kinds, J["wo"], J["u"], J["u2"])
    for x, y in zip(ts[:3], js[:3]):
        close_sampled(x, y)
    for x, y in zip(ts[3:], js[3:]):     # is_specular, is_transmission
        assert (x.numpy() != np.asarray(y)).mean() <= 5e-3
    # three taps averaged: the float fields' mean, kind and flags from the first
    avg = tmat.average_taps([tlp, tlp, tlp])
    assert torch.equal(avg.kind, tlp.kind) and avg.fourier is tlp.fourier
    close(avg.kd, tlp.kd)


def test_mix_blends_and_cannot_render(jax_sss_table):
    jb, tb = jtex.TextureBuilder(), ttex.TextureBuilder()
    mix = dict(kind=tmat.MAT_MIX, kd=(0.25, 0.5, 0.75), aux=(1, 4, 0, 0, 0, 0, 0, 0))
    jrows = material_rows(jb, jfou.make_lambertian_table()) + [mix]
    trows = material_rows(tb, tfou.make_lambertian_table()) + [mix]
    jm, tm = jmat.build_materials(jrows), tmat.build_materials(trows, "cpu")
    assert tmat.MAT_MIX in tm.kinds_present
    from tests.test_torch_bxdf import batch, both
    J, T = both(batch(8))
    mid = np.random.RandomState(9).choice([0, 1, 4, 7, len(jrows) - 1], N)
    jlp = jmat.resolve(jm, jnp.asarray(mid))
    tlp = tmat.resolve(tm, torch.as_tensor(mid))
    kinds = tm.kinds_present
    close(tmat.evaluate_f(tlp, kinds, T["wo"], T["wi"], _mats=tm),
          jmat.evaluate_f(jlp, kinds, J["wo"], J["wi"], _mats=jm))
    with pytest.raises(KeyError):
        jmat.pdf(jlp, kinds, J["wo"], J["wi"])
    with pytest.raises(KeyError):
        jmat.sample(jlp, kinds, J["wo"], J["u"], J["u2"])
    with pytest.raises(ValueError, match="mix"):
        tmat.pdf(tlp, kinds, T["wo"], T["wi"])
    with pytest.raises(ValueError, match="mix"):
        tmat.sample(tlp, kinds, T["wo"], T["u"], T["u2"])
