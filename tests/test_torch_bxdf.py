"""The appearance slice's lobes and tables against pbrt_tpu, per lane:
the Beckmann and GGX microfacet functions, conductor and Schlick Fresnel,
Lambertian transmission, FresnelBlend, the transmission lobes in both
transport modes, the Disney BSDF, the Fourier BSDF (a table made in
memory and one read from a SCATFUN file the test writes), the Catmull–Rom
and Fourier series functions, and the BSSRDF's Fresnel moments, Sr,
radius sample and Sw.

Inputs are numpy-seeded batches. Tolerance: rtol 1e-5, atol 1e-6 (the
two packages' transcendentals differ by an ulp). Sampled directions, and
the values evaluated at them, chain several transcendentals, and an ulp
there moves the sample: of those at most 0.5% of lanes may pass rtol
1e-5, none rtol 1e-3. The Fresnel moments' polynomial fits cancel terms
up to 500 in float32: atol there is 1e-6 × the float64 sum of the terms'
magnitudes. Torch runs on one thread."""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import interpolation as jint
from pbrt_tpu.shade import bssrdf as jbss
from pbrt_tpu.shade import bxdf as jbx
from pbrt_tpu.shade import disney as jdis
from pbrt_tpu.shade import fourier as jfou
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)

from pbrt_tpu_torch.core import interpolation as tint
from pbrt_tpu_torch.shade import bssrdf as tbss
from pbrt_tpu_torch.shade import bxdf as tbx
from pbrt_tpu_torch.shade import disney as tdis
from pbrt_tpu_torch.shade import fourier as tfou

RTOL, ATOL = 1e-5, 1e-6
N = 4096


def close(t, j, **kw):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **{"rtol": RTOL, "atol": ATOL,
                                                                **kw})


def close_sampled(t, j, frac=5e-3, loose=1e-3):
    """Values of a sample: all lanes within rtol `loose`, all but `frac`
    of them within RTOL."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    np.testing.assert_allclose(t, j, rtol=loose, atol=ATOL)
    bad = np.abs(t - j) > ATOL + RTOL * np.abs(j)
    if bad.ndim > 1:
        bad = bad.reshape(bad.shape[0], -1).any(-1)
    assert bad.mean() <= frac, f"{bad.sum()} of {bad.size} lanes past rtol {RTOL}"


def unit(r, n, flip_frac=0.25):
    v = r.randn(n, 3)
    v[: int(n * flip_frac), 2] = -np.abs(v[: int(n * flip_frac), 2])
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    v[:, 2] = np.where(np.abs(v[:, 2]) < 1e-3, 1e-3, v[:, 2])
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def batch(seed, n=N):
    r = np.random.RandomState(seed)
    return dict(wo=unit(r, n), wi=unit(r, n), u2=r.rand(n, 2).astype(np.float32),
                u=r.rand(n).astype(np.float32),
                rgb=r.uniform(0.05, 1.0, (n, 3)).astype(np.float32),
                rgb2=r.uniform(0.05, 1.0, (n, 3)).astype(np.float32),
                ax=r.uniform(0.02, 0.8, n).astype(np.float32),
                ay=r.uniform(0.02, 0.8, n).astype(np.float32),
                eta=r.uniform(1.1, 2.0, n).astype(np.float32),
                metal_eta=r.uniform(0.1, 2.0, (n, 3)).astype(np.float32),
                metal_k=r.uniform(0.5, 4.0, (n, 3)).astype(np.float32))


def both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


@pytest.mark.parametrize("dist", [jbx.DIST_GGX, jbx.DIST_BECKMANN])
def test_microfacet_distribution_and_lobes(dist):
    assert tbx.DIST_GGX == jbx.DIST_GGX and tbx.DIST_BECKMANN == jbx.DIST_BECKMANN
    J, T = both(batch(1))
    ja, jay, ta, tay = J["ax"], J["ay"], T["ax"], T["ay"]
    wh_j = jbx.mf_sample_wh(dist, ja, jay, J["wo"], J["u2"])
    wh_t = tbx.mf_sample_wh(dist, ta, tay, T["wo"], T["u2"])
    close_sampled(wh_t, wh_j)
    for fn in ("mf_d", "mf_lambda", "mf_g1"):
        close(getattr(tbx, fn)(dist, ta, tay, T["wi"]), getattr(jbx, fn)(dist, ja, jay, J["wi"]))
    close(tbx.mf_g(dist, ta, tay, T["wo"], T["wi"]), jbx.mf_g(dist, ja, jay, J["wo"], J["wi"]))
    wh = np.asarray(wh_j)           # both pdfs at the same half vectors
    close(tbx.mf_pdf(dist, ta, tay, T["wo"], torch.as_tensor(wh)),
          jbx.mf_pdf(dist, ja, jay, J["wo"], jnp.asarray(wh)))
    one_j, one_t = jnp.ones_like(J["eta"]), torch.ones_like(T["eta"])
    fr_j = lambda c: jbx.fresnel_conductor(c, one_j, J["metal_eta"], J["metal_k"])  # noqa: E731
    fr_t = lambda c: tbx.fresnel_conductor(c, one_t, T["metal_eta"], T["metal_k"])  # noqa: E731
    close(tbx.microfacet_reflection_f(T["rgb"], dist, ta, tay, fr_t, T["wo"], T["wi"]),
          jbx.microfacet_reflection_f(J["rgb"], dist, ja, jay, fr_j, J["wo"], J["wi"]))
    close(tbx.microfacet_reflection_pdf(dist, ta, tay, T["wo"], T["wi"]),
          jbx.microfacet_reflection_pdf(dist, ja, jay, J["wo"], J["wi"]))
    for x, y in zip(tbx.microfacet_reflection_sample(T["rgb"], dist, ta, tay, fr_t, T["wo"],
                                                     T["u2"]),
                    jbx.microfacet_reflection_sample(J["rgb"], dist, ja, jay, fr_j, J["wo"],
                                                     J["u2"])):
        close_sampled(x, y)
    for mode in (True, False):
        close(tbx.microfacet_transmission_f(T["rgb"], dist, ta, tay, one_t, T["eta"], T["wo"],
                                            T["wi"], mode_radiance=mode),
              jbx.microfacet_transmission_f(J["rgb"], dist, ja, jay, one_j, J["eta"], J["wo"],
                                            J["wi"], mode_radiance=mode))
    close(tbx.microfacet_transmission_pdf(dist, ta, tay, one_t, T["eta"], T["wo"], T["wi"]),
          jbx.microfacet_transmission_pdf(dist, ja, jay, one_j, J["eta"], J["wo"], J["wi"]))
    for x, y in zip(tbx.microfacet_transmission_sample(T["rgb"], dist, ta, tay, one_t, T["eta"],
                                                       T["wo"], T["u2"]),
                    jbx.microfacet_transmission_sample(J["rgb"], dist, ja, jay, one_j, J["eta"],
                                                       J["wo"], J["u2"])):
        close_sampled(x, y)
    close(tbx.fresnel_blend_f(T["rgb"], T["rgb2"], dist, ta, tay, T["wo"], T["wi"]),
          jbx.fresnel_blend_f(J["rgb"], J["rgb2"], dist, ja, jay, J["wo"], J["wi"]))
    close(tbx.fresnel_blend_pdf(dist, ta, tay, T["wo"], T["wi"]),
          jbx.fresnel_blend_pdf(dist, ja, jay, J["wo"], J["wi"]))
    for x, y in zip(tbx.fresnel_blend_sample(T["rgb"], T["rgb2"], dist, ta, tay, T["wo"],
                                             T["u2"], T["u"]),
                    jbx.fresnel_blend_sample(J["rgb"], J["rgb2"], dist, ja, jay, J["wo"],
                                             J["u2"], J["u"])):
        close_sampled(x, y)


def test_fresnel_lambert_transmission_and_specular_modes():
    J, T = both(batch(2))
    c_j, c_t = J["wo"][:, 2], T["wo"][:, 2]
    one_j, one_t = jnp.ones_like(J["eta"]), torch.ones_like(T["eta"])
    close(tbx.fresnel_conductor(c_t, one_t, T["metal_eta"], T["metal_k"]),
          jbx.fresnel_conductor(c_j, one_j, J["metal_eta"], J["metal_k"]))
    close(tbx.fresnel_schlick(c_t, T["rgb"]), jbx.fresnel_schlick(c_j, J["rgb"]))
    close(tbx.lambertian_transmission_f(T["rgb"], T["wo"], T["wi"]),
          jbx.lambertian_transmission_f(J["rgb"], J["wo"], J["wi"]))
    close(tbx.lambertian_transmission_pdf(T["wo"], T["wi"]),
          jbx.lambertian_transmission_pdf(J["wo"], J["wi"]))
    wi_t, pdf_t = tbx.lambertian_transmission_sample(T["wo"], T["u2"])
    wi_j, _, pdf_j = jbx.lambertian_transmission_sample(J["rgb"], J["wo"], J["u2"])
    close(wi_t, wi_j)
    close(pdf_t, pdf_j)
    for mode in (True, False):
        for x, y in zip(tbx.specular_transmission_sample(T["rgb"], one_t, T["eta"], T["wo"],
                                                         mode_radiance=mode),
                        jbx.specular_transmission_sample(J["rgb"], one_j, J["eta"], J["wo"],
                                                         mode_radiance=mode)):
            close(x, y)
        for x, y in zip(tbx.fresnel_specular_sample(T["rgb"], T["rgb2"], one_t, T["eta"],
                                                    T["wo"], T["u"], mode_radiance=mode),
                        jbx.fresnel_specular_sample(J["rgb"], J["rgb2"], one_j, J["eta"],
                                                    J["wo"], J["u"], mode_radiance=mode)):
            close(x, y)


def test_disney_bsdf():
    b = batch(3)
    r = np.random.RandomState(4)
    b.update({k: r.uniform(0.0, 1.0, N).astype(np.float32)
              for k in ("metallic", "spec_tint", "sheen", "sheen_tint", "clearcoat",
                        "cc_gloss")})
    b["rough"] = r.uniform(0.05, 1.0, N).astype(np.float32)
    J, T = both(b)
    names = ("metallic", "rough", "spec_tint", "sheen", "sheen_tint", "clearcoat", "cc_gloss")
    aj = [J["rgb"]] + [J[k] for k in names]
    at = [T["rgb"]] + [T[k] for k in names]
    close(tdis.disney_f(*at, T["wo"], T["wi"]), jdis.disney_f(*aj, J["wo"], J["wi"]))
    close(tdis.disney_pdf(T["rough"], T["metallic"], T["clearcoat"], T["wo"], T["wi"]),
          jdis.disney_pdf(J["rough"], J["metallic"], J["clearcoat"], J["wo"], J["wi"]))
    for x, y in zip(tdis.disney_sample(*at, T["wo"], T["u"], T["u2"]),
                    jdis.disney_sample(*aj, J["wo"], J["u"], J["u2"])):
        close_sampled(x, y)


def test_interpolation():
    r = np.random.RandomState(5)
    nodes = np.sort(r.uniform(-1.0, 2.0, 12)).astype(np.float32)
    values = r.uniform(0.0, 3.0, 12).astype(np.float32)
    x = r.uniform(-1.2, 2.2, N).astype(np.float32)
    jn, jv, jx = jnp.asarray(nodes), jnp.asarray(values), jnp.asarray(x)
    tn, tv, tx = torch.as_tensor(nodes), torch.as_tensor(values), torch.as_tensor(x)
    jw, tw = jint.catmull_rom_weights(jn, jx), tint.catmull_rom_weights(tn, tx)
    np.testing.assert_array_equal(tw[0].numpy(), np.asarray(jw[0]))
    for a, b in zip(tw[1:], jw[1:]):
        close(a, b)
    close(tint.catmull_rom(tn, tv, tx), jint.catmull_rom(jn, jv, jx))
    for a, b in zip(tint.integrate_catmull_rom(tn, tv), jint.integrate_catmull_rom(jn, jv)):
        close(a, b)
    n2 = np.sort(r.uniform(0.0, 1.0, 9)).astype(np.float32)
    vals = r.uniform(0.0, 2.0, (12, 9)).astype(np.float32)
    cdf = np.cumsum(vals, axis=1).astype(np.float32)
    alpha, u = r.uniform(-1.0, 2.0, N).astype(np.float32), r.rand(N).astype(np.float32)
    for a, b in zip(tint.sample_catmull_rom_2d(tn, torch.as_tensor(n2), torch.as_tensor(vals),
                                               torch.as_tensor(cdf), torch.as_tensor(alpha),
                                               torch.as_tensor(u)),
                    jint.sample_catmull_rom_2d(jn, jnp.asarray(n2), jnp.asarray(vals),
                                               jnp.asarray(cdf), jnp.asarray(alpha),
                                               jnp.asarray(u))):
        close(a, b)
    coef = r.randn(N, 7).astype(np.float32)
    cphi = r.uniform(-1.0, 1.0, N).astype(np.float32)
    m = r.randint(0, 8, N)
    close(tint.fourier(torch.as_tensor(coef), torch.as_tensor(cphi), torch.as_tensor(m)),
          jint.fourier(jnp.asarray(coef), jnp.asarray(cphi), jnp.asarray(m)), atol=1e-5)
    close(tint.fourier(torch.as_tensor(coef), torch.as_tensor(cphi), 5),
          jint.fourier(jnp.asarray(coef), jnp.asarray(cphi), 5), atol=1e-5)


def write_scatfun(path, mu, coeffs_ij, n_channels, eta):
    """A SCATFUN v1 file in the layout pbrt_tpu.shade.fourier reads:
    header, mu, a cdf block, (offset, length) per (i, j), coefficients."""
    n = len(mu)
    offlen, flat = [], []
    for c in coeffs_ij:
        offlen.append((len(flat), len(c)))
        flat.extend(c)
    m_max = max(len(c) for c in coeffs_ij) // n_channels
    head = b"SCATFUN" + bytes([1]) + struct.pack("<8i6f", 0, n, len(flat), m_max, n_channels,
                                                 1, 0, 0, eta, 0, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(head + np.asarray(mu, "<f4").tobytes() + np.zeros(n * n, "<f4").tobytes()
                + np.asarray(offlen, "<i4").tobytes() + np.asarray(flat, "<f4").tobytes())


def test_fourier_bsdf(tmp_path):
    r = np.random.RandomState(6)
    n = 7
    mu = np.sort(np.concatenate([[-1.0, 1.0], r.uniform(-0.95, 0.95, n - 2)])).astype(np.float32)
    coeffs = []
    for _ in range(n * n):
        m = r.randint(1, 5)
        coeffs.append(list((r.rand(3 * m) * 0.3 / (1 + np.arange(3 * m) % m)).astype(np.float32)))
    path = tmp_path / "random.bsdf"
    write_scatfun(path, mu, coeffs, 3, 1.3)
    jt = jfou.load_bsdf_file(str(path))
    tt = tfou.load_bsdf_file(str(path))
    lj = jfou.make_lambertian_table((0.6, 0.4, 0.3))
    lt = tfou.make_lambertian_table((0.6, 0.4, 0.3))
    J, T = both(batch(7))
    for j, t in ((jt, tt), (lj, lt)):
        for k in ("mu", "a", "m"):
            np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)))
        assert (t.eta, t.m_max) == (j.eta, j.m_max)
        close(tfou.fourier_f(t, T["wo"], T["wi"]), jfou.fourier_f(j, J["wo"], J["wi"]),
              atol=1e-5)
        for x, y in zip(tfou.fourier_sample(t, T["wo"], T["u2"]),
                        jfou.fourier_sample(j, J["wo"], J["u2"])):
            close_sampled(x, y)


def test_bssrdf_functions():
    arrs = tbss.beam_diffusion_table_np(g=0.2, eta=1.4, n_rho=8, n_r=16)
    tt = tbss.table_from_numpy(arrs, "cpu")
    jt = jbss.BSSRDFTable(*(jnp.asarray(arrs[k]) for k in tbss.FIELDS))
    r = np.random.RandomState(8)
    eta = r.uniform(0.6, 2.0, N).astype(np.float32)
    e = eta.astype(np.float64)
    scale1 = np.where(e < 1, sum(abs(c) * e ** k for k, c in enumerate(
        (0.45966, 1.73965, 3.37668, 3.904945, 2.49277, 0.68441))), sum(abs(c) * e ** k for k, c in
        enumerate((4.61686, 11.1136, 10.4646, 5.11455, 1.27198, 0.12746))))
    scale2 = np.where(e < 1, sum(abs(c) * e ** k for k, c in enumerate(
        (0.27614, 0.87350, 1.12077, 0.65095, 0.07883, 0.04860))),
        547.033 + 45.3087 / e ** 3 + 218.725 / e ** 2 + 458.843 / e + 404.557 * e
        + 189.519 * e ** 2 + 54.9327 * e ** 3 + 9.00603 * e ** 4 + 0.63942 * e ** 5)
    for fn, scale in (("fresnel_moment1", scale1), ("fresnel_moment2", scale2)):
        t = getattr(tbss, fn)(torch.as_tensor(eta)).numpy().astype(np.float64)
        j = np.asarray(getattr(jbss, fn)(jnp.asarray(eta)), np.float64)
        assert (np.abs(t - j) <= ATOL * scale + RTOL * np.abs(j)).all(), fn
    sig_t = r.uniform(0.5, 40.0, (N, 3)).astype(np.float32)
    rho = r.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    rad = np.exp(r.uniform(np.log(1e-4), np.log(3.0), N)).astype(np.float32)
    close(tbss.sr(tt, torch.as_tensor(sig_t), torch.as_tensor(rho), torch.as_tensor(rad)),
          jbss.sr(jt, jnp.asarray(sig_t), jnp.asarray(rho), jnp.asarray(rad)))
    u = r.rand(N).astype(np.float32)
    for x, y in zip(tbss.sample_radius(tt, torch.as_tensor(sig_t[:, 0]),
                                       torch.as_tensor(rho[:, 0]), torch.as_tensor(u)),
                    jbss.sample_radius(jt, jnp.asarray(sig_t[:, 0]), jnp.asarray(rho[:, 0]),
                                       jnp.asarray(u))):
        close_sampled(x, y)
    cos = r.uniform(-1.0, 1.0, N).astype(np.float32)
    close(tbss.sw(torch.as_tensor(eta), torch.as_tensor(cos)),
          jbss.sw(jnp.asarray(eta), jnp.asarray(cos)))
