"""The PyTorch port's samplers and tabulated distributions vs the JAX
package: every sampler kind's streams, bit for bit (halton's 32-digit
float fold included: both packages round each step alike), the generated
Sobol' and max-min matrices and the primes, Distribution1D's discrete
sampling and Distribution2D's sampling and pdf (allclose: the two
packages' cumulative sums add in different orders, rtol 1e-5 with atol
1e-6). Each kind renders the Cornell box in tests/test_torch_cornell.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import lowdiscrepancy as jld, samplers as jsmp, sampling as jsampling

from pbrt_tpu_torch.core import lowdiscrepancy as tld, samplers as tsmp
from pbrt_tpu_torch.core import sampling as tsampling


def _lanes(spp=None):
    pix = np.arange(0, 4096, 37, dtype=np.uint32)
    smp_i = np.array([0, 1, 2, 3, 7, 8, 100, 65535, 2 ** 31 + 11], np.uint32)
    if spp is not None:
        smp_i = smp_i % np.uint32(spp)
    P, S = np.meshgrid(pix, smp_i, indexing="ij")
    return P.reshape(-1), S.reshape(-1)


@pytest.mark.parametrize("kind,spp,jitter", [
    ("stratified", 16, True), ("stratified", 6, False), ("maxmin", 8, True),
    ("halton", 16, True), ("sobol", 16, True)])
def test_streams_equal_bit_for_bit(kind, spp, jitter):
    """sample_1d and sample_2d at dims 0 (the film; maxmin's net), 5,
    159, 160 (past the Sobol' table: clamped) and 9000. Stratified takes
    sample indices below spp, as the driver gives it."""
    P, S = _lanes(spp if kind == "stratified" else None)
    jc = jsmp.SamplerConfig(kind=kind, spp=spp, seed=3, jitter=jitter)
    tc = tsmp.SamplerConfig(kind=kind, spp=spp, seed=3, jitter=jitter)
    tp, ts = torch.as_tensor(P.astype(np.int64)), torch.as_tensor(S.astype(np.int64))
    for dim in (0, 5, 159, 160, 9000):
        for jfn, tfn in ((jsmp.sample_1d, tsmp.sample_1d), (jsmp.sample_2d, tsmp.sample_2d)):
            j = np.asarray(jfn(jc, jnp.asarray(P), jnp.asarray(S), dim))
            t = tfn(tc, tp, ts, dim).numpy()
            np.testing.assert_array_equal(t, j, err_msg=f"{kind} dim {dim}")


def test_stratified_permutes_the_strata():
    """Each (pixel, dim) visits every stratum once over its spp samples,
    the walk finishing in more than one round of checks."""
    spp = 48
    pid = torch.arange(200, dtype=torch.int64).repeat_interleave(spp)
    sid = torch.arange(spp, dtype=torch.int64).repeat(200)
    u = tsmp.sample_1d(tsmp.SamplerConfig(kind="stratified", spp=spp, jitter=False),
                       pid, sid, 7)
    strata = (u * spp).floor().reshape(200, spp).sort(-1).values
    assert torch.equal(strata, torch.arange(spp, dtype=torch.float32).expand(200, spp))


def test_generated_tables_equal():
    np.testing.assert_array_equal(tld.primes(), jld.primes().astype(np.int64))
    for m in (1, 2, 3, 5, 6):
        np.testing.assert_array_equal(tld.maxmin_matrix(m),
                                      jld.maxmin_matrix(m).astype(np.int64))
    i = torch.arange(0, 5000, 3, dtype=torch.int64)
    np.testing.assert_array_equal(
        tld.radical_inverse(4, i).numpy(),
        np.asarray(jld.radical_inverse(4, jnp.asarray(i.numpy().astype(np.uint32)))))


def test_distributions():
    r = np.random.RandomState(4)
    func = (r.rand(16, 32) ** 3).astype(np.float32)
    func[3] = 0.0                                   # an empty row
    jd = jsampling.Distribution2D.build(jnp.asarray(func))
    td = tsampling.Distribution2D.build(torch.as_tensor(func))
    kw = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.conditional.cdf.numpy(), np.asarray(jd.conditional.cdf), **kw)
    u = r.rand(4096, 2).astype(np.float32)
    jp, jpdf = jd.sample_continuous(jnp.asarray(u))
    tp, tpdf = td.sample_continuous(torch.as_tensor(u))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **kw)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-4, atol=1e-6)
    q = r.rand(4096, 2).astype(np.float32)
    np.testing.assert_allclose(td.pdf(torch.as_tensor(q)).numpy(),
                               np.asarray(jd.pdf(jnp.asarray(q))), rtol=1e-4, atol=1e-6)
    f1 = (r.rand(9) + 0.05).astype(np.float32)
    j1 = jsampling.Distribution1D.build(jnp.asarray(f1))
    t1 = tsampling.Distribution1D.build(torch.as_tensor(f1))
    uu = r.rand(4096).astype(np.float32)
    ji, jpmf, jur = j1.sample_discrete(jnp.asarray(uu))
    ti, tpmf, tur = t1.sample_discrete(torch.as_tensor(uu))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tpmf.numpy(), np.asarray(jpmf), **kw)
    np.testing.assert_allclose(tur.numpy(), np.asarray(jur), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t1.discrete_pdf(ti).numpy(),
                               np.asarray(j1.discrete_pdf(ji)), **kw)


def test_sphere_and_cone_warps():
    u = np.random.RandomState(6).rand(4096, 2).astype(np.float32)
    cos_max = np.float32(0.8)
    np.testing.assert_allclose(tsampling.uniform_sample_sphere(torch.as_tensor(u)).numpy(),
                               np.asarray(jsampling.uniform_sample_sphere(jnp.asarray(u))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tsampling.uniform_sample_cone(torch.as_tensor(u), float(cos_max)).numpy(),
        np.asarray(jsampling.uniform_sample_cone(jnp.asarray(u), cos_max)),
        rtol=1e-5, atol=1e-6)

