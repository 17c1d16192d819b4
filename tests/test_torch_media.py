"""The PyTorch port's participating media vs the JAX package, per lane:
the Henyey–Greenstein phase function and its sampling, the homogeneous
medium's transmittance and distance sampling, the per-lane dispatch
(medium_tr, medium_sample, phase_g) over vacuum, homogeneous and grid
lanes, and the grid medium's density lookup, ratio tracking and delta
tracking.

Inputs: 4,096 lanes made with numpy from a seed. Tolerance rtol 1e-5,
atol 1e-6 on every lane but those the float64 rule marks: a lane whose
result hangs on a decision (t < dist, u < density / majorant, tr > 1e-4,
|g| < 1e-3) that a float64 re-evaluation puts within 1e-5 (relative) of
its threshold, anywhere along its tracking walk. There the two packages'
ulps may take the lane down another branch. The rule reads numpy alone,
so a fault of the port shows on every other lane; the tests also bound
the share it marks."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import rng as jrng
from pbrt_tpu.shade import media as jmed
from scenes.volumetric import smoke_scene as jsmoke_scene

from pbrt_tpu_torch.core import rng as trng
from pbrt_tpu_torch.shade import media as tmed
from tests.test_torch_shade import scene_tree

RTOL, ATOL = 1e-5, 1e-6
N = 4096
MARGIN = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's torch ops on one thread. A few thousand lanes do
    not pay for the thread pool, and beside other busy processes its
    threads spin against them: on an 8-core CPU with seven busy
    processes this file took 88.8 s with 8 threads and 15.7 s with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w2m():
    m = np.eye(4, dtype=np.float32)
    m[2, 2] = -1.0
    m[:3, 3] = (0.0, 0.0, 0.0)
    return m


def _rows(med):
    """Three media: homogeneous, the smoke grid, a denser homogeneous one."""
    return [dict(kind=med.MEDIUM_HOMOGENEOUS, sigma_a=(0.08, 0.1, 0.12),
                 sigma_s=(0.45, 0.4, 0.5), g=0.3),
            dict(kind=med.MEDIUM_GRID, sigma_a=(0.05,) * 3, sigma_s=(0.9,) * 3, g=0.0,
                 world_to_medium=_w2m(), scale=8.0),
            dict(kind=med.MEDIUM_HOMOGENEOUS, sigma_a=(1.5, 1.0, 0.5),
                 sigma_s=(0.5, 0.7, 0.9), g=-0.6)]


@pytest.fixture(scope="module")
def tables():
    grid = scene_tree(jsmoke_scene())["media"]["grid"]
    return jmed.build_media(_rows(jmed), grid=grid), tmed.build_media(_rows(tmed), grid, "cpu")


def _unit(r, n):
    v = r.randn(n, 3)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def lanes():
    r = np.random.RandomState(3)
    return dict(
        o=(r.rand(N, 3) * np.array([1.4, 1.4, -1.4]) - np.array([0.2, 0.2, -0.2])
           ).astype(np.float32),
        d=_unit(r, N), dist=(r.rand(N) * 2.0).astype(np.float32),
        u=r.rand(N).astype(np.float32), u_ch=r.rand(N).astype(np.float32),
        u2=r.rand(N, 2).astype(np.float32), cos=(r.rand(N) * 2 - 1).astype(np.float32),
        g=np.where(r.rand(N) < 0.1, r.uniform(-2e-3, 2e-3, N), r.uniform(-0.95, 0.95, N))
        .astype(np.float32),
        med=r.randint(-1, 3, N), pid=r.randint(0, 1 << 20, N), sid=r.randint(0, 64, N))


def _keys(lanes):
    j = jrng.hash_combine(jnp.asarray(lanes["pid"], jnp.uint32),
                          jnp.asarray(lanes["sid"], jnp.uint32), jnp.uint32(37))
    t = trng.hash_combine(torch.as_tensor(lanes["pid"]), torch.as_tensor(lanes["sid"]), 37)
    assert np.array_equal(np.asarray(j).astype(np.int64), t.numpy())
    return j, t, np.asarray(j)


def _close(t, j, keep=None):
    t, j = np.asarray(t.numpy(), np.float64), np.asarray(j, np.float64)
    if keep is not None:
        t, j = t[keep], j[keep]
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def _far(a, threshold):
    """The float64 rule: a decision a < threshold is well away from it."""
    return np.abs(a - threshold) > MARGIN * np.maximum(np.abs(threshold), 1e-30)


# ------------------------------------------------- float64 re-evaluation

def _density64(grid, w2m, p):
    pm = np.einsum("nij,nj->ni", w2m[:, :3, :3], p) + w2m[:, :3, 3]
    nz, ny, nx = grid.shape
    g = pm * np.array([nx, ny, nz]) - 0.5
    gi = np.floor(g).astype(np.int64)
    f = g - gi

    def d(x, y, z):
        ok = (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz)
        return np.where(ok, grid[np.clip(z, 0, nz - 1), np.clip(y, 0, ny - 1),
                                 np.clip(x, 0, nx - 1)], 0.0)

    x, y, z = gi.T
    fx, fy, fz = f.T
    lerp = lambda a, b, t: (1 - t) * a + t * b   # noqa: E731
    return lerp(lerp(lerp(d(x, y, z), d(x + 1, y, z), fx), lerp(d(x, y + 1, z),
                                                                d(x + 1, y + 1, z), fx), fy),
                lerp(lerp(d(x, y, z + 1), d(x + 1, y, z + 1), fx),
                     lerp(d(x, y + 1, z + 1), d(x + 1, y + 1, z + 1), fx), fy), fz)


def _track64(jt, mid, o, d, dist, key, sample):
    """Ratio (sample=False) or delta tracking in float64 on the JAX
    table's arrays. Returns (tr, t, sampled, well), `well` the lanes whose
    every decision lies outside the rule's margin."""
    a = lambda x: np.asarray(x, np.float64)   # noqa: E731
    grid, w2m = a(jt.grid), a(jt.world_to_medium)[mid]
    scale = a(jt.sigma_scale)[mid]
    sig = np.maximum((a(jt.sigma_a)[mid] + a(jt.sigma_s)[mid]).mean(-1) * scale, 1e-10)
    o, d, dist = a(o), a(d), a(dist)
    n = len(mid)
    tr, t = np.ones(n), np.zeros(n)
    sampled, alive, well = np.zeros(n, bool), np.ones(n, bool), np.ones(n, bool)
    for i in range(tmed.MAX_TRACK_STEPS):
        if not alive.any():
            break
        u1 = jrng.np_uniform_float(key, np.uint32(2 * i)).astype(np.float64)
        t_new = t - np.log(np.maximum(1.0 - u1, 1e-10)) / sig
        inside = t_new < dist
        well &= ~alive | _far(t_new, dist)
        dens = _density64(grid, w2m, o + t_new[:, None] * d) * scale
        if sample:
            u2 = jrng.np_uniform_float(key, np.uint32(2 * i + 1)).astype(np.float64)
            real = u2 < dens / sig
            well &= ~(alive & inside) | _far(u2, dens / sig)
            moved = alive & inside
            t = np.where(moved, t_new, t)
            sampled |= moved & real
            alive = moved & ~real
        else:
            t = t_new
            tr = np.where(alive & inside, tr * np.clip(1.0 - dens / sig, 0.0, 1.0), tr)
            well &= ~(alive & inside) | _far(tr, 1e-4)
            alive = alive & inside & (tr > 1e-4)
    return tr, np.minimum(t, dist), sampled, well


# ------------------------------------------------------------------ tests

def test_build_media_equals_the_jax_table(tables):
    jt, tt = tables
    for k in tmed.COLUMNS:
        assert np.array_equal(getattr(tt, k).numpy(), np.asarray(getattr(jt, k))), k
    assert tt.kinds_present == jt.kinds_present == (0, 1)


def test_hg_phase_and_sample(lanes):
    g, cos = lanes["g"], lanes["cos"]
    _close(tmed.hg_phase(torch.as_tensor(cos), torch.as_tensor(g)),
           jmed.hg_phase(jnp.asarray(cos), jnp.asarray(g)))
    wo = _unit(np.random.RandomState(8), N)
    wi_t, pdf_t = tmed.hg_sample(torch.as_tensor(wo), torch.as_tensor(g),
                                 torch.as_tensor(lanes["u2"]))
    wi_j, pdf_j = jmed.hg_sample(jnp.asarray(wo), jnp.asarray(g), jnp.asarray(lanes["u2"]))
    keep = _far(np.abs(g.astype(np.float64)), 1e-3)
    assert keep.mean() > 0.99
    _close(wi_t, wi_j, keep)
    _close(pdf_t, pdf_j, keep)
    # the sample is a unit vector whose pdf is the phase value at its cosine
    wi = wi_t.numpy()
    np.testing.assert_allclose(np.linalg.norm(wi, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(pdf_t.numpy(), tmed.hg_phase(
        torch.as_tensor((wi * wo).sum(-1)), torch.as_tensor(g)).numpy(), rtol=1e-3, atol=1e-4)


def test_homogeneous_tr_and_sample(lanes):
    r = np.random.RandomState(5)
    sig_t = (r.rand(N, 3) * 3.0).astype(np.float32)
    sig_s = (sig_t * r.rand(N, 3)).astype(np.float32)
    dist = lanes["dist"].copy()
    dist[:64] = np.inf
    _close(tmed.homogeneous_tr(torch.as_tensor(sig_t), torch.as_tensor(dist)),
           jmed.homogeneous_tr(jnp.asarray(sig_t), jnp.asarray(dist)))
    dist = lanes["dist"]
    args = (sig_t, sig_s, dist, lanes["u"], lanes["u_ch"])
    s_t, t_t, w_t = tmed.homogeneous_sample(*map(torch.as_tensor, args))
    s_j, t_j, w_j = jmed.homogeneous_sample(*map(jnp.asarray, args))
    ch = np.minimum((lanes["u_ch"] * 3).astype(np.int64), 2)
    sig_c = sig_t.astype(np.float64)[np.arange(N), ch]
    t64 = -np.log(np.maximum(1.0 - lanes["u"].astype(np.float64), 1e-10)) / sig_c
    keep = _far(t64, dist.astype(np.float64))
    assert keep.mean() > 0.999
    assert np.array_equal(s_t.numpy()[keep], np.asarray(s_j)[keep])
    assert 0.1 < s_t.numpy().mean() < 0.9
    _close(t_t, t_j, keep)
    _close(w_t, w_j, keep)


def _dispatch_inputs(lanes, tables):
    jt, tt = tables
    jk, tk, key = _keys(lanes)
    names = ("o", "d", "dist")
    return jt, tt, jk, tk, key, [lanes[k] for k in names]


def test_medium_tr_over_vacuum_homogeneous_and_grid_lanes(lanes, tables):
    jt, tt, jk, tk, key, (o, d, dist) = _dispatch_inputs(lanes, tables)
    med = lanes["med"]
    tr_t = tmed.medium_tr(tt, torch.as_tensor(med), *map(torch.as_tensor, (o, d, dist)), tk)
    tr_j = jmed.medium_tr(jt, jnp.asarray(med, jnp.int32), *map(jnp.asarray, (o, d, dist)),
                          jk)
    grid = med == 1
    _, _, _, well = _track64(jt, np.maximum(med, 0), o, d, dist, key, sample=False)
    keep = ~grid | well
    assert keep.mean() > 0.99 and grid.sum() > 900
    _close(tr_t, tr_j, keep)
    assert (tr_t.numpy()[med < 0] == 1.0).all()
    tr64, _, _, _ = _track64(jt, np.maximum(med, 0), o, d, dist, key, sample=False)
    np.testing.assert_allclose(tr_t.numpy()[grid & keep, 0], tr64[grid & keep],
                               rtol=1e-4, atol=1e-5)
    _close(tmed.phase_g(tt, torch.as_tensor(med)), jmed.phase_g(jt, jnp.asarray(med)))


def test_medium_sample_over_vacuum_homogeneous_and_grid_lanes(lanes, tables):
    jt, tt, jk, tk, key, (o, d, dist) = _dispatch_inputs(lanes, tables)
    med = lanes["med"]
    u, u_ch = lanes["u"], lanes["u_ch"]
    s_t, t_t, w_t = tmed.medium_sample(tt, torch.as_tensor(med),
                                       *map(torch.as_tensor, (o, d, dist, u, u_ch)), tk)
    s_j, t_j, w_j = jmed.medium_sample(jt, jnp.asarray(med, jnp.int32),
                                       *map(jnp.asarray, (o, d, dist, u, u_ch)), jk)
    midc = np.maximum(med, 0)
    sig_t = np.asarray(jt.sigma_a + jt.sigma_s, np.float64)[midc]
    ch = np.minimum((u_ch * 3).astype(np.int64), 2)
    t64 = -np.log(np.maximum(1.0 - u.astype(np.float64), 1e-10)) / sig_t[np.arange(N), ch]
    _, _, s64, well = _track64(jt, midc, o, d, dist, key, sample=True)
    keep = np.where(med == 1, well, np.where(med < 0, True, _far(t64, dist)))
    assert keep.mean() > 0.99
    assert np.array_equal(s_t.numpy()[keep], np.asarray(s_j)[keep])
    assert np.array_equal(s_t.numpy()[keep & (med == 1)], s64[keep & (med == 1)])
    assert not s_t.numpy()[med < 0].any() and (w_t.numpy()[med < 0] == 1.0).all()
    for kind in (0, 1, 2):
        assert 0.05 < s_t.numpy()[med == kind].mean() < 0.95
    _close(t_t, t_j, keep)
    _close(w_t, w_j, keep)


def test_grid_density_tr_and_sample(lanes, tables):
    jt, tt, jk, tk, key, (o, d, dist) = _dispatch_inputs(lanes, tables)
    mid = np.ones(N, np.int64)
    _close(tmed.grid_density(tt, torch.as_tensor(mid), torch.as_tensor(o)),
           jmed.grid_density(jt, jnp.asarray(mid, jnp.int32), jnp.asarray(o)))
    dens64 = _density64(np.asarray(jt.grid, np.float64),
                        np.asarray(jt.world_to_medium, np.float64)[mid], o.astype(np.float64))
    np.testing.assert_allclose(tmed.grid_density(tt, torch.as_tensor(mid),
                                                 torch.as_tensor(o)).numpy(), dens64,
                               rtol=1e-5, atol=1e-6)
    args_t = (tt, torch.as_tensor(mid), *map(torch.as_tensor, (o, d, dist)), tk)
    args_j = (jt, jnp.asarray(mid, jnp.int32), *map(jnp.asarray, (o, d, dist)), jk)
    _, _, _, well_tr = _track64(jt, mid, o, d, dist, key, sample=False)
    _, _, s64, well_s = _track64(jt, mid, o, d, dist, key, sample=True)
    assert well_tr.mean() > 0.99 and well_s.mean() > 0.99
    _close(tmed.grid_tr(*args_t), jmed.grid_tr(*args_j), well_tr)
    s_t, t_t, w_t = tmed.grid_sample(*args_t)
    s_j, t_j, w_j = jmed.grid_sample(*args_j)
    assert np.array_equal(s_t.numpy()[well_s], np.asarray(s_j)[well_s])
    assert 0.1 < s_t.numpy().mean() < 0.9
    _close(t_t, t_j, well_s)
    _close(w_t, w_j, well_s)


def test_tracking_stops_early_with_the_full_walks_results(lanes, tables, monkeypatch):
    """Stopping once no lane is alive gives the 256-step walk's results
    bit for bit, in fewer steps."""
    _, tt, _, tk, _, (o, d, dist) = _dispatch_inputs(lanes, tables)
    args = (tt, torch.ones(N, dtype=torch.int64), *map(torch.as_tensor, (o, d, dist)), tk)
    runs = []
    for check in (tmed.CHECK_EVERY, tmed.MAX_TRACK_STEPS + 1):
        monkeypatch.setattr(tmed, "CHECK_EVERY", check)
        before = tmed.TRACKED.steps
        runs.append((tmed.grid_tr(*args), *tmed.grid_sample(*args),
                     tmed.TRACKED.steps - before))
    (*early, steps_early), (*full, steps_full) = runs
    assert steps_full == 2 * tmed.MAX_TRACK_STEPS and steps_early < steps_full // 2
    for a, b in zip(early, full):
        assert torch.equal(a, b)
